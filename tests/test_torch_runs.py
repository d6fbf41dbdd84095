"""Run-compressed scan parity: karpenter_tpu_torch's runs_scan_plain (the
plain PyTorch version the runs_screen kernel is held to) against the JAX
package's _solve_ffd_runs_jit on the same padded problem, carried over leaf
for leaf by problem_from_numpy.

Exact, floats included (atol=0, rtol=0): kind/index per row and every leaf
of the final FFDState, from the initial state and from a carried state (a
second pass over the rows the first left unplaced, as the screen's passes
run). The corpora cover the three run modes: per-pod steps, closed-form
analytic commits (node fills, claim waterfills, template opens, CSI
capacities) and topology runs on existing nodes and claims.
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.ops.ffd_runs import solve_ffd_runs as j_solve_ffd_runs
from karpenter_tpu_torch.models.problem import RUN_ANALYTIC, RUN_TOPO, numpy_fields, problem_from_numpy, state_from_numpy
from karpenter_tpu_torch.ops.ffd_core import KIND_FAIL, initial_state
from karpenter_tpu_torch.ops.ffd_runs import has_topo_runs, max_run_bucket, runs_scan_plain, solve_ffd_runs
from tests import test_torch_encode as TE
import tests.torch_threads  # noqa: F401  (one intra-op thread)

TE.WORKLOADS.setdefault("topology-4", lambda m: m.topology_workload(4))
TE.WORKLOADS.setdefault("rtopo-11", lambda m: m.relax_topology_workload(11))

CORPORA = ["chain-2003", "topology-4", "volumes-0", "homog-48"]
SLOW_CORPORA = ["fuzz-6", "chain-2000", "chain-2001", "fuzz-1", "bounds-0", "diverse-280", "rtopo-11", "topology-8"]


def _problem(name, slots=32):
    jp, _, _, _ = TE.encode_both(name, claim_slots=slots)
    return jp, problem_from_numpy(numpy_fields(jp), "cpu")


def assert_exact(jr, tr):
    np.testing.assert_array_equal(np.asarray(jr.kind), tr.kind.numpy())
    np.testing.assert_array_equal(np.asarray(jr.index), tr.index.numpy())
    js, ts = numpy_fields(jr.state), numpy_fields(tr.state)
    assert sorted(js) == sorted(ts)
    for key in js:
        assert js[key].shape == ts[key].shape, key
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)


def _fresh_and_carried(name, carried):
    """Both scans from the initial state and, with ``carried``, a second
    pass over what the first left unplaced, from its state. Returns the JAX
    problem and first result."""
    jp, tp = _problem(name)
    jr = j_solve_ffd_runs(jp, 32)
    tr = solve_ffd_runs(tp, 32)
    assert_exact(jr, tr)
    if carried:
        placed = np.asarray(jr.kind) < KIND_FAIL
        state = numpy_fields(jr.state)
        jp2 = dataclasses.replace(jp, pod_active=np.asarray(jp.pod_active) & ~placed)
        tp2 = dataclasses.replace(tp, pod_active=tp.pod_active & ~torch.from_numpy(placed))
        jr2 = j_solve_ffd_runs(jp2, 32, init=jr.state)
        tr2 = runs_scan_plain(tp2, state_from_numpy(state, "cpu"), max_run_bucket(tp2), has_topo_runs(tp2))
        assert_exact(jr2, tr2)
    return jp, jr


@pytest.mark.parametrize("name", CORPORA)
def test_runs_scan_parity(name):
    jp, jr = _fresh_and_carried(name, carried=name == "chain-2003")
    used = set(np.asarray(jp.run_mode)[np.asarray(jp.run_len) > 0].tolist())
    if name in ("chain-2003", "topology-4"):
        assert RUN_TOPO in used
    if name in ("chain-2003", "volumes-0", "homog-48"):
        assert RUN_ANALYTIC in used
    if name == "homog-48":
        assert used == {RUN_ANALYTIC} and np.asarray(jr.state.claim_open).sum() > 1


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW_CORPORA)
def test_runs_scan_parity_deep(name):
    _fresh_and_carried(name, carried=True)


def test_topology_run_without_the_topology_commit_raises():
    """A RUN_TOPO run fed to a scan built without the topology commit is an
    error, not a silent fall into the analytic commit."""
    _, tp = _problem("chain-2003")
    assert has_topo_runs(tp)
    with pytest.raises(ValueError, match="RUN_TOPO"):
        runs_scan_plain(tp, initial_state(tp, 32), max_run_bucket(tp), with_topo=False)


# -- the KARPENTER_TPU_RUNS solve ------------------------------------------------


def _runs_corpus(pkg, seed):
    """tests/test_runs_solver.py's fuzz corpus (identical-pod-heavy batches
    with host ports and existing nodes) built by ``pkg``'s constructors;
    seed None is its claim-slot case (twelve 0.9-cpu pods, one a claim,
    against four initial slots)."""
    import importlib
    import random

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    o, wk = mod("apis.objects"), mod("apis.labels")
    its_of, encode = mod("cloudprovider.fake").instance_types, mod("solver.encode")
    label_requirements, Taints = mod("scheduling.requirements").label_requirements, mod("scheduling").Taints

    def pod(i, cpu=0.5, mem=1e8, ports=None):
        return o.Pod(metadata=o.ObjectMeta(name=f"p{i}"), spec=o.PodSpec(containers=[o.Container(
            requests={"cpu": cpu, "memory": mem}, ports=[o.ContainerPort(host_port=p) for p in (ports or [])])]))

    def node(name, cpu):
        labels = {wk.LABEL_HOSTNAME: name, wk.LABEL_TOPOLOGY_ZONE: "test-zone-1",
                  wk.CAPACITY_TYPE_LABEL_KEY: wk.CAPACITY_TYPE_ON_DEMAND}
        return encode.NodeInfo(name=name, requirements=label_requirements(labels), taints=Taints([]),
                               available={"cpu": cpu, "memory": 8e9, "pods": 110.0}, daemon_overhead={})

    def template(its):
        np_mod = mod("apis.nodepool")
        pool = np_mod.NodePool(metadata=o.ObjectMeta(name="pool"), spec=np_mod.NodePoolSpec(
            template=np_mod.NodeClaimTemplateSpec(spec=np_mod.NodeClaimSpec())))
        return encode.template_from_nodepool(pool, its, range(len(its)))

    if seed is None:
        its = its_of(4)
        return [pod(i, cpu=0.9, mem=2e9) for i in range(12)], its, [template(its)], []
    rng = random.Random(seed)
    its = its_of(rng.randint(3, 12))
    tpl = template(its)
    nodes = [node(f"n-{i}", rng.choice([0.5, 1.0, 4.0])) for i in range(rng.randint(0, 3))]
    pods = [pod(i, cpu=rng.choice([0.1, 0.25, 0.5, 1.0]), mem=rng.choice([1e8, 5e8, 1e9]),
                ports=[8080] if rng.random() < 0.1 else None) for i in range(rng.randint(10, 60))]
    return pods, its, [tpl], nodes


@pytest.mark.parametrize("seed", [0, 1, 2, None])
def test_runs_solve_matches_jax(seed, monkeypatch):
    """``KARPENTER_TPU_RUNS=1`` (the plain ``solve_ffd_runs`` per pass on
    the CPU) against ``JaxSolver`` with its ``_USE_RUNS`` on: equal claims,
    node placements and failures, the same claim-slot escalations, no
    IterCounts (the per-pass loop)."""
    import karpenter_tpu.solver.jax_backend as jb
    from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as JFAKE
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from tests.test_torch_solver import assert_same_results

    monkeypatch.setattr(jb, "_USE_RUNS", True)
    monkeypatch.setenv("KARPENTER_TPU_RUNS", "1")
    slots = 4 if seed is None else 32
    pods, its, tpls, nodes = _runs_corpus("karpenter_tpu", seed)
    js = jb.JaxSolver(well_known=JFAKE, initial_claim_slots=slots)
    jr = js.solve(pods, its, tpls, nodes)
    pods, its, tpls, nodes = _runs_corpus("karpenter_tpu_torch", seed)
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", initial_claim_slots=slots)
    assert ts.runs
    tr = ts.solve(pods, its, tpls, nodes)
    assert_same_results(jr, tr)
    assert ts.claim_escalations == js.claim_escalations and ts.last_iters is None
    assert tr.verify_ctx is None  # a per-pass solve leaves the host validator to its caller
