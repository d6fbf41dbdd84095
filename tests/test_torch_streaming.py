"""The streaming layer (streaming/warm.py, residual.py, verify/incremental.py,
churn's spot reclaims) against the JAX package's on the same streams, on the
CPU.

Both packages build their inputs with their own constructors from the same
seeds (``churn.default_pod_factory``, ``testing/workloads.make_diverse_pods``
and its JAX-bound copy), so pods, nodes and churn events are equal field for
field; uids differ, so every comparison keys pods by name.

Exact, per cycle: the streaming outcome, the reuse ratio, the certified pods
and every placement (node name, claim index, failure), and the stream-cycle
flight records. The residual world's NodeInfo fields, and the incremental
gate's violations and audit counts, are exact too. Against cold truth (the
JAX parity contract of tests/test_streaming_parity.py): certified pods sit
where a cold solve of the same snapshot puts them, and every result is clean
under the full host validator.
"""

from __future__ import annotations

import copy
import importlib
import random
from types import SimpleNamespace

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_encode import reference_workloads as RW
from karpenter_tpu_torch.testing import workloads as TW


def _side(root, workloads):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        name=root, wk=mod("apis.labels"), objects=mod("apis.objects"), NodePool=mod("apis.nodepool").NodePool,
        instance_types=mod("cloudprovider.fake").instance_types, encode=mod("solver.encode"),
        Oracle=mod("solver.oracle").OracleSolver, val=mod("solver.validator"), churn=mod("streaming.churn"),
        warm=mod("streaming.warm"), residual=mod("streaming.residual"), faults=mod("testing.faults"),
        verify=mod("verify"), gate=mod("verify.gate"), registry=mod("metrics.registry"),
        flight=mod("obs.flight"), slo=mod("obs.slo"), Taints=mod("scheduling").Taints,
        label_requirements=mod("scheduling.requirements").label_requirements, workloads=workloads,
    )


JAX = _side("karpenter_tpu", RW)
PORT = _side("karpenter_tpu_torch", TW)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_STATE_DIR", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_FAULTS", raising=False)
    for s in SIDES:
        s.faults.clear()
        s.gate._audit_calls = 0
    yield
    for s in SIDES:
        s.faults.clear()
        s.flight.set_enabled(None)
        s.slo.set_enabled(None)


def build_world(s, its_count=12, pool="stream"):
    its = s.instance_types(its_count)
    tpl = s.encode.template_from_nodepool(s.NodePool(metadata=s.objects.ObjectMeta(name=pool)), its, range(len(its)))
    return its, [tpl]


def make_node(s, name, cpu=8.0, mem=32e9):
    return s.encode.NodeInfo(
        name=name, requirements=s.label_requirements({s.wk.LABEL_HOSTNAME: name}), taints=s.Taints(()),
        available={"cpu": cpu, "memory": mem, "pods": 40.0}, daemon_overhead={},
    )


def placements(pods, result):
    """pod name -> ("node", name) | ("claim", index) | ("fail", reason)."""
    out = {}
    for name, idxs in result.node_pods.items():
        for i in idxs:
            out[pods[i].metadata.name] = ("node", name)
    for ci, c in enumerate(result.new_claims):
        for i in c.pod_indices:
            out[pods[i].metadata.name] = ("claim", ci)
    for i, reason in result.failures.items():
        out[pods[i].metadata.name] = ("fail", reason)
    return out


def run_stream(s, inner, pods, nodes, its, tpls, cycles, seed, arrivals=4, deletes=3, spec=None, cold=None):
    """Drive ``StreamingSolver(inner)`` through a churn stream; per cycle the
    outcome, reuse ratio, certified pod names and placements. With ``cold``
    (a backend), hold the warm result to the JAX parity contract: validator
    clean, certified pods where a cold solve puts them."""
    if spec:
        s.faults.install(s.faults.FaultInjector.from_spec(spec))
    solver = s.warm.StreamingSolver(inner)
    proc = s.churn.ChurnProcess(
        list(pods), nodes=list(nodes),
        config=s.churn.ChurnConfig(seed=seed, arrivals_per_cycle=arrivals, deletes_per_cycle=deletes),
    )
    out = []
    for cycle in range(cycles):
        ev = proc.step()
        snap, snap_nodes = list(proc.pods), list(proc.nodes)
        result = solver.solve(snap, its, tpls, nodes=snap_nodes)
        name_of = {p.uid: p.metadata.name for p in snap}
        placed = placements(snap, result)
        certified = sorted(name_of[u] for u in solver.last_certified_uids)
        if cold is not None:
            assert not s.val.validate_result(result, snap, its, tpls, nodes=snap_nodes, level="full"), cycle
            truth = placements(snap, cold.solve(snap, its, tpls, nodes=snap_nodes))
            for name in certified:
                assert placed[name][0] == truth[name][0], (cycle, name)
                if placed[name][0] == "node":
                    assert placed[name][1] == truth[name][1], (cycle, name)
        out.append(dict(outcome=solver.last_outcome, ratio=solver.last_reuse_ratio, certified=certified,
                        placed=placed, reclaimed=list(ev.reclaimed)))
    return out, solver


def both(run):
    jax_view, port_view = run(JAX), run(PORT)
    assert port_view == jax_view
    return port_view


# -- the residual world --------------------------------------------------------


def test_residual_world_matches_jax():
    """The pinned-node residuals and a claim pseudo-node: equal NodeInfo
    fields (requirements by their label set and repr)."""

    def run(s):
        its, tpls = build_world(s, its_count=6)
        pods = s.workloads.make_diverse_pods(24, random.Random(4))
        nodes = [make_node(s, f"n-{i}", cpu=16.0) for i in range(3)]
        result = s.Oracle().solve(pods, its, tpls, nodes=nodes)
        pinned = {name: idxs[: max(1, len(idxs) // 2)] for name, idxs in result.node_pods.items()}
        residuals = s.residual.pinned_node_residuals(nodes, pods, pinned)
        pseudo = [s.residual.claim_pseudo_node(ci, c, pods, its, tpls) for ci, c in enumerate(result.new_claims)]

        def fields(n):
            return (n.name, sorted(n.requirements.labels().items()), repr(n.requirements), sorted(n.available.items()),
                    sorted(n.daemon_overhead.items()), [repr(p) for p in n.host_ports], sorted(n.volume_used.items()),
                    sorted(n.volume_limits.items()), repr(n.taints))

        return [fields(n) for n in residuals + pseudo]

    view = both(run)
    assert len(view) >= 4 and any(f[0].startswith("@claim-") for f in view)


# -- incremental gate ----------------------------------------------------------


@pytest.mark.parametrize("frac", ["0", "1.0"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_incremental_gate_matches_jax(corrupt, frac, monkeypatch):
    """tests/test_verify.py's scope corpus through both packages: claim 1
    stale (or not), claim 0 the touched scope. Equal violations, audit
    counts and incremental-mode observations; the audit at rate 1 widens
    the scope to the corrupted untouched claim."""
    monkeypatch.setenv("KARPENTER_TPU_VERIFY_AUDIT_FRAC", frac)

    def run(s):
        its = s.instance_types(1)
        tpl = s.encode.template_from_nodepool(s.NodePool(metadata=s.objects.ObjectMeta(name="np")), its, range(1))
        o = s.objects
        pods = [o.Pod(metadata=o.ObjectMeta(name=f"p-{i}"), spec=o.PodSpec(containers=[o.Container(requests={"cpu": 0.8})]))
                for i in range(6)]
        result = copy.deepcopy(s.Oracle().solve(pods, its, [tpl]))
        assert len(result.new_claims) >= 2
        if corrupt:
            result.new_claims[1].requests = {"cpu": 0.0}
        scope = s.verify.IncrementalScope(claim_indices={0}, node_names=set(), check_topology=False,
                                          total_claims=len(result.new_claims), total_nodes=0)

        def series(name):
            return {tuple(sorted(k.items())): (v["count"] if kind == "histogram" else v)
                    for kind, _, k, v in s.registry.REGISTRY.get(name).collect()}

        names = ("karpenter_solver_gate_audit_total", "karpenter_solver_gate_duration_seconds")
        before = {n: series(n) for n in names}
        violations = s.verify.incremental_gate(result, pods, its, [tpl], (), scope)
        moved = {n: {k: v - before[n].get(k, 0) for k, v in series(n).items() if v != before[n].get(k, 0)}
                 for n in names}
        return dict(violations=sorted((v.invariant, v.claim_index, v.node_name) for v in violations), moved=moved)

    view = both(run)
    assert bool(view["violations"]) == (corrupt and frac == "1.0")
    assert (("mode", "incremental"),) in view["moved"]["karpenter_solver_gate_duration_seconds"]
    if frac == "1.0":
        outcome = "mismatch" if corrupt else "match"
        assert view["moved"]["karpenter_solver_gate_audit_total"] == {(("outcome", outcome),): 1.0}


# -- StreamingSolver -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_stream_matches_jax(seed):
    """tests/test_streaming_parity.py:205's streams (50 pods, 6 cycles, 4
    arrivals and 3 deletes a cycle) over OracleSolver in both packages, with
    the SLO engine on: equal per-cycle views and stream-cycle records, and
    the port's stream holds the parity contract against a cold oracle."""

    def run(s):
        s.flight.set_enabled(True)
        s.slo.set_enabled(True)
        s.flight.reset()
        its, tpls = build_world(s)
        rng = random.Random(seed)
        pods = [s.churn.default_pod_factory(f"base-{i}", rng) for i in range(50)]
        cycles, solver = run_stream(s, s.Oracle(), pods, (), its, tpls, 6, seed,
                                    cold=s.Oracle() if s is PORT else None)
        records = [{k: v for k, v in r.items() if k not in ("t", "trace_id")}
                   for r in s.flight.ring().snapshot() if r["kind"] == "stream-cycle"]
        return dict(cycles=cycles, counters=dict(solver.counters), records=records)

    view = both(run)
    assert view["counters"].get("warm", 0) >= 4
    assert sum(len(c["certified"]) for c in view["cycles"] if c["outcome"] == "warm") > 0
    assert len(view["records"]) == 6


def test_torch_stream_matches_jax(monkeypatch):
    """StreamingSolver(TorchSolver(device="cpu", relax=False)) against
    StreamingSolver(JaxSolver()) with KARPENTER_TPU_RELAX=0: the warm
    sub-solve and the cold solves run the port's solve; the views are
    exact."""
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")

    def run(s):
        its, tpls = build_world(s)
        rng = random.Random(1)
        pods = [s.churn.default_pod_factory(f"base-{i}", rng) for i in range(40)]
        inner = TorchSolver(device="cpu", relax=False) if s is PORT else JaxSolver()
        cycles, solver = run_stream(s, inner, pods, (), its, tpls, 4, 1, arrivals=2, deletes=1)
        return dict(cycles=cycles, counters=dict(solver.counters))

    view = both(run)
    assert view["counters"].get("warm", 0) == 3


def test_adversarial_mix_matches_jax():
    """tests/test_streaming_parity.py:216: topology-constrained pods, existing
    nodes and ``cloud.reclaim`` firings shrinking the node set; equal views
    in both packages, and the parity contract holds."""

    def run(s):
        its, tpls = build_world(s, its_count=16)
        pods = s.workloads.make_diverse_pods(60, random.Random(9))
        nodes = [make_node(s, f"rn-{i}") for i in range(5)]
        cycles, solver = run_stream(s, s.Oracle(), pods, nodes, its, tpls, 6, 9, arrivals=3, deletes=2,
                                    spec="seed=9;cloud.reclaim=1@p0.5", cold=s.Oracle() if s is PORT else None)
        return dict(cycles=cycles, counters=dict(solver.counters))

    view = both(run)
    assert view["counters"].get("warm", 0) >= 1
    assert any(c["reclaimed"] for c in view["cycles"])


def test_warm_error_degrades_but_device_faults_propagate():
    """A host-side exception in the warm sub-solve is the ``warm-error``
    degrade (a cold solve answers); an error of the kernels or of the CUDA
    runtime propagates out of the streaming layer."""
    from karpenter_tpu_torch.kernels import KernelDeviceError

    its, tpls = build_world(PORT)
    rng = random.Random(0)
    pods = [PORT.churn.default_pod_factory(f"base-{i}", rng) for i in range(30)]

    class Failing:
        def __init__(self, error):
            self.inner, self.error = PORT.Oracle(), error

        def solve(self, pods, *args, cluster_pods=(), **kwargs):
            if cluster_pods:  # the warm sub-solve
                raise self.error
            return self.inner.solve(pods, *args, cluster_pods=cluster_pods, **kwargs)

    for error, raises in ((ValueError("host bug"), False), (KernelDeviceError("launch failed"), True),
                          (RuntimeError("CUDA error: an illegal memory access"), True)):
        solver = PORT.warm.StreamingSolver(Failing(error))
        proc = PORT.churn.ChurnProcess(list(pods), config=PORT.churn.ChurnConfig(seed=0, arrivals_per_cycle=2,
                                                                                  deletes_per_cycle=1))
        proc.step()
        solver.solve(proc.pods, its, tpls)
        assert solver.last_outcome == "cold-first"
        proc.step()
        if raises:
            with pytest.raises(type(error)):
                solver.solve(proc.pods, its, tpls)
        else:
            result = solver.solve(proc.pods, its, tpls)
            assert solver.last_outcome == "warm-error"
            assert not PORT.val.validate_result(result, proc.pods, its, tpls, level="full")


def test_warm_serve_stream_is_not_batchable():
    """A tenant whose stream is warm never rides the stacked path; a cold
    one does, and the batch layer finds the TorchSolver under both wrappers."""
    from karpenter_tpu_torch.serve import batch
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    its, tpls = build_world(PORT)
    pods = [PORT.churn.default_pod_factory(f"p-{i}", random.Random(2)) for i in range(8)]
    sup = SupervisedSolver(TorchSolver(device="cpu"), fallback=PORT.Oracle(), streaming=True)
    inner, streaming = batch._unwrap_inner(sup)
    assert isinstance(inner, TorchSolver) and streaming is sup.primary
    request = SimpleNamespace(pods=pods, templates=tpls, kwargs={})
    assert batch.batchable(request, sup)
    sup.solve(pods, its, tpls)
    assert streaming.last_outcome == "cold-first"
    assert not batch.batchable(request, sup)


def test_churn_reclaims_match_jax():
    """``cloud.reclaim`` through the shared grammar: the same nodes reclaimed
    on the same cycles in both packages."""

    def run(s):
        s.faults.install(s.faults.FaultInjector.from_spec("seed=3;cloud.reclaim=2@p0.6"))
        nodes = [make_node(s, f"n-{i}") for i in range(9)]
        pods = [s.churn.default_pod_factory(f"p-{i}", random.Random(1)) for i in range(5)]
        proc = s.churn.ChurnProcess(pods, nodes, config=s.churn.ChurnConfig(seed=3))
        return [proc.step().reclaimed for _ in range(6)]

    view = both(run)
    assert sum(len(r) for r in view) >= 4
