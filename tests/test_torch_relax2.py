"""The convex phase 1 (KARPENTER_TPU_RELAX2, program 17): karpenter_tpu_torch's
relax2_place and TorchSolver against the JAX package's on the same inputs,
on the CPU.

Both packages' inputs are drawn by the same generator code
(tests/test_torch_encode.reference_workloads). Exact: kind, index,
residue_active, every integer and bool leaf of the committed state and every
integer of Relax2Stats. Floats within rtol 1e-5 / atol 1e-6: the committed
claim requests, and the last trip's max |dX| (``residual``) and the final
overload (``capviol``), whose float32 adds the two packages may order
differently (ops/relax2.py docstring).

The standdowns follow tests/test_relax2.py: each reason reproduced on its
own input or by the same surgical injection, the result being the one the
solve gives with the flag off. An error of the kernels inside the phase is
no standdown: it propagates, through the supervisor too.
"""

import sys

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.ops import relax2 as j_relax2
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.metrics.registry import RELAX_FALLBACK
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy
from karpenter_tpu_torch.ops import relax2
from karpenter_tpu_torch.ops.ffd_core import KIND_CLAIM, KIND_NEW_CLAIM
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import workloads as port_workloads
from tests.test_torch_encode import reference_workloads
from tests.test_torch_relax import assert_same_relax
from tests.test_torch_solver import assert_same_results
import tests.torch_threads  # noqa: F401  (one intra-op thread)

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-6
KNOBS = ("KARPENTER_TPU_RELAX2", "KARPENTER_TPU_RELAX2_ITERS", "KARPENTER_TPU_RELAX2_STEP",
         "KARPENTER_TPU_RELAX2_TOL")

# tests/test_relax2.py's corpora: the generic fuzz seeds 22000+0..4, the
# topology seeds 23000+0..3, the 48-pod bulk and the 32-pod accounting batch
CORPORA = {
    **{f"r2fuzz-{s}": (lambda s: lambda m: m.relax2_fuzz_workload(s))(s) for s in range(5)},
    **{f"r2topo-{s}": (lambda s: lambda m: m.relax2_topology_workload(s))(s) for s in range(4)},
    "bulk-48": lambda m: m.homogeneous_workload(48),
    "accounting-32": lambda m: m.accounting_workload(),
}


def draw(name):
    """(JAX-package workload, port workload) drawn by the same code."""
    return CORPORA[name](reference_workloads), CORPORA[name](port_workloads)


@pytest.fixture
def knobs(monkeypatch):
    """Set relax2 knobs for a test; everything else of them unset."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def set_(**env):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)

    return set_


def _encode_both(name, slots=32):
    from karpenter_tpu.apis import labels as wk
    from karpenter_tpu.ops.padding import pad_problem
    from karpenter_tpu.provisioning.topology import Topology
    from karpenter_tpu.solver.encode import Encoder, domains_from_instance_types
    from karpenter_tpu_torch.ops.padding import pad_problem as t_pad
    from karpenter_tpu_torch.provisioning.topology import Topology as TTopology
    from karpenter_tpu_torch.solver.encode import Encoder as TEncoder
    from karpenter_tpu_torch.solver.encode import domains_from_instance_types as t_domains

    (pods, its, tpls, nodes), (tpods, tits, ttpls, tnodes) = draw(name)
    topo = Topology(domains_from_instance_types(its, tpls), batch_pods=pods, cluster_pods=[])
    ttopo = TTopology(t_domains(tits, ttpls), batch_pods=tpods, cluster_pods=[])
    for n, tn in zip(nodes, tnodes):
        topo.register(wk.LABEL_HOSTNAME, n.name)
        ttopo.register(wk.LABEL_HOSTNAME, tn.name)
    jp = Encoder(FAKE_WELL_KNOWN_LABELS).encode(pods, its, tpls, nodes, topology=topo, num_claim_slots=slots)
    tp = TEncoder(FAKE_WELL_KNOWN_LABELS).encode(tpods, tits, ttpls, tnodes, topology=ttopo, num_claim_slots=slots)
    return pad_problem(jp.problem), problem_from_numpy(numpy_fields(t_pad(tp.problem)), "cpu")


def assert_same_stats(js, ts):
    j = [float(x) for x in js]
    t = [float(x) for x in relax2.host_stats(ts)]
    floats = (5, 6)  # residual, capviol
    assert [x for i, x in enumerate(t) if i not in floats] == [x for i, x in enumerate(j) if i not in floats]
    np.testing.assert_allclose([t[i] for i in floats], [j[i] for i in floats], rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


@pytest.mark.parametrize("name", CORPORA)
def test_relax2_place_parity(name):
    jp, tp = _encode_both(name)
    jr = j_relax2.relax2_place(jp, 32)
    tr = relax2.relax2_place(tp, 32)
    assert_same_relax(jr._replace(stats=()), tr._replace(stats=()))
    assert_same_stats(jr.stats, tr.stats)
    stats = relax2.host_stats(tr.stats)
    assert stats.placed + stats.demoted == stats.eligible
    if name in ("bulk-48", "accounting-32"):  # the port pod is never eligible
        assert stats.placed > 0 and stats.eligible == {"bulk-48": 48, "accounting-32": 31}[name]


def _solve_both(name, relax=False, **kwargs):
    (wl, twl) = draw(name)
    js = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS)
    jr = js.solve(*wl)
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=relax, **kwargs)
    tr = ts.solve(*twl)
    return js, jr, ts, tr


def _same_record(j, t):
    """last_relax2 of both backends: equal but for the phase wall, floats
    within the stated tolerance."""
    if j is None or t is None:
        assert j is t
        return
    j = {k: v for k, v in j.items() if k != "phase_s"}
    t = {k: v for k, v in t.items() if k != "phase_s"}
    assert j.keys() == t.keys()
    for k in j:
        if isinstance(j[k], float):
            np.testing.assert_allclose(t[k], j[k], rtol=FLOAT_RTOL, atol=FLOAT_ATOL, err_msg=k)
        else:
            assert t[k] == j[k], k


@pytest.mark.parametrize("name", ["bulk-48", "accounting-32", "r2fuzz-1", "r2topo-0"])
def test_solver_relax2_parity(name, knobs):
    """Whole solves with the flag on (the JAX package's KARPENTER_TPU_RELAX=0
    is the port's relax=False): the same placements, IterCounts and phase-1
    record."""
    knobs(KARPENTER_TPU_RELAX2="1")
    js, jr, ts, tr = _solve_both(name)
    assert_same_results(jr, tr)
    _same_record(js.last_relax2, ts.last_relax2)
    if js.last_iters is None:  # relaxable pods: the per-pass solve, no phase 1
        assert ts.last_iters is None and ts.last_relax2 is None
    else:
        assert tuple(int(x) for x in js.last_iters) == tuple(ts.last_iters)
    assert ts.relax_fallbacks == js.relax_fallbacks == 0
    if name in ("bulk-48", "accounting-32"):
        info = ts.last_relax2
        assert info["reason"] is None and info["placed"] > 0
        assert info["eligible"] == info["placed"] + info["demoted"]
        assert tr.verify_ctx is not None  # the gated two-phase result


def test_relax2_flag_on_with_waterfill_allowed(knobs, monkeypatch):
    """relax=True: the convex phase comes first and the waterfill does not
    run when it serves (the JAX package with both flags on)."""
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1")
    knobs(KARPENTER_TPU_RELAX2="1")
    js, jr, ts, tr = _solve_both("bulk-48", relax=True)
    assert_same_results(jr, tr)
    assert ts.last_relax is None and js.last_relax is None
    assert ts.last_relax2["reason"] is None
    _same_record(js.last_relax2, ts.last_relax2)


# -- standdowns -----------------------------------------------------------------


def _one(name_or_workloads, knobs, **env):
    knobs(KARPENTER_TPU_RELAX2="1", **env)
    wl, twl = name_or_workloads
    js = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS)
    jr = js.solve(*wl)
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    tr = ts.solve(*twl)
    assert_same_results(jr, tr)
    _same_record(js.last_relax2, ts.last_relax2)
    return ts, tr


def _both(fn):
    return fn(reference_workloads), fn(port_workloads)


def _ports(m):
    its = m.instance_types(6)
    pods = [m.make_pod(i, cpu=0.2) for i in range(10)]
    for p in pods:
        p.spec.containers[0].ports.append(m.ContainerPort(host_port=8443, protocol="TCP"))
    return pods, its, [m.simple_template(its)], []


def _spread(m):
    its = m.instance_types(6)
    pods = [m.make_pod(i, cpu=0.2) for i in range(10)]
    for p in pods:
        p.metadata.labels = {"grp": "all-spread"}
        p.spec.topology_spread_constraints = [m.TopologySpreadConstraint(
            max_skew=1, topology_key=m.wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable="DoNotSchedule",
            label_selector=m.LabelSelector(match_labels={"grp": "all-spread"}))]
    return pods, its, [m.simple_template(its)], []


def _finite(m):
    its = m.instance_types(6)
    tpl = m.simple_template(its)
    tpl.remaining_resources = {"cpu": 6.0}
    return [m.make_pod(i, cpu=1.0) for i in range(12)], its, [tpl], []


def _node_big(m):
    its = m.instance_types(6)
    return [m.make_pod(i, cpu=0.2) for i in range(8)], its, [m.simple_template(its)], [m.make_node("node-big", cpu=16.0)]


@pytest.mark.parametrize("case,reason", [(_finite, "finite-pool"), (_ports, "ports"), (_spread, "topology"),
                                         (_node_big, "no-eligible")])
def test_standdown_on_input(case, reason, knobs):
    before = RELAX_FALLBACK.value({"reason": reason})
    ts, _ = _one(_both(case), knobs)
    assert ts.last_relax2 == {"reason": reason}
    assert RELAX_FALLBACK.value({"reason": reason}) == before + 1


def test_non_convergence_env_injection(knobs):
    """One trip, a zero tolerance and a wild step: the point still slides
    (or rounds anyway, as the JAX package allows); both packages agree."""
    its = lambda m: m.instance_types(8)  # noqa: E731
    wl = _both(lambda m: ([m.make_pod(i, cpu=0.7, mem=2e9) for i in range(24)], its(m),
                          [m.simple_template(its(m))], []))
    ts, _ = _one(wl, knobs, KARPENTER_TPU_RELAX2_ITERS="1", KARPENTER_TPU_RELAX2_STEP="50.0",
                 KARPENTER_TPU_RELAX2_TOL="0.0")
    assert ts.last_relax2["reason"] in (None, "non-convergence")


def test_non_convergence_forced(knobs, monkeypatch):
    """The host verdict forced to 'still sliding and violating': the phase
    stands down and the solve is the flag-off one."""
    monkeypatch.setattr(relax2, "converged", lambda *_: False)
    _, twl = draw("bulk-48")
    knobs()
    ref = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(*twl)
    knobs(KARPENTER_TPU_RELAX2="1")
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    r = ts.solve(*twl)
    assert ts.last_relax2["reason"] == "non-convergence"
    assert {"residual", "capviol", "pgd_iterations"} <= ts.last_relax2.keys()
    assert [(c.template_index, c.pod_indices) for c in r.new_claims] == [
        (c.template_index, c.pod_indices) for c in ref.new_claims]


def test_rounding_overflow(knobs, monkeypatch):
    real = relax2.relax2_place

    def doctored(problem, max_claims):
        r = real(problem, max_claims)
        return r._replace(stats=r.stats._replace(placed=r.stats.placed * 0, round_demoted=r.stats.eligible))

    monkeypatch.setattr(relax2, "relax2_place", doctored)
    knobs(KARPENTER_TPU_RELAX2="1")
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    r = ts.solve(*draw("bulk-48")[1])
    assert ts.last_relax2["reason"] == "rounding-overflow" and ts.last_relax2["eligible"] > 0
    assert r.num_scheduled() == 48


def test_gate_rejected_corruption_is_caught_and_resolved(knobs, monkeypatch):
    """Every phase-1 pod piled into claim slot 0, in both packages: the gate
    catches it and the batch is re-solved with the convex phase off."""
    import jax.numpy as jnp

    def pile(real, where):
        def corrupt(problem, max_claims, *rest):
            r = real(problem, max_claims, *rest)
            placed = (r.kind == KIND_NEW_CLAIM) | (r.kind == KIND_CLAIM)
            return r._replace(index=where(placed, 0, r.index))
        return corrupt

    monkeypatch.setattr(j_relax2, "relax2_place", pile(j_relax2.relax2_place, jnp.where))
    monkeypatch.setattr(relax2, "relax2_place", pile(relax2.relax2_place, lambda c, a, b: torch.where(
        c, torch.zeros_like(b), b)))
    wl = _both(lambda m: ([m.make_pod(i, cpu=2.0, mem=4e9) for i in range(32)], m.instance_types(8),
                          [m.simple_template(m.instance_types(8))], []))
    before = RELAX_FALLBACK.value({"reason": "gate-rejected"})
    ts, r = _one(wl, knobs)
    assert ts.last_relax2 == {"reason": "gate-rejected"} and ts.relax_fallbacks == 1
    assert RELAX_FALLBACK.value({"reason": "gate-rejected"}) == before + 1
    assert r.num_scheduled() == 32


def test_host_error_is_a_standdown(knobs, monkeypatch):
    def boom(problem, max_claims):
        raise RuntimeError("injected relax2 failure")

    monkeypatch.setattr(relax2, "relax2_place", boom)
    knobs(KARPENTER_TPU_RELAX2="1")
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    r = ts.solve(*draw("bulk-48")[1])
    assert ts.last_relax2["reason"] == "error" and "injected relax2 failure" in ts.last_relax2["error"]
    assert r.num_scheduled() == 48


@pytest.mark.parametrize("error", [kernels.KernelDeviceError("relax_place: CUDA launch error 1"),
                                   kernels.KernelCompileError("kernel build failed"),
                                   RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_kernel_error_propagates_through_the_supervisor(error, knobs, monkeypatch):
    """A kernel or CUDA error inside the phase is neither a standdown nor a
    fallback: the supervisor retries and raises it."""
    calls = []

    def fault(problem, max_claims):
        calls.append(1)
        raise error

    monkeypatch.setattr(relax2, "relax2_place", fault)
    knobs(KARPENTER_TPU_RELAX2="1")
    primary = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    sup = SupervisedSolver(primary, fallback=OracleSolver(), retries=1, backoff_base_s=0.0)
    before = RELAX_FALLBACK.value({"reason": "error"})
    with pytest.raises(type(error)):
        sup.solve(*draw("bulk-48")[1])
    # a device error is retried once; a build error is not (it fails again)
    assert len(calls) == (1 if isinstance(error, kernels.KernelCompileError) else 2)
    assert primary.last_relax2 is None
    assert RELAX_FALLBACK.value({"reason": "error"}) == before
    assert sup.counters["solve_fallbacks"] == 0


def test_flag_off_never_imports_and_keeps_placements(knobs):
    _, twl = draw("bulk-48")
    knobs()
    base = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(*twl)
    sys.modules.pop("karpenter_tpu_torch.ops.relax2", None)
    knobs(KARPENTER_TPU_RELAX2="0", KARPENTER_TPU_RELAX2_ITERS="7", KARPENTER_TPU_RELAX2_STEP="1.5")
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    off = ts.solve(*twl)
    assert "karpenter_tpu_torch.ops.relax2" not in sys.modules
    sys.modules["karpenter_tpu_torch.ops.relax2"] = relax2
    assert ts.last_relax2 is None and ts.relax_fallbacks == 0
    assert [(c.template_index, c.pod_indices) for c in off.new_claims] == [
        (c.template_index, c.pod_indices) for c in base.new_claims]
    assert off.failures == base.failures and off.node_pods == base.node_pods


def test_status_surfaces_last_relax2(knobs):
    knobs(KARPENTER_TPU_RELAX2="1")
    sup = SupervisedSolver(TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False))
    sup.solve(*draw("bulk-48")[1])
    status = sup.status()
    assert status["relax2"]["reason"] is None and status["relax2"]["placed"] > 0


def test_vocabulary_and_knobs_are_the_reference_ones(knobs):
    assert relax2.STANDDOWN_REASONS == j_relax2.STANDDOWN_REASONS
    for name in ("_WINDOW", "_RHO", "_GAMMA", "_BETA", "_MIN_REL_MASS", "_CAPVIOL_OK", "_SCAN_TOL"):
        assert getattr(relax2, name) == getattr(j_relax2, name), name
    knobs(KARPENTER_TPU_RELAX2="1", KARPENTER_TPU_RELAX2_ITERS="0", KARPENTER_TPU_RELAX2_STEP="0.5",
          KARPENTER_TPU_RELAX2_TOL="0.2")
    assert (relax2.pgd_iters(), relax2.pgd_step(), relax2.pgd_tol()) == (
        j_relax2.pgd_iters(), j_relax2.pgd_step(), j_relax2.pgd_tol()) == (1, 0.5, 0.2)
