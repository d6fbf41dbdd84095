"""Backend parity: TorchSolver(device="cpu", relax=False) against JaxSolver
with KARPENTER_TPU_RELAX=0 (tests/conftest.py pins it) on the same API
objects. The two-phase solve's parity is tests/test_torch_relax.py.

Claims (template, pod indices, instance types, requests), node placements
and failures (keys and reasons) must be equal, and so must the claim-slot
escalations. Sweeps-mode corpora (nothing relaxable) and per-pass corpora
(ScheduleAnyway spreads and preferred affinities make pods relaxable) both
run.
"""

import pytest

from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from tests.test_solver_parity import _same_requirements
from tests.test_torch_encode import draw
import tests.torch_threads  # noqa: F401  (one intra-op thread)

CASES = ["fuzz-1", "fuzz-6", "bounds-0", "diverse-280", "chain-2000", "topology-3"]
SLOW = ["chain-2003", "topology-8"]


def _solve_both(name, initial_claim_slots=32):
    workload, t_workload, pod_volumes = draw(name)
    js = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=initial_claim_slots)
    jr = js.solve(*workload, pod_volumes=pod_volumes)
    ts = TorchSolver(
        well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=initial_claim_slots, device="cpu",
        relax=False,
    )
    tr = ts.solve(*t_workload, pod_volumes=pod_volumes)
    return js, jr, ts, tr


def assert_same_results(jr, tr):
    assert len(tr.new_claims) == len(jr.new_claims)
    for jc, tc in zip(jr.new_claims, tr.new_claims):
        assert tc.template_index == jc.template_index
        assert tc.nodepool_name == jc.nodepool_name
        assert tc.pod_indices == jc.pod_indices
        assert tc.instance_type_indices == jc.instance_type_indices
        assert tc.requests.keys() == jc.requests.keys()
        for key in jc.requests:
            assert tc.requests[key] == pytest.approx(jc.requests[key], rel=1e-5)
        _same_requirements(jc.requirements, tc.requirements)
    assert tr.node_pods == jr.node_pods
    assert tr.failures == jr.failures


@pytest.mark.parametrize("name", CASES)
def test_solver_parity(name):
    js, jr, ts, tr = _solve_both(name)
    assert_same_results(jr, tr)
    assert (ts.last_iters is None) == (js.last_iters is None)
    if ts.last_iters is not None:
        assert ts.last_iters.sweeps == js.last_iters.sweeps
        assert tuple(ts.last_iters) == tuple(int(x) for x in js.last_iters)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_solver_parity_deep(name):
    _, jr, _, tr = _solve_both(name)
    assert_same_results(jr, tr)


def test_claim_slot_escalation_parity():
    """More claims than the starting slot bucket: both backends see
    KIND_NO_SLOT at the same sweep, escalate the same number of times and
    land on the same placements."""
    js, jr, ts, tr = _solve_both("chain-2001", initial_claim_slots=8)
    assert js.claim_escalations > 0
    assert ts.claim_escalations == js.claim_escalations
    assert ts.claim_slots == js.claim_slots
    assert_same_results(jr, tr)


def test_csi_attach_limit_parity():
    _, jr, _, tr = _solve_both("volumes-0")
    assert jr.node_pods
    assert_same_results(jr, tr)


# -- the solve's trace spans (ROADMAP C8) ----------------------------------------

# Span names only one package opens, and why. The JAX package names the first
# dispatch of a program in a process ``compile`` (its XLA trace and compile),
# with the program in the span's attributes; the port's kernels build once per
# process outside any solve, so the port names that dispatch as every other:
# the name the JAX package gives the program's later dispatches.
JAX_COMPILE_SPAN = {
    "relax_place": "relax", "relax2_place": "relax2", "verify_gate": "gate_program",
    "solve_ffd_sweeps": "sweeps", "solve_ffd_sweeps_carried": "sweeps", "solve_ffd": "narrow",
    "solve_ffd_runs": "narrow", "patch_world": "patch", "solve_ffd_fused_gate": "fused",
}


def span_tree(node, jax: bool = False):
    """(name, children) of a published trace's span, the JAX package's
    ``compile`` spans renamed by JAX_COMPILE_SPAN."""
    name = node["name"]
    if jax and name == "compile":
        name = JAX_COMPILE_SPAN[node["attrs"]["program"]]
    return (name, tuple(span_tree(c, jax) for c in node.get("children", ())))


def traced(trace, run):
    """The span trees of the cycles ``run`` publishes, oldest first."""
    trace.set_enabled(True)
    trace.reset_ring()
    try:
        run()
        return [span_tree(t["root"], jax=trace.__name__.startswith("karpenter_tpu.")) for t in
                reversed(trace.ring().snapshot())]
    finally:
        trace.set_enabled(None)
        trace.reset_ring()


@pytest.mark.parametrize("case", ["default", "relax-off", "relax2", "supervised"])
def test_solve_span_trees_match_jax(case, monkeypatch):
    """One traced solve of fuzz-6 in each package: the two-phase default, the
    plain sweeps solve (``relax=False`` / ``KARPENTER_TPU_RELAX=0``), the
    convex phase 1 (``KARPENTER_TPU_RELAX2=1``) and a solve under the
    supervisor, whose gate opens ``gate`` / ``gate_program``: equal span
    names and nesting."""
    from karpenter_tpu.obs import trace as j_trace
    from karpenter_tpu.solver.oracle import OracleSolver as JOracle
    from karpenter_tpu.solver.supervisor import SupervisedSolver as JSupervised
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as T_LABELS
    from karpenter_tpu_torch.obs import trace as t_trace
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver

    relax = case in ("default", "relax2")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1" if relax else "0")
    if case == "relax2":
        monkeypatch.setenv("KARPENTER_TPU_RELAX2", "1")
    workload, t_workload, _ = draw("fuzz-6")
    js = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS)
    ts = TorchSolver(well_known=T_LABELS, device="cpu", relax=relax)
    if case == "supervised":
        js = JSupervised(js, fallback=JOracle(), validate="full")
        ts = SupervisedSolver(ts, fallback=OracleSolver(), validate="full")
    jt = traced(j_trace, lambda: js.solve(*workload))
    tt = traced(t_trace, lambda: ts.solve(*t_workload))
    assert tt == jt and len(tt) == 1
    names = str(tt)
    for stage in ("encode", "bucket", "sweeps", "decode"):
        assert f"'{stage}'" in names
    assert ("'relax'" in names) == (case == "default")
    assert ("'relax2'" in names) == (case == "relax2")
    assert ("'gate_program'" in names) == (case != "relax-off")
