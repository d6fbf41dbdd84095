"""The two-phase solve: karpenter_tpu_torch's phase 1 (relax_place), its
carried repair pass (solve_ffd_sweeps_carried) and TorchSolver(relax=True)
against the JAX package's on the same inputs, on the CPU.

Both packages' inputs are drawn by the same generator code
(tests/test_torch_encode.draw). Exact: every integer and bool leaf of the
committed state, kind, index, residue_active and the stats. Float leaves
(claim_requests) within rtol 1e-5 / atol 1e-6: the same float32 adds in the
same pod order, so they agree to the bit here; the tolerance is the port's
stated bar. The waterfill level is a float64 prefix sum in the port and a
difference of float32 prefix sums in the JAX package (ops/relax.py
docstring); on these corpora no pod sits on a bin boundary, so the slots
agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.ops.ffd_sweeps import solve_ffd_sweeps_carried as j_carried
from karpenter_tpu.ops.relax import relax_place as j_relax_place
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy, state_from_numpy
from karpenter_tpu_torch.ops import ffd_sweeps
from karpenter_tpu_torch.ops import relax as t_relax
from karpenter_tpu_torch.ops.ffd_core import KIND_FAIL, initial_state, problem_bounds_free
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from tests.test_torch_encode import draw, encode_both
from tests.test_torch_ffd import assert_same_result, same_iters
from tests.test_torch_solver import assert_same_results
import tests.torch_threads  # noqa: F401  (one intra-op thread)

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-6

# (corpus, claim slots): unconstrained bulk whose ladder demotes pods, the
# diverse mix (topology groups that eligible pods record into), host ports
# and taints, existing nodes, Gt/Lt bounds, and a slot overflow
PHASE1_CASES = [
    ("homog-48", 32),
    ("diverse-280", 32),
    ("rfuzz-3", 32),
    ("rfuzz-6", 32),
    ("bounds-0-free", 32),
    ("diverse-280", 8),
]


def _problems(name, slots):
    jp, _, _, _ = encode_both(name, claim_slots=slots)
    return jp, problem_from_numpy(numpy_fields(jp), "cpu")


def assert_same_relax(jr, tr):
    for key in ("kind", "index", "residue_active"):
        np.testing.assert_array_equal(getattr(tr, key).numpy(), np.asarray(getattr(jr, key)), err_msg=key)
    assert [int(x) for x in tr.stats] == [int(x) for x in jr.stats]
    js, ts = numpy_fields(jr.state), numpy_fields(tr.state)
    assert sorted(js) == sorted(ts)
    for key in js:
        if js[key].dtype.kind == "f":
            np.testing.assert_allclose(ts[key], js[key], rtol=FLOAT_RTOL, atol=FLOAT_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(ts[key], js[key], err_msg=key)


def carry_from_jax(jr):
    """(state, kind, index) of the JAX package's phase-1 result as CPU
    tensors: the carry the port's repair pass starts from."""
    return (state_from_numpy(numpy_fields(jr.state), "cpu"),
            torch.from_numpy(np.array(jr.kind)), torch.from_numpy(np.array(jr.index)))


@pytest.mark.parametrize("name,slots", PHASE1_CASES)
def test_relax_place_parity(name, slots):
    jp, tp = _problems(name, slots)
    jr = j_relax_place(jp, slots)
    tr = t_relax.relax_place(tp, slots)
    assert_same_relax(jr, tr)
    stats = tr.stats
    assert int(stats.placed) + int(stats.demoted) == int(stats.eligible)
    if name == "homog-48":  # the rounding ladder demotes, no slot overflows
        assert int(stats.demoted) > 0 and int(stats.claims) < slots
    if slots == 8:  # groups overflow the claim slots
        assert int(stats.claims) == slots and int(stats.demoted) > 0


@pytest.mark.parametrize("name,slots", [("homog-48", 32), ("diverse-280", 32), ("rfuzz-6", 32), ("diverse-280", 8)])
def test_carried_sweeps_parity(name, slots):
    """The repair pass from the JAX package's phase-1 carry, in both packages:
    kind/index exact (phase 1's rows ride through), state as above, and the
    same IterCounts, chain commits included."""
    jp, _ = _problems(name, slots)
    jr = j_relax_place(jp, slots)
    state, kind, index = carry_from_jax(jr)  # before the JAX entry donates it
    residue = dataclasses.replace(jp, pod_active=np.asarray(jr.residue_active))
    jc = j_carried(residue, slots, init=(jr.state, jr.kind, jr.index))
    tp = problem_from_numpy(numpy_fields(residue), "cpu")
    tc = ffd_sweeps.solve_ffd_sweeps_carried(tp, slots, init=(state, kind, index))
    assert_same_result(jc, tc, check_sweeps=False)
    assert int(tc.iters.sweeps) == int(jc.iters.sweeps)
    placed = kind.numpy() != KIND_FAIL
    assert placed.any()
    np.testing.assert_array_equal(tc.kind.numpy()[placed], kind.numpy()[placed])
    assert same_iters(jc.iters, tc.iters)


def test_sweeps_plain_unseeded_equals_fresh():
    """Seeds of all-KIND_FAIL / -1 give the fresh loop's result."""
    _, tp = _problems("fuzz-6", 32)
    fresh = ffd_sweeps.solve_ffd_sweeps(tp, 32)
    P = tp.num_pods
    seeded = ffd_sweeps.sweeps_plain(
        tp, initial_state(tp, 32), problem_bounds_free(tp),
        torch.full((P,), KIND_FAIL, dtype=torch.int32), torch.full((P,), -1, dtype=torch.int32),
    )
    assert torch.equal(seeded.kind, fresh.kind) and torch.equal(seeded.index, fresh.index)


# corpus -> starting claim slots (the diverse mix starts at 64, where it
# needs no escalation: one phase-1 and one repair program per side)
SOLVER_CASES = {"homog-48": 32, "diverse-280": 64, "rfuzz-3": 32, "rfuzz-4": 32, "rfuzz-6": 32,
                "rtopo-1": 32, "chain-2000": 32}


@pytest.mark.parametrize("name", SOLVER_CASES)
def test_solver_relax_parity(name, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1")
    workload, t_workload, _ = draw(name)
    slots = SOLVER_CASES[name]
    js = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=slots)
    jr = js.solve(*workload)
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=slots, device="cpu")
    assert ts.relax
    tr = ts.solve(*t_workload)
    assert_same_results(jr, tr)
    assert ts.last_relax == js.last_relax
    assert ts.relax_fallbacks == js.relax_fallbacks == 0
    assert ts.claim_escalations == js.claim_escalations
    if name in ("homog-48", "diverse-280"):
        assert ts.last_relax["placed"] > 0
        assert ts.last_iters.sweeps == js.last_iters.sweeps
        assert same_iters(js.last_iters, ts.last_iters)
        assert tr.verify_ctx is not None


def test_relax_off_reports_nothing():
    workload = draw("homog-48")[1]
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    r = ts.solve(*workload)
    assert ts.last_relax is None and ts.relax_fallbacks == 0
    assert r.num_scheduled() == len(workload[0])


def test_gate_rejection_resolves_with_relax_off(monkeypatch):
    """A two-phase result the gate rejects is re-solved with relaxation off:
    the solver counts one fallback and returns the relax-off placements."""
    from karpenter_tpu_torch import verify

    calls = []

    def reject_first(result, *args, **kwargs):
        calls.append(result)
        return ["forced violation"] if len(calls) == 1 else []

    monkeypatch.setattr(verify, "gate_relaxed", reject_first)
    workload = draw("homog-48")[1]
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu")
    r = ts.solve(*workload)
    assert len(calls) == 1  # the relax-off re-solve is not gated again
    assert ts.relax_fallbacks == 1 and ts.last_relax is None
    ref = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(*workload)
    assert [(c.template_index, c.pod_indices) for c in r.new_claims] == [
        (c.template_index, c.pod_indices) for c in ref.new_claims
    ]
    assert r.failures == ref.failures


@pytest.mark.slow
def test_solver_relax_parity_north_star(monkeypatch):
    """The 10k north-star batch (chip_smoke.py's main path) through both
    backends with the two-phase solve on: the same phase-1 counts, claims,
    placements and failures. Tens of minutes on the CPU, so outside tier-1."""
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1")
    from tests.test_torch_encode import reference_workloads
    from karpenter_tpu_torch.testing import workloads

    js = JaxSolver(initial_claim_slots=128)
    jr = js.solve(*reference_workloads.diverse_workload(10000, 400, seed=42))
    ts = TorchSolver(initial_claim_slots=128, device="cpu")
    tr = ts.solve(*workloads.diverse_workload(10000, 400, seed=42))
    assert ts.last_relax == js.last_relax
    assert ts.claim_escalations == js.claim_escalations
    assert tr.num_scheduled() == jr.num_scheduled() == 10000
    assert_same_results(jr, tr)
