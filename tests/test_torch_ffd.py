"""FFD loop parity: karpenter_tpu_torch's solve_ffd_sweeps / solve_ffd (the
plain PyTorch path, CPU tensors) against the JAX package's on the same
padded problem, carried over leaf for leaf by problem_from_numpy.

Exact: kind/index per row, every integer and bool leaf of the final FFDState,
and all four IterCounts fields (narrow iterations, sweeps, chain commits,
chain pods): both packages commit chains of chain-identical pods in the same
closed forms. The float32 leaves (claim_requests, node_requests, remaining)
are held to rtol 1e-5: the one-pass scan adds one pod at a time, and a chain
commit's ``requests + k * request`` rounds once in both packages.
"""

import numpy as np
import pytest

from karpenter_tpu.ops.ffd import solve_ffd as j_solve_ffd
from karpenter_tpu.ops.ffd import solve_ffd_sweeps as j_solve_ffd_sweeps
from karpenter_tpu.ops.ffd_core import KIND_NO_SLOT, initial_state as j_initial_state
from karpenter_tpu.ops.ffd_core import _pad_lanes_mult32 as j_pad_lanes
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy, state_from_numpy
from karpenter_tpu_torch.ops.ffd_step import solve_ffd
from karpenter_tpu_torch.ops.ffd_sweeps import solve_ffd_sweeps
from tests.test_torch_encode import encode_both
import tests.torch_threads  # noqa: F401  (one intra-op thread)

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-6

# (workload, claim slots): topology chains, existing nodes + ports + taints,
# Gt/Lt bounds, the diverse mix, a claim-slot overflow (KIND_NO_SLOT) and
# CSI attach limits on existing nodes
SWEEPS_CASES = [
    ("chain-2000", 32),
    ("chain-2003", 32),
    ("fuzz-1", 32),
    ("fuzz-6", 32),
    ("topology-3", 32),
    ("bounds-0", 32),
    ("diverse-280", 32),
    ("chain-2001", 8),
    ("volumes-0", 32),
]
SLOW_CASES = [("chain-2002", 32), ("chain-2004", 32), ("bounds-1", 32), ("topology-8", 32)]


def _problem(name, slots):
    jp, _, _, _ = encode_both(name, claim_slots=slots)
    return jp, problem_from_numpy(numpy_fields(jp), "cpu")


def assert_same_result(jr, tr, check_sweeps=True):
    np.testing.assert_array_equal(np.asarray(jr.kind), tr.kind.numpy())
    np.testing.assert_array_equal(np.asarray(jr.index), tr.index.numpy())
    js, ts = numpy_fields(jr.state), numpy_fields(tr.state)
    assert sorted(js) == sorted(ts)
    for key in js:
        a, b = js[key], ts[key]
        assert a.shape == b.shape, key
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
    if check_sweeps:
        assert int(jr.iters.sweeps) == int(tr.iters.sweeps)
        assert same_iters(jr.iters, tr.iters)


def same_iters(j_iters, t_iters) -> bool:
    """All seven IterCounts fields equal (the wavefront's are 0 with it
    off)."""
    return tuple(int(x) for x in j_iters) == tuple(int(x) for x in t_iters)


def _sweeps_case(name, slots):
    jp, tp = _problem(name, slots)
    jr = j_solve_ffd_sweeps(jp, slots)
    tr = solve_ffd_sweeps(tp, slots)
    assert_same_result(jr, tr)
    return jr


@pytest.mark.parametrize("name,slots", SWEEPS_CASES)
def test_sweeps_parity(name, slots):
    jr = _sweeps_case(name, slots)
    if slots == 8:  # more claims than slots
        assert (np.asarray(jr.kind) == KIND_NO_SLOT).any()


@pytest.mark.slow
@pytest.mark.parametrize("name,slots", SLOW_CASES)
def test_sweeps_parity_deep(name, slots):
    _sweeps_case(name, slots)


@pytest.mark.parametrize("name", ["topology-3", "bounds-0"])
def test_one_pass_parity_fresh_and_carried(name):
    """solve_ffd: one scan from a fresh state, then a second scan carrying the
    first pass's state (the backend's relax-ladder passes)."""
    jp, tp = _problem(name, 32)
    j1 = j_solve_ffd(jp, 32)
    t1 = solve_ffd(tp, 32)
    assert_same_result(j1, t1, check_sweeps=False)
    carried = numpy_fields(j1.state)  # the JAX pass donates its init state
    j2 = j_solve_ffd(jp, 32, init=j1.state)
    t2 = solve_ffd(tp, 32, init=state_from_numpy(carried, "cpu"))
    assert_same_result(j2, t2, check_sweeps=False)


def test_state_round_trip():
    """problem_from_numpy / state_from_numpy carry every leaf unchanged."""
    jp, tp = _problem("fuzz-6", 32)
    jf, tf = numpy_fields(jp), numpy_fields(tp)
    assert sorted(jf) == sorted(tf)
    for key in jf:
        assert np.array_equal(jf[key], tf[key], equal_nan=jf[key].dtype.kind == "f"), key
    js = numpy_fields(j_initial_state(j_pad_lanes(jp), 32))
    ts = numpy_fields(state_from_numpy(js, "cpu"))
    for key in js:
        assert np.array_equal(js[key], ts[key]), key
