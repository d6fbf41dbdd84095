"""No kernel shape limits: more than 32 label keys, more than 2,048 value
lanes.

A cluster reaches these shapes in ordinary operation: every existing node
mints a hostname value and brings its label keys. The kernels loop over keys
in strides of 32 and over value words in chunks of 64, so the functions
that assemble their arguments take any K and V (the shape cases of
tests/test_torch_kernels.py run the kernels there on the card). Here, on the
CPU: those functions accept both shapes, the plain solve equals the JAX
package's on both, and a shape the device cannot hold (shared memory per
block) is a launch the CUDA runtime refuses: a typed kernel error, which the
supervisor raises after its retries instead of answering from the oracle.
"""

import ctypes

import pytest

from karpenter_tpu.ops.ffd import solve_ffd_sweeps as j_solve_ffd_sweeps
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy
from karpenter_tpu_torch.ops import ffd_sweeps
from karpenter_tpu_torch.ops.ffd_core import initial_state
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver, device_fault
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import workloads as W
from tests.test_torch_encode import encode_both
from tests.test_torch_ffd import assert_same_result
import tests.torch_threads  # noqa: F401  (one intra-op thread)

SLOTS = 32


@pytest.mark.parametrize("name,k_min,v_min", [("wide-keys", 33, 0), ("wide-lanes", 0, 2049)])
def test_wide_problem_builds_and_solves_like_jax(name, k_min, v_min):
    jp, _, tp, _ = encode_both(name, claim_slots=SLOTS)
    assert jp.num_keys >= k_min and jp.num_lanes >= v_min
    prob = problem_from_numpy(numpy_fields(jp), "cpu")
    # the kernels' arguments assemble at this shape (no ValueError for K or V)
    t, _ = ffd_sweeps.ffd_loop_args(prob, initial_state(prob, SLOTS), one_pass=False)
    assert t["lvw"].shape == (prob.num_keys, prob.num_lanes // 32)
    jr = j_solve_ffd_sweeps(jp, SLOTS)
    tr = ffd_sweeps.solve_ffd_sweeps(prob, SLOTS)
    assert_same_result(jr, tr)
    assert (tr.kind.numpy() < 3).any() and int(tr.iters.chain_commits) > 0


class _RefusingLibrary:
    """A kernel library whose launch the CUDA runtime refuses, as it refuses
    a block that asks for more dynamic shared memory than the card lets it
    opt into (``cudaFuncSetAttribute``: ``cudaErrorInvalidValue``, 1)."""

    def __init__(self, args_size):
        self.args_size = args_size

    def ffd_loop_launch(self, args, stream):
        return 1

    def ffd_loop_args_size(self):
        return self.args_size


def _refuse_launches(monkeypatch, prob):
    _, args = ffd_sweeps.ffd_loop_args(prob, initial_state(prob, SLOTS), one_pass=False)
    monkeypatch.setattr(kernels, "library", lambda name: _RefusingLibrary(ctypes.sizeof(args)))
    return args


def test_shared_memory_beyond_the_device_is_a_kernel_error(monkeypatch):
    jp, _, _, _ = encode_both("wide-lanes", claim_slots=SLOTS)
    args = _refuse_launches(monkeypatch, problem_from_numpy(numpy_fields(jp), "cpu"))
    before = kernels.LAUNCHES["ffd_loop"]
    with pytest.raises(kernels.KernelDeviceError, match="launch error 1") as err:
        kernels.launch("ffd_loop", args, 0)
    assert device_fault(err.value) and kernels.LAUNCHES["ffd_loop"] == before


def test_supervisor_raises_a_kernel_shape_error_without_failing_over(monkeypatch):
    """A launch whose shape the device refuses raises the typed kernel error
    (a device fault): the supervisor retries it and raises it, and the oracle
    never answers."""
    pods, its, tpls, nodes = W.wide_lanes_workload()

    def refused(problem, max_claims, order_scores=None, wavefront=None, tables=None):
        _, args = ffd_sweeps.ffd_loop_args(problem, initial_state(problem, max_claims), one_pass=False)
        kernels.launch("ffd_loop", args, 0)

    jp, _, _, _ = encode_both("wide-lanes", claim_slots=SLOTS)
    _refuse_launches(monkeypatch, problem_from_numpy(numpy_fields(jp), "cpu"))
    monkeypatch.setattr("karpenter_tpu_torch.solver.torch_backend.solve_ffd_sweeps", refused)
    primary = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
    sup = SupervisedSolver(primary, fallback=OracleSolver(well_known=FAKE_WELL_KNOWN_LABELS), retries=1,
                           circuit_threshold=1, sleep_fn=lambda s: None)
    with pytest.raises(kernels.KernelDeviceError) as err:
        sup.solve(pods, its, tpls, nodes)
    assert device_fault(err.value) and not isinstance(err.value, ValueError)
    assert sup.counters["solve_retries"] == 1 and sup.counters["solve_fallbacks"] == 0
    assert sup.circuit_state() == "closed"
