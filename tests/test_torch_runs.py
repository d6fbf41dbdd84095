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
