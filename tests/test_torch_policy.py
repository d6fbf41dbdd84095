"""The learned order (KARPENTER_TPU_ORDER_POLICY, program 6): karpenter_tpu_torch's
lane scorer, host tie-break, policy sweeps solves and weights artifact
against the JAX package's, on the CPU.

Both packages' inputs are drawn by the same generator code
(tests/test_torch_encode). The feature columns that count (fan-outs,
ports, tolerations, groups, chain bits) are exact; the log1p columns and the
scores within atol 1e-6 (the two packages' log1p and dot products may round
differently). The orders, placements and IterCounts that the scores decide
are exact.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.ops import policy as j_policy
from karpenter_tpu.ops.ffd import solve_ffd_sweeps_carried_policy as j_carried_policy
from karpenter_tpu.ops.ffd import solve_ffd_sweeps_policy as j_sweeps_policy
from karpenter_tpu.ops.relax import relax_place as j_relax_place
from karpenter_tpu.solver import encode as j_encode
from karpenter_tpu.solver import ordering as j_ordering
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch.metrics.registry import ORDER_POLICY_LOADS, ORDER_POLICY_SOLVES
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy
from karpenter_tpu_torch.ops import ffd_sweeps, policy
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver import ordering
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.utils.persist import write_framed
from tests.test_torch_encode import draw, encode_both
from tests.test_torch_ffd import assert_same_result
from tests.test_torch_relax import carry_from_jax
from tests.test_torch_solver import assert_same_results
import tests.torch_threads  # noqa: F401  (one intra-op thread)

REPO = Path(__file__).resolve().parent.parent
LOG1P_COLUMNS = (0, 1)
ATOL = 1e-6

# a lane head with every column weighted (the committed head leaves some at 0)
LANE_W = [0.5, -0.25, 0.1, -0.4, 0.2, 0.3, -0.1, 0.15, -0.2, 0.05]
HOST_VECS = (
    [0, 0, 0, 0, 0, 0, 0, -1.0, -1.0, 0],
    [0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 0],
    [0.3, -0.2, 0.1, 0.4, -0.1, 0.2, -0.3, 0.5, -0.4, 0.1],
)


@pytest.fixture(autouse=True)
def _clean_policy_state(monkeypatch):
    """Each test starts with the flags off, no override and cold caches in
    both packages, and leaves them so."""
    for mod in (ordering, j_ordering):
        mod.reset_for_tests()
        for name in (mod.FLAG, mod.LANES_FLAG, mod.WEIGHTS_ENV):
            monkeypatch.delenv(name, raising=False)
    yield
    ordering.reset_for_tests()
    j_ordering.reset_for_tests()


def _override(monkeypatch, weights):
    """The same weights in force in both packages."""
    ours = json.loads(json.dumps(weights))
    monkeypatch.setattr(ordering, "active_weights", lambda: ours)
    j_ordering.set_override(json.loads(json.dumps(weights)))


def _weights(host_w=None, lane_w=None, hidden=None):
    w = ordering.builtin_weights()
    if host_w is not None:
        w["host"]["w"] = [float(x) for x in host_w]
    if lane_w is not None:
        w["lane"]["w"] = [float(x) for x in lane_w]
    if hidden is not None:
        w["arch"] = "mlp"
        w["lane"]["hidden"] = hidden
    return w


def _mlp_lane(seed=3, units=4):
    rng = np.random.default_rng(seed)
    hidden = {"w": rng.normal(size=(units, policy.N_LANE_FEATURES)).tolist(), "b": rng.normal(size=units).tolist()}
    return _weights(lane_w=rng.normal(size=units).tolist(), hidden=hidden)


def _problems(name, slots=32):
    jp, _, tp, _ = encode_both(name, claim_slots=slots)
    return jp, problem_from_numpy(numpy_fields(tp), "cpu")


@pytest.mark.parametrize("name", ["diverse-280", "chain-2003", "topology-3", "fuzz-6", "bounds-0"])
def test_lane_features_and_scores_parity(name):
    jp, tp = _problems(name)
    jf = np.asarray(j_policy.lane_features(jp))
    tf = policy.lane_features(tp).numpy()
    assert jf.shape == tf.shape == (tp.num_pods, policy.N_LANE_FEATURES)
    counts = [c for c in range(policy.N_LANE_FEATURES) if c not in LOG1P_COLUMNS]
    np.testing.assert_array_equal(tf[:, counts], jf[:, counts])
    np.testing.assert_allclose(tf[:, LOG1P_COLUMNS], jf[:, LOG1P_COLUMNS], rtol=0, atol=ATOL)
    for weights in (ordering.active_weights(), _weights(lane_w=LANE_W), _mlp_lane()):
        head = ordering._head_static(weights["lane"])
        js = np.asarray(j_policy.lane_scores(jp, head))
        np.testing.assert_allclose(policy.lane_scores(tp, head).numpy(), js, rtol=0, atol=ATOL)
    assert policy.LANE_FEATURE_VERSION == j_policy.LANE_FEATURE_VERSION


@pytest.mark.parametrize("seed", range(4))
def test_host_order_parity(seed, monkeypatch):
    """The host tie-break with the flag on: the same features and the same
    ffd_order in both packages, for the committed head and for probes."""
    from tests.test_torch_encode import reference_workloads
    from karpenter_tpu_torch.testing import workloads

    jpods, tpods = reference_workloads.chain_workload(5000 + seed)[0], workloads.chain_workload(5000 + seed)[0]
    for mod in (ordering, j_ordering):
        monkeypatch.setenv(mod.FLAG, "1")
    np.testing.assert_array_equal(ordering.host_features(tpods), j_ordering.host_features(jpods))
    before = ORDER_POLICY_SOLVES.value({"part": "host"})
    assert t_encode.ffd_order(tpods) == j_encode.ffd_order(jpods)
    assert ORDER_POLICY_SOLVES.value({"part": "host"}) == before + 1
    _override(monkeypatch, _weights(host_w=HOST_VECS[seed % len(HOST_VECS)]))
    assert t_encode.ffd_order(tpods) == j_encode.ffd_order(jpods)


@pytest.mark.parametrize("name,lane", [("diverse-280", "committed"), ("chain-2003", "probe"),
                                       ("topology-3", "probe")])
def test_policy_sweeps_parity(name, lane, monkeypatch):
    """The scored sweeps solve and its carried twin (from the JAX package's
    phase 1) against the JAX package's policy entries: kind, index, state
    and IterCounts."""
    if lane == "probe":
        _override(monkeypatch, _weights(lane_w=LANE_W))
    jp, tp = _problems(name)
    scores = policy.lane_scores(tp, ordering.lane_weights_static())
    assert_same_result(j_sweeps_policy(jp, 32), ffd_sweeps.solve_ffd_sweeps(tp, 32, order_scores=scores))
    jr = j_relax_place(jp, 32)
    if int(jr.stats.placed) > 0:
        carry = carry_from_jax(jr)  # before the JAX entry donates it
        residue = dataclasses.replace(jp, pod_active=np.asarray(jr.residue_active))
        jc = j_carried_policy(residue, 32, init=(jr.state, jr.kind, jr.index))
        tc = ffd_sweeps.solve_ffd_sweeps_carried(
            problem_from_numpy(numpy_fields(residue), "cpu"), 32, init=carry, order_scores=scores)
        assert_same_result(jc, tc)


@pytest.mark.parametrize("name,relax", [("diverse-280", False), ("diverse-280", True), ("fuzz-6", False),
                                        ("homog-48", True), ("rfuzz-3", True)])
def test_solver_policy_parity(name, relax, monkeypatch):
    """Whole solves with the flag on (committed artifact): the same
    placements, IterCounts and phase-1 counts, and the lane solves counted
    as the JAX backend counts them."""
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1" if relax else "0")
    for mod in (ordering, j_ordering):
        monkeypatch.setenv(mod.FLAG, "1")
    workload, t_workload, _ = draw(name)
    slots = 64 if name == "diverse-280" else 32
    js = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=slots)
    jr = js.solve(*workload)
    before = ORDER_POLICY_SOLVES.value({"part": "lane"})
    ts = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=slots, device="cpu", relax=relax)
    tr = ts.solve(*t_workload)
    assert_same_results(jr, tr)
    assert tuple(int(x) for x in js.last_iters) == tuple(ts.last_iters)
    assert ts.last_relax == js.last_relax
    lanes = ORDER_POLICY_SOLVES.value({"part": "lane"}) - before
    assert lanes == (2 if ts.last_relax is not None else 1)


@pytest.mark.parametrize("name", ["diverse-280", "chain-2003"])
def test_zero_weights_give_the_static_order(name, monkeypatch):
    """The zero head (every artifact failure's target): ffd_order and the
    policy sweeps solve are the static ones, byte for byte."""
    from karpenter_tpu_torch.testing import workloads

    pods = workloads.chain_workload(4100)[0]
    static = t_encode.ffd_order(pods)
    monkeypatch.setenv(ordering.FLAG, "1")
    monkeypatch.setattr(ordering, "active_weights", ordering.builtin_weights)
    assert t_encode.ffd_order(pods) == static
    _, tp = _problems(name)
    r0 = ffd_sweeps.solve_ffd_sweeps(tp, 32)
    r1 = ffd_sweeps.solve_ffd_sweeps(tp, 32, order_scores=policy.lane_scores(tp, ordering.lane_weights_static()))
    assert torch.equal(r0.kind, r1.kind) and torch.equal(r0.index, r1.index)
    assert tuple(r0.iters) == tuple(r1.iters)


def test_artifact_bytes_equal_the_reference():
    ours = Path(ordering.artifact_path())
    assert ours.parent == REPO / "karpenter_tpu_torch" / "solver"
    assert ours.read_bytes() == (REPO / "karpenter_tpu" / "solver" / "order_policy.v1.bin").read_bytes()
    before = ORDER_POLICY_LOADS.value({"outcome": "loaded"})
    weights = ordering.active_weights()
    assert ORDER_POLICY_LOADS.value({"outcome": "loaded"}) == before + 1
    assert weights == j_ordering.active_weights()
    assert ordering.lane_weights_static() == j_ordering.lane_weights_static()


def _payload(**over):
    weights = ordering.builtin_weights()
    weights.update(over)
    return json.dumps(weights).encode()


@pytest.mark.parametrize("damage,outcome", [
    ("missing", "missing"),
    ("magic", "corrupt"),
    ("truncated", "truncated"),
    ("checksum", "checksum"),
    ("json", "corrupt"),
    ("feature-version", "version-skew"),
])
def test_corrupt_artifact_degrades_to_zero_weights(damage, outcome, tmp_path, monkeypatch):
    path = tmp_path / "weights.bin"
    if damage != "missing":
        payload = b"{not json" if damage == "json" else _payload(
            feature_version=2 if damage == "feature-version" else 1)
        write_framed(str(path), payload, kind=ordering.WEIGHTS_KIND, version=ordering.WEIGHTS_VERSION)
        blob = path.read_bytes()
        if damage == "magic":
            blob = b"X" + blob[1:]
        elif damage == "truncated":
            blob = blob[:-4]
        elif damage == "checksum":
            blob = blob[:-2] + bytes([blob[-2] ^ 1]) + blob[-1:]
        path.write_bytes(blob)
    monkeypatch.setenv(ordering.WEIGHTS_ENV, str(path))
    before = ORDER_POLICY_LOADS.value({"outcome": outcome})
    assert ordering.active_weights() == ordering.builtin_weights()
    assert ORDER_POLICY_LOADS.value({"outcome": outcome}) == before + 1


def test_device_world_stands_down_with_order_policy(monkeypatch):
    """The resident path has no requeue scorer: with the lane half on every
    cycle stands down with ``order-policy`` and the ordinary solve serves it;
    with the host half alone the resident path runs."""
    from karpenter_tpu_torch.testing import workloads

    pods, its, tpls, nodes = workloads.diverse_workload(120, 20, seed=3)
    monkeypatch.setenv(ordering.FLAG, "1")
    world = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False, device_world=True)
    r = world.solve(pods, its, tpls, nodes)
    assert world.last_world_outcome == "standdown-order-policy"
    ref = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(pods, its, tpls, nodes)
    assert [(c.template_index, c.pod_indices) for c in r.new_claims] == [
        (c.template_index, c.pod_indices) for c in ref.new_claims]
    monkeypatch.setenv(ordering.LANES_FLAG, "0")
    world.solve(pods, its, tpls, nodes)
    assert world.last_world_outcome != "standdown-order-policy"


@pytest.mark.parametrize("where", ["lane_scores", "ffd_loop"])
def test_kernel_error_on_the_policy_path_propagates_through_the_supervisor(where, monkeypatch):
    """A kernel error in the policy solve (the scorer or the scored loop) is
    neither absorbed nor failed over: the supervisor retries and raises it."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver

    calls = []

    def fault(*args, **kwargs):
        calls.append(1)
        raise kernels.KernelDeviceError(f"{where}: CUDA launch error 1")

    from karpenter_tpu_torch.solver import torch_backend

    # the names the backend's policy solve calls
    monkeypatch.setattr(torch_backend, {"lane_scores": "lane_scores", "ffd_loop": "solve_ffd_sweeps"}[where], fault)
    monkeypatch.setenv(ordering.FLAG, "1")
    sup = SupervisedSolver(TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False),
                           fallback=OracleSolver(), retries=1, backoff_base_s=0.0)
    with pytest.raises(kernels.KernelDeviceError):
        sup.solve(*draw("fuzz-6")[1][:4])
    assert len(calls) == 2 and sup.counters["solve_fallbacks"] == 0
