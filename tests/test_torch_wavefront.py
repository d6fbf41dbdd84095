"""The wavefront (``KARPENTER_TPU_WAVEFRONT``): the port's plain sweeps loop
against the JAX package's, exactly.

After each narrow iteration the JAX package's ``_wave_extend``
(ops/ffd_sweeps.py:473) acts on up to W - 1 further chain heads, each gated
by proofs that its verdict equals the sequential one. The port's plain
version is ops/ffd_chain.py ``wave`` (the kernel, csrc/wave.cuh, is held to
it on the card: tests/test_torch_kernels.py and chip_smoke.py). On the same
padded problem both packages must agree, with no tolerance, on every row's
kind and index, all seven IterCounts fields and the width histogram
``wave_hist``; the state's leaves are compared bit for bit too. The corpora
are tests/test_wavefront_parity.py's (``wave_workload``), and the flag-on
placements must equal the flag-off ones.

Beyond the loop: the carried entry from a phase-1 carry, the scored
(learned-order) entry, the backend's ``last_iters``/``last_wave_hist``, one
resident (DeviceWorld) cycle and one partitioned solve under the flag, all
against the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as J_FAKE_LABELS
from karpenter_tpu.ops.ffd_sweeps import solve_ffd_sweeps as j_sweeps
from karpenter_tpu.ops.ffd_sweeps import solve_ffd_sweeps_carried as j_carried
from karpenter_tpu.ops.ffd_sweeps import solve_ffd_sweeps_policy as j_sweeps_policy
from karpenter_tpu.ops.relax import relax_place as j_relax_place
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy
from karpenter_tpu_torch.ops import ffd_sweeps, policy
from karpenter_tpu_torch.solver import ordering
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from tests.test_torch_encode import WORKLOADS, draw, encode_both
from tests.test_torch_relax import carry_from_jax
from tests.test_torch_solver import assert_same_results
import tests.torch_threads  # noqa: F401  (one intra-op thread)

SLOTS = 128
# (corpus, extra lanes, byte chains): tests/test_wavefront_parity.py's tier-1
# cases — seeds 4000-4002 at three extra lanes, width one, byte identity
CASES = [("wave-4000", 3, False), ("wave-4001", 3, False), ("wave-4002", 3, False),
         ("wave-4100", 1, False), ("wave-4200", 3, True)]
for _seed in (4000, 4001, 4002, 4004, 4100, 4200):
    WORKLOADS[f"wave-{_seed}"] = (lambda s: lambda m: m.wave_workload(s))(_seed)


def _problems(name, byte=False, slots=SLOTS):
    jp, _, tp, _ = encode_both(name, claim_slots=slots)
    if byte:
        jp = dataclasses.replace(jp, pod_eqprev_chain=jp.pod_eqprev)
        tp = dataclasses.replace(tp, pod_eqprev_chain=tp.pod_eqprev)
    return jp, problem_from_numpy(numpy_fields(tp), "cpu")


def assert_same_wave(jr, tr):
    """Kinds, indices, all seven IterCounts, wave_hist, and every state leaf
    bit for bit."""
    np.testing.assert_array_equal(np.asarray(jr.kind), tr.kind.numpy())
    np.testing.assert_array_equal(np.asarray(jr.index), tr.index.numpy())
    assert tuple(int(x) for x in jr.iters) == tuple(int(x) for x in tr.iters)
    assert (jr.wave_hist is None) == (tr.wave_hist is None)
    if tr.wave_hist is not None:
        assert np.asarray(jr.wave_hist).tolist() == tr.wave_hist.tolist()
    js, ts = numpy_fields(jr.state), numpy_fields(tr.state)
    for key in js:
        a, b = js[key], ts[key]
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=key)


# the case also solved with the flag off
OFF_CASE = "wave-4000"


@pytest.fixture(scope="module")
def solved():
    """Per case: the JAX result with the wavefront and the port's (and for
    OFF_CASE the port's without it)."""
    out = {}
    for name, lanes, byte in CASES:
        jp, tp = _problems(name, byte)
        out[name] = (j_sweeps(jp, SLOTS, wavefront=lanes),
                     ffd_sweeps.solve_ffd_sweeps(tp, SLOTS, wavefront=lanes),
                     ffd_sweeps.solve_ffd_sweeps(tp, SLOTS, wavefront=0) if name == OFF_CASE else None)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_wavefront_parity(solved, name):
    jr, tr, _ = solved[name]
    assert_same_wave(jr, tr)


def test_wavefront_places_as_flag_off(solved):
    """The flag-on placements are the flag-off ones, in fewer iterations."""
    _, tr, off = solved[OFF_CASE]
    assert torch.equal(tr.kind, off.kind) and torch.equal(tr.index, off.index)
    assert tr.iters.narrow < off.iters.narrow and tr.iters.sweeps == off.iters.sweeps
    assert off.wave_hist is None and tuple(off.iters)[4:] == (0, 0, 0)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_width_histogram_accounting(solved, name):
    """tests/test_wavefront_parity.py's guards: the histogram sums to the
    narrow iterations, its bin 0 stays 0, and the width beyond the first
    lane is the placements plus the batched failures."""
    lanes = {c[0]: c[1] for c in CASES}[name]
    _, tr, _ = solved[name]
    hist = tr.wave_hist.numpy()
    assert hist.shape == (lanes + 2,)
    assert int(hist.sum()) == tr.iters.narrow and int(hist[0]) == 0
    extra = int((hist * np.arange(lanes + 2)).sum()) - tr.iters.narrow
    assert extra == tr.iters.wave_commits + tr.iters.retry_lanes
    assert tr.iters.wave_pods >= tr.iters.wave_commits


def test_lanes_fire(solved):
    """Across the three seeds the extra lanes both place and batch failed
    chains (otherwise parity would hold trivially)."""
    seeds = ("wave-4000", "wave-4001", "wave-4002")
    assert sum(solved[n][1].iters.wave_commits for n in seeds) > 0
    assert sum(solved[n][1].iters.retry_lanes for n in seeds) > 0


def test_carried_entry_parity():
    """The repair pass from the JAX package's phase-1 carry, flag on."""
    jp, tp = _problems("wave-4001")
    jr = j_relax_place(jp, SLOTS)
    assert int(jr.stats.placed) > 0
    carry = carry_from_jax(jr)  # before the JAX entry donates it
    residue = dataclasses.replace(jp, pod_active=np.asarray(jr.residue_active))
    jc = j_carried(residue, SLOTS, init=(jr.state, jr.kind, jr.index), wavefront=3)
    tc = ffd_sweeps.solve_ffd_sweeps_carried(problem_from_numpy(numpy_fields(residue), "cpu"), SLOTS,
                                             init=carry, wavefront=3)
    assert_same_wave(jc, tc)


def test_scored_entry_parity(monkeypatch):
    """The learned order's entry (the committed weights), flag read from the
    environment as the JAX entry reads it."""
    monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT", "1")
    monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT_WIDTH", "3")
    jp, tp = _problems("wave-4004")
    scores = policy.lane_scores(tp, ordering.lane_weights_static())
    jr = j_sweeps_policy(jp, SLOTS)
    tr = ffd_sweeps.solve_ffd_sweeps(tp, SLOTS, order_scores=scores)
    assert tr.wave_hist is not None and tr.wave_hist.shape == (4,)
    assert_same_wave(jr, tr)


def test_flag_read_per_call(monkeypatch):
    for value, width, lanes in (("0", "4", 0), ("1", None, 3), ("1", "2", 1), ("1", "1", 0)):
        monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT", value)
        if width is None:
            monkeypatch.delenv("KARPENTER_TPU_WAVEFRONT_WIDTH", raising=False)
        else:
            monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT_WIDTH", width)
        assert ffd_sweeps.wavefront_lanes() == lanes


@pytest.mark.parametrize("flag", ["1", "0"])
def test_backend_iters_and_hist(flag, monkeypatch):
    """TorchSolver against JaxSolver on a batch that takes the sweeps path
    (no relaxable preferences): results, last_iters and last_wave_hist."""
    monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT", flag)
    jw, tw, _ = draw("wave-4000")
    for pods in (jw[0], tw[0]):  # no preference to relax: one sweeps solve
        for pod in pods:
            for c in pod.spec.topology_spread_constraints:
                c.when_unsatisfiable = "DoNotSchedule"
    js = JaxSolver(well_known=J_FAKE_LABELS)
    jr = js.solve(*jw)
    ts = TorchSolver(device="cpu", well_known=FAKE_WELL_KNOWN_LABELS,
                     relax=os.environ.get("KARPENTER_TPU_RELAX", "1") != "0")
    tr = ts.solve(*tw)
    assert_same_results(jr, tr)
    assert tuple(ts.last_iters) == tuple(int(x) for x in js.last_iters)
    assert ts.last_wave_hist == js.last_wave_hist
    if flag == "0":
        assert ts.last_wave_hist is None and tuple(ts.last_iters)[4:] == (0, 0, 0)
    else:
        assert len(ts.last_wave_hist) == 5 and sum(ts.last_wave_hist) == ts.last_iters.narrow


def test_device_world_cycle(monkeypatch):
    """Two resident cycles (adopt, patch) under the flag against the JAX
    package's resident path: results, IterCounts and histograms."""
    from tests.test_torch_world import _catalog, _stream

    monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT", "1")
    monkeypatch.setenv("KARPENTER_TPU_DEVICE_WORLD", "1")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")
    its, tpls = _catalog("port")
    jits, jtpls = _catalog("jax")
    dw = TorchSolver(device="cpu", relax=False, device_world=True)
    js = JaxSolver()
    outcomes = []
    for (pods, nodes, _), (jpods, jnodes, _) in list(zip(_stream("port"), _stream("jax")))[:2]:
        tr = dw.solve(pods, its, tpls, nodes=nodes)
        jr = js.solve(jpods, jits, jtpls, nodes=jnodes)
        assert_same_results(jr, tr)
        assert tuple(dw.last_iters) == tuple(int(x) for x in js.last_iters)
        assert dw.last_wave_hist == js.last_wave_hist and dw.last_wave_hist is not None
        outcomes.append((dw.last_world_outcome, js._device_world.last_outcome))
    assert [o for o, _ in outcomes] == [j for _, j in outcomes] == ["adopt-first-encode", "patched"]


def test_sharded_solve(monkeypatch):
    """One partitioned solve under the flag (tests/test_torch_shard.py's
    setup): equal results, last_shard and per-lane verdicts and IterCounts."""
    from tests.test_torch_shard import _both, assert_same_shard

    r = _both(lambda m: m.shard_topology_workload(1), KARPENTER_TPU_WAVEFRONT="1")
    assert r.ts.last_shard["reason"] is None and r.ts.last_shard["wavefront"] == 3
    assert_same_shard(r.js, r.ts)
    assert_same_results(r.jr, r.tr)
    assert r.ts.last_iters is None and r.ts.last_wave_hist is None
    assert len(r.tlanes) == len(r.jlanes) >= 1
    fired = 0
    for (_, results), (jkind, jindex, jiters) in zip(r.tlanes, r.jlanes):
        for b, res in enumerate(results):
            np.testing.assert_array_equal(res.kind.numpy(), jkind[b])
            np.testing.assert_array_equal(res.index.numpy(), jindex[b])
            assert tuple(res.iters) == tuple(it[b] for it in jiters)
            fired += res.iters.wave_commits + res.iters.retry_lanes
    assert fired > 0
