"""Consolidation screen parity: karpenter_tpu_torch's UnionScorer (plain
PyTorch on the CPU) against the JAX package's on the bench cluster, each
built by its own package's build_bench_scorer from the same seed (the
encoders intern label values in set-iteration order, so both sides are
drawn, not copied).

  - verdicts equal field for field (verdict_key of tests/test_screen_delta.py)
    on the residual (delta) path, on the full path, on the spread corpus
    (the batch stands down to the full screen: three passes, a topology
    run) and on the filled-survivor corpus, whose lanes open new claims;
  - the raw screens equal the JAX programs on the same padded problem and
    lane arrays: kind, index and every state leaf exactly, floats included
    (residual_screen against _residual_screen_jit from the same carried
    state, lean_screen against _lean_screen_jit);
  - one test per standdown reason, and a lane vetoed by the lane gate is
    re-scored through the full screen, all with the full screen's verdicts.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.disruption.batch import build_bench_scorer as j_build_bench_scorer
from karpenter_tpu.parallel import mesh as j_mesh
from karpenter_tpu_torch.disruption import batch, screen_delta
from karpenter_tpu_torch.disruption.batch import build_bench_scorer
from karpenter_tpu_torch.models.problem import numpy_fields, state_from_numpy
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.testing import workloads as W
from tests.test_screen_delta import verdict_key
from tests.test_torch_encode import reference_workloads as RW
import tests.torch_threads  # noqa: F401  (one intra-op thread)

N_CAND = 8
SUBSETS = [list(range(k + 1)) for k in range(N_CAND)] + [[k] for k in range(N_CAND)] + [[3, 7], [0, 5, 6]]


def _jax_scores(monkeypatch, delta, base_pods, n=N_CAND, subsets=SUBSETS):
    monkeypatch.setenv("KARPENTER_TPU_SCREEN_DELTA", "1" if delta else "0")
    scorer = j_build_bench_scorer(n, base_pods=base_pods)[0]
    return scorer, scorer.score_subsets(subsets, mesh=None)


def _capture(monkeypatch):
    """Record the arguments of the screens the port's scorer dispatches."""
    seen = {}
    real_lean, real_res = batch.lean_screen, batch.residual_screen

    def lean(base, variants, C, passes=3):
        seen["full"] = (base, variants, C, passes)
        return real_lean(base, variants, C, passes)

    def res(base, carried, variants, run_idx, C):
        seen["residual"] = (base, carried, variants, run_idx, C)
        return real_res(base, carried, variants, run_idx, C)

    monkeypatch.setattr(batch, "lean_screen", lean)
    monkeypatch.setattr(batch, "residual_screen", res)
    return seen


def _assert_verdicts(jv, tv):
    assert len(jv) == len(tv)
    for bi, (a, b) in enumerate(zip(jv, tv)):
        assert verdict_key(a) == verdict_key(b), f"lane {bi}: {verdict_key(b)} != JAX {verdict_key(a)}"


def _assert_raw(jr, tr):
    np.testing.assert_array_equal(np.asarray(jr.kind), tr.kind.numpy())
    np.testing.assert_array_equal(np.asarray(jr.index), tr.index.numpy())
    js, ts = numpy_fields(jr.state), numpy_fields(tr.state)
    assert sorted(js) == sorted(ts)
    for key in js:
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)


@pytest.mark.parametrize("cpu", [2.0, 63.5])
def test_delta_path_verdicts_and_residual_screen(monkeypatch, cpu):
    """Prefixes and singletons over pinned base pods (cpu 2.0), and the
    filled-survivor corpus (cpu 63.5: the survivors are full, so lanes open
    new claims): the residual path's verdicts, and its raw residual screen
    against _residual_screen_jit from the JAX package's carried base world."""
    js, jv = _jax_scores(monkeypatch, True, RW.pinned_base_pods(8, cpu=cpu))
    seen = _capture(monkeypatch)
    scorer = build_bench_scorer(N_CAND, base_pods=W.pinned_base_pods(8, cpu=cpu), device="cpu")[0]
    tv = scorer.score_subsets(SUBSETS)
    _assert_verdicts(jv, tv)
    stats = scorer.last_screen_stats
    assert stats["mode"] == js.last_screen_stats["mode"] == "delta"
    for key in ("delta_lanes", "fallback_lanes", "rnr", "resident_counts", "run_counts"):
        assert stats[key] == js.last_screen_stats[key], key
    assert stats["fallback_lanes"] == 0
    if cpu == 63.5:
        assert sum(v.n_new_claims > 0 for v in tv) > 0

    base, _, variants, run_idx, C = seen["residual"]
    world = js._delta_ctx.base_world(js)
    jvar = j_mesh.ResidualVariants(node_avail=variants.node_avail.numpy(), pod_active=variants.pod_active.numpy())
    carried_np = numpy_fields(world.carried)
    jr = j_mesh.residual_screen(js.base_problem, world.carried, jvar, run_idx, C, mesh=None)
    tr = mesh.residual_screen(base, state_from_numpy(carried_np, "cpu"), variants, run_idx, C)
    _assert_raw(jr, tr)


def test_full_path_verdicts_and_lean_screen(monkeypatch):
    """delta=False: the full screen on every lane, verdicts and the raw
    lean_screen against _lean_screen_jit on the same lane arrays."""
    js, jv = _jax_scores(monkeypatch, False, RW.pinned_base_pods(8, cpu=63.5))
    seen = _capture(monkeypatch)
    scorer = build_bench_scorer(N_CAND, base_pods=W.pinned_base_pods(8, cpu=63.5), device="cpu", delta=False)[0]
    tv = scorer.score_subsets(SUBSETS)
    _assert_verdicts(jv, tv)
    assert scorer.last_screen_stats["mode"] == "full"
    _compare_lean(js, seen["full"])


def _compare_lean(js, captured):
    base, variants, C, passes = captured
    jvar = j_mesh.ScreenVariants(
        node_avail=variants.node_avail.numpy(), pod_active=variants.pod_active.numpy(),
        grp_counts0=variants.grp_counts0.numpy(), grp_registered0=variants.grp_registered0.numpy(),
    )
    jr = j_mesh.lean_screen(js.base_problem, jvar, C, mesh=None, passes=passes)
    _assert_raw(jr, mesh.lean_screen(base, variants, C, passes))


def test_spread_corpus_stands_down_to_three_topology_passes(monkeypatch):
    """Zonal DoNotSchedule spread pods: the batch stands down
    (standdown-topology) to the full screen with three passes and a RUN_TOPO
    run; verdicts and the raw screen equal the JAX package's."""
    n, subsets = 8, [list(range(k + 1)) for k in range(8)] + [[k] for k in range(8)]
    js, jv = _jax_scores(monkeypatch, True, RW.zonal_spread_pods(6), n=n, subsets=subsets)
    seen = _capture(monkeypatch)
    scorer = build_bench_scorer(n, base_pods=W.zonal_spread_pods(6), device="cpu")[0]
    tv = scorer.score_subsets(subsets)
    _assert_verdicts(jv, tv)
    stats = scorer.last_screen_stats
    assert stats["mode"] == "full" and stats["passes"] == 3
    assert stats["outcomes"] == {"standdown-topology": len(subsets)}
    assert mesh.has_topo_runs(scorer.device_problem)
    _compare_lean(js, seen["full"])


def _both_paths(base_pods, subsets, n=8, tweak=None):
    """(full verdicts, delta verdicts, delta stats) of two fresh port scorers."""
    out = []
    for delta in (False, True):
        scorer = build_bench_scorer(n, base_pods=base_pods, device="cpu", delta=delta)[0]
        if tweak is not None:
            tweak(scorer)
        out.append((scorer.score_subsets(subsets), scorer.last_screen_stats))
    (full, _), (delta, stats) = out
    assert [verdict_key(v) for v in full] == [verdict_key(v) for v in delta]
    return stats


PREFIXES = [list(range(k + 1)) for k in range(8)]


def test_standdown_ports():
    stats = _both_paths(W.port_pods(), PREFIXES)
    assert stats["mode"] == "full" and stats["outcomes"] == {"standdown-ports": len(PREFIXES)}


def test_standdown_pool():
    """A finite NodePool limit (here written into the encoded pool) makes
    claim opens drain shared headroom: the whole batch stands down."""

    def finite_pool(scorer):
        scorer.base_problem.tpl_remaining[:] = np.float32(1e6)
        scorer.device_problem.tpl_remaining[:] = 1e6

    stats = _both_paths(W.pinned_base_pods(), PREFIXES, tweak=finite_pool)
    assert stats["mode"] == "full" and stats["outcomes"] == {"standdown-pool": len(PREFIXES)}


def test_standdown_base_on_candidate():
    stats = _both_paths(W.unpinned_base_pods(), [[0], [1], [0, 1], [4], [5], [4, 5]])
    assert stats["mode"] == "delta"
    assert stats["standdowns"].get("standdown-base-on-candidate", 0) >= 3 and stats["delta_lanes"] >= 1


def test_standdown_resident_order():
    subsets = [[0], [1], [2], [0, 1]]
    stats = _both_paths(W.tiny_base_pods(), subsets, n=6)
    assert stats["standdowns"] == {"standdown-resident-order": len(subsets)} and stats["delta_lanes"] == 0


def test_standdown_resident_overflow():
    def one_run(scorer):
        scorer.max_residual_runs = 1

    stats = _both_paths((), [list(range(12))], n=12, tweak=one_run)
    assert stats["standdowns"] == {"standdown-resident-overflow": 1}
    assert screen_delta.MAX_RUNS == 64


def test_gate_mismatch_lane_is_rescored_by_the_full_screen():
    def veto_first(scorer):
        real = scorer.lane_gate

        def gate(kinds, idxs, scope, **kw):
            ok = np.asarray(real(kinds, idxs, scope, **kw)).copy()
            ok[0] = False
            return ok

        scorer.lane_gate = gate

    stats = _both_paths((), [[0], [1], [2]], tweak=veto_first)
    assert stats["standdowns"] == {"gate-mismatch": 1}
    assert stats["fallback_lanes"] == 1 and stats["delta_lanes"] == 2
    assert stats["outcomes"] == {"delta": 2, "gate-mismatch": 1}


def test_screen_session_batches_misses_into_one_score():
    scorer = build_bench_scorer(6, device="cpu")[0]
    calls = []
    real = scorer.score_subsets

    def counted(subsets, passes=3):
        calls.append(len(subsets))
        return real(subsets, passes)

    scorer.score_subsets = counted
    session = batch.ScreenSession()
    session.use(scorer)
    first = session.score([[0, 1], [0]], extra=[[k] for k in range(6)])
    again = session.score([[0], [3]])
    assert calls == [7] and verdict_key(first[1]) == verdict_key(again[0])


def test_unionscorer_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_bench_scorer(2)


def test_bench_candidate_scoring_reports_the_split():
    out = batch.bench_candidate_scoring(6, device="cpu")
    assert out["candidates"] == 6 and out["screen_mode"] == "delta" and out["fallback_lanes"] == 0
    assert "mesh_devices" not in out and out["consolidatable"] == 6


@pytest.mark.slow
@pytest.mark.parametrize("corpus", ["A", "B"])
def test_full_width_corpora(monkeypatch, corpus):
    """chip_smoke.py's consolidation corpora at full width (200 candidates,
    its 320 subsets): corpus A on the residual path, corpus B (spread pods)
    standing down to three topology passes. Verdicts equal the JAX package's
    on every lane, and the JAX package's counts are the ones chip_smoke.py
    holds the card to (EXPECT_A, EXPECT_B)."""
    import chip_smoke

    subsets = chip_smoke.screen_subsets(200)
    j_pods = RW.pinned_base_pods(8, cpu=63.5) + (RW.zonal_spread_pods(24) if corpus == "B" else [])
    t_pods = W.pinned_base_pods(8, cpu=63.5) + (W.zonal_spread_pods(24) if corpus == "B" else [])
    monkeypatch.setenv("KARPENTER_TPU_SCREEN_DELTA", "1")
    js, its, cands = j_build_bench_scorer(200, base_pods=j_pods)
    jv = js.score_subsets(subsets, mesh=None)
    cons = sum(1 for v, s in zip(jv, subsets) if v.consolidatable_with([cands[i] for i in s], its))
    claims = np.bincount([v.n_new_claims for v in jv], minlength=3).tolist()
    want = chip_smoke.EXPECT_A if corpus == "A" else chip_smoke.EXPECT_B
    assert (cons, claims) == (want["consolidatable"], want["new_claims"])
    if corpus == "A":
        st = js.last_screen_stats
        assert {k: st[k] for k in ("delta_lanes", "fallback_lanes", "rnr")} == {
            k: want[k] for k in ("delta_lanes", "fallback_lanes", "rnr")}
    else:
        assert sum(v.all_pods_scheduled for v in jv) == want["all_scheduled"]
    scorer = build_bench_scorer(200, base_pods=t_pods, device="cpu")[0]
    _assert_verdicts(jv, scorer.score_subsets(subsets))
    assert scorer.last_screen_stats["mode"] == ("delta" if corpus == "A" else "full")
