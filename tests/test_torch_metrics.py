"""The port's metrics registry and exposition against the JAX package's.

The lint (tools/metrics_lint.py's checks over ``karpenter_tpu_torch``): with
every module of the port imported, each series the port registers is
documented in README.md or docs/*.md, appears in the port's /metrics
exposition with ``# HELP`` and ``# TYPE``, has help text, follows the
``_seconds``/``_total`` conventions, and is a series of the JAX package of
the same kind (and buckets); the port registers every series of the JAX
package (``WAITING`` is empty).

Then each of the seven series the gate, the screen, the resident world and
the SLO engine write (``solver_gate_duration_seconds``,
``solver_gate_audit_total``, ``solver_transfer_bytes_total``,
``solver_screen_delta_total``, ``solver_screen_delta_lane_seconds``,
``solver_world_patch_total``, ``slo_burn_rate``), and the four of the
streaming layer (``STREAMING``) with the gate's incremental mode: the same
scenario through both packages moves it by the same labels and counts
(observation counts for the duration histograms, whose values are wall
times; label sets for the gate's bytes, whose values are what each package
copies). The solve's own copies follow a stated rule per site
(``test_solve_transfer_bytes_follow_the_rule``).
"""

from __future__ import annotations

import copy
import importlib
import pkgutil
import random
from pathlib import Path

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_encode import draw
from tests.test_torch_encode import reference_workloads as RW
from karpenter_tpu_torch.testing import workloads as W

REPO = Path(__file__).resolve().parent.parent

# the JAX package's series that wait for the port of their layers: none
# since the program lifecycle and the serve replicas came (ROADMAP.md A4-A5)
WAITING: dict = {}
# the series of the program lifecycle and the replicas: the same names,
# kinds, help and label names as the JAX package's
LIFECYCLE = (
    "karpenter_serve_replica_placements_total",
    "karpenter_solver_aot_restore_total",
    "karpenter_solver_compile_cache_total",
    "karpenter_solver_persistent_cache_total",
    "karpenter_solver_compile_seconds",
    "karpenter_solver_program_launches_total",
    "karpenter_solver_device_bytes",
    "karpenter_solver_restart_recovery_seconds",
)
# label values of R1's series whose emitters wait for their layers (none:
# the incremental mode came with the streaming layer)
WAITING_MODES: dict = {}
# the streaming layer's series (streaming/warm.py, streaming/snapshot.py)
STREAMING = (
    "karpenter_solver_delta_reuse_ratio",
    "karpenter_solver_warm_solves_total",
    "karpenter_solver_state_restore_total",
    "karpenter_restore_fallback_total",
)
R1 = (
    "karpenter_solver_gate_duration_seconds",
    "karpenter_solver_gate_audit_total",
    "karpenter_solver_transfer_bytes_total",
    "karpenter_solver_screen_delta_total",
    "karpenter_solver_screen_delta_lane_seconds",
    "karpenter_solver_world_patch_total",
    "karpenter_slo_burn_rate",
)


def _registry(pkg: str):
    """Every module of ``pkg`` imported (so every registration ran); its
    REGISTRY."""
    mod = importlib.import_module(pkg)
    for info in pkgutil.walk_packages(mod.__path__, prefix=pkg + "."):
        importlib.import_module(info.name)
    return importlib.import_module(pkg + ".metrics.registry").REGISTRY


def _docs() -> str:
    return "\n".join(p.read_text() for p in sorted((REPO / "docs").glob("*.md")) + [REPO / "README.md"])


# -- the lint ------------------------------------------------------------------


def test_port_series_are_documented_exposed_and_the_jax_packages():
    from karpenter_tpu_torch.operator.serving import render_prometheus

    port, jax = _registry("karpenter_tpu_torch"), _registry("karpenter_tpu")
    described = port.describe()
    assert described
    docs, exposition = _docs(), render_prometheus()
    jax_kinds = {name: kind for kind, name, _ in jax.describe()}
    problems = []
    for kind, name, help_ in described:
        if name not in docs:
            problems.append(f"{name} is not documented in docs/*.md or README.md")
        if f"# TYPE {name} {kind}" not in exposition or f"# HELP {name} " not in exposition:
            problems.append(f"{name} ({kind}) is absent from /metrics")
        if not help_:
            problems.append(f"{name} has no help text")
        if name.endswith("_seconds") and kind != "histogram":
            problems.append(f"{name} is *_seconds but a {kind}")
        if name.endswith("_total") and kind != "counter":
            problems.append(f"{name} is *_total but a {kind}")
        if jax_kinds.get(name) != kind:
            problems.append(f"{name} ({kind}) is not a {kind} of the JAX package")
        elif kind == "histogram" and port.get(name).buckets != jax.get(name).buckets:
            problems.append(f"{name}: buckets differ from the JAX package's")
    assert problems == []
    assert set(jax_kinds) - {name for _, name, _ in described} == set(WAITING)


def test_r1_series_equal_the_jax_packages():
    port, jax = _registry("karpenter_tpu_torch"), _registry("karpenter_tpu")
    for name in R1 + STREAMING + LIFECYCLE:
        p, j = port.get(name), jax.get(name)
        assert p is not None, name
        assert (p.kind, p.help) == (j.kind, j.help), name
    assert {name for name in WAITING} & {name for _, name, _ in port.describe()} == set()


def test_describe_and_get():
    from karpenter_tpu_torch.metrics.registry import GATE_AUDIT, REGISTRY

    kinds = {name: (kind, help_) for kind, name, help_ in REGISTRY.describe()}
    assert kinds[GATE_AUDIT.name] == ("counter", GATE_AUDIT.help)
    assert REGISTRY.get(GATE_AUDIT.name) is GATE_AUDIT
    assert REGISTRY.get("karpenter_no_such_series") is None


def test_store_replaces_and_deletes_owned_series():
    from karpenter_tpu_torch.metrics.registry import Gauge, Store

    g = Gauge("store_probe", "a gauge the store owns")
    store = Store()
    store.update("a", [(g, {"k": "1"}, 1.0), (g, {"k": "2"}, 2.0)])
    store.update("b", [(g, {"k": "3"}, 3.0)])
    store.update("a", [(g, {"k": "2"}, 5.0)])
    assert sorted((lbl["k"], v) for _, _, lbl, v in g.collect()) == [("2", 5.0), ("3", 3.0)]
    store.replace_all({"b": [(g, {"k": "3"}, 4.0)]})
    assert [(lbl["k"], v) for _, _, lbl, v in g.collect()] == [("3", 4.0)]
    store.delete("b")
    assert g.collect() == []


# -- the seven series, moved alike ---------------------------------------------


def _series(port: bool, name: str) -> dict:
    """{labels: value} of one series (a histogram's observation count)."""
    reg = importlib.import_module(("karpenter_tpu_torch" if port else "karpenter_tpu") + ".metrics.registry").REGISTRY
    out = {}
    for kind, _, labels, value in reg.get(name).collect():
        out[tuple(sorted(labels.items()))] = value["count"] if kind == "histogram" else value
    return out


def _moves(port: bool, names, run) -> dict:
    before = {n: _series(port, n) for n in names}
    run()
    out = {}
    for n in names:
        after = _series(port, n)
        delta = {k: v - before[n].get(k, 0) for k, v in after.items() if v != before[n].get(k, 0)}
        if delta:
            out[n] = delta
    return out


def _reset_audits():
    for pkg in ("karpenter_tpu", "karpenter_tpu_torch"):
        importlib.import_module(pkg + ".verify.gate")._audit_calls = 0


def test_gate_series_move_alike():
    """Forty full gates of one clean result (device mode, with the sampled
    audits the shared seed draws), one of a corrupted result (the device
    reject and its host confirmation), and the bytes each gate's wrapper
    moves. The incremental mode is test_streaming_series_move_alike's."""
    from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as JFAKE
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu.verify import full_gate as j_full_gate
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.verify import full_gate

    wl, t_wl, _ = draw("fuzz-6")
    jres = JaxSolver(well_known=JFAKE).solve(*wl)
    tres = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(*t_wl)

    def gates(res, workload, gate):
        def run():
            for _ in range(40):
                assert not gate(res, *workload).violations
            bad = copy.deepcopy(res)
            bad.new_claims[0].requests["cpu"] = bad.new_claims[0].requests.get("cpu", 0.0) + 5.0
            assert gate(bad, *workload).violations
        return run

    names = R1[:3]
    _reset_audits()
    jm = _moves(False, names, gates(jres, wl, j_full_gate))
    _reset_audits()
    pm = _moves(True, names, gates(tres, t_wl, full_gate))
    bytes_name = "karpenter_solver_transfer_bytes_total"
    assert sorted(pm.pop(bytes_name)) == sorted(jm.pop(bytes_name)) == [(("direction", "d2h"),),
                                                                        (("direction", "h2d"),)]
    assert pm == jm
    modes = {dict(k)["mode"] for k in pm["karpenter_solver_gate_duration_seconds"]}
    assert modes == {"device", "host", "audit"}
    assert not modes & set(WAITING_MODES)
    outcomes = {dict(k)["outcome"] for k in pm["karpenter_solver_gate_audit_total"]}
    assert {"match", "reject_confirmed"} <= outcomes


def test_screen_series_move_alike(monkeypatch):
    """The residual screen over pinned base pods (every lane residual, one
    dispatch), a dispatch whose first lane the lane gate vetoes (re-scored
    by the full screen), and a batch that stands down (zonal spread): the
    same outcomes by the same counts, one lane-time observation per residual
    dispatch, and the lane gate's screen-lane mode."""
    from karpenter_tpu import verify as j_verify
    from karpenter_tpu.disruption import batch as j_batch
    from karpenter_tpu_torch.disruption import batch

    subsets = [list(range(k + 1)) for k in range(8)] + [[k] for k in range(8)]
    monkeypatch.setenv("KARPENTER_TPU_SCREEN_DELTA", "1")

    def veto_first(real):
        def gate(kinds, idxs, scope, **kw):
            ok = real(kinds, idxs, scope, **kw)
            ok[0] = False
            return ok
        return gate

    def j_run():
        def build(pods):
            return j_batch.build_bench_scorer(8, base_pods=pods)[0]

        build(RW.pinned_base_pods(8, cpu=2.0)).score_subsets(subsets, mesh=None)
        scorer = build(RW.pinned_base_pods(8, cpu=2.0))
        with monkeypatch.context() as m:
            # the JAX scorer calls verify.screen_lane_gate at each dispatch
            m.setattr(j_verify, "screen_lane_gate", veto_first(j_verify.screen_lane_gate))
            scorer.score_subsets(subsets[:4], mesh=None)
        build(RW.zonal_spread_pods(6)).score_subsets(subsets[:5], mesh=None)

    def p_run():
        def build(pods):
            return batch.build_bench_scorer(8, base_pods=pods, device="cpu")[0]

        build(W.pinned_base_pods(8, cpu=2.0)).score_subsets(subsets)
        scorer = build(W.pinned_base_pods(8, cpu=2.0))
        scorer.lane_gate = veto_first(batch.UnionScorer.lane_gate)
        scorer.score_subsets(subsets[:4])
        build(W.zonal_spread_pods(6)).score_subsets(subsets[:5])

    names = ("karpenter_solver_screen_delta_total", "karpenter_solver_screen_delta_lane_seconds",
             "karpenter_solver_gate_duration_seconds")
    jm, pm = _moves(False, names, j_run), _moves(True, names, p_run)
    assert pm == jm
    outcomes = {dict(k)["outcome"] for k in pm["karpenter_solver_screen_delta_total"]}
    assert {"delta", "gate-mismatch", "standdown-topology"} <= outcomes
    assert (("mode", "screen-lane"),) in pm["karpenter_solver_gate_duration_seconds"]


def test_world_series_move_alike(monkeypatch):
    """Seven churn cycles (two adopts, five patches) through each package's
    resident path: the same outcomes by the same counts, and bytes moved in
    both directions."""
    from tests.test_torch_world import CYCLES, _catalog, _stream
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    monkeypatch.setenv("KARPENTER_TPU_DEVICE_WORLD", "1")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")

    def cycles(port):
        its, tpls = _catalog("port" if port else "jax")
        snaps = _stream("port" if port else "jax")
        solver = TorchSolver(device="cpu", relax=False, device_world=True) if port else JaxSolver()

        def run():
            for pods, nodes, _ in snaps:
                solver.solve(pods, its, tpls, nodes=nodes)
        return run

    names = ("karpenter_solver_world_patch_total", "karpenter_solver_transfer_bytes_total")
    jm, pm = _moves(False, names, cycles(False)), _moves(True, names, cycles(True))
    assert pm["karpenter_solver_world_patch_total"] == jm["karpenter_solver_world_patch_total"]
    assert sum(pm["karpenter_solver_world_patch_total"].values()) == CYCLES
    assert set(pm["karpenter_solver_transfer_bytes_total"]) == {(("direction", "d2h"),), (("direction", "h2d"),)}


def test_slo_burn_rate_moves_alike(monkeypatch):
    """The same solve, gate and serve events on one clock: the same burn
    rates per objective and window, written at scrape time."""
    mods = [importlib.import_module(pkg + ".obs.slo") for pkg in ("karpenter_tpu", "karpenter_tpu_torch")]
    clock = {"t": 5000.0}
    rng = random.Random(3)
    events = [(rng.random() * 40.0, rng.randrange(1, 50), rng.randrange(0, 3), rng.random() < 0.9)
              for _ in range(60)]

    def run(slo):
        def go():
            for dur, ok, failed, gate_ok in events:
                clock["t"] += 1.0
                slo.on_solve_cycle(dur, ok, failed)
                slo.on_gate(gate_ok)
                slo.on_serve_latency("default", dur / 8.0)
            slo.refresh_metrics()
        return go

    out = []
    for port, slo in enumerate(mods):
        monkeypatch.setattr(slo, "_wall", lambda: clock["t"])
        slo.set_enabled(True)
        slo.reset()
        try:
            clock["t"] = 5000.0
            out.append(_moves(bool(port), ("karpenter_slo_burn_rate",), run(slo)))
            out.append(slo.rollup())
        finally:
            slo.set_enabled(None)
            slo.reset()
    jm, jroll, pm, proll = out
    assert pm == jm and pm
    assert {dict(k)["window"] for k in pm["karpenter_slo_burn_rate"]} == {"fast", "slow"}
    assert proll == jroll


def test_exposition_renders_burn_rates_at_scrape(monkeypatch):
    from karpenter_tpu_torch.obs import slo
    from karpenter_tpu_torch.operator.serving import render_prometheus

    slo.set_enabled(True)
    slo.reset()
    try:
        slo.on_solve_cycle(1.0, 3, 1)
        body = render_prometheus()
    finally:
        slo.set_enabled(None)
        slo.reset()
    lines = [line for line in body.splitlines() if line.startswith("karpenter_slo_burn_rate{")]
    assert any('objective="solve-scheduled"' in line and 'window="fast"' in line for line in lines)
    assert np.isfinite([float(line.rsplit(" ", 1)[1]) for line in lines]).all()


def test_streaming_series_move_alike(tmp_path, monkeypatch):
    """Six churn cycles through each package's StreamingSolver over its
    oracle, journaled (cold-first, then warm with the incremental gate and
    its audit sample at rate 0.5), then a fresh stream that restores the
    journal and one that finds it corrupt: the streaming series and the
    gate's incremental mode move by the same labels and counts."""
    monkeypatch.setenv("KARPENTER_TPU_VERIFY_AUDIT_FRAC", "0.5")

    def run(pkg):
        restart = importlib.import_module(pkg + ".testing.restart")
        warm = importlib.import_module(pkg + ".streaming.warm")
        oracle = importlib.import_module(pkg + ".solver.oracle").OracleSolver
        snapshot = importlib.import_module(pkg + ".streaming.snapshot")

        def go():
            monkeypatch.setenv("KARPENTER_TPU_STATE_DIR", str(tmp_path / pkg))
            pods, its, tpls = restart.base_problem(40, 4)
            proc = restart._churn(pods, 3, 2, 1)
            solver = warm.StreamingSolver(oracle())
            for _ in range(6):
                proc.step()
                solver.solve(proc.pods, its, tpls)
            assert warm.StreamingSolver(oracle()).last_restore_outcome == "restored"
            path = snapshot.journal_path()
            blob = open(path, "rb").read()
            open(path, "wb").write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
            assert warm.StreamingSolver(oracle()).last_restore_outcome == "checksum"
        return go

    names = STREAMING + ("karpenter_solver_gate_duration_seconds", "karpenter_solver_gate_audit_total")
    _reset_audits()
    jm = _moves(False, names, run("karpenter_tpu"))
    _reset_audits()
    pm = _moves(True, names, run("karpenter_tpu_torch"))
    assert pm == jm
    assert pm["karpenter_solver_warm_solves_total"] == {(("outcome", "cold-first"),): 1.0,
                                                         (("outcome", "warm"),): 5.0}
    assert (("mode", "incremental"),) in pm["karpenter_solver_gate_duration_seconds"]
    assert pm["karpenter_solver_state_restore_total"] == {
        (("outcome", "missing"),): 1.0, (("outcome", "restored"),): 1.0, (("outcome", "checksum"),): 1.0}
    assert pm["karpenter_restore_fallback_total"] == {(("reason", "journal-checksum"),): 1.0}


# the files whose TRANSFER_BYTES increments are the solve's own copies
SOLVE_SITES = {"jax_backend.py", "torch_backend.py", "solve.py"}


def _solve_copies(reg, monkeypatch) -> list:
    """Record (direction, bytes) of every solve-site increment of ``reg``'s
    TRANSFER_BYTES, in order."""
    import os
    import sys

    log = []
    real = reg.TRANSFER_BYTES.inc

    def inc(labels=None, value=1.0):
        if os.path.basename(sys._getframe(1).f_code.co_filename) in SOLVE_SITES:
            log.append((labels["direction"], int(value)))
        return real(labels, value)

    monkeypatch.setattr(reg.TRANSFER_BYTES, "inc", inc)
    return log


@pytest.mark.parametrize("case", ["default", "relax-off", "relax2", "shard"])
def test_solve_transfer_bytes_follow_the_rule(case, monkeypatch):
    """ROADMAP C7: the solve's own copies, increment by increment. The rule: the
    port counts the padded problem once per encode pass (phase 1 and the
    loop read one upload) and never the carried state, which stays on the
    device; the JAX package counts the problem at each dispatch and the
    carried phase-1 state at the repair dispatch. So the port's increments
    are the JAX package's without the repair dispatch's host-to-device
    entry; every fetch is equal, byte for byte. The sharded solve (claims-40:
    8 partitions on the port's one device, 8 lanes on the JAX package's 8
    host devices) is equal."""
    import karpenter_tpu.metrics.registry as j_reg
    import karpenter_tpu_torch.metrics.registry as t_reg
    from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as JFAKE
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from tests.test_torch_shard import CORPORA, _Env

    relax = case in ("default", "relax2")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1" if relax else "0")
    if case == "relax2":
        monkeypatch.setenv("KARPENTER_TPU_RELAX2", "1")
    if case == "shard":
        jw, tw = CORPORA["claims-40"](RW), CORPORA["claims-40"](W)
    else:
        jw, tw, _ = draw("fuzz-6")
    jlog, tlog = _solve_copies(j_reg, monkeypatch), _solve_copies(t_reg, monkeypatch)
    js, ts = JaxSolver(well_known=JFAKE), TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=relax)
    if case == "shard":
        with _Env():
            js.solve(*jw)
        with _Env():
            ts.solve(*tw)
        assert ts.last_shard["reason"] is None and js.last_shard["lanes"] == ts.last_shard["partitions"]
    else:
        js.solve(*jw)
        ts.solve(*tw)
    if case in ("default", "relax2"):
        # phase 1 (upload, stats), the repair dispatch (upload + carried
        # state), the loop's fetch
        assert [d for d, _ in jlog] == ["h2d", "d2h", "h2d", "d2h"] and jlog[2][1] > jlog[0][1]
        assert tlog == [jlog[0], jlog[1], jlog[3]]
    else:
        assert [d for d, _ in jlog] == ["h2d", "d2h"]
        assert tlog == jlog
