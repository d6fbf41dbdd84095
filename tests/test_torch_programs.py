"""The port's program registry (karpenter_tpu_torch/obs/programs.py) against
the JAX package's (tests/test_obs_programs.py's cases, and one scenario
through both packages).

The same scenario, with ``KARPENTER_TPU_PROGRAMS=1`` in both packages, gives
the same ``program`` label set, the same launches per label, the same
first-dispatch-then-``memory`` sequence per label (the JAX package's first
dispatch may read ``persistent`` from its on-disk compile cache; the port's
reads ``cold`` on the CPU, obs/programs.py's source rule), and moves
``solver_compile_cache_total`` alike. On the card the source follows the
library a key's first dispatch first launched (``cold``, ``persistent``,
``restored``); here that rule is held with recorded first uses. Exact
throughout: counts and labels, no float tolerance.
"""

from __future__ import annotations

import json
import types
import urllib.request

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_encode import reference_workloads as RW
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.obs import programs
from karpenter_tpu_torch.testing import workloads as W


@pytest.fixture(autouse=True)
def _registry_on():
    from karpenter_tpu.obs import programs as jprograms

    for mod in (programs, jprograms):
        mod.set_enabled(True)
        mod.reset()
    yield
    for mod in (programs, jprograms):
        mod.set_enabled(None)
        mod.reset()


@pytest.fixture
def fresh_caches(monkeypatch):
    """Both packages' program-cache sets empty, so that a scenario's
    compile-cache counts do not depend on the tests before it."""
    from karpenter_tpu.solver import jax_backend
    from karpenter_tpu.verify import gate as jgate
    from karpenter_tpu_torch.solver import torch_backend
    from karpenter_tpu_torch.verify import gate

    for mod, name in ((jax_backend, "_COMPILED_PROGRAMS"), (jgate, "_SEEN_GATE_PROGRAMS"),
                      (torch_backend, "_COMPILED_PROGRAMS"), (gate, "_SEEN_GATE_PROGRAMS")):
        monkeypatch.setattr(mod, name, set())


def _solvers(relax=False, **kwargs):
    from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as JFAKE
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    return (JaxSolver(well_known=JFAKE, **kwargs),
            TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=relax, **kwargs))


def _records(mod):
    return {r["program"]: r for r in mod.registry().snapshot()["programs"]}


def _sequence(rec):
    """A record's sources as first dispatch / memory counts (the JAX
    package's first dispatch may be ``persistent`` from its disk cache)."""
    first = sum(n for src, n in rec["sources"].items() if src != "memory")
    return first, rec["sources"].get("memory", 0)


def _compile_cache(port: bool):
    import importlib

    reg = importlib.import_module(("karpenter_tpu_torch" if port else "karpenter_tpu") + ".metrics.registry")
    return {tuple(sorted(lbl.items())): v for _, _, lbl, v in reg.COMPILE_CACHE.collect()}


def _moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


# -- program keys --------------------------------------------------------------


class TestProgramKey:
    def test_key_varies_by_shape_and_claims(self):
        import numpy as np

        a = {"x": np.zeros((4, 2), np.float32)}
        b = {"x": np.zeros((8, 2), np.float32)}
        k1 = programs.program_key("f", 16, a)
        k2 = programs.program_key("f", 16, b)
        k3 = programs.program_key("f", 32, a)
        assert len({k1, k2, k3}) == 3
        assert k1.startswith("f/C16/")
        assert k1.endswith(programs.isa_tag())

    def test_key_varies_by_flag_config(self, monkeypatch):
        import numpy as np
        import torch

        a = {"x": torch.zeros((4, 2)), "y": np.zeros(3, np.int32)}
        k1 = programs.program_key("f", 16, a)
        monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT", "1")
        assert programs.program_key("f", 16, a) != k1

    def test_label_is_bounded(self):
        from karpenter_tpu.obs import programs as jprograms

        for mod in (programs, jprograms):
            assert mod.program_label("solve_ffd_sweeps", 32) == "solve_ffd_sweeps/C32"
        assert programs.PROGRAM_FLAGS == jprograms.PROGRAM_FLAGS
        assert "/" not in programs.isa_tag() and programs.isa_tag().startswith("torch-")


# -- one scenario through both packages -------------------------------------------

SCENARIOS = {
    # the sweeps solve, twice, each result through the device gate
    "sweeps": dict(workload=lambda m: m.diverse_workload(60, 12), relax=False, solves=2, gate=True),
    # the two-phase solve: relax_place, then the carried loop
    "relax": dict(workload=lambda m: m.diverse_workload(60, 12), relax=True, solves=2, gate=False),
    # relaxable pods: the per-pass loop (one solve_ffd dispatch per pass)
    "per-pass": dict(workload=lambda m: m.relax_fuzz_workload(3), relax=False, solves=1, gate=False),
    # a claim-slot escalation: one record per claim bucket
    "escalation": dict(workload=lambda m: m.diverse_workload(60, 4), relax=False, solves=1, gate=False,
                       kwargs={"initial_claim_slots": 2}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_labels_launches_and_sources_equal_the_jax_packages(name, monkeypatch, fresh_caches):
    from karpenter_tpu.verify import full_gate as j_full_gate
    from karpenter_tpu_torch.verify import full_gate

    sc = SCENARIOS[name]
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "1" if sc["relax"] else "0")
    jwl, pwl = sc["workload"](RW), sc["workload"](W)
    js, ps = _solvers(relax=sc["relax"], **sc.get("kwargs", {}))
    from karpenter_tpu.obs import programs as jprograms

    before = (_compile_cache(False), _compile_cache(True))
    for _ in range(sc["solves"]):
        jr, pr = js.solve(*jwl), ps.solve(*pwl)
        if sc["gate"]:
            j_full_gate(jr, *jwl)
            full_gate(pr, *pwl)
    jrec, prec = _records(jprograms), _records(programs)
    assert sorted(prec) == sorted(jrec)
    assert {k: r["launches"] for k, r in prec.items()} == {k: r["launches"] for k, r in jrec.items()}
    assert {k: _sequence(r) for k, r in prec.items()} == {k: _sequence(r) for k, r in jrec.items()}
    for r in prec.values():
        assert set(r["sources"]) <= {"cold", "memory"}  # the CPU: no library loads
        assert r["kernel"] in kernels.LAUNCHES
        assert r["eqns"] is None  # no jaxpr in the port
    assert _moved(before[1], _compile_cache(True)) == _moved(before[0], _compile_cache(False))
    assert (ps.compile_cache_hits, ps.compile_cache_misses) == (js.compile_cache_hits, js.compile_cache_misses)
    if name == "escalation":
        assert ps.claim_escalations == js.claim_escalations >= 1
        solve = [r for r in prec.values() if r["name"].startswith("solve_ffd")]
        assert len({r["claims"] for r in solve}) >= 2
        assert sum(r["launches"] for r in solve) == ps.claim_escalations + 1


def test_resident_and_screen_sites_label_alike(monkeypatch, fresh_caches):
    """The resident cycle (``patch_world``, ``solve_ffd_fused_gate``) and the
    consolidation screen (``residual_screen`` / ``lean_screen``) record the
    JAX package's labels and launches, and the resident sites move
    ``solver_compile_cache_total`` alike."""
    from karpenter_tpu.disruption.batch import build_bench_scorer as j_build
    from karpenter_tpu.obs import programs as jprograms
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu_torch.disruption.batch import build_bench_scorer
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from tests.test_torch_world import _catalog, _stream

    monkeypatch.setenv("KARPENTER_TPU_DEVICE_WORLD", "1")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")
    before = (_compile_cache(False), _compile_cache(True))
    for pkg, solver in (("jax", JaxSolver()), ("port", TorchSolver(device="cpu", relax=False, device_world=True))):
        its, tpls = _catalog(pkg)
        for pods, nodes, _ in _stream(pkg)[:4]:
            solver.solve(pods, its, tpls, nodes=nodes)
    jrec, prec = _records(jprograms), _records(programs)
    assert any(k.startswith("patch_world/") for k in prec) and any(k.startswith("solve_ffd_fused_gate/") for k in prec)
    assert {k: r["launches"] for k, r in prec.items()} == {k: r["launches"] for k, r in jrec.items()}
    assert _moved(before[1], _compile_cache(True)) == _moved(before[0], _compile_cache(False))
    for mod in (programs, jprograms):
        mod.reset()
    subsets = [[0], [0, 1], [2, 3]]
    j_build(8, base_pods=RW.pinned_base_pods())[0].score_subsets(subsets, mesh=None)
    build_bench_scorer(8, base_pods=W.pinned_base_pods(), device="cpu")[0].score_subsets(subsets)
    jrec, prec = _records(jprograms), _records(programs)
    assert prec and {k: r["launches"] for k, r in prec.items()} == {k: r["launches"] for k, r in jrec.items()}
    assert {r["kernel"] for r in prec.values()} == {"runs_screen"}


# -- the source rule on the card -----------------------------------------------------

_CARD = types.SimpleNamespace(shape=(4,), dtype="float32", device=types.SimpleNamespace(type="cuda"))


@pytest.mark.parametrize("uses,want", [
    ((), "memory"),
    ((("ffd_loop", "cold"),), "cold"),
    ((("ffd_loop", "persistent"),), "persistent"),
    ((("ffd_loop", "restored"),), "restored"),
    ((("gate_counts", "restored"), ("ffd_loop", "persistent")), "persistent"),
    ((("gate_counts", "restored"), ("ffd_loop", "cold")), "cold"),
])
def test_card_source_follows_the_first_launched_library(uses, want, monkeypatch):
    """A key's first dispatch on the card takes the origin of the libraries
    it launched first (cold over persistent over restored), else
    ``memory``; every later dispatch is ``memory``. On the CPU a key's first
    dispatch is ``cold``."""
    monkeypatch.setattr(kernels._tls, "uses", [], raising=False)
    obs = programs.begin_dispatch("solve_ffd_sweeps", 32, {"x": _CARD}, kernel="ffd_loop")
    kernels.first_uses().extend(uses)
    assert obs.finish() == want
    assert programs.begin_dispatch("solve_ffd_sweeps", 32, {"x": _CARD}).finish() == "memory"
    import torch

    cpu = {"x": torch.zeros(3)}
    assert programs.begin_dispatch("relax_place", 32, cpu).finish() == "cold"
    assert programs.begin_dispatch("relax_place", 32, cpu).finish() == "memory"
    rec = _records(programs)["solve_ffd_sweeps/C32"]
    assert rec["sources"] == {want: 1, "memory": 1} if want != "memory" else {"memory": 2}
    assert rec["compiles"] == (0 if want == "memory" else 1)


def test_library_origins_and_first_launches(monkeypatch, tmp_path):
    """kernels.library() keeps each library's origin (built here: cold;
    loaded from an existing file: persistent; kernels.install: restored),
    and the first launch after each load is recorded once on its thread."""
    import ctypes

    opened = []

    def fake_open(name, path):
        opened.append((name, str(path)))
        lib = types.SimpleNamespace()
        for launch, size in kernels.symbols(name):
            setattr(lib, launch, lambda *a: 0)
            setattr(lib, size, lambda *a: ctypes.sizeof(ctypes.c_int))
        return lib

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_open", fake_open)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_paths", {})
    monkeypatch.setattr(kernels, "_origin", {})
    monkeypatch.setattr(kernels, "_used", set())
    monkeypatch.setattr(kernels, "NVCC_RUNS", ["gate_counts"])
    monkeypatch.setattr(kernels._tls, "uses", [], raising=False)
    monkeypatch.setattr(kernels, "build", lambda names: {n: kernels.library_path(n) for n in names})
    kernels.library("probe")
    kernels.library("gate_counts")
    kernels.install("attribute", tmp_path / "libattribute-restored.so")
    assert kernels.library_origins() == {"probe": "persistent", "gate_counts": "cold", "attribute": "restored"}
    assert len(opened) == 3 and kernels.loaded_path("attribute") == tmp_path / "libattribute-restored.so"
    args = ctypes.c_int(0)
    before = dict(kernels.LAUNCHES)
    for _ in range(2):
        kernels.launch("probe", args, 0)
        kernels.launch("attribute", args, 0)
    assert kernels.first_uses() == [("probe", "persistent"), ("attribute", "restored")]
    assert kernels.LAUNCHES["probe"] == before["probe"] + 2
    kernels.evict(["attribute"])
    assert "attribute" not in kernels.library_origins()
    assert kernels.build(["probe"]) == {"probe": kernels.library_path("probe")}


# -- flag-off contract -------------------------------------------------------------


def placements(result):
    return ([(c.template_index, list(c.pod_indices), list(c.instance_type_indices)) for c in result.new_claims],
            sorted((k, list(v)) for k, v in result.node_pods.items()), sorted(result.failures))


def test_off_records_nothing_and_placements_bit_identical():
    pods, its, tpls, nodes = W.diverse_workload(40, 10)
    _, ps = _solvers()
    programs.set_enabled(False)
    off = ps.solve(pods, its, tpls, nodes)
    snap = programs.registry().snapshot()
    assert snap["totals"]["launches"] == 0 and snap["memory"]["last"] is None
    assert programs.begin_dispatch("f", 8, {"x": 1}) is None
    assert programs.sample_memory() is None
    programs.set_enabled(True)
    on = ps.solve(pods, its, tpls, nodes)
    assert placements(on) == placements(off)
    assert programs.registry().snapshot()["totals"]["launches"] >= 1


def test_byte_accounting_present():
    pods, its, tpls, nodes = W.diverse_workload(40, 6)
    _solvers()[1].solve(pods, its, tpls, nodes)
    recs = [r for r in programs.registry().snapshot()["programs"] if r["name"].startswith("solve_ffd")]
    b = recs[0]["bytes_last"]
    assert b["problem"] > 0 and b["result"] > 0 and b["donated"] == 0


# -- memory samples ------------------------------------------------------------------


def test_solve_cycle_records_sample():
    pods, its, tpls, nodes = W.diverse_workload(25, 6)
    _solvers()[1].solve(pods, its, tpls, nodes)
    last = programs.registry().snapshot()["memory"]["last"]
    assert last is not None and last["source"] == programs.MEMORY_SOLVE_TENSORS
    assert last["live_bytes"] > 0 and last["peak_bytes"] >= last["live_bytes"]
    assert last["carried_state_bytes"] > 0 and last["pods"] == 25


def test_gauge_exported():
    from karpenter_tpu_torch.operator.serving import render_prometheus

    programs.registry().sample_memory(carried_bytes=123, pods=1)
    text = render_prometheus()
    assert 'karpenter_solver_device_bytes{kind="live"}' in text
    assert 'karpenter_solver_device_bytes{kind="carried_state"} 123' in text


def test_shard_site_labels_like_the_jax_package(monkeypatch, fresh_caches):
    """The partitioned solve: one lane-grid dispatch and a gate per
    partition, labelled and counted as in the JAX package; its lane layout
    noted (the port's lanes are the partitions, the JAX package pads them
    to its 8 devices: ROADMAP.md C, the partitioned solve on one card)."""
    from karpenter_tpu.obs import programs as jprograms

    monkeypatch.setenv("KARPENTER_TPU_SHARD", "1")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_DEVICES", "1")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_PARTITIONS", "2")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", "16")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")
    js, ps = _solvers()
    before = (_compile_cache(False), _compile_cache(True))
    js.solve(*RW.diverse_workload(64, 6))
    pods, its, tpls, nodes = W.diverse_workload(64, 6)
    ps.solve(pods, its, tpls, nodes)
    assert ps.last_shard["reason"] is None is js.last_shard["reason"]
    jrec, prec = _records(jprograms), _records(programs)
    assert {k: r["launches"] for k, r in prec.items()} == {k: r["launches"] for k, r in jrec.items()}
    assert _moved(before[1], _compile_cache(True)) == _moved(before[0], _compile_cache(False))
    assert jprograms.registry().snapshot()["shard"]["partitions"] == 2
    snap = programs.registry().snapshot()
    assert snap["shard"]["partitions"] == 2 == snap["shard"]["lanes"]
    assert sum(snap["shard"]["pods_per_partition"]) == len(pods)
    # one lane-grid dispatch, then each partition's gate
    kinds = {r["program"].split("/")[0]: r for r in snap["programs"]}
    assert sorted(kinds) == ["shard_sweeps", "verify_gate"]
    assert kinds["shard_sweeps"]["kernel"] == "ffd_loop_lanes" and kinds["shard_sweeps"]["launches"] == 1
    assert kinds["verify_gate"]["launches"] == 2


# -- serving surface -----------------------------------------------------------------


def test_debug_programs_and_statusz():
    from karpenter_tpu_torch.operator import serving

    pods, its, tpls, nodes = W.diverse_workload(15, 5)
    _solvers()[1].solve(pods, its, tpls, nodes)
    server = serving.serve(0, host="127.0.0.1", status=serving.OperatorStatus())
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/programs") as resp:
            body = json.loads(resp.read())
        assert body["enabled"] is True and body["totals"]["launches"] >= 1
        first = body["programs"][0]
        assert {"key", "program", "sources", "launches", "kernel"} <= set(first)
        assert first["key"].endswith(programs.isa_tag())
        assert [k["name"] for k in body["kernels"]["kernels"]] == list(kernels.SOURCES)
        status = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz").read())
        assert status["programs"]["launches"] >= 1
        assert status["programs"]["by_source"] == {"cold": status["programs"]["programs"]}
        assert status["kernels"]["launches_total"] == sum(kernels.LAUNCHES.values())
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics").read().decode()
        assert "# TYPE karpenter_solver_compile_seconds histogram" in metrics
        assert "karpenter_solver_program_launches_total{" in metrics
    finally:
        server.shutdown()
        server.server_close()


def test_trace_span_stamped_with_program_key():
    from karpenter_tpu_torch.obs import trace

    trace.set_enabled(True)
    trace.reset_ring()
    try:
        pods, its, tpls, nodes = W.diverse_workload(18, 5)
        _solvers()[1].solve(pods, its, tpls, nodes)
        d = trace.ring().snapshot()[0]

        def walk(node):
            yield node
            for child in node.get("children", ()):
                yield from walk(child)

        stamped = [n for n in walk(d["root"]) if n.get("attrs", {}).get("program_key")]
        assert [n["name"] for n in stamped] == ["sweeps"]
        assert stamped[0]["attrs"]["cache_source"] == programs.SOURCE_COLD
    finally:
        trace.set_enabled(None)
        trace.reset_ring()
