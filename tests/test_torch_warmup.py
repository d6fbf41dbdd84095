"""The port's prewarm and restart recovery (karpenter_tpu_torch/solver/
warmup.py, solver/aot.py) against the JAX package's.

The ladders equal the JAX package's; each prewarm function on
``TorchSolver(device="cpu")`` returns what the JAX function returns on the
same arguments, under the same ``warmup`` trace cycle; a kernel build error
or a device fault in a warm reaches the operator's status (/readyz 503) and
any other exception is swallowed. The kernel-library snapshots are covered
with synthetic framed entries: the off path, each failure reason classified
once and counted, the restore and eviction of a library, the recovery record
and /readyz through the recovery phases (tests/test_restart_resilience.py's
scenario through both packages). No test here depends on the JAX package's
AOT round trip. Exact throughout: counts, labels and return values.
"""

from __future__ import annotations

import ctypes
import json
import os
import types

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.solver import aot, warmup


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Fresh loaded-library and snapshot tables, and both packages'
    recovery phase machines reset afterwards."""
    from karpenter_tpu.solver import aot as jaot

    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_paths", {})
    monkeypatch.setattr(kernels, "_origin", {})
    monkeypatch.setattr(kernels, "_used", set())
    aot.reset_table()
    yield
    aot.reset_table()
    for mod in (aot, jaot):
        mod.reset_recovery_for_tests()


@pytest.fixture
def state(tmp_path, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_AOT_RESTORE", "1")
    monkeypatch.setenv("KARPENTER_TPU_STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _jax_solver(**kwargs):
    from karpenter_tpu.solver.jax_backend import JaxSolver

    return JaxSolver(**kwargs)


def _port_solver(**kwargs):
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    return TorchSolver(device="cpu", relax=False, **kwargs)


# the attributes the warm functions give their cycles (the solves inside
# may add their own, such as the resident path's world_outcome)
WARM_ATTRS = ("kind", "max_pods", "max_claims", "candidates", "pods")


def _warm_cycles(trace, run):
    """(result, [(cycle name, warm attrs)]) of the cycles ``run`` publishes."""
    trace.set_enabled(True)
    trace.reset_ring()
    try:
        out = run()
        return out, [(t["name"], {k: v for k, v in t["root"]["attrs"].items() if k in WARM_ATTRS})
                     for t in reversed(trace.ring().snapshot())]
    finally:
        trace.set_enabled(None)
        trace.reset_ring()


def _both(jax_run, port_run):
    from karpenter_tpu.obs import trace as jtrace
    from karpenter_tpu_torch.obs import trace as ptrace

    return _warm_cycles(jtrace, jax_run), _warm_cycles(ptrace, port_run)


# -- the ladders ---------------------------------------------------------------------


@pytest.mark.parametrize("max_pods", [0, 8, 9, 100, 1000, 10000, 50000])
def test_bucket_ladder_equals_the_jax_packages(max_pods):
    from karpenter_tpu.solver import warmup as jwarm

    assert warmup.bucket_ladder(max_pods) == jwarm.bucket_ladder(max_pods)


@pytest.mark.parametrize("max_claims", [0, 1, 16, 128, 256, 600])
def test_claim_ladder_equals_the_jax_packages(max_claims):
    from karpenter_tpu.solver import warmup as jwarm

    assert warmup.claim_ladder(max_claims) == jwarm.claim_ladder(max_claims)


# -- the warms, through both packages -----------------------------------------------


def test_prewarm_solver_returns_and_traces_like_the_jax_package():
    from karpenter_tpu.solver import warmup as jwarm

    kw = dict(pod_buckets=(9, 33), instance_types_n=20, max_pods=70)
    (jn, jc), (pn, pc) = _both(lambda: jwarm.prewarm_solver(solver=_jax_solver(), **kw),
                               lambda: warmup.prewarm_solver(solver=_port_solver(), **kw))
    assert pn == jn == 4 + len([b for b in warmup.bucket_ladder(70) if b not in (16, 64)])
    assert pc == jc == [("warmup", {"kind": "solver", "max_pods": 70})]


def test_prewarm_claim_buckets_returns_and_traces_like_the_jax_package():
    from karpenter_tpu.solver import warmup as jwarm

    kw = dict(max_claims=16, instance_types_n=20)
    (jn, jc), (pn, pc) = _both(lambda: jwarm.prewarm_claim_buckets(solver=_jax_solver(), **kw),
                               lambda: warmup.prewarm_claim_buckets(solver=_port_solver(), **kw))
    assert pn == jn == len(warmup.claim_ladder(16))
    assert pc == jc == [("warmup", {"kind": "claim-ladder", "max_claims": 16})]


@pytest.mark.parametrize("flag", ["0", "1"])
def test_prewarm_device_world_returns_like_the_jax_package(flag, monkeypatch):
    from karpenter_tpu.solver import warmup as jwarm

    monkeypatch.setenv("KARPENTER_TPU_DEVICE_WORLD", flag)
    (jn, jc), (pn, pc) = _both(
        lambda: jwarm.prewarm_device_world(solver=_jax_solver(), instance_types_n=20),
        lambda: warmup.prewarm_device_world(solver=_port_solver(device_world=flag == "1"), instance_types_n=20))
    assert pn == jn == (4 if flag == "1" else 0)
    assert pc == jc == ([("warmup", {"kind": "device-world"})] if flag == "1" else [])
    if flag == "1":
        # without a solver the port builds one with a resident world
        assert warmup.prewarm_device_world(instance_types_n=20, device="cpu") == 4


def test_prewarm_screen_returns_like_the_jax_package():
    from karpenter_tpu.solver import warmup as jwarm

    (jn, jc), (pn, pc) = _both(lambda: jwarm.prewarm_screen(8), lambda: warmup.prewarm_screen(8, device="cpu"))
    assert pn is jn is True
    assert pc == jc == [("warmup", {"kind": "screen", "candidates": 8})]


@pytest.mark.parametrize("flag", ["0", "1"])
def test_prewarm_shard_returns_like_the_jax_package(flag, monkeypatch):
    from karpenter_tpu.solver import warmup as jwarm

    monkeypatch.setenv("KARPENTER_TPU_SHARD", flag)
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_DEVICES", "1")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_PARTITIONS", "2")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", "16")
    kw = dict(n_pods=32, instance_types_n=20)
    (jn, jc), (pn, pc) = _both(lambda: jwarm.prewarm_shard(**kw), lambda: warmup.prewarm_shard(device="cpu", **kw))
    assert pn is jn is (flag == "1")
    assert pc == jc == ([("warmup", {"kind": "shard", "pods": 32})] if flag == "1" else [])


def test_probe_solve_passes_in_both_packages():
    from karpenter_tpu.solver import warmup as jwarm

    assert jwarm._probe_solve() is True
    assert warmup._probe_solve(device="cpu") is True


# -- warm faults: raised, or swallowed as in the JAX package --------------------------


class _Raising:
    def __init__(self, exc):
        self.exc = exc
        self.claim_slots = 0

    def solve(self, *args, **kwargs):
        raise self.exc


@pytest.mark.parametrize("exc,raised", [
    (kernels.KernelCompileError("kernel build failed:\nffd_loop: nvcc exit 1"), True),
    (kernels.KernelDeviceError("ffd_loop: CUDA launch error 700"), True),
    (ValueError("not a fault of the card"), False),
])
def test_warm_faults_raise_and_other_errors_are_swallowed(exc, raised, monkeypatch):
    from karpenter_tpu.solver import warmup as jwarm
    from karpenter_tpu_torch.disruption import batch

    calls = [
        lambda: warmup.prewarm_solver(solver=_Raising(exc), instance_types_n=5),
        lambda: warmup.prewarm_claim_buckets(solver=_Raising(exc), max_claims=4, instance_types_n=5),
    ]
    monkeypatch.setattr(batch, "bench_candidate_scoring", lambda *a, **k: (_ for _ in ()).throw(exc))
    calls.append(lambda: warmup.prewarm_screen(8, device="cpu"))
    for call in calls:
        if raised:
            with pytest.raises(type(exc)):
                call()
        else:
            out = call()
            assert out in (0, False)
    if not raised:
        # the JAX package's own values for a swallowed failure
        assert jwarm.prewarm_solver(solver=_Raising(exc), instance_types_n=5) == 0
        assert jwarm.prewarm_claim_buckets(solver=_Raising(exc), max_claims=4, instance_types_n=5) == 0


@pytest.mark.parametrize("exc,where", [
    (kernels.KernelCompileError("kernel build failed:\nrelax_place: nvcc exit 1"), "kernel_build_error"),
    (kernels.KernelDeviceError("relax_place: CUDA launch error 700"), "device_faults"),
    (ValueError("a warm that fails on its own"), None),
])
def test_warm_fault_reaches_the_operator_status(exc, where, monkeypatch):
    from karpenter_tpu_torch.operator import operator as op_mod
    from tests.test_torch_operator import _readyz, _started, _statusz

    def failing(**kwargs):
        raise exc

    monkeypatch.setattr(warmup, "_on_accelerator", lambda: True)
    monkeypatch.setattr(warmup, "prewarm_solver", failing)
    op, port = _started(monkeypatch, build=lambda names=None: {})
    try:
        op._warm_thread.join(30)
        payload = _statusz(port)
        if where is None:
            assert _readyz(port) == 200 and payload["ready"]
            assert "kernel_build_error" not in payload and "device_faults" not in payload
        else:
            assert _readyz(port) == 503 and not payload["ready"]
            text = payload[where] if where == "kernel_build_error" else payload[where]["solver-prewarm"]
            assert type(exc).__name__ in text
    finally:
        op.stop()


# -- kernel-library snapshots ----------------------------------------------------------


def test_reasons_and_phases_equal_the_jax_packages():
    from karpenter_tpu.solver import aot as jaot

    assert aot.REASONS == jaot.REASONS
    for name in ("IDLE", "RESTORING", "PROBING", "READY", "FAILED"):
        assert getattr(aot, f"PHASE_{name}") == getattr(jaot, f"PHASE_{name}")


def test_off_path_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_AOT_RESTORE", raising=False)
    monkeypatch.setenv("KARPENTER_TPU_STATE_DIR", str(tmp_path))
    lib = tmp_path / "libprobe-x.so"
    lib.write_bytes(b"\x7fELF")
    assert not aot.enabled()
    assert aot.persist_library("probe", lib) is None
    assert aot.restore()["entries"] == 0 and aot.snapshot_files() == []
    assert warmup.restore_and_probe() is None and warmup.maybe_recover_in_background() is None
    assert aot.recovery_phase() == aot.PHASE_IDLE and list(tmp_path.iterdir()) == [lib]


def _fake_open(name, path):
    lib = types.SimpleNamespace(path=str(path))
    for launch, size in kernels.symbols(name):
        setattr(lib, launch, lambda *a: 0)
        setattr(lib, size, lambda *a: 0)
    return lib


def _entry(state, name="probe", payload=b"library bytes", **meta):
    """A snapshot entry written as a library's first load writes it, with
    ``meta`` overriding its header's fields."""
    lib = state / f"lib{name}-{kernels.source_digest(name)}.so"
    lib.write_bytes(payload)
    path = aot.persist_library(name, lib)
    if meta:
        from karpenter_tpu_torch.utils import persist

        header, body = persist.load_framed(path, kind=aot.AOT_KIND)
        persist.write_framed(path, body, kind=meta.pop("kind", aot.AOT_KIND),
                             version=meta.pop("version", aot.AOT_VERSION), meta={**header["meta"], **meta})
    return path


def _counts():
    from karpenter_tpu_torch.metrics.registry import AOT_RESTORE, RESTORE_FALLBACK

    return ({lbl["result"]: v for _, _, lbl, v in AOT_RESTORE.collect()},
            {lbl["reason"]: v for _, _, lbl, v in RESTORE_FALLBACK.collect()})


def _flip(path, at):
    data = bytearray(open(path, "rb").read())
    data[at] ^= 0xFF
    open(path, "wb").write(bytes(data))


CORRUPTIONS = {
    "truncated": lambda p: open(p, "r+b").truncate(os.path.getsize(p) - 5),
    "corrupt": lambda p: _flip(p, 0),
    "checksum": lambda p: _flip(p, os.path.getsize(p) - 1),
}
META = {
    "version-skew": {"torch": "0.0.0"},
    "isa-mismatch": {"device": "torch-0.0-cuda12.0-another-card-sm_80"},
    "flag-mismatch": {"flags": "00000000"},
}


@pytest.mark.parametrize("reason", ["truncated", "corrupt", "checksum", "version-skew", "isa-mismatch",
                                    "flag-mismatch", "deserialize-error", "source-digest", "frame-kind",
                                    "frame-version"])
def test_each_failure_is_classified_once_and_counted(reason, state):
    """Every entry lands in exactly one of the JAX package's labels; a
    source digest that is not the tree's, and an entry of the next frame
    version, are version skew; an entry of another frame kind (a JAX-written
    snapshot, say) is corrupt; a payload that is no library does not load."""
    if reason in CORRUPTIONS:
        CORRUPTIONS[reason](_entry(state))
        want = reason
    elif reason in META:
        _entry(state, **META[reason])
        want = reason
    elif reason == "source-digest":
        _entry(state, source_digest="0" * 16)
        want = "version-skew"
    elif reason == "frame-kind":
        _entry(state, kind="aot-entry")
        want = "corrupt"
    elif reason == "frame-version":
        _entry(state, version=aot.AOT_VERSION + 1)
        want = "version-skew"
    else:
        _entry(state, payload=b"not a shared library")
        want = "deserialize-error"
    assert want in aot.REASONS
    before = _counts()
    summary = aot.restore()
    after = _counts()
    assert summary["entries"] == 1 and summary["restored"] == 0
    assert summary["failures"] == {want: 1} and summary["libraries"] == {"probe": want}
    assert after[0][want] - before[0].get(want, 0) == 1
    assert after[1][f"aot-{want}"] - before[1].get(f"aot-{want}", 0) == 1
    assert kernels.library_origins() == {} and aot.restored_count() == 0


def test_restore_loads_under_a_fresh_name_and_evicts(state, monkeypatch):
    """A good entry is written to a new file under the build directory and
    loaded in place of a build (origin ``restored``, no nvcc); a second
    restore never overwrites the first file; ``clear_restored`` evicts it,
    counted ``probe-failed``."""
    monkeypatch.setattr(kernels, "_open", _fake_open)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: pytest.fail("nvcc must not run"))
    _entry(state, "probe")
    _entry(state, "gate_counts", payload=b"gate bytes")
    assert [os.path.basename(f) for f in aot.snapshot_files()] == ["gate_counts.aot", "probe.aot"]
    before = _counts()
    summary = aot.restore()
    assert summary["restored"] == 2 and summary["failures"] == {}
    assert set(summary["library_ms"]) == {"gate_counts", "probe"}
    assert kernels.library_origins() == {"gate_counts": "restored", "probe": "restored"}
    first = kernels.loaded_path("probe")
    assert first.parent == kernels.BUILD_DIR / "restored" and first.read_bytes() == b"library bytes"
    assert kernels.library("probe").path == str(first)
    assert kernels.build(["probe"]) == {"probe": first}
    aot.restore()
    assert kernels.loaded_path("probe") != first and first.exists()
    assert aot.clear_restored() == 2 and kernels.library_origins() == {}
    after = _counts()
    assert after[0]["restored"] - before[0].get("restored", 0) == 4
    assert after[0]["probe-failed"] - before[0].get("probe-failed", 0) == 2
    assert after[1]["aot-probe-failed"] - before[1].get("aot-probe-failed", 0) == 1


def test_first_load_writes_the_entry(state, monkeypatch):
    monkeypatch.setattr(kernels, "_open", _fake_open)
    monkeypatch.setattr(kernels, "build", lambda names: {n: state / f"lib{n}.so" for n in names})
    (state / "libprobe.so").write_bytes(b"built bytes")
    kernels.library("probe")
    assert [os.path.basename(f) for f in aot.snapshot_files()] == ["probe.aot"]
    from karpenter_tpu_torch.obs.programs import flag_digest, isa_tag
    from karpenter_tpu_torch.utils import persist

    header, body = persist.load_framed(aot.snapshot_files()[0], kind=aot.AOT_KIND)
    assert body == b"built bytes"
    meta = header["meta"]
    assert (meta["name"], meta["source_digest"], meta["flags"], meta["device"]) == (
        "probe", kernels.source_digest("probe"), flag_digest(), isa_tag())
    assert aot.snapshot_files()[0].startswith(os.path.join(str(state / "state"), "aot", isa_tag()))


def test_recovery_with_no_entries_records_what_the_jax_package_records(state):
    from karpenter_tpu.solver import warmup as jwarm

    jrec, prec = jwarm.restore_and_probe(), warmup.restore_and_probe()
    assert sorted(prec) == sorted(jrec) == ["aot", "phase", "probe", "seconds", "trace_id"]
    assert prec["probe"] == jrec["probe"] == "skipped" and prec["phase"] == jrec["phase"] == "ready"
    assert aot.last_recovery() == prec and not aot.recovery_blocking()


def test_failing_probe_evicts_the_restored_libraries(state, monkeypatch):
    monkeypatch.setattr(kernels, "_open", _fake_open)
    _entry(state, "probe")
    monkeypatch.setattr(warmup, "_probe_solve", lambda **kw: False)
    before = _counts()
    record = warmup.restore_and_probe()
    assert record["probe"] == "failed" and record["evicted"] == 1 and record["phase"] == aot.PHASE_FAILED
    assert kernels.library_origins() == {} and not aot.recovery_blocking()
    assert _counts()[0]["probe-failed"] - before[0].get("probe-failed", 0) == 1


def test_probe_error_evicts_and_reaches_the_fault_handler(state, monkeypatch):
    """A kernel build error in the probe (its library not restored and no
    nvcc) evicts the restored libraries and goes to ``on_fault``."""
    monkeypatch.setattr(kernels, "_open", _fake_open)
    _entry(state, "probe")

    def probe(**kw):
        raise kernels.KernelCompileError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(warmup, "_probe_solve", probe)
    faults = []
    record = warmup.restore_and_probe(on_fault=faults.append)
    assert record["probe"] == "error" and record["evicted"] == 1 and record["phase"] == aot.PHASE_FAILED
    assert "KernelCompileError" in record["error"] and [type(f) for f in faults] == [kernels.KernelCompileError]
    assert kernels.library_origins() == {}


def test_background_recovery_blocks_synchronously(state, monkeypatch):
    import threading

    release = threading.Event()
    monkeypatch.setattr(aot, "restore", lambda: (release.wait(10), {"entries": 0, "restored": 0})[1])
    t = warmup.maybe_recover_in_background()
    try:
        assert aot.recovery_blocking() and aot.recovery_phase() == aot.PHASE_RESTORING
    finally:
        release.set()
        t.join(10)
    assert aot.recovery_phase() == aot.PHASE_READY and aot.last_recovery()["probe"] == "skipped"


def test_readyz_blocks_through_recovery_phases(request):
    """tests/test_restart_resilience.py's scenario through both packages."""
    import tests.test_restart_resilience as TRR
    from tests.torch_port import assert_same_run

    assert_same_run(TRR.test_readyz_blocks_through_recovery_phases, request, digest=False)


def test_statusz_recovery_section_after_a_recovery(state):
    from karpenter_tpu_torch.operator import serving

    warmup.restore_and_probe()
    payload = json.loads(json.dumps(serving.OperatorStatus().statusz(), default=str))
    assert payload["recovery"]["phase"] == "ready"
    assert payload["recovery"]["last_restart_recovery"]["probe"] == "skipped"
    assert ctypes.sizeof(ctypes.c_int) == 4
