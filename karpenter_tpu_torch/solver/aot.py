"""Kernel-library snapshots: built libraries that survive a restart.

Counterpart of the JAX package's ``solver/aot.py``. A fresh process of the
port builds its eight kernel libraries with ``nvcc`` (kernels.py), which
takes minutes and needs the CUDA toolkit. When ``KARPENTER_TPU_AOT_RESTORE``
is on and ``KARPENTER_TPU_STATE_DIR`` set, the first build or load of each
library writes its snapshot entry into ``<state>/aot/<device tag>/``, and a
restarted process restores the lot before any build, so that
``kernels.library()`` never runs ``nvcc`` for a restored library.

An entry is one library: the built ``lib<name>-<digest>.so`` bytes, framed
by utils/persist.write_framed under the kind ``aot-entry-torch``, with meta:
the library's source-and-flags digest (kernels.source_digest), the
program-keying flags' digest (obs/programs.flag_digest), the device tag
(obs/programs.isa_tag) and the torch and CUDA versions.

Restore classification (``karpenter_solver_aot_restore_total{result}`` and
``karpenter_restore_fallback_total{reason="aot-*"}``): every entry restores
or lands in exactly one of the JAX package's failure labels: ``truncated``,
``corrupt``, ``checksum`` (the frame), ``version-skew`` (the frame's version,
the torch or CUDA version, or a source digest that is not the tree's),
``isa-mismatch`` (another card or ``sm``), ``flag-mismatch``,
``deserialize-error`` (the library does not ``dlopen``, or lacks a
``<name>_launch`` / args-size symbol), and, after the probe solve,
``probe-failed``. A good entry is written under a fresh name (never over a
file a live process has mapped), atomically, and loaded in place of a build
(kernels.install). A failed entry degrades to an ``nvcc`` build at first
use, as the JAX package degrades to a cold compile; with ``nvcc`` missing or
failing that build raises ``KernelCompileError``, as it does without
snapshots.

Two points differ from the JAX package:

  * the JAX package's hook sits at each dispatch (``maybe_begin``) and its
    table holds one executable per shape; the port's hook sits at library
    load, so the table holds one entry per library;
  * ``clear_restored()`` drops the restored libraries from the loaded set
    (kernels.evict). ``ctypes`` cannot unload a library, so the next use
    loads one built under ``_build/``, never the evicted file.

Recovery sequencing for /readyz (operator/serving.py): the recovery runner
(solver/warmup.restore_and_probe) drives the JAX package's phase machine,
``idle -> restoring -> probing -> ready|failed``, and readiness is held
false while a recovery is in flight.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

AOT_VERSION = 1
AOT_KIND = "aot-entry-torch"
_FILE_SUFFIX = ".aot"

# restore failure reasons (doubles as the bounded label-value set)
REASONS = (
    "missing", "truncated", "corrupt", "checksum", "version-skew",
    "isa-mismatch", "flag-mismatch", "deserialize-error", "probe-failed",
)


def enabled() -> bool:
    """Opt-in twice over: the flag AND a state dir."""
    return (
        os.environ.get("KARPENTER_TPU_AOT_RESTORE", "") not in ("", "0")
        and bool(os.environ.get("KARPENTER_TPU_STATE_DIR"))
    )


def state_dir() -> Optional[str]:
    return os.environ.get("KARPENTER_TPU_STATE_DIR") or None


def aot_dir() -> Optional[str]:
    """The snapshot directory, keyed by the device tag: a library built for
    one card and toolchain is never loaded on another."""
    root = state_dir()
    if not root:
        return None
    from karpenter_tpu_torch.obs.programs import isa_tag

    return os.path.join(root, "aot", isa_tag())


def _versions() -> Dict[str, Optional[str]]:
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda}


# -- the library table ---------------------------------------------------------


class _Entry:
    __slots__ = ("name", "source", "path")

    def __init__(self, name: str, source: str, path: Optional[str]):
        self.name = name
        self.source = source  # "written" | "restored"
        self.path = path


_lock = threading.Lock()
_table: Dict[str, _Entry] = {}
_warned: set = set()
_seq = itertools.count()


def _warn_once(tag: str, msg: str, *args) -> None:
    if tag in _warned:
        return
    _warned.add(tag)
    log.warning(msg, *args)


def restored_count() -> int:
    with _lock:
        return sum(1 for e in _table.values() if e.source == "restored")


def reset_table() -> None:
    """Drop the in-memory table (tests / simulated restart). Snapshot files
    stay on disk, and loaded libraries stay loaded."""
    with _lock:
        _table.clear()


def clear_restored(reason: str = "probe-failed") -> int:
    """Evict the restored libraries (probe failure): later launches build
    or load them under ``_build/`` instead of trusting a library that could
    not produce a valid placement. Returns how many were dropped."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics.registry import AOT_RESTORE, RESTORE_FALLBACK

    with _lock:
        bad = [n for n, e in _table.items() if e.source == "restored"]
        for n in bad:
            del _table[n]
    kernels.evict(bad)
    if bad:
        AOT_RESTORE.inc({"result": reason}, len(bad))
        RESTORE_FALLBACK.inc({"reason": f"aot-{reason}"})
    return len(bad)


# -- snapshot persistence ------------------------------------------------------


def entry_path(name: str) -> Optional[str]:
    directory = aot_dir()
    if directory is None:
        return None
    return os.path.join(directory, name + _FILE_SUFFIX)


def persist_library(name: str, path) -> Optional[str]:
    """Write the snapshot entry of a library this process built or loaded
    from ``_build/`` (kernels.library calls it once per load). No-op when
    snapshots are off. Best-effort: a failed write costs the next process a
    build, never this one a solve."""
    if not enabled():
        return None
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics.registry import RESTORE_FALLBACK

    out = entry_path(name)
    try:
        from karpenter_tpu_torch.obs.programs import flag_digest, isa_tag
        from karpenter_tpu_torch.utils import persist

        persist.write_framed(
            out, Path(path).read_bytes(), kind=AOT_KIND, version=AOT_VERSION,
            meta={
                "name": name,
                "library": Path(path).name,
                "source_digest": kernels.source_digest(name),
                "flags": flag_digest(),
                "device": isa_tag(),
                **_versions(),
            },
        )
        with _lock:
            _table[name] = _Entry(name, "written", out)
        return out
    except Exception as exc:  # noqa: BLE001
        RESTORE_FALLBACK.inc({"reason": "aot-persist-error"})
        _warn_once("persist", "aot: snapshot write failed for %s: %s: %s", name, type(exc).__name__, exc)
        return None


def _materialize(name: str, digest: str, payload: bytes) -> Path:
    """Write a restored library under a fresh name, atomically."""
    from karpenter_tpu_torch import kernels

    directory = kernels.BUILD_DIR / "restored"
    directory.mkdir(parents=True, exist_ok=True)
    out = directory / f"lib{name}-{digest}.{os.getpid()}.{next(_seq)}.so"
    tmp = out.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


def restore() -> Dict:
    """Load every snapshot entry that matches this tree, card, flags and
    toolchain as a ``restored`` library. Every entry resolves to exactly one
    classified result. Returns a summary dict."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics.registry import AOT_RESTORE, RESTORE_FALLBACK
    from karpenter_tpu_torch.utils.persist import PersistError, load_framed

    t0 = time.perf_counter()
    summary: Dict = {"entries": 0, "restored": 0, "failures": {}, "libraries": {}, "library_ms": {}}

    def fail(name: str, reason: str) -> None:
        summary["failures"][reason] = summary["failures"].get(reason, 0) + 1
        summary["libraries"][name] = reason
        AOT_RESTORE.inc({"result": reason})
        RESTORE_FALLBACK.inc({"reason": f"aot-{reason}"})

    directory = aot_dir()
    if not enabled() or directory is None or not os.path.isdir(directory):
        summary["seconds"] = time.perf_counter() - t0
        return summary
    from karpenter_tpu_torch.obs.programs import flag_digest, isa_tag

    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(_FILE_SUFFIX):
            continue
        summary["entries"] += 1
        entry = fname[: -len(_FILE_SUFFIX)]
        t_entry = time.perf_counter()
        try:
            header, payload = load_framed(os.path.join(directory, fname), kind=AOT_KIND,
                                          min_version=AOT_VERSION)
        except PersistError as exc:
            fail(entry, exc.reason)
            continue
        meta = header.get("meta", {})
        name = meta.get("name")
        if meta.get("device") != isa_tag():
            fail(entry, "isa-mismatch")
            continue
        if meta.get("flags") != flag_digest():
            fail(entry, "flag-mismatch")
            continue
        if (name not in kernels.SOURCES or meta.get("source_digest") != kernels.source_digest(name)
                or any(meta.get(k) != v for k, v in _versions().items())):
            fail(entry, "version-skew")
            continue
        try:
            path = _materialize(name, meta["source_digest"], payload)
            kernels.install(name, path)
        except Exception as exc:  # noqa: BLE001 — checksummed, but be exhaustive
            fail(name, "deserialize-error")
            _warn_once("deserialize", "aot: entry %s failed to load: %s: %s", fname, type(exc).__name__, exc)
            continue
        with _lock:
            _table[name] = _Entry(name, "restored", str(path))
        summary["restored"] += 1
        summary["libraries"][name] = "restored"
        summary["library_ms"][name] = (time.perf_counter() - t_entry) * 1e3
        AOT_RESTORE.inc({"result": "restored"})
    summary["seconds"] = time.perf_counter() - t0
    return summary


def snapshot_files() -> List[str]:
    directory = aot_dir()
    if directory is None or not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, n) for n in os.listdir(directory) if n.endswith(_FILE_SUFFIX)
    )


# -- recovery state machine (consulted by /readyz) -----------------------------

PHASE_IDLE = "idle"
PHASE_RESTORING = "restoring"
PHASE_PROBING = "probing"
PHASE_READY = "ready"
PHASE_FAILED = "failed"

_recovery_lock = threading.Lock()
_recovery_phase = PHASE_IDLE
_last_recovery: Optional[Dict] = None


def set_recovery_phase(phase: str) -> None:
    global _recovery_phase
    with _recovery_lock:
        _recovery_phase = phase


def recovery_phase() -> str:
    with _recovery_lock:
        return _recovery_phase


def recovery_blocking() -> bool:
    """True while a recovery is in flight: /readyz stays false until the
    restored libraries pass a probe solve. ``failed`` does not block: the
    recovery degrades to builds."""
    with _recovery_lock:
        return _recovery_phase in (PHASE_RESTORING, PHASE_PROBING)


def finish_recovery(record: Optional[Dict], phase: str) -> None:
    global _recovery_phase, _last_recovery
    with _recovery_lock:
        _recovery_phase = phase
        if record is not None:
            _last_recovery = dict(record)


def last_recovery() -> Optional[Dict]:
    """The /statusz ``last_restart_recovery`` payload (None before any)."""
    with _recovery_lock:
        return dict(_last_recovery) if _last_recovery is not None else None


def reset_recovery_for_tests() -> None:
    global _recovery_phase, _last_recovery
    with _recovery_lock:
        _recovery_phase = PHASE_IDLE
        _last_recovery = None
