"""Flight recorder: a bounded ring of classified events, dumped on incident.

Counterpart of the JAX package's ``obs/flight.py``, ported for what the
solver supervisor, the serve layer, the gate's audit and the streaming layer
call: ``record`` (one classified event into the ring) and ``snapshot_dump`` (the ring to disk through the framed
files of utils/persist.py), with the JAX package's ``KIND_*`` names and
dump reasons for what those callers emit, its flag (``KARPENTER_TPU_SLO``: off, every call is one flag check)
and knobs. ``record`` raises on a kind outside :data:`KINDS` and
``snapshot_dump`` on a reason outside :data:`DUMP_REASONS`; a dump that
cannot be written returns None; dumps are debounced
(``KARPENTER_TPU_FLIGHT_DEBOUNCE_S``) and capped
(``KARPENTER_TPU_FLIGHT_MAX``), oldest evicted first. ``load_dump`` and
``scan_dumps`` read them back, and ``debug_payload`` is the operator's
``/debug/flight`` body (operator/serving.py).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from karpenter_tpu_torch.obs import trace
from karpenter_tpu_torch.utils.persist import PersistError, load_framed, write_framed

# Monkeypatchable clock so window/dump tests are deterministic.
_wall = time.time

DUMP_KIND = "flight-ring"  # framed-protocol kind tag
DUMP_VERSION = 1

# -- the bounded event vocabulary ---------------------------------------------
# One kind per instrumented decision point. record() raises on anything else:
# an unclassified flight event is a bug. The vocabulary is the JAX
# package's, every kind with an emitter in this package.
KIND_SOLVE_CYCLE = "solve-cycle"
KIND_SOLVE_RETRY = "solve-retry"
KIND_SOLVE_FALLBACK = "solve-fallback"
KIND_SOLVE_SALVAGE = "solve-salvage"
KIND_CIRCUIT = "circuit"
KIND_VALIDATOR_REJECT = "validator-reject"
KIND_QUARANTINE = "quarantine"
KIND_GATE_AUDIT = "gate-audit"
KIND_ADMISSION = "admission"
KIND_SERVE_COMPLETE = "serve-complete"
KIND_STREAM_CYCLE = "stream-cycle"
KIND_MESH_FAULT = "mesh-fault"
KIND_MESH_RECARVE = "mesh-recarve"
KIND_MESH_RECOVERED = "mesh-recovered"
KIND_SHARD_STANDDOWN = "shard-standdown"
KIND_SLO_BREACH = "slo-breach"
KIND_DUMP = "flight-dump"

KINDS = frozenset({
    KIND_SOLVE_CYCLE, KIND_SOLVE_RETRY, KIND_SOLVE_FALLBACK,
    KIND_SOLVE_SALVAGE, KIND_CIRCUIT, KIND_VALIDATOR_REJECT, KIND_QUARANTINE,
    KIND_GATE_AUDIT, KIND_ADMISSION, KIND_SERVE_COMPLETE, KIND_STREAM_CYCLE,
    KIND_MESH_FAULT, KIND_MESH_RECARVE, KIND_MESH_RECOVERED,
    KIND_SHARD_STANDDOWN, KIND_SLO_BREACH, KIND_DUMP,
})

# What may trigger a dump — the incident classes, not the event kinds.
DUMP_REASONS = frozenset({
    "slo-breach", "circuit-open", "recarve", "validator-reject", "manual",
})

_enabled_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force the recorder on/off (tests, bench); ``None`` restores the env
    flag. Shares ``KARPENTER_TPU_SLO`` with the SLO engine — they are one
    feature."""
    global _enabled_override
    _enabled_override = value


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("KARPENTER_TPU_SLO", "") not in ("", "0")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def dump_dir() -> str:
    """``KARPENTER_TPU_FLIGHT_DIR``, else ``$KARPENTER_TPU_STATE_DIR/flight``,
    else a directory under the temporary directory — same resolution order
    as the quarantine ring."""
    explicit = os.environ.get("KARPENTER_TPU_FLIGHT_DIR")
    if explicit:
        return explicit
    state = os.environ.get("KARPENTER_TPU_STATE_DIR")
    if state:
        return os.path.join(state, "flight")
    return os.path.join(tempfile.gettempdir(), "karpenter-tpu-flight")


class FlightRing:
    """Bounded ring of flight records (plain dicts, newest last)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = _env_int("KARPENTER_TPU_FLIGHT_RING", 512)
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self.recorded = 0  # lifetime count, beyond the ring bound

    def append(self, rec: Dict) -> None:
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def snapshot(self) -> List[Dict]:
        """Chronological (oldest first) — the causal-timeline order."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.recorded = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_ring: Optional[FlightRing] = None
_ring_lock = threading.Lock()
_dump_lock = threading.Lock()
_last_dump_at = 0.0
_dump_seq = 0


def ring() -> FlightRing:
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = FlightRing()
    return _ring


def reset(capacity: Optional[int] = None) -> FlightRing:
    """Replace the ring and clear the dump debounce (tests; re-reads
    KARPENTER_TPU_FLIGHT_RING)."""
    global _ring, _last_dump_at
    with _ring_lock:
        _ring = FlightRing(capacity)
    with _dump_lock:
        _last_dump_at = 0.0
    return _ring


def record(kind: str, trace_id: Optional[str] = None, **detail) -> None:
    """Append one classified record. O(1): a flag check, a dict, a deque
    append under the ring lock. No-op (one flag check) when disabled."""
    if not enabled():
        return
    if kind not in KINDS:
        raise ValueError(f"unclassified flight event kind {kind!r}")
    if trace_id is None:
        trace_id = trace.current_trace_id()
    rec: Dict[str, object] = {"t": _wall(), "kind": kind}
    if trace_id:
        rec["trace_id"] = trace_id
    if detail:
        # absent beats null in a capped ring: callers pass optional context
        # (tenant, path) unconditionally and None would bloat every record
        rec.update({k: v for k, v in detail.items() if v is not None})
    ring().append(rec)


def _evict(directory: str, keep: int) -> None:
    try:
        dumps = sorted(
            f for f in os.listdir(directory)
            if f.startswith("flight-") and f.endswith(".bin")
        )
    except OSError:
        return
    for stale in dumps[: max(0, len(dumps) - keep)]:
        try:
            os.remove(os.path.join(directory, stale))
        except OSError:
            pass


def snapshot_dump(reason: str, objective: Optional[str] = None) -> Optional[str]:
    """Snapshot the ring to ``dump_dir()`` under the framed protocol. Returns
    the dump path, or None when disabled, debounced, or the write failed
    (best-effort: incident capture must never break the path it observes)."""
    global _last_dump_at, _dump_seq
    if not enabled():
        return None
    if reason not in DUMP_REASONS:
        raise ValueError(f"unclassified flight dump reason {reason!r}")
    now = _wall()
    with _dump_lock:
        if now - _last_dump_at < _env_float("KARPENTER_TPU_FLIGHT_DEBOUNCE_S", 5.0):
            return None
        _last_dump_at = now
        _dump_seq += 1
        seq = _dump_seq
    events = ring().snapshot()
    payload = json.dumps({
        "reason": reason,
        "objective": objective,
        "captured_unix": now,
        "pid": os.getpid(),
        "events": events,
    }, sort_keys=True).encode()
    directory = dump_dir()
    path = os.path.join(
        directory, f"flight-{int(now * 1000)}-{os.getpid()}-{seq}.bin"
    )
    meta = {"reason": reason, "events": len(events)}
    if objective:
        meta["objective"] = objective
    try:
        write_framed(path, payload, kind=DUMP_KIND, version=DUMP_VERSION, meta=meta)
    except OSError:
        return None
    _evict(directory, _env_int("KARPENTER_TPU_FLIGHT_MAX", 16))
    from karpenter_tpu_torch.metrics.registry import FLIGHT_DUMPS

    FLIGHT_DUMPS.inc({"reason": reason})
    record(KIND_DUMP, reason=reason, path=path, events=len(events))
    return path


def load_dump(path: str) -> Dict:
    """Load one dump; raises :class:`PersistError` with a classified reason
    (missing / truncated / corrupt / checksum / version-skew) on damage."""
    header, payload = load_framed(path, kind=DUMP_KIND, min_version=DUMP_VERSION)
    try:
        body = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise PersistError("corrupt", "unparseable flight payload") from exc
    body["header"] = header
    return body


def scan_dumps(directory: Optional[str] = None) -> List[str]:
    """Dump paths, oldest first (filenames embed the capture time)."""
    directory = directory or dump_dir()
    try:
        names = sorted(
            f for f in os.listdir(directory)
            if f.startswith("flight-") and f.endswith(".bin")
        )
    except OSError:
        return []
    return [os.path.join(directory, f) for f in names]


def debug_payload() -> Dict:
    """The ``/debug/flight`` body: ring contents plus the on-disk dump
    inventory (each dump loadable offline with tools/flight_report.py)."""
    r = ring()
    return {
        "enabled": enabled(),
        "captured": len(r),
        "recorded": r.recorded,
        "dump_dir": dump_dir(),
        "dumps": [os.path.basename(p) for p in scan_dumps()],
        "events": r.snapshot(),
    }
