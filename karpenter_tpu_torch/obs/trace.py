"""Solve-cycle tracing: phase spans and a ring of the last cycles.

Counterpart of the JAX package's ``obs/trace.py``, ported for what the
solver supervisor, the serve layer and the explain pass call: ``cycle`` (a
solve cycle's root, or a nested span when one is already open), ``span`` (a
phase span under it), ``attr`` and ``current_trace_id``. The same span names and attributes, the same
``KARPENTER_TPU_TRACE`` flag (off: every call is a no-op), the same
self-time accounting (``phase_totals`` sums to the root's wall clock), and
the same per-phase histogram (``karpenter_solver_phase_duration_seconds``),
and the same Chrome trace-event exporter (``to_chrome_trace``,
``chrome_trace_json``), which ``/debug/traces?format=chrome`` serves
(operator/serving.py).
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

# Monkeypatchable clocks so golden-file tests are deterministic.
_perf = time.perf_counter
_wall = time.time

_enabled_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force tracing on/off (tests, bench); ``None`` restores the env flag."""
    global _enabled_override
    _enabled_override = value


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("KARPENTER_TPU_TRACE", "") not in ("", "0")


class Span:
    __slots__ = ("name", "t0", "dur", "attrs", "counters", "children")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.t0 = _perf()
        self.dur: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self.counters: Dict[str, float] = {}
        self.children: List["Span"] = []

    def close(self) -> None:
        if self.dur is None:
            self.dur = _perf() - self.t0

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value


class Trace:
    """One solve cycle: a root span plus its tree, identified by a trace id."""

    def __init__(self, name: str, backend: Optional[str] = None, **attrs):
        self.trace_id = "t-" + uuid.uuid4().hex[:16]
        self.start_unix = _wall()
        self.backend = backend
        self.root = Span(name, **attrs)

    def finish(self) -> None:
        # Force-close leaves-first so durations of abandoned spans (deadline
        # watchdog leaves its worker's spans open) stay within their parents.
        def _close(span: Span) -> None:
            for child in span.children:
                _close(child)
            if span.dur is None:
                span.attrs["unclosed"] = True
                span.close()
        _close(self.root)

    def duration_s(self) -> float:
        return self.root.dur if self.root.dur is not None else 0.0

    def phase_totals(self) -> Dict[str, float]:
        """Per-phase *self time* keyed by span name; sums to the root wall
        clock exactly (each instant belongs to exactly one span)."""
        totals: Dict[str, float] = {}

        def _walk(span: Span) -> None:
            child_time = sum(c.dur or 0.0 for c in span.children)
            self_time = max(0.0, (span.dur or 0.0) - child_time)
            totals[span.name] = totals.get(span.name, 0.0) + self_time
            for child in span.children:
                _walk(child)

        _walk(self.root)
        return totals

    def to_dict(self) -> Dict:
        def _span(span: Span, base: float) -> Dict:
            out: Dict[str, object] = {
                "name": span.name,
                "offset_s": round(span.t0 - base, 9),
                "duration_s": round(span.dur or 0.0, 9),
            }
            if span.attrs:
                out["attrs"] = dict(span.attrs)
            if span.counters:
                out["counters"] = dict(span.counters)
            if span.children:
                out["children"] = [_span(c, base) for c in span.children]
            return out

        return {
            "trace_id": self.trace_id,
            "name": self.root.name,
            "backend": self.backend,
            "start_unix": self.start_unix,
            "duration_s": round(self.duration_s(), 9),
            "phases": {k: round(v, 9) for k, v in self.phase_totals().items()},
            "root": _span(self.root, self.root.t0),
        }


_cur_trace: contextvars.ContextVar[Optional[Trace]] = contextvars.ContextVar(
    "karpenter_tpu_trace", default=None
)
_cur_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "karpenter_tpu_span", default=None
)


class TraceRing:
    """Bounded ring of the last N published cycle traces (as plain dicts)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("KARPENTER_TPU_TRACE_RING", "64"))
            except ValueError:
                capacity = 64
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()

    def append(self, trace_dict: Dict) -> None:
        with self._lock:
            self._ring.append(trace_dict)

    def snapshot(self) -> List[Dict]:
        """Most recent first."""
        with self._lock:
            return list(reversed(self._ring))


_ring: Optional[TraceRing] = None
_ring_lock = threading.Lock()


def ring() -> TraceRing:
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = TraceRing()
    return _ring


def reset_ring(capacity: Optional[int] = None) -> TraceRing:
    """Replace the ring (tests; re-reads KARPENTER_TPU_TRACE_RING)."""
    global _ring
    with _ring_lock:
        _ring = TraceRing(capacity)
    return _ring


def publish(tr: Trace) -> None:
    tr.finish()
    ring().append(tr.to_dict())
    # Sink (a): per-phase Prometheus histograms. Imported lazily to keep the
    # module import-light for tools that only want the exporter.
    from karpenter_tpu_torch.metrics.registry import SOLVER_PHASE_DURATION

    backend = tr.backend or ""
    for phase, secs in tr.phase_totals().items():
        SOLVER_PHASE_DURATION.observe(secs, {"phase": phase, "backend": backend})


@contextmanager
def cycle(name: str, backend: Optional[str] = None, passthrough: bool = False, **attrs):
    """Open a cycle root. If a cycle is already active (the provisioner opened
    one before calling the supervisor), this nests as a span instead, updating
    the trace's backend if one is given — every layer can call ``cycle()``
    without caring whether it is outermost. ``passthrough=True`` skips even
    the nested span (the backend's own phases land directly under whatever
    span the caller holds)."""
    if not enabled():
        yield None
        return
    existing = _cur_trace.get()
    if existing is not None:
        if backend is not None and existing.backend is None:
            existing.backend = backend
        if passthrough:
            yield existing
            return
        with span(name, **attrs):
            yield existing
        return
    tr = Trace(name, backend=backend, **attrs)
    trace_token = _cur_trace.set(tr)
    span_token = _cur_span.set(tr.root)
    try:
        yield tr
    finally:
        _cur_span.reset(span_token)
        _cur_trace.reset(trace_token)
        tr.root.close()  # an orderly exit; finish() marks only abandoned spans
        publish(tr)


@contextmanager
def span(name: str, **attrs):
    """A phase span nested under the current one; no-op outside a cycle."""
    if not enabled():
        yield None
        return
    parent = _cur_span.get()
    if parent is None:
        yield None
        return
    sp = Span(name, **attrs)
    parent.children.append(sp)
    token = _cur_span.set(sp)
    try:
        yield sp
    finally:
        _cur_span.reset(token)
        sp.close()


def attr(name: str, value) -> None:
    """Attach an attribute to the current span (no-op outside one)."""
    sp = _cur_span.get()
    if sp is not None:
        sp.attrs[name] = value


def current_trace_id() -> Optional[str]:
    tr = _cur_trace.get()
    return tr.trace_id if tr is not None else None


def count(name: str, value: float) -> None:
    """Add to a counter on the current span (no-op outside one)."""
    sp = _cur_span.get()
    if sp is not None:
        sp.count(name, value)


# -- Chrome trace-event exporter (sink c) ------------------------------------
# https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
# "X" complete events with ts/dur in microseconds; loads in Perfetto and
# chrome://tracing. One tid per trace so concurrent cycles render as lanes.


def to_chrome_trace(trace_dicts: Iterable[Dict]) -> Dict:
    traces = list(trace_dicts)
    events: List[Dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "args": {"name": "karpenter-tpu solver"},
        }
    ]
    if not traces:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base_unix = min(t.get("start_unix", 0.0) for t in traces)
    for tid, tr in enumerate(sorted(traces, key=lambda t: t.get("start_unix", 0.0)), 1):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": f"{tr.get('name', 'cycle')} {tr.get('trace_id', '')}"},
            }
        )
        trace_offset_us = (tr.get("start_unix", base_unix) - base_unix) * 1e6

        def _emit(node: Dict, tid: int = tid, trace_offset_us: float = trace_offset_us):
            args: Dict[str, object] = dict(node.get("attrs", {}))
            counters = node.get("counters")
            if counters:
                args["counters"] = dict(counters)
            events.append(
                {
                    "name": node["name"],
                    "ph": "X",
                    "pid": 1,
                    "tid": tid,
                    "ts": round(trace_offset_us + node["offset_s"] * 1e6, 3),
                    "dur": round(node["duration_s"] * 1e6, 3),
                    "args": args,
                }
            )
            for child in node.get("children", ()):
                _emit(child)

        _emit(tr["root"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_json(trace_dicts: Iterable[Dict], indent: Optional[int] = None) -> str:
    return json.dumps(to_chrome_trace(trace_dicts), indent=indent, sort_keys=True)
