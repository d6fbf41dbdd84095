"""Deduplicated, rate-limited event recorder.

Equivalent of reference pkg/events/recorder.go:30-95: events are keyed by
(involved object kind/name, reason, message) and each key is published at most
once per TTL window, with a flow-control token bucket per coarser
(kind/name/reason) key — a 10k-pod failure storm that varies only the message
(per-pod forensics strings do) still drains each object's bucket instead of
flooding the log. Our store keeps the published events in memory so tests can
assert on them (the reference's test recorder counts publishes,
events/suite_test.go:42-70). Suppressions are exported via
``karpenter_events_deduped_total{cause}`` (duplicate | rate-limited).
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

NORMAL = "Normal"
WARNING = "Warning"

_DEDUPE_TTL = 2 * 60.0  # recorder.go:36
# flow control per (kind|name|reason) key, the reference's bucket shape
# (recorder.go:40: 10 qps, burst 25)
_RATE_LIMIT_QPS = 10.0
_RATE_LIMIT_BURST = 25.0


@dataclass
class Event:
    involved_kind: str = ""
    involved_name: str = ""
    type: str = NORMAL
    reason: str = ""
    message: str = ""
    timestamp: float = 0.0

    def dedupe_key(self) -> str:
        return "|".join([self.involved_kind, self.involved_name, self.reason, self.message])

    def rate_key(self) -> str:
        """Flow-control key: message excluded, so per-pod message variation
        cannot sidestep the bucket."""
        return "|".join([self.involved_kind, self.involved_name, self.reason])


def object_event(obj, type_: str, reason: str, message: str) -> Event:
    return Event(
        involved_kind=type(obj).__name__,
        involved_name=getattr(obj.metadata, "name", ""),
        type=type_,
        reason=reason,
        message=message,
    )


@dataclass
class Recorder:
    clock: Optional[object] = None
    events: List[Event] = field(default_factory=list)
    _last_published: Dict[str, float] = field(default_factory=dict)
    # rate_key -> (tokens, last refill time) token bucket
    _buckets: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    rate_limit_qps: float = _RATE_LIMIT_QPS
    rate_limit_burst: float = _RATE_LIMIT_BURST
    calls: int = 0  # every publish() attempt, pre-dedup
    deduped: int = 0  # suppressed as within-TTL duplicates
    rate_limited: int = 0  # suppressed by the per-key bucket

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _time.time()

    def _suppress(self, cause: str) -> None:
        from karpenter_tpu_torch.metrics.registry import EVENTS_DEDUPED

        EVENTS_DEDUPED.inc({"cause": cause})

    def _take_token(self, key: str, now: float) -> bool:
        tokens, last = self._buckets.get(key, (self.rate_limit_burst, now))
        tokens = min(
            self.rate_limit_burst, tokens + (now - last) * self.rate_limit_qps
        )
        if tokens < 1.0:
            self._buckets[key] = (tokens, now)
            return False
        self._buckets[key] = (tokens - 1.0, now)
        return True

    def publish(self, *events: Event):
        for ev in events:
            self.calls += 1
            key = ev.dedupe_key()
            now = self._now()
            last = self._last_published.get(key)
            if last is not None and now - last < _DEDUPE_TTL:
                self.deduped += 1
                self._suppress("duplicate")
                continue
            if not self._take_token(ev.rate_key(), now):
                self.rate_limited += 1
                self._suppress("rate-limited")
                continue
            self._last_published[key] = now
            # store a copy: a caller-retained Event must not alias the log
            self.events.append(dataclasses.replace(ev, timestamp=now))

    def reset(self):
        self.events.clear()
        self._last_published.clear()
        self._buckets.clear()
        self.calls = 0
        self.deduped = 0
        self.rate_limited = 0

    def count(self, reason: str) -> int:
        return sum(1 for e in self.events if e.reason == reason)

    def for_object(self, obj) -> List[Event]:
        kind, name = type(obj).__name__, obj.metadata.name
        return [e for e in self.events if e.involved_kind == kind and e.involved_name == name]
