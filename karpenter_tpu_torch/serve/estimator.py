"""Queue-wait estimation for admission: a time-decayed EWMA of per-request
service time.

The admission gate sheds a request at the door when ``backlog x estimate``
exceeds its wait bound. Counterpart of the JAX package's
``serve/estimator.py``. Two properties the raw per-request
EWMA the dispatcher used to carry did not have:

  time decay     the old estimate was updated only when a solve COMPLETED, so
                 across an idle gap it froze at whatever the last busy period
                 measured. The first requests of the next burst were then shed
                 against a stale number (a warm cache and an idle device serve
                 the new burst much faster than the saturated tail of the old
                 one). Here the estimate decays toward zero with wall-clock
                 age: ``estimate(t) = ewma x max(floor, 0.5^(age/half_life))``.
  staleness floor the decay never goes below ``floor`` x the learned value: a
                 service that was genuinely slow does not forget that entirely
                 just because nobody asked for a minute — the first burst
                 request still meets SOME skepticism, the hundredth meets a
                 fresh estimate again.

Fed with per-request SERVICE time (dispatch wall amortized over the stacked
group), not queue-inclusive latency: predicted wait is ``backlog x per-request
service``; feeding queue-inclusive latency double-counts the queue and makes
admission collapse under exactly the sustained load it exists to manage.

Knobs (read by the dispatcher at construction):

  KARPENTER_TPU_SERVE_EWMA_HALF_LIFE_S  decay half-life, seconds (5)
  KARPENTER_TPU_SERVE_EWMA_FLOOR        staleness floor fraction (0.25)
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# heavily weighted to history so one fast warm solve doesn't swing the
# admission gate open mid-overload (same alpha the dispatcher always used)
DEFAULT_ALPHA = 0.2


class WaitEstimator:
    """Thread-safe: the dispatcher observes, submitter threads read."""

    def __init__(
        self,
        alpha: float = DEFAULT_ALPHA,
        half_life_s: float = 5.0,
        floor: float = 0.25,
        time_fn=time.monotonic,
    ):
        self.alpha = float(alpha)
        self.half_life_s = max(1e-3, float(half_life_s))
        self.floor = min(1.0, max(0.0, float(floor)))
        self._time = time_fn
        self._lock = threading.Lock()
        self._ewma = 0.0
        self._observed_at: Optional[float] = None
        self.observations = 0

    def observe(self, service_s: float, now: Optional[float] = None) -> None:
        """Fold one completed request's per-request service time in."""
        if service_s < 0:
            return
        now = self._time() if now is None else now
        with self._lock:
            self._ewma = (
                service_s
                if self._ewma == 0
                else (1 - self.alpha) * self._ewma + self.alpha * service_s
            )
            self._observed_at = now
            self.observations += 1

    def seed(self, service_s: float, now: Optional[float] = None) -> None:
        """Pessimistically pre-load the estimate (replica failover: a
        survivor absorbing a dead replica's tenants should meet the surge
        with backpressure BEFORE the first migrated solve completes). Only
        raises the estimate — a survivor that already learned it is slower
        keeps its own number."""
        if service_s <= 0:
            return
        now = self._time() if now is None else now
        with self._lock:
            if service_s > self._ewma:
                self._ewma = float(service_s)
                self._observed_at = now

    def per_request_s(self, now: Optional[float] = None) -> float:
        """The decayed per-request service estimate; 0.0 before any sample
        (no estimate means no predicted-wait shedding — admission falls back
        to the queue-depth bound alone)."""
        now = self._time() if now is None else now
        with self._lock:
            if self._ewma == 0 or self._observed_at is None:
                return 0.0
            age = max(0.0, now - self._observed_at)
            decay = max(self.floor, 0.5 ** (age / self.half_life_s))
            return self._ewma * decay

    def predicted_wait_s(self, backlog: int, now: Optional[float] = None) -> float:
        return max(0, int(backlog)) * self.per_request_s(now)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ewma_s": round(self._ewma, 6),
                "observations": self.observations,
                "half_life_s": self.half_life_s,
                "floor": self.floor,
            }
