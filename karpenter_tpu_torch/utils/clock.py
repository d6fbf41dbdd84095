"""Injectable clocks (equivalent of k8s.io/utils/clock + clock/testing).

Deterministic time drives every TTL decision in the framework (consolidation
TTLs, liveness, expiry), so controllers never call time.time() directly.
"""

from __future__ import annotations

import threading
import time as _time


class Clock:
    """Real wall clock."""

    def now(self) -> float:
        return _time.time()

    def since(self, t: float) -> float:
        return self.now() - t

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)


class FakeClock(Clock):
    """Manually-stepped clock for tests (clock/testing.FakeClock)."""

    def __init__(self, start: float = 1_700_000_000.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def set(self, t: float) -> None:
        with self._lock:
            self._now = t

    def sleep(self, seconds: float) -> None:
        self.step(seconds)
