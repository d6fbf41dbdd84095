"""Pod-arrival batching window.

Equivalent of reference pkg/controllers/provisioning/batcher.go: the
provisioner waits for a quiet period so one solve covers a burst of pods —
wait returns after ``idle_duration`` with no new triggers, or ``max_duration``
after the first trigger, whichever comes first (batcher.go:52-76).

For the streaming solve path (streaming/) the batcher also accumulates the
*events* behind the triggers: watch handlers call :meth:`note` with whatever
delta object they saw (pod added/deleted, node reclaimed), and the
provisioning loop calls :meth:`drain` once ``wait`` returns to get the batch
of deltas that formed the window — feeding the delta encoder the changes
directly instead of making it re-diff full snapshots.
"""

from __future__ import annotations

import threading
from typing import Any, List

from karpenter_tpu_torch.utils.clock import Clock

DEFAULT_IDLE_SECONDS = 1.0
DEFAULT_MAX_SECONDS = 10.0
_POLL_SECONDS = 0.01  # immediate() poll period (batcher.go:60)


class Batcher:
    def __init__(
        self,
        clock: Clock,
        idle_duration: float = DEFAULT_IDLE_SECONDS,
        max_duration: float = DEFAULT_MAX_SECONDS,
    ):
        self._clock = clock
        self.idle_duration = idle_duration
        self.max_duration = max_duration
        self._trigger = threading.Event()
        self._lock = threading.Lock()
        self._last_trigger = 0.0
        self._events: List[Any] = []

    def trigger(self) -> None:
        """Signal pod arrival (batcher.go:42-48)."""
        with self._lock:
            self._last_trigger = self._clock.now()
        self._trigger.set()

    def note(self, event: Any) -> None:
        """Record one delta event and extend the batch window. Events are
        opaque to the batcher; the streaming path passes whatever its watch
        handlers produce and replays them from :meth:`drain` in arrival
        order."""
        with self._lock:
            self._events.append(event)
            self._last_trigger = self._clock.now()
        self._trigger.set()

    def drain(self) -> List[Any]:
        """Return (and clear) the events accumulated since the last drain —
        the deltas that make up the batch ``wait`` just formed."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def wait(self) -> bool:
        """Block until a batch has formed. Returns True if at least one
        trigger arrived (batcher.go:52-76)."""
        # clock-driven poll (not Event.wait) so an injected FakeClock fully
        # controls the timeout: FakeClock.sleep advances virtual time, so the
        # no-trigger case returns after max_duration *virtual* seconds
        wait_start = self._clock.now()
        while not self._trigger.is_set():
            if self._clock.now() - wait_start >= self.max_duration:
                return False
            self._clock.sleep(_POLL_SECONDS)
        self._trigger.clear()
        start = self._clock.now()
        while True:
            now = self._clock.now()
            if now - start >= self.max_duration:
                return True
            with self._lock:
                idle_for = now - self._last_trigger
            if idle_for >= self.idle_duration:
                return True
            self._clock.sleep(min(_POLL_SECONDS, self.idle_duration))
