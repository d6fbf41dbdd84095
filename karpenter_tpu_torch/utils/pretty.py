"""ChangeMonitor — log/emit only when a value changes.

Equivalent of reference pkg/utils/pretty: controllers that reconcile every few
seconds use it to avoid re-logging identical state (e.g. the provisioner's
"found N provisionable pods" line)."""

from __future__ import annotations

import hashlib
import json
import time as _time
from typing import Dict, Optional, Tuple


def _digest(value) -> str:
    try:
        payload = json.dumps(value, sort_keys=True, default=str)
    except TypeError:
        payload = repr(value)
    return hashlib.sha256(payload.encode()).hexdigest()


class ChangeMonitor:
    def __init__(self, ttl_seconds: float = 24 * 3600.0, clock=None):
        self.ttl = ttl_seconds
        self._clock = clock
        self._seen: Dict[str, Tuple[str, float]] = {}

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else _time.time()

    def has_changed(self, key: str, value) -> bool:
        """True when the value differs from the last observation (or the TTL
        elapsed), recording the new observation."""
        digest = _digest(value)
        now = self._now()
        prev = self._seen.get(key)
        self._seen[key] = (digest, now)
        if prev is None:
            return True
        prev_digest, prev_at = prev
        return digest != prev_digest or now - prev_at > self.ttl
