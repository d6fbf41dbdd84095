"""Fleet SLO engine: multi-window burn-rate objectives over live streams.

Counterpart of the JAX package's ``obs/slo.py``, ported for the hooks the
solver supervisor, the streaming layer and the serve layer call:
``on_solve_cycle``, ``on_gate``, ``on_stream``, ``on_serve_admission`` and
``on_serve_latency`` (each one flag check when
``KARPENTER_TPU_SLO`` is off), over the same objectives, windows, budgets
and knobs. Each objective owns an error budget (``target`` = allowed bad
fraction) and two sliding windows, fast (5 m) and slow (1 h); a breach needs
both windows over the burn threshold (default 14.4) with at least
``min_events`` in each. A breach is edge-triggered: it counts
``karpenter_slo_breach_total{objective}``, records a ``slo-breach`` flight
event and snapshots the flight ring (obs/flight.py). The read path serves
the operator's endpoints (operator/serving.py): ``refresh_metrics`` writes
the ``karpenter_slo_burn_rate{objective, window}`` gauges at scrape time,
``rollup`` is the ``/statusz`` verdict and ``debug_payload`` the
``/debug/slo`` body.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

# Monkeypatchable clock so burn-rate window tests are deterministic.
_wall = time.time

WINDOW_FAST = "fast"
WINDOW_SLOW = "slow"

VERDICT_OK = "ok"
VERDICT_WARN = "warn"
VERDICT_BREACH = "breach"

# Per-class serve objectives stay bounded like the serve metric labels:
# classes are operator config, capped well under the lint's cls ceiling.
_MAX_SERVE_CLASSES = 64

# Stream outcomes that count as good service (streaming/warm.py _finish): a
# warm hit, or the legitimate first cold solve of a stream. Everything else
# (warm-rejected, warm-error, cold-threshold, cold-unsupported,
# cold-world-changed) is a cold-solve leak against the stream-warm budget.
_STREAM_GOOD = frozenset({"warm", "cold-first"})

_enabled_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force the engine on/off (tests, bench); ``None`` restores the env
    flag."""
    global _enabled_override
    _enabled_override = value


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("KARPENTER_TPU_SLO", "") not in ("", "0")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _Window:
    """One sliding window as a ring of time buckets with running totals.

    ``record`` advances a bucket cursor (each bucket recycled at most once
    per slot — amortized O(1)) and adds to the current bucket and the running
    good/bad sums; no allocation, no scan. Reads advance the same cursor so
    totals never include expired buckets."""

    __slots__ = ("span_s", "bucket_s", "n", "_slots_good", "_slots_bad",
                 "good", "bad", "_cursor")

    def __init__(self, span_s: float, n_buckets: int):
        self.span_s = span_s
        self.n = n_buckets
        self.bucket_s = span_s / n_buckets
        self._slots_good = [0.0] * n_buckets
        self._slots_bad = [0.0] * n_buckets
        self.good = 0.0
        self.bad = 0.0
        self._cursor: Optional[int] = None  # last time slot advanced to

    def _advance(self, slot: int) -> None:
        if self._cursor is None:
            self._cursor = slot
            return
        if slot <= self._cursor:
            return  # same bucket, or a monkeypatched clock stepping back
        start = max(self._cursor + 1, slot - self.n + 1)
        for s in range(start, slot + 1):
            idx = s % self.n
            self.good -= self._slots_good[idx]
            self.bad -= self._slots_bad[idx]
            self._slots_good[idx] = 0.0
            self._slots_bad[idx] = 0.0
        self._cursor = slot
        if slot - start >= self.n - 1:  # full wrap: clamp float drift
            self.good = 0.0
            self.bad = 0.0

    def record(self, now: float, good: float, bad: float) -> None:
        self._advance(int(now // self.bucket_s))
        idx = self._cursor % self.n
        self._slots_good[idx] += good
        self._slots_bad[idx] += bad
        self.good += good
        self.bad += bad

    def totals(self, now: float) -> Tuple[float, float]:
        self._advance(int(now // self.bucket_s))
        return self.good, self.bad


class Objective:
    """One declarative objective: a budget (``target`` = allowed bad
    fraction), an optional latency threshold (latency-kind objectives turn a
    duration into good/bad against it), and the two burn windows."""

    def __init__(
        self,
        name: str,
        kind: str,  # "latency" | "ratio"
        target: float,
        threshold_s: Optional[float] = None,
        min_events: float = 8.0,
        burn_threshold: Optional[float] = None,
        fast_span_s: Optional[float] = None,
        slow_span_s: Optional[float] = None,
        description: str = "",
    ):
        self.name = name
        self.kind = kind
        self.target = max(target, 1e-9)
        self.threshold_s = threshold_s
        self.min_events = min_events
        self.burn_threshold = (
            burn_threshold
            if burn_threshold is not None
            else _env_float("KARPENTER_TPU_SLO_BURN", 14.4)
        )
        fast = fast_span_s if fast_span_s is not None else _env_float(
            "KARPENTER_TPU_SLO_FAST_S", 300.0
        )
        slow = slow_span_s if slow_span_s is not None else _env_float(
            "KARPENTER_TPU_SLO_SLOW_S", 3600.0
        )
        self.fast = _Window(fast, 30)
        self.slow = _Window(slow, 60)
        self.description = description
        self.breached = False
        self.breaches = 0
        self.last_breach_unix: Optional[float] = None

    def record(self, now: float, good: float, bad: float) -> None:
        self.fast.record(now, good, bad)
        self.slow.record(now, good, bad)

    def record_latency(self, now: float, seconds: float) -> None:
        bad = self.threshold_s is not None and seconds > self.threshold_s
        self.record(now, 0.0 if bad else 1.0, 1.0 if bad else 0.0)

    @staticmethod
    def _burn(good: float, bad: float, target: float) -> float:
        total = good + bad
        if total <= 0.0:
            return 0.0
        return (bad / total) / target

    def evaluate(self, now: float) -> Tuple[float, float, float, float]:
        """(fast_burn, slow_burn, fast_events, slow_events) — pure floats,
        no allocation (the hot-path breach check)."""
        fg, fb = self.fast.totals(now)
        sg, sb = self.slow.totals(now)
        return (
            self._burn(fg, fb, self.target),
            self._burn(sg, sb, self.target),
            fg + fb,
            sg + sb,
        )

    def is_breaching(self, now: float) -> bool:
        fast_burn, slow_burn, fast_n, slow_n = self.evaluate(now)
        return (
            fast_burn >= self.burn_threshold
            and slow_burn >= self.burn_threshold
            and fast_n >= self.min_events
            and slow_n >= self.min_events
        )


    def snapshot(self, now: float) -> Dict:
        fast_burn, slow_burn, fast_n, slow_n = self.evaluate(now)
        out: Dict[str, object] = {
            "name": self.name,
            "kind": self.kind,
            "target": self.target,
            "burn_threshold": self.burn_threshold,
            "min_events": self.min_events,
            "burn": {WINDOW_FAST: round(fast_burn, 4),
                     WINDOW_SLOW: round(slow_burn, 4)},
            "events": {WINDOW_FAST: fast_n, WINDOW_SLOW: slow_n},
            "status": VERDICT_BREACH if self.breached else (
                VERDICT_WARN if slow_burn >= 1.0 or fast_burn >= self.burn_threshold
                else VERDICT_OK
            ),
            "breaches": self.breaches,
        }
        if self.threshold_s is not None:
            out["threshold_s"] = self.threshold_s
        if self.description:
            out["description"] = self.description
        if self.last_breach_unix is not None:
            out["last_breach_unix"] = self.last_breach_unix
        return out


class SloEngine:
    """The objective set plus the edge-triggered breach machinery."""

    def __init__(self, time_fn=None):
        self._time = time_fn or (lambda: _wall())
        self._lock = threading.Lock()
        self._objectives: Dict[str, Objective] = {}
        for obj in (
            Objective(
                "solve-latency", "latency", target=0.01,
                threshold_s=_env_float("KARPENTER_TPU_SLO_SOLVE_P99_S", 30.0),
                min_events=8,
                description="supervised solve cycles within the wall budget",
            ),
            Objective(
                "solve-scheduled", "ratio",
                target=_env_float("KARPENTER_TPU_SLO_SCHED_TARGET", 0.20),
                min_events=50,
                description="pod units scheduled vs requeued per cycle",
            ),
            Objective(
                "stream-warm", "ratio", target=0.10, min_events=8,
                description="warm-path cycles vs cold-solve leaks",
            ),
            Objective(
                "mesh-recovery", "latency", target=0.001,
                threshold_s=_env_float("KARPENTER_TPU_SLO_RECOVERY_S", 60.0),
                min_events=1,
                description="device failure to first green solve on the "
                            "recarved mesh within the ceiling",
            ),
            Objective(
                "gate-integrity", "ratio", target=0.001, min_events=1,
                description="validated results vs quarantined rejections — "
                            "one rejection is an incident",
            ),
        ):
            self._objectives[obj.name] = obj

    # -- objective access -----------------------------------------------------

    def objective(self, name: str) -> Optional[Objective]:
        with self._lock:
            return self._objectives.get(name)

    def objectives(self) -> List[str]:
        with self._lock:
            return sorted(self._objectives)

    def _serve_objective(self, prefix: str, cls: str) -> Objective:
        """Per-class objective, created lazily and bounded: past
        ``_MAX_SERVE_CLASSES`` distinct classes (never hit with real operator
        config; the serve lint caps cls at 64 too) new ones fold into
        ``other``."""
        name = f"{prefix}.{cls}"
        obj = self._objectives.get(name)
        if obj is not None:
            return obj
        n_serve = sum(1 for k in self._objectives if k.startswith(prefix + "."))
        if n_serve >= _MAX_SERVE_CLASSES:
            name = f"{prefix}.other"
            obj = self._objectives.get(name)
            if obj is not None:
                return obj
        if prefix == "serve-latency":
            obj = Objective(
                name, "latency",
                target=_env_float("KARPENTER_TPU_SLO_SERVE_TARGET", 0.01),
                threshold_s=_env_float("KARPENTER_TPU_SLO_SERVE_P99_S", 5.0),
                min_events=16,
                description="serve requests answered within the class budget",
            )
        else:
            obj = Objective(
                name, "ratio",
                target=_env_float("KARPENTER_TPU_SLO_SHED_TARGET", 0.05),
                min_events=16,
                description="admissions accepted vs shed for this class",
            )
        self._objectives[name] = obj
        return obj

    # -- recording (the hot path) ---------------------------------------------

    def _record(self, obj: Objective, good: float, bad: float) -> None:
        now = self._time()
        fire = False
        with self._lock:
            obj.record(now, good, bad)
            breaching = obj.is_breaching(now)
            if breaching and not obj.breached:
                obj.breached = True
                obj.breaches += 1
                obj.last_breach_unix = now
                fire = True
            elif not breaching and obj.breached:
                obj.breached = False
        if fire:
            self._on_breach(obj, now)

    def _record_latency(self, obj: Objective, seconds: float) -> None:
        bad = obj.threshold_s is not None and seconds > obj.threshold_s
        self._record(obj, 0.0 if bad else 1.0, 1.0 if bad else 0.0)

    def _on_breach(self, obj: Objective, now: float) -> None:
        # Edge side effects only — dicts and IO happen per breach, not per
        # event. The flight snapshot captures the causal timeline the moment
        # the breach is detected; its own debounce absorbs breach clusters.
        from karpenter_tpu_torch.metrics.registry import SLO_BREACH
        from karpenter_tpu_torch.obs import flight

        SLO_BREACH.inc({"objective": obj.name})
        fast_burn, slow_burn, _, _ = obj.evaluate(now)
        flight.record(
            flight.KIND_SLO_BREACH, objective=obj.name,
            fast_burn=round(fast_burn, 3), slow_burn=round(slow_burn, 3),
        )
        flight.snapshot_dump("slo-breach", objective=obj.name)

    # subsystem entry points ---------------------------------------------------

    def record_solve(self, duration_s: float, scheduled: int, failed: int) -> None:
        self._record_latency(self._objectives["solve-latency"], duration_s)
        if scheduled or failed:
            self._record(
                self._objectives["solve-scheduled"],
                float(scheduled), float(failed),
            )

    def record_recovery(self, seconds: float) -> None:
        self._record_latency(self._objectives["mesh-recovery"], seconds)

    def record_gate(self, ok: bool) -> None:
        self._record(
            self._objectives["gate-integrity"],
            1.0 if ok else 0.0, 0.0 if ok else 1.0,
        )

    def record_stream(self, outcome: str) -> None:
        good = outcome in _STREAM_GOOD
        self._record(
            self._objectives["stream-warm"],
            1.0 if good else 0.0, 0.0 if good else 1.0,
        )

    def record_serve_admission(self, cls: str, accepted: bool) -> None:
        with self._lock:
            obj = self._serve_objective("serve-shed", cls)
        self._record(obj, 1.0 if accepted else 0.0, 0.0 if accepted else 1.0)

    def record_serve_latency(self, cls: str, seconds: float) -> None:
        with self._lock:
            obj = self._serve_objective("serve-latency", cls)
        self._record_latency(obj, seconds)


    # -- read path ------------------------------------------------------------

    def breached(self) -> List[str]:
        with self._lock:
            return sorted(n for n, o in self._objectives.items() if o.breached)

    def snapshot(self) -> List[Dict]:
        now = self._time()
        with self._lock:
            return [
                self._objectives[name].snapshot(now)
                for name in sorted(self._objectives)
            ]

    def rollup(self) -> Dict:
        """The single fleet health verdict with worst-objective attribution:
        ``breach`` if any objective breached, ``warn`` if any is burning
        budget faster than allowed (slow burn >= 1, or the fast window past
        the page threshold), else ``ok``."""
        now = self._time()
        verdict = VERDICT_OK
        worst_name = None
        worst_burn = -1.0
        breached: List[str] = []
        with self._lock:
            for name in sorted(self._objectives):
                obj = self._objectives[name]
                fast_burn, slow_burn, fast_n, slow_n = obj.evaluate(now)
                if fast_n + slow_n <= 0 and not obj.breached:
                    continue
                if obj.breached:
                    breached.append(name)
                    verdict = VERDICT_BREACH
                elif verdict != VERDICT_BREACH and (
                    slow_burn >= 1.0 or fast_burn >= obj.burn_threshold
                ):
                    verdict = VERDICT_WARN
                score = max(fast_burn, slow_burn) + (1e9 if obj.breached else 0.0)
                if score > worst_burn:
                    worst_burn = score
                    worst_name = name
        out: Dict[str, object] = {
            "verdict": verdict,
            "objectives": len(self._objectives),
            "breached": breached,
        }
        if worst_name is not None:
            worst = self._objectives[worst_name]
            fast_burn, slow_burn, _, _ = worst.evaluate(now)
            out["worst"] = {
                "objective": worst_name,
                "burn": {WINDOW_FAST: round(fast_burn, 4),
                         WINDOW_SLOW: round(slow_burn, 4)},
            }
        return out

    def refresh_metrics(self) -> None:
        """Write the burn-rate gauges for every objective (read path only —
        /metrics scrape or an explicit call; never per event)."""
        from karpenter_tpu_torch.metrics.registry import SLO_BURN_RATE

        now = self._time()
        with self._lock:
            burns = [
                (name, obj.evaluate(now)[:2])
                for name, obj in self._objectives.items()
            ]
        for name, (fast_burn, slow_burn) in burns:
            SLO_BURN_RATE.set(fast_burn, {"objective": name, "window": WINDOW_FAST})
            SLO_BURN_RATE.set(slow_burn, {"objective": name, "window": WINDOW_SLOW})


_engine: Optional[SloEngine] = None
_engine_lock = threading.Lock()


def engine() -> SloEngine:
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = SloEngine()
    return _engine


def reset(time_fn=None) -> SloEngine:
    """Replace the engine (tests; re-reads the env-tunable objectives)."""
    global _engine
    with _engine_lock:
        _engine = SloEngine(time_fn)
    return _engine


# -- hook functions the subsystems call (each a flag check when off) ----------


def on_solve_cycle(duration_s: float, scheduled: int, failed: int) -> None:
    if not enabled():
        return
    engine().record_solve(duration_s, scheduled, failed)


def on_recovery(seconds: float) -> None:
    if not enabled():
        return
    engine().record_recovery(seconds)


def on_gate(ok: bool) -> None:
    if not enabled():
        return
    engine().record_gate(ok)


def on_stream(outcome: str) -> None:
    if not enabled():
        return
    engine().record_stream(outcome)


def on_serve_admission(cls: str, accepted: bool) -> None:
    if not enabled():
        return
    engine().record_serve_admission(cls, accepted)


def on_serve_latency(cls: str, seconds: float) -> None:
    if not enabled():
        return
    engine().record_serve_latency(cls, seconds)


def refresh_metrics() -> None:
    if not enabled():
        return
    engine().refresh_metrics()


def rollup() -> Dict:
    """The /statusz section; cheap and honest when off."""
    if not enabled() and _engine is None:
        return {"enabled": False, "verdict": VERDICT_OK}
    out = engine().rollup()
    out["enabled"] = enabled()
    return out


def debug_payload() -> Dict:
    """The /debug/slo body."""
    if not enabled() and _engine is None:
        return {"enabled": False, "objectives": [],
                "rollup": {"verdict": VERDICT_OK}}
    eng = engine()
    return {
        "enabled": enabled(),
        "objectives": eng.snapshot(),
        "rollup": eng.rollup(),
    }
