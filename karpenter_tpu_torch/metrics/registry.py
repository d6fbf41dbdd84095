"""Self-contained Prometheus-style metrics.

Counterpart of the JAX package's ``metrics/registry.py``: the same counter,
gauge and histogram classes under the ``karpenter`` namespace, the same
duration buckets, and the same bounded tenant label. Only the series the
ported layers write are registered here: the solver supervisor's
(solver/supervisor.py), the serve layer's (serve/), and those of the
observability hooks they call (obs/). Names, labels and buckets equal the
JAX package's.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

NAMESPACE = "karpenter"

# reference metrics/constants.go:41-50 (exponential-ish duration buckets)
DURATION_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5,
    0.75, 1.0, 2.5, 5.0, 7.5, 10.0, 30.0, 60.0, 120.0, 180.0, 300.0, 450.0, 600.0,
)

LabelValues = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> LabelValues:
    return tuple(sorted((labels or {}).items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = "", subsystem: str = ""):
        parts = [NAMESPACE]
        if subsystem:
            parts.append(subsystem)
        parts.append(name)
        self.name = "_".join(parts)
        self.help = help_
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str = "", subsystem: str = ""):
        super().__init__(name, help_, subsystem)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, labels: Optional[Dict[str, str]] = None, value: float = 1.0):
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def collect(self):
        return [("counter", self.name, dict(k), v) for k, v in self._values.items()]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str = "", subsystem: str = ""):
        super().__init__(name, help_, subsystem)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[_labels_key(labels)] = value

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def collect(self):
        return [("gauge", self.name, dict(k), v) for k, v in self._values.items()]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str = "",
        subsystem: str = "",
        buckets: Iterable[float] = DURATION_BUCKETS,
    ):
        super().__init__(name, help_, subsystem)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelValues, List[int]] = {}
        self._sums: Dict[LabelValues, float] = {}
        self._totals: Dict[LabelValues, int] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None):
        key = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            # prometheus le semantics: bucket le=B counts observations <= B
            idx = bisect_left(self.buckets, value)
            for i in range(idx, len(self.buckets)):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._totals.get(_labels_key(labels), 0)

    def collect(self):
        return [
            (
                "histogram",
                self.name,
                dict(k),
                {
                    "count": self._totals[k],
                    "sum": self._sums[k],
                    "buckets": dict(zip(self.buckets, self._counts[k])),
                },
            )
            for k in self._totals
        ]


class Registry:
    """Holds every metric so an exporter / test can enumerate them."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "", subsystem: str = "") -> Counter:
        return self._get_or_register(Counter(name, help_, subsystem))

    def gauge(self, name: str, help_: str = "", subsystem: str = "") -> Gauge:
        return self._get_or_register(Gauge(name, help_, subsystem))

    def histogram(self, name: str, help_: str = "", subsystem: str = "", buckets=DURATION_BUCKETS) -> Histogram:
        return self._get_or_register(Histogram(name, help_, subsystem, buckets))

    def _get_or_register(self, metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def collect(self):
        out = []
        for m in self._metrics.values():
            out.extend(m.collect())
        return out


REGISTRY = Registry()

# -- solver robustness series (solver/supervisor.py) ---------------------------
SOLVER_RETRIES = REGISTRY.counter(
    "solver_retries_total",
    "Solve attempts retried after a transient failure, by failure class",
)
SOLVER_FALLBACK = REGISTRY.counter(
    "solver_fallback_total",
    "Solves answered by the fallback backend, by (from, to) backend pair",
)
SOLVER_CIRCUIT_STATE = REGISTRY.gauge(
    "solver_circuit_state",
    "Primary-backend circuit breaker state (0=closed, 1=half-open, 2=open); "
    "one series per tenant under the multi-tenant serve layer",
)
VALIDATOR_REJECTIONS = REGISTRY.counter(
    "validator_rejections_total",
    "SolveResults quarantined by the invariant gate, by violated invariant "
    "and, under the multi-tenant serve layer, tenant",
)
SOLVE_DEADLINE_EXCEEDED = REGISTRY.counter(
    "solve_deadline_exceeded_total",
    "Solves abandoned by the wall-clock watchdog",
)

# -- solve-cycle tracing (obs/trace.py) ----------------------------------------
SOLVER_PHASE_DURATION = REGISTRY.histogram(
    "solver_phase_duration_seconds",
    "Per-phase solve-cycle self time, by phase span name and backend",
)

# -- multi-tenant serve series (serve/) ----------------------------------------
# Hot-path series carry the tenant CLASS label ("cls"), never tenant ids (a
# bounded set at any fleet size); series that do carry a tenant label go
# through tenant_label() below, which caps the value set.
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "serve_queue_depth",
    "Queued solve requests per tenant class (each tenant's queue bounded by "
    "KARPENTER_TPU_SERVE_QUEUE_DEPTH; per-tenant depth in the service snapshot)",
)
SERVE_ADMISSION = REGISTRY.counter(
    "serve_admission_total",
    "Serve-layer admission decisions, by tenant class and classified "
    "outcome (accepted, overloaded-queue-full, overloaded-predicted-wait, "
    "overloaded-saturated, overloaded-expired, rejected-max-tenants, "
    "rejected-shutdown) — an unadmitted request is always one of these, "
    "never a silent drop",
)
SERVE_FAIRNESS_DEFICIT = REGISTRY.gauge(
    "serve_fairness_deficit",
    "Hierarchical-DWRR class-level balance: the pod-units of service a "
    "tenant class may still spend before yielding to the other classes "
    "(flat single-class mode writes nothing here)",
)
SERVE_CYCLES = REGISTRY.counter(
    "serve_cycles_total",
    "Solve requests completed by the serve dispatcher, by tenant class and "
    "path (solo = per-tenant supervised solve, batched = answered by a "
    "cross-stream stacked dispatch)",
)
SERVE_ACTIVE = REGISTRY.gauge(
    "serve_active_streams",
    "Backlogged (ready-ring) tenant streams per class",
)
SERVE_POOL = REGISTRY.counter(
    "serve_pool_total",
    "Shared program-pool gather outcomes per dispatch (hit = the shape-"
    "family index produced co-batch riders, alone = the lead dispatched "
    "solo)",
)
SERVE_BATCH = REGISTRY.counter(
    "serve_batch_total",
    "Cross-stream batching decisions, by result (hit = request answered by "
    "a stacked batched_screen dispatch, fallback = stacked path stood down "
    "to the per-tenant solve)",
)
SERVE_CYCLE_SECONDS = REGISTRY.histogram(
    "serve_cycle_seconds",
    "End-to-end serve request latency from admission to completed result "
    "(queue wait included)",
)

# -- fleet SLO engine + flight recorder (obs/slo.py, obs/flight.py) -----------
SLO_BREACH = REGISTRY.counter(
    "slo_breach_total",
    "Edge-triggered SLO breach transitions by {objective} — each one also "
    "records a slo-breach flight event and snapshots the flight ring. "
    "SLO-gated.",
)
FLIGHT_DUMPS = REGISTRY.counter(
    "flight_dumps_total",
    "Flight-recorder ring snapshots written to disk, by classified {reason} "
    "(slo-breach, circuit-open, recarve, validator-reject, manual). "
    "SLO-gated.",
)

# -- placement explainability series (obs/explain.py) -------------------------
UNSCHEDULABLE_PODS = REGISTRY.counter(
    "unschedulable_pods_total",
    "Pods a solve left unscheduled, by UnschedulableReason (label values are "
    "bounded to the obs/explain.py taxonomy; KARPENTER_TPU_EXPLAIN only)",
)
EXPLAIN_OVERHEAD = REGISTRY.histogram(
    "solver_explain_overhead_seconds",
    "Wall time of the post-pass gate-attribution + decode (the explain "
    "feature's whole marginal cost; zero series when the flag is off)",
)


def tenant_label_max() -> int:
    """Cap on DISTINCT tenant-id label values any metric family may carry
    (KARPENTER_TPU_TENANT_LABEL_MAX, default 32): the first N distinct
    tenants keep their ids, the rest aggregate into ``other``. Forensics
    (quarantine namespaces) always use the raw tenant id."""
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_TENANT_LABEL_MAX", "32")))
    except ValueError:
        return 32


_tenant_label_lock = threading.Lock()
_tenant_label_seen: Dict[str, str] = {}


def tenant_label(tenant: str) -> str:
    """Bounded metric-label value for a tenant id: the id itself for the
    first tenant_label_max() distinct tenants this process sees, ``other``
    beyond that. Stable within a process (first-come keeps its id)."""
    with _tenant_label_lock:
        mapped = _tenant_label_seen.get(tenant)
        if mapped is None:
            mapped = (
                tenant
                if len(_tenant_label_seen) < tenant_label_max()
                else "other"
            )
            _tenant_label_seen[tenant] = mapped
        return mapped
