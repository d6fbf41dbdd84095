"""Self-contained Prometheus-style metrics.

Counterpart of the JAX package's ``metrics/registry.py``: the same counter,
gauge and histogram classes under the ``karpenter`` namespace, the same
duration buckets, and the same bounded tenant label. Only the series the
ported layers write are registered here: the solver supervisor's
(solver/supervisor.py), the serve layer's (serve/), those of the
observability hooks they call (obs/), the phase-1 fallbacks of the backend
(solver/torch_backend.py), the learned order's (solver/ordering.py) and the
event recorder's (events/recorder.py), the verification gate's (verify/),
the consolidation screen's (disruption/batch.py), the resident world's
(streaming/device_world.py), the streaming layer's (streaming/warm.py,
streaming/snapshot.py) and the SLO engine's (obs/slo.py); the
provisioner and the lifecycle controllers register their own, timed with
``measure``. Names, labels and buckets equal the JAX package's. ``Store`` is
the diffing gauge store of the node, nodepool and pod exporters
(controllers/metrics_exporters.py).
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from contextlib import contextmanager
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

    def delete(self, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values.pop(_labels_key(labels), None)

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

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sums.get(_labels_key(labels), 0.0)

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

    def describe(self) -> List[Tuple[str, str, str]]:
        """(kind, name, help) for every registered metric, sample or not:
        the exposition's # HELP / # TYPE headers read this."""
        with self._lock:
            return [(m.kind, m.name, m.help) for m in self._metrics.values()]

    def get(self, name: str):
        """The registered metric object by name (None if absent)."""
        with self._lock:
            return self._metrics.get(name)


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

RELAX_FALLBACK = REGISTRY.counter(
    "solver_relax_fallback_total",
    "Phase-1 relaxation fallbacks, by classified reason: gate-rejected "
    "covers both phase-1 solvers' validator re-solves (KARPENTER_TPU_RELAX "
    "waterfill and KARPENTER_TPU_RELAX2 convex solve); the convex solve "
    "additionally classifies its standdowns (finite-pool, ports, topology, "
    "no-eligible, non-convergence, rounding-overflow, error) before falling "
    "through to the waterfill",
)

# -- mesh-sharded partitioned solve series (shard/, KARPENTER_TPU_SHARD) ------
SHARD_PARTITIONS = REGISTRY.gauge(
    "solver_shard_partitions",
    "Independent sub-problems the last partitioned solve distributed over "
    "the device mesh (0 until a solve takes the shard path)",
)
SHARD_PAD_FRACTION = REGISTRY.gauge(
    "solver_shard_pad_fraction",
    "Fraction of the last partitioned solve's stacked pod rows that were "
    "padding (bucket waste + inert mesh-alignment lanes)",
)
SHARD_MERGE_REJECTIONS = REGISTRY.counter(
    "solver_shard_merge_rejections_total",
    "Partitioned solves stood down after a per-partition device gate or a "
    "cross-partition claim-merge check rejected the result",
)
SHARD_FALLBACK = REGISTRY.counter(
    "solver_shard_fallback_total",
    "Partitioned solves that stood down to the unsharded path, by "
    "classified reason (single-device, small-batch, relaxable, "
    "unsupported-args, single-partition, cross-partition-claims, "
    "shape-mismatch, slot-overflow, merge-rejected, error)",
)

# -- degraded-mesh resilience series (solver/mesh_health.py,
# KARPENTER_TPU_MESH_HEALTH) ---------------------------------------------------
MESH_DEVICES = REGISTRY.gauge(
    "solver_mesh_devices",
    "Local devices by mesh-health state (healthy, degraded, lost, "
    "probation); written on every recarve and probe pass "
    "(KARPENTER_TPU_MESH_HEALTH)",
)
MESH_RECARVE = REGISTRY.counter(
    "solver_mesh_recarve_total",
    "Mesh recarve events by classified reason: device-lost / "
    "device-degraded (a dispatch failure excluded the device), probe-failed "
    "(an excluded device failed its re-entry probe), recovered (a device "
    "cleared probation and rejoined) — an unclassified recarve never "
    "happens",
)
MESH_RECOVERY_SECONDS = REGISTRY.histogram(
    "solver_mesh_recovery_seconds",
    "Wall time from a device failure to the first green solve on the "
    "recarved (shrunken) mesh — the degraded-mesh latency cost the "
    "resilience contract trades for correctness",
)

# -- verification gate series (verify/) ----------------------------------------
GATE_DURATION = REGISTRY.histogram(
    "solver_gate_duration_seconds",
    "Placement verification gate wall time, by mode (device = jitted "
    "invariant program incl. host structural screen, host = full float64 "
    "validator, incremental = row-scoped streaming re-check, audit = "
    "sampled float64 spot-check)",
)
GATE_AUDIT = REGISTRY.counter(
    "solver_gate_audit_total",
    "Float64 audits of device-gate verdicts, by outcome (match / mismatch "
    "on sampled rows of accepted results; reject_confirmed / "
    "reject_overturned for host confirmation of device rejections)",
)

# -- incremental consolidation screen (disruption/batch.py) --------------------
SCREEN_DELTA = REGISTRY.counter(
    "solver_screen_delta_total",
    "Incremental consolidation screen lane outcomes "
    "(KARPENTER_TPU_SCREEN_DELTA), by classified outcome: delta (residual "
    "verdict published), standdown-topology / standdown-ports / "
    "standdown-pool / standdown-base-on-candidate / "
    "standdown-resident-order / standdown-resident-overflow (lane or batch "
    "fell back to the full screen), gate-mismatch (the row-scoped lane gate "
    "rejected a residual verdict; the full screen re-solve was published "
    "instead)",
)
SCREEN_DELTA_LANE = REGISTRY.histogram(
    "solver_screen_delta_lane_seconds",
    "Residual consolidation screen device wall time per lane (dispatch "
    "wall / lane count, observed once per residual dispatch)",
)

# -- learned ordering policy series (solver/ordering.py, ops/policy.py) -------
ORDER_POLICY_LOADS = REGISTRY.counter(
    "solver_order_policy_loads_total",
    "Ordering-policy weight artifact load resolutions, by outcome (loaded, "
    "or the classified degrade to built-in zero weights: missing, truncated, "
    "corrupt, checksum, version-skew) — a bad artifact costs nothing, not "
    "even iterations",
)
ORDER_POLICY_SOLVES = REGISTRY.counter(
    "solver_order_policy_solves_total",
    "Learned-ordering score evaluations, by part (host = FFD tie-break over "
    "Pod objects, lane = policy sweeps solve dispatched with the requeue "
    "scorer)",
)
ORDER_POLICY_SCORE_SECONDS = REGISTRY.histogram(
    "solver_order_policy_score_seconds",
    "Wall time of the host-side ordering-policy score pass (feature "
    "extraction + scorer head) per ffd_order call",
)

# -- solve-cycle tracing (obs/trace.py) ----------------------------------------
SOLVER_PHASE_DURATION = REGISTRY.histogram(
    "solver_phase_duration_seconds",
    "Per-phase solve-cycle self time, by phase span name and backend",
)

COMPILE_CACHE = REGISTRY.counter(
    "solver_compile_cache_total",
    "Solver program-cache lookups, by result (hit, miss)",
)
TRANSFER_BYTES = REGISTRY.counter(
    "solver_transfer_bytes_total",
    "Host-device transfer bytes on the solve path, by direction (h2d, d2h)",
)

# -- program registry series (obs/programs.py) ---------------------------------
PROGRAM_COMPILE_SECONDS = REGISTRY.histogram(
    "solver_compile_seconds",
    "Per-program compile wall time by program (fn/claim-bucket) and cache "
    "source (persistent = on-disk AOT reload, cold = full trace+compile)",
)
PROGRAM_LAUNCHES = REGISTRY.counter(
    "solver_program_launches_total",
    "Dispatches of each compiled solver program (fn/claim-bucket)",
)
DEVICE_BYTES = REGISTRY.gauge(
    "solver_device_bytes",
    "Device memory at the last solve-cycle sample, by kind (live, peak, "
    "carried_state, donated = carried bytes reclaimed in place by "
    "donate_argnums on the carried solve entries)",
)
PERSISTENT_CACHE = REGISTRY.counter(
    "solver_persistent_cache_total",
    "Process-cold program dispatches by persistent-cache result (hit = AOT "
    "executable reloaded from disk, miss = cold trace+compile)",
)

# -- streaming solve series (streaming/warm.py, streaming/snapshot.py) --------
DELTA_REUSE_RATIO = REGISTRY.gauge(
    "solver_delta_reuse_ratio",
    "Fraction of the batch pinned to its previous placement by the last "
    "streaming solve cycle (0 on a cold cycle)",
)
WARM_SOLVES = REGISTRY.counter(
    "solver_warm_solves_total",
    "Streaming solve cycles, by outcome (warm, warm-rejected, warm-error, "
    "cold-first, cold-threshold, cold-unsupported, cold-world-changed) and, "
    "under the multi-tenant serve layer, tenant (label values capped via "
    "tenant_label(); overflow tenants aggregate into 'other')",
)
STATE_RESTORE = REGISTRY.counter(
    "solver_state_restore_total",
    "Streaming-state journal restore attempts, by outcome (restored, "
    "missing, truncated, corrupt, checksum, version-skew, isa-mismatch, "
    "stale, validator, error)",
)
RESTART_RECOVERY_SECONDS = REGISTRY.histogram(
    "solver_restart_recovery_seconds",
    "Wall time of the restart-recovery sequence (AOT executable restore + "
    "probe solve + streaming-journal restore) after a process exec",
)
AOT_RESTORE = REGISTRY.counter(
    "solver_aot_restore_total",
    "AOT executable snapshot entries processed at restore, by result "
    "(restored, or the classified failure: missing, truncated, corrupt, "
    "checksum, version-skew, isa-mismatch, flag-mismatch, "
    "deserialize-error, probe-failed)",
)
RESTORE_FALLBACK = REGISTRY.counter(
    "restore_fallback_total",
    "Restore paths that degraded to a cold start, by classified reason "
    "(aot-* for executable-snapshot failures, journal-* for streaming-state "
    "failures; every recovery is classified — 'unknown' never appears)",
)

# -- resident world series (streaming/device_world.py) -------------------------
WORLD_PATCH = REGISTRY.counter(
    "solver_world_patch_total",
    "Device-resident world cycles (KARPENTER_TPU_DEVICE_WORLD) by outcome: "
    "patched/repatched (delta applied as an on-device row patch into the "
    "donated carried world), adopt-* (cold world re-uploaded, suffixed with "
    "the delta cold reason or shape/node-axis drift), or standdown-* "
    "(classified reason — the legacy host path served the cycle: "
    "unsupported-args, topology, not-sweeps, runs-mode, shard, order-policy, "
    "relax-applicable, slot-overflow, gate-reject, device-lost (the world's "
    "device died mid-cycle; reset-then-re-adopt, never resurrected), error)",
)

# -- multi-tenant serve series (serve/) ----------------------------------------
# Hot-path series carry the tenant CLASS label ("cls"), never tenant ids (a
# bounded set at any fleet size); series that do carry a tenant label go
# through tenant_label() below, which caps the value set.
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "serve_queue_depth",
    "Queued solve requests per tenant class (each tenant's queue bounded by "
    "KARPENTER_TPU_SERVE_QUEUE_DEPTH; per-tenant depth in /debug/tenants)",
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
    "(flat single-class mode writes nothing here; per-tenant balances in "
    "/debug/tenants)",
)
SERVE_CYCLES = REGISTRY.counter(
    "serve_cycles_total",
    "Solve requests completed by the serve dispatcher, by tenant class and "
    "path (solo = per-tenant supervised solve, batched = answered by a "
    "cross-stream stacked dispatch)",
)
SERVE_ACTIVE = REGISTRY.gauge(
    "serve_active_streams",
    "Backlogged (ready-ring) tenant streams per class — the population the "
    "O(active) dispatcher actually sweeps, vs. registered tenants which "
    "cost nothing while idle",
)
SERVE_POOL = REGISTRY.counter(
    "serve_pool_total",
    "Shared program-pool gather outcomes per dispatch (hit = the shape-"
    "family index produced co-batch riders, alone = the lead dispatched "
    "solo)",
)
SERVE_REPLICA_PLACEMENTS = REGISTRY.counter(
    "serve_replica_placements_total",
    "Tenant-to-replica placement decisions by classified reason (pinned, "
    "big-tenant = routed to the largest mesh slice, hash = stable default)",
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
    "(queue wait included; per-tenant quantiles live in /debug/tenants)",
)

# -- fleet SLO engine + flight recorder (obs/slo.py, obs/flight.py) -----------
SLO_BURN_RATE = REGISTRY.gauge(
    "slo_burn_rate",
    "Error-budget burn-rate multiple per SLO objective and window "
    "(multi-window burn rate; breach requires both fast and slow windows "
    "over the threshold). Labels {objective, window} are bounded: a fixed "
    "objective set plus per-tenant-class serve objectives, window in "
    "(fast, slow). SLO-gated (KARPENTER_TPU_SLO).",
)
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


# -- event recorder series (events/recorder.py) --------------------------------
EVENTS_DEDUPED = REGISTRY.counter(
    "events_deduped_total",
    "Event publishes suppressed by the recorder, by cause (duplicate = seen "
    "within the dedupe TTL, rate-limited = per-key flow control)",
)


@contextmanager
def measure(histogram: Histogram, labels: Optional[Dict[str, str]] = None):
    """Time a block into a histogram (reference metrics/constants.go:60-67)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        histogram.observe(time.perf_counter() - start, labels)


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


class Store:
    """Diff-based gauge store (reference metrics/store.go:32-102): update
    replaces the gauge series owned by a key, deleting series that vanished."""

    def __init__(self):
        self._owned: Dict[str, List[Tuple[Gauge, Dict[str, str]]]] = {}
        self._lock = threading.Lock()

    def update(self, key: str, series: List[Tuple[Gauge, Dict[str, str], float]]):
        with self._lock:
            for gauge, labels in self._owned.get(key, []):
                gauge.delete(labels)
            new_owned = []
            for gauge, labels, value in series:
                gauge.set(value, labels)
                new_owned.append((gauge, labels))
            self._owned[key] = new_owned

    def delete(self, key: str):
        with self._lock:
            for gauge, labels in self._owned.pop(key, []):
                gauge.delete(labels)

    def replace_all(self, series_by_key: Dict[str, List[Tuple[Gauge, Dict[str, str], float]]]):
        for key in list(self._owned):
            if key not in series_by_key:
                self.delete(key)
        for key, series in series_by_key.items():
            self.update(key, series)
