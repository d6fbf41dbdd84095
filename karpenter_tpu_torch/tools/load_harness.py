"""Open-loop load harness: the fleet-scale ground truth for serve numbers.

Counterpart of the JAX system's ``tools/load_harness.py``. Closed-loop
drivers (submit, wait, submit again) lie about saturation: when the service
slows down the driver slows down with it, so measured latency flattens
exactly when real clients would be piling up. This harness is OPEN-LOOP —
the arrival schedule is fixed up front by a seeded trace and requests fire
at their scheduled instants whether or not earlier ones completed. Under
saturation the backlog grows and admission sheds, which is the point:
``serve_fleet`` below reports aggregate pods/s AND p99 cycle latency under
that pressure, and every unserved request must carry a classified outcome
(an unclassified count is an error, not a statistic).

The trace models a fleet day in miniature:

  diurnal     a sinusoidal rate envelope over the trace (peak/trough),
  churn       the ACTIVE tenant window rotates through the registered fleet,
              so 1,000 registered streams stay mostly idle at any instant
              (exactly the population the O(active) dispatcher contract is
              about) while every stream gets traffic eventually,
  bursts      scheduled instants where a cluster of arrivals lands at once
              (the EWMA-decay admission case),
  storms      optional reclaim-storm windows tagged on events so chaos runs
              (the chaos sweep's fleet row) can align fault injection with
              arrival pressure.

Everything is deterministic from the seed: the same (seed, spec) produces
the same event list byte for byte, the JAX system's harness's list — traces
are pinnable in tests.

The trace and report are stdlib only and solver-agnostic: ``run_trace``
takes any object with the SolveService ``submit(tenant, pods,
instance_types, templates)`` surface (a ``serve.SolveService``, a
``serve.replica.ReplicaSet``, or a stub) plus a request factory.
``serve_fleet`` drives a ``ReplicaSet`` of the port's services over
``TorchSolver`` tenants, on the card unless asked for the CPU:

    python -m karpenter_tpu_torch.tools.load_harness
    python -m karpenter_tpu_torch.tools.load_harness --device cpu --tenants 64 --requests 60
"""

from __future__ import annotations

import math
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# classified outcome vocabulary the report recognizes; anything else on an
# unserved outcome counts as UNCLASSIFIED (a contract violation upstream)
_CLASSIFIED_UNSERVED = frozenset({
    "overloaded-queue-full",
    "overloaded-predicted-wait",
    "overloaded-saturated",
    "overloaded-expired",
    "rejected-max-tenants",
    "rejected-shutdown",
})


@dataclass(frozen=True)
class TraceEvent:
    at_s: float    # arrival offset from trace start
    tenant: str
    cls: str
    pods: int
    storm: bool = False  # inside a reclaim-storm window (chaos alignment)


@dataclass
class TraceSpec:
    """Knobs for one synthetic fleet day. Defaults give a busy-but-sane
    trace; the bench and chaos rows override deliberately."""

    n_tenants: int = 1000
    classes: Dict[str, float] = field(
        default_factory=lambda: {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
    )
    duration_s: float = 10.0
    base_rate_hz: float = 50.0      # mean arrivals/s before the envelope
    diurnal_amplitude: float = 0.5  # rate swings x(1 +/- amplitude)
    active_window: int = 64         # tenants receiving traffic at an instant
    churn_period_s: float = 1.0     # window advance cadence
    bursts: int = 3                 # evenly spaced burst instants
    burst_size: int = 32            # arrivals landing at each burst
    storm_windows: int = 0          # reclaim-storm windows to tag
    storm_span_s: float = 0.5
    pods_lo: int = 1
    pods_hi: int = 8


def build_fleet(spec: TraceSpec) -> List[Tuple[str, str]]:
    """The registered fleet: (tenant_id, class) rows, classes striped
    round-robin so every class is populated at any fleet size."""
    names = sorted(spec.classes) or ["default"]
    return [
        (f"t{i:04d}", names[i % len(names)])
        for i in range(max(1, spec.n_tenants))
    ]


def make_trace(spec: TraceSpec, seed: int = 0) -> List[TraceEvent]:
    """Deterministic open-loop arrival schedule for one fleet day."""
    rng = random.Random(seed)
    fleet = build_fleet(spec)
    events: List[TraceEvent] = []
    storms = [
        (
            (w + 0.5) * spec.duration_s / max(1, spec.storm_windows),
            (w + 0.5) * spec.duration_s / max(1, spec.storm_windows)
            + spec.storm_span_s,
        )
        for w in range(spec.storm_windows)
    ]

    def in_storm(t: float) -> bool:
        return any(lo <= t < hi for lo, hi in storms)

    def pick_tenant(t: float) -> Tuple[str, str]:
        # the active window slides through the fleet: most registered
        # streams are idle at any instant, all see traffic across the trace
        window = min(spec.active_window, len(fleet))
        start = int(t / max(1e-6, spec.churn_period_s)) * window
        return fleet[(start + rng.randrange(window)) % len(fleet)]

    # diurnal arrivals: integrate the rate envelope in fixed steps and emit
    # whenever the accumulator crosses 1 (deterministic thinning — no
    # Poisson draw, so the schedule is stable across python versions)
    dt = 1.0 / max(1.0, spec.base_rate_hz * 4.0)
    acc, t = 0.0, 0.0
    while t < spec.duration_s:
        phase = 2.0 * math.pi * t / max(1e-6, spec.duration_s)
        rate = spec.base_rate_hz * (
            1.0 + spec.diurnal_amplitude * math.sin(phase)
        )
        acc += rate * dt
        while acc >= 1.0:
            acc -= 1.0
            tenant, cls = pick_tenant(t)
            events.append(TraceEvent(
                at_s=round(t, 6), tenant=tenant, cls=cls,
                pods=rng.randint(spec.pods_lo, spec.pods_hi),
                storm=in_storm(t),
            ))
        t += dt
    # bursts: a cluster of arrivals at one instant (same timestamp — the
    # admission gate sees them back to back against a possibly-stale EWMA)
    for b in range(spec.bursts):
        at = (b + 1) * spec.duration_s / (spec.bursts + 1)
        for _ in range(spec.burst_size):
            tenant, cls = pick_tenant(at)
            events.append(TraceEvent(
                at_s=round(at, 6), tenant=tenant, cls=cls,
                pods=rng.randint(spec.pods_lo, spec.pods_hi),
                storm=in_storm(at),
            ))
    events.sort(key=lambda e: (e.at_s, e.tenant))
    return events


def run_trace(
    service,
    trace: Sequence[TraceEvent],
    request_factory: Callable[[TraceEvent], tuple],
    time_scale: float = 1.0,
    register: bool = True,
    drain_timeout_s: float = 30.0,
    time_fn=time.monotonic,
    sleep_fn=time.sleep,
) -> Dict:
    """Drive the trace open-loop against ``service`` and report.

    ``request_factory(event) -> (pods, instance_types, templates, kwargs)``
    builds each request's payload. ``time_scale`` compresses the schedule
    (0.1 = 10x faster than the trace's nominal clock); the loop NEVER waits
    on outcomes between submits — that is the open-loop contract. Outcomes
    are collected after the last arrival, bounded by ``drain_timeout_s``.
    """
    if register:
        seen = {}
        for ev in trace:
            seen.setdefault(ev.tenant, ev.cls)
        for tenant, cls in seen.items():
            service.register_tenant(tenant, tenant_class=cls)
    pending: List[Tuple[TraceEvent, object, float]] = []
    started = time_fn()
    for ev in trace:
        due = started + ev.at_s * time_scale
        delay = due - time_fn()
        if delay > 0:
            sleep_fn(delay)
        pods, its, tpls, kwargs = request_factory(ev)
        ticket = service.submit(ev.tenant, pods, its, tpls, **kwargs)
        pending.append((ev, ticket, time_fn()))
    deadline = time_fn() + drain_timeout_s
    outcomes = []
    for ev, ticket, _at in pending:
        outcomes.append((ev, ticket.wait(max(0.0, deadline - time_fn()))))
    wall = time_fn() - started
    return summarize(outcomes, wall)


def summarize(outcomes: Sequence[Tuple[TraceEvent, object]], wall_s: float) -> Dict:
    """Fold (event, outcome) pairs into the serve_fleet report row."""
    served_pods = 0
    latencies: List[float] = []
    by_outcome: Dict[str, int] = {}
    by_class: Dict[str, Dict[str, int]] = {}
    unclassified = 0
    pending = 0
    for ev, out in outcomes:
        row = by_class.setdefault(ev.cls, {"submitted": 0, "served": 0, "shed": 0})
        row["submitted"] += 1
        if out.status == "ok":
            served_pods += ev.pods
            latencies.append(out.latency_s)
            by_outcome["ok"] = by_outcome.get("ok", 0) + 1
            row["served"] += 1
        elif out.status == "pending":
            # still in flight at drain timeout: not shed, not unclassified
            pending += 1
            by_outcome["pending"] = by_outcome.get("pending", 0) + 1
        elif out.status == "error":
            by_outcome["error"] = by_outcome.get("error", 0) + 1
        else:
            reason = out.reason or "UNCLASSIFIED"
            by_outcome[reason] = by_outcome.get(reason, 0) + 1
            row["shed"] += 1
            if reason not in _CLASSIFIED_UNSERVED:
                unclassified += 1
    latencies.sort()

    def quantile(q: float) -> float:
        if not latencies:
            return 0.0
        return latencies[min(len(latencies) - 1, int(q * len(latencies)))]

    return {
        "requests": len(outcomes),
        "served": by_outcome.get("ok", 0),
        "served_pods": served_pods,
        "pending": pending,
        "unclassified": unclassified,
        "wall_s": round(wall_s, 4),
        "agg_pods_per_s": round(served_pods / wall_s, 2) if wall_s > 0 else 0.0,
        "p50_cycle_s": round(quantile(0.50), 6),
        "p99_cycle_s": round(quantile(0.99), 6),
        "outcomes": dict(sorted(by_outcome.items())),
        "by_class": by_class,
    }


FLEET_CLASSES = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
# the wait for the last admitted request to resolve once arrivals stop
FLEET_DRAIN_TIMEOUT_S = 180.0


def fleet_spec(n_tenants: int, classes: Dict[str, float], requests: int, rate_hz: float) -> TraceSpec:
    """The serve_fleet trace's spec: ``requests`` arrivals at ``rate_hz``,
    a 64-tenant active window, three bursts and 4-pod batches."""
    return TraceSpec(
        n_tenants=n_tenants,
        classes=dict(classes),
        duration_s=requests / rate_hz,
        base_rate_hz=rate_hz,
        active_window=min(64, n_tenants),
        churn_period_s=max(0.05, requests / rate_hz / 8.0),
        bursts=3,
        burst_size=min(32, max(8, requests // 16)),
        pods_lo=4, pods_hi=4,
    )


def serve_fleet(
    device=None,
    n_tenants: int = 1000,
    requests: int = 600,
    replicas: int = 2,
    seed: int = 17,
) -> Dict:
    """One open-loop trace at the serve_fleet shape over the port: 4-pod
    batches of ``default_pod_factory`` over 50 instance types, every tenant
    a ``build_tenant_solver(primary=TorchSolver(device), fallback=
    OracleSolver())`` stack. The arrival rate is 8 / svc_s and the
    admission bound 25 * svc_s, where svc_s is the median warm solo solve
    through ``SupervisedSolver(TorchSolver())``. The tenants are served by a
    ``ReplicaSet`` of ``replicas`` stacking services in the classes
    ``FLEET_CLASSES``. Returns ``summarize``'s report with the calibration,
    the stacked share and the replica placements."""
    import statistics

    from karpenter_tpu_torch import serve as serve_pkg
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.serve.replica import ReplicaSet
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver, resolve_device
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    device = resolve_device(device)
    its = instance_types(50)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="fleet")), its, range(len(its)))
    rng = random.Random(42)
    # one pod batch per arrival, all in one padded-shape family
    pods = [default_pod_factory(f"fl-{i}", rng) for i in range(4)]

    def solver_factory(tenant):
        return serve_pkg.build_tenant_solver(tenant, primary=TorchSolver(device=device), fallback=OracleSolver())

    # calibrate the arrival rate off the measured warm solo solve: open-loop
    # saturation needs arrivals past service capacity
    cal = SupervisedSolver(TorchSolver(device=device), fallback=OracleSolver())
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        cal.solve(pods, its, [tpl])
        walls.append(time.perf_counter() - t0)
    svc_s = max(1e-4, statistics.median(walls[1:]))
    rate_hz = 8.0 / svc_s  # past the 8-lane stacked capacity
    admit_bound_s = 25.0 * svc_s

    trace = make_trace(fleet_spec(n_tenants, FLEET_CLASSES, requests, rate_hz), seed=seed)
    service = ReplicaSet(n_replicas=replicas, solver_factory=solver_factory, max_tenants=n_tenants,
                         admit_deadline_s=admit_bound_s, classes=FLEET_CLASSES, batching=True, device=device)
    # seed the wait estimator with the calibrated service time: a cold
    # estimator (predicted wait 0) would blind-admit the whole trace
    for rep in service.replicas:
        rep._wait.observe(svc_s)
    before = service.summary()
    try:
        report = run_trace(service, trace, lambda ev: (pods, its, [tpl], {}),
                           drain_timeout_s=FLEET_DRAIN_TIMEOUT_S)
        after = service.summary()
        placements = service.snapshot()["placement_reasons"]
    finally:
        service.close()
    completed = after["completed"] - before.get("completed", 0)
    report["batch_hit_rate"] = round((after["batched"] - before.get("batched", 0)) / max(completed, 1), 4)
    report["placements"] = placements
    report.update(tenants=n_tenants, replicas=replicas, classes=dict(FLEET_CLASSES), calibrated_service_s=round(svc_s, 6),
                  rate_hz=round(rate_hz, 2), admit_bound_s=round(admit_bound_s, 6))
    return report


def main(argv=None) -> int:
    """One serve_fleet trace over the port, printed as JSON; exit 1 on any
    unclassified outcome."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the solvers' device (default cuda; cpu on a host)")
    ap.add_argument("--tenants", type=int, default=1000)
    ap.add_argument("--requests", type=int, default=600)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    report = serve_fleet(device=args.device, n_tenants=args.tenants, requests=args.requests,
                         replicas=args.replicas, seed=args.seed)
    print(json.dumps(report, indent=2))
    return 0 if report["unclassified"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
