"""karpenter_tpu_torch/tools/load_harness.py against tools/load_harness.py:
every test of tests/test_load_harness.py through both packages' harness and
SolveService, the trace equal event for event, the report equal on the same
outcomes, and a short open-loop run over the port's SolveService with
TorchSolver tenants on the CPU."""

import sys
import threading
from pathlib import Path

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tools.load_harness as J  # noqa: E402
from karpenter_tpu_torch.tools import load_harness as T  # noqa: E402

PACKAGES = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _tenant_labels():
    """Forget the tenant label values this module's services take: each
    package's metrics keep the ids of the first 32 tenants a process sees
    (``metrics/registry.tenant_label``), so a later test in the same process
    would see its tenants as ``other``."""
    import importlib

    regs = [importlib.import_module(f"{pkg}.metrics.registry") for pkg in ("karpenter_tpu", "karpenter_tpu_torch")]
    saved = [dict(reg._tenant_label_seen) for reg in regs]
    yield
    for reg, seen in zip(regs, saved):
        with reg._tenant_label_lock:
            reg._tenant_label_seen.clear()
            reg._tenant_label_seen.update(seen)


def harness(pkg):
    return J if pkg == "jax" else T


def service(pkg, **kwargs):
    """The package's SolveService over stub solvers (the port's on the CPU)."""
    if pkg == "jax":
        from karpenter_tpu.serve.dispatcher import SolveService

        return SolveService(**kwargs)
    from karpenter_tpu_torch.serve.dispatcher import SolveService

    return SolveService(device="cpu", **kwargs)


class _Outcome:
    def __init__(self, status, reason="", latency_s=0.0):
        self.status = status
        self.reason = reason
        self.latency_s = latency_s


def _ev(h, cls="gold", pods=2, at=0.0):
    return h.TraceEvent(at_s=at, tenant="t0000", cls=cls, pods=pods)


class _StubResult:
    new_claims = ()
    node_pods: dict = {}
    failures: dict = {}

    def num_scheduled(self):
        return 0


class _StubSolver:
    def solve(self, pods, its, tpls, **kwargs):
        return _StubResult()


# -- tests/test_load_harness.py through both packages ---------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
class TestTrace:
    def test_same_seed_same_trace_byte_for_byte(self, pkg):
        h = harness(pkg)
        spec = h.TraceSpec(n_tenants=50, duration_s=2.0, base_rate_hz=40.0)
        assert h.make_trace(spec, seed=3) == h.make_trace(spec, seed=3)
        assert h.make_trace(spec, seed=3) != h.make_trace(spec, seed=4)

    def test_events_sorted_and_bounded(self, pkg):
        h = harness(pkg)
        spec = h.TraceSpec(n_tenants=50, duration_s=2.0, base_rate_hz=40.0)
        trace = h.make_trace(spec, seed=1)
        assert trace
        ats = [e.at_s for e in trace]
        assert ats == sorted(ats)
        assert all(0.0 <= a < spec.duration_s for a in ats)
        assert all(spec.pods_lo <= e.pods <= spec.pods_hi for e in trace)

    def test_bursts_land_as_clusters(self, pkg):
        h = harness(pkg)
        spec = h.TraceSpec(n_tenants=50, duration_s=4.0, base_rate_hz=10.0, bursts=2, burst_size=16)
        by_instant = {}
        for e in h.make_trace(spec, seed=0):
            by_instant[e.at_s] = by_instant.get(e.at_s, 0) + 1
        clustered = [t for t, n in by_instant.items() if n >= spec.burst_size]
        assert len(clustered) == spec.bursts

    def test_storm_windows_tag_events(self, pkg):
        h = harness(pkg)
        quiet = h.TraceSpec(n_tenants=20, duration_s=2.0, storm_windows=0)
        assert not any(e.storm for e in h.make_trace(quiet, seed=0))
        stormy = h.TraceSpec(n_tenants=20, duration_s=2.0, storm_windows=1, storm_span_s=1.0)
        trace = h.make_trace(stormy, seed=0)
        assert any(e.storm for e in trace)
        assert any(not e.storm for e in trace)

    def test_fleet_stripes_every_class(self, pkg):
        h = harness(pkg)
        spec = h.TraceSpec(n_tenants=10)
        fleet = h.build_fleet(spec)
        assert len(fleet) == 10
        assert {cls for _, cls in fleet} == set(spec.classes)
        # churn: across a long trace, traffic reaches beyond one window
        spec = h.TraceSpec(n_tenants=200, duration_s=4.0, base_rate_hz=100.0, active_window=16,
                           churn_period_s=0.5)
        tenants = {e.tenant for e in h.make_trace(spec, seed=0)}
        assert len(tenants) > spec.active_window


@pytest.mark.parametrize("pkg", PACKAGES)
class TestSummarize:
    def test_classified_vocabulary_and_unclassified_detection(self, pkg):
        h = harness(pkg)
        rows = [
            (_ev(h, pods=3), _Outcome("ok", "accepted", latency_s=0.010)),
            (_ev(h, pods=2), _Outcome("ok", "accepted", latency_s=0.030)),
            (_ev(h, cls="bronze"), _Outcome("overloaded", "overloaded-saturated")),
            (_ev(h, cls="bronze"), _Outcome("rejected", "rejected-shutdown")),
            (_ev(h), _Outcome("pending")),
            (_ev(h), _Outcome("error", "boom")),
            (_ev(h, cls="bronze"), _Outcome("overloaded", "mystery-reason")),
        ]
        report = h.summarize(rows, wall_s=2.0)
        assert report["requests"] == 7
        assert report["served"] == 2
        assert report["served_pods"] == 5
        assert report["pending"] == 1
        assert report["unclassified"] == 1  # only "mystery-reason"
        assert report["agg_pods_per_s"] == 2.5
        assert report["outcomes"]["overloaded-saturated"] == 1
        assert report["by_class"]["bronze"]["shed"] == 3
        assert report["by_class"]["gold"]["served"] == 2

    def test_quantiles_from_served_latencies(self, pkg):
        h = harness(pkg)
        rows = [(_ev(h), _Outcome("ok", latency_s=0.001 * (i + 1))) for i in range(100)]
        report = h.summarize(rows, wall_s=1.0)
        assert report["p50_cycle_s"] == 0.051
        assert report["p99_cycle_s"] == 0.1
        assert h.summarize([], wall_s=0.0)["p99_cycle_s"] == 0.0


@pytest.mark.parametrize("pkg", PACKAGES)
class TestRunTrace:
    def test_open_loop_never_waits_between_submits(self, pkg):
        """The driver sleeps only toward each arrival instant; it must not
        block on outcomes mid-trace. With a virtual clock every computed
        delay is observable: all sleeps are bounded by inter-arrival gaps."""
        h = harness(pkg)

        class _Clock:
            t = 0.0

            def __call__(self):
                return self.t

        clock = _Clock()
        sleeps = []

        def sleep(d):
            sleeps.append(d)
            clock.t += d

        spec = h.TraceSpec(n_tenants=20, duration_s=1.0, base_rate_hz=40.0, bursts=1, burst_size=8,
                           active_window=8)
        trace = h.make_trace(spec, seed=5)
        svc = service(pkg, solver_factory=lambda t: _StubSolver(), batching=False, max_tenants=spec.n_tenants,
                      classes=dict(spec.classes))
        try:
            report = h.run_trace(svc, trace, lambda ev: ([object()] * ev.pods, [], [], {}), time_fn=clock,
                                 sleep_fn=sleep)
        finally:
            svc.close()
        assert report["requests"] == len(trace)
        assert report["unclassified"] == 0
        gaps = [b.at_s - a.at_s for a, b in zip(trace, trace[1:])]
        # one sleep per arrival at most, each no longer than its gap
        assert len(sleeps) <= len(trace)
        assert max(sleeps) <= max(gaps) + 1e-6

    def test_end_to_end_stub_fleet_all_outcomes_classified(self, pkg):
        h = harness(pkg)
        spec = h.TraceSpec(n_tenants=100, duration_s=1.0, base_rate_hz=80.0, active_window=16, bursts=2,
                           burst_size=12)
        trace = h.make_trace(spec, seed=9)
        svc = service(pkg, solver_factory=lambda t: _StubSolver(), batching=False, max_tenants=spec.n_tenants,
                      classes=dict(spec.classes), admit_deadline_s=5.0)
        try:
            report = h.run_trace(svc, trace, lambda ev: ([object()] * ev.pods, [], [], {}), time_scale=0.02)
        finally:
            svc.close()
        assert report["requests"] == len(trace)
        assert report["unclassified"] == 0
        assert report["served"] > 0
        accounted = (report["served"] + report["pending"]
                     + sum(n for reason, n in report["outcomes"].items() if reason not in ("ok", "pending")))
        assert accounted == report["requests"]
        assert set(report["by_class"]) <= set(spec.classes)


# -- the port against the JAX system's harness -------------------------------------

SPECS = {
    "default": {},
    "serve-fleet": dict(n_tenants=1000, duration_s=2.5, base_rate_hz=240.0, active_window=64, churn_period_s=0.3125,
                        bursts=3, burst_size=32, pods_lo=4, pods_hi=4),
    "storms": dict(n_tenants=40, duration_s=3.0, base_rate_hz=30.0, storm_windows=2, storm_span_s=0.4,
                   classes={"a": 1.0, "b": 3.0}),
    "small-window": dict(n_tenants=7, duration_s=1.5, base_rate_hz=90.0, active_window=16, bursts=0,
                         diurnal_amplitude=0.9),
}


@pytest.mark.parametrize("seed", [0, 17, 123])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_make_trace_equals_the_jax_harness(spec, seed):
    kw = SPECS[spec]
    tt = T.make_trace(T.TraceSpec(**kw), seed=seed)
    jt = J.make_trace(J.TraceSpec(**kw), seed=seed)
    assert tt
    assert [tuple(vars(e).values()) for e in tt] == [tuple(vars(e).values()) for e in jt]
    assert T.build_fleet(T.TraceSpec(**kw)) == J.build_fleet(J.TraceSpec(**kw))
    assert T._CLASSIFIED_UNSERVED == J._CLASSIFIED_UNSERVED


def test_fleet_spec_is_the_serve_fleet_shape():
    """``fleet_spec`` is bench.py's serve_fleet spec: the same trace."""
    rate = 240.0
    spec = T.fleet_spec(1000, T.FLEET_CLASSES, 600, rate)
    jspec = J.TraceSpec(n_tenants=1000, classes=dict(T.FLEET_CLASSES), duration_s=600 / rate, base_rate_hz=rate,
                        active_window=64, churn_period_s=max(0.05, 600 / rate / 8.0), bursts=3, burst_size=32,
                        pods_lo=4, pods_hi=4)
    assert vars(spec) == vars(jspec)
    assert [vars(e) for e in T.make_trace(spec, 17)] == [vars(e) for e in J.make_trace(jspec, 17)]


def test_summarize_equal_on_the_same_outcomes():
    statuses = [("ok", "accepted"), ("overloaded", "overloaded-queue-full"), ("pending", ""),
                ("rejected", "rejected-max-tenants"), ("error", "boom"), ("overloaded", "overloaded-expired"),
                ("overloaded", "strange"), ("ok", "")]
    jtrace = J.make_trace(J.TraceSpec(n_tenants=30, duration_s=1.0, base_rate_hz=50.0), seed=4)
    ttrace = T.make_trace(T.TraceSpec(n_tenants=30, duration_s=1.0, base_rate_hz=50.0), seed=4)
    outs = [_Outcome(*statuses[i % len(statuses)], latency_s=0.001 * ((7 * i) % 23)) for i in range(len(jtrace))]
    assert T.summarize(list(zip(ttrace, outs)), 1.7) == J.summarize(list(zip(jtrace, outs)), 1.7)


def test_open_loop_run_over_torch_solver_tenants():
    """A short open-loop trace over the port's SolveService with
    ``build_tenant_solver(primary=TorchSolver(device="cpu"))`` tenants:
    arrivals fire while earlier requests are still in flight (the submits
    never wait on outcomes), and every unserved request carries a
    classified outcome."""
    from karpenter_tpu_torch import serve
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.tools.chaos_sweep import build_problem

    pods, its, tpls = build_problem(4, 20)
    svc = serve.SolveService(
        solver_factory=lambda t: serve.build_tenant_solver(t, primary=TorchSolver(device="cpu"),
                                                           fallback=OracleSolver()),
        batching=False, max_tenants=40, classes=dict(T.FLEET_CLASSES), admit_deadline_s=0.3, device="cpu",
    )
    tickets, in_flight = [], []
    lock = threading.Lock()

    class _Recording:
        """The service, recording at each submit how many earlier tickets
        were still unresolved."""

        def register_tenant(self, tenant, **kwargs):
            return svc.register_tenant(tenant, **kwargs)

        def submit(self, tenant, *args, **kwargs):
            with lock:
                in_flight.append(sum(not t.done() for t in tickets))
            ticket = svc.submit(tenant, *args, **kwargs)
            tickets.append(ticket)
            return ticket

    trace = T.make_trace(T.fleet_spec(40, T.FLEET_CLASSES, 30, 300.0), seed=3)
    try:
        report = T.run_trace(_Recording(), trace, lambda ev: (pods, its, tpls, {}), drain_timeout_s=120.0)
    finally:
        svc.close()
    assert report["requests"] == len(trace) == len(tickets)
    assert max(in_flight) > 1  # later arrivals were submitted before earlier ones completed
    assert report["unclassified"] == 0
    assert report["pending"] == 0 and report["outcomes"].get("error", 0) == 0
    assert report["served"] > 0
    shed = sum(n for reason, n in report["outcomes"].items() if reason != "ok")
    assert report["served"] + shed == report["requests"]
    assert all(reason in T._CLASSIFIED_UNSERVED for reason in report["outcomes"] if reason != "ok")


def test_serve_fleet_on_the_cpu():
    """``serve_fleet`` at a small size: calibrated, open-loop over two
    replicas, every request accounted with no unclassified outcome."""
    report = T.serve_fleet(device="cpu", n_tenants=48, requests=24, replicas=2)
    assert report["unclassified"] == 0 and report["pending"] == 0
    assert report["served"] > 0 and report["replicas"] == 2
    assert sum(report["outcomes"].values()) == report["requests"]
    assert report["calibrated_service_s"] > 0 and report["admit_bound_s"] == pytest.approx(
        25 * report["calibrated_service_s"], rel=1e-3)
