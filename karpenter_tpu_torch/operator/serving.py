"""Metrics + health endpoints.

Port of the JAX package's ``operator/serving.py`` (the reference's metrics
port and health probes, operator.go:139-182): /metrics serves the registry
in Prometheus text format. /healthz is liveness-only (the process answers,
always 200); /readyz reflects real readiness when the operator wires an
OperatorStatus in, and /statusz exposes the supervisor's circuit and failure
state as JSON.

Where the port differs:
  * readiness also needs no kernel build error and no device fault
    (``solver/supervisor.device_fault``) recorded by a controller since its
    last clean pass that did device work, or by the warm: the port's
    supervisor raises such errors instead of failing them over, so its
    circuit alone would leave /readyz at 200 while every pass raises.
    /statusz names the build error and each recorded fault;
  * /debug/programs answers from the program registry (obs/programs.py) as
    in the JAX package, with the kernel inventory (``kernel_inventory``:
    each kernel's name, library, whether that library is built or loaded
    and from where, and ``kernels.LAUNCHES``) under its own key,
    ``kernels``; /statusz["programs"] is the registry's summary and
    /statusz["kernels"] the inventory;
  * --enable-profiling runs ``torch.profiler`` over the host and the card
    (the JAX package runs ``jax.profiler``).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from karpenter_tpu_torch.metrics import REGISTRY

# Every debug endpoint the handler resolves — /statusz indexes these and
# tools/metrics_lint.py checks docs/OBSERVABILITY.md names each one (and
# names nothing that is not here).
DEBUG_ENDPOINTS = (
    "/debug/explain",
    "/debug/flight",
    "/debug/programs",
    "/debug/slo",
    "/debug/tenants",
    "/debug/traces",
)


def _series(name: str, labels, value) -> str:
    if labels:
        label_s = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return f"{name}{{{label_s}}} {value}"
    return f"{name} {value}"


def render_prometheus() -> str:
    # HELP/TYPE headers come from describe() so every REGISTERED metric
    # appears in the exposition even before its first sample — scrape configs
    # and tools/metrics_lint.py see the full surface from process start.
    from karpenter_tpu_torch.obs import slo

    # burn-rate gauges are computed on the read path (the engine's hot path
    # never allocates label dicts); one flag check when the engine is off
    slo.refresh_metrics()
    samples: dict = {}
    for kind, name, labels, value in REGISTRY.collect():
        samples.setdefault(name, []).append((kind, labels, value))
    lines = []
    for kind, name, help_ in REGISTRY.describe():
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for _, labels, value in samples.pop(name, ()):
            if kind == "histogram":
                lines.append(_series(name + "_count", labels, value["count"]))
                lines.append(_series(name + "_sum", labels, value["sum"]))
            else:
                lines.append(_series(name, labels, value))
    for name, entries in samples.items():  # unregistered strays, if any
        for kind, labels, value in entries:
            if kind == "histogram":
                lines.append(_series(name + "_count", labels, value["count"]))
                lines.append(_series(name + "_sum", labels, value["sum"]))
            else:
                lines.append(_series(name, labels, value))
    return "\n".join(lines) + "\n"


def kernel_inventory() -> dict:
    """The kernels this process can launch: per library its name, file,
    whether it is built, and the launches counted under it and its modes."""
    from karpenter_tpu_torch import kernels

    rows = []
    origins = kernels.library_origins()
    for name in kernels.SOURCES:
        path = kernels.loaded_path(name) or kernels.library_path(name)
        rows.append({"name": name, "source": kernels.SOURCES[name], "library": path.name,
                     "built": name in origins or path.exists(), "origin": origins.get(name)})
    launches = dict(kernels.LAUNCHES)
    return {
        "kernels": rows,
        "built": sum(r["built"] for r in rows),
        "launches": launches,
        "launches_total": sum(launches.values()),
    }


class OperatorStatus:
    """Readiness/introspection the endpoints consult. ``supervisor`` is the
    SupervisedSolver (or None for an unwrapped backend); ``warmup_ready``
    answers whether the startup kernel build finished."""

    def __init__(
        self,
        supervisor=None,
        warmup_ready: Optional[Callable[[], bool]] = None,
        serve_service=None,
    ):
        self.supervisor = supervisor
        self.warmup_ready = warmup_ready
        # the multi-tenant SolveService, when one is wired: readiness then
        # also requires a live dispatcher, and /statusz + /debug/tenants
        # expose its streams
        self.serve_service = serve_service
        # the startup kernel build's error, if it failed (never cleared: the
        # same sources fail the same way again)
        self.build_error: Optional[str] = None
        # controller name -> the device fault its last pass raised; cleared
        # by that controller's next clean pass that did device work
        self._faults: dict = {}
        self._lock = threading.Lock()

    def record_build_error(self, exc: BaseException) -> None:
        with self._lock:
            self.build_error = f"{type(exc).__name__}: {exc}"

    def record_device_fault(self, controller: str, exc: BaseException) -> None:
        with self._lock:
            self._faults[controller] = f"{type(exc).__name__}: {exc}"

    def clear_device_fault(self, controller: str) -> None:
        if self._faults:
            with self._lock:
                self._faults.pop(controller, None)

    def device_faults(self) -> dict:
        with self._lock:
            return dict(self._faults)

    def ready(self) -> bool:
        """Ready to serve traffic: the warm (the kernel build first) done
        and clean, no restart recovery in flight, no device fault
        outstanding, and the primary solve path not hard-open.
        Half-open counts as ready: the next solve probes the primary and the
        fallback still answers either way."""
        if self.warmup_ready is not None and not self.warmup_ready():
            return False
        from karpenter_tpu_torch.solver import aot

        if aot.recovery_blocking():
            # restored kernel libraries must pass the probe solve before any
            # traffic can land on them (solver/warmup.py restore_and_probe)
            return False
        if self.build_error is not None or self._faults:
            return False
        if self.supervisor is not None:
            from karpenter_tpu_torch.solver.supervisor import CIRCUIT_OPEN

            if self.supervisor.circuit_state() == CIRCUIT_OPEN:
                return False
        if self.serve_service is not None and not self.serve_service.healthy():
            # a closed service or dead dispatcher thread would queue
            # requests forever: stop routing traffic here
            return False
        return True

    def statusz(self) -> dict:
        from karpenter_tpu_torch.obs import trace

        out = {"ready": self.ready()}
        if self.warmup_ready is not None:
            out["warmup_complete"] = bool(self.warmup_ready())
        if self.build_error is not None:
            out["kernel_build_error"] = self.build_error
        faults = self.device_faults()
        if faults:
            out["device_faults"] = faults
        if self.supervisor is not None:
            out["solver"] = self.supervisor.status()
        captured = trace.ring().snapshot()
        summary = {"enabled": trace.enabled(), "captured": len(captured)}
        if captured:
            last = captured[0]
            summary["last"] = {
                k: last.get(k)
                for k in ("trace_id", "name", "backend", "duration_s", "phases")
            }
        out["traces"] = summary
        # restart recovery (solver/aot.py): current phase plus the last
        # completed recovery record: restore summary, probe verdict, wall
        # seconds, and the recovery trace id
        from karpenter_tpu_torch.obs import programs
        from karpenter_tpu_torch.solver import aot

        recovery = {"phase": aot.recovery_phase()}
        last = aot.last_recovery()
        if last is not None:
            recovery["last_restart_recovery"] = last
        out["recovery"] = recovery
        # program registry one-liner (obs/programs.py), and the kernel
        # inventory (/debug/programs has both in full)
        out["programs"] = programs.registry().summary()
        out["kernels"] = kernel_inventory()
        from karpenter_tpu_torch.obs import explain

        # unschedulable summary over the report ring (/debug/explain drills in)
        out["unschedulable"] = explain.summary()
        if self.serve_service is not None:
            # multi-tenant fleet totals (/debug/tenants has per-stream rows)
            out["serve"] = self.serve_service.summary()
        # degraded-mesh health (solver/mesh_health.py): only once a tracker
        # exists
        from karpenter_tpu_torch.solver import mesh_health

        if mesh_health.has_tracker():
            out["mesh_health"] = mesh_health.tracker().snapshot()
        # fleet SLO rollup (obs/slo.py); /debug/slo has the full table
        from karpenter_tpu_torch.obs import slo

        out["slo"] = slo.rollup()
        out["debug_endpoints"] = list(DEBUG_ENDPOINTS)
        return out


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server API)
        status: Optional[OperatorStatus] = getattr(self.server, "status", None)
        if self.path.startswith("/metrics"):
            body = render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
        elif self.path.startswith("/healthz"):
            # liveness only: if this handler runs, the process is alive
            body = b"ok\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
        elif self.path.startswith("/readyz"):
            # no wired status (tests, bare serve()) preserves always-ready
            if status is None or status.ready():
                body = b"ok\n"
                self.send_response(200)
            else:
                body = b"not ready\n"
                self.send_response(503)
            self.send_header("Content-Type", "text/plain")
        elif self.path.startswith("/statusz"):
            payload = status.statusz() if status is not None else {"ready": True}
            body = (json.dumps(payload, indent=1, default=str) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path.startswith("/debug/programs"):
            from karpenter_tpu_torch.obs import programs

            # the program registry: per-program launches, load sources and
            # bytes, memory samples; the kernel inventory beside it
            payload = programs.registry().snapshot()
            payload["kernels"] = kernel_inventory()
            body = (json.dumps(payload, indent=1, default=str) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path.startswith("/debug/explain"):
            from karpenter_tpu_torch.obs import explain

            # decision provenance of recent solves: per-pod reasons, hints,
            # raw gate bits, nomination margins (most recent report first)
            payload = {
                "enabled": explain.enabled(),
                "captured": len(explain.ring()),
                "reports": explain.ring().snapshot(),
            }
            body = (json.dumps(payload, indent=1, default=str) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path.startswith("/debug/tenants"):
            from karpenter_tpu_torch import serve as serve_pkg

            # per-tenant stream rows of the multi-tenant solve service:
            # queue pressure, DWRR balance, outcome counters, latency
            # quantiles, circuit state. Resolves the wired service first,
            # then the process-wide one (a bare serve() still answers).
            service = (
                getattr(status, "serve_service", None)
                or serve_pkg.current_service()
            )
            payload = (
                service.snapshot()
                if service is not None
                else {"enabled": serve_pkg.enabled(), "tenants": []}
            )
            body = (json.dumps(payload, indent=1, default=str) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path.startswith("/debug/slo"):
            from karpenter_tpu_torch.obs import slo

            # the full objective table: per-objective burn rates, event
            # counts, breach history, plus the fleet rollup verdict
            body = (
                json.dumps(slo.debug_payload(), indent=1, default=str) + "\n"
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path.startswith("/debug/flight"):
            from karpenter_tpu_torch.obs import flight

            # the flight-recorder ring (chronological) and the on-disk dump
            # inventory; tools/flight_report.py renders either as a timeline
            body = (
                json.dumps(flight.debug_payload(), indent=1, default=str)
                + "\n"
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path.startswith("/debug/traces"):
            from karpenter_tpu_torch.obs import trace

            captured = trace.ring().snapshot()  # most recent first
            if "chrome" in self.path or "format=chrome" in self.path:
                # Perfetto/chrome://tracing-loadable trace-event JSON
                body = (trace.chrome_trace_json(captured, indent=1) + "\n").encode()
            else:
                payload = {
                    "enabled": trace.enabled(),
                    "captured": len(captured),
                    "traces": captured,
                }
                body = (json.dumps(payload, indent=1, default=str) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        else:
            body = b"not found\n"
            self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def serve(
    port: int, host: str = "", status: Optional[OperatorStatus] = None
) -> ThreadingHTTPServer:
    """Start the endpoint server on a daemon thread; returns the server (call
    .shutdown() to stop). Binds all interfaces by default so in-cluster
    probes/scrapes against the pod IP work."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.status = status
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"karpenter-tpu/serve-{port}").start()
    return server


_profiler = None


def start_profiler(trace_dir: Optional[str] = None) -> Optional[str]:
    """--enable-profiling: begin a torch.profiler trace of the host and, on
    a card, CUDA activity; stop_profiler writes it as a Chrome trace under
    ``trace_dir`` (default: the temporary directory)."""
    global _profiler
    import tempfile

    import torch

    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "karpenter-tpu-torch-profile")
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        prof.trace_dir = trace_dir
        _profiler = prof
        return trace_dir
    except Exception:
        return None


def stop_profiler() -> Optional[str]:
    """End the trace begun by start_profiler; returns the trace file."""
    global _profiler
    prof, _profiler = _profiler, None
    if prof is None:
        return None
    try:
        prof.stop()
        path = os.path.join(prof.trace_dir, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        return path
    except Exception:
        return None
