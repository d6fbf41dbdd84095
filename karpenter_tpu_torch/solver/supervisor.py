"""Solver supervisor — deadlines, retries, circuit-broken fallback, salvage.

Counterpart of the JAX package's ``solver/supervisor.py`` (``SupervisedSolver``
:120): the SolverBackend the controllers call. It wraps a primary backend
(normally ``TorchSolver``, whose device programs are the CUDA kernels) and an
optional fallback (the pure-Python ``OracleSolver``, the slow exact
baseline) with:

  deadline   every primary solve runs under a wall-clock watchdog
             (``KARPENTER_TPU_SOLVE_DEADLINE_S``; 0 disables and the call is
             inlined with zero overhead). The watchdog is a join(timeout) on
             a daemon worker thread: a hung device call cannot be cancelled
             from Python, so the thread is abandoned and the cycle proceeds.
  classify   failures map to classes — compile / device / nan / deadline /
             encode / unknown — by exception type and message
             (``classify_failure``: the kernels' typed errors, the CUDA
             runtime's messages, and the JAX package's rules). Transient
             classes (device, deadline) are retried with capped exponential
             backoff and deterministic jitter (crc32 of the attempt, never
             the salted ``hash()``); deterministic classes go straight to
             fallback.
  validate   successful results pass the invariant gate before leaving: the
             device gate (``verify.full_gate`` over the ``gate_counts``
             kernel) where the result carries its GateContext, else the host
             validator (solver/validator.py). A violation quarantines the
             result to disk (forensics.dump_quarantine), counts as a primary
             failure, and fails over. An error of the device gate on a
             primary result is a failed attempt of the primary, classified
             and retried like any solve error.
  raise      an error of the port's own kernels or of the CUDA runtime
             (``device_fault``: the kernels' typed build and launch errors,
             a CUDA out-of-memory error, a ``CUDA error: ...``) is retried
             like its class and then raised to the caller. It neither
             fails over nor salvages nor counts towards the circuit: an
             oracle answer on the host would hide a kernel that does not
             build or launch. This is where the port differs from the JAX
             package, which fails over every class.
  circuit    N consecutive primary failures trip the breaker: solves route
             straight to the fallback until a cooldown elapses, then one
             half-open probe decides between closing and re-opening. State is
             exported via the ``solver_circuit_state`` gauge.
  salvage    when no backend can answer, the cycle is never dropped: the
             supervisor returns a SolveResult that requeues every pod via
             ``failures``, and a validation failure with no fallback strips
             only the violating bins, keeping the placements that verified.

On the fault-free path the supervisor wraps, never alters, the primary's
result: the same object comes back. Counters, circuit states, flight record
kinds and trace span names are the JAX package's. ``streaming=True`` (or
``KARPENTER_TPU_DELTA=1``) wraps the primary in the warm-state streaming
layer (streaming/warm.StreamingSolver), as the JAX package does; a
quarantine resets its carried state and removes its journal.
"""

from __future__ import annotations

import contextvars
import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence

import torch

from karpenter_tpu_torch.kernels import KernelCompileError, KernelDeviceError
from karpenter_tpu_torch.metrics.registry import (
    SOLVE_DEADLINE_EXCEEDED,
    SOLVER_CIRCUIT_STATE,
    SOLVER_FALLBACK,
    SOLVER_RETRIES,
    VALIDATOR_REJECTIONS,
    tenant_label,
)
from karpenter_tpu_torch.obs import flight, slo, trace
from karpenter_tpu_torch.solver import validator as val
from karpenter_tpu_torch.solver.backend import SolveResult, SolverBackend
from karpenter_tpu_torch.testing import faults

log = logging.getLogger(__name__)

CLASS_COMPILE = "compile"
CLASS_DEVICE = "device"
CLASS_NAN = "nan"
CLASS_DEADLINE = "deadline"
CLASS_ENCODE = "encode"
CLASS_VALIDATION = "validation"
CLASS_UNKNOWN = "unknown"

# retrying helps only when the same call can succeed next time
RETRYABLE = frozenset({CLASS_DEVICE, CLASS_DEADLINE, CLASS_UNKNOWN})

CIRCUIT_CLOSED = "closed"
CIRCUIT_HALF_OPEN = "half-open"
CIRCUIT_OPEN = "open"
_CIRCUIT_GAUGE = {CIRCUIT_CLOSED: 0, CIRCUIT_HALF_OPEN: 1, CIRCUIT_OPEN: 2}


class DeadlineExceeded(Exception):
    """The watchdog gave up on a solve."""


class NaNResultError(Exception):
    """The solve returned NaN/inf request tensors (diverged reduction)."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def classify_failure(exc: BaseException) -> str:
    """Map an exception from the solve path to a failure class. Type name
    first (the injected fault types and the kernels' errors, kernels.py,
    carry their class in the name), then message patterns: the JAX
    package's rules for the exceptions XLA wraps in RuntimeError, and the
    CUDA runtime's. A CUDA out-of-memory error and any ``CUDA error: ...``
    the runtime raises through PyTorch are ``device``."""
    if isinstance(exc, DeadlineExceeded):
        return CLASS_DEADLINE
    if isinstance(exc, NaNResultError):
        return CLASS_NAN
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return CLASS_DEVICE
    name = type(exc).__name__.lower()
    msg = str(exc).lower()
    if "encode" in name:
        return CLASS_ENCODE
    if "compil" in name or "compil" in msg or "lowering" in msg or "mosaic" in msg:
        return CLASS_COMPILE
    if (
        "device" in name
        or "xlaruntime" in name
        or any(tok in msg for tok in ("resource_exhausted", "device", "pjrt", "dma", "cuda error"))
    ):
        return CLASS_DEVICE
    return CLASS_UNKNOWN


def device_fault(exc: BaseException) -> bool:
    """True for an error of the port's own kernels or of the CUDA runtime
    under them, which the supervisor raises instead of failing over. An
    injected fault (testing/faults.py) is not one: the chaos suite's
    classes keep the JAX package's failover."""
    if isinstance(exc, faults.InjectedFault):
        return False
    if isinstance(exc, (KernelCompileError, KernelDeviceError, torch.cuda.OutOfMemoryError)):
        return True
    return isinstance(exc, RuntimeError) and "cuda error" in str(exc).lower()


class SupervisedSolver(SolverBackend):
    def __init__(
        self,
        primary: SolverBackend,
        fallback: Optional[SolverBackend] = None,
        deadline_s: Optional[float] = None,
        retries: Optional[int] = None,
        circuit_threshold: Optional[int] = None,
        circuit_cooldown_s: Optional[float] = None,
        validate: Optional[str] = None,
        backoff_base_s: Optional[float] = None,
        time_fn=time.monotonic,
        sleep_fn=time.sleep,
        streaming: Optional[bool] = None,
        tenant: Optional[str] = None,
    ):
        # ``tenant`` names the stream this supervisor serves under the
        # multi-tenant layer (serve/): it namespaces the quarantine ring and
        # journal, labels the circuit/rejection/warm metrics, and scopes
        # tenant-selected fault rules. None (the default) is byte-identical
        # to the pre-tenant behavior — no label, shared ring, global faults.
        self.tenant = tenant
        # KARPENTER_TPU_DELTA=1 (or streaming=True) wraps the primary in the
        # warm-state streaming layer: delta-diffed snapshots re-solve only the
        # churned frontier, with a cold solve above KARPENTER_TPU_DELTA_MAX_FRAC.
        # The fallback stays unwrapped: it is the reference answer the
        # streaming path degrades to.
        if streaming is None:
            streaming = os.environ.get("KARPENTER_TPU_DELTA", "") not in ("", "0")
        if streaming:
            from karpenter_tpu_torch.streaming.warm import StreamingSolver

            if not isinstance(primary, StreamingSolver):
                primary = StreamingSolver(primary, tenant=tenant)
            elif tenant is not None and primary.tenant is None:
                primary.set_tenant(tenant)
        self.primary = primary
        self.fallback = fallback
        self.deadline_s = (
            deadline_s
            if deadline_s is not None
            else _env_float("KARPENTER_TPU_SOLVE_DEADLINE_S", 0.0)
        )
        self.retries = (
            retries
            if retries is not None
            else int(_env_float("KARPENTER_TPU_SOLVE_RETRIES", 1))
        )
        self.circuit_threshold = (
            circuit_threshold
            if circuit_threshold is not None
            else int(_env_float("KARPENTER_TPU_CIRCUIT_THRESHOLD", 3))
        )
        self.circuit_cooldown_s = (
            circuit_cooldown_s
            if circuit_cooldown_s is not None
            else _env_float("KARPENTER_TPU_CIRCUIT_COOLDOWN_S", 30.0)
        )
        if validate is None:
            validate = os.environ.get("KARPENTER_TPU_VALIDATE", "1")
        self.validate_level = {"0": "off", "1": "fast", "2": "full"}.get(
            validate, validate
        )
        self.backoff_base_s = (
            backoff_base_s
            if backoff_base_s is not None
            else _env_float("KARPENTER_TPU_RETRY_BACKOFF_S", 0.05)
        )
        self.backoff_cap_s = 2.0
        self._time = time_fn
        self._sleep = sleep_fn
        self._lock = threading.Lock()
        self._circuit = CIRCUIT_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._solve_seq = 0
        # primary solves that passed their gate: what proves the device
        # healthy again after a fault (operator/operator.py)
        self.primary_solves = 0
        # previous cycle's trace id, threaded into the next cycle as
        # parent_trace_id: a churn stream greps as one lineage in
        # /debug/traces and in quarantine dumps
        self._last_trace_id: Optional[str] = None
        self.last_failure: Optional[Dict[str, str]] = None
        self.counters: Dict[str, int] = {
            "solve_retries": 0,
            "solve_fallbacks": 0,
            "validator_rejections": 0,
            "deadline_exceeded": 0,
            "salvaged": 0,
        }
        SOLVER_CIRCUIT_STATE.set(0, self._labels())

    def _labels(self, **labels) -> Optional[Dict[str, str]]:
        """Metric labels with the tenant folded in. Returns the exact
        pre-tenant shape (None for no labels) when untenanted, so existing
        series and their tests stay bit-identical. The tenant label value
        goes through tenant_label() — bounded at fleet scale (overflow
        tenants aggregate into 'other'); quarantine/journal namespaces keep
        the raw id."""
        if self.tenant is not None:
            labels["tenant"] = tenant_label(self.tenant)
        return labels or None

    # -- public introspection (serving.py /statusz) ---------------------------

    def circuit_state(self) -> str:
        with self._lock:
            # an elapsed cooldown shows as half-open: the next solve probes
            if (
                self._circuit == CIRCUIT_OPEN
                and self._time() - self._opened_at >= self.circuit_cooldown_s
            ):
                return CIRCUIT_HALF_OPEN
            return self._circuit

    def status(self) -> Dict:
        out = {
            "primary": type(self.primary).__name__,
            "fallback": type(self.fallback).__name__ if self.fallback else None,
            "tenant": self.tenant,
            "circuit": self.circuit_state(),
            "consecutive_failures": self._consecutive_failures,
            "deadline_s": self.deadline_s,
            "validate": self.validate_level,
            "counters": dict(self.counters),
            "last_failure": self.last_failure,
        }
        from karpenter_tpu_torch.obs import explain as obs_explain

        if obs_explain.enabled() or len(obs_explain.ring()):
            # decision provenance of recent solves (the result of a
            # supervised solve carries its own report unchanged)
            out["explain"] = obs_explain.summary()
        last_relax2 = getattr(self.primary, "last_relax2", None)
        if last_relax2 is not None:
            # the convex phase 1 of the last supervised solve
            # (KARPENTER_TPU_RELAX2): reason None when its result served,
            # else the classified standdown
            out["relax2"] = last_relax2
        return out

    # -- circuit transitions --------------------------------------------------

    def _set_circuit(self, state: str) -> None:
        self._circuit = state
        SOLVER_CIRCUIT_STATE.set(_CIRCUIT_GAUGE[state], self._labels())

    def _route(self) -> str:
        """Where this solve starts: 'primary' (closed, or half-open probe) or
        'fallback' (open and cooling down). With no fallback there is nothing
        to route to, so the primary is always tried."""
        if self.fallback is None:
            return "primary"
        with self._lock:
            if self._circuit == CIRCUIT_CLOSED:
                return "primary"
            if self._time() - self._opened_at >= self.circuit_cooldown_s:
                self._set_circuit(CIRCUIT_HALF_OPEN)
                return "primary"
            return "fallback"

    def _record_primary_success(self) -> None:
        with self._lock:
            self.primary_solves += 1
            self._consecutive_failures = 0
            if self._circuit != CIRCUIT_CLOSED:
                log.info("solver circuit closed: primary backend recovered")
            self._set_circuit(CIRCUIT_CLOSED)

    def _record_primary_failure(self) -> None:
        opened = False
        with self._lock:
            self._consecutive_failures += 1
            if self._circuit == CIRCUIT_HALF_OPEN:
                # failed probe: restart the cooldown
                self._opened_at = self._time()
                self._set_circuit(CIRCUIT_OPEN)
                opened = True
            elif (
                self._circuit == CIRCUIT_CLOSED
                and self._consecutive_failures >= self.circuit_threshold
            ):
                self._opened_at = self._time()
                self._set_circuit(CIRCUIT_OPEN)
                opened = True
                log.warning(
                    "solver circuit opened after %d consecutive failures",
                    self._consecutive_failures,
                )
        if opened and slo.enabled():
            # a tripped breaker is an incident: capture the ring now, while
            # the failures that opened it are still in it
            flight.record(
                flight.KIND_CIRCUIT, state=CIRCUIT_OPEN, tenant=self.tenant,
                failures=self._consecutive_failures,
            )
            flight.snapshot_dump("circuit-open")

    # -- the solve ------------------------------------------------------------

    def solve(
        self,
        pods,
        instance_types,
        templates,
        nodes=(),
        pod_requirements_override=None,
        topology=None,
        cluster_pods=(),
        domains=None,
        pod_volumes=None,
    ) -> SolveResult:
        kwargs = dict(
            nodes=nodes,
            pod_requirements_override=pod_requirements_override,
            topology=topology,
            cluster_pods=cluster_pods,
            domains=domains,
            pod_volumes=pod_volumes,
        )
        self._solve_seq += 1
        attrs = {"pods": len(pods)}
        if self._last_trace_id:
            attrs["parent_trace_id"] = self._last_trace_id
        with trace.cycle(
            "solve", backend=type(self.primary).__name__, **attrs
        ):
            result = None
            t0 = time.perf_counter()
            try:
                result = self._solve_supervised(
                    pods, instance_types, templates, kwargs
                )
                return result
            finally:
                trace_id = trace.current_trace_id()
                if trace_id is not None:
                    self._last_trace_id = trace_id
                if slo.enabled():
                    duration_s = time.perf_counter() - t0
                    scheduled = result.num_scheduled() if result is not None else 0
                    failed = (
                        len(result.failures) if result is not None else len(pods)
                    )
                    slo.on_solve_cycle(duration_s, scheduled, failed)
                    flight.record(
                        flight.KIND_SOLVE_CYCLE, tenant=self.tenant,
                        duration_s=round(duration_s, 6), pods=len(pods),
                        scheduled=scheduled, failed=failed,
                    )

    def _solve_supervised(self, pods, instance_types, templates, kwargs) -> SolveResult:
        route = self._route()
        failure_class = None
        if route == "primary":
            result, failure_class = self._solve_primary(
                pods, instance_types, templates, kwargs
            )
            if result is not None:
                return result
        # primary skipped (open circuit) or exhausted — fall back
        if self.fallback is not None:
            from_name = type(self.primary).__name__
            to_name = type(self.fallback).__name__
            SOLVER_FALLBACK.inc({"from": from_name, "to": to_name})
            self.counters["solve_fallbacks"] += 1
            flight.record(flight.KIND_SOLVE_FALLBACK, **{
                "from": from_name, "to": to_name,
                "class": failure_class or "circuit-open",
            })
            log.warning(
                "solve falling back %s -> %s (class=%s, trace=%s)",
                from_name, to_name, failure_class or "circuit-open",
                trace.current_trace_id(),
            )
            with trace.span(
                "fallback",
                **{"from": from_name, "to": to_name,
                   "class": failure_class or "circuit-open"},
            ):
                try:
                    result = self.fallback.solve(
                        pods, instance_types, templates, **kwargs
                    )
                except Exception:
                    log.exception("fallback backend failed; salvaging the cycle")
                    return self._salvage(pods, failure_class or "fallback-error")
                violations = self._validate(
                    result, pods, instance_types, templates, kwargs
                )
            if violations:
                # both backends disagree with the invariants: keep what
                # verified, requeue the rest
                self._quarantine(result, violations, backend=to_name)
                self._reset_streaming()
                return val.strip_violations(
                    result, violations, self._requeue_reason(CLASS_VALIDATION)
                )
            return result
        return self._salvage(pods, failure_class or "primary-error")

    def _solve_primary(self, pods, instance_types, templates, kwargs):
        """Returns (result, None) on success or (None, failure_class) once
        retries are exhausted."""
        attempts = 1 + max(0, self.retries)
        failure_class = None
        for attempt in range(attempts):
            try:
                result = self._attempt(pods, instance_types, templates, kwargs)
                # the device gate of a primary result runs inside the attempt:
                # an error of its kernel is a failed attempt like any other
                violations = self._validate(
                    result, pods, instance_types, templates, kwargs
                )
            except Exception as exc:
                failure_class = classify_failure(exc)
                self.last_failure = {
                    "class": failure_class,
                    "error": f"{type(exc).__name__}: {exc}",
                }
                trace_id = trace.current_trace_id()
                if trace_id:
                    self.last_failure["trace_id"] = trace_id
                if self._last_trace_id:
                    self.last_failure["parent_trace_id"] = self._last_trace_id
                if failure_class == CLASS_DEADLINE:
                    SOLVE_DEADLINE_EXCEEDED.inc()
                    self.counters["deadline_exceeded"] += 1
                if failure_class in RETRYABLE and attempt + 1 < attempts:
                    SOLVER_RETRIES.inc({"class": failure_class})
                    self.counters["solve_retries"] += 1
                    flight.record(flight.KIND_SOLVE_RETRY, **{
                        "class": failure_class, "attempt": attempt + 1,
                    })
                    with trace.span(
                        "retry", **{"class": failure_class, "attempt": attempt + 1}
                    ):
                        self._sleep(self._backoff(attempt))
                    continue
                if device_fault(exc):
                    # the kernel or the card failed: surface it, never hide
                    # it behind the host fallback or a salvaged cycle
                    raise
                log.warning(
                    "primary solve failed (class=%s, attempt %d/%d): %s",
                    failure_class, attempt + 1, attempts, exc,
                )
                self._record_primary_failure()
                return None, failure_class
            if violations:
                failure_class = CLASS_VALIDATION
                self.last_failure = {
                    "class": CLASS_VALIDATION,
                    "error": "; ".join(str(v) for v in violations[:4]),
                }
                trace_id = trace.current_trace_id()
                if trace_id:
                    self.last_failure["trace_id"] = trace_id
                if self._last_trace_id:
                    self.last_failure["parent_trace_id"] = self._last_trace_id
                self._reset_streaming()
                self._quarantine(
                    result, violations, backend=type(self.primary).__name__
                )
                self._record_primary_failure()
                if self.fallback is not None:
                    return None, failure_class
                # no fallback: keep the verified placements, requeue the rest
                self._record_salvage()
                return (
                    val.strip_violations(
                        result, violations, self._requeue_reason(CLASS_VALIDATION)
                    ),
                    None,
                )
            self._record_primary_success()
            return result, None
        return None, failure_class

    def _attempt(self, pods, instance_types, templates, kwargs) -> SolveResult:
        """One primary solve under the watchdog, with solve-site fault
        injection applied (only the primary is ever injected — the fallback
        must stay trustworthy for the chaos suite to mean anything). A
        tenanted supervisor runs the whole attempt inside its tenant's fault
        scope, so tenant-selected rules fire only for this stream (the
        watchdog worker inherits the scope through copy_context)."""
        import contextlib

        scope = (
            faults.tenant_scope(self.tenant)
            if self.tenant is not None
            else contextlib.nullcontext()
        )
        with scope:
            injector = faults.active()
            rule = injector.draw("solve") if injector is not None else None

            def call():
                if rule is not None:
                    if rule.kind == "hang":
                        time.sleep(rule.param or 30.0)
                    else:
                        faults.raise_solve_fault(rule)
                result = self.primary.solve(
                    pods, instance_types, templates, **kwargs
                )
                if rule is not None and rule.kind == "nan":
                    faults.corrupt_result(result)
                return result

            result = self._with_deadline(call)
        if val.has_nan(result):
            raise NaNResultError("NaN/inf in result request tensors")
        return result

    def _with_deadline(self, fn):
        if self.deadline_s <= 0:
            return fn()
        box: Dict[str, object] = {}
        done = threading.Event()
        # The worker inherits the caller's contextvars (copy_context) so the
        # active trace/span propagate into it and the backend's phase spans
        # land in the right tree.
        ctx = contextvars.copy_context()

        def run():
            try:
                box["result"] = ctx.run(fn)
            except BaseException as exc:  # propagate to the waiting thread
                box["error"] = exc
            finally:
                done.set()

        worker = threading.Thread(
            target=run, daemon=True, name="karpenter-tpu/solve-worker"
        )
        worker.start()
        if not done.wait(self.deadline_s):
            # the worker cannot be cancelled; abandon it (daemon) and move on
            raise DeadlineExceeded(f"solve exceeded {self.deadline_s:g}s deadline")
        if "error" in box:
            raise box["error"]  # type: ignore[misc]
        return box["result"]

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_base_s * (2.0 ** attempt), self.backoff_cap_s)
        # deterministic jitter in [0.5, 1.5): crc32, not the salted hash()
        frac = zlib.crc32(f"{self._solve_seq}:{attempt}".encode()) / 2**32
        return base * (0.5 + frac)

    # -- validation / quarantine / salvage ------------------------------------

    def _validate(
        self, result, pods, instance_types, templates, kwargs
    ) -> List[val.Violation]:
        violations = self._validate_inner(
            result, pods, instance_types, templates, kwargs
        )
        if slo.enabled() and self.validate_level != "off":
            # gate-integrity objective: every validated result is one event,
            # a rejection is budget burn (min_events=1 — one quarantine is
            # an incident, not noise)
            slo.on_gate(not violations)
            if violations:
                flight.record(
                    flight.KIND_VALIDATOR_REJECT, tenant=self.tenant,
                    count=len(violations),
                    invariants=sorted({v.invariant for v in violations[:8]}),
                )
        return violations

    def _validate_inner(
        self, result, pods, instance_types, templates, kwargs
    ) -> List[val.Violation]:
        if self.validate_level == "off":
            return []
        violations = self._device_gate(result, pods, instance_types, templates, kwargs)
        if violations is not None:
            for v in violations:
                VALIDATOR_REJECTIONS.inc(self._labels(invariant=v.invariant))
            if violations:
                self.counters["validator_rejections"] += 1
            return violations
        try:
            violations = val.validate_result(
                result,
                pods,
                instance_types,
                templates,
                nodes=kwargs["nodes"],
                pod_requirements_override=kwargs["pod_requirements_override"],
                cluster_pods=kwargs["cluster_pods"],
                domains=kwargs["domains"],
                level=self.validate_level,
            )
        except Exception:
            # the gate must never take down a healthy solve
            log.exception("validator crashed; passing result through")
            return []
        for v in violations:
            VALIDATOR_REJECTIONS.inc(self._labels(invariant=v.invariant))
        if violations:
            self.counters["validator_rejections"] += 1
        return violations

    def _device_gate(
        self, result, pods, instance_types, templates, kwargs
    ) -> Optional[List[val.Violation]]:
        """The device-side verification gate (verify/) before the host
        validator. Returns the canonical violation list when the gate owned
        the verdict, or None when it does not apply (no verify_ctx, or a
        context that does not describe this result) so the host path keeps
        the cycle. An error of the gate's kernel propagates: the caller
        counts it as a failed attempt of the primary and, once its retries
        are spent, raises it.

        When the gate engages, verification runs at FULL rigor regardless of
        validate_level: a device accept is sound against the full host gate
        (the device predicates are tolerance-tighter), and a device reject is
        host-confirmed at full level before anything is stripped — so the
        level knob only governs the fallback host path's cost.
        """
        from karpenter_tpu_torch import verify

        if getattr(result, "verify_ctx", None) is None:
            return None
        outcome = verify.full_gate(
            result,
            pods,
            instance_types,
            templates,
            nodes=kwargs["nodes"],
            pod_requirements_override=kwargs["pod_requirements_override"],
            cluster_pods=kwargs["cluster_pods"],
            domains=kwargs["domains"],
        )
        if outcome is None:
            return None
        return list(outcome.violations)

    def _reset_streaming(self) -> None:
        """A rejected result must never seed the next warm solve: drop the
        streaming layer's carried placement state (no-op for plain backends)."""
        reset = getattr(self.primary, "reset_streaming_state", None)
        if reset is not None:
            reset()

    def _quarantine(self, result, violations, backend: str) -> None:
        from karpenter_tpu_torch.solver.forensics import dump_quarantine

        path = dump_quarantine(
            result, violations, backend=backend,
            parent_trace_id=self._last_trace_id, tenant=self.tenant,
        )
        if slo.enabled():
            # cross-link the incident lineage: the flight ring names the
            # quarantine file, the dump that follows carries the ring
            flight.record(
                flight.KIND_QUARANTINE, backend=backend, tenant=self.tenant,
                path=path, violations=len(violations),
            )
            flight.snapshot_dump("validator-reject")
        log.error(
            "validator rejected %s result (%d violation(s), first: %s)%s",
            backend, len(violations), violations[0],
            f"; forensics at {path}" if path else "",
        )

    def _requeue_reason(self, failure_class: str) -> str:
        return (
            f"solver unavailable ({failure_class}); pod requeued for the "
            f"next provisioning cycle"
        )

    def _record_salvage(self) -> None:
        self.counters["salvaged"] += 1

    def _salvage(self, pods: Sequence, failure_class: str) -> SolveResult:
        """No backend could answer: complete the cycle anyway by requeueing
        every pod — FailedScheduling events fire and the next cycle retries,
        instead of the controllers seeing an exception and dropping the batch."""
        self._record_salvage()
        flight.record(flight.KIND_SOLVE_SALVAGE, **{
            "class": failure_class, "pods": len(pods),
        })
        with trace.span("salvage", **{"class": failure_class}):
            reason = self._requeue_reason(failure_class)
            return SolveResult(failures={i: reason for i in range(len(pods))})
