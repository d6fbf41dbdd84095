"""Per-tenant state: the isolated solver stack and its stream accounting.

Counterpart of the JAX package's ``serve/tenant.py``.

One ``TenantState`` per registered stream. Everything that can fail, carry
state, or be quarantined is tenant-private (the solver stack); everything
shared (the loaded kernels, the device, the dispatcher thread) is
stateless with respect to tenants — that split is the isolation contract
the chaos suite verifies.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional

from karpenter_tpu_torch.solver.backend import SolverBackend

# enough samples for a stable p99 over a churn stream's recent window
# without unbounded growth in a long-lived process
_LATENCY_WINDOW = 512


def build_tenant_solver(
    tenant_id: str,
    primary: Optional[SolverBackend] = None,
    fallback: Optional[SolverBackend] = None,
    device=None,
    **supervisor_kwargs,
) -> SolverBackend:
    """The default per-tenant stack: a SupervisedSolver owning this tenant's
    circuit breaker, quarantine namespace and fault scope. ``primary``
    defaults to a fresh ``TorchSolver`` on ``device`` (CUDA unless
    ``device="cpu"``); per-tenant instances share the process's loaded
    kernels, so N tenants pay each kernel's build once, not N times."""
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver

    if primary is None:
        from karpenter_tpu_torch.solver.torch_backend import TorchSolver

        primary = TorchSolver(device=device)
    return SupervisedSolver(
        primary, fallback=fallback, tenant=tenant_id, **supervisor_kwargs
    )


class TenantState:
    """One tenant stream: its solver stack, bounded queue, DWRR balance, and
    counters. The queue and counters are guarded by the service lock (the
    dispatcher and submitters share it); the solver is touched only by the
    dispatcher thread."""

    def __init__(
        self,
        tenant_id: str,
        solver: SolverBackend,
        weight: float = 1.0,
        deadline_s: float = 0.0,
        queue_depth: int = 8,
        cls: str = "default",
    ):
        self.id = tenant_id
        self.solver = solver
        self.weight = max(0.001, float(weight))
        # default wall-clock budget a request inherits when submitted
        # without an explicit deadline; 0 = no budget
        self.deadline_s = float(deadline_s)
        self.queue_depth = int(queue_depth)
        self.cls = cls
        self.queue: Deque = deque()
        self.deficit = 0.0
        # ready == this stream sits in its class's ready-ring (nonempty
        # queue). Idle streams are NOT swept by the dispatcher at all — that
        # is the O(active) contract at 1k registered tenants.
        self.ready = False
        self.counters: Dict[str, int] = {
            "submitted": 0,
            "completed": 0,
            "shed": 0,
            "errors": 0,
            "batched": 0,
        }
        self._latencies: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._lat_lock = threading.Lock()

    def record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._latencies.append(seconds)

    def latency_quantile(self, q: float) -> float:
        """Windowed latency quantile (q in [0, 1]); 0.0 before any sample."""
        with self._lat_lock:
            samples = sorted(self._latencies)
        if not samples:
            return 0.0
        idx = min(len(samples) - 1, max(0, int(q * len(samples))))
        return samples[idx]

    def circuit_state(self) -> Optional[str]:
        fn = getattr(self.solver, "circuit_state", None)
        return fn() if fn is not None else None

    def snapshot(self) -> Dict:
        """The tenant's row of the service snapshot: queue pressure, fairness balance, outcome
        counters, latency quantiles, and the solver's own health."""
        out = {
            "tenant": self.id,
            "class": self.cls,
            "weight": self.weight,
            "deadline_s": self.deadline_s,
            "queued": len(self.queue),
            "queue_depth": self.queue_depth,
            "deficit": round(self.deficit, 3),
            "counters": dict(self.counters),
            "latency_p50_s": round(self.latency_quantile(0.50), 6),
            "latency_p99_s": round(self.latency_quantile(0.99), 6),
        }
        circuit = self.circuit_state()
        if circuit is not None:
            out["circuit"] = circuit
        status = getattr(self.solver, "status", None)
        if status is not None:
            try:
                out["last_failure"] = status().get("last_failure")
            except Exception:  # noqa: BLE001 — introspection must not break the page
                pass
        return out
