"""Multi-tenant solve service: N tenant streams over one solver process.

Counterpart of the JAX package's ``serve/`` (its one server entry point,
behind ``KARPENTER_TPU_SERVE=1``). Many independent clusters (tenants) share
one warmed-up solver process and one card; everything stateful is per
tenant:

  isolation   every tenant gets its OWN SupervisedSolver stack (circuit
              breaker, quarantine namespace, deadline budget, fault scope,
              and with ``KARPENTER_TPU_DELTA=1`` its warm streaming state
              and journal namespace: ``SupervisedSolver(tenant=...)``,
              ``faults.tenant_scope``). A
              fault in one tenant's stream trips that tenant's circuit and
              quarantines into that tenant's ring.
  fairness    a single dispatcher thread drains the per-tenant bounded
              queues by deficit-weighted round robin in pod-units, in two
              levels (tenant classes above tenants). A heavy tenant cannot
              starve a light one; an idle tenant cannot hoard credit.
  admission   every request the service cannot serve is CLASSIFIED, never
              silently dropped (serve_admission_total).
  batching    shape-compatible requests from different tenants stack into
              one ``batched_screen`` launch (serve/batch.py): the
              ``runs_screen`` kernel in its stacked mode, one block per
              tenant lane. Every stacked lane is validated at full level;
              a classified stand-down sends that lane to its tenant's own
              supervised solve.

The service and the default tenant stack run their ``TorchSolver`` on CUDA
unless given ``device="cpu"``. ``/debug/tenants`` and ``/statusz["serve"]``
(operator/serving.py) read a wired service's snapshot, or the process-wide
one (``current_service``). ``ReplicaSet`` (serve/replica.py) runs N services
over carved device slices with classified sticky tenant placement. The
port's Operator wires no service, as the JAX package's does not.

Knobs (all read at construction; the JAX package's names and defaults):

  KARPENTER_TPU_SERVE                  enable the serve layer (operator wiring)
  KARPENTER_TPU_SERVE_MAX_TENANTS      tenant capacity bound (16)
  KARPENTER_TPU_SERVE_QUEUE_DEPTH      per-tenant queue bound (8)
  KARPENTER_TPU_SERVE_QUANTUM          DWRR pod-units earned per sweep (64)
  KARPENTER_TPU_SERVE_WEIGHTS          per-tenant weights, "a=4,b=1"
  KARPENTER_TPU_SERVE_CLASSES          tenant-class weights, "gold=4,bronze=1"
                                       (unset = one implicit "default" class:
                                       the flat DWRR path)
  KARPENTER_TPU_SERVE_ADMIT_DEADLINE_S predicted-wait shed bound (0 = off)
  KARPENTER_TPU_SERVE_BATCH            cross-tenant stacking (1)
  KARPENTER_TPU_SERVE_BATCH_LANES      max lanes per stacked dispatch (8)
  KARPENTER_TPU_SERVE_EWMA_HALF_LIFE_S wait-estimate decay half-life (5)
  KARPENTER_TPU_SERVE_EWMA_FLOOR       wait-estimate staleness floor (0.25)
  KARPENTER_TPU_SERVE_REPLICAS         ReplicaSet replicas (1)
  KARPENTER_TPU_SERVE_BIG_PODS         big-tenant placement threshold (1024)
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def enabled() -> bool:
    """The operator wires a SolveService only when this is set; the flag-off
    process never constructs the layer (zero overhead, identical programs)."""
    return os.environ.get("KARPENTER_TPU_SERVE", "") not in ("", "0")


def max_tenants() -> int:
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_SERVE_MAX_TENANTS", "16")))
    except ValueError:
        return 16


def queue_depth() -> int:
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_SERVE_QUEUE_DEPTH", "8")))
    except ValueError:
        return 8


def quantum() -> float:
    try:
        return max(1.0, float(os.environ.get("KARPENTER_TPU_SERVE_QUANTUM", "64")))
    except ValueError:
        return 64.0


def admit_deadline_s() -> float:
    try:
        return float(os.environ.get("KARPENTER_TPU_SERVE_ADMIT_DEADLINE_S", "0"))
    except ValueError:
        return 0.0


def batching_enabled() -> bool:
    return os.environ.get("KARPENTER_TPU_SERVE_BATCH", "1") not in ("", "0")


def batch_lanes() -> int:
    """Max lanes per stacked dispatch: wider stops amortizing and starts
    inflating the padded batch (one lane's latency holds every lane hostage)."""
    try:
        return max(2, int(os.environ.get("KARPENTER_TPU_SERVE_BATCH_LANES", "8")))
    except ValueError:
        return 8


def replicas() -> int:
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_SERVE_REPLICAS", "1")))
    except ValueError:
        return 1


def big_tenant_pods() -> int:
    """Expected-pods threshold above which a tenant is placed on the replica
    owning the largest device slice."""
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_SERVE_BIG_PODS", "1024")))
    except ValueError:
        return 1024


def ewma_half_life_s() -> float:
    try:
        return max(
            1e-3,
            float(os.environ.get("KARPENTER_TPU_SERVE_EWMA_HALF_LIFE_S", "5")),
        )
    except ValueError:
        return 5.0


def ewma_floor() -> float:
    try:
        return min(1.0, max(
            0.0, float(os.environ.get("KARPENTER_TPU_SERVE_EWMA_FLOOR", "0.25"))
        ))
    except ValueError:
        return 0.25


def parse_weights(spec: Optional[str] = None) -> Dict[str, float]:
    """``KARPENTER_TPU_SERVE_WEIGHTS="a=4,b=1"`` -> {"a": 4.0, "b": 1.0}.
    Malformed entries are skipped (an operator typo must not take down the
    service); unlisted tenants default to weight 1."""
    if spec is None:
        spec = os.environ.get("KARPENTER_TPU_SERVE_WEIGHTS", "")
    out: Dict[str, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry or "=" not in entry:
            continue
        name, _, raw = entry.partition("=")
        try:
            weight = float(raw)
        except ValueError:
            continue
        if name.strip() and weight > 0:
            out[name.strip()] = weight
    return out


def parse_classes(spec: Optional[str] = None) -> Dict[str, float]:
    """``KARPENTER_TPU_SERVE_CLASSES="gold=4,bronze=1"`` -> class weights.
    Same grammar and tolerance as parse_weights. Empty/unset means ONE
    implicit ``default`` class — the dispatcher then skips class-level
    accounting entirely and the 16-tenant flat DWRR path is bit-identical."""
    if spec is None:
        spec = os.environ.get("KARPENTER_TPU_SERVE_CLASSES", "")
    return parse_weights(spec)


DEFAULT_CLASS = "default"


# The live service this process is running, if any. Plain module global,
# set/cleared by SolveService.start()/close() (one serve layer per process is
# the model, matching the one-process-one-device assumption everywhere else).
_current = None


def current_service():
    return _current


def _set_current(service) -> None:
    global _current
    _current = service


from karpenter_tpu_torch.serve.dispatcher import (  # noqa: E402  (re-export)
    ServeOutcome,
    SolveService,
    Ticket,
)
from karpenter_tpu_torch.serve.tenant import TenantState, build_tenant_solver  # noqa: E402

__all__ = [
    "DEFAULT_CLASS",
    "ServeOutcome",
    "SolveService",
    "TenantState",
    "Ticket",
    "admit_deadline_s",
    "batch_lanes",
    "batching_enabled",
    "build_tenant_solver",
    "current_service",
    "enabled",
    "ewma_floor",
    "ewma_half_life_s",
    "max_tenants",
    "parse_classes",
    "parse_weights",
    "quantum",
    "queue_depth",
]
