"""Prometheus-style metrics of the ported layers (registry.py)."""

from karpenter_tpu_torch.metrics.registry import (  # noqa: F401
    DURATION_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    Store,
    measure,
    tenant_label,
)
