"""Metrics decorator around any CloudProvider.

Equivalent of reference pkg/cloudprovider/metrics/cloudprovider.go: wraps each
SPI method with a duration histogram and error counter.
"""

from __future__ import annotations

from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.metrics import REGISTRY, measure

_method_duration = REGISTRY.histogram(
    "cloudprovider_duration_seconds",
    "Duration of cloud provider method calls.",
)
_method_errors = REGISTRY.counter(
    "cloudprovider_errors_total",
    "Total cloud provider method errors.",
)


class MetricsCloudProvider(CloudProvider):
    """Decorator pattern: every call is timed and errors counted, labeled by
    method and provider name."""

    def __init__(self, inner: CloudProvider):
        self._inner = inner

    def _call(self, method: str, fn, *args):
        labels = {"method": method, "provider": self._inner.name()}
        try:
            with measure(_method_duration, labels):
                return fn(*args)
        except Exception:
            _method_errors.inc(labels)
            raise

    def create(self, node_claim):
        return self._call("Create", self._inner.create, node_claim)

    def delete(self, node_claim):
        return self._call("Delete", self._inner.delete, node_claim)

    def get(self, provider_id):
        return self._call("Get", self._inner.get, provider_id)

    def list(self):
        return self._call("List", self._inner.list)

    def get_instance_types(self, nodepool):
        return self._call("GetInstanceTypes", self._inner.get_instance_types, nodepool)

    def is_drifted(self, node_claim):
        return self._call("IsDrifted", self._inner.is_drifted, node_claim)

    def name(self):
        return self._inner.name()
