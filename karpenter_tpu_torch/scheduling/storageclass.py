"""Default StorageClass discovery (reference pkg/scheduling/storageclass.go:41):
an unbound PVC without an explicit class uses the cluster default."""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis.objects import StorageClass
from karpenter_tpu_torch.kube.client import KubeClient


def default_storage_class(kube: KubeClient) -> Optional[StorageClass]:
    defaults = [sc for sc in kube.list(StorageClass) if sc.is_default]
    # newest default wins, matching the apiserver's admission behavior
    defaults.sort(key=lambda sc: sc.metadata.creation_timestamp or 0.0, reverse=True)
    return defaults[0] if defaults else None


def resolve_storage_class(kube: KubeClient, name: Optional[str]) -> Optional[StorageClass]:
    if name:
        return kube.get_opt(StorageClass, name, "")
    return default_storage_class(kube)
