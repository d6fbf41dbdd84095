"""CSI volume-attachment tracking.

Equivalent of reference pkg/scheduling/volumeusage.go: resolves a pod's
volumes to (CSI driver, unique volume id) pairs and tracks per-node usage
against CSINode attach limits (volumeusage.go:82,202,211).

Solver-level note: the tensorized existing-node gate counts volumes per pod
rather than deduplicating shared PVCs across pods on a node — a conservative
approximation (it can only refuse placements the set-based reference would
allow when pods share a PVC). The host-side VolumeUsage here keeps the exact
set semantics for cluster-state accounting.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Set

from karpenter_tpu_torch.apis.objects import CSINode, PersistentVolume, PersistentVolumeClaim, Pod
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.scheduling.storageclass import resolve_storage_class

# Lane for volumes whose PVC/StorageClass can't be resolved. No CSINode ever
# publishes a limit for it, so these volumes never gate a placement — the same
# skip-on-unresolvable behavior the reference takes; the pod will be bound by
# its real driver's limit once the PVC resolves and the next pass runs.
UNKNOWN_DRIVER = "unknown"

# CSI migration (the reference goes through k8s csi-translation-lib,
# scheduling/volumeusage.go:96-118): volumes provisioned by an in-tree
# plugin count against the MIGRATED CSI driver's attach limits, whether the
# plugin name arrives via a StorageClass provisioner or a PV's in-tree
# volume source.
IN_TREE_DRIVER_MIGRATIONS = {
    "kubernetes.io/aws-ebs": "ebs.csi.aws.com",
    "kubernetes.io/gce-pd": "pd.csi.storage.gke.io",
    "kubernetes.io/azure-disk": "disk.csi.azure.com",
    "kubernetes.io/azure-file": "file.csi.azure.com",
    "kubernetes.io/cinder": "cinder.csi.openstack.org",
    "kubernetes.io/vsphere-volume": "csi.vsphere.vmware.com",
}


def migrate_in_tree_driver(name: str) -> str:
    """Translate an in-tree plugin/provisioner name to its CSI driver;
    unknown names pass through unchanged."""
    return IN_TREE_DRIVER_MIGRATIONS.get(name, name)


VolumeSet = Dict[str, FrozenSet[str]]  # driver -> unique volume ids


class VolumeResolver:
    """Caches PVC/PV/StorageClass lookups for one scheduling pass — the
    resolution chain is pure reads, and re-deep-copying them per pod per node
    would dominate a large pass."""

    def __init__(self, kube: KubeClient):
        self.kube = kube
        self._pvc: Dict[str, Optional[PersistentVolumeClaim]] = {}
        self._pv: Dict[str, Optional[PersistentVolume]] = {}
        self._sc_driver: Dict[Optional[str], str] = {}
        self._pod: Dict[str, VolumeSet] = {}

    def pod_volumes(self, pod: Pod) -> VolumeSet:
        """Resolve every PVC/ephemeral volume on the pod to its CSI driver
        (volumeusage.go:82-160)."""
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        cached = self._pod.get(key)
        if cached is not None:
            return cached
        out: Dict[str, Set[str]] = {}
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is not None:
                claim_name = volume.persistent_volume_claim.claim_name
                vol_id = f"{pod.metadata.namespace}/{claim_name}"
                driver = self._driver_for_pvc(pod.metadata.namespace, claim_name)
            elif volume.ephemeral is not None:
                # generic ephemeral volumes materialize as <pod>-<volume> PVCs
                vol_id = f"{pod.metadata.namespace}/{pod.metadata.name}-{volume.name}"
                driver = self._sc(volume.ephemeral.storage_class_name)
            else:
                continue
            out.setdefault(driver, set()).add(vol_id)
        result = {d: frozenset(v) for d, v in out.items()}
        self._pod[key] = result
        return result

    def _driver_for_pvc(self, namespace: str, claim_name: str) -> str:
        key = f"{namespace}/{claim_name}"
        if key not in self._pvc:
            self._pvc[key] = self.kube.get_opt(
                PersistentVolumeClaim, claim_name, namespace
            )
        pvc = self._pvc[key]
        if pvc is None:
            return UNKNOWN_DRIVER
        if pvc.volume_name:
            if pvc.volume_name not in self._pv:
                self._pv[pvc.volume_name] = self.kube.get_opt(
                    PersistentVolume, pvc.volume_name, ""
                )
            pv = self._pv[pvc.volume_name]
            if pv is not None and pv.csi_driver:
                return pv.csi_driver
            if pv is not None and pv.in_tree_plugin:
                return migrate_in_tree_driver(pv.in_tree_plugin)
        return self._sc(pvc.storage_class_name)

    def _sc(self, name: Optional[str]) -> str:
        if name not in self._sc_driver:
            sc = resolve_storage_class(self.kube, name)
            self._sc_driver[name] = (
                migrate_in_tree_driver(sc.provisioner)
                if sc is not None
                else UNKNOWN_DRIVER
            )
        return self._sc_driver[name]


def get_pod_volumes(kube: KubeClient, pod: Pod) -> VolumeSet:
    """One-shot resolution (tests, webhooks); hot paths share a VolumeResolver."""
    return VolumeResolver(kube).pod_volumes(pod)


def node_volume_limits(kube: KubeClient, node_name: str) -> Dict[str, int]:
    csinode = kube.get_opt(CSINode, node_name, "")
    return dict(csinode.driver_limits) if csinode is not None else {}


class VolumeUsage:
    """Per-node attach tracking with exact unique-volume (set) semantics."""

    def __init__(self):
        self._volumes: Dict[str, Set[str]] = {}  # driver -> ids

    def add(self, volumes: VolumeSet) -> None:
        for driver, ids in volumes.items():
            self._volumes.setdefault(driver, set()).update(ids)

    def counts(self) -> Dict[str, int]:
        return {d: len(v) for d, v in self._volumes.items()}

    def exceeds_limits(self, volumes: VolumeSet, limits: Dict[str, int]) -> Optional[str]:
        """The driver that would overflow, if any (volumeusage.go:202)."""
        for driver, ids in volumes.items():
            limit = limits.get(driver)
            if limit is None:
                continue
            combined = self._volumes.get(driver, set()) | set(ids)
            if len(combined) > limit:
                return f"{driver}: {len(combined)} > limit {limit}"
        return None

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage()
        out._volumes = {d: set(v) for d, v in self._volumes.items()}
        return out
