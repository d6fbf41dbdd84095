"""Volume topology injection.

Equivalent of reference pkg/controllers/provisioning/scheduling/
volumetopology.go:41-76: before a pod reaches the solver, any zone (or other
topology) constraints implied by its volumes — a bound PV's node affinity, or
an unbound PVC's StorageClass allowedTopologies — are injected as required
node-affinity terms so the pack lands the pod where its storage can attach.
"""

from __future__ import annotations

from typing import List

from karpenter_tpu_torch.apis.objects import (
    Affinity,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
)
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.scheduling.storageclass import resolve_storage_class


class VolumeTopology:
    def __init__(self, kube: KubeClient):
        self.kube = kube

    def inject(self, pod: Pod) -> Pod:
        """Mutates (and returns) the pod with volume-implied requirements
        (volumetopology.go:41-76)."""
        requirements: List[NodeSelectorRequirement] = []
        for volume in pod.spec.volumes:
            requirements.extend(self._volume_requirements(pod, volume))
        if not requirements:
            return pod
        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        na = pod.spec.affinity.node_affinity
        if na.required:
            # AND the volume requirements into every OR term (:60-70)
            for term in na.required:
                term.match_expressions.extend(requirements)
        else:
            na.required = [NodeSelectorTerm(match_expressions=list(requirements))]
        return pod

    def validate_persistent_volume_claims(self, pod: Pod) -> None:
        """A pod whose storage can never bind must not reach the solver
        (volumetopology.go:144-183): every PVC volume needs an existing PVC;
        a bound PVC's PV must exist; an unbound PVC must name an existing
        StorageClass. Raises ValueError with the failing object named."""
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is None:
                # an ephemeral volume's PVC is generated at admission (the
                # reference validates that generated claim, volume.go:28-44);
                # this store has no ephemeral controller, so validate the one
                # thing the spec itself pins: a NAMED storage class must exist
                if volume.ephemeral is not None:
                    sc_name = volume.ephemeral.storage_class_name
                    if sc_name == "":
                        # same rule as an unbound classless PVC below: dynamic
                        # provisioning is off and nothing pre-binds ephemeral
                        # claims, so this can never provision
                        raise ValueError(
                            f"ephemeral volume {volume.name!r} must define "
                            f"a storage class"
                        )
                    # None means "the default class" (same adaptation as the
                    # PVC branch below): it must resolve, else the generated
                    # claim can never provision
                    if resolve_storage_class(self.kube, sc_name) is None:
                        raise ValueError(
                            f"ephemeral volume {volume.name!r} needs storage "
                            f"class {sc_name!r}"
                            if sc_name
                            else f"ephemeral volume {volume.name!r} needs a "
                                 f"default storage class"
                        )
                # hostPath/emptyDir etc. have no storage to validate
                continue
            name = volume.persistent_volume_claim.claim_name
            pvc = self.kube.get_opt(
                PersistentVolumeClaim, name, pod.metadata.namespace
            )
            if pvc is None:
                raise ValueError(f"pvc {name!r} not found")
            if pvc.volume_name:
                if self.kube.get_opt(PersistentVolume, pvc.volume_name, "") is None:
                    raise ValueError(
                        f"pvc {name!r} bound to missing volume {pvc.volume_name!r}"
                    )
                continue
            if pvc.storage_class_name == "":
                # explicitly classless and unbound: can never bind. A None
                # (nil) class means "use the default" — real clusters stamp
                # the default via admission defaulting before the provisioner
                # ever sees the PVC; this store has no defaulting webhook, so
                # the default resolves here instead.
                raise ValueError(f"unbound pvc {name!r} must define a storage class")
            if resolve_storage_class(self.kube, pvc.storage_class_name) is None:
                raise ValueError(
                    f"pvc {name!r} names missing storage class "
                    f"{pvc.storage_class_name!r}"
                )

    def _volume_requirements(self, pod: Pod, volume) -> List[NodeSelectorRequirement]:
        if volume.persistent_volume_claim is not None:
            pvc = self.kube.get_opt(
                PersistentVolumeClaim,
                volume.persistent_volume_claim.claim_name,
                pod.metadata.namespace,
            )
            if pvc is None:
                return []
            if pvc.volume_name:
                pv = self.kube.get_opt(PersistentVolume, pvc.volume_name, "")
                if pv is not None and pv.node_affinity_required:
                    # a bound PV pins the pod to its topology; NodeSelectorTerms
                    # are ORed, so only the first term is used — flattening all
                    # terms would AND mutually-exclusive zones together and
                    # make the pod unschedulable (volumetopology.go:134-137)
                    return list(pv.node_affinity_required[0].match_expressions)
                return []
            sc = resolve_storage_class(self.kube, pvc.storage_class_name)
        elif volume.ephemeral is not None:
            sc = resolve_storage_class(self.kube, volume.ephemeral.storage_class_name)
        else:
            return []
        if sc is None or not sc.allowed_topologies:
            return []
        # allowedTopologies terms are ORed like NodeSelectorTerms: first only
        # (volumetopology.go:146-153)
        return list(sc.allowed_topologies[0].match_expressions)
