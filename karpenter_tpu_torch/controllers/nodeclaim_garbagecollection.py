"""NodeClaim garbage collection.

Equivalent of reference pkg/controllers/nodeclaim/garbagecollection/
controller.go:57-99: every 2 minutes, delete NodeClaims that launched more
than 10 seconds ago whose instance has vanished from CloudProvider.List —
the cloud side died (or was manually terminated) and nothing else will
notice.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.nodeclaim import LAUNCHED, NodeClaim
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.utils.clock import Clock

POLL_PERIOD_SECONDS = 120.0
LAUNCH_GRACE_SECONDS = 10.0


class GarbageCollectionController:
    def __init__(
        self, kube: KubeClient, cloud_provider: CloudProvider, clock: Clock,
        recorder: Recorder,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder

    def reconcile(self) -> int:
        """Returns the number of claims collected."""
        live_ids = {c.status.provider_id for c in self.cloud_provider.list()}
        collected = 0
        for claim in self.kube.list(NodeClaim):
            if claim.metadata.deletion_timestamp is not None:
                continue
            cond = claim.status.conditions.get(LAUNCHED)
            if cond is None or cond.status != "True":
                continue
            if self.clock.now() - cond.last_transition_time < LAUNCH_GRACE_SECONDS:
                continue
            if claim.status.provider_id and claim.status.provider_id not in live_ids:
                self.recorder.publish(
                    object_event(
                        claim, "Warning", "GarbageCollected",
                        "cloud instance no longer exists",
                    )
                )
                self.kube.delete_opt(NodeClaim, claim.metadata.name, "")
                collected += 1
        return collected
