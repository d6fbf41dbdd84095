"""NodeClaim termination finalizer.

Equivalent of reference pkg/controllers/nodeclaim/termination/controller.go:
on NodeClaim delete → delete its Node objects → CloudProvider.Delete →
remove the finalizer (controller.go:66-100). The Node deletes cascade into
the node termination controller's drain path.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.objects import Node
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, NodeClaimNotFoundError
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY

CLAIMS_TERMINATED = REGISTRY.counter(
    "terminated_total", "NodeClaims fully terminated",
    subsystem="nodeclaims",
)


class TerminationController:
    def __init__(self, kube: KubeClient, cloud_provider: CloudProvider):
        self.kube = kube
        self.cloud_provider = cloud_provider

    def reconcile_all(self) -> None:
        for claim in self.kube.list(NodeClaim):
            if claim.metadata.deletion_timestamp is not None:
                self.reconcile(claim)

    def reconcile(self, claim: NodeClaim) -> None:
        claim = self.kube.get_opt(NodeClaim, claim.metadata.name, "")
        if claim is None or claim.metadata.deletion_timestamp is None:
            return
        if wk.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            return
        # cascade into the node termination path first
        nodes = self.kube.list(
            Node, predicate=lambda n: n.spec.provider_id == claim.status.provider_id
            and claim.status.provider_id != ""
        )
        for node in nodes:
            self.kube.delete_opt(Node, node.metadata.name, "")
        if any(
            self.kube.get_opt(Node, n.metadata.name, "") is not None for n in nodes
        ):
            # nodes still draining; retry next pass (controller.go:80-86)
            return
        try:
            self.cloud_provider.delete(claim)
        except NodeClaimNotFoundError:
            pass  # instance already gone
        self.kube.patch(
            claim,
            lambda c: c.metadata.finalizers.__setitem__(
                slice(None),
                [f for f in c.metadata.finalizers if f != wk.TERMINATION_FINALIZER],
            ),
        )
        CLAIMS_TERMINATED.inc()
