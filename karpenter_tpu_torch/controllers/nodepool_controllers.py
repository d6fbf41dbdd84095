"""NodePool hash stamping, resource counting, and lease GC.

Equivalents of reference pkg/controllers/nodepool/hash (the static-drift
input, hash/controller.go:51-61), nodepool/counter (limits-enforcement input,
counter/controller.go:61-96), and pkg/controllers/leasegarbagecollection
(controller.go:53-64).
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import Lease, Node
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.utils import resources as res


class NodePoolHashController:
    """Stamps karpenter.tpu/nodepool-hash on every NodePool and its claims;
    the drift marker compares against it."""

    def __init__(self, kube: KubeClient):
        self.kube = kube

    def reconcile_all(self) -> None:
        for np_obj in self.kube.list(NodePool):
            self.reconcile(np_obj)

    def reconcile(self, np_obj: NodePool) -> None:
        digest = np_obj.hash()
        if np_obj.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY) != digest:
            self.kube.patch(
                np_obj,
                lambda n: n.metadata.annotations.__setitem__(
                    wk.NODEPOOL_HASH_ANNOTATION_KEY, digest
                ),
            )
        for claim in self.kube.list(
            NodeClaim,
            predicate=lambda c: c.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
            == np_obj.name,
        ):
            # only claims that never had the annotation get it backfilled; an
            # existing different value IS the static-drift signal and must
            # not be overwritten (hash/controller.go:51-61)
            if wk.NODEPOOL_HASH_ANNOTATION_KEY not in claim.metadata.annotations:
                self.kube.patch(
                    claim,
                    lambda c: c.metadata.annotations.__setitem__(
                        wk.NODEPOOL_HASH_ANNOTATION_KEY, digest
                    ),
                )


class NodePoolCounterController:
    """Aggregates in-cluster capacity into NodePool.status.resources — what
    Limits.ExceededBy is checked against (counter/controller.go:61-96)."""

    def __init__(self, kube: KubeClient):
        self.kube = kube

    def reconcile_all(self) -> None:
        for np_obj in self.kube.list(NodePool):
            self.reconcile(np_obj)

    def reconcile(self, np_obj: NodePool) -> None:
        totals = {}
        counted_ids = set()
        # count claims (they exist before nodes and carry the launch shape)
        for claim in self.kube.list(
            NodeClaim,
            predicate=lambda c: c.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
            == np_obj.name and c.metadata.deletion_timestamp is None,
        ):
            totals = res.merge(totals, claim.status.capacity)
            if claim.status.provider_id:
                counted_ids.add(claim.status.provider_id)
        # plus nodes in the pool not represented by a claim
        for node in self.kube.list(
            Node,
            predicate=lambda n: n.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
            == np_obj.name and n.metadata.deletion_timestamp is None,
        ):
            if node.spec.provider_id in counted_ids:
                continue
            totals = res.merge(totals, node.status.capacity)
        if dict(np_obj.status.resources) != dict(totals):
            self.kube.patch(
                np_obj, lambda n: setattr(n.status, "resources", dict(totals))
            )


class LeaseGarbageCollectionController:
    """Deletes kube-node-lease Leases whose owner Node is gone
    (leasegarbagecollection/controller.go:53-64)."""

    def __init__(self, kube: KubeClient):
        self.kube = kube

    def reconcile_all(self) -> int:
        collected = 0
        for lease in self.kube.list(Lease, namespace="kube-node-lease"):
            owner = lease.holder_identity or lease.metadata.name
            if self.kube.get_opt(Node, owner, "") is None:
                self.kube.delete_opt(
                    Lease, lease.metadata.name, lease.metadata.namespace
                )
                collected += 1
        return collected
