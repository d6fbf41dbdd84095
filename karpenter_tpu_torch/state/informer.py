"""Informers — watch-stream pumps from the kube store into the Cluster cache.

Equivalent of reference pkg/controllers/state/informer/{node,pod,nodeclaim,
nodepool,daemonset}.go: five thin controllers whose only job is to translate
ADDED/MODIFIED/DELETED watch events into Cluster updates. With the in-memory
kube client the watch delivery is synchronous, so the cache is consistent the
moment a write returns — `Cluster.synced()` still guards the crash-recovery
path where a Cluster is attached to a pre-populated store.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import DaemonSet, Node, Pod
from karpenter_tpu_torch.kube.client import DELETED, KubeClient
from karpenter_tpu_torch.state.cluster import Cluster


def start_informers(kube: KubeClient, cluster: Cluster) -> None:
    """Register all five informers, replaying current store contents
    (LIST+WATCH)."""

    def on_node(event: str, obj: Node):
        if event == DELETED:
            cluster.delete_node(obj.metadata.name)
        else:
            cluster.update_node(obj)

    def on_nodeclaim(event: str, obj: NodeClaim):
        if event == DELETED:
            cluster.delete_node_claim(obj.metadata.name)
        else:
            cluster.update_node_claim(obj)

    def on_pod(event: str, obj: Pod):
        if event == DELETED:
            cluster.delete_pod(f"{obj.metadata.namespace}/{obj.metadata.name}")
        else:
            cluster.update_pod(obj)

    def on_daemonset(event: str, obj: DaemonSet):
        if event == DELETED:
            cluster.delete_daemonset(f"{obj.metadata.namespace}/{obj.metadata.name}")
        else:
            cluster.update_daemonset(obj)

    def on_nodepool(event: str, obj: NodePool):
        # any NodePool change invalidates consolidation decisions
        # (informer/nodepool.go)
        cluster.mark_unconsolidated()

    kube.watch(Node, on_node)
    kube.watch(NodeClaim, on_nodeclaim)
    kube.watch(Pod, on_pod)
    kube.watch(DaemonSet, on_daemonset)
    kube.watch(NodePool, on_nodepool)
