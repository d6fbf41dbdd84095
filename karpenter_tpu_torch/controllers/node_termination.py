"""Node termination — taint, drain, delete.

Equivalent of reference pkg/controllers/node/termination/: the Node finalizer
path (termination/controller.go:76-108) —

  1. taint the node so nothing new lands (terminator.go:50-77)
  2. drain: evict pods in order — non-critical non-daemon first, then
     non-critical daemon, then critical non-daemon, then critical daemon
     (terminator.go:112-147); static pods and already-terminating pods are
     skipped; PodDisruptionBudgets are honored the way the Evict API's 429
     responses are (terminator/eviction.go:101-149)
  3. once drained: CloudProvider.Delete and remove the finalizer
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim, NodeClaimStatus
from karpenter_tpu_torch.apis.objects import Node, ObjectMeta, Pod
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, NodeClaimNotFoundError
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.state.statenode import disruption_taint
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock

SYSTEM_CRITICAL_PRIORITY = 2_000_000_000

TERMINATION_DURATION = REGISTRY.histogram(
    "termination_duration_seconds", "Time from delete to finalizer removal",
    subsystem="node",
)
# metrics.go:122-133 — nodes fully terminated, by owning pool
NODES_TERMINATED = REGISTRY.counter(
    "terminated_total", "Nodes fully terminated", subsystem="node"
)


def _is_critical(pod: Pod) -> bool:
    if pod.spec.priority is not None and pod.spec.priority >= SYSTEM_CRITICAL_PRIORITY:
        return True
    return pod.spec.priority_class_name in (
        "system-cluster-critical", "system-node-critical"
    )


def _is_daemon(pod: Pod) -> bool:
    return podutil.is_owned_by_daemonset(pod)


class NodeTerminationController:
    def __init__(
        self, kube: KubeClient, cloud_provider: CloudProvider, clock: Clock,
        recorder: Recorder, eviction_queue=None,
    ):
        from karpenter_tpu_torch.controllers.eviction_queue import EvictionQueue

        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self.eviction_queue = (
            eviction_queue
            if eviction_queue is not None
            else EvictionQueue(kube, clock, recorder)
        )

    def reconcile_all(self) -> None:
        for node in self.kube.list(Node):
            if node.metadata.deletion_timestamp is not None:
                self.reconcile(node)

    def reconcile(self, node: Node) -> str:
        """Returns 'draining' while evictions are in flight, 'done' when the
        finalizer came off, 'skip' otherwise."""
        node = self.kube.get_opt(Node, node.metadata.name, "")
        if node is None or node.metadata.deletion_timestamp is None:
            return "skip"
        if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return "skip"
        self._delete_node_claims(node)
        self._ensure_taint(node)
        if self._drain(node):
            # a vanished instance can never finish draining: kubelet is gone,
            # pods will never leave — take the finalizer off now
            # (termination/controller.go:90-97)
            if node.spec.provider_id and not self._instance_exists(node):
                self._remove_finalizer(node)
                return "done"
            return "draining"
        self._delete_instance(node)
        self._remove_finalizer(node)
        return "done"

    def _remove_finalizer(self, node: Node) -> None:
        deleted_at = node.metadata.deletion_timestamp
        self.kube.patch(
            node,
            lambda n: n.metadata.finalizers.__setitem__(
                slice(None),
                [f for f in n.metadata.finalizers if f != wk.TERMINATION_FINALIZER],
            ),
        )
        TERMINATION_DURATION.observe(self.clock.now() - deleted_at)
        NODES_TERMINATED.inc(
            labels={"nodepool": node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")}
        )

    def _delete_node_claims(self, node: Node) -> None:
        """Deleting the node deletes its claims too, so the claim-side
        finalizer runs in parallel (termination/controller.go:109-120)."""
        if not node.spec.provider_id:
            return
        for claim in self.kube.list(
            NodeClaim,
            predicate=lambda c: c.status.provider_id == node.spec.provider_id,
        ):
            if claim.metadata.deletion_timestamp is None:
                self.kube.delete(NodeClaim, claim.metadata.name, "")

    def _instance_exists(self, node: Node) -> bool:
        try:
            self.cloud_provider.get(node.spec.provider_id)
            return True
        except NodeClaimNotFoundError:
            return False

    def _ensure_taint(self, node: Node) -> None:
        taint = disruption_taint()

        def apply(n):
            if not any(t.match(taint) for t in n.spec.taints):
                n.spec.taints.append(taint)
            # pull the node out of load-balancer target groups while it
            # drains (terminator.go:64-70)
            n.metadata.labels[wk.LABEL_NODE_EXCLUDE_DISRUPTION] = "karpenter"

        if (
            not any(t.match(taint) for t in node.spec.taints)
            or node.metadata.labels.get(wk.LABEL_NODE_EXCLUDE_DISRUPTION) != "karpenter"
        ):
            self.kube.patch(node, apply)

    def _drain(self, node: Node) -> bool:
        """One drain pass; True while pods remain (terminator.go:81-147).

        Eviction itself is asynchronous: the current priority group's pods go
        into the singleton eviction queue (PDB-429-aware, exponential
        backoff) and the drain just observes pods leaving the node — the
        reference's Terminator.Drain + eviction queue split."""
        pods = self.kube.list(
            Pod, predicate=lambda p: p.spec.node_name == node.metadata.name
        )
        waiting: List[Pod] = []
        disruption_taints = Taints([disruption_taint()])
        for p in pods:
            if podutil.is_owned_by_node(p):  # static pods die with the node
                continue
            if podutil.is_terminal(p):
                continue
            # pods tolerating the disruption taint opted in to riding the
            # node down (terminator.go:91-92)
            if not disruption_taints.tolerates(p):
                continue
            # kubelet partitioned: a pod a minute past its deletion stamp
            # will never confirm — stop waiting on it (terminator.go:149-154)
            if (
                podutil.is_terminating(p)
                and self.clock.now() > p.metadata.deletion_timestamp + 60.0
            ):
                continue
            waiting.append(p)
        if not waiting:
            return False
        evictable = [p for p in waiting if not podutil.is_terminating(p)]
        # ordered groups: the first non-empty group drains before later ones;
        # already-terminating pods keep the drain open without re-enqueueing
        groups = [
            [p for p in evictable if not _is_critical(p) and not _is_daemon(p)],
            [p for p in evictable if not _is_critical(p) and _is_daemon(p)],
            [p for p in evictable if _is_critical(p) and not _is_daemon(p)],
            [p for p in evictable if _is_critical(p) and _is_daemon(p)],
        ]
        for group in groups:
            if group:
                self.eviction_queue.add(*group)
                break  # later groups wait for this one to finish draining
        return True

    def _delete_instance(self, node: Node) -> None:
        if not node.spec.provider_id:
            return
        claims = self.kube.list(
            NodeClaim,
            predicate=lambda c: c.status.provider_id == node.spec.provider_id,
        )
        claim = claims[0] if claims else NodeClaim(
            metadata=ObjectMeta(name=node.metadata.name, namespace=""),
            status=NodeClaimStatus(provider_id=node.spec.provider_id),
        )
        try:
            self.cloud_provider.delete(claim)
        except NodeClaimNotFoundError:
            pass
