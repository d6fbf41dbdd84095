"""Orchestration queue — async executor for disruption commands (the JAX
package's ``disruption/orchestration.py``).

Equivalent of reference pkg/controllers/disruption/orchestration/queue.go:
a command waits until every replacement NodeClaim is Initialized, then the
candidate claims are deleted (queue.go:158-274). Commands that exceed the
10-minute timeout, or whose replacements fail, roll back: disruption taints
come off, deletion marks clear, surviving replacements are deleted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.objects import Node
from karpenter_tpu_torch.disruption.types import Command
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient, NotFound
from karpenter_tpu_torch.metrics import REGISTRY
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import disruption_taint
from karpenter_tpu_torch.utils.clock import Clock

COMMAND_TIMEOUT_SECONDS = 600.0  # queue.go:52

QUEUE_DEPTH = REGISTRY.gauge(
    "queue_depth", "Commands waiting on replacements", subsystem="disruption"
)
ACTIONS_PERFORMED = REGISTRY.counter(
    "actions_performed_total", "Completed disruption commands",
    subsystem="disruption",
)


def set_disruption_taint(kube: KubeClient, node_name: str, add: bool) -> None:
    """RequireNoScheduleTaint (statenode.go:354-397): idempotently add/remove
    the karpenter.tpu/disruption:NoSchedule taint on the Node object."""
    node = kube.get_opt(Node, node_name, "")
    if node is None:
        return
    taint = disruption_taint()
    has = any(t.match(taint) for t in node.spec.taints)
    if add and not has:
        kube.patch(node, lambda n: n.spec.taints.append(taint))
    elif not add and has:
        kube.patch(
            node, lambda n: n.spec.taints.__setitem__(
                slice(None), [t for t in n.spec.taints if not t.match(taint)]
            )
        )


@dataclass
class QueueItem:
    command: Command
    replacement_names: List[str]
    added_at: float
    candidate_claim_names: List[str] = field(default_factory=list)
    candidate_node_names: List[str] = field(default_factory=list)
    candidate_provider_ids: List[str] = field(default_factory=list)


class Queue:
    def __init__(
        self, kube: KubeClient, cluster: Cluster, clock: Clock, recorder: Recorder
    ):
        self.kube = kube
        self.cluster = cluster
        self.clock = clock
        self.recorder = recorder
        self.items: List[QueueItem] = []

    def add(self, command: Command) -> None:
        """Enqueue an executed command (queue.go:278-322)."""
        item = QueueItem(
            command=command,
            replacement_names=[r.metadata.name for r in command.replacements],
            added_at=self.clock.now(),
            candidate_claim_names=[
                c.node_claim.metadata.name for c in command.candidates if c.node_claim
            ],
            candidate_node_names=[c.name for c in command.candidates],
            candidate_provider_ids=[c.provider_id for c in command.candidates],
        )
        self.items.append(item)
        QUEUE_DEPTH.set(len(self.items))

    def has_any(self, *provider_ids: str) -> bool:
        tracked = {pid for item in self.items for pid in item.candidate_provider_ids}
        return any(pid in tracked for pid in provider_ids)

    def reconcile(self) -> None:
        """One pass over pending commands (queue.go:158-274)."""
        remaining: List[QueueItem] = []
        for item in self.items:
            state = self._step(item)
            if state == "waiting":
                remaining.append(item)
        self.items = remaining
        QUEUE_DEPTH.set(len(self.items))

    def _step(self, item: QueueItem) -> str:
        if self.clock.now() - item.added_at > COMMAND_TIMEOUT_SECONDS:
            self._rollback(item, "command reached the 10-minute timeout")
            return "dropped"
        ready = True
        for name in item.replacement_names:
            claim = self.kube.get_opt(NodeClaim, name, "")
            if claim is None:
                # a replacement died (ICE, GC): the trade is off
                self._rollback(item, f"replacement nodeclaim {name} disappeared")
                return "dropped"
            if not claim.is_initialized():
                ready = False
        if not ready:
            return "waiting"
        # replacements (if any) are live: retire the candidates
        for name in item.candidate_claim_names:
            try:
                self.kube.delete(NodeClaim, name, "")
            except NotFound:
                pass
        ACTIONS_PERFORMED.inc(labels={"method": item.command.method})
        return "done"

    def _rollback(self, item: QueueItem, reason: str) -> None:
        """Undo the command: untaint, unmark, delete surviving replacements
        (queue.go:191-203)."""
        for node_name in item.candidate_node_names:
            set_disruption_taint(self.kube, node_name, add=False)
        self.cluster.unmark_for_deletion(*item.candidate_provider_ids)
        for name in item.replacement_names:
            try:
                self.kube.delete(NodeClaim, name, "")
            except NotFound:
                pass
        for c in item.command.candidates:
            if c.node_claim is not None:
                self.recorder.publish(
                    object_event(
                        c.node_claim, "Warning", "DisruptionFailed", reason
                    )
                )
