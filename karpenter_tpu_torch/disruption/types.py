"""Disruption candidates and commands (the JAX package's
``disruption/types.py``).

Equivalent of reference pkg/controllers/disruption/types.go: the Candidate
eligibility chain (types.go:60-131), the pod-eviction cost model and
disruption cost (types.go:129-145, helpers.go:137-158), and the Command an
evaluation method emits (types.go:147-169).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NEVER, NodePool
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock

# pod annotation mirrored from k8s.io/api core/v1
POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"

DECISION_NONE = "none"
DECISION_DELETE = "delete"
DECISION_REPLACE = "replace"


class IneligibleError(Exception):
    """Why a node cannot be a disruption candidate."""


def get_pod_eviction_cost(pod: Pod) -> float:
    """Relative pain of evicting one pod, from the deletion-cost annotation
    and pod priority, clamped to [-10, 10] (helpers.go:137-158)."""
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw:
        try:
            cost += float(raw) / (2**31) * 10.0
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += float(pod.spec.priority) / (2**31) * 10.0
    return max(-10.0, min(10.0, cost))


def lifetime_remaining(clock: Clock, nodepool: NodePool, node_claim: Optional[NodeClaim]) -> float:
    """Fraction of the node's allowed lifetime left; discounts the disruption
    cost of nodes that will expire soon anyway (types.go:133-145)."""
    expire_after = nodepool.spec.disruption.expire_after_seconds()
    if expire_after == NEVER or expire_after <= 0 or node_claim is None:
        return 1.0
    if node_claim.metadata.creation_timestamp is None:
        return 1.0
    age = clock.now() - node_claim.metadata.creation_timestamp
    return max(0.0, min(1.0, 1.0 - age / expire_after))


@dataclass
class Candidate:
    """One disruptable node: its state view, owning pool, live pods, current
    instance type/offering price, and the cost of disrupting it."""

    state_node: StateNode
    nodepool: NodePool
    pods: List[Pod]
    instance_type: Optional[InstanceType]
    price: float  # current offering price; inf when unresolvable
    capacity_type: str
    zone: str
    disruption_cost: float

    @property
    def name(self) -> str:
        return self.state_node.name

    @property
    def node_claim(self) -> Optional[NodeClaim]:
        return self.state_node.node_claim

    @property
    def provider_id(self) -> str:
        return self.state_node.provider_id

    def reschedulable_pods(self) -> List[Pod]:
        return [p for p in self.pods if podutil.is_reschedulable(p)]

    def is_empty(self) -> bool:
        return len(self.reschedulable_pods()) == 0


def new_candidate(
    clock: Clock,
    state_node: StateNode,
    pods: List[Pod],
    nodepools: Dict[str, NodePool],
    instance_types: Dict[str, Dict[str, InstanceType]],
    is_nominated: bool,
) -> Candidate:
    """The eligibility chain (types.go:60-131); raises IneligibleError with
    the reason the reference events."""
    if not state_node.managed():
        raise IneligibleError("not managed by this framework")
    if state_node.node is None or state_node.node_claim is None:
        raise IneligibleError("node and nodeclaim pair not yet resolved")
    if not state_node.initialized():
        raise IneligibleError("node is not initialized")
    if state_node.marked_for_deletion():
        raise IneligibleError("node is deleting or already disrupting")
    if is_nominated:
        raise IneligibleError("node is nominated for pending pods")
    # the node-level do-not-disrupt annotation blocks candidacy outright on
    # KEY PRESENCE — the reference deliberately ignores the value here
    # (types.go:78-81), unlike the per-pod check below which requires the
    # value "true" (pod/scheduling.go:91)
    if wk.DO_NOT_DISRUPT_ANNOTATION_KEY in state_node.annotations():
        raise IneligibleError(
            f"disruption is blocked through the "
            f"{wk.DO_NOT_DISRUPT_ANNOTATION_KEY!r} annotation"
        )
    labels = state_node.labels()
    # candidates must carry the offering labels (types.go:83-91): a node
    # without them can't be priced, so it can't be consolidated
    for required in (wk.CAPACITY_TYPE_LABEL_KEY, wk.LABEL_TOPOLOGY_ZONE):
        if required not in labels:
            raise IneligibleError(f"required label {required!r} doesn't exist")
    pool_name = state_node.nodepool_name
    if pool_name is None:
        raise IneligibleError("node has no nodepool label")
    nodepool = nodepools.get(pool_name)
    if nodepool is None:
        raise IneligibleError(f"nodepool {pool_name!r} no longer exists")
    for pod in pods:
        if podutil.has_do_not_disrupt(pod) and not podutil.is_terminal(pod):
            raise IneligibleError(
                f"pod {pod.key()} has the do-not-disrupt annotation"
            )

    it_name = labels.get(wk.LABEL_INSTANCE_TYPE_STABLE, "")
    zone = labels.get(wk.LABEL_TOPOLOGY_ZONE, "")
    capacity_type = labels.get(wk.CAPACITY_TYPE_LABEL_KEY, "")
    instance_type = instance_types.get(pool_name, {}).get(it_name)
    if instance_type is None:
        raise IneligibleError(f"instance type {it_name!r} not found for pool")
    offering = instance_type.offerings.get(capacity_type, zone)
    price = offering.price if offering is not None else float("inf")

    remaining = lifetime_remaining(clock, nodepool, state_node.node_claim)
    cost = sum(get_pod_eviction_cost(p) for p in pods) * remaining
    return Candidate(
        state_node=state_node,
        nodepool=nodepool,
        pods=pods,
        instance_type=instance_type,
        price=price,
        capacity_type=capacity_type,
        zone=zone,
        disruption_cost=cost,
    )


@dataclass
class Command:
    """What a method decided (types.go:147-169): candidates to remove and the
    replacement claims (as solver Placements turned into NodeClaims by the
    provisioner's creation path)."""

    candidates: List[Candidate] = field(default_factory=list)
    replacements: List[NodeClaim] = field(default_factory=list)
    method: str = ""
    consolidation_type: str = ""

    @property
    def decision(self) -> str:
        if not self.candidates:
            return DECISION_NONE
        return DECISION_REPLACE if self.replacements else DECISION_DELETE

    def __repr__(self) -> str:
        return (
            f"Command({self.decision}, candidates={[c.name for c in self.candidates]}, "
            f"replacements={len(self.replacements)})"
        )
