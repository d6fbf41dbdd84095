"""NodePool API type.

Equivalent of reference pkg/apis/v1beta1/nodepool.go: the desired shape of a
pool of nodes — a NodeClaim template, disruption policy with budgets, capacity
limits, and a scheduling weight.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis.objects import NodeSelectorRequirement, ObjectMeta, Taint
from karpenter_tpu_torch.utils import cron as cronutil
from karpenter_tpu_torch.utils.clock import Clock

# consolidation policies (nodepool.go:132-137)
CONSOLIDATION_POLICY_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED = "WhenUnderutilized"

NEVER = math.inf  # NillableDuration "Never"

UNBOUNDED_DISRUPTIONS = 2**31 - 1


def parse_duration(value) -> float:
    """Parse "1h30m", "30s", "Never", or a number into seconds."""
    if value is None:
        return NEVER
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if s == "Never":
        return NEVER
    total, num = 0.0, ""
    for ch in s:
        if ch.isdigit() or ch == ".":
            num += ch
        elif ch in "smh" and num:
            total += float(num) * {"s": 1, "m": 60, "h": 3600}[ch]
            num = ""
        else:
            raise ValueError(f"invalid duration {value!r}")
    if num:
        raise ValueError(f"invalid duration {value!r} (missing unit)")
    return total


@dataclass
class Budget:
    """Caps simultaneous disruptions, optionally within cron-scheduled windows
    (nodepool.go:103-130)."""

    nodes: str = "10%"  # int count or percentage
    schedule: Optional[str] = None
    duration: Optional[str] = None  # e.g. "8h"; required iff schedule set

    def is_active(self, clock: Clock) -> bool:
        """Active if the last schedule hit is within ``duration`` of now
        (nodepool.go:265-277)."""
        if self.schedule is None and self.duration is None:
            return True
        sched = cronutil.parse(self.schedule or "")
        duration_s = parse_duration(self.duration or "0s")
        now = _dt.datetime.fromtimestamp(clock.now())
        checkpoint = now - _dt.timedelta(seconds=duration_s)
        next_hit = sched.next_after(checkpoint)
        return next_hit <= now

    def get_allowed_disruptions(self, clock: Clock, num_nodes: int) -> int:
        """Scaled budget value; MAXINT when inactive (nodepool.go:236-257)."""
        if not self.is_active(clock):
            return UNBOUNDED_DISRUPTIONS
        nodes = self.nodes.strip()
        if nodes.endswith("%"):
            pct = int(nodes[:-1])
            return math.floor(num_nodes * pct / 100)
        return int(nodes)


@dataclass
class Disruption:
    """Disruption policy (nodepool.go:65-99)."""

    consolidation_policy: str = CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
    consolidate_after: Optional[str] = None  # duration or "Never"; WhenEmpty only
    expire_after: str = "720h"  # duration or "Never"
    budgets: List[Budget] = field(default_factory=lambda: [Budget(nodes="10%")])

    def consolidate_after_seconds(self) -> float:
        return parse_duration(self.consolidate_after) if self.consolidate_after else 0.0

    def expire_after_seconds(self) -> float:
        return parse_duration(self.expire_after)


@dataclass
class NodeClassReference:
    name: str = "default"
    kind: str = ""
    api_version: str = ""


@dataclass
class KubeletConfiguration:
    """Kubelet overrides affecting allocatable computation
    (nodeclaim.go:70-132)."""

    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: Dict[str, float] = field(default_factory=dict)
    kube_reserved: Dict[str, float] = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)
    eviction_soft: Dict[str, str] = field(default_factory=dict)
    eviction_soft_grace_period: Dict[str, str] = field(default_factory=dict)
    eviction_max_pod_grace_period: Optional[int] = None
    image_gc_high_threshold_percent: Optional[int] = None
    image_gc_low_threshold_percent: Optional[int] = None
    cpu_cfs_quota: Optional[bool] = None
    cluster_dns: List[str] = field(default_factory=list)


@dataclass
class NodeClaimSpec:
    """Desired state of one machine (reference nodeclaim.go:26-55)."""

    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    resource_requests: Dict[str, float] = field(default_factory=dict)
    kubelet: Optional[KubeletConfiguration] = None
    node_class_ref: NodeClassReference = field(default_factory=NodeClassReference)


@dataclass
class NodeClaimTemplateSpec:
    """Pool-level template metadata + NodeClaimSpec (nodepool.go:155-175)."""

    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplateSpec = field(default_factory=NodeClaimTemplateSpec)
    disruption: Disruption = field(default_factory=Disruption)
    limits: Dict[str, float] = field(default_factory=dict)
    weight: Optional[int] = None


@dataclass
class NodePoolStatus:
    resources: Dict[str, float] = field(default_factory=dict)


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)

    @property
    def name(self):
        return self.metadata.name

    def hash(self) -> str:
        """Static-drift hash over the template (nodepool.go:191-197).

        Budgets/requirements/resources carry ``hash:"ignore"`` in the
        reference; the drift-relevant surface is template labels, annotations,
        taints, startup taints, and kubelet config."""
        tpl = self.spec.template
        payload = {
            "labels": sorted(tpl.labels.items()),
            "annotations": sorted(tpl.annotations.items()),
            "taints": sorted((t.key, t.value, t.effect) for t in tpl.spec.taints),
            "startup_taints": sorted((t.key, t.value, t.effect) for t in tpl.spec.startup_taints),
            "kubelet": _kubelet_payload(tpl.spec.kubelet),
            "node_class_ref": (
                tpl.spec.node_class_ref.kind,
                tpl.spec.node_class_ref.name,
                tpl.spec.node_class_ref.api_version,
            ),
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]

    def get_allowed_disruptions(self, clock: Clock, num_nodes: int) -> int:
        """Most restrictive active budget (nodepool.go:217-231)."""
        vals = [b.get_allowed_disruptions(clock, num_nodes) for b in self.spec.disruption.budgets]
        return min(vals) if vals else UNBOUNDED_DISRUPTIONS

    def must_consolidate_when_empty(self) -> bool:
        return self.spec.disruption.consolidation_policy == CONSOLIDATION_POLICY_WHEN_EMPTY


def _kubelet_payload(k: Optional[KubeletConfiguration]):
    if k is None:
        return None
    return {
        "max_pods": k.max_pods,
        "pods_per_core": k.pods_per_core,
        "system_reserved": sorted(k.system_reserved.items()),
        "kube_reserved": sorted(k.kube_reserved.items()),
        "eviction_hard": sorted(k.eviction_hard.items()),
        "eviction_soft": sorted(k.eviction_soft.items()),
        "cluster_dns": list(k.cluster_dns),
    }


def order_by_weight(nodepools: List[NodePool]) -> List[NodePool]:
    """Highest weight first (nodepool.go:209-213)."""
    return sorted(nodepools, key=lambda np: -(np.spec.weight or 0))
