"""StateNode — the Node + NodeClaim union view with resource accounting.

Equivalent of reference pkg/controllers/state/statenode.go. A StateNode exists
as soon as either the NodeClaim or the Node object is known and fuses both
sides: before the node registers, capacity/taints come from the claim; after,
from the node. `available = allocatable - pod requests` (statenode.go:259-261)
is the quantity every scheduling and consolidation decision reads.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.objects import NO_SCHEDULE, Node, Pod, Taint
from karpenter_tpu_torch.scheduling.hostports import HostPort, get_host_ports
from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS, Taints
from karpenter_tpu_torch.utils import resources as res


def disruption_taint() -> Taint:
    """The karpenter.tpu/disruption:NoSchedule=disrupting taint
    (reference v1beta1/taints.go)."""
    return Taint(
        key=wk.DISRUPTION_TAINT_KEY,
        effect=NO_SCHEDULE,
        value=wk.DISRUPTING_NO_SCHEDULE_TAINT_VALUE,
    )


class StateNode:
    def __init__(self, node: Optional[Node] = None, node_claim: Optional[NodeClaim] = None):
        self.node = node
        self.node_claim = node_claim
        # pod key -> resource list (terminal/terminating pods are not tracked)
        self.pod_requests: Dict[str, Dict[str, float]] = {}
        self.pod_limits: Dict[str, Dict[str, float]] = {}
        # subset of pod_requests owned by daemonsets (statenode.go:64-66)
        self.daemonset_requests: Dict[str, Dict[str, float]] = {}
        self.daemonset_limits: Dict[str, Dict[str, float]] = {}
        self.host_port_usage: Dict[str, List[HostPort]] = {}
        self.mark_for_deletion = False
        self.nominated_until: float = 0.0

    # -- identity -------------------------------------------------------------

    @property
    def name(self) -> str:
        if self.node is not None:
            return self.node.metadata.name
        if self.node_claim is not None:
            return self.node_claim.status.node_name or self.node_claim.metadata.name
        return ""

    @property
    def provider_id(self) -> str:
        if self.node is not None and self.node.spec.provider_id:
            return self.node.spec.provider_id
        if self.node_claim is not None:
            return self.node_claim.status.provider_id
        return ""

    def labels(self) -> Dict[str, str]:
        # registered node labels win; claim labels fill the pre-registration gap
        out: Dict[str, str] = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.labels)
        if self.node is not None:
            out.update(self.node.metadata.labels)
        return out

    def annotations(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.annotations)
        if self.node is not None:
            out.update(self.node.metadata.annotations)
        return out

    @property
    def nodepool_name(self) -> Optional[str]:
        return self.labels().get(wk.NODEPOOL_LABEL_KEY)

    # -- lifecycle predicates (statenode.go:206-230) --------------------------

    def managed(self) -> bool:
        """Owned by this framework: a NodeClaim exists or the node carries the
        nodepool label."""
        return self.node_claim is not None or wk.NODEPOOL_LABEL_KEY in self.labels()

    def registered(self) -> bool:
        if self.node is None:
            return False
        return self.node.metadata.labels.get(wk.NODE_REGISTERED_LABEL_KEY) == "true"

    def initialized(self) -> bool:
        if self.node is None:
            return False
        return self.node.metadata.labels.get(wk.NODE_INITIALIZED_LABEL_KEY) == "true"

    def marked_for_deletion(self) -> bool:
        """Deleting, or tracked by an in-flight disruption command
        (statenode.go:291-299)."""
        if self.mark_for_deletion:
            return True
        if self.node_claim is not None and self.node_claim.metadata.deletion_timestamp is not None:
            return True
        return self.node is not None and self.node.metadata.deletion_timestamp is not None

    def nominate(self, until: float) -> None:
        self.nominated_until = until

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now

    # -- resources (statenode.go:232-276) -------------------------------------

    def capacity(self) -> Dict[str, float]:
        """Claim capacity until the node registers (the claim knows the
        instance type's shape before kubelet reports it)."""
        if not self.registered() and self.node_claim is not None:
            return dict(self.node_claim.status.capacity)
        if self.node is not None:
            return dict(self.node.status.capacity)
        if self.node_claim is not None:
            return dict(self.node_claim.status.capacity)
        return {}

    def allocatable(self) -> Dict[str, float]:
        if not self.registered() and self.node_claim is not None:
            return dict(self.node_claim.status.allocatable)
        if self.node is not None:
            return dict(self.node.status.allocatable)
        if self.node_claim is not None:
            return dict(self.node_claim.status.allocatable)
        return {}

    def pod_request_total(self) -> Dict[str, float]:
        return res.merge(*self.pod_requests.values()) if self.pod_requests else {}

    def daemonset_request_total(self) -> Dict[str, float]:
        return (
            res.merge(*self.daemonset_requests.values()) if self.daemonset_requests else {}
        )

    def available(self) -> Dict[str, float]:
        """allocatable - Σ pod requests (statenode.go:259-261)."""
        return res.subtract(self.allocatable(), self.pod_request_total())

    # -- taints (statenode.go:183-204) ----------------------------------------

    def taints(self) -> Taints:
        """Until initialized, a managed node's taints come from the claim spec
        (kubelet hasn't synced yet) and startup taints are carved out; known
        ephemeral taints are always ignored."""
        ephemeral = list(KNOWN_EPHEMERAL_TAINTS)
        use_claim = not self.initialized() and self.managed() and self.node_claim is not None
        if use_claim:
            ephemeral.extend(self.node_claim.spec.startup_taints)
            source = list(self.node_claim.spec.taints)
        elif self.node is not None:
            source = list(self.node.spec.taints)
        else:
            source = []
        return Taints(t for t in source if not any(t.match(e) for e in ephemeral))

    # -- pod bookkeeping (cluster.updateNodeUsageFromPod) ---------------------

    def update_for_pod(self, pod: Pod, is_daemonset: bool) -> None:
        key = pod.key()
        self.pod_requests[key] = res.pod_requests(pod)
        self.pod_limits[key] = res.pod_limits(pod)
        if is_daemonset:
            self.daemonset_requests[key] = res.pod_requests(pod)
            self.daemonset_limits[key] = res.pod_limits(pod)
        ports = get_host_ports(pod)
        if ports:
            self.host_port_usage[key] = ports
        else:
            self.host_port_usage.pop(key, None)

    def cleanup_for_pod(self, pod_key: str) -> None:
        self.pod_requests.pop(pod_key, None)
        self.pod_limits.pop(pod_key, None)
        self.daemonset_requests.pop(pod_key, None)
        self.daemonset_limits.pop(pod_key, None)
        self.host_port_usage.pop(pod_key, None)

    def host_ports(self) -> List[HostPort]:
        out: List[HostPort] = []
        for ports in self.host_port_usage.values():
            out.extend(ports)
        return out

    def pod_keys(self) -> List[str]:
        return list(self.pod_requests)

    def deep_copy(self) -> "StateNode":
        return copy.deepcopy(self)

    def __repr__(self) -> str:
        return (
            f"StateNode(name={self.name!r}, provider_id={self.provider_id!r}, "
            f"pods={len(self.pod_requests)})"
        )
