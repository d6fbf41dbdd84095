"""Cluster — the thread-safe in-memory mirror of cluster state.

Equivalent of reference pkg/controllers/state/cluster.go. All durable state
lives in the kube store; this cache is rebuilt from LIST/WATCH on startup
(informer.py) and gated by `synced()` before any provisioning or disruption
decision runs (cluster.go:89-123). Snapshots handed to the scheduler are deep
copies (cluster.go:161-168) so a simulation can never corrupt live state.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.objects import DaemonSet, Node, ObjectMeta, Pod
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock

# How long a nomination protects a node from consolidation: 2x the max batch
# window (cluster.go nominationWindow, 20s with default options).
NOMINATION_WINDOW_SECONDS = 20.0

# Forced consolidation revisit period (cluster.go:299-325).
CONSOLIDATION_TIMEOUT_SECONDS = 300.0


class Cluster:
    def __init__(self, kube: KubeClient, clock: Clock):
        self._kube = kube
        self._clock = clock
        self._lock = threading.RLock()
        # state key (providerID, or "node/<name>" pre-providerID) -> StateNode
        self._nodes: Dict[str, StateNode] = {}
        self._node_name_to_key: Dict[str, str] = {}
        self._claim_name_to_key: Dict[str, str] = {}
        # pod key -> state key of the node the pod is bound to
        self._bindings: Dict[str, str] = {}
        # pod key -> Pod for pods with required anti-affinity (cluster.go:128-144)
        self._anti_affinity_pods: Dict[str, Pod] = {}
        # daemonset key -> template Pod (daemon overhead source)
        self._daemonsets: Dict[str, Pod] = {}
        self._unconsolidated_at: float = clock.now()
        self._consolidated_at: float = 0.0
        self._consolidated: bool = False

    # -- sync gate (cluster.go:89-123) ----------------------------------------

    def synced(self) -> bool:
        """True when every NodeClaim and Node in the store is reflected here.
        The informers in this framework are synchronous, so this is primarily
        the crash-recovery / startup gate."""
        # List outside the cluster lock: watch emission holds the kube lock and
        # then takes ours, so taking them in the opposite order here would be
        # an ABBA deadlock.
        claims = self._kube.list(NodeClaim)
        nodes = self._kube.list(Node)
        with self._lock:
            for claim in claims:
                # a claim that hasn't resolved its providerID hasn't resolved
                # its status: decisions on top of it would race the launch
                # (cluster.go:106-110)
                if not claim.status.provider_id:
                    return False
                if claim.metadata.name not in self._claim_name_to_key:
                    return False
            for node in nodes:
                if node.metadata.name not in self._node_name_to_key:
                    return False
            return True

    # -- snapshots ------------------------------------------------------------

    def nodes(self) -> List[StateNode]:
        """Deep-copy snapshot (cluster.go:161-168)."""
        with self._lock:
            return [n.deep_copy() for n in self._nodes.values()]

    def node_for_name(self, name: str) -> Optional[StateNode]:
        with self._lock:
            key = self._node_name_to_key.get(name)
            return self._nodes[key].deep_copy() if key is not None else None

    def node_for_claim(self, claim_name: str) -> Optional[StateNode]:
        with self._lock:
            key = self._claim_name_to_key.get(claim_name)
            return self._nodes[key].deep_copy() if key is not None else None

    def anti_affinity_pods(self) -> List[Pod]:
        with self._lock:
            return [copy.deepcopy(p) for p in self._anti_affinity_pods.values()]

    def daemonset_pods(self) -> List[Pod]:
        with self._lock:
            return [copy.deepcopy(p) for p in self._daemonsets.values()]

    def pods_bound_to(self, node_name: str) -> List[str]:
        """Pod keys currently tracked against a node."""
        with self._lock:
            key = self._node_name_to_key.get(node_name)
            if key is None:
                return []
            return self._nodes[key].pod_keys()

    # -- node / nodeclaim updates (cluster.go:220-294) ------------------------

    def _state_key(self, provider_id: str, node_name: str = "", claim_name: str = "") -> str:
        if provider_id:
            return provider_id
        if node_name:
            return f"node/{node_name}"
        return f"nodeclaim/{claim_name}"

    def _rekey(self, old_key: str, new_key: str) -> None:
        """A claim/node gained its providerID: migrate the shell entry."""
        state = self._nodes.pop(old_key)
        existing = self._nodes.get(new_key)
        if existing is not None:
            # merge the two views: object references from whichever side has
            # them, and the union of both sides' pod bookkeeping
            if state.node is not None:
                existing.node = state.node
            if state.node_claim is not None:
                existing.node_claim = state.node_claim
            existing.pod_requests.update(state.pod_requests)
            existing.pod_limits.update(state.pod_limits)
            existing.daemonset_requests.update(state.daemonset_requests)
            existing.daemonset_limits.update(state.daemonset_limits)
            existing.host_port_usage.update(state.host_port_usage)
            existing.mark_for_deletion = existing.mark_for_deletion or state.mark_for_deletion
            existing.nominated_until = max(existing.nominated_until, state.nominated_until)
            state = existing
        self._nodes[new_key] = state
        for mapping in (self._node_name_to_key, self._claim_name_to_key):
            for name, key in list(mapping.items()):
                if key == old_key:
                    mapping[name] = new_key
        for pod_key, key in list(self._bindings.items()):
            if key == old_key:
                self._bindings[pod_key] = new_key

    def update_node(self, node: Node) -> None:
        with self._lock:
            name = node.metadata.name
            key = self._state_key(node.spec.provider_id, node_name=name)
            old_key = self._node_name_to_key.get(name)
            if old_key is not None and old_key != key:
                self._rekey(old_key, key)
            state = self._nodes.get(key)
            if state is None:
                # a NodeClaim with the same providerID may already hold state
                state = StateNode()
                self._nodes[key] = state
            state.node = node
            self._node_name_to_key[name] = key
            self._mark_unconsolidated_locked()

    def delete_node(self, name: str) -> None:
        with self._lock:
            key = self._node_name_to_key.pop(name, None)
            if key is None:
                return
            state = self._nodes.get(key)
            if state is not None:
                state.node = None
                if state.node_claim is None:
                    self._drop_state(key)
            self._mark_unconsolidated_locked()

    def update_node_claim(self, claim: NodeClaim) -> None:
        with self._lock:
            name = claim.metadata.name
            key = self._state_key(claim.status.provider_id, claim_name=name)
            old_key = self._claim_name_to_key.get(name)
            if old_key is not None and old_key != key:
                self._rekey(old_key, key)
            state = self._nodes.get(key)
            if state is None:
                state = StateNode()
                self._nodes[key] = state
            state.node_claim = claim
            self._claim_name_to_key[name] = key
            self._mark_unconsolidated_locked()

    def delete_node_claim(self, name: str) -> None:
        with self._lock:
            key = self._claim_name_to_key.pop(name, None)
            if key is None:
                return
            state = self._nodes.get(key)
            if state is not None:
                state.node_claim = None
                if state.node is None:
                    self._drop_state(key)
            self._mark_unconsolidated_locked()

    def _drop_state(self, key: str) -> None:
        self._nodes.pop(key, None)
        for pod_key, k in list(self._bindings.items()):
            if k == key:
                del self._bindings[pod_key]

    # -- pod updates (cluster.go:262-294, 547-557) ----------------------------

    def update_pod(self, pod: Pod) -> None:
        with self._lock:
            if podutil.is_terminal(pod) or podutil.is_terminating(pod):
                self._cleanup_pod(pod.key())
            else:
                self._update_pod_binding(pod)
            if podutil.has_required_pod_anti_affinity(pod):
                if podutil.is_terminal(pod) or podutil.is_terminating(pod):
                    self._anti_affinity_pods.pop(pod.key(), None)
                else:
                    self._anti_affinity_pods[pod.key()] = pod
            self._mark_unconsolidated_locked()

    def _update_pod_binding(self, pod: Pod) -> None:
        pod_key = pod.key()
        node_name = pod.spec.node_name
        if not node_name:
            return
        key = self._node_name_to_key.get(node_name)
        if key is None:
            # pod bound to a node we haven't seen yet: create a shell entry
            key = f"node/{node_name}"
            shell = StateNode(node=Node(metadata=ObjectMeta(name=node_name)))
            self._nodes[key] = shell
            self._node_name_to_key[node_name] = key
        old_key = self._bindings.get(pod_key)
        if old_key is not None and old_key != key:
            old = self._nodes.get(old_key)
            if old is not None:
                old.cleanup_for_pod(pod_key)
        newly_bound = old_key != key
        self._bindings[pod_key] = key
        self._nodes[key].update_for_pod(pod, podutil.is_owned_by_daemonset(pod))
        if newly_bound:
            # a pod landed: its nomination (if any) is spent; status-only
            # updates of already-bound pods must not spend it
            self._nodes[key].nominated_until = 0.0

    def delete_pod(self, pod_key: str) -> None:
        with self._lock:
            self._cleanup_pod(pod_key)
            self._anti_affinity_pods.pop(pod_key, None)
            self._mark_unconsolidated_locked()

    def _cleanup_pod(self, pod_key: str) -> None:
        key = self._bindings.pop(pod_key, None)
        if key is not None:
            state = self._nodes.get(key)
            if state is not None:
                state.cleanup_for_pod(pod_key)

    # -- daemonsets ------------------------------------------------------------

    def update_daemonset(self, ds: DaemonSet) -> None:
        with self._lock:
            pod = Pod(metadata=ObjectMeta(name=f"{ds.metadata.name}-template",
                                          namespace=ds.metadata.namespace),
                      spec=ds.pod_template_spec)
            self._daemonsets[f"{ds.metadata.namespace}/{ds.metadata.name}"] = pod
            self._mark_unconsolidated_locked()

    def delete_daemonset(self, ds_key: str) -> None:
        with self._lock:
            self._daemonsets.pop(ds_key, None)
            self._mark_unconsolidated_locked()

    # -- nomination (cluster.go:172-190) --------------------------------------

    def nominate_node_for_pod(self, node_name: str) -> None:
        with self._lock:
            key = self._node_name_to_key.get(node_name)
            if key is not None:
                self._nodes[key].nominate(self._clock.now() + NOMINATION_WINDOW_SECONDS)

    def is_nominated(self, node_name: str) -> bool:
        with self._lock:
            key = self._node_name_to_key.get(node_name)
            return key is not None and self._nodes[key].nominated(self._clock.now())

    # -- deletion marks (disruption in flight) --------------------------------

    def mark_for_deletion(self, *provider_ids: str) -> None:
        with self._lock:
            for pid in provider_ids:
                state = self._nodes.get(pid)
                if state is not None:
                    state.mark_for_deletion = True
            self._mark_unconsolidated_locked()

    def unmark_for_deletion(self, *provider_ids: str) -> None:
        with self._lock:
            for pid in provider_ids:
                state = self._nodes.get(pid)
                if state is not None:
                    state.mark_for_deletion = False
            self._mark_unconsolidated_locked()

    # -- consolidation timestamp (cluster.go:299-325) -------------------------

    def _mark_unconsolidated_locked(self) -> None:
        self._unconsolidated_at = self._clock.now()
        self._consolidated = False

    def mark_unconsolidated(self) -> None:
        with self._lock:
            self._mark_unconsolidated_locked()

    def mark_consolidated(self) -> float:
        with self._lock:
            self._consolidated = True
            self._consolidated_at = self._clock.now()
            return self._unconsolidated_at

    def consolidated(self) -> bool:
        """False if state changed since mark_consolidated, or the forced
        5-minute revisit window elapsed since that mark."""
        with self._lock:
            if not self._consolidated:
                return False
            return self._clock.now() - self._consolidated_at < CONSOLIDATION_TIMEOUT_SECONDS

    # -- test helpers ----------------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()
            self._node_name_to_key.clear()
            self._claim_name_to_key.clear()
            self._bindings.clear()
            self._anti_affinity_pods.clear()
            self._daemonsets.clear()
            self._mark_unconsolidated_locked()
