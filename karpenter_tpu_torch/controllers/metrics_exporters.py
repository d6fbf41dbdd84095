"""Metric gauge exporters for nodes, nodepools, and pods.

Equivalent of reference pkg/controllers/metrics/{node,nodepool,pod}: periodic
scans publishing allocatable/requests per node (node/controller.go:47-190),
limits/usage per nodepool, pod phase counts, and the pod startup-time
histogram — creation to the Ready condition's transition, observed once per
pod first seen Pending (pod/controller.go:68-75, 146-160) — all through the
diffing metrics.Store so series for deleted objects disappear.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import Node, Pod
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY, Store
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res

NODE_ALLOCATABLE = REGISTRY.gauge(
    "allocatable", "Node allocatable by resource", subsystem="nodes"
)
NODE_REQUESTS = REGISTRY.gauge(
    "total_pod_requests", "Requested resources by node", subsystem="nodes"
)
NODEPOOL_LIMIT = REGISTRY.gauge(
    "limit", "NodePool resource limits", subsystem="nodepools"
)
NODEPOOL_USAGE = REGISTRY.gauge(
    "usage", "NodePool resource usage", subsystem="nodepools"
)
POD_STATE = REGISTRY.gauge(
    "state", "Pods by phase", subsystem="pods"
)
POD_STARTUP_TIME = REGISTRY.histogram(
    "startup_time_seconds",
    "The time from pod creation until the pod is running",
    subsystem="pods",
)


class MetricsExporter:
    def __init__(self, kube: KubeClient):
        self.kube = kube
        self.store = Store()
        # pods seen Pending whose startup time has not been recorded yet
        # (pod/controller.go pendingPods set); the observation fires exactly
        # once, at the first scan where the pod has left Pending and carries
        # a Ready condition
        self._pending_pods: set = set()

    def reconcile(self) -> None:
        series: Dict[str, List[Tuple]] = {}
        pods = self.kube.list(Pod)
        requests_by_node: Dict[str, Dict[str, float]] = {}
        for p in pods:
            # same active-pod filter as the cluster state cache, so the gauge
            # matches what the scheduler/consolidator actually see
            if p.spec.node_name and not podutil.is_terminal(p) and not podutil.is_terminating(p):
                requests_by_node[p.spec.node_name] = res.merge(
                    requests_by_node.get(p.spec.node_name), res.pod_requests(p)
                )
        for node in self.kube.list(Node):
            key = f"node/{node.metadata.name}"
            out = []
            for name, value in node.status.allocatable.items():
                out.append((NODE_ALLOCATABLE,
                            {"node": node.metadata.name, "resource": name}, value))
            for name, value in requests_by_node.get(node.metadata.name, {}).items():
                out.append((NODE_REQUESTS,
                            {"node": node.metadata.name, "resource": name}, value))
            series[key] = out
        for np_obj in self.kube.list(NodePool):
            out = []
            for name, value in np_obj.spec.limits.items():
                out.append((NODEPOOL_LIMIT,
                            {"nodepool": np_obj.name, "resource": name}, value))
            for name, value in np_obj.status.resources.items():
                out.append((NODEPOOL_USAGE,
                            {"nodepool": np_obj.name, "resource": name}, value))
            series[f"nodepool/{np_obj.name}"] = out
        phase_counts: Dict[str, int] = {}
        for p in pods:
            phase_counts[p.status.phase] = phase_counts.get(p.status.phase, 0) + 1
            self._record_pod_startup(p)
        live = {f"{p.metadata.namespace}/{p.metadata.name}" for p in pods}
        self._pending_pods &= live
        series["pods"] = [
            (POD_STATE, {"phase": phase}, float(count))
            for phase, count in phase_counts.items()
        ]
        self.store.replace_all(series)

    def _record_pod_startup(self, p: Pod) -> None:
        """pod/controller.go:146-160: a pod is tracked while Pending; when it
        has left Pending AND has a Ready condition, observe Ready transition
        minus creation, once."""
        key = f"{p.metadata.namespace}/{p.metadata.name}"
        if p.status.phase == "Pending":
            self._pending_pods.add(key)
            return
        if key not in self._pending_pods:
            return
        ready = next(
            (
                c
                for c in p.status.conditions
                if c.type == "Ready" and c.status == "True"
            ),
            None,
        )
        if ready is None:
            return
        created = p.metadata.creation_timestamp or 0.0
        POD_STARTUP_TIME.observe(max(ready.last_transition_time - created, 0.0))
        self._pending_pods.discard(key)
