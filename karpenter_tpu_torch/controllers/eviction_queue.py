"""Singleton rate-limited eviction queue.

Equivalent of reference pkg/controllers/node/termination/terminator/
eviction.go:40-149: draining nodes enqueue their pods here exactly once
(set-dedup); the queue attempts each eviction and, when a PodDisruptionBudget
blocks it (the Evict API's 429), requeues with per-pod exponential backoff —
100ms base doubling to a 10s cap — instead of hammering the budget every
reconcile. Successful evictions (and vanished pods, the 404 path) leave the
queue. The drain controller only observes progress: pods disappear from the
node as the queue works through them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.disruption.pdblimits import PDBLimits
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock

BASE_DELAY_SECONDS = 0.1  # eviction.go:44
MAX_DELAY_SECONDS = 10.0  # eviction.go:45

EVICTION_QUEUE_DEPTH = REGISTRY.gauge(
    "eviction_queue_depth", "Pods waiting for eviction", subsystem="node"
)
EVICTIONS_TOTAL = REGISTRY.counter(
    "evictions_total", "Eviction attempts by outcome", subsystem="node"
)


@dataclass
class _Item:
    namespace: str
    name: str
    failures: int = 0
    next_attempt_at: float = 0.0


class EvictionQueue:
    """Pods enter once and are retried with exponential backoff until evicted
    or gone (workqueue.NewItemExponentialFailureRateLimiter semantics)."""

    def __init__(self, kube: KubeClient, clock: Clock, recorder: Recorder):
        self.kube = kube
        self.clock = clock
        self.recorder = recorder
        self.items: Dict[Tuple[str, str], _Item] = {}

    def add(self, *pods: Pod) -> None:
        """Enqueue pods for eviction; already-tracked pods keep their backoff
        state (eviction.go:92-99)."""
        for pod in pods:
            key = (pod.metadata.namespace, pod.metadata.name)
            if key not in self.items:
                self.items[key] = _Item(*key, next_attempt_at=self.clock.now())
        EVICTION_QUEUE_DEPTH.set(len(self.items))

    def has(self, pod: Pod) -> bool:
        return (pod.metadata.namespace, pod.metadata.name) in self.items

    def __len__(self) -> int:
        return len(self.items)

    def reconcile(self) -> None:
        """One singleton pass: attempt every item whose backoff has elapsed
        (eviction.go:101-125). PDB allowances are snapshotted fresh per pass,
        the way each Evict API call sees live budget state."""
        if not self.items:
            return
        now = self.clock.now()
        pdb = PDBLimits(self.kube)
        for key in list(self.items):
            item = self.items[key]
            if item.next_attempt_at > now:
                continue
            pod = self.kube.get_opt(Pod, item.name, item.namespace)
            if pod is None or podutil.is_terminal(pod) or podutil.is_terminating(pod):
                # 404 path: nothing left to evict (eviction.go:131-133)
                del self.items[key]
                continue
            if pdb.try_consume(pod):
                self.recorder.publish(
                    object_event(pod, "Normal", "Evicted", "draining node")
                )
                EVICTIONS_TOTAL.inc(labels={"outcome": "evicted"})
                self.kube.delete_opt(Pod, item.name, item.namespace)
                del self.items[key]
            else:
                # 429 path: budget violation — back off exponentially
                # (eviction.go:135-142)
                item.failures += 1
                delay = min(
                    BASE_DELAY_SECONDS * (2 ** (item.failures - 1)),
                    MAX_DELAY_SECONDS,
                )
                item.next_attempt_at = now + delay
                EVICTIONS_TOTAL.inc(labels={"outcome": "pdb_blocked"})
                self.recorder.publish(
                    object_event(
                        pod, "Normal", "EvictionBlocked",
                        "pod disruption budget prevents eviction",
                    )
                )
        EVICTION_QUEUE_DEPTH.set(len(self.items))
