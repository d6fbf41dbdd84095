"""PodDisruptionBudget gate (the JAX package's ``disruption/pdblimits.py``).

Equivalent of reference pkg/controllers/disruption/pdblimits.go: a snapshot of
every PDB's remaining disruption allowance, answering "can this set of pods be
evicted right now?" (pdblimits.go:59-85). Used by disruption candidate
eligibility and by the node drain's eviction queue.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis.objects import Pod, PodDisruptionBudget
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.utils import pod as podutil


def _parse_count(value, total: int) -> int:
    """An int count or a percentage string, k8s intstr-style."""
    if isinstance(value, str) and value.endswith("%"):
        return math.ceil(total * int(value[:-1]) / 100)
    return int(value)


class PDBLimits:
    def __init__(self, kube: KubeClient):
        self.kube = kube
        self._pdbs = kube.list(PodDisruptionBudget)
        # remaining allowance per pdb, computed against current healthy pods
        self._allowed: Dict[int, int] = {}
        for i, pdb in enumerate(self._pdbs):
            self._allowed[i] = self._disruptions_allowed(pdb)

    def _matching_pods(self, pdb: PodDisruptionBudget) -> List[Pod]:
        return self.kube.list(
            Pod,
            namespace=pdb.metadata.namespace,
            predicate=lambda p: (
                pdb.selector is not None
                and pdb.selector.matches(p.metadata.labels)
                and not podutil.is_terminal(p)
                and not podutil.is_terminating(p)
            ),
        )

    def _disruptions_allowed(self, pdb: PodDisruptionBudget) -> int:
        pods = self._matching_pods(pdb)
        healthy = sum(1 for p in pods if p.status.phase == "Running")
        total = len(pods)
        if pdb.min_available is not None:
            return max(0, healthy - _parse_count(pdb.min_available, total))
        if pdb.max_unavailable is not None:
            unavailable = total - healthy
            return max(0, _parse_count(pdb.max_unavailable, total) - unavailable)
        return 2**31

    def _pdbs_for(self, pod: Pod) -> List[int]:
        out = []
        for i, pdb in enumerate(self._pdbs):
            if pdb.metadata.namespace != pod.metadata.namespace:
                continue
            if pdb.selector is not None and pdb.selector.matches(pod.metadata.labels):
                out.append(i)
        return out

    def can_evict_pods(self, pods: Sequence[Pod]) -> Tuple[bool, Optional[str]]:
        """Whether the whole set can be evicted without violating any budget
        (pdblimits.go:59-85)."""
        needed: Dict[int, int] = {}
        for pod in pods:
            for i in self._pdbs_for(pod):
                needed[i] = needed.get(i, 0) + 1
        for i, count in needed.items():
            if count > self._allowed[i]:
                pdb = self._pdbs[i]
                return False, (
                    f"pdb {pdb.metadata.namespace}/{pdb.metadata.name} prevents "
                    f"evicting {count} pods (allows {self._allowed[i]})"
                )
        return True, None

    def try_consume(self, pod: Pod) -> bool:
        """Reserve one disruption for this pod if every covering budget
        allows it; the eviction queue's 429 path."""
        indices = self._pdbs_for(pod)
        if any(self._allowed[i] <= 0 for i in indices):
            return False
        for i in indices:
            self._allowed[i] -= 1
        return True
