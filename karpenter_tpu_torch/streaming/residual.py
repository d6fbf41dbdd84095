"""Residual-world construction: the shared statement of "pin what stayed".

Counterpart of the JAX package's ``streaming/residual.py``. The streaming
warm re-solve (streaming/warm.py) re-solves its churn seeds against a world
whose earlier decisions are pinned: existing nodes with their kept pods'
consumption folded into the daemon overhead, and each surviving claim
exposed as a joinable pseudo-node. The incremental consolidation screen
(disruption/screen_delta.py) pins the same world at the FFDState level, on
the device. Both are capacity minus everything the kept placement consumes,
ports and pod count included; this module holds the NodeInfo-level
constructions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import IN
from karpenter_tpu_torch.scheduling import Requirement
from karpenter_tpu_torch.scheduling.hostports import get_host_ports
from karpenter_tpu_torch.solver.encode import NodeInfo
from karpenter_tpu_torch.utils import resources as res

# hostname prefix of claim pseudo-nodes (must never collide with a real node)
CLAIM_PREFIX = "@claim-"


def pinned_node_residuals(
    nodes: Sequence[NodeInfo],
    pods: Sequence,
    pinned_by_bin: Dict[str, List[int]],
) -> List[NodeInfo]:
    """Real nodes with their pinned pods' consumption folded into the
    overhead side: available capacity is untouched (the encoder subtracts
    overhead), host ports extend with the pinned pods' reservations, and the
    implicit pods=1 resource rides along, so a re-solve sees exactly the
    capacity the pinned placement leaves behind."""
    out: List[NodeInfo] = []
    for n in nodes:
        overhead = dict(n.daemon_overhead)
        ports = list(n.host_ports)
        for i in pinned_by_bin.get(n.name, ()):
            overhead = res.merge(overhead, {**res.pod_requests(pods[i]), res.PODS: 1.0})
            ports.extend(get_host_ports(pods[i]))
        out.append(
            NodeInfo(
                name=n.name,
                requirements=n.requirements.copy(),
                taints=n.taints,
                available=dict(n.available),
                daemon_overhead=overhead,
                host_ports=ports,
                volume_used=dict(n.volume_used),
                volume_limits=dict(n.volume_limits),
            )
        )
    return out


def claim_pseudo_node(
    ci: int,
    placement,
    pods: Sequence,
    instance_types: Sequence,
    templates: Sequence,
    prefix: str = CLAIM_PREFIX,
) -> NodeInfo:
    """A surviving claim as a joinable pseudo-node: hostname-pinned so only
    an explicit requirement can land there, capacity the elementwise minimum
    over its surviving instance types (a joining pod must fit every one, so
    actuation keeps its full choice set), consumption so far as overhead."""
    name = prefix + str(ci)
    reqs = placement.requirements.copy()
    reqs.add(Requirement(wk.LABEL_HOSTNAME, IN, [name]))
    alloc = None
    for ti in placement.instance_type_indices:
        a = instance_types[ti].allocatable()
        alloc = a if alloc is None else {
            k: min(alloc.get(k, float("inf")), a.get(k, float("inf")))
            for k in set(alloc) | set(a)
        }
    ports: List = []
    for i in placement.pod_indices:
        ports.extend(get_host_ports(pods[i]))
    return NodeInfo(
        name=name,
        requirements=reqs,
        taints=templates[placement.template_index].taints,
        available=alloc or {},
        daemon_overhead=dict(placement.requests),
        host_ports=ports,
    )
