"""The inputs of one solve, assembled on the host (the JAX package's
``provisioning/provisioner.SchedulerInputs``, provisioner.go:204-296)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.solver.encode import NodeInfo, TemplateInfo


@dataclass
class SchedulerInputs:
    """Everything one Solve needs."""

    pods: List[Pod]
    instance_types: List[InstanceType]
    templates: List[TemplateInfo]
    nodes: List[NodeInfo]
    domains: Dict[str, set]
    cluster_pods: List[Tuple[Pod, Dict[str, str]]]
    nodepools: Dict[str, NodePool] = field(default_factory=dict)
    # resolved CSI volumes per pod (parallel to pods); None when no CSINode
    # publishes limits
    pod_volumes: Optional[List[Dict[str, frozenset]]] = None
