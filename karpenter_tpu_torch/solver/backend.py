"""SolverBackend interface and result model.

The seam between the host control plane and the compute core (BASELINE.json
north star: a pluggable `scheduling-solver`). This package ships one
backend, ``TorchSolver`` (solver/torch_backend.py): the tensorized FFD solve
on PyTorch tensors, whose device programs are hand-written CUDA kernels.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.solver.encode import NodeInfo, TemplateInfo

FAIL_INCOMPATIBLE = "incompatible"


@dataclass
class Placement:
    """One new claim produced by a solve: the pods packed onto it, the
    surviving instance types (input order, as the reference preserves it), and
    the narrowed requirement state."""

    template_index: int
    nodepool_name: str
    pod_indices: List[int] = field(default_factory=list)  # indices into input pods
    instance_type_indices: List[int] = field(default_factory=list)
    requirements: Optional[Requirements] = None
    requests: Dict[str, float] = field(default_factory=dict)


@dataclass
class SolveResult:
    new_claims: List[Placement] = field(default_factory=list)
    # existing-node name -> pod indices placed there this round
    node_pods: Dict[str, List[int]] = field(default_factory=dict)
    # failed pod index -> reason
    failures: Dict[int, str] = field(default_factory=dict)
    # obs/explain.ExplainReport decision provenance (KARPENTER_TPU_EXPLAIN
    # only; None when the flag is off or the solve left no pod unscheduled)
    explain: Optional[object] = None
    # verify.GateContext stashed by single-pass (sweeps-mode) solves: the
    # padded problem + meta this result decoded from, which the device-side
    # verification gate (verify/) re-reads. None from multi-pass relax-ladder
    # solves and any synthetic/stripped result — all of which the host
    # validator handles as before. Excluded from
    # equality/repr: it is provenance, not part of the placement.
    verify_ctx: Optional[object] = field(default=None, compare=False, repr=False)

    def num_scheduled(self) -> int:
        return sum(len(c.pod_indices) for c in self.new_claims) + sum(
            len(v) for v in self.node_pods.values()
        )


class SolverBackend(abc.ABC):
    """One pass of the FFD pack (no relaxation loop — the provisioning layer
    owns relax-and-retry, scheduler.go:150-170)."""

    @abc.abstractmethod
    def solve(
        self,
        pods: Sequence[Pod],
        instance_types: Sequence[InstanceType],
        templates: Sequence[TemplateInfo],
        nodes: Sequence[NodeInfo] = (),
        pod_requirements_override: Optional[Sequence[Requirements]] = None,
        topology=None,  # Optional[Topology]: caller-owned group state to clone
        cluster_pods: Sequence = (),  # (Pod, node labels) pairs for the census
        domains: Optional[Dict[str, set]] = None,  # per-key domain universe
        pod_volumes: Optional[Sequence[Dict[str, frozenset]]] = None,  # per-pod
        # resolved CSI volumes (driver -> unique volume ids), parallel to pods
    ) -> SolveResult:
        ...
