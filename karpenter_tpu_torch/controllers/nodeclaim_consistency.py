"""NodeClaim consistency checks.

Equivalent of reference pkg/controllers/nodeclaim/consistency/: 10-minute
invariant scans (controller.go:64-112) —

  Termination  a deleting claim whose node refuses to go away is stuck
  NodeShape    the registered node's capacity must be within 10% of what the
               claim promised (nodeshape.go:40); a mismatch means the cloud
               delivered the wrong shape and the scheduler's math is off

Violations surface as events plus the consistency-errors counter; nothing is
mutated.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.objects import Node
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY
from karpenter_tpu_torch.utils.clock import Clock

POLL_PERIOD_SECONDS = 600.0
STUCK_TERMINATION_SECONDS = 600.0
SHAPE_TOLERANCE = 0.10

CONSISTENCY_ERRORS = REGISTRY.counter(
    "consistency_errors_total", "Invariant violations observed",
    subsystem="nodeclaims",
)


class ConsistencyController:
    def __init__(self, kube: KubeClient, clock: Clock, recorder: Recorder):
        self.kube = kube
        self.clock = clock
        self.recorder = recorder

    def reconcile(self) -> int:
        violations = 0
        for claim in self.kube.list(NodeClaim):
            violations += self._check_termination(claim)
            violations += self._check_node_shape(claim)
        return violations

    def _check_termination(self, claim: NodeClaim) -> int:
        if claim.metadata.deletion_timestamp is None:
            return 0
        if self.clock.now() - claim.metadata.deletion_timestamp < STUCK_TERMINATION_SECONDS:
            return 0
        self.recorder.publish(
            object_event(
                claim, "Warning", "FailedConsistencyCheck",
                "nodeclaim has been deleting for over 10 minutes",
            )
        )
        CONSISTENCY_ERRORS.inc(labels={"check": "termination"})
        return 1

    def _check_node_shape(self, claim: NodeClaim) -> int:
        if not claim.is_initialized() or not claim.status.node_name:
            return 0
        node = self.kube.get_opt(Node, claim.status.node_name, "")
        if node is None:
            return 0
        for name, promised in claim.status.capacity.items():
            if promised <= 0:
                continue
            actual = node.status.capacity.get(name, 0.0)
            if actual < promised * (1.0 - SHAPE_TOLERANCE):
                self.recorder.publish(
                    object_event(
                        claim, "Warning", "FailedConsistencyCheck",
                        f"node capacity {name}={actual} is below the claimed "
                        f"{promised} by more than {int(SHAPE_TOLERANCE*100)}%",
                    )
                )
                CONSISTENCY_ERRORS.inc(labels={"check": "node_shape"})
                return 1
        return 0
