"""NodeClaim API type — one requested machine.

Equivalent of reference pkg/apis/v1beta1/{nodeclaim,nodeclaim_status}.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.conditions import ConditionSet
from karpenter_tpu_torch.apis.nodepool import NodeClaimSpec
from karpenter_tpu_torch.apis.objects import ObjectMeta

# condition types (nodeclaim_status.go:54-67)
LAUNCHED = "Launched"
REGISTERED = "Registered"
INITIALIZED = "Initialized"
EMPTY = "Empty"
DRIFTED = "Drifted"
EXPIRED = "Expired"

LIVING_CONDITIONS = [LAUNCHED, REGISTERED, INITIALIZED]


@dataclass
class NodeClaimStatus:
    node_name: str = ""
    provider_id: str = ""
    image_id: str = ""
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    conditions: ConditionSet = field(
        default_factory=lambda: ConditionSet(living=list(LIVING_CONDITIONS))
    )


@dataclass
class NodeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)

    @property
    def name(self):
        return self.metadata.name

    @property
    def nodepool_name(self) -> Optional[str]:
        return self.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)

    def is_launched(self) -> bool:
        return self.status.conditions.is_true(LAUNCHED)

    def is_registered(self) -> bool:
        return self.status.conditions.is_true(REGISTERED)

    def is_initialized(self) -> bool:
        return self.status.conditions.is_true(INITIALIZED)
