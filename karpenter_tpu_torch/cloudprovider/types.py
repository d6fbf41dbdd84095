"""Instance types and offerings.

Equivalent of the InstanceType/Offering model of reference
pkg/cloudprovider/types.go, which feeds the solver. The CloudProvider SPI
itself (create/delete/get/list/drift) is not part of the solve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.utils import resources as res


@dataclass(frozen=True)
class Offering:
    """(capacityType, zone, price, available) (types.go:127-134)."""

    capacity_type: str
    zone: str
    price: float
    available: bool = True


class Offerings(list):
    """Decorated list of Offering (types.go:136-166)."""

    def get(self, capacity_type: str, zone: str) -> Optional[Offering]:
        for o in self:
            if o.capacity_type == capacity_type and o.zone == zone:
                return o
        return None

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def requirements(self, reqs: Requirements) -> "Offerings":
        """Offerings compatible with zone / capacity-type requirements
        (types.go:154-159)."""
        return Offerings(
            o
            for o in self
            if (not reqs.has(wk.LABEL_TOPOLOGY_ZONE) or reqs.get(wk.LABEL_TOPOLOGY_ZONE).has(o.zone))
            and (
                not reqs.has(wk.CAPACITY_TYPE_LABEL_KEY)
                or reqs.get(wk.CAPACITY_TYPE_LABEL_KEY).has(o.capacity_type)
            )
        )


@dataclass
class InstanceTypeOverhead:
    """Reserved capacity outside k8s (types.go:112-123)."""

    kube_reserved: Dict[str, float] = field(default_factory=dict)
    system_reserved: Dict[str, float] = field(default_factory=dict)
    eviction_threshold: Dict[str, float] = field(default_factory=dict)

    def total(self) -> Dict[str, float]:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


class InstanceType:
    """A potential node shape: capacity, requirement set (one per well-known
    label at minimum), and offerings (types.go:83-110)."""

    __slots__ = ("name", "requirements", "offerings", "capacity", "overhead", "_allocatable")

    def __init__(
        self,
        name: str,
        requirements: Requirements,
        offerings: Sequence[Offering],
        capacity: Dict[str, float],
        overhead: Optional[InstanceTypeOverhead] = None,
    ):
        self.name = name
        self.requirements = requirements
        self.offerings = Offerings(offerings)
        self.capacity = capacity
        self.overhead = overhead or InstanceTypeOverhead()
        self._allocatable: Optional[Dict[str, float]] = None

    def allocatable(self) -> Dict[str, float]:
        """capacity - overhead, cached (types.go:101-110)."""
        if self._allocatable is None:
            self._allocatable = res.subtract(self.capacity, self.overhead.total())
        return self._allocatable

    def __repr__(self):
        return f"InstanceType({self.name})"

