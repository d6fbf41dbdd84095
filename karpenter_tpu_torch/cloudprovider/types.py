"""CloudProvider SPI.

Equivalent of reference pkg/cloudprovider/types.go: the pluggable seam each
cloud implements (Create/Delete/Get/List/GetInstanceTypes/IsDrifted/Name), the
InstanceType/Offering model that feeds the solver, and the typed errors that
drive lifecycle retry/delete decisions.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool
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

    def cheapest(self) -> Optional[Offering]:
        return min(self, key=lambda o: o.price) if self else None


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


def order_by_price(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> List[InstanceType]:
    """Cheapest compatible-offering first, name tiebreak (types.go:62-79)."""

    def price_of(it: InstanceType) -> float:
        compatible = it.offerings.available().requirements(reqs)
        cheapest = compatible.cheapest()
        return cheapest.price if cheapest else math.inf

    return sorted(instance_types, key=lambda it: (price_of(it), it.name))


# -- typed errors (types.go:169-256) -----------------------------------------


class CloudProviderError(Exception):
    pass


class NodeClaimNotFoundError(CloudProviderError):
    """The machine behind a NodeClaim no longer exists."""


class InsufficientCapacityError(CloudProviderError):
    """Launch failed for lack of capacity (ICE); the claim is deleted and
    scheduling retries elsewhere (lifecycle/launch.go:80-96)."""


class NodeClassNotReadyError(CloudProviderError):
    """The referenced NodeClass is not fully resolved yet."""


class RateLimitError(CloudProviderError):
    """The provider API throttled the call. Transient: the lifecycle
    controller retries the same claim with jittered exponential backoff
    rather than deleting it."""


class CreateTimeoutError(CloudProviderError):
    """The Create call timed out at the provider. Transient, same backoff
    treatment as RateLimitError."""


class CloudProvider(abc.ABC):
    """The SPI every cloud implements (types.go:38-58)."""

    @abc.abstractmethod
    def create(self, node_claim: NodeClaim) -> NodeClaim:
        """Launch a machine for the claim; returns a hydrated claim with
        resolved labels, provider id, and capacity."""

    @abc.abstractmethod
    def delete(self, node_claim: NodeClaim) -> None:
        """Terminate the machine behind the claim."""

    @abc.abstractmethod
    def get(self, provider_id: str) -> NodeClaim:
        """Fetch one machine by provider id."""

    @abc.abstractmethod
    def list(self) -> List[NodeClaim]:
        """All machines owned by the framework."""

    @abc.abstractmethod
    def get_instance_types(self, nodepool: Optional[NodePool]) -> List[InstanceType]:
        """All instance types (including currently-unavailable offerings)."""

    @abc.abstractmethod
    def is_drifted(self, node_claim: NodeClaim) -> str:
        """Non-empty drift reason if the machine no longer matches its
        provisioning requirements."""

    @abc.abstractmethod
    def name(self) -> str:
        ...
