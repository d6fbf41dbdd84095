"""In-memory CloudProvider for tests and benchmarks.

Equivalent of reference pkg/cloudprovider/fake/{cloudprovider,instancetype}.go —
the test substrate everything downstream builds on: a provider whose Create
picks the cheapest compatible instance type, plus deterministic instance-type
catalog generators.
"""

from __future__ import annotations

import itertools
import math
import uuid
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.labels import (
    CAPACITY_TYPE_ON_DEMAND,
    CAPACITY_TYPE_SPOT,
)
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim, NodeClaimStatus
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import DOES_NOT_EXIST, IN, ObjectMeta
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InstanceTypeOverhead,
    NodeClaimNotFoundError,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling import Requirement, Requirements
from karpenter_tpu_torch.utils import resources as res

# extra label keys the fake catalog exposes (fake/instancetype.go:34-40); they
# are treated as well-known for compatibility purposes in tests
LABEL_INSTANCE_SIZE = "size"
EXOTIC_INSTANCE_LABEL_KEY = "special"
INTEGER_INSTANCE_LABEL_KEY = "integer"
RESOURCE_GPU_VENDOR_A = "fake.com/vendor-a"
RESOURCE_GPU_VENDOR_B = "fake.com/vendor-b"

FAKE_WELL_KNOWN_LABELS = frozenset(
    wk.WELL_KNOWN_LABELS
    | {LABEL_INSTANCE_SIZE, EXOTIC_INSTANCE_LABEL_KEY, INTEGER_INSTANCE_LABEL_KEY}
)

GI = 1024.0**3


def price_from_resources(resources: Dict[str, float]) -> float:
    """Simple capacity-proportional price (fake/instancetype.go:176-189)."""
    price = 0.0
    for name, value in resources.items():
        if name == res.CPU:
            price += 0.1 * value
        elif name == res.MEMORY:
            price += 0.1 * value / 1e9
        elif name in (RESOURCE_GPU_VENDOR_A, RESOURCE_GPU_VENDOR_B):
            price += 1.0
    return price


def make_instance_type(
    name: str,
    resources: Optional[Dict[str, float]] = None,
    offerings: Optional[Sequence[Offering]] = None,
    architecture: str = "amd64",
    operating_systems: Sequence[str] = ("linux", "windows", "darwin"),
) -> InstanceType:
    """Build one fake instance type with defaulted capacity (4cpu/4Gi/5pods)
    and a 5-offering spread over 3 zones (fake/instancetype.go:50-107)."""
    resources = dict(resources or {})
    resources.setdefault(res.CPU, 4.0)
    resources.setdefault(res.MEMORY, 4 * GI)
    resources.setdefault(res.PODS, 5.0)
    price = price_from_resources(resources)
    if offerings is None:
        offerings = [
            Offering(CAPACITY_TYPE_SPOT, "test-zone-1", price, True),
            Offering(CAPACITY_TYPE_SPOT, "test-zone-2", price, True),
            Offering(CAPACITY_TYPE_ON_DEMAND, "test-zone-1", price, True),
            Offering(CAPACITY_TYPE_ON_DEMAND, "test-zone-2", price, True),
            Offering(CAPACITY_TYPE_ON_DEMAND, "test-zone-3", price, True),
        ]
    offerings = Offerings(offerings)
    available = offerings.available()
    requirements = Requirements(
        Requirement(wk.LABEL_INSTANCE_TYPE_STABLE, IN, [name]),
        Requirement(wk.LABEL_ARCH_STABLE, IN, [architecture]),
        Requirement(wk.LABEL_OS_STABLE, IN, list(operating_systems)),
        Requirement(wk.LABEL_TOPOLOGY_ZONE, IN, [o.zone for o in available]),
        Requirement(wk.CAPACITY_TYPE_LABEL_KEY, IN, [o.capacity_type for o in available]),
        Requirement(INTEGER_INSTANCE_LABEL_KEY, IN, [str(int(resources[res.CPU]))]),
    )
    if resources[res.CPU] > 4 and resources[res.MEMORY] > 8 * GI:
        requirements.add(Requirement(LABEL_INSTANCE_SIZE, IN, ["large"]))
        requirements.add(Requirement(EXOTIC_INSTANCE_LABEL_KEY, IN, ["optional"]))
    else:
        requirements.add(Requirement(LABEL_INSTANCE_SIZE, IN, ["small"]))
        requirements.add(Requirement(EXOTIC_INSTANCE_LABEL_KEY, DOES_NOT_EXIST))
    return InstanceType(
        name=name,
        requirements=requirements,
        offerings=offerings,
        capacity=resources,
        overhead=InstanceTypeOverhead(
            kube_reserved={res.CPU: 0.1, res.MEMORY: 10 * 1024.0**2}
        ),
    )


def instance_types(total: int) -> List[InstanceType]:
    """Incrementing catalog: i+1 vcpu, 2(i+1)Gi, 10(i+1) pods
    (fake/instancetype.go:153-166)."""
    return [
        make_instance_type(
            f"fake-it-{i}",
            resources={
                res.CPU: float(i + 1),
                res.MEMORY: (i + 1) * 2 * GI,
                res.PODS: float((i + 1) * 10),
            },
        )
        for i in range(total)
    ]


def instance_types_assorted() -> List[InstanceType]:
    """Cross product over cpu × mem × zone × capacity-type × os × arch, one
    offering each (fake/instancetype.go:111-145)."""
    out = []
    for cpu, mem, zone, ct, os_, arch in itertools.product(
        [1, 2, 4, 8, 16, 32, 64],
        [1, 2, 4, 8, 16, 32, 64, 128],
        ["test-zone-1", "test-zone-2", "test-zone-3"],
        [CAPACITY_TYPE_SPOT, CAPACITY_TYPE_ON_DEMAND],
        ["linux", "windows"],
        ["amd64", "arm64"],
    ):
        resources = {res.CPU: float(cpu), res.MEMORY: mem * GI}
        out.append(
            make_instance_type(
                f"{cpu}-cpu-{mem}-mem-{arch}-{os_}-{zone}-{ct}",
                resources=resources,
                offerings=[Offering(ct, zone, price_from_resources(resources), True)],
                architecture=arch,
                operating_systems=[os_],
            )
        )
    return out


def default_instance_types() -> List[InstanceType]:
    """The provider's built-in 6-type catalog (fake/cloudprovider.go:177-215)."""
    return [
        make_instance_type("default-instance-type"),
        make_instance_type(
            "small-instance-type", resources={res.CPU: 2.0, res.MEMORY: 2 * GI}
        ),
        make_instance_type(
            "gpu-vendor-instance-type", resources={RESOURCE_GPU_VENDOR_A: 2.0}
        ),
        make_instance_type(
            "gpu-vendor-b-instance-type", resources={RESOURCE_GPU_VENDOR_B: 2.0}
        ),
        make_instance_type(
            "arm-instance-type",
            resources={res.CPU: 16.0, res.MEMORY: 128 * GI},
            architecture="arm64",
            operating_systems=["ios", "linux", "windows", "darwin"],
        ),
        make_instance_type("single-pod-instance-type", resources={res.PODS: 1.0}),
    ]


def random_provider_id() -> str:
    return f"fake:///{uuid.uuid4()}"


class FakeCloudProvider(CloudProvider):
    """Launches are bookkeeping: Create picks the cheapest instance type
    compatible with the claim's requirements/requests and fabricates a
    provider id (fake/cloudprovider.go:82-143). Error knobs
    (next_create_error, allowed_create_calls, errors_for_nodepool) drive
    fault-injection in tests."""

    def __init__(self):
        self.instance_types: Optional[List[InstanceType]] = None
        self.instance_types_for_nodepool: Dict[str, List[InstanceType]] = {}
        self.errors_for_nodepool: Dict[str, Exception] = {}
        self.create_calls: List[NodeClaim] = []
        self.delete_calls: List[NodeClaim] = []
        self.allowed_create_calls: int = 2**31
        self.next_create_error: Optional[Exception] = None
        self.created_nodeclaims: Dict[str, NodeClaim] = {}
        self.drifted: str = "drifted"
        # per-instance fault injector (testing/faults.py); None falls through
        # to the ambient/env-installed one so KARPENTER_TPU_FAULTS reaches
        # the provider without test plumbing
        self.fault_injector = None

    def reset(self):
        self.__init__()

    def _draw_fault(self, site: str):
        from karpenter_tpu_torch.testing import faults

        injector = (
            self.fault_injector if self.fault_injector is not None else faults.active()
        )
        if injector is None:
            return
        rule = injector.draw(site)
        if rule is not None:
            raise faults.cloud_exception(rule)

    # -- SPI ------------------------------------------------------------------

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        if self.next_create_error is not None:
            err, self.next_create_error = self.next_create_error, None
            raise err
        self._draw_fault("create")
        self.create_calls.append(node_claim)
        if len(self.create_calls) > self.allowed_create_calls:
            raise RuntimeError("number of allowed create calls exceeded")

        reqs = Requirements.from_node_selector_requirements(*node_claim.spec.requirements)
        nodepool = NodePool(metadata=ObjectMeta(name=node_claim.nodepool_name or ""))
        candidates = [
            it
            for it in self.get_instance_types(nodepool)
            if reqs.is_compatible(it.requirements, FAKE_WELL_KNOWN_LABELS)
            and len(it.offerings.requirements(reqs).available()) > 0
            and res.fits(node_claim.spec.resource_requests, it.allocatable())
        ]
        if not candidates:
            raise RuntimeError(f"no compatible instance type for claim {node_claim.name}")
        candidates.sort(
            key=lambda it: it.offerings.available().requirements(reqs).cheapest().price
        )
        instance_type = candidates[0]

        labels = {}
        for key in instance_type.requirements:
            requirement = instance_type.requirements.get(key)
            if requirement.operator() == IN:
                labels[key] = requirement.sorted_values()[0]
        for o in instance_type.offerings.available():
            offering_reqs = Requirements(
                Requirement(wk.LABEL_TOPOLOGY_ZONE, IN, [o.zone]),
                Requirement(wk.CAPACITY_TYPE_LABEL_KEY, IN, [o.capacity_type]),
            )
            if reqs.is_compatible(offering_reqs, FAKE_WELL_KNOWN_LABELS):
                labels[wk.LABEL_TOPOLOGY_ZONE] = o.zone
                labels[wk.CAPACITY_TYPE_LABEL_KEY] = o.capacity_type
                break

        created = NodeClaim(
            metadata=ObjectMeta(
                name=node_claim.name,
                labels={**labels, **node_claim.metadata.labels},
                annotations=dict(node_claim.metadata.annotations),
            ),
            spec=node_claim.spec,
            status=NodeClaimStatus(
                provider_id=random_provider_id(),
                capacity=res.positive_part(instance_type.capacity),
                allocatable=res.positive_part(instance_type.allocatable()),
            ),
        )
        self.created_nodeclaims[created.status.provider_id] = created
        return created

    def get(self, provider_id: str) -> NodeClaim:
        if provider_id in self.created_nodeclaims:
            return self.created_nodeclaims[provider_id]
        raise NodeClaimNotFoundError(f"no nodeclaim exists with id {provider_id!r}")

    def list(self) -> List[NodeClaim]:
        return list(self.created_nodeclaims.values())

    def get_instance_types(self, nodepool: Optional[NodePool]) -> List[InstanceType]:
        if nodepool is not None:
            if nodepool.name in self.errors_for_nodepool:
                raise self.errors_for_nodepool[nodepool.name]
            if nodepool.name in self.instance_types_for_nodepool:
                return self.instance_types_for_nodepool[nodepool.name]
        if self.instance_types is not None:
            return self.instance_types
        return default_instance_types()

    def delete(self, node_claim: NodeClaim) -> None:
        self._draw_fault("delete")
        self.delete_calls.append(node_claim)
        if node_claim.status.provider_id in self.created_nodeclaims:
            del self.created_nodeclaims[node_claim.status.provider_id]
            return
        raise NodeClaimNotFoundError(
            f"no nodeclaim exists with provider id {node_claim.status.provider_id!r}"
        )

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted

    def name(self) -> str:
        return "fake"
