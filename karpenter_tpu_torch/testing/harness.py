"""Provisioning harness + expectation DSL.

Port of the JAX package's test harness (tests/harness.py), the equivalent of
the reference's envtest Environment plus pkg/test/expectations: an Env
bundles the in-memory kube store, fake clock, cluster cache, fake cloud
provider and a Provisioner; ``expect_provisioned`` drives a full
schedule → launch → register → bind cycle the way ExpectProvisioned +
ExpectMakeNodesReady + ExpectManualBinding do (expectations.go:242,375,460);
no kubelet or kube-scheduler runs here either. ``reconcile_disruption``
drives the disruption controller (disruption/controller.py) through its
two-phase validation TTL, and ``create_candidate_node`` makes the registered
node and claim pair every disruption scenario starts from.

``Env(solver=...)`` takes the Provisioner's solver; without one the
Provisioner builds its default, the supervised solve on the card
(provisioning/provisioner.default_solver), which raises on a host without
CUDA. On the CPU pass ``SupervisedSolver(TorchSolver(device="cpu",
well_known=FAKE_WELL_KNOWN_LABELS), fallback=OracleSolver())``; the
disruption controller's screens then run on the CPU too (they take the
solver's device).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.conditions import ConditionSet
from karpenter_tpu_torch.apis.nodeclaim import (
    INITIALIZED,
    LAUNCHED,
    LIVING_CONDITIONS,
    REGISTERED,
    NodeClaim,
    NodeClaimStatus,
)
from karpenter_tpu_torch.apis.nodepool import NodeClaimSpec
from karpenter_tpu_torch.apis.objects import Node, NodeCondition, NodeSpec, NodeStatus, ObjectMeta, Pod
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.kube import KubeClient
from karpenter_tpu_torch.provisioning.provisioner import Provisioner, ProvisioningPass
from karpenter_tpu_torch.solver.backend import SolverBackend
from karpenter_tpu_torch.state import Cluster
from karpenter_tpu_torch.state.informer import start_informers
from karpenter_tpu_torch.utils.clock import FakeClock


class Env:
    def __init__(self, solver: Optional[SolverBackend] = None):
        self.clock = FakeClock()
        self.kube = KubeClient(clock=self.clock)
        self.cluster = Cluster(self.kube, self.clock)
        start_informers(self.kube, self.cluster)
        self.recorder = Recorder(clock=self.clock)
        self.cloud_provider = FakeCloudProvider()
        self.provisioner = Provisioner(
            self.kube, self.cloud_provider, self.cluster, self.clock,
            self.recorder, solver=solver,
        )

    # -- expectations ---------------------------------------------------------

    def create(self, *objs):
        for o in objs:
            self.kube.create(o)

    def expect_provisioned(self, *pods: Pod) -> ProvisioningPass:
        """Create the pods (if new), run one provisioning pass, then fake the
        cloud + kubelet: launch every created claim, register a ready Node,
        and bind the claim's pods to it."""
        for p in pods:
            if self.kube.get_opt(Pod, p.metadata.name, p.metadata.namespace) is None:
                self.kube.create(p)
        pass_ = self.provisioner.reconcile()
        for claim in pass_.created:
            node = self.launch_and_register(claim)
            for pi in pass_.claim_pods[claim.metadata.name]:
                self.bind(pass_.inputs.pods[pi], node.metadata.name)
        for node_name, pod_indices in (pass_.result.node_pods if pass_.result else {}).items():
            for pi in pod_indices:
                self.bind(pass_.inputs.pods[pi], node_name)
        return pass_

    def launch_and_register(self, claim: NodeClaim, ready: bool = True) -> Node:
        """Fake CloudProvider.Create + kubelet registration for one claim."""
        launched = self.cloud_provider.create(claim)
        stored = self.kube.get(NodeClaim, claim.metadata.name, "")
        stored.status.provider_id = launched.status.provider_id
        stored.status.capacity = dict(launched.status.capacity)
        stored.status.allocatable = dict(launched.status.allocatable)
        stored.metadata.labels = dict(launched.metadata.labels)
        node_name = f"node-{claim.metadata.name}"
        stored.status.node_name = node_name
        stored.status.conditions.set_true("Launched")
        stored.status.conditions.set_true("Registered")
        stored.status.conditions.set_true("Initialized")
        self.kube.update(stored)
        node = Node(
            metadata=ObjectMeta(
                name=node_name,
                namespace="",
                labels={
                    **launched.metadata.labels,
                    wk.LABEL_HOSTNAME: node_name,
                    wk.NODE_REGISTERED_LABEL_KEY: "true",
                    wk.NODE_INITIALIZED_LABEL_KEY: "true",
                },
            ),
            spec=NodeSpec(provider_id=launched.status.provider_id,
                          taints=list(claim.spec.taints)),
            status=NodeStatus(
                capacity=dict(launched.status.capacity),
                allocatable=dict(launched.status.allocatable),
                conditions=[NodeCondition(type="Ready", status="True" if ready else "False")],
            ),
        )
        self.kube.create(node)
        return node

    def bind(self, pod: Pod, node_name: str) -> None:
        stored = self.kube.get(Pod, pod.metadata.name, pod.metadata.namespace)
        stored.spec.node_name = node_name
        stored.status.phase = "Running"
        self.kube.update(stored)

    # -- disruption -----------------------------------------------------------

    def reconcile_disruption(self):
        """Drive the controller through the two-phase consolidation TTL: the
        compute pass, the fake clock stepped past the validation TTL, the
        revalidation pass. Returns the executed command (or None), as the
        10 s singleton poll does against a real clock."""
        ctrl = self.disruption_controller()
        cmd = ctrl.reconcile()
        if cmd is None and ctrl.pending is not None:
            self.clock.step(ctrl.pending.method.validation_ttl + 0.1)
            cmd = ctrl.reconcile()
        return cmd

    def disruption_controller(self):
        """The Env's disruption controller, built on first use."""
        from karpenter_tpu_torch.disruption.controller import Controller

        if not hasattr(self, "_disruption"):
            self._disruption = Controller(
                self.kube, self.cluster, self.provisioner, self.cloud_provider,
                self.clock, self.recorder,
            )
        return self._disruption

    def create_candidate_node(
        self,
        name: str,
        nodepool: str = "default",
        it_name: str = "default-instance-type",
        zone: str = "test-zone-1",
        capacity_type: str = wk.CAPACITY_TYPE_ON_DEMAND,
        pods=(),
        conditions=(),
        creation_timestamp: Optional[float] = None,
    ):
        """A registered and initialized Node and NodeClaim pair of instance
        type ``it_name``, shaped like what the lifecycle produces, holding
        ``pods`` (bound and Running). Returns (node, claim)."""
        it = next(i for i in self.cloud_provider.get_instance_types(None) if i.name == it_name)
        labels = {
            wk.NODEPOOL_LABEL_KEY: nodepool,
            wk.LABEL_INSTANCE_TYPE_STABLE: it_name,
            wk.LABEL_TOPOLOGY_ZONE: zone,
            wk.CAPACITY_TYPE_LABEL_KEY: capacity_type,
        }
        provider_id = f"fake:///{name}"
        claim = NodeClaim(
            metadata=ObjectMeta(name=f"claim-{name}", namespace="", labels=dict(labels)),
            spec=NodeClaimSpec(),
            status=NodeClaimStatus(
                provider_id=provider_id, node_name=name, capacity=dict(it.capacity),
                allocatable=dict(it.allocatable()), conditions=ConditionSet(living=list(LIVING_CONDITIONS)),
            ),
        )
        for cond in (LAUNCHED, REGISTERED, INITIALIZED):
            claim.status.conditions.set_true(cond)
        if creation_timestamp is not None:
            claim.metadata.creation_timestamp = creation_timestamp
        for cond, when in conditions:
            claim.status.conditions.set_true(cond, now=when)
        self.kube.create(claim)
        # the fake cloud must know the instance exists: termination probes
        # CloudProvider.Get for vanished instances (controller.go:90-97)
        self.cloud_provider.created_nodeclaims[provider_id] = claim
        node = Node(
            metadata=ObjectMeta(name=name, namespace="", labels={
                **labels,
                wk.NODE_REGISTERED_LABEL_KEY: "true",
                wk.NODE_INITIALIZED_LABEL_KEY: "true",
                wk.LABEL_HOSTNAME: name,
            }),
            spec=NodeSpec(provider_id=provider_id),
            status=NodeStatus(capacity=dict(it.capacity), allocatable=dict(it.allocatable()),
                              conditions=[NodeCondition(type="Ready", status="True")]),
        )
        self.kube.create(node)
        for p in pods:
            p.spec.node_name = name
            p.status.phase = "Running"
            if self.kube.get_opt(Pod, p.metadata.name, p.metadata.namespace) is None:
                self.kube.create(p)
            else:
                self.kube.update(p)
        return node, claim

    # -- assertions -----------------------------------------------------------

    def expect_scheduled(self, pod: Pod) -> str:
        got = self.kube.get(Pod, pod.metadata.name, pod.metadata.namespace)
        assert got.spec.node_name, f"pod {pod.metadata.name} not scheduled"
        return got.spec.node_name

    def expect_not_scheduled(self, pod: Pod) -> None:
        got = self.kube.get(Pod, pod.metadata.name, pod.metadata.namespace)
        assert not got.spec.node_name, (
            f"pod {pod.metadata.name} unexpectedly on {got.spec.node_name}"
        )

    def node_of(self, pod: Pod) -> Optional[str]:
        got = self.kube.get(Pod, pod.metadata.name, pod.metadata.namespace)
        return got.spec.node_name or None

    def expect_skew(self, topology_key: str, namespace: str = "default",
                    label_selector: Optional[Dict[str, str]] = None) -> Dict[str, int]:
        """Domain -> pod count over bound pods (ExpectSkew,
        expectations.go:479)."""
        node_domain = {}
        for n in self.kube.list(Node):
            if topology_key in n.metadata.labels:
                node_domain[n.metadata.name] = n.metadata.labels[topology_key]
        counts: Dict[str, int] = {}
        for p in self.kube.list(Pod, namespace=namespace,
                                label_selector=label_selector):
            if not p.spec.node_name:
                continue
            domain = node_domain.get(p.spec.node_name)
            if domain is not None:
                counts[domain] = counts.get(domain, 0) + 1
        return counts

    def nodeclaims(self) -> List[NodeClaim]:
        return self.kube.list(NodeClaim)

    def nodes(self) -> List[Node]:
        return self.kube.list(Node)
