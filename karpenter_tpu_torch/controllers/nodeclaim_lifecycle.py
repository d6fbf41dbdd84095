"""NodeClaim lifecycle — launch, registration, initialization, liveness.

Equivalent of reference pkg/controllers/nodeclaim/lifecycle/: four chained
sub-reconcilers drive a NodeClaim from created to Initialized
(controller.go:79-124):

  Launch        cloud create; insufficient capacity deletes the claim so the
                scheduler retries elsewhere (launch.go:44-105)
  Registration  the kubelet's Node appears with our providerID; sync metadata
                and take ownership via the termination finalizer
                (registration.go:42-98)
  Initialization Node is Ready, startup taints cleared, extended resources
                registered (initialization.go:46-89)
  Liveness      claims that never register within 15 minutes are deleted
                (liveness.go)
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import INITIALIZED, LAUNCHED, NodeClaim, REGISTERED
from karpenter_tpu_torch.apis.objects import Node
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    CreateTimeoutError,
    InsufficientCapacityError,
    NodeClassNotReadyError,
    RateLimitError,
)
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient, NotFound
from karpenter_tpu_torch.metrics import REGISTRY
from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS
from karpenter_tpu_torch.utils.clock import Clock

REGISTRATION_TTL_SECONDS = 15 * 60.0  # liveness.go

CLAIMS_LAUNCHED = REGISTRY.counter(
    "launched_total", "NodeClaims launched", subsystem="nodeclaims"
)
CLAIMS_REGISTERED = REGISTRY.counter(
    "registered_total", "NodeClaims registered", subsystem="nodeclaims"
)
CLAIMS_INITIALIZED = REGISTRY.counter(
    "initialized_total", "NodeClaims initialized", subsystem="nodeclaims"
)
# metrics.go:111-121 — a Node registering under a claim counts as created
NODES_CREATED = REGISTRY.counter(
    "created_total", "Nodes created (registered)", subsystem="node"
)
CLAIMS_TERMINATED_LIVENESS = REGISTRY.counter(
    "terminated_liveness_total",
    "NodeClaims deleted for failing to register",
    subsystem="nodeclaims",
)
CLAIMS_LAUNCH_RETRIES = REGISTRY.counter(
    "launch_retries_total",
    "Create calls deferred for retry after a transient provider error",
    subsystem="nodeclaims",
)

# transient-Create backoff: base doubles per attempt, capped, plus
# deterministic jitter so a burst of throttled claims doesn't re-stampede
# the provider API on the same tick
LAUNCH_BACKOFF_BASE_SECONDS = 1.0
LAUNCH_BACKOFF_CAP_SECONDS = 60.0


class LifecycleController:
    def __init__(
        self, kube: KubeClient, cloud_provider: CloudProvider, clock: Clock,
        recorder: Recorder,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        # claim name -> (attempts, earliest next Create try)
        self._launch_backoff: dict = {}

    def reconcile_all(self) -> None:
        for claim in self.kube.list(NodeClaim):
            if claim.metadata.deletion_timestamp is not None:
                continue
            self.reconcile(claim)

    def reconcile(self, claim: NodeClaim) -> None:
        claim = self.kube.get_opt(NodeClaim, claim.metadata.name, "")
        if claim is None or claim.metadata.deletion_timestamp is not None:
            return
        # take ownership first (controller.go:84-92)
        if wk.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            self.kube.patch(
                claim, lambda c: c.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
            )
            claim = self.kube.get(NodeClaim, claim.metadata.name, "")
        for step in (self._launch, self._register, self._initialize, self._liveness):
            claim = self.kube.get_opt(NodeClaim, claim.metadata.name, "")
            if claim is None or claim.metadata.deletion_timestamp is not None:
                return
            step(claim)

    # -- launch (launch.go:44-105) --------------------------------------------

    def _launch(self, claim: NodeClaim) -> None:
        if claim.is_launched():
            self._launch_backoff.pop(claim.metadata.name, None)
            return
        attempts, next_try = self._launch_backoff.get(claim.metadata.name, (0, 0.0))
        if self.clock.now() < next_try:
            return
        try:
            launched = self.cloud_provider.create(claim)
        except (InsufficientCapacityError, NodeClassNotReadyError) as e:
            # ICE: delete the claim; the pods go back to pending and the next
            # scheduling pass avoids this shape (launch.go:81-88)
            self._launch_backoff.pop(claim.metadata.name, None)
            self.recorder.publish(
                object_event(claim, "Warning", "LaunchFailed", str(e))
            )
            self.kube.delete_opt(NodeClaim, claim.metadata.name, "")
            return
        except (RateLimitError, CreateTimeoutError) as e:
            # transient: keep the claim, retry the same Create with jittered
            # exponential backoff instead of immediately requeueing
            attempts += 1
            delay = min(
                LAUNCH_BACKOFF_BASE_SECONDS * 2.0 ** (attempts - 1),
                LAUNCH_BACKOFF_CAP_SECONDS,
            )
            import zlib

            frac = (
                zlib.crc32(f"{claim.metadata.name}:{attempts}".encode()) / 2**32
            )
            delay *= 0.5 + frac  # deterministic jitter in [0.5, 1.5)
            self._launch_backoff[claim.metadata.name] = (
                attempts, self.clock.now() + delay,
            )
            CLAIMS_LAUNCH_RETRIES.inc()
            self.recorder.publish(
                object_event(
                    claim, "Warning", "LaunchRetry",
                    f"{e}; retrying in {delay:.1f}s (attempt {attempts})",
                )
            )
            return
        self._launch_backoff.pop(claim.metadata.name, None)
        def apply(c):
            c.status.provider_id = launched.status.provider_id
            c.status.capacity = dict(launched.status.capacity)
            c.status.allocatable = dict(launched.status.allocatable)
            c.status.image_id = launched.status.image_id
            # cloud-resolved labels (instance type, zone, capacity type) fill
            # in under the claim's own labels (launch.go:98)
            c.metadata.labels = {**launched.metadata.labels, **c.metadata.labels}
            c.status.conditions.set_true(LAUNCHED, now=self.clock.now())
        self.kube.patch(claim, apply)
        CLAIMS_LAUNCHED.inc()

    # -- registration (registration.go:42-98) ---------------------------------

    def _find_node(self, provider_id: str) -> Optional[Node]:
        if not provider_id:
            return None
        matches = self.kube.list(
            Node, predicate=lambda n: n.spec.provider_id == provider_id
        )
        return matches[0] if len(matches) == 1 else None

    def _register(self, claim: NodeClaim) -> None:
        if not claim.is_launched() or claim.is_registered():
            return
        node = self._find_node(claim.status.provider_id)
        if node is None:
            return
        def apply_node(n):
            n.metadata.labels.update(claim.metadata.labels)
            n.metadata.labels[wk.NODE_REGISTERED_LABEL_KEY] = "true"
            n.metadata.annotations.update(claim.metadata.annotations)
            if wk.TERMINATION_FINALIZER not in n.metadata.finalizers:
                n.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
            # claim taints + startup taints flow onto the node once
            have = {(t.key, t.effect) for t in n.spec.taints}
            for t in list(claim.spec.taints) + list(claim.spec.startup_taints):
                if (t.key, t.effect) not in have:
                    n.spec.taints.append(t)
        self.kube.patch(node, apply_node)
        def apply_claim(c):
            c.status.node_name = node.metadata.name
            c.status.conditions.set_true(REGISTERED, now=self.clock.now())
        self.kube.patch(claim, apply_claim)
        CLAIMS_REGISTERED.inc()
        NODES_CREATED.inc(
            labels={"nodepool": claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")}
        )

    # -- initialization (initialization.go:46-89) -----------------------------

    def _initialize(self, claim: NodeClaim) -> None:
        if not claim.is_registered() or claim.is_initialized():
            return
        node = self.kube.get_opt(Node, claim.status.node_name, "")
        if node is None or not node.is_ready():
            return
        # startup taints must have been removed by their owners
        startup = list(claim.spec.startup_taints)
        for taint in node.spec.taints:
            if any(taint.match(s) for s in startup):
                return
            if any(taint.match(e) for e in KNOWN_EPHEMERAL_TAINTS):
                return
        # every resource the claim promised must be registered on the node
        for name, quantity in claim.status.allocatable.items():
            if quantity > 0 and node.status.allocatable.get(name, 0.0) <= 0:
                return
        self.kube.patch(
            node, lambda n: n.metadata.labels.__setitem__(
                wk.NODE_INITIALIZED_LABEL_KEY, "true"
            )
        )
        self.kube.patch(
            claim, lambda c: c.status.conditions.set_true(
                INITIALIZED, now=self.clock.now()
            )
        )
        CLAIMS_INITIALIZED.inc()

    # -- liveness -------------------------------------------------------------

    def _liveness(self, claim: NodeClaim) -> None:
        if claim.is_registered():
            return
        if claim.metadata.creation_timestamp is None:
            return
        age = self.clock.now() - claim.metadata.creation_timestamp
        if age < REGISTRATION_TTL_SECONDS:
            return
        self.recorder.publish(
            object_event(
                claim, "Warning", "FailedRegistration",
                f"did not register within {int(REGISTRATION_TTL_SECONDS)}s; deleting",
            )
        )
        CLAIMS_TERMINATED_LIVENESS.inc()
        self.kube.delete_opt(NodeClaim, claim.metadata.name, "")
