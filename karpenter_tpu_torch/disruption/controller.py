"""Disruption controller — one action per pass, methods in priority order
(the JAX package's ``disruption/controller.py``).

Equivalent of reference pkg/controllers/disruption/controller.go: the 10-second
singleton poll runs Expiration → Drift → Emptiness → EmptyNodeConsolidation →
MultiNodeConsolidation → SingleNodeConsolidation (controller.go:72-85), takes
the first method that produces a command, validates it, and executes: taint
the candidates, launch replacements, mark for deletion, and hand the command
to the orchestration queue (controller.go:142-213).

Each pass installs one ``ScreenSession`` (disruption/batch.py): the
consolidation methods' screens share one scorer, built on the device of the
provisioner's solver, and usually one ``runs_screen`` launch. An error of the
port's kernels or of the CUDA runtime in that screen propagates out of
``reconcile`` (disruption/consolidation.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.disruption.batch import ScreenSession
from karpenter_tpu_torch.disruption.consolidation import (
    EmptyNodeConsolidation,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_tpu_torch.disruption.helpers import (
    build_disruption_budget_mapping,
    build_nodepool_map,
    get_candidates,
)
from karpenter_tpu_torch.disruption.methods import Drift, Emptiness, Expiration
from karpenter_tpu_torch.disruption.orchestration import Queue, set_disruption_taint
from karpenter_tpu_torch.disruption.types import Command, DECISION_NONE
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY, measure
from karpenter_tpu_torch.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import disruption_taint
from karpenter_tpu_torch.utils.clock import Clock

POLL_PERIOD_SECONDS = 10.0  # controller.go:56

EVALUATION_DURATION = REGISTRY.histogram(
    "evaluation_duration_seconds",
    "Duration of one disruption evaluation pass",
    subsystem="disruption",
)
ELIGIBLE_NODES = REGISTRY.gauge(
    "eligible_nodes", "Eligible candidates at last pass",
    subsystem="disruption",
)


@dataclass
class PendingCommand:
    """A computed consolidation command waiting out its validation TTL.
    The reference blocks its singleton goroutine on the TTL
    (consolidation.go IsValid); here the controller parks the command and
    keeps reconciling — no wall-clock sleep ever happens inside a pass."""

    command: Command
    method: object
    computed_at: float


class Controller:
    def __init__(
        self,
        kube: KubeClient,
        cluster: Cluster,
        provisioner: Provisioner,
        cloud_provider: CloudProvider,
        clock: Clock,
        recorder: Recorder,
        queue: Optional[Queue] = None,
        drift_enabled: bool = True,
    ):
        self.kube = kube
        self.cluster = cluster
        self.provisioner = provisioner
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self.queue = queue if queue is not None else Queue(kube, cluster, clock, recorder)
        self.methods = [
            Expiration(provisioner, clock),
            Drift(provisioner, clock, enabled=drift_enabled),
            Emptiness(provisioner, clock),
            EmptyNodeConsolidation(provisioner, clock),
            MultiNodeConsolidation(provisioner, clock),
            SingleNodeConsolidation(provisioner, clock),
        ]
        self.pending: Optional[PendingCommand] = None

    def reconcile(self) -> Optional[Command]:
        """One pass: first method that produces a validated command wins
        (controller.go:97-171). Consolidation commands are two-phase: the
        first pass parks them as pending, a pass after the 15s validation TTL
        revalidates and executes — no pass ever blocks. Returns the executed
        command, if any."""
        if not self.cluster.synced():
            return None
        self._cleanup_orphaned_taints()
        self.queue.reconcile()
        if self.pending is not None:
            return self._resolve_pending()
        nodepool_map = build_nodepool_map(self.kube, self.cloud_provider)
        nodepools = nodepool_map[0]
        evaluated_consolidation = False
        # one shared screen per pass: Multi's prefix launch carries Single's
        # singleton probes, so the pass usually costs one runs_screen launch
        session = ScreenSession()
        for method in self.methods:
            method.screen_session = session
            if self._consolidated_gate(method):
                continue
            if isinstance(
                method,
                (EmptyNodeConsolidation, MultiNodeConsolidation, SingleNodeConsolidation),
            ):
                evaluated_consolidation = True
            candidates = get_candidates(
                self.clock, self.kube, self.cluster, self.cloud_provider,
                method.should_disrupt, nodepool_map=nodepool_map,
            )
            ELIGIBLE_NODES.set(len(candidates), labels={"method": method.method_name})
            if not candidates:
                continue
            budgets = build_disruption_budget_mapping(
                self.clock, self.cluster, nodepools
            )
            with measure(EVALUATION_DURATION, labels={"method": method.method_name}):
                command = method.compute_command(budgets, candidates)
            if command.decision == DECISION_NONE:
                continue
            if getattr(method, "validation_ttl", 0.0) > 0:
                # park for TTL revalidation; one action per pass still holds
                # because nothing else executes while a command is pending
                self.pending = PendingCommand(command, method, self.clock.now())
                return None
            if not method.validate(
                command, self.kube, self.cluster, self.cloud_provider
            ):
                continue
            self._execute(command)
            return command
        # remember a full no-op evaluation until state changes — but only when
        # the consolidation methods actually ran: re-marking on gated passes
        # would reset the 5-minute forced-revisit window forever
        if evaluated_consolidation:
            self.cluster.mark_consolidated()
        return None

    def _resolve_pending(self) -> Optional[Command]:
        """Validate-and-execute a parked command once its TTL has elapsed
        (validation.go:68-110 semantics without blocking the pass)."""
        pending = self.pending
        assert pending is not None
        if (
            self.clock.now() - pending.computed_at
            < pending.method.validation_ttl
        ):
            return None
        self.pending = None
        if pending.method.validate(
            pending.command, self.kube, self.cluster, self.cloud_provider
        ):
            self._execute(pending.command)
            return pending.command
        return None

    def _consolidated_gate(self, method) -> bool:
        """Consolidation methods skip evaluation while the cluster is in a
        known-consolidated state (cluster.go:299-325)."""
        is_consolidation = isinstance(
            method, (EmptyNodeConsolidation, MultiNodeConsolidation, SingleNodeConsolidation)
        )
        return is_consolidation and self.cluster.consolidated()

    def _cleanup_orphaned_taints(self) -> None:
        """A crash between taint and queue leaves nodes tainted with no
        in-flight command; untaint them (controller.go:106-118)."""
        taint = disruption_taint()
        for sn in self.cluster.nodes():
            if sn.node is None:
                continue
            if sn.marked_for_deletion() or self.queue.has_any(sn.provider_id):
                continue
            if any(t.match(taint) for t in sn.node.spec.taints):
                set_disruption_taint(self.kube, sn.name, add=False)

    def _execute(self, command: Command) -> None:
        """Taint → launch replacements → mark deleting → enqueue
        (controller.go:177-213)."""
        for c in command.candidates:
            set_disruption_taint(self.kube, c.name, add=True)
        for claim in command.replacements:
            self.kube.create(claim)
        self.cluster.mark_for_deletion(*[c.provider_id for c in command.candidates])
        self.queue.add(command)
        for c in command.candidates:
            if c.node_claim is not None:
                self.recorder.publish(
                    object_event(
                        c.node_claim, "Normal", "DisruptionLaunching",
                        f"{command.method}: disrupting node {c.name} "
                        f"({command.decision})",
                    )
                )
