"""Provisioner — the singleton reconciler turning pending pods into NodeClaims.

Equivalent of reference pkg/controllers/provisioning/provisioner.go:
batch → state-sync gate → schedule (the solver) → create NodeClaims
(provisioner.go:114-137). The solve itself runs in a SolverBackend; this
layer assembles its tensor-free inputs — templates from NodePools, the merged
instance-type catalog, existing-node views from cluster state, the topology
domain universe — and turns placements back into API writes.

Port of the JAX package's ``provisioning/provisioner.py``. One deliberate
difference: with no ``solver`` given, the Provisioner solves on the card
through ``SupervisedSolver(TorchSolver(), fallback=OracleSolver())`` (the JAX
package builds an ``OracleSolver``); on a host without CUDA that raises, as
every entry point of this package does unless asked for the CPU. Callers
that want the CPU pass ``TorchSolver(device="cpu")`` (under a supervisor or
not).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool, order_by_weight
from karpenter_tpu_torch.apis.validation import validate_nodepool
from karpenter_tpu_torch.apis.objects import IN, ObjectMeta, OwnerReference, Pod
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, InstanceType, order_by_price
from karpenter_tpu_torch.events import Recorder, object_event
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.metrics import REGISTRY, measure
from karpenter_tpu_torch.scheduling.requirements import (
    Requirement,
    Requirements,
    label_requirements,
    pod_requirements,
)
from karpenter_tpu_torch.solver.backend import Placement, SolveResult, SolverBackend
from karpenter_tpu_torch.solver.encode import (
    NodeInfo,
    TemplateInfo,
    domains_from_instance_types,
    template_from_nodepool,
)
from karpenter_tpu_torch.provisioning.volumetopology import VolumeTopology
from karpenter_tpu_torch.scheduling.volumeusage import (
    VolumeResolver,
    VolumeUsage,
    node_volume_limits,
)
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.clock import Clock

# The reference caps each launched claim's instance-type requirement at the
# 100 cheapest (nodeclaimtemplate.go:55-81).
MAX_INSTANCE_TYPES_PER_CLAIM = 100

# metrics.go:30-41 — claims created, by owning pool
NODECLAIMS_CREATED = REGISTRY.counter(
    "created_total", "NodeClaims created", subsystem="nodeclaims"
)
SCHEDULING_DURATION = REGISTRY.histogram(
    "scheduling_duration_seconds",
    "Duration of one scheduling pass",
    subsystem="provisioner",
)

# Observed around every Solve — provisioning passes and disruption's
# simulated ones alike, like the reference's defer inside Scheduler.Solve
# (scheduling/scheduler.go:141, scheduling/metrics.go:29-40).
SCHEDULING_SIMULATION_DURATION = REGISTRY.histogram(
    "scheduling_simulation_duration_seconds",
    "Duration of scheduling simulations used for deprovisioning and provisioning",
    subsystem="provisioner",
)


@dataclass
class SchedulerInputs:
    """Everything one Solve needs, assembled host-side
    (provisioner.go:204-296)."""

    pods: List[Pod]
    instance_types: List[InstanceType]
    templates: List[TemplateInfo]
    nodes: List[NodeInfo]
    domains: Dict[str, set]
    cluster_pods: List[Tuple[Pod, Dict[str, str]]]
    nodepools: Dict[str, NodePool] = field(default_factory=dict)
    # resolved CSI volumes per pod (parallel to pods); None when no CSINode
    # publishes limits, so the volume path costs nothing
    pod_volumes: Optional[List[Dict[str, frozenset]]] = None


@dataclass
class ProvisioningPass:
    """What one reconcile produced — consumed by callers (and the test
    expectation DSL) that need placement detail beyond the created claims."""

    created: List[NodeClaim] = field(default_factory=list)
    result: Optional[SolveResult] = None
    inputs: Optional[SchedulerInputs] = None
    # claim name -> pod indices packed onto it (parallel to result.new_claims)
    claim_pods: Dict[str, List[int]] = field(default_factory=dict)


class ValidationError(Exception):
    pass


def validate_pod(pod: Pod) -> None:
    """The provisioner's pod admission checks (provisioner.go:411-489): the
    requirement surface must be well-formed before it reaches the solver."""
    for key, value in pod.spec.node_selector.items():
        reason = wk.is_restricted_label(key)
        if reason:
            raise ValidationError(f"node selector {key}: {reason}")
    # building requirements validates operators/values and raises on nonsense
    reqs = pod_requirements(pod)
    for key in reqs:
        reason = wk.is_restricted_label(key)
        if reason:
            raise ValidationError(f"requirement {key}: {reason}")
    aff = pod.spec.affinity
    if aff:
        for term_list in (
            (aff.pod_affinity.required if aff.pod_affinity else []),
            (aff.pod_anti_affinity.required if aff.pod_anti_affinity else []),
        ):
            for term in term_list:
                if not term.topology_key:
                    raise ValidationError("pod (anti)affinity term missing topologyKey")
    for cs in pod.spec.topology_spread_constraints:
        if not cs.topology_key:
            raise ValidationError("topology spread constraint missing topologyKey")
        if cs.max_skew < 1:
            raise ValidationError(f"maxSkew must be >= 1, got {cs.max_skew}")


def resolve_affinity_namespaces(kube: KubeClient, pod: Pod, universe=None):
    """Resolve each pod-(anti)affinity term's namespaceSelector into an
    explicit namespace list against the live Namespace objects, at the kube
    boundary — the solver core never needs an apiserver
    (topology.go buildNamespaceList: the term's namespaces list is UNIONED
    with the selector's matches; a non-nil empty selector matches ALL
    namespaces). ``universe`` memoizes the Namespace listing across the pods
    of one pass (cluster state is fixed within it); the possibly-updated
    universe is returned."""
    from karpenter_tpu_torch.apis.objects import Namespace

    aff = pod.spec.affinity
    if aff is None:
        return universe
    terms = []
    for src in (aff.pod_affinity, aff.pod_anti_affinity):
        if src is None:
            continue
        terms.extend(src.required)
        terms.extend(w.pod_affinity_term for w in src.preferred)
    if not any(t.namespace_selector is not None for t in terms):
        return universe
    if universe is None:
        universe = kube.list(Namespace)
    for term in terms:
        sel = term.namespace_selector
        if sel is None:
            continue
        resolved = set(term.namespaces)
        resolved |= {
            ns.metadata.name
            for ns in universe
            if sel.matches(ns.metadata.labels)
        }
        # a selector that matched NOTHING must stay unsatisfiable — an empty
        # list would read downstream as "the pod's own namespace"
        # (topology.py _namespace_list). "" is not a legal namespace name, so
        # no pod can ever match it.
        term.namespaces = sorted(resolved) if resolved else [""]
        term.namespace_selector = None
    return universe


def default_solver() -> SolverBackend:
    """The solver of a Provisioner built without one: the supervised solve on
    the card, with the host oracle as its fallback. Raises when CUDA is
    absent (there is no silent CPU solve)."""
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    return SupervisedSolver(TorchSolver(), fallback=OracleSolver())


class Provisioner:
    def __init__(
        self,
        kube: KubeClient,
        cloud_provider: CloudProvider,
        cluster: Cluster,
        clock: Clock,
        recorder: Recorder,
        solver: Optional[SolverBackend] = None,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.clock = clock
        self.recorder = recorder
        self.solver = solver if solver is not None else default_solver()
        self.volume_topology = VolumeTopology(kube)

    # -- pod gathering (provisioner.go:298-327) -------------------------------

    def get_pending_pods(self) -> List[Pod]:
        out = []
        for pod in self.kube.list(Pod, predicate=podutil.is_provisionable):
            try:
                validate_pod(pod)
                # storage that can never bind keeps the pod out of the solve
                # (provisioner.go:416 -> volumetopology.go:144-183); other
                # pods in the batch still provision
                self.volume_topology.validate_persistent_volume_claims(pod)
            except (ValidationError, ValueError) as e:
                self.recorder.publish(
                    object_event(pod, "Warning", "FailedValidation", str(e))
                )
                continue
            out.append(pod)
        return out

    def get_deleting_node_pods(self) -> List[Pod]:
        """Reschedulable pods on nodes being drained: the solver plans their
        replacement capacity alongside the pending pods
        (provisioner.go:313-321)."""
        out = []
        for sn in self.cluster.nodes():
            if not sn.marked_for_deletion():
                continue
            for key in sn.pod_keys():
                ns, name = key.split("/", 1)
                pod = self.kube.get_opt(Pod, name, ns)
                if pod is None or not podutil.is_reschedulable(pod):
                    continue
                try:
                    validate_pod(pod)
                except (ValidationError, ValueError) as e:
                    self.recorder.publish(
                        object_event(pod, "Warning", "FailedValidation", str(e))
                    )
                    continue
                out.append(pod)
        return out

    # -- scheduler input assembly (provisioner.go:204-296) --------------------

    def build_inputs(self, pods: Sequence[Pod]) -> Optional[SchedulerInputs]:
        # fold volume-implied topology into every pod entering the solve —
        # pending, drained-node, and consolidation-candidate pods alike
        # (provisioner.go:284 -> volumetopology.go:41)
        ns_universe = None
        for pod in pods:
            if pod.spec.volumes:
                self.volume_topology.inject(pod)
            ns_universe = resolve_affinity_namespaces(self.kube, pod, ns_universe)
        nodepools = [
            np
            for np in self.kube.list(NodePool)
            if np.metadata.deletion_timestamp is None
        ]
        nodepools = order_by_weight(nodepools)
        if not nodepools:
            return None

        daemon_pods = self.cluster.daemonset_pods()
        instance_types: List[InstanceType] = []
        templates: List[TemplateInfo] = []
        pools: Dict[str, NodePool] = {}
        for np_obj in nodepools:
            # RuntimeValidate: a malformed pool is skipped, not fatal
            # (provisioner.go:214-228)
            errors = validate_nodepool(np_obj)
            if errors:
                self.recorder.publish(
                    object_event(
                        np_obj, "Warning", "FailedValidation", "; ".join(errors)
                    )
                )
                continue
            try:
                its = self.cloud_provider.get_instance_types(np_obj)
            except Exception as e:  # skip the pool, keep the pass going
                self.recorder.publish(
                    object_event(np_obj, "Warning", "InstanceTypeResolutionFailed", str(e))
                )
                continue
            if not its:
                continue
            base = len(instance_types)
            instance_types.extend(its)
            tpl = template_from_nodepool(
                np_obj, its, range(base, base + len(its)), daemon_pods=daemon_pods
            )
            if np_obj.spec.limits:
                usage = np_obj.status.resources
                tpl.remaining_resources = res.positive_part(
                    res.subtract(np_obj.spec.limits, usage)
                )
            templates.append(tpl)
            pools[np_obj.name] = np_obj
        if not templates:
            return None

        from karpenter_tpu_torch.apis.objects import CSINode

        has_csi_limits = len(self.kube.list(CSINode)) > 0
        resolver = VolumeResolver(self.kube) if has_csi_limits else None
        bound_by_node: Dict[str, List[Pod]] = {}
        if has_csi_limits:
            # one LIST feeds every node's usage computation
            for p in self.kube.list(Pod):
                if p.spec.node_name and not podutil.is_terminal(p) \
                        and not podutil.is_terminating(p):
                    bound_by_node.setdefault(p.spec.node_name, []).append(p)
        its_by_name = {it.name: it for it in instance_types}
        # initialized nodes first, then by name (scheduler.go:311-322): in
        # consolidation simulations pods must prefer nodes whose capacity is
        # real over in-flight ones — the solver's first-fit picks the first
        # eligible bin, so the order IS the preference
        state_nodes = sorted(
            (sn for sn in self.cluster.nodes() if not sn.marked_for_deletion()),
            key=lambda sn: (not sn.initialized(), sn.name),
        )
        nodes = []
        for sn in state_nodes:
            nodes.append(
                self._node_info(sn, daemon_pods, its_by_name, resolver,
                                bound_by_node.get(sn.name, []))
            )

        domains = domains_from_instance_types(instance_types, templates)
        return SchedulerInputs(
            pods=list(pods),
            instance_types=instance_types,
            templates=templates,
            nodes=nodes,
            domains=domains,
            cluster_pods=self._cluster_pods(),
            nodepools=pools,
            pod_volumes=(
                [resolver.pod_volumes(p) for p in pods]
                if resolver is not None
                else None
            ),
        )

    def _node_info(
        self,
        sn: StateNode,
        daemon_pods: Sequence[Pod],
        its_by_name: Optional[Dict[str, InstanceType]] = None,
        resolver: Optional[VolumeResolver] = None,
        bound_pods: Sequence[Pod] = (),
    ) -> NodeInfo:
        labels = sn.labels()
        requirements = label_requirements(labels)
        requirements.add(Requirement(wk.LABEL_HOSTNAME, IN, [sn.name]))
        available = sn.available()
        if sn.node is None and sn.node_claim is not None:
            # in-flight claim (calculateExistingNodeClaims,
            # scheduler.go:287-322): the claim's spec requirements are richer
            # than its labels, and until the cloud fills status.allocatable we
            # reserve capacity from the cheapest instance type it can become —
            # otherwise the pods just planned onto it get provisioned twice
            claim = sn.node_claim
            requirements = Requirements.from_node_selector_requirements(
                *claim.spec.requirements
            )
            requirements.add(*label_requirements(claim.metadata.labels).values())
            requirements.add(Requirement(wk.LABEL_HOSTNAME, IN, [sn.name]))
            if not available and its_by_name:
                candidates = [
                    its_by_name[r]
                    for r in (
                        requirements.get(wk.LABEL_INSTANCE_TYPE_STABLE).sorted_values()
                        if requirements.has(wk.LABEL_INSTANCE_TYPE_STABLE)
                        else []
                    )
                    if r in its_by_name
                ]
                ordered = order_by_price(candidates, requirements)
                if ordered:
                    available = dict(ordered[0].allocatable())
        # in-flight nodes owe capacity to daemonsets that haven't landed yet
        # (existingnode.go:40-62)
        overhead: Dict[str, float] = {}
        if not sn.initialized():
            compat = []
            for dp in daemon_pods:
                if sn.taints().tolerates(dp):
                    continue
                if not requirements.is_compatible(
                    pod_requirements(dp), wk.WELL_KNOWN_LABELS
                ):
                    continue
                compat.append(dp)
            expected = res.requests_for_pods(*compat) if compat else {}
            overhead = res.positive_part(
                res.subtract(expected, sn.daemonset_request_total())
            )
        volume_used: Dict[str, int] = {}
        volume_limits: Dict[str, int] = {}
        if resolver is not None:
            volume_limits = node_volume_limits(self.kube, sn.name)
            if volume_limits:
                usage = VolumeUsage()
                for bound in bound_pods:
                    usage.add(resolver.pod_volumes(bound))
                volume_used = usage.counts()
        return NodeInfo(
            name=sn.name,
            requirements=requirements,
            taints=sn.taints(),
            available=available,
            daemon_overhead=overhead,
            host_ports=sn.host_ports(),
            volume_used=volume_used,
            volume_limits=volume_limits,
        )

    def _cluster_pods(self) -> List[Tuple[Pod, Dict[str, str]]]:
        node_labels = {sn.name: sn.labels() for sn in self.cluster.nodes()}
        pairs = []
        ns_universe = None
        for p in self.kube.list(Pod):
            if not p.spec.node_name:
                continue
            if podutil.is_terminal(p) or podutil.is_terminating(p):
                continue
            labels = node_labels.get(p.spec.node_name)
            if labels is not None:
                # existing pods' inverse anti-affinity terms need their
                # namespaceSelectors resolved too (buildNamespaceList runs
                # for census pods as well); the listing is a deep copy, so
                # the mutation is pass-local
                ns_universe = resolve_affinity_namespaces(self.kube, p, ns_universe)
                pairs.append((p, labels))
        return pairs

    # -- the pass (provisioner.go:114-137, 298-339) ---------------------------

    def schedule(self, pods: Sequence[Pod]) -> Tuple[SolveResult, Optional[SchedulerInputs]]:
        inputs = self.build_inputs(pods)
        if inputs is None:
            return SolveResult(failures={i: "no nodepools" for i in range(len(pods))}), None
        from karpenter_tpu_torch.obs import trace

        with measure(SCHEDULING_DURATION), measure(SCHEDULING_SIMULATION_DURATION), \
                trace.cycle("provision", pods=len(pods)):
            result = self.solver.solve(
                inputs.pods,
                inputs.instance_types,
                inputs.templates,
                nodes=inputs.nodes,
                topology=None,
                cluster_pods=inputs.cluster_pods,
                domains=inputs.domains,
                pod_volumes=inputs.pod_volumes,
            )
        return result, inputs

    def reconcile(self) -> ProvisioningPass:
        """One provisioning pass; returns what it produced."""
        if not self.cluster.synced():
            return ProvisioningPass()
        pods = self.get_pending_pods() + self.get_deleting_node_pods()
        if not pods:
            return ProvisioningPass()
        result, inputs = self.schedule(pods)
        if inputs is None:
            return ProvisioningPass(result=result)
        created, claim_pods = self.create_node_claims(result, inputs)
        # pods placed on existing capacity: nominate those nodes so
        # consolidation leaves them alone until the pods land
        for node_name, pod_indices in result.node_pods.items():
            self.cluster.nominate_node_for_pod(node_name)
            for pi in pod_indices:
                self.recorder.publish(
                    object_event(
                        inputs.pods[pi], "Normal", "Nominated",
                        f"should schedule on node {node_name}",
                    )
                )
        explain = getattr(result, "explain", None)
        for pi, reason in result.failures.items():
            # reference event text (scheduling/events.go:52-56) with the
            # per-criterion forensics rendered by solver/forensics.py
            message = f"Failed to schedule pod, {reason}"
            expl = explain.pods.get(pi) if explain is not None else None
            if expl is not None:
                # gate attribution prefix (obs/explain.py): the stable reason
                # plus its counterfactual hint lead the forensics string
                message = (
                    f"Failed to schedule pod [{expl.reason}: {expl.hint}], "
                    f"{reason}"
                )
            self.recorder.publish(
                object_event(
                    inputs.pods[pi], "Warning", "FailedScheduling", message,
                )
            )
        return ProvisioningPass(
            created=created, result=result, inputs=inputs, claim_pods=claim_pods
        )

    # -- claim creation (provisioner.go:141-154, 341-367) ---------------------

    def create_node_claims(
        self, result: SolveResult, inputs: SchedulerInputs
    ) -> Tuple[List[NodeClaim], Dict[str, List[int]]]:
        created = []
        claim_pods: Dict[str, List[int]] = {}
        for placement in result.new_claims:
            np_obj = inputs.nodepools.get(placement.nodepool_name)
            if np_obj is None:
                continue
            # re-check pool limits against live usage; the solver's
            # remaining_resources was a pessimistic snapshot
            if np_obj.spec.limits:
                usage = res.merge(np_obj.status.resources, placement.requests)
                exceeded = res.exceeded_by(np_obj.spec.limits, usage)
                if exceeded:
                    self.recorder.publish(
                        object_event(
                            np_obj, "Warning", "LimitExceeded",
                            f"cannot launch claim: limit exceeded for {exceeded}",
                        )
                    )
                    continue
            claim = self._to_node_claim(placement, inputs, np_obj)
            self.kube.create(claim)
            NODECLAIMS_CREATED.inc(labels={"nodepool": np_obj.name})
            created.append(claim)
            claim_pods[claim.metadata.name] = list(placement.pod_indices)
            for pi in placement.pod_indices:
                self.recorder.publish(
                    object_event(
                        inputs.pods[pi], "Normal", "Nominated",
                        f"should schedule on nodeclaim {claim.metadata.name}",
                    )
                )
        return created, claim_pods

    def _to_node_claim(
        self, placement: Placement, inputs: SchedulerInputs, np_obj: NodePool
    ) -> NodeClaim:
        """NodeClaimTemplate.ToNodeClaim (nodeclaimtemplate.go:55-81): claim
        requirements from the narrowed solve state, instance types capped at
        the 100 cheapest."""
        tpl = np_obj.spec.template
        reqs = (
            placement.requirements.copy()
            if placement.requirements is not None
            else Requirements()
        )
        its = [inputs.instance_types[i] for i in placement.instance_type_indices]
        ordered = order_by_price(its, reqs)[:MAX_INSTANCE_TYPES_PER_CLAIM]
        if ordered:
            reqs.add(
                Requirement(
                    wk.LABEL_INSTANCE_TYPE_STABLE, IN, [it.name for it in ordered]
                )
            )
        labels = {**tpl.labels, **reqs.labels(), wk.NODEPOOL_LABEL_KEY: np_obj.name}
        claim = NodeClaim(
            metadata=ObjectMeta(
                name=f"{np_obj.name}-{uuid.uuid4().hex[:8]}",
                namespace="",
                labels=labels,
                annotations={wk.NODEPOOL_HASH_ANNOTATION_KEY: np_obj.hash()},
                # the owning pool, as the reference stamps it
                # (nodeclaimtemplate.go ToNodeClaim OwnerReferences;
                # suite_test.go:1062-1079)
                owner_references=[
                    OwnerReference(
                        kind="NodePool", name=np_obj.name, controller=True
                    )
                ],
                # ages/TTLs are measured against the injected clock
                creation_timestamp=self.clock.now(),
            ),
        )
        claim.spec.requirements = reqs.to_node_selector_requirements()
        claim.spec.resource_requests = dict(placement.requests)
        claim.spec.taints = list(tpl.spec.taints)
        claim.spec.startup_taints = list(tpl.spec.startup_taints)
        claim.spec.kubelet = tpl.spec.kubelet
        claim.spec.node_class_ref = tpl.spec.node_class_ref
        return claim
