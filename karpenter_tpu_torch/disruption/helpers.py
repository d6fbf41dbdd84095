"""Disruption shared machinery (the JAX package's ``disruption/helpers.py``).

Equivalent of reference pkg/controllers/disruption/helpers.go: candidate
collection, the scheduling simulation every consolidation probe runs
(helpers.go:73-127), nodepool/instance-type maps, disruption budgets, and the
price filter with its spot rules (helpers.go:160-169, consolidation.go:163-188).
The screen's verdicts (disruption/batch.py) share the two price helpers with
the sequential path. The simulation solves through the provisioner's solver:
on the card, ``TorchSolver``'s kernels, one solve per probe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, InstanceType
from karpenter_tpu_torch.disruption.pdblimits import PDBLimits
from karpenter_tpu_torch.disruption.types import Candidate, IneligibleError, new_candidate
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.provisioning.provisioner import Provisioner, SchedulerInputs
from karpenter_tpu_torch.scheduling.requirements import Requirement, Requirements
from karpenter_tpu_torch.metrics.registry import measure
from karpenter_tpu_torch.obs import trace
from karpenter_tpu_torch.provisioning.provisioner import SCHEDULING_SIMULATION_DURATION  # noqa: F401 (re-exported)
from karpenter_tpu_torch.solver.backend import SolveResult
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils.clock import Clock


def build_nodepool_map(
    kube: KubeClient, cloud_provider: CloudProvider
) -> Tuple[Dict[str, NodePool], Dict[str, Dict[str, InstanceType]]]:
    """nodepool name -> NodePool, and name -> {instance type name -> IT}
    (helpers.go:195-222)."""
    nodepools: Dict[str, NodePool] = {}
    instance_types: Dict[str, Dict[str, InstanceType]] = {}
    for np_obj in kube.list(NodePool):
        if np_obj.metadata.deletion_timestamp is not None:
            continue
        try:
            its = cloud_provider.get_instance_types(np_obj)
        except Exception:
            continue
        if not its:
            continue
        nodepools[np_obj.name] = np_obj
        instance_types[np_obj.name] = {it.name: it for it in its}
    return nodepools, instance_types


def get_candidates(
    clock: Clock,
    kube: KubeClient,
    cluster: Cluster,
    cloud_provider: CloudProvider,
    should_disrupt,
    nodepool_map: Optional[Tuple[Dict[str, NodePool], Dict[str, Dict[str, InstanceType]]]] = None,
) -> List[Candidate]:
    """All eligible candidates passing the method's gate (helpers.go:180-192).
    Pass a prebuilt nodepool_map to avoid re-fetching the instance-type
    catalog once per method per pass."""
    nodepools, instance_types = (
        nodepool_map if nodepool_map is not None
        else build_nodepool_map(kube, cloud_provider)
    )
    pdb = PDBLimits(kube)
    out = []
    for sn in cluster.nodes():
        pods = []
        for key in sn.pod_keys():
            ns, name = key.split("/", 1)
            pod = kube.get_opt(Pod, name, ns)
            if pod is not None:
                pods.append(pod)
        try:
            candidate = new_candidate(
                clock, sn, pods, nodepools, instance_types,
                is_nominated=cluster.is_nominated(sn.name),
            )
        except IneligibleError:
            continue
        # PDB-blocked pods make the node undisruptable (types.go:90-96)
        ok, _reason = pdb.can_evict_pods(candidate.reschedulable_pods())
        if not ok:
            continue
        if should_disrupt(candidate):
            out.append(candidate)
    return out


def build_disruption_budget_mapping(
    clock: Clock, cluster: Cluster, nodepools: Dict[str, NodePool]
) -> Dict[str, int]:
    """Remaining allowed disruptions per nodepool this pass: the most
    restrictive active budget minus nodes already disrupting
    (disruption/helpers.go BuildDisruptionBudgets)."""
    totals: Dict[str, int] = {}
    disrupting: Dict[str, int] = {}
    for sn in cluster.nodes():
        pool = sn.nodepool_name
        if pool is None or pool not in nodepools:
            continue
        totals[pool] = totals.get(pool, 0) + 1
        if sn.marked_for_deletion():
            disrupting[pool] = disrupting.get(pool, 0) + 1
    out = {}
    for name, np_obj in nodepools.items():
        allowed = np_obj.get_allowed_disruptions(clock, totals.get(name, 0))
        out[name] = max(0, allowed - disrupting.get(name, 0))
    return out


@dataclass
class SimulationResults:
    """What one simulated re-schedule of the cluster-minus-candidates showed
    (helpers.go:73-127)."""

    result: SolveResult
    inputs: SchedulerInputs
    pods: List[Pod]
    # indices >= candidate_pod_start are candidate pods that MUST reschedule
    candidate_pod_start: int

    def all_candidate_pods_scheduled(self) -> bool:
        return all(
            pi < self.candidate_pod_start for pi in self.result.failures
        )

    def failed_candidate_pods(self) -> List[Pod]:
        return [
            self.pods[pi]
            for pi in self.result.failures
            if pi >= self.candidate_pod_start
        ]


def simulate_scheduling(
    provisioner: Provisioner, candidates: Sequence[Candidate]
) -> Optional[SimulationResults]:
    """Re-run the scheduler as if the candidates were gone: their pods join
    the pending set and their nodes leave the bin list (helpers.go:73-127,
    SimulationMode=true). Returns None when no NodePool can host anything."""
    candidate_names = {c.name for c in candidates}
    pending = provisioner.get_pending_pods()
    deleting = [
        p for p in provisioner.get_deleting_node_pods()
        # pods on candidates are added below; don't double-count when a
        # candidate was already marked deleting by an earlier command
        if p.spec.node_name not in candidate_names
    ]
    candidate_pods = [p for c in candidates for p in c.reschedulable_pods()]
    pods = pending + deleting + candidate_pods
    inputs = provisioner.build_inputs(pods)
    if inputs is None:
        return None
    inputs.nodes = [n for n in inputs.nodes if n.name not in candidate_names]
    with measure(SCHEDULING_SIMULATION_DURATION), \
            trace.cycle("disruption", candidates=len(candidates)):
        result = provisioner.solver.solve(
            inputs.pods,
            inputs.instance_types,
            inputs.templates,
            nodes=inputs.nodes,
            cluster_pods=inputs.cluster_pods,
            domains=inputs.domains,
            pod_volumes=inputs.pod_volumes,
        )
    # a delete assumes the candidate's pods move IMMEDIATELY; a placement on
    # a not-yet-initialized or not-Ready node can't honor that, so those pods
    # count as failures (helpers.go:116-124)
    state_by_name = {sn.name: sn for sn in provisioner.cluster.nodes()}
    for node_name in list(result.node_pods):
        sn = state_by_name.get(node_name)
        if sn is None:
            continue
        if not sn.initialized() or (sn.node is not None and not sn.node.is_ready()):
            for pi in result.node_pods.pop(node_name):
                result.failures[pi] = (
                    f"would schedule against a non-initialized node {node_name}"
                )
    return SimulationResults(
        result=result,
        inputs=inputs,
        pods=pods,
        candidate_pod_start=len(pending) + len(deleting),
    )


def candidate_total_price(candidates: Sequence[Candidate]) -> float:
    return sum(c.price for c in candidates)


def cheapest_existing_price_by_type(
    candidates: Sequence[Candidate],
) -> Dict[str, float]:
    """Cheapest current offering price per instance-type name among the
    candidates (multinodeconsolidation.go:160-172). Shared by the sequential
    filter below and the batched screen's verdict so the two paths can never
    desynchronize on the same-type rule."""
    prices: Dict[str, float] = {}
    for c in candidates:
        if c.instance_type is None:
            continue
        of = c.instance_type.offerings.get(c.capacity_type, c.zone)
        if of is None:
            continue
        prev = prices.get(c.instance_type.name)
        if prev is None or of.price < prev:
            prices[c.instance_type.name] = of.price
    return prices


def same_type_price_cap(
    replacement_names, existing_prices: Dict[str, float]
) -> float:
    """The maximum allowed replacement price once a type is shared between
    the replacement options and the deleted nodes (inf when none shared)."""
    return min(
        (existing_prices[n] for n in replacement_names if n in existing_prices),
        default=float("inf"),
    )


def filter_out_same_type(
    sim: SimulationResults, candidates: Sequence[Candidate]
) -> bool:
    """Multi-node churn guard (multinodeconsolidation.go:155-188): when the
    replacement's instance-type options include a type that one of the
    deleted nodes already is, replacing is only a win below that type's
    price — [2xlarge, 2xlarge, small] -> small is just deleting the two
    2xlarges with extra churn, so every option >= the small's price is
    dropped. The cap is the cheapest existing price among shared types;
    options are kept only when their cheapest compatible offering is
    strictly cheaper. Returns False when nothing survives (the command
    becomes a rejection, not a pointless replace)."""
    if not sim.result.new_claims:
        return True
    placement = sim.result.new_claims[0]
    max_price = same_type_price_cap(
        (sim.inputs.instance_types[i].name for i in placement.instance_type_indices),
        cheapest_existing_price_by_type(candidates),
    )
    if max_price == float("inf"):
        return True
    reqs = placement.requirements
    surviving = []
    for idx in placement.instance_type_indices:
        offerings = sim.inputs.instance_types[idx].offerings.available()
        if reqs is not None:
            offerings = offerings.requirements(reqs)
        cheapest = offerings.cheapest()
        if cheapest is not None and cheapest.price < max_price:
            surviving.append(idx)
    if not surviving:
        return False
    placement.instance_type_indices = surviving
    return True


def _replacement_capacity_types(sim, placement, surviving) -> set:
    """The capacity types the replacement claim could launch as: its explicit
    capacity-type requirement when concrete, else everything its surviving
    instance types offer (an undefined requirement admits any type) — the
    Requirements.Get(CapacityTypeLabelKey) read in consolidation.go:173-188."""
    reqs = placement.requirements
    if reqs is not None and reqs.has(wk.CAPACITY_TYPE_LABEL_KEY):
        r = reqs.get(wk.CAPACITY_TYPE_LABEL_KEY)
        if not r.complement:
            return set(r.values)
    cts = set()
    for idx in surviving:
        offerings = sim.inputs.instance_types[idx].offerings.available()
        if reqs is not None:
            offerings = offerings.requirements(reqs)
        cts |= {o.capacity_type for o in offerings}
    return cts


def filter_replacement_instance_types(
    sim: SimulationResults, candidates: Sequence[Candidate]
) -> bool:
    """Apply the consolidation price rules to the (single) replacement claim
    in the simulation result, in place (consolidation.go:150-190,
    helpers.go:235-258):

      - the replacement's viable instance types must be strictly cheaper than
        the current total price of the candidates (any capacity type);
      - spot -> spot churn guard: when every candidate is spot AND the
        replacement could launch as spot, consolidation aborts (availability
        of the cheaper spot type is not a reliable signal) — an on-demand
        replacement of spot nodes remains allowed;
      - when the replacement could be either spot or on-demand, it is PINNED
        to spot: the price filter assumed the spot price, and falling back to
        on-demand could launch something more expensive than what exists.

    Returns False when no instance type survives (consolidation aborts)."""
    if not sim.result.new_claims:
        return True
    if len(sim.result.new_claims) > 1:
        return False
    max_price = candidate_total_price(candidates)
    placement = sim.result.new_claims[0]
    reqs = placement.requirements
    surviving = []
    for idx in placement.instance_type_indices:
        it = sim.inputs.instance_types[idx]
        offerings = it.offerings.available()
        if reqs is not None:
            offerings = offerings.requirements(reqs)
        cheapest = offerings.cheapest()
        if cheapest is not None and cheapest.price < max_price:
            surviving.append(idx)
    if not surviving:
        return False
    placement.instance_type_indices = surviving

    cts = _replacement_capacity_types(sim, placement, surviving)
    all_spot = all(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in candidates)
    if all_spot and wk.CAPACITY_TYPE_SPOT in cts:
        return False
    if wk.CAPACITY_TYPE_SPOT in cts and wk.CAPACITY_TYPE_ON_DEMAND in cts:
        if placement.requirements is None:
            placement.requirements = Requirements()
        placement.requirements.add(
            Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_SPOT])
        )
    return True
