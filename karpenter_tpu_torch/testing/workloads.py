"""Seeded workload generators for the port's tests and ``chip_smoke.py``.

They draw the same populations as the JAX package's bench and parity suites
(``bench.make_diverse_pods``; tests/test_solver_parity.py and
tests/test_chain_parity.py generators) from the same ``random.Random``
sequence, built from this package's own API types so the card's machine
needs nothing of the JAX package.
"""

from __future__ import annotations

import random
from typing import List, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodepool import (
    NodeClaimSpec,
    NodeClaimTemplateSpec,
    NodePool,
    NodePoolSpec,
)
from karpenter_tpu_torch.apis.objects import (
    DO_NOT_SCHEDULE,
    GT,
    LT,
    NOT_IN,
    SCHEDULE_ANYWAY,
    Affinity,
    Container,
    ContainerPort,
    LabelSelector,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from karpenter_tpu_torch.cloudprovider.fake import GI, instance_types, make_instance_type
from karpenter_tpu_torch.scheduling import Requirements, Taints
from karpenter_tpu_torch.solver.encode import NodeInfo, TemplateInfo, template_from_nodepool
from karpenter_tpu_torch.utils import resources as res

ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


def make_pod(i, cpu=0.5, mem=1e8, selector=None, tolerations=None, requirements=None) -> Pod:
    """``requirements``: [(key, op, values), ...] become a required
    node-affinity term."""
    affinity = None
    if requirements:
        affinity = Affinity(
            node_affinity=NodeAffinity(
                required=[NodeSelectorTerm([NodeSelectorRequirement(*r) for r in requirements])]
            )
        )
    return Pod(
        metadata=ObjectMeta(name=f"p{i}"),
        spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": mem})],
            node_selector=selector or {},
            tolerations=tolerations or [],
            affinity=affinity,
        ),
    )


def simple_template(its, name="pool", taints=None, labels=None, requirements=None) -> TemplateInfo:
    pool = NodePool(
        metadata=ObjectMeta(name=name),
        spec=NodePoolSpec(
            template=NodeClaimTemplateSpec(
                labels=labels or {},
                spec=NodeClaimSpec(taints=taints or [], requirements=requirements or []),
            )
        ),
    )
    return template_from_nodepool(pool, its, range(len(its)))


def make_node(name, cpu=8.0, labels=None, taints=None, zone="test-zone-1") -> NodeInfo:
    reqs = Requirements.from_labels(
        {
            **(labels or {}),
            wk.LABEL_HOSTNAME: name,
            wk.LABEL_TOPOLOGY_ZONE: zone,
            wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
        }
    )
    return NodeInfo(
        name=name,
        requirements=reqs,
        taints=Taints(taints or []),
        available={res.CPU: cpu, res.MEMORY: 16 * GI, res.PODS: 100.0},
        daemon_overhead={},
    )


Workload = Tuple[List[Pod], list, List[TemplateInfo], List[NodeInfo]]


def make_diverse_pods(count: int, rng: random.Random, ns: str = "") -> List[Pod]:
    """The reference's makeDiversePods mix (scheduling_benchmark_test.go):
    1/7 each of generic, zone spread, hostname spread, hostname affinity and
    zone affinity, the rest generic — ``bench.make_diverse_pods`` draw for
    draw."""

    def random_cpu():
        return rng.choice([0.1, 0.25, 0.5, 1.0, 1.5])

    def random_memory():
        return rng.choice([100, 256, 512, 1024, 2048, 4096]) * 1024.0**2

    def random_labels():
        return {"my-label": ns + rng.choice("abcdefg")}

    def random_affinity_labels():
        return {"my-affininity": ns + rng.choice("abcdefg")}

    def container():
        return Container(requests={"cpu": random_cpu(), "memory": random_memory()})

    def generic(i):
        return Pod(
            metadata=ObjectMeta(name=f"pod-{ns}{i}", labels=random_labels()),
            spec=PodSpec(containers=[container()]),
        )

    def spread(i, key):
        return Pod(
            metadata=ObjectMeta(name=f"pod-{ns}{i}", labels=random_labels()),
            spec=PodSpec(
                containers=[container()],
                topology_spread_constraints=[
                    TopologySpreadConstraint(
                        max_skew=1,
                        topology_key=key,
                        when_unsatisfiable=DO_NOT_SCHEDULE,
                        label_selector=LabelSelector(match_labels=random_labels()),
                    )
                ],
            ),
        )

    def affine(i, key):
        return Pod(
            metadata=ObjectMeta(name=f"pod-{ns}{i}", labels=random_affinity_labels()),
            spec=PodSpec(
                containers=[container()],
                affinity=Affinity(
                    pod_affinity=PodAffinity(
                        required=[
                            PodAffinityTerm(
                                topology_key=key,
                                label_selector=LabelSelector(match_labels=random_affinity_labels()),
                            )
                        ]
                    )
                ),
            ),
        )

    pods: List[Pod] = []
    n = count // 7
    pods += [generic(i) for i in range(n)]
    pods += [spread(len(pods) + i, wk.LABEL_TOPOLOGY_ZONE) for i in range(n)]
    pods += [spread(len(pods) + i, wk.LABEL_HOSTNAME) for i in range(n)]
    pods += [affine(len(pods) + i, wk.LABEL_HOSTNAME) for i in range(n)]
    pods += [affine(len(pods) + i, wk.LABEL_TOPOLOGY_ZONE) for i in range(n)]
    pods += [generic(len(pods) + i) for i in range(count - len(pods))]
    return pods


def make_fleet_pods(count: int, rng: random.Random, neighborhoods: int = 32,
                    constrained_frac: float = 0.15) -> List[Pod]:
    """The fleet-scale corpus (``bench.make_fleet_pods``, draw for draw): the
    diverse constrained mix replicated across ``neighborhoods`` independent
    label namespaces, plus a bulk of unconstrained service pods, shuffled.
    Most pods carry no topology constraint, and the constrained ones scope
    to their own namespace's alphabet: the independence the partitioned
    solve exploits."""
    constrained = int(count * constrained_frac)
    pods: List[Pod] = []
    base = max(constrained // max(neighborhoods, 1), 1)
    nb = 0
    while len(pods) < constrained:
        n = min(base, constrained - len(pods)) if nb < neighborhoods - 1 else constrained - len(pods)
        pods += make_diverse_pods(n, rng, ns=f"t{nb}-")
        nb += 1
    while len(pods) < count:
        pods.append(Pod(
            metadata=ObjectMeta(name=f"pod-bulk-{len(pods)}", labels={"app": f"svc-{rng.randrange(64)}"}),
            spec=PodSpec(containers=[Container(requests={
                "cpu": rng.choice([0.1, 0.25, 0.5, 1.0]),
                "memory": rng.choice([128, 256, 512, 1024]) * 1024.0**2,
            })]),
        ))
    rng.shuffle(pods)
    return pods


def fleet_workload(pods_n: int, num_its: int = 400, seed: int = 42, neighborhoods: int = 32) -> Workload:
    """``make_fleet_pods`` against ``num_its`` catalog types and one default
    NodePool: the JAX bench's partitioned-solve rows (``run_shard_child``)."""
    its = instance_types(num_its)
    pool = NodePool(metadata=ObjectMeta(name="default"))
    tpl = template_from_nodepool(pool, its, range(len(its)))
    return make_fleet_pods(pods_n, random.Random(seed), neighborhoods=neighborhoods), its, [tpl], []


def diverse_workload(pods_n: int, num_its: int = 400, seed: int = 42) -> Workload:
    """The bench's north-star shape: makeDiversePods against the fake
    catalog's ``num_its`` instance types and one default NodePool
    (tools/_profharness.bench_problem in the JAX package)."""
    rng = random.Random(seed)
    its = instance_types(num_its)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="default")), its, range(len(its)))
    return make_diverse_pods(pods_n, rng), its, [tpl], []


def _chain_pod(rng: random.Random, i: int) -> Pod:
    """One pod of tests/test_chain_parity.py's bench-shaped mixed population."""
    letter = rng.choice("abcdefg")
    labels = {"my-label": letter}
    spec_kw = {}
    roll = rng.random()
    if roll < 0.22:
        spec_kw["topology_spread_constraints"] = [
            TopologySpreadConstraint(
                max_skew=rng.choice([1, 1, 2, 3]),
                topology_key=wk.LABEL_TOPOLOGY_ZONE,
                when_unsatisfiable=DO_NOT_SCHEDULE if rng.random() < 0.7 else SCHEDULE_ANYWAY,
                label_selector=LabelSelector(match_labels={"my-label": letter}),
                min_domains=rng.choice([None, None, 2, 3, 5]),
            )
        ]
    elif roll < 0.40:
        spec_kw["topology_spread_constraints"] = [
            TopologySpreadConstraint(
                max_skew=1,
                topology_key=wk.LABEL_HOSTNAME,
                when_unsatisfiable=DO_NOT_SCHEDULE,
                label_selector=LabelSelector(match_labels={"my-label": rng.choice("abcdefg")}),
            )
        ]
    elif roll < 0.55:
        labels = {"my-affinity": letter}
        spec_kw["affinity"] = Affinity(
            pod_affinity=PodAffinity(
                required=[
                    PodAffinityTerm(
                        label_selector=LabelSelector(match_labels={"my-affinity": letter}),
                        topology_key=(
                            wk.LABEL_TOPOLOGY_ZONE if rng.random() < 0.5 else wk.LABEL_HOSTNAME
                        ),
                    )
                ]
            )
        )
    cpu = rng.choice([0.1, 0.1, 0.5, 1.0, 1.5])
    return Pod(
        metadata=ObjectMeta(name=f"p{i}", labels=labels),
        spec=PodSpec(containers=[Container(requests={"cpu": cpu})], **spec_kw),
    )


def chain_workload(seed: int) -> Workload:
    """tests/test_chain_parity.py ``_population(seed)``: 40-260 pods of
    zone/hostname spread, affinity with retry orderings, and generic pods."""
    rng = random.Random(seed)
    its = instance_types(rng.choice([6, 10]))
    templates = [simple_template(its, name="a")]
    n = rng.randint(40, 140) if seed % 3 else rng.randint(150, 260)
    return [_chain_pod(rng, i) for i in range(n)], its, templates, []


def _wave_pod(rng: random.Random, i: int) -> Pod:
    """One pod of tests/test_wavefront_parity.py's wavefront-stressing
    population: many small groups so adjacent chains land in different
    groups (independent lanes act) but collide often enough to cut the
    wavefront, affinity families that fail whole sweeps (the failed chains
    the lanes batch), and lumpy sizes that run shared claims out of room
    mid-chain."""
    letter = rng.choice("abcdefghij")
    labels = {"my-label": letter}
    spec_kw = {}
    roll = rng.random()
    if roll < 0.30:
        spec_kw["topology_spread_constraints"] = [
            TopologySpreadConstraint(
                max_skew=rng.choice([1, 1, 2, 3]),
                topology_key=wk.LABEL_TOPOLOGY_ZONE,
                when_unsatisfiable=DO_NOT_SCHEDULE if rng.random() < 0.7 else SCHEDULE_ANYWAY,
                label_selector=LabelSelector(match_labels={"my-label": letter}),
                min_domains=rng.choice([None, None, 2, 3, 5]),
            )
        ]
    elif roll < 0.45:
        spec_kw["topology_spread_constraints"] = [
            TopologySpreadConstraint(
                max_skew=1,
                topology_key=wk.LABEL_HOSTNAME,
                when_unsatisfiable=DO_NOT_SCHEDULE,
                label_selector=LabelSelector(match_labels={"my-label": rng.choice("abcdefghij")}),
            )
        ]
    elif roll < 0.65:
        labels = {"my-affinity": letter}
        spec_kw["affinity"] = Affinity(
            pod_affinity=PodAffinity(
                required=[
                    PodAffinityTerm(
                        label_selector=LabelSelector(match_labels={"my-affinity": letter}),
                        topology_key=(
                            wk.LABEL_TOPOLOGY_ZONE if rng.random() < 0.5 else wk.LABEL_HOSTNAME
                        ),
                    )
                ]
            )
        )
    cpu = rng.choice([0.1, 0.1, 0.5, 1.0, 1.5, 3.0])
    return Pod(
        metadata=ObjectMeta(name=f"p{i}", labels=labels),
        spec=PodSpec(containers=[Container(requests={"cpu": cpu})], **spec_kw),
    )


def wave_workload(seed: int) -> Workload:
    """tests/test_wavefront_parity.py ``_encode(seed)``'s population: 40-260
    ``_wave_pod`` pods against 6 or 10 instance types and one template."""
    rng = random.Random(seed)
    its = instance_types(rng.choice([6, 10]))
    templates = [simple_template(its, name="a")]
    n = rng.randint(40, 140) if seed % 3 else rng.randint(150, 260)
    return [_wave_pod(rng, i) for i in range(n)], its, templates, []


def fuzz_workload(seed: int) -> Workload:
    """tests/test_solver_parity.py ``TestRandomizedParity.test_fuzz(seed)``:
    selectors, taints and tolerations, host ports, NodePool limits and
    existing nodes."""
    rng = random.Random(seed)
    its = instance_types(rng.randint(2, 12))
    taint = Taint(key="team", value="x", effect="NoSchedule")
    templates = [simple_template(its, name="a")]
    if rng.random() < 0.3:
        templates[0].remaining_resources = {"cpu": float(rng.randint(4, 40))}
    if rng.random() < 0.5:
        templates.append(simple_template(its, name="b", taints=[taint]))
    pods = []
    for i in range(rng.randint(5, 30)):
        selector = {}
        if rng.random() < 0.3:
            selector[wk.LABEL_TOPOLOGY_ZONE] = rng.choice(ZONES)
        if rng.random() < 0.2:
            selector["integer"] = str(rng.randint(1, 12))
        if rng.random() < 0.15:
            selector[wk.CAPACITY_TYPE_LABEL_KEY] = rng.choice(["spot", "on-demand"])
        tols = [Toleration(key="team", operator="Exists")] if rng.random() < 0.3 else []
        pod = make_pod(
            i,
            cpu=rng.choice([0.1, 0.25, 0.5, 1.0, 1.5, 3.0]),
            mem=rng.choice([1e8, 2.5e8, 1e9, 4e9]),
            selector=selector,
            tolerations=tols,
        )
        if rng.random() < 0.25:
            pod.spec.containers[0].ports.append(
                ContainerPort(
                    host_port=rng.choice([80, 443, 8080]),
                    host_ip=rng.choice(["", "10.0.0.1", "10.0.0.2"]),
                    protocol=rng.choice(["TCP", "UDP"]),
                )
            )
        pods.append(pod)
    nodes = [make_node(f"node-{n}", cpu=rng.choice([2.0, 4.0, 8.0])) for n in range(rng.randint(0, 3))]
    return pods, its, templates, nodes


def _spread(rng, key):
    return TopologySpreadConstraint(
        max_skew=rng.choice([1, 1, 2]),
        topology_key=key,
        when_unsatisfiable=SCHEDULE_ANYWAY if rng.random() < 0.3 else DO_NOT_SCHEDULE,
        label_selector=LabelSelector(match_labels={"grp": rng.choice(["g0", "g1", "g2"])}),
        min_domains=rng.choice([None, None, 2, 3]),
    )


def _aff_term(rng, key):
    return PodAffinityTerm(
        topology_key=key,
        label_selector=LabelSelector(match_labels={"aff": rng.choice(["a0", "a1", "a2"])}),
    )


def _topology_pod(rng, i):
    labels = {"grp": rng.choice(["g0", "g1", "g2"]), "aff": rng.choice(["a0", "a1", "a2"])}
    pod = make_pod(i, cpu=rng.choice([0.1, 0.25, 0.5, 1.0]), mem=rng.choice([1e8, 2.5e8, 1e9]))
    pod.metadata.labels = labels
    roll = rng.random()
    key = rng.choice([wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME])
    if roll < 0.25:
        pod.spec.topology_spread_constraints = [_spread(rng, key)]
        if rng.random() < 0.2:
            other = wk.LABEL_HOSTNAME if key == wk.LABEL_TOPOLOGY_ZONE else wk.LABEL_TOPOLOGY_ZONE
            pod.spec.topology_spread_constraints.append(_spread(rng, other))
    elif roll < 0.45:
        pod.spec.affinity = Affinity(pod_affinity=PodAffinity(required=[_aff_term(rng, key)]))
    elif roll < 0.60:
        pod.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(required=[_aff_term(rng, key)]))
    elif roll < 0.72:
        pod.spec.affinity = Affinity(
            pod_affinity=PodAffinity(
                preferred=[
                    WeightedPodAffinityTerm(weight=rng.randint(1, 100), pod_affinity_term=_aff_term(rng, key))
                ]
            )
        )
    elif roll < 0.82:
        pod.spec.affinity = Affinity(
            pod_anti_affinity=PodAntiAffinity(
                preferred=[
                    WeightedPodAffinityTerm(weight=rng.randint(1, 100), pod_affinity_term=_aff_term(rng, key))
                ]
            )
        )
    if rng.random() < 0.2:
        pod.spec.node_selector = {wk.LABEL_TOPOLOGY_ZONE: rng.choice(ZONES)}
    return pod


def topology_workload(seed: int) -> Workload:
    """tests/test_solver_parity.py ``test_fuzz_topology(seed)``: spread,
    affinity and anti-affinity (required and preferred — preferred terms make
    pods relaxable), selectors, taints and existing nodes."""
    rng = random.Random(1000 + seed)
    its = instance_types(rng.choice([6, 10]))
    templates = [simple_template(its, name="a")]
    taint = Taint(key="team", value="x", effect="NoSchedule")
    if rng.random() < 0.3:
        templates.append(simple_template(its, name="b", taints=[taint]))
    n = rng.randint(10, 60) if seed % 4 else rng.randint(100, 200)
    pods = [_topology_pod(rng, i) for i in range(n)]
    nodes = [
        make_node(f"node-{j}", cpu=rng.choice([2.0, 4.0, 8.0]), zone=rng.choice(ZONES))
        for j in range(rng.randint(0, 4))
    ]
    return pods, its, templates, nodes


def bounds_workload(seed: int, with_nodes: bool = True) -> Workload:
    """Integer Gt/Lt requirements on a template and on pods (the bounded arm
    of the mask algebra), with existing nodes unless ``with_nodes`` is False
    (then every unconstrained pod is eligible for phase 1 of the two-phase
    solve)."""
    rng = random.Random(5000 + seed)
    its = instance_types(12)
    templates = [
        simple_template(its, name="big", requirements=[NodeSelectorRequirement("integer", GT, ["4"])]),
        simple_template(its, name="any"),
    ]
    pods = []
    for i in range(rng.randint(40, 90)):
        reqs = None
        roll = rng.random()
        if roll < 0.3:
            reqs = [("integer", GT, [str(rng.randint(1, 8))])]
        elif roll < 0.5:
            reqs = [("integer", LT, [str(rng.randint(3, 12))])]
        pods.append(make_pod(i, cpu=rng.choice([0.25, 0.5, 1.0, 2.0, 3.0]), mem=rng.choice([1e8, 1e9]),
                             requirements=reqs))
    if not with_nodes:
        return pods, its, templates, []
    nodes = [make_node(f"node-{j}", cpu=rng.choice([2.0, 4.0])) for j in range(rng.randint(1, 3))]
    return pods, its, templates, nodes


def volume_workload(seed: int):
    """Existing nodes with CSI attach limits and pods that attach 0-2
    volumes: returns (workload, pod_volumes), the per-pod volume sets
    (driver -> unique volume ids) that ``TorchSolver.solve`` takes."""
    rng = random.Random(7000 + seed)
    its = instance_types(8)
    templates = [simple_template(its, name="a")]
    nodes = []
    for j in range(rng.randint(2, 4)):
        node = make_node(f"node-{j}", cpu=8.0)
        node.volume_limits = {"ebs.csi": rng.randint(1, 3)}
        node.volume_used = {"ebs.csi": rng.randint(0, 1)}
        nodes.append(node)
    pods, volumes = [], []
    for i in range(rng.randint(20, 50)):
        pods.append(make_pod(i, cpu=rng.choice([0.1, 0.25, 0.5])))
        k = rng.choice([0, 0, 1, 2])
        volumes.append({"ebs.csi": frozenset(f"vol-{i}-{v}" for v in range(k))} if k else {})
    return (pods, its, templates, nodes), volumes


def relax_fuzz_workload(seed: int) -> Workload:
    """tests/test_solver_relax_parity.py ``TestRelaxFuzzGeneric.test_fuzz(seed)``:
    the generic fuzz family under the two-phase solve (selectors, taints,
    host ports, NodePool limits, existing nodes)."""
    rng = random.Random(5000 + seed)
    its = instance_types(rng.randint(2, 12))
    taint = Taint(key="team", value="x", effect="NoSchedule")
    templates = [simple_template(its, name="a")]
    if rng.random() < 0.3:
        templates[0].remaining_resources = {"cpu": float(rng.randint(4, 40))}
    if rng.random() < 0.5:
        templates.append(simple_template(its, name="b", taints=[taint]))
    pods = []
    for i in range(rng.randint(5, 30)):
        selector = {}
        if rng.random() < 0.3:
            selector[wk.LABEL_TOPOLOGY_ZONE] = rng.choice(ZONES)
        if rng.random() < 0.2:
            selector["integer"] = str(rng.randint(1, 12))
        tols = [Toleration(key="team", operator="Exists")] if rng.random() < 0.3 else []
        pod = make_pod(
            i,
            cpu=rng.choice([0.1, 0.25, 0.5, 1.0, 1.5, 3.0]),
            mem=rng.choice([1e8, 2.5e8, 1e9, 4e9]),
            selector=selector,
            tolerations=tols,
        )
        if rng.random() < 0.25:
            pod.spec.containers[0].ports.append(
                ContainerPort(
                    host_port=rng.choice([80, 443, 8080]),
                    host_ip=rng.choice(["", "10.0.0.1"]),
                    protocol=rng.choice(["TCP", "UDP"]),
                )
            )
        pods.append(pod)
    nodes = [make_node(f"node-{n}", cpu=rng.choice([2.0, 4.0, 8.0])) for n in range(rng.randint(0, 3))]
    return pods, its, templates, nodes


def relax_topology_workload(seed: int) -> Workload:
    """tests/test_solver_relax_parity.py ``TestRelaxFuzzTopology
    .test_fuzz_topology(seed)``: spread, affinity and anti-affinity mixes
    whose constrained pods all go to the repair pass."""
    rng = random.Random(7000 + seed)
    its = instance_types(rng.choice([6, 10]))
    templates = [simple_template(its, name="a")]
    n = rng.randint(12, 60)
    pods = [_topology_pod(rng, i) for i in range(n)]
    nodes = [
        make_node(f"node-{j}", cpu=rng.choice([2.0, 4.0, 8.0]), zone=rng.choice(ZONES))
        for j in range(rng.randint(0, 3))
    ]
    return pods, its, templates, nodes


def homogeneous_workload(n: int = 48, num_its: int = 8) -> Workload:
    """tests/test_solver_relax_parity.py ``test_phase1_places_bulk_and_shrinks
    _repair``: a bulk of unconstrained pods of five sizes, phase 1's target
    (``num_its`` catalog types; 8 there)."""
    its = instance_types(num_its)
    pods = [make_pod(i, cpu=0.3 + 0.2 * (i % 5)) for i in range(n)]
    return pods, its, [simple_template(its)], []


def relax2_fuzz_workload(seed: int) -> Workload:
    """tests/test_relax2.py ``TestRelax2FuzzGeneric.test_fuzz(seed)``:
    zone selectors, host ports, a NodePool limit on some seeds, existing
    nodes."""
    rng = random.Random(22000 + seed)
    its = instance_types(rng.randint(2, 10))
    templates = [simple_template(its, name="a")]
    if rng.random() < 0.3:
        templates[0].remaining_resources = {"cpu": float(rng.randint(4, 40))}
    pods = []
    for i in range(rng.randint(5, 24)):
        selector = {}
        if rng.random() < 0.3:
            selector[wk.LABEL_TOPOLOGY_ZONE] = rng.choice(ZONES)
        pod = make_pod(
            i,
            cpu=rng.choice([0.1, 0.25, 0.5, 1.0, 1.5, 3.0]),
            mem=rng.choice([1e8, 2.5e8, 1e9, 4e9]),
            selector=selector,
        )
        if rng.random() < 0.25:
            pod.spec.containers[0].ports.append(
                ContainerPort(host_port=rng.choice([80, 443, 8080]), protocol=rng.choice(["TCP", "UDP"]))
            )
        pods.append(pod)
    nodes = [make_node(f"node-{n}", cpu=rng.choice([2.0, 4.0, 8.0])) for n in range(rng.randint(0, 2))]
    return pods, its, templates, nodes


def relax2_topology_workload(seed: int) -> Workload:
    """tests/test_relax2.py ``TestRelax2FuzzTopology.test_fuzz_topology(seed)``:
    spread, affinity and anti-affinity mixes, all repaired."""
    rng = random.Random(23000 + seed)
    its = instance_types(rng.choice([6, 10]))
    n = rng.randint(10, 40)
    pods = [_topology_pod(rng, i) for i in range(n)]
    return pods, its, [simple_template(its, name="a")], []


def accounting_workload() -> Workload:
    """tests/test_relax2.py ``test_eligible_pods_accounted_exactly_once``:
    32 pods of three sizes, the first with a host port."""
    its = instance_types(8)
    pods = [make_pod(i, cpu=0.4 + 0.3 * (i % 3)) for i in range(32)]
    pods[0].spec.containers[0].ports.append(ContainerPort(host_port=9090, protocol="TCP"))
    return pods, its, [simple_template(its)], []


# -- the consolidation screen's base pods (tests/test_screen_delta.py shapes) --


def _wide_pod(rng: random.Random, i: int, cls: int, selector, requirements) -> Pod:
    pod = make_pod(i, cpu=[0.25, 0.5, 1.0][cls % 3], mem=1e8, selector=selector, requirements=requirements)
    pod.metadata.labels = {"grp": f"g{cls % 2}"}
    if cls % 4 == 1:
        pod.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable=DO_NOT_SCHEDULE,
            label_selector=LabelSelector(match_labels={"grp": "g1"}),
        )]
    elif cls % 4 == 3:
        pod.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key=wk.LABEL_HOSTNAME, when_unsatisfiable=DO_NOT_SCHEDULE,
            label_selector=LabelSelector(match_labels={"grp": "g1"}),
        )]
    return pod


def wide_keys_workload(seed: int = 0, keys: int = 40) -> Workload:
    """More than 32 label keys: three existing nodes carry ``keys`` custom
    labels between them, and chains of identical pods select some of them,
    spread over zones or hostnames, or take any bin."""
    rng = random.Random(9000 + seed)
    its = instance_types(8)
    templates = [simple_template(its, name="a")]
    per = -(-keys // 3)
    nodes = [
        make_node(f"node-{j}", cpu=4.0, zone=ZONES[j],
                  labels={f"team.example/k{j * per + i}": f"v{rng.randint(0, 2)}" for i in range(per)})
        for j in range(3)
    ]
    pods = []
    for cls in range(12):
        selector = {}
        if cls % 3 == 0:
            node = nodes[rng.randrange(3)]
            key = rng.choice(sorted(k for k in node.requirements.keys() if k.startswith("team.example/")))
            selector[key] = next(iter(node.requirements.get(key).values))
        for _ in range(rng.randint(1, 6)):
            pods.append(_wide_pod(rng, len(pods), cls, selector, None))
    return pods, its, templates, nodes


def wide_lanes_workload(seed: int = 0, values: int = 2100) -> Workload:
    """More than 2,048 value lanes: pods that keep off ``values`` racks
    (NotIn: the racks enter the vocabulary of one key), beside chains of
    zone and hostname spread pods and one existing node on a rack."""
    rng = random.Random(9500 + seed)
    its = instance_types(8)
    templates = [simple_template(its, name="a")]
    racks = [f"rack-{i}" for i in range(values)]
    nodes = [make_node("node-0", cpu=4.0, labels={"topology.example/rack": racks[7]})]
    pods = []
    for cls in range(10):
        reqs = [("topology.example/rack", NOT_IN, racks[: values - cls])] if cls % 2 == 0 else None
        for _ in range(rng.randint(1, 6)):
            pods.append(_wide_pod(rng, len(pods), cls, None, reqs))
    return pods, its, templates, nodes


def _screen_pod(name: str, cpu: float, labels=None, node_selector=None, host_ports=(),
                topology_spread=()) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=name, labels=dict(labels or {})),
        spec=PodSpec(
            containers=[Container(requests={"cpu": cpu},
                                  ports=[ContainerPort(container_port=p, host_port=p) for p in host_ports])],
            node_selector=dict(node_selector or {}),
            topology_spread_constraints=list(topology_spread),
        ),
    )


def pinned_base_pods(n: int = 6, cpu: float = 2.0) -> List[Pod]:
    """Pending pods pinned by hostname to the bench scorer's roomy survivors
    (``big-node-<i % 8>``): they drive the residual screen's base-world solve
    without landing on a candidate, and sort before every resident."""
    return [_screen_pod(f"base-{i}", cpu, node_selector={wk.LABEL_HOSTNAME: f"big-node-{i % 8}"})
            for i in range(n)]


def zonal_spread_pods(n: int, cpu: float = 0.2) -> List[Pod]:
    """Pending pods under one zonal DoNotSchedule spread (max skew 1): the
    screen needs more than one placement pass for them, so the residual
    path stands the whole batch down to the full screen."""
    spread = TopologySpreadConstraint(
        max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable=DO_NOT_SCHEDULE,
        label_selector=LabelSelector(match_labels={"spread": "s"}),
    )
    return [_screen_pod(f"spread-{i}", cpu, labels={"spread": "s"}, topology_spread=[spread])
            for i in range(n)]


def port_pods(n: int = 1, cpu: float = 0.2) -> List[Pod]:
    """Pending pods with a host port (the ports standdown)."""
    return [_screen_pod(f"portly-{i}", cpu, host_ports=[8080]) for i in range(n)]


def unpinned_base_pods(n: int = 2, cpu: float = 3.0) -> List[Pod]:
    """Fat pending pods with no selector: first fit lands them on the first
    candidate nodes (the base-on-candidate standdown)."""
    return [_screen_pod(f"fat-{i}", cpu) for i in range(n)]


def tiny_base_pods(n: int = 2, cpu: float = 0.05) -> List[Pod]:
    """Pending pods smaller than every resident, pinned to survivors: they
    sort after the residents (the resident-order standdown)."""
    return [_screen_pod(f"tiny-{i}", cpu, node_selector={wk.LABEL_HOSTNAME: f"big-node-{i}"})
            for i in range(n)]


# -- the partitioned solve's corpora (tests/test_shard_parity.py) -------------


def shard_port_pod(i, host_port, cpu=0.5, selector=None) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=f"pp{i}"),
        spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": 1e8},
                                  ports=[ContainerPort(host_port=host_port)])],
            node_selector=selector or {},
        ),
    )


def shard_spread_pod(i, letter, max_skew=1, when=DO_NOT_SCHEDULE, cpu=0.5) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=f"sp{i}", labels={"my-label": letter}),
        spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": 1e8})],
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=max_skew,
                    topology_key=wk.LABEL_TOPOLOGY_ZONE,
                    when_unsatisfiable=when,
                    label_selector=LabelSelector(match_labels={"my-label": letter}),
                )
            ],
        ),
    )


def shard_plain_workload(seed: int) -> Workload:
    """test_shard_parity's plain fuzz: 24-48 pods with zone and capacity-type
    selectors and tolerations over 3-8 types, one or two templates."""
    rng = random.Random(seed)
    its = instance_types(rng.randint(3, 8))
    templates = [simple_template(its, name="a")]
    if rng.random() < 0.5:
        taint = Taint(key="team", value="x", effect="NoSchedule")
        templates.append(simple_template(its, name="b", taints=[taint]))
    pods = []
    for i in range(rng.randint(24, 48)):
        selector = {}
        if rng.random() < 0.3:
            selector[wk.LABEL_TOPOLOGY_ZONE] = rng.choice(ZONES)
        if rng.random() < 0.15:
            selector[wk.CAPACITY_TYPE_LABEL_KEY] = rng.choice(["spot", "on-demand"])
        tols = [Toleration(key="team", operator="Exists")] if rng.random() < 0.3 else []
        pods.append(make_pod(i, cpu=rng.choice([0.1, 0.25, 0.5, 1.0, 1.5, 3.0]),
                             mem=rng.choice([1e8, 2.5e8, 1e9]), selector=selector, tolerations=tols))
    return pods, its, templates, []


def shard_topology_workload(seed: int) -> Workload:
    """test_shard_parity's topology fuzz: 36 hard zone-spread pods over six
    disjoint label families."""
    rng = random.Random(100 + seed)
    its = instance_types(6)
    pods = []
    for i in range(36):
        letter = rng.choice("abcdef")
        pods.append(shard_spread_pod(i, letter, max_skew=rng.choice([1, 1, 2]), cpu=rng.choice([0.25, 0.5, 1.0])))
    return pods, its, [simple_template(its)], []


def shard_ports_workload(seed: int) -> Workload:
    """test_shard_parity's ports fuzz: 28 zone-pinned pods, 40% with a host
    port, over two existing nodes in two zones."""
    rng = random.Random(200 + seed)
    its = instance_types(6)
    pods, nodes = [], [make_node("n1", cpu=6.0), make_node("n2", cpu=6.0, zone="test-zone-2")]
    for i in range(28):
        zone = rng.choice(["test-zone-1", "test-zone-2"])
        selector = {wk.LABEL_TOPOLOGY_ZONE: zone}
        if rng.random() < 0.4:
            pods.append(shard_port_pod(i, host_port=rng.choice([80, 443, 8080]), selector=selector))
        else:
            pods.append(make_pod(i, cpu=rng.choice([0.25, 0.5, 1.0]), selector=selector))
    return pods, its, [simple_template(its)], nodes


def shard_claims_workload() -> Workload:
    """test_shard_parity's claim-heavy batch: 40 free pods of three sizes,
    whose per-partition claims the merge re-joins."""
    its = instance_types(4)
    return [make_pod(i, cpu=0.5 + (i % 3) * 0.25) for i in range(40)], its, [simple_template(its)], []


def shard_relax2_workload() -> Workload:
    """test_shard_parity's sharded convex corpus: 160 fleet pods (seed 13)
    over 12 types, one template, a phase-1 residue in every lane."""
    its = instance_types(12)
    return make_fleet_pods(160, random.Random(13)), its, [simple_template(its)], []
