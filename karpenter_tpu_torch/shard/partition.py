"""Host-side independence analysis: split a scheduling batch into
provably independent sub-problems (the JAX package's
``shard/partition.py``, the same host code over this package's types).

Two pods interact during a solve only through *shared state*:

- an **existing node** both could land on (capacity, host ports, CSI
  attach counts),
- a **topology group** that counts both (spread skew, affinity, or
  anti-affinity domains),
- a **finite-template budget** both draw from (``remaining_resources``
  is a shared NodePool headroom counter), or
- a **shared claim** — but claims minted from infinite templates are
  fresh nodes, so pods in different partitions simply open separate
  claims and the post-solve merge (shard/solve.py) may re-join them.
  Shared claims therefore never force co-partitioning by themselves.

We build a union-find over pod *classes* (pods with identical
constraint signature — and identical override row when an override is
in play — encode to the same row modulo requests, so one representative
answers every compatibility question for the class) plus one element
per node, per topology group, and per finite template. An edge is the
exact host-side compatibility check the oracle uses: taints via
``Taints.tolerates`` (empty error list = tolerated) and requirements
via ``Requirements.is_compatible``. Edges only ever OVER-approximate
interaction — a spurious edge costs balance, a missing edge would cost
correctness, so every check mirrors solver/oracle.py verbatim.

Components that touch no node, group, or template element are
**splittable**: their pods share nothing, so the planner may chunk them
across partitions freely for balance (the provisioning-style fleet
batches that motivate this subsystem are almost entirely splittable).
All other components are atomic and placed whole via LPT.

The two-stage count classifies non-decomposable inputs: if the batch
only collapses to one component once finite-template edges are applied,
the standdown reason is ``cross-partition-claims`` (shared budget);
if it is monolithic even without them, ``single-partition``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.provisioning.topology import TopologyGroup
from karpenter_tpu_torch.scheduling import Requirements, pod_requirements
from karpenter_tpu_torch.solver.encode import (
    NodeInfo,
    TemplateInfo,
    _reqs_digest,
    constraint_signature,
)
from karpenter_tpu_torch import shard as _shard_flags


class _UnionFind:
    __slots__ = ("parent", "rank")

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        parent = self.parent
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


@dataclass
class Partition:
    """One independent sub-problem: row maps into the original batch.
    Both index lists preserve original order so per-partition decode maps
    straight back to caller indices."""

    pod_idx: List[int] = field(default_factory=list)
    node_idx: List[int] = field(default_factory=list)


@dataclass
class PartitionPlan:
    """Output of partition_pods. When ``reason`` is set the batch did not
    decompose and ``parts`` is empty — the caller stands down."""

    parts: List[Partition] = field(default_factory=list)
    reason: Optional[str] = None
    # telemetry: how the component graph looked before balancing
    atomic_components: int = 0
    splittable_pods: int = 0
    dropped_nodes: int = 0  # nodes no pod in the batch can reach


def _effective_reqs(
    pod: Pod, i: int, override: Optional[Sequence[Requirements]]
) -> Requirements:
    # Mirrors the encode fold: the device solve judges node/template
    # compatibility against the override row when one is supplied,
    # else preference-inclusive pod requirements.
    if override is not None:
        return override[i]
    return pod_requirements(pod)


def group_members(pods: Sequence[Pod], groups: Sequence[TopologyGroup]) -> List[List[int]]:
    """Per pod, the indices of the groups it owns or that select it, in
    group order. Selection depends only on the pod's namespace and labels,
    so it is computed once per distinct (namespace, labels)."""
    owned: Dict[str, List[int]] = {}
    for gi, tg in enumerate(groups):
        for uid in tg.owners:
            owned.setdefault(uid, []).append(gi)
    selected: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], List[int]] = {}
    out = []
    for p in pods:
        key = (p.namespace, tuple(sorted(p.metadata.labels.items())))
        sel = selected.get(key)
        if sel is None:
            sel = selected[key] = [gi for gi, tg in enumerate(groups) if tg.selects(p)]
        own = owned.get(p.uid)
        out.append(sorted(set(own) | set(sel)) if own else sel)
    return out


def partition_pods(
    pods: Sequence[Pod],
    templates: Sequence[TemplateInfo],
    nodes: Sequence[NodeInfo],
    groups: Sequence[TopologyGroup],
    n_parts: int,
    pod_requirements_override: Optional[Sequence[Requirements]] = None,
) -> PartitionPlan:
    """Partition ``pods``/``nodes`` into at most ``n_parts`` independent
    sub-problems, or classify why that is impossible."""
    n_pods = len(pods)
    plan = PartitionPlan()
    if n_pods < 2 or n_parts < 2:
        plan.reason = _shard_flags.REASON_SINGLE_PARTITION
        return plan

    # ---- pod classes -------------------------------------------------
    # Same constraint signature (and same override digest when an override
    # is in play) => identical encoded row modulo requests => one
    # representative per class answers every compatibility question.
    class_ids: Dict[object, int] = {}
    pod_class: List[int] = []
    class_rep: List[int] = []  # class -> representative pod index
    for i, p in enumerate(pods):
        key: object = constraint_signature(p)
        if pod_requirements_override is not None:
            key = (key, _reqs_digest(pod_requirements_override[i]))
        ci = class_ids.get(key)
        if ci is None:
            ci = len(class_rep)
            class_ids[key] = ci
            class_rep.append(i)
        pod_class.append(ci)
    n_classes = len(class_rep)

    # ---- union-find elements -----------------------------------------
    # [0, n_classes)                      pod classes
    # [n_classes, +len(nodes))            nodes
    # [.., +len(groups))                  topology groups
    # [.., +len(finite templates))        finite-template budgets
    node_base = n_classes
    group_base = node_base + len(nodes)
    finite_tpls = [ti for ti, t in enumerate(templates) if t.remaining_resources is not None]
    tpl_base = group_base + len(groups)
    uf = _UnionFind(tpl_base + len(finite_tpls))

    reps = [(ci, pods[class_rep[ci]], _effective_reqs(pods[class_rep[ci]], class_rep[ci], pod_requirements_override)) for ci in range(n_classes)]

    # Node edges — exact oracle checks (oracle.py: skip when
    # taints.tolerates returns errors, skip when requirements are
    # incompatible). Any pod class that can land on a node shares its
    # capacity/ports/attach state with every other such class.
    node_reached = [False] * len(nodes)
    for ni, n in enumerate(nodes):
        for ci, rep, reqs in reps:
            if n.taints.tolerates(rep):
                continue
            if not n.requirements.is_compatible(reqs):
                continue
            node_reached[ni] = True
            uf.union(ci, node_base + ni)

    # Group edges — membership is per-pod: the groups a pod owns (by uid)
    # and the groups that select it, memoised by (namespace, labels) like the
    # encode fold's selects cache (the JAX package tests every pod against
    # every group; the unions, and so the components, are the same).
    if groups:
        for i, gis in enumerate(group_members(pods, groups)):
            for gi in gis:
                uf.union(pod_class[i], group_base + gi)

    # Snapshot BEFORE finite-template edges: distinguishes a batch glued
    # together only by a shared NodePool budget (cross-partition-claims)
    # from one that is monolithic outright (single-partition).
    def _component_stats() -> Tuple[int, int]:
        """(atomic component count, splittable pod count)."""
        comp_pods: Dict[int, int] = {}
        anchored: set = set()
        for ci in range(n_classes):
            comp_pods.setdefault(uf.find(ci), 0)
        for i in range(n_pods):
            comp_pods[uf.find(pod_class[i])] += 1
        for e in range(node_base, len(uf.parent)):
            anchored.add(uf.find(e))
        atomic = sum(1 for r in comp_pods if r in anchored)
        splittable = sum(c for r, c in comp_pods.items() if r not in anchored)
        return atomic, splittable

    def _partitionable(atomic: int, splittable: int) -> bool:
        return atomic >= 2 or (atomic >= 1 and splittable >= 1) or splittable >= 2

    pre_atomic, pre_split = _component_stats()

    # Finite-template edges: remaining_resources is one shared headroom
    # counter, so every class that can mint from the template must solve
    # in the same partition to see the same budget.
    for k, ti in enumerate(finite_tpls):
        t = templates[ti]
        for ci, rep, reqs in reps:
            if t.taints.tolerates(rep):
                continue
            if not t.requirements.is_compatible(reqs, wk.WELL_KNOWN_LABELS):
                continue
            uf.union(ci, tpl_base + k)

    atomic, splittable = _component_stats()
    plan.atomic_components = atomic
    plan.splittable_pods = splittable
    if not _partitionable(atomic, splittable):
        plan.reason = (
            _shard_flags.REASON_CROSS_PARTITION_CLAIMS
            if _partitionable(pre_atomic, pre_split)
            else _shard_flags.REASON_SINGLE_PARTITION
        )
        return plan

    # ---- balance into bins (LPT + splittable backfill) ----------------
    comp_members: Dict[int, List[int]] = {}  # root -> pod indices
    comp_anchored: Dict[int, bool] = {}
    for e in range(node_base, len(uf.parent)):
        comp_anchored[uf.find(e)] = True
    for i in range(n_pods):
        root = uf.find(pod_class[i])
        comp_members.setdefault(root, []).append(i)

    atomic_comps = [(root, m) for root, m in comp_members.items() if comp_anchored.get(root)]
    split_pods = [i for root, m in comp_members.items() if not comp_anchored.get(root) for i in m]

    bins: List[List[int]] = [[] for _ in range(n_parts)]
    bin_root: List[List[int]] = [[] for _ in range(n_parts)]  # roots per bin (node routing)
    loads = [0] * n_parts
    for root, members in sorted(atomic_comps, key=lambda rm: -len(rm[1])):
        b = loads.index(min(loads))
        bins[b].extend(members)
        bin_root[b].append(root)
        loads[b] += len(members)
    # Splittable pods level the bins: repeatedly top up the lightest bin
    # toward the ideal share. Chunked (not one-by-one) to stay O(parts).
    split_pods.sort()
    remaining = len(split_pods)
    pos = 0
    target = (n_pods + n_parts - 1) // n_parts
    order = sorted(range(n_parts), key=lambda b: loads[b])
    for b in order:
        take = min(remaining, max(0, target - loads[b]))
        if take:
            bins[b].extend(split_pods[pos : pos + take])
            loads[b] += take
            pos += take
            remaining -= take
    while remaining:  # rounding leftovers
        b = loads.index(min(loads))
        bins[b].append(split_pods[pos])
        loads[b] += 1
        pos += 1
        remaining -= 1

    # Route each reachable node to the bin owning its component; a node no
    # pod can reach belongs to no sub-problem (it could not have received
    # a pod in the unsharded solve either) and is dropped.
    root_to_bin: Dict[int, int] = {}
    for b, roots in enumerate(bin_root):
        for root in roots:
            root_to_bin[root] = b
    node_bins: List[List[int]] = [[] for _ in range(n_parts)]
    dropped = 0
    for ni in range(len(nodes)):
        if not node_reached[ni]:
            dropped += 1
            continue
        node_bins[root_to_bin[uf.find(node_base + ni)]].append(ni)
    plan.dropped_nodes = dropped

    for b in range(n_parts):
        if bins[b]:
            bins[b].sort()
            plan.parts.append(Partition(pod_idx=bins[b], node_idx=node_bins[b]))
    if len(plan.parts) < 2:
        plan.parts = []
        plan.reason = _shard_flags.REASON_SINGLE_PARTITION
    return plan
