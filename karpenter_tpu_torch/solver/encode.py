"""Tensor codec: API objects -> SchedulingProblem.

Builds the per-batch closed-world vocabulary (label key -> lane dictionary) and
encodes pods, instance types, nodepool templates, and existing nodes into the
struct-of-arrays model in models/problem.py. See that module's docstring for
the encoding invariants.

Reference correspondence: this replaces the object graph the Go scheduler
builds in NewScheduler (provisioner.go:204-296) — requirement maps, taints,
daemon overhead — with dense arrays; what the reference recomputes per
pod-placement attempt (nodeclaim.go:225-260) becomes one-time encoding plus
on-device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import Pod, Taint
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.models.problem import (
    CT_KEY,
    GT_NONE,
    HOSTNAME_KEY,
    LT_NONE,
    ProblemMeta,
    ReqTensor,
    SchedulingProblem,
    ZONE_KEY,
)
from karpenter_tpu_torch.ops.padding import pow2_bucket
from karpenter_tpu_torch.provisioning.topology import Topology, TOPOLOGY_TYPE_SPREAD
from karpenter_tpu_torch.scheduling import (
    Requirement,
    Requirements,
    Taints,
    has_preferred_node_affinity,
    pod_requirements,
    strict_pod_requirements,
)
from karpenter_tpu_torch.scheduling.hostports import HostPort, get_host_ports
from karpenter_tpu_torch.scheduling.requirements import label_requirements
from karpenter_tpu_torch.utils import resources as res


@dataclass
class TemplateInfo:
    """Host-side view of one NodeClaimTemplate (scheduling/nodeclaimtemplate.go:43-53):
    pool requirements + labels, taints, daemonset overhead, instance types, and
    the NodePool's remaining resource headroom (None = no limits)."""

    nodepool_name: str
    requirements: Requirements
    taints: Taints
    daemon_overhead: Dict[str, float]
    instance_type_indices: List[int]
    remaining_resources: Optional[Dict[str, float]] = None


@dataclass
class NodeInfo:
    """Host-side view of one existing node entering the solve
    (scheduling/existingnode.go:40-62)."""

    name: str
    requirements: Requirements  # label requirements (+hostname)
    taints: Taints
    available: Dict[str, float]  # allocatable - scheduled pod requests
    daemon_overhead: Dict[str, float]  # unscheduled daemonset requests
    host_ports: List["HostPort"] = None  # type: ignore[assignment]
    # CSI attach state (volumeusage.go): current unique-volume counts and the
    # node's per-driver limits (absent driver = unlimited)
    volume_used: Dict[str, int] = None  # type: ignore[assignment]
    volume_limits: Dict[str, int] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.host_ports is None:
            self.host_ports = []
        if self.volume_used is None:
            self.volume_used = {}
        if self.volume_limits is None:
            self.volume_limits = {}


@dataclass
class EncodedProblem:
    problem: SchedulingProblem
    meta: ProblemMeta


# longest run one scan step commits; bounds the per-step ordinal-mapping
# tensors ([C, MAX_RUN] in ops/ffd.py) and the output-window scratch
MAX_RUN_LEN = 512


def constraint_signature(p: Pod) -> str:
    """Deterministic digest of everything that can distinguish two pods'
    encoded rows besides their resource requests. Used as an FFD sort
    tie-break so identical pods become *consecutive* queue rows and compress
    into runs (ops/ffd.py). Purely an ordering heuristic — run formation
    itself re-checks byte-identical encodings — so an imprecise digest can
    only cost compression, never correctness."""
    spec = p.spec
    # PERF-SENSITIVE ordering: moving labels all the way to the END (past
    # ports) was measured to DOUBLE the 10k bench's device time — reordering
    # pod CLASSES within a size tier changes the claim landscape every later
    # pod packs against (docs/PERF_NOTES.md item 5). A/B any change to this
    # list on the bench before landing it.
    #
    # Labels sit AFTER the spread constraints but BEHIND a 2-way label
    # bucket (round-6 A/B'd). Pods sharing a spread/affinity shape but
    # differing only in own labels become consecutive — exactly the
    # adjacency the chain-identity commits (pod_eqprev_chain) batch over.
    # The bucket caps that adjacency on purpose: a fully contiguous
    # same-selector hostname-spread cohort opens a fresh claim per pod
    # (each wants a zero-count domain), which blew the 10k bench past its
    # 128-claim bucket (134 needed) and onto the 256-slot program — a
    # 3.5x wall-time cliff. Interleaving two label halves bounds the
    # consecutive same-selector demand (97 claims at 10k) while keeping
    # runs long enough for the chain commits (93% of the queue batched).
    labels = repr(sorted((p.metadata.labels or {}).items()))
    parts = [
        p.namespace,
        repr(sorted(spec.node_selector.items())),
        repr(spec.affinity),
        repr(spec.tolerations),
        str(sum(labels.encode()) % 2),
        repr(spec.topology_spread_constraints),
        labels,
        repr([(c.ports or []) for c in spec.containers]),
    ]
    return "|".join(parts)


def ffd_order(pods: Sequence[Pod], requests_of=None) -> List[int]:
    """The FFD queue order: cpu desc, memory desc, then a constraint-signature
    tie-break, then creation time / sequence. The primary keys mirror the
    reference queue sort (queue.go:76-111); the signature tie-break is this
    framework's own refinement — the reference breaks resource ties purely by
    age, which is arbitrary for placement quality, while grouping
    equal-signature pods lets the device solver commit whole runs per scan
    step. Shared by every backend — parity depends on a single definition.
    ``requests_of`` lets callers share a memoized pod_requests (the encoder
    computes requests for several tensors; pods are immutable within a call).

    ``KARPENTER_TPU_ORDER_POLICY`` inserts the learned score
    (solver/ordering.py) between the resource keys and the signature: it
    reorders pod classes within a resource tier, while the resource order
    and the adjacency of identical pods (identical features, then the
    signature) survive. Flag off, the keys are the static ones."""
    if requests_of is None:
        requests_of = res.pod_requests
    from karpenter_tpu_torch.solver import ordering

    scores = ordering.order_scores(pods, requests_of) if ordering.enabled() else None
    keys = []
    for i, p in enumerate(pods):
        requests = requests_of(p)
        key = [
            -requests.get(res.CPU, 0.0),
            -requests.get(res.MEMORY, 0.0),
        ]
        if scores is not None:
            key.append(-float(scores[i]))
        key.extend(
            (
                constraint_signature(p),
                p.metadata.creation_timestamp or 0.0,
                p.metadata.creation_seq,
                i,
            )
        )
        keys.append(tuple(key))
    return sorted(range(len(pods)), key=lambda i: keys[i])


class _Vocab:
    def __init__(self):
        self.keys: List[str] = []
        self.key_index: Dict[str, int] = {}
        self.values: List[Dict[str, int]] = []

    def key(self, k: str) -> int:
        if k not in self.key_index:
            self.key_index[k] = len(self.keys)
            self.keys.append(k)
            self.values.append({})
        return self.key_index[k]

    def value(self, k: str, v: str) -> int:
        ki = self.key(k)
        vals = self.values[ki]
        if v not in vals:
            vals[v] = len(vals)
        return vals[v]

    def add_requirements(self, reqs: Requirements):
        for key in reqs:
            r = reqs.get(key)
            self.key(key)
            for v in r.values:
                self.value(key, v)

    def add_values_for_active_keys(self, reqs: Requirements):
        """Intern values only for keys already in the vocabulary.

        Instance types are always the *right side* of Intersects/Compatible
        (nodeclaim.go:262-264); a key no pod/template/node/topology entity
        defines can never fail those checks (`both_defined` gates every
        per-key test, requirements.go:241-258), so instance-type-only keys —
        e.g. 400+ instance-type-name lanes — are dropped from the device
        tensors entirely. Values of *active* keys must still be interned:
        a NotIn pod requirement admits lanes it has never seen, so the
        instance type's own values need lanes for the intersection test."""
        for key in reqs:
            ki = self.key_index.get(key)
            if ki is None:
                continue
            r = reqs.get(key)
            for v in r.values:
                self.value(key, v)


def vocab_from_meta(meta: ProblemMeta) -> _Vocab:
    """Reconstruct the exact vocabulary from an encode's meta: values_per_key
    lists values in lane order, so re-interning in list order reproduces
    every index."""
    v = _Vocab()
    for ki, key in enumerate(meta.keys):
        v.key(key)
        for value in meta.values_per_key[ki]:
            v.value(key, value)
    return v


def build_vocab(
    vocab_pods: Sequence[Pod],
    templates: Sequence[TemplateInfo],
    nodes: Sequence[NodeInfo],
    groups: Sequence,
    claim_hostnames: Sequence[str],
    instance_types: Sequence[InstanceType],
    override_reqs_list: Optional[Sequence[Requirements]] = None,
    vocab_reqs: Optional[Sequence[Requirements]] = None,
) -> _Vocab:
    """The full vocabulary build, in the exact insertion order the encoder
    commits to. Module-level so the streaming delta encoder
    (streaming/delta.py) can rebuild and compare vocabularies against its
    cached encode without re-running the expensive tensor sections — lane
    numbering is insertion-ordered, so any shared-code drift here would
    silently break patched-vs-cold bit parity."""
    vocab = _Vocab()
    # zone / capacity-type / hostname keys always exist at pinned indices
    # (offering checks + claim hostname minting index them statically)
    zone_k = vocab.key(wk.LABEL_TOPOLOGY_ZONE)
    ct_k = vocab.key(wk.CAPACITY_TYPE_LABEL_KEY)
    hostname_k = vocab.key(wk.LABEL_HOSTNAME)
    if (zone_k, ct_k, hostname_k) != (ZONE_KEY, CT_KEY, HOSTNAME_KEY):
        # device kernels index these statically; survive python -O
        raise AssertionError(
            f"pinned vocab keys moved: {(zone_k, ct_k, hostname_k)}"
        )
    for p in vocab_pods:
        # seed EVERY affinity term, not just the active one: relaxation
        # can surface later OR terms / lighter preferences in later
        # passes, and the frozen vocabulary must already cover them
        vocab.add_requirements(label_requirements(p.spec.node_selector))
        aff = p.spec.affinity.node_affinity if p.spec.affinity else None
        if aff is not None:
            for term in aff.required:
                vocab.add_requirements(
                    Requirements.from_node_selector_requirements(*term.match_expressions)
                )
            for pref in aff.preferred:
                vocab.add_requirements(
                    Requirements.from_node_selector_requirements(
                        *pref.preference.match_expressions
                    )
                )
    # vocab_reqs (stable, full-universe order) must seed BEFORE the
    # per-pass pod_reqs_list, whose FFD-queue order varies across relax
    # passes — otherwise override-only keys/values get different lane
    # indices per pass and carried solver state misreads them
    if vocab_reqs is not None:
        for reqs in vocab_reqs:
            vocab.add_requirements(reqs)
    if override_reqs_list is not None:
        for reqs in override_reqs_list:
            vocab.add_requirements(reqs)
    for t in templates:
        vocab.add_requirements(t.requirements)
    for n in nodes:
        vocab.add_requirements(n.requirements)
    # topology domains + node-filter terms + claim hostname placeholders
    for tg in groups:
        vocab.key(tg.key)
        for domain in tg.domains:
            vocab.value(tg.key, domain)
        for term in tg.node_filter.terms:
            vocab.add_requirements(term)
    for h in claim_hostnames:
        vocab.value(wk.LABEL_HOSTNAME, h)
    # instance types go LAST and never create keys (active-key compaction:
    # see add_values_for_active_keys) — the key set above is exactly what
    # left-side states can ever define, so compat on any other key is
    # statically true and the lanes would be dead weight in the hot
    # [bins x instance-types] product
    for it in instance_types:
        vocab.add_values_for_active_keys(it.requirements)
        for o in it.offerings:
            vocab.value(wk.LABEL_TOPOLOGY_ZONE, o.zone)
            vocab.value(wk.CAPACITY_TYPE_LABEL_KEY, o.capacity_type)
    return vocab


def _reqs_digest(reqs: Requirements):
    """Canonical hashable form of a Requirements object — the encode fold
    is a pure function of it, so identical-class entities (duplicated pods,
    repeated templates) share one fold."""
    return tuple(
        sorted(
            (
                key,
                r.complement,
                frozenset(r.values),
                r.greater_than,
                r.less_than,
            )
            for key, r in ((k, reqs.get(k)) for k in reqs)
        )
    )


def encode_reqs_with_vocab(
    entities: Sequence[Requirements], vocab: _Vocab, lane_valid: np.ndarray
) -> ReqTensor:
    """Requirement rows under a fixed vocabulary. Row content is a pure
    function of (requirements, vocab), so the streaming delta encoder can
    build rows for just the new pods and splice them next to cached rows
    while staying bit-identical to a cold encode."""
    K, V = lane_valid.shape
    E = len(entities)
    # fold to requirement CLASSES first: at 10k diverse pods only a
    # few hundred exist, and the per-value has() probing is the
    # dominant host cost of this section (PERF_NOTES item 4). The
    # tensors are then built once per class and every entity row is
    # ONE fancy-index gather — no per-pod numpy row copies
    folded: Dict[tuple, int] = {}
    reps: List[Requirements] = []
    cls_of = np.empty(E, dtype=np.int32)
    for e, reqs in enumerate(entities):
        digest = _reqs_digest(reqs)
        ci = folded.get(digest)
        if ci is None:
            ci = folded[digest] = len(reps)
            reps.append(reqs)
        cls_of[e] = ci
    U = len(reps)
    admitted = np.zeros((U, K, V), dtype=bool)
    comp = np.zeros((U, K), dtype=bool)
    gt = np.full((U, K), GT_NONE, dtype=np.int32)
    lt = np.full((U, K), LT_NONE, dtype=np.int32)
    defined = np.zeros((U, K), dtype=bool)
    for u, reqs in enumerate(reps):
        # undefined keys are identity elements: full-admit complements
        admitted[u] = lane_valid
        comp[u] = True
        for key in reqs:
            r = reqs.get(key)
            # inactive key (instance-type rows only): no left-side
            # state defines it, so Intersects can't fail on it —
            # leaving the row undefined here is exact
            ki = vocab.key_index.get(key)
            if ki is None:
                continue
            defined[u, ki] = True
            comp[u, ki] = r.complement
            if r.greater_than is not None:
                gt[u, ki] = r.greater_than
            if r.less_than is not None:
                lt[u, ki] = r.less_than
            row = np.zeros(V, dtype=bool)
            for value, vi in vocab.values[ki].items():
                row[vi] = r.has(value)
            admitted[u, ki] = row
    return ReqTensor(
        admitted=admitted[cls_of],
        comp=comp[cls_of],
        gt=gt[cls_of],
        lt=lt[cls_of],
        defined=defined[cls_of],
    )


def segment_runs(
    pod_reqs: ReqTensor,
    pod_strict_reqs: ReqTensor,
    pod_requests: np.ndarray,
    pod_tol_tpl: np.ndarray,
    pod_tol_node: np.ndarray,
    pod_ports: np.ndarray,
    pod_port_conflict: np.ndarray,
    pod_vol_counts: np.ndarray,
    pod_grp_match: np.ndarray,
    pod_grp_selects: np.ndarray,
    pod_grp_owned: np.ndarray,
    G: int,
):
    """Run segmentation over the assembled pod-axis arrays: consecutive queue
    rows with identical encodings commit as one scan step (ops/ffd.py run
    solver); topology-inert runs take the closed-form analytic commit; runs
    that interact with topology groups take the light per-pod inner loop
    (ops/topo_runs.py) unless they carry host ports or CSI volumes (whose
    within-run interactions the closed node-capacity form does not model —
    those stay on the per-pod step). Eligibility is re-checked on byte
    equality of the encoded rows themselves, so the sort-signature heuristic
    can never cause a false merge. Module-level (shared with
    streaming/delta.py) so patched encodes segment identically to cold ones.

    Returns (run_start, run_len, run_mode, pod_eqprev, pod_eqprev_gate,
    pod_eqprev_chain)."""
    from karpenter_tpu_torch.models.problem import RUN_ANALYTIC, RUN_SINGLE, RUN_TOPO

    P = len(pod_requests)
    # gate_interacts: some group GATES this pod's placement (matched
    # regular groups / victim of an inverse group). selects-only pods are
    # merely COUNTED by other pods' groups — their placement decisions
    # are topology-blind, and their record deltas aggregate per bin, so
    # the analytic run commit handles them exactly (its record sum).
    gate_interacts = (
        pod_grp_match.any(axis=1) | pod_grp_owned.any(axis=1)
    ) if G else np.zeros(P, dtype=bool)
    interacts = (
        gate_interacts | pod_grp_selects.any(axis=1)
    ) if G else np.zeros(P, dtype=bool)
    has_ports = pod_ports.any(axis=1) if pod_ports.size else np.zeros(P, dtype=bool)
    has_vols = (
        pod_vol_counts.any(axis=1) if pod_vol_counts.size else np.zeros(P, dtype=bool)
    )
    mergeable = ~(interacts & (has_ports | has_vols))
    # run formation needs only CONSECUTIVE-row equality of the encoded
    # lanes, which vectorizes to one elementwise comparison per array —
    # no hashing. Equal rows have equal interacts/ports/vols, so checking
    # mergeable[i] for the run head covers every member.
    if P > 1:
        same_as_prev = np.ones(P, dtype=bool)
        same_as_prev[0] = False
        for a in (
            pod_reqs.admitted, pod_reqs.comp, pod_reqs.gt, pod_reqs.lt,
            pod_reqs.defined, pod_strict_reqs.admitted,
            pod_strict_reqs.comp, pod_strict_reqs.gt,
            pod_strict_reqs.lt, pod_strict_reqs.defined,
            pod_requests, pod_tol_tpl, pod_tol_node,
            pod_ports, pod_port_conflict, pod_vol_counts,
            pod_grp_match, pod_grp_selects, pod_grp_owned,
        ):
            if a.size:
                flat = a.reshape(P, -1)
                same_as_prev[1:] &= (flat[1:] == flat[:-1]).all(axis=1)
    else:
        same_as_prev = np.zeros(P, dtype=bool)
    pod_eqprev = same_as_prev.copy()  # byte-identity with the previous row
    # gate-identity: equality over only the arrays that can influence a
    # topology-blind pod's own placement (labels/selectors may differ —
    # they only change who counts whom, which the analytic commit's
    # record sum aggregates exactly). Only meaningful between rows that
    # are NOT gate-interacting and carry no ports/volumes when records
    # are in play (mirroring `mergeable`).
    if P > 1:
        gate_same = np.ones(P, dtype=bool)
        gate_same[0] = False
        for a in (
            pod_reqs.admitted, pod_reqs.comp, pod_reqs.gt, pod_reqs.lt,
            pod_reqs.defined, pod_requests, pod_tol_tpl, pod_tol_node,
            pod_ports, pod_port_conflict, pod_vol_counts,
        ):
            if a.size:
                flat = a.reshape(P, -1)
                gate_same[1:] &= (flat[1:] == flat[:-1]).all(axis=1)
        eligible = ~gate_interacts & mergeable
        gate_same &= eligible
        gate_same[1:] &= eligible[:-1]
    else:
        gate_same = np.zeros(P, dtype=bool)
    pod_eqprev_gate = gate_same
    # CHAIN-identity: equality over every array that can influence a
    # pod's OWN placement verdict. The full select side may differ (own
    # labels) — no gate reads it except through match∩selects (spread
    # self-count, affinity self-select bootstrap), which IS compared.
    # Differing selects only change who records whom, and both chain
    # consumers (the stride's weighted record, the run commits'
    # per-member record gather) sum records per member, so a chain
    # commit stays bit-identical to stepping its members one at a time.
    if P > 1 and G:
        chain_same = np.ones(P, dtype=bool)
        chain_same[0] = False
        for a in (
            pod_reqs.admitted, pod_reqs.comp, pod_reqs.gt, pod_reqs.lt,
            pod_reqs.defined, pod_strict_reqs.admitted,
            pod_strict_reqs.comp, pod_strict_reqs.gt,
            pod_strict_reqs.lt, pod_strict_reqs.defined,
            pod_requests, pod_tol_tpl, pod_tol_node,
            pod_ports, pod_port_conflict, pod_vol_counts,
            pod_grp_match, pod_grp_owned,
            pod_grp_match & pod_grp_selects,
        ):
            if a.size:
                flat = a.reshape(P, -1)
                chain_same[1:] &= (flat[1:] == flat[:-1]).all(axis=1)
        # ports/volumes + topology interaction stays per-pod (mirrors
        # `mergeable`): the chain commits don't model within-chain port
        # and CSI interactions against shifting topology counters
        chain_same &= mergeable
        chain_same[1:] &= mergeable[:-1]
        pod_eqprev_chain = pod_eqprev | chain_same
    else:
        pod_eqprev_chain = pod_eqprev.copy()
    run_start_l: List[int] = []
    run_len_l: List[int] = []
    run_mode_l: List[int] = []
    i = 0
    while i < P:
        j = i + 1
        if mergeable[i]:
            # runs extend over byte-identical rows AND chain-identical
            # ones: the analytic commit (ops/ffd_runs.py) gathers each
            # member's select row for its record sum, and the topo run
            # commit (ops/topo_runs.py) rebuilds the per-member
            # PodTopoStatics, so both stay exact when only the select
            # side differs across the run
            while j < P and j - i < MAX_RUN_LEN and pod_eqprev_chain[j]:
                j += 1
        run_start_l.append(i)
        run_len_l.append(j - i)
        # length-1 runs go through the battle-tested per-pod step; the
        # run commits are only entered when they actually pay
        if j - i == 1:
            run_mode_l.append(RUN_SINGLE)
        elif gate_interacts[i]:
            run_mode_l.append(RUN_TOPO)
        else:
            run_mode_l.append(RUN_ANALYTIC)
        i = j
    return (
        np.array(run_start_l, dtype=np.int32),
        np.array(run_len_l, dtype=np.int32),
        np.array(run_mode_l, dtype=np.int32),
        pod_eqprev,
        pod_eqprev_gate,
        pod_eqprev_chain,
    )


class Encoder:
    """Encodes one scheduling batch. The vocabulary is rebuilt per batch —
    label spaces are open-ended, so there is no global dictionary to maintain
    (SURVEY.md §7 'per-batch dictionary + explicit residual')."""

    def __init__(self, well_known_labels: frozenset = wk.WELL_KNOWN_LABELS):
        self.well_known = well_known_labels

    def encode(
        self,
        pods: Sequence[Pod],
        instance_types: Sequence[InstanceType],
        templates: Sequence[TemplateInfo],
        nodes: Sequence[NodeInfo] = (),
        pod_reqs_override: Optional[Sequence[Requirements]] = None,
        topology: Optional[Topology] = None,
        num_claim_slots: int = 0,
        vocab_pods: Optional[Sequence[Pod]] = None,
        vocab_reqs: Optional[Sequence[Requirements]] = None,
        pod_volumes: Optional[Sequence[Dict[str, frozenset]]] = None,
        vocab_nodes: Optional[Sequence[NodeInfo]] = None,
        vocab_resources: Optional[Sequence[str]] = None,
    ) -> EncodedProblem:
        """``vocab_pods`` seeds the vocabulary (defaults to ``pods``): across
        the relax-and-retry passes the vocabulary must stay identical so the
        carried solver state keeps valid lane indices — callers pass the
        original unrelaxed batch there while ``pods`` shrinks to the retry
        queue. ``vocab_reqs`` seeds requirement sets that exist outside any pod
        spec (the full pod_reqs_override universe) for the same reason.
        ``vocab_nodes`` and ``vocab_resources`` extend the same freeze to the
        node-label / host-port / CSI-driver vocabularies and the resource-axis
        ordering: the partitioned solve (shard/) encodes disjoint pod/node
        slices that must stack into ONE batched program, so every
        shape-determining dictionary is seeded from the full batch while the
        tensor sections cover only this partition's rows."""
        # -- 1. FFD queue order: cpu desc, mem desc, creation, uid (queue.go:76-111)
        pod_reqs_list = (
            list(pod_reqs_override)
            if pod_reqs_override is not None
            else [pod_requirements(p) for p in pods]
        )
        pod_strict_list = (
            list(pod_reqs_list)
            if pod_reqs_override is not None
            else [
                strict_pod_requirements(p) if has_preferred_node_affinity(p) else r
                for p, r in zip(pods, pod_reqs_list)
            ]
        )
        # requests are re-read for several tensors below; pods never mutate
        # within one encode call, so memoize by object identity
        _req_memo: Dict[int, Dict[str, float]] = {}

        def preq(p):
            r = _req_memo.get(id(p))
            if r is None:
                r = res.pod_requests(p)
                _req_memo[id(p)] = r
            return r

        order = ffd_order(pods, requests_of=preq)
        pods = [pods[i] for i in order]
        pod_reqs_list = [pod_reqs_list[i] for i in order]
        pod_strict_list = [pod_strict_list[i] for i in order]
        pod_volumes_list = (
            [pod_volumes[i] for i in order] if pod_volumes is not None else None
        )
        if vocab_pods is None:
            vocab_pods = pods
        if vocab_nodes is None:
            vocab_nodes = nodes

        groups = []
        if topology is not None:
            groups = list(topology.topologies.values()) + list(
                topology.inverse_topologies.values()
            )
            inverse_from = len(topology.topologies)

        # -- 2. vocabulary over every value mentioned anywhere (build_vocab —
        # shared with streaming/delta.py, which replays it to prove lane
        # stability before patching rows)
        claim_hostnames = [claim_hostname(i) for i in range(num_claim_slots)]
        vocab = build_vocab(
            vocab_pods,
            templates,
            vocab_nodes,
            groups,
            claim_hostnames,
            instance_types,
            override_reqs_list=(
                pod_reqs_list if pod_reqs_override is not None else None
            ),
            vocab_reqs=vocab_reqs,
        )
        zone_k, ct_k, hostname_k = ZONE_KEY, CT_KEY, HOSTNAME_KEY

        K = len(vocab.keys)
        V = max((len(v) for v in vocab.values), default=1) or 1

        lane_valid = np.zeros((K, V), dtype=bool)
        lane_numeric = np.full((K, V), np.nan, dtype=np.float32)
        lane_lex_rank = np.full((K, V), 2**30, dtype=np.int32)
        for ki, vals in enumerate(vocab.values):
            for value, vi in vals.items():
                lane_valid[ki, vi] = True
                try:
                    lane_numeric[ki, vi] = float(int(value))
                except ValueError:
                    pass
            for rank, value in enumerate(sorted(vals)):
                lane_lex_rank[ki, vals[value]] = rank
        key_wellknown = np.array([k in self.well_known for k in vocab.keys], dtype=bool)

        # -- 3. resource axis
        resource_names = (
            list(vocab_resources)
            if vocab_resources is not None
            else [res.CPU, res.MEMORY, res.PODS, res.EPHEMERAL_STORAGE]
        )
        seen = set(resource_names)

        def note_resources(rl):
            for name in rl:
                if name not in seen:
                    seen.add(name)
                    resource_names.append(name)

        for p in pods:
            note_resources(preq(p))
        for it in instance_types:
            note_resources(it.capacity)
        for t in templates:
            note_resources(t.daemon_overhead)
        for n in vocab_nodes:
            note_resources(n.available)

        # -- 4. requirement tensors (encode_reqs_with_vocab — shared with the
        # streaming delta encoder so spliced new-pod rows are bit-identical)
        def encode_reqs(entities: List[Requirements]) -> ReqTensor:
            return encode_reqs_with_vocab(entities, vocab, lane_valid)

        pod_reqs = encode_reqs(pod_reqs_list)
        pod_strict_reqs = encode_reqs(pod_strict_list)
        it_reqs = encode_reqs([it.requirements for it in instance_types])
        # the run commit hoists its template x instance-type product out of
        # the claim-open loop on the invariant that instance types never
        # define the hostname key (a fresh claim's minted hostname exists
        # precisely because nothing else names it, nodeclaim.go:46-63);
        # enforce the hoist's precondition here rather than assuming it
        if it_reqs.defined[:, HOSTNAME_KEY].any():  # survive python -O
            raise AssertionError(
                "instance type requirements must not define the hostname key"
            )
        tpl_reqs = encode_reqs([t.requirements for t in templates])
        node_reqs = encode_reqs([n.requirements for n in nodes])

        # -- 5. resources
        def dense(rl) -> np.ndarray:
            return np.array(res.to_dense(rl, resource_names), dtype=np.float32)

        pod_requests = np.stack(
            [dense({**preq(p), res.PODS: 1.0}) for p in pods]
        ) if pods else np.zeros((0, len(resource_names)), dtype=np.float32)
        it_alloc = np.stack([dense(it.allocatable()) for it in instance_types]) if instance_types else np.zeros((0, len(resource_names)), dtype=np.float32)
        it_cap = np.stack([dense(it.capacity) for it in instance_types]) if instance_types else np.zeros((0, len(resource_names)), dtype=np.float32)
        tpl_overhead = np.stack([dense(t.daemon_overhead) for t in templates]) if templates else np.zeros((0, len(resource_names)), dtype=np.float32)
        node_avail = np.stack([dense(n.available) for n in nodes]) if nodes else np.zeros((0, len(resource_names)), dtype=np.float32)
        node_overhead = np.stack([dense(n.daemon_overhead) for n in nodes]) if nodes else np.zeros((0, len(resource_names)), dtype=np.float32)

        # -- 6. offerings
        T = len(instance_types)
        O = max((len(it.offerings) for it in instance_types), default=1) or 1
        offer_zone = np.zeros((T, O), dtype=np.int32)
        offer_ct = np.zeros((T, O), dtype=np.int32)
        offer_ok = np.zeros((T, O), dtype=bool)
        offer_price = np.full((T, O), np.inf, dtype=np.float32)
        for ti, it in enumerate(instance_types):
            for oi, o in enumerate(it.offerings):
                offer_zone[ti, oi] = vocab.values[zone_k][o.zone]
                offer_ct[ti, oi] = vocab.values[ct_k][o.capacity_type]
                offer_ok[ti, oi] = o.available
                offer_price[ti, oi] = o.price
        # dense (zone-lane x ct-lane) availability per instance type, the
        # has_offering table of masks.has_offering_zc (the JAX package's solver
        # reads it; this package's solver uses the per-offering lanes, which
        # give the same verdicts). Only built when both sub-vocabularies fit
        # the fixed 32-lane window; otherwise None.
        n_zone = len(vocab.values[zone_k])
        n_ct = len(vocab.values[ct_k])
        if n_zone <= 32 and n_ct <= 32:
            zb = int(pow2_bucket(max(n_zone, 1), lo=8))
            cb = int(pow2_bucket(max(n_ct, 1), lo=8))
            offer_zc = np.zeros((T, zb, cb), dtype=bool)
            np.logical_or.at(
                offer_zc,
                (np.arange(T)[:, None].repeat(O, 1), offer_zone, offer_ct),
                offer_ok,
            )
        else:
            offer_zc = None

        # -- 7. templates' instance-type universes + taints + limit headroom
        TPL = len(templates)
        tpl_it_ok = np.zeros((TPL, T), dtype=bool)
        tpl_remaining = np.full((TPL, len(resource_names)), np.inf, dtype=np.float32)
        for ti, t in enumerate(templates):
            tpl_it_ok[ti, list(t.instance_type_indices)] = True
            if t.remaining_resources is not None:
                for ri, name in enumerate(resource_names):
                    if name in t.remaining_resources:
                        tpl_remaining[ti, ri] = t.remaining_resources[name]

        # toleration folding: tolerates() reads only pod.spec.tolerations
        # (a tuple of frozen dataclasses), so a 10k batch collapses to a
        # handful of toleration CLASSES — compute one row per class and
        # expand by fancy index instead of P x TPL / P x N python loops
        tol_cls: Dict[tuple, int] = {}
        tol_reps: List[Pod] = []
        pod_tol_cls = np.empty(len(pods), dtype=np.int32)
        for pi, p in enumerate(pods):
            tk = tuple(p.spec.tolerations)
            ci = tol_cls.get(tk)
            if ci is None:
                ci = tol_cls[tk] = len(tol_reps)
                tol_reps.append(p)
            pod_tol_cls[pi] = ci
        cls_tol_tpl = np.zeros((len(tol_reps), TPL), dtype=bool)
        for ci, rep in enumerate(tol_reps):
            for ti, t in enumerate(templates):
                cls_tol_tpl[ci, ti] = not t.taints.tolerates(rep)
        cls_tol_node = np.zeros((len(tol_reps), len(nodes)), dtype=bool)
        for ci, rep in enumerate(tol_reps):
            for ni, n in enumerate(nodes):
                cls_tol_node[ci, ni] = not n.taints.tolerates(rep)
        pod_tol_tpl = cls_tol_tpl[pod_tol_cls]
        pod_tol_node = cls_tol_node[pod_tol_cls]

        # -- 8. host-port lanes: vocab over every distinct port tuple in the
        # batch, with a precomputed lane-vs-lane conflict matrix (wildcard IPs
        # fold in here, so the device check is a plain mask AND). Lanes come
        # from the frozen vocab_pods so carried port masks stay valid across
        # relax passes.
        pod_port_lists = [get_host_ports(p) for p in pods]
        port_vocab: Dict[HostPort, int] = {}
        for p in vocab_pods:
            for hp in get_host_ports(p):
                port_vocab.setdefault(hp, len(port_vocab))
        for n in vocab_nodes:
            for hp in n.host_ports:
                port_vocab.setdefault(hp, len(port_vocab))
        PT = max(len(port_vocab), 1)
        lanes = list(port_vocab.keys())
        conflict = np.zeros((PT, PT), dtype=bool)
        for a, hp_a in enumerate(lanes):
            for b, hp_b in enumerate(lanes):
                conflict[a, b] = hp_a.matches(hp_b)
        # port-row folding, same class trick as tolerations: the rows are a
        # pure function of the pod's port tuple (almost always empty), so
        # build one (ports, conflict) row pair per distinct tuple
        pod_ports = np.zeros((len(pods), PT), dtype=bool)
        pod_port_conflict = np.zeros((len(pods), PT), dtype=bool)
        port_rows: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}
        for pi, plist in enumerate(pod_port_lists):
            pk = tuple(plist)
            rows = port_rows.get(pk)
            if rows is None:
                prow = np.zeros(PT, dtype=bool)
                crow = np.zeros(PT, dtype=bool)
                for hp in plist:
                    li = port_vocab[hp]
                    prow[li] = True
                    crow |= conflict[li]
                rows = port_rows[pk] = (prow, crow)
            pod_ports[pi] = rows[0]
            pod_port_conflict[pi] = rows[1]
        # -- CSI attach limits: one lane per driver that is limited on some
        # node (drivers no node limits never gate; see volumeusage.py)
        drivers = sorted({d for n in vocab_nodes for d in n.volume_limits})
        D = len(drivers)
        driver_idx = {d: i for i, d in enumerate(drivers)}
        pod_vol_counts = np.zeros((len(pods), D), dtype=np.int32)
        if pod_volumes_list is not None and D:
            for pi, vols in enumerate(pod_volumes_list):
                for d, ids in (vols or {}).items():
                    if d in driver_idx:
                        pod_vol_counts[pi, driver_idx[d]] = len(ids)
        node_vol_used = np.zeros((len(nodes), D), dtype=np.int32)
        node_vol_limits = np.full((len(nodes), D), 2**30, dtype=np.int32)
        for ni, n in enumerate(nodes):
            for d, count in n.volume_used.items():
                if d in driver_idx:
                    node_vol_used[ni, driver_idx[d]] = count
            for d, limit in n.volume_limits.items():
                node_vol_limits[ni, driver_idx[d]] = limit

        node_used_ports = np.zeros((len(nodes), PT), dtype=bool)
        for ni, n in enumerate(nodes):
            for hp in n.host_ports:
                node_used_ports[ni, port_vocab[hp]] = True

        # -- 9. topology groups (regular first, then inverse)
        G = len(groups)
        # F=0 when no group carries a real node filter (the common case): the
        # record() filter product then vmaps over an empty axis and compiles
        # away entirely. A filter containing an EMPTY term matches every node
        # (OR semantics, and an empty Requirements is Compatible with
        # anything), so such a filter is equivalent to no filter at all —
        # TopologyNodeFilter.for_pod emits exactly that for pods without node
        # affinity.
        def _real_terms(tg):
            terms = list(tg.node_filter.terms)
            if any(len(t) == 0 for t in terms):
                return []
            return terms

        F = max((len(_real_terms(tg)) for tg in groups), default=0)
        grp_type = np.zeros(G, dtype=np.int32)
        grp_key = np.zeros(G, dtype=np.int32)
        grp_max_skew = np.full(G, 2**31 - 1, dtype=np.int32)
        grp_min_domains = np.full(G, -1, dtype=np.int32)
        grp_counts0 = np.zeros((G, V), dtype=np.int32)
        grp_registered0 = np.zeros((G, V), dtype=bool)
        grp_inverse = np.zeros(G, dtype=bool)
        grp_has_filter = np.zeros(G, dtype=bool)
        grp_filter_valid = np.zeros((G, F), dtype=bool)
        filter_rows: List[Requirements] = []
        for gi, tg in enumerate(groups):
            grp_type[gi] = tg.type
            grp_key[gi] = vocab.key_index[tg.key]
            grp_max_skew[gi] = tg.max_skew
            if tg.min_domains is not None:
                grp_min_domains[gi] = tg.min_domains
            grp_inverse[gi] = topology is not None and gi >= inverse_from
            for domain, count in tg.domains.items():
                lane = vocab.values[grp_key[gi]][domain]
                grp_registered0[gi, lane] = True
                grp_counts0[gi, lane] = count
            terms = _real_terms(tg)
            grp_has_filter[gi] = bool(terms)
            for fi, term in enumerate(terms):
                grp_filter_valid[gi, fi] = True
            filter_rows.extend(terms + [Requirements()] * (F - len(terms)))
        grp_filter_flat = encode_reqs(filter_rows)  # [(G*F), K, V]
        grp_filter = ReqTensor(
            admitted=grp_filter_flat.admitted.reshape(G, F, K, V),
            comp=grp_filter_flat.comp.reshape(G, F, K),
            gt=grp_filter_flat.gt.reshape(G, F, K),
            lt=grp_filter_flat.lt.reshape(G, F, K),
            defined=grp_filter_flat.defined.reshape(G, F, K),
        ) if G else ReqTensor(
            admitted=np.zeros((0, F, K, V), dtype=bool),
            comp=np.zeros((0, F, K), dtype=bool),
            gt=np.zeros((0, F, K), dtype=np.int32),
            lt=np.zeros((0, F, K), dtype=np.int32),
            defined=np.zeros((0, F, K), dtype=bool),
        )
        pod_grp_selects = np.zeros((len(pods), G), dtype=bool)
        pod_grp_owned = np.zeros((len(pods), G), dtype=bool)
        # selects() depends only on (namespace, labels) — a large batch has
        # few distinct label sets, so cache rows instead of P x G matching;
        # ownership inverts each group's owner set instead of P x G lookups
        # one row per uid: the queue is deduplicated upstream, so a uid maps
        # to exactly one batch row — if that ever changes, ownership marking
        # must mark EVERY row of the uid, not just the last
        if len({p.uid for p in pods}) != len(pods):  # survive python -O
            raise AssertionError("duplicate pod uid in batch")
        uid_to_pi = {p.uid: pi for pi, p in enumerate(pods)}
        for gi, tg in enumerate(groups):
            for uid in tg.owners:
                pi = uid_to_pi.get(uid)
                if pi is not None:
                    pod_grp_owned[pi, gi] = True
        sel_cache: Dict[Tuple, np.ndarray] = {}
        for pi, p in enumerate(pods):
            lk = (p.namespace, tuple(sorted(p.metadata.labels.items())))
            row = sel_cache.get(lk)
            if row is None:
                row = np.fromiter((tg.selects(p) for tg in groups), bool, G)
                sel_cache[lk] = row
            pod_grp_selects[pi] = row
        pod_grp_match = np.where(
            grp_inverse[None, :], pod_grp_selects, pod_grp_owned
        ) if G else np.zeros((len(pods), G), dtype=bool)
        claim_hostname_lane = np.array(
            [vocab.values[hostname_k][h] for h in claim_hostnames], dtype=np.int32
        )

        # -- 10. run segmentation (segment_runs -- shared with the streaming
        # delta encoder so patched encodes segment identically to cold ones)
        P = len(pods)
        (
            run_start,
            run_len,
            run_mode,
            pod_eqprev,
            pod_eqprev_gate,
            pod_eqprev_chain,
        ) = segment_runs(
            pod_reqs, pod_strict_reqs, pod_requests, pod_tol_tpl, pod_tol_node,
            pod_ports, pod_port_conflict, pod_vol_counts,
            pod_grp_match, pod_grp_selects, pod_grp_owned, G,
        )
        pod_active = np.ones(P, dtype=bool)

        problem = SchedulingProblem(
            lane_valid=lane_valid,
            lane_numeric=lane_numeric,
            lane_lex_rank=lane_lex_rank,
            key_wellknown=key_wellknown,
            pod_reqs=pod_reqs,
            pod_requests=pod_requests,
            pod_tol_tpl=pod_tol_tpl,
            pod_tol_node=pod_tol_node,
            pod_ports=pod_ports,
            pod_port_conflict=pod_port_conflict,
            pod_strict_reqs=pod_strict_reqs,
            it_reqs=it_reqs,
            it_alloc=it_alloc,
            it_cap=it_cap,
            offer_zone=offer_zone,
            offer_ct=offer_ct,
            offer_ok=offer_ok,
            offer_price=offer_price,
            offer_zc=offer_zc,
            tpl_reqs=tpl_reqs,
            tpl_overhead=tpl_overhead,
            tpl_it_ok=tpl_it_ok,
            tpl_remaining=tpl_remaining,
            node_reqs=node_reqs,
            node_avail=node_avail,
            node_overhead=node_overhead,
            node_used_ports=node_used_ports,
            pod_vol_counts=pod_vol_counts,
            node_vol_used=node_vol_used,
            node_vol_limits=node_vol_limits,
            grp_type=grp_type,
            grp_key=grp_key,
            grp_max_skew=grp_max_skew,
            grp_min_domains=grp_min_domains,
            grp_counts0=grp_counts0,
            grp_registered0=grp_registered0,
            grp_inverse=grp_inverse,
            grp_has_filter=grp_has_filter,
            grp_filter=grp_filter,
            grp_filter_valid=grp_filter_valid,
            pod_grp_match=pod_grp_match,
            pod_grp_selects=pod_grp_selects,
            pod_grp_owned=pod_grp_owned,
            claim_hostname_lane=claim_hostname_lane,
            pod_active=pod_active,
            run_start=run_start,
            run_len=run_len,
            run_mode=run_mode,
            pod_eqprev=pod_eqprev,
            pod_eqprev_gate=pod_eqprev_gate,
            pod_eqprev_chain=pod_eqprev_chain,
        )
        meta = ProblemMeta(
            keys=list(vocab.keys),
            values_per_key=[
                [v for v, _ in sorted(vals.items(), key=lambda kv: kv[1])]
                for vals in vocab.values
            ],
            resource_names=resource_names,
            pod_order=order,
            template_names=[t.nodepool_name for t in templates],
            instance_type_names=[it.name for it in instance_types],
            node_names=[n.name for n in nodes],
            zone_key_idx=zone_k,
            ct_key_idx=ct_k,
            hostname_key_idx=hostname_k,
        )
        return EncodedProblem(problem=problem, meta=meta)


def claim_hostname(slot: int) -> str:
    """Placeholder hostname minted per claim for hostname-topology purposes
    (nodeclaim.go:48); both solver backends must agree on the naming."""
    return f"hostname-placeholder-{slot:04d}"


def domains_from_instance_types(
    instance_types: Sequence[InstanceType], templates: Sequence[TemplateInfo] = ()
) -> Dict[str, set]:
    """Default per-key domain universe: every value an instance type or
    template requirement could produce (the provisioner's domain census,
    provisioner.go:248-281)."""
    domains: Dict[str, set] = {}
    for it in instance_types:
        for key in it.requirements:
            r = it.requirements.get(key)
            if not r.complement:
                domains.setdefault(key, set()).update(r.values)
    for t in templates:
        for key in t.requirements:
            r = t.requirements.get(key)
            if not r.complement:
                domains.setdefault(key, set()).update(r.values)
    return domains


def template_from_nodepool(
    nodepool: NodePool,
    instance_types: Sequence[InstanceType],
    instance_type_indices: Sequence[int],
    daemon_pods: Sequence[Pod] = (),
) -> TemplateInfo:
    """Build a TemplateInfo the way NewNodeClaimTemplate + getDaemonOverhead do
    (nodeclaimtemplate.go:43-53, scheduler.go:324-341)."""
    tpl = nodepool.spec.template
    requirements = Requirements()
    requirements.add(
        *Requirements.from_node_selector_requirements(*tpl.spec.requirements).values()
    )
    labels = {**tpl.labels, wk.NODEPOOL_LABEL_KEY: nodepool.name}
    requirements.add(*label_requirements(labels).values())
    taints = Taints(tpl.spec.taints)

    daemons = []
    for p in daemon_pods:
        if taints.tolerates(p):
            continue
        if not requirements.is_compatible(pod_requirements(p), wk.WELL_KNOWN_LABELS):
            continue
        daemons.append(p)
    overhead = res.requests_for_pods(*daemons) if daemons else {}

    return TemplateInfo(
        nodepool_name=nodepool.name,
        requirements=requirements,
        taints=taints,
        daemon_overhead=overhead,
        instance_type_indices=list(instance_type_indices),
    )
