"""Incremental delta encode: snapshot diffing + row-patched SchedulingProblem.

Counterpart of the JAX package's ``streaming/delta.py``. The class-keyed
encoder makes every pod-axis tensor a pure function of (pod spec, frozen
vocabulary): requirement rows gather from per-class tables, toleration/port
rows fold by class, and run segmentation reads only the assembled rows. That
purity is what makes churn a *row patch*: when the vocabulary, resource
axis, port lanes, and the instance-type/template/node sides are provably
unchanged, a new snapshot's problem is the previous problem with rows
gathered for surviving pods and freshly encoded rows spliced in for
arrivals — bit-identical to a cold encode by construction, because both
paths run the same shared functions (``build_vocab``,
``encode_reqs_with_vocab``, ``segment_runs`` in solver/encode.py) over the
same inputs.

``DeltaEncoder`` never guesses: every precondition is *checked*, not assumed
(the vocabulary is rebuilt and compared, the resource axis re-derived, port
lanes re-interned), and any mismatch falls back to a cold encode with the
reason recorded in ``last_patch``. tests/test_torch_world.py holds the
patched encode to the cold one, and to the JAX package's delta encode,
array for array.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.models.problem import (
    CT_KEY,
    HOSTNAME_KEY,
    ProblemMeta,
    ReqTensor,
    SchedulingProblem,
    ZONE_KEY,
)
from karpenter_tpu_torch.scheduling import (
    has_preferred_node_affinity,
    pod_requirements,
    strict_pod_requirements,
)
from karpenter_tpu_torch.scheduling.hostports import HostPort, get_host_ports
from karpenter_tpu_torch.solver.encode import (
    EncodedProblem,
    Encoder,
    NodeInfo,
    TemplateInfo,
    _Vocab,
    build_vocab,
    claim_hostname,
    encode_reqs_with_vocab,
    ffd_order,
    segment_runs,
    vocab_from_meta,
)
from karpenter_tpu_torch.utils import resources as res


def _digest(parts: Sequence[str]) -> str:
    return hashlib.blake2b("|".join(parts).encode(), digest_size=16).hexdigest()


def pod_digest(p: Pod) -> str:
    """Deterministic digest of every pod field any encoded tensor reads
    (selectors, affinity, tolerations, spread, containers incl. requests and
    ports, labels, FFD sort inputs). Two pods with equal digests produce
    byte-identical encoded rows under the same vocabulary; an imprecise
    (over-wide) digest only costs reuse, never correctness."""
    spec = p.spec
    return _digest(
        (
            p.namespace,
            p.metadata.name,
            repr(sorted((p.metadata.labels or {}).items())),
            repr(sorted(spec.node_selector.items())),
            repr(spec.affinity),
            repr(spec.tolerations),
            repr(spec.topology_spread_constraints),
            repr(spec.containers),
            repr(spec.init_containers),
            repr(sorted(spec.overhead.items())),
            repr(spec.volumes),
            repr(p.metadata.creation_timestamp),
            str(p.metadata.creation_seq),
        )
    )


def node_info_digest(n: NodeInfo) -> str:
    """Digest of every NodeInfo field the encode reads. A changed digest
    under the same name means the node's gates may have moved (capacity,
    taints, ports, CSI state) — the delta layer treats it as remove+add."""
    return _digest(
        (
            n.name,
            repr(n.requirements),
            repr(list(n.taints)),
            repr(sorted(n.available.items())),
            repr(sorted(n.daemon_overhead.items())),
            repr(sorted(str(hp) for hp in n.host_ports)),
            repr(sorted(n.volume_used.items())),
            repr(sorted(n.volume_limits.items())),
        )
    )


def template_digest(t: TemplateInfo) -> str:
    return _digest(
        (
            t.nodepool_name,
            repr(t.requirements),
            repr(list(t.taints)),
            repr(sorted(t.daemon_overhead.items())),
            repr(list(t.instance_type_indices)),
            repr(sorted(t.remaining_resources.items()))
            if t.remaining_resources is not None
            else "None",
        )
    )


def instance_type_digest(it: InstanceType) -> str:
    return _digest(
        (
            it.name,
            repr(it.requirements),
            repr(sorted(it.capacity.items())),
            repr(
                [
                    (o.zone, o.capacity_type, o.available, o.price)
                    for o in it.offerings
                ]
            ),
        )
    )


@dataclass
class SnapshotDelta:
    """What changed between two cluster snapshots, in terms the delta
    encoder consumes. Pod entries are indices into the
    *current* pod list (uids for removals — they have no current index)."""

    added_pods: List[int] = field(default_factory=list)
    changed_pods: List[int] = field(default_factory=list)
    removed_pods: List[str] = field(default_factory=list)
    added_nodes: List[str] = field(default_factory=list)
    changed_nodes: List[str] = field(default_factory=list)
    removed_nodes: List[str] = field(default_factory=list)
    templates_changed: bool = False
    its_changed: bool = False
    prev_pod_count: int = 0

    @property
    def pod_events(self) -> int:
        return len(self.added_pods) + len(self.changed_pods) + len(self.removed_pods)

    @property
    def node_events(self) -> int:
        return len(self.added_nodes) + len(self.changed_nodes) + len(self.removed_nodes)

    @property
    def frac(self) -> float:
        """Delta fraction: churned pods relative to the previous batch size."""
        return self.pod_events / max(1, self.prev_pod_count)


def diff_snapshots(
    prev_pods: Sequence[Pod],
    prev_nodes: Sequence[NodeInfo],
    cur_pods: Sequence[Pod],
    cur_nodes: Sequence[NodeInfo],
    prev_pod_digests: Optional[Dict[str, str]] = None,
    prev_node_digests: Optional[Dict[str, str]] = None,
) -> Tuple[SnapshotDelta, Dict[str, str], Dict[str, str]]:
    """Diff two snapshots. Returns (delta, cur_pod_digests, cur_node_digests)
    so callers can thread the current digests into the next diff instead of
    recomputing the previous side every cycle."""
    if prev_pod_digests is None:
        prev_pod_digests = {p.uid: pod_digest(p) for p in prev_pods}
    if prev_node_digests is None:
        prev_node_digests = {n.name: node_info_digest(n) for n in prev_nodes}
    delta = SnapshotDelta(prev_pod_count=len(prev_pods))
    cur_pod_digests: Dict[str, str] = {}
    for i, p in enumerate(cur_pods):
        d = cur_pod_digests[p.uid] = pod_digest(p)
        old = prev_pod_digests.get(p.uid)
        if old is None:
            delta.added_pods.append(i)
        elif old != d:
            delta.changed_pods.append(i)
    delta.removed_pods = [u for u in prev_pod_digests if u not in cur_pod_digests]
    cur_node_digests: Dict[str, str] = {}
    for n in cur_nodes:
        d = cur_node_digests[n.name] = node_info_digest(n)
        old = prev_node_digests.get(n.name)
        if old is None:
            delta.added_nodes.append(n.name)
        elif old != d:
            delta.changed_nodes.append(n.name)
    delta.removed_nodes = [
        name for name in prev_node_digests if name not in cur_node_digests
    ]
    return delta, cur_pod_digests, cur_node_digests


@dataclass
class _DeltaState:
    """Everything a row patch gathers from: the previous encode plus the
    host-side side tables (vocab, port lanes, digests) needed to prove the
    patch preconditions and encode arrival rows."""

    pods: List[Pod]  # FFD queue order (matches problem rows)
    uid_row: Dict[str, int]
    pod_digests: Dict[str, str]  # by uid
    nodes: List[NodeInfo]
    node_row: Dict[str, int]
    node_digests: Dict[str, str]  # by name
    problem: SchedulingProblem
    meta: ProblemMeta
    vocab: _Vocab
    port_vocab: Dict[HostPort, int]
    port_conflict: np.ndarray
    drivers: List[str]
    instance_types: List[InstanceType]
    it_digests: List[str]
    templates: List[TemplateInfo]
    tpl_digests: List[str]
    num_claim_slots: int


def _vocabs_equal(a: _Vocab, b: _Vocab) -> bool:
    return a.keys == b.keys and a.values == b.values


def _build_port_vocab(
    sorted_pods: Sequence[Pod], nodes: Sequence[NodeInfo]
) -> Dict[HostPort, int]:
    pv: Dict[HostPort, int] = {}
    for p in sorted_pods:
        for hp in get_host_ports(p):
            pv.setdefault(hp, len(pv))
    for n in nodes:
        for hp in n.host_ports:
            pv.setdefault(hp, len(pv))
    return pv


def _digest_list(objs, fn, cached_objs=None, cached_digests=None):
    """Digest a list with an identity fast path: churn streams pass the same
    instance-type/template objects every cycle, so `is`-equality skips the
    repr work entirely."""
    if (
        cached_objs is not None
        and len(objs) == len(cached_objs)
        and all(a is b for a, b in zip(objs, cached_objs))
    ):
        return list(cached_digests)
    return [fn(o) for o in objs]


class DeltaEncoder:
    """Stateful encoder: first call (and any call whose patch preconditions
    fail) runs a cold ``Encoder.encode``; subsequent calls patch the cached
    problem's rows. ``last_patch`` reports what the last call did:

        {"mode": "cold"|"patched", "reason": ..., "reused_rows": int,
         "fresh_rows": int, "pods": int}

    Only the batch-solve argument subset is patchable (no per-pass override
    requirements, no topology groups, no CSI pod volumes) — exactly the
    arguments the streaming path produces. Anything else is a checked cold
    fallback, never a wrong answer.
    """

    def __init__(self, well_known_labels=None):
        self.encoder = Encoder(**({} if well_known_labels is None else {"well_known_labels": well_known_labels}))
        self._state: Optional[_DeltaState] = None
        self.last_patch: Dict[str, object] = {}
        # per-row previous-world index of the last _patch (-1 = fresh), or
        # None after a cold encode — the DeviceWorld path turns this into a
        # device gather plan (ops/fused.build_patch_args)
        self.last_rows_prev: Optional[np.ndarray] = None
        self.stats = {"cold": 0, "patched": 0}

    def reset(self) -> None:
        self._state = None

    # -- entry ---------------------------------------------------------------

    def encode(
        self,
        pods: Sequence[Pod],
        instance_types: Sequence[InstanceType],
        templates: Sequence[TemplateInfo],
        nodes: Sequence[NodeInfo] = (),
        num_claim_slots: int = 0,
        **kwargs,
    ) -> EncodedProblem:
        if any(v is not None for v in kwargs.values()):
            # per-pass overrides / topology / CSI volumes: the cached row
            # tables don't model them, and a later patch against this state
            # wouldn't either — encode cold and drop the state
            self._state = None
            return self._cold(
                pods, instance_types, templates, nodes, num_claim_slots,
                reason="unsupported-args", cache=False, **kwargs,
            )
        reason = self._patch_blocker(
            pods, instance_types, templates, nodes, num_claim_slots
        )
        if reason is not None:
            return self._cold(
                pods, instance_types, templates, nodes, num_claim_slots,
                reason=reason,
            )
        return self._patch(pods, instance_types, templates, nodes, num_claim_slots)

    # -- cold path -----------------------------------------------------------

    def _cold(
        self,
        pods,
        instance_types,
        templates,
        nodes,
        num_claim_slots,
        reason: str,
        cache: bool = True,
        **kwargs,
    ) -> EncodedProblem:
        encoded = self.encoder.encode(
            pods,
            instance_types,
            templates,
            nodes=nodes,
            num_claim_slots=num_claim_slots,
            **kwargs,
        )
        self.stats["cold"] += 1
        self.last_rows_prev = None
        self.last_patch = {
            "mode": "cold",
            "reason": reason,
            "reused_rows": 0,
            "fresh_rows": len(pods),
            "pods": len(pods),
        }
        if cache:
            meta = encoded.meta
            sorted_pods = [pods[i] for i in meta.pod_order]
            pv = _build_port_vocab(sorted_pods, nodes)
            self._state = _DeltaState(
                pods=sorted_pods,
                uid_row={p.uid: i for i, p in enumerate(sorted_pods)},
                pod_digests={p.uid: pod_digest(p) for p in sorted_pods},
                nodes=list(nodes),
                node_row={n.name: i for i, n in enumerate(nodes)},
                node_digests={n.name: node_info_digest(n) for n in nodes},
                problem=encoded.problem,
                meta=meta,
                vocab=vocab_from_meta(meta),
                port_vocab=pv,
                port_conflict=self._conflict_matrix(pv),
                drivers=sorted({d for n in nodes for d in n.volume_limits}),
                instance_types=list(instance_types),
                it_digests=[instance_type_digest(it) for it in instance_types],
                templates=list(templates),
                tpl_digests=[template_digest(t) for t in templates],
                num_claim_slots=num_claim_slots,
            )
        return encoded

    @staticmethod
    def _conflict_matrix(port_vocab: Dict[HostPort, int]) -> np.ndarray:
        PT = max(len(port_vocab), 1)
        lanes = list(port_vocab.keys())
        conflict = np.zeros((PT, PT), dtype=bool)
        for a, hp_a in enumerate(lanes):
            for b, hp_b in enumerate(lanes):
                conflict[a, b] = hp_a.matches(hp_b)
        return conflict

    # -- patch preconditions ---------------------------------------------------

    def _patch_blocker(
        self, pods, instance_types, templates, nodes, num_claim_slots
    ) -> Optional[str]:
        st = self._state
        if st is None:
            return "first-encode"
        if not pods:
            return "empty-batch"
        if num_claim_slots != st.num_claim_slots:
            return "claim-slots"
        if _digest_list(
            templates, template_digest, st.templates, st.tpl_digests
        ) != st.tpl_digests or len(templates) != len(st.templates):
            return "templates-changed"
        if _digest_list(
            instance_types, instance_type_digest, st.instance_types, st.it_digests
        ) != st.it_digests or len(instance_types) != len(st.instance_types):
            return "instance-types-changed"
        # nodes: removals keep the cached rows selectable (the node axis is
        # column-masked), though a removed hostname usually leaves the
        # vocabulary too and the vocab comparison below then decides cold;
        # adds/changes/reorders invalidate the node axis outright
        prev_row = -1
        for n in nodes:
            row = st.node_row.get(n.name)
            if row is None:
                return "node-added"
            if node_info_digest(n) != st.node_digests[n.name]:
                return "node-changed"
            if row <= prev_row:
                return "node-reordered"
            prev_row = row
        if sorted({d for n in nodes for d in n.volume_limits}) != st.drivers:
            return "driver-drift"
        return None

    # -- the row patch ---------------------------------------------------------

    def _patch(
        self, pods, instance_types, templates, nodes, num_claim_slots
    ) -> EncodedProblem:
        st = self._state
        assert st is not None
        prev = st.problem

        _req_memo: Dict[int, Dict[str, float]] = {}

        def preq(p):
            r = _req_memo.get(id(p))
            if r is None:
                r = _req_memo[id(p)] = res.pod_requests(p)
            return r

        order = ffd_order(pods, requests_of=preq)
        spods = [pods[i] for i in order]
        P = len(spods)

        # which sorted rows gather from cache vs. encode fresh
        cur_digests = {p.uid: pod_digest(p) for p in spods}
        rows_prev = np.full(P, -1, dtype=np.int64)
        for i, p in enumerate(spods):
            row = st.uid_row.get(p.uid)
            if row is not None and st.pod_digests[p.uid] == cur_digests[p.uid]:
                rows_prev[i] = row
        cached = rows_prev >= 0
        cached_rows = rows_prev[cached]
        fresh_pos = np.where(~cached)[0]
        fresh_pods = [spods[i] for i in fresh_pos]

        # vocabulary must be provably stable: rebuild over the new snapshot
        # with the shared build_vocab and compare. Rebuilding is dict interning
        # only — the expensive part of a cold encode is the per-class tensor
        # fold this patch skips.
        claim_hostnames = [claim_hostname(i) for i in range(num_claim_slots)]
        vocab = build_vocab(
            spods, templates, nodes, (), claim_hostnames, instance_types
        )
        if not _vocabs_equal(vocab, st.vocab):
            return self._cold(
                pods, instance_types, templates, nodes, num_claim_slots,
                reason="vocab-drift",
            )
        # resource axis must match lane-for-lane
        resource_names = [res.CPU, res.MEMORY, res.PODS, res.EPHEMERAL_STORAGE]
        seen = set(resource_names)
        for rl in (
            [preq(p) for p in spods]
            + [it.capacity for it in instance_types]
            + [t.daemon_overhead for t in templates]
            + [n.available for n in nodes]
        ):
            for name in rl:
                if name not in seen:
                    seen.add(name)
                    resource_names.append(name)
        if resource_names != st.meta.resource_names:
            return self._cold(
                pods, instance_types, templates, nodes, num_claim_slots,
                reason="resource-drift",
            )
        # port lanes are interned in pod-queue-then-node order; compare
        pv = _build_port_vocab(spods, nodes)
        if list(pv) != list(st.port_vocab):
            return self._cold(
                pods, instance_types, templates, nodes, num_claim_slots,
                reason="port-drift",
            )

        lane_valid = prev.lane_valid
        K, V = lane_valid.shape
        R = len(resource_names)
        node_sel = np.array(
            [st.node_row[n.name] for n in nodes], dtype=np.int64
        )

        # fresh rows through the exact shared encode functions
        fresh_reqs_list = [pod_requirements(p) for p in fresh_pods]
        fresh_strict_list = [
            strict_pod_requirements(p) if has_preferred_node_affinity(p) else r
            for p, r in zip(fresh_pods, fresh_reqs_list)
        ]
        fresh_reqs = encode_reqs_with_vocab(fresh_reqs_list, vocab, lane_valid)
        fresh_strict = encode_reqs_with_vocab(fresh_strict_list, vocab, lane_valid)

        def splice_req(prev_t: ReqTensor, fresh_t: ReqTensor) -> ReqTensor:
            out = {}
            for f in ("admitted", "comp", "gt", "lt", "defined"):
                pa = getattr(prev_t, f)
                fa = getattr(fresh_t, f)
                arr = np.empty((P,) + pa.shape[1:], dtype=pa.dtype)
                arr[cached] = pa[cached_rows]
                arr[fresh_pos] = fa
                out[f] = arr
            return ReqTensor(**out)

        pod_reqs = splice_req(prev.pod_reqs, fresh_reqs)
        pod_strict_reqs = splice_req(prev.pod_strict_reqs, fresh_strict)

        def splice(prev_a: np.ndarray, tail_shape, fill_fresh) -> np.ndarray:
            arr = np.zeros((P,) + tail_shape, dtype=prev_a.dtype)
            arr[cached] = prev_a[cached_rows]
            for j, pos in enumerate(fresh_pos):
                fill_fresh(arr[pos], fresh_pods[j])
            return arr

        def dense(rl) -> np.ndarray:
            return np.array(res.to_dense(rl, resource_names), dtype=np.float32)

        pod_requests = splice(
            prev.pod_requests,
            (R,),
            lambda row, p: np.copyto(row, dense({**preq(p), res.PODS: 1.0})),
        )

        TPL = len(templates)

        def fill_tol_tpl(row, p):
            for ti, t in enumerate(templates):
                row[ti] = not t.taints.tolerates(p)

        pod_tol_tpl = splice(prev.pod_tol_tpl, (TPL,), fill_tol_tpl)

        # node-axis columns: gather surviving columns for cached rows, encode
        # fresh rows directly against the surviving node list
        N = len(nodes)
        pod_tol_node = np.zeros((P, N), dtype=prev.pod_tol_node.dtype)
        pod_tol_node[cached] = prev.pod_tol_node[cached_rows][:, node_sel]
        for j, pos in enumerate(fresh_pos):
            p = fresh_pods[j]
            for ni, n in enumerate(nodes):
                pod_tol_node[pos, ni] = not n.taints.tolerates(p)

        PT = max(len(pv), 1)
        conflict = st.port_conflict

        def fill_ports(pair, p):
            prow, crow = pair
            for hp in get_host_ports(p):
                li = pv[hp]
                prow[li] = True
                crow |= conflict[li]

        pod_ports = np.zeros((P, PT), dtype=bool)
        pod_port_conflict = np.zeros((P, PT), dtype=bool)
        pod_ports[cached] = prev.pod_ports[cached_rows]
        pod_port_conflict[cached] = prev.pod_port_conflict[cached_rows]
        for j, pos in enumerate(fresh_pos):
            fill_ports((pod_ports[pos], pod_port_conflict[pos]), fresh_pods[j])

        D = len(st.drivers)
        # pod volumes are an unsupported (cold-only) argument, so every pod's
        # volume row is zero on both paths
        pod_vol_counts = np.zeros((P, D), dtype=prev.pod_vol_counts.dtype)

        G = 0
        pod_grp_match = np.zeros((P, G), dtype=bool)
        pod_grp_selects = np.zeros((P, G), dtype=bool)
        pod_grp_owned = np.zeros((P, G), dtype=bool)

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

        problem = SchedulingProblem(
            lane_valid=prev.lane_valid,
            lane_numeric=prev.lane_numeric,
            lane_lex_rank=prev.lane_lex_rank,
            key_wellknown=prev.key_wellknown,
            pod_reqs=pod_reqs,
            pod_requests=pod_requests,
            pod_tol_tpl=pod_tol_tpl,
            pod_tol_node=pod_tol_node,
            pod_ports=pod_ports,
            pod_port_conflict=pod_port_conflict,
            pod_strict_reqs=pod_strict_reqs,
            it_reqs=prev.it_reqs,
            it_alloc=prev.it_alloc,
            it_cap=prev.it_cap,
            offer_zone=prev.offer_zone,
            offer_ct=prev.offer_ct,
            offer_ok=prev.offer_ok,
            offer_price=prev.offer_price,
            offer_zc=prev.offer_zc,
            tpl_reqs=prev.tpl_reqs,
            tpl_overhead=prev.tpl_overhead,
            tpl_it_ok=prev.tpl_it_ok,
            tpl_remaining=prev.tpl_remaining,
            node_reqs=ReqTensor(
                admitted=prev.node_reqs.admitted[node_sel],
                comp=prev.node_reqs.comp[node_sel],
                gt=prev.node_reqs.gt[node_sel],
                lt=prev.node_reqs.lt[node_sel],
                defined=prev.node_reqs.defined[node_sel],
            ),
            node_avail=prev.node_avail[node_sel],
            node_overhead=prev.node_overhead[node_sel],
            node_used_ports=prev.node_used_ports[node_sel],
            pod_vol_counts=pod_vol_counts,
            node_vol_used=prev.node_vol_used[node_sel],
            node_vol_limits=prev.node_vol_limits[node_sel],
            grp_type=prev.grp_type,
            grp_key=prev.grp_key,
            grp_max_skew=prev.grp_max_skew,
            grp_min_domains=prev.grp_min_domains,
            grp_counts0=prev.grp_counts0,
            grp_registered0=prev.grp_registered0,
            grp_inverse=prev.grp_inverse,
            grp_has_filter=prev.grp_has_filter,
            grp_filter=prev.grp_filter,
            grp_filter_valid=prev.grp_filter_valid,
            pod_grp_match=pod_grp_match,
            pod_grp_selects=pod_grp_selects,
            pod_grp_owned=pod_grp_owned,
            claim_hostname_lane=prev.claim_hostname_lane,
            pod_active=np.ones(P, dtype=bool),
            run_start=run_start,
            run_len=run_len,
            run_mode=run_mode,
            pod_eqprev=pod_eqprev,
            pod_eqprev_gate=pod_eqprev_gate,
            pod_eqprev_chain=pod_eqprev_chain,
        )
        meta = ProblemMeta(
            keys=st.meta.keys,
            values_per_key=st.meta.values_per_key,
            resource_names=resource_names,
            pod_order=order,
            template_names=st.meta.template_names,
            instance_type_names=st.meta.instance_type_names,
            node_names=[n.name for n in nodes],
            zone_key_idx=ZONE_KEY,
            ct_key_idx=CT_KEY,
            hostname_key_idx=HOSTNAME_KEY,
        )
        self.stats["patched"] += 1
        self.last_rows_prev = rows_prev
        self.last_patch = {
            "mode": "patched",
            "reason": "",
            "reused_rows": int(cached.sum()),
            "fresh_rows": int(len(fresh_pos)),
            "pods": P,
        }
        self._state = _DeltaState(
            pods=spods,
            uid_row={p.uid: i for i, p in enumerate(spods)},
            pod_digests=cur_digests,
            nodes=list(nodes),
            node_row={n.name: i for i, n in enumerate(nodes)},
            node_digests={n.name: st.node_digests[n.name] for n in nodes},
            problem=problem,
            meta=meta,
            vocab=vocab,
            port_vocab=pv,
            port_conflict=conflict,
            drivers=st.drivers,
            instance_types=list(instance_types),
            it_digests=st.it_digests,
            templates=list(templates),
            tpl_digests=st.tpl_digests,
            num_claim_slots=num_claim_slots,
        )
        return EncodedProblem(problem=problem, meta=meta)
