"""Batched consolidation-candidate scoring (the JAX package's
``disruption/batch.py``).

The reference evaluates consolidation subsets one at a time, each probe a
full scheduling simulation (multinodeconsolidation.go:87-137,
singlenodeconsolidation.go:42-88). Here every subset is the same cluster
problem with a few rows masked, so the union problem is encoded once and all
subsets are scored in one device launch: the ``runs_screen`` kernel
(csrc/runs_screen.cu) runs one lane per subset.

Exactness notes (as in the reference package):
  - A subset's variant problem is what the sequential simulation would build
    for those candidates, except that pods of other candidates exist as
    inert rows, and their topology census contribution is restored through
    per-candidate count deltas.
  - The screen runs a fixed number of placement passes without preference
    relaxation, so it is pessimistic: a subset it accepts is confirmed by
    one sequential simulation before a command is issued.
  - Two claim slots suffice: consolidation rejects any result needing more
    than one replacement (consolidation.go:155-162).

By default (``delta=True``) ``score_subsets`` takes the residual screen
(disruption/screen_delta.py) and scores lanes or batches that stand down by
the full screen; ``delta=False`` always takes the full screen. Both give the
same verdicts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.disruption import screen_delta
from karpenter_tpu_torch.disruption.helpers import cheapest_existing_price_by_type, same_type_price_cap
from karpenter_tpu_torch.metrics.registry import SCREEN_DELTA, SCREEN_DELTA_LANE
from karpenter_tpu_torch.models.problem import problem_to_torch
from karpenter_tpu_torch.ops.ffd_core import KIND_FAIL
from karpenter_tpu_torch.ops.padding import pad_problem, screen_axis_bucket
from karpenter_tpu_torch.parallel.mesh import ResidualVariants, ScreenVariants, lean_screen, residual_screen
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.solver.encode import Encoder, NodeInfo
from karpenter_tpu_torch.solver.torch_backend import resolve_device
from karpenter_tpu_torch.verify.incremental import ScreenLaneScope, screen_lane_gate

MAX_SCREEN_CLAIMS = 2


def node_labels_of(node: NodeInfo) -> Dict[str, str]:
    """The node's concrete labels, from its requirement rows (every node label
    encodes as a singleton In requirement, existingnode.go:40-62)."""
    labels = {}
    for key in node.requirements:
        r = node.requirements.get(key)
        if not r.complement and len(r.values) == 1:
            labels[key] = next(iter(r.values))
    return labels


@dataclass
class _CandidateDelta:
    """What one candidate's staying put contributes to the topology census:
    the counts its pods add to each group and the registered lanes its node
    hostname provides. Applied for candidates outside the scored subset."""

    counts: np.ndarray  # i32[G, V]
    registered: np.ndarray  # bool[G, V]


@dataclass
class SubsetVerdict:
    """One subset's screen result."""

    all_pods_scheduled: bool
    n_new_claims: int
    # surviving instance-type indices and admitted zone/capacity-type lanes
    # of the single replacement claim (empty / None unless n_new_claims == 1)
    replacement_its: List[int] = field(default_factory=list)
    replacement_zones: Optional[Set[str]] = None
    replacement_cts: Optional[Set[str]] = None

    def _admitted_offerings(self, it):
        for o in it.offerings.available():
            if self.replacement_zones is not None and o.zone not in self.replacement_zones:
                continue
            if self.replacement_cts is not None and o.capacity_type not in self.replacement_cts:
                continue
            yield o

    def consolidatable_with(self, candidates, instance_types) -> bool:
        """Full consolidation verdict: pods fit elsewhere, at most one
        replacement, and the replacement passes the price and spot rules
        (consolidation.go:150-190, multinodeconsolidation.go:155-188)."""
        if not self.all_pods_scheduled or self.n_new_claims > 1:
            return False
        if self.n_new_claims == 0:
            return True
        max_price = sum(c.price for c in candidates)
        max_price = min(
            max_price,
            same_type_price_cap(
                (instance_types[idx].name for idx in self.replacement_its),
                cheapest_existing_price_by_type(candidates),
            ),
        )
        surviving_cts = set()
        for idx in self.replacement_its:
            it = instance_types[idx]
            if any(o.price < max_price for o in self._admitted_offerings(it)):
                surviving_cts |= {o.capacity_type for o in self._admitted_offerings(it)}
        if not surviving_cts:
            return False
        all_spot = all(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in candidates)
        if all_spot and wk.CAPACITY_TYPE_SPOT in surviving_cts:
            return False
        return True


class UnionScorer:
    """Encodes the union problem once and scores arbitrary candidate subsets
    in one device launch. ``inputs`` is a provisioning.inputs.SchedulerInputs
    whose ``pods`` are the base reschedule set (pending and deleting-node
    pods) and whose ``nodes`` still contain the candidates (masked per
    subset). The scorer runs on CUDA unless ``device`` says otherwise;
    ``delta`` takes the residual screen (the JAX package's
    ``KARPENTER_TPU_SCREEN_DELTA``, on by default there too)."""

    max_residual_runs = screen_delta.MAX_RUNS

    def __init__(
        self,
        inputs,
        candidates: Sequence,
        num_claim_slots: int = MAX_SCREEN_CLAIMS,
        base_pod_count: Optional[int] = None,
        *,
        delta: bool = True,
        device=None,
    ):
        """``inputs.pods`` must be the base reschedule set followed by each
        candidate's reschedulable pods as contiguous slices when
        ``base_pod_count`` is given; with base_pod_count=None the candidates'
        pods are appended here (the synthetic benchmark path)."""
        self.device = resolve_device(device)
        self.delta = delta
        self.inputs = inputs
        self.candidates = list(candidates)
        self.num_claim_slots = num_claim_slots

        cand_names = {c.name for c in self.candidates}
        node_by_name = {n.name: n for n in inputs.nodes}
        self.cand_nodes = [node_by_name.get(c.name) for c in self.candidates]

        self.cand_slices: List[Tuple[int, int]] = []
        if base_pod_count is None:
            self.base_pods: List[Pod] = list(inputs.pods)
            self.union_pods: List[Pod] = list(inputs.pods)
            for c in self.candidates:
                pods = c.reschedulable_pods()
                start = len(self.union_pods)
                self.union_pods.extend(pods)
                self.cand_slices.append((start, len(self.union_pods)))
            self.pod_volumes = (
                list(inputs.pod_volumes) + [{}] * (len(self.union_pods) - len(self.base_pods))
                if inputs.pod_volumes is not None
                else None
            )
        else:
            self.base_pods = list(inputs.pods[:base_pod_count])
            self.union_pods = list(inputs.pods)
            pos = base_pod_count
            for c in self.candidates:
                n = len(c.reschedulable_pods())
                self.cand_slices.append((pos, pos + n))
                pos += n
            if pos != len(self.union_pods):
                raise ValueError("candidate slices misaligned with inputs.pods")
            self.pod_volumes = inputs.pod_volumes

        # survivor screen: a non-candidate node that cannot fit any union pod
        # can never take a reschedule row in any subset's solve
        self.enc_nodes = self._screen_survivors(inputs.nodes, cand_names)

        # topology over the union: batch pods are excluded from the census,
        # so this is the every-candidate-removed base; per-candidate deltas
        # restore the census of the ones that stay
        topo = Topology(inputs.domains, batch_pods=self.union_pods, cluster_pods=inputs.cluster_pods)
        for n in inputs.nodes:
            if n.name not in cand_names:
                topo.register(wk.LABEL_HOSTNAME, n.name)
        # encoder group order: regular topologies first, then inverse
        self.groups = list(topo.topologies.values()) + list(topo.inverse_topologies.values())
        self.n_regular = len(topo.topologies)

        encoded = Encoder().encode(
            self.union_pods,
            inputs.instance_types,
            inputs.templates,
            nodes=self.enc_nodes,
            topology=topo,
            num_claim_slots=num_claim_slots,
            pod_volumes=self.pod_volumes,
        )
        self.meta = encoded.meta
        self.base_problem = pad_problem(encoded.problem)  # numpy, for the host math
        self.device_problem = problem_to_torch(self.base_problem, self.device)  # uploaded once
        self._key_idx = {k: i for i, k in enumerate(self.meta.keys)}
        self._lane = [{v: i for i, v in enumerate(vals)} for vals in self.meta.values_per_key]
        self._node_idx = {n: i for i, n in enumerate(self.meta.node_names)}
        # problem pod rows are FFD-queue-sorted; candidate slices index the
        # original union order
        row_of = {orig: row for row, orig in enumerate(self.meta.pod_order)}
        self._row_of = row_of
        self.cand_rows = [
            np.array([row_of[orig] for orig in range(start, end)], dtype=np.int64)
            for (start, end) in self.cand_slices
        ]
        P = self.base_problem.pod_active.shape[0]
        self._cand_row_mask = np.zeros((len(self.candidates), P), dtype=bool)
        for ci, rows in enumerate(self.cand_rows):
            self._cand_row_mask[ci, rows] = True
        self._cand_row_mask_i32 = self._cand_row_mask.astype(np.int32)
        self._cand_node_idx = np.array(
            [self._node_idx.get(c.name, -1) for c in self.candidates], dtype=np.int64
        )
        self.deltas = [self._delta_for(c, n) for c, n in zip(self.candidates, self.cand_nodes)]
        self._delta_ctx = None
        # the shared-vs-lane split of the last call and its outcome counts
        self.last_screen_stats: Optional[Dict] = None

    # -- survivor screen ------------------------------------------------------

    def _screen_survivors(self, nodes, cand_names: Set[str]) -> List[NodeInfo]:
        """Drop survivor (non-candidate) nodes that cannot fit any union pod
        (elementwise requests <= available over the union's resources)."""
        if not nodes or not self.union_pods:
            return list(nodes)
        from karpenter_tpu_torch.utils import resources as res

        req_dicts = [dict(res.pod_requests(p)) for p in self.union_pods]
        rnames = sorted({r for d in req_dicts for r in d})
        if not rnames:
            return list(nodes)
        ridx = {r: i for i, r in enumerate(rnames)}
        preq = np.zeros((len(req_dicts), len(rnames)), dtype=np.float64)
        for pi, d in enumerate(req_dicts):
            for r, v in d.items():
                preq[pi, ridx[r]] = v
        preq = np.unique(preq, axis=0)
        navail = np.zeros((len(nodes), len(rnames)), dtype=np.float64)
        for ni, n in enumerate(nodes):
            for r, v in (n.available or {}).items():
                i = ridx.get(r)
                if i is not None:
                    navail[ni, i] = v
        fits_any = np.any(np.all(navail[:, None, :] >= preq[None, :, :], axis=-1), axis=-1)
        return [n for ni, n in enumerate(nodes) if n.name in cand_names or bool(fits_any[ni])]

    # -- census deltas --------------------------------------------------------

    def _lane_of(self, key: str, value: str) -> Optional[int]:
        ki = self._key_idx.get(key)
        if ki is None:
            return None
        return self._lane[ki].get(value)

    def _delta_for(self, candidate, node: Optional[NodeInfo]) -> _CandidateDelta:
        """counts/registered a staying candidate contributes: its pods into
        every regular group that selects them (topology.go:238-291), its
        anti-affinity pods into their own inverse groups (topology.go:205-232),
        and its hostname as a registered domain for hostname groups."""
        G = self.base_problem.grp_counts0.shape[0]
        V = self.base_problem.grp_counts0.shape[1]
        counts = np.zeros((G, V), dtype=np.int32)
        registered = np.zeros((G, V), dtype=bool)
        if node is None:
            return _CandidateDelta(counts, registered)
        labels = node_labels_of(node)
        from karpenter_tpu_torch.scheduling.requirements import label_requirements

        node_reqs = label_requirements(labels)
        pods = candidate.reschedulable_pods()
        for gi, tg in enumerate(self.groups):
            if gi >= G:
                break
            domain = labels.get(tg.key)
            lane = self._lane_of(tg.key, domain) if domain is not None else None
            if gi >= self.n_regular:
                for pod in pods:
                    aff = pod.spec.affinity
                    if not (aff and aff.pod_anti_affinity and aff.pod_anti_affinity.required):
                        continue
                    if not tg.is_owned_by(pod.uid):
                        continue
                    if lane is not None and lane < V:
                        counts[gi, lane] += 1
                        registered[gi, lane] = True
            else:
                for pod in pods:
                    if pod.namespace not in tg.namespaces:
                        continue
                    if tg.selector is None or not tg.selector.matches(pod.metadata.labels):
                        continue
                    if lane is None or lane >= V:
                        continue
                    if not tg.node_filter.matches_requirements(node_reqs):
                        continue
                    counts[gi, lane] += 1
                    registered[gi, lane] = True
                if tg.key == wk.LABEL_HOSTNAME:
                    hlane = self._lane_of(wk.LABEL_HOSTNAME, node.name)
                    if hlane is not None and hlane < V:
                        registered[gi, hlane] = True
        return _CandidateDelta(counts, registered)

    # -- subset scoring -------------------------------------------------------

    def score_subsets(self, subsets: Sequence[Sequence[int]], passes: int = 3) -> List[SubsetVerdict]:
        """Score each subset (a list of candidate indices) in one device
        launch. ``passes`` is an upper bound: when no pod interacts with any
        topology group, one placement pass is a fixed point and the screen
        runs one exact pass."""
        if not subsets:
            return []
        base = self.base_problem
        if base.num_groups == 0 or not (
            np.any(base.pod_grp_match) or np.any(base.pod_grp_selects) or np.any(base.pod_grp_owned)
        ):
            passes = 1
        if self.delta:
            out = self._score_subsets_delta(subsets, passes)
            if out is not None:
                return out
        return self._score_full(subsets, passes)

    def _lane_avail(self, member: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per lane: which node rows its subset deletes, and node_avail with
        those rows at -1."""
        base = self.base_problem
        member_node = np.zeros((member.shape[0], base.node_avail.shape[0]), dtype=bool)
        valid_ni = self._cand_node_idx >= 0
        member_node[:, self._cand_node_idx[valid_ni]] = member[:, valid_ni]
        node_avail_b = np.where(member_node[:, :, None], np.float32(-1.0), np.asarray(base.node_avail)[None])
        return member_node, node_avail_b.astype(np.float32)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _score_full(self, subsets: Sequence[Sequence[int]], passes: int) -> List[SubsetVerdict]:
        """The full screen: every lane re-solves the whole union problem."""
        base = self.base_problem
        t0 = time.perf_counter()
        # every-candidate-stays census, computed once: a subset then only
        # subtracts its own members' deltas
        if self.deltas:
            delta_counts = np.stack([d.counts for d in self.deltas])
            delta_reg_int = np.stack([d.registered for d in self.deltas]).astype(np.int32)
        else:
            delta_counts = np.zeros((0,) + base.grp_counts0.shape, dtype=np.int32)
            delta_reg_int = delta_counts
        all_counts = base.grp_counts0 + delta_counts.sum(axis=0)
        all_reg_int = delta_reg_int.sum(axis=0)
        all_cand_rows = np.concatenate(self.cand_rows) if self.cand_rows else np.zeros(0, dtype=np.int64)
        B = len(subsets)
        pad_to = screen_axis_bucket(B)
        n_cand = len(self.candidates)
        member = np.zeros((pad_to, n_cand), dtype=bool)
        for bi, subset in enumerate(subsets):
            member[bi, list(subset)] = True
        m8 = member.astype(np.int32)
        counts_b = all_counts[None] - np.tensordot(m8, delta_counts, axes=1)
        reg_int_b = all_reg_int[None] - np.tensordot(m8, delta_reg_int, axes=1)
        _, node_avail_b = self._lane_avail(member)
        # members' pods become active reschedule rows; other candidates'
        # pods stay inert
        base_active = np.asarray(base.pod_active).copy()
        base_active[all_cand_rows] = False
        pod_active_b = base_active[None] | (m8 @ self._cand_row_mask_i32 > 0)
        variants = ScreenVariants(
            node_avail=self._to_device(node_avail_b),
            pod_active=self._to_device(pod_active_b),
            grp_counts0=self._to_device(counts_b.astype(np.int32)),
            grp_registered0=self._to_device(np.asarray(base.grp_registered0)[None] | (reg_int_b > 0)),
        )
        t_shared = time.perf_counter() - t0
        t1 = time.perf_counter()
        result = lean_screen(self.device_problem, variants, self.num_claim_slots, passes=passes)
        kinds = result.kind.cpu().numpy()
        claim_open = result.state.claim_open.cpu().numpy()
        claim_it_ok = result.state.claim_it_ok.cpu().numpy()
        claim_adm = result.state.claim_req.admitted.cpu().numpy()
        t_lane = time.perf_counter() - t1
        self.last_screen_stats = {
            "mode": "full",
            "lanes": B,
            "pad_to": pad_to,
            "passes": passes,
            "screen_shared_ms": t_shared * 1e3,
            "screen_lane_ms": t_lane * 1e3,
            # what the delta path would have re-solved per lane
            "resident_counts": (m8 @ self._cand_row_mask_i32)[:B].clip(max=1).sum(axis=1).tolist(),
        }
        return self._decode_verdicts(subsets, member[:B], kinds[:B], claim_open[:B], claim_it_ok[:B],
                                     claim_adm[:B])

    def _decode_verdicts(self, subsets, member, kinds, claim_open, claim_it_ok, claim_adm) -> List[SubsetVerdict]:
        """Verdicts from a screen's host rows (shared by both paths): a subset
        passes iff none of its members' pod rows failed."""
        T_real = len(self.meta.instance_type_names)
        zone_k = self.meta.zone_key_idx
        ct_k = self.meta.ct_key_idx
        fail_b = (kinds >= KIND_FAIL).astype(np.int32)
        cand_failed = fail_b @ self._cand_row_mask_i32.T > 0
        ok_b = ~np.any(cand_failed & member, axis=1)
        n_claims_b = claim_open.sum(axis=1).astype(np.int64)
        verdicts = []
        for bi, _ in enumerate(subsets):
            ok = bool(ok_b[bi])
            n_claims = int(n_claims_b[bi])
            verdict = SubsetVerdict(all_pods_scheduled=ok, n_new_claims=n_claims)
            if ok and n_claims == 1:
                slot = int(np.flatnonzero(claim_open[bi])[0])
                verdict.replacement_its = [int(t) for t in np.flatnonzero(claim_it_ok[bi, slot]) if t < T_real]
                verdict.replacement_zones = self._admitted_values(claim_adm[bi, slot], zone_k)
                verdict.replacement_cts = self._admitted_values(claim_adm[bi, slot], ct_k)
            verdicts.append(verdict)
        return verdicts

    def _score_subsets_delta(self, subsets: Sequence[Sequence[int]], passes: int) -> Optional[List[SubsetVerdict]]:
        """The residual screen: solve the shared base world once, then re-solve
        each lane over only its resident rows and their runs. Returns None when
        the whole batch stands down (the caller runs the full screen); lanes
        that stand down or fail the lane gate are re-scored by the full screen
        inside this call."""
        base = self.base_problem
        t0 = time.perf_counter()
        if self._delta_ctx is None:
            self._delta_ctx = screen_delta.DeltaContext(self)
        ctx = self._delta_ctx
        reason = ctx.batch_standdown(base, passes)
        if reason is not None:
            SCREEN_DELTA.inc({"outcome": reason}, float(len(subsets)))
            verdicts = self._score_full(subsets, passes)
            self.last_screen_stats["outcomes"] = {reason: len(subsets)}
            return verdicts
        world = ctx.base_world(self)
        plan = ctx.plan_lanes(self, subsets, world)
        delta_ix = [i for i, r in enumerate(plan.reasons) if r is None]
        fb_ix = [i for i, r in enumerate(plan.reasons) if r is not None]
        verdicts: List[Optional[SubsetVerdict]] = [None] * len(subsets)
        stats: Dict = {"mode": "delta", "lanes": len(subsets)}
        reason_counts: Dict[str, int] = {}
        for i in fb_ix:
            SCREEN_DELTA.inc({"outcome": plan.reasons[i]})
            reason_counts[plan.reasons[i]] = reason_counts.get(plan.reasons[i], 0) + 1
        n_good = 0
        t_lane = 0.0
        if delta_ix:
            B = len(delta_ix)
            pad_to = screen_axis_bucket(B)
            n_cand = len(self.candidates)
            member = np.zeros((pad_to, n_cand), dtype=bool)
            member[:B] = plan.member[delta_ix]
            m8 = member.astype(np.int32)
            member_node, node_avail_b = self._lane_avail(member)
            # residents only: the base rows' verdicts live in the carried world
            pod_active_b = (m8 @ self._cand_row_mask_i32) > 0
            # the shared run trim: every delta lane's touched runs, in run order
            union_runs = np.flatnonzero(plan.touched[delta_ix].any(axis=0))
            rnr = screen_delta.residual_run_bucket(len(union_runs))
            run_idx = np.full(rnr, -1, dtype=np.int32)
            run_idx[: len(union_runs)] = union_runs
            counts = plan.run_counts[delta_ix]
            variants = ResidualVariants(
                node_avail=self._to_device(node_avail_b), pod_active=self._to_device(pod_active_b),
            )
            t_shared = time.perf_counter() - t0
            t1 = time.perf_counter()
            result = residual_screen(self.device_problem, world.carried, variants, run_idx, self.num_claim_slots)
            kinds = result.kind.cpu().numpy()
            idxs = result.index.cpu().numpy()
            claim_open = result.state.claim_open.cpu().numpy()
            claim_it_ok = result.state.claim_it_ok.cpu().numpy()
            claim_adm = result.state.claim_req.admitted.cpu().numpy()
            node_requests = result.state.node_requests.cpu().numpy()
            carried_requests = world.carried.node_requests.cpu().numpy()
            t_lane = time.perf_counter() - t1
            SCREEN_DELTA_LANE.observe(t_lane / max(B, 1))
            scope = ScreenLaneScope(resident_mask=pod_active_b[:B], masked_nodes=member_node[:B])
            gate_ok = self.lane_gate(
                kinds[:B], idxs[:B], scope, node_requests=node_requests[:B], node_avail=node_avail_b[:B],
                carried_node_requests=carried_requests,
            )
            good = [bi for bi in range(B) if gate_ok[bi]]
            bad = [bi for bi in range(B) if not gate_ok[bi]]
            n_good = len(good)
            if good:
                SCREEN_DELTA.inc({"outcome": "delta"}, float(len(good)))
                rows = np.array(good, dtype=np.int64)
                for key, verdict in zip(good, self._decode_verdicts(
                    [subsets[delta_ix[bi]] for bi in good], member[rows], kinds[rows],
                    claim_open[rows], claim_it_ok[rows], claim_adm[rows],
                )):
                    verdicts[delta_ix[key]] = verdict
            if bad:
                SCREEN_DELTA.inc({"outcome": "gate-mismatch"}, float(len(bad)))
                reason_counts["gate-mismatch"] = len(bad)
                fb_ix = fb_ix + [delta_ix[bi] for bi in bad]
            stats.update({
                "pad_to": pad_to,
                "rnr": rnr,
                "resident_counts": pod_active_b[:B].sum(axis=1).tolist(),
                "run_counts": counts[:B].tolist(),
            })
        else:
            t_shared = time.perf_counter() - t0
        if fb_ix:
            fb_sorted = sorted(fb_ix)
            for key, verdict in zip(fb_sorted, self._score_full([subsets[i] for i in fb_sorted], passes)):
                verdicts[key] = verdict
            full_stats = self.last_screen_stats or {}
            t_lane += full_stats.get("screen_lane_ms", 0.0) / 1e3
            t_shared += full_stats.get("screen_shared_ms", 0.0) / 1e3
        stats.update({
            "screen_shared_ms": t_shared * 1e3,
            "screen_lane_ms": t_lane * 1e3,
            "delta_lanes": n_good,
            "fallback_lanes": len(fb_ix),
            "standdowns": reason_counts,
            "outcomes": {"delta": n_good, **reason_counts},
        })
        self.last_screen_stats = stats
        return verdicts

    # the lane gate (verify/incremental.screen_lane_gate); an attribute so a
    # test can veto lanes and watch them re-scored
    lane_gate = staticmethod(screen_lane_gate)

    def _admitted_values(self, adm_row: np.ndarray, key_idx: int) -> Set[str]:
        vals = self.meta.values_per_key[key_idx]
        return {vals[vi] for vi in np.flatnonzero(adm_row[key_idx][: len(vals)])}


def build_scorer(provisioner, candidates) -> Optional[UnionScorer]:
    """A UnionScorer from the live provisioner state, assembled the way
    simulate_scheduling assembles one probe (helpers.go:73-127): base pods are
    pending and deleting-node pods; candidate pods join the input set so their
    volume topology and CSI limits resolve as in the sequential path; nodes
    keep the candidates (masked per subset). It runs on the device of the
    provisioner's solver (``TorchSolver.device``, through
    ``SupervisedSolver.primary``); a solver without one gets the package
    default, CUDA, which raises without a card."""
    primary = getattr(provisioner.solver, "primary", provisioner.solver)
    device = resolve_device(getattr(primary, "device", None))
    candidate_names = {c.name for c in candidates}
    pending = provisioner.get_pending_pods()
    deleting = [p for p in provisioner.get_deleting_node_pods() if p.spec.node_name not in candidate_names]
    cand_pods = [p for c in candidates for p in c.reschedulable_pods()]
    inputs = provisioner.build_inputs(pending + deleting + cand_pods)
    if inputs is None:
        return None
    return UnionScorer(inputs, candidates, base_pod_count=len(pending) + len(deleting), device=device)


# ---------------------------------------------------------------------------
# synthetic benchmark entry: score all prefixes of a synthetic cluster the
# way MultiNodeConsolidation would
# ---------------------------------------------------------------------------

def build_bench_scorer(
    n_candidates: int = 100,
    base_pods: Sequence = (),
    rng_seed: int = 7,
    num_claim_slots: int = MAX_SCREEN_CLAIMS,
    device=None,
    delta: bool = True,
):
    """The synthetic consolidation cluster of the JAX package's bench, as a
    scorer: n_candidates small nodes (1-4 residents each) and 8 roomy
    survivors, 100 instance types, one default NodePool, drawn from
    ``random.Random(rng_seed)`` in the reference's draw order. ``base_pods``
    ride as the pending reschedule set. Returns (scorer, instance_types,
    candidates)."""
    import random

    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, PodSpec
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.provisioning.inputs import SchedulerInputs
    from karpenter_tpu_torch.scheduling import Taints
    from karpenter_tpu_torch.scheduling.requirements import label_requirements
    from karpenter_tpu_torch.solver.encode import domains_from_instance_types, template_from_nodepool

    rng = random.Random(rng_seed)
    its = instance_types(100)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="default")), its, range(len(its)))

    class _FakeCandidate:
        def __init__(self, name, pods, price, capacity_type):
            self.name = name
            self._pods = pods
            self.price = price
            self.capacity_type = capacity_type
            # no catalog type: the same-type churn guard skips None
            self.instance_type = None
            self.zone = ""

        def reschedulable_pods(self):
            return self._pods

    nodes = []
    candidates = []
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    for i in range(n_candidates):
        name = f"cand-node-{i:03d}"
        labels = {
            wk.LABEL_HOSTNAME: name,
            wk.LABEL_TOPOLOGY_ZONE: zones[i % 3],
            wk.CAPACITY_TYPE_LABEL_KEY: wk.CAPACITY_TYPE_ON_DEMAND,
            wk.NODEPOOL_LABEL_KEY: "default",
        }
        pods = [
            Pod(
                metadata=ObjectMeta(name=f"p-{i}-{j}", labels={"app": f"a{j%5}"}),
                spec=PodSpec(
                    containers=[
                        Container(
                            requests={
                                "cpu": rng.choice([0.1, 0.25, 0.5]),
                                "memory": rng.choice([128, 256, 512]) * 1024.0**2,
                            }
                        )
                    ],
                    node_name=name,
                ),
            )
            for j in range(rng.randint(1, 4))
        ]
        nodes.append(
            NodeInfo(
                name=name,
                requirements=label_requirements(labels),
                taints=Taints([]),
                available={"cpu": 4.0, "memory": 8 * 1024.0**3, "pods": 110.0},
                daemon_overhead={},
            )
        )
        candidates.append(_FakeCandidate(name, pods, price=1.0, capacity_type=wk.CAPACITY_TYPE_ON_DEMAND))
    # roomy survivors so candidate pods have somewhere to go
    for i in range(8):
        name = f"big-node-{i}"
        labels = {
            wk.LABEL_HOSTNAME: name,
            wk.LABEL_TOPOLOGY_ZONE: zones[i % 3],
            wk.CAPACITY_TYPE_LABEL_KEY: wk.CAPACITY_TYPE_ON_DEMAND,
            wk.NODEPOOL_LABEL_KEY: "default",
        }
        nodes.append(
            NodeInfo(
                name=name,
                requirements=label_requirements(labels),
                taints=Taints([]),
                available={"cpu": 64.0, "memory": 256 * 1024.0**3, "pods": 500.0},
                daemon_overhead={},
            )
        )
    inputs = SchedulerInputs(
        pods=list(base_pods),
        instance_types=list(its),
        templates=[tpl],
        nodes=nodes,
        domains=domains_from_instance_types(its, [tpl]),
        cluster_pods=[],
    )
    scorer = UnionScorer(inputs, candidates, num_claim_slots, delta=delta, device=device)
    return scorer, its, candidates


def bench_candidate_scoring(n_candidates: int = 100, device=None) -> Dict:
    """Score every prefix of the synthetic cluster's candidate list (the
    Multi-node consolidation probes) and report the verdict count and the
    screen's shared-vs-lane split."""
    scorer, its, candidates = build_bench_scorer(n_candidates, device=device)
    subsets = [list(range(k + 1)) for k in range(n_candidates)]
    verdicts = scorer.score_subsets(subsets)
    consolidatable = sum(
        1 for v, s in zip(verdicts, subsets) if v.consolidatable_with([candidates[i] for i in s], its)
    )
    out: Dict = {"candidates": n_candidates, "consolidatable": consolidatable}
    stats = scorer.last_screen_stats
    if stats is not None:
        out["screen_mode"] = stats.get("mode")
        out["screen_shared_ms"] = round(stats.get("screen_shared_ms", 0.0), 3)
        out["screen_lane_ms"] = round(stats.get("screen_lane_ms", 0.0), 3)
        residents = stats.get("resident_counts") or []
        if residents:
            out["resident_counts"] = {
                "min": int(np.min(residents)),
                "p50": float(np.percentile(residents, 50)),
                "max": int(np.max(residents)),
            }
        if stats.get("mode") == "delta":
            out["delta_lanes"] = stats.get("delta_lanes")
            out["fallback_lanes"] = stats.get("fallback_lanes")
    return out


class ScreenSession:
    """One reconcile pass's shared screen: every subset the Multi and Single
    methods ask about is scored in as few device launches as possible, on one
    scorer. Sound because the methods run back to back within a pass with no
    command in between (controller.go:127-171). The controller installs a
    fresh session each pass; ``scorer_for`` builds the scorer from the live
    provisioner (``build_scorer``) once per candidate basis, and ``use`` sets
    a scorer built elsewhere."""

    def __init__(self):
        self._key = None
        self._scorer: Optional[UnionScorer] = None
        self._verdicts: Dict[tuple, SubsetVerdict] = {}

    def scorer_for(self, provisioner, candidates) -> Optional[UnionScorer]:
        """The pass's scorer over ``candidates``: built on the first call for
        a basis, the same object (and its cached verdicts) after that."""
        key = tuple(c.name for c in candidates)
        if self._key != key:
            self._scorer = build_scorer(provisioner, candidates)
            self._key = key
            self._verdicts = {}
        return self._scorer

    def use(self, scorer: UnionScorer) -> UnionScorer:
        """Score with ``scorer`` from now on (cached verdicts are dropped when
        its candidates differ from the previous scorer's)."""
        key = tuple(c.name for c in scorer.candidates)
        if self._key != key or self._scorer is not scorer:
            self._verdicts = {}
        self._key, self._scorer = key, scorer
        return scorer

    def score(self, subsets, extra=()) -> List[SubsetVerdict]:
        """Verdicts for ``subsets``; cache misses are batched into one device
        launch together with ``extra`` speculative subsets (a later method's
        expected queries: Multi passes the singletons Single will ask for)."""
        if self._scorer is None:
            raise RuntimeError("ScreenSession.score before use(scorer)")
        want = [tuple(s) for s in subsets]
        missing = [s for s in want if s not in self._verdicts]
        missing += [t for t in (tuple(s) for s in extra) if t not in self._verdicts and t not in missing]
        if missing:
            for key, verdict in zip(missing, self._scorer.score_subsets([list(s) for s in missing])):
                self._verdicts[key] = verdict
        return [self._verdicts[s] for s in want]
