"""The narrow iteration of the sweeps loop: one pod evaluated, its chain
committed.

Plain PyTorch counterpart of the JAX package's ``ops/ffd_sweeps._make_stride``
``narrow_iter`` (:872) with its default switches (``_STRIDE`` 64,
``_SPREAD_CHAIN`` and ``_TOPO_CHAIN`` on). One iteration evaluates the pod at
the queue cursor through the per-pod gates (the node, claim and template
phases of ops/ffd_step.make_step), then commits it together with up to
``STRIDE - 1`` chain-identical queue successors (``pod_eqprev_chain``: equal on
every gate-relevant array, select side free to differ) in one of four closed
forms, each equal to stepping the members one at a time:

  * ``single``: the pod's own bin takes the chain while the per-pod fit holds
    and, for a claim, while it stays the fewest-pods pick (``j_rank``);
    a FAIL or NO_SLOT verdict replicates over the whole chain;
  * ``fill``: the chain waterfills over every eligible claim (the run
    commit's fewest-pods math, ``_water_level``) when no record can feed
    back into the chain's own gates;
  * ``round``: one closed-form round of a maxSkew-1 spread over claims that
    are pinned to single lanes of the group key;
  * ``spread``: a mini-scan of the spread group's counters over the chain,
    with its exactness guards and the fallback to ``single``.

The topology record weights one unit delta per committed bin row by the
members' select/owned rows (``do_record``/``multi_deltas``). The state is
updated in place. The CUDA kernel csrc/ffd_loop.cu carries the same commit.

The wavefront (``KARPENTER_TPU_WAVEFRONT``; the JAX package's
``_wave_extend``, :473) is ``narrow.wave``: after an iteration, further chain
heads judged against the state the iteration left, each committed only
where its verdict provably equals the sequential one (csrc/wave.cuh on the
card).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Tuple

import torch

from karpenter_tpu_torch.models.problem import HOSTNAME_KEY, ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    _BIG,
    _BIG_CAP,
    KIND_CLAIM,
    KIND_FAIL,
    KIND_NEW_CLAIM,
    KIND_NO_SLOT,
    KIND_NODE,
    FFDState,
    PodRow,
    pod_row,
    _add_times,
    _bcast,
    _capacity,
    _first_true,
    _fresh_template_rows,
    _intersect_rows,
    _make_it_gate,
    _offer_rows,
    _water_level,
)
from karpenter_tpu_torch.ops.topology_kernels import PodTopoStatics, record_delta, topo_gate

STRIDE = 64  # the JAX package's _STRIDE: members a narrow iteration may commit
_MAXI = 2**31 - 1

# commit branches (the JAX package's lax.switch order)
SINGLE, FILL, ROUND, SPREAD = 0, 1, 2, 3


def chain_rows(problem: SchedulingProblem) -> torch.Tensor:
    """bool[P]: the row extends its predecessor's chain (``pod_eqprev_chain``,
    or byte identity ``pod_eqprev`` when the encoder gave no chain rows)."""
    for src in (problem.pod_eqprev_chain, problem.pod_eqprev):
        if src is not None:
            return src
    return torch.zeros(problem.num_pods, dtype=torch.bool, device=problem.lane_valid.device)


def chain_flags(problem: SchedulingProblem) -> List[bool]:
    return [bool(x) for x in chain_rows(problem).cpu().tolist()]


def chain_length(queue: List[int], i: int, chain: List[bool]) -> int:
    """Members of the chain at queue cursor ``i`` (at most STRIDE):
    consecutive queue entries that are consecutive rows, each chain-identical
    to the previous one."""
    p = queue[i]
    k = 1
    while k < STRIDE and i + k < len(queue) and queue[i + k] == p + k and chain[p + k]:
        k += 1
    return k


def make_narrow(problem: SchedulingProblem, statics, C: int):
    """``narrow(state, pod, p, k_chain) -> (kind, index_rows, k)``: one
    narrow iteration for pod row ``p`` heading a chain of ``k_chain`` members,
    committed into ``state`` in place; ``index_rows`` holds each of the ``k``
    committed members' index. Its two halves are ``narrow.evaluate(state,
    pod)`` (pure) and ``narrow.commit(state, verdict, pod, p, k_chain)``: the
    wavefront (``narrow.wave``) evaluates further chain heads against one
    state before it commits any of them."""
    lv, ln = statics.lv, statics.ln
    wellknown, no_allow = statics.wellknown, statics.no_allow
    bounds_free = statics.bounds_free
    N, T, TPL = problem.num_nodes, problem.num_instance_types, problem.num_templates
    K, V = problem.num_keys, problem.num_lanes
    G = problem.grp_key.shape[0]
    dev = lv.device
    i32 = torch.int32
    it_gate = _make_it_gate(problem, statics)
    idxC = torch.arange(C, device=dev, dtype=i32)
    mint_hostnames = problem.claim_hostname_lane.shape[0] > 0
    host_groups = problem.grp_key == HOSTNAME_KEY
    big = lambda like: torch.full_like(like, _BIG)  # noqa: E731
    if G > 0:
        grp_key = problem.grp_key.long()
        aff_safe = (problem.grp_type == 1) & ~problem.grp_inverse
        key_is = grp_key[:, None] == torch.arange(K, device=dev)[None, :]  # [G, K]
        sel_all, own_all = problem.pod_grp_selects, problem.pod_grp_owned

    def gated(state, pod_topo, merged, allow, registered):
        return topo_gate(problem, state.grp_counts, registered, pod_topo, merged, allow)

    row_fields = ("admitted", "comp", "defined") + (() if bounds_free else ("gt", "lt"))
    ones_g = torch.ones(G, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.bool, device=dev)

    def set_row(rows: ReqTensor, i: int, row: ReqTensor) -> None:
        # bounds-free rows keep their gt/lt sentinels
        for name in row_fields:
            getattr(rows, name)[i] = getattr(row, name)

    def commit_node(state: FFDState, n: int, row: ReqTensor, pod: PodRow, k: int) -> None:
        """``k`` members of the pod's chain onto existing node ``n``, whose
        narrowed row is ``row``."""
        set_row(state.node_req, n, row)
        state.node_requests[n] = _add_times(state.node_requests[n], torch.tensor(k, dtype=i32, device=dev),
                                            pod.requests)
        state.node_npods[n] += k
        state.node_used_ports[n] |= pod.ports
        state.node_vol_used[n] += k * pod.vols

    def unit_record(pod: PodRow, row: ReqTensor, allow) -> torch.Tensor:
        """bool[G, V]: what one member placed on a bin of final row ``row``
        records, before its own select/owned weights."""
        return record_delta(problem, PodTopoStatics(pod.strict.admitted, pod.grp_match, ones_g, ones_g),
                            row, allow, one, lv, ln)

    def evaluate(state: FFDState, pod: PodRow) -> SimpleNamespace:
        """The pod's verdict against ``state`` and what a commit reads of it
        (the gates' rows, capacities and ranks); ``state`` is not changed."""
        topo_pod = PodTopoStatics(pod.strict.admitted, pod.grp_match, pod.grp_selects, pod.grp_owned)
        port_cap = 1 if bool(pod.ports.any()) else _BIG_CAP

        # -- existing nodes
        any_node, node_pick, node_static_any, node_fit_count = False, 0, False, 0
        node_row = None
        if N > 0:
            node_requests2 = state.node_requests + pod.requests[None, :]
            node_fit = masks.fits(node_requests2, problem.node_avail)
            node_merged = _intersect_rows(state.node_req, pod.req, bounds_free)
            if bounds_free:
                node_compat = masks.compatible_from_merged(
                    masks.nonempty(node_merged, True), state.node_req.defined,
                    masks.negative_polarity(state.node_req, lv, ln, True),
                    pod.req.defined, pod.neg, no_allow,
                )
            else:
                node_compat = masks.compatible_ok(state.node_req, _bcast(pod.req), lv, ln, no_allow)
            node_port_ok = ~(state.node_used_ports & pod.conflict[None, :]).any(dim=-1)
            node_vol_ok = (state.node_vol_used + pod.vols[None, :] <= problem.node_vol_limits).all(dim=-1)
            node_topo_ok, node_final = gated(state, topo_pod, node_merged, no_allow, state.grp_registered)
            static_ok = pod.tol_node & node_fit & node_compat & node_port_ok & node_vol_ok
            node_ok = static_ok & node_topo_ok
            node_pick = int(_first_true(node_ok))
            any_node = node_pick < N
            node_static_any = bool(static_ok.any())
            pick_n = min(node_pick, N - 1)
            node_row = node_final.row(pick_n)
            res_cap = int(_capacity(problem.node_avail[pick_n], state.node_requests[pick_n], pod.requests))
            vol_cap = _BIG_CAP
            if problem.pod_vol_counts.shape[1] > 0:
                room = torch.clamp(
                    torch.div(problem.node_vol_limits[pick_n] - state.node_vol_used[pick_n],
                              torch.clamp(pod.vols, min=1), rounding_mode="floor"),
                    min=0,
                )
                vol_cap = int(torch.where(pod.vols > 0, room, torch.full_like(room, _BIG_CAP)).min())
            node_fit_count = min(res_cap, vol_cap, port_cap)

        # -- open claims
        claim_merged = _intersect_rows(state.claim_req, pod.req, bounds_free)
        if bounds_free:
            claim_compat = masks.compatible_from_merged(
                masks.nonempty(claim_merged, True), state.claim_req.defined,
                masks.negative_polarity(state.claim_req, lv, ln, True),
                pod.req.defined, pod.neg, wellknown,
            )
        else:
            claim_compat = masks.compatible_ok(state.claim_req, _bcast(pod.req), lv, ln, wellknown)
        claim_topo_ok, claim_final = gated(state, topo_pod, claim_merged, wellknown, state.grp_registered)
        claim_requests2 = state.claim_requests + pod.requests[None, :]
        claim_it_ok2 = it_gate(claim_final, claim_requests2, state.claim_it_ok)
        claim_port_ok = ~(state.claim_used_ports & pod.conflict[None, :]).any(dim=-1)
        claim_ok_pre = state.claim_open & pod.tol_tpl[state.claim_tpl.long()] & claim_port_ok & claim_compat
        claim_ok = claim_ok_pre & claim_topo_ok & claim_it_ok2.any(dim=-1)
        claim_rank = torch.where(claim_ok, state.claim_npods * C + idxC, big(idxC))
        claim_pick = int(torch.argmin(claim_rank))
        any_claim = bool(claim_ok.any())
        rank2 = int(torch.where(idxC == claim_pick, big(idxC), claim_rank).min())
        cap_ct_all = _capacity(
            problem.it_alloc[None, :, :], state.claim_requests[:, None, :], pod.requests[None, None, :]
        )  # [C, T]
        cap_c = torch.where(claim_it_ok2, cap_ct_all, torch.zeros_like(cap_ct_all)).max(dim=-1).values
        cap_c = torch.where(claim_ok, torch.clamp(cap_c, max=port_cap), torch.zeros_like(cap_c)).to(i32)
        claim_fit_count = int(cap_c[claim_pick])
        claim_npods0 = int(state.claim_npods[claim_pick])

        # -- a fresh claim from the first accepting template
        free_slot_t = _first_true(~state.claim_open)
        free_slot = int(free_slot_t)
        has_slot = free_slot < C
        any_tpl, tpl_pick = False, 0
        tpl_final = tpl_it_ok2 = tpl_requests2 = host_onehot = None
        active = bool(pod.active)
        if not any_node and not any_claim and has_slot and active:
            tpl_requests2 = problem.tpl_overhead + pod.requests[None, :]
            tpl_merged, tpl_compat, host_onehot = _fresh_template_rows(
                problem, lv, ln, wellknown, pod.req, free_slot_t,
                bounds_free=bounds_free, tpl_neg=statics.tpl_neg, pod_neg=pod.neg,
            )
            reg_for_tpl = state.grp_registered | (host_groups[:, None] & host_onehot[None, :])
            tpl_topo_ok, tpl_final = gated(state, topo_pod, tpl_merged, wellknown, reg_for_tpl)
            within_limits = masks.fits(problem.it_cap[None, :, :], state.remaining[:, None, :])
            tpl_it_ok2 = it_gate(tpl_final, tpl_requests2, problem.tpl_it_ok & within_limits)
            tpl_ok = pod.tol_tpl & tpl_compat & tpl_topo_ok & tpl_it_ok2.any(dim=-1)
            tpl_pick = int(_first_true(tpl_ok))
            any_tpl = tpl_pick < TPL

        if not active:
            kind = KIND_FAIL
        elif any_node:
            kind = KIND_NODE
        elif any_claim:
            kind = KIND_CLAIM
        elif not has_slot:
            kind = KIND_NO_SLOT
        else:
            kind = KIND_NEW_CLAIM if any_tpl else KIND_FAIL
        index = {KIND_NODE: node_pick, KIND_CLAIM: claim_pick, KIND_NEW_CLAIM: free_slot}.get(kind, -1)
        return SimpleNamespace(
            topo_pod=topo_pod, any_node=any_node, node_pick=node_pick, node_static_any=node_static_any,
            node_fit_count=node_fit_count, node_row=node_row, any_claim=any_claim, claim_merged=claim_merged,
            claim_final=claim_final, claim_it_ok2=claim_it_ok2, claim_ok_pre=claim_ok_pre,
            claim_topo_ok=claim_topo_ok, claim_pick=claim_pick, rank2=rank2, cap_ct_all=cap_ct_all,
            cap_c=cap_c, claim_fit_count=claim_fit_count, claim_npods0=claim_npods0, free_slot=free_slot,
            has_slot=has_slot, any_tpl=any_tpl, tpl_pick=tpl_pick, tpl_final=tpl_final, tpl_it_ok2=tpl_it_ok2,
            tpl_requests2=tpl_requests2, host_onehot=host_onehot, active=active, kind=kind, index=index,
        )

    def commit(state: FFDState, ev: SimpleNamespace, pod: PodRow, p: int, k_chain: int) -> Tuple[int, List[int], int]:
        """Commit the chain of ``k_chain`` members headed by pod row ``p``
        into ``state`` in place, from ``evaluate(state, pod)``."""
        any_node, node_pick, node_static_any = ev.any_node, ev.node_pick, ev.node_static_any
        node_fit_count, node_row = ev.node_fit_count, ev.node_row
        claim_merged, claim_final, claim_it_ok2 = ev.claim_merged, ev.claim_final, ev.claim_it_ok2
        claim_ok_pre, claim_topo_ok, claim_pick, rank2 = ev.claim_ok_pre, ev.claim_topo_ok, ev.claim_pick, ev.rank2
        cap_ct_all, cap_c = ev.cap_ct_all, ev.cap_c
        claim_fit_count, claim_npods0, free_slot = ev.claim_fit_count, ev.claim_npods0, ev.free_slot
        tpl_pick, tpl_final, tpl_it_ok2 = ev.tpl_pick, ev.tpl_final, ev.tpl_it_ok2
        tpl_requests2, host_onehot = ev.tpl_requests2, ev.host_onehot
        kind, index = ev.kind, ev.index
        placed = kind < KIND_FAIL
        is_open = kind == KIND_NEW_CLAIM
        is_claim = kind == KIND_CLAIM

        # -- which commit: record -> gate feedback, spread shape
        stack_safe = fill_safe = True
        spread_pod = round_ok = False
        if G > 0:
            match, selects, owned = pod.grp_match, pod.grp_selects, pod.grp_owned
            inverse = problem.grp_inverse
            feedback = match & ((selects & ~inverse) | (owned & inverse))
            pod_dom = pod.strict.admitted[grp_key]  # [G, V]
            positive_any = (state.grp_registered & (state.grp_counts > 0) & pod_dom).any(dim=-1)
            stack_safe = not bool((feedback & ~aff_safe).any())
            fill_safe = stack_safe and bool((~feedback | positive_any).all())
            spread_pod = (
                int(match.sum()) == 1
                and bool((match & (problem.grp_type == 0)).any())
                and not bool((match & problem.grp_has_filter).any())
                and not bool((match & inverse).any())
                and not bool((owned & ~match).any())
                and not bool((owned & inverse).any())
            )
            s_gi = int((match & selects).any())
            is_host_g = bool((match & host_groups).any())
            reg_g = (match[:, None] & state.grp_registered).any(dim=0)  # [V]
            pod_dom_g = (match[:, None] & pod_dom).any(dim=0)  # [V]
            key_onehot_g = (key_is & match[:, None]).any(dim=0)  # [K]
            counts_g0 = (match[:, None].to(i32) * state.grp_counts).sum(dim=0).to(i32)  # [V]
            lex_g = (key_onehot_g.to(i32)[:, None] * problem.lane_lex_rank.to(i32)).sum(dim=0)  # [V]
            skew_g = int((match.to(i32) * problem.grp_max_skew).sum())
            md_g = int(torch.where(match, problem.grp_min_domains, torch.full_like(problem.grp_min_domains, -1)).max())
            sup_mask = reg_g & pod_dom_g
            gmin_zero = is_host_g or (md_g >= 0 and int(sup_mask.sum()) < md_g)
            lexv = torch.clamp(lex_g, max=V - 1)
            lanes_cm = (claim_merged.admitted & key_onehot_g[None, :, None]).any(dim=1)  # [C, V]
            fillable = cap_c > 0
            lane_c = torch.argmax(lanes_cm.to(i32), dim=-1)
            single_ok = (lanes_cm.sum(dim=-1) == 1) & sup_mask[lane_c]
            ok_struct = bool((~fillable | single_ok).all())
            sup_counts = torch.where(sup_mask, counts_g0, torch.full_like(counts_g0, _MAXI))
            gmin0 = 0 if gmin_zero else int(sup_counts.min())
            open_lane = sup_mask & (counts_g0 == gmin0)
            lane_open_claim = open_lane & (lanes_cm & fillable[:, None]).any(dim=0)
            n_win = int(lane_open_claim.sum())
            round_ok = spread_pod and skew_g == 1 and s_gi == 1 and ok_struct and n_win >= k_chain
        j_rank = (rank2 - 1 - index) // C - claim_npods0 + 1 if is_claim else _BIG_CAP
        fitc = node_fit_count if kind == KIND_NODE else claim_fit_count
        use_fill = is_claim and fill_safe and k_chain > 1
        use_round = is_claim and round_ok and k_chain > 1 and not use_fill
        use_spread = (is_claim and spread_pod and not node_static_any and k_chain > 1
                      and not use_fill and not use_round)

        def single():
            k_placed = 1 if is_open else (min(fitc, j_rank) if stack_safe else 1)
            k1 = max(min(k_chain, k_placed if placed else _BIG_CAP), 1)
            take = torch.zeros(C, dtype=i32, device=dev)
            if is_claim:
                take[claim_pick] = k1
            return take, [claim_pick] * k1, k1, None, False

        def fill():
            p_lvl = state.claim_npods
            m = min(k_chain, int(cap_c.sum()))
            L = _water_level(p_lvl, cap_c, torch.tensor(m, dtype=i32, device=dev))
            take0 = torch.minimum(torch.clamp(L - p_lvl, min=0), cap_c)
            leftover = m - int(take0.sum())
            at_level = (p_lvl + take0 == L) & (take0 < cap_c)
            extra = at_level & (torch.cumsum(at_level.to(i32), 0) <= leftover)
            take = (take0 + extra.to(i32)).to(i32)
            lev = _water_level(p_lvl, take, torch.arange(m, dtype=i32, device=dev))  # [m]
            before = torch.minimum(torch.clamp(lev[:, None] - p_lvl[None, :], min=0), take[None, :]).sum(dim=-1)
            pos = torch.arange(m, device=dev) - before
            at_lev = (p_lvl[None, :] <= lev[:, None]) & (lev[:, None] < (p_lvl + take)[None, :])  # [m, C]
            lev_cum = torch.cumsum(at_lev.to(i32), dim=-1)
            of = torch.argmax((at_lev & (lev_cum == (pos + 1)[:, None])).to(i32), dim=-1)
            return take, of.tolist(), m, None, True

        def round_():
            prio_c = torch.where(fillable, state.claim_npods * C + idxC, big(idxC))
            claim_lane_prio = torch.where(lanes_cm, prio_c[:, None], torch.full_like(lanes_cm, _BIG, dtype=i32))
            lane_prio = torch.where(lane_open_claim, claim_lane_prio.min(dim=0).values, torch.full((V,), _BIG, dtype=i32, device=dev))
            win_c = torch.argmin(claim_lane_prio, dim=0)  # [V]
            m = min(k_chain, n_win)
            of = win_c[torch.argsort(lane_prio, stable=True)][:m].tolist()
            if m == 0 or of[0] != claim_pick:
                return single()
            take = torch.zeros(C, dtype=i32, device=dev)
            for c in of:
                take[c] += 1
            return take, of, m, None, True

        def spread():
            # lane-insensitivity: every relevant type admits and offers every
            # pinnable lane (synthetic single-lane rows through the gates)
            eyeV = torch.eye(V, dtype=torch.bool, device=dev)
            syn = ReqTensor(
                admitted=torch.where(key_onehot_g[None, :, None], eyeV[:, None, :], lv[None, :, :]),
                comp=(~key_onehot_g)[None].expand(V, K),
                gt=torch.full((V, K), -(2**31) + 1, dtype=i32, device=dev),
                lt=torch.full((V, K), 2**31 - 1, dtype=i32, device=dev),
                defined=key_onehot_g[None].expand(V, K),
            )
            kg_ok = masks.packed_pairwise_compat(
                syn, masks.pack_lanes(syn.admitted), masks.negative_polarity(syn, lv, ln, bounds_free),
                problem.it_reqs, statics.it_packed, statics.it_neg, bounds_free,
            ) & _offer_rows(problem, syn.admitted)  # [V, T]
            relevant_t = claim_it_ok2.any(dim=0)
            pinnable = pod_dom_g & reg_g
            insensitive = not bool((relevant_t[None, :] & pinnable[:, None] & ~kg_ok).any())
            resurrect = claim_ok_pre & ~claim_topo_ok
            counts, npods, cap = counts_g0.clone(), state.claim_npods.clone(), cap_c.clone()
            lanes = lanes_cm.clone()
            picks: List[int] = []
            maxi_v = torch.full((V,), _MAXI, dtype=torch.int64, device=dev)
            for _ in range(k_chain):
                sc = torch.where(sup_mask, counts, torch.full_like(counts, _MAXI))
                gmin = 0 if gmin_zero else int(sc.min())
                self_cnt = counts + s_gi
                within = (self_cnt - gmin) <= skew_g
                elig = lanes & (reg_g & within)[None, :]
                any_lane = elig.any(dim=-1)
                okc = any_lane & (cap > 0)
                prio = torch.where(okc, npods * C + idxC, big(idxC))
                pick = int(torch.argmin(prio))
                res_prio = torch.where(resurrect & any_lane, npods * C + idxC, big(idxC))
                if not bool(okc.any()) or int(res_prio.min()) < int(prio.min()):
                    break
                rank = torch.where(elig[pick], self_cnt.to(torch.int64) * V + lexv, maxi_v)
                a = int(torch.argmin(rank))
                counts[a] += s_gi
                npods[pick] += 1
                cap[pick] -= 1
                lanes[pick] = False
                lanes[pick, a] = True
                picks.append(pick)
            if not insensitive or not picks or picks[0] != claim_pick:
                return single()
            take = torch.zeros(C, dtype=i32, device=dev)
            for c in picks:
                take[c] += 1
            pin = torch.where(take > 0, torch.argmax(lanes.to(i32), dim=-1), torch.full_like(take, -1))
            return take, picks, len(picks), pin, True

        branch = FILL if use_fill else ROUND if use_round else SPREAD if use_spread else SINGLE
        take, claim_of, k, pin, multi = (single, fill, round_, spread)[branch]()
        took = take > 0

        # -- commit k members
        committed = claim_final
        if pin is not None:
            pinned = pin >= 0
            pin_hot = torch.arange(V, device=dev)[None, :] == pin[:, None]  # [C, V]
            committed = ReqTensor(
                admitted=torch.where((pinned[:, None] & key_onehot_g[None, :])[:, :, None],
                                     pin_hot[:, None, :], claim_final.admitted),
                comp=claim_final.comp, gt=claim_final.gt, lt=claim_final.lt, defined=claim_final.defined,
            )
        if bool(took.any()):
            t2, t3 = took[:, None], took[:, None, None]
            cr = state.claim_req
            state.claim_req = ReqTensor(
                admitted=torch.where(t3, committed.admitted, cr.admitted),
                comp=torch.where(t2, committed.comp, cr.comp),
                gt=cr.gt if bounds_free else torch.where(t2, committed.gt, cr.gt),
                lt=cr.lt if bounds_free else torch.where(t2, committed.lt, cr.lt),
                defined=torch.where(t2, committed.defined, cr.defined),
            )
            state.claim_requests = _add_times(state.claim_requests, take[:, None], pod.requests[None, :])
            state.claim_it_ok = torch.where(t2, claim_it_ok2 & (cap_ct_all >= take[:, None]), state.claim_it_ok)
            state.claim_npods = state.claim_npods + take
            state.claim_used_ports = state.claim_used_ports | (t2 & pod.ports[None, :])
        if kind == KIND_NODE:
            commit_node(state, node_pick, node_row, pod, k)
        slot_req = None
        if is_open:
            slot_req = tpl_final.row(tpl_pick)
            tpl_row_it_ok = tpl_it_ok2[tpl_pick]
            max_cap = torch.where(tpl_row_it_ok[:, None], problem.it_cap, torch.zeros_like(problem.it_cap)).max(dim=0).values
            s = free_slot
            set_row(state.claim_req, s, slot_req)
            state.claim_requests[s] = tpl_requests2[tpl_pick]
            state.claim_it_ok[s] = tpl_row_it_ok
            state.claim_open[s] = True
            state.claim_npods[s] += 1
            state.claim_tpl[s] = tpl_pick
            state.claim_used_ports[s] |= pod.ports
            state.remaining[tpl_pick] = state.remaining[tpl_pick] - max_cap
            if mint_hostnames:
                state.grp_registered = state.grp_registered | (host_groups[:, None] & host_onehot[None, :])

        # -- the topology record: one unit delta per committed row, weighted
        # by the members' own select/owned rows
        if G > 0 and placed:
            sel_mem, own_mem = sel_all[p:p + k], own_all[p:p + k]
            if bool((sel_mem | own_mem).any()):
                add = torch.zeros((G, V), dtype=i32, device=dev)
                reg = torch.zeros((G, V), dtype=torch.bool, device=dev)
                if multi:
                    for c in sorted(set(claim_of)):
                        unit = unit_record(pod, committed.row(c), wellknown)
                        mem = torch.tensor([x == c for x in claim_of], dtype=torch.bool, device=dev)
                        w = torch.where(problem.grp_inverse, (own_mem & mem[:, None]).sum(dim=0),
                                        (sel_mem & mem[:, None]).sum(dim=0)).to(i32)
                        add += w[:, None] * unit.to(i32)
                        reg |= (w > 0)[:, None] & unit
                else:
                    if kind == KIND_NODE:
                        rec_row, allow = node_row, no_allow
                    elif is_open:
                        rec_row, allow = slot_req, wellknown
                    else:
                        rec_row, allow = claim_final.row(claim_pick), wellknown
                    unit = unit_record(pod, rec_row, allow)
                    w = torch.where(problem.grp_inverse, own_mem.sum(dim=0), sel_mem.sum(dim=0)).to(i32)
                    add = w[:, None] * unit.to(i32)
                    reg = (w > 0)[:, None] & unit
                state.grp_counts = state.grp_counts + add
                state.grp_registered = state.grp_registered | reg

        rows = claim_of if is_claim else [index] * k
        return kind, rows, k

    def narrow(state: FFDState, pod: PodRow, p: int, k_chain: int) -> Tuple[int, List[int], int]:
        return commit(state, evaluate(state, pod), pod, p, k_chain)

    def wave(state: FFDState, xs, queue: List[int], h: int, chain: List[bool], lanes: int, cont: bool,
             kinds: List[int], idxs: List[int], nq: List[int]) -> Tuple[int, int, int, int, int]:
        """The wavefront after a narrow iteration (the JAX package's
        ``_wave_extend``, ops/ffd_sweeps.py:473): up to ``lanes`` further
        chain heads from queue cursor ``h``, each evaluated against ``state``
        as the first lane left it, act in queue order while ``cont`` holds.
        A lane acts only when its verdict provably equals the sequential
        one: its matched groups are disjoint from those earlier lanes
        recorded into, and a placement's node is untouched or every claim an
        earlier lane touched is ineligible to it. A placement stacks up to
        its bin's fit and fewest-pods rank (one bin); a verdict with no node,
        no claim and no template sends the whole chain to ``nq``. Only a
        whole-chain placement or such a failure lets the next lane act.
        Writes the lanes' verdict rows into ``kinds``/``idxs``, then commits
        the placements and their summed topology record into ``state``.
        Returns (pods consumed, lanes acted, placements, pods placed, failed
        chains)."""
        qlen = len(queue)
        touched_c: set = set()
        touched_n: set = set()
        eff_acc = torch.zeros(G, dtype=torch.bool, device=dev)
        placements = []
        consumed = n_lanes = n_commit = n_pods = n_retry = 0
        for _ in range(lanes):
            if not cont or h >= qlen:
                break
            p = queue[h]
            kch = chain_length(queue, h, chain)
            pod = pod_row(xs, p)
            ev = evaluate(state, pod)
            any_node = ev.any_node
            is_claim = not any_node and ev.any_claim
            fail = not any_node and not ev.any_claim and ev.has_slot and ev.active and not ev.any_tpl
            topo_indep = stack_safe = True
            if G > 0:
                match = pod.grp_match
                topo_indep = not bool((match & eff_acc).any())
                inverse = problem.grp_inverse
                feedback = match & ((pod.grp_selects & ~inverse) | (pod.grp_owned & inverse))
                stack_safe = not bool((feedback & ~aff_safe).any())
            claim_indep = not any(int(ev.cap_c[c]) > 0 for c in touched_c)
            node_indep = ev.node_pick not in touched_n
            placed = topo_indep and ((any_node and node_indep) or (is_claim and claim_indep))
            failed = topo_indep and fail
            if placed:
                if is_claim:
                    j_rank = (ev.rank2 - 1 - ev.claim_pick) // C - ev.claim_npods0 + 1
                    fitc = ev.claim_fit_count
                else:
                    j_rank, fitc = _BIG_CAP, ev.node_fit_count
                k = max(min(min(fitc, j_rank) if stack_safe else 1, kch), 1)
                kind, index = (KIND_NODE, ev.node_pick) if any_node else (KIND_CLAIM, ev.claim_pick)
                placements.append((ev, pod, p, k))
                (touched_n if any_node else touched_c).add(index)
                if G > 0:
                    eff_acc = eff_acc | (sel_all[p:p + kch] | own_all[p:p + kch]).any(dim=0)
                n_commit += 1
                n_pods += k
            elif failed:
                k, kind, index = kch, KIND_FAIL, -1
                nq.extend(range(p, p + kch))
                n_retry += 1
            else:
                break
            for s in range(k):
                kinds[p + s], idxs[p + s] = kind, index
            n_lanes += 1
            consumed += k
            h += k
            cont = k == kch

        # -- the placements, each into its own bin, and their records summed
        add = torch.zeros((G, V), dtype=i32, device=dev)
        reg = torch.zeros((G, V), dtype=torch.bool, device=dev)
        for ev, pod, p, k in placements:
            if ev.any_node:
                row, allow = ev.node_row, no_allow
                commit_node(state, ev.node_pick, row, pod, k)
            else:
                c, row, allow = ev.claim_pick, ev.claim_final.row(ev.claim_pick), wellknown
                set_row(state.claim_req, c, row)
                state.claim_requests[c] = _add_times(state.claim_requests[c], torch.tensor(k, dtype=i32, device=dev),
                                                     pod.requests)
                state.claim_it_ok[c] = ev.claim_it_ok2[c] & (ev.cap_ct_all[c] >= k)
                state.claim_npods[c] += k
                state.claim_used_ports[c] |= pod.ports
            if G > 0:
                w = torch.where(problem.grp_inverse, own_all[p:p + k].sum(dim=0),
                                sel_all[p:p + k].sum(dim=0)).to(i32)
                if bool((w > 0).any()):
                    unit = unit_record(pod, row, allow)
                    add += w[:, None] * unit.to(i32)
                    reg |= (w > 0)[:, None] & unit
        if placements and G > 0:
            state.grp_counts = state.grp_counts + add
            state.grp_registered = state.grp_registered | reg
        return consumed, n_lanes, n_commit, n_pods, n_retry

    narrow.evaluate = evaluate
    narrow.commit = commit
    narrow.wave = wave
    return narrow
