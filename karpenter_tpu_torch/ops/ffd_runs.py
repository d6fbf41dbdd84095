"""Run-compressed FFD: one scan step commits a RUN of identical pods.

Plain PyTorch counterpart of the JAX package's ``ops/ffd_runs.py``. The
encoder segments the FFD queue into runs (solver/encode.segment_runs): a
length-1 run takes the per-pod step (ops/ffd_step.make_step), a run of
identical topology-blind pods the closed-form analytic commit
(``make_run_commit``), a run of identical topology-interacting pods the light
per-pod inner loop (ops/topo_runs.make_topo_run_commit). The consolidation
screens (parallel/mesh.py) run this scan once per candidate lane; on CUDA
tensors they launch the ``runs_screen`` kernel (csrc/runs_screen.cu), which
carries the same three commits. ``runs_scan_plain`` is the yardstick the
kernel is held to.

The plain commits update the carried FFDState in place, like the plain step.
"""

from __future__ import annotations

from typing import Optional

import torch

from karpenter_tpu_torch.models.problem import (
    HOSTNAME_KEY,
    RUN_ANALYTIC,
    RUN_SINGLE,
    RUN_TOPO,
    ReqTensor,
    SchedulingProblem,
)
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    _BIG_CAP,
    KIND_CLAIM,
    KIND_FAIL,
    KIND_NEW_CLAIM,
    KIND_NO_SLOT,
    KIND_NODE,
    FFDResult,
    FFDState,
    PodRow,
    _bcast,
    _add_times,
    _capacity,
    _intersect_rows,
    _lane_align,
    _mix_req_rows,
    _offer_rows,
    _pad_lanes_mult32,
    _pin_hostname,
    _pod_xs,
    _statics,
    _water_level,
    initial_state,
    pod_row,
)
from karpenter_tpu_torch.ops.ffd_step import clone_state, make_step
from karpenter_tpu_torch.ops.padding import pow2_bucket


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def make_run_commit(problem: SchedulingProblem, statics, C: int, max_run: int):
    """The analytic multi-pod commit: one call places a whole run of
    identical, topology-blind pods and reproduces the per-pod step's outcome,
    each pod's (kind, index) in temporal order included, in closed form
    (the JAX package's ``_make_run_commit``):

      nodes  - a pod takes the first node with room, so k pods fill nodes in
               index order up to each node's integer capacity;
      claims - a pod takes the open claim with the fewest pods, so the pods
               waterfill the claims' levels, each bounded by its capacity;
               the temporal order is (level before, claim index);
      opens  - pods beyond claim capacity open template claims one at a time,
               each absorbing pods up to its own capacity; limit headroom
               burns once per open.
    """
    lv, ln = statics.lv, statics.ln
    wellknown, no_allow = statics.wellknown, statics.no_allow
    N = problem.num_nodes
    D = problem.pod_vol_counts.shape[1]
    G = problem.num_groups
    mint = problem.claim_hostname_lane.shape[0] > 0
    dev = lv.device
    win = torch.arange(max_run, device=dev)
    arange_c = torch.arange(C, device=dev)
    host_groups = problem.grp_key == HOSTNAME_KEY

    def commit(state: FFDState, pod: PodRow, start: int, length: int, active_arr):
        act = active_arr[start:start + max_run] & (win < length)
        k = int(act.sum())
        kind_row = torch.full((max_run,), KIND_FAIL, dtype=torch.int32, device=dev)
        index_row = torch.full((max_run,), -1, dtype=torch.int32, device=dev)
        if k == 0:
            # no active member: every commit below adds nothing
            return kind_row, index_row
        ordinal = (torch.cumsum(act.to(torch.int64), 0) - 1).to(torch.int32)
        port_cap = 1 if bool(pod.ports.any()) else _BIG_CAP

        # -- 1. existing nodes: first-fit fill in node order
        placed_n = 0
        node_of = torch.zeros((max_run,), dtype=torch.int32, device=dev)
        if N > 0:
            node_merged = _intersect_rows(state.node_req, pod.req)
            node_compat = masks.compatible_ok(state.node_req, _bcast(pod.req), lv, ln, no_allow)
            node_port_ok = ~(state.node_used_ports & pod.conflict[None, :]).any(dim=-1)
            if D > 0:
                # an over-limit attach count reads as 0 capacity, not negative
                vol_room = torch.clamp(
                    torch.div(problem.node_vol_limits - state.node_vol_used,
                              torch.clamp(pod.vols[None, :], min=1), rounding_mode="floor"),
                    min=0,
                )
                vol_cap = torch.where(pod.vols[None, :] > 0, vol_room, _BIG_CAP).min(dim=-1).values
            else:
                vol_cap = torch.full((N,), _BIG_CAP, dtype=torch.int32, device=dev)
            res_cap = _capacity(problem.node_avail, state.node_requests, pod.requests[None, :])
            node_ok = pod.tol_node & node_compat & node_port_ok
            ncap = torch.where(
                node_ok, torch.clamp(torch.minimum(res_cap, vol_cap.to(torch.int32)), max=port_cap), 0
            ).to(torch.int32)
            ncum = torch.cumsum(ncap.to(torch.int64), 0).to(torch.int32)
            placed_n = min(k, int(ncum[-1]))
            node_take = torch.clamp(k - (ncum - ncap), min=0)
            node_take = torch.minimum(node_take, ncap).to(torch.int32)
            took_n = node_take > 0
            state.node_req = _mix_req_rows(state.node_req, node_merged, took_n)
            state.node_requests = _add_times(state.node_requests, node_take[:, None], pod.requests[None, :])
            state.node_npods = state.node_npods + node_take
            state.node_used_ports = state.node_used_ports | (took_n[:, None] & pod.ports[None, :])
            state.node_vol_used = state.node_vol_used + node_take[:, None] * pod.vols[None, :]
            node_of = torch.searchsorted(ncum, ordinal, right=True).to(torch.int32)
        rem = k - placed_n

        # -- 2. open claims: fewest-pods waterfill bounded by capacity
        claim_merged = _intersect_rows(state.claim_req, pod.req)
        claim_compat = masks.compatible_ok(state.claim_req, _bcast(pod.req), lv, ln, wellknown)
        claim_port_ok = ~(state.claim_used_ports & pod.conflict[None, :]).any(dim=-1)
        m_packed = masks.pack_lanes(claim_merged.admitted)
        m_neg = masks.negative_polarity(claim_merged, lv, ln)
        itc = masks.packed_pairwise_compat(
            claim_merged, m_packed, m_neg, problem.it_reqs, statics.it_packed, statics.it_neg
        )  # [C, T]
        itok = state.claim_it_ok & itc & _offer_rows(problem, claim_merged.admitted)
        cap_ct = _capacity(
            problem.it_alloc[None, :, :], state.claim_requests[:, None, :], pod.requests[None, None, :]
        )  # [C, T]
        cap_c = torch.where(itok, cap_ct, 0).max(dim=-1).values
        elig = (
            state.claim_open & pod.tol_tpl[state.claim_tpl.long()] & claim_compat & claim_port_ok
        )
        cap_c = torch.where(elig, torch.clamp(cap_c, max=port_cap), 0).to(torch.int32)
        p_lvl = state.claim_npods.clone()
        m = min(rem, int(cap_c.sum()))
        L = _water_level(p_lvl, cap_c, _i32(m, dev))
        take0 = torch.minimum(torch.clamp(L - p_lvl, min=0), cap_c)
        leftover = m - int(take0.sum())
        at_level = (p_lvl + take0 == L) & (take0 < cap_c)
        extra = at_level & (torch.cumsum(at_level.to(torch.int64), 0) <= leftover)
        claim_take = (take0 + extra.to(torch.int32)).to(torch.int32)
        tookc = claim_take > 0
        state.claim_req = _mix_req_rows(state.claim_req, claim_merged, tookc)
        state.claim_requests = _add_times(state.claim_requests, claim_take[:, None], pod.requests[None, :])
        state.claim_npods = state.claim_npods + claim_take
        state.claim_it_ok = torch.where(
            tookc[:, None], itok & (cap_ct >= claim_take[:, None]), state.claim_it_ok
        )
        state.claim_used_ports = state.claim_used_ports | (tookc[:, None] & pod.ports[None, :])
        rem2 = rem - int(claim_take.sum())

        # temporal ordinal -> claim: assignments sort by (level before, claim)
        jj = torch.clamp(ordinal - placed_n, min=0)
        lev = _water_level(p_lvl, claim_take, jj)  # [MR]
        before = torch.minimum(
            torch.clamp(lev[:, None] - p_lvl[None, :], min=0), claim_take[None, :]
        ).sum(dim=-1)
        pos = jj - before
        at_lev = (p_lvl[None, :] <= lev[:, None]) & (lev[:, None] < (p_lvl + claim_take)[None, :])
        lev_cum = torch.cumsum(at_lev.to(torch.int64), dim=-1)
        claim_of = torch.argmax(
            (at_lev & (lev_cum == (pos + 1)[:, None])).to(torch.int32), dim=-1
        ).to(torch.int32)

        # -- 3. fresh template claims, one open at a time; the template-side
        # products depend only on the pod and are computed once
        placed_new, noslot = 0, False
        new_take = torch.zeros((C,), dtype=torch.int32, device=dev)
        if rem2 > 0:
            tpl_merged = _intersect_rows(problem.tpl_reqs, pod.req)
            tpl_compat = masks.compatible_ok(problem.tpl_reqs, _bcast(pod.req), lv, ln, wellknown)
            t_packed = masks.pack_lanes(tpl_merged.admitted)
            t_neg = masks.negative_polarity(tpl_merged, lv, ln)
            itc_t = masks.packed_pairwise_compat(
                tpl_merged, t_packed, t_neg, problem.it_reqs, statics.it_packed, statics.it_neg
            )  # [TPL, T]
            cap_tt = _capacity(
                problem.it_alloc[None, :, :], problem.tpl_overhead[:, None, :], pod.requests[None, None, :]
            )  # [TPL, T]
            itok_t_static = (
                problem.tpl_it_ok & itc_t & _offer_rows(problem, tpl_merged.admitted) & (cap_tt >= 1)
            )
            c_rem = rem2
            while c_rem > 0:
                closed = ~state.claim_open
                has_slot = bool(closed.any())
                free_slot = int(torch.argmax(closed.to(torch.int32))) if has_slot else C
                within = masks.fits(problem.it_cap[None, :, :], state.remaining[:, None, :])
                itok_t = itok_t_static & within
                q_t = torch.where(itok_t, cap_tt, 0).max(dim=-1).values  # [TPL]
                tpl_ok = pod.tol_tpl & tpl_compat & (q_t >= 1)
                any_tpl = bool(tpl_ok.any())
                noslot |= not has_slot
                if not (any_tpl and has_slot):
                    break
                pick = int(torch.argmax(tpl_ok.to(torch.int32)))
                take = min(c_rem, int(q_t[pick]), port_cap)
                slot_req = tpl_merged.row(pick)
                if mint:
                    host = problem.claim_hostname_lane[min(free_slot, problem.claim_hostname_lane.shape[0] - 1)]
                    host_onehot = torch.arange(problem.num_lanes, device=dev) == host
                    slot_req = _pin_hostname(slot_req, host_onehot)
                    state.grp_registered = state.grp_registered | (host_groups[:, None] & host_onehot[None, :])
                hot = arange_c == free_slot
                state.claim_req = _mix_req_rows(state.claim_req, _bcast(slot_req), hot)
                surv1 = itok_t[pick]
                state.claim_it_ok[free_slot] = surv1 & (cap_tt[pick] >= take)
                state.claim_requests[free_slot] = _add_times(problem.tpl_overhead[pick], _i32(take, dev), pod.requests)
                max_cap = torch.where(surv1[:, None], problem.it_cap, torch.zeros_like(problem.it_cap)).max(dim=0).values
                state.remaining[pick] = state.remaining[pick] - max_cap
                state.claim_open[free_slot] = True
                state.claim_npods[free_slot] += take
                state.claim_tpl[free_slot] = pick
                state.claim_used_ports[free_slot] |= pod.ports
                new_take[free_slot] += take
                c_rem -= take
                placed_new += take

        new_cum = torch.cumsum(new_take.to(torch.int64), 0).to(torch.int32)  # slot order == opening order
        nc_ord = ordinal - placed_n - m
        newclaim_of = torch.searchsorted(new_cum, nc_ord, right=True).to(torch.int32)
        opens_slot = nc_ord == (new_cum - new_take)[torch.clamp(newclaim_of, max=C - 1).long()]

        # -- 4. per-row outputs, in the run's queue window
        fail_kind = KIND_NO_SLOT if noslot else KIND_FAIL
        in_n = ordinal < placed_n
        in_c = ordinal < placed_n + m
        in_new = ordinal < placed_n + m + placed_new
        kind_row = torch.where(
            ~act, KIND_FAIL,
            torch.where(in_n, KIND_NODE, torch.where(in_c, KIND_CLAIM, torch.where(
                in_new, torch.where(opens_slot, KIND_NEW_CLAIM, KIND_CLAIM), fail_kind))),
        ).to(torch.int32)
        index_row = torch.where(
            ~act, -1,
            torch.where(in_n, node_of, torch.where(in_c, claim_of, torch.where(in_new, newclaim_of, -1))),
        ).to(torch.int32)

        # -- 5. Topology.Record of every placed member against the final row
        # of the bin it landed on (members are topology-blind, so records
        # never feed back into a member's own gates and simply sum)
        if G > 0:
            sel = problem.pod_grp_selects[start:start + max_run]
            sel = torch.cat([sel, torch.zeros((max_run - sel.shape[0], G), dtype=torch.bool, device=dev)])
            _record_rows(problem, state, kind_row, index_row, sel, lv, ln, wellknown, no_allow)
        return kind_row, index_row

    return commit


def _bin_rows(state: FFDState) -> ReqTensor:
    if state.node_req.admitted.shape[0] == 0:
        return state.claim_req
    return ReqTensor(*(torch.cat([getattr(state.node_req, f), getattr(state.claim_req, f)])
                       for f in ("admitted", "comp", "gt", "lt", "defined")))


def _record_rows(problem, state, kind_row, index_row, sel, lv, ln, wellknown, no_allow) -> None:
    """Sum the records of a run's placed members into the topology counters:
    member i on bin b counts once in every group g it selects whose domain on
    b's final row is recordable (concrete, one domain for spread/affinity,
    past the group's node filter, not inverse)."""
    N = problem.num_nodes
    placed = kind_row < KIND_FAIL
    if not bool(placed.any()):
        return
    bins = torch.where(kind_row == KIND_NODE, index_row, N + index_row)
    rows = _bin_rows(state)
    B = rows.admitted.shape[0]
    cnt = torch.zeros((B, sel.shape[1]), dtype=torch.int32, device=sel.device)
    for i in torch.nonzero(placed).flatten().tolist():
        cnt[int(bins[i])] += sel[i].to(torch.int32)
    key = problem.grp_key.long()
    dom = rows.admitted[:, key, :]  # [B, G, V]
    concrete = ~rows.comp[:, key]  # [B, G]
    single = dom.sum(dim=-1) == 1
    spread_or_aff = (problem.grp_type == 0) | (problem.grp_type == 1)
    F = problem.grp_filter_valid.shape[1]
    if F > 0:
        allow = torch.cat([no_allow[None].expand(N, -1), wellknown[None].expand(B - N, -1)])
        term_ok = masks.compatible_ok(
            ReqTensor(*(getattr(rows, f)[:, None, None] for f in ("admitted", "comp", "gt", "lt", "defined"))),
            ReqTensor(*(getattr(problem.grp_filter, f)[None] for f in ("admitted", "comp", "gt", "lt", "defined"))),
            lv, ln, allow[:, None, None, :],
        )  # [B, G, F]
        filt = ~problem.grp_has_filter[None] | (problem.grp_filter_valid[None] & term_ok).any(dim=-1)
    else:
        filt = torch.ones_like(concrete)
    dom_ok = concrete & torch.where(spread_or_aff[None], single, True) & filt & ~problem.grp_inverse[None]
    dom_final = dom & dom_ok[:, :, None]
    state.grp_counts = state.grp_counts + (cnt[:, :, None] * dom_final.to(torch.int32)).sum(dim=0).to(torch.int32)
    state.grp_registered = state.grp_registered | ((cnt[:, :, None] > 0) & dom_final).any(dim=0)


def max_run_bucket(problem: SchedulingProblem) -> int:
    """The max-run window bucket of a problem (every run fits in it)."""
    run_len = problem.run_len
    longest = int(run_len.max()) if run_len.numel() else 1
    return pow2_bucket(max(longest, 1), lo=1)


def has_topo_runs(problem: SchedulingProblem) -> bool:
    """Whether any run needs the topology run commit."""
    return bool((problem.run_mode == RUN_TOPO).any())


def check_run_modes(problem: SchedulingProblem, with_topo: bool) -> None:
    """A RUN_TOPO run in a scan built without the topology commit is an
    error: taking the analytic commit for it would ignore its topology (the
    JAX package's switch clamps it there silently)."""
    if not with_topo and has_topo_runs(problem):
        raise ValueError("the problem has RUN_TOPO runs but the scan was built without the topology commit")
    modes = set(problem.run_mode.tolist())
    if not modes <= {RUN_SINGLE, RUN_ANALYTIC, RUN_TOPO}:
        raise ValueError(f"unknown run modes {sorted(modes)}")


def runs_scan_plain(problem: SchedulingProblem, init: FFDState, max_run: int, with_topo: bool) -> FFDResult:
    """Plain PyTorch run-compressed scan (the JAX package's
    ``_solve_ffd_runs_jit``): one step per run, then the run windows
    scattered back to queue order; rows no run covers (padding) stay
    KIND_FAIL / -1. ``init`` is not modified."""
    from karpenter_tpu_torch.ops.topo_runs import make_topo_run_commit

    check_run_modes(problem, with_topo)
    problem, init = _lane_align(problem, init)
    C = init.claim_open.shape[0]
    dev = problem.lane_valid.device
    state = clone_state(init)
    statics = _statics(problem)
    step = make_step(problem, statics, C)
    commit = make_run_commit(problem, statics, C, max_run)
    topo_commit = make_topo_run_commit(problem, statics, C, max_run) if with_topo else None
    xs = _pod_xs(problem)
    P = problem.num_pods
    active_arr = torch.cat([problem.pod_active, torch.zeros((max_run,), dtype=torch.bool, device=dev)])
    kinds = torch.full((P,), KIND_FAIL, dtype=torch.int32, device=dev)
    idxs = torch.full((P,), -1, dtype=torch.int32, device=dev)
    for start, length, mode in zip(problem.run_start.tolist(), problem.run_len.tolist(),
                                   problem.run_mode.tolist()):
        if length <= 0:
            continue  # a padding run: an analytic commit of nothing
        if mode == RUN_SINGLE:
            kind, index = step(state, pod_row(xs, start))
            kind_row, index_row = _i32([kind], dev), _i32([index], dev)
        elif mode == RUN_ANALYTIC:
            kind_row, index_row = commit(state, pod_row(xs, start), start, length, active_arr)
        else:
            kind_row, index_row = topo_commit(state, pod_row(xs, start), start, length, active_arr)
        kinds[start:start + length] = kind_row[:length]
        idxs[start:start + length] = index_row[:length]
    return FFDResult(kind=kinds, index=idxs, state=state)


def solve_ffd_runs(problem: SchedulingProblem, max_claims: int, init: Optional[FFDState] = None) -> FFDResult:
    """One pack pass through the run-compressed scan (plain PyTorch; the
    screens' kernel runs it per lane)."""
    if init is None:
        problem = _pad_lanes_mult32(problem)
        init = initial_state(problem, max_claims)
    return runs_scan_plain(problem, init, max_run_bucket(problem), has_topo_runs(problem))

