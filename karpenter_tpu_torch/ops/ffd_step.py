"""The per-pod FFD step and the one-pass scan entry.

``make_step`` is the plain PyTorch counterpart of the JAX package's
``ops/ffd_step._make_step``: one call places one pod in the reference's
priority order (scheduler.go:238-285) — existing nodes first, then open
claims with the fewest pods, then a fresh claim from the first template that
accepts the pod. The one-pass scan (``solve_ffd``, the backend's per-pass
mode, and ffd_loop's one-pass mode) steps pods through exactly this logic;
the requeue loop's narrow iteration (ops/ffd_chain.py) evaluates the same
gate phases and commits whole chains.

The plain step updates the carried FFDState in place (the JAX version
returns a new state); callers that need the old state clone it first.

``attribute_pods`` is the explain pass (the JAX package's ``_attribute_jit``,
program 7): the same gate phases re-run per failed pod against the final
state, reduced into the obs/explain.py wire words. It launches the
``attribute`` kernel (csrc/attribute.cu) for CUDA tensors and runs its plain
version, ``attribute_plain``, for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import HOSTNAME_KEY, ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    _BIG,
    KIND_CLAIM,
    KIND_FAIL,
    KIND_NEW_CLAIM,
    KIND_NO_SLOT,
    KIND_NODE,
    FFDResult,
    FFDState,
    PodRow,
    _bcast,
    _first_true,
    _fresh_template_rows,
    _intersect_rows,
    _lane_align,
    _make_it_gate,
    _mix_req_rows,
    _offer_rows,
    _pad_lanes_mult32,
    _pod_xs,
    _statics,
    initial_state,
    pod_row,
    problem_bounds_free,
)
from karpenter_tpu_torch.ops.topology_kernels import PodTopoStatics, record, topo_gate


def make_step(problem: SchedulingProblem, statics, C: int):
    lv, ln = statics.lv, statics.ln
    wellknown, no_allow = statics.wellknown, statics.no_allow
    bounds_free = statics.bounds_free
    N = problem.num_nodes
    TPL = problem.num_templates
    dev = lv.device
    it_gate = _make_it_gate(problem, statics)
    arange_c = torch.arange(C, device=dev, dtype=torch.int32)
    arange_n = torch.arange(N, device=dev)
    mint_hostnames = problem.claim_hostname_lane.shape[0] > 0
    host_groups = problem.grp_key == HOSTNAME_KEY  # [G]

    def step(state: FFDState, pod: PodRow) -> Tuple[int, int]:
        """Place one pod against ``state`` (updated in place); returns
        (kind, index)."""
        if not bool(pod.active):
            # masked-out rows (padding) fail without touching state
            return KIND_FAIL, -1
        topo_pod = PodTopoStatics(
            strict_admitted=pod.strict.admitted,
            grp_match=pod.grp_match,
            grp_selects=pod.grp_selects,
            grp_owned=pod.grp_owned,
        )

        def gated(merged, allow, registered):
            return topo_gate(problem, state.grp_counts, registered, topo_pod, merged, allow)

        # -- 1. existing nodes (scheduler.go:240-244; existingnode.go:64-124)
        any_node, node_pick, node_final, node_requests2 = False, 0, None, None
        if N > 0:
            node_requests2 = state.node_requests + pod.requests[None, :]
            node_fit = masks.fits(node_requests2, problem.node_avail)
            node_merged = _intersect_rows(state.node_req, pod.req, bounds_free)
            if bounds_free:
                node_neg = masks.negative_polarity(state.node_req, lv, ln, True)
                node_compat = masks.compatible_from_merged(
                    masks.nonempty(node_merged, True), state.node_req.defined,
                    node_neg, pod.req.defined, pod.neg, no_allow,
                )
            else:
                node_compat = masks.compatible_ok(
                    state.node_req, _bcast(pod.req), lv, ln, no_allow
                )
            node_port_ok = ~(state.node_used_ports & pod.conflict[None, :]).any(dim=-1)
            node_vol_ok = (
                state.node_vol_used + pod.vols[None, :] <= problem.node_vol_limits
            ).all(dim=-1)
            node_topo_ok, node_final = gated(node_merged, no_allow, state.grp_registered)
            node_ok = (
                pod.tol_node & node_fit & node_compat & node_port_ok & node_vol_ok & node_topo_ok
            )
            node_pick = int(_first_true(node_ok))
            any_node = node_pick < N

        # -- 2. open claims, fewest pods first (scheduler.go:247-254)
        claim_merged = _intersect_rows(state.claim_req, pod.req, bounds_free)
        if bounds_free:
            claim_neg = masks.negative_polarity(state.claim_req, lv, ln, True)
            claim_compat = masks.compatible_from_merged(
                masks.nonempty(claim_merged, True), state.claim_req.defined,
                claim_neg, pod.req.defined, pod.neg, wellknown,
            )
        else:
            claim_compat = masks.compatible_ok(state.claim_req, _bcast(pod.req), lv, ln, wellknown)
        claim_topo_ok, claim_final = gated(claim_merged, wellknown, state.grp_registered)
        claim_requests2 = state.claim_requests + pod.requests[None, :]
        claim_it_ok2 = it_gate(claim_final, claim_requests2, state.claim_it_ok)
        claim_port_ok = ~(state.claim_used_ports & pod.conflict[None, :]).any(dim=-1)
        claim_ok = (
            state.claim_open
            & pod.tol_tpl[state.claim_tpl.long()]
            & claim_port_ok
            & claim_compat
            & claim_topo_ok
            & claim_it_ok2.any(dim=-1)
        )
        claim_rank = torch.where(
            claim_ok, state.claim_npods * C + arange_c, torch.full_like(arange_c, _BIG)
        )
        claim_pick = int(torch.argmin(claim_rank))
        any_claim = bool(claim_ok.any())

        # -- 3. fresh claim from templates, weight order (scheduler.go:256-283);
        # the prospective slot's hostname is minted before evaluation
        # (nodeclaim.go:46-63) and its lane registered for topology if opened
        free_slot_t = _first_true(~state.claim_open)
        free_slot = int(free_slot_t)
        has_slot = free_slot < C
        any_tpl = False
        if not any_node and not any_claim and has_slot:
            tpl_requests2 = problem.tpl_overhead + pod.requests[None, :]
            tpl_merged, tpl_compat, host_onehot = _fresh_template_rows(
                problem, lv, ln, wellknown, pod.req, free_slot_t,
                bounds_free=bounds_free, tpl_neg=statics.tpl_neg, pod_neg=pod.neg,
            )
            reg_for_tpl = state.grp_registered | (host_groups[:, None] & host_onehot[None, :])
            tpl_topo_ok, tpl_final = gated(tpl_merged, wellknown, reg_for_tpl)
            within_limits = masks.fits(
                problem.it_cap[None, :, :], state.remaining[:, None, :]
            )  # [TPL, T]
            tpl_it_ok2 = it_gate(tpl_final, tpl_requests2, problem.tpl_it_ok & within_limits)
            tpl_ok = pod.tol_tpl & tpl_compat & tpl_topo_ok & tpl_it_ok2.any(dim=-1)
            tpl_pick = int(_first_true(tpl_ok))
            any_tpl = tpl_pick < TPL

        # with every slot taken the template phase never ran: the no-slot
        # case classifies as KIND_NO_SLOT unconditionally (the backend's
        # slot-growth retry then produces the true answer)
        if any_node:
            kind, index = KIND_NODE, node_pick
        elif any_claim:
            kind, index = KIND_CLAIM, claim_pick
        elif not has_slot:
            return KIND_NO_SLOT, -1
        elif any_tpl:
            kind, index = KIND_NEW_CLAIM, free_slot
        else:
            return KIND_FAIL, -1

        # -- commit (all gates above read the pre-commit state)
        new_registered = state.grp_registered
        if kind == KIND_NODE:
            rec_row = node_final.row(node_pick)
            rec_allow = no_allow
            state.node_req = _mix_req_rows(
                state.node_req, node_final, arange_n == node_pick, bounds_free
            )
            state.node_requests[node_pick] = node_requests2[node_pick]
            state.node_npods[node_pick] += 1
            state.node_used_ports[node_pick] |= pod.ports
            state.node_vol_used[node_pick] += pod.vols
        elif kind == KIND_CLAIM:
            rec_row = claim_final.row(claim_pick)
            rec_allow = wellknown
            state.claim_req = _mix_req_rows(
                state.claim_req, claim_final, arange_c == claim_pick, bounds_free
            )
            state.claim_requests[claim_pick] = claim_requests2[claim_pick]
            state.claim_it_ok[claim_pick] = claim_it_ok2[claim_pick]
            state.claim_npods[claim_pick] += 1
            state.claim_used_ports[claim_pick] |= pod.ports
        else:
            slot_req = tpl_final.row(tpl_pick)
            tpl_row_it_ok = tpl_it_ok2[tpl_pick]
            max_cap = torch.where(
                tpl_row_it_ok[:, None], problem.it_cap, torch.zeros_like(problem.it_cap)
            ).max(dim=0).values  # [R]
            rec_row = slot_req
            rec_allow = wellknown
            state.claim_req = _mix_req_rows(
                state.claim_req, _bcast(slot_req), arange_c == free_slot, bounds_free
            )
            state.claim_requests[free_slot] = tpl_requests2[tpl_pick]
            state.claim_it_ok[free_slot] = tpl_row_it_ok
            state.claim_open[free_slot] = True
            state.claim_npods[free_slot] += 1
            state.claim_tpl[free_slot] = tpl_pick
            state.claim_used_ports[free_slot] |= pod.ports
            # opening a claim burns pessimistic headroom (subtractMax) and
            # registers its hostname lane for hostname topologies
            state.remaining[tpl_pick] = state.remaining[tpl_pick] - max_cap
            if mint_hostnames:
                new_registered = new_registered | (host_groups[:, None] & host_onehot[None, :])

        # topology record for the chosen bin (topology.go:125-148)
        if bool(pod.grp_selects.any()) or bool(pod.grp_owned.any()):
            state.grp_counts, new_registered = record(
                problem, state.grp_counts, new_registered, topo_pod, rec_row,
                rec_allow, torch.ones((), dtype=torch.bool, device=dev), lv, ln,
            )
        state.grp_registered = new_registered
        return kind, index

    return step


def clone_state(state: FFDState) -> FFDState:
    def c(x):
        if isinstance(x, ReqTensor):
            return ReqTensor(*(t.clone() for t in (x.admitted, x.comp, x.gt, x.lt, x.defined)))
        return x.clone()

    return FFDState(**{k: c(v) for k, v in vars(state).items()})


def solve_ffd_plain(problem: SchedulingProblem, init: FFDState, bounds_free: bool) -> FFDResult:
    """Plain PyTorch one-pass scan: every row stepped once in queue order
    against the carried state (the JAX package's ``_solve_ffd_jit``)."""
    problem, init = _lane_align(problem, init)
    C = init.claim_open.shape[0]
    state = clone_state(init)
    step = make_step(problem, _statics(problem, bounds_free), C)
    xs = _pod_xs(problem, bounds_free)
    P = problem.num_pods
    kinds, idxs = [], []
    for p in range(P):
        k, i = step(state, pod_row(xs, p))
        kinds.append(k)
        idxs.append(i)
    dev = problem.lane_valid.device
    return FFDResult(
        kind=torch.tensor(kinds, dtype=torch.int32, device=dev).reshape(P),
        index=torch.tensor(idxs, dtype=torch.int32, device=dev).reshape(P),
        state=state,
    )


def solve_ffd(
    problem: SchedulingProblem, max_claims: int, init: Optional[FFDState] = None
) -> FFDResult:
    """Run one pack pass (no requeue). ``init`` carries bin and topology state
    between relax-and-retry passes (scheduler.go:150-170). On CUDA tensors
    this launches the ffd_loop kernel in its one-pass mode; on CPU tensors it
    runs the plain version."""
    if init is None:
        problem = _pad_lanes_mult32(problem)
        init = initial_state(problem, max_claims)
    if problem.lane_valid.is_cuda:
        from karpenter_tpu_torch.ops.ffd_sweeps import launch_ffd_loop

        problem, init = _lane_align(problem, init)
        return launch_ffd_loop(problem, init, one_pass=True)
    return solve_ffd_plain(problem, init, problem_bounds_free(problem))


# -- the explain pass (program 7) ---------------------------------------------


def make_attribution(problem: SchedulingProblem, statics, C: int, state: FFDState):
    """``attr(pod) -> int32[3]``: one pod's gate-family attribution against
    ``state`` (the JAX package's ``_make_attribution``). Mirrors make_step's
    node, claim and template gate phases, but instead of picking a bin it
    reduces per-family fail predicates into the obs/explain.py wire words via
    masks.family_bitmask. Family bit order is obs/explain.FAM_*: resources,
    requirements, taints, host-ports, topology, claim-capacity, volume."""
    lv, ln = statics.lv, statics.ln
    wellknown, no_allow = statics.wellknown, statics.no_allow
    bounds_free = statics.bounds_free
    N, TPL = problem.num_nodes, problem.num_templates
    dev = lv.device
    host_groups = problem.grp_key == HOSTNAME_KEY

    def it_terms(rows: ReqTensor, requests):
        """(compat & offer, fit) halves of the instance-type gate [B, T],
        apart, so that attribution sees which half killed the last type."""
        compat = masks.packed_pairwise_compat(
            rows, masks.pack_lanes(rows.admitted), masks.negative_polarity(rows, lv, ln, bounds_free),
            problem.it_reqs, statics.it_packed, statics.it_neg, bounds_free,
        )
        fit = masks.fits(requests[:, None, :], problem.it_alloc[None, :, :])
        return compat & _offer_rows(problem, rows.admitted), fit

    # template-side capacity terms do not depend on the pod
    tpl_base0 = problem.tpl_it_ok  # [TPL, T]
    tpl_cap_ok = tpl_base0 & masks.fits(problem.it_cap[None, :, :], state.remaining[:, None, :])
    tpl_has_base = tpl_base0.any(dim=-1)
    tpl_has_cap = tpl_cap_ok.any(dim=-1)
    tpl_fail_cap = tpl_has_base & ~tpl_has_cap  # nodepool limits ate the headroom

    def compat_rows(base: ReqTensor, merged: ReqTensor, pod: PodRow, allow):
        if bounds_free:
            return masks.compatible_from_merged(
                masks.nonempty(merged, True), base.defined,
                masks.negative_polarity(base, lv, ln, True), pod.req.defined, pod.neg, allow,
            )
        return masks.compatible_ok(base, _bcast(pod.req), lv, ln, allow)

    def attr(pod: PodRow) -> torch.Tensor:
        topo_pod = PodTopoStatics(pod.strict.admitted, pod.grp_match, pod.grp_selects, pod.grp_owned)

        def gated(merged, allow, registered):
            return topo_gate(problem, state.grp_counts, registered, topo_pod, merged, allow)

        # -- node class
        if N == 0:
            node_ubn = torch.tensor([0, 1 << 7, 0], dtype=torch.int32, device=dev)
        else:
            node_fit = masks.fits(state.node_requests + pod.requests[None, :], problem.node_avail)
            node_merged = _intersect_rows(state.node_req, pod.req, bounds_free)
            node_compat = compat_rows(state.node_req, node_merged, pod, no_allow)
            node_port_ok = ~(state.node_used_ports & pod.conflict[None, :]).any(dim=-1)
            node_vol_ok = (state.node_vol_used + pod.vols[None, :] <= problem.node_vol_limits).all(dim=-1)
            node_topo_ok, _ = gated(node_merged, no_allow, state.grp_registered)
            zeros_n = torch.zeros(N, dtype=torch.bool, device=dev)
            node_ubn = masks.family_bitmask(
                torch.stack([~node_fit, ~node_compat, ~pod.tol_node, ~node_port_ok, ~node_topo_ok,
                             zeros_n, ~node_vol_ok]),
                # padded node rows carry node_avail = -1 (ops/padding.py)
                (problem.node_avail >= 0).any(dim=-1),
            )

        # -- open-claim class
        claim_merged = _intersect_rows(state.claim_req, pod.req, bounds_free)
        claim_compat = compat_rows(state.claim_req, claim_merged, pod, wellknown)
        claim_topo_ok, claim_final = gated(claim_merged, wellknown, state.grp_registered)
        it_co, it_fit = it_terms(claim_final, state.claim_requests + pod.requests[None, :])
        claim_co = state.claim_it_ok & it_co
        has_base = state.claim_it_ok.any(dim=-1)
        has_co = claim_co.any(dim=-1)
        has_fit = (claim_co & it_fit).any(dim=-1)
        claim_port_ok = ~(state.claim_used_ports & pod.conflict[None, :]).any(dim=-1)
        zeros_c = torch.zeros(C, dtype=torch.bool, device=dev)
        claim_ubn = masks.family_bitmask(
            torch.stack([
                (has_co & ~has_fit) | ~has_base,
                ~claim_compat | (has_base & ~has_co),
                ~pod.tol_tpl[state.claim_tpl.long()],
                ~claim_port_ok,
                ~claim_topo_ok,
                zeros_c,
                zeros_c,
            ]),
            state.claim_open,
        )

        # -- fresh-template class (the same minted slot as the step)
        free_slot = _first_true(~state.claim_open)
        tpl_merged, tpl_compat, host_onehot = _fresh_template_rows(
            problem, lv, ln, wellknown, pod.req, free_slot,
            bounds_free=bounds_free, tpl_neg=statics.tpl_neg, pod_neg=pod.neg,
        )
        reg_for_tpl = state.grp_registered | (host_groups[:, None] & host_onehot[None, :])
        tpl_topo_ok, tpl_final = gated(tpl_merged, wellknown, reg_for_tpl)
        it_co_t, it_fit_t = it_terms(tpl_final, problem.tpl_overhead + pod.requests[None, :])
        tpl_co = tpl_cap_ok & it_co_t
        has_co_t = tpl_co.any(dim=-1)
        has_fit_t = (tpl_co & it_fit_t).any(dim=-1)
        zeros_t = torch.zeros(TPL, dtype=torch.bool, device=dev)
        tpl_ubn = masks.family_bitmask(
            torch.stack([
                has_co_t & ~has_fit_t,
                ~tpl_compat | ~tpl_has_base | (tpl_has_cap & ~has_co_t),
                ~pod.tol_tpl,
                zeros_t,
                ~tpl_topo_ok,
                tpl_fail_cap,
                zeros_t,
            ]),
            # padded template rows have tpl_it_ok all-False (ops/padding.py)
            tpl_has_base,
        )
        # one int32 triple per pod: class bytes packed node | claim<<8 | tpl<<16
        return node_ubn + claim_ubn * 256 + tpl_ubn * 65536

    return attr


def attribute_plain(problem: SchedulingProblem, state: FFDState, rows) -> torch.Tensor:
    """Plain PyTorch explain pass: int32[B, 3] words (union, blockers, near)
    for the pod rows ``rows`` against ``state``, one row at a time."""
    bounds_free = problem_bounds_free(problem)
    problem, state = _lane_align(problem, state)
    rows = [int(r) for r in torch.as_tensor(rows).reshape(-1).tolist()]
    dev = problem.lane_valid.device
    if not rows:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    attr = make_attribution(problem, _statics(problem, bounds_free), state.claim_open.shape[0], state)
    xs = _pod_xs(problem, bounds_free)
    return torch.stack([attr(pod_row(xs, r)) for r in rows])


def attribute_pods(problem: SchedulingProblem, state: FFDState, rows, tables: Optional[dict] = None) -> torch.Tensor:
    """int32[B, 3] explain words (obs/explain.py wire format) for the pod rows
    ``rows``, evaluated against the final ``state``: one ``attribute`` launch
    over all the rows for CUDA tensors, the plain version for CPU tensors.
    ``tables``: the problem's tables in the kernels' layout as the solve's
    ``ffd_loop`` launch read them (``FFDResult.tables``), else packed here."""
    if problem.lane_valid.is_cuda:
        problem, state = _lane_align(problem, state)
        return launch_attribute(problem, state, rows, tables)[0]
    return attribute_plain(problem, state, rows)


# -- the attribute kernel's argument struct (csrc/attribute.cu AttrArgs) ------

_ATTR_INPUTS = (
    "lvw", "ln", "lex", "wellknown",
    "pod_adm", "pod_comp", "pod_def", "pod_gt", "pod_lt", "pod_neg", "pod_strict_adm",
    "pod_requests", "pod_tol_tpl", "pod_tol_node", "pod_conflict", "pod_match", "pod_selects", "pod_vols",
    "it_adm", "it_comp", "it_def", "it_gt", "it_lt", "it_neg",
    "it_alloc", "it_cap", "offer_zone", "offer_ct", "offer_ok",
    "tpl_adm", "tpl_comp", "tpl_def", "tpl_gt", "tpl_lt", "tpl_neg", "tpl_overhead", "tpl_it_ok",
    "node_avail", "node_vol_limits",
    "grp_type", "grp_key", "grp_max_skew", "grp_min_domains", "host_lane",
    "claim_adm", "claim_comp", "claim_def", "claim_gt", "claim_lt",
    "claim_requests", "claim_it_ok", "claim_open", "claim_tpl", "claim_ports",
    "node_adm", "node_comp", "node_def", "node_gt", "node_lt",
    "node_requests", "node_ports", "node_vol_used", "remaining", "grp_counts", "grp_registered",
    "rows",
)
# the rows' plan (attr_row_plan): the words of each row stand for ``mult``
# entries of ``rows``
ATTR_PLAN = ("mult",)
# written by the kernel and read by nothing after it (not counted as its bytes)
ATTR_SCRATCH = ("sections", "next", "plan")
_ATTR_POINTERS = _ATTR_INPUTS + ATTR_PLAN + ("words", "work") + ATTR_SCRATCH
_ATTR_INTS = ("K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G", "CH", "B", "NB", "TW")
_AttrArgs = kernels.make_struct("AttrArgs", _ATTR_POINTERS, _ATTR_INTS)
# persistent blocks of one launch, at most: one per SM of an H100, each of
# 16 warps in teams, a team a row at a time
ATTR_BLOCKS = 132
# the kernel's work counters, in order: csrc/step.cuh WORK_* (the work the
# launch needs: the gates of the rows it attributes, the type tests up to
# each bin's first survivor), then csrc/attribute.cu AW_*, for comparison
# only: the gates of every entry of ``rows`` and every listed type tested
# (the work of a launch that attributes every row and stops at no survivor)
ATTR_WORK_COUNTERS = ("bin_gates", "topo_lanes", "type_tests", "barriers", "cluster_barriers",
                      "entry_gates", "listed_type_tests")
# the kernel's section counters (csrc/attribute.cu ASEC_*): each team's
# cycles between its barriers (the first five, and the block's table load),
# then the warps' own cycles by part of a bin
ATTR_SECTIONS = ("prep", "bins", "prep_templates", "templates", "words",
                 "node_gate", "claim_gate", "claim_types", "template_gate", "template_types", "load")
_TEAM_SECTIONS = ("load", "prep", "bins", "prep_templates", "templates", "words")
def attr_section_split(sections, kernel_ms: float) -> dict:
    """The teams' sections' shares of their cycles times ``kernel_ms``, then
    each part of a bin's share of the warps' cycles (``*_share``)."""
    cyc = dict(zip(ATTR_SECTIONS, (int(x) for x in sections)))
    team = sum(cyc[n] for n in _TEAM_SECTIONS) or 1
    out = {n: cyc[n] / team * kernel_ms for n in _TEAM_SECTIONS if cyc[n]}
    parts = [n for n in ATTR_SECTIONS if n not in _TEAM_SECTIONS]
    warps = sum(cyc[n] for n in parts) or 1
    out.update({f"{n}_share": cyc[n] / warps for n in parts if cyc[n]})
    return out


def attr_row_plan(pod_eqprev, rows):
    """The rows one launch attributes, on the host: ``rows`` (pod rows) and
    ``pod_eqprev`` (bool[P]: the row's encoded tensors equal the previous
    row's; None: every entry its own row). Rows of one run of byte-identical
    rows get the same words, so each run among ``rows`` is attributed once,
    at its first entry. Returns (the rows to attribute, how many entries
    each stands for, each entry's index among them) as int32 numpy arrays."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if pod_eqprev is None or rows.size < 2:
        return rows.astype(np.int32), np.ones(rows.size, dtype=np.int32), np.arange(rows.size, dtype=np.int32)
    eq = np.asarray(pod_eqprev, dtype=bool)
    head = np.maximum.accumulate(np.where(eq, 0, np.arange(eq.size)))
    _, first, inverse = np.unique(head[rows], return_index=True, return_inverse=True)
    # keep the runs in the order of their first entries
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    inverse = rank[inverse.reshape(-1)]
    return (rows[first[order]].astype(np.int32), np.bincount(inverse, minlength=order.size).astype(np.int32),
            inverse.astype(np.int32))


def attr_team_warps(n_rows: int) -> int:
    """Warps a team for a launch over ``n_rows`` rows: a team a row at a time
    and the teams of ATTR_BLOCKS blocks, so few rows get wide teams (each
    row's bins over more warps), many rows narrow ones (more rows at once)."""
    for tw in (16, 8, 4):
        if n_rows <= ATTR_BLOCKS * (16 // tw):
            return tw
    return 4


def attribute_words(t: dict) -> torch.Tensor:
    """The launch's int32[B, 3] words, one row per entry of ``rows``: each
    run's attributed row's words copied to its entries."""
    return t["words"][t["inverse"]]


def attribute_args(problem: SchedulingProblem, state: FFDState, rows, tables: Optional[dict] = None):
    """The ``attribute`` kernel's tensors by struct field name and its
    argument struct (``problem``/``state`` lane-aligned). The problem's
    tables are ``tables`` where the caller has them (the solve's own,
    ``FFDResult.tables``), else ``problem_tensors``; the state is read where
    it lies; the rows' plan is ``attr_row_plan`` over the problem's
    ``pod_eqprev`` (``t["inverse"]`` maps each entry of ``rows`` to its
    attributed row)."""
    from karpenter_tpu_torch.ops.ffd_sweeps import check_tables, problem_tensors, state_tensors

    dev = problem.lane_valid.device
    if tables is not None:
        check_tables(tables, problem.num_pods, problem.num_instance_types, problem.num_keys, problem.num_lanes)
        t = dict(tables)
    else:
        t = problem_tensors(problem)
    t.update(state_tensors(state, problem.lane_valid, problem.lane_numeric, copy=False))
    entries = torch.as_tensor(rows).reshape(-1).cpu().numpy()
    eq = problem.pod_eqprev
    eq = None if eq is None else np.asarray(eq.cpu() if isinstance(eq, torch.Tensor) else eq)
    urows, mult, inverse = attr_row_plan(eq, entries)
    B = int(urows.size)
    plan = torch.from_numpy(np.concatenate([urows, mult, inverse])).to(dev)
    t["rows"], t["mult"], t["inverse"] = plan[:B], plan[B:2 * B], plan[2 * B:].long()
    K, W = t["lvw"].shape
    V = t["ln"].shape[1]
    N, C, TPL = problem.num_nodes, state.claim_open.shape[0], problem.num_templates
    TW = attr_team_warps(B)
    NB = max(1, min(ATTR_BLOCKS, -(-B // (16 // TW))))
    t.update(kernels.workspace([("words", torch.int32, (B, 3)), ("next", torch.int32, (1,)),
                                ("plan", torch.int32, (5,))], dev))
    counters = torch.zeros((len(ATTR_WORK_COUNTERS) + len(ATTR_SECTIONS),), dtype=torch.int64, device=dev)
    t["work"], t["sections"] = counters[:len(ATTR_WORK_COUNTERS)], counters[len(ATTR_WORK_COUNTERS):]
    G = problem.grp_key.shape[0]
    dims = dict(K=K, V=V, W=W, C=C, N=N, T=problem.num_instance_types, TPL=TPL, R=problem.num_resources,
                O=t["offer_ok"].shape[1], PT=t["pod_ports"].shape[1], D=t["pod_vols"].shape[1], G=G,
                CH=t["host_lane"].shape[0], B=B, NB=NB, TW=TW)
    inverse = t["inverse"]
    t = {name: t[name] for name in _ATTR_POINTERS}
    args = _AttrArgs(**{name: t[name].data_ptr() for name in _ATTR_POINTERS}, **dims)
    t["inverse"] = inverse
    return t, args


def launch_attribute(problem: SchedulingProblem, state: FFDState, rows, tables: Optional[dict] = None):
    """Run the ``attribute`` kernel on CUDA tensors: every row's words in one
    launch (the JAX package's 32-row chunks exist only for its static
    shapes). ``problem``/``state`` lane-aligned; ``tables`` as in
    ``attribute_pods``. Returns (int32[B, 3] words, int64[7] work counters,
    ATTR_WORK_COUNTERS)."""
    dev = problem.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_attribute needs CUDA tensors")
    t, args = attribute_args(problem, state, rows, tables)
    if args.B > 0:
        kernels.launch("attribute", args, torch.cuda.current_stream(dev).cuda_stream)
    return attribute_words(t), t["work"]
