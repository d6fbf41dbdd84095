"""FFD solver core: carried state, constants, initial state, lane padding and
alignment, the shared per-pod gate builders, and the closed-form capacity and
water-level math of the run commit (ops/ffd_runs.py).

Plain PyTorch counterpart of the JAX package's ``ops/ffd_core.py``. Reference
anchor: scheduler.go:140-189 (Solve pod loop) and :238-285 (placement
priority).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from karpenter_tpu_torch.models.problem import (
    CT_KEY,
    GT_NONE,
    HOSTNAME_KEY,
    LT_NONE,
    ZONE_KEY,
    ReqTensor,
    SchedulingProblem,
)
from karpenter_tpu_torch.ops import masks

KIND_NODE = 0
KIND_CLAIM = 1
KIND_NEW_CLAIM = 2
KIND_FAIL = 3
KIND_NO_SLOT = 4  # a fresh claim would accept the pod, but slots ran out

_BIG = 2**30


@dataclass
class FFDState:
    claim_req: ReqTensor  # [C, K, V] narrowed requirement state per claim
    claim_requests: Any  # f32[C, R] accumulated requests (incl daemon overhead)
    claim_it_ok: Any  # bool[C, T] surviving instance types
    claim_open: Any  # bool[C]
    claim_npods: Any  # i32[C]
    claim_tpl: Any  # i32[C]
    claim_used_ports: Any  # bool[C, PT] reserved host-port lanes
    node_req: ReqTensor  # [N, K, V] narrowed existing-node requirements
    node_requests: Any  # f32[N, R] accumulated requests (incl daemon overhead)
    node_npods: Any  # i32[N]
    node_used_ports: Any  # bool[N, PT]
    node_vol_used: Any  # i32[N, D] CSI attach counts per limited driver
    remaining: Any  # f32[TPL, R] nodepool limits headroom (+inf unlimited)
    grp_counts: Any  # i32[G, V] topology domain counts
    grp_registered: Any  # bool[G, V] known topology domains


class IterCounts(NamedTuple):
    """Loop counters of one sweeps-mode solve, as the JAX package counts
    them: ``narrow`` the narrow iterations (each evaluates one pod and
    commits its chain, ops/ffd_chain.py), ``sweeps`` the requeue sweeps,
    ``chain_commits`` the iterations that consumed more than one pod and
    ``chain_pods`` the pods those iterations consumed."""

    narrow: Any
    sweeps: Any
    chain_commits: Any
    chain_pods: Any


@dataclass
class FFDResult:
    kind: Any  # i32[P]
    index: Any  # i32[P] node index / claim slot (meaning depends on kind)
    state: FFDState  # final bin state
    iters: Any = None  # IterCounts (sweeps path only)
    work: Any = None  # i64[4] ffd_loop work counters (kernel path only; ffd_sweeps.WORK_COUNTERS)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (or len(mask) when none), as a 0-d tensor."""
    ext = torch.cat([mask, torch.ones(1, dtype=torch.bool, device=mask.device)])
    return torch.argmax(ext.to(torch.int32))


def _intersect_rows(reqs: ReqTensor, row: ReqTensor, bounds_free: bool = False) -> ReqTensor:
    """Intersect every row of ``reqs`` ([E, K, ...]) with one row."""
    return masks.intersect(reqs, _bcast(row), bounds_free)


def _bcast(row: ReqTensor) -> ReqTensor:
    return ReqTensor(
        admitted=row.admitted[None], comp=row.comp[None], gt=row.gt[None],
        lt=row.lt[None], defined=row.defined[None],
    )


def problem_bounds_free(problem: SchedulingProblem) -> bool:
    """No requirement in the problem carries a finite integer Gt/Lt bound, so
    gt/lt are sentinels everywhere for the whole solve. Takes a problem of
    torch tensors or of numpy arrays."""
    for r in (
        problem.pod_reqs,
        problem.pod_strict_reqs,
        problem.it_reqs,
        problem.tpl_reqs,
        problem.node_reqs,
        problem.grp_filter,
    ):
        gt, lt = torch.as_tensor(r.gt), torch.as_tensor(r.lt)
        if gt.numel() and (bool((gt != int(GT_NONE)).any()) or bool((lt != int(LT_NONE)).any())):
            return False
    return True


def initial_state(problem: SchedulingProblem, max_claims: int) -> FFDState:
    K, V = problem.num_keys, problem.num_lanes
    T, R = problem.num_instance_types, problem.num_resources
    N, C = problem.num_nodes, max_claims
    PT = problem.pod_ports.shape[1]
    lv = problem.lane_valid
    dev = lv.device
    return FFDState(
        claim_req=ReqTensor(
            admitted=lv[None].expand(C, K, V).clone(),
            comp=torch.ones((C, K), dtype=torch.bool, device=dev),
            gt=torch.full((C, K), int(GT_NONE), dtype=torch.int32, device=dev),
            lt=torch.full((C, K), int(LT_NONE), dtype=torch.int32, device=dev),
            defined=torch.zeros((C, K), dtype=torch.bool, device=dev),
        ),
        claim_requests=torch.zeros((C, R), dtype=torch.float32, device=dev),
        claim_it_ok=torch.zeros((C, T), dtype=torch.bool, device=dev),
        claim_open=torch.zeros((C,), dtype=torch.bool, device=dev),
        claim_npods=torch.zeros((C,), dtype=torch.int32, device=dev),
        claim_tpl=torch.zeros((C,), dtype=torch.int32, device=dev),
        claim_used_ports=torch.zeros((C, PT), dtype=torch.bool, device=dev),
        node_req=ReqTensor(
            admitted=problem.node_reqs.admitted.clone(),
            comp=problem.node_reqs.comp.clone(),
            gt=problem.node_reqs.gt.clone(),
            lt=problem.node_reqs.lt.clone(),
            defined=problem.node_reqs.defined.clone(),
        ),
        node_requests=problem.node_overhead.clone(),
        node_npods=torch.zeros((N,), dtype=torch.int32, device=dev),
        node_used_ports=problem.node_used_ports.clone(),
        node_vol_used=problem.node_vol_used.clone(),
        remaining=problem.tpl_remaining.clone(),
        grp_counts=problem.grp_counts0.clone(),
        grp_registered=problem.grp_registered0.clone(),
    )


def _pad_last(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[-1] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=-1)


def _pad_lanes_mult32(problem: SchedulingProblem) -> SchedulingProblem:
    """Pad the value-lane axis to a multiple of 32 for bitpacking (a no-op on
    problems from ops/padding.py, which already buckets V)."""
    V = problem.num_lanes
    pad = (-V) % 32
    if pad == 0:
        return problem

    def pad_req(r: ReqTensor) -> ReqTensor:
        return dataclasses.replace(r, admitted=_pad_last(r.admitted, pad, False))

    return dataclasses.replace(
        problem,
        lane_valid=_pad_last(problem.lane_valid, pad, False),
        lane_numeric=_pad_last(problem.lane_numeric, pad, float("nan")),
        lane_lex_rank=_pad_last(problem.lane_lex_rank, pad, 2**30),
        pod_reqs=pad_req(problem.pod_reqs),
        pod_strict_reqs=pad_req(problem.pod_strict_reqs),
        it_reqs=pad_req(problem.it_reqs),
        tpl_reqs=pad_req(problem.tpl_reqs),
        node_reqs=pad_req(problem.node_reqs),
        grp_filter=pad_req(problem.grp_filter),
        grp_counts0=_pad_last(problem.grp_counts0, pad, 0),
        grp_registered0=_pad_last(problem.grp_registered0, pad, False),
    )


def _lane_align(problem: SchedulingProblem, init: FFDState):
    problem = _pad_lanes_mult32(problem)
    V = problem.num_lanes
    if init.grp_counts.shape[-1] != V:
        pad = V - init.grp_counts.shape[-1]

        def pad_adm(r):
            return dataclasses.replace(r, admitted=_pad_last(r.admitted, pad, False))

        init = dataclasses.replace(
            init,
            claim_req=pad_adm(init.claim_req),
            node_req=pad_adm(init.node_req),
            grp_counts=_pad_last(init.grp_counts, pad, 0),
            grp_registered=_pad_last(init.grp_registered, pad, False),
        )
    return problem, init


class Statics(NamedTuple):
    """Per-solve invariants of the per-pod step."""

    lv: Any  # bool[K, V]
    ln: Any  # f32[K, V]
    wellknown: Any  # bool[K]
    no_allow: Any  # bool[K]
    it_packed: Any  # int32[T, K, W]
    it_neg: Any  # bool[T, K]
    tpl_neg: Any  # bool[TPL, K]
    bounds_free: bool


def _statics(problem, bounds_free: bool = False) -> Statics:
    lv, ln = problem.lane_valid, problem.lane_numeric
    wellknown = problem.key_wellknown
    no_allow = torch.zeros_like(wellknown)
    it_packed = masks.pack_lanes(problem.it_reqs.admitted)
    it_neg = masks.negative_polarity(problem.it_reqs, lv, ln, bounds_free)
    tpl_neg = masks.negative_polarity(problem.tpl_reqs, lv, ln, bounds_free)
    return Statics(lv, ln, wellknown, no_allow, it_packed, it_neg, tpl_neg, bounds_free)


def _make_it_gate(problem, statics: Statics):
    lv, ln = statics.lv, statics.ln
    bounds_free = statics.bounds_free

    def it_gate(state_rows: ReqTensor, requests: torch.Tensor, prior_ok: torch.Tensor):
        """[B, T] mask of instance types surviving a narrowed state plus
        accumulated requests (nodeclaim.go:225-260)."""
        state_packed = masks.pack_lanes(state_rows.admitted)
        state_neg = masks.negative_polarity(state_rows, lv, ln, bounds_free)
        compat = masks.packed_pairwise_compat(
            state_rows, state_packed, state_neg,
            problem.it_reqs, statics.it_packed, statics.it_neg, bounds_free,
        )
        fit = masks.fits(requests[:, None, :], problem.it_alloc[None, :, :])
        offer = _offer_rows(problem, state_rows.admitted)
        return prior_ok & compat & fit & offer

    return it_gate


def _offer_rows(problem, admitted) -> torch.Tensor:
    """[B, T] has_offering over a batch of bin states (per-offering lane
    gathers; exactly the JAX package's dense offer_zc product)."""
    zone_adm = admitted[:, ZONE_KEY, :][:, problem.offer_zone.long()]  # [B, T, O]
    ct_adm = admitted[:, CT_KEY, :][:, problem.offer_ct.long()]
    return (problem.offer_ok[None] & zone_adm & ct_adm).any(dim=-1)


def _mix_req_rows(cur: ReqTensor, upd: ReqTensor, hot, bounds_free: bool = False) -> ReqTensor:
    """Commit updated requirement rows where ``hot`` (bool[E]) is set."""
    sel2, sel3 = hot[:, None], hot[:, None, None]
    if bounds_free:
        gt, lt = cur.gt, cur.lt
    else:
        gt = torch.where(sel2, upd.gt, cur.gt)
        lt = torch.where(sel2, upd.lt, cur.lt)
    return ReqTensor(
        admitted=torch.where(sel3, upd.admitted, cur.admitted),
        comp=torch.where(sel2, upd.comp, cur.comp),
        gt=gt,
        lt=lt,
        defined=torch.where(sel2, upd.defined, cur.defined),
    )


def _mint_host_onehot(problem: SchedulingProblem, free_slot) -> torch.Tensor:
    """One-hot of the hostname lane minted for the prospective slot
    (nodeclaim.go:46-63); all-False when the encoder allotted no lanes."""
    V = problem.num_lanes
    dev = problem.lane_valid.device
    CH = problem.claim_hostname_lane.shape[0]
    if CH == 0:
        return torch.zeros((V,), dtype=torch.bool, device=dev)
    host_lane = problem.claim_hostname_lane[torch.clamp(free_slot, max=CH - 1)]
    return torch.arange(V, device=dev) == host_lane


def _pin_hostname(row: ReqTensor, host_onehot) -> ReqTensor:
    """Pin requirement row(s) ([K, V] or [E, K, V]) to the minted hostname."""
    admitted = row.admitted.clone()
    admitted[..., HOSTNAME_KEY, :] = admitted[..., HOSTNAME_KEY, :] & host_onehot
    comp = row.comp.clone()
    comp[..., HOSTNAME_KEY] = False
    defined = row.defined.clone()
    defined[..., HOSTNAME_KEY] = True
    return ReqTensor(admitted=admitted, comp=comp, gt=row.gt, lt=row.lt, defined=defined)


def _fresh_template_rows(problem, lv, ln, wellknown, pod_req, free_slot,
                         bounds_free: bool = False, tpl_neg=None, pod_neg=None):
    """Fresh-claim template evaluation: the prospective slot's hostname is
    minted and pinned into the merged template rows before any gate sees
    them, and template compatibility uses the well-known allowance. Returns
    (tpl_merged, tpl_compat, host_onehot)."""
    mint_hostnames = problem.claim_hostname_lane.shape[0] > 0
    host_onehot = _mint_host_onehot(problem, free_slot)
    tpl_merged = _intersect_rows(problem.tpl_reqs, pod_req, bounds_free)
    if bounds_free and tpl_neg is not None and pod_neg is not None:
        tpl_compat = masks.compatible_from_merged(
            masks.nonempty(tpl_merged, bounds_free),
            problem.tpl_reqs.defined, tpl_neg,
            pod_req.defined, pod_neg, wellknown,
        )
    else:
        tpl_compat = masks.compatible_ok(
            problem.tpl_reqs, _bcast(pod_req), lv, ln, wellknown, bounds_free
        )
    if mint_hostnames:
        tpl_merged = _pin_hostname(tpl_merged, host_onehot)
    return tpl_merged, tpl_compat, host_onehot


class PodRow(NamedTuple):
    """One pod's slice of the per-pod arrays (the JAX package's _pod_xs
    tuple, by name)."""

    req: ReqTensor
    strict: ReqTensor
    requests: Any
    tol_tpl: Any
    tol_node: Any
    ports: Any
    conflict: Any
    grp_match: Any
    grp_selects: Any
    grp_owned: Any
    vols: Any
    active: Any
    neg: Any


def _pod_xs(problem: SchedulingProblem, bounds_free: bool = False) -> PodRow:
    """Per-pod arrays of the step, with the effective-requirement polarity
    computed once per solve."""
    pod_negs = masks.negative_polarity(
        problem.pod_reqs, problem.lane_valid, problem.lane_numeric, bounds_free
    )
    return PodRow(
        problem.pod_reqs,
        problem.pod_strict_reqs,
        problem.pod_requests,
        problem.pod_tol_tpl,
        problem.pod_tol_node,
        problem.pod_ports,
        problem.pod_port_conflict,
        problem.pod_grp_match,
        problem.pod_grp_selects,
        problem.pod_grp_owned,
        problem.pod_vol_counts,
        problem.pod_active,
        pod_negs,
    )


def pod_row(xs: PodRow, p: int) -> PodRow:
    return PodRow(*(x.row(p) if isinstance(x, ReqTensor) else x[p] for x in xs))


# integer "unbounded" sentinel for analytic pod-count capacities; large enough
# to never bind, small enough that int32 level arithmetic cannot overflow
_BIG_CAP = 2**20


def _capacity(avail, used, req):
    """Integer count of additional identical pods with requests ``req`` that
    fit in ``avail - used`` (trailing resource axis), honoring fits()'s float
    tolerance: max j with used + j*req <= avail + eps, the closed form of
    iterating the per-pod fit check. Zero-request dims still gate: an already
    overcommitted dim (or the -1 sentinel of a removed or padded bin) admits
    no pod."""
    eps = 1e-6 + 1e-6 * torch.abs(avail)
    room = avail + eps - used
    roomf = room / torch.where(req > 0, req, torch.ones_like(req))
    per_r = torch.where(req > 0, torch.floor(roomf), torch.full_like(roomf, float(_BIG_CAP)))
    zero_ok = ((req > 0) | (room >= 0)).all(dim=-1)
    cap = torch.clamp(per_r.min(dim=-1).values, 0, _BIG_CAP).to(torch.int32)
    return torch.where(zero_ok, cap, torch.zeros_like(cap))


def _add_times(base, take, req):
    """``base + take * req`` (float32, ``take`` an integer count) with one
    rounding, as a fused multiply-add: the JAX package's CPU compilation
    contracts the run commits' ``requests + take * pod_requests`` into one
    FMA. float64 holds the product of an int32 and a float32 exactly, so the
    sum rounds once to float64 and then to float32; the runs_screen kernel
    evaluates the same float64 expression."""
    return (base.to(torch.float64) + take.to(torch.float64) * req.to(torch.float64)).to(torch.float32)


def _water_level(levels, caps, units, iters: int = 22):
    """Largest integer L with sum(clip(L - levels, 0, caps)) <= units: the
    common fill level after pouring ``units`` one by one into the bin with the
    lowest level (index tie-break), each bin bounded by its cap. ``levels`` and
    ``caps`` are int32 [C]; ``units`` is an int32 tensor of any shape (the
    bisection runs elementwise over it)."""
    lo = torch.zeros_like(units)
    hi = torch.full_like(units, 2 * _BIG_CAP)
    for _ in range(iters):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        used = torch.minimum(torch.clamp(mid[..., None] - levels, min=0), caps).sum(dim=-1)
        ok = used <= units
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo
