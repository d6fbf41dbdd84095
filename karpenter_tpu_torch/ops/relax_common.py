"""The phase-1 pipeline of the two-phase solve, as plain PyTorch.

Counterpart of the JAX package's ``ops/relax_common.py``:

  screen -> bin-groups -> template pick -> [waterfill, ops/relax.py] ->
  real-gate rounding ladder -> committed FFDState + residue

  - ``relax_applicable``: the host-side screen (finite NodePool limits burn
    headroom claim by claim, which no dense open can reproduce);
  - ``eligibility``: the pods phase 1 may place, which by construction
    interact with no phase-2 pod except through claim membership;
  - ``plan_groups``: bin-groups over adjacent byte-equal eligible pods, the
    template each group packs on, the best-packing instance type's capacity
    vector and the normalised per-pod demand;
  - ``commit_assignment``: the real instance-type-gate rounding ladder over a
    proposed (slot, assigned), then the FFDState / verdict / topology commit.

The CUDA kernel ``relax_place`` (csrc/relax_place.cu) computes the same
function. Sums whose float32 result depends on the order of their adds (the
per-group and per-claim request sums) are taken here in pod-index order on a
host copy (``ordered_sum``), and the kernel adds in the same order, so the
two agree bit for bit on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from karpenter_tpu_torch.models.problem import HOSTNAME_KEY, ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_CLAIM,
    KIND_FAIL,
    KIND_NEW_CLAIM,
    FFDState,
    _make_it_gate,
    _mix_req_rows,
    _pin_hostname,
    initial_state,
)
from karpenter_tpu_torch.ops.topology_kernels import (
    TYPE_ANTI_AFFINITY,
    PodTopoStatics,
    record_delta,
)


def relax_applicable(problem: SchedulingProblem) -> bool:
    """Host-side screen: phase 1 runs only when every NodePool is unlimited."""
    rem = problem.tpl_remaining
    rem = rem.cpu().numpy() if isinstance(rem, torch.Tensor) else np.asarray(rem)
    return bool(np.all(np.isinf(rem)))


def ordered_sum(index: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """float32 [n, R]: row ``index[p]`` accumulates ``values[p]`` in pod-index
    order (rows with index >= n are dropped), on a host copy so the order
    does not depend on the device."""
    idx = index.cpu().numpy().astype(np.int64)
    vals = values.cpu().numpy().astype(np.float32)
    out = np.zeros((n + 1, vals.shape[1]), np.float32)
    np.add.at(out, np.minimum(idx, n), vals)
    return torch.from_numpy(out[:n]).to(values.device)


def _scatter(n: int, index, values, reduce: str, fill) -> torch.Tensor:
    """[n] (or [n, ...]) reduction of ``values`` into rows ``index`` from a
    ``fill`` start; rows with index >= n are dropped."""
    shape = (n + 1,) + tuple(values.shape[1:])
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    idx = torch.clamp(index.long(), max=n)
    if values.dim() > 1:
        idx = idx.reshape(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce(0, idx, values, reduce, include_self=True)[:n]


def eligibility(problem: SchedulingProblem, state0: FFDState, statics) -> torch.Tensor:
    """bool[P]: pods phase 1 may place.

      - host ports reserve per-claim lanes sequentially;
      - matched topology groups are gated by counters other pods move, owned
        groups feed inverse gates, and a pod selected by an inverse or
        anti-affinity group records into a blocking gate;
      - a hostname requirement may pin to another claim's minted lane;
      - a possibly-compatible existing node (screened at the initial node
        state) keeps node-priority semantics;
      - finite remaining headroom disables relaxation."""
    lv, ln, bf = statics.lv, statics.ln, statics.bounds_free
    G, N = problem.num_groups, problem.num_nodes
    pr = problem.pod_reqs
    req = problem.pod_requests

    elig = problem.pod_active.clone()
    if problem.pod_ports.shape[1] > 0:
        elig &= ~problem.pod_ports.any(dim=1)
        elig &= ~problem.pod_port_conflict.any(dim=1)
    if G > 0:
        elig &= ~problem.pod_grp_match.any(dim=1)
        elig &= ~problem.pod_grp_owned.any(dim=1)
        blocking = problem.grp_inverse | (problem.grp_type == TYPE_ANTI_AFFINITY)
        elig &= ~(problem.pod_grp_selects & blocking[None, :]).any(dim=1)
    elig &= ~pr.defined[:, HOSTNAME_KEY]
    elig &= torch.isinf(state0.remaining).all()
    if N > 0:
        node_fit = masks.fits(problem.node_overhead[None, :, :] + req[:, None, :],
                              problem.node_avail[None, :, :])  # [P, N]
        nr = problem.node_reqs
        compat = masks.packed_pairwise_compat(
            pr, masks.pack_lanes(pr.admitted), masks.negative_polarity(pr, lv, ln, bf),
            nr, masks.pack_lanes(nr.admitted), masks.negative_polarity(nr, lv, ln, bf), bf,
        )  # [P, N]: the node gate's allowance-free Intersects
        maybe = problem.pod_tol_node & node_fit & compat
        if problem.pod_vol_counts.shape[1] > 0:
            maybe &= (
                problem.node_vol_used[None, :, :] + problem.pod_vol_counts[:, None, :]
                <= problem.node_vol_limits[None, :, :]
            ).all(dim=-1)
        elig &= ~maybe.any(dim=1)
    return elig


class GroupPlan(NamedTuple):
    """Bin-groups, the template each packs on, and the normalised demand."""

    state0: FFDState
    it_gate: Any  # the real instance-type gate (ffd_core._make_it_gate)
    elig0: Any  # bool[P] raw eligibility screen
    elig: Any  # bool[P] after the group cap and template validity
    gid: Any  # i32[P] group id (valid where elig0)
    gidc: Any  # i32[P] clip(gid, 0, C-1)
    hp: Any  # i32[C] head pod of each group
    gvalid: Any  # bool[C]
    merged: ReqTensor  # [C, TPL, K, V] template rows merged with the head's
    tpick: Any  # i32[C] picked template per group
    prior: Any  # bool[TPL, T]
    overhead: Any  # f32[TPL, R]
    capvec: Any  # f32[C, R] best-packing instance type's capacity per group
    w: Any  # f32[P] normalised demand of eligible pods (0 elsewhere)


class Commit(NamedTuple):
    state: FFDState
    kind: Any  # i32[P]
    index: Any  # i32[P]
    residue_active: Any  # bool[P]
    assigned: Any  # bool[P] final (post-ladder) assignment
    open_c: Any  # bool[C] claims committed open


def _eq_prev(a: torch.Tensor) -> torch.Tensor:
    flat = a.reshape(a.shape[0], -1)
    return (flat[1:] == flat[:-1]).all(dim=1)


def _expand(r: ReqTensor, *lead) -> ReqTensor:
    return ReqTensor(
        admitted=r.admitted.expand(*lead, *r.admitted.shape[-2:]),
        comp=r.comp.expand(*lead, r.comp.shape[-1]),
        gt=r.gt.expand(*lead, r.gt.shape[-1]),
        lt=r.lt.expand(*lead, r.lt.shape[-1]),
        defined=r.defined.expand(*lead, r.defined.shape[-1]),
    )


def _lead(r: ReqTensor, fn) -> ReqTensor:
    return ReqTensor(*(fn(x) for x in (r.admitted, r.comp, r.gt, r.lt, r.defined)))


def plan_groups(problem: SchedulingProblem, C: int, statics) -> GroupPlan:
    """Eligibility, bin-groups over adjacent byte-equal eligible pods (their
    requests may differ), template pick per group from the head's row and the
    group's elementwise-max request, and the normalised per-pod demand
    against the group's best-packing instance type."""
    P, R = problem.num_pods, problem.num_resources
    TPL, T = problem.num_templates, problem.num_instance_types
    bf = statics.bounds_free
    lv, ln, wellknown = statics.lv, statics.ln, statics.wellknown
    dev = problem.lane_valid.device
    it_gate = _make_it_gate(problem, statics)
    state0 = initial_state(problem, C)
    pr = problem.pod_reqs
    req = problem.pod_requests
    pidx = torch.arange(P, dtype=torch.int32, device=dev)
    f32 = torch.float32

    elig0 = eligibility(problem, state0, statics)

    # -- bin-groups: adjacent eligible pods with byte-equal requirement rows
    # and template tolerations
    same = (_eq_prev(pr.admitted) & _eq_prev(pr.comp) & _eq_prev(pr.defined)
            & _eq_prev(problem.pod_tol_tpl))
    if not bf:
        same &= _eq_prev(pr.gt) & _eq_prev(pr.lt)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same = torch.cat([false1, same])
    join = elig0 & same & torch.cat([false1, elig0[:-1]])
    head = elig0 & ~join
    gid = (torch.cumsum(head.to(torch.int32), 0) - 1).to(torch.int32)
    # the group axis is capped at C: a group beyond C slots could not open a
    # claim anyway, so it goes to the repair pass whole
    elig = elig0 & (gid < C)
    head = head & (gid < C)
    gidc = torch.clamp(gid, 0, C - 1)
    gscatter = torch.where(head, gid, C)
    hp = _scatter(C, gscatter, pidx, "amax", 0)
    gvalid = _scatter(C, gscatter, torch.ones(P, dtype=torch.int32, device=dev), "amax", 0) > 0
    gmax = _scatter(C, torch.where(elig, gid, C), req, "amax", 0.0)

    # -- template pick per group: if the max member fits an instance type
    # per resource, every member does
    rep = pr.row(hp.long())  # [C, K, V]
    tplb = _lead(problem.tpl_reqs, lambda x: x[None])
    repb = _lead(rep, lambda x: x[:, None])
    merged = masks.intersect(tplb, repb, bf)
    merged = _expand(merged, C, TPL)
    tpl_compat = masks.compatible_ok(tplb, repb, lv, ln, wellknown, bf)  # [C, TPL]
    within_limits = masks.fits(problem.it_cap[None, :, :], state0.remaining[:, None, :])
    prior = problem.tpl_it_ok & within_limits  # [TPL, T]
    tol = problem.pod_tol_tpl[hp.long()]  # [C, TPL]
    overhead = problem.tpl_overhead
    flat = _lead(merged, lambda x: x.reshape(C * TPL, *x.shape[2:]))
    it_ok_max = it_gate(
        flat,
        (overhead[None, :, :] + gmax[:, None, :]).reshape(C * TPL, R),
        prior.repeat(C, 1),
    ).reshape(C, TPL, T)
    tpl_ok = tol & tpl_compat & it_ok_max.any(dim=-1)  # [C, TPL]
    ext = torch.cat([tpl_ok, torch.ones((C, 1), dtype=torch.bool, device=dev)], dim=1)
    tpick = torch.argmax(ext.to(torch.int32), dim=1).to(torch.int32)  # first True; TPL when none
    gvalid = gvalid & tpl_ok.any(dim=1)
    tpick = torch.clamp(tpick, max=TPL - 1)
    elig = elig & gvalid[gidc.long()]

    # -- normalised demand against the group's best-packing instance type
    garange = torch.arange(C, device=dev)
    it_pick_ok = it_ok_max[garange, tpick.long()]  # [C, T]
    capvec_t = problem.it_alloc[None, :, :] - overhead[tpick.long()][:, None, :]  # [C, T, R]
    gsum = ordered_sum(torch.where(elig, gid, C), torch.where(elig[:, None], req, 0.0), C)
    tiny = torch.tensor(1e-9, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    demand = gsum[:, None, :] > 0
    frac = torch.where(demand, gsum[:, None, :] / torch.maximum(capvec_t, tiny), zero).amax(dim=-1)
    no_room = (demand & (capvec_t <= 0)).any(dim=-1)
    frac = torch.where(no_room, inf, frac)
    tau = torch.argmin(torch.where(it_pick_ok, frac, inf), dim=-1)  # [C], first minimum
    capvec = problem.it_alloc[tau] - overhead[tpick.long()]  # [C, R]
    cv = capvec[gidc.long()]
    size = torch.where(req > 0, req / torch.maximum(cv, tiny), zero).amax(dim=-1)
    size = torch.clamp(size, 1e-6, 1.0)
    w = torch.where(elig, size, zero)
    return GroupPlan(
        state0=state0, it_gate=it_gate, elig0=elig0, elig=elig, gid=gid, gidc=gidc,
        hp=hp, gvalid=gvalid, merged=merged, tpick=tpick, prior=prior,
        overhead=overhead, capvec=capvec, w=w,
    )


def commit_assignment(problem: SchedulingProblem, C: int, statics, plan: GroupPlan,
                      slot, assigned, n_passes: int) -> Commit:
    """The real instance-type-gate rounding ladder over a proposed assignment
    (``slot`` i32[P], ``assigned`` bool[P]; every pod of a slot belongs to
    the slot's group), then the FFDState / verdict / topology commit. Each
    rung demotes the last-assigned pod of every claim the gate rejects; the
    final rung demotes whole claims that never became feasible."""
    P, V = problem.num_pods, problem.num_lanes
    G = problem.num_groups
    wellknown, lv, ln, bf = statics.wellknown, statics.lv, statics.ln, statics.bounds_free
    state0, it_gate = plan.state0, plan.it_gate
    dev = problem.lane_valid.device
    mint_hostnames = problem.claim_hostname_lane.shape[0] > 0
    req = problem.pod_requests
    pidx = torch.arange(P, dtype=torch.int32, device=dev)
    garange = torch.arange(C, device=dev)

    slotc = torch.clamp(slot, 0, C - 1).long()
    g_of_c = _scatter(C, torch.where(assigned, slot, C), plan.gid, "amax", 0).long()

    # -- per-claim rows: the owning group's merged template row, pinned to the
    # slot's minted hostname
    tpl_of_c = plan.tpick[g_of_c]  # [C]
    rows_c = _lead(plan.merged, lambda x: x[g_of_c, tpl_of_c.long()])
    if mint_hostnames:
        CH = problem.claim_hostname_lane.shape[0]
        lanes = problem.claim_hostname_lane[torch.clamp(garange, max=CH - 1)]
        host1 = torch.arange(V, device=dev)[None, :] == lanes[:, None]  # [C, V]
        rows_c = _pin_hostname(rows_c, host1)
    else:
        host1 = torch.zeros((C, V), dtype=torch.bool, device=dev)
    prior_c = plan.prior[tpl_of_c.long()]  # [C, T]
    overhead_c = plan.overhead[tpl_of_c.long()]  # [C, R]

    # -- rounding ladder
    for rung in range(n_passes + 1):
        sidx = torch.where(assigned, slot, C)
        sums = ordered_sum(sidx, torch.where(assigned[:, None], req, 0.0), C)
        feas = it_gate(rows_c, overhead_c + sums, prior_c).any(dim=-1)
        if rung < n_passes:
            lastp = _scatter(C, sidx, pidx, "amax", -1)
            assigned = assigned & (feas[slotc] | (pidx != lastp[slotc]))
        else:
            assigned = assigned & feas[slotc]

    # -- commit over the surviving assignment
    sidx = torch.where(assigned, slot, C)
    npods = _scatter(C, sidx, torch.ones(P, dtype=torch.int32, device=dev), "sum", 0)
    sums = ordered_sum(sidx, torch.where(assigned[:, None], req, 0.0), C)
    creq = overhead_c + sums
    ok_c = it_gate(rows_c, creq, prior_c)
    open_c = (npods > 0) & ok_c.any(dim=-1)

    new_registered = state0.grp_registered
    new_counts = state0.grp_counts
    if G > 0:
        if mint_hostnames:
            # a claim open registers its minted hostname lane for every
            # hostname-keyed group
            minted = (open_c[:, None] & host1).any(dim=0)  # [V]
            new_registered = new_registered | ((problem.grp_key == HOSTNAME_KEY)[:, None] & minted[None, :])
        # record_delta depends on the pod only through grp_selects/grp_owned:
        # an all-select probe per claim row gives the per-group unit delta,
        # scaled by how many assigned pods of the claim select the group
        # (eligible pods never own, so the inverse term is zero)
        K = problem.num_keys
        probe = PodTopoStatics(
            strict_admitted=torch.zeros((K, V), dtype=torch.bool, device=dev),
            grp_match=torch.zeros((G,), dtype=torch.bool, device=dev),
            grp_selects=torch.ones((G,), dtype=torch.bool, device=dev),
            grp_owned=torch.zeros((G,), dtype=torch.bool, device=dev),
        )
        units = torch.stack([
            record_delta(problem, probe, rows_c.row(c), wellknown, open_c[c], lv, ln)
            for c in range(C)
        ])  # [C, G, V]
        selcnt = _scatter(
            C, sidx, (assigned[:, None] & problem.pod_grp_selects).to(torch.int32), "sum", 0
        )  # [C, G]
        new_counts = new_counts + (selcnt[:, :, None] * units.to(torch.int32)).sum(dim=0).to(torch.int32)
        new_registered = new_registered | ((selcnt > 0)[:, :, None] & units).any(dim=0)

    state1 = dataclasses.replace(
        state0,
        claim_req=_mix_req_rows(state0.claim_req, rows_c, open_c, bf),
        claim_requests=torch.where(open_c[:, None], creq, 0.0),
        claim_it_ok=ok_c & open_c[:, None],
        claim_open=open_c,
        claim_npods=torch.where(open_c, npods, 0).to(torch.int32),
        claim_tpl=torch.where(open_c, tpl_of_c, 0).to(torch.int32),
        grp_counts=new_counts,
        grp_registered=new_registered,
    )
    firstp = _scatter(C, sidx, pidx, "amin", P)
    kind = torch.where(
        assigned,
        torch.where(pidx == firstp[slotc], KIND_NEW_CLAIM, KIND_CLAIM),
        KIND_FAIL,
    ).to(torch.int32)
    index = torch.where(assigned, slot, -1).to(torch.int32)
    residue = problem.pod_active & ~assigned
    return Commit(state=state1, kind=kind, index=index, residue_active=residue,
                  assigned=assigned, open_c=open_c)
