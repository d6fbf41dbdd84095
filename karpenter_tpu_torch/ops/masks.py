"""Requirement-algebra functions on torch tensors.

Plain PyTorch versions of the JAX package's ``ops/masks.py`` (reference
pkg/scheduling/{requirement,requirements}.go). The solver's plain path and the
CPU tests use them; the CUDA kernels carry the same functions as ``__device__``
code in ``csrc/masks.cuh``. See models/problem.py for the encoding invariants
that make these exact.

``bounds_free`` (ops/ffd_core.problem_bounds_free): no requirement in the
problem carries a finite integer Gt/Lt bound, so gt/lt are sentinels
everywhere and their math can be skipped. Both arms give the same answers on
such problems; the bounded arm is the general one.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.models.problem import GT_NONE, LT_NONE, ReqTensor

_FLAG_COMP = 1
_FLAG_DEFINED = 2
_FLAG_NEG = 4


def intersect(a: ReqTensor, b: ReqTensor, bounds_free: bool = False) -> ReqTensor:
    """Keywise requirement intersection (requirement.go:128-161); shapes
    broadcast over leading axes."""
    if bounds_free:
        gt, lt = a.gt, a.lt
    else:
        gt, lt = torch.maximum(a.gt, b.gt), torch.minimum(a.lt, b.lt)
    return ReqTensor(
        admitted=a.admitted & b.admitted,
        comp=a.comp & b.comp,
        gt=gt,
        lt=lt,
        defined=a.defined | b.defined,
    )


def nonempty(r: ReqTensor, bounds_free: bool = False) -> torch.Tensor:
    """Per-key Len() != 0 (requirement.go:210-215)."""
    if bounds_free:
        return r.admitted.any(dim=-1) | r.comp
    return r.admitted.any(dim=-1) | (r.comp & (r.gt < r.lt))


def _in_bounds(lane_numeric, lane_valid, gt, lt) -> torch.Tensor:
    """Which vocab lanes satisfy integer bounds (requirement.go:238-254)."""
    unbounded = (gt[..., None] <= int(GT_NONE)) & (lt[..., None] >= int(LT_NONE))
    numeric_ok = (
        ~torch.isnan(lane_numeric)
        & (lane_numeric > gt[..., None].to(torch.float32))
        & (lane_numeric < lt[..., None].to(torch.float32))
    )
    return lane_valid & (unbounded | numeric_ok)


def negative_polarity(r: ReqTensor, lane_valid, lane_numeric, bounds_free: bool = False):
    """Per-key Operator() in {NotIn, DoesNotExist} (requirement.go:197-208)."""
    if bounds_free:
        excl = (lane_valid & ~r.admitted).any(dim=-1)
    else:
        excl = (
            lane_valid & _in_bounds(lane_numeric, lane_valid, r.gt, r.lt) & ~r.admitted
        ).any(dim=-1)
    return torch.where(r.comp, excl, ~r.admitted.any(dim=-1))


def intersects_ok(a: ReqTensor, b: ReqTensor, lane_valid, lane_numeric, bounds_free: bool = False):
    """Requirements.Intersects (requirements.go:241-258), reduced over keys."""
    ne = nonempty(intersect(a, b, bounds_free), bounds_free)
    both_defined = a.defined & b.defined
    both_neg = negative_polarity(a, lane_valid, lane_numeric, bounds_free) & negative_polarity(
        b, lane_valid, lane_numeric, bounds_free
    )
    return (~both_defined | ne | both_neg).all(dim=-1)


def compatible_ok(r: ReqTensor, incoming: ReqTensor, lane_valid, lane_numeric, key_wellknown,
                  bounds_free: bool = False):
    """Requirements.Compatible (requirements.go:163-174)."""
    neg_inc = negative_polarity(incoming, lane_valid, lane_numeric, bounds_free)
    undef_bad = incoming.defined & ~r.defined & ~key_wellknown & ~neg_inc
    return ~undef_bad.any(dim=-1) & intersects_ok(r, incoming, lane_valid, lane_numeric, bounds_free)


def compatible_from_merged(merged_ne, r_defined, r_neg, inc_defined, inc_neg, key_wellknown):
    """Requirements.Compatible from an already-intersected row:
    ``merged_ne = nonempty(intersect(r, incoming))``."""
    both_defined = r_defined & inc_defined
    both_neg = r_neg & inc_neg
    intersects = (~both_defined | merged_ne | both_neg).all(dim=-1)
    undef_bad = (inc_defined & ~r_defined & ~key_wellknown & ~inc_neg).any(dim=-1)
    return ~undef_bad & intersects


def fits(requests: torch.Tensor, available: torch.Tensor) -> torch.Tensor:
    """resources.Fits with eps = 1e-6 + 1e-6|avail|; reduction over the
    trailing resource axis. The CUDA kernels evaluate the same expression
    with FMA contraction off, so both round alike."""
    eps = 1e-6 + 1e-6 * torch.abs(available)
    return (requests <= available + eps).all(dim=-1)


def it_compatible(it_reqs: ReqTensor, state: ReqTensor, lane_valid, lane_numeric):
    """[T] mask: instance type requirements intersect the claim state
    (nodeclaim.go:262-264)."""
    st = ReqTensor(
        admitted=state.admitted[None], comp=state.comp[None], gt=state.gt[None],
        lt=state.lt[None], defined=state.defined[None],
    )
    return intersects_ok(it_reqs, st, lane_valid, lane_numeric)


def pack_lanes(admitted: torch.Tensor) -> torch.Tensor:
    """bool[..., V] -> int32[..., V/32]: bit i of word w is lane 32w+i (the
    uint32 words of the JAX package, held as int32 bit patterns since torch
    has no uint32 arithmetic). V must be a multiple of 32."""
    *lead, V = admitted.shape
    words = admitted.reshape(*lead, V // 32, 32).to(torch.int64)
    shifts = torch.arange(32, device=admitted.device, dtype=torch.int64)
    packed = (words << shifts).sum(dim=-1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_lanes(words: torch.Tensor, V: int) -> torch.Tensor:
    """Inverse of pack_lanes: int32[..., W] -> bool[..., V]."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :V].to(torch.bool)


def packed_pairwise_compat(a: ReqTensor, a_packed, a_neg, b: ReqTensor, b_packed, b_neg,
                           bounds_free: bool = False):
    """[A, B] all-pairs Requirements.Intersects on bitpacked lanes."""
    inter_any = ((a_packed[:, None, :, :] & b_packed[None, :, :, :]) != 0).any(dim=-1)
    comp_ab = a.comp[:, None, :] & b.comp[None, :, :]
    if bounds_free:
        ne = inter_any | comp_ab
    else:
        gt_ab = torch.maximum(a.gt[:, None, :], b.gt[None, :, :])
        lt_ab = torch.minimum(a.lt[:, None, :], b.lt[None, :, :])
        ne = inter_any | (comp_ab & (gt_ab < lt_ab))
    both_defined = a.defined[:, None, :] & b.defined[None, :, :]
    both_neg = a_neg[:, None, :] & b_neg[None, :, :]
    return (~both_defined | ne | both_neg).all(dim=-1)


def pack_req(r: ReqTensor, lane_valid, lane_numeric, bounds_free: bool = False) -> torch.Tensor:
    """ReqTensor[..., K, V] -> int32[..., K, W+3] bitword rows: W lane words,
    then a flags word (bit0 comp, bit1 defined, bit2 negative polarity), then
    gt and lt — the JAX package's pack_req layout."""
    words = pack_lanes(r.admitted)
    neg = negative_polarity(r, lane_valid, lane_numeric, bounds_free)
    flags = (
        r.comp.to(torch.int32) * _FLAG_COMP
        | r.defined.to(torch.int32) * _FLAG_DEFINED
        | neg.to(torch.int32) * _FLAG_NEG
    )
    return torch.cat(
        [words, flags[..., None], r.gt.to(torch.int32)[..., None], r.lt.to(torch.int32)[..., None]],
        dim=-1,
    )


def _packed_intersect_terms(pa, pb, bounds_free: bool):
    and_w = pa & pb
    inter_any = (and_w[..., :-3] != 0).any(dim=-1)
    fl = and_w[..., -3]
    comp_ab = (fl & _FLAG_COMP) != 0
    if bounds_free:
        ne = inter_any | comp_ab
    else:
        gt_ab = torch.maximum(pa[..., -2], pb[..., -2])
        lt_ab = torch.minimum(pa[..., -1], pb[..., -1])
        ne = inter_any | (comp_ab & (gt_ab < lt_ab))
    return ne, (fl & _FLAG_DEFINED) != 0, (fl & _FLAG_NEG) != 0


def packed_intersects_ok(pa, pb, bounds_free: bool = False):
    """Requirements.Intersects on pack_req rows."""
    ne, both_defined, both_neg = _packed_intersect_terms(pa, pb, bounds_free)
    return (~both_defined | ne | both_neg).all(dim=-1)


def packed_compatible_ok(pr, pinc, key_wellknown, bounds_free: bool = False):
    """Requirements.Compatible on pack_req rows."""
    ne, both_defined, both_neg = _packed_intersect_terms(pr, pinc, bounds_free)
    inc_fl, r_fl = pinc[..., -3], pr[..., -3]
    undef_bad = (
        ((inc_fl & _FLAG_DEFINED) != 0)
        & ((r_fl & _FLAG_DEFINED) == 0)
        & ~key_wellknown
        & ((inc_fl & _FLAG_NEG) == 0)
    )
    return ~undef_bad.any(dim=-1) & (~both_defined | ne | both_neg).all(dim=-1)


def has_offering_zc(state_admitted, zone_key: int, ct_key: int, offer_zc):
    """[B, T] has_offering from the dense (zone lane x ct lane) table: some
    available offering's lane pair is admitted by the bin state."""
    T, Zb, Cb = offer_zc.shape
    z = state_admitted[..., zone_key, :Zb]
    c = state_admitted[..., ct_key, :Cb]
    pairs = z[..., :, None] & c[..., None, :]  # [B, Zb, Cb]
    return (pairs[..., None, :, :] & offer_zc).flatten(-2).any(dim=-1)


def has_offering(state_admitted, zone_key: int, ct_key: int, offer_zone, offer_ct, offer_ok):
    """[T] mask: some available offering's zone and capacity type are
    admitted by the claim state (nodeclaim.go:270-278)."""
    zone_adm = state_admitted[zone_key][offer_zone.long()]
    ct_adm = state_admitted[ct_key][offer_ct.long()]
    return (offer_ok & zone_adm & ct_adm).any(dim=-1)


def family_bitmask(fails: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """int32[3] (union, blockers, near) gate-attribution byte for ONE
    candidate class, the tensor twin of obs/explain.encode_family_bits.

    ``fails``: bool[F, E], family f failed on candidate e (F <= 7 families,
    obs/explain.FAM_*). ``cand``: bool[E], candidate liveness (open claims;
    real rows of nodes and templates).

      union    bit f: family f failed on >= 1 live candidate
      blockers bit f: family f failed on EVERY live candidate; bit 7 when the
               class has no live candidate at all (EMPTY)
      near     bit f: some live candidate failed ONLY family f, the
               counterfactual "relax this one gate and the pod schedules"
    """
    F = fails.shape[0]
    present = bool(cand.any())
    hit = fails & cand[None, :]
    union = hit.any(dim=-1)
    blockers = (fails | ~cand[None, :]).all(dim=-1) & present
    nfail = hit.sum(dim=0)
    near = (hit & (nfail[None, :] == 1)).any(dim=-1)
    bits = 1 << torch.arange(F, dtype=torch.int32, device=fails.device)
    zero = torch.zeros_like(bits)
    return torch.stack([
        torch.where(union, bits, zero).sum(),
        torch.where(blockers, bits, zero).sum() + (0 if present else 1 << 7),
        torch.where(near, bits, zero).sum(),
    ]).to(torch.int32)
