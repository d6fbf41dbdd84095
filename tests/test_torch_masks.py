"""Mask algebra parity: karpenter_tpu_torch.ops.masks against
karpenter_tpu.ops.masks on seeded random requirement rows, with and without
integer Gt/Lt bounds. Exact equality: every function is boolean/integer
logic (fits compares float32 in the same order on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.models.problem import GT_NONE, LT_NONE, ReqTensor as JReq
from karpenter_tpu.ops import masks as jm
from karpenter_tpu_torch.models.problem import ReqTensor as TReq
from karpenter_tpu_torch.ops import masks as tm
import tests.torch_threads  # noqa: F401  (one intra-op thread)

K, V, E, T, O = 4, 64, 9, 11, 5
SEEDS = (0, 1, 2)


def _vocab(rng):
    lane_valid = np.zeros((K, V), dtype=bool)
    for k in range(K):
        lane_valid[k, : rng.integers(3, V)] = True
    lane_numeric = np.where(
        lane_valid & (rng.random((K, V)) < 0.6), rng.integers(0, 12, (K, V)), np.nan
    ).astype(np.float32)
    key_wellknown = rng.random(K) < 0.4
    return lane_valid, lane_numeric, key_wellknown


def _rows(rng, n, lane_valid, bounded):
    admitted = (rng.random((n, K, V)) < 0.35) & lane_valid
    comp = rng.random((n, K)) < 0.4
    defined = rng.random((n, K)) < 0.6
    empty = rng.random((n, K)) < 0.1  # some empty concrete sets
    admitted[empty] = False
    gt = np.full((n, K), GT_NONE, dtype=np.int32)
    lt = np.full((n, K), LT_NONE, dtype=np.int32)
    if bounded:
        has_gt = rng.random((n, K)) < 0.3
        has_lt = rng.random((n, K)) < 0.3
        gt[has_gt] = rng.integers(0, 8, has_gt.sum())
        lt[has_lt] = rng.integers(2, 12, has_lt.sum())
    return admitted, comp, gt, lt, defined


def _pair(arrs):
    return JReq(*(jnp.asarray(a) for a in arrs)), TReq(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(jx, tx):
    a, b = _np(jx), _np(tx)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    assert a.shape == b.shape
    assert np.array_equal(a, b)


def _setup(seed, bounded):
    rng = np.random.default_rng(seed)
    lv, ln, wkn = _vocab(rng)
    A = _pair(_rows(rng, E, lv, bounded))
    B = _pair(_rows(rng, E, lv, bounded))
    statics = (jnp.asarray(lv), jnp.asarray(ln), jnp.asarray(wkn)), (
        torch.from_numpy(lv), torch.from_numpy(ln), torch.from_numpy(wkn))
    return rng, A, B, statics


def _vmap2(fn):
    return jax.vmap(fn)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_intersect_nonempty_polarity(seed, bounded):
    _, (ja, ta), (jb, tb), ((jlv, jln, _), (tlv, tln, _)) = _setup(seed, bounded)
    bf = not bounded
    ji, ti = jm.intersect(ja, jb, bf), tm.intersect(ta, tb, bf)
    for f in ("admitted", "comp", "gt", "lt", "defined"):
        _same(getattr(ji, f), getattr(ti, f))
    _same(jm.nonempty(ji, bf), tm.nonempty(ti, bf))
    _same(
        _vmap2(lambda r: jm.negative_polarity(r, jlv, jln, bf))(ja),
        tm.negative_polarity(ta, tlv, tln, bf),
    )


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_intersects_and_compatible(seed, bounded):
    _, (ja, ta), (jb, tb), ((jlv, jln, jwk), (tlv, tln, twk)) = _setup(seed, bounded)
    bf = not bounded
    _same(
        jax.vmap(lambda a, b: jm.intersects_ok(a, b, jlv, jln, bf))(ja, jb),
        tm.intersects_ok(ta, tb, tlv, tln, bf),
    )
    _same(
        jax.vmap(lambda a, b: jm.compatible_ok(a, b, jlv, jln, jwk, bf))(ja, jb),
        tm.compatible_ok(ta, tb, tlv, tln, twk, bf),
    )
    # compatible_from_merged equals compatible_ok given the merged rows
    jneg_a = jax.vmap(lambda r: jm.negative_polarity(r, jlv, jln, bf))(ja)
    jneg_b = jax.vmap(lambda r: jm.negative_polarity(r, jlv, jln, bf))(jb)
    tneg_a = tm.negative_polarity(ta, tlv, tln, bf)
    tneg_b = tm.negative_polarity(tb, tlv, tln, bf)
    jc = jax.vmap(
        lambda ne, ad, an, bd, bn: jm.compatible_from_merged(ne, ad, an, bd, bn, jwk)
    )(jm.nonempty(jm.intersect(ja, jb, bf), bf), ja.defined, jneg_a, jb.defined, jneg_b)
    tc = tm.compatible_from_merged(
        tm.nonempty(tm.intersect(ta, tb, bf), bf), ta.defined, tneg_a, tb.defined, tneg_b, twk
    )
    _same(jc, tc)
    _same(tc, tm.compatible_ok(ta, tb, tlv, tln, twk, bf))


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_packed_forms(seed, bounded):
    _, (ja, ta), (jb, tb), ((jlv, jln, jwk), (tlv, tln, twk)) = _setup(seed, bounded)
    bf = not bounded
    _same(jm.pack_lanes(ja.admitted), tm.pack_lanes(ta.admitted))
    assert torch.equal(tm.unpack_lanes(tm.pack_lanes(ta.admitted), V), ta.admitted)
    jpa, jpb = jm.pack_req(ja, jlv, jln, bf), jm.pack_req(jb, jlv, jln, bf)
    tpa, tpb = tm.pack_req(ta, tlv, tln, bf), tm.pack_req(tb, tlv, tln, bf)
    _same(jpa, tpa)
    _same(jm.packed_intersects_ok(jpa, jpb, bf), tm.packed_intersects_ok(tpa, tpb, bf))
    _same(jm.packed_compatible_ok(jpa, jpb, jwk, bf), tm.packed_compatible_ok(tpa, tpb, twk, bf))
    jneg_a = jax.vmap(lambda r: jm.negative_polarity(r, jlv, jln, bf))(ja)
    jneg_b = jax.vmap(lambda r: jm.negative_polarity(r, jlv, jln, bf))(jb)
    _same(
        jm.packed_pairwise_compat(ja, jm.pack_lanes(ja.admitted), jneg_a,
                                  jb, jm.pack_lanes(jb.admitted), jneg_b, bf),
        tm.packed_pairwise_compat(ta, tm.pack_lanes(ta.admitted), tm.negative_polarity(ta, tlv, tln, bf),
                                  tb, tm.pack_lanes(tb.admitted), tm.negative_polarity(tb, tlv, tln, bf), bf),
    )
    # the instance-type form: every row of B against one state row of A
    _same(
        jm.it_compatible(jb, ja.row(0), jlv, jln),
        tm.it_compatible(tb, ta.row(0), tlv, tln),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_fits(seed):
    rng = np.random.default_rng(seed)
    avail = rng.choice([0.0, 1.0, 2.5, 1e9, 4.0 * 1024**3, np.inf, -1.0], (E, 6)).astype(np.float32)
    # requests at, just above and just below the tolerance boundary
    finite = np.where(np.isfinite(avail), avail, np.float32(3.0))
    eps = (np.float32(1e-6) + np.float32(1e-6) * np.abs(finite)).astype(np.float32)
    step = rng.choice([-1.0, 0.0, 0.5, 1.0, 2.0], (E, 6)).astype(np.float32)
    req = (finite + step * eps).astype(np.float32)
    _same(jm.fits(jnp.asarray(req), jnp.asarray(avail)), tm.fits(torch.from_numpy(req), torch.from_numpy(avail)))
    _same(
        jm.fits(jnp.asarray(req)[:, None, :], jnp.asarray(avail)[None]),
        tm.fits(torch.from_numpy(req)[:, None, :], torch.from_numpy(avail)[None]),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_offerings(seed):
    rng = np.random.default_rng(seed)
    lv, _, _ = _vocab(rng)
    adm = (rng.random((E, K, V)) < 0.5) & lv
    zb = cb = 8
    offer_zone = rng.integers(0, zb, (T, O)).astype(np.int32)
    offer_ct = rng.integers(0, cb, (T, O)).astype(np.int32)
    offer_ok = rng.random((T, O)) < 0.7
    zc = np.zeros((T, zb, cb), dtype=bool)
    np.logical_or.at(zc, (np.arange(T)[:, None].repeat(O, 1), offer_zone, offer_ct), offer_ok)
    jrows = jax.vmap(
        lambda a: jm.has_offering(a, 0, 1, jnp.asarray(offer_zone), jnp.asarray(offer_ct), jnp.asarray(offer_ok))
    )(jnp.asarray(adm))
    trows = torch.stack([
        tm.has_offering(torch.from_numpy(adm[e]), 0, 1, torch.from_numpy(offer_zone),
                        torch.from_numpy(offer_ct), torch.from_numpy(offer_ok))
        for e in range(E)
    ])
    _same(jrows, trows)
    _same(jm.has_offering_zc(jnp.asarray(adm), 0, 1, jnp.asarray(zc)),
          tm.has_offering_zc(torch.from_numpy(adm), 0, 1, torch.from_numpy(zc)))
    _same(trows, tm.has_offering_zc(torch.from_numpy(adm), 0, 1, torch.from_numpy(zc)))
