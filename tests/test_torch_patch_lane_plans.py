"""The work plans of ``patch_world`` and ``lane_scores``, and the inputs
their wrappers hand the kernels, on the CPU.

``patch_world`` (csrc/patch_world.cu) walks a host-built work list: survivor
pieces (``ops/fused.patch_plan``), the rows it builds from shipped rows in
the encoder's form, and full-ship chunks, over a leaf table that says how
each leaf's row is made (``OP_COPY``, ``OP_PACK``, ``OP_NEG``). Here a numpy
walk of that table and those lists, as the kernel does it, is held to the
plain version (rows ``pod_tensors`` packs on the host) and to the gather it
replaces. ``lane_scores`` (csrc/lane_scores.cu) reads the solve's tables
(``ops/ffd_sweeps.problem_tensors``); a numpy pass over the launch's own
inputs, a row at a time in the kernel's order, is held to the plain version
and to the JAX package. The kernels themselves are held to their plain
versions by tests/test_torch_kernels.py's card tests.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu.ops import policy as j_policy
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import ReqTensor, numpy_fields, problem_from_numpy, problem_to_torch
from karpenter_tpu_torch.ops import ffd_sweeps, fused, masks, policy
from karpenter_tpu_torch.testing import workloads as W
from tests.test_torch_encode import encode_both
from tests.test_torch_kernels import _churn_world, _encode, _self_splice, policy_weights

CSRC = Path(kernels.__file__).resolve().parent / "csrc"


# -- the segment plan ------------------------------------------------------------


def _splice(case: str, seed: int = 0):
    """(gather_idx, use_fresh, fresh_sel, previous row count) of a row splice
    as ``build_patch_args`` lays it out: survivors gathered from a previous
    world, fresh rows numbered in row order, pad rows taking the fill row."""
    rng = np.random.default_rng(seed)
    P_prev, P_cur, Pb = 300, 280, 320
    if case == "no-fresh":
        P_cur = P_prev
        fresh = np.zeros(P_cur, dtype=bool)
    elif case == "all-fresh":
        fresh = np.ones(P_cur, dtype=bool)
    elif case == "arrivals-at-ends":
        fresh = np.zeros(P_cur, dtype=bool)
        fresh[[0, 1, P_cur - 1]] = True
    elif case == "one-run":  # a single survivor run, cut into pieces
        fresh = np.zeros(P_cur, dtype=bool)
        fresh[P_cur // 2] = True
    else:
        fresh = rng.random(P_cur) < 0.08
    n_surv = int((~fresh).sum())
    if case == "one-run":
        src = np.arange(n_surv) + 7
    else:
        # deletes drop rows; arrivals sort in between; a few survivors move
        src = np.sort(rng.choice(P_prev, size=n_surv, replace=False))
        if case == "random" and n_surv > 10:
            i = rng.choice(n_surv - 1, size=3, replace=False)
            src[i], src[i + 1] = src[i + 1].copy(), src[i].copy()
    gather = np.zeros(Pb, dtype=np.int32)
    gather[:P_cur][~fresh] = src
    use = np.ones(Pb, dtype=bool)
    use[:P_cur] = fresh
    F = int(fresh.sum())
    sel = np.full(Pb, F, dtype=np.int32)
    sel[np.flatnonzero(fresh)] = np.arange(F, dtype=np.int32)
    return gather, use, sel, P_prev


@pytest.mark.parametrize("case,seed", [("random", 0), ("random", 1), ("random", 2), ("no-fresh", 0),
                                       ("all-fresh", 0), ("arrivals-at-ends", 0), ("one-run", 0)])
def test_patch_plan_reproduces_the_gather(case, seed):
    gather, use, sel, P_prev = _splice(case, seed)
    pieces, fresh = fused.patch_plan(gather, use, sel)
    rng = np.random.default_rng(99)
    prev = rng.integers(0, 1 << 30, size=(P_prev, 3))
    stack = rng.integers(0, 1 << 30, size=(int(sel.max()) + 1, 3))
    out = np.full((gather.shape[0], 3), -1)
    for d, g, n in pieces:
        assert 1 <= n <= fused.PIECE_ROWS and (out[d:d + n] == -1).all()
        out[d:d + n] = prev[g:g + n]
    for d, s in fresh:
        assert (out[d] == -1).all()
        out[d] = stack[s]
    np.testing.assert_array_equal(out, np.where(use[:, None], stack[sel], prev[gather]))
    assert sorted(fresh[:, 0].tolist()) == np.flatnonzero(use).tolist()
    # a run is cut only at its end or every PIECE_ROWS rows
    for (d0, g0, n0), (d1, g1, _) in zip(pieces[:-1], pieces[1:]):
        assert not (d1 == d0 + n0 and g1 == g0 + n0 and n0 < fused.PIECE_ROWS)
    if case == "no-fresh":
        assert fresh.shape == (gather.shape[0] - P_prev, 2) and set(fresh[:, 1].tolist()) == {0}
    if case == "all-fresh":
        assert pieces.shape == (0, 3)
    if case == "one-run":
        assert pieces.shape[0] == -(-(use.shape[0] // 2) // fused.PIECE_ROWS) + 3


# -- the kernel's walk of the upload, in numpy -------------------------------------


def _table(up):
    nf = len(fused._LEAF_FIELDS)
    rows = up.args.L + up.args.FL
    off = up.args.leaves - up.buffer.data_ptr()
    words = up.buffer[off:off + rows * nf * 8].view(torch.int64).reshape(rows, nf).tolist()
    return [dict(zip(fused._LEAF_FIELDS, w)) for w in words]


def _at(up, world, ptr):
    """The tensor an address of the table points into, and the byte offset."""
    for x in (up.buffer, *world.t.values(), *world.spare.values()):
        base = x.data_ptr()
        if x.numel() and base <= ptr < base + x.numel() * x.element_size():
            return x.view(-1).view(torch.uint8).numpy(), ptr - base
    raise AssertionError(f"address {ptr} is in no buffer")


def _bytes(up, world, ptr, n):
    buf, off = _at(up, world, ptr)
    return buf[off:off + n]


def _kernel_walk(up, world):
    """What the kernel writes, done in numpy from the upload alone: {leaf:
    bytes of its output buffer}. Packs with the table's ops; the polarity
    row through masks.negative_polarity on the packed words."""
    table = _table(up)
    L, K, W = up.args.L, up.args.K, up.args.W
    names = [n for n in fused.PATCH_ROWS if world.t[n].numel()]
    out = {}
    for name, lf in zip(names, table):
        assert lf["out"] == world.spare[name].data_ptr() and lf["prev"] == world.t[name].data_ptr()
        out[name] = np.full(world.t[name].numel() * world.t[name].element_size(), 0xEE, dtype=np.uint8)
    pieces = up.pieces.tolist()
    fresh = up.fresh.tolist()
    assert (up.args.NP, up.args.NF) == (len(pieces), len(fresh))
    assert up.args.FP == 1 + sum(lf["op"] == fused.OP_PACK for lf in table[:L])
    for d, g, n in pieces:
        for name, lf in zip(names, table):
            rb = lf["row_bytes"]
            out[name][d * rb:(d + n) * rb] = _bytes(up, world, lf["prev"] + g * rb, n * rb)
    lv = world.t["lvw"]
    ln = world.t["ln"]
    for d, s in fresh:
        for i, (name, lf) in enumerate(zip(names, table)):
            rb, srb = lf["row_bytes"], lf["stk_row_bytes"]
            if lf["op"] == fused.OP_NEG:
                continue
            src = _bytes(up, world, lf["stk"] + s * srb, srb)
            if lf["op"] == fused.OP_COPY:
                assert srb == rb
                out[name][d * rb:(d + 1) * rb] = src
                continue
            assert lf["op"] == fused.OP_PACK
            VS = srb // K
            lanes = np.zeros((K, 32 * W), dtype=bool)
            lanes[:, :VS] = src.reshape(K, VS).astype(bool)
            words = np.packbits(lanes.reshape(K, W, 32), axis=-1, bitorder="little").view(np.int32).reshape(K, W)
            out[name][d * rb:(d + 1) * rb] = words.reshape(-1).view(np.uint8)
            if lf["aux"] < 0:
                continue
            comp, gt, lt = (_bytes(up, world, table[i + j]["stk"] + s * table[i + j]["stk_row_bytes"],
                                   table[i + j]["stk_row_bytes"]) for j in (1, 3, 4))
            row = ReqTensor(admitted=masks.unpack_lanes(torch.from_numpy(words.copy()), 32 * W),
                            comp=torch.from_numpy(comp.astype(bool)), gt=torch.from_numpy(gt.view(np.int32).copy()),
                            lt=torch.from_numpy(lt.view(np.int32).copy()), defined=torch.zeros(K, dtype=torch.bool))
            neg = masks.negative_polarity(row, masks.unpack_lanes(lv, 32 * W), ln)
            out[names[lf["aux"]]][d * K:(d + 1) * K] = neg.numpy().astype(np.uint8)
    full = table[L:]
    chunks = 0
    for (name, _), lf in zip(fused.PATCH_FULL, full):
        assert lf["out"] == world.t[name].data_ptr() and lf["op"] == fused.OP_COPY
        out[name] = _bytes(up, world, lf["stk"], lf["row_bytes"]).copy()
        chunks += -(-lf["row_bytes"] // fused.FULL_CHUNK)
    assert up.args.FC == chunks
    return out


def _as_bytes(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(-1).view(torch.uint8).numpy()


# churn patches, and patches whose shipped rows carry integer bounds (the
# bounds corpus's own rows, every third shipped again in place)
CORPORA = {"churn-permute": lambda: _churn_world(permute=True)[:2],
           "churn-spec-change": lambda: _churn_world(permute=False)[:2],
           "bounds-0": lambda: _self_splice(W.bounds_workload(0), "thirds"),
           "bounds-1": lambda: _self_splice(W.bounds_workload(1), "thirds"),
           "fuzz-6-ends": lambda: _self_splice(W.fuzz_workload(6), "ends")}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_the_kernels_walk_of_the_upload_matches_plain(corpus):
    prev, args = CORPORA[corpus]()
    world = fused.adopt_world(prev, 8, "cpu")
    before = {k: v.clone() for k, v in world.t.items()}
    up = fused.upload_patch(args, world)
    walked = _kernel_walk(up, world)
    plain = fused.patch_world_plain(before, up)
    assert set(walked) == {name for name, value in plain.items() if value.numel()}
    for name, value in plain.items():
        if value.numel():
            np.testing.assert_array_equal(walked[name], _as_bytes(value), err_msg=name)
    if not corpus.startswith("churn"):
        # the shipped rows are the world's own: the patch changes nothing
        for name in fused.PATCH_ROWS:
            assert torch.equal(plain[name], before[name]), name
    if corpus.startswith("bounds"):
        shipped = up.fresh[:, 0].long()
        bounded = (before["pod_gt"] > -2147483647) | (before["pod_lt"] < 2147483647)
        assert bool((bounded & before["pod_comp"])[shipped].any()), "no bounded complement row was shipped"


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_shipped_rows_pack_like_pod_tensors(corpus):
    """The rows the kernel builds from the shipped stack are the rows
    ``pod_tensors`` packs from it on the host, leaf for leaf, and only the
    stack rows a row takes are shipped."""
    prev, args = CORPORA[corpus]()
    world = fused.adopt_world(prev, 8, "cpu")
    up = fused.upload_patch(args, world)
    host = fused._stack_rows(args, world.lanes)
    walked = _kernel_walk(up, world)
    S = int(up.fresh[:, 1].max()) + 1
    assert all(x.shape[0] == S for x in up.shipped.values()) and S == int(args.fresh_sel.max()) + 1
    for d, s in up.fresh.tolist():
        for name in walked.keys() & set(fused.PATCH_ROWS):
            rb = world.t[name].numel() * world.t[name].element_size() // world.t[name].shape[0]
            np.testing.assert_array_equal(walked[name][d * rb:(d + 1) * rb], _as_bytes(host[name][s]),
                                          err_msg=f"{name} row {d} from {s}")


def test_leaf_struct_and_constants_match_the_kernel():
    text = (CSRC / "patch_world.cu").read_text()
    body = text[text.index("struct PatchLeaf {"):]
    body = re.sub(r"//.*", "", body[: body.index("};")])
    assert re.findall(r"(\w+);", body) == list(fused._LEAF_FIELDS)
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"\b(OP_\w+|FULL_CHUNK|MAX_LEAVES) = (\d+)", text)}
    assert consts == {"OP_COPY": fused.OP_COPY, "OP_PACK": fused.OP_PACK, "OP_NEG": fused.OP_NEG,
                      "FULL_CHUNK": fused.FULL_CHUNK, "MAX_LEAVES": fused.MAX_LEAVES}
    assert set(fused._SHIPPED) == set(fused.PATCH_ROWS)
    assert len(fused.PATCH_ROWS) + len(fused.PATCH_FULL) <= fused.MAX_LEAVES


@pytest.mark.parametrize("field,dtype,leaf", [
    ("requests", np.float64, "pod_requests"),  # another width
    ("req_gt", np.float32, "pod_gt"),  # the width of the leaf's int32, another type
    ("strict_lt", np.uint32, "pod_strict_lt"),
    ("requests", np.int32, "pod_requests"),
])
def test_upload_refuses_a_stack_the_kernel_cannot_copy(field, dtype, leaf):
    prev, args = _churn_world()[:2]
    world = fused.adopt_world(prev, 8, "cpu")
    src = np.asarray(getattr(args, field))
    bad = args._replace(**{field: src.view(dtype) if np.dtype(dtype).itemsize == src.itemsize else src.astype(dtype)})
    with pytest.raises(ValueError, match=leaf):
        fused.upload_patch(bad, world)
    # 0/1 bytes copy as the bools they are
    ok = args._replace(tol_tpl=np.asarray(args.tol_tpl).astype(np.uint8))
    fused.upload_patch(ok, world)


# -- lane_scores over the solve's tables ---------------------------------------------


def _kernel_scores(t, args, weights):
    """The kernel's arithmetic, a row at a time, in numpy float32 over the
    launch's own inputs (``lane_scores_args``' tensors); log1p and tanh as
    the plain version takes them (the kernel's are CUDA's, held to plain on
    the card)."""
    f32 = np.float32
    P, K, W, R = args.P, args.K, args.W, args.R
    adm = t["adm"].numpy().reshape(P, K * W).view(np.uint32)
    lvw = t["lvw"].numpy().reshape(-1).view(np.uint32)
    popc = np.vectorize(lambda x: bin(int(x)).count("1"))
    nvalid = int(popc(lvw).sum())
    nadm = popc(adm & lvw[None]).sum(axis=1)
    req = t["req"].numpy()
    total = np.zeros(P, f32)
    for r in range(R):
        total = (total + req[:, r]).astype(f32)
    feats = np.stack([
        torch.log1p(torch.from_numpy(total)).numpy(), torch.log1p(torch.from_numpy(req.max(axis=1))).numpy(),
        t["defined"].numpy().sum(1).astype(f32) / f32(K), nadm.astype(f32) / f32(max(nvalid, 1)),
        t["ports"].numpy().any(1).astype(f32), t["tol_tpl"].numpy().sum(1).astype(f32) / f32(args.TPL),
        t["match"].numpy().sum(1).astype(f32), t["owned"].numpy().sum(1).astype(f32),
        f32(1) - (t["eqprev_chain"].numpy().astype(f32) if t["eqprev_chain"] is not None else np.zeros(P, f32)),
        t["eqprev_gate"].numpy().astype(f32) if t["eqprev_gate"] is not None else np.zeros(P, f32),
    ], axis=1).astype(f32)
    head = t["weights"].numpy()
    NF = policy.N_LANE_FEATURES

    def dot(x, w):
        acc = (x[:, 0] * w[0]).astype(f32)
        for i in range(1, len(w)):
            acc = (acc + x[:, i] * w[i]).astype(f32)
        return acc

    H = args.hidden
    if H:
        rows, b1, w = head[:H * NF].reshape(H, NF), head[H * NF:H * NF + H], head[H * NF + H:]
        hidden = np.stack([(torch.tanh(torch.from_numpy(dot(feats, rows[h]) + b1[h])).numpy() * w[h]).astype(f32)
                           for h in range(H)], axis=1)
        score = hidden[:, 0]
        for h in range(1, H):
            score = (score + hidden[:, h]).astype(f32)
        return (score + w[H]).astype(f32)
    return (dot(feats, head[:NF]) + head[NF]).astype(f32)


# a linear head with every column weighted, and a tanh head wider than the
# kernel's tile of 64 hidden units in shared memory; scores of a few units,
# where 1e-6 is a few ulps
LANE_W = (0.5, -0.25, 0.1, -0.4, 0.2, 0.3, -0.1, 0.15, -0.2, 0.05)


def _heads():
    rng = np.random.default_rng(7)
    wide = 70
    mlp_wide = ("mlp", tuple(float(x) for x in 0.05 * rng.normal(size=wide)), float(rng.normal()),
                (tuple(tuple(float(x) for x in rng.normal(size=policy.N_LANE_FEATURES)) for _ in range(wide)),
                 tuple(float(x) for x in rng.normal(size=wide))))
    return {"committed": policy_weights(), "linear": ("linear", LANE_W, 0.25, None),
            "mlp": policy_weights(6, hidden=4), "mlp-wide": mlp_wide}


@pytest.mark.parametrize("name", ["diverse-280", "chain-2003", "topology-3", "bounds-0"])
def test_lane_scores_over_the_solves_tables(name):
    jp, _, tp, _ = encode_both(name)
    prob = problem_from_numpy(numpy_fields(tp), "cpu")
    tables = ffd_sweeps.problem_tensors(prob)
    for head_name, head in _heads().items():
        t, args = policy.lane_scores_args(prob, head, tables=tables)
        # the launch reads the solve's tables themselves: nothing packed again
        for field, table, _ in policy._LANE_TABLES:
            assert t[field] is tables[table], field
        assert t["weights"] is policy.lane_scores_args(prob, head, tables=tables)[0]["weights"]
        got = _kernel_scores(t, args, head)
        plain = policy.lane_scores_plain(prob, head).numpy()
        ref = np.asarray(j_policy.lane_scores(jp, head))
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6, err_msg=head_name)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=head_name)


def test_lane_scores_refuse_another_problems_tables():
    prob = problem_to_torch(_encode(W.fuzz_workload(6), 8), "cpu")
    other = problem_to_torch(_encode(W.chain_workload(2000), 8), "cpu")
    with pytest.raises(ValueError, match="tables hold"):
        policy.lane_scores_args(prob, policy_weights(), tables=ffd_sweeps.problem_tensors(other))
    bad = dict(ffd_sweeps.problem_tensors(prob), pod_requests=prob.pod_requests.double())
    with pytest.raises(ValueError, match="pod_requests"):
        policy.lane_scores_args(prob, policy_weights(), tables=bad)
    residue = dataclasses.replace(prob, pod_active=torch.zeros_like(prob.pod_active))
    # the scorer reads no pod_active: the residue's scores are the problem's
    t, _ = policy.lane_scores_args(residue, policy_weights(), tables=ffd_sweeps.problem_tensors(prob))
    assert "pod_active" not in t
