"""The cluster design of the ``ffd_loop`` kernel, on the CPU.

One solve runs on a thread-block cluster (csrc/ffd_loop.cu): the wrapper's
planner (``ops/ffd_sweeps.loop_plan``) picks the cluster's size from the
lane count, each block's slice of the instance types, and whether that
slice of the type tables fits the block's shared memory (``resident``) or is
read from device memory. The kernel stores the chain head's per-type
capacities as uint8 saturated at 255 and places a fill's members by one
rank pass over the units. Here: the planner at the shapes the main path and the
tests use, the per-block scratch of a launch's arguments, and the
arithmetic the saturation and the fill's pass rely on, against the plain
functions the kernel is held to. The kernel itself is held to its plain loop
at cluster sizes 1, 2, 4 and 8 by tests/test_torch_kernels.py's card tests.
"""

import threading

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu_torch.models.problem import problem_to_torch
from karpenter_tpu_torch.ops import ffd_sweeps
from karpenter_tpu_torch.ops.ffd_core import _BIG_CAP, _water_level, initial_state
from karpenter_tpu_torch.testing import workloads as W
from tests.test_torch_kernels import CORPORA, _encode

STRIDE = 64  # ffd_chain.STRIDE: the most members a chain commits

# the 10k main path's dims (chip_smoke.py phase 2: P = 10,240, C = 128,
# T = 512, K = 4, V = 128, R = 8, G = 32; one template, 6 offerings a type)
MAIN_DIMS = dict(P=10240, K=4, V=128, W=4, C=128, N=0, T=512, TPL=1, R=8, O=6, PT=1, D=1, G=32, F=1, CH=128)


def _dims(prob, slots):
    t, args = ffd_sweeps.ffd_loop_args(prob, initial_state(prob, slots), one_pass=False)
    return {k: getattr(args, k) for k in ("P", "K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G",
                                          "F", "CH")}


@pytest.mark.parametrize("lanes,want", [(1, 16), (2, 8), (8, 8), (16, 8), (17, 4), (33, 4), (34, 2), (66, 2),
                                        (67, 1), (200, 1)])
def test_cluster_size_from_the_lane_count(lanes, want):
    """One solve takes the largest cluster; several share the card's SMs,
    the cluster a power of two no larger than 8 that fits them all."""
    assert ffd_sweeps.cluster_size(lanes) == want
    if lanes > 1:
        assert want == 1 or want * lanes <= ffd_sweeps.CARD_SMS


def test_forced_cluster_overrides_and_restores():
    with ffd_sweeps.forced_cluster(2):
        assert ffd_sweeps.cluster_size(1) == 2 and ffd_sweeps.cluster_size(100) == 2
        with ffd_sweeps.forced_cluster(16):
            assert ffd_sweeps.cluster_size(1) == 16
        assert ffd_sweeps.cluster_size(1) == 2
    assert ffd_sweeps.cluster_size(1) == ffd_sweeps.SOLO_CLUSTER
    with pytest.raises(ValueError):
        with ffd_sweeps.forced_cluster(0):
            pass


@pytest.mark.parametrize("T,cluster,want", [(512, 8, 64), (512, 1, 512), (512, 16, 32), (400, 8, 64),
                                            (64, 8, 16), (16, 4, 16), (1, 8, 16)])
def test_type_slice_covers_the_types_in_aligned_slices(T, cluster, want):
    nt = ffd_sweeps.type_slice(T, cluster)
    assert nt == want and nt % 16 == 0 and nt * cluster >= T


@pytest.mark.parametrize("cluster,resident", [(1, False), (2, True), (4, True), (8, True), (16, True)])
def test_main_path_plan(cluster, resident):
    """At 10k the type tables do not fit one block whole, and do fit each
    block's slice from a cluster of 2 up; a resident slice at 8 is about
    40 KB."""
    plan = ffd_sweeps.loop_plan(MAIN_DIMS, cluster=cluster)
    assert (plan.cluster, plan.tslice, bool(plan.resident)) == (cluster, 512 // cluster, resident)
    assert plan.smem == ffd_sweeps.smem_bytes(MAIN_DIMS, cluster, resident)
    assert plan.smem <= ffd_sweeps.SMEM_OPTIN - ffd_sweeps.SMEM_STATIC
    if cluster == 8:
        assert 30_000 < plan.smem < 50_000
    assert ffd_sweeps.loop_plan(MAIN_DIMS).cluster == ffd_sweeps.SOLO_CLUSTER


def test_smem_bytes_counts_each_array_aligned():
    d = dict(G=3, R=5, C=7, TPL=2, K=3, W=2, O=5, T=40)
    nt = ffd_sweeps.type_slice(40, 2)  # 32
    a16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    common = 5 * a16(12) + 16 + a16(20) + 4 * a16(28) + 2 * a16(8)
    assert ffd_sweeps.smem_bytes(d, 2, False) == common
    resident = (a16(4 * nt * 6) + 2 * a16(4 * nt * 3) + 2 * a16(4 * nt * 5) + 2 * a16(4 * nt * 5)
                + 3 * a16(nt * 3) + a16(nt * 5) + a16(2 * nt) + 3 * a16(7 * nt))
    assert ffd_sweeps.smem_bytes(d, 2, True) == common + resident


def test_resident_or_streamed_from_the_shape():
    """The 10k shape streams its type tables at a cluster of 1 (a block
    cannot hold them whole) and keeps them resident from 2 blocks up; the
    card-test corpora (a few to 64 types, K = 64 keys and W = 80 lane words
    among them) are resident at every cluster size; 512 types of 64 keys over
    2,560 lanes stream at every size."""
    assert not ffd_sweeps.loop_plan(MAIN_DIMS, cluster=1).resident
    assert ffd_sweeps.loop_plan(MAIN_DIMS, cluster=2).resident
    for make, slots in ((lambda: W.chain_workload(3000), 128), CORPORA["topology-3-wide"]):
        d = _dims(problem_to_torch(_encode(make(), slots), "cpu"), slots)
        assert all(ffd_sweeps.loop_plan(d, cluster=cl).resident for cl in (1, 2, 4, 8))
    keys = _dims(problem_to_torch(_encode(W.wide_keys_workload(), 32), "cpu"), 32)
    assert keys["K"] >= 64 and ffd_sweeps.loop_plan(keys).resident
    wide = dict(MAIN_DIMS, K=64, W=80, V=2560)
    for cl in (1, 2, 4, 8, 16):
        plan = ffd_sweeps.loop_plan(wide, cluster=cl)
        assert not plan.resident and plan.smem == ffd_sweeps.smem_bytes(wide, cl, False)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_args_carry_the_plan_and_per_block_scratch(cluster):
    make, slots = CORPORA["chain-2000"]
    prob = problem_to_torch(_encode(make(), slots), "cpu")
    with ffd_sweeps.forced_cluster(cluster):
        t, args = ffd_sweeps.ffd_loop_args(prob, initial_state(prob, slots), one_pass=False, wavefront=3)
    plan = ffd_sweeps.loop_plan(_dims(prob, slots), cluster=cluster)
    assert (args.cluster, args.tslice, args.resident, args.smem) == tuple(plan)
    P, C, V = prob.num_pods, slots, prob.num_lanes
    assert t["queue"].shape == (cluster, 2 * P)
    assert t["chain_c"].shape == (cluster, ffd_sweeps._CHAIN_CLAIM_ROWS, C)
    assert t["chain_v"].shape == (cluster, ffd_sweeps._CHAIN_LANE_ROWS, V)
    assert t["cap_t"].dtype == torch.uint8 and t["plan"].shape == (3,)
    assert t["wave"].numel() == ffd_sweeps.wave_scratch_words(3, args.G, C, args.N, args.K, args.W, args.T, cluster)
    assert len(ffd_sweeps.WORK_COUNTERS) == 5 and ffd_sweeps.WORK_COUNTERS[-1] == "cluster_barriers"


def test_lanes_args_share_one_cluster_and_the_widest_shared_memory():
    probs = [problem_to_torch(_encode(W.chain_workload(s), 32), "cpu") for s in (2000, 2003)]
    inits = [initial_state(p, 32) for p in probs]
    ts, _buf, args = ffd_sweeps.ffd_loop_lanes_args(probs, inits)
    assert args.L == 2 and args.cluster == ffd_sweeps.cluster_size(2)
    assert args.smem == max(ffd_sweeps.loop_plan(_dims(p, 32), cluster=args.cluster).smem for p in probs)
    assert all(t["queue"].shape[0] == args.cluster for t in ts)


def test_explicit_cluster_wins_over_the_override():
    make, slots = CORPORA["chain-2000"]
    prob = problem_to_torch(_encode(make(), slots), "cpu")
    with ffd_sweeps.forced_cluster(2):
        t, args = ffd_sweeps.ffd_loop_args(prob, initial_state(prob, slots), one_pass=False, cluster=4)
        assert (args.cluster, t["queue"].shape[0]) == (4, 4)
        _, _buf, largs = ffd_sweeps.ffd_loop_lanes_args([prob] * 3, [initial_state(prob, slots)] * 3)
    assert largs.cluster == 2


def test_concurrent_overrides_do_not_leak_between_solves():
    """Two threads build lanes arguments while their cluster overrides
    interleave (one enters, the other enters, the first leaves, the second
    leaves): each lane of each launch is planned for that launch's own
    cluster, and no override outlives its block."""
    make, slots = CORPORA["chain-2000"]
    prob = problem_to_torch(_encode(make(), slots), "cpu")
    gates = [threading.Barrier(2) for _ in range(3)]
    got, errors = {}, []

    def solve(name, cluster):
        try:
            gates[0].wait()
            with ffd_sweeps.forced_cluster(cluster):
                gates[1].wait()  # both overrides are set
                if name == "b":
                    gates[2].wait()  # "a" has left its block
                ts, _buf, args = ffd_sweeps.ffd_loop_lanes_args([prob] * 2, [initial_state(prob, slots)] * 2)
                if name == "a":
                    gates[2].wait()
                got[name] = (args.cluster, [t["queue"].shape[0] for t in ts], [t["chain_c"].shape[0] for t in ts])
        except BaseException as exc:  # noqa: BLE001  (re-raised below)
            errors.append(exc)

    threads = [threading.Thread(target=solve, args=(n, cl)) for n, cl in (("a", 2), ("b", 4))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not errors, errors
    assert got == {"a": (2, [2, 2], [2, 2]), "b": (4, [4, 4], [4, 4])}
    assert ffd_sweeps.cluster_size(1) == ffd_sweeps.SOLO_CLUSTER


def _fill_plain(lvl, cap, kc):
    """ops/ffd_chain.py fill's take and member rows, over int32 tensors."""
    i32 = torch.int32
    m = min(kc, int(cap.sum()))
    L = _water_level(lvl, cap, torch.tensor(m, dtype=i32))
    take0 = torch.minimum(torch.clamp(L - lvl, min=0), cap)
    leftover = m - int(take0.sum())
    at_level = (lvl + take0 == L) & (take0 < cap)
    extra = at_level & (torch.cumsum(at_level.to(i32), 0) <= leftover)
    take = (take0 + extra.to(i32)).to(i32)
    lev = _water_level(lvl, take, torch.arange(m, dtype=i32))
    before = torch.minimum(torch.clamp(lev[:, None] - lvl[None, :], min=0), take[None, :]).sum(dim=-1)
    pos = torch.arange(m) - before
    at_lev = (lvl[None, :] <= lev[:, None]) & (lev[:, None] < (lvl + take)[None, :])
    lev_cum = torch.cumsum(at_lev.to(i32), dim=-1)
    of = torch.argmax((at_lev & (lev_cum == (pos + 1)[:, None])).to(i32), dim=-1)
    return int(L), take.tolist(), of.tolist()


def _pour_order(lvl, take, k):
    """The members in pour order as csrc/chain.cuh fill_members places them:
    the claims with a take listed in slot order with their first unit's
    ordinal, and unit u (claim c, level L) written at the count of the units
    that pour before it: those at lower levels, and at level L of claims
    listed before c."""
    listed = [c for c in range(len(lvl)) if take[c] > 0]
    ustart = np.cumsum([0] + [take[c] for c in listed])[:-1].tolist()
    of = [None] * k
    for u in range(k):
        i = max(x for x in range(len(listed)) if ustart[x] <= u)
        c = listed[i]
        L = lvl[c] + u - ustart[i]
        rank = sum(min(max(L - lvl[c2], 0), take[c2]) + (c2 < c and lvl[c2] <= L < lvl[c2] + take[c2])
                   for c2 in listed)
        of[rank] = c
    return of


def test_saturated_caps_leave_the_fill_unchanged():
    """Seeded: the chain's capacities as the kernel stores them (uint8,
    saturated at 255) give the plain fill's level, takes and members exactly
    for every chain of at most STRIDE members; and the kernel's one-pass
    ranks of the units give the same members."""
    rng = np.random.default_rng(10)
    i32 = torch.int32
    for trial in range(300):
        C = int(rng.choice([4, 32, 128]))
        lvl = torch.tensor(rng.integers(0, 300, size=C), dtype=i32)
        # capacities from none to far beyond 255 (BIG_CAP included)
        cap = torch.tensor(rng.choice([0, 1, 2, 7, 63, 64, 200, 255, 256, 1000, _BIG_CAP], size=C), dtype=i32)
        if trial % 3 == 0:
            lvl = torch.tensor(rng.integers(0, 4, size=C), dtype=i32)  # many claims at one level
        kc = int(rng.integers(2, STRIDE + 1))
        exact = _fill_plain(lvl, cap, kc)
        sat = _fill_plain(lvl, torch.clamp(cap, max=255), kc)
        assert exact == sat, trial
        for units in range(0, kc + 1, 7):
            u = torch.tensor(units, dtype=i32)
            assert int(_water_level(lvl, cap, u)) == int(_water_level(lvl, torch.clamp(cap, max=255), u))
        L, take, of = exact
        assert _pour_order(lvl.tolist(), take, len(of)) == of, trial


def test_saturated_caps_keep_the_committed_survivors():
    """cap_t >= take with take <= STRIDE: the saturated compare equals the
    exact one for every capacity."""
    caps = torch.arange(0, 2000, dtype=torch.int32)
    sat = torch.clamp(caps, max=255).to(torch.uint8)
    for take in range(1, STRIDE + 1):
        assert torch.equal(caps >= take, sat.to(torch.int32) >= take)
