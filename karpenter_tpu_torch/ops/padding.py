"""Shape bucketing for the solver.

Pods/instance-types/nodes/templates/keys/lanes vary per batch; jit compiles
per shape. Padding every axis up to a bucket makes compile shapes repeat
across batches (SURVEY.md §7 hard part (3): pad-and-mask with bucketed compile
sizes). Padded entities are made inert:

  pods       toleration rows all-False  -> every placement check fails, the
             pod reads as KIND_FAIL; decode drops rows past the real count
  nodes      node_avail = -1            -> fits() can never pass
  ITs        it_alloc = -1, tpl_it_ok False
  templates  tpl_it_ok row False, pod_tol_tpl column False
  keys/lanes lane_valid False, defined False (identity under intersection)
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.models.problem import GT_NONE, LT_NONE, ReqTensor, SchedulingProblem

def pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def claim_axis_bucket(n: int) -> int:
    """Claim-slot bucket: pow2 up to 128, quarter-pow2 steps above
    (160/192/224/256/320/...). The claim axis C multiplies every claim-gate
    tensor AND (through the minted hostname lanes) the lane axis V, so the
    pow2 jump 128->256 nearly quadrupled the narrow step's data — the
    "256-slot cliff". Quarter steps cap the overshoot at 25% per axis for at
    most 2x the compiled variants; the backend escalates one step at a time
    on overflow (solver/torch_backend.TorchSolver)."""
    if n <= 128:
        return pow2_bucket(n)
    return quarter_bucket(n, lo=128)


def lane_axis_bucket(n: int) -> int:
    """Lane-axis bucket: pow2 up to 128, quarter-pow2 steps above. Every
    quarter step over 128 is a multiple of 32, preserving the uint32
    bitpack invariant on V. Tracks claim_axis_bucket because claim-heavy
    batches mint one hostname lane per slot: at 134 claims V lands on 192
    instead of doubling to 256+."""
    if n <= 128:
        return pow2_bucket(n, lo=32)
    return quarter_bucket(n, lo=128)


def pod_axis_bucket(n: int) -> int:
    """Pod-axis bucket: pow2 up to 1024, then quarter-pow2 mantissa steps
    (1.25/1.5/1.75/2.0 x 2^k). The pod axis is the SCAN length — every padded
    row is a wasted sequential step, and pure pow2 wastes up to 50% of them
    (10k pods pad to 16,384). Mantissa steps cap the waste at 25% for at most
    2x the compile-cache variants; the other axes keep pow2 (they are vector
    widths, where padding costs bandwidth, not latency)."""
    if n <= 1024:
        return pow2_bucket(n)
    return quarter_bucket(n, lo=1024)


def quarter_bucket(n: int, lo: int = 8) -> int:
    """Quarter-pow2 bucket (1.25/1.5/1.75/2.0 x 2^k steps above ``lo``): caps
    padding waste at 25% for ~2x the bucket count. Used for axes where
    padding costs real compute per padded element: the pod scan axis above
    1024 (pod_axis_bucket) and the claim and lane axes above 128."""
    if n <= lo:
        return lo
    base = lo
    while base * 2 < n:
        base *= 2
    # base < n <= base*2 here; the smallest quarter step at or above n wins
    for mantissa in (5, 6, 7):
        b = base * mantissa // 4
        if b >= n:
            return b
    return base * 2


def screen_axis_bucket(n: int, lo: int = 8) -> int:
    """Eighth-pow2 bucket (1.125/1.25/.../2.0 x 2^k steps above ``lo``) for
    the consolidation screen's subset axis and the residual screen's run
    axis: every padded lane is a dummy solve, so eighth steps cap the waste
    at 12.5% (300 lanes pad to 320)."""
    if n <= lo:
        return lo
    base = lo
    while base * 2 < n:
        base *= 2
    for mantissa in (9, 10, 11, 12, 13, 14, 15):
        b = base * mantissa // 8
        if b >= n:
            return b
    return base * 2


def _pad(arr: np.ndarray, target_shape, fill) -> np.ndarray:
    arr = np.asarray(arr)
    pads = [(0, t - s) for s, t in zip(arr.shape, target_shape)]
    return np.pad(arr, pads, constant_values=fill)


def _pad_capacity(arr: np.ndarray, rows: int, cols: int, row_fill: float) -> np.ndarray:
    """Pad a [E, R] capacity array: new resource columns get 0 (real entities
    must still fit requests of 0 there) while new entity rows get ``row_fill``
    (-1 makes fits() unsatisfiable, neutralizing the row)."""
    arr = np.asarray(arr)
    arr = np.pad(arr, [(0, 0), (0, cols - arr.shape[1])], constant_values=0.0)
    return np.pad(arr, [(0, rows - arr.shape[0]), (0, 0)], constant_values=row_fill)


def _pad_reqs(r: ReqTensor, e: int, k: int, v: int) -> ReqTensor:
    E = r.admitted.shape[0]
    return ReqTensor(
        admitted=_pad(r.admitted, (e, k, v), False),
        comp=_pad(r.comp, (e, k), True),
        gt=_pad(r.gt, (e, k), GT_NONE),
        lt=_pad(r.lt, (e, k), LT_NONE),
        defined=_pad(r.defined, (e, k), False),
    )


def pad_problem(p: SchedulingProblem) -> SchedulingProblem:
    """Pad every axis of ``p`` to its bucket. Padded pod rows tolerate
    nothing, so they resolve to KIND_FAIL without touching state."""
    P = pod_axis_bucket(p.num_pods)
    T = pow2_bucket(p.num_instance_types)
    # N=0 stays 0: provisioning batches without existing nodes skip the
    # whole node branch statically instead of scanning 8 inert rows
    N = pow2_bucket(p.num_nodes, lo=8) if p.num_nodes else 0
    RN = pow2_bucket(p.num_runs, lo=4)
    TPL = pow2_bucket(p.num_templates, lo=4)
    K = pow2_bucket(p.num_keys, lo=4)
    # V must stay a multiple of 32: the solver bitpacks value lanes into
    # uint32 words for the hot instance-type compatibility product
    # (lane_axis_bucket's quarter steps above 128 keep that invariant)
    V = lane_axis_bucket(p.num_lanes)
    R = pow2_bucket(p.num_resources, lo=8)
    O = pow2_bucket(p.offer_ok.shape[1], lo=8)
    PT = pow2_bucket(p.pod_ports.shape[1], lo=8)
    # G=0 stays 0: the topology kernels early-exit statically
    G = pow2_bucket(p.num_groups, lo=8) if p.num_groups else 0
    # F=0 stays 0 (no node filters anywhere): record()'s filter product
    # vanishes statically
    F = (
        pow2_bucket(p.grp_filter_valid.shape[1], lo=2)
        if p.num_groups and p.grp_filter_valid.shape[1]
        else p.grp_filter_valid.shape[1]
    )

    return SchedulingProblem(
        lane_valid=_pad(p.lane_valid, (K, V), False),
        lane_numeric=_pad(p.lane_numeric, (K, V), np.nan),
        lane_lex_rank=_pad(p.lane_lex_rank, (K, V), 2**30),
        key_wellknown=_pad(p.key_wellknown, (K,), False),
        pod_reqs=_pad_reqs(p.pod_reqs, P, K, V),
        pod_requests=_pad(p.pod_requests, (P, R), 0.0),
        pod_tol_tpl=_pad(p.pod_tol_tpl, (P, TPL), False),
        pod_tol_node=_pad(p.pod_tol_node, (P, N), False),
        pod_ports=_pad(p.pod_ports, (P, PT), False),
        pod_port_conflict=_pad(p.pod_port_conflict, (P, PT), False),
        pod_strict_reqs=_pad_reqs(p.pod_strict_reqs, P, K, V),
        it_reqs=_pad_reqs(p.it_reqs, T, K, V),
        it_alloc=_pad_capacity(p.it_alloc, T, R, -1.0),
        it_cap=_pad_capacity(p.it_cap, T, R, 0.0),
        offer_zone=_pad(p.offer_zone, (T, O), 0),
        offer_ct=_pad(p.offer_ct, (T, O), 0),
        offer_ok=_pad(p.offer_ok, (T, O), False),
        offer_price=_pad(p.offer_price, (T, O), np.inf),
        tpl_reqs=_pad_reqs(p.tpl_reqs, TPL, K, V),
        tpl_overhead=_pad(p.tpl_overhead, (TPL, R), 0.0),
        tpl_it_ok=_pad(p.tpl_it_ok, (TPL, T), False),
        tpl_remaining=_pad(p.tpl_remaining, (TPL, R), np.float32(np.inf)),
        node_reqs=_pad_reqs(p.node_reqs, N, K, V),
        node_avail=_pad_capacity(p.node_avail, N, R, -1.0),
        node_overhead=_pad(p.node_overhead, (N, R), 0.0),
        node_used_ports=_pad(p.node_used_ports, (N, PT), False),
        # D stays unpadded (drivers are few and static per batch); padded
        # node rows get unlimited headroom so they never gate
        pod_vol_counts=_pad(p.pod_vol_counts, (P, p.pod_vol_counts.shape[1]), 0),
        node_vol_used=_pad(p.node_vol_used, (N, p.node_vol_used.shape[1]), 0),
        node_vol_limits=_pad(p.node_vol_limits, (N, p.node_vol_limits.shape[1]), 2**30),
        grp_type=_pad(p.grp_type, (G,), 0),
        grp_key=_pad(p.grp_key, (G,), 0),
        grp_max_skew=_pad(p.grp_max_skew, (G,), 2**31 - 1),
        grp_min_domains=_pad(p.grp_min_domains, (G,), -1),
        grp_counts0=_pad(p.grp_counts0, (G, V), 0),
        grp_registered0=_pad(p.grp_registered0, (G, V), False),
        grp_inverse=_pad(p.grp_inverse, (G,), False),
        grp_has_filter=_pad(p.grp_has_filter, (G,), False),
        grp_filter=_pad_filter_reqs(p.grp_filter, G, F, K, V),
        grp_filter_valid=_pad(p.grp_filter_valid, (G, F), False),
        pod_grp_match=_pad(p.pod_grp_match, (P, G), False),
        pod_grp_selects=_pad(p.pod_grp_selects, (P, G), False),
        pod_grp_owned=_pad(p.pod_grp_owned, (P, G), False),
        claim_hostname_lane=p.claim_hostname_lane,
        # padded pod rows are inactive; padding runs have len 0 (the run
        # solver's masked window write makes them no-ops). Padded rows are
        # NOT covered by any run — their outputs stay at the initial
        # KIND_FAIL and decode drops them anyway.
        pod_active=_pad(p.pod_active, (P,), False),
        run_start=_pad(p.run_start, (RN,), 0),
        run_len=_pad(p.run_len, (RN,), 0),
        # padding runs are length-0 analytic commits (pure no-ops)
        run_mode=_pad(p.run_mode, (RN,), 1),
        # padded instance-type rows have no offerings at all
        offer_zc=(
            _pad(p.offer_zc, (T,) + p.offer_zc.shape[1:], False)
            if p.offer_zc is not None
            else None
        ),
        # padded pod rows are never identical to their predecessor
        pod_eqprev=(
            _pad(p.pod_eqprev, (P,), False) if p.pod_eqprev is not None else None
        ),
        pod_eqprev_gate=(
            _pad(p.pod_eqprev_gate, (P,), False)
            if p.pod_eqprev_gate is not None
            else None
        ),
        pod_eqprev_chain=(
            _pad(p.pod_eqprev_chain, (P,), False)
            if p.pod_eqprev_chain is not None
            else None
        ),
    )


def _pad_filter_reqs(r: ReqTensor, g: int, f: int, k: int, v: int) -> ReqTensor:
    return ReqTensor(
        admitted=_pad(r.admitted, (g, f, k, v), False),
        comp=_pad(r.comp, (g, f, k), True),
        gt=_pad(r.gt, (g, f, k), GT_NONE),
        lt=_pad(r.lt, (g, f, k), LT_NONE),
        defined=_pad(r.defined, (g, f, k), False),
    )
