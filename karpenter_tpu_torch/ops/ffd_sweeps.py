"""The requeue-until-no-progress FFD loop: all retry sweeps of one solve.

The reference's Solve loop requeues failed pods and retries while any
placement makes progress (scheduler.go:150-170): a pod whose required
pod-affinity peers were placed later in the queue succeeds on the next sweep.
This is the JAX package's ``ops/ffd_sweeps._sweeps_impl`` without its
flag-gated branches: a compact queue of the active rows in FFD order; each
sweep walks the queue in narrow iterations (ops/ffd_chain.py: one pod
evaluated, its chain of chain-identical successors committed in closed form)
and queues the KIND_FAIL rows for the next sweep; the loop stops when a sweep
makes no progress or a pod hit KIND_NO_SLOT (the backend then retries with
more claim slots, at the same sweep boundary as the JAX package).
``IterCounts`` counts as the JAX package does.

Two implementations of the same function:
  * ``sweeps_plain`` — plain PyTorch, one ``ffd_chain`` narrow iteration at a
    time. Taken for CPU tensors (the tests) and as the yardstick on the card.
  * the ``ffd_loop`` CUDA kernel (csrc/ffd_loop.cu) — the whole loop in one
    launch, taken for CUDA tensors. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_FAIL,
    KIND_NO_SLOT,
    FFDResult,
    FFDState,
    IterCounts,
    _lane_align,
    _pad_lanes_mult32,
    _pod_xs,
    _statics,
    initial_state,
    pod_row,
    problem_bounds_free,
)
from karpenter_tpu_torch.ops.ffd_chain import chain_flags, chain_length, chain_rows, make_narrow
from karpenter_tpu_torch.ops.ffd_step import clone_state


def sweeps_plain(problem: SchedulingProblem, init: FFDState, bounds_free: bool,
                 kind0=None, index0=None) -> FFDResult:
    """Plain PyTorch requeue loop (see module docstring). ``kind0``/``index0``
    seed the verdict rows of pods the loop does not step (the carried repair
    pass: phase 1's placements); unseeded rows start KIND_FAIL / -1."""
    P = problem.num_pods
    C = init.claim_open.shape[0]
    dev = problem.lane_valid.device
    state = clone_state(init)
    narrow = make_narrow(problem, _statics(problem, bounds_free), C)
    chain = chain_flags(problem)
    xs = _pod_xs(problem, bounds_free)
    active = problem.pod_active.cpu().tolist()
    queue = [p for p in range(P) if active[p]]
    kinds = [KIND_FAIL] * P if kind0 is None else kind0.cpu().tolist()
    idxs = [-1] * P if index0 is None else index0.cpu().tolist()
    n_narrow = sweeps = chain_commits = chain_pods = 0
    progress, noslot = True, False
    while progress and queue and not noslot:
        nq = []
        i = 0
        while i < len(queue):
            p = queue[i]
            kind, rows, k = narrow(state, pod_row(xs, p), p, chain_length(queue, i, chain))
            for s in range(k):
                kinds[p + s], idxs[p + s] = kind, rows[s]
                if kind == KIND_FAIL:
                    nq.append(p + s)
            noslot |= kind == KIND_NO_SLOT
            n_narrow += 1
            if k > 1:
                chain_commits += 1
                chain_pods += k
            i += k
        progress = len(nq) < len(queue)
        queue = nq
        sweeps += 1
    return FFDResult(
        kind=torch.tensor(kinds, dtype=torch.int32, device=dev).reshape(P),
        index=torch.tensor(idxs, dtype=torch.int32, device=dev).reshape(P),
        state=state,
        iters=IterCounts(narrow=n_narrow, sweeps=sweeps, chain_commits=chain_commits, chain_pods=chain_pods),
    )


def solve_ffd_sweeps(problem: SchedulingProblem, max_claims: int) -> FFDResult:
    """Run all retry sweeps of a solve from a fresh state: one ``ffd_loop``
    launch for CUDA tensors, the plain version for CPU tensors."""
    problem = _pad_lanes_mult32(problem)
    init = initial_state(problem, max_claims)
    if problem.lane_valid.is_cuda:
        return launch_ffd_loop(problem, init, one_pass=False)
    return sweeps_plain(problem, init, problem_bounds_free(problem))


def solve_ffd_sweeps_carried(problem: SchedulingProblem, max_claims: int, init) -> FFDResult:
    """The repair pass of the two-phase solve (ops/relax.py): ``init`` is
    (state, kind, index) from phase 1, ``problem.pod_active`` holds only the
    residue. The loop starts from phase 1's claim landscape, and phase 1's
    verdict rows ride through untouched because their pods are never stepped.
    One ``ffd_loop`` launch for CUDA tensors, the plain version for CPU
    tensors. ``max_claims`` must equal the carried state's claim axis."""
    state, kind0, index0 = init
    if state.claim_open.shape[0] != max_claims:
        raise ValueError(f"carried state has {state.claim_open.shape[0]} claim slots, not {max_claims}")
    problem, state = _lane_align(problem, state)
    if problem.lane_valid.is_cuda:
        return launch_ffd_loop(problem, state, one_pass=False, kind0=kind0, index0=index0)
    return sweeps_plain(problem, state, problem_bounds_free(problem), kind0, index0)


def fresh_carry(problem: SchedulingProblem, max_claims: int):
    """A cold carry for ``solve_ffd_sweeps_carried``: the plain initial state
    and all-FAIL verdict seeds. The consolidation screen's base-world solve
    (disruption/screen_delta.py) rides the carried entry this way, because
    the state it keeps is that entry's output."""
    problem = _pad_lanes_mult32(problem)
    P = problem.num_pods
    dev = problem.lane_valid.device
    return (
        initial_state(problem, max_claims),
        torch.full((P,), KIND_FAIL, dtype=torch.int32, device=dev),
        torch.full((P,), -1, dtype=torch.int32, device=dev),
    )


# -- the ffd_loop kernel's argument struct (csrc/ffd_loop.cu FfdArgs) ---------

_FFD_INPUTS = (
    "lvw", "ln", "lex", "wellknown",
    "pod_adm", "pod_comp", "pod_def", "pod_gt", "pod_lt", "pod_neg", "pod_strict_adm",
    "pod_requests", "pod_tol_tpl", "pod_tol_node", "pod_ports", "pod_conflict",
    "pod_match", "pod_selects", "pod_owned", "pod_vols", "pod_active", "pod_eqprev_chain",
    "it_adm", "it_comp", "it_def", "it_gt", "it_lt", "it_neg",
    "it_alloc", "it_cap", "offer_zone", "offer_ct", "offer_ok",
    "tpl_adm", "tpl_comp", "tpl_def", "tpl_gt", "tpl_lt", "tpl_neg",
    "tpl_overhead", "tpl_it_ok",
    "node_avail", "node_vol_limits",
    "grp_type", "grp_key", "grp_max_skew", "grp_min_domains", "grp_inverse", "grp_has_filter",
    "flt_adm", "flt_comp", "flt_def", "flt_gt", "flt_lt", "flt_neg", "flt_valid",
    "host_lane", "kind0", "index0",
)
# the carried state, read and updated in place
FFD_STATE = (
    "claim_adm", "claim_comp", "claim_def", "claim_gt", "claim_lt",
    "claim_requests", "claim_it_ok", "claim_open", "claim_npods", "claim_tpl", "claim_ports",
    "node_adm", "node_comp", "node_def", "node_gt", "node_lt",
    "node_requests", "node_npods", "node_ports", "node_vol_used",
    "remaining", "grp_counts", "grp_registered",
)
# the kernel's own working rows, neither read before nor kept after it
FFD_SCRATCH = ("fin_adm", "fin_comp", "fin_def", "fin_gt", "fin_lt", "fin_neg", "bin_ok", "queue",
               "ok_t", "cap_t", "chain_c", "chain_v")
_FFD_POINTERS = _FFD_INPUTS + FFD_STATE + FFD_SCRATCH + ("kind", "index", "counters", "work")
_FFD_INTS = ("P", "K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G", "F", "CH", "one_pass")
_FfdArgs = kernels.make_struct("FfdArgs", _FFD_POINTERS, _FFD_INTS)

# the kernel's work counters (csrc/ffd_loop.cu WORK_*), in order
WORK_COUNTERS = ("bin_gates", "topo_lanes", "type_tests", "barriers")

# rows of the chain commit's per-claim and per-lane scratch (csrc/chain.cuh
# NCS, NVS)
_CHAIN_CLAIM_ROWS = 9
_CHAIN_LANE_ROWS = 2


def _req_tensors(prefix: str, r: ReqTensor, lv, ln, out: dict, state: bool = False) -> None:
    """Packed rows of ``r`` under ``prefix``; ``state`` rows are fresh copies
    the kernel may update, the others also carry their polarity."""
    out[prefix + "_adm"] = masks.pack_lanes(r.admitted).contiguous()
    for name, src in (("_comp", r.comp), ("_def", r.defined), ("_gt", r.gt), ("_lt", r.lt)):
        src = src.to(torch.int32) if name in ("_gt", "_lt") else src
        out[prefix + name] = src.clone().contiguous() if state else src.contiguous()
    if not state:
        out[prefix + "_neg"] = masks.negative_polarity(r, lv, ln).contiguous()


def launch_ffd_loop(problem: SchedulingProblem, init: FFDState, one_pass: bool,
                    kind0=None, index0=None) -> FFDResult:
    """Run the ``ffd_loop`` kernel on CUDA tensors: the requeue loop, or with
    ``one_pass`` a single scan over every row (the backend's per-pass mode).
    ``kind0``/``index0`` (i32[P], both or neither) seed the verdict rows, as
    in ``sweeps_plain``. ``init`` is not modified. The kernel evaluates the
    general (bounded) arm of the mask algebra, which equals the bounds-free
    arm on problems without Gt/Lt bounds, so there is no separate bounds-free
    kernel path."""
    dev = problem.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_ffd_loop needs CUDA tensors")
    t, args = ffd_loop_args(problem, init, one_pass, kind0, index0)
    kernels.launch("ffd_loop", args, torch.cuda.current_stream(dev).cuda_stream)

    state = state_back(t, problem.num_lanes)
    iters: Optional[IterCounts] = None
    if not one_pass:
        iters = IterCounts(*t["counters"])
    return FFDResult(kind=t["kind"], index=t["index"], state=state, iters=iters, work=t["work"])


# the pod-axis tables in the kernels' layout: struct field <- problem field
POD_FIELDS = (
    ("pod_requests", "pod_requests"), ("pod_tol_tpl", "pod_tol_tpl"),
    ("pod_tol_node", "pod_tol_node"), ("pod_ports", "pod_ports"),
    ("pod_conflict", "pod_port_conflict"), ("pod_match", "pod_grp_match"),
    ("pod_selects", "pod_grp_selects"), ("pod_owned", "pod_grp_owned"),
    ("pod_vols", "pod_vol_counts"),
)


def _i32(src: torch.Tensor) -> torch.Tensor:
    return (src.to(torch.int32) if src.dtype == torch.int64 else src).contiguous()


def pod_tensors(src, lv, ln) -> dict:
    """The pod-axis rows of ``src`` (anything with the SchedulingProblem
    pod fields ``pod_reqs``, ``pod_strict_reqs`` and ``POD_FIELDS``) in the
    kernels' layout: packed lane words, per-row polarity, int32 indices.
    ``pod_active`` is not among them. Rows convert independently of each
    other, which is what lets the device world patch converted rows
    (ops/fused.py)."""
    t: dict = {}
    _req_tensors("pod", src.pod_reqs, lv, ln, t)
    t["pod_strict_adm"] = masks.pack_lanes(src.pod_strict_reqs.admitted).contiguous()
    for name, field in POD_FIELDS:
        t[name] = _i32(getattr(src, field))
    return t


def problem_tensors(problem: SchedulingProblem) -> dict:
    """The problem's tables in the kernels' layout, by struct field name:
    packed lane words, per-row polarities, int32 indices. Shared by the
    ``ffd_loop`` and ``runs_screen`` argument builders."""
    lv, ln = problem.lane_valid, problem.lane_numeric
    i32 = torch.int32
    t: dict = {}
    t["lvw"] = masks.pack_lanes(lv).contiguous()
    t["ln"] = ln.contiguous()
    t["lex"] = problem.lane_lex_rank.to(i32).contiguous()
    t["wellknown"] = problem.key_wellknown.contiguous()
    t.update(pod_tensors(problem, lv, ln))
    for name, src in (
        ("pod_active", problem.pod_active),
        ("it_alloc", problem.it_alloc), ("it_cap", problem.it_cap),
        ("offer_zone", problem.offer_zone), ("offer_ct", problem.offer_ct),
        ("offer_ok", problem.offer_ok), ("tpl_overhead", problem.tpl_overhead),
        ("tpl_it_ok", problem.tpl_it_ok), ("node_avail", problem.node_avail),
        ("node_vol_limits", problem.node_vol_limits), ("grp_type", problem.grp_type),
        ("grp_key", problem.grp_key), ("grp_max_skew", problem.grp_max_skew),
        ("grp_min_domains", problem.grp_min_domains), ("grp_inverse", problem.grp_inverse),
        ("grp_has_filter", problem.grp_has_filter), ("flt_valid", problem.grp_filter_valid),
        ("host_lane", problem.claim_hostname_lane),
        ("pod_eqprev_chain", chain_rows(problem)),
    ):
        t[name] = _i32(src)
    _req_tensors("it", problem.it_reqs, lv, ln, t)
    _req_tensors("tpl", problem.tpl_reqs, lv, ln, t)
    _req_tensors("flt", problem.grp_filter, lv, ln, t)
    return t


# the carried state's struct fields and their FFDState sources
_STATE_LEAVES = (
    ("claim_requests", "claim_requests"), ("claim_it_ok", "claim_it_ok"),
    ("claim_open", "claim_open"), ("claim_npods", "claim_npods"),
    ("claim_tpl", "claim_tpl"), ("claim_ports", "claim_used_ports"),
    ("node_requests", "node_requests"), ("node_npods", "node_npods"),
    ("node_ports", "node_used_ports"), ("node_vol_used", "node_vol_used"),
    ("remaining", "remaining"), ("grp_counts", "grp_counts"),
    ("grp_registered", "grp_registered"),
)


def state_tensors(init: FFDState, lv, ln, prefix: str = "") -> dict:
    """A copy of the carried state in the kernels' layout (packed requirement
    rows), by struct field name with ``prefix``."""
    t: dict = {}
    _req_tensors("claim", init.claim_req, lv, ln, t, state=True)
    _req_tensors("node", init.node_req, lv, ln, t, state=True)
    for name, leaf in _STATE_LEAVES:
        t[name] = getattr(init, leaf).clone().contiguous()
    return {prefix + name: t[name] for name in FFD_STATE}


def state_back(t: dict, V: int) -> FFDState:
    """The FFDState of the kernel-layout state tensors in ``t`` (unpacked
    lanes; leading lane axes kept)."""

    def req_back(prefix: str) -> ReqTensor:
        return ReqTensor(
            admitted=masks.unpack_lanes(t[prefix + "_adm"], V),
            comp=t[prefix + "_comp"], gt=t[prefix + "_gt"], lt=t[prefix + "_lt"],
            defined=t[prefix + "_def"],
        )

    return FFDState(
        claim_req=req_back("claim"), node_req=req_back("node"),
        **{leaf: t[name] for name, leaf in _STATE_LEAVES},
    )


def ffd_loop_args(problem: SchedulingProblem, init: FFDState, one_pass: bool, kind0=None, index0=None):
    """The kernel's tensors by struct field name (inputs in its layout, a
    copy of the carried state to update in place, scratch, outputs) and its
    argument struct: one launch's worth, as ``launch_ffd_loop`` passes it."""
    t = problem_tensors(problem)
    # the carried state, copied into the kernel's layout (updated in place)
    t.update(state_tensors(init, problem.lane_valid, problem.lane_numeric))
    return loop_args_from(t, one_pass, kind0, index0)


def loop_args_from(tensors: dict, one_pass: bool, kind0=None, index0=None):
    """``ffd_loop_args`` over tables already in the kernel's layout: the
    problem's (``problem_tensors``, or a device-resident world holding them,
    ops/fused.py) and a state the launch may update in place
    (``state_tensors``), by struct field name. Adds scratch and outputs to a
    copy of ``tensors``; the dimensions are read from the tables' shapes."""
    t = dict(tensors)
    dev = t["ln"].device
    K, W = t["lvw"].shape
    V = t["ln"].shape[1]
    P, R = t["pod_requests"].shape
    T, TPL, N = t["it_alloc"].shape[0], t["tpl_overhead"].shape[0], t["node_avail"].shape[0]
    C, G, F = t["claim_open"].shape[0], t["grp_type"].shape[0], t["flt_valid"].shape[1]
    i32 = torch.int32
    B = N + C + TPL
    t["fin_adm"] = torch.empty((B, K, W), dtype=i32, device=dev)
    t["fin_gt"] = torch.empty((B, K), dtype=i32, device=dev)
    t["fin_lt"] = torch.empty((B, K), dtype=i32, device=dev)
    for name in ("fin_comp", "fin_def", "fin_neg"):
        t[name] = torch.empty((B, K), dtype=torch.bool, device=dev)
    t["bin_ok"] = torch.zeros((B,), dtype=torch.bool, device=dev)
    t["queue"] = torch.empty((2 * P,), dtype=i32, device=dev)
    t["kind"] = torch.empty((P,), dtype=i32, device=dev)
    t["index"] = torch.empty((P,), dtype=i32, device=dev)
    if (kind0 is None) != (index0 is None):
        raise ValueError("kind0 and index0 seed the verdict rows together")
    for name, seed in (("kind0", kind0), ("index0", index0)):
        if seed is not None and (seed.shape != (P,) or seed.device != dev):
            raise ValueError(f"{name} must be i32[{P}] on {dev}")
        t[name] = None if seed is None else seed.to(i32).contiguous()
    t["ok_t"] = torch.empty((C, T), dtype=torch.bool, device=dev)
    t["cap_t"] = torch.empty((C, T), dtype=i32, device=dev)
    t["chain_c"] = torch.empty((_CHAIN_CLAIM_ROWS, C), dtype=i32, device=dev)
    t["chain_v"] = torch.empty((_CHAIN_LANE_ROWS, V), dtype=i32, device=dev)
    t["counters"] = torch.zeros((4,), dtype=i32, device=dev)
    t["work"] = torch.zeros((len(WORK_COUNTERS),), dtype=torch.int64, device=dev)

    dims = dict(P=P, K=K, V=V, W=W, C=C, N=N, T=T, TPL=TPL, R=R,
                O=t["offer_ok"].shape[1], PT=t["pod_ports"].shape[1],
                D=t["pod_vols"].shape[1], G=G, F=F,
                CH=t["host_lane"].shape[0], one_pass=int(one_pass))
    args = _FfdArgs(**{name: (t[name].data_ptr() if t[name] is not None else None) for name in _FFD_POINTERS},
                    **dims)
    return t, args
