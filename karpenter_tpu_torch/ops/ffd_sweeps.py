"""The requeue-until-no-progress FFD loop: all retry sweeps of one solve.

The reference's Solve loop requeues failed pods and retries while any
placement makes progress (scheduler.go:150-170): a pod whose required
pod-affinity peers were placed later in the queue succeeds on the next sweep.
This is the JAX package's ``ops/ffd_sweeps._sweeps_impl``: a compact queue
of the active rows in FFD order; each sweep walks the queue in narrow
iterations (ops/ffd_chain.py: one pod evaluated, its chain of
chain-identical successors committed in closed form) and queues the
KIND_FAIL rows for the next sweep; the loop stops when a sweep makes no
progress or a pod hit KIND_NO_SLOT (the backend then retries with more claim
slots, at the same sweep boundary as the JAX package). With the wavefront
(``KARPENTER_TPU_WAVEFRONT``, ``wavefront_lanes``) up to ``wavefront``
further chain heads act after each narrow iteration (ops/ffd_chain.py
``wave``), and the result carries ``wave_hist``. ``IterCounts`` counts as
the JAX package does.

The learned order (``KARPENTER_TPU_ORDER_POLICY``, program 6; the JAX
package's policy sweeps entries): given ``order_scores`` (one score per row,
ops/policy.lane_scores over the weights of solver/ordering.py), the loop
sorts the next sweep's queue at each sweep boundary stably by descending
score (equal scores, -0.0 and +0.0 among them, keep their queue order, so
identical adjacent rows stay adjacent for the chain commits).

Two implementations of the same function:
  * ``sweeps_plain`` — plain PyTorch, one ``ffd_chain`` narrow iteration at a
    time. Taken for CPU tensors (the tests) and as the yardstick on the card.
  * the ``ffd_loop`` CUDA kernel (csrc/ffd_loop.cu) — the whole loop in one
    launch, taken for CUDA tensors. There is no fallback between the two.

The kernel runs one solve on a thread-block cluster (csrc/ffd_loop.cu):
``loop_plan`` picks the cluster's size, each block's slice of the instance
types and whether that slice of the type tables is resident in the block's
shared memory, from the shape alone; the launch reports the plan it ran
with (``plan`` of its tensors). A cluster the card refuses raises
KernelDeviceError; nothing falls back to a smaller cluster.

The lanes mode (``launch_ffd_loop_lanes``; the partitioned solve's
programs 13 and 14, parallel/mesh.py) runs L independent loops in one
launch, one cluster per lane, each lane from its own argument struct with
its own scratch, verdicts, IterCounts and work counters, each exiting its
loop when it converges. Its plain version is ``sweeps_plain`` per lane.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence

import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_FAIL,
    KIND_NEW_CLAIM,
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


def wavefront_lanes() -> int:
    """The extra lanes per narrow iteration that ``KARPENTER_TPU_WAVEFRONT``
    asks for (the JAX package's ``_wavefront_lanes``, ops/ffd_sweeps.py:74):
    0 with the flag off (its default), else ``KARPENTER_TPU_WAVEFRONT_WIDTH``
    (default 4) less one. Read at every call, so one process can solve with
    the flag on and off."""
    if os.environ.get("KARPENTER_TPU_WAVEFRONT", "0") == "0":
        return 0
    return max(int(os.environ.get("KARPENTER_TPU_WAVEFRONT_WIDTH", "4")) - 1, 0)


def _lanes(wavefront: Optional[int]) -> int:
    return wavefront_lanes() if wavefront is None else int(wavefront)


def sweeps_plain(problem: SchedulingProblem, init: FFDState, bounds_free: bool,
                 kind0=None, index0=None, order_scores=None, wavefront: int = 0) -> FFDResult:
    """Plain PyTorch requeue loop (see module docstring). ``kind0``/``index0``
    seed the verdict rows of pods the loop does not step (the carried repair
    pass: phase 1's placements); unseeded rows start KIND_FAIL / -1.
    ``order_scores`` (f32[P]) sorts each sweep's requeue by descending score.
    ``wavefront`` extra lanes follow each narrow iteration
    (ops/ffd_chain.py ``wave``); the result then carries ``wave_hist``."""
    P = problem.num_pods
    C = init.claim_open.shape[0]
    dev = problem.lane_valid.device
    state = clone_state(init)
    narrow = make_narrow(problem, _statics(problem, bounds_free), C)
    chain = chain_flags(problem)
    xs = _pod_xs(problem, bounds_free)
    active = problem.pod_active.cpu().tolist()
    score = None if order_scores is None else order_scores.cpu().tolist()
    queue = [p for p in range(P) if active[p]]
    kinds = [KIND_FAIL] * P if kind0 is None else kind0.cpu().tolist()
    idxs = [-1] * P if index0 is None else index0.cpu().tolist()
    n_narrow = sweeps = chain_commits = chain_pods = wave_commits = wave_pods = retry_lanes = 0
    hist = [0] * (wavefront + 2)
    progress, noslot = True, False
    while progress and queue and not noslot:
        nq = []
        i = 0
        while i < len(queue):
            p = queue[i]
            kc = chain_length(queue, i, chain)
            kind, rows, k = narrow(state, pod_row(xs, p), p, kc)
            for s in range(k):
                kinds[p + s], idxs[p + s] = kind, rows[s]
                if kind == KIND_FAIL:
                    nq.append(p + s)
            noslot |= kind == KIND_NO_SLOT
            n_narrow += 1
            if k > 1:
                chain_commits += 1
                chain_pods += k
            if wavefront:
                # further lanes only after a whole chain that opened no claim
                cont = k == kc and kind not in (KIND_NEW_CLAIM, KIND_NO_SLOT)
                extra, n_lanes, n_commit, n_pods, n_retry = narrow.wave(
                    state, xs, queue, i + k, chain, wavefront, cont, kinds, idxs, nq)
                k += extra
                hist[1 + n_lanes] += 1
                wave_commits += n_commit
                wave_pods += n_pods
                retry_lanes += n_retry
            i += k
        progress = len(nq) < len(queue)
        if score is not None:
            nq.sort(key=lambda row: -score[row])  # stable; -0.0 == 0.0
        queue = nq
        sweeps += 1
    return FFDResult(
        kind=torch.tensor(kinds, dtype=torch.int32, device=dev).reshape(P),
        index=torch.tensor(idxs, dtype=torch.int32, device=dev).reshape(P),
        state=state,
        iters=IterCounts(narrow=n_narrow, sweeps=sweeps, chain_commits=chain_commits, chain_pods=chain_pods,
                         wave_commits=wave_commits, wave_pods=wave_pods, retry_lanes=retry_lanes),
        wave_hist=torch.tensor(hist, dtype=torch.int32, device=dev) if wavefront else None,
    )


def solve_ffd_sweeps(problem: SchedulingProblem, max_claims: int, order_scores=None,
                     wavefront: Optional[int] = None, tables: Optional[dict] = None) -> FFDResult:
    """Run all retry sweeps of a solve from a fresh state: one ``ffd_loop``
    launch for CUDA tensors, the plain version for CPU tensors.
    ``order_scores`` as in ``sweeps_plain``; ``wavefront`` extra lanes, None
    for what ``KARPENTER_TPU_WAVEFRONT`` asks (``wavefront_lanes``);
    ``tables`` as in ``launch_ffd_loop``."""
    lanes = _lanes(wavefront)
    problem = _pad_lanes_mult32(problem)
    init = initial_state(problem, max_claims)
    if problem.lane_valid.is_cuda:
        return launch_ffd_loop(problem, init, one_pass=False, order_scores=order_scores, wavefront=lanes,
                               tables=tables)
    return sweeps_plain(problem, init, problem_bounds_free(problem), order_scores=order_scores, wavefront=lanes)


def solve_ffd_sweeps_carried(problem: SchedulingProblem, max_claims: int, init, order_scores=None,
                             wavefront: Optional[int] = None, tables: Optional[dict] = None) -> FFDResult:
    """The repair pass of the two-phase solve (ops/relax.py): ``init`` is
    (state, kind, index) from phase 1, ``problem.pod_active`` holds only the
    residue. The loop starts from phase 1's claim landscape, and phase 1's
    verdict rows ride through untouched because their pods are never stepped.
    One ``ffd_loop`` launch for CUDA tensors, the plain version for CPU
    tensors. ``max_claims`` must equal the carried state's claim axis.
    ``order_scores``, ``wavefront`` and ``tables`` as in ``solve_ffd_sweeps``."""
    lanes = _lanes(wavefront)
    state, kind0, index0 = init
    if state.claim_open.shape[0] != max_claims:
        raise ValueError(f"carried state has {state.claim_open.shape[0]} claim slots, not {max_claims}")
    problem, state = _lane_align(problem, state)
    if problem.lane_valid.is_cuda:
        return launch_ffd_loop(problem, state, one_pass=False, kind0=kind0, index0=index0,
                               order_scores=order_scores, wavefront=lanes, tables=tables)
    return sweeps_plain(problem, state, problem_bounds_free(problem), kind0, index0, order_scores, lanes)


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
    "host_lane", "kind0", "index0", "order_scores",
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
               "ok_t", "cap_t", "chain_c", "chain_v", "wave")
_FFD_POINTERS = _FFD_INPUTS + FFD_STATE + FFD_SCRATCH + ("kind", "index", "counters", "work", "sections", "plan",
                                                         "wave_hist")
_FFD_INTS = ("P", "K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G", "F", "CH", "one_pass",
             "wavefront", "cluster", "tslice", "resident", "smem")
_FfdArgs = kernels.make_struct("FfdArgs", _FFD_POINTERS, _FFD_INTS)

# the kernel's work counters (csrc/ffd_loop.cu WORK_*), in order
WORK_COUNTERS = ("bin_gates", "topo_lanes", "type_tests", "barriers", "cluster_barriers")
# the kernel's section counters (csrc/step.cuh SEC_*), in order: clock64
# cycles of the launch by section, for the split of its time
SECTIONS = ("group_prep", "bin_gates", "table", "first_survivor", "template", "chain", "fill", "round", "spread",
            "single", "commit", "record", "queue", "wave")


def section_split(sections, kernel_ms: float) -> dict:
    """{section: (share of the cycles, its ms: share x kernel_ms)} of one
    launch's section counters, the sections that counted any."""
    cycles = [int(x) for x in sections]
    total = sum(cycles) or 1
    return {name: (c / total, c / total * kernel_ms) for name, c in zip(SECTIONS, cycles) if c}

# rows of the chain commit's per-claim and per-lane scratch (csrc/chain.cuh
# NCS, NVS), one set per block of the cluster
_CHAIN_CLAIM_ROWS = 12
_CHAIN_LANE_ROWS = 2
# the loop's counters: IterCounts' seven fields
_N_COUNTERS = 7


def wave_scratch_words(lanes: int, G: int, C: int, N: int, K: int, W: int, T: int, blocks: int = 1) -> int:
    """int32 words of the wavefront's scratch (csrc/wave.cuh): each block's
    marks of the groups recorded into and the claims and nodes touched, and
    one slab per extra lane (4 scalars, the committed row's K x W lane words
    and its five K-rows, the claim's survivors and capacities over the T
    types). 0 with no lanes."""
    if lanes <= 0:
        return 0
    return blocks * (G + C + max(N, 1)) + lanes * (4 + K * W + 5 * K + 2 * T)


# -- the launch plan (csrc/ffd_loop.cu: the cluster, Carver, load_slice) -----

SMEM_OPTIN = 232448  # bytes of shared memory a block may opt into on an H100
SMEM_STATIC = 4096  # kept back for the kernel's static shared memory
DEFAULT_CLUSTER = 8  # blocks per solve of a launch of several: the portable cluster size
SOLO_CLUSTER = 16  # blocks of a launch's one solve: an H100's largest (non-portable) cluster
CARD_SMS = 132  # an H100 SXM's streaming multiprocessors

# the card tests' and the measurements' cluster size (``forced_cluster``);
# a context variable, so solves on other threads or in other contexts never
# see each other's setting
_cluster_override: contextvars.ContextVar = contextvars.ContextVar("ffd_loop_cluster", default=None)


class LoopPlan(NamedTuple):
    """One ``ffd_loop`` launch's shape: blocks per cluster, the instance types
    each block owns (block r: [r * tslice, (r + 1) * tslice)), whether each
    block's slice of the type tables lives in its shared memory, and the
    dynamic shared memory of a block in bytes."""

    cluster: int
    tslice: int
    resident: int
    smem: int


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def cluster_size(lanes: int = 1) -> int:
    """Blocks per solve for a launch of ``lanes`` solves of ``ffd_loop``
    or ``relax_place``: SOLO_CLUSTER for one (faster than 8 at the 10k shapes
    on an H100, PERF.md section 6); for several, the largest power of two no
    larger than DEFAULT_CLUSTER or CARD_SMS // lanes, and at least 1 (8 up
    to 16 lanes). ``forced_cluster`` overrides it."""
    forced = _cluster_override.get()
    return lanes_cluster(lanes) if forced is None else forced


def lanes_cluster(lanes: int) -> int:
    """``cluster_size`` without the override: the blocks a lane of a launch
    of ``lanes`` lanes takes by the card's SMs alone."""
    if lanes <= 1:
        return SOLO_CLUSTER
    cap = min(DEFAULT_CLUSTER, max(CARD_SMS // max(lanes, 1), 1))
    cl = 1
    while cl * 2 <= cap:
        cl *= 2
    return cl


@contextlib.contextmanager
def forced_cluster(cluster: int):
    """Launch every ``ffd_loop`` and ``relax_place`` planned in this
    context on clusters of ``cluster`` blocks (the card tests' and the
    measurements' cluster sizes)."""
    if not 1 <= cluster <= 64:
        raise ValueError(f"cluster size {cluster} out of range")
    token = _cluster_override.set(int(cluster))
    try:
        yield
    finally:
        _cluster_override.reset(token)


def type_slice(T: int, cluster: int) -> int:
    """Instance types a block owns: T over the cluster, rounded up to 16 (so
    every slice starts 16-byte aligned in each type table)."""
    return _a16(max(-(-T // cluster), 1))


def smem_bytes(dims: dict, cluster: int, resident: bool) -> int:
    """A block's dynamic shared memory (csrc/ffd_loop.cu loop_body's Carver):
    the step's arrays (group scratch and the matched-group list over G, the
    fresh claim's max capacity over R, the claims' reductions and candidate
    list over C, the templates' over TPL), then with ``resident`` the block's
    slice of the type tables and of the claims' survivors, the chain head's
    survivors and their capacities; each array 16-byte aligned."""
    G, R, C, TPL = dims["G"], dims["R"], dims["C"], dims["TPL"]
    K, W, O = dims["K"], dims["W"], dims["O"]
    nt = type_slice(dims["T"], cluster)
    total = 5 * _a16(4 * G) + _a16(4) + _a16(4 * R) + 4 * _a16(4 * C) + 2 * _a16(4 * TPL)
    if resident:
        total += (_a16(4 * nt * K * W) + 2 * _a16(4 * nt * K) + 2 * _a16(4 * nt * R) + 2 * _a16(4 * nt * O)
                  + 3 * _a16(nt * K) + _a16(nt * O) + _a16(TPL * nt) + 3 * _a16(C * nt))
    return total


def loop_plan(dims: dict, cluster: Optional[int] = None) -> LoopPlan:
    """The plan of a launch over a problem of ``dims`` (the FfdArgs dims):
    the cluster (``cluster``, else ``cluster_size()``), the slice, and
    resident when the resident layout fits what a block may opt into (less
    the static shared memory); otherwise the same kernel reads the type
    tables from device memory. No shape is refused here: a layout the card
    cannot hold fails at the launch."""
    cl = cluster_size() if cluster is None else int(cluster)
    full = smem_bytes(dims, cl, True)
    resident = full <= SMEM_OPTIN - SMEM_STATIC
    return LoopPlan(cl, type_slice(dims["T"], cl), int(resident), full if resident else smem_bytes(dims, cl, False))


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
                    kind0=None, index0=None, order_scores=None, wavefront: int = 0,
                    tables: Optional[dict] = None) -> FFDResult:
    """Run the ``ffd_loop`` kernel on CUDA tensors: the requeue loop, or with
    ``one_pass`` a single scan over every row (the backend's per-pass mode).
    ``kind0``/``index0`` (i32[P], both or neither) seed the verdict rows, as
    in ``sweeps_plain``. ``init`` is not modified. The kernel evaluates the
    general (bounded) arm of the mask algebra, which equals the bounds-free
    arm on problems without Gt/Lt bounds, so there is no separate bounds-free
    kernel path. ``order_scores`` (f32[P]) sorts each sweep's requeue;
    ``wavefront`` extra lanes follow each narrow iteration (csrc/wave.cuh;
    not in the one-pass mode). The result carries the problem's tables as
    the launch read them (``FFDResult.tables``), for the solve's later
    launches over the same problem (the gate, the explain pass).
    ``tables``: the problem's ``problem_tensors`` where the caller built them
    already (the learned order's scorer reads them first); the launch reads
    its ``pod_active`` from ``problem``."""
    dev = problem.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_ffd_loop needs CUDA tensors")
    if tables is None:
        tables = problem_tensors(problem)
    else:
        check_tables(tables, problem.num_pods, problem.num_instance_types, problem.num_keys, problem.num_lanes)
        tables = dict(tables, pod_active=_i32(problem.pod_active))
    t, args = ffd_loop_args(problem, init, one_pass, kind0, index0, order_scores, wavefront, tables=tables)
    kernels.launch("ffd_loop", args, torch.cuda.current_stream(dev).cuda_stream, counter=loop_counter(args))
    return dataclasses.replace(result_of(t, problem.num_lanes, one_pass), tables=tables)


def loop_counter(args) -> str:
    """The kernels.LAUNCHES entry a single-lane ``ffd_loop`` launch counts
    under: ``ffd_loop_wavefront`` with the wavefront on."""
    return "ffd_loop_wavefront" if args.wavefront else "ffd_loop"


def result_of(t: dict, V: int, one_pass: bool = False) -> FFDResult:
    """The FFDResult of a finished launch's tensors ``t`` (ffd_loop_args)."""
    iters: Optional[IterCounts] = None
    if not one_pass:
        iters = IterCounts(*t["counters"])
    return FFDResult(kind=t["kind"], index=t["index"], state=state_back(t, V), iters=iters, work=t["work"],
                     wave_hist=t["wave_hist"])


# the lanes mode's launch struct (csrc/ffd_loop.cu FfdLanesArgs): the device
# array of per-lane FfdArgs, the lane count, the blocks per lane and the
# widest lane's dynamic shared memory
_FFD_LANES_INTS = ("L", "cluster", "smem")
_FfdLanesArgs = kernels.make_struct("FfdLanesArgs", ("lanes",), _FFD_LANES_INTS)


def lane_structs(structs: Sequence, dev) -> torch.Tensor:
    """The argument structs of the lanes, in order, copied into one device
    buffer (the array a lanes-mode kernel's block b reads entry b of)."""
    raw = b"".join(bytes(a) for a in structs)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)


def ffd_loop_lanes_args(problems: Sequence[SchedulingProblem], inits: Sequence[FFDState],
                        kind0s=None, index0s=None, wavefront: int = 0):
    """One ``ffd_loop_args`` per lane (fresh, or seeded with ``kind0s`` /
    ``index0s``, one i32[P] each), their structs in one device buffer, and
    the lanes-mode struct: (per-lane tensors, buffer, struct). Every lane
    must have the same G and R (one vocabulary, one bucket)."""
    if not problems or len(problems) != len(inits):
        raise ValueError("the lanes mode needs one initial state per lane, and at least one lane")
    if (kind0s is None) != (index0s is None):
        raise ValueError("kind0s and index0s seed the verdict rows together")
    cluster = cluster_size(len(problems))
    lanes = [ffd_loop_args(p, init, False,
                           None if kind0s is None else kind0s[b], None if index0s is None else index0s[b],
                           wavefront=wavefront, cluster=cluster)
             for b, (p, init) in enumerate(zip(problems, inits))]
    dims = {(a.G, a.R) for _, a in lanes}
    if len(dims) != 1:
        raise ValueError(f"the lanes differ in their topology groups or resources: {sorted(dims)}")
    smem = max(a.smem for _, a in lanes)
    for _, a in lanes:
        a.smem = smem
    buf = lane_structs([a for _, a in lanes], problems[0].lane_valid.device)
    args = _FfdLanesArgs(lanes=buf.data_ptr(), L=len(lanes), cluster=cluster, smem=smem)
    return [t for t, _ in lanes], buf, args


def launch_ffd_loop_lanes(problems: Sequence[SchedulingProblem], inits: Sequence[FFDState],
                          kind0s=None, index0s=None, wavefront: int = 0) -> List[FFDResult]:
    """Run the ``ffd_loop`` kernel's lanes mode on CUDA tensors: lane b's
    requeue loop from ``inits[b]`` over ``problems[b]`` (seeded like
    ``solve_ffd_sweeps_carried`` when ``kind0s``/``index0s`` are given), all
    lanes in one launch, grid L, each with ``wavefront`` extra lanes an
    iteration. One FFDResult per lane; counted as ``ffd_loop_lanes`` in
    kernels.LAUNCHES."""
    dev = problems[0].lane_valid.device if problems else None
    if dev is None or dev.type != "cuda":
        raise ValueError("launch_ffd_loop_lanes needs CUDA tensors")
    # the struct buffer may be freed once the launch is queued: the caching
    # allocator hands its memory out again only in stream order
    ts, _buf, args = ffd_loop_lanes_args(problems, inits, kind0s, index0s, wavefront)
    kernels.launch("ffd_loop_lanes", args, torch.cuda.current_stream(dev).cuda_stream)
    return [result_of(t, p.num_lanes) for t, p in zip(ts, problems)]


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


def check_tables(tables: dict, P: int, T: int, K: int, V: int) -> None:
    """Raise unless ``tables`` (a ``problem_tensors`` dict handed to a
    launch's argument build) has ``P`` pod rows and ``T`` type rows over ``K``
    keys of ``V`` lanes: the tables of the problem the launch reads."""
    got = (tables["pod_adm"].shape[0], tables["it_adm"].shape[0], tuple(tables["lvw"].shape))
    if got != (P, T, (K, V // 32)):
        raise ValueError(f"the tables hold (pods, types, lane words) {got}, not {(P, T, (K, V // 32))}")


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


def state_tensors(init: FFDState, lv, ln, prefix: str = "", copy: bool = True) -> dict:
    """A copy of the carried state in the kernels' layout (packed requirement
    rows), by struct field name with ``prefix``; without ``copy``, the
    leaves that need no conversion are the state's own tensors (a launch that
    only reads the state)."""
    t: dict = {}
    for side, r in (("claim", init.claim_req), ("node", init.node_req)):
        if copy:
            _req_tensors(side, r, lv, ln, t, state=True)
            continue
        t[side + "_adm"] = masks.pack_lanes(r.admitted).contiguous()
        for name, src in (("_comp", r.comp), ("_def", r.defined), ("_gt", r.gt), ("_lt", r.lt)):
            t[side + name] = (src.to(torch.int32) if name in ("_gt", "_lt") else src).contiguous()
    for name, leaf in _STATE_LEAVES:
        src = getattr(init, leaf)
        t[name] = src.clone().contiguous() if copy else src.contiguous()
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


def ffd_loop_args(problem: SchedulingProblem, init: FFDState, one_pass: bool, kind0=None, index0=None,
                  order_scores=None, wavefront: int = 0, cluster: Optional[int] = None,
                  tables: Optional[dict] = None):
    """The kernel's tensors by struct field name (inputs in its layout, a
    copy of the carried state to update in place, scratch, outputs) and its
    argument struct: one launch's worth, as ``launch_ffd_loop`` passes it,
    planned for clusters of ``cluster`` blocks (else ``cluster_size()``).
    ``tables``: the problem's ``problem_tensors``, where the caller has them."""
    t = dict(tables) if tables is not None else problem_tensors(problem)
    # the carried state, copied into the kernel's layout (updated in place)
    t.update(state_tensors(init, problem.lane_valid, problem.lane_numeric))
    return loop_args_from(t, one_pass, kind0, index0, order_scores, wavefront, cluster)


def loop_args_from(tensors: dict, one_pass: bool, kind0=None, index0=None, order_scores=None,
                   wavefront: int = 0, cluster: Optional[int] = None):
    """``ffd_loop_args`` over tables already in the kernel's layout: the
    problem's (``problem_tensors``, or a device-resident world holding them,
    ops/fused.py) and a state the launch may update in place
    (``state_tensors``), by struct field name. Adds scratch and outputs to a
    copy of ``tensors``; the dimensions are read from the tables' shapes and
    the launch's plan from them and ``cluster`` (``loop_plan``)."""
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
    dims = dict(P=P, K=K, V=V, W=W, C=C, N=N, T=T, TPL=TPL, R=R,
                O=t["offer_ok"].shape[1], PT=t["pod_ports"].shape[1],
                D=t["pod_vols"].shape[1], G=G, F=F, CH=t["host_lane"].shape[0])
    plan = loop_plan(dims, cluster)
    CL = plan.cluster
    t["bin_ok"] = torch.zeros((B,), dtype=torch.bool, device=dev)
    t["queue"] = torch.empty((CL, 2 * P), dtype=i32, device=dev)
    t["kind"] = torch.empty((P,), dtype=i32, device=dev)
    t["index"] = torch.empty((P,), dtype=i32, device=dev)
    if (kind0 is None) != (index0 is None):
        raise ValueError("kind0 and index0 seed the verdict rows together")
    for name, seed in (("kind0", kind0), ("index0", index0)):
        if seed is not None and (seed.shape != (P,) or seed.device != dev):
            raise ValueError(f"{name} must be i32[{P}] on {dev}")
        t[name] = None if seed is None else seed.to(i32).contiguous()
    if order_scores is not None and (order_scores.shape != (P,) or order_scores.device != dev):
        raise ValueError(f"order_scores must be f32[{P}] on {dev}")
    t["order_scores"] = None if order_scores is None else order_scores.to(torch.float32).contiguous()
    t["ok_t"] = torch.empty((C, T), dtype=torch.bool, device=dev)
    t["cap_t"] = torch.empty((C, T), dtype=torch.uint8, device=dev)
    t["chain_c"] = torch.empty((CL, _CHAIN_CLAIM_ROWS, C), dtype=i32, device=dev)
    t["chain_v"] = torch.empty((CL, _CHAIN_LANE_ROWS, V), dtype=i32, device=dev)
    t["counters"] = torch.zeros((_N_COUNTERS,), dtype=i32, device=dev)
    t["work"] = torch.zeros((len(WORK_COUNTERS),), dtype=torch.int64, device=dev)
    t["sections"] = torch.zeros((len(SECTIONS),), dtype=torch.int64, device=dev)
    t["plan"] = torch.zeros((3,), dtype=i32, device=dev)
    if one_pass or wavefront < 0:
        wavefront = 0  # the one-pass mode has no wavefront, as in the JAX package
    words = wave_scratch_words(wavefront, G, C, N, K, W, T, CL)
    t["wave"] = torch.empty((words,), dtype=i32, device=dev) if words else None
    t["wave_hist"] = torch.zeros((wavefront + 2,), dtype=i32, device=dev) if wavefront else None

    args = _FfdArgs(**{name: (t[name].data_ptr() if t[name] is not None else None) for name in _FFD_POINTERS},
                    **dims, one_pass=int(one_pass), wavefront=int(wavefront), **plan._asdict())
    return t, args
