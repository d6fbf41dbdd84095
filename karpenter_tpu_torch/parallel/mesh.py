"""The consolidation screens: one run-compressed scan per candidate lane.

Plain PyTorch and CUDA counterparts of the JAX package's
``parallel/mesh.py`` screens (``lean_screen`` :269 over ``_lean_screen_jit``
:232, ``residual_screen`` :360 over ``_residual_screen_jit`` :321). Every
lane solves the same shared union problem with a few arrays varied
(``ScreenVariants`` / ``ResidualVariants``); lanes are independent.

  * the full screen (``lean_screen``) starts each lane from the problem's
    initial state with the lane's topology census, and runs up to ``passes``
    placement passes: after each pass the placed rows leave ``pod_active``
    and kind/index keep their first placement;
  * the residual screen (``residual_screen``) starts every lane from one
    carried base-world state and runs one pass over a shared trim of the run
    axis (``run_idx``, -1 entries are no-op runs).

On CUDA tensors both launch the ``runs_screen`` kernel
(csrc/runs_screen.cu): all lanes in one launch, laid out by ``screen_plan``
(a cluster per lane for few lanes of many rows, else a block per lane), the
heaviest lanes first. On CPU tensors they run ``lean_screen_plain`` /
``residual_screen_plain``, which loop ``ops/ffd_runs.runs_scan_plain`` over
the lanes. There is no fallback
between the two. There is no mesh here: one card scores every lane.

The batched programs (``batched_solve`` :129 over ``_batched_solve_jit`` :88,
``batched_screen`` :184 over ``_batched_screen_jit`` :154) solve B whole,
independent problems stacked on a leading axis (``stack_problems``), each
lane from its own initial state: one pass, or up to ``passes`` with the
first placement kept. The serve layer's cross-tenant stacking
(serve/batch.py) runs them. On CUDA tensors they launch the same kernel in
its stacked mode (every problem table and the start state offset per lane
too); on CPU tensors ``batched_solve_plain`` / ``batched_screen_plain`` loop
the runs scan over the lanes.

The partitioned solve's programs (shard/solve.py, ``KARPENTER_TPU_SHARD``):
``shard_sweeps`` (program 13, the JAX package's ``shard_sweeps_program``
:468) and ``shard_relax2_sweeps`` (program 14, ``shard_relax2_sweeps_program``
:517) run every partition of a stacked batch as one lane of a grid, one
cluster each: ``ffd_loop`` in its lanes mode, after ``relax_place``'s convex
lanes mode for program 14. Each lane exits its loop when it converges,
which is ``shard_map``'s per-device semantics (the JAX package's vmap
lockstep gives the same per-lane results). ``healthy_devices`` and
``default_mesh`` give the device list the JAX package carves its mesh from;
the lanes all run on the solver's device. ``carve_meshes`` carves the
CUDA devices into the serve replicas' slices (serve/replica.py).

Each screen and stacked dispatch (``lean_screen``, ``residual_screen``,
``batched_screen``, ``batched_solve``) is recorded in the program registry
(obs/programs.py) under the JAX package's program name, as its
counterparts are; like them it is not counted in
``solver_compile_cache_total``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import RUN_ANALYTIC, SchedulingProblem
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_FAIL,
    FFDResult,
    FFDState,
    _lane_align,
    _pad_lanes_mult32,
    initial_state,
    problem_bounds_free,
)
from karpenter_tpu_torch.ops.ffd_runs import check_run_modes, has_topo_runs, max_run_bucket, runs_scan_plain
from karpenter_tpu_torch.ops.ffd_sweeps import (
    CARD_SMS,
    FFD_STATE,
    _FFD_INPUTS,
    WORK_COUNTERS,
    lanes_cluster,
    launch_ffd_loop_lanes,
    problem_tensors,
    state_back,
    state_tensors,
    sweeps_plain,
)


@dataclasses.dataclass
class ScreenVariants:
    """The four arrays a full-screen lane changes on the shared union
    problem, each with a leading lane axis [B, ...]."""

    node_avail: torch.Tensor  # f32[B, N, R] (deleted nodes: -1)
    pod_active: torch.Tensor  # bool[B, P]
    grp_counts0: torch.Tensor  # i32[B, G, V]
    grp_registered0: torch.Tensor  # bool[B, G, V]


@dataclasses.dataclass
class ResidualVariants:
    """The two arrays a residual-screen lane changes: its deleted node rows
    and its resident pod rows. The topology census is the base world's: the
    residual path stands down whenever any pod consults it."""

    node_avail: torch.Tensor  # f32[B, N, R]
    pod_active: torch.Tensor  # bool[B, P]


def trim_runs(base: SchedulingProblem, run_idx) -> SchedulingProblem:
    """``base`` with its run axis gathered at ``run_idx``; -1 entries are the
    (start 0, length 0, analytic) no-op run."""
    run_idx = torch.as_tensor(run_idx, dtype=torch.int64, device=base.run_start.device)
    valid = run_idx >= 0
    ridx = torch.where(valid, run_idx, 0)
    return dataclasses.replace(
        base,
        run_start=base.run_start[ridx],
        run_len=torch.where(valid, base.run_len[ridx], 0).to(base.run_len.dtype),
        run_mode=torch.where(valid, base.run_mode[ridx], RUN_ANALYTIC).to(base.run_mode.dtype),
    )


def _stack_results(results: Sequence[FFDResult]) -> FFDResult:
    return FFDResult(
        kind=torch.stack([r.kind for r in results]),
        index=torch.stack([r.index for r in results]),
        state=_map_leaves(lambda *xs: torch.stack(xs), *[r.state for r in results]),
    )


def _lanes(B: int, lanes: Optional[Sequence[int]]):
    return range(B) if lanes is None else list(lanes)


def _multi_pass_plain(p: SchedulingProblem, max_claims: int, passes: int, max_run: int,
                      with_topo: bool) -> FFDResult:
    """One lane's runs scan from its initial state, then up to ``passes - 1``
    more over the rows still unplaced, carrying the state; kind/index keep
    each row's first placement."""
    r = runs_scan_plain(p, initial_state(p, max_claims), max_run, with_topo)
    kind, index = r.kind, r.index
    for _ in range(passes - 1):
        placed = kind < KIND_FAIL
        r = runs_scan_plain(dataclasses.replace(p, pod_active=p.pod_active & ~placed), r.state,
                            max_run, with_topo)
        kind = torch.where(placed, kind, r.kind)
        index = torch.where(placed, index, r.index)
    return FFDResult(kind=kind, index=index, state=r.state)


def lean_screen_plain(base: SchedulingProblem, variants: ScreenVariants, max_claims: int,
                      passes: int = 3, lanes: Optional[Sequence[int]] = None) -> FFDResult:
    """Plain PyTorch full screen: the multi-pass runs scan of each lane in
    ``lanes`` (default all), stacked on a leading lane axis."""
    base = _pad_lanes_mult32(base)
    max_run, with_topo = max_run_bucket(base), has_topo_runs(base)
    out = []
    for b in _lanes(variants.pod_active.shape[0], lanes):
        p = dataclasses.replace(
            base, node_avail=variants.node_avail[b], pod_active=variants.pod_active[b],
            grp_counts0=variants.grp_counts0[b], grp_registered0=variants.grp_registered0[b],
        )
        out.append(_multi_pass_plain(p, max_claims, passes, max_run, with_topo))
    return _stack_results(out)


def residual_screen_plain(base: SchedulingProblem, carried: FFDState, variants: ResidualVariants,
                          run_idx, max_claims: int, lanes: Optional[Sequence[int]] = None) -> FFDResult:
    """Plain PyTorch residual screen: each lane's one pass over the shared
    run trim from the carried base world, stacked on a leading lane axis."""
    base = _pad_lanes_mult32(base)
    max_run = max_run_bucket(base)
    p0 = trim_runs(base, run_idx)
    check_run_modes(p0, with_topo=False)
    out = []
    for b in _lanes(variants.pod_active.shape[0], lanes):
        p = dataclasses.replace(p0, node_avail=variants.node_avail[b], pod_active=variants.pod_active[b])
        out.append(runs_scan_plain(p, carried, max_run, with_topo=False))
    return _stack_results(out)


def lean_screen(base: SchedulingProblem, variants: ScreenVariants, max_claims: int,
                passes: int = 3) -> FFDResult:
    """The full consolidation screen over a shared base problem and per-lane
    variant arrays: one ``runs_screen`` launch on CUDA tensors, the plain
    version on CPU tensors. Results carry a leading lane axis."""
    base = _pad_lanes_mult32(base)
    max_run, with_topo = max_run_bucket(base), has_topo_runs(base)
    with _dispatch("lean_screen", max_claims, (base, variants),
                   {"passes": passes, "max_run": max_run, "with_topo": with_topo}):
        if base.lane_valid.is_cuda:
            return launch_runs_screen(
                base, initial_state(base, max_claims), variants.node_avail, variants.pod_active,
                max_run=max_run, passes=passes, with_topo=with_topo,
                grp_counts0=variants.grp_counts0, grp_registered0=variants.grp_registered0,
            )
        return lean_screen_plain(base, variants, max_claims, passes)


def residual_screen(base: SchedulingProblem, carried: FFDState, variants: ResidualVariants,
                    run_idx, max_claims: int) -> FFDResult:
    """The incremental consolidation screen: every lane re-solves only its
    resident rows, over the shared run trim, from the shared carried base
    world. The trimmed runs must hold no RUN_TOPO run (the caller's batch
    standdown rejects topology first); one is an error, not a clamp."""
    base = _pad_lanes_mult32(base)
    if carried.claim_open.shape[0] != max_claims:
        raise ValueError(f"carried state has {carried.claim_open.shape[0]} claim slots, not {max_claims}")
    with _dispatch("residual_screen", max_claims, (base, carried, variants, run_idx),
                   {"max_run": max_run_bucket(base), "with_topo": False}):
        if base.lane_valid.is_cuda:
            p0 = trim_runs(base, run_idx)
            return launch_runs_screen(
                p0, carried, variants.node_avail, variants.pod_active,
                max_run=max_run_bucket(base), passes=1, with_topo=False,
            )
        return residual_screen_plain(base, carried, variants, run_idx, max_claims)


@contextlib.contextmanager
def _dispatch(name: str, max_claims: int, tree, statics: dict):
    """One screen or stacked dispatch in the program registry (off: one
    flag check)."""
    from karpenter_tpu_torch.obs import programs
    from karpenter_tpu_torch.verify.gate import _nbytes

    obs = programs.begin_dispatch(name, max_claims, tree, statics=statics, kernel="runs_screen")
    yield
    if obs is not None:
        obs.finish(problem_bytes=_nbytes(tree))


# -- the batched programs: B whole problems, one per lane ---------------------


def _map_leaves(fn, *trees):
    """``fn`` over the matching leaves of dataclass trees (ReqTensor
    included); None leaves stay None."""
    first = trees[0]
    kwargs = {}
    for f in dataclasses.fields(first):
        values = [getattr(t, f.name) for t in trees]
        if values[0] is None:
            kwargs[f.name] = None
        elif dataclasses.is_dataclass(values[0]):
            kwargs[f.name] = _map_leaves(fn, *values)
        else:
            kwargs[f.name] = fn(*values)
    return type(first)(**kwargs)


def stack_problems(problems: Sequence[SchedulingProblem]) -> SchedulingProblem:
    """Stack identically-shaped problems along a new leading lane axis (the
    JAX package's ``stack_problems``). Host (numpy) problems stack into a
    host problem, torch problems into torch tensors; callers pad
    (ops/padding.py) to a common bucket first."""

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return _map_leaves(stack, *problems)


def lane_problem(batch: SchedulingProblem, b: int) -> SchedulingProblem:
    """Lane ``b`` of a stacked problem."""
    return _map_leaves(lambda x: x[b], batch)


def batched_screen_plain(batch: SchedulingProblem, max_claims: int, passes: int = 3,
                         lanes: Optional[Sequence[int]] = None) -> FFDResult:
    """Plain PyTorch batched screen: each lane in ``lanes`` (default all) of
    the stacked problem from its own initial state, up to ``passes`` passes
    with the first placement kept, stacked on a leading lane axis. The run
    window and the topology commit are taken over the whole stack, as the
    JAX package takes them."""
    max_run, with_topo = max_run_bucket(batch), has_topo_runs(batch)
    out = [
        _multi_pass_plain(_pad_lanes_mult32(lane_problem(batch, b)), max_claims, passes, max_run, with_topo)
        for b in _lanes(batch.pod_active.shape[0], lanes)
    ]
    return _stack_results(out)


def batched_solve_plain(batch: SchedulingProblem, max_claims: int,
                        lanes: Optional[Sequence[int]] = None) -> FFDResult:
    """Plain PyTorch batched solve: ``batched_screen_plain`` with one pass."""
    return batched_screen_plain(batch, max_claims, passes=1, lanes=lanes)


def batched_screen(batch: SchedulingProblem, max_claims: int, passes: int = 3) -> FFDResult:
    """Solve B independent stacked problems, each from its own initial state,
    with up to ``passes`` placement passes (after each pass the placed rows
    leave ``pod_active``; kind/index keep the first placement): one
    ``runs_screen`` launch in its stacked mode on CUDA tensors, the plain
    version on CPU tensors. Results carry a leading lane axis."""
    return _batched("batched_screen", batch, max_claims, passes)


def batched_solve(batch: SchedulingProblem, max_claims: int, passes: int = 1) -> FFDResult:
    """The JAX package's ``batched_solve``: ``batched_screen`` with one pass
    by default."""
    return _batched("batched_solve", batch, max_claims, passes)


def _batched(name: str, batch: SchedulingProblem, max_claims: int, passes: int) -> FFDResult:
    if passes < 1:
        raise ValueError("passes must be >= 1")
    statics = {"max_run": max_run_bucket(batch), "with_topo": has_topo_runs(batch)}
    if name == "batched_screen":
        statics["passes"] = passes
    with _dispatch(name, max_claims, batch, statics):
        if batch.lane_valid.is_cuda:
            return launch_stacked_screen(batch, max_claims, passes=passes)
        return batched_screen_plain(batch, max_claims, passes)


# -- the partitioned solve (KARPENTER_TPU_SHARD, shard/) ----------------------


def healthy_devices(device=None) -> list:
    """The devices the partitioned solve counts (the JAX package's
    ``healthy_devices``): every CUDA device, or a CPU solver's own device
    (solver/mesh_health.local_devices), minus whatever the mesh-health
    tracker excludes when ``KARPENTER_TPU_MESH_HEALTH`` is on."""
    from karpenter_tpu_torch.solver import mesh_health

    devices = mesh_health.local_devices(device)
    if mesh_health.enabled() and mesh_health.has_tracker():
        devices = mesh_health.tracker().healthy_devices(devices)
    return list(devices)


def default_mesh(min_devices: int = 2, device=None) -> Optional[list]:
    """The healthy devices (``healthy_devices(device)``), or None below
    ``min_devices``. There is no device mesh object: the partitioned solve
    runs its lanes as blocks of one launch on the solver's device, and the
    list sets the default partition count and the ``single-device``
    standdown, as the JAX package's mesh does."""
    devices = healthy_devices(device)
    if len(devices) < min_devices:
        return None
    return devices


def carve_meshes(n_slices: int, devices=None) -> list:
    """Carve the devices (default ``healthy_devices()``: every healthy CUDA
    device) into ``n_slices`` contiguous slices, one per serve replica
    (serve/replica.py), as the JAX package carves its meshes: sorted by
    index, balanced, the remainder devices to the first slices (slice 0 is
    the largest, the big-tenant home), and None for a slice of fewer than 2
    devices. A slice is a list of devices; its replica runs on the first."""
    from karpenter_tpu_torch.solver.mesh_health import device_id

    if devices is None:
        devices = healthy_devices()
    devices = sorted(devices, key=device_id)
    n_slices = max(1, int(n_slices))
    base, extra = divmod(len(devices), n_slices)
    out = []
    start = 0
    for i in range(n_slices):
        size = base + (1 if i < extra else 0)
        chunk = devices[start:start + size]
        start += size
        out.append(list(chunk) if len(chunk) >= 2 else None)
    return out


def _shard_lanes(batch: SchedulingProblem) -> list:
    return [_pad_lanes_mult32(lane_problem(batch, b)) for b in range(batch.pod_active.shape[0])]


def shard_sweeps_plain(batch: SchedulingProblem, max_claims: int,
                       lanes: Optional[Sequence[int]] = None, wavefront: int = 0) -> list:
    """Plain PyTorch program 13: the fresh sweeps of each lane in ``lanes``
    (default all) from its own initial state, in the arm of the whole
    stack's ``problem_bounds_free``, one FFDResult per lane; ``wavefront``
    extra lanes an iteration (ops/ffd_sweeps.wavefront_lanes)."""
    bounds_free = problem_bounds_free(batch)
    out = []
    for b in _lanes(batch.pod_active.shape[0], lanes):
        p = _pad_lanes_mult32(lane_problem(batch, b))
        out.append(sweeps_plain(p, initial_state(p, max_claims), bounds_free, wavefront=wavefront))
    return out


def shard_sweeps(batch: SchedulingProblem, max_claims: int, wavefront: int = 0) -> list:
    """Program 13 (the JAX package's ``shard_sweeps_program``): every lane of
    the stacked batch runs its own requeue loop from a fresh state to its own
    convergence. One ``ffd_loop`` launch in its lanes mode (one cluster of
    blocks per lane) on CUDA tensors, ``shard_sweeps_plain`` on CPU tensors. One
    FFDResult per lane, in lane order; ``wavefront`` as in
    ``shard_sweeps_plain``."""
    if batch.lane_valid.is_cuda:
        problems = _shard_lanes(batch)
        return launch_ffd_loop_lanes(problems, [initial_state(p, max_claims) for p in problems],
                                     wavefront=wavefront)
    return shard_sweeps_plain(batch, max_claims, wavefront=wavefront)


def shard_relax2_sweeps_plain(batch: SchedulingProblem, max_claims: int, iters: int, step: float,
                              lanes: Optional[Sequence[int]] = None, wavefront: int = 0):
    """Plain PyTorch program 14: per lane in ``lanes`` (default all) the
    convex phase 1, then the carried repair of its residue from phase 1's
    (state, kind, index). Returns (one FFDResult per lane, one Relax2Stats
    per lane)."""
    from karpenter_tpu_torch.ops.relax2 import relax2_place_plain

    bounds_free = problem_bounds_free(batch)
    results, stats = [], []
    for b in _lanes(batch.pod_active.shape[0], lanes):
        p = _pad_lanes_mult32(lane_problem(batch, b))
        r = relax2_place_plain(p, max_claims, iters, step)
        residue, state = _lane_align(dataclasses.replace(p, pod_active=r.residue_active), r.state)
        results.append(sweeps_plain(residue, state, bounds_free, r.kind, r.index, wavefront=wavefront))
        stats.append(r.stats)
    return results, stats


def shard_relax2_sweeps(batch: SchedulingProblem, max_claims: int, iters: int, step: float,
                        wavefront: int = 0):
    """Program 14 (the JAX package's ``shard_relax2_sweeps_program``): per
    lane the convex phase 1, then the carried sweeps repair from its
    (state, kind, index) with ``pod_active = residue_active``, and per-lane
    Relax2Stats. On CUDA tensors two launches: ``relax_place`` in its convex
    lanes mode, then ``ffd_loop`` in its lanes mode seeded with phase 1's
    verdicts; ``shard_relax2_sweeps_plain`` on CPU tensors. The repair runs
    ``wavefront`` extra lanes an iteration."""
    if not batch.lane_valid.is_cuda:
        return shard_relax2_sweeps_plain(batch, max_claims, iters, step, wavefront=wavefront)
    from karpenter_tpu_torch.ops.relax2 import launch_relax2_place_lanes

    problems = _shard_lanes(batch)
    outs = launch_relax2_place_lanes(problems, max_claims, iters, step)
    residues, states = zip(*(_lane_align(dataclasses.replace(p, pod_active=o.residue_active), o.state)
                             for p, o in zip(problems, outs)))
    results = launch_ffd_loop_lanes(list(residues), list(states), [o.kind for o in outs], [o.index for o in outs],
                                    wavefront)
    return results, [o.stats for o in outs]


# -- the runs_screen kernel's argument struct (csrc/runs_screen.cu RunsArgs) --

# the shared problem: the ffd_loop tables less the per-lane and seed arrays,
# plus the run axis
_RS_SHARED = tuple(
    n for n in _FFD_INPUTS
    if n not in ("pod_active", "pod_eqprev_chain", "node_avail", "kind0", "index0", "order_scores")
) + (
    "run_start", "run_len", "run_mode",
)
# the state every lane starts from (read only)
RS_INIT = tuple("init_" + n for n in FFD_STATE)
# per-lane inputs: deleted node rows, active rows (a working copy the passes
# update), and in full mode the lane's topology census
RS_LANE_INPUTS = ("node_avail", "pod_active", "lane_grp_counts0", "lane_grp_registered0")
# per-lane state, written by the kernel
RS_STATE = FFD_STATE
# per-lane working rows, neither read before nor kept after a launch
RS_SCRATCH = ("fin_adm", "fin_comp", "fin_def", "fin_gt", "fin_lt", "fin_neg", "bin_ok",
              "ok_t", "cap_t", "node_cap", "node_taken")
_RS_POINTERS = (_RS_SHARED + RS_INIT + RS_LANE_INPUTS + RS_STATE + RS_SCRATCH
                + ("kind", "index", "work", "sections", "order", "plan"))
_RS_INTS = ("P", "K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G", "F", "CH",
            "B", "RN", "MR", "passes", "stacked", "layout", "cluster")
_RunsArgs = kernels.make_struct("RunsArgs", _RS_POINTERS, _RS_INTS)

# the kernel's per-lane work counters (csrc/runs_screen.cu), in order: the
# step's four, then runs committed by mode and pods by route
RS_WORK_COUNTERS = WORK_COUNTERS + ("runs_single", "runs_analytic", "runs_topo", "pods_stepped", "pods_analytic")
# each lane's clock by section (csrc/runs_screen.cu RS_SEC_*), in order
RS_SECTIONS = ("init", "single", "analytic_nodes", "analytic_claims", "analytic_templates", "analytic_rows",
               "analytic_records", "topology", "pass")


# -- the launch plan (csrc/runs_screen.cu LAYOUT_*) -----------------------------

# the kernel's layouts, by their LAYOUT_* number: a 512-thread block per
# lane, a cluster of 512-thread blocks per lane
SCREEN_LAYOUTS = ("block", "cluster")
# the rows a lane needs for a cluster to pay for its barriers (~0.6 us each,
# against ~40 ns for a block's): on an H100 the serve layer's 8 lanes of
# 1,280 rows ran 5% faster on clusters of 8 than on blocks, its 8 lanes of
# 64 rows 33% slower (PERF.md section 5)
SCREEN_CLUSTER_ROWS = 512


class ScreenPlan(NamedTuple):
    """One ``runs_screen`` launch's layout (a SCREEN_LAYOUTS name) and its
    blocks per lane."""

    layout: str
    cluster: int


# the card tests' and the measurements' layout (``forced_screen_plan``); a
# context variable, as ffd_sweeps' cluster override
_plan_override: contextvars.ContextVar = contextvars.ContextVar("runs_screen_plan", default=None)


def screen_plan(lanes: int, rows: int) -> ScreenPlan:
    """The layout of a launch of ``lanes`` lanes of ``rows`` rows each on an
    H100 (CARD_SMS SMs): with at most half as many lanes as SMs and at least
    SCREEN_CLUSTER_ROWS rows, a cluster per lane of the largest power of two
    no larger than DEFAULT_CLUSTER (8) or CARD_SMS // lanes blocks (the serve
    layer's 8 wide lanes: 8); otherwise a 512-thread block per lane (the
    screen's 320 lanes). ``forced_screen_plan`` overrides it."""
    forced = _plan_override.get()
    if forced is not None:
        return forced
    if 2 * lanes <= CARD_SMS and rows >= SCREEN_CLUSTER_ROWS:
        return ScreenPlan("cluster", lanes_cluster(max(lanes, 2)))
    return ScreenPlan("block", 1)


@contextlib.contextmanager
def forced_screen_plan(layout: str, cluster: int = 1):
    """Launch every ``runs_screen`` planned in this context in ``layout``
    with ``cluster`` blocks per lane (1 unless the layout is "cluster"):
    the card tests' and the measurements' layouts."""
    if layout not in SCREEN_LAYOUTS or not 1 <= cluster <= 64 or (layout != "cluster" and cluster != 1):
        raise ValueError(f"no runs_screen layout {layout!r} with {cluster} block(s) a lane")
    token = _plan_override.set(ScreenPlan(layout, int(cluster)))
    try:
        yield
    finally:
        _plan_override.reset(token)


def lane_order(pod_active) -> torch.Tensor:
    """The lanes by their active rows, most first (ties in lane order): the
    order the launch's blocks take them, so that the lanes that set its
    length start in the first wave. On the lanes' device, no host sync."""
    return torch.argsort(pod_active.sum(dim=1), descending=True, stable=True).to(torch.int32).contiguous()


def lane_elems(dims) -> dict:
    """Per-lane element count of every problem table and start-state leaf,
    from the struct's ints (a dict or the struct): what ``lane_view`` in
    csrc/runs_screen.cu advances each of these pointers by, times the lane,
    in stacked mode."""
    g = dims.get if isinstance(dims, dict) else (lambda k: getattr(dims, k))
    P, K, V, W, C, N = g("P"), g("K"), g("V"), g("W"), g("C"), g("N")
    T, TPL, R, O, PT, D = g("T"), g("TPL"), g("R"), g("O"), g("PT"), g("D")
    G, F, CH, RN = g("G"), g("F"), g("CH"), g("RN")
    out = {"lvw": K * W, "ln": K * V, "lex": K * V, "wellknown": K, "pod_strict_adm": P * K * W,
           "pod_requests": P * R, "pod_tol_tpl": P * TPL, "pod_tol_node": P * N, "pod_ports": P * PT,
           "pod_conflict": P * PT, "pod_match": P * G, "pod_selects": P * G, "pod_owned": P * G,
           "pod_vols": P * D, "it_alloc": T * R, "it_cap": T * R, "offer_zone": T * O, "offer_ct": T * O,
           "offer_ok": T * O, "tpl_overhead": TPL * R, "tpl_it_ok": TPL * T, "node_vol_limits": N * D,
           "flt_valid": G * F, "host_lane": CH, "run_start": RN, "run_len": RN, "run_mode": RN,
           "init_claim_requests": C * R, "init_claim_it_ok": C * T, "init_claim_open": C,
           "init_claim_npods": C, "init_claim_tpl": C, "init_claim_ports": C * PT,
           "init_node_requests": N * R, "init_node_npods": N, "init_node_ports": N * PT,
           "init_node_vol_used": N * D, "init_remaining": TPL * R, "init_grp_counts": G * V,
           "init_grp_registered": G * V}
    for name in ("grp_type", "grp_key", "grp_max_skew", "grp_min_domains", "grp_inverse", "grp_has_filter"):
        out[name] = G
    # requirement rows: packed admitted words, then a value per key
    for prefix, rows, fields in (("pod", P, "comp def gt lt neg"), ("it", T, "comp def gt lt neg"),
                                 ("tpl", TPL, "comp def gt lt neg"), ("flt", G * F, "comp def gt lt neg"),
                                 ("init_claim", C, "comp def gt lt"), ("init_node", N, "comp def gt lt")):
        out[prefix + "_adm"] = rows * K * W
        for f in fields.split():
            out[f"{prefix}_{f}"] = rows * K
    return out


def _shared_tensors(problem: SchedulingProblem) -> dict:
    """The tables every lane of one problem reads: the ``ffd_loop`` tables
    less the per-lane and seed arrays, plus the run axis."""
    t = problem_tensors(problem)
    del t["pod_active"], t["node_avail"], t["pod_eqprev_chain"]
    for name in ("run_start", "run_len", "run_mode"):
        t[name] = getattr(problem, name).to(torch.int32).contiguous()
    return t


def runs_screen_args(base: SchedulingProblem, init: FFDState, node_avail, pod_active, *, max_run: int,
                     passes: int, with_topo: bool, grp_counts0=None, grp_registered0=None):
    """One ``runs_screen`` launch's tensors by struct field name and its
    argument struct. ``base`` carries the run axis the lanes walk (trimmed,
    for the residual screen); ``init`` is the state every lane starts from;
    ``grp_counts0``/``grp_registered0`` (both or neither) replace its census
    per lane (the full screen)."""
    check_run_modes(base, with_topo)
    t = _shared_tensors(base)
    t.update(state_tensors(init, base.lane_valid, base.lane_numeric, prefix="init_"))
    return _launch_args(t, base, init.claim_open.shape[0], node_avail, pod_active, max_run=max_run,
                        passes=passes, grp_counts0=grp_counts0, grp_registered0=grp_registered0)


def _initial_tensors(p: SchedulingProblem, max_claims: int) -> dict:
    """``state_tensors(initial_state(p, max_claims))`` under the prefix
    ``init_``, packed from one claim row: every claim slot starts as the same
    row, so its lane words are packed once, not once per slot."""
    t = state_tensors(initial_state(p, 1), p.lane_valid, p.lane_numeric, prefix="init_")
    for name, x in t.items():
        if name.startswith("init_claim_"):
            t[name] = x.expand(max_claims, *x.shape[1:])
    return t


def stacked_screen_args(batch: SchedulingProblem, max_claims: int, *, max_run: int, passes: int,
                        with_topo: bool):
    """The stacked mode's launch: every lane's problem tables and initial
    state on the stack's leading lane axis (nothing shared but the struct's
    ints), each lane's own ``node_avail``/``pod_active`` as its lane inputs,
    and no lane census (each lane's start state carries its own). The tables
    are built once for the whole stack: ``torch.func.vmap`` maps the one-lane
    builders over the lane axis. Returns the tensors by struct field name and
    the argument struct."""
    check_run_modes(batch, with_topo)
    leaves = []
    _map_leaves(leaves.append, batch)

    def lane_tables(*lane_leaves):
        it = iter(lane_leaves)
        p = _pad_lanes_mult32(_map_leaves(lambda _: next(it), batch))
        t = _shared_tensors(p)
        t.update(_initial_tensors(p, max_claims))
        return t

    t = {name: x.contiguous() for name, x in torch.func.vmap(lane_tables)(*leaves).items()}
    return _launch_args(t, _pad_lanes_mult32(lane_problem(batch, 0)), max_claims, batch.node_avail,
                        batch.pod_active, max_run=max_run, passes=passes, stacked=True)


def _launch_args(t: dict, base: SchedulingProblem, C: int, node_avail, pod_active, *, max_run: int,
                 passes: int, grp_counts0=None, grp_registered0=None, stacked: bool = False):
    """Add the lane inputs, the per-lane state, scratch and outputs to the
    problem tables and start state in ``t``, and build the argument struct.
    In stacked mode every table in ``t`` carries a leading lane axis, and its
    per-lane size must be what the kernel computes from the struct's ints."""
    dev = base.lane_valid.device
    if passes < 1:
        raise ValueError("passes must be >= 1")
    B = pod_active.shape[0]
    P, N, R, G, V = base.num_pods, base.num_nodes, base.num_resources, base.num_groups, base.num_lanes
    K, W = base.num_keys, V // 32
    T, TPL = base.num_instance_types, base.num_templates
    if node_avail.shape != (B, N, R) or node_avail.dtype != torch.float32:
        raise ValueError(f"node_avail must be f32[{B}, {N}, {R}]")
    if pod_active.shape != (B, P) or pod_active.dtype != torch.bool:
        raise ValueError(f"pod_active must be bool[{B}, {P}]")
    if (grp_counts0 is None) != (grp_registered0 is None):
        raise ValueError("grp_counts0 and grp_registered0 replace the census together")
    if grp_counts0 is not None and (stacked or grp_counts0.shape != (B, G, V) or grp_registered0.shape != (B, G, V)):
        raise ValueError(f"the lane census must be [{B}, {G}, {V}], and the stacked mode takes none")
    lanes_in = [node_avail, pod_active] + ([grp_counts0, grp_registered0] if grp_counts0 is not None else [])
    if any(x.device != dev for x in lanes_in):
        raise ValueError(f"every lane array must be on {dev}")
    i32 = torch.int32
    t = dict(t)
    t["node_avail"] = node_avail.contiguous()
    # the scratch tail keeps a window starting near P inside the lane's row
    t["pod_active"] = torch.cat([pod_active, torch.zeros((B, max_run), dtype=torch.bool, device=dev)], dim=1).contiguous()
    t["lane_grp_counts0"] = None if grp_counts0 is None else grp_counts0.to(i32).contiguous()
    t["lane_grp_registered0"] = None if grp_registered0 is None else grp_registered0.contiguous()
    for name in RS_STATE:
        src = t["init_" + name]
        shape = tuple(src.shape) if stacked else (B,) + tuple(src.shape)
        t[name] = torch.empty(shape, dtype=src.dtype, device=dev)
    bins = N + C + TPL
    t["fin_adm"] = torch.empty((B, bins, K, W), dtype=i32, device=dev)
    t["fin_gt"] = torch.empty((B, bins, K), dtype=i32, device=dev)
    t["fin_lt"] = torch.empty((B, bins, K), dtype=i32, device=dev)
    for name in ("fin_comp", "fin_def", "fin_neg"):
        t[name] = torch.empty((B, bins, K), dtype=torch.bool, device=dev)
    t["bin_ok"] = torch.zeros((B, bins), dtype=torch.bool, device=dev)
    t["ok_t"] = torch.empty((B, C + TPL, T), dtype=torch.bool, device=dev)
    t["cap_t"] = torch.empty((B, C + TPL, T), dtype=i32, device=dev)
    t["node_cap"] = torch.empty((B, max(N, 1)), dtype=i32, device=dev)
    t["node_taken"] = torch.empty((B, max(N, 1)), dtype=i32, device=dev)
    t["kind"] = torch.empty((B, P), dtype=i32, device=dev)
    t["index"] = torch.empty((B, P), dtype=i32, device=dev)
    t["work"] = torch.zeros((B, len(RS_WORK_COUNTERS)), dtype=torch.int64, device=dev)
    t["sections"] = torch.zeros((B, len(RS_SECTIONS)), dtype=torch.int64, device=dev)
    t["order"] = lane_order(pod_active)
    t["plan"] = torch.zeros((3,), dtype=i32, device=dev)
    plan = screen_plan(B, P)
    dims = dict(P=P, K=K, V=V, W=W, C=C, N=N, T=T, TPL=TPL, R=R, O=base.offer_ok.shape[1],
                PT=base.pod_ports.shape[1], D=base.pod_vol_counts.shape[1], G=G,
                F=base.grp_filter_valid.shape[1], CH=base.claim_hostname_lane.shape[0], B=B,
                RN=base.num_runs, MR=max_run, passes=passes, stacked=int(stacked),
                layout=SCREEN_LAYOUTS.index(plan.layout), cluster=plan.cluster)
    if stacked:
        for name, n in lane_elems(dims).items():
            x = t[name]
            if x.shape[0] != B or x[0].numel() != n:
                raise ValueError(f"stacked {name}: {tuple(x.shape)}, the kernel reads {n} elements per lane")
    args = _RunsArgs(**{name: (t[name].data_ptr() if t[name] is not None else None) for name in _RS_POINTERS},
                     **dims)
    return t, args


def launch_runs_screen(base: SchedulingProblem, init: FFDState, node_avail, pod_active, *, max_run: int,
                       passes: int, with_topo: bool, grp_counts0=None, grp_registered0=None) -> FFDResult:
    """Run the ``runs_screen`` kernel on CUDA tensors: every lane's runs scan
    in one launch. Returns kind/index [B, P], the lanes' final states with a
    leading lane axis, and the per-lane work counters."""
    dev = base.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_runs_screen needs CUDA tensors")
    t, args = runs_screen_args(base, init, node_avail, pod_active, max_run=max_run, passes=passes,
                               with_topo=with_topo, grp_counts0=grp_counts0, grp_registered0=grp_registered0)
    kernels.launch("runs_screen", args, torch.cuda.current_stream(dev).cuda_stream)
    return FFDResult(kind=t["kind"], index=t["index"], state=state_back(t, base.num_lanes), work=t["work"])


def launch_stacked_screen(batch: SchedulingProblem, max_claims: int, *, passes: int) -> FFDResult:
    """Run the ``runs_screen`` kernel in its stacked mode on CUDA tensors:
    every lane's whole problem, from its own initial state, in one launch.
    Returns kind/index [B, P], the lanes' final states with a leading lane
    axis, and the per-lane work counters."""
    dev = batch.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_stacked_screen needs CUDA tensors")
    t, args = stacked_screen_args(batch, max_claims, max_run=max_run_bucket(batch), passes=passes,
                                  with_topo=has_topo_runs(batch))
    kernels.launch("runs_screen", args, torch.cuda.current_stream(dev).cuda_stream)
    return FFDResult(kind=t["kind"], index=t["index"], state=state_back(t, t["ln"].shape[-1]), work=t["work"])
