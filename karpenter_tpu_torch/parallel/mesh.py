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
(csrc/runs_screen.cu): one block per lane, all lanes in one launch. On CPU
tensors they run ``lean_screen_plain`` / ``residual_screen_plain``, which
loop ``ops/ffd_runs.runs_scan_plain`` over the lanes. There is no fallback
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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import RUN_ANALYTIC, SchedulingProblem
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_FAIL,
    FFDResult,
    FFDState,
    _pad_lanes_mult32,
    initial_state,
)
from karpenter_tpu_torch.ops.ffd_runs import check_run_modes, has_topo_runs, max_run_bucket, runs_scan_plain
from karpenter_tpu_torch.ops.ffd_sweeps import (
    FFD_STATE,
    _FFD_INPUTS,
    WORK_COUNTERS,
    problem_tensors,
    state_back,
    state_tensors,
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
    if base.lane_valid.is_cuda:
        p0 = trim_runs(base, run_idx)
        return launch_runs_screen(
            p0, carried, variants.node_avail, variants.pod_active,
            max_run=max_run_bucket(base), passes=1, with_topo=False,
        )
    return residual_screen_plain(base, carried, variants, run_idx, max_claims)


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
    if passes < 1:
        raise ValueError("passes must be >= 1")
    if batch.lane_valid.is_cuda:
        return launch_stacked_screen(batch, max_claims, passes=passes)
    return batched_screen_plain(batch, max_claims, passes)


def batched_solve(batch: SchedulingProblem, max_claims: int, passes: int = 1) -> FFDResult:
    """The JAX package's ``batched_solve``: ``batched_screen`` with one pass
    by default."""
    return batched_screen(batch, max_claims, passes=passes)


# -- the runs_screen kernel's argument struct (csrc/runs_screen.cu RunsArgs) --

# the shared problem: the ffd_loop tables less the per-lane and seed arrays,
# plus the run axis
_RS_SHARED = tuple(
    n for n in _FFD_INPUTS if n not in ("pod_active", "pod_eqprev_chain", "node_avail", "kind0", "index0")
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
_RS_POINTERS = _RS_SHARED + RS_INIT + RS_LANE_INPUTS + RS_STATE + RS_SCRATCH + ("kind", "index", "work")
_RS_INTS = ("P", "K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G", "F", "CH",
            "B", "RN", "MR", "passes", "stacked")
_RunsArgs = kernels.make_struct("RunsArgs", _RS_POINTERS, _RS_INTS)

# the kernel's per-lane work counters (csrc/runs_screen.cu), in order: the
# step's four, then runs committed by mode and pods by route
RS_WORK_COUNTERS = WORK_COUNTERS + ("runs_single", "runs_analytic", "runs_topo", "pods_stepped", "pods_analytic")


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
    dims = dict(P=P, K=K, V=V, W=W, C=C, N=N, T=T, TPL=TPL, R=R, O=base.offer_ok.shape[1],
                PT=base.pod_ports.shape[1], D=base.pod_vol_counts.shape[1], G=G,
                F=base.grp_filter_valid.shape[1], CH=base.claim_hostname_lane.shape[0], B=B,
                RN=base.num_runs, MR=max_run, passes=passes, stacked=int(stacked))
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
