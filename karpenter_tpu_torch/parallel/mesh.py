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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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
    def stack(values):
        first = values[0]
        if dataclasses.is_dataclass(first):
            return type(first)(**{f.name: stack([getattr(v, f.name) for v in values])
                                  for f in dataclasses.fields(first)})
        return torch.stack(values)

    return FFDResult(
        kind=torch.stack([r.kind for r in results]),
        index=torch.stack([r.index for r in results]),
        state=stack([r.state for r in results]),
    )


def _lanes(B: int, lanes: Optional[Sequence[int]]):
    return range(B) if lanes is None else list(lanes)


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
        r = runs_scan_plain(p, initial_state(p, max_claims), max_run, with_topo)
        kind, index = r.kind, r.index
        for _ in range(passes - 1):
            placed = kind < KIND_FAIL
            r = runs_scan_plain(dataclasses.replace(p, pod_active=p.pod_active & ~placed), r.state,
                                max_run, with_topo)
            kind = torch.where(placed, kind, r.kind)
            index = torch.where(placed, index, r.index)
        out.append(FFDResult(kind=kind, index=index, state=r.state))
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


# -- the runs_screen kernel's argument struct (csrc/runs_screen.cu RunsArgs) --

# the shared problem: the ffd_loop tables less the per-lane and seed arrays,
# plus the run axis
_RS_SHARED = tuple(n for n in _FFD_INPUTS if n not in ("pod_active", "node_avail", "kind0", "index0")) + (
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
            "B", "RN", "MR", "passes")
_RunsArgs = kernels.make_struct("RunsArgs", _RS_POINTERS, _RS_INTS)

# the kernel's per-lane work counters (csrc/runs_screen.cu), in order: the
# step's four, then runs committed by mode and pods by route
RS_WORK_COUNTERS = WORK_COUNTERS + ("runs_single", "runs_analytic", "runs_topo", "pods_stepped", "pods_analytic")


def runs_screen_args(base: SchedulingProblem, init: FFDState, node_avail, pod_active, *, max_run: int,
                     passes: int, with_topo: bool, grp_counts0=None, grp_registered0=None):
    """One ``runs_screen`` launch's tensors by struct field name and its
    argument struct. ``base`` carries the run axis the lanes walk (trimmed,
    for the residual screen); ``init`` is the state every lane starts from;
    ``grp_counts0``/``grp_registered0`` (both or neither) replace its census
    per lane (the full screen)."""
    dev = base.lane_valid.device
    check_run_modes(base, with_topo)
    if passes < 1:
        raise ValueError("passes must be >= 1")
    B = pod_active.shape[0]
    P, N, R, G, V = base.num_pods, base.num_nodes, base.num_resources, base.num_groups, base.num_lanes
    K, W = base.num_keys, V // 32
    C, T, TPL = init.claim_open.shape[0], base.num_instance_types, base.num_templates
    if node_avail.shape != (B, N, R) or node_avail.dtype != torch.float32:
        raise ValueError(f"node_avail must be f32[{B}, {N}, {R}]")
    if pod_active.shape != (B, P) or pod_active.dtype != torch.bool:
        raise ValueError(f"pod_active must be bool[{B}, {P}]")
    if (grp_counts0 is None) != (grp_registered0 is None):
        raise ValueError("grp_counts0 and grp_registered0 replace the census together")
    if grp_counts0 is not None and (grp_counts0.shape != (B, G, V) or grp_registered0.shape != (B, G, V)):
        raise ValueError(f"the lane census must be [{B}, {G}, {V}]")
    lanes_in = [node_avail, pod_active] + ([grp_counts0, grp_registered0] if grp_counts0 is not None else [])
    if any(x.device != dev for x in lanes_in):
        raise ValueError(f"every lane array must be on {dev}")
    i32 = torch.int32
    t = problem_tensors(base)
    del t["pod_active"], t["node_avail"]
    for name in ("run_start", "run_len", "run_mode"):
        t[name] = getattr(base, name).to(i32).contiguous()
    t.update(state_tensors(init, base.lane_valid, base.lane_numeric, prefix="init_"))
    t["node_avail"] = node_avail.contiguous()
    # the scratch tail keeps a window starting near P inside the lane's row
    t["pod_active"] = torch.cat([pod_active, torch.zeros((B, max_run), dtype=torch.bool, device=dev)], dim=1).contiguous()
    t["lane_grp_counts0"] = None if grp_counts0 is None else grp_counts0.to(i32).contiguous()
    t["lane_grp_registered0"] = None if grp_registered0 is None else grp_registered0.contiguous()
    for name in RS_STATE:
        src = t["init_" + name]
        t[name] = torch.empty((B,) + tuple(src.shape), dtype=src.dtype, device=dev)
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
                RN=base.num_runs, MR=max_run, passes=passes)
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
