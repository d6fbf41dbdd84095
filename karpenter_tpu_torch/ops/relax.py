"""Phase 1 of the two-phase solve: a dense waterfill over pod x template bins.

Counterpart of the JAX package's ``ops/relax.py`` (``_relax_place_jit``).
The sweeps loop steps the queue pod by pod because every commit can narrow
the chosen bin and move the topology counters. For the easy bulk of a batch
none of that feedback exists: a pod with no host ports, no matched or owned
topology group, no hostname requirement and no candidate existing node
meets the rest of the solve only through the claim it lands in. Phase 1
places those pods in a fixed number of dense passes (ops/relax_common.py):
eligibility, bin-groups, template pick, the waterfill below, the real-gate
rounding ladder and the state commit. Everything it demotes, plus everything
ineligible, is the residue that the carried sweeps loop
(ops/ffd_sweeps.solve_ffd_sweeps_carried) repairs.

Two implementations of the same function:
  * ``relax_place_plain`` — plain PyTorch, taken for CPU tensors (the tests)
    and the yardstick on the card;
  * the ``relax_place`` CUDA kernel (csrc/relax_place.cu), taken for CUDA
    tensors. There is no fallback between the two.

The waterfill's bin of pod p is ``floor(level + 1e-6)`` where ``level`` is
the sum of the normalised demand of the group's earlier pods. The JAX
package takes it as a difference of two float32 prefix sums over the whole
batch, whose rounding depends on the scan's order; both implementations here
take one float64 prefix sum in pod-index order instead (numpy's sequential
``cumsum`` on a host copy; the kernel takes the same sums exactly in
integers while the batch's demand sums below 512, and one lane adds them in
pod order above that), which agree bit for bit and match the JAX package
wherever its float32 rounding does not move a pod across a bin boundary.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    FFDState,
    _pad_lanes_mult32,
    _statics,
    initial_state,
    problem_bounds_free,
)
from karpenter_tpu_torch.ops.ffd_sweeps import _req_tensors, cluster_size, lane_structs
from karpenter_tpu_torch.ops.relax_common import (
    _scatter,
    commit_assignment,
    plan_groups,
    relax_applicable,
)

__all__ = ["RELAX_PASSES", "RelaxOut", "RelaxStats", "relax_applicable", "relax_place", "relax_place_plain"]

# feasibility-repair rungs after rounding: each demotes the last-assigned pod
# of every claim the real instance-type gate rejects (the JAX default)
RELAX_PASSES = 2


class RelaxStats(NamedTuple):
    eligible: Any  # i32 pods that passed the eligibility screen
    placed: Any  # i32 pods phase 1 committed
    demoted: Any  # i32 eligible pods the rounding ladder sent to repair
    claims: Any  # i32 claims phase 1 opened


class RelaxOut(NamedTuple):
    """The claim landscape the repair pass starts from: ``kind``/``index``
    are final for placed pods (KIND_FAIL elsewhere); ``residue_active``
    replaces pod_active for the repair problem."""

    state: FFDState
    kind: Any  # i32[P]
    index: Any  # i32[P]
    residue_active: Any  # bool[P]
    stats: RelaxStats
    work: Any = None  # i64[2] relax_place work counters (kernel path only; WORK_COUNTERS)


def waterfill_bins(w: torch.Tensor, hp: torch.Tensor, gidc: torch.Tensor) -> torch.Tensor:
    """i32[P] bin of each pod within its group: floor(level + 1e-6), level the
    float64 sum of the group's earlier demand, from one exclusive prefix sum
    in pod-index order (see the module docstring)."""
    w64 = w.cpu().numpy().astype(np.float64)
    start = np.zeros_like(w64)
    start[1:] = np.cumsum(w64)[:-1]
    head = hp.cpu().numpy()[gidc.cpu().numpy()]
    level = start - start[head]
    binp = np.maximum(np.floor(level + 1e-6), 0).astype(np.int32)
    return torch.from_numpy(binp).to(w.device)


def relax_place_plain(problem: SchedulingProblem, max_claims: int) -> RelaxOut:
    """Plain PyTorch phase 1 (see module docstring)."""
    problem = _pad_lanes_mult32(problem)
    C = int(max_claims)
    statics = _statics(problem, problem_bounds_free(problem))
    plan = plan_groups(problem, C, statics)
    elig, gid, gidc = plan.elig, plan.gid, plan.gidc

    binp = waterfill_bins(plan.w, plan.hp, gidc)
    nbins = _scatter(C, torch.where(elig, gid, C), binp, "amax", -1) + 1
    nbins = torch.where(plan.gvalid, nbins, 0)
    slotbase = torch.cumsum(nbins, 0).to(torch.int32) - nbins  # exclusive prefix
    slot = (slotbase[gidc.long()] + binp).to(torch.int32)
    assigned = elig & (slot < C)  # slot overflow -> repair pass

    com = commit_assignment(problem, C, statics, plan, slot, assigned, RELAX_PASSES)
    i32 = torch.int32
    stats = RelaxStats(
        eligible=plan.elig0.sum().to(i32),
        placed=com.assigned.sum().to(i32),
        demoted=(plan.elig0 & ~com.assigned).sum().to(i32),
        claims=com.open_c.sum().to(i32),
    )
    return RelaxOut(state=com.state, kind=com.kind, index=com.index,
                    residue_active=com.residue_active, stats=stats)


def relax_place(problem: SchedulingProblem, max_claims: int) -> RelaxOut:
    """Phase 1: one ``relax_place`` kernel launch for CUDA tensors, the plain
    version for CPU tensors."""
    if problem.lane_valid.is_cuda:
        return launch_relax_place(_pad_lanes_mult32(problem), int(max_claims))
    return relax_place_plain(problem, max_claims)


# -- the relax_place kernel's argument struct (csrc/relax_place.cu RelaxArgs) --

_RELAX_INPUTS = (
    "lvw", "ln", "wellknown",
    "pod_adm", "pod_comp", "pod_def", "pod_gt", "pod_lt", "pod_neg",
    "pod_requests", "pod_tol_tpl", "pod_tol_node", "pod_ports", "pod_conflict",
    "pod_match", "pod_selects", "pod_owned", "pod_vols", "pod_active",
    "it_adm", "it_comp", "it_def", "it_gt", "it_lt", "it_neg",
    "it_alloc", "it_cap", "offer_zone", "offer_ct", "offer_ok",
    "tpl_adm", "tpl_comp", "tpl_def", "tpl_gt", "tpl_lt", "tpl_neg",
    "tpl_overhead", "tpl_it_ok", "remaining",
    "node_adm", "node_comp", "node_def", "node_gt", "node_lt", "node_neg",
    "node_overhead", "node_avail", "node_vol_used", "node_vol_limits",
    "grp_type", "grp_key", "grp_inverse", "grp_has_filter",
    "flt_adm", "flt_comp", "flt_def", "flt_gt", "flt_lt", "flt_neg", "flt_valid",
    "host_lane",
)
# the initial claim and topology state, read and committed in place
RELAX_STATE = (
    "claim_adm", "claim_comp", "claim_def", "claim_gt", "claim_lt",
    "claim_requests", "claim_it_ok", "claim_open", "claim_npods", "claim_tpl",
    "grp_counts", "grp_registered",
)
# the kernel's own working memory, sized by relax_place_workspace_bytes
RELAX_SCRATCH = ("workspace",)
_RELAX_POINTERS = (_RELAX_INPUTS + RELAX_STATE + ("kind", "index", "residue", "stats", "work", "sections", "plan")
                   + RELAX_SCRATCH)
_RELAX_INTS = ("P", "K", "V", "W", "C", "N", "T", "TPL", "R", "O", "PT", "D", "G", "F", "CH", "n_passes",
               "mode", "iters", "cluster")
_RELAX_FLOATS = ("step",)
_RelaxArgs = kernels.make_struct("RelaxArgs", _RELAX_POINTERS, _RELAX_INTS, _RELAX_FLOATS)
# the stats word: RelaxStats' four counts, then (convex mode) the rest of
# ops/relax2.Relax2Stats, its two floats as float32 bits
N_STATS = 9

# the kernel's work counters (csrc/relax_place.cu WORK_*), in order
WORK_COUNTERS = ("type_tests", "record_lanes", "pgd_columns")
# the leader's clock by stage (csrc/relax_place.cu SEC_*), in order
SECTIONS = ("init", "eligibility", "groups", "merge", "survival", "pick", "demand", "prefix", "slots", "loads",
            "update", "round", "rows", "ladder", "commit", "topology", "verdicts")


def relax_place_args(problem: SchedulingProblem, C: int, convex=None, cluster: Optional[int] = None):
    """The kernel's tensors by struct field name (inputs in its layout, the
    initial state to be committed in place, outputs, its workspace), the
    initial state, and its argument struct: one launch's worth, as
    ``launch_relax_place`` passes it. ``problem`` holds CUDA tensors with
    lanes padded to a multiple of 32. ``convex`` = (iters, step) selects the
    convex mode (ops/relax2.py); None the waterfill. ``cluster``: the blocks
    of the solve's cluster (default ``ffd_sweeps.cluster_size()``, the
    plan ffd_loop's launches take, and its ``forced_cluster`` override)."""
    dev = problem.lane_valid.device
    K, V = problem.num_keys, problem.num_lanes
    if V % 32:
        raise ValueError(f"relax_place needs V a multiple of 32; got V={V}")
    lv, ln = problem.lane_valid, problem.lane_numeric
    i32 = torch.int32
    t: dict = {}
    t["lvw"] = masks.pack_lanes(lv).contiguous()
    t["ln"] = ln.contiguous()
    t["wellknown"] = problem.key_wellknown.contiguous()
    _req_tensors("pod", problem.pod_reqs, lv, ln, t)
    _req_tensors("it", problem.it_reqs, lv, ln, t)
    _req_tensors("tpl", problem.tpl_reqs, lv, ln, t)
    _req_tensors("node", problem.node_reqs, lv, ln, t)
    _req_tensors("flt", problem.grp_filter, lv, ln, t)
    for name, src in (
        ("pod_requests", problem.pod_requests), ("pod_tol_tpl", problem.pod_tol_tpl),
        ("pod_tol_node", problem.pod_tol_node), ("pod_ports", problem.pod_ports),
        ("pod_conflict", problem.pod_port_conflict), ("pod_match", problem.pod_grp_match),
        ("pod_selects", problem.pod_grp_selects), ("pod_owned", problem.pod_grp_owned),
        ("pod_vols", problem.pod_vol_counts), ("pod_active", problem.pod_active),
        ("it_alloc", problem.it_alloc), ("it_cap", problem.it_cap),
        ("offer_zone", problem.offer_zone), ("offer_ct", problem.offer_ct),
        ("offer_ok", problem.offer_ok), ("tpl_overhead", problem.tpl_overhead),
        ("tpl_it_ok", problem.tpl_it_ok), ("remaining", problem.tpl_remaining),
        ("node_overhead", problem.node_overhead), ("node_avail", problem.node_avail),
        ("node_vol_used", problem.node_vol_used), ("node_vol_limits", problem.node_vol_limits),
        ("grp_type", problem.grp_type), ("grp_key", problem.grp_key),
        ("grp_inverse", problem.grp_inverse), ("grp_has_filter", problem.grp_has_filter),
        ("flt_valid", problem.grp_filter_valid), ("host_lane", problem.claim_hostname_lane),
    ):
        t[name] = (src.to(i32) if src.dtype == torch.int64 else src).contiguous()

    state0 = initial_state(problem, C)
    _req_tensors("claim", state0.claim_req, lv, ln, t, state=True)
    for name, src in (
        ("claim_requests", state0.claim_requests), ("claim_it_ok", state0.claim_it_ok),
        ("claim_open", state0.claim_open), ("claim_npods", state0.claim_npods),
        ("claim_tpl", state0.claim_tpl), ("grp_counts", state0.grp_counts),
        ("grp_registered", state0.grp_registered),
    ):
        t[name] = src.clone().contiguous()
    P = problem.num_pods
    t["kind"] = torch.empty((P,), dtype=i32, device=dev)
    t["index"] = torch.empty((P,), dtype=i32, device=dev)
    t["residue"] = torch.empty((P,), dtype=torch.bool, device=dev)
    t["stats"] = torch.zeros((N_STATS,), dtype=i32, device=dev)
    t["work"] = torch.zeros((len(WORK_COUNTERS),), dtype=torch.int64, device=dev)
    t["sections"] = torch.zeros((len(SECTIONS),), dtype=torch.int64, device=dev)
    t["plan"] = torch.zeros((1,), dtype=i32, device=dev)
    dims = dict(P=P, K=K, V=V, W=V // 32, C=C, N=problem.num_nodes, T=problem.num_instance_types,
                TPL=problem.num_templates, R=problem.num_resources, O=problem.offer_ok.shape[1],
                PT=problem.pod_ports.shape[1], D=problem.pod_vol_counts.shape[1], G=problem.num_groups,
                F=problem.grp_filter_valid.shape[1], CH=problem.claim_hostname_lane.shape[0],
                n_passes=RELAX_PASSES, mode=0 if convex is None else 1,
                iters=0 if convex is None else int(convex[0]), step=0.0 if convex is None else float(convex[1]),
                cluster=cluster_size() if cluster is None else int(cluster))
    t["workspace"] = None
    args = _RelaxArgs(**{n: (t[n].data_ptr() if t[n] is not None else None) for n in _RELAX_POINTERS}, **dims)
    lib = kernels.library("relax_place")
    lib.relax_place_workspace_bytes.argtypes = [ctypes.c_void_p]
    lib.relax_place_workspace_bytes.restype = ctypes.c_longlong
    t["workspace"] = torch.empty((int(lib.relax_place_workspace_bytes(ctypes.addressof(args))),),
                                 dtype=torch.uint8, device=dev)
    args.workspace = t["workspace"].data_ptr()
    return t, state0, args


# the lanes mode's launch struct (csrc/relax_place.cu RelaxLanesArgs)
_RelaxLanesArgs = kernels.make_struct("RelaxLanesArgs", ("lanes",), ("L", "cluster"))


def _relax_out(t: dict, state0: FFDState, V: int, convex) -> RelaxOut:
    """The RelaxOut of one launch's (or lane's) tensors: the committed claim
    and topology state over ``state0``'s untouched leaves."""
    state = dataclasses.replace(
        state0,
        claim_req=ReqTensor(admitted=masks.unpack_lanes(t["claim_adm"], V), comp=t["claim_comp"],
                            gt=t["claim_gt"], lt=t["claim_lt"], defined=t["claim_def"]),
        claim_requests=t["claim_requests"], claim_it_ok=t["claim_it_ok"], claim_open=t["claim_open"],
        claim_npods=t["claim_npods"], claim_tpl=t["claim_tpl"],
        grp_counts=t["grp_counts"], grp_registered=t["grp_registered"],
    )
    stats = RelaxStats(*t["stats"][:4]) if convex is None else t["stats"]
    return RelaxOut(state=state, kind=t["kind"], index=t["index"], residue_active=t["residue"],
                    stats=stats, work=t["work"])


def relax_place_lanes_args(problems, C: int, convex):
    """One ``relax_place_args`` per lane in the convex mode (``convex`` =
    (iters, step)), their structs in one device buffer, and the lanes-mode
    struct: (per-lane (tensors, initial state), buffer, struct). Every lane
    runs on a cluster of ``cluster_size(L)`` blocks."""
    cluster = cluster_size(len(problems))
    lanes = [relax_place_args(p, C, convex, cluster=cluster) for p in problems]
    buf = lane_structs([a for _, _, a in lanes], problems[0].lane_valid.device)
    return [(t, st) for t, st, _ in lanes], buf, _RelaxLanesArgs(lanes=buf.data_ptr(), L=len(lanes), cluster=cluster)


def launch_relax_place_lanes(problems, C: int, convex):
    """Run ``relax_place``'s convex mode in its lanes mode on CUDA tensors
    (program 14's phase 1): lane b over ``problems[b]`` (lanes padded to a
    multiple of 32), all lanes in one launch, a cluster per lane, each with
    its own workspace. One RelaxOut per lane, its stats the raw int32[9] word;
    counted as ``relax2_place_lanes``."""
    dev = problems[0].lane_valid.device if problems else None
    if dev is None or dev.type != "cuda":
        raise ValueError("launch_relax_place_lanes needs CUDA tensors")
    lanes, _buf, args = relax_place_lanes_args(problems, C, convex)
    kernels.launch("relax2_place_lanes", args, torch.cuda.current_stream(dev).cuda_stream)
    return [_relax_out(t, st, p.num_lanes, convex) for (t, st), p in zip(lanes, problems)]


def launch_relax_place(problem: SchedulingProblem, C: int, convex=None) -> RelaxOut:
    """Run the ``relax_place`` kernel on CUDA tensors (lanes padded to a
    multiple of 32). With ``convex`` = (iters, step) it runs the convex mode
    (counted as ``relax2_place``) and ``stats`` is the raw int32[9] word that
    ops/relax2.stats_of reads."""
    dev = problem.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_relax_place needs CUDA tensors")
    t, state0, args = relax_place_args(problem, C, convex)
    kernels.launch("relax_place", args, torch.cuda.current_stream(dev).cuda_stream,
                   counter="relax_place" if convex is None else "relax2_place")
    return _relax_out(t, state0, problem.num_lanes, convex)
