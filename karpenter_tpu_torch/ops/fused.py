"""The device-resident world: the row patch, and the fused solve + gate.

Counterpart of the JAX package's ``ops/fused.py`` (its programs 15 and 16),
behind ``DeviceWorld`` (streaming/device_world.py).

The world lives on the device in the KERNELS' layout (``world_tensors``):
the tables ``ops/ffd_sweeps.problem_tensors`` builds (packed 32-lane words,
per-row polarity, int32 indices), plus the leaves the gate and the plain
versions read, so that no cycle repacks the whole problem.

``patch_world``
    Applies a ``DeltaEncoder`` row splice (streaming/delta.py) on the
    device: every pod-axis leaf of the world takes, per padded row, either
    its previous row ``gather_idx[r]`` or row ``fresh_sel[r]`` of a small
    shipped stack (arrivals, spec changes, and pad_problem's fill row for
    the pad rows), and the small full-ship leaves (``pod_active``, the
    ``eqprev`` rows, the run tables) are replaced whole. The host converts
    the stack into the kernels' layout (``pod_tensors`` on its few rows) and
    ships everything in one pinned buffer, one copy. ``gather_idx`` is not
    monotone (``ffd_order`` sorts arrivals into the middle of the batch), so
    a patch in place could read a row another thread has already written:
    each pod-axis leaf has two buffers, the patch writes the spare one, and
    the two swap (the JAX package donates the world instead). The CUDA
    kernel ``patch_world`` (csrc/patch_world.cu) runs for CUDA tensors,
    ``patch_world_plain`` (the JAX package's per-leaf ``where``) for CPU
    tensors.

``solve_ffd_fused_gate``
    The fresh ``ffd_loop`` over the resident tables and ``gate_counts`` in
    its fused mode over the loop's final state, enqueued back to back on one
    stream with no host synchronisation between them; the result and the
    int32[7] invariant counts come back in one fetch. The gate reads the
    solver's own claim rows (the minted hostname pin included) and derives
    each pod's bin from kind/index in the kernel. For CPU tensors,
    ``solve_ffd_fused_gate_plain`` (the plain loop, then
    ``gate_counts_plain`` over ``verify.device.gate_args_from_state``).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import (
    GT_NONE,
    LT_NONE,
    ReqTensor,
    SchedulingProblem,
    numpy_fields,
    problem_to_torch,
)
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    FFDResult,
    IterCounts,
    _pad_lanes_mult32,
    initial_state,
)
from karpenter_tpu_torch.ops.ffd_sweeps import (
    POD_FIELDS,
    _req_tensors,
    loop_args_from,
    pod_tensors,
    problem_tensors,
    state_back,
    state_tensors,
    sweeps_plain,
)
from karpenter_tpu_torch.ops.padding import pow2_bucket


class PatchArgs(NamedTuple):
    """Everything one row patch ships, in padded coordinates and the
    problem's own layout (numpy; the JAX package's PatchArgs field for
    field): O(P) index/mask lanes, a fresh-row stack per pod-axis leaf whose
    tail rows hold pad_problem's fills (so pad rows and fresh rows share one
    gather), and the full run tables (``segment_runs`` output depends on
    neighbouring rows, so it is recomputed on the host and shipped whole)."""

    gather_idx: Any  # i32[P] previous-world row per surviving row
    use_fresh: Any  # bool[P] row comes from the fresh stack (incl. pad rows)
    fresh_sel: Any  # i32[P] stack row for fresh/pad rows
    # fresh-row stacks [S, ...tail buckets...]
    req_admitted: Any
    req_comp: Any
    req_gt: Any
    req_lt: Any
    req_defined: Any
    strict_admitted: Any
    strict_comp: Any
    strict_gt: Any
    strict_lt: Any
    strict_defined: Any
    requests: Any  # f32[S, R]
    tol_tpl: Any  # bool[S, TPL]
    tol_node: Any  # bool[S, N]
    ports: Any  # bool[S, PT]
    port_conflict: Any  # bool[S, PT]
    vol_counts: Any  # i32[S, D]
    grp_match: Any  # bool[S, G] (G=0 on every patchable world)
    grp_selects: Any
    grp_owned: Any
    # full-ship small arrays
    pod_active: Any  # bool[P]
    eqprev: Any  # bool[P]
    eqprev_gate: Any  # bool[P]
    eqprev_chain: Any  # bool[P]
    run_start: Any  # i32[RN]
    run_len: Any  # i32[RN]
    run_mode: Any  # i32[RN]


# pad_problem's constant fills for the pod-axis requirement leaves
# (ops/padding.py); tests/test_torch_world.py holds the patched world to
# pad_problem(cold encode), so a drift here fails there
_REQ_FILLS = {
    "admitted": False,
    "comp": True,
    "gt": GT_NONE,
    "lt": LT_NONE,
    "defined": False,
}


def leaf_shapes(problem: SchedulingProblem) -> Dict[str, tuple]:
    """{dotted field name: shape} of a padded problem: the tail buckets
    ``build_patch_args`` fills its stacks to."""
    return {name: tuple(arr.shape) for name, arr in numpy_fields(problem).items()}


def build_patch_args(spliced: SchedulingProblem, rows_prev: np.ndarray,
                     shapes: Dict[str, tuple]) -> PatchArgs:
    """Host-side plan (numpy): map the delta encoder's row splice onto the
    resident padded world. ``spliced`` is the UNPADDED patched problem the
    DeltaEncoder produced, ``rows_prev`` its per-row previous-world index
    (-1 = freshly encoded), ``shapes`` the resident world's padded leaf
    shapes (``leaf_shapes``), which fix every tail bucket. The caller has
    already proven the pod/node/lane buckets match."""
    P_cur = int(np.asarray(spliced.pod_requests).shape[0])
    Pb = int(shapes["pod_requests"][0])
    rows_prev = np.asarray(rows_prev, dtype=np.int64)
    fresh_pos = np.where(rows_prev < 0)[0]
    F = len(fresh_pos)
    # S > F always: the stack's tail rows ARE the pad-row template
    S = pow2_bucket(F + 1, lo=8)

    gather_idx = np.zeros(Pb, dtype=np.int32)
    gather_idx[:P_cur] = np.maximum(rows_prev, 0)
    use_fresh = np.ones(Pb, dtype=bool)  # pad rows gather the fill row
    use_fresh[:P_cur] = rows_prev < 0
    fresh_sel = np.full(Pb, F, dtype=np.int32)
    fresh_sel[fresh_pos] = np.arange(F, dtype=np.int32)

    def stack(arr, name, fill):
        arr = np.asarray(arr)
        out = np.full((S,) + tuple(shapes[name][1:]), fill, dtype=arr.dtype)
        sub = arr[fresh_pos]
        out[(slice(0, F),) + tuple(slice(0, d) for d in sub.shape[1:])] = sub
        return out

    def req_stacks(src: ReqTensor, prefix: str):
        return {f: stack(getattr(src, f), f"{prefix}.{f}", fill) for f, fill in _REQ_FILLS.items()}

    reqs = req_stacks(spliced.pod_reqs, "pod_reqs")
    strict = req_stacks(spliced.pod_strict_reqs, "pod_strict_reqs")

    def full(arr, length, fill):
        arr = np.asarray(arr)
        out = np.full((length,), fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    RNb = pow2_bucket(int(np.asarray(spliced.run_len).shape[0]), lo=4)
    return PatchArgs(
        gather_idx=gather_idx,
        use_fresh=use_fresh,
        fresh_sel=fresh_sel,
        req_admitted=reqs["admitted"],
        req_comp=reqs["comp"],
        req_gt=reqs["gt"],
        req_lt=reqs["lt"],
        req_defined=reqs["defined"],
        strict_admitted=strict["admitted"],
        strict_comp=strict["comp"],
        strict_gt=strict["gt"],
        strict_lt=strict["lt"],
        strict_defined=strict["defined"],
        requests=stack(spliced.pod_requests, "pod_requests", 0.0),
        tol_tpl=stack(spliced.pod_tol_tpl, "pod_tol_tpl", False),
        tol_node=stack(spliced.pod_tol_node, "pod_tol_node", False),
        ports=stack(spliced.pod_ports, "pod_ports", False),
        port_conflict=stack(spliced.pod_port_conflict, "pod_port_conflict", False),
        vol_counts=stack(spliced.pod_vol_counts, "pod_vol_counts", 0),
        grp_match=stack(spliced.pod_grp_match, "pod_grp_match", False),
        grp_selects=stack(spliced.pod_grp_selects, "pod_grp_selects", False),
        grp_owned=stack(spliced.pod_grp_owned, "pod_grp_owned", False),
        pod_active=full(spliced.pod_active, Pb, False),
        eqprev=full(spliced.pod_eqprev, Pb, False),
        eqprev_gate=full(spliced.pod_eqprev_gate, Pb, False),
        eqprev_chain=full(spliced.pod_eqprev_chain, Pb, False),
        run_start=full(spliced.run_start, RNb, 0),
        run_len=full(spliced.run_len, RNb, 0),
        run_mode=full(spliced.run_mode, RNb, 1),
    )


# -- the world in the kernels' layout ------------------------------------------

# pod-axis leaves the patch rewrites row by row: ``pod_tensors``' leaves plus
# the strict rows' other fields (the plain versions read them)
PATCH_ROWS = (
    "pod_adm", "pod_comp", "pod_def", "pod_gt", "pod_lt", "pod_neg",
    "pod_strict_adm", "pod_strict_comp", "pod_strict_def", "pod_strict_gt", "pod_strict_lt",
    *(name for name, _ in POD_FIELDS),
)
# leaves the patch replaces whole: kernel name <- PatchArgs field
PATCH_FULL = (
    ("pod_active", "pod_active"), ("pod_eqprev", "eqprev"), ("pod_eqprev_gate", "eqprev_gate"),
    ("pod_eqprev_chain", "eqprev_chain"), ("run_start", "run_start"), ("run_len", "run_len"),
    ("run_mode", "run_mode"),
)
# constant leaves beyond problem_tensors: kernel name <- problem field
_WORLD_EXTRAS = (
    ("node_overhead", "node_overhead"), ("node_used_ports", "node_used_ports"),
    ("node_vol_used", "node_vol_used"), ("offer_price", "offer_price"),
    ("tpl_remaining", "tpl_remaining"), ("grp_counts0", "grp_counts0"),
    ("grp_registered0", "grp_registered0"), ("offer_zc", "offer_zc"),
)


def _strict_rest(strict: ReqTensor) -> dict:
    return {
        "pod_strict_comp": strict.comp.contiguous(), "pod_strict_def": strict.defined.contiguous(),
        "pod_strict_gt": strict.gt.to(torch.int32).contiguous(),
        "pod_strict_lt": strict.lt.to(torch.int32).contiguous(),
    }


def world_tensors(problem: SchedulingProblem) -> dict:
    """A padded problem of torch tensors in the kernels' layout, by struct
    field name: ``problem_tensors``, the node rows the gate reads
    (``nreq_*``), and every other leaf, so that ``world_problem`` inverts it
    exactly."""
    problem = _pad_lanes_mult32(problem)
    lv, ln = problem.lane_valid, problem.lane_numeric
    t = problem_tensors(problem)
    t.update(_strict_rest(problem.pod_strict_reqs))
    # the problem's node rows, as the gate reads them; "node_*" names the
    # loop's node state, which starts from these rows and narrows
    _req_tensors("nreq", problem.node_reqs, lv, ln, t)
    for name, field in _WORLD_EXTRAS:
        src = getattr(problem, field)
        if src is not None:
            t[name] = src.contiguous()
    for name, _ in PATCH_FULL[1:]:
        t[name] = getattr(problem, name).contiguous()
    return t


def world_problem(t: dict) -> SchedulingProblem:
    """The SchedulingProblem a world in the kernels' layout holds (unpacked
    lanes): the inverse of ``world_tensors``, for the plain versions."""
    V = t["ln"].shape[1]

    def req(prefix: str) -> ReqTensor:
        return ReqTensor(
            admitted=masks.unpack_lanes(t[prefix + "_adm"], V), comp=t[prefix + "_comp"],
            gt=t[prefix + "_gt"], lt=t[prefix + "_lt"], defined=t[prefix + "_def"],
        )

    fields = {problem_field: t[name] for name, problem_field in POD_FIELDS}
    fields.update({field: t.get(name) for name, field in _WORLD_EXTRAS})
    return SchedulingProblem(
        lane_valid=masks.unpack_lanes(t["lvw"], V), lane_numeric=t["ln"],
        lane_lex_rank=t["lex"], key_wellknown=t["wellknown"],
        pod_reqs=req("pod"), pod_strict_reqs=req("pod_strict"),
        it_reqs=req("it"), it_alloc=t["it_alloc"], it_cap=t["it_cap"],
        offer_zone=t["offer_zone"], offer_ct=t["offer_ct"], offer_ok=t["offer_ok"],
        tpl_reqs=req("tpl"), tpl_overhead=t["tpl_overhead"], tpl_it_ok=t["tpl_it_ok"],
        node_reqs=req("nreq"), node_avail=t["node_avail"], node_vol_limits=t["node_vol_limits"],
        grp_type=t["grp_type"], grp_key=t["grp_key"], grp_max_skew=t["grp_max_skew"],
        grp_min_domains=t["grp_min_domains"], grp_inverse=t["grp_inverse"],
        grp_has_filter=t["grp_has_filter"], grp_filter=req("flt"), grp_filter_valid=t["flt_valid"],
        claim_hostname_lane=t["host_lane"], pod_active=t["pod_active"],
        run_start=t["run_start"], run_len=t["run_len"], run_mode=t["run_mode"],
        pod_eqprev=t["pod_eqprev"], pod_eqprev_gate=t["pod_eqprev_gate"],
        pod_eqprev_chain=t["pod_eqprev_chain"],
        **fields,
    )


@dataclass
class World:
    """A padded problem resident on one device, in the kernels' layout."""

    t: dict  # world_tensors, by struct field name
    spare: dict  # the second buffer of each PATCH_ROWS leaf: the next patch's output
    init: dict  # the fresh solve's initial state (state_tensors of initial_state)
    lanes: tuple  # (lane_valid, lane_numeric) on the host: packs the shipped rows
    shapes: Dict[str, tuple]  # the padded problem's leaf shapes (leaf_shapes)
    max_claims: int

    @property
    def device(self) -> torch.device:
        return self.t["ln"].device

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for d in (self.t, self.spare) for x in d.values())


def adopt_world(padded: SchedulingProblem, max_claims: int, device) -> World:
    """Upload a padded host problem whole and convert it on the device."""
    problem = problem_to_torch(padded, device)
    t = world_tensors(problem)
    init = state_tensors(initial_state(problem, max_claims), problem.lane_valid, problem.lane_numeric)
    return World(
        t=t, spare={name: torch.empty_like(t[name]) for name in PATCH_ROWS}, init=init,
        lanes=(torch.from_numpy(np.asarray(padded.lane_valid)), torch.from_numpy(np.asarray(padded.lane_numeric))),
        shapes=leaf_shapes(padded), max_claims=int(max_claims),
    )


# -- the patch kernel's arguments (csrc/patch_world.cu) -------------------------

_ALIGN = 16
# one PatchLeaf {prev, out, stk, row_bytes} of the kernel's leaf table
_LEAF_WORDS = 4
_PATCH_POINTERS = ("leaves", "gather_idx", "use_fresh", "fresh_sel")
_PATCH_INTS = ("L", "FL", "P")
_PatchKernelArgs = kernels.make_struct("PatchKernelArgs", _PATCH_POINTERS, _PATCH_INTS)


def _stack_rows(args: PatchArgs, lanes) -> dict:
    """The shipped stack in the kernels' layout (``pod_tensors`` on its rows)."""
    lv, ln = lanes

    def req(prefix: str) -> ReqTensor:
        return ReqTensor(*(torch.from_numpy(np.asarray(getattr(args, f"{prefix}_{f}")))
                           for f in ("admitted", "comp", "gt", "lt", "defined")))

    rows = SimpleNamespace(pod_reqs=req("req"), pod_strict_reqs=req("strict"))
    for (_, field), src in zip(POD_FIELDS, (
        args.requests, args.tol_tpl, args.tol_node, args.ports, args.port_conflict,
        args.grp_match, args.grp_selects, args.grp_owned, args.vol_counts,
    )):
        setattr(rows, field, torch.from_numpy(np.asarray(src)))
    t = pod_tensors(rows, lv, ln)
    t.update(_strict_rest(rows.pod_strict_reqs))
    return t


@dataclass
class PatchUpload:
    """One patch's arguments on the device: typed views into one buffer that
    came over in one copy, and the kernel's argument struct."""

    gather_idx: torch.Tensor
    use_fresh: torch.Tensor
    fresh_sel: torch.Tensor
    stack: Dict[str, torch.Tensor]  # PATCH_ROWS leaf -> [S, ...] rows, kernel layout
    full: Dict[str, torch.Tensor]  # PATCH_FULL leaf -> its new value
    buffer: torch.Tensor  # the device buffer holding all of the above
    args: Any  # _PatchKernelArgs, pointers into ``buffer`` and the world
    nbytes: int  # bytes copied host -> device


def upload_patch(args: PatchArgs, world: World) -> PatchUpload:
    """Pack ``args`` into the kernels' layout, write it into one host buffer
    (pinned for a CUDA world) and copy it to the world's device with one
    non-blocking copy. The leaf table the kernel walks is part of the same
    buffer: for each non-empty PATCH_ROWS leaf (previous buffer, spare
    buffer, stack rows, row bytes), then for each PATCH_FULL leaf (-, its
    destination, its new value, total bytes). A full-ship leaf whose length
    changed (the run tables follow the run count's bucket) gets a new
    destination tensor here."""
    dev = world.device
    host_arrays: Dict[str, np.ndarray] = {
        "gather_idx": np.asarray(args.gather_idx, dtype=np.int32),
        "use_fresh": np.asarray(args.use_fresh, dtype=bool),
        "fresh_sel": np.asarray(args.fresh_sel, dtype=np.int32),
    }
    stack = {name: x.numpy() for name, x in _stack_rows(args, world.lanes).items()}
    for name in PATCH_ROWS:
        host_arrays["stk:" + name] = stack[name]
    for name, field in PATCH_FULL:
        host_arrays["full:" + name] = np.asarray(getattr(args, field))
    offsets, total = {}, 0
    for key, arr in host_arrays.items():
        offsets[key] = total
        total += -(-arr.nbytes // _ALIGN) * _ALIGN
    rows = [name for name in PATCH_ROWS if stack[name].nbytes]
    n_leaves = len(rows) + len(PATCH_FULL)
    table_off = total
    total += n_leaves * _LEAF_WORDS * 8

    pinned = dev.type == "cuda"
    host = torch.empty((total,), dtype=torch.uint8, pin_memory=pinned)
    buf = torch.empty((total,), dtype=torch.uint8, device=dev) if pinned else host
    hview = host.numpy()
    for key, arr in host_arrays.items():
        flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        hview[offsets[key]:offsets[key] + flat.size] = flat

    def device_view(key: str) -> torch.Tensor:
        arr = host_arrays[key]
        dtype = torch.from_numpy(arr[:0].copy()).dtype
        return buf[offsets[key]:offsets[key] + arr.nbytes].view(dtype).view(arr.shape)

    for name, _ in PATCH_FULL:
        shape = host_arrays["full:" + name].shape
        if tuple(world.t[name].shape) != shape:
            world.t[name] = torch.empty(shape, dtype=world.t[name].dtype, device=dev)
    table = np.zeros((n_leaves, _LEAF_WORDS), dtype=np.int64)
    base = buf.data_ptr()
    for i, name in enumerate(rows):
        prev, out = world.t[name], world.spare[name]
        table[i] = (prev.data_ptr(), out.data_ptr(), base + offsets["stk:" + name],
                    stack[name].nbytes // stack[name].shape[0])
    for j, (name, _) in enumerate(PATCH_FULL):
        dst = world.t[name]
        table[len(rows) + j] = (0, dst.data_ptr(), base + offsets["full:" + name], dst.numel() * dst.element_size())
    hview[table_off:table_off + table.nbytes] = table.reshape(-1).view(np.uint8)
    if pinned:
        buf.copy_(host, non_blocking=True)
    kargs = _PatchKernelArgs(
        leaves=base + table_off, gather_idx=base + offsets["gather_idx"],
        use_fresh=base + offsets["use_fresh"], fresh_sel=base + offsets["fresh_sel"],
        L=len(rows), FL=len(PATCH_FULL), P=int(host_arrays["gather_idx"].shape[0]),
    )
    return PatchUpload(
        gather_idx=device_view("gather_idx"), use_fresh=device_view("use_fresh"),
        fresh_sel=device_view("fresh_sel"),
        stack={name: device_view("stk:" + name) for name in PATCH_ROWS},
        full={name: device_view("full:" + name) for name, _ in PATCH_FULL},
        buffer=buf, args=kargs, nbytes=total,
    )


def patch_world_plain(prev: Dict[str, torch.Tensor], up: PatchUpload) -> Dict[str, torch.Tensor]:
    """The patched leaves, in plain PyTorch (the JAX package's per-leaf
    ``where(use_fresh, stack[fresh_sel], prev[gather_idx])``): PATCH_ROWS
    from ``prev`` and the stack, PATCH_FULL from the upload."""
    out = {}
    idx, sel = up.gather_idx.long(), up.fresh_sel.long()
    for name in PATCH_ROWS:
        leaf = prev[name]
        mask = up.use_fresh.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[name] = torch.where(mask, up.stack[name][sel], leaf[idx])
    for name, _ in PATCH_FULL:
        out[name] = up.full[name].clone()
    return out


def patch_world(world: World, up: PatchUpload) -> None:
    """Apply one row patch to ``world``: the ``patch_world`` kernel for a
    CUDA world (one launch, spare buffers written, then swapped in), the
    plain version for a CPU world."""
    if world.device.type == "cuda":
        for name in PATCH_ROWS:
            if world.t[name].numel() and world.t[name].data_ptr() == world.spare[name].data_ptr():
                raise RuntimeError(f"patch_world: {name} would be patched in place")
        kernels.launch("patch_world", up.args, torch.cuda.current_stream(world.device).cuda_stream)
    else:
        new = patch_world_plain(world.t, up)
        for name in PATCH_ROWS:
            world.spare[name].copy_(new[name])
        for name, _ in PATCH_FULL:
            world.t[name].copy_(new[name])
    for name in PATCH_ROWS:
        world.t[name], world.spare[name] = world.spare[name], world.t[name]


# -- program 16: the fresh loop and the gate over its final state ----------------


def fused_gate_counts(problem, kind, index, state, pod_check, max_claims, gate_bf) -> torch.Tensor:
    """The fused epilogue in plain PyTorch: GateArgs from the final state
    (``verify.device.gate_args_from_state``) and the invariant counts."""
    from karpenter_tpu_torch.verify import device as gdev

    ga = gdev.gate_args_from_state(state, kind, index, pod_check, max_claims)
    return gdev.gate_counts_plain(gdev.gate_problem(problem), ga, bool(gate_bf))


def solve_ffd_fused_gate_plain(problem: SchedulingProblem, pod_check, max_claims: int,
                               bounds_free: bool = False, gate_bf: bool = False):
    """(FFDResult, i32[7] counts): the plain requeue loop from a fresh state,
    then ``fused_gate_counts`` over its final state."""
    problem = _pad_lanes_mult32(problem)
    result = sweeps_plain(problem, initial_state(problem, max_claims), bounds_free)
    counts = fused_gate_counts(problem, result.kind, result.index, result.state, pod_check,
                               max_claims, gate_bf)
    return result, counts


def solve_ffd_fused_gate(world: World, pod_check, max_claims: int, bounds_free: bool = False,
                         gate_bf: bool = False):
    """(FFDResult, i32[7] counts) of the resident world: for a CUDA world the
    fresh ``ffd_loop`` over the resident tables and ``gate_counts`` in its
    fused mode, enqueued back to back (nothing is synchronised; the caller
    fetches); for a CPU world the plain version. ``pod_check`` is bool[P] on
    the world's device."""
    if max_claims != world.max_claims:
        raise ValueError(f"the world holds {world.max_claims} claim slots, not {max_claims}")
    if world.device.type != "cuda":
        return solve_ffd_fused_gate_plain(world_problem(world.t), pod_check, max_claims, bounds_free, gate_bf)
    from karpenter_tpu_torch.verify import device as gdev

    t = dict(world.t)
    t.update({name: x.clone() for name, x in world.init.items()})
    t, args = loop_args_from(t, one_pass=False)
    kernels.launch("ffd_loop", args, torch.cuda.current_stream(world.device).cuda_stream)
    counts = gdev.launch_gate_counts_fused(t, pod_check)
    result = FFDResult(
        kind=t["kind"], index=t["index"], state=state_back(t, t["ln"].shape[1]),
        iters=IterCounts(*t["counters"]), work=t["work"],
    )
    return result, counts

