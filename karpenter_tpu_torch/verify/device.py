"""The invariant gate: the full-level validator as tensor reductions.

Counterpart of the JAX package's ``verify/device.py``. One program re-checks a
decoded placement against the SAME padded problem tensors the solve consumed,
re-using the solver's own predicates (masks.fits, the instance-type gate of
ops/ffd_core._make_it_gate). The placement arrives as one flat assignment
vector: ``pod_bin[r]`` maps problem row r to a claim slot (0..C-1), an
existing node (C..C+N-1), or -1 for unplaced rows — plus per-claim tensors
describing what the result PUBLISHED.

Two implementations of ``verify_gate``: ``gate_counts_plain`` (plain
PyTorch, taken for CPU tensors) and the ``gate_counts`` CUDA kernel
(csrc/gate_counts.cu, taken for CUDA tensors). The device-resident cycle
(ops/fused.py) runs the kernel in its fused mode over the solve's own final
state (``launch_gate_counts_fused``; plain: ``gate_args_from_state``).

Tolerance direction (the safety contract): every predicate here is equal to
or TIGHTER than its float64 host twin in solver/validator.py. masks.fits
allows eps = 1e-6 + 1e-6|avail| where the host allows 1e-6 + 1e-4|avail|;
pod_tol_* rows encode ALL taints where the host checks hard taints only.
Device-accept therefore implies host-accept, and every device reject is
host-confirmed by the caller (verify/gate.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import GT_NONE, LT_NONE, ReqTensor, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import _make_it_gate, _statics

# Count-vector lane order; gate.py maps nonzero lanes back to host Violation
# invariant names when building the reject report.
INVARIANTS = (
    "claim-requests",
    "claim-capacity",
    "instance-type-survivor",
    "taint-admissibility",
    "host-port",
    "requirement-intersection",
    "node-capacity",
)

# Host validator tolerances for the claim-requests equality check.
_REL_TOL = 1e-4
_ABS_TOL = 1e-6


class GateProblem(NamedTuple):
    """The subset of SchedulingProblem the gate reads (field names match
    SchedulingProblem, which ffd_core._statics/_make_it_gate duck-type)."""

    lane_valid: Any
    lane_numeric: Any
    key_wellknown: Any
    pod_reqs: ReqTensor
    pod_requests: Any
    pod_tol_tpl: Any
    pod_tol_node: Any
    pod_ports: Any
    pod_port_conflict: Any
    it_reqs: ReqTensor
    it_alloc: Any
    offer_zone: Any
    offer_ct: Any
    offer_ok: Any
    offer_zc: Optional[Any]
    tpl_reqs: ReqTensor
    tpl_overhead: Any
    node_reqs: ReqTensor
    node_avail: Any
    node_overhead: Any
    node_used_ports: Any


def gate_problem(problem: SchedulingProblem) -> GateProblem:
    """Project a (lane-padded) SchedulingProblem onto the gate's field set."""
    return GateProblem(**{f: getattr(problem, f) for f in GateProblem._fields})


class GateArgs(NamedTuple):
    """Per-result tensors describing the decoded placement under test."""

    claim_req: ReqTensor  # [C] published claim requirements (meta vocab)
    claim_tpl: Any  # i32[C] template index per claim slot
    claim_active: Any  # bool[C]
    claim_reported: Any  # f32[C, R] densified claim.requests
    claim_its: Any  # bool[C, T] listed instance types
    claim_has_reqs: Any  # bool[C] claim.requirements was not None
    pod_bin: Any  # i32[P] claim 0..C-1 / node C..C+N-1 / -1 unplaced
    pod_check: Any  # bool[P] host reqs_of() would be non-None


def gate_counts_plain(gp: GateProblem, ga: GateArgs, bounds_free: bool) -> torch.Tensor:
    """i32[len(INVARIANTS)] violation counts; all-zero means device-accept."""
    P, R = gp.pod_requests.shape
    C = ga.claim_tpl.shape[0]
    N = gp.node_avail.shape[0]
    TPL = gp.tpl_overhead.shape[0]
    dev = gp.pod_requests.device
    statics = _statics(gp, bounds_free)
    pod_bin = ga.pod_bin.long()

    on_claim = (pod_bin >= 0) & (pod_bin < C)
    on_node = (pod_bin >= C) & (pod_bin < C + N)
    placed = on_claim | on_node
    ci = torch.where(on_claim, pod_bin, torch.full_like(pod_bin, C))  # C drops
    ni = torch.where(on_node, pod_bin - C, torch.full_like(pod_bin, N))  # N drops
    ci_safe = torch.clamp(ci, 0, max(C - 1, 0))

    # claim-requests: published requests equal template overhead plus the
    # placed pods' request rows
    summed = torch.zeros((C + 1, R), dtype=torch.float32, device=dev)
    summed.index_add_(0, ci, gp.pod_requests)
    summed = summed[:C]
    tpl_safe = torch.clamp(ga.claim_tpl.long(), 0, max(TPL - 1, 0))
    expected = summed + torch.where(
        ga.claim_active[:, None], gp.tpl_overhead[tpl_safe], torch.zeros_like(summed)
    )
    err = torch.abs(expected - ga.claim_reported)
    tol = _ABS_TOL + _REL_TOL * torch.maximum(torch.abs(expected), torch.abs(ga.claim_reported))
    bad_requests = ga.claim_active & (err > tol).any(dim=-1)

    # claim-capacity: some listed instance type fits the recomputed totals
    fit_ct = masks.fits(expected[:, None, :], gp.it_alloc[None, :, :])
    any_listed = ga.claim_its.any(dim=-1)
    bad_capacity = ga.claim_active & any_listed & ~(ga.claim_its & fit_ct).any(dim=-1)

    # instance-type-survivor: every LISTED type survives the published
    # requirements (compat x fits x offering)
    it_gate = _make_it_gate(gp, statics)
    ok_it = it_gate(
        ga.claim_req, expected,
        torch.ones((C, gp.it_alloc.shape[0]), dtype=torch.bool, device=dev),
    )
    bad_survivor = ga.claim_active & ga.claim_has_reqs & (ga.claim_its & ~ok_it).any(dim=-1)

    # taint-admissibility (pod_tol_* are True where the pod tolerates the bin)
    rows = torch.arange(P, device=dev)
    tpl_of_pod = torch.clamp(ga.claim_tpl.long()[ci_safe], 0, max(TPL - 1, 0))
    bad_taint_claim = on_claim & ~gp.pod_tol_tpl[rows, tpl_of_pod]
    if N:
        ni_safe = torch.clamp(ni, 0, N - 1)
        bad_taint_node = on_node & ~gp.pod_tol_node[rows, ni_safe]
    else:
        bad_taint_node = torch.zeros((P,), dtype=torch.bool, device=dev)
    taint_count = bad_taint_claim.sum() + bad_taint_node.sum()

    # host-port: a pod's conflict lanes are used by no OTHER pod in its bin
    # and not pre-used by its node
    PT = gp.pod_ports.shape[1]
    B = C + N
    bidx = torch.where(placed, pod_bin, torch.full_like(pod_bin, B))
    ports_i = gp.pod_ports.to(torch.int32)
    cnt = torch.zeros((B + 1, PT), dtype=torch.int32, device=dev)
    cnt.index_add_(0, bidx, ports_i)
    cnt = cnt[:B]
    pre = torch.zeros((B, PT), dtype=torch.int32, device=dev)
    if N:
        pre[C:] = gp.node_used_ports.to(torch.int32)
    bidx_safe = torch.clamp(bidx, 0, B - 1)
    others = cnt[bidx_safe] - ports_i + pre[bidx_safe]
    bad_port = placed & (gp.pod_port_conflict & (others > 0)).any(dim=-1)

    # requirement-intersection: each checked pod's row intersects its bin's
    # published/narrowed row
    lv, ln = statics.lv, statics.ln
    pod_packed = masks.pack_req(gp.pod_reqs, lv, ln, bounds_free)
    bin_packed = masks.pack_req(ga.claim_req, lv, ln, bounds_free)
    if N:
        bin_packed = torch.cat([bin_packed, masks.pack_req(gp.node_reqs, lv, ln, bounds_free)])
    ok_int = masks.packed_intersects_ok(bin_packed[bidx_safe], pod_packed, bounds_free)
    claim_side = on_claim & ga.claim_has_reqs[ci_safe]
    bad_intersect = ga.pod_check & (claim_side | on_node) & ~ok_int

    # node-capacity: overhead plus landed pods fits, on nodes that got pods
    if N:
        nsum = torch.zeros((N + 1, R), dtype=torch.float32, device=dev)
        nsum.index_add_(0, ni, gp.pod_requests)
        got = torch.zeros((N + 1,), dtype=torch.int32, device=dev)
        got.index_add_(0, ni, torch.ones_like(ni, dtype=torch.int32))
        bad_node = (got[:N] > 0) & ~masks.fits(gp.node_overhead + nsum[:N], gp.node_avail)
        node_count = bad_node.sum()
    else:
        node_count = torch.zeros((), dtype=torch.int64, device=dev)

    return torch.stack(
        [
            bad_requests.sum(),
            bad_capacity.sum(),
            bad_survivor.sum(),
            taint_count,
            bad_port.sum(),
            bad_intersect.sum(),
            node_count,
        ]
    ).to(torch.int32)


# -- the gate_counts kernel's argument struct (csrc/gate_counts.cu) -----------

_GATE_POINTERS = (
    "lvw", "ln",
    "pod_adm", "pod_comp", "pod_def", "pod_gt", "pod_lt", "pod_neg",
    "pod_requests", "pod_tol_tpl", "pod_tol_node", "pod_ports", "pod_conflict",
    "it_adm", "it_comp", "it_def", "it_gt", "it_lt", "it_neg",
    "it_alloc", "offer_zone", "offer_ct", "offer_ok", "tpl_overhead",
    "node_adm", "node_comp", "node_def", "node_gt", "node_lt", "node_neg",
    "node_avail", "node_overhead", "node_used_ports",
    "claim_adm", "claim_comp", "claim_def", "claim_gt", "claim_lt", "claim_neg",
    "claim_tpl", "claim_active", "claim_reported", "claim_its", "claim_has_reqs",
    "pod_bin", "pod_check", "kind", "index",
    "summed", "nsum", "ngot", "port_cnt", "neg_out", "counts",
)
# the kernel's zeroed accumulators, neither read before nor kept after it
GATE_SCRATCH = ("summed", "nsum", "ngot", "port_cnt")
# fused mode adds the claim rows' polarity, computed and read in the launch
# (written as neg_out, read as claim_neg)
GATE_FUSED_SCRATCH = GATE_SCRATCH + ("neg_out", "claim_neg")
_GATE_INTS = ("P", "K", "W", "T", "TPL", "C", "N", "R", "O", "PT")
_GateKernelArgs = kernels.make_struct("GateKernelArgs", _GATE_POINTERS, _GATE_INTS)


def _packed_rows(prefix: str, r: ReqTensor, lv, ln, out: dict) -> None:
    out[prefix + "_adm"] = masks.pack_lanes(r.admitted).contiguous()
    out[prefix + "_comp"] = r.comp.contiguous()
    out[prefix + "_def"] = r.defined.contiguous()
    out[prefix + "_gt"] = r.gt.to(torch.int32).contiguous()
    out[prefix + "_lt"] = r.lt.to(torch.int32).contiguous()
    out[prefix + "_neg"] = masks.negative_polarity(r, lv, ln).contiguous()


def launch_gate_counts(gp: GateProblem, ga: GateArgs) -> torch.Tensor:
    """The ``gate_counts`` kernel on CUDA tensors (general bounded arm, equal
    to the bounds-free arm on bounds-free problems)."""
    dev = gp.pod_requests.device
    if dev.type != "cuda":
        raise ValueError("launch_gate_counts needs CUDA tensors")
    t, args = gate_counts_args(gp, ga)
    kernels.launch("gate_counts", args, torch.cuda.current_stream(dev).cuda_stream)
    return t["counts"]


def gate_counts_args(gp: GateProblem, ga: GateArgs):
    """The kernel's tensors by struct field name (inputs in its layout,
    zeroed accumulators, the counts) and its argument struct: one launch's
    worth, as ``launch_gate_counts`` passes it."""
    lv, ln = gp.lane_valid, gp.lane_numeric
    V = lv.shape[1]
    if V % 32:
        raise ValueError(f"gate_counts needs a lane axis padded to a multiple of 32, got {V}")
    t: dict = {"lvw": masks.pack_lanes(lv).contiguous(), "ln": ln.contiguous()}
    _packed_rows("pod", gp.pod_reqs, lv, ln, t)
    _packed_rows("it", gp.it_reqs, lv, ln, t)
    _packed_rows("node", gp.node_reqs, lv, ln, t)
    _packed_rows("claim", ga.claim_req, lv, ln, t)
    for name, src in (
        ("pod_requests", gp.pod_requests), ("pod_tol_tpl", gp.pod_tol_tpl),
        ("pod_tol_node", gp.pod_tol_node), ("pod_ports", gp.pod_ports),
        ("pod_conflict", gp.pod_port_conflict), ("it_alloc", gp.it_alloc),
        ("offer_zone", gp.offer_zone), ("offer_ct", gp.offer_ct), ("offer_ok", gp.offer_ok),
        ("tpl_overhead", gp.tpl_overhead), ("node_avail", gp.node_avail),
        ("node_overhead", gp.node_overhead), ("node_used_ports", gp.node_used_ports),
        ("claim_tpl", ga.claim_tpl), ("claim_active", ga.claim_active),
        ("claim_reported", ga.claim_reported), ("claim_its", ga.claim_its),
        ("claim_has_reqs", ga.claim_has_reqs), ("pod_bin", ga.pod_bin), ("pod_check", ga.pod_check),
    ):
        t[name] = src.contiguous()
    t["kind"] = t["index"] = t["neg_out"] = None
    return _gate_struct(t)


def _gate_struct(t: dict):
    """Zeroed accumulators and the counts added to ``t``, and the argument
    struct, with the dimensions read from the tables' shapes."""
    dev = t["ln"].device
    K, W = t["lvw"].shape
    P, R = t["pod_requests"].shape
    C, N, PT = t["claim_tpl"].shape[0], t["node_avail"].shape[0], t["pod_ports"].shape[1]
    t["summed"] = torch.zeros((C, R), dtype=torch.float32, device=dev)
    t["nsum"] = torch.zeros((N, R), dtype=torch.float32, device=dev)
    t["ngot"] = torch.zeros((N,), dtype=torch.int32, device=dev)
    t["port_cnt"] = torch.zeros((C + N, PT), dtype=torch.int32, device=dev)
    t["counts"] = torch.zeros((len(INVARIANTS),), dtype=torch.int32, device=dev)
    dims = dict(P=P, K=K, W=W, T=t["it_alloc"].shape[0], TPL=t["tpl_overhead"].shape[0],
                C=C, N=N, R=R, O=t["offer_ok"].shape[1], PT=PT)
    args = _GateKernelArgs(**{name: (t[name].data_ptr() if t[name] is not None else None)
                              for name in _GATE_POINTERS}, **dims)
    return t, args


def gate_args_from_state(state, kind, index, pod_check, max_claims) -> GateArgs:
    """GateArgs of a solve's own final state (the JAX package's
    ops/fused.py:283-299): a pod's bin is its claim slot on a claim, C + its
    node on a node, else -1; the claim rows are the state's (the minted
    hostname pin included), active and with requirements where the claim is
    open, reported requests the accumulated ones, listed types the
    surviving ones."""
    from karpenter_tpu_torch.ops.ffd_core import KIND_CLAIM, KIND_NEW_CLAIM, KIND_NODE

    C = int(max_claims)
    on_claim = (kind == KIND_CLAIM) | (kind == KIND_NEW_CLAIM)
    on_node = kind == KIND_NODE
    pod_bin = torch.where(on_claim, index, torch.where(on_node, C + index, torch.full_like(index, -1)))
    return GateArgs(
        claim_req=state.claim_req,
        claim_tpl=state.claim_tpl,
        claim_active=state.claim_open,
        claim_reported=state.claim_requests,
        claim_its=state.claim_it_ok,
        claim_has_reqs=state.claim_open,
        pod_bin=pod_bin.to(torch.int32),
        pod_check=pod_check,
    )


# gate_counts' fused-mode inputs taken from a resident world (ops/fused.py):
# struct field <- world field
_FUSED_FROM_WORLD = (
    *((name, name) for name in (
        "lvw", "ln", "pod_adm", "pod_comp", "pod_def", "pod_gt", "pod_lt", "pod_neg",
        "pod_requests", "pod_tol_tpl", "pod_tol_node", "pod_ports", "pod_conflict",
        "it_adm", "it_comp", "it_def", "it_gt", "it_lt", "it_neg",
        "it_alloc", "offer_zone", "offer_ct", "offer_ok", "tpl_overhead",
        "node_avail", "node_overhead", "node_used_ports",
        "claim_adm", "claim_comp", "claim_def", "claim_gt", "claim_lt", "claim_tpl", "kind", "index",
    )),
    ("node_adm", "nreq_adm"), ("node_comp", "nreq_comp"), ("node_def", "nreq_def"),
    ("node_gt", "nreq_gt"), ("node_lt", "nreq_lt"), ("node_neg", "nreq_neg"),
    ("claim_active", "claim_open"), ("claim_reported", "claim_requests"),
    ("claim_its", "claim_it_ok"), ("claim_has_reqs", "claim_open"),
)


def gate_fused_args(world: dict, pod_check):
    """gate_counts' fused-mode tensors by struct field name and its argument
    struct, over ``world``: a resident world's tables with ``ffd_loop``'s
    final state and kind/index added (ops/fused.solve_ffd_fused_gate), all
    in the kernels' layout and read where they lie."""
    P = world["pod_requests"].shape[0]
    if pod_check.shape != (P,) or pod_check.dtype != torch.bool or pod_check.device != world["ln"].device:
        raise ValueError(f"pod_check must be bool[{P}] on {world['ln'].device}")
    t = {name: world[src] for name, src in _FUSED_FROM_WORLD}
    C, K = t["claim_comp"].shape
    t["neg_out"] = torch.empty((C, K), dtype=torch.bool, device=pod_check.device)
    t["claim_neg"] = t["neg_out"]
    t["pod_bin"] = None
    t["pod_check"] = pod_check.contiguous()
    return _gate_struct(t)


def launch_gate_counts_fused(world: dict, pod_check) -> torch.Tensor:
    """The ``gate_counts`` kernel in its fused mode on CUDA tensors (see
    ``gate_fused_args``): the i32[7] counts, not synchronised."""
    dev = world["ln"].device
    if dev.type != "cuda":
        raise ValueError("launch_gate_counts_fused needs CUDA tensors")
    t, args = gate_fused_args(world, pod_check)
    kernels.launch("gate_counts", args, torch.cuda.current_stream(dev).cuda_stream)
    return t["counts"]


def verify_gate(gp: GateProblem, ga: GateArgs, bounds_free: bool) -> torch.Tensor:
    """i32[7] violation counts: the ``gate_counts`` kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if gp.pod_requests.is_cuda:
        return launch_gate_counts(gp, ga)
    return gate_counts_plain(gp, ga, bounds_free)


def gate_bounds_free(gp: GateProblem) -> bool:
    """No requirement tensor the gate reads carries a finite Gt/Lt bound."""
    for r in (gp.pod_reqs, gp.it_reqs, gp.tpl_reqs, gp.node_reqs):
        gt, lt = torch.as_tensor(r.gt), torch.as_tensor(r.lt)
        if gt.numel() and (bool((gt != int(GT_NONE)).any()) or bool((lt != int(LT_NONE)).any())):
            return False
    return True


def gate_args_to(ga: GateArgs, device) -> GateArgs:
    """GateArgs of numpy arrays (as gate.py builds them) as torch tensors."""
    from karpenter_tpu_torch.models.problem import _tensor

    req = ga.claim_req
    return GateArgs(
        claim_req=ReqTensor(*(_tensor(x, device) for x in (req.admitted, req.comp, req.gt, req.lt, req.defined))),
        **{f: _tensor(getattr(ga, f), device) for f in GateArgs._fields if f != "claim_req"},
    )
