"""Composite placement gate: device program + host screen + sampled audit.

The flow for one result (``full_gate``):

  1. host structural screen — O(P) python over the decoded result: pod
     accounting, index ranges, NaN, claim template/empty/instance-type
     structure, node names, request keys outside the encoded resource axis.
     These are exactly the checks a tensor program cannot express (they
     guard whether the placement can even be mapped onto the problem axes).
  2. device invariant program (verify/device.py, the gate_counts kernel on
     the card) over the SAME padded problem tensors the solve consumed
     (stashed on the result as a GateContext by solver/torch_backend.py;
     a device-resident solve brings its fused counts instead), re-checking the
     published claims/placements: claim-requests, claim-capacity,
     instance-type-survivor, taints, host-ports, requirement intersection,
     node-capacity.
  3. host topology-skew check — cheap after the validator's content-keyed
     cohort dedup, and it needs exact python cohort semantics, so it stays
     on the host.
  4. sampled float64 audit — a seeded random subset
     (``KARPENTER_TPU_VERIFY_AUDIT_FRAC``, default AUDIT_FRAC) of
     claims/nodes re-run through solver/validator.py at full level every
     cycle; solver/validator.py remains ground truth, the device program is
     only ever an accelerator of it.

Any reject signal — screen hit, nonzero device counts, skew violation, audit
mismatch — routes through ONE confirmation: the full host validator runs and
ITS violation list is returned (GateOutcome.audit_outcome records
reject_confirmed / reject_overturned). So a device-gate bug can cost a host
re-validation, never a wrong accept or a wrong reject, and callers always
strip/quarantine off canonical host Violations.

``full_gate`` returns None only where the device gate does not apply to the
call: no GateContext on the result (multi-pass solves), or a context that
does not describe this result (pod count, claim count, override). An error
in the device program, its kernel launch or the host checks is raised to the
caller: the gate never moves to the host validator on its own while the
tensors are on the card.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_ABS_TOL = 1e-6
_REL_TOL = 1e-4


# the default per-cycle probability that each accepted claim/node is
# re-checked by the float64 host validator, and the default seed of that draw
AUDIT_FRAC = 0.05
AUDIT_SEED = 0


def enabled() -> bool:
    """KARPENTER_TPU_DEVICE_GATE (default on), as the JAX package reads it.
    The streaming warm path (streaming/warm.py) reads it to choose its exit
    gate: the incremental row-scoped check when on, the full host validator
    when off. ``full_gate`` itself always applies."""
    return os.environ.get("KARPENTER_TPU_DEVICE_GATE", "1") not in ("", "0")


def audit_frac() -> float:
    """KARPENTER_TPU_VERIFY_AUDIT_FRAC (default AUDIT_FRAC), clamped to
    [0, 1]; an unparsable value is the default."""
    raw = os.environ.get("KARPENTER_TPU_VERIFY_AUDIT_FRAC", str(AUDIT_FRAC))
    try:
        return max(0.0, min(1.0, float(raw)))
    except ValueError:
        return AUDIT_FRAC


def _audit_seed() -> int:
    try:
        return int(os.environ.get("KARPENTER_TPU_VERIFY_AUDIT_SEED", str(AUDIT_SEED)))
    except ValueError:
        return AUDIT_SEED


# deterministic per-process audit cadence: (seed, call ordinal) seeds the
# sampler so a replayed cycle audits the same rows (restart journals replay
# cycles in order) while successive cycles walk different subsets
_audit_calls = 0


def _audit_rng() -> random.Random:
    global _audit_calls
    _audit_calls += 1
    return random.Random((_audit_seed() << 20) ^ _audit_calls)


@dataclasses.dataclass
class GateContext:
    """Stashed by the torch backend on each single-pass (sweeps-mode) result:
    the padded problem + meta the solve consumed, which the device program
    re-reads so verification and solve see bit-identical tensors. Multi-pass
    relax-ladder solves never attach one (their final encoded problem covers
    only the last pass's queue) and fall back to the host validator."""

    problem: Any  # padded SchedulingProblem (host-side numpy)
    meta: Any  # ProblemMeta
    max_claims: int
    num_pods: int
    has_override: bool
    # the same problem already on the solve's device (torch tensors), so the
    # gate re-reads it without a second upload; None uploads ``problem`` to
    # ``device``
    device_problem: Any = None
    device: Any = "cpu"
    # a device-resident solve (streaming/device_world.py) already counted the
    # invariants in the fused gate over its own final state: the nonzero
    # counts by invariant (empty = device-accept), which full_gate uses in
    # place of a gate_counts launch. None = no fused counts.
    fused_counts: Optional[Dict[str, int]] = None
    # ``device_problem``'s tables in the kernels' layout as the solve's
    # ffd_loop launch read them (ops/ffd_core.FFDResult.tables): the gate
    # launch reads its lane words and pod and type rows from them instead of
    # packing them again. None = packed by the gate.
    device_tables: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class GateOutcome:
    violations: List[Any]
    mode: str  # "device" | "host-confirm"
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    audited: bool = False
    audit_outcome: Optional[str] = None


def make_context(
    problem, meta, max_claims, num_pods, has_override, device_problem=None, device="cpu",
    fused_counts=None, device_tables=None,
) -> GateContext:
    return GateContext(
        problem=problem, meta=meta, max_claims=int(max_claims),
        num_pods=int(num_pods), has_override=bool(has_override),
        device_problem=device_problem, device=device, fused_counts=fused_counts,
        device_tables=device_tables,
    )


def full_gate(
    result,
    pods: Sequence,
    instance_types: Sequence,
    templates: Sequence,
    nodes: Sequence = (),
    pod_requirements_override=None,
    cluster_pods: Sequence = (),
    domains=None,
) -> Optional[GateOutcome]:
    """Full-level verdict on ``result``, or None when the device gate does
    not apply to it (the caller then runs the host validator). Errors of the
    device program propagate."""
    ctx = getattr(result, "verify_ctx", None)
    if ctx is None or ctx.num_pods != len(pods):
        return None
    if len(result.new_claims) > ctx.max_claims:
        return None
    if ctx.has_override != (pod_requirements_override is not None):
        return None
    from karpenter_tpu_torch.metrics.registry import GATE_AUDIT, GATE_DURATION, measure
    from karpenter_tpu_torch.obs import trace

    host_args = (
        result, pods, instance_types, templates, nodes,
        pod_requirements_override, cluster_pods, domains,
    )
    with trace.span("gate") as sp, measure(GATE_DURATION, {"mode": "device"}):
        reject = _screen(result, pods, templates, instance_types, nodes, ctx)
        counts: Dict[str, int] = {}
        if reject is None:
            if ctx.fused_counts is not None:
                # the fused solve + gate already reduced the invariants over
                # the solver's own committed state; the screen above, the
                # skew check and the sampled audit below still cover the
                # published decode
                counts = dict(ctx.fused_counts)
            else:
                counts = _device_counts(ctx, result, pods, pod_requirements_override)
            if counts:
                reject = "device:" + ",".join(sorted(counts))
        if reject is None and _skew_check(*host_args):
            reject = "topology-skew"
        if sp is not None and reject is not None:
            sp.attrs["reject"] = reject

    if reject is not None:
        # every reject is host-confirmed before anyone acts on it: the
        # canonical violation list (and hence strip/quarantine behavior)
        # always comes from the float64 validator
        violations = _host_full(*host_args)
        GATE_AUDIT.inc({"outcome": "reject_confirmed" if violations else "reject_overturned"})
        return GateOutcome(
            violations=violations, mode="host-confirm", counts=counts,
            audited=True,
            audit_outcome="reject_confirmed" if violations else "reject_overturned",
        )

    outcome = GateOutcome(violations=[], mode="device", counts=counts)
    audit = _maybe_audit(*host_args)
    if audit is not None:
        outcome.audited = True
        if audit:
            # float64 disagrees with the device accept on a sampled row:
            # the full host gate governs this cycle
            GATE_AUDIT.inc({"outcome": "mismatch"})
            from karpenter_tpu_torch.obs import flight

            flight.record(flight.KIND_GATE_AUDIT, outcome="mismatch")
            violations = _host_full(*host_args)
            return GateOutcome(
                violations=violations, mode="host-confirm", counts=counts,
                audited=True, audit_outcome="mismatch",
            )
        GATE_AUDIT.inc({"outcome": "match"})
        outcome.audit_outcome = "match"
    return outcome


def gate_relaxed(
    result, pods, instance_types, templates, nodes=(),
    pod_requirements_override=None, cluster_pods=(), domains=None,
) -> List[Any]:
    """The gate of the two-phase solve (solver/torch_backend.py): phase-1
    placements are validator-equivalent to FFD rather than identical, so
    every relaxed result is gated before the backend returns it. The
    composite verdict of ``full_gate`` where the result carries a context,
    the host ``full_gate_relaxed`` otherwise. Device errors propagate."""
    outcome = full_gate(
        result, pods, instance_types, templates, nodes,
        pod_requirements_override, cluster_pods, domains,
    )
    if outcome is not None:
        return outcome.violations
    from karpenter_tpu_torch.solver.validator import full_gate_relaxed

    return full_gate_relaxed(
        result, pods, instance_types, templates, nodes,
        pod_requirements_override, cluster_pods, domains,
    )


# -- host-side pieces ----------------------------------------------------------


def _host_full(
    result, pods, instance_types, templates, nodes,
    pod_requirements_override, cluster_pods, domains,
) -> List[Any]:
    from karpenter_tpu_torch.metrics.registry import GATE_DURATION, measure
    from karpenter_tpu_torch.solver.validator import validate_result

    with measure(GATE_DURATION, {"mode": "host"}):
        return validate_result(
            result, pods, instance_types, templates, nodes,
            pod_requirements_override, cluster_pods, domains, level="full",
        )


def _skew_check(
    result, pods, instance_types, templates, nodes,
    pod_requirements_override, cluster_pods, domains,
) -> List[Any]:
    from karpenter_tpu_torch.solver.validator import _check_topology_skew

    return _check_topology_skew(
        result, pods, instance_types, templates, nodes,
        pod_requirements_override, cluster_pods, domains,
    )


def _maybe_audit(
    result, pods, instance_types, templates, nodes,
    pod_requirements_override, cluster_pods, domains,
) -> Optional[List[Any]]:
    """Float64 spot-check of an accepted result: every claim/node is drawn
    into the sample at ``audit_frac()``, and the sampled subset runs through the
    host validator at full level (accounting always rides along — it is
    O(P) and the one cross-bin invariant). Returns None when nothing was
    sampled, else the sampled violations (empty = match)."""
    frac = audit_frac()
    if frac <= 0.0:
        return None
    rng = _audit_rng()
    claim_scope = {
        ci for ci in range(len(result.new_claims)) if rng.random() < frac
    }
    node_scope = {name for name in result.node_pods if rng.random() < frac}
    if not claim_scope and not node_scope:
        return None
    from karpenter_tpu_torch.metrics.registry import GATE_DURATION, measure
    from karpenter_tpu_torch.solver.validator import validate_result

    with measure(GATE_DURATION, {"mode": "audit"}):
        return validate_result(
            result, pods, instance_types, templates, nodes,
            pod_requirements_override, cluster_pods, domains, level="full",
            claim_scope=claim_scope, node_scope=node_scope,
            check_topology=False,
        )


def _screen(result, pods, templates, instance_types, nodes, ctx) -> Optional[str]:
    """Structural host screen: returns a short reject reason, or None when
    the placement is structurally sound and mappable onto the problem axes.
    Detection only — the host validator produces the canonical violations on
    the confirm path."""
    meta = ctx.meta
    num_pods = len(pods)
    seen = set()

    def account(pi) -> Optional[str]:
        if not isinstance(pi, int) or not 0 <= pi < num_pods:
            return "pod-range"
        if pi in seen:
            return "pod-duplicate"
        seen.add(pi)
        return None

    res_index = {name: ri for ri, name in enumerate(meta.resource_names)}
    for claim in result.new_claims:
        if not 0 <= claim.template_index < len(templates):
            return "claim-template"
        if not claim.pod_indices:
            return "claim-empty"
        if not claim.instance_type_indices:
            return "claim-instance-types"
        for ti in claim.instance_type_indices:
            if not 0 <= ti < len(instance_types):
                return "claim-instance-types"
        for key, value in claim.requests.items():
            v = float(value)
            if v != v or v in (float("inf"), float("-inf")):
                return "nan"
            if key not in res_index and abs(v) > _ABS_TOL + _REL_TOL * abs(v):
                # a request on a resource the encode never saw cannot be
                # checked on-device; nonzero means the host must arbitrate
                return "resource-axis"
        for pi in claim.pod_indices:
            bad = account(pi)
            if bad:
                return bad
    node_names = set(meta.node_names)
    for name, indices in result.node_pods.items():
        if name not in node_names or name not in {n.name for n in nodes}:
            return "node-unknown"
        for pi in indices:
            bad = account(pi)
            if bad:
                return bad
    for pi in result.failures:
        bad = account(pi)
        if bad:
            return bad
    if len(seen) != num_pods:
        return "pod-dropped"
    return None


# -- device dispatch -----------------------------------------------------------


def _nbytes(tree) -> int:
    """Bytes of every array or tensor leaf of a (nested) named tuple or
    dataclass."""
    if tree is None:
        return 0
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if hasattr(tree, "element_size"):
        return int(tree.numel() * tree.element_size())
    if isinstance(tree, tuple):
        return sum(_nbytes(x) for x in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_nbytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


# the gate's program keys dispatched so far (the JAX gate's set of the same
# name); feeds solver_compile_cache_total
_SEEN_GATE_PROGRAMS: set = set()


def _device_counts(ctx, result, pods, pod_requirements_override) -> Dict[str, int]:
    """Build the gate tensors for ``result`` against the stashed problem, run
    the invariant program on the solve's device, and return the nonzero
    per-invariant counts (empty dict = device-accept)."""
    from karpenter_tpu_torch.metrics.registry import COMPILE_CACHE, TRANSFER_BYTES
    from karpenter_tpu_torch.obs import programs, trace
    from karpenter_tpu_torch.verify import device as dev

    gp, ga, bf = _build_args(ctx, result, pods, pod_requirements_override)
    # the JAX gate's program-cache key: claim bucket, bounds_free, shapes
    key = ("verify_gate", int(ctx.max_claims), bool(bf), programs.shape_key(gp))
    cache_hit = key in _SEEN_GATE_PROGRAMS
    _SEEN_GATE_PROGRAMS.add(key)
    COMPILE_CACHE.inc({"result": "hit" if cache_hit else "miss"})
    # what this wrapper hands to the device: the result's GateArgs, and the
    # problem when the solve left no copy of it there
    h2d = _nbytes(ga) + (_nbytes(ctx.problem) if ctx.device_problem is None else 0)
    TRANSFER_BYTES.inc({"direction": "h2d"}, h2d)
    obs = programs.begin_dispatch("verify_gate", ctx.max_claims, gp, statics={"bf": int(bf)}, kernel="gate_counts")
    with trace.span("gate_program", program="verify_gate") as sp:
        counts = dev.verify_gate(gp, ga, bf, ctx.device_tables).cpu().numpy()
        TRANSFER_BYTES.inc({"direction": "d2h"}, int(counts.nbytes))
        if obs is not None:
            programs.stamp(sp, obs, obs.finish(problem_bytes=_nbytes((gp, ga)), result_bytes=int(counts.nbytes)))
        nonzero = {
            dev.INVARIANTS[i]: int(counts[i])
            for i in range(len(dev.INVARIANTS))
            if counts[i]
        }
        if sp is not None:
            for name, n in nonzero.items():
                sp.count(name, n)
    return nonzero


def _build_args(ctx, result, pods, pod_requirements_override):
    """Map the decoded result onto the problem axes: pod rows via the
    inverse of meta.pod_order (identity in sweeps mode, but do not rely on
    it), claims onto the slot axis in publication order, nodes onto the
    node axis via meta.node_names. Claim requirement rows re-encode the
    PUBLISHED claim.requirements through the same vocab the solve used
    (streaming/delta.py reconstructs it exactly from meta), so the device
    checks what the caller will act on, not solver internals."""
    from karpenter_tpu_torch.models.problem import GT_NONE, LT_NONE, problem_to_torch
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
    from karpenter_tpu_torch.scheduling import Requirements
    from karpenter_tpu_torch.solver.encode import encode_reqs_with_vocab, vocab_from_meta
    from karpenter_tpu_torch.solver.validator import checked_requirements
    from karpenter_tpu_torch.verify import device as dev

    meta = ctx.meta
    problem = ctx.problem
    if np.asarray(problem.lane_valid).shape[1] % 32:
        raise ValueError("the gate expects a problem from ops/padding.pad_problem")
    device_problem = ctx.device_problem
    if device_problem is None:
        device_problem = problem_to_torch(problem, ctx.device)
    device_problem = _pad_lanes_mult32(device_problem)  # no-op on the bucketed path
    gp = dev.gate_problem(device_problem)
    P = np.asarray(problem.pod_requests).shape[0]
    R = np.asarray(problem.pod_requests).shape[1]
    T = np.asarray(problem.it_alloc).shape[0]
    C = int(ctx.max_claims)

    row_of = np.full(len(pods), -1, dtype=np.int64)
    for row, orig in enumerate(meta.pod_order):
        if 0 <= orig < len(pods):
            row_of[orig] = row
    pod_bin = np.full(P, -1, dtype=np.int32)
    pod_check = np.zeros(P, dtype=bool)

    def place(pi: int, b: int) -> None:
        row = row_of[pi]
        if row < 0:
            raise ValueError(f"pod {pi} has no encoded row")
        pod_bin[row] = b
        if pod_requirements_override is not None:
            pod_check[row] = pod_requirements_override[pi] is not None
        else:
            pod_check[row] = checked_requirements(pods[pi]) is not None

    claims = result.new_claims
    claim_tpl = np.zeros(C, dtype=np.int32)
    claim_active = np.zeros(C, dtype=bool)
    claim_reported = np.zeros((C, R), dtype=np.float32)
    claim_its = np.zeros((C, T), dtype=bool)
    claim_has_reqs = np.zeros(C, dtype=bool)
    res_index = {name: ri for ri, name in enumerate(meta.resource_names)}
    for ci, claim in enumerate(claims):
        claim_tpl[ci] = claim.template_index
        claim_active[ci] = True
        claim_has_reqs[ci] = claim.requirements is not None
        for key, value in claim.requests.items():
            ri = res_index.get(key)
            if ri is not None and ri < R:
                claim_reported[ci, ri] = value
        for ti in claim.instance_type_indices:
            if 0 <= ti < T:
                claim_its[ci, ti] = True
        for pi in claim.pod_indices:
            place(pi, ci)
    node_index = {name: ni for ni, name in enumerate(meta.node_names)}
    for name, indices in result.node_pods.items():
        ni = node_index[name]
        for pi in indices:
            place(pi, C + ni)

    vocab = vocab_from_meta(meta)
    lane_valid = np.asarray(problem.lane_valid)
    empty = Requirements()
    entities = [
        c.requirements if c.requirements is not None else empty for c in claims
    ]
    entities.extend([empty] * (C - len(claims)))
    claim_req = encode_reqs_with_vocab(entities, vocab, lane_valid)

    bf = dev.gate_bounds_free(dev.gate_problem(problem))
    if bf:
        gt, lt = np.asarray(claim_req.gt), np.asarray(claim_req.lt)
        if gt.size and (np.any(gt != GT_NONE) or np.any(lt != LT_NONE)):
            # a published claim row carries an integer bound the sources
            # lacked: demote to the bounds-carrying program rather than
            # silently ignoring it
            bf = False
    ga = dev.GateArgs(
        claim_req=claim_req,
        claim_tpl=claim_tpl,
        claim_active=claim_active,
        claim_reported=claim_reported,
        claim_its=claim_its,
        claim_has_reqs=claim_has_reqs,
        pod_bin=pod_bin,
        pod_check=pod_check,
    )
    return gp, dev.gate_args_to(ga, device_problem.lane_valid.device), bf
