"""Cross-tenant batching: stack compatible solves into one kernel launch.

Counterpart of the JAX package's ``serve/batch.py``. When several tenant
streams have generic, shape-compatible requests queued at the same instant,
the dispatcher stacks them into one ``parallel/mesh.batched_screen`` call:
each tenant's whole problem is one lane of the ``runs_screen`` kernel's
stacked mode (a cluster of blocks per lane when its few lanes are wide, up
to three placement passes from the lane's own initial state), so the launch
and the transfers are paid once for the group.

Strictly opportunistic:

  * only structurally simple requests qualify (``batchable``): no existing
    nodes, no overrides/volumes/topology arguments, nothing relaxable, a
    cold warm-state stream, a closed circuit, and a ``TorchSolver`` at the
    bottom of the tenant's stack. Everything else takes the tenant's own
    supervised solve.
  * every decoded lane passes the FULL-level validator before it is
    returned.
  * stacked results never seed streaming state: the tenant's
    ``StreamingSolver`` stays cold, so a later warm cycle diffs against
    nothing this path produced.
  * fault injection disables stacking wholesale (``faults.active()``): a
    chaos run's per-tenant blast radius must see one stream per solve site.

A lane stands down to its tenant's solo solve only for a classified reason
(``STANDDOWNS``): its padded shape differs from the group's lead, the group
has a single lane, a row reports KIND_NO_SLOT (the shared claim bucket
overflowed), the validator found a violation, or a claim opened with no pod
in it. Here the port differs from the reference, which swallows every
exception in the stacked path and re-serves the group solo: a kernel build
or launch error, a CUDA error or a decode error propagates to the
dispatcher, which resolves the group's tickets as ``error`` outcomes naming
it (as the device-resident world of streaming/device_world.py does: errors
raise, only classified reasons stand down). The tenant's solo solve keeps
the same rule: its supervisor raises the kernels' and the CUDA runtime's
errors instead of failing over to the host oracle (solver/supervisor.py).

The decode mirrors the torch backend's final decode (rows via
``meta.pod_order``, claims via the state's slot tensors and
``decode_claim_requirements``) for the no-existing-nodes case.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
from karpenter_tpu_torch.ops.ffd_core import KIND_CLAIM, KIND_NEW_CLAIM, KIND_NODE, KIND_NO_SLOT
from karpenter_tpu_torch.ops.padding import claim_axis_bucket, pad_problem
from karpenter_tpu_torch.provisioning.preferences import Preferences
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.solver import validator as val
from karpenter_tpu_torch.solver.backend import FAIL_INCOMPATIBLE, Placement, SolveResult
from karpenter_tpu_torch.solver.encode import Encoder, domains_from_instance_types
from karpenter_tpu_torch.solver.torch_backend import (
    TorchSolver,
    decode_claim_requirements,
    fetch_claims,
    resolve_device,
)
from karpenter_tpu_torch.testing import faults

# a lane's classified stand-down reasons (None = the lane was answered)
STANDDOWN_SINGLE = "single-lane"
STANDDOWN_SHAPE = "shape-mismatch"
STANDDOWN_SLOT = "slot-overflow"
STANDDOWN_VALIDATOR = "validator"
STANDDOWN_EMPTY_CLAIM = "empty-claim"
STANDDOWNS = (STANDDOWN_SINGLE, STANDDOWN_SHAPE, STANDDOWN_SLOT, STANDDOWN_VALIDATOR, STANDDOWN_EMPTY_CLAIM)

# generic-kwargs contract a batchable request must satisfy: anything beyond
# these defaults (pinned nodes, overrides, explicit topology, volumes) keeps
# the request on the tenant's own solve path
_GENERIC_KWARGS = {
    "nodes": (),
    "pod_requirements_override": None,
    "topology": None,
    "cluster_pods": (),
    "domains": None,
    "pod_volumes": None,
}


def _unwrap_inner(solver):
    """Walk SupervisedSolver.primary and StreamingSolver.inner to the backend
    that would run; returns it and the streaming layer, if any."""
    streaming = None
    seen = set()
    while id(solver) not in seen:
        seen.add(id(solver))
        if hasattr(solver, "primary"):
            solver = solver.primary
            continue
        if hasattr(solver, "inner") and hasattr(solver, "reset_streaming_state"):
            streaming = solver
            solver = solver.inner
            continue
        break
    return solver, streaming


def batchable(request, solver) -> bool:
    """Can this request ride a cross-tenant stacked dispatch? Conservative by
    design: a False here costs one solo solve, a wrong True could cost
    correctness."""
    if faults.active() is not None:
        return False
    if not request.pods:
        return False
    for key, default in _GENERIC_KWARGS.items():
        value = request.kwargs.get(key, default)
        if key in ("nodes", "cluster_pods"):
            if len(value or ()) != 0:
                return False
        elif value is not None:
            return False
    # anything relaxable needs the per-pass host relax loop (mirrors the
    # backend's use_sweeps condition)
    if any(
        t.effect == "PreferNoSchedule"
        for tpl in request.templates
        for t in tpl.taints
    ):
        return False
    if any(Preferences.is_relaxable(p) for p in request.pods):
        return False
    circuit = getattr(solver, "circuit_state", None)
    if circuit is not None and circuit() != "closed":
        return False
    inner, streaming = _unwrap_inner(solver)
    if streaming is not None and streaming._prev is not None:
        # a warm stream's next answer depends on carried state; only cold
        # streams can take the stateless stacked path
        return False
    return isinstance(inner, TorchSolver)


def _shape_key(problem) -> tuple:
    """The padded problem's leaves by name, shape and dtype: lanes with equal
    keys stack."""
    return tuple((name, x.shape, str(x.dtype)) for name, x in numpy_fields(problem).items())


def _decode_lane(pods, instance_types, templates, meta, max_claims, kinds, indices, claims):
    """One lane of the stacked result back into the host model. Returns
    (result, None), or (None, reason) for a classified stand-down."""
    (claim_open, claim_tpl, claim_it_ok, claim_requests,
     claim_adm, claim_comp, claim_gt, claim_lt, claim_def) = claims
    n_real = len(meta.pod_order)
    if (np.asarray(kinds[:n_real]) == KIND_NO_SLOT).any():
        return None, STANDDOWN_SLOT
    out = SolveResult()
    slot_to_claim = {}
    for slot in range(max_claims):
        if slot < len(claim_open) and claim_open[slot]:
            tpl_idx = int(claim_tpl[slot])
            placement = Placement(
                template_index=tpl_idx,
                nodepool_name=meta.template_names[tpl_idx],
                instance_type_indices=[
                    int(t)
                    for t in np.flatnonzero(claim_it_ok[slot])
                    if t < len(meta.instance_type_names)
                ],
                requirements=decode_claim_requirements(
                    meta, claim_adm[slot], claim_comp[slot],
                    claim_gt[slot], claim_lt[slot], claim_def[slot],
                ),
                requests={
                    name: float(claim_requests[slot, ri])
                    for ri, name in enumerate(meta.resource_names)
                    if claim_requests[slot, ri] > 0
                },
            )
            slot_to_claim[slot] = placement
            out.new_claims.append(placement)
    failed = []
    for row in range(n_real):
        orig = meta.pod_order[row]
        kind, index = int(kinds[row]), int(indices[row])
        if kind == KIND_NODE:
            out.node_pods.setdefault(meta.node_names[index], []).append(orig)
        elif kind in (KIND_CLAIM, KIND_NEW_CLAIM) and index in slot_to_claim:
            slot_to_claim[index].pod_indices.append(orig)
        else:
            failed.append(orig)
    if failed:
        from karpenter_tpu_torch.solver.forensics import failure_reason

        for orig in failed:
            out.failures[orig] = failure_reason(
                pods[orig], instance_types, templates,
                well_known=wk.WELL_KNOWN_LABELS,
            ) or FAIL_INCOMPATIBLE
    # claims no pod landed in would launch empty capacity — stand down
    # instead (the solo path never produces them)
    if any(not c.pod_indices for c in out.new_claims):
        return None, STANDDOWN_EMPTY_CLAIM
    return out, None


def stacked_solve(group: Sequence, device=None, stats: Optional[Dict] = None) -> List[Optional[SolveResult]]:
    """Solve a group of batchable requests in one ``batched_screen`` launch
    on ``device`` (CUDA unless ``device="cpu"``). Returns one entry per
    request: a validator-clean SolveResult, or None where the lane stood
    down for a classified reason (that request then runs its tenant's solo
    solve). Errors propagate (module docstring).

    ``stats``, when given, is filled with the lanes that rode the launch,
    each request's stand-down reason (None when answered), the shared claim
    bucket, and the wall milliseconds of the encode, the launch with its
    fetch, the decode and the validation."""
    from karpenter_tpu_torch.parallel.mesh import batched_screen, stack_problems

    dev = resolve_device(device)
    results: List[Optional[SolveResult]] = [None] * len(group)
    reasons: List[Optional[str]] = [STANDDOWN_SINGLE] * len(group)
    timing = {"encode_ms": 0.0, "device_ms": 0.0, "decode_ms": 0.0, "validate_ms": 0.0}
    lanes: List[int] = []
    shared_claims = max((claim_axis_bucket(len(r.pods)) for r in group), default=0)
    if stats is not None:
        stats.update(lanes=lanes, reasons=reasons, max_claims=shared_claims, timing=timing)
    if len(group) < 2:
        return results
    t0 = time.perf_counter()
    encoded = []
    for r in group:
        domains = domains_from_instance_types(r.instance_types, r.templates)
        topo = Topology(domains, batch_pods=list(r.pods), cluster_pods=())
        enc = Encoder(wk.WELL_KNOWN_LABELS).encode(
            list(r.pods), r.instance_types, r.templates, (),
            topology=topo, num_claim_slots=shared_claims,
            vocab_pods=list(r.pods),
        )
        encoded.append((pad_problem(enc.problem), enc.meta))
    key0 = _shape_key(encoded[0][0])
    lanes += [i for i in range(len(group)) if _shape_key(encoded[i][0]) == key0]
    for i in range(len(group)):
        if i not in lanes:
            reasons[i] = STANDDOWN_SHAPE
    if len(lanes) < 2:
        del lanes[:]
        return results
    batch = problem_to_torch(stack_problems([encoded[i][0] for i in lanes]), dev)
    timing["encode_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fr = batched_screen(batch, shared_claims)
    kinds, indices = fr.kind.cpu().numpy(), fr.index.cpu().numpy()
    claims = fetch_claims(fr.state)
    timing["device_ms"] = (time.perf_counter() - t0) * 1e3
    for li, i in enumerate(lanes):
        r = group[i]
        t0 = time.perf_counter()
        decoded, reason = _decode_lane(
            list(r.pods), r.instance_types, r.templates, encoded[i][1], shared_claims,
            kinds[li], indices[li], tuple(x[li] for x in claims),
        )
        timing["decode_ms"] += (time.perf_counter() - t0) * 1e3
        if decoded is None:
            reasons[i] = reason
            continue
        t0 = time.perf_counter()
        violations = val.validate_result(
            decoded, list(r.pods), r.instance_types, r.templates,
            nodes=(), level="full",
        )
        timing["validate_ms"] += (time.perf_counter() - t0) * 1e3
        if violations:
            reasons[i] = STANDDOWN_VALIDATOR
            continue
        reasons[i] = None
        results[i] = decoded
    return results
