"""Row-scoped re-checks: the streaming warm path's ``incremental_gate`` and
the residual screen's ``screen_lane_gate`` (the JAX package's
``verify/incremental.py``).

``incremental_gate`` re-proves only the bins a warm merge touched
(streaming/warm.py): every claim built or re-narrowed from the sub-solve
fold-back and every existing node that received pods, with pod accounting
over the whole batch and topology skew whenever a touched pod carries a
spread constraint (the warm path's topology closure re-solves every
constrained pod together, so a skew cohort lies inside the touched set).
Untouched bins were proven when the previous result was accepted and their
pods' digests are unchanged; a seeded sample of them
(``KARPENTER_TPU_VERIFY_AUDIT_FRAC``) rides along each cycle, so a latent
corruption in a long-lived pin is still found. Any violation, touched or
sampled, rejects the warm result (the warm path then solves cold). It counts
``solver_gate_duration_seconds{mode="incremental"}`` and, when it sampled,
``solver_gate_audit_total{outcome}``.

A residual-screen lane (disruption/screen_delta.py) re-solves only its
resident rows against the carried base world, whose own solve went through
the solver. So only what the lane changed needs re-proving, on the host, from
the arrays the verdict decode fetches anyway (``screen_lane_gate``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Set

import numpy as np

from karpenter_tpu_torch.ops.ffd_core import KIND_NODE


@dataclasses.dataclass
class IncrementalScope:
    """What the warm merge touched this cycle, as validator scopes."""

    claim_indices: Set[int]
    node_names: Set[str]
    check_topology: bool
    total_claims: int
    total_nodes: int


def incremental_gate(result, pods: Sequence, instance_types: Sequence, templates: Sequence, nodes: Sequence,
                     scope: IncrementalScope, *, pod_requirements_override=None, cluster_pods: Sequence = (),
                     domains=None) -> List[Any]:
    """Scoped full-level host check of a warm result: the touched bins plus a
    seeded audit sample of the untouched ones. Returns the violation list
    (empty = accept), as ``validate_result`` does."""
    from karpenter_tpu_torch.metrics.registry import GATE_AUDIT, GATE_DURATION, measure
    from karpenter_tpu_torch.solver.validator import validate_result
    from karpenter_tpu_torch.verify.gate import _audit_rng, audit_frac

    claim_scope = set(scope.claim_indices)
    node_scope = set(scope.node_names)
    sampled_claims: Set[int] = set()
    sampled_nodes: Set[str] = set()
    frac = audit_frac()
    if frac > 0.0:
        rng = _audit_rng()
        sampled_claims = {ci for ci in range(scope.total_claims) if ci not in claim_scope and rng.random() < frac}
        sampled_nodes = {name for name in result.node_pods if name not in node_scope and rng.random() < frac}
        claim_scope |= sampled_claims
        node_scope |= sampled_nodes

    with measure(GATE_DURATION, {"mode": "incremental"}):
        violations = validate_result(
            result, pods, instance_types, templates, nodes, pod_requirements_override, cluster_pods, domains,
            level="full", claim_scope=claim_scope, node_scope=node_scope, check_topology=scope.check_topology,
        )

    if sampled_claims or sampled_nodes:
        # a violation pinned to a sampled-only bin means the previous
        # accept's trust was misplaced
        audit_hit = any(
            (v.claim_index in sampled_claims and v.claim_index not in scope.claim_indices)
            or (v.node_name in sampled_nodes and v.node_name not in scope.node_names)
            for v in violations
        )
        GATE_AUDIT.inc({"outcome": "mismatch" if audit_hit else "match"})
    return violations


@dataclasses.dataclass
class ScreenLaneScope:
    """What one residual-screen dispatch changed per lane: the pod rows each
    lane re-solved and the node rows it deleted."""

    resident_mask: np.ndarray  # bool [B, P]
    masked_nodes: np.ndarray  # bool [B, N]


def screen_lane_gate(kinds, indexes, scope: ScreenLaneScope, *, node_requests=None, node_avail=None,
                     carried_node_requests=None, eps: float = 1e-4) -> np.ndarray:
    """bool[B], True = the lane's verdict may be published. Always: no
    resident placed on a node its own lane deleted, every node placement in
    range. With the state arrays given (the deep recheck, which the screen
    always runs): accumulated node requests fit the available capacity on
    surviving rows, and deleted rows' accounting equals the carried base
    world's bit for bit. A failed lane is re-scored through the full screen."""
    from karpenter_tpu_torch.metrics.registry import GATE_DURATION, measure

    with measure(GATE_DURATION, {"mode": "screen-lane"}):
        kinds = np.asarray(kinds)
        indexes = np.asarray(indexes)
        B = kinds.shape[0]
        N = scope.masked_nodes.shape[1]
        placed_node = scope.resident_mask & (kinds == KIND_NODE)
        in_range = (indexes >= 0) & (indexes < N)
        idx = np.clip(indexes, 0, max(N - 1, 0))
        on_masked = scope.masked_nodes[np.arange(B)[:, None], idx] if N else np.zeros_like(placed_node)
        ok = ~np.any(placed_node & (~in_range | on_masked), axis=1)
        if node_requests is not None:
            node_requests = np.asarray(node_requests)
            node_avail = np.asarray(node_avail)
            carried = np.asarray(carried_node_requests)
            # deleted and padded rows carry avail < 0 and are exempt from the fit
            fits = np.where(node_avail >= 0.0, node_requests <= node_avail + eps, True)
            ok &= np.all(fits, axis=(1, 2))
            untouched = np.all(node_requests == carried[None], axis=2)
            ok &= np.all(~scope.masked_nodes | untouched, axis=1)
        return ok
