"""Row-scoped re-check of a residual-screen result (the JAX package's
``verify/incremental.py`` ``ScreenLaneScope`` / ``screen_lane_gate``).

A residual-screen lane (disruption/screen_delta.py) re-solves only its
resident rows against the carried base world, whose own solve went through
the solver. So only what the lane changed needs re-proving, on the host, from
the arrays the verdict decode fetches anyway.

The JAX package's ``incremental_gate`` (the warm streaming path's scoped
re-check, ``solver_gate_duration_seconds{mode="incremental"}``) comes with
its caller, ``streaming/warm.py`` (ROADMAP.md A3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from karpenter_tpu_torch.ops.ffd_core import KIND_NODE


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
