"""Incremental consolidation screen: residual-world lane planning (the JAX
package's ``disruption/screen_delta.py``).

The full screen re-solves the whole union problem in every candidate lane,
though a lane differs from the shared base world only by deleting its
subset's nodes and re-queueing their residents. So the base world is solved
once per scorer, and each lane re-runs only the runs its residents occupy:

  - base world: every base (pending or deleting) pod solved once against the
    unmasked cluster through the carried sweeps entry
    (ops/ffd_sweeps.solve_ffd_sweeps_carried from ``fresh_carry``); the
    result's state pins the base placement's consumption;
  - per lane: mask the subset's node rows, activate only its resident rows,
    and gather just the runs those rows live in (``run_idx``, shared by
    every lane of a dispatch; -1 pads are no-op runs).

Sound by first-fit prefix decomposability, as long as the base rows'
decisions transfer to the lane's world. Each condition that could break the
transfer is a classified standdown: the lane (or the batch) is scored by the
full screen and the reason is counted in the scorer's ``last_screen_stats``:

  standdown-topology           the batch needs more than one placement pass
                               or has topology-coupled runs;
  standdown-ports              some pod declares host ports;
  standdown-pool               a template pool is finite;
  standdown-base-on-candidate  (per lane) the base solve placed a pod on a
                               node the lane deletes;
  standdown-resident-order     (per lane) a resident row precedes an active
                               base row in the FFD queue;
  standdown-resident-overflow  (per lane) the lane touches more than
                               ``MAX_RUNS`` runs, or a resident row is
                               covered by no run.

The JAX package reads ``KARPENTER_TPU_SCREEN_DELTA`` and
``KARPENTER_TPU_SCREEN_DELTA_MAX_RUNS``; this package reads no environment:
``UnionScorer(delta=...)`` chooses the path and ``MAX_RUNS`` is a constant.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from karpenter_tpu_torch.models.problem import RUN_TOPO
from karpenter_tpu_torch.ops.ffd_core import KIND_NODE, initial_state
from karpenter_tpu_torch.ops.padding import screen_axis_bucket

# the largest per-lane touched-run count the residual program carries
MAX_RUNS = 64


def residual_run_bucket(n: int) -> int:
    """Eighth-pow2 bucket for the residual program's gathered-run axis,
    floor 4."""
    return screen_axis_bucket(max(int(n), 1), lo=4)


@dataclasses.dataclass
class BaseWorld:
    """The once-per-scorer shared solve: the carried state with every base
    pod's consumption pinned, and which node rows base pods landed on."""

    carried: object  # FFDState on the scorer's device
    nodes_used: np.ndarray  # i64 sorted unique node indices base pods occupy
    kinds: Optional[np.ndarray]  # i32[P] base verdict rows (None: no base pods)
    indexes: Optional[np.ndarray]


@dataclasses.dataclass
class LanePlan:
    """Host-side plan for one score_subsets call on the delta path."""

    reasons: List[Optional[str]]  # per lane; None = residual-eligible
    member: np.ndarray  # bool [B, n_cand]
    touched: np.ndarray  # bool [B, RN] runs each lane's residents occupy
    run_counts: np.ndarray  # i64 [B]


class DeltaContext:
    """Per-scorer host precompute of the residual screen, built on the first
    delta-path call and cached on the UnionScorer (the base world is a
    per-scorer constant)."""

    def __init__(self, scorer) -> None:
        base = scorer.base_problem
        run_start = np.asarray(base.run_start)
        run_len = np.asarray(base.run_len)
        self.RN = int(run_start.shape[0])
        P = int(base.pod_active.shape[0])

        # row -> run id (-1: covered by no run, e.g. pad rows)
        rid = np.full(P, -1, dtype=np.int64)
        for r in range(self.RN):
            ln = int(run_len[r])
            if ln > 0:
                rid[int(run_start[r]): int(run_start[r]) + ln] = r
        self.run_of_row = rid

        n_cand = len(scorer.candidates)
        self.cand_runs = np.zeros((n_cand, self.RN), dtype=bool)
        self.cand_min_row = np.full(n_cand, P, dtype=np.int64)
        self.cand_uncovered = np.zeros(n_cand, dtype=bool)
        for ci, rows in enumerate(scorer.cand_rows):
            if len(rows) == 0:
                continue
            self.cand_min_row[ci] = rows.min()
            rr = rid[rows]
            if np.any(rr < 0):
                self.cand_uncovered[ci] = True
            self.cand_runs[ci, rr[rr >= 0]] = True
        self.cand_runs_i32 = self.cand_runs.astype(np.int32)

        # active base rows: the union problem's active rows minus every
        # candidate's resident rows
        base_active = np.asarray(base.pod_active).copy()
        all_cand = np.concatenate(scorer.cand_rows) if scorer.cand_rows else np.zeros(0, dtype=np.int64)
        base_active[all_cand] = False
        self.base_active = base_active
        nz = np.flatnonzero(base_active)
        self.max_base_row = int(nz.max()) if nz.size else -1
        self._world: Optional[BaseWorld] = None

    def batch_standdown(self, base, passes: int) -> Optional[str]:
        """One classified reason that disqualifies the whole batch, or None."""
        if passes != 1 or bool(np.any(np.asarray(base.run_mode) == RUN_TOPO)):
            return "standdown-topology"
        if np.any(np.asarray(base.pod_ports)):
            return "standdown-ports"
        if np.any(np.isfinite(np.asarray(base.tpl_remaining))):
            return "standdown-pool"
        return None

    def base_world(self, scorer) -> BaseWorld:
        """Solve the base pods once against the unmasked cluster and pin their
        consumption in a carried state (cached for the scorer's lifetime)."""
        if self._world is not None:
            return self._world
        import torch

        from karpenter_tpu_torch.ops.ffd_sweeps import fresh_carry, solve_ffd_sweeps_carried

        prob = scorer.device_problem
        C = scorer.num_claim_slots
        if self.max_base_row < 0:
            # no base pods: the carried state is the plain initial state
            self._world = BaseWorld(
                carried=initial_state(prob, C), nodes_used=np.zeros(0, dtype=np.int64),
                kinds=None, indexes=None,
            )
            return self._world
        active = torch.as_tensor(self.base_active, device=prob.lane_valid.device)
        p_base = dataclasses.replace(prob, pod_active=active)
        r = solve_ffd_sweeps_carried(p_base, C, init=fresh_carry(p_base, C))
        kinds = r.kind.cpu().numpy()
        indexes = r.index.cpu().numpy()
        on_node = self.base_active & (kinds == KIND_NODE)
        self._world = BaseWorld(
            carried=r.state, nodes_used=np.unique(indexes[on_node]), kinds=kinds, indexes=indexes,
        )
        return self._world

    def plan_lanes(self, scorer, subsets, world: BaseWorld) -> LanePlan:
        """Classify every lane: residual-eligible or a named standdown,
        vectorized over the membership matrix."""
        n_cand = len(scorer.candidates)
        B = len(subsets)
        member = np.zeros((B, n_cand), dtype=bool)
        for bi, subset in enumerate(subsets):
            member[bi, list(subset)] = True
        m8 = member.astype(np.int32)

        touched = (m8 @ self.cand_runs_i32) > 0  # [B, RN]
        run_counts = touched.sum(axis=1).astype(np.int64)

        # base-on-candidate: the lane deletes a node the base solve occupies
        cand_node_used = np.isin(scorer._cand_node_idx, world.nodes_used)
        base_on_cand = (m8 @ cand_node_used.astype(np.int32)) > 0

        # resident-order: every resident row must follow every active base row
        lane_min_row = np.where(member, self.cand_min_row[None, :], np.iinfo(np.int64).max).min(axis=1)
        order_bad = lane_min_row <= self.max_base_row

        # resident-overflow: too many touched runs, or an uncovered row
        uncovered = (m8 @ self.cand_uncovered.astype(np.int32)) > 0
        overflow = (run_counts > scorer.max_residual_runs) | uncovered

        reasons: List[Optional[str]] = [None] * B
        for bi in range(B):
            if base_on_cand[bi]:
                reasons[bi] = "standdown-base-on-candidate"
            elif order_bad[bi]:
                reasons[bi] = "standdown-resident-order"
            elif overflow[bi]:
                reasons[bi] = "standdown-resident-overflow"
        return LanePlan(reasons=reasons, member=member, touched=touched, run_counts=run_counts)
