"""Consolidation methods (the JAX package's ``disruption/consolidation.py``).

Equivalent of reference pkg/controllers/disruption/{consolidation,
emptynodeconsolidation,multinodeconsolidation,singlenodeconsolidation,
validation}.go: the shared simulate-and-price core (consolidation.go:113-194),
the empty-node batch path, the multi-node binary search
(multinodeconsolidation.go:87-137), the single-node linear scan, and the
15-second revalidation TTL (consolidation.go:42, validation.go:68-110).

The screens run on the device of the provisioner's solver through
``runs_screen`` (disruption/batch.py). One difference from the JAX package:
an error of the port's kernels or of the CUDA runtime inside a screen
(``solver/supervisor.device_fault``) propagates out of the controller, as the
supervisor raises it; every other screen error keeps the logged fallback to
the sequential search.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

from karpenter_tpu_torch.apis.nodepool import (
    CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED,
)
from karpenter_tpu_torch.disruption.helpers import (
    filter_out_same_type,
    filter_replacement_instance_types,
    get_candidates,
    simulate_scheduling,
)
from karpenter_tpu_torch.disruption.types import Candidate, Command, DECISION_NONE
from karpenter_tpu_torch.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.solver.supervisor import device_fault

log = logging.getLogger(__name__)

CONSOLIDATION_TTL_SECONDS = 15.0  # consolidation.go:42
MULTI_NODE_MAX_CANDIDATES = 100  # multinodeconsolidation.go:34
MULTI_NODE_TIMEOUT_SECONDS = 60.0  # multinodeconsolidation.go:57-59
SINGLE_NODE_TIMEOUT_SECONDS = 180.0  # singlenodeconsolidation.go:29


def sort_candidates(candidates: Sequence[Candidate]) -> List[Candidate]:
    """Cheapest-to-disrupt first (types.go disruptionCost ordering)."""
    return sorted(candidates, key=lambda c: c.disruption_cost)


def _has_required_pod_terms(pod) -> bool:
    """Required pod affinity/anti-affinity: placement is order-dependent, so
    the screen's fixed retry-pass count can be pessimistic about it."""
    aff = pod.spec.affinity
    if aff is None:
        return False
    return bool(
        (aff.pod_affinity is not None and aff.pod_affinity.required)
        or (aff.pod_anti_affinity is not None and aff.pod_anti_affinity.required)
    )


def apply_budgets(
    candidates: Sequence[Candidate], budgets: Dict[str, int]
) -> List[Candidate]:
    """Keep at most the budgeted number of candidates per nodepool, in the
    given priority order."""
    taken: Dict[str, int] = {}
    out = []
    for c in candidates:
        pool = c.nodepool.name
        if taken.get(pool, 0) >= budgets.get(pool, 0):
            continue
        taken[pool] = taken.get(pool, 0) + 1
        out.append(c)
    return out


class ConsolidationBase:
    """Shared gate + simulate-and-price core."""

    method_name = "consolidation"
    consolidation_type = ""

    def __init__(self, provisioner: Provisioner, clock):
        self.provisioner = provisioner
        self.clock = clock
        # per-reconcile-pass shared screen (disruption/batch.py
        # ScreenSession); the controller installs a fresh one each pass so
        # Multi's and Single's probes share one encode + device launch
        self.screen_session = None

    def _any_prefer_no_schedule(self) -> bool:
        """Whether any pool's template carries a PreferNoSchedule taint — the
        relaxation rung the screen never applies (preferences.py
        _tolerate_prefer_no_schedule)."""
        from karpenter_tpu_torch.apis.nodepool import NodePool

        for np_obj in self.provisioner.kube.list(NodePool):
            for t in np_obj.spec.template.spec.taints:
                if t.effect == "PreferNoSchedule":
                    return True
        return False


    # the shared screen encodes at most this many candidates; tails beyond it
    # fall to the sequential probes (Single's deadline-bounded scan)
    SCREEN_BASIS_CAP = 2 * MULTI_NODE_MAX_CANDIDATES

    def _screen_basis(self, ordered):
        """The candidate prefix both methods build their shared scorer over —
        one bounded union encode per pass regardless of cluster size. The
        scorer additionally drops survivor nodes that cannot fit any union
        pod (UnionScorer._screen_survivors), so the stacked screen's node
        axis scales with the reschedulable load, not the cluster."""
        return list(ordered[: self.SCREEN_BASIS_CAP])

    def _session_scorer(self, ordered):
        """(scorer, score_fn) through the pass's ScreenSession when one is
        installed, else a one-shot scorer."""
        from karpenter_tpu_torch.disruption.batch import build_scorer

        if self.screen_session is not None:
            scorer = self.screen_session.scorer_for(self.provisioner, ordered)
            return scorer, (
                self.screen_session.score if scorer is not None else None
            )
        scorer = build_scorer(self.provisioner, ordered)
        if scorer is None:
            return None, None
        return scorer, lambda subsets, extra=(): scorer.score_subsets(subsets)

    def should_disrupt(self, candidate: Candidate) -> bool:
        """Policy gate (consolidation.go ShouldDisrupt): only pools asking for
        WhenUnderutilized consolidation participate."""
        return (
            candidate.nodepool.spec.disruption.consolidation_policy
            == CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
        )

    def compute_consolidation(self, candidates: Sequence[Candidate]) -> Command:
        """Simulate removing the candidates; allow at most one replacement,
        and only when it is strictly cheaper (consolidation.go:113-194)."""
        if not candidates:
            return Command(method=self.method_name)
        sim = simulate_scheduling(self.provisioner, candidates)
        if sim is None or not sim.all_candidate_pods_scheduled():
            return Command(method=self.method_name)
        if len(sim.result.new_claims) > 1:
            # a multi-replacement trade is never a consolidation win
            return Command(method=self.method_name)
        if not self._filter_replacement(sim, candidates):
            return Command(method=self.method_name)
        replacements = []
        for placement in sim.result.new_claims:
            np_obj = sim.inputs.nodepools.get(placement.nodepool_name)
            if np_obj is None:
                return Command(method=self.method_name)
            replacements.append(
                self.provisioner._to_node_claim(placement, sim.inputs, np_obj)
            )
        return Command(
            candidates=list(candidates),
            replacements=replacements,
            method=self.method_name,
            consolidation_type=self.consolidation_type,
        )

    def _filter_replacement(self, sim, candidates) -> bool:
        """Price rules applied to the replacement claim; methods layer extra
        filters on top (multi-node adds the same-type churn guard)."""
        return filter_replacement_instance_types(sim, candidates)

    # -- validation (validation.go:68-110) ------------------------------------

    # the controller holds a computed command as pending and calls validate()
    # only after this much wall-clock has elapsed — reconcile never sleeps
    # (consolidationTTL, consolidation.go:42)
    validation_ttl = CONSOLIDATION_TTL_SECONDS

    def validate(self, command: Command, kube, cluster, cloud_provider) -> bool:
        """Re-verify after the TTL (the controller owns the wait): every
        candidate must still be eligible and un-nominated, and any decision
        whose correctness depends on the candidates' pods — replace commands,
        and delete commands over non-empty nodes — must re-simulate against
        the candidates' *fresh* pod lists (validation.go:68-110 re-runs the
        simulation for every command)."""
        if command.decision == DECISION_NONE:
            return False
        fresh = {
            c.name: c
            for c in get_candidates(
                self.clock, kube, cluster, cloud_provider, self.should_disrupt
            )
        }
        refreshed = []
        for c in command.candidates:
            now = fresh.get(c.name)
            if now is None or cluster.is_nominated(c.name):
                return False
            refreshed.append(now)
        if command.replacements or any(not c.is_empty() for c in refreshed):
            # nodes may have gained pods during the TTL; the decision must
            # hold against what is on them NOW — and the command is updated
            # to the FRESH result, so a replacement sized for the old pod set
            # is never launched (a stale one could be too small for pods that
            # arrived during the TTL)
            recheck = self.compute_consolidation(refreshed)
            if recheck.decision != command.decision:
                return False
            command.candidates = refreshed
            command.replacements = recheck.replacements
            return True
        return True


class EmptyNodeConsolidation(ConsolidationBase):
    """Delete every empty underutilized node in one command
    (emptynodeconsolidation.go:40-92)."""

    method_name = "empty-node-consolidation"
    consolidation_type = "empty"

    def compute_command(
        self, budgets: Dict[str, int], candidates: Sequence[Candidate]
    ) -> Command:
        empty = [c for c in sort_candidates(candidates) if c.is_empty()]
        empty = apply_budgets(empty, budgets)
        if not empty:
            return Command(method=self.method_name)
        return Command(
            candidates=empty, method=self.method_name,
            consolidation_type=self.consolidation_type,
        )

    def validate(self, command: Command, kube, cluster, cloud_provider) -> bool:
        if command.decision == DECISION_NONE:
            return False
        fresh = {
            c.name: c
            for c in get_candidates(
                self.clock, kube, cluster, cloud_provider, self.should_disrupt
            )
        }
        return all(
            c.name in fresh and fresh[c.name].is_empty() and not cluster.is_nominated(c.name)
            for c in command.candidates
        )


class MultiNodeConsolidation(ConsolidationBase):
    """The largest prefix of (cost-sorted) candidates that consolidates
    simultaneously (multinodeconsolidation.go:87-137).

    Screened path: instead of the reference's sequential binary search —
    log2(100) probes, each a full scheduling simulation — ALL prefixes are
    scored in one ``runs_screen`` launch (disruption/batch.py), then the chosen
    prefix is confirmed by one sequential simulation that also builds the
    replacement claim. The screen is relaxation-free and therefore
    pessimistic; when it rejects everything, the reference binary search runs
    as the fallback so preference-relaxation-dependent consolidations are
    still found."""

    method_name = "multi-node-consolidation"
    consolidation_type = "multi"

    def _filter_replacement(self, sim, candidates) -> bool:
        """Multi-node adds filterOutSameType (multinodeconsolidation.go:121-125,
        155-188): replacing N nodes with one of the SAME types only counts as
        consolidation below the existing type's price — otherwise deleting
        alone is the right command and the replace is churn."""
        if not filter_replacement_instance_types(sim, candidates):
            return False
        return filter_out_same_type(sim, candidates)

    def compute_command(
        self, budgets: Dict[str, int], candidates: Sequence[Candidate]
    ) -> Command:
        ordered_full = apply_budgets(sort_candidates(candidates), budgets)
        ordered = ordered_full[:MULTI_NODE_MAX_CANDIDATES]
        if not ordered:
            return Command(method=self.method_name)
        deadline = self.clock.now() + MULTI_NODE_TIMEOUT_SECONDS

        best_k = self._screen_best_prefix(ordered_full, len(ordered))
        # confirm screened prefixes sequentially, walking down on disagreement
        # (the sequential sim is the source of truth and builds the command)
        attempts = 0
        while best_k > 0 and attempts < 3 and self.clock.now() < deadline:
            cmd = self.compute_consolidation(ordered[:best_k])
            if cmd.decision != DECISION_NONE:
                return cmd
            best_k -= 1
            attempts += 1
        return self._binary_search(ordered, deadline)

    def _screen_best_prefix(
        self, ordered_full: Sequence[Candidate], k_max: int
    ) -> int:
        """Largest prefix size (<= k_max, the reference's 100-candidate cap)
        the batched screen accepts; 0 = none.

        With a ScreenSession installed the scorer is built over the shared
        bounded basis (_screen_basis, the first 2x-cap candidates) so
        SingleNodeConsolidation's screen this pass reuses the same scorer
        key, and every basis singleton rides this launch speculatively —
        one union encode and one device program per pass. Without a session
        only the capped prefix is encoded, exactly as before the session
        existed. Candidates beyond a scored prefix stay live nodes in the
        union problem either way."""
        try:
            with_session = self.screen_session is not None
            # the session's shared basis keeps Single's screen on the same
            # scorer key; without a session, encode only what this method
            # scores
            basis = (
                self._screen_basis(ordered_full)
                if with_session
                else list(ordered_full[:k_max])
            )
            scorer, score = self._session_scorer(basis)
            if scorer is None:
                return 0
            subsets = [list(range(k + 1)) for k in range(k_max)]
            # Single screens every basis singleton later this pass; carrying
            # ALL of them (bounded by SCREEN_BASIS_CAP) keeps it cache-only
            singletons = (
                [[i] for i in range(len(basis))] if with_session else []
            )
            verdicts = score(subsets, extra=singletons)
            for k in range(k_max, 0, -1):
                if verdicts[k - 1].consolidatable_with(
                    ordered_full[:k], scorer.inputs.instance_types
                ):
                    return k
            return 0
        except Exception as e:
            # the screen is an accelerator, never a correctness dependency —
            # but a silent failure here degrades the fast path, so make it
            # loud before falling back; a kernel or CUDA error is raised
            if device_fault(e):
                raise
            log.exception("batched multi-node screen failed; using binary search")
            return 0

    def _binary_search(self, ordered, deadline) -> Command:
        best = Command(method=self.method_name)
        lo, hi = 1, len(ordered)
        while lo <= hi:
            if self.clock.now() >= deadline:
                break
            mid = (lo + hi) // 2
            cmd = self.compute_consolidation(ordered[:mid])
            if cmd.decision != DECISION_NONE:
                best = cmd
                lo = mid + 1
            else:
                hi = mid - 1
        return best


class SingleNodeConsolidation(ConsolidationBase):
    """First consolidatable candidate wins (singlenodeconsolidation.go:42-88).

    Screened path: all candidates are scored in one launch, then the first
    accepted candidate (in disruption-cost order) is confirmed sequentially.
    The screen is exact for pods the relaxation ladder cannot touch; screen-
    rejected candidates that DO carry relaxable preferences still get the
    sequential probe (bounded by the same 3-minute deadline as the
    reference), so no consolidation is permanently screened out."""

    method_name = "single-node-consolidation"
    consolidation_type = "single"

    def compute_command(
        self, budgets: Dict[str, int], candidates: Sequence[Candidate]
    ) -> Command:
        from karpenter_tpu_torch.provisioning.preferences import Preferences

        ordered = apply_budgets(sort_candidates(candidates), budgets)
        if not ordered:
            return Command(method=self.method_name)
        deadline = self.clock.now() + SINGLE_NODE_TIMEOUT_SECONDS

        screened = self._screen(ordered)
        if screened is None:
            probe_order = list(range(len(ordered)))  # screen unavailable
        else:
            accepted_list, n_screened = screened
            # screen-accepted first (priority order), then every candidate
            # the fixed-pass relaxation-free screen may have been pessimistic
            # about: pods with relaxable preferences, pods with required
            # affinity chains deeper than the screen's pass count, and any
            # pod when a pool uses PreferNoSchedule taints (the blanket-
            # toleration rung relaxes those only in the sequential solver) —
            # plus the tail beyond the screen basis, which was never screened
            prefer_no_schedule_pools = self._any_prefer_no_schedule()
            accepted = set(accepted_list)
            maybe_pessimistic = [
                i
                for i, c in enumerate(ordered)
                if i not in accepted
                and (
                    i >= n_screened
                    or prefer_no_schedule_pools
                    or any(
                        Preferences.is_relaxable(p) or _has_required_pod_terms(p)
                        for p in c.reschedulable_pods()
                    )
                )
            ]
            probe_order = accepted_list + maybe_pessimistic
        for i in probe_order:
            if self.clock.now() >= deadline:
                break
            cmd = self.compute_consolidation([ordered[i]])
            if cmd.decision != DECISION_NONE:
                return cmd
        return Command(method=self.method_name)

    def _screen(self, ordered: Sequence[Candidate]):
        """(accepted indices in priority order, how many were screened), or
        None when the screen is unavailable (fall back to the linear scan).
        Screens the same bounded basis MultiNodeConsolidation used this pass,
        so the session returns cached verdicts with no new scorer build; the
        tail past the basis is left to the sequential probes."""
        try:
            basis = self._screen_basis(ordered)
            scorer, score = self._session_scorer(basis)
            if scorer is None:
                return None
            subsets = [[i] for i in range(len(basis))]
            verdicts = score(subsets)
            return (
                [
                    i
                    for i, v in enumerate(verdicts)
                    if v.consolidatable_with([ordered[i]], scorer.inputs.instance_types)
                ],
                len(basis),
            )
        except Exception as e:
            if device_fault(e):
                raise
            log.exception("batched single-node screen failed; using linear scan")
            return None
