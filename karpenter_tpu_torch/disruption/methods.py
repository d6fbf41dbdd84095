"""Emptiness, Drift, and Expiration disruption methods (the JAX package's
``disruption/methods.py``).

Equivalent of reference pkg/controllers/disruption/{emptiness,drift,
expiration}.go. These are condition-driven: the nodeclaim disruption marker
controller stamps Empty/Drifted/Expired on NodeClaims, and these methods act
on them — emptiness deletes, drift and expiration replace via simulation with
no price gate (a drifted/expired node must go regardless of cost).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from karpenter_tpu_torch.apis import nodeclaim as nc
from karpenter_tpu_torch.apis.nodepool import CONSOLIDATION_POLICY_WHEN_EMPTY, NEVER
from karpenter_tpu_torch.disruption.consolidation import apply_budgets, sort_candidates
from karpenter_tpu_torch.disruption.helpers import simulate_scheduling
from karpenter_tpu_torch.disruption.types import Candidate, Command
from karpenter_tpu_torch.provisioning.provisioner import Provisioner


class Emptiness:
    """WhenEmpty policy: delete nodes whose Empty condition has outlasted
    consolidateAfter (emptiness.go:42-48). No simulation — an empty node's
    removal cannot strand pods."""

    method_name = "emptiness"
    consolidation_type = ""

    def __init__(self, provisioner: Provisioner, clock):
        self.provisioner = provisioner
        self.clock = clock

    def should_disrupt(self, candidate: Candidate) -> bool:
        if (
            candidate.nodepool.spec.disruption.consolidation_policy
            != CONSOLIDATION_POLICY_WHEN_EMPTY
        ):
            return False
        claim = candidate.node_claim
        if claim is None:
            return False
        cond = claim.status.conditions.get(nc.EMPTY)
        if cond is None or cond.status != "True":
            return False
        ttl = candidate.nodepool.spec.disruption.consolidate_after_seconds()
        if ttl == NEVER:
            return False
        return self.clock.now() - cond.last_transition_time >= ttl

    def compute_command(
        self, budgets: Dict[str, int], candidates: Sequence[Candidate]
    ) -> Command:
        empty = [c for c in sort_candidates(candidates) if c.is_empty()]
        empty = apply_budgets(empty, budgets)
        if not empty:
            return Command(method=self.method_name)
        return Command(candidates=empty, method=self.method_name)

    def validate(self, command: Command, kube, cluster, cloud_provider) -> bool:
        return command.decision != "none"


class _ConditionReplacer:
    """Shared shape of drift and expiration: empty marked nodes are deleted in
    a batch; occupied ones are replaced one per pass via simulation, without
    the consolidation price filter (drift.go:56-120, expiration.go:61-122)."""

    method_name = ""
    consolidation_type = ""
    condition = ""

    def __init__(self, provisioner: Provisioner, clock):
        self.provisioner = provisioner
        self.clock = clock

    def should_disrupt(self, candidate: Candidate) -> bool:
        claim = candidate.node_claim
        return claim is not None and claim.status.conditions.is_true(self.condition)

    def order(self, candidates: Sequence[Candidate]) -> List[Candidate]:
        return list(candidates)

    def compute_command(
        self, budgets: Dict[str, int], candidates: Sequence[Candidate]
    ) -> Command:
        ordered = apply_budgets(self.order(candidates), budgets)
        if not ordered:
            return Command(method=self.method_name)
        empty = [c for c in ordered if c.is_empty()]
        if empty:
            # fast path: no replacement needed (drift.go:65-79)
            return Command(candidates=empty, method=self.method_name)
        for candidate in ordered:
            sim = simulate_scheduling(self.provisioner, [candidate])
            if sim is None or not sim.all_candidate_pods_scheduled():
                continue
            replacements = []
            viable = True
            for placement in sim.result.new_claims:
                np_obj = sim.inputs.nodepools.get(placement.nodepool_name)
                if np_obj is None:
                    viable = False
                    break
                replacements.append(
                    self.provisioner._to_node_claim(placement, sim.inputs, np_obj)
                )
            if viable:
                return Command(
                    candidates=[candidate],
                    replacements=replacements,
                    method=self.method_name,
                )
        return Command(method=self.method_name)

    def validate(self, command: Command, kube, cluster, cloud_provider) -> bool:
        return command.decision != "none"


class Drift(_ConditionReplacer):
    method_name = "drift"
    condition = nc.DRIFTED

    def __init__(self, provisioner: Provisioner, clock, enabled: bool = True):
        super().__init__(provisioner, clock)
        # the Drift feature gate is checked at the method too, not only at
        # the condition-stamping marker (drift.go:56-60): conditions stamped
        # before a restart disabled the gate must not trigger disruption
        self.enabled = enabled

    def should_disrupt(self, candidate: Candidate) -> bool:
        return self.enabled and super().should_disrupt(candidate)

    def order(self, candidates: Sequence[Candidate]) -> List[Candidate]:
        """Earliest-drifted first (drift.go:62-72)."""

        def drifted_at(c: Candidate) -> float:
            claim = c.node_claim
            cond = claim.status.conditions.get(self.condition) if claim else None
            return cond.last_transition_time if cond is not None else float("inf")

        return sorted(candidates, key=drifted_at)


class Expiration(_ConditionReplacer):
    method_name = "expiration"
    condition = nc.EXPIRED

    def order(self, candidates: Sequence[Candidate]) -> List[Candidate]:
        """Soonest-expired first (expiration.go:69-75)."""

        def expiry(c: Candidate) -> float:
            claim = c.node_claim
            ttl = c.nodepool.spec.disruption.expire_after_seconds()
            if claim is None or ttl == NEVER or claim.metadata.creation_timestamp is None:
                return float("inf")
            return claim.metadata.creation_timestamp + ttl

        return sorted(candidates, key=expiry)
