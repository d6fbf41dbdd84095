"""NodeClaim disruption status markers — Empty, Drifted, Expired.

Equivalent of reference pkg/controllers/nodeclaim/disruption/: a per-claim
reconciler that stamps (or clears) the three disruption conditions the
disruption methods key off (nodeclaim/disruption/controller.go:71-79):

  Empty    initialized claim whose node runs no reschedulable pods
  Drifted  static drift (nodepool-hash annotation mismatch, drift.go:114-121),
           requirements drift (node labels fall outside the pool's current
           requirements, drift.go:123), or CloudProvider.IsDrifted
  Expired  claim older than the pool's expireAfter
"""

from __future__ import annotations

import copy

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import DRIFTED, EMPTY, EXPIRED, NodeClaim
from karpenter_tpu_torch.apis.nodepool import NEVER, NodePool
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.scheduling.requirements import (
    Requirements,
    label_requirements,
)
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock


class DisruptionMarkerController:
    def __init__(
        self, kube: KubeClient, cloud_provider: CloudProvider, clock: Clock,
        drift_enabled: bool = True, cluster=None,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.drift_enabled = drift_enabled  # --feature-gates Drift (options.go:97)
        # optional cluster state: nominated nodes must not read as Empty
        # (emptiness.go:126-140)
        self.cluster = cluster

    def reconcile_all(self) -> None:
        pools = {np.name: np for np in self.kube.list(NodePool)}
        for claim in self.kube.list(NodeClaim):
            if claim.metadata.deletion_timestamp is not None:
                continue
            self.reconcile(claim, pools)

    def reconcile(self, claim: NodeClaim, pools=None) -> None:
        if pools is None:
            pools = {np.name: np for np in self.kube.list(NodePool)}
        nodepool = pools.get(claim.nodepool_name or "")
        if nodepool is None:
            return
        now = self.clock.now()

        def mark(c: NodeClaim):
            self._mark_empty(c, nodepool, now)
            if self.drift_enabled:
                self._mark_drifted(c, nodepool, now)
            else:
                # a disabled gate actively REMOVES the condition so stale
                # pre-restart markers cannot drive disruption
                # (nodeclaim/disruption/drift_test.go:105-115)
                c.status.conditions.clear(DRIFTED)
            self._mark_expired(c, nodepool, now)

        # dry-run against a copy; only write when a condition actually
        # transitioned — a steady-state pass must not churn resource versions
        # and fan no-op MODIFIED events into the informers
        probe = copy.deepcopy(claim)
        mark(probe)
        if probe.status.conditions == claim.status.conditions:
            return
        self.kube.patch(claim, mark)

    # -- emptiness (nodeclaim/disruption/emptiness.go) ------------------------

    def _mark_empty(self, claim: NodeClaim, nodepool: NodePool, now: float) -> None:
        if not claim.is_initialized() or not claim.status.node_name:
            claim.status.conditions.clear(EMPTY)
            return
        # a node nominated for pending pods is about to be non-empty
        # (emptiness.go:126-140)
        if self.cluster is not None and self.cluster.is_nominated(
            claim.status.node_name
        ):
            claim.status.conditions.clear(EMPTY)
            return
        pods = self.kube.list(
            Pod,
            predicate=lambda p: p.spec.node_name == claim.status.node_name
            and podutil.is_reschedulable(p),
        )
        if pods:
            claim.status.conditions.clear(EMPTY)
        elif not claim.status.conditions.is_true(EMPTY):
            claim.status.conditions.set_true(EMPTY, now=now)

    # -- drift (nodeclaim/disruption/drift.go) --------------------------------

    def _mark_drifted(self, claim: NodeClaim, nodepool: NodePool, now: float) -> None:
        # an unlaunched claim has nothing to be drifted FROM; the condition
        # comes off until Launched is true (drift_test.go:116-141)
        if not claim.is_launched():
            claim.status.conditions.clear(DRIFTED)
            return
        reason = self._drift_reason(claim, nodepool)
        if reason:
            if not claim.status.conditions.is_true(DRIFTED):
                claim.status.conditions.set_true(DRIFTED, reason=reason, now=now)
        else:
            claim.status.conditions.clear(DRIFTED)

    def _drift_reason(self, claim: NodeClaim, nodepool: NodePool) -> str:
        # static drift: the pool template changed under the claim
        claim_hash = claim.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
        if claim_hash is not None and claim_hash != nodepool.hash():
            return "NodePoolStaticDrifted"
        # requirements drift: the claim's labels no longer satisfy the pool's
        # requirements. Direction matters (areRequirementsDrifted,
        # drift.go:123-133): the CLAIM label set is the receiver and the pool
        # requirements the incoming side — so pool requirement keys the claim
        # doesn't label are drift, while provider-specific claim label keys
        # the pool never constrained are NOT (reversed, every custom-label
        # provider claim would false-drift and churn-replace forever)
        pool_reqs = Requirements.from_node_selector_requirements(
            *nodepool.spec.template.spec.requirements
        )
        claim_reqs = label_requirements(claim.metadata.labels)
        # NO allow-undefined set: the reference calls Compatible with the
        # default (empty) CompatibilityOptions here (drift.go:129), so a pool
        # requirement on a well-known key the claim doesn't label IS drift
        if not claim_reqs.is_compatible(pool_reqs):
            return "RequirementsDrifted"
        cloud_reason = self.cloud_provider.is_drifted(claim)
        if cloud_reason:
            return cloud_reason
        return ""

    # -- expiration (nodeclaim/disruption/expiration.go) ----------------------

    def _mark_expired(self, claim: NodeClaim, nodepool: NodePool, now: float) -> None:
        ttl = nodepool.spec.disruption.expire_after_seconds()
        created = claim.metadata.creation_timestamp
        if ttl == NEVER or created is None:
            claim.status.conditions.clear(EXPIRED)
            return
        # an adopted node may predate its claim: whichever is older expires
        # the pair (expiration_test.go:80-103)
        if claim.status.node_name:
            from karpenter_tpu_torch.apis.objects import Node

            node = self.kube.get_opt(Node, claim.status.node_name, "")
            if node is not None and node.metadata.creation_timestamp is not None:
                created = min(created, node.metadata.creation_timestamp)
        if now - created >= ttl:
            if not claim.status.conditions.is_true(EXPIRED):
                claim.status.conditions.set_true(EXPIRED, now=now)
        else:
            claim.status.conditions.clear(EXPIRED)
