"""Warm-state re-solve: reuse the previous placement under churn.

Counterpart of the JAX package's ``streaming/warm.py``. ``StreamingSolver``
wraps any ``SolverBackend``. Each cycle it diffs the incoming snapshot
against the previous one (streaming/delta.py digests) and splits the batch
into three buckets:

  resolved   pods whose gates could have changed: arrivals, spec changes,
             previous failures, residents of removed nodes, and (on any churn
             at all) every topology-constrained pod, since counts anywhere can
             move a skew gate. These re-solve through the inner backend
             against the residual world (streaming/residual.py): real nodes
             with the pinned capacity pre-consumed, plus each surviving claim
             as a pseudo-node re-solved pods can still join. The sub-solve
             goes through the inner backend's ordinary entry, so under
             ``TorchSolver`` it runs the kernels of any other solve
             (``ffd_loop``, ``relax_place`` with relax on, ``gate_counts``).
  reused     everything else, pinned to its previous bin verbatim. The merged
             result must pass the exit gate (``verify.incremental_gate`` with
             ``KARPENTER_TPU_DEVICE_GATE`` on, the default; the full host
             validator otherwise) or the whole cycle is solved cold.
  certified  the subset of ``reused`` provably identical to what a cold solve
             of the current snapshot would produce: the FFD-queue prefix that
             matches the previous queue up to the first churned pod.

Fallback triggers (``last_outcome`` and ``solver_warm_solves_total``): the
first cycle (``cold-first``), a delta fraction above
``KARPENTER_TPU_DELTA_MAX_FRAC`` (default 0.15, ``cold-threshold``), a node
add or change or an instance-type/template universe change
(``cold-world-changed``), unsupported solve arguments (``cold-unsupported``),
an exit-gate rejection (``warm-rejected``), or a host-side exception inside
the warm path (``warm-error``). A fallback is a plain inner solve of the full
batch: the warm path can degrade, never corrupt.

One place differs from the JAX package, which turns every exception of the
warm path into ``warm-error``: an error of the port's kernels or of the CUDA
runtime (``solver/supervisor.device_fault``) in the warm sub-solve
propagates, as in the disruption controller's screens, so no kernel fault is
served quietly by a cold solve.

With ``KARPENTER_TPU_STATE_DIR`` set, every accepted cycle is journaled
(streaming/snapshot.py) and a fresh ``StreamingSolver`` restores the last one,
so its first cycle can be warm. Each cycle opens the ``delta_encode`` and
``warm_solve`` trace spans and, with ``KARPENTER_TPU_SLO`` on, records a
``stream-cycle`` flight event and feeds the ``stream-warm`` objective.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.metrics.registry import DELTA_REUSE_RATIO, WARM_SOLVES
from karpenter_tpu_torch.obs import flight, slo, trace
from karpenter_tpu_torch.scheduling import pod_requirements
from karpenter_tpu_torch.solver import validator as val
from karpenter_tpu_torch.solver.backend import Placement, SolveResult, SolverBackend
from karpenter_tpu_torch.solver.encode import NodeInfo, TemplateInfo, ffd_order
from karpenter_tpu_torch.solver.oracle import _fits, _has_offering
from karpenter_tpu_torch.streaming import snapshot as journal
from karpenter_tpu_torch.streaming.delta import DeltaEncoder, SnapshotDelta, diff_snapshots
from karpenter_tpu_torch.streaming.residual import claim_pseudo_node, pinned_node_residuals
from karpenter_tpu_torch.testing import faults
from karpenter_tpu_torch.utils import resources as res

_WARM_CLAIM_PREFIX = "warm-claim-"


def _has_topology_constraints(p: Pod) -> bool:
    if p.spec.topology_spread_constraints:
        return True
    aff = p.spec.affinity
    if aff is None:
        return False
    return bool(
        (aff.pod_affinity and (aff.pod_affinity.required or aff.pod_affinity.preferred))
        or (aff.pod_anti_affinity and (aff.pod_anti_affinity.required or aff.pod_anti_affinity.preferred))
    )


@dataclass
class _StreamState:
    """The previous accepted cycle: the snapshot, its result (without its
    ``verify_ctx``), and the FFD queue order and certification frontier
    needed to prove the next prefix."""

    pods: List[Pod]
    pod_digests: Dict[str, str]
    nodes: List[NodeInfo]
    node_digests: Dict[str, str]
    instance_types: List[InstanceType]
    templates: List[TemplateInfo]
    result: SolveResult
    order_uids: List[str]  # FFD queue order of `pods`
    certified_uids: frozenset  # uids whose placements are provably cold-identical
    # uid -> ("node", name) | ("claim", index) | ("fail", reason)
    placement_of: Dict[str, Tuple[str, object]] = field(default_factory=dict)
    # restored from the journal: universe comparisons go by content digest
    # (unpickled objects never pass the identity fast path)
    restored: bool = False


def _index_placements(pods: Sequence[Pod], result: SolveResult) -> Dict[str, Tuple[str, object]]:
    out: Dict[str, Tuple[str, object]] = {}
    for name, idxs in result.node_pods.items():
        for i in idxs:
            out[pods[i].uid] = ("node", name)
    for ci, c in enumerate(result.new_claims):
        for i in c.pod_indices:
            out[pods[i].uid] = ("claim", ci)
    for i, reason in result.failures.items():
        out[pods[i].uid] = ("fail", reason)
    return out


class StreamingSolver(SolverBackend):
    """SolverBackend wrapper adding the warm-state re-solve. Safe under
    SupervisedSolver (``KARPENTER_TPU_DELTA=1`` wraps it there); stateless
    callers see a normal backend that gets faster under churn.

    ``maintain_encoded`` also runs a DeltaEncoder over every supported
    snapshot so callers can read ``last_encoded``; off by default."""

    def __init__(
        self,
        inner: SolverBackend,
        max_frac: Optional[float] = None,
        maintain_encoded: bool = False,
        tenant: Optional[str] = None,
    ):
        self.inner = inner
        if max_frac is None:
            max_frac = float(os.environ.get("KARPENTER_TPU_DELTA_MAX_FRAC", "0.15"))
        self.max_frac = max_frac
        self.maintain_encoded = maintain_encoded
        # the serve layer names each stream: the tenant labels the warm-solve
        # counter and namespaces the journal
        self.tenant = tenant
        self.delta_encoder = DeltaEncoder(well_known_labels=getattr(inner, "well_known", None))
        self.last_encoded = None
        self._prev: Optional[_StreamState] = None
        self.last_outcome: Optional[str] = None
        self.last_reuse_ratio = 0.0
        self.last_delta: Optional[SnapshotDelta] = None
        self.last_certified_uids: frozenset = frozenset()
        self.counters: Dict[str, int] = {}
        # the last warm cycle's split in seconds (diff, sub-solve, gate,
        # certify, accept) and the sub-solve's pod count; empty after a cold
        # cycle
        self.last_warm_timing: Dict[str, float] = {}
        self.last_sub_pods = 0
        self._accepts = 0
        self._journal_tag: Optional[str] = None
        # crash-consistent journal (KARPENTER_TPU_STATE_DIR): a fresh process
        # restores the last accepted cycle and re-enters the warm path on its
        # first solve; any journal defect is a classified cold start
        self.restored_from_journal = False
        self.last_restore_outcome: Optional[str] = None
        if journal.enabled():
            self._restore(tenant)

    @property
    def device(self):
        """The inner backend's device (``TorchSolver.device``), None for a
        host backend: what the operator and the consolidation screen read
        through ``SupervisedSolver.primary``."""
        return getattr(self.inner, "device", None)

    def _tag(self) -> str:
        if self._journal_tag is None:
            self._journal_tag = journal.device_tag(self.inner)
        return self._journal_tag

    def _restore(self, namespace: Optional[str]) -> None:
        outcome, state = journal.load(self._tag(), namespace=namespace)
        self.last_restore_outcome = outcome
        if state is not None:
            state.restored = True
            self._prev = state
            self.restored_from_journal = True

    def set_tenant(self, tenant: Optional[str]) -> None:
        """Adopt a tenant identity after construction (the supervisor wraps
        pre-built streaming solvers). Re-runs the journal restore under the
        tenant's namespace only while still cold: live warm state wins."""
        self.tenant = tenant
        if tenant is not None and self._prev is None and journal.enabled():
            self._restore(tenant)

    def reset_streaming_state(self) -> None:
        """The supervisor's quarantine hook: a rejected result never seeds
        the next warm cycle. Propagates to the inner backend's carried state
        (``TorchSolver``'s resident world) and removes the journal."""
        self._prev = None
        self.delta_encoder.reset()
        inner_reset = getattr(self.inner, "reset_streaming_state", None)
        if callable(inner_reset):
            inner_reset()
        if journal.enabled():
            journal.invalidate(namespace=self.tenant)

    reset = reset_streaming_state

    # -- entry ----------------------------------------------------------------

    def solve(
        self,
        pods: Sequence[Pod],
        instance_types: Sequence[InstanceType],
        templates: Sequence[TemplateInfo],
        nodes: Sequence[NodeInfo] = (),
        pod_requirements_override=None,
        topology=None,
        cluster_pods: Sequence = (),
        domains=None,
        pod_volumes=None,
    ) -> SolveResult:
        faults.crash_point("cycle.enter")
        pods = list(pods)
        nodes = list(nodes)
        self.last_warm_timing = {}
        self.last_sub_pods = 0
        unsupported = (
            pod_requirements_override is not None
            or topology is not None
            or len(cluster_pods) > 0
            or domains is not None
            or pod_volumes is not None
        )
        if unsupported:
            # consolidation sims and override passes carry state the pinning
            # does not model: stay out of their way
            self.reset_streaming_state()
            result = self.inner.solve(
                pods, instance_types, templates, nodes=nodes,
                pod_requirements_override=pod_requirements_override,
                topology=topology, cluster_pods=cluster_pods,
                domains=domains, pod_volumes=pod_volumes,
            )
            self._finish("cold-unsupported", 0.0, len(pods))
            return result

        import time

        t0 = time.perf_counter()
        prev = self._prev
        with trace.span("delta_encode", pods=len(pods)):
            if prev is None:
                delta, pod_digests, node_digests = diff_snapshots((), (), pods, nodes)
            else:
                delta, pod_digests, node_digests = diff_snapshots(
                    prev.pods, prev.nodes, pods, nodes,
                    prev_pod_digests=prev.pod_digests,
                    prev_node_digests=prev.node_digests,
                )
            self.last_delta = delta
            trace.attr("pod_events", delta.pod_events)
            trace.attr("node_events", delta.node_events)
            if self.maintain_encoded:
                self.last_encoded = self.delta_encoder.encode(pods, instance_types, templates, nodes=nodes)
                trace.attr("encode_mode", self.delta_encoder.last_patch.get("mode"))
        t_diff = time.perf_counter() - t0

        cold_reason = self._cold_reason(prev, delta, pods, instance_types, templates)
        if cold_reason is None:
            try:
                with trace.span("warm_solve", pods=len(pods)):
                    out = self._warm(prev, delta, pods, pod_digests, instance_types, templates, nodes)
                    if out is not None:
                        result, seeds, certified, order = out
                        ratio = (len(pods) - len(seeds)) / max(1, len(pods))
                        trace.attr("resolved", len(seeds))
                        trace.attr("reused", len(pods) - len(seeds))
                        trace.attr("certified", len(certified))
                        t_accept = time.perf_counter()
                        self._accept(
                            pods, pod_digests, nodes, node_digests,
                            instance_types, templates, result, certified, order=order,
                        )
                        self.last_warm_timing["diff"] = t_diff
                        self.last_warm_timing["accept"] = time.perf_counter() - t_accept
                        self._finish("warm", ratio, len(pods))
                        return result
                    cold_reason = "warm-rejected"
            except Exception as exc:
                from karpenter_tpu_torch.solver.supervisor import device_fault

                if device_fault(exc):
                    # a kernel or CUDA error is the inner backend's fault, not
                    # a warm-path degrade: raise it (module docstring)
                    raise
                cold_reason = "warm-error"
            self.last_warm_timing = {}

        result = self.inner.solve(pods, instance_types, templates, nodes=nodes)
        # a cold solve IS the reference answer: every placement is certified
        self._accept(
            pods, pod_digests, nodes, node_digests, instance_types, templates,
            result, frozenset(p.uid for p in pods),
        )
        self._finish(cold_reason, 0.0, len(pods))
        return result

    # -- bookkeeping ----------------------------------------------------------

    def _finish(self, outcome: str, ratio: float, pods: int) -> None:
        self.last_outcome = outcome
        self.last_reuse_ratio = ratio
        self.counters[outcome] = self.counters.get(outcome, 0) + 1
        labels = {"outcome": outcome}
        if self.tenant is not None:
            # bounded label value; the raw tenant id still namespaces the
            # journal and the quarantine ring
            from karpenter_tpu_torch.metrics.registry import tenant_label

            labels["tenant"] = tenant_label(self.tenant)
        WARM_SOLVES.inc(labels=labels)
        DELTA_REUSE_RATIO.set(ratio)
        if slo.enabled():
            slo.on_stream(outcome)
            flight.record(
                flight.KIND_STREAM_CYCLE, outcome=outcome, pods=pods,
                tenant=self.tenant, reuse_ratio=round(ratio, 4),
            )
        trace.attr("streaming_outcome", outcome)
        trace.attr("reuse_ratio", round(ratio, 4))

    def _accept(
        self, pods, pod_digests, nodes, node_digests, instance_types, templates,
        result, certified, order=None,
    ) -> None:
        if order is None:
            order = ffd_order(pods)
        if getattr(result, "verify_ctx", None) is not None:
            # the gate context holds the solve's device tensors: the carried
            # state (and the journal) keep the placement only
            result = dataclasses.replace(result, verify_ctx=None)
        self._prev = _StreamState(
            pods=pods,
            pod_digests=pod_digests,
            nodes=nodes,
            node_digests=node_digests,
            instance_types=list(instance_types),
            templates=list(templates),
            result=result,
            order_uids=[pods[i].uid for i in order],
            certified_uids=frozenset(certified),
            placement_of=_index_placements(pods, result),
        )
        self.last_certified_uids = frozenset(certified)
        self._accepts += 1
        if journal.enabled() and self._accepts % journal.cadence() == 0:
            journal.save(self._prev, self._tag(), namespace=self.tenant)

    def _cold_reason(self, prev, delta, pods, instance_types, templates) -> Optional[str]:
        if prev is None or not pods:
            return "cold-first"
        if delta.added_nodes or delta.changed_nodes:
            # node adds/changes move every bin decision after them; removals
            # are handled warm (their residents become seeds)
            return "cold-world-changed"
        if self._universe_changed(instance_types, prev.instance_types, prev.restored) or self._universe_changed(
            templates, prev.templates, prev.restored
        ):
            return "cold-world-changed"
        if delta.frac > self.max_frac:
            return "cold-threshold"
        return None

    @staticmethod
    def _universe_changed(cur, prev, prev_restored: bool) -> bool:
        """Object identity in the steady state (the provisioner passes the
        same lists), content digests when the previous state came off the
        journal (identity cannot survive a pickle round trip)."""
        if len(cur) != len(prev):
            return True
        if all(a is b for a, b in zip(cur, prev)):
            return False
        if not prev_restored:
            return True
        from karpenter_tpu_torch.streaming.delta import instance_type_digest, template_digest

        fn = template_digest if prev and isinstance(prev[0], TemplateInfo) else instance_type_digest
        return any(fn(a) != fn(b) for a, b in zip(cur, prev))

    # -- the warm path --------------------------------------------------------

    def _warm(self, prev, delta, pods, pod_digests, instance_types, templates, nodes):
        """(result, seed indices, certified uids, FFD order), or None when
        there is nothing to reuse or the merged result fails the exit gate."""
        import time

        uid_index = {p.uid: i for i, p in enumerate(pods)}
        removed_node_names = set(delta.removed_nodes)

        seeds = set(delta.added_pods) | set(delta.changed_pods)
        for uid, (kind, payload) in prev.placement_of.items():
            i = uid_index.get(uid)
            if i is None:
                continue
            if kind == "fail":
                seeds.add(i)  # a delete or reclaim may have freed its blocker
            elif kind == "node" and payload in removed_node_names:
                seeds.add(i)
        # topology closure: any churn can move a count a constrained pod's
        # skew/affinity gate reads, so all of them re-solve together
        if delta.pod_events > 0 or delta.node_events > 0:
            for i, p in enumerate(pods):
                if _has_topology_constraints(p):
                    seeds.add(i)
        if len(seeds) == len(pods):
            return None  # nothing to reuse: cold is strictly simpler

        # pinned pods keep their previous bin; build the merged skeleton
        merged = SolveResult()
        pinned: List[Tuple[int, str, Dict[str, str]]] = []  # (idx, bin name, labels)
        surviving_claims: Dict[int, Placement] = {}
        claim_members: Dict[int, List[int]] = {}
        for uid, (kind, payload) in prev.placement_of.items():
            i = uid_index.get(uid)
            if i is None or i in seeds:
                continue
            if kind == "node":
                merged.node_pods.setdefault(payload, []).append(i)
            elif kind == "claim":
                claim_members.setdefault(payload, []).append(i)

        node_by_name = {n.name: n for n in nodes}
        for name, idxs in merged.node_pods.items():
            if name not in node_by_name:
                return None  # placement map out of sync with the node diff
            labels = node_by_name[name].requirements.labels()
            for i in idxs:
                pinned.append((i, name, labels))

        claim_index_map: Dict[int, int] = {}
        for ci, members in sorted(claim_members.items()):
            old = prev.result.new_claims[ci]
            requests = dict(templates[old.template_index].daemon_overhead)
            for i in members:
                requests = res.merge(requests, {**res.pod_requests(pods[i]), res.PODS: 1.0})
            pl = Placement(
                template_index=old.template_index,
                nodepool_name=old.nodepool_name,
                pod_indices=list(members),
                instance_type_indices=list(old.instance_type_indices),
                requirements=old.requirements.copy(),
                requests=requests,
            )
            claim_index_map[ci] = len(merged.new_claims)
            merged.new_claims.append(pl)
            surviving_claims[ci] = pl
            labels = old.requirements.labels()
            labels[wk.LABEL_HOSTNAME] = _WARM_CLAIM_PREFIX + str(ci)
            for i in members:
                pinned.append((i, _WARM_CLAIM_PREFIX + str(ci), labels))

        # residual world: real nodes with the pinned consumption folded into
        # the overhead, surviving claims as joinable pseudo-nodes
        pinned_by_bin: Dict[str, List[int]] = {}
        for i, bin_name, _ in pinned:
            pinned_by_bin.setdefault(bin_name, []).append(i)
        sub_nodes: List[NodeInfo] = pinned_node_residuals(nodes, pods, pinned_by_bin)
        for ci, pl in sorted(surviving_claims.items()):
            sub_nodes.append(
                claim_pseudo_node(ci, pl, pods, instance_types, templates, prefix=_WARM_CLAIM_PREFIX)
            )

        sub_indices = sorted(seeds)
        sub_pods = [pods[i] for i in sub_indices]
        census = [(pods[i], labels) for i, _, labels in pinned]
        t0 = time.perf_counter()
        sub_result = self.inner.solve(
            sub_pods, instance_types, templates, nodes=sub_nodes, cluster_pods=census,
        )
        t_sub = time.perf_counter()
        self.last_sub_pods = len(sub_pods)

        # fold the sub-solve back in, re-narrowing any claim it joined
        joined: Dict[int, List[int]] = {}
        for name, idxs in sub_result.node_pods.items():
            gidx = [sub_indices[si] for si in idxs]
            if name.startswith(_WARM_CLAIM_PREFIX):
                joined.setdefault(int(name[len(_WARM_CLAIM_PREFIX):]), []).extend(gidx)
            else:
                merged.node_pods.setdefault(name, []).extend(gidx)
        for c in sub_result.new_claims:
            merged.new_claims.append(
                Placement(
                    template_index=c.template_index,
                    nodepool_name=c.nodepool_name,
                    pod_indices=[sub_indices[si] for si in c.pod_indices],
                    instance_type_indices=list(c.instance_type_indices),
                    requirements=c.requirements,
                    requests=c.requests,
                )
            )
        for si, reason in sub_result.failures.items():
            merged.failures[sub_indices[si]] = reason
        sub_explain = getattr(sub_result, "explain", None)
        if sub_explain is not None:
            # failed pods are always seeds, so the sub-solve attributed every
            # failure; re-key its report to batch-global indices
            from karpenter_tpu_torch.obs import explain as obs_explain

            remapped = obs_explain.ExplainReport(
                backend=sub_explain.backend,
                trace_id=sub_explain.trace_id,
                total_pods=len(pods),
                scheduled=len(pods) - len(merged.failures),
                overhead_s=sub_explain.overhead_s,
            )
            for si, expl in sub_explain.pods.items():
                remapped.pods[sub_indices[si]] = dataclasses.replace(expl, pod=sub_indices[si])
            for si, nom in sub_explain.nominations.items():
                remapped.nominations[sub_indices[si]] = nom
            merged.explain = remapped
        for ci, gidx in joined.items():
            pl = surviving_claims[ci]
            for i in gidx:
                pl.requirements.add(*pod_requirements(pods[i]).values())
                pl.requests = res.merge(pl.requests, {**res.pod_requests(pods[i]), res.PODS: 1.0})
                pl.pod_indices.append(i)
            pl.requirements.delete(wk.LABEL_HOSTNAME)
            surviving = [
                ti
                for ti in pl.instance_type_indices
                if not instance_types[ti].requirements.intersects(pl.requirements)
                and _fits(pl.requests, instance_types[ti].allocatable())
                and _has_offering(instance_types[ti], pl.requirements)
            ]
            if not surviving:
                return None
            pl.instance_type_indices = surviving

        from karpenter_tpu_torch import verify

        if verify.enabled():
            # re-gate only what this merge touched: the sub-solve's claims,
            # the reused claims it joined, and the nodes that received pods;
            # untouched pins ride the gate's seeded audit sample
            n_sub = len(sub_result.new_claims)
            touched_claims = set(range(len(merged.new_claims) - n_sub, len(merged.new_claims)))
            touched_claims |= {claim_index_map[ci] for ci in joined}
            scope = verify.IncrementalScope(
                claim_indices=touched_claims,
                node_names={name for name in sub_result.node_pods if not name.startswith(_WARM_CLAIM_PREFIX)},
                check_topology=any(_has_topology_constraints(pods[i]) for i in seeds),
                total_claims=len(merged.new_claims),
                total_nodes=len(nodes),
            )
            violations = verify.incremental_gate(merged, pods, instance_types, templates, nodes, scope)
        else:
            violations = val.validate_result(merged, pods, instance_types, templates, nodes=nodes, level="full")
        t_gate = time.perf_counter()
        if violations:
            return None

        order = ffd_order(pods)
        certified = self._certify(prev, delta, pods, seeds, order)
        self.last_warm_timing = {
            "sub_solve": t_sub - t0,
            "gate": t_gate - t_sub,
            "certify": time.perf_counter() - t_gate,
        }
        return merged, seeds, certified, order

    def _certify(self, prev, delta, pods, seeds, order) -> frozenset:
        """The FFD-queue prefix provably identical to a cold solve: positions
        matching the previous queue uid for uid, stopping at the first seed,
        the first pod outside the previous cycle's own certified set, or
        (when the node set shrank) the first topology-constrained pod."""
        node_set_changed = bool(delta.removed_nodes)
        certified: List[str] = []
        for pos, i in enumerate(order):
            uid = pods[i].uid
            if pos >= len(prev.order_uids) or prev.order_uids[pos] != uid:
                break
            if i in seeds or uid not in prev.certified_uids:
                break
            if node_set_changed and _has_topology_constraints(pods[i]):
                break
            certified.append(uid)
        return frozenset(certified)
