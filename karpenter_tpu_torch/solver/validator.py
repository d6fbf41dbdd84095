"""Host-side invariant gate over SolveResults.

The tensor solver's placements drive real node launches, so before a result
leaves the solver layer the supervisor (solver/supervisor.py) replays the
cheap, provable placement invariants against the ORIGINAL host-side inputs:

  pod-accounting          every input pod lands in exactly one of
                          {a new claim, an existing node, failures}
  claim-requests          a claim's request tensor equals daemonset overhead
                          plus the sum of its pods' requests (the device
                          accumulates in float32, so comparison is
                          relative-tolerant)
  claim-instance-types    a claim keeps at least one surviving instance type
  claim-capacity          the recomputed requests fit at least one of the
                          claim's listed instance types' allocatable
  taint-admissibility     every placed pod tolerates its bin's hard taints
                          (NoSchedule/NoExecute — PreferNoSchedule is soft
                          and relaxation may have added a blanket toleration
                          the original pod spec lacks)
  host-port               host ports are pairwise disjoint within each bin
                          (and against an existing node's already-used ports)
  requirement-intersection a placed pod's label requirements intersect its
                          bin's narrowed requirements (skipped for relaxable
                          pods — relaxation legally drops requirement terms)
  node-unknown/node-capacity  existing-node placements name a known node and
                          fit its available resources
  topology-skew (full)    DoNotSchedule spread skew bounds for non-hostname
                          keys, checked only when the cohort is exactly
                          reconstructible (see _check_topology_skew)
  instance-type-survivor (full)  every listed instance type is compatible
                          with / fits / offers under the claim requirements

Checks are deliberately NECESSARY conditions only: a violation proves the
result is unsafe to act on; silence does not prove optimality. Anything that
cannot be decided from the inputs without replaying the solve (relaxation
ladders, multi-valued topology domains) is skipped rather than guessed — a
false rejection would needlessly fail over a healthy backend.

Levels: ``fast`` (default; everything linear in pods+claims) and ``full``
(adds the per-claim instance-type sweep and topology-skew bounds).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import (
    DO_NOT_SCHEDULE,
    NO_EXECUTE,
    NO_SCHEDULE,
    Pod,
)
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.provisioning.preferences import Preferences
from karpenter_tpu_torch.scheduling import Requirements, pod_requirements
from karpenter_tpu_torch.scheduling.requirements import EXISTS
from karpenter_tpu_torch.scheduling.hostports import get_host_ports
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.solver.backend import SolveResult
from karpenter_tpu_torch.solver.encode import (
    NodeInfo,
    TemplateInfo,
    domains_from_instance_types,
)
from karpenter_tpu_torch.utils import resources as res

# The solver accumulates requests in float32 on device; the recompute
# here is float64, so equality and fits checks carry float32-scale slack.
REL_TOL = 1e-4
ABS_TOL = 1e-6


@dataclass
class Violation:
    invariant: str
    detail: str
    claim_index: Optional[int] = None
    node_name: Optional[str] = None
    pod_indices: Tuple[int, ...] = ()

    def __str__(self) -> str:
        where = ""
        if self.claim_index is not None:
            where = f" [claim {self.claim_index}]"
        elif self.node_name is not None:
            where = f" [node {self.node_name}]"
        return f"{self.invariant}{where}: {self.detail}"


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= ABS_TOL + REL_TOL * max(abs(a), abs(b))


def _fits_loose(requests: Dict[str, float], available: Dict[str, float]) -> bool:
    for name, q in requests.items():
        avail = available.get(name, 0.0)
        if q > avail + ABS_TOL + REL_TOL * abs(avail):
            return False
    return True


def has_nan(result: SolveResult) -> bool:
    """NaN/inf anywhere in the result's request tensors — the signature of a
    diverged device reduction; such a result must never reach the validator's
    arithmetic, let alone a cloud Create call."""
    for claim in result.new_claims:
        for v in claim.requests.values():
            if v != v or v in (float("inf"), float("-inf")):
                return True
    return False


def _hard_taints(taints: Taints) -> Taints:
    return Taints(t for t in taints if t.effect in (NO_SCHEDULE, NO_EXECUTE))


def checked_requirements(pod: Pod) -> Optional[Requirements]:
    """A placed pod's label requirements, when they are provably still in
    force: relaxation may have legally dropped affinity terms, so relaxable
    pods are skipped unless an override pins them. Pods with no node selector
    and no node affinity have empty requirements — trivially intersecting —
    and skip the recompute entirely (the common case on large batches; this
    keeps the fast gate sub-0.5% of a 10k solve). Module-level so the device
    gate (verify/gate.py) derives its pod_check mask from the same predicate
    the host intersection checks use."""
    if not pod.spec.node_selector:
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None:
            return None
    if Preferences.is_relaxable(pod):
        return None
    return pod_requirements(pod)


def _port_clashes(pods_ports: List[Tuple[int, list]], pre_used: list) -> List[str]:
    errs = []
    used = [(None, p) for p in pre_used]
    for pi, ports in pods_ports:
        for port in ports:
            for owner, existing in used:
                if port.matches(existing):
                    errs.append(
                        f"pod {pi} port {port.protocol}/{port.port} clashes "
                        f"with {'node' if owner is None else f'pod {owner}'}"
                    )
        used.extend((pi, p) for p in ports)
    return errs


def validate_result(
    result: SolveResult,
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    templates: Sequence[TemplateInfo],
    nodes: Sequence[NodeInfo] = (),
    pod_requirements_override: Optional[Sequence[Requirements]] = None,
    cluster_pods: Sequence = (),
    domains: Optional[Dict[str, set]] = None,
    level: str = "fast",
    *,
    claim_scope: Optional[set] = None,
    node_scope: Optional[set] = None,
    check_topology: bool = True,
) -> List[Violation]:
    """``claim_scope`` / ``node_scope`` / ``check_topology`` scope the check
    to a row subset (verify/ incremental re-checks and the sampled float64
    audit): None means every bin, a set restricts the per-claim / per-node
    loops to those claim indices / node names. Pod accounting always runs —
    it is the cross-bin invariant scoping cannot localize. Defaults keep the
    historical full-surface behavior bit-for-bit. Runs under a ``validate``
    trace span (obs/trace.py), as the JAX package's does."""
    from karpenter_tpu_torch.obs import trace

    with trace.span("validate", level=level) as sp:
        violations = _validate_result(
            result, pods, instance_types, templates, nodes,
            pod_requirements_override, cluster_pods, domains, level,
            claim_scope=claim_scope, node_scope=node_scope,
            check_topology=check_topology,
        )
        if sp is not None and violations:
            sp.count("violations", len(violations))
        return violations


def full_gate_relaxed(
    result: SolveResult,
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    templates: Sequence[TemplateInfo],
    nodes: Sequence[NodeInfo] = (),
    pod_requirements_override: Optional[Sequence[Requirements]] = None,
    cluster_pods: Sequence = (),
    domains: Optional[Dict[str, set]] = None,
) -> List[Violation]:
    """The relaxed-solve contract (KARPENTER_TPU_RELAX, round 15): phase-1
    placements are validator-equivalent to FFD rather than bit-identical, so
    EVERY result the two-phase path produces is full-gated here before the
    backend returns it — a violation makes the backend redo the solve with
    relaxation off (solver_relax_fallback_total) instead of acting on it.
    Just validate_result at the full level under the relax span's roof; a
    named wrapper so call sites and tests pin the contract, not a string."""
    return validate_result(
        result, pods, instance_types, templates, nodes,
        pod_requirements_override, cluster_pods, domains, level="full",
    )


def _validate_result(
    result: SolveResult,
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    templates: Sequence[TemplateInfo],
    nodes: Sequence[NodeInfo] = (),
    pod_requirements_override: Optional[Sequence[Requirements]] = None,
    cluster_pods: Sequence = (),
    domains: Optional[Dict[str, set]] = None,
    level: str = "fast",
    *,
    claim_scope: Optional[set] = None,
    node_scope: Optional[set] = None,
    check_topology: bool = True,
) -> List[Violation]:
    violations: List[Violation] = []
    node_by_name = {n.name: n for n in nodes}

    # -- pod accounting -------------------------------------------------------
    seen: Dict[int, str] = {}

    def account(pi: int, where: str):
        if pi in seen:
            violations.append(
                Violation(
                    "pod-accounting",
                    f"pod {pi} placed in both {seen[pi]} and {where}",
                    pod_indices=(pi,),
                )
            )
        seen[pi] = where

    for ci, claim in enumerate(result.new_claims):
        for pi in claim.pod_indices:
            account(pi, f"claim {ci}")
    for name, indices in result.node_pods.items():
        for pi in indices:
            account(pi, f"node {name}")
    for pi in result.failures:
        account(pi, "failures")
    missing = [pi for pi in range(len(pods)) if pi not in seen]
    if missing:
        violations.append(
            Violation(
                "pod-accounting",
                f"{len(missing)} pod(s) dropped (neither placed nor failed): "
                f"{missing[:8]}",
                pod_indices=tuple(missing[:8]),
            )
        )
    out_of_range = [pi for pi in seen if not 0 <= pi < len(pods)]
    if out_of_range:
        violations.append(
            Violation(
                "pod-accounting",
                f"placement references unknown pod indices {out_of_range[:8]}",
            )
        )
        return violations  # downstream checks would index out of bounds

    def reqs_of(pi: int) -> Optional[Requirements]:
        if pod_requirements_override is not None:
            return pod_requirements_override[pi]
        return checked_requirements(pods[pi])

    # -- per-claim invariants -------------------------------------------------
    for ci, claim in enumerate(result.new_claims):
        if claim_scope is not None and ci not in claim_scope:
            continue
        if not 0 <= claim.template_index < len(templates):
            violations.append(
                Violation(
                    "claim-template",
                    f"unknown template index {claim.template_index}",
                    claim_index=ci,
                )
            )
            continue
        tpl = templates[claim.template_index]
        if not claim.pod_indices:
            violations.append(
                Violation("claim-empty", "claim schedules no pods", claim_index=ci)
            )
            continue

        # requests must equal daemon overhead + sum of pod requests
        expected = dict(tpl.daemon_overhead)
        for pi in claim.pod_indices:
            expected = res.merge(
                expected, {**res.pod_requests(pods[pi]), res.PODS: 1.0}
            )
        keys = set(expected) | set(claim.requests)
        for key in keys:
            if not _close(expected.get(key, 0.0), claim.requests.get(key, 0.0)):
                violations.append(
                    Violation(
                        "claim-requests",
                        f"requests[{key}]={claim.requests.get(key, 0.0):g} but "
                        f"pods sum to {expected.get(key, 0.0):g}",
                        claim_index=ci,
                    )
                )
                break

        its = [
            ti for ti in claim.instance_type_indices
            if 0 <= ti < len(instance_types)
        ]
        if len(its) != len(claim.instance_type_indices):
            violations.append(
                Violation(
                    "claim-instance-types",
                    "placement references unknown instance-type indices",
                    claim_index=ci,
                )
            )
        if not its:
            violations.append(
                Violation(
                    "claim-instance-types",
                    "no surviving instance types",
                    claim_index=ci,
                )
            )
        else:
            # a valid claim fits EVERY listed type, so the loop exits on the
            # first check; an overpacked bin scans all of them and reports
            if not any(
                _fits_loose(expected, instance_types[ti].allocatable())
                for ti in its
            ):
                violations.append(
                    Violation(
                        "claim-capacity",
                        f"recomputed requests {expected} exceed allocatable of "
                        f"all {len(its)} listed instance types",
                        claim_index=ci,
                    )
                )

        hard = _hard_taints(tpl.taints)
        if hard:
            for pi in claim.pod_indices:
                errs = hard.tolerates(pods[pi])
                if errs:
                    violations.append(
                        Violation(
                            "taint-admissibility",
                            f"pod {pi}: {'; '.join(errs)}",
                            claim_index=ci,
                            pod_indices=(pi,),
                        )
                    )

        clashes = _port_clashes(
            [(pi, get_host_ports(pods[pi])) for pi in claim.pod_indices], []
        )
        for err in clashes:
            violations.append(Violation("host-port", err, claim_index=ci))

        if claim.requirements is not None:
            for pi in claim.pod_indices:
                reqs = reqs_of(pi)
                if reqs is None:
                    continue
                errs = claim.requirements.intersects(reqs)
                if errs:
                    violations.append(
                        Violation(
                            "requirement-intersection",
                            f"pod {pi}: {'; '.join(errs)}",
                            claim_index=ci,
                            pod_indices=(pi,),
                        )
                    )

        if level == "full" and claim.requirements is not None:
            for ti in its:
                it = instance_types[ti]
                if it.requirements.intersects(claim.requirements):
                    violations.append(
                        Violation(
                            "instance-type-survivor",
                            f"{it.name} conflicts with claim requirements",
                            claim_index=ci,
                        )
                    )
                    break
                if not _fits_loose(expected, it.allocatable()):
                    violations.append(
                        Violation(
                            "instance-type-survivor",
                            f"{it.name} cannot fit the claim's requests",
                            claim_index=ci,
                        )
                    )
                    break
                if not it.offerings.available().requirements(claim.requirements):
                    violations.append(
                        Violation(
                            "instance-type-survivor",
                            f"{it.name} has no offering under claim requirements",
                            claim_index=ci,
                        )
                    )
                    break

    # -- existing-node invariants ---------------------------------------------
    for name, indices in result.node_pods.items():
        if node_scope is not None and name not in node_scope:
            continue
        node = node_by_name.get(name)
        if node is None:
            violations.append(
                Violation(
                    "node-unknown",
                    f"placement targets node {name!r} not in the solve inputs",
                    node_name=name,
                )
            )
            continue
        merged = dict(node.daemon_overhead)
        for pi in indices:
            merged = res.merge(merged, {**res.pod_requests(pods[pi]), res.PODS: 1.0})
        if not _fits_loose(merged, node.available):
            violations.append(
                Violation(
                    "node-capacity",
                    f"pods {indices} plus daemon overhead exceed available "
                    f"resources",
                    node_name=name,
                )
            )
        hard = _hard_taints(node.taints)
        if hard:
            for pi in indices:
                errs = hard.tolerates(pods[pi])
                if errs:
                    violations.append(
                        Violation(
                            "taint-admissibility",
                            f"pod {pi}: {'; '.join(errs)}",
                            node_name=name,
                            pod_indices=(pi,),
                        )
                    )
        clashes = _port_clashes(
            [(pi, get_host_ports(pods[pi])) for pi in indices],
            list(node.host_ports),
        )
        for err in clashes:
            violations.append(Violation("host-port", err, node_name=name))
        for pi in indices:
            reqs = reqs_of(pi)
            if reqs is None:
                continue
            errs = node.requirements.intersects(reqs)
            if errs:
                violations.append(
                    Violation(
                        "requirement-intersection",
                        f"pod {pi}: {'; '.join(errs)}",
                        node_name=name,
                        pod_indices=(pi,),
                    )
                )

    if level == "full" and check_topology:
        violations.extend(
            _check_topology_skew(
                result, pods, instance_types, templates, nodes,
                pod_requirements_override, cluster_pods, domains,
            )
        )
    return violations


def _check_topology_skew(
    result: SolveResult,
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    templates: Sequence[TemplateInfo],
    nodes: Sequence[NodeInfo],
    pod_requirements_override,
    cluster_pods: Sequence,
    domains: Optional[Dict[str, set]],
) -> List[Violation]:
    """DoNotSchedule spread skew over the full registered domain universe,
    for non-hostname keys. Checked only when the final counts are exactly
    reconstructible without replaying the solve:

      - every batch pod matching the selector carries the identical
        constraint (one shared cohort),
      - no cluster pod matches the selector (no pre-existing counts),
      - every matching pod was placed (a failed pod never consumed a slot),
      - no matching pod is relaxable (relaxation may drop the constraint),
      - no matching pod carries its own requirement on the topology key
        (which would shrink its eligible-domain set below the universe),
      - every matched placement pins the key to a single domain value.

    Hostname spreads are out of scope: their domain universe grows with each
    minted claim, so the end-state counts cannot bound what any prefix of
    the mint sequence saw, and an overpacked hostname shows up as a
    capacity violation anyway.
    """
    violations: List[Violation] = []
    if domains is None:
        domains = domains_from_instance_types(instance_types, templates)

    # bin of every placed pod: pod index -> key-valued Requirements container
    placed_reqs: Dict[int, Requirements] = {}
    for claim in result.new_claims:
        if claim.requirements is None:
            return violations
        for pi in claim.pod_indices:
            placed_reqs[pi] = claim.requirements
    node_by_name = {n.name: n for n in nodes}
    for name, indices in result.node_pods.items():
        node = node_by_name.get(name)
        if node is None:
            return violations
        for pi in indices:
            placed_reqs[pi] = node.requirements

    # group constraints by (key, skew, selector CONTENT): every cohort pod
    # carries its own constraint instance, so an identity dedup would rescan
    # the same O(P) cohort once per member — quadratic on spread-heavy mixes.
    # The check depends only on the constraint's content, so content-equal
    # signatures are one class and one scan.
    from karpenter_tpu_torch.provisioning.topology import _selector_key

    checked = set()
    for pi, pod in enumerate(pods):
        for tsc in pod.spec.topology_spread_constraints or ():
            if tsc.when_unsatisfiable != DO_NOT_SCHEDULE:
                continue
            key = tsc.topology_key
            if key == wk.LABEL_HOSTNAME or key not in domains:
                continue
            sig = (key, tsc.max_skew, _selector_key(tsc.label_selector))
            if sig in checked:
                continue
            checked.add(sig)
            selector = tsc.label_selector
            cohort = [
                qi for qi, q in enumerate(pods)
                if selector is not None and selector.matches(q.metadata.labels)
            ]
            if not cohort:
                continue
            # preconditions: exact cohort, fully placed, constraint-identical
            ok = True
            for qi in cohort:
                q = pods[qi]
                same = [
                    c for c in (q.spec.topology_spread_constraints or ())
                    if c.topology_key == key
                    and c.when_unsatisfiable == DO_NOT_SCHEDULE
                    and c.max_skew == tsc.max_skew
                ]
                if not same or Preferences.is_relaxable(q):
                    ok = False
                    break
                own = (
                    pod_requirements_override[qi]
                    if pod_requirements_override is not None
                    else pod_requirements(q)
                )
                own_req = own.get(key)
                if own_req is not None and not (
                    # a bare Exists (what pod_requirements synthesizes for
                    # every spread topology key) admits every domain value
                    # and must not disable the check
                    own_req.operator() == EXISTS
                    and own_req.greater_than is None
                    and own_req.less_than is None
                ):
                    ok = False
                    break
                if qi not in placed_reqs:
                    ok = False
                    break
            if not ok:
                continue
            if any(
                selector.matches(cp[0].metadata.labels) if isinstance(cp, tuple)
                else selector.matches(cp.metadata.labels)
                for cp in cluster_pods
            ):
                continue
            counts: Dict[str, int] = {d: 0 for d in domains[key]}
            exact = True
            for qi in cohort:
                req = placed_reqs[qi].get(key)
                values = req.sorted_values() if req is not None else []
                if len(values) != 1 or values[0] not in counts:
                    exact = False
                    break
                counts[values[0]] += 1
            if not exact:
                continue
            skew = max(counts.values()) - min(counts.values())
            if skew > tsc.max_skew:
                # pin the whole cohort: the content dedup reports each class
                # once, and strip_violations must still requeue every bin the
                # cohort occupies (the identity dedup used to reach them via
                # one violation per member)
                violations.append(
                    Violation(
                        "topology-skew",
                        f"key {key}: domain counts {counts} skew {skew} > "
                        f"max_skew {tsc.max_skew}",
                        pod_indices=tuple(cohort),
                    )
                )
    return violations


def strip_violations(
    result: SolveResult, violations: Sequence[Violation], reason: str
) -> SolveResult:
    """Salvage: a fresh SolveResult without the violating bins, their pods
    requeued via ``failures`` (the provisioning layer re-solves them next
    cycle). Used when a validation failure has no healthy backend to fail
    over to — the rest of the committed placements are still safe."""
    pod_bin: Dict[int, List] = {}
    for ci, claim in enumerate(result.new_claims):
        for pi in claim.pod_indices:
            pod_bin.setdefault(pi, []).append(("claim", ci))
    for name, indices in result.node_pods.items():
        for pi in indices:
            pod_bin.setdefault(pi, []).append(("node", name))
    bad_claims = {v.claim_index for v in violations if v.claim_index is not None}
    bad_nodes = {v.node_name for v in violations if v.node_name is not None}
    # a violation pinned to pods rather than a bin (accounting, skew) strips
    # every bin holding those pods
    for v in violations:
        if v.claim_index is None and v.node_name is None:
            for pi in v.pod_indices:
                for kind, ref in pod_bin.get(pi, []):
                    (bad_claims if kind == "claim" else bad_nodes).add(ref)
    out = SolveResult(failures=dict(result.failures))
    for ci, claim in enumerate(result.new_claims):
        if ci in bad_claims:
            for pi in claim.pod_indices:
                out.failures[pi] = reason
        else:
            out.new_claims.append(claim)
    for name, indices in result.node_pods.items():
        if name in bad_nodes:
            for pi in indices:
                out.failures[pi] = reason
        else:
            out.node_pods[name] = indices
    for v in violations:
        for pi in v.pod_indices:
            if pi not in pod_bin and pi not in out.failures:
                out.failures[pi] = reason
    return out
