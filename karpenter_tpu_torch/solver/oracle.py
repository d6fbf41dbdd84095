"""Pure-Python FFD oracle — the supervisor's exact fallback.

Counterpart of the JAX package's ``solver/oracle.py``: a mirror of the
reference scheduler's placement semantics (scheduler.go:140-285,
nodeclaim.go:65-119, existingnode.go:64-124, topology.go, preferences.go),
the golden model the tensor solvers are tested against, and the fallback
backend under ``solver/supervisor.SupervisedSolver``.

The relax-and-retry loop is pass-structured: each pass attempts every queued
pod once in FFD order against persistent bin state; after a pass, every failed
pod is relaxed one notch (preferences.go ladder) and retried. The reference
interleaves retries within one queue using cycle detection
(scheduler.go:150-170, queue.go:46-70) — the pass structure reaches the same
fixed point and both backends implement it identically.

With ``KARPENTER_TPU_EXPLAIN`` set, the terminal pass's failed pods get the
host half of the explain pair (``_explain``): a per-family re-run of the
gates, folded through the same obs/explain.py encode/decode helpers as the
device attribution, so that both give the same reasons.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import IN, Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.provisioning.preferences import Preferences
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.scheduling import (
    Requirement,
    Requirements,
    has_preferred_node_affinity,
    pod_requirements,
    strict_pod_requirements,
)
from karpenter_tpu_torch.scheduling.hostports import HostPort, get_host_ports
from karpenter_tpu_torch.solver.backend import (
    FAIL_INCOMPATIBLE,
    Placement,
    SolveResult,
    SolverBackend,
)
from karpenter_tpu_torch.solver.encode import (
    NodeInfo,
    TemplateInfo,
    claim_hostname,
    domains_from_instance_types,
    ffd_order,
)
from karpenter_tpu_torch.utils import resources as res


def _fits(requests: Dict[str, float], available: Dict[str, float]) -> bool:
    # same tolerance as ops/masks.py fits() so both backends agree bit-for-bit
    for name, q in requests.items():
        avail = available.get(name, 0.0)
        if q > avail + 1e-6 + 1e-6 * abs(avail):
            return False
    return True


def _has_offering(it: InstanceType, reqs: Requirements) -> bool:
    return len(it.offerings.available().requirements(reqs)) > 0


def _port_conflict(used: List[HostPort], ports: List[HostPort]) -> bool:
    return any(new.matches(existing) for new in ports for existing in used)


@dataclass
class _OpenClaim:
    template_index: int
    template: TemplateInfo
    requirements: Requirements
    requests: Dict[str, float]
    it_indices: List[int]
    pod_indices: List[int] = field(default_factory=list)
    used_ports: List[HostPort] = field(default_factory=list)
    seq: int = 0


@dataclass
class _NodeBin:
    info: NodeInfo
    requirements: Requirements
    requests: Dict[str, float]
    pod_indices: List[int] = field(default_factory=list)
    used_ports: List[HostPort] = field(default_factory=list)
    vol_counts: Dict[str, int] = field(default_factory=dict)

    def vol_fits(self, pod_vols) -> bool:
        """Count-based CSI gate — intentionally the tensor solver's semantics
        (see volumeusage.py docstring) so both backends agree bit-for-bit."""
        if not pod_vols:
            return True
        for driver, ids in pod_vols.items():
            limit = self.info.volume_limits.get(driver)
            if limit is None:
                continue
            if self.vol_counts.get(driver, 0) + len(ids) > limit:
                return False
        return True

    def vol_add(self, pod_vols) -> None:
        for driver, ids in (pod_vols or {}).items():
            if driver in self.info.volume_limits:
                self.vol_counts[driver] = self.vol_counts.get(driver, 0) + len(ids)


class OracleSolver(SolverBackend):
    def __init__(self, well_known: frozenset = wk.WELL_KNOWN_LABELS):
        self.well_known = well_known

    def solve(
        self,
        pods: Sequence[Pod],
        instance_types: Sequence[InstanceType],
        templates: Sequence[TemplateInfo],
        nodes: Sequence[NodeInfo] = (),
        pod_requirements_override: Optional[Sequence[Requirements]] = None,
        topology: Optional[Topology] = None,
        cluster_pods: Sequence = (),
        domains: Optional[Dict[str, set]] = None,
        pod_volumes: Optional[Sequence[Dict[str, frozenset]]] = None,
    ) -> SolveResult:
        # copy-on-write: pods are only copied when relaxation mutates them;
        # a caller-provided topology is isolated so the caller's group state
        # never sees this solve's relaxations (as the torch backend does)
        work = list(pods)
        copied = set()
        if domains is None:
            domains = domains_from_instance_types(instance_types, templates)
        topo = (
            topology.clone()
            if topology is not None
            else Topology(domains, batch_pods=work, cluster_pods=cluster_pods)
        )
        for n in nodes:
            topo.register(wk.LABEL_HOSTNAME, n.name)
        prefs = Preferences(
            tolerate_prefer_no_schedule=any(
                t.effect == "PreferNoSchedule" for tpl in templates for t in tpl.taints
            )
        )

        node_bins = [
            _NodeBin(
                info=n,
                requirements=n.requirements.copy(),
                requests=dict(n.daemon_overhead),
                used_ports=list(n.host_ports),
                vol_counts=dict(n.volume_used),
            )
            for n in nodes
        ]
        claims: List[_OpenClaim] = []
        remaining = [
            dict(t.remaining_resources) if t.remaining_resources is not None else None
            for t in templates
        ]
        result = SolveResult()

        queue = list(range(len(work)))
        while queue:
            progress = False
            failed: List[int] = []
            for pi in [queue[i] for i in ffd_order([work[i] for i in queue])]:
                pod = work[pi]
                # the override pins label requirements for the whole solve —
                # relax still runs its full ladder but node-affinity steps
                # can't change the pinned reqs (tensor-solver parity)
                if pod_requirements_override is not None:
                    reqs = pod_requirements_override[pi]
                    strict = reqs
                else:
                    reqs = pod_requirements(pod)
                    strict = (
                        strict_pod_requirements(pod)
                        if has_preferred_node_affinity(pod)
                        else reqs
                    )
                requests = {**res.pod_requests(pod), res.PODS: 1.0}
                ports = get_host_ports(pod)
                vols = pod_volumes[pi] if pod_volumes is not None else None
                if (
                    self._try_nodes(pi, pod, reqs, strict, requests, ports, vols,
                                    node_bins, topo)
                    or self._try_claims(
                        pi, pod, reqs, strict, requests, ports, claims, instance_types, topo
                    )
                    or self._try_templates(
                        pi, pod, reqs, strict, requests, ports, claims, templates,
                        instance_types, remaining, topo,
                    )
                ):
                    progress = True
                else:
                    failed.append(pi)
            relaxed_any = False
            for pi in failed:
                if pi not in copied:
                    work[pi] = copy.deepcopy(work[pi])
                    copied.add(pi)
                if prefs.relax(work[pi]) is not None:
                    relaxed_any = True
                    topo.update(work[pi])
            if not progress and not relaxed_any:
                # same host-side forensics as the torch backend (forensics.py)
                from karpenter_tpu_torch.solver.forensics import failure_reason

                for pi in failed:
                    result.failures[pi] = failure_reason(
                        work[pi],
                        instance_types,
                        templates,
                        pod_reqs=(
                            pod_requirements_override[pi]
                            if pod_requirements_override is not None
                            else None
                        ),
                        well_known=self.well_known,
                    ) or FAIL_INCOMPATIBLE
                from karpenter_tpu_torch.obs import explain as obs_explain

                if obs_explain.enabled():
                    # the terminal pass committed nothing, so this state is
                    # exactly what every failed pod was last evaluated against
                    result.explain = self._explain(
                        failed, work, pod_requirements_override, pod_volumes,
                        node_bins, claims, templates, instance_types,
                        remaining, topo, total_pods=len(work),
                    )
                break
            queue = failed

        for nb in node_bins:
            if nb.pod_indices:
                result.node_pods[nb.info.name] = nb.pod_indices
        for claim in claims:
            reqs_out = claim.requirements.copy()
            reqs_out.delete(wk.LABEL_HOSTNAME)  # FinalizeScheduling (nodeclaim.go:123-127)
            result.new_claims.append(
                Placement(
                    template_index=claim.template_index,
                    nodepool_name=claim.template.nodepool_name,
                    pod_indices=claim.pod_indices,
                    instance_type_indices=claim.it_indices,
                    requirements=reqs_out,
                    requests=claim.requests,
                )
            )
        return result

    # -- placement attempts, in reference priority order ----------------------

    def _try_nodes(self, pi, pod, reqs, strict, requests, ports, vols, node_bins, topo) -> bool:
        for nb in node_bins:
            if nb.info.taints.tolerates(pod):
                continue
            if _port_conflict(nb.used_ports, ports):
                continue
            if not nb.vol_fits(vols):
                continue
            merged_requests = res.merge(nb.requests, requests)
            if not _fits(merged_requests, nb.info.available):
                continue
            # strict Compatible — no well-known allowance (existingnode.go:94)
            if not nb.requirements.is_compatible(reqs):
                continue
            merged = nb.requirements.copy()
            merged.add(*reqs.values())
            topo_reqs = topo.add_requirements(strict, merged, pod)
            if topo_reqs is None or not merged.is_compatible(topo_reqs):
                continue
            merged.add(*topo_reqs.values())
            nb.requests = merged_requests
            nb.requirements = merged
            nb.pod_indices.append(pi)
            nb.used_ports.extend(ports)
            nb.vol_add(vols)
            topo.record(pod, merged)
            return True
        return False

    def _try_claims(
        self, pi, pod, reqs, strict, requests, ports, claims, instance_types, topo
    ) -> bool:
        for claim in sorted(claims, key=lambda c: (len(c.pod_indices), c.seq)):
            if claim.template.taints.tolerates(pod):
                continue
            if _port_conflict(claim.used_ports, ports):
                continue
            if not claim.requirements.is_compatible(reqs, self.well_known):
                continue
            narrowed = claim.requirements.copy()
            narrowed.add(*reqs.values())
            topo_reqs = topo.add_requirements(strict, narrowed, pod, self.well_known)
            if topo_reqs is None or not narrowed.is_compatible(topo_reqs, self.well_known):
                continue
            narrowed.add(*topo_reqs.values())
            merged = res.merge(claim.requests, requests)
            surviving = [
                ti
                for ti in claim.it_indices
                if not instance_types[ti].requirements.intersects(narrowed)
                and _fits(merged, instance_types[ti].allocatable())
                and _has_offering(instance_types[ti], narrowed)
            ]
            if not surviving:
                continue
            claim.requirements = narrowed
            claim.requests = merged
            claim.it_indices = surviving
            claim.pod_indices.append(pi)
            claim.used_ports.extend(ports)
            topo.record(pod, narrowed, self.well_known)
            return True
        return False

    def _try_templates(
        self, pi, pod, reqs, strict, requests, ports, claims, templates,
        instance_types, remaining, topo,
    ) -> bool:
        # the prospective claim's hostname is minted once for this step;
        # registration is rolled back if no template accepts the pod (the
        # reference leaks ghost registrations here — both backends don't)
        hostname = claim_hostname(len(claims))
        topo.register(wk.LABEL_HOSTNAME, hostname)
        for ti_idx, tpl in enumerate(templates):
            if tpl.taints.tolerates(pod):
                continue
            if not tpl.requirements.is_compatible(reqs, self.well_known):
                continue
            narrowed = tpl.requirements.copy()
            narrowed.add(Requirement(wk.LABEL_HOSTNAME, IN, [hostname]))
            narrowed.add(*reqs.values())
            topo_reqs = topo.add_requirements(strict, narrowed, pod, self.well_known)
            if topo_reqs is None or not narrowed.is_compatible(topo_reqs, self.well_known):
                continue
            narrowed.add(*topo_reqs.values())
            merged = res.merge(tpl.daemon_overhead, requests)
            # nodepool limits: drop instance types whose capacity exceeds the
            # pool's remaining headroom (filterByRemainingResources)
            universe = tpl.instance_type_indices
            if remaining[ti_idx] is not None:
                universe = [
                    t
                    for t in universe
                    if _fits(
                        {
                            name: instance_types[t].capacity.get(name, 0.0)
                            for name in remaining[ti_idx]
                        },
                        remaining[ti_idx],
                    )
                ]
            surviving = [
                t
                for t in universe
                if not instance_types[t].requirements.intersects(narrowed)
                and _fits(merged, instance_types[t].allocatable())
                and _has_offering(instance_types[t], narrowed)
            ]
            if not surviving:
                continue
            if remaining[ti_idx] is not None:
                # pessimistic headroom burn (subtractMax, scheduler.go:347-364)
                max_cap = res.max_resources(
                    *(instance_types[t].capacity for t in surviving)
                )
                remaining[ti_idx] = {
                    name: q - max_cap.get(name, 0.0)
                    for name, q in remaining[ti_idx].items()
                }
            claims.append(
                _OpenClaim(
                    template_index=ti_idx,
                    template=tpl,
                    requirements=narrowed,
                    requests=merged,
                    it_indices=surviving,
                    pod_indices=[pi],
                    used_ports=list(ports),
                    seq=len(claims),
                )
            )
            topo.record(pod, narrowed, self.well_known)
            return True
        # roll back the ghost hostname registration
        for tg in list(topo.topologies.values()) + list(topo.inverse_topologies.values()):
            if tg.key == wk.LABEL_HOSTNAME and tg.domains.get(hostname) == 0:
                del tg.domains[hostname]
        return False

    # -- explainability (obs/explain.py): per-family re-run of the gates ------
    # The host half of the parity pair: the same checks _try_nodes/_try_claims/
    # _try_templates short-circuit through are evaluated exhaustively per
    # candidate, then folded through the SAME encode/decode helpers the device
    # attribution path uses — the parity test compares reasons, and any drift
    # is a real semantic divergence, not a taxonomy mismatch.

    def _explain(self, failed, work, override, pod_volumes, node_bins, claims,
                 templates, instance_types, remaining, topo, total_pods):
        import time

        from karpenter_tpu_torch.obs import explain as ox

        t0 = time.perf_counter()
        report = ox.ExplainReport(
            backend=type(self).__name__,
            total_pods=total_pods,
            scheduled=total_pods - len(failed),
        )
        for pi in failed:
            pod = work[pi]
            if override is not None:
                reqs = strict = override[pi]
            else:
                reqs = pod_requirements(pod)
                strict = (
                    strict_pod_requirements(pod)
                    if has_preferred_node_affinity(pod)
                    else reqs
                )
            requests = {**res.pod_requests(pod), res.PODS: 1.0}
            ports = get_host_ports(pod)
            vols = pod_volumes[pi] if pod_volumes is not None else None
            words = ox.pack_words((
                self._node_families(pod, reqs, strict, requests, ports, vols,
                                    node_bins, topo),
                self._claim_families(pod, reqs, strict, requests, ports,
                                     claims, instance_types, topo),
                self._template_families(pod, reqs, strict, requests, claims,
                                        templates, instance_types, remaining,
                                        topo),
            ))
            expl = ox.decode_pod(pi, ox._KIND_FAIL, words)
            if expl.reason == ox.REASON_RESOURCES:
                better = ox.resource_hint(requests, instance_types)
                if better:
                    expl.hint = better
            report.pods[pi] = expl
        report.overhead_s = time.perf_counter() - t0
        ox.publish(report)
        return report

    def _topo_fails(self, strict, merged, pod, topo, allow=frozenset()) -> bool:
        try:
            topo_reqs = topo.add_requirements(strict, merged, pod, allow)
        except Exception:
            return True
        return topo_reqs is None or not merged.is_compatible(topo_reqs, allow)

    def _node_families(self, pod, reqs, strict, requests, ports, vols,
                       node_bins, topo):
        from karpenter_tpu_torch.obs import explain as ox

        fails = [[False] * len(node_bins) for _ in range(ox.NUM_FAMILIES)]
        for e, nb in enumerate(node_bins):
            fails[ox.FAM_TAINTS][e] = bool(nb.info.taints.tolerates(pod))
            fails[ox.FAM_PORTS][e] = _port_conflict(nb.used_ports, ports)
            fails[ox.FAM_VOLUME][e] = not nb.vol_fits(vols)
            fails[ox.FAM_RESOURCES][e] = not _fits(
                res.merge(nb.requests, requests), nb.info.available
            )
            compat = nb.requirements.is_compatible(reqs)
            fails[ox.FAM_REQUIREMENTS][e] = not compat
            merged = nb.requirements.copy()
            merged.add(*reqs.values())
            fails[ox.FAM_TOPOLOGY][e] = self._topo_fails(strict, merged, pod, topo)
        return ox.encode_family_bits(fails, [True] * len(node_bins))

    def _claim_families(self, pod, reqs, strict, requests, ports, claims,
                        instance_types, topo):
        from karpenter_tpu_torch.obs import explain as ox

        fails = [[False] * len(claims) for _ in range(ox.NUM_FAMILIES)]
        for e, claim in enumerate(claims):
            fails[ox.FAM_TAINTS][e] = bool(claim.template.taints.tolerates(pod))
            fails[ox.FAM_PORTS][e] = _port_conflict(claim.used_ports, ports)
            compat = claim.requirements.is_compatible(reqs, self.well_known)
            narrowed = claim.requirements.copy()
            narrowed.add(*reqs.values())
            topo_fail = self._topo_fails(strict, narrowed, pod, topo, self.well_known)
            fails[ox.FAM_TOPOLOGY][e] = topo_fail
            if not topo_fail:
                topo_reqs = topo.add_requirements(strict, narrowed, pod, self.well_known)
                narrowed.add(*topo_reqs.values())
            merged = res.merge(claim.requests, requests)
            co = [
                ti for ti in claim.it_indices
                if not instance_types[ti].requirements.intersects(narrowed)
                and _has_offering(instance_types[ti], narrowed)
            ]
            has_fit = any(
                _fits(merged, instance_types[ti].allocatable()) for ti in co
            )
            has_base = bool(claim.it_indices)
            fails[ox.FAM_RESOURCES][e] = (bool(co) and not has_fit) or not has_base
            fails[ox.FAM_REQUIREMENTS][e] = not compat or (has_base and not co)
        return ox.encode_family_bits(fails, [True] * len(claims))

    def _template_families(self, pod, reqs, strict, requests, claims,
                           templates, instance_types, remaining, topo):
        from karpenter_tpu_torch.obs import explain as ox

        # mint the same prospective hostname the terminal _try_templates used
        hostname = claim_hostname(len(claims))
        topo.register(wk.LABEL_HOSTNAME, hostname)
        fails = [[False] * len(templates) for _ in range(ox.NUM_FAMILIES)]
        try:
            for e, tpl in enumerate(templates):
                fails[ox.FAM_TAINTS][e] = bool(tpl.taints.tolerates(pod))
                compat = tpl.requirements.is_compatible(reqs, self.well_known)
                narrowed = tpl.requirements.copy()
                narrowed.add(Requirement(wk.LABEL_HOSTNAME, IN, [hostname]))
                narrowed.add(*reqs.values())
                topo_fail = self._topo_fails(strict, narrowed, pod, topo, self.well_known)
                fails[ox.FAM_TOPOLOGY][e] = topo_fail
                if not topo_fail:
                    topo_reqs = topo.add_requirements(strict, narrowed, pod, self.well_known)
                    narrowed.add(*topo_reqs.values())
                merged = res.merge(tpl.daemon_overhead, requests)
                universe = tpl.instance_type_indices
                has_base = bool(universe)
                if remaining[e] is not None:
                    universe = [
                        t for t in universe
                        if _fits(
                            {
                                name: instance_types[t].capacity.get(name, 0.0)
                                for name in remaining[e]
                            },
                            remaining[e],
                        )
                    ]
                has_cap = bool(universe)
                fails[ox.FAM_CLAIM_CAPACITY][e] = has_base and not has_cap
                co = [
                    t for t in universe
                    if not instance_types[t].requirements.intersects(narrowed)
                    and _has_offering(instance_types[t], narrowed)
                ]
                has_fit = any(
                    _fits(merged, instance_types[t].allocatable()) for t in co
                )
                fails[ox.FAM_RESOURCES][e] = bool(co) and not has_fit
                fails[ox.FAM_REQUIREMENTS][e] = (
                    not compat or not has_base or (has_cap and not co)
                )
        finally:
            for tg in list(topo.topologies.values()) + list(
                topo.inverse_topologies.values()
            ):
                if tg.key == wk.LABEL_HOSTNAME and tg.domains.get(hostname) == 0:
                    del tg.domains[hostname]
        return ox.encode_family_bits(fails, [True] * len(templates))
