"""Scheduling-failure forensics — why a pod could not be placed.

The reference deliberately does NOT short-circuit instance-type filtering so
it can tell the operator which criteria eliminated every instance type:
filterInstanceTypesByRequirements tracks per-criterion and pairwise results
(nodeclaim.go:225-260) and FailureReason() renders them (nodeclaim.go:161-221);
the scheduler wraps each template's failure with the nodepool name and
daemonset overhead (scheduler.go:268-283) and the event carries the message
(scheduling/events.go:52-56).

The tensor solver reduces a failed pod to one flag; these helpers reconstruct
the reference's forensics HOST-SIDE at decode time — failed pods are rare, so
a straight-line Python pass over the (price-capped) instance-type lists costs
microseconds and keeps the device program lean. Both backends call the same
function, so the rendered reasons are backend-independent.

The quarantine ring (``dump_quarantine`` / ``load_quarantine`` /
``scan_quarantine``) keeps the results the solver supervisor's validator
rejected as JSON files for offline diagnosis: atomic writes, a bounded ring
evicted oldest first, and a per-tenant namespace with its own cap, as the
JAX package keeps them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.scheduling import Requirements, pod_requirements
from karpenter_tpu_torch.solver.encode import TemplateInfo
from karpenter_tpu_torch.utils import resources as res


@dataclass
class FilterResults:
    """filterInstanceTypesByRequirements' accumulator (nodeclaim.go:225-260):
    which single criteria and which pairs some instance type satisfied."""

    requirements_met: bool = False
    fits: bool = False
    has_offering: bool = False
    requirements_and_fits: bool = False
    requirements_and_offering: bool = False
    fits_and_offering: bool = False
    remaining: List[int] = field(default_factory=list)
    requests: Dict[str, float] = field(default_factory=dict)

    def failure_reason(self) -> str:
        """FailureReason (nodeclaim.go:161-221), string-for-string."""
        if self.remaining:
            return ""
        r, f, o = self.requirements_met, self.fits, self.has_offering
        if not r and not f and not o:
            return (
                "no instance type met the scheduling requirements or had "
                "enough resources or had a required offering"
            )
        if not r and not f:
            return "no instance type met the scheduling requirements or had enough resources"
        if not r and not o:
            return "no instance type met the scheduling requirements or had a required offering"
        if not f and not o:
            return "no instance type had enough resources or had a required offering"
        if not r:
            return "no instance type met all requirements"
        if not f:
            msg = "no instance type has enough resources"
            # the reference's special case for a user typo (m vs M)
            if self.requests.get(res.CPU, 0.0) >= 1_000_000:
                msg += " (CPU request >= 1 Million, m vs M typo?)"
            return msg
        if not o:
            return "no instance type has the required offering"
        if self.requirements_and_fits:
            return (
                "no instance type which met the scheduling requirements and "
                "had enough resources, had a required offering"
            )
        if self.fits_and_offering:
            return (
                "no instance type which had enough resources and the required "
                "offering met the scheduling requirements"
            )
        if self.requirements_and_offering:
            return (
                "no instance type which met the scheduling requirements and "
                "the required offering had the required resources"
            )
        return "no instance type met the requirements/resources/offering tuple"


def _it_fits(it: InstanceType, requests: Dict[str, float]) -> bool:
    alloc = it.allocatable()
    for name, q in requests.items():
        avail = alloc.get(name, 0.0)
        if q > avail + 1e-6 + 1e-6 * abs(avail):
            return False
    return True


def filter_instance_types(
    instance_types: Sequence[InstanceType],
    indices: Sequence[int],
    reqs: Requirements,
    requests: Dict[str, float],
) -> FilterResults:
    """The non-short-circuiting filter (nodeclaim.go:225-260) over a
    template's instance-type universe."""
    results = FilterResults(requests=dict(requests))
    for ti in indices:
        it = instance_types[ti]
        it_compat = not it.requirements.intersects(reqs)  # empty = intersects
        it_fits = _it_fits(it, requests)
        it_offer = len(it.offerings.available().requirements(reqs)) > 0
        results.requirements_met = results.requirements_met or it_compat
        results.fits = results.fits or it_fits
        results.has_offering = results.has_offering or it_offer
        results.requirements_and_fits = results.requirements_and_fits or (
            it_compat and it_fits and not it_offer
        )
        results.requirements_and_offering = results.requirements_and_offering or (
            it_compat and it_offer and not it_fits
        )
        results.fits_and_offering = results.fits_and_offering or (
            it_fits and it_offer and not it_compat
        )
        if it_compat and it_fits and it_offer:
            results.remaining.append(ti)
    return results


def failure_reason(
    pod: Pod,
    instance_types: Sequence[InstanceType],
    templates: Sequence[TemplateInfo],
    pod_reqs: Optional[Requirements] = None,
    well_known=None,
) -> str:
    """Render the reference's per-template failure forensics for one
    unschedulable pod (scheduler.go:268-283 error chain + FailureReason).
    The device solver already decided the pod fails; this explains why."""
    from karpenter_tpu_torch.apis import labels as wk

    if well_known is None:
        well_known = wk.WELL_KNOWN_LABELS
    reqs = pod_reqs if pod_reqs is not None else pod_requirements(pod)
    requests = {**res.pod_requests(pod), res.PODS: 1.0}
    parts: List[str] = []
    for tpl in templates:
        # NodeClaim.Add's gate order (nodeclaim.go:65-119)
        untolerated = tpl.taints.tolerates(pod)  # error strings, empty = ok
        if untolerated:
            parts.append(
                f'incompatible with nodepool "{tpl.nodepool_name}", '
                f"{'; '.join(untolerated)}"
            )
            continue
        if not tpl.requirements.is_compatible(reqs, well_known):
            errs = tpl.requirements.compatible(reqs, well_known)
            parts.append(
                f'incompatible with nodepool "{tpl.nodepool_name}", '
                f"incompatible requirements, {'; '.join(errs)}"
            )
            continue
        merged = tpl.requirements.copy()
        merged.add(*reqs.values())
        overhead = dict(tpl.daemon_overhead)
        total = dict(requests)
        for k, v in overhead.items():
            total[k] = total.get(k, 0.0) + v
        fr = filter_instance_types(
            instance_types, tpl.instance_type_indices, merged, total
        )
        reason = fr.failure_reason()
        if not reason:
            # every per-IT criterion passes on this template, so the solver's
            # verdict came from the stateful gates the replayed filter cannot
            # see (topology counters, limits headroom, port/volume usage)
            reason = (
                "did not fit topology/limit constraints against current state"
            )
        parts.append(
            f'incompatible with nodepool "{tpl.nodepool_name}", '
            f"daemonset overhead={_fmt_resources(overhead)}, {reason}"
        )
    if not parts:
        return "no nodepools available"
    return "; ".join(parts)


# -- the quarantine ring: rejected results, dumped for offline diagnosis ------

def quarantine_dir() -> str:
    """``KARPENTER_TPU_QUARANTINE_DIR``, else ``karpenter-tpu-quarantine``
    under the temporary directory."""
    import os
    import tempfile

    return os.environ.get(
        "KARPENTER_TPU_QUARANTINE_DIR",
        os.path.join(tempfile.gettempdir(), "karpenter-tpu-quarantine"),
    )


_quarantine_seq = 0


def _quarantine_max() -> int:
    """Ring size for on-disk quarantine dumps (KARPENTER_TPU_QUARANTINE_MAX,
    default 32): a crash-looping validator must not fill the disk."""
    import os

    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_QUARANTINE_MAX", "32")))
    except ValueError:
        return 32


def _tenant_quarantine_max() -> int:
    """Per-tenant ring size (KARPENTER_TPU_QUARANTINE_TENANT_MAX, default 8).
    Tenant dumps live in their own ``tenant-<id>/`` namespace with their own
    cap, so one noisy tenant can only ever evict its OWN forensics — the
    global ring used to be oldest-first across all dumps, which let a
    crash-looping tenant erase every other tenant's evidence."""
    import os

    try:
        return max(
            1, int(os.environ.get("KARPENTER_TPU_QUARANTINE_TENANT_MAX", "8"))
        )
    except ValueError:
        return 8


def _tenant_dirname(tenant: str) -> str:
    """Filesystem-safe namespace directory for a tenant's quarantine ring."""
    import re

    return "tenant-" + re.sub(r"[^A-Za-z0-9._-]", "-", tenant)


def _evict_quarantine(directory: str, keep: int) -> None:
    """Oldest-first eviction down to ``keep`` files. The timestamp-pid-seq
    filename sorts lexicographically wrong across epochs of different digit
    counts, so order on mtime (ties broken by name for determinism)."""
    import os

    try:
        entries = [
            (os.path.getmtime(os.path.join(directory, name)), name)
            for name in os.listdir(directory)
            if name.startswith("quarantine-") and name.endswith(".json")
        ]
    except OSError:
        return
    entries.sort()
    for _, name in entries[: max(0, len(entries) - keep)]:
        try:
            os.remove(os.path.join(directory, name))
        except OSError:
            pass


def dump_quarantine(
    result,
    violations: Sequence,
    backend: str = "",
    directory: Optional[str] = None,
    parent_trace_id: Optional[str] = None,
    tenant: Optional[str] = None,
) -> Optional[str]:
    """Write a rejected SolveResult to a forensics JSON file so a bad
    placement can be diagnosed offline after the supervisor failed over.
    Directory: ``quarantine_dir()``, bounded to the newest
    ``KARPENTER_TPU_QUARANTINE_MAX`` dumps (oldest evicted first). With a
    ``tenant``, the dump lands in that tenant's ``tenant-<id>/`` namespace
    with its own ``KARPENTER_TPU_QUARANTINE_TENANT_MAX`` ring — eviction
    never crosses tenant boundaries. Best-effort — quarantine must never be
    the thing that breaks the failover path — returns the path or None."""
    import json
    import os
    import time

    global _quarantine_seq
    directory = directory or quarantine_dir()
    keep = _quarantine_max()
    if tenant:
        directory = os.path.join(directory, _tenant_dirname(tenant))
        keep = _tenant_quarantine_max()
    try:
        os.makedirs(directory, exist_ok=True)
        _quarantine_seq += 1
        path = os.path.join(
            directory,
            f"quarantine-{int(time.time())}-{os.getpid()}-{_quarantine_seq}.json",
        )
        from karpenter_tpu_torch.obs import trace

        payload = {
            "backend": backend,
            "tenant": tenant,
            # the solve cycle that produced this rejected result — grep the
            # id across /debug/traces and logs to reconstruct the timeline
            "trace_id": trace.current_trace_id(),
            # the previous cycle in the same stream (SupervisedSolver threads
            # it forward), so a churn lineage reconstructs end to end
            "parent_trace_id": parent_trace_id,
            "violations": [str(v) for v in violations],
            "new_claims": [
                {
                    "template_index": c.template_index,
                    "nodepool_name": c.nodepool_name,
                    "pod_indices": list(c.pod_indices),
                    "instance_type_indices": list(c.instance_type_indices),
                    "requests": dict(c.requests),
                    "requirements": str(c.requirements),
                }
                for c in result.new_claims
            ],
            "node_pods": {k: list(v) for k, v in result.node_pods.items()},
            "failures": {str(k): v for k, v in result.failures.items()},
        }
        explain = getattr(result, "explain", None)
        if explain is not None:
            # decision provenance travels with the quarantined result: the
            # offline diagnosis starts from the per-pod gate attribution
            payload["explain"] = (
                explain.to_dict() if hasattr(explain, "to_dict") else explain
            )
        # atomic tmp+rename: a crash (or SIGKILL) mid-dump must leave either
        # no file or a complete one — a torn half-JSON used to poison every
        # later loader pass over the ring
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _evict_quarantine(directory, keep)
        return path
    except Exception:
        return None


def load_quarantine(
    directory: Optional[str] = None, limit: int = 0,
    tenant: Optional[str] = None,
) -> List[Dict]:
    """Load the quarantine ring, newest first, each payload annotated with
    its ``_path``. Walks the shared ring AND every tenant namespace (or just
    one tenant's with ``tenant=``). Tolerant by design: unparseable or
    unreadable files — pre-fix torn dumps, bit rot, concurrent eviction —
    are SKIPPED, never raised; offline forensics must degrade to the dumps
    that survived. Use :func:`scan_quarantine` to also see which paths were
    skipped."""
    return scan_quarantine(directory, limit, tenant)[0]


def scan_quarantine(
    directory: Optional[str] = None, limit: int = 0,
    tenant: Optional[str] = None,
) -> Tuple[List[Dict], List[str]]:
    """Like :func:`load_quarantine` but also returns the paths that failed
    to parse (so tooling can report how much of the ring was torn)."""
    import json
    import os

    directory = directory or quarantine_dir()
    roots = [directory]
    if tenant:
        roots = [os.path.join(directory, _tenant_dirname(tenant))]
    else:
        try:
            roots += sorted(
                os.path.join(directory, name)
                for name in os.listdir(directory)
                if name.startswith("tenant-")
                and os.path.isdir(os.path.join(directory, name))
            )
        except OSError:
            pass
    entries: List[Tuple[float, str]] = []
    for root in roots:
        try:
            entries += [
                (os.path.getmtime(os.path.join(root, name)),
                 os.path.join(root, name))
                for name in os.listdir(root)
                if name.startswith("quarantine-") and name.endswith(".json")
            ]
        except OSError:
            continue
    entries.sort(reverse=True)  # newest first
    loaded: List[Dict] = []
    skipped: List[str] = []
    for _, path in entries:
        if limit and len(loaded) >= limit:
            break
        try:
            with open(path) as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                raise ValueError("quarantine payload is not an object")
        except (OSError, ValueError):
            skipped.append(path)
            continue
        payload["_path"] = path
        loaded.append(payload)
    return loaded, skipped


def _fmt_resources(requests: Dict[str, float]) -> str:
    if not requests:
        return "{}"
    inner = ",".join(f'"{k}":"{_fmt_qty(k, v)}"' for k, v in sorted(requests.items()))
    return "{" + inner + "}"


def _fmt_qty(name: str, v: float) -> str:
    if name == res.MEMORY or name == res.EPHEMERAL_STORAGE:
        if v >= 1024**3 and v % 1024**3 == 0:
            return f"{int(v // 1024**3)}Gi"
        if v >= 1024**2 and v % 1024**2 == 0:
            return f"{int(v // 1024**2)}Mi"
    if v == int(v):
        return str(int(v))
    return f"{v:g}"
