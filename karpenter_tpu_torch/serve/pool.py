"""Shared per-shape program pools: the co-batch rider index at fleet scale.

Counterpart of the JAX package's ``serve/pool.py``.

The dispatcher used to find co-batch riders by sweeping the WHOLE tenant
rotation on every dispatch — O(registered) work that thrashes at 1,000
tenants (990 idle streams scanned per decision for nothing). This pool keeps
a process-cheap index from shape FAMILY to the ready tenants whose head
request could ride a stacked dispatch of that family, maintained
incrementally at enqueue/pop time. Gathering riders is then O(family), and a
family is by construction a subset of the backlogged streams.

The family key is a coarse host-side predictor of padded-program shape
(pod-axis bucket, claim-slot bucket, catalog sizes — the axes
ops/padding.py buckets by). It deliberately over-groups: serve/batch.py
stacked_solve still computes the EXACT padded shape key per lane and stands
mismatched lanes down to solo, so a false family hit costs one wasted
candidate scan, never a wrong stack. Tenant-private state is untouched —
the pool indexes requests, it never shares solver state across tenants
(the isolation contract).

Guarded by the service lock (the dispatcher and submitters already hold it
at every call site); no locking of its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

from karpenter_tpu_torch.ops.padding import claim_axis_bucket, pod_axis_bucket


def shape_family(request) -> Tuple:
    """Coarse padded-shape family of a request: requests in different
    families can never stack, requests in the same family usually can."""
    n = max(1, len(request.pods))
    return (
        pod_axis_bucket(n),
        claim_axis_bucket(n),
        len(request.instance_types),
        len(request.templates),
    )


class ProgramPool:
    """Index: shape family -> insertion-ordered set of tenant ids whose HEAD
    request is a co-batch candidate of that family."""

    def __init__(self):
        # dict-as-ordered-set: candidates() preserves note order, giving the
        # same first-come rider priority the old rotation sweep had
        self._families: Dict[Tuple, Dict[str, None]] = {}
        self._key_of: Dict[str, Tuple] = {}
        self.noted = 0
        self.cleared = 0

    def note_head(self, tenant_id: str, request, eligible: bool) -> None:
        """(Re)index a tenant's head request. ``eligible`` is the caller's
        batchable() verdict at note time; ineligible heads are only
        de-indexed (solver state can change by dispatch time either way —
        the gather re-verifies batchable before stacking)."""
        self.clear(tenant_id)
        if not eligible:
            return
        key = shape_family(request)
        self._families.setdefault(key, {})[tenant_id] = None
        self._key_of[tenant_id] = key
        self.noted += 1

    def clear(self, tenant_id: str) -> None:
        key = self._key_of.pop(tenant_id, None)
        if key is None:
            return
        family = self._families.get(key)
        if family is not None:
            family.pop(tenant_id, None)
            if not family:
                del self._families[key]
        self.cleared += 1

    def candidates(self, key: Tuple) -> Tuple[str, ...]:
        """Tenant ids whose head request sits in this family, note order."""
        family = self._families.get(key)
        return tuple(family) if family else ()

    def families(self) -> int:
        return len(self._families)

    def indexed(self) -> int:
        return len(self._key_of)

    def snapshot(self) -> Dict:
        return {
            "families": self.families(),
            "indexed": self.indexed(),
            "noted": self.noted,
            "cleared": self.cleared,
        }
