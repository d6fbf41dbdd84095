"""Placement explainability: gate attribution, reason taxonomy, report ring.

Counterpart of the JAX package's ``obs/explain.py`` (host-only, copied here
so the port imports nothing of that package). Behind ``KARPENTER_TPU_EXPLAIN``
(default off), the solver runs one extra device pass over the pods the pack
left unscheduled: a re-evaluation of the step's gate families against the
FINAL bin state (exact by construction: the terminal pass commits nothing,
so the final state IS the state every failed pod was last evaluated against;
ops/ffd_step.attribute_pods, the ``attribute`` kernel on the card), and folds
the resulting bitmasks into a stable ``UnschedulableReason`` taxonomy with
counterfactual hints, the vocabulary upstream Karpenter operators already
debug in ("incompatible with nodepool", "no instance type satisfied
resources").

Wire format (one int32 triple per pod, produced by ops/masks.family_bitmask
via ops/ffd_step.attribute_pods, or host-side by the oracle's classifier
through the SAME ``encode_family_bits``/``pack_words`` helpers, so the parity
tests compare decoders' inputs, not two taxonomies):

  word 0  union     candidate-class byte x3: family failed on >= 1 candidate
  word 1  blockers  family failed on EVERY candidate of the class; bit 7 set
                    when the class has zero candidates (EMPTY)
  word 2  near      some candidate failed ONLY this family: the
                    counterfactual "fix this one gate and the pod schedules"

Each word packs three candidate-class bytes: node (bits 0-7), open claim
(8-15), fresh template (16-23). Families are bits 0-6 of each byte.

Off, every integration site costs one ``enabled()`` check. On, placements
are bit-identical: attribution is a separate pass over the already-final
state, never a change to the solve.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_enabled_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force explain on/off (tests, bench); ``None`` restores the env flag."""
    global _enabled_override
    _enabled_override = value


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("KARPENTER_TPU_EXPLAIN", "") not in ("", "0")


def max_pods() -> int:
    """Per-report cap on nomination rationales (KARPENTER_TPU_EXPLAIN_MAX).
    Failure reasons are never capped — they are the point of the feature —
    but per-scheduled-pod rationale on a 10k-pod solve would be pure bloat."""
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_EXPLAIN_MAX", "256")))
    except ValueError:
        return 256


# -- gate families (bit index in each candidate-class byte) -------------------

FAM_RESOURCES = 0
FAM_REQUIREMENTS = 1  # node-affinity / requirements / offering compatibility
FAM_TAINTS = 2
FAM_PORTS = 3
FAM_TOPOLOGY = 4
FAM_CLAIM_CAPACITY = 5  # nodepool limits headroom (templates only)
FAM_VOLUME = 6  # CSI attach limits (existing nodes only)
NUM_FAMILIES = 7
EMPTY_BIT = 7  # in the blockers word: the class had zero candidates

FAMILY_NAMES = (
    "resources",
    "requirements",
    "taints",
    "host-ports",
    "topology",
    "claim-capacity",
    "volume",
)

CLASS_NODE = 0
CLASS_CLAIM = 1
CLASS_TEMPLATE = 2
CLASS_NAMES = ("node", "claim", "template")

# decode kinds: ops/ffd_core KIND_*, kept here so obs imports no solver module
_KIND_NODE, _KIND_CLAIM, _KIND_NEW_CLAIM, _KIND_FAIL, _KIND_NO_SLOT = range(5)
KIND_NAMES = ("node", "claim", "new-claim", "fail", "no-slot")


# -- the UnschedulableReason taxonomy ----------------------------------------
# Stable strings: they are Prometheus label values
# (karpenter_unschedulable_pods_total{reason}) and Event message prefixes, so
# additions are fine but renames are a dashboard break. They equal the JAX
# package's, value for value.

REASON_RESOURCES = "resources"
REASON_REQUIREMENTS = "requirements"
REASON_TAINTS = "taints"
REASON_HOST_PORTS = "host-ports"
REASON_TOPOLOGY = "topology"
REASON_CLAIM_CAPACITY = "claim-capacity"
REASON_VOLUME = "volume"
REASON_NO_CANDIDATES = "no-candidates"
REASON_UNKNOWN = "unknown"

REASONS = (
    REASON_RESOURCES,
    REASON_REQUIREMENTS,
    REASON_TAINTS,
    REASON_HOST_PORTS,
    REASON_TOPOLOGY,
    REASON_CLAIM_CAPACITY,
    REASON_VOLUME,
    REASON_NO_CANDIDATES,
    REASON_UNKNOWN,
)

_FAMILY_REASON = {
    FAM_RESOURCES: REASON_RESOURCES,
    FAM_REQUIREMENTS: REASON_REQUIREMENTS,
    FAM_TAINTS: REASON_TAINTS,
    FAM_PORTS: REASON_HOST_PORTS,
    FAM_TOPOLOGY: REASON_TOPOLOGY,
    FAM_CLAIM_CAPACITY: REASON_CLAIM_CAPACITY,
    FAM_VOLUME: REASON_VOLUME,
}

# tie-break order when several families qualify at the same decode stage:
# hard identity gates first (a taint or affinity mismatch is actionable and
# categorical), capacity-flavored families last (resources is the catch-all
# a bin-packing failure degrades to)
_PRIORITY = (
    FAM_TAINTS,
    FAM_REQUIREMENTS,
    FAM_PORTS,
    FAM_VOLUME,
    FAM_CLAIM_CAPACITY,
    FAM_TOPOLOGY,
    FAM_RESOURCES,
)


# -- host-side encoder (the oracle classifier's half of the parity pair) ------


def encode_family_bits(
    fails: Sequence[Sequence[bool]], cand: Sequence[bool]
) -> Tuple[int, int, int]:
    """(union, blockers, near) byte for one candidate class, from per-family
    per-candidate fail booleans — the pure-Python mirror of
    ops/masks.family_bitmask, byte-for-byte (tests pin the equivalence)."""
    cand = list(cand)
    present = any(cand)
    union = blockers = near = 0
    nfail = [sum(fails[f][e] for f in range(NUM_FAMILIES)) for e in range(len(cand))]
    for f in range(NUM_FAMILIES):
        row = fails[f]
        hit = [c and row[e] for e, c in enumerate(cand)]
        if any(hit):
            union |= 1 << f
        if present and all(row[e] for e, c in enumerate(cand) if c):
            blockers |= 1 << f
        if any(h and nfail[e] == 1 for e, h in enumerate(hit)):
            near |= 1 << f
    if not present:
        blockers |= 1 << EMPTY_BIT
    return union, blockers, near


def pack_words(
    per_class: Sequence[Tuple[int, int, int]]
) -> Tuple[int, int, int]:
    """Fold (union, blockers, near) bytes for [node, claim, template] into
    the three int32 wire words."""
    u = b = n = 0
    for cls, (cu, cb, cn) in enumerate(per_class):
        u |= (cu & 0xFF) << (8 * cls)
        b |= (cb & 0xFF) << (8 * cls)
        n |= (cn & 0xFF) << (8 * cls)
    return u, b, n


def _class_byte(word: int, cls: int) -> int:
    return (int(word) >> (8 * cls)) & 0xFF


def _bit_names(byte: int) -> List[str]:
    return [FAMILY_NAMES[f] for f in range(NUM_FAMILIES) if byte & (1 << f)]


# -- decoder ------------------------------------------------------------------


@dataclass
class PodExplanation:
    """One pod's decoded verdict: the reason, how it was derived (blocking
    family vs near-miss vs dominant union), and the raw per-class bits."""

    pod: int  # caller-facing pod index
    kind: str  # "fail" | "no-slot" (failed pods) — committed kinds in nominations
    reason: str
    hint: str
    derivation: str  # "no-slot" | "no-candidates" | "blocking" | "near-miss" | "dominant"
    classes: Dict[str, Dict[str, List[str]]] = field(default_factory=dict)
    words: Tuple[int, int, int] = (0, 0, 0)

    def to_dict(self) -> Dict:
        return {
            "pod": self.pod,
            "kind": self.kind,
            "reason": self.reason,
            "hint": self.hint,
            "derivation": self.derivation,
            "classes": self.classes,
            "words": list(self.words),
        }


def decode_pod(pod: int, kind_code: int, words: Sequence[int]) -> PodExplanation:
    """Fold one pod's (union, blockers, near) words into a reason.

    Decode ladder (first hit wins; identical for the device path and the
    oracle's host classifier, which is what makes parity a test and not a
    hope):

      1. KIND_NO_SLOT        -> claim-capacity (the slot ring ran out; the
                                backend's escalation retry owns the real answer)
      2. all classes empty   -> no-candidates
      3. a family blocks every non-empty class -> that family (priority order)
      4. a near-miss exists  -> that family (template class preferred: "one
                                gate away from a fresh node" is the actionable
                                counterfactual)
      5. otherwise           -> the union family covering the most classes
                                (priority tie-break); unknown only if the
                                words are all zero (malformed input)
    """
    union_w, blocker_w, near_w = (int(w) for w in words)
    classes: Dict[str, Dict[str, List[str]]] = {}
    non_empty: List[int] = []
    for cls in (CLASS_NODE, CLASS_CLAIM, CLASS_TEMPLATE):
        u, b, n = (
            _class_byte(union_w, cls),
            _class_byte(blocker_w, cls),
            _class_byte(near_w, cls),
        )
        empty = bool(b & (1 << EMPTY_BIT))
        classes[CLASS_NAMES[cls]] = {
            "union": _bit_names(u),
            "blockers": _bit_names(b),
            "near": _bit_names(n),
            **({"empty": True} if empty else {}),
        }
        if not empty:
            non_empty.append(cls)

    kind = KIND_NAMES[kind_code] if 0 <= kind_code < len(KIND_NAMES) else str(kind_code)

    def done(reason: str, derivation: str) -> PodExplanation:
        return PodExplanation(
            pod=pod,
            kind=kind,
            reason=reason,
            hint=_hint(reason, derivation, classes),
            derivation=derivation,
            classes=classes,
            words=(union_w, blocker_w, near_w),
        )

    if kind_code == _KIND_NO_SLOT:
        return done(REASON_CLAIM_CAPACITY, "no-slot")
    if not non_empty:
        return done(REASON_NO_CANDIDATES, "no-candidates")
    for fam in _PRIORITY:
        if all(_class_byte(blocker_w, cls) & (1 << fam) for cls in non_empty):
            return done(_FAMILY_REASON[fam], "blocking")
    for cls in (CLASS_TEMPLATE, CLASS_CLAIM, CLASS_NODE):
        if cls not in non_empty:
            continue
        byte = _class_byte(near_w, cls)
        for fam in _PRIORITY:
            if byte & (1 << fam):
                return done(_FAMILY_REASON[fam], "near-miss")
    best, best_cover = None, 0
    for fam in _PRIORITY:
        cover = sum(
            1 for cls in non_empty if _class_byte(union_w, cls) & (1 << fam)
        )
        if cover > best_cover:
            best, best_cover = fam, cover
    if best is not None:
        return done(_FAMILY_REASON[best], "dominant")
    return done(REASON_UNKNOWN, "dominant")


_HINTS = {
    REASON_TAINTS: "all candidates tainted; no matching toleration",
    REASON_REQUIREMENTS: "node requirements/affinity incompatible with every candidate",
    REASON_HOST_PORTS: "requested host ports already in use on every candidate",
    REASON_VOLUME: "CSI volume attach limits reached on every candidate",
    REASON_TOPOLOGY: "topology skew bound; spread constraint rejects every remaining domain",
    REASON_CLAIM_CAPACITY: "nodepool limits exhausted; no headroom to open a node",
    REASON_RESOURCES: "insufficient capacity on every candidate",
    REASON_NO_CANDIDATES: "no nodes, open claims, or templates to evaluate",
    REASON_UNKNOWN: "no gate attribution recorded",
}


def _hint(reason: str, derivation: str, classes: Dict) -> str:
    if derivation == "no-slot":
        return "all claim slots in use this pass; slot escalation owns the retry"
    base = _HINTS.get(reason, reason)
    if derivation == "near-miss":
        return f"{base} (near miss: one gate away on some candidate)"
    return base


def resource_hint(requests: Dict[str, float], instance_types: Iterable) -> Optional[str]:
    """The upstream-Karpenter counterfactual for a resources verdict: name the
    resource no instance type can satisfy ("fits no instance type by cpu"),
    or None when every single resource fits somewhere (a packing, not a
    sizing, failure)."""
    its = list(instance_types)
    if not its or not requests:
        return None
    short = []
    for res, want in requests.items():
        best = 0.0
        for it in its:
            alloc = getattr(it, "allocatable", None)
            if callable(alloc):  # cloudprovider.types.InstanceType.allocatable()
                alloc = alloc()
            best = max(best, float((alloc or {}).get(res, 0.0)))
        if float(want) > best:
            short.append(res)
    if short:
        return "fits no instance type by " + ", ".join(sorted(short))
    return None


# -- the end-to-end report ----------------------------------------------------


@dataclass
class ExplainReport:
    """Decision provenance of one solve: per-failed-pod reasons plus bounded
    winning-candidate rationale, linked to the cycle trace."""

    backend: str = ""
    trace_id: Optional[str] = None
    total_pods: int = 0
    scheduled: int = 0
    overhead_s: float = 0.0
    pods: Dict[int, PodExplanation] = field(default_factory=dict)
    nominations: Dict[int, Dict] = field(default_factory=dict)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for expl in self.pods.values():
            out[expl.reason] = out.get(expl.reason, 0) + 1
        return out

    def to_dict(self) -> Dict:
        return {
            "backend": self.backend,
            "trace_id": self.trace_id,
            "total_pods": self.total_pods,
            "scheduled": self.scheduled,
            "unschedulable": len(self.pods),
            "overhead_s": round(self.overhead_s, 6),
            "reasons": self.counts(),
            "pods": {str(k): v.to_dict() for k, v in sorted(self.pods.items())},
            "nominations": {str(k): v for k, v in sorted(self.nominations.items())},
        }


class ReportRing:
    """Bounded ring of the last N published reports (as plain dicts), same
    discipline as obs/trace.TraceRing: plain dicts in, lock around the deque,
    most-recent-first snapshots for /debug/explain."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("KARPENTER_TPU_EXPLAIN_RING", "16"))
            except ValueError:
                capacity = 16
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()

    def append(self, report_dict: Dict) -> None:
        with self._lock:
            self._ring.append(report_dict)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(reversed(self._ring))

    def last(self) -> Optional[Dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_ring: Optional[ReportRing] = None
_ring_lock = threading.Lock()


def ring() -> ReportRing:
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = ReportRing()
    return _ring


def reset_ring(capacity: Optional[int] = None) -> ReportRing:
    global _ring
    with _ring_lock:
        _ring = ReportRing(capacity)
    return _ring


def publish(report: ExplainReport) -> None:
    """Ring + metrics sink: every reason increments
    karpenter_unschedulable_pods_total{reason} and the attribution pass's
    wall cost lands in karpenter_solver_explain_overhead_seconds."""
    ring().append(report.to_dict())
    from karpenter_tpu_torch.metrics.registry import EXPLAIN_OVERHEAD, UNSCHEDULABLE_PODS

    for reason, n in report.counts().items():
        UNSCHEDULABLE_PODS.inc({"reason": reason}, n)
    EXPLAIN_OVERHEAD.observe(report.overhead_s)


def summary() -> Dict:
    """Aggregated unschedulable summary over the ring (/statusz section)."""
    reports = ring().snapshot()
    reasons: Dict[str, int] = {}
    unscheduled = 0
    for rep in reports:
        unscheduled += rep.get("unschedulable", 0)
        for reason, n in rep.get("reasons", {}).items():
            reasons[reason] = reasons.get(reason, 0) + n
    return {
        "enabled": enabled(),
        "reports": len(reports),
        "unschedulable": unscheduled,
        "reasons": reasons,
        "last_trace_id": reports[0].get("trace_id") if reports else None,
    }
