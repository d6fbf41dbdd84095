"""API validation.

Equivalent of reference pkg/apis/v1beta1/{nodepool,nodeclaim}_validation*.go:
the CEL rules embedded in the CRD schema plus the webhook-path
RuntimeValidate. The provisioner calls validate_nodepool before building a
template (provisioner.go:214-228) and skips invalid pools with an event.
"""

from __future__ import annotations

import re
from typing import List, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import (
    CONSOLIDATION_POLICY_WHEN_EMPTY,
    CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED,
    NodePool,
    parse_duration,
)
from karpenter_tpu_torch.apis.objects import (
    DOES_NOT_EXIST,
    EXISTS,
    GT,
    IN,
    LT,
    NO_EXECUTE,
    NO_SCHEDULE,
    NOT_IN,
    NodeSelectorRequirement,
    PREFER_NO_SCHEDULE,
    Taint,
)
from karpenter_tpu_torch.utils import cron as cronutil

SUPPORTED_OPERATORS = {IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT}
SUPPORTED_EFFECTS = {NO_SCHEDULE, PREFER_NO_SCHEDULE, NO_EXECUTE}

# CEL caps stamped in the reference CRD schema
MAX_REQUIREMENTS = 30  # nodeclaim.go:39 MaxItems
MAX_BUDGETS = 50  # nodepool.go:96 MaxItems

_QUALIFIED_NAME = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]{0,61}[A-Za-z0-9])?$")
_LABEL_VALUE = re.compile(r"^([A-Za-z0-9]([A-Za-z0-9._-]{0,61}[A-Za-z0-9])?)?$")
_DNS_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?(\.[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?)*$"
)
# nodepool.go:69,85 — duration strings are unit-suffixed and non-negative, or
# the literal "Never"
_DURATION_PATTERN = re.compile(r"^(([0-9]+(s|m|h))+)$|^Never$")
# nodepool.go:126 — budget windows have minute granularity
_BUDGET_DURATION_PATTERN = re.compile(r"^([0-9]+(m|h)+(0s)?)$")
# nodepool.go:110 — int or 0-100%
_BUDGET_NODES_PATTERN = re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")
# nodepool.go:117 — 5-field cron or @descriptor
_SCHEDULE_PATTERN = re.compile(
    r"^(@(annually|yearly|monthly|weekly|daily|midnight|hourly))$|^(\S+)\s+(\S+)\s+(\S+)\s+(\S+)\s+(\S+)$"
)

# nodeclaim.go:87-105 — kubelet reservation / eviction-signal key universes
RESERVED_RESOURCE_KEYS = {"cpu", "memory", "ephemeral-storage", "pid"}
EVICTION_SIGNALS = {
    "memory.available",
    "nodefs.available",
    "nodefs.inodesFree",
    "imagefs.available",
    "imagefs.inodesFree",
    "pid.available",
}
_QUANTITY = re.compile(r"^[0-9]+(\.[0-9]+)?(Ki|Mi|Gi|Ti|Pi|Ei|m|k|M|G|T|P|E)?$")


def _validate_label_key(key: str) -> Optional[str]:
    if key.count("/") > 1:
        return f"invalid label key {key!r}"
    if "/" in key:
        prefix, name = key.split("/", 1)
        if not prefix or len(prefix) > 253 or not _DNS_SUBDOMAIN.match(prefix):
            return f"invalid label key prefix {key!r}"
    else:
        name = key
    if not name or not _QUALIFIED_NAME.match(name):
        return f"invalid label key {key!r}"
    return None


def _validate_signal_value(value: str) -> bool:
    """Eviction-signal values are percentages (0-100%) or resource
    quantities (kubelet validation, nodeclaim_validation.go)."""
    s = str(value)
    if s.endswith("%"):
        try:
            pct = float(s[:-1])
        except ValueError:
            return False
        return 0 <= pct <= 100
    return bool(_QUANTITY.match(s))


def validate_kubelet_configuration(kc) -> List[str]:
    """KubeletConfiguration CEL rules (nodeclaim.go:48-126)."""
    errs: List[str] = []
    if kc is None:
        return errs
    for field_name, reserved in (
        ("systemReserved", kc.system_reserved),
        ("kubeReserved", kc.kube_reserved),
    ):
        for key, value in reserved.items():
            if key not in RESERVED_RESOURCE_KEYS:
                errs.append(
                    f"{field_name}: invalid key {key!r} (valid: cpu, memory, "
                    "ephemeral-storage, pid)"
                )
            if isinstance(value, (int, float)) and value < 0:
                errs.append(f"{field_name} {key}: cannot be negative")
            elif isinstance(value, str) and value.startswith("-"):
                errs.append(f"{field_name} {key}: cannot be negative")
    for field_name, signals in (
        ("evictionHard", kc.eviction_hard),
        ("evictionSoft", kc.eviction_soft),
        ("evictionSoftGracePeriod", kc.eviction_soft_grace_period),
    ):
        for key in signals:
            if key not in EVICTION_SIGNALS:
                errs.append(f"{field_name}: invalid signal {key!r}")
    for key, value in kc.eviction_hard.items():
        if key in EVICTION_SIGNALS and not _validate_signal_value(value):
            errs.append(f"evictionHard {key}: invalid value {value!r}")
    for key, value in kc.eviction_soft.items():
        if key in EVICTION_SIGNALS and not _validate_signal_value(value):
            errs.append(f"evictionSoft {key}: invalid value {value!r}")
    for key in kc.eviction_soft:
        if key not in kc.eviction_soft_grace_period:
            errs.append(f"evictionSoft {key}: no matching evictionSoftGracePeriod")
    for key in kc.eviction_soft_grace_period:
        if key not in kc.eviction_soft:
            errs.append(f"evictionSoftGracePeriod {key}: no matching evictionSoft")
    hi, lo = kc.image_gc_high_threshold_percent, kc.image_gc_low_threshold_percent
    for name, pct in (("imageGCHighThresholdPercent", hi), ("imageGCLowThresholdPercent", lo)):
        if pct is not None and not (0 <= pct <= 100):
            errs.append(f"{name}: must be between 0 and 100")
    if hi is not None and lo is not None and hi <= lo:
        errs.append(
            "imageGCHighThresholdPercent must be greater than imageGCLowThresholdPercent"
        )
    for name, value in (("maxPods", kc.max_pods), ("podsPerCore", kc.pods_per_core)):
        if value is not None and value < 0:
            errs.append(f"{name}: must be non-negative")
    return errs


def _validate_duration_string(value, field_name: str) -> List[str]:
    """Durations on the API surface are pattern-validated strings
    (nodepool.go:69,85): unit-suffixed, non-negative, or 'Never'. Plain
    numbers (internal callers) bypass the pattern but not the sign check."""
    if value is None:
        return []
    if isinstance(value, (int, float)):
        return [f"{field_name}: must be non-negative"] if value < 0 else []
    if not _DURATION_PATTERN.match(str(value).strip()):
        return [f"{field_name}: invalid duration {value!r}"]
    return []


def validate_requirement(req: NodeSelectorRequirement) -> List[str]:
    """One requirement's rules (nodepool_validation.go requirement checks)."""
    errs = []
    key_err = _validate_label_key(req.key)
    if key_err:
        errs.append(key_err)
    restricted = wk.is_restricted_label(req.key)
    if restricted:
        errs.append(f"{req.key}: {restricted}")
    if req.operator not in SUPPORTED_OPERATORS:
        errs.append(f"{req.key}: unsupported operator {req.operator!r}")
        return errs
    if req.operator == IN and not req.values:
        errs.append(f"{req.key}: In requires at least one value")
    if req.operator in (EXISTS, DOES_NOT_EXIST) and req.values:
        errs.append(f"{req.key}: {req.operator} must not have values")
    if req.operator in (GT, LT):
        # single non-negative integer (nodeclaim.go:38 CEL: int(values[0]) >= 0)
        if len(req.values) != 1:
            errs.append(f"{req.key}: {req.operator} requires exactly one value")
        elif not str(req.values[0]).isdigit():
            errs.append(
                f"{req.key}: {req.operator} value must be a single non-negative integer"
            )
    for v in req.values:
        if not _LABEL_VALUE.match(str(v)):
            errs.append(f"{req.key}: invalid value {v!r}")
    return errs


def validate_taint(taint: Taint) -> List[str]:
    errs = []
    key_err = _validate_label_key(taint.key)
    if key_err:
        errs.append(f"taint {key_err}")
    if taint.effect not in SUPPORTED_EFFECTS:
        errs.append(f"taint {taint.key}: unsupported effect {taint.effect!r}")
    if taint.value and not _LABEL_VALUE.match(taint.value):
        errs.append(f"taint {taint.key}: invalid value {taint.value!r}")
    return errs


def validate_nodepool(np_obj: NodePool) -> List[str]:
    """RuntimeValidate (nodepool_validation.go) + the CRD's CEL rule matrix
    (nodepool.go markers, asserted by nodepool_validation_cel_test.go);
    empty list means valid."""
    errs: List[str] = []
    tpl = np_obj.spec.template
    if len(tpl.spec.requirements) > MAX_REQUIREMENTS:
        errs.append(f"requirements: must have at most {MAX_REQUIREMENTS} items")
    for req in tpl.spec.requirements:
        # the ownership label is stamped by the controller; users may not
        # pin it (nodepool_validation.go excludes NodePoolLabelKey from the
        # well-known allowance; cel_test.go:574-580)
        if req.key == wk.NODEPOOL_LABEL_KEY:
            errs.append(f"{req.key}: restricted (stamped by the controller)")
            continue
        errs.extend(validate_requirement(req))
    seen = set()
    for req in tpl.spec.requirements:
        if (req.key, req.operator) in seen:
            errs.append(f"{req.key}: duplicate requirement with operator {req.operator}")
        seen.add((req.key, req.operator))
    for taint in list(tpl.spec.taints) + list(tpl.spec.startup_taints):
        errs.extend(validate_taint(taint))
    for key, value in tpl.labels.items():
        if key == wk.NODEPOOL_LABEL_KEY:
            errs.append(f"label {key}: restricted (stamped by the controller)")
            continue
        restricted = wk.is_restricted_label(key)
        if restricted:
            errs.append(f"label {key}: {restricted}")
        key_err = _validate_label_key(key)
        if key_err:
            errs.append(key_err)
        if not _LABEL_VALUE.match(str(value)):
            errs.append(f"label {key}: invalid value {value!r}")
    errs.extend(validate_kubelet_configuration(tpl.spec.kubelet))

    d = np_obj.spec.disruption
    if d.consolidation_policy not in (
        CONSOLIDATION_POLICY_WHEN_EMPTY, CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
    ):
        errs.append(f"unsupported consolidationPolicy {d.consolidation_policy!r}")
    if d.consolidate_after is not None:
        errs.extend(_validate_duration_string(d.consolidate_after, "consolidateAfter"))
        # consolidateAfter is WhenEmpty-only unless disabled (nodepool.go:48)
        if (
            d.consolidation_policy == CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
            and str(d.consolidate_after) != "Never"
        ):
            errs.append("consolidateAfter is only allowed with policy WhenEmpty")
    elif d.consolidation_policy == CONSOLIDATION_POLICY_WHEN_EMPTY:
        errs.append("consolidateAfter is required with policy WhenEmpty")
    errs.extend(_validate_duration_string(d.expire_after, "expireAfter"))
    if len(d.budgets) > MAX_BUDGETS:
        errs.append(f"budgets: must have at most {MAX_BUDGETS} items")
    for budget in d.budgets:
        if not _BUDGET_NODES_PATTERN.match(str(budget.nodes).strip()):
            errs.append(
                f"budget nodes {budget.nodes!r}: must be a non-negative int or 0-100%"
            )
        if (budget.schedule is None) != (budget.duration is None):
            errs.append("budget schedule and duration must be set together")
        if budget.schedule is not None:
            if not _SCHEDULE_PATTERN.match(str(budget.schedule).strip()):
                errs.append(
                    f"budget schedule {budget.schedule!r}: must be a 5-field cron "
                    "or @descriptor"
                )
            else:
                try:
                    cronutil.parse(budget.schedule)
                except ValueError as e:
                    errs.append(f"budget schedule: {e}")
        if budget.duration is not None:
            # minute granularity, no bare seconds, non-negative
            # (nodepool.go:126 pattern) — plus parseability: in the
            # reference, metav1.Duration JSON decoding rejects strings like
            # "20mh" before CEL ever runs, so the effective rule is
            # pattern AND parseable
            if not _BUDGET_DURATION_PATTERN.match(str(budget.duration).strip()):
                errs.append(f"budget duration {budget.duration!r}: invalid window")
            else:
                try:
                    parse_duration(budget.duration)
                except ValueError as e:
                    errs.append(f"budget duration: {e}")

    for name, value in np_obj.spec.limits.items():
        if value < 0:
            errs.append(f"limit {name}: must be non-negative")
    if np_obj.spec.weight is not None and not (1 <= np_obj.spec.weight <= 100):
        errs.append("weight must be between 1 and 100")
    return errs


def validate_nodeclaim(claim: NodeClaim) -> List[str]:
    """RuntimeValidate (nodeclaim_validation.go) + CRD CEL rules."""
    errs: List[str] = []
    if len(claim.spec.requirements) > MAX_REQUIREMENTS:
        errs.append(f"requirements: must have at most {MAX_REQUIREMENTS} items")
    for req in claim.spec.requirements:
        # the nodepool ownership label is stamped by the provisioner itself
        # and is legal on claims (launched claims always carry it)
        if req.key == wk.NODEPOOL_LABEL_KEY:
            continue
        errs.extend(validate_requirement(req))
    for taint in list(claim.spec.taints) + list(claim.spec.startup_taints):
        errs.extend(validate_taint(taint))
    errs.extend(validate_kubelet_configuration(claim.spec.kubelet))
    for name, value in claim.spec.resource_requests.items():
        if value < 0:
            errs.append(f"resource request {name}: must be non-negative")
    return errs
