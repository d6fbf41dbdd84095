"""Status conditions (stand-in for knative apis.ConditionManager).

NodeClaims carry Launched/Registered/Initialized living conditions plus
Empty/Drifted/Expired markers (reference pkg/apis/v1beta1/nodeclaim_status.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

TRUE = "True"
FALSE = "False"
UNKNOWN = "Unknown"


@dataclass
class Condition:
    type: str
    status: str = UNKNOWN
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0
    severity: str = ""


@dataclass
class ConditionSet:
    """A living condition set: the aggregate Ready condition is True iff every
    dependent (living) condition is True."""

    living: List[str] = field(default_factory=list)
    conditions: Dict[str, Condition] = field(default_factory=dict)

    def get(self, type_: str) -> Optional[Condition]:
        return self.conditions.get(type_)

    def is_true(self, type_: str) -> bool:
        c = self.conditions.get(type_)
        return c is not None and c.status == TRUE

    def set_true(self, type_: str, reason: str = "", message: str = "", now: float = 0.0):
        self._set(type_, TRUE, reason, message, now)

    def set_false(self, type_: str, reason: str = "", message: str = "", now: float = 0.0):
        self._set(type_, FALSE, reason, message, now)

    def clear(self, type_: str):
        self.conditions.pop(type_, None)

    def _set(self, type_: str, status: str, reason: str, message: str, now: float):
        existing = self.conditions.get(type_)
        if existing and existing.status == status:
            existing.reason, existing.message = reason, message
            return
        self.conditions[type_] = Condition(
            type=type_, status=status, reason=reason, message=message, last_transition_time=now
        )

    def root_is_true(self) -> bool:
        return all(self.is_true(t) for t in self.living) if self.living else True
