"""Minimal standard-cron parser for disruption budget schedules.

The reference uses robfig/cron's ParseStandard (5-field cron plus @descriptors)
to decide when a disruption Budget is active (nodepool.go:265-277). We carry a
small self-contained equivalent: parse + "next fire time after t".
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import FrozenSet

_DESCRIPTORS = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}

# literal name maps — locale-independent (calendar.month_abbr localizes)
_MONTH_NAMES = {
    "jan": 1, "feb": 2, "mar": 3, "apr": 4, "may": 5, "jun": 6,
    "jul": 7, "aug": 8, "sep": 9, "oct": 10, "nov": 11, "dec": 12,
}
# cron day-of-week: 0=Sunday; python weekday(): 0=Monday
_DAY_NAMES = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6}


class CronParseError(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int, names=None) -> FrozenSet[int]:
    out = set()
    for part in field.split(","):
        has_step = "/" in part
        step = 1
        if has_step:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError as e:
                raise CronParseError(f"bad step {step_s!r}") from e
            if step <= 0:
                raise CronParseError(f"bad step {step}")
        if part in ("*", "?", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = _parse_value(a, names), _parse_value(b, names)
        else:
            start = _parse_value(part, names)
            # robfig semantics: "N/step" expands N..max, plain "N" is just N
            end = hi if has_step else start
        if start < lo or end > hi or start > end:
            raise CronParseError(f"field value out of range [{lo},{hi}]: {field!r}")
        out.update(range(start, end + 1, step))
    return frozenset(out)


def _parse_value(s: str, names) -> int:
    s = s.strip().lower()
    if names and s in names:
        return names[s]
    try:
        return int(s)
    except ValueError as e:
        raise CronParseError(f"bad value {s!r}") from e


@dataclass(frozen=True)
class Schedule:
    minutes: FrozenSet[int]
    hours: FrozenSet[int]
    days_of_month: FrozenSet[int]
    months: FrozenSet[int]
    days_of_week: FrozenSet[int]
    dom_star: bool
    dow_star: bool

    def _day_matches(self, t: _dt.datetime) -> bool:
        dom_ok = t.day in self.days_of_month
        cron_dow = (t.weekday() + 1) % 7  # python Mon=0 -> cron Sun=0
        dow_ok = cron_dow in self.days_of_week
        # standard cron rule: if both dom and dow are restricted, match either
        if not self.dom_star and not self.dow_star:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def next_after(self, t: _dt.datetime) -> _dt.datetime:
        """First fire time strictly after ``t`` (robfig cron Next semantics)."""
        t = t.replace(second=0, microsecond=0) + _dt.timedelta(minutes=1)
        # bounded search: four years covers any 5-field schedule with a match
        limit = t + _dt.timedelta(days=4 * 366)
        while t < limit:
            if t.month not in self.months:
                # jump to the first day of the next month
                year, month = t.year, t.month + 1
                if month > 12:
                    year, month = year + 1, 1
                t = t.replace(year=year, month=month, day=1, hour=0, minute=0)
                continue
            if not self._day_matches(t):
                t = (t + _dt.timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if t.hour not in self.hours:
                t = (t + _dt.timedelta(hours=1)).replace(minute=0)
                continue
            if t.minute not in self.minutes:
                t = t + _dt.timedelta(minutes=1)
                continue
            return t
        raise CronParseError("schedule never fires")


def parse(expr: str) -> Schedule:
    """Parse a 5-field cron expression or @descriptor."""
    expr = expr.strip()
    if expr.startswith("@"):
        if expr not in _DESCRIPTORS:
            raise CronParseError(f"unknown descriptor {expr!r}")
        expr = _DESCRIPTORS[expr]
    fields = expr.split()
    if len(fields) != 5:
        raise CronParseError(f"expected 5 fields, got {len(fields)}: {expr!r}")
    return Schedule(
        minutes=_parse_field(fields[0], 0, 59),
        hours=_parse_field(fields[1], 0, 23),
        days_of_month=_parse_field(fields[2], 1, 31),
        months=_parse_field(fields[3], 1, 12, _MONTH_NAMES),
        days_of_week=_parse_field(fields[4], 0, 6, _DAY_NAMES),
        dom_star=fields[2] in ("*", "?"),
        dow_star=fields[4] in ("*", "?"),
    )
