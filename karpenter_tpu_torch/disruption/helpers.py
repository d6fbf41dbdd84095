"""The consolidation price rules the screen's verdicts share with the
sequential path (the JAX package's ``disruption/helpers.py`` :194, :214)."""

from __future__ import annotations

from typing import Dict, Sequence


def cheapest_existing_price_by_type(candidates: Sequence) -> Dict[str, float]:
    """Cheapest current offering price per instance-type name among the
    candidates (multinodeconsolidation.go:160-172)."""
    prices: Dict[str, float] = {}
    for c in candidates:
        if c.instance_type is None:
            continue
        of = c.instance_type.offerings.get(c.capacity_type, c.zone)
        if of is None:
            continue
        prev = prices.get(c.instance_type.name)
        if prev is None or of.price < prev:
            prices[c.instance_type.name] = of.price
    return prices


def same_type_price_cap(replacement_names, existing_prices: Dict[str, float]) -> float:
    """The maximum allowed replacement price once a type is shared between
    the replacement options and the deleted nodes (inf when none shared)."""
    return min(
        (existing_prices[n] for n in replacement_names if n in existing_prices),
        default=float("inf"),
    )
