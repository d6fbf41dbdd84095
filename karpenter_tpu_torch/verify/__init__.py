"""Placement verification: the composite gate (gate.py) over the
``gate_counts`` invariant program (device.py)."""

from karpenter_tpu_torch.verify.gate import (  # noqa: F401
    GateContext,
    GateOutcome,
    full_gate,
    gate_relaxed,
    make_context,
)
