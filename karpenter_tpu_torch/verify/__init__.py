"""Placement verification: the composite gate (gate.py) over the
``gate_counts`` invariant program (device.py), and the row-scoped re-checks
of the streaming warm path and the residual screen (incremental.py)."""

from karpenter_tpu_torch.verify.gate import (  # noqa: F401
    GateContext,
    GateOutcome,
    audit_frac,
    enabled,
    full_gate,
    gate_relaxed,
    make_context,
)
from karpenter_tpu_torch.verify.incremental import (  # noqa: F401
    IncrementalScope,
    ScreenLaneScope,
    incremental_gate,
    screen_lane_gate,
)
