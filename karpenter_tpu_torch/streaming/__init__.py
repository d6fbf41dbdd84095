"""Streaming solve: incremental delta encode and warm-state re-solve under
churn (the JAX package's ``streaming/``).

  delta.py         snapshot digests and diff, and a DeltaEncoder that patches
                   rows of the previous SchedulingProblem instead of a full
                   rebuild, bit-identical to a cold encode or it falls back.
  warm.py          StreamingSolver: reuses the previous placement and
                   re-places only the pods whose gates could have changed.
  residual.py      the residual world the warm re-solve runs against.
  snapshot.py      the crash-consistent journal of the accepted cycle state.
  device_world.py  the encoded world resident on the card across cycles
                   (``TorchSolver(device_world=True)``).
  churn.py         the seeded arrival/delete/reclaim load generator.
"""

from karpenter_tpu_torch.streaming.delta import DeltaEncoder, SnapshotDelta, diff_snapshots
from karpenter_tpu_torch.streaming.warm import StreamingSolver

__all__ = [
    "DeltaEncoder",
    "SnapshotDelta",
    "diff_snapshots",
    "StreamingSolver",
]
