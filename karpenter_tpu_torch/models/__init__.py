"""The padded problem tensors (problem.py). Re-exports the JAX package's
``karpenter_tpu.models`` names."""

from karpenter_tpu_torch.models.problem import (  # noqa: F401
    GT_NONE,
    LT_NONE,
    ReqTensor,
    SchedulingProblem,
)
