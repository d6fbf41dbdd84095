"""The device programs' plain versions and kernel wrappers. Re-exports the
JAX package's ``karpenter_tpu.ops`` names; the JAX package's ``ops/ffd.py``
import facade has no module of its own here (each name lives in its
``ffd_*`` module, as in the JAX package)."""

from karpenter_tpu_torch.ops import masks  # noqa: F401
from karpenter_tpu_torch.ops.ffd_core import FFDResult  # noqa: F401
from karpenter_tpu_torch.ops.ffd_step import solve_ffd  # noqa: F401
