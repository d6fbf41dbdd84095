"""The solver: the host encode (encode.py), the backend contract
(backend.py), ``TorchSolver`` (torch_backend.py), the supervisor and its
``OracleSolver`` fallback. Re-exports the JAX package's
``karpenter_tpu.solver`` names."""

from karpenter_tpu_torch.solver.encode import EncodedProblem, Encoder  # noqa: F401
from karpenter_tpu_torch.solver.backend import Placement, SolveResult, SolverBackend  # noqa: F401
