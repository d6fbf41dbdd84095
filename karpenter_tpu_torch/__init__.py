"""karpenter_tpu_torch: the provisioning solver on PyTorch, with its device
programs as hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``karpenter_tpu``, which stays the reference it is
tested against; this package imports neither it nor JAX. The main path is
``solver.torch_backend.TorchSolver``: host encode and padding (numpy), the
FFD requeue loop (kernel ``ffd_loop``, csrc/ffd_loop.cu), host decode, and
the invariant gate (kernel ``gate_counts``, csrc/gate_counts.cu) behind
``verify.full_gate``; phase 1 of the default two-phase solve is the kernel
``relax_place``. The consolidation screen, ``disruption.batch.UnionScorer``,
scores every candidate subset of a pass in one launch of the kernel
``runs_screen`` (csrc/runs_screen.cu). ``solver.supervisor.SupervisedSolver``
wraps the solver with deadlines, retries, a circuit breaker, validation and
the pure-Python ``solver.oracle.OracleSolver`` as its fallback;
``serve.SolveService`` serves many tenants' solves through one such stack
each, stacking compatible tenants into one launch of ``runs_screen``'s
stacked mode. Every kernel has a plain PyTorch version beside it, which runs
for CPU tensors.
"""
