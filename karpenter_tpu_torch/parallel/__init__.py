"""The stacked and partitioned dispatches (mesh.py). Re-exports the JAX
package's ``karpenter_tpu.parallel`` names that have a counterpart: the
port runs a stacked or partitioned batch as lanes of one launch on one
card, so there is no device mesh to make (``make_mesh``) and no batch to
shard over one (``shard_batch``)."""

from karpenter_tpu_torch.parallel.mesh import batched_solve, stack_problems  # noqa: F401
