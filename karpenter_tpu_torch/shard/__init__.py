"""Partitioned solve (``KARPENTER_TPU_SHARD``), the JAX package's
``shard/`` on one card.

Fleet-scale batches (100k+ pods) do not fit one FFD loop well: the pod axis
is the loop's sequential depth, so one launch's time grows with the batch
however wide the card is. This package splits a scheduling batch into
provably independent sub-problems (shard/partition.py, the JAX package's
union-find over constraint-signature classes), encodes each partition
against ONE frozen vocabulary, pads them to a common bucket, and runs all of
them as one launch of a lane grid (parallel/mesh.shard_sweeps: the
``ffd_loop`` kernel with one cluster per partition, each running its own
requeue loop to its own convergence), then merges the per-partition claim
landscapes back into one SolveResult behind the per-partition device gate
(shard/solve.py).

The JAX package lays the partitions across a device mesh; the port runs
them as blocks of one launch on the solver's card. ``n_devices`` (the
healthy CUDA devices, parallel/mesh.healthy_devices) still sets the default
partition count and the ``single-device`` standdown, with the JAX package's
knobs and defaults: on one card ``KARPENTER_TPU_SHARD_MIN_DEVICES=1`` and
``KARPENTER_TPU_SHARD_PARTITIONS=N`` run N lanes, as the JAX package runs N
vmapped lanes on one chip.

The contract is Karpenter's own: a shard-path bug may cost latency, never
correctness. Every result is gated (a device gate per partition and exact
host-side merge checks), and any non-decomposable input or gate rejection is
a classified standdown: try_shard_solve returns None with a reason
(``solver_shard_fallback_total{reason}``) and the caller runs the ordinary
unsharded path. Flag off, nothing changes: the entry is one env read.
"""

from __future__ import annotations

import os
from typing import Optional

# classified standdown reasons — the bounded label-value set for
# solver_shard_fallback_total and the vocabulary of tests/test_shard_parity.py
REASON_SINGLE_DEVICE = "single-device"
REASON_SMALL_BATCH = "small-batch"
REASON_RELAXABLE = "relaxable"
REASON_UNSUPPORTED_ARGS = "unsupported-args"
REASON_SINGLE_PARTITION = "single-partition"
REASON_CROSS_PARTITION_CLAIMS = "cross-partition-claims"
REASON_SHAPE_MISMATCH = "shape-mismatch"
REASON_SLOT_OVERFLOW = "slot-overflow"
REASON_MERGE_REJECTED = "merge-rejected"
REASON_ERROR = "error"

REASONS = (
    REASON_SINGLE_DEVICE, REASON_SMALL_BATCH, REASON_RELAXABLE,
    REASON_UNSUPPORTED_ARGS, REASON_SINGLE_PARTITION,
    REASON_CROSS_PARTITION_CLAIMS, REASON_SHAPE_MISMATCH,
    REASON_SLOT_OVERFLOW, REASON_MERGE_REJECTED, REASON_ERROR,
)


def enabled() -> bool:
    """KARPENTER_TPU_SHARD, default OFF: the partitioned solve is opt-in
    until the fleet-scale bench history matures. Off = zero overhead and a
    bit-identical dispatch path (the census pin holds the proof)."""
    return os.environ.get("KARPENTER_TPU_SHARD", "0") not in ("", "0")


def min_pods() -> int:
    """KARPENTER_TPU_SHARD_MIN_PODS: batches below this never shard — the
    partition/merge overhead only amortizes on large batches. Tests lower it
    to exercise the path on small corpora."""
    try:
        return int(os.environ.get("KARPENTER_TPU_SHARD_MIN_PODS", "512"))
    except ValueError:
        return 512


def min_devices() -> int:
    """KARPENTER_TPU_SHARD_MIN_DEVICES: the fewest healthy devices worth
    sharding over (default 2, the JAX package's; 1 runs the lanes on one
    card)."""
    try:
        return int(os.environ.get("KARPENTER_TPU_SHARD_MIN_DEVICES", "2"))
    except ValueError:
        return 2


def target_partitions(n_devices: int) -> int:
    """KARPENTER_TPU_SHARD_PARTITIONS: how many partitions to balance the
    component graph into (0 = one per mesh device, the default). More
    partitions than devices round-robin onto the mesh axis in the JAX
    package; here every partition is one block of the solver's card)."""
    try:
        knob = int(os.environ.get("KARPENTER_TPU_SHARD_PARTITIONS", "0"))
    except ValueError:
        knob = 0
    return knob if knob > 0 else n_devices


def max_partition_pods() -> int:
    """KARPENTER_TPU_SHARD_MAX_PART_PODS: hard ceiling on one partition's
    pod count (0 = no ceiling). A partition above the ceiling means the
    component graph did not decompose enough to be worth padding — the
    caller stands down to the unsharded path instead of running one huge
    lane plus many tiny ones."""
    try:
        return int(os.environ.get("KARPENTER_TPU_SHARD_MAX_PART_PODS", "0"))
    except ValueError:
        return 0


def merge_enabled() -> bool:
    """KARPENTER_TPU_SHARD_MERGE, default ON: compact cross-partition claims
    with identical narrowed requirements into shared claims after the solve
    (shard/solve.py _merge_claims). Off = claims pass through concatenated
    (more launched nodes, never an invalid placement)."""
    return os.environ.get("KARPENTER_TPU_SHARD_MERGE", "1") not in ("", "0")


def full_validate_max() -> int:
    """KARPENTER_TPU_SHARD_VALIDATE_MAX: run the float64 host validator at
    full level over the MERGED result when the batch is at most this many
    pods (belt-and-braces over the per-partition device gates; the merge
    step's own checks are exact either way). 0 disables; large batches rely
    on the device gates + the supervisor's configured validation."""
    try:
        return int(os.environ.get("KARPENTER_TPU_SHARD_VALIDATE_MAX", "4096"))
    except ValueError:
        return 4096


from karpenter_tpu_torch.shard.partition import (  # noqa: E402
    Partition,
    PartitionPlan,
    partition_pods,
)
from karpenter_tpu_torch.shard.solve import try_shard_solve  # noqa: E402

__all__ = [
    "enabled", "min_pods", "min_devices", "target_partitions",
    "max_partition_pods", "merge_enabled", "full_validate_max",
    "Partition", "PartitionPlan", "partition_pods", "try_shard_solve",
    "REASONS",
]
