#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``karpenter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``karpenter_tpu_torch/csrc`` and runs:

  1. kernel vs plain: each kernel against its plain PyTorch version on the
     card, over seeded corpora (existing nodes, taints, host ports, Gt/Lt
     bounds, zone/hostname spread and affinity, claim-slot overflows, a
     rounding ladder that demotes pods, relaxable pods in one-pass mode,
     chain-heavy populations whose chains commit through every branch, more
     than 32 label keys and 2,560 value lanes). ``ffd_loop`` (fresh,
     carried from phase 1, one-pass, and fresh with a scored requeue on
     SCORED_CORPORA), ``relax_place`` in both modes (the waterfill, and the
     convex phase 1 with every Relax2Stats field bit for bit) must match exactly
     on kind/index, residue, stats, integer and bool state and all four
     IterCounts fields (narrow iterations, sweeps, chain commits, chain
     pods), and within rtol 1e-5 on float state; ``attribute`` must give the
     plain words for every active row against each solve's final state under
     both row plans (each run of byte-identical rows once, and every row:
     their counts of every entry's gates and listed types equal, the work
     each launch needs no more than that), and
     every gate family must fail somewhere; ``runs_screen`` (stacked) must
     equal its plain version at the wide shapes; ``gate_counts`` must give
     identical counts on clusters of GATE_CLUSTERS blocks on clean results
     and on results corrupted to trip each invariant;
     ``lane_scores`` must be within 1e-6 of its plain version.
     Whole solves with ``relax`` on and off, and with
     ``KARPENTER_TPU_RELAX2`` or ``KARPENTER_TPU_ORDER_POLICY`` on, must equal
     the plain path's ``TorchSolver(device="cpu")``. The wavefront corpora
     (tests/test_wavefront_parity.py's seeds 4000-4002, chain-3003, fuzz-3
     and topology-8 with existing nodes): ``ffd_loop`` with the wavefront on
     (csrc/wave.cuh) at W = 4 and W = 2, fresh, carried (from all-FAIL seeds
     and from phase 1), scored, in the lanes mode on two lanes and in the
     fused launch, each bit-equal to ``sweeps_plain`` with the wavefront in
     kinds, indices, the 7 IterCounts fields and ``wave_hist``.
  2. the main path at full width: ``TorchSolver().solve`` (the default
     two-phase solve: ``relax_place``, the carried ``ffd_loop``, the relaxed
     gate) on 10,000 pods of the reference's diverse mix against 400 catalog
     instance types and one default NodePool, 128 claim slots with
     escalation, with the launch counts read just after it; then
     ``full_gate`` of the result (a reject fails the run); then the
     ``relax=False`` path on the same batch. Then at the main path's shapes
     each kernel alone (CUDA events around the launch, arguments built
     beforehand), its wrapper, and its plain version on the same inputs,
     which it must equal: ``relax_place``, ``ffd_loop`` carried and fresh
     (with their IterCounts) and one-pass (over the batch's first
     ONE_PASS_PODS rows, the depth cut so the whole smoke keeps its time),
     ``gate_counts`` on clusters of GATE_CLUSTERS blocks with its split by stage, its leader's
     barriers and its latency floor (one launch + barriers x a barrier's
     cost), and the 10k gate stage split into the host's GateArgs build, the
     wrapper, the kernel and the rest of ``full_gate``. The main path's
     ``ffd_loop`` must have run on a
     cluster of more than one block; each of its three modes is then timed
     on clusters of CLUSTER_SIZES blocks (16 where the card schedules it),
     each launch equal to the plain loop bit for bit (verdicts, IterCounts,
     every state leaf's bits), with the split of its leader
     block's cycles by section (share and ms, csrc/step.cuh ``SEC_*``), and
     the sync probe times a block barrier and a cluster barrier of each size.
     ``relax_place`` (one solve on a cluster of 16) is timed with its split
     by stage, beside its lanes kernel at one lane, and again on clusters of
     CLUSTER_SIZES blocks, each launch equal to the plain waterfill bit for
     bit (verdicts, residue, stats, every state leaf's bits).
  3. the consolidation screen at full width: ``UnionScorer.score_subsets``
     over the bench cluster widened to 200 candidates (the 100 prefixes, the
     200 singletons and 20 seeded random subsets of 150-200 candidates: 320
     lanes in one ``runs_screen`` launch). Corpus A (8 pinned base pods
     filling the survivors) through the residual screen (``delta=True``, its
     base world on the seeded ``ffd_loop``) and through the full screen
     (``delta=False``); corpus B (A plus 24 zonal spread pods) stands the
     batch down to the full screen with three passes and a topology run.
     The delta verdicts must equal the full screen's on every lane, the
     counts must equal the JAX package's on the same subsets, and
     ``runs_screen`` must equal its plain version exactly (kind, index, every
     state leaf) in each mode on 26 lanes (every 20th, the last, 10 of the
     large random subsets); then the kernel alone, through its wrapper, and its
     plain version are timed, with the plan's layout and its slowest lane's
     split by section; then each mode again in every layout and cluster
     size of SCREEN_PLANS, each launch bit-equal to the plan's own.
  4. the steady-state churn cycle (the JAX package's device-world bench
     scenario): 10,000 ``default_pod_factory`` pods against 400 catalog
     types, 200 arrivals and 200 deletes a cycle, 24 cycles, through
     ``TorchSolver(relax=False, device_world=True)`` and, in lockstep on the
     same snapshots, ``TorchSolver(relax=False)``. One adopt and 23 patched
     cycles with no standdown; placements equal to the legacy arm's on
     every cycle; the fused counts zero; per patched cycle exactly one
     ``patch_world``, one ``ffd_loop`` and one ``gate_counts`` launch (the
     counts set to 0 before each cycle and read after it); ``patch_world``
     bit-equal to its plain version on every patched cycle; the resident
     world bit-equal to the cold encode's on every fourth cycle and the
     last; the fused counts equal to ``gate_counts_plain`` over the same
     state on every cycle, on every cluster size. Then the cycle walls, their
     split, the bytes up, and ``patch_world`` (its shipped rows packed on the
     card; with its bytes up, bound and one launch beside it) and the fused
     gate alone (on every cluster size, with its split and latency floor),
     wrapped and plain.
  5. the supervised multi-tenant serve path (the JAX package's serve
     scenario): ``runs_screen`` in its stacked mode through
     ``serve.batch.stacked_solve`` (encode, stack, one launch, decode, full
     validation) at 8 tenants x 50 pods (50 types) and 8 x 1,250 (400
     types), one launch each with every lane riding it, each lane's
     scheduled count equal to a solo ``TorchSolver`` solve, the kernel
     equal to ``batched_screen_plain`` (three passes) and
     ``batched_solve_plain`` (one) on every narrow lane and two wide ones,
     then timed alone, wrapped and plain, and in every layout of
     SCREEN_PLANS, bit-equal to the plan's own; the 16-tenant x 6-cycle scenario
     through ``SolveService`` (a warm pass, a measured pass with its launch
     counts, every ticket ok, the stacked ``runs_screen`` launched) beside
     the same problems through one ``SupervisedSolver``, every tenant's
     supervisor and the control left with a closed circuit and no fallback,
     retry or rejection; the overload probe (a 2-deep queue, a 20 ms
     solver, a 50 ms budget: no unclassified outcome); and phase 2's batch
     through ``SupervisedSolver(TorchSolver(), fallback=OracleSolver())``,
     which must return phase 2's placements with the circuit closed and no
     fallback, retry or rejection.
  6. the explain pass at full width: phase 2's batch under a NodePool cpu
     limit that leaves about a quarter of it unscheduled (claim-capacity,
     topology), and phase
     2's batch with tests/test_explain.py's engineered pods added
     (resources, requirements), each with ``KARPENTER_TPU_EXPLAIN`` off and
     on: the same placements, one ``attribute`` launch with the flag on
     (none off), words equal to ``attribute_plain``'s on the same rows and
     state, the report's reasons equal to the plain words' decode; then the
     kernel alone under each row plan (its split by section, its latency
     floor), wrapped and plain on the limited batch's rows, and the explain
     overhead.
  7. the flag-gated phase-1 and order paths at full width (the JAX
     package's flags): ``KARPENTER_TPU_RELAX2=1`` on phase 2's batch and on
     10,000 pods of homogeneous_workload's five sizes against the 400 types
     (relax_place's convex mode, program 17, counted as ``relax2_place``),
     ``KARPENTER_TPU_ORDER_POLICY=1`` on phase 2's batch fresh and carried
     (``lane_scores``, program 6, and the scored ``ffd_loop``): each solve's
     launch counts, ``full_gate`` clean, IterCounts, scheduled pods, claims
     and phase-1 stats equal to the JAX package's (EXPECT_RELAX2,
     EXPECT_POLICY); then the convex mode and ``lane_scores`` (over the
     tables the solve builds once for the scorer and the loop) alone, wrapped
     and plain at those shapes, each equal to plain, the homogeneous carried
     repair and the scored fresh loop against their plain loops; the convex
     mode also on clusters of CLUSTER_SIZES blocks, each launch equal to
     plain bit for bit, with its split by stage.
  8. the partitioned solve (the JAX package's ``KARPENTER_TPU_SHARD`` with
     ``_MIN_DEVICES=1`` and ``_PARTITIONS=8``, programs 13-14) and mesh
     health (program 18) at full width: 100,000 pods of the JAX bench's
     fleet corpus (``make_fleet_pods``, 32 neighborhoods) against 400 types,
     sharded into 8 lanes of one ``ffd_loop`` launch (one cluster each),
     served, every partition's ``gate_counts`` clean and equal to its plain
     version on every cluster size (the deepest partition timed), every pod the
     unsharded FFD control schedules scheduled, and each pod scheduled
     beyond them one with a required pod affinity; the recorded stack's lanes
     launch equal to 8 single-lane launches bit for bit (kinds, indices,
     state, IterCounts) and to the plain twin on two lanes; the same
     with ``KARPENTER_TPU_RELAX2=1`` (``relax_place``'s convex lanes mode,
     then the seeded lanes loop); the 10,000-pod fleet, fresh and relax2,
     equal to the JAX package's (EXPECT_SHARD); ``device[0].loss@1`` under
     ``KARPENTER_TPU_MESH_HEALTH=1`` standing the shard path down
     ``single-device`` (recarves 1) while the unsharded path serves, two
     forced probes (``probe`` kernel launches) bringing the card back, the
     next sharded solve serving; the ``probe`` kernel against its plain sum.
     Then each lanes mode and the probe alone, wrapped and plain; the convex
     lanes with the slowest lane's split by stage, the deepest lane alone
     against the single launch, and the lanes launch on clusters of
     CLUSTER_SIZES blocks a lane, every lane bit-equal to the default's.
  9. the wavefront at full width (``KARPENTER_TPU_WAVEFRONT=1``, W = 4):
     phase 2's batch through ``TorchSolver.solve`` fresh (``relax=False``)
     and carried (``relax=True``), each one ``ffd_loop_wavefront`` launch
     (the counts set to 0 just before the solve and read just after), the
     gate clean, IterCounts and ``wave_hist`` equal to the JAX package's
     (EXPECT_WAVE) and placements equal to phase 2's flag-off solves; then
     the mode alone and through its wrapper at phase 2's inputs, each
     beside the flag-off loop's times on the same run, the carried launch
     held to its plain loop (the fresh one to EXPECT_WAVE here, and to its
     plain loop on phase 1's corpora).
 10. the entry point at the 10k shape: ``Provisioner.reconcile()`` over a
     ``FakeCloudProvider`` with the 400 catalog types, one ``default``
     NodePool and 10,000 makeDiversePods pods in the ``KubeClient``, through
     ``SupervisedSolver(TorchSolver(), fallback=OracleSolver())``, with the
     wavefront off and on: the created NodeClaims (pool, instance-type
     values, pods, in creation order) equal to the JAX package's Provisioner
     over JaxSolver (EXPECT_PROVISION), IterCounts as the JAX package's, the
     circuit closed and no fallback; the split build_inputs / solve
     (``last_timing``) / create_node_claims / wall.
 11. the disruption pass: the port's harness (``testing.harness.Env``) on
     the card over ``SupervisedSolver(TorchSolver(), fallback=
     OracleSolver())``, a ``default`` NodePool (WhenUnderutilized, budget
     100%) over the 100 catalog types, 1,000 candidate nodes in three zones
     with 1-4 pods each (``build_bench_scorer``'s draws, seed 7) and 8 roomy
     survivors annotated do-not-disrupt; ``Controller.reconcile()``, the
     fake clock past the 15 s TTL, ``reconcile()`` again: a command executed,
     exactly one ``runs_screen`` launch to screen, whose rows equal the plain
     screen's on the card on every lane; every screened prefix the
     screen accepts the sequential ``compute_consolidation`` (on the card)
     accepts, agreeing on at least DISRUPT_AGREE prefixes including the
     chosen k and k + 1; the pass's wall split (get_candidates, the scorer
     build's inputs and encode, the screen alone and wrapped, confirmation,
     validation) and screened candidates/s.
 12. the operator: ``Operator(FakeCloudProvider(400 types), Options())``
     (``SupervisedSolver(TorchSolver(), fallback=OracleSolver())`` on the
     card, the ten lifecycle controllers, the batcher, the disruption
     controller) on a FakeClock through ``operator_scenario``: 3,000
     makeDiversePods pods (OPERATOR_PODS) provisioned by ``step()``, launched by
     ``run_until_settled()``, registered by a fake kubelet and bound to
     their nominated nodes until every claim is initialized; a seeded half of
     the pods deleted; the clock stepped past the 15 s validation TTL round
     after round while the disruption controller screens and commands, the
     termination and eviction controllers drain and delete nodes, and a fake
     ReplicaSet makes each evicted pod anew for the provisioner. The final
     state (claims, nodes with their taints, bindings, pending pods, commands
     executed, event reasons in order) must equal the JAX package's
     (EXPECT_OPERATOR, tools/operator_digest.py); the circuit closed with no
     fallback, retry or rejection; ``ffd_loop``, ``relax_place``,
     ``gate_counts`` and ``runs_screen`` each launched by the run (the counts
     set to 0 just before it and read just after). Prints each stage's wall,
     the disruption passes' split and the launches. Then ``start()`` on two
     free localhost ports: /readyz 200 once the warm thread (the kernel
     build, then the standard buckets) ends, OPERATOR_THREADED_PODS pods
     nominated under the real batch window,
     ``# TYPE`` in /metrics for every registered series, /statusz and
     /debug/programs parsed, ``stop()``.
 13. the streaming layer (``streaming_phase``, STREAM_* and the constants
     after them): phase 4's stream (10,000 ``default_pod_factory`` pods,
     seed 21, 400 types, 200 arrivals and 200 deletes a cycle) through
     ``SupervisedSolver(TorchSolver(relax=False), fallback=OracleSolver(),
     streaming=True)`` for STREAM_CYCLES cycles beside a cold
     ``TorchSolver(relax=False)`` on the same snapshots: ``cold-first``,
     then ``warm`` every cycle, every result clean under the full host
     validator with every pod accounted once, every certified pod where the
     cold solve puts it (node for node, claim co-location and template);
     the same stream under the default flags for STREAM_RELAX_CYCLES; each
     cycle's launches (counts set to 0 just before it and read just after),
     the warm p50/p99 beside the cold p50, the warm cycle's split (diff,
     sub-solve, incremental gate, certify, accept), the reuse ratio and the
     sub-solve's pods. Then the journal on the card (``KARPENTER_TPU_STATE_
     DIR``): a fresh ``StreamingSolver`` restores and its first cycle is
     warm; and a restart storm over ``TorchSolver`` on the card
     (``testing.restart.run_restart_storm``, STORM_*). Then phase 2's batch
     through the ``KARPENTER_TPU_RUNS`` solve: validator-clean, its
     scheduled count beside the sweeps path's, its first pass's
     ``runs_screen`` launch (one lane of 10,240 rows) equal to ``ffd_loop``'s
     one pass on the same problem, and over the batch's first
     RUNS_CHECK_PODS pods bit-equal to ``runs_scan_plain`` (kind, index,
     every state leaf); the launch timed alone and wrapped, with its bound.
 14. the program lifecycle and serve replicas (``lifecycle_phase``,
     ``replica_phase``): child processes of this script
     (``--lifecycle-child``) with ``KARPENTER_TPU_AOT_RESTORE``,
     ``KARPENTER_TPU_STATE_DIR`` (a temporary directory) and
     ``KARPENTER_TPU_PROGRAMS`` set. (a) ``Operator.start()`` with
     ``prewarm_max_pods`` MAIN_PODS and ``prewarm_screen_candidates``
     SCREEN_CANDIDATES under ``KARPENTER_TPU_DEVICE_WORLD=1``: /readyz 503 on
     every poll while the warm runs and 200 after; then ``prewarm_claim_
     buckets`` and ``prewarm_shard`` under ``SHARD=1``; ``ffd_loop``,
     ``relax_place``, ``gate_counts``, ``runs_screen``, ``patch_world`` and
     ``ffd_loop_lanes`` launched; all eight libraries loaded from phase 0's
     ``_build/`` (source ``persistent``, no nvcc) and snapshotted; then phase
     2's batch, whose wall is printed beside a process that did not warm,
     with equal placements. (b) a restart with no nvcc on ``PATH``,
     ``CUDA_HOME`` pointing nowhere and an empty build directory:
     ``Operator.start()`` answers /readyz 503 through ``restoring`` and
     ``probing`` and 200 after; the probe passed; every library restored,
     nvcc never run, every program's source ``restored`` or ``memory``; phase
     2's batch bit-equal to (a)'s; the recovery seconds and each library's
     restore beside its nvcc build. (c) one byte of ``probe``'s entry
     flipped: without nvcc /readyz stays 503 with ``kernel_build_error``; with
     nvcc the entry is ``checksum``, the other seven restored, ``probe``
     alone rebuilt and the probe passes. (d) phase 5's serve scenario with
     stacking off through a flat ``SolveService``, ``ReplicaSet(1)`` and
     ``ReplicaSet(2)`` (both replicas busy at once), every tenant's
     placements equal to the flat service's, aggregate pods/s of each; then
     ``ReplicaSet(2)`` with ``failover(1)`` after the third cycle: every
     ticket ok, the moved tenants placed with reason ``failover``.
 15. a ``kernels`` JSON line: per kernel its launches on the main path, its
     time alone and through its wrapper, its bound, and the plain version's
     time; for ``ffd_loop``, ``relax_place`` and ``runs_screen`` also the
     work counters their launches recorded, from which the operation bounds
     are computed, and for ``ffd_loop`` the latency floor of its barriers
     (block barriers x a block barrier's cost + cluster barriers x a cluster
     barrier's cost), its cluster, residency and times at each cluster size
     with their section splits, and its fresh and one-pass modes; for
     ``relax_place`` (and its convex and lanes modes) the cluster and the
     times by cluster size, for ``runs_screen`` the plan and the times by
     layout. Bytes are those of the kernel's own
     arguments. The churn, serve, shard and provisioning phases' records
     ride in the same line; the wavefront mode is an entry of its own. The
     entries of the four kernels phase 12 runs carry ``launches_operator``,
     those of ``ffd_loop``, ``relax_place`` and ``gate_counts`` their
     launches per warm cycle of phase 13 (``launches_warm_cycle``), and
     ``runs_screen``'s the ``RUNS`` solve (``runs_solve``). Every entry
     carries ``restored``: whether phase 14's restart restored its library.
 16. the card's name and power limit; the last line is the device JSON.

Any mismatch or exception exits non-zero. Needs one CUDA device; imports
only torch, numpy and karpenter_tpu_torch.
"""

import copy
import ctypes
import dataclasses
import json
import os
import random
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bytes/s, and float32
# operations/s outside the tensor cores (an FMA counted as two). The
# kernels' mask algebra is int32/bool work: an H100 SM has 64 int32 lanes
# against 128 float32 lanes and no int32 FMA, so its int32 peak is a quarter
# of the float32 figure.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_OPS_S = 67e12
PEAK_INT32_OPS_S = PEAK_FP32_OPS_S * 64 / 128 / 2

FLOAT_RTOL = 1e-5  # float state: same adds in the same order, FMA off
FLOAT_ATOL = 1e-6

MAIN_PODS = 10000  # the north-star batch
# phase 2 times ffd_loop at each cluster size (16, non-portable, where the
# card schedules it); a lone solve on the main path runs on the planner's
# SOLO_CLUSTER (16), the lanes of the partitioned solve on 8
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# runs_screen's layouts and cluster sizes (parallel/mesh.screen_plan), each
# run in phases 3 and 5 beside the plan's own pick
SCREEN_PLANS = (("block", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8), ("cluster", 16))
ONE_PASS_PODS = 2500  # the one-pass scan's depth in phase 2 (its plain loop is per pod)
SOLVE_KERNELS = ("ffd_loop", "gate_counts", "relax_place")
# phase 1's corpora whose requeue the scored ffd_loop sorts against its plain
# loop (the scored plain loop is a second plain loop per corpus)
SCORED_CORPORA = ("chain-2000", "topology-3", "homogeneous-48")

# the consolidation screen's cluster: the bench scorer widened to the screen's
# 200-candidate basis; the JAX package's counts on these subsets, read on the
# CPU (the residual path: every lane residual, the run trim 9 wide)
SCREEN_CANDIDATES = 200
SCREEN_SEED = 3
EXPECT_A = {"delta_lanes": 320, "fallback_lanes": 0, "rnr": 9, "consolidatable": 316, "new_claims": [306, 10, 4]}
EXPECT_B = {"mode": "full", "passes": 3, "all_scheduled": 320, "consolidatable": 307, "new_claims": [306, 1, 13]}

# the steady-state churn cycle: the JAX package's device-world bench scenario
# (bench.py device_churn): 10,000 default_pod_factory pods, 2% arrivals and
# 2% deletes a cycle, 24 cycles; 64 claim slots, the bucket the batch's 39
# claims escalate to from the default 32 (read from the JAX package on the
# CPU), so that no cycle overflows
CHURN_PODS = 10000
CHURN_CYCLES = 24
CHURN_RATE = CHURN_PODS * 2 // 100
CHURN_SEED = 21
CHURN_SLOTS = 64

# the multi-tenant serve path: the JAX package's serve scenario (bench.py
# serve: 16 tenants, 6 cycles of 50 default_pod_factory pods each, 50 catalog
# types, one NodePool, seed 99) and the stacked kernel at two shapes: that
# scenario's first cycle over 8 tenants, and the north-star 10k batch split
# over 8 tenant clusters at the 400-type catalog
SERVE_TENANTS = 16
SERVE_CYCLES = 6
SERVE_PODS = 50
SERVE_ITS = 50
SERVE_SEED = 99
STACK_LANES = 8
WIDE_PODS = 1250
WIDE_ITS = 400

# the explain phase: phase 2's batch under a NodePool cpu limit that leaves a
# large share of it unscheduled (each opened claim burns the largest surviving
# type's capacity, 400 cpu at the 400-type catalog: 20 claims take 7,352 of
# the 10,000 pods on the card)
EXPLAIN_CPU_LIMIT = 8000.0

# the flag-gated phase-1 and order paths (phase 7): the JAX package's own
# values for each full-width run, read from its JaxSolver(initial_claim_slots
# =128) on the CPU. KARPENTER_TPU_RELAX2=1 on phase 2's batch and on 10,000
# pods of homogeneous_workload's five sizes against the 400 catalog types;
# KARPENTER_TPU_ORDER_POLICY=1 (the committed artifact) on phase 2's batch,
# fresh (the JAX package's KARPENTER_TPU_RELAX=0) and carried from the
# waterfill. IterCounts are (narrow, sweeps, chain commits, chain pods, and
# the wavefront's wave commits, wave pods, retry lanes: 0 with it off).
FLAG_ENV = ("KARPENTER_TPU_RELAX2", "KARPENTER_TPU_RELAX2_ITERS", "KARPENTER_TPU_RELAX2_STEP",
            "KARPENTER_TPU_RELAX2_TOL", "KARPENTER_TPU_ORDER_POLICY", "KARPENTER_TPU_ORDER_POLICY_LANES",
            "KARPENTER_TPU_ORDER_POLICY_WEIGHTS")
EXPECT_RELAX2 = {
    "diverse": dict(iters=(1937, 2, 1332, 5112, 0, 0, 0), scheduled=10000, claims=111,
                    stats=dict(eligible=4288, placed=4288, demoted=0, claims=60, pgd_iterations=24, overflow=0,
                               round_demoted=0),
                    residual=0.0013015065342187881, capviol=0.0),
    "homogeneous": dict(iters=(8, 1, 0, 0, 0, 0, 0), scheduled=10000, claims=18,
                        stats=dict(eligible=10000, placed=9992, demoted=8, claims=18, pgd_iterations=24, overflow=0,
                                   round_demoted=7),
                        residual=0.005609273910522461, capviol=0.008820994757115841),
}
EXPECT_POLICY = {
    "fresh": dict(iters=(2067, 1, 1400, 9333, 0, 0, 0), scheduled=10000, claims=118, relax=None),
    "carried": dict(iters=(1971, 1, 1313, 5054, 0, 0, 0), scheduled=10000, claims=113,
                    relax=dict(eligible=4288, placed=4288, demoted=0, claims=30)),
}
# the partitioned solve (phase 8): the JAX bench's fleet rows
# (bench.py:1345-1356, run_shard_child): make_fleet_pods(n, Random(42),
# neighborhoods=32) against the 400 catalog types and one default NodePool,
# in the 8 partitions of its 8-device mesh, here 8 lanes on one card. The
# fresh and the relax2 lanes are held against their plain twins on lane 0,
# the deepest (the plain loops step every chain in Python; every lane is also
# held to its single-lane launch). EXPECT_SHARD: the JAX
# package's own sharded solve of the 10,000-pod fleet on the CPU (8 host
# devices, the same knobs, EXPLAIN off).
SHARD_PODS = 100000
SHARD_CHECK_PODS = 10000
SHARD_NEIGHBORHOODS = 32
SHARD_PARTITIONS = 8
SHARD_PLAIN_LANES = (0,)
SHARD_ENV = {"KARPENTER_TPU_SHARD": "1", "KARPENTER_TPU_SHARD_MIN_DEVICES": "1",
             "KARPENTER_TPU_SHARD_PARTITIONS": str(SHARD_PARTITIONS), "KARPENTER_TPU_EXPLAIN": "0"}
EXPECT_SHARD = {
    "fresh": dict(scheduled=9862, claims=31, merged_claims=0, part_pods=[1250] * 8, reason=None, max_claims=32,
                  narrow_iters=1732, sweep_iters=31),
    "relax2": dict(scheduled=9851, claims=127, merged_claims=1, part_pods=[1250] * 8, reason=None, max_claims=32,
                   narrow_iters=1636, sweep_iters=32,
                   relax2=dict(eligible=9216, placed=2406, demoted=6810, claims=128, pgd_iterations=24,
                               overflow=4337, round_demoted=4337, residual=0.0013015065342187881, capviol=0.0)),
}
# the wavefront (phase 9, KARPENTER_TPU_WAVEFRONT=1 at the JAX package's
# default width 4): phase 2's batch through the JAX package's
# JaxSolver(initial_claim_slots=128) on the CPU, fresh (its
# KARPENTER_TPU_RELAX=0) and carried from the waterfill. Round 8 recorded the
# fresh solve's numbers (docs/PERF_NOTES.md:660-663); they hold today.
WAVE_WIDTH = 4
EXPECT_WAVE = {
    "fresh": dict(iters=(1436, 2, 940, 7183, 1397, 2321, 1), wave_hist=[0, 136, 1209, 84, 7], scheduled=10000,
                  claims=97),
    "carried": dict(iters=(1365, 2, 909, 3418, 1429, 1838, 1), wave_hist=[0, 72, 1161, 127, 5], scheduled=10000,
                    claims=111),
}
# the entry point (phase 10): the JAX package's Provisioner over
# JaxSolver(FAKE_WELL_KNOWN_LABELS, initial_claim_slots=128) on the CPU, one
# reconcile of 10,000 makeDiversePods pods against FakeCloudProvider with the
# 400 catalog types and one default NodePool: ``provision_digest`` of the
# pass (per created claim in order its pool, instance-type values and pods;
# nominations; failures), with the wavefront off ("0") and on ("1")
EXPECT_PROVISION = {
    "0": dict(claims=111, on_claims=10000, failed=0,
              sha256="9b8fe3a915a36c0fd7855d7538e682b65e31df6fcb43b667f8610d3f43d5b92b",
              iters=(1937, 2, 1332, 5112, 0, 0, 0), wave_hist=None),
    "1": dict(claims=111, on_claims=10000, failed=0,
              sha256="9b8fe3a915a36c0fd7855d7538e682b65e31df6fcb43b667f8610d3f43d5b92b",
              iters=(1365, 2, 909, 3418, 1429, 1838, 1), wave_hist=[0, 72, 1161, 127, 5]),
}
# the disruption pass (phase 11): a mid-size cluster through the port's
# harness, the candidates' pods drawn as build_bench_scorer draws them
DISRUPT_CANDIDATES = 1000
DISRUPT_SURVIVORS = 8
DISRUPT_SEED = 7
DISRUPT_CANDIDATE_TYPE = "fake-it-3"  # 4 cpu, 8 GiB, 40 pods: the bench's candidate node
DISRUPT_SURVIVOR_TYPE = "fake-it-63"  # 64 cpu, 128 GiB
# the prefixes the screen and the sequential path must agree on (each a
# sequential compute_consolidation on the card: 10 of them, with the chosen k
# and k + 1, so that the smoke keeps its time with phase 14)
DISRUPT_AGREE = 10
DISRUPT_PREFIXES = (1, 2, 4, 8, 16, 32, 50, 80, 150, 200)
# the operator (phase 12): ``Operator.step()`` / ``run_until_settled()`` on a
# FakeClock through a whole cluster lifecycle (``operator_scenario``), and
# ``start()`` on two localhost ports. EXPECT_OPERATOR is the scenario's digest
# through the JAX package's ``Operator(Options(solver_backend="jax"))`` on the
# CPU (tools/operator_digest.py, the same function called with that package)
# cut from the north-star 10,000: the cooperative run took 128.5, 93.5,
# 128.0 and 482.1 s on the card at 2,500, 3,000, 3,500 and 5,000 pods
# (host-bound consolidation; its rounds, not the pods alone, set the time),
# and the whole smoke at 3,500 took 1,026 s of its 1,200 s limit with this
# phase at 192.4 s, so 3,000 holds the phase well inside its ~180 s share
OPERATOR_PODS = 3000
OPERATOR_TYPES = 400
OPERATOR_SEED = 12  # the seeded half of the pods that is deleted
OPERATOR_THREADED_PODS = 300
OPERATOR_THREADED_WAIT_S = 120.0
EXPECT_OPERATOR = dict(claims=29, nodes=29, bound=1500, pending=0, commands=3, disrupted=35, evicted=736, events=4526,
                       sha256="2adbc8f06f375fd7f3d2d62b3d3654c09fb506e94fef4e70bd6dcaf09244e1ee")
# the streaming layer (phase 13): phase 4's churn stream (10,000
# default_pod_factory pods, seed 21, 400 catalog types, 200 arrivals and 200
# deletes a cycle: 4% churn, under the 0.15 cold threshold) through
# SupervisedSolver(streaming=True) over TorchSolver, relax off for
# STREAM_CYCLES cycles against a cold TorchSolver in lockstep, then under the
# default flags for STREAM_RELAX_CYCLES; the journal restored on the card;
# a restart storm of STORM_* over TorchSolver on the card; and phase 2's
# batch through the KARPENTER_TPU_RUNS solve, whose runs_screen launch is
# held bit for bit to runs_scan_plain over the batch's first RUNS_CHECK_PODS
# pods (the plain scan steps one run at a time in Python: ~24 s for 2,000
# pods on a CPU), and at full width to ffd_loop's one-pass launch
STREAM_PODS = CHURN_PODS
STREAM_SEED = CHURN_SEED
STREAM_RATE = CHURN_RATE
STREAM_CYCLES = 12
STREAM_RELAX_CYCLES = 6
STORM_PODS = 300
STORM_CYCLES = 4
STORM_KILLS = 2
RUNS_CHECK_PODS = 1000
# the convex phase's two float stats against the JAX package's: the float32
# adds of the bin loads and the gradient step round in another order there
# (its CPU build may contract a multiply and an add), by 1.5e-4 relative on
# the homogeneous bulk's overload (ROADMAP.md, section C)
STAT_RTOL = 1e-3
SCORE_ATOL = 1e-6  # lane scores, kernel against plain: log1p may differ by an ulp
GATE_REPEATS = 20  # phase 7: gate_counts launches on each result, each equal to plain
GATE_CLUSTERS = (16, 8, 4)  # gate_counts' cluster sizes held to plain and timed (the plan's first)
# float32 operations per valid (pod, window column) pair and trip of the
# convex phase: the load's multiply and add, and the update's overload,
# price, gradient, step, clip, row sum, rescale and change (ops/relax2.py)
PGD_COLUMN_OPS = 18


def log(msg):
    print(msg, flush=True)


def relax_bits(tag, rk, rp):
    """Two phase-1 results equal bit for bit: verdicts, residue, the raw
    stats words and every state leaf (float leaves as their bits)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.models.problem import numpy_fields

    for key in ("kind", "index", "residue_active"):
        if not torch.equal(getattr(rk, key).cpu(), getattr(rp, key).cpu()):
            raise AssertionError(f"{tag}: relax_place {key} differs")
    words = lambda st: [int(x.reshape(()).view(torch.int32)) if x.dtype == torch.float32 else int(x)  # noqa: E731
                        for x in st]
    if words(rk.stats) != words(rp.stats):
        raise AssertionError(f"{tag}: relax_place stats {words(rk.stats)} != {words(rp.stats)}")
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for name in sp:
        if not np.array_equal(sk[name].view(np.uint8), sp[name].view(np.uint8)):
            raise AssertionError(f"{tag}: relax_place state {name} differs in its bits")


def split_by(names, sections, ms):
    """{section: ms} of one launch's (or lane's) section counters: each
    section's share of the clock, times the launch's ms."""
    cyc = [int(x) for x in sections.cpu()]
    total = sum(cyc) or 1
    return {n: round(c / total * ms, 4) for n, c in zip(names, cyc) if c}


def relax_by_cluster(tag, prob, C, convex, ref, time_launches):
    """relax_place at each cluster size of CLUSTER_SIZES (single launches):
    timed, each launch held to ``ref`` (its plain version) bit for bit, and
    its split by stage."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops import relax2 as R2
    from karpenter_tpu_torch.ops.ffd_sweeps import forced_cluster

    rows = {}
    for cl in CLUSTER_SIZES:
        try:
            with forced_cluster(cl):
                sets = [((t, st), a) for t, st, a in (RX.relax_place_args(prob, C, convex) for _ in range(3))]
            ms, all_ms = time_launches("relax_place", [(t, a) for (t, _), a in sets])
        except kernels.KernelDeviceError as e:
            if cl <= 8:
                raise
            log(f"  {tag} at a cluster of {cl}: refused by the card ({e})")
            continue
        for (t, st), _ in sets:
            if int(t["plan"][0]) != cl:
                raise AssertionError(f"{tag}: a launch planned at {cl} ran on {int(t['plan'][0])} blocks")
            rk = RX._relax_out(t, st, prob.num_lanes, convex)
            relax_bits(f"{tag} cluster {cl}", rk if convex is None else rk._replace(stats=R2.stats_of(rk.stats)), ref)
        rows[cl] = {"ms": ms, "sections": split_by(RX.SECTIONS, sets[0][0][0]["sections"], ms)}
        log(f"  {tag} cluster {cl}: {ms:.4f} ms median of {[round(x, 4) for x in all_ms]}, == plain bit for bit; "
            f"by stage {rows[cl]['sections']}")
    return rows


def screen_by_layout(tag, make_args, rk, V, time_launches):
    """runs_screen in every layout and cluster size of SCREEN_PLANS: each
    launch ran in the forced layout and equals ``rk`` (the default plan's
    launch, itself held to the plain screen) bit for bit; timed, with its
    slowest lane's split by section."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.parallel import mesh as M

    want = numpy_fields(rk.state)
    rows = {}
    for layout, cl in SCREEN_PLANS:
        name = f"{layout}{cl}" if layout == "cluster" else layout
        try:
            with M.forced_screen_plan(layout, cl):
                sets = [make_args() for _ in range(2)]
            ms, all_ms = time_launches("runs_screen", sets)
        except kernels.KernelDeviceError as e:
            if layout != "cluster" or cl <= 8:
                raise
            log(f"  {tag} {name}: refused by the card ({e})")
            continue
        for t, _ in sets:
            if t["plan"].cpu().tolist() != [M.SCREEN_LAYOUTS.index(layout), cl, 512]:
                raise AssertionError(f"{tag} {name}: the launch ran as {t['plan'].cpu().tolist()}")
            if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
                raise AssertionError(f"{tag} {name}: kind/index differ from the default layout's")
            got = numpy_fields(M.state_back(t, V))
            for key in want:
                if not np.array_equal(got[key].view(np.uint8), want[key].view(np.uint8)):
                    raise AssertionError(f"{tag} {name}: state {key} differs from the default layout's in its bits")
        t = sets[0][0]
        per = t["sections"].sum(dim=1)
        slow = int(per.argmax())
        rows[name] = {"ms": ms, "slowest_lane": slow, "sections": split_by(M.RS_SECTIONS, t["sections"][slow], ms)}
        log(f"  {tag} {name}: {ms:.3f} ms median of {[round(x, 3) for x in all_ms]}, == the default layout bit for "
            f"bit; the slowest lane ({slow}) by section {rows[name]['sections']}")
    return rows


# one launch and the barrier costs (phase 2's sync probe), for the latency
# floors of the later phases
LATENCY = {}


def gate_by_cluster(tag, build, wrap, want, time_ms, time_launches, reps=10):
    """``gate_counts`` on clusters of GATE_CLUSTERS blocks: each launch's
    counts held to ``want`` (the plain version's), the kernel's time, the
    wrapper's, the split by section and the leader's barriers. Returns the
    rows by cluster size and the plan's argument sets."""
    import numpy as np

    from karpenter_tpu_torch.ops.ffd_sweeps import forced_cluster
    from karpenter_tpu_torch.verify import device as gdev

    rows, default = {}, None
    for blocks in GATE_CLUSTERS:
        layout = f"cluster{blocks}"
        with forced_cluster(blocks):
            sets = [build() for _ in range(reps)]
            ms, all_ms = time_launches("gate_counts", sets)
            wrap_ms, _ = time_ms(wrap, 5)
        for t, _ in sets:
            if not np.array_equal(t["counts"].cpu().numpy(), np.asarray(want)):
                raise AssertionError(f"{tag} ({layout}): kernel {t['counts'].tolist()} != plain {list(want)}")
        t, args = sets[0]
        sec = t["sections"].cpu()
        rows[layout] = {"ms": ms, "wrapper_ms": wrap_ms, "blocks": args.NB,
                        "sections": {k: round(v, 5) for k, v in gdev.gate_section_split(sec, ms).items()},
                        "barriers": list(gdev.gate_barriers(sec))}
        log(f"  {tag} {layout} ({args.NB} blocks): kernel {ms:.4f} ms median of {[round(x, 4) for x in all_ms]}, "
            f"wrapper {wrap_ms:.4f} ms, == plain; by section {rows[layout]['sections']}; leader's block / cluster "
            f"barriers {rows[layout]['barriers']}")
        if blocks == gdev.gate_blocks():
            default = sets
    if LATENCY:
        gate_floors(rows)
    return rows, default


def gate_floors(rows):
    """Each layout's latency floor: one launch, plus the leader's block
    barriers at a block barrier's cost and its cluster barriers at the cost
    of one in a cluster of its size."""
    for layout, row in rows.items():
        nb, ncl = row["barriers"]
        cl = LATENCY["cluster_sync_ms"].get(row["blocks"], 0.0) if ncl else 0.0
        row["latency_floor_ms"] = LATENCY["launch_ms"] + nb * LATENCY["sync_ms"] + ncl * cl


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--lifecycle-child":
        return lifecycle_child(sys.argv[2], json.loads(sys.argv[3]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    return run(torch.device("cuda"))


def run(dev) -> int:
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
    from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
    from karpenter_tpu_torch.ops import policy as POL
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops import relax2 as R2
    from karpenter_tpu_torch.ops.ffd_core import (
        IterCounts,
        _lane_align,
        _pad_lanes_mult32,
        initial_state,
        problem_bounds_free,
    )
    from karpenter_tpu_torch.ops.ffd_step import (
        ATTR_WORK_COUNTERS,
        attribute_plain,
        launch_attribute,
        solve_ffd,
        solve_ffd_plain,
    )
    from karpenter_tpu_torch.ops.ffd_sweeps import (
        FFD_SCRATCH,
        FFD_STATE,
        WORK_COUNTERS,
        ffd_loop_args,
        ffd_loop_lanes_args,
        forced_cluster,
        result_of,
        section_split,
        smem_bytes,
        solve_ffd_sweeps,
        solve_ffd_sweeps_carried,
        sweeps_plain,
    )
    from karpenter_tpu_torch.ops.padding import pad_problem
    from karpenter_tpu_torch.parallel import mesh
    from karpenter_tpu_torch.provisioning.topology import Topology
    from karpenter_tpu_torch.solver import ordering
    from karpenter_tpu_torch.solver.encode import Encoder, domains_from_instance_types
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W
    from karpenter_tpu_torch.verify import full_gate
    from karpenter_tpu_torch.verify import device as gdev
    from karpenter_tpu_torch.verify.gate import _build_args

    # phases 1-6 run with the flag-gated paths off, as a deployment's default
    for name in FLAG_ENV:
        os.environ.pop(name, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 0. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f}s (per library {({k: round(v, 1) for k, v in kernels.BUILD_SECONDS.items()})})")
    for name in kernels.SOURCES:
        for line in (kernels.BUILD_DIR / f"{name}.log").read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def encode(workload, claim_slots, well_known=FAKE_WELL_KNOWN_LABELS, pod_volumes=None):
        pods, its, tpls, nodes = workload
        topo = Topology(domains_from_instance_types(its, tpls), batch_pods=pods, cluster_pods=[])
        for n in nodes:
            topo.register("kubernetes.io/hostname", n.name)
        enc = (Encoder(well_known) if well_known is not None else Encoder()).encode(
            pods, its, tpls, nodes, topology=topo, num_claim_slots=claim_slots,
            pod_volumes=pod_volumes,
        )
        return pad_problem(enc.problem)

    def compare_state(tag, state_k, state_p):
        """Integer and bool leaves exact, float leaves within rtol 1e-5;
        returns the largest float difference."""
        sk, sp = numpy_fields(state_k), numpy_fields(state_p)
        max_err = 0.0
        for name in sp:
            a, b = sk[name], sp[name]
            if a.dtype.kind == "f":
                if not np.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, equal_nan=True):
                    raise AssertionError(f"{tag}: float state {name} differs")
                finite = np.isfinite(a) & np.isfinite(b)
                if finite.any():
                    max_err = max(max_err, float(np.abs(a[finite] - b[finite]).max()))
            elif not np.array_equal(a, b):
                raise AssertionError(f"{tag}: state {name} differs")
        return max_err

    def compare_results(tag, rk, rp, check_iters=True):
        kk, kp = rk.kind.cpu().numpy(), rp.kind.cpu().numpy()
        ik, ip = rk.index.cpu().numpy(), rp.index.cpu().numpy()
        if not (np.array_equal(kk, kp) and np.array_equal(ik, ip)):
            bad = np.flatnonzero((kk != kp) | (ik != ip))
            raise AssertionError(f"{tag}: kind/index differ at rows {bad[:10].tolist()}")
        max_err = compare_state(tag, rk.state, rp.state)
        if check_iters:
            if tuple(int(x) for x in rk.iters) != tuple(int(x) for x in rp.iters):
                raise AssertionError(f"{tag}: iters differ {rk.iters} vs {rp.iters}")
        return max_err

    def iters_of(result):
        return dict(zip(IterCounts._fields, (int(x) for x in result.iters)))

    def compare_relax(tag, rk, rp):
        for key in ("kind", "index", "residue_active"):
            if not torch.equal(getattr(rk, key).cpu(), getattr(rp, key).cpu()):
                raise AssertionError(f"{tag}: relax_place {key} differs")
        sk, sp = [int(x) for x in rk.stats], [int(x) for x in rp.stats]
        if sk != sp:
            raise AssertionError(f"{tag}: relax_place stats {sk} != plain {sp}")
        return compare_state(f"{tag} relax_place", rk.state, rp.state)

    def compare_relax2(tag, rk, rp):
        """The convex mode against its plain version: every stat exact (the
        two float stats bit for bit), then as compare_relax."""
        sk, sp = R2.host_stats(rk.stats), R2.host_stats(rp.stats)
        if sk != sp:
            raise AssertionError(f"{tag}: relax2 stats {sk} != plain {sp}")
        return compare_relax(f"{tag} convex", rk._replace(stats=()), rp._replace(stats=()))

    weights = ordering.lane_weights_static()  # the committed artifact's lane head

    # -- 1. kernel vs plain -------------------------------------------------
    t_phase = time.perf_counter()
    log("phase 1: kernels vs plain PyTorch on the card")
    corpora = [
        ("chain-2000", W.chain_workload(2000), 128),
        ("chain-2003", W.chain_workload(2003), 128),
        # chain commits through every branch (waterfill, round, spread
        # mini-scan), and the most spread commits
        ("chain-3000", W.chain_workload(3000), 128),
        ("chain-3003", W.chain_workload(3003), 128),
        # no kernel shape limit: K = 64 keys; V = 2,560 lanes (W = 80 words)
        ("wide-keys", W.wide_keys_workload(), 32),
        ("wide-lanes", W.wide_lanes_workload(), 32),
        ("chain-2001-overflow", W.chain_workload(2001), 8),
        ("fuzz-1", W.fuzz_workload(1), 32),
        ("fuzz-5", W.fuzz_workload(5), 32),
        ("fuzz-6", W.fuzz_workload(6), 32),
        ("bounds-0", W.bounds_workload(0), 32),
        ("topology-0", W.topology_workload(0), 64),
        ("topology-3", W.topology_workload(3), 32),
        ("topology-4", W.topology_workload(4), 32),
        ("diverse-300", W.diverse_workload(300, 40, seed=7), 32),
        # 256 claim slots mint 256 hostname lanes: V=256, 8 lane words
        ("diverse-300-wide", W.diverse_workload(300, 40, seed=7), 256),
        # phase 1: its groups overflow 8 claim slots; its rounding ladder
        # demotes pods; Gt/Lt bounds and existing nodes with eligible pods
        ("diverse-300-overflow", W.diverse_workload(300, 40, seed=7), 8),
        ("homogeneous-48", W.homogeneous_workload(48), 32),
        ("bounds-0-free", W.bounds_workload(0, with_nodes=False), 32),
        ("relax-fuzz-6", W.relax_fuzz_workload(6), 32),
    ]
    vol_wl, vol_sets = W.volume_workload(0)
    corpora = [(tag, wl, slots, None) for tag, wl, slots in corpora]
    corpora.append(("volumes-0", vol_wl, 32, vol_sets))
    ffd_err = relax_err = relax2_err = score_err = 0.0
    attr_err = 0
    saw = {"nodes": False, "bounded": False, "noslot": False, "ports": False, "volumes": False,
           "phase1-bounded": False, "phase1-nodes": False, "ladder-demotes": False, "slot-overflow": False,
           "chain-commits": False, "keys>32": False, "lanes>2048": False,
           "convex-placed": False, "convex-demoted": False, "convex-overflow": False, "scored-requeue": False}
    families = 0  # gate families the attribute kernel saw fail, over all corpora
    for tag, wl, slots, vols in corpora:
        host = encode(wl, slots, pod_volumes=vols)
        prob = problem_to_torch(host, dev)
        bf = problem_bounds_free(prob)
        saw["nodes"] |= prob.num_nodes > 0
        saw["bounded"] |= not bf
        saw["ports"] |= bool(host.pod_ports.any())
        saw["volumes"] |= bool(host.pod_vol_counts.any())
        rk = solve_ffd_sweeps(prob, slots)
        rp = sweeps_plain(prob, initial_state(prob, slots), bf)
        torch.cuda.synchronize()
        ffd_err = max(ffd_err, compare_results(f"{tag} sweeps", rk, rp))
        saw["noslot"] |= bool((rk.kind == 4).any())
        saw["chain-commits"] |= int(rk.iters.chain_commits) > 0
        saw["keys>32"] |= prob.num_keys > 32
        saw["lanes>2048"] |= prob.num_lanes > 2048
        # the explain pass over every active row against the final state
        rows = torch.nonzero(prob.pod_active).reshape(-1)
        aprob, astate = _lane_align(prob, rk.state)
        wk_, work_ = launch_attribute(aprob, astate, rows)
        wp_ = attribute_plain(prob, rk.state, rows)
        # every row attributed (the problem without its byte-identity runs)
        wa_, work_all = launch_attribute(dataclasses.replace(aprob, pod_eqprev=None), astate, rows)
        torch.cuda.synchronize()
        if not (torch.equal(wk_.cpu(), wp_.cpu()) and torch.equal(wa_.cpu(), wp_.cpu())):
            raise AssertionError(f"{tag}: attribute words differ from plain")
        # the comparison counters (every entry's gates, every listed type)
        # do not depend on the row plan; the needed work is at most theirs
        wd = dict(zip(ATTR_WORK_COUNTERS, work_.cpu().tolist()))
        wa = dict(zip(ATTR_WORK_COUNTERS, work_all.cpu().tolist()))
        if (any(wd[k] != wa[k] for k in ("entry_gates", "listed_type_tests")) or wa["bin_gates"] != wa["entry_gates"]
                or wd["bin_gates"] > wa["bin_gates"] or wa["type_tests"] > wa["listed_type_tests"]
                or wd["type_tests"] > wa["type_tests"]):
            raise AssertionError(f"{tag}: attribute work counters disagree between the row plans ({wd} against {wa})")
        if rows.numel():
            attr_err = max(attr_err, int((wk_.cpu().long() - wp_.cpu().long()).abs().max()))
        for word in wk_[:, 0].cpu().tolist():
            families |= (word | word >> 8 | word >> 16) & 0x7F
        if tag in ("wide-keys", "wide-lanes"):
            # runs_screen at the same shapes: two stacked lanes, 1 and 3 passes
            batch = mesh.stack_problems([prob, prob])
            for passes in (1, 3):
                sk = mesh.batched_screen(batch, slots, passes)
                sp = mesh.batched_screen_plain(batch, slots, passes)
                torch.cuda.synchronize()
                if not (torch.equal(sk.kind.cpu(), sp.kind.cpu()) and torch.equal(sk.index.cpu(), sp.index.cpu())):
                    raise AssertionError(f"{tag}: runs_screen kind/index differ from plain ({passes} passes)")
                compare_state(f"{tag} runs_screen {passes} passes", sk.state, sp.state)
        # one-pass mode, twice: fresh, then carrying the first pass's state
        ok1 = solve_ffd(prob, slots)
        op1 = solve_ffd_plain(prob, initial_state(prob, slots), bf)
        ffd_err = max(ffd_err, compare_results(f"{tag} one-pass", ok1, op1, check_iters=False))
        ok2 = solve_ffd(prob, slots, init=op1.state)
        op2 = solve_ffd_plain(prob, op1.state, bf)
        ffd_err = max(ffd_err, compare_results(f"{tag} one-pass carried", ok2, op2, check_iters=False))
        # phase 1, then the repair pass carrying it
        xk = RX.relax_place(prob, slots)
        xp = RX.relax_place_plain(prob, slots)
        relax_err = max(relax_err, compare_relax(tag, xk, xp))
        eligible, placed, demoted, claims = (int(x) for x in xp.stats)
        if placed > 0:
            res = dataclasses.replace(prob, pod_active=xp.residue_active)
            ck = solve_ffd_sweeps_carried(res, slots, init=(xp.state, xp.kind, xp.index))
            ares, astate = _lane_align(res, xp.state)
            cp = sweeps_plain(ares, astate, problem_bounds_free(ares), xp.kind, xp.index)
            ffd_err = max(ffd_err, compare_results(f"{tag} carried", ck, cp))
            saw["phase1-bounded"] |= not bf
            saw["phase1-nodes"] |= prob.num_nodes > 0
        saw["ladder-demotes"] |= demoted > 0 and claims < slots
        saw["slot-overflow"] |= demoted > 0 and claims == slots
        # the convex phase 1 (program 17): relax_place's convex mode
        yk = R2.launch_relax2_place(_pad_lanes_mult32(prob), slots, R2.pgd_iters(), R2.pgd_step())
        yp = R2.relax2_place_plain(prob, slots)
        relax2_err = max(relax2_err, compare_relax2(tag, yk, yp))
        ys = R2.host_stats(yp.stats)
        saw["convex-placed"] |= ys.placed > 0
        saw["convex-demoted"] |= ys.round_demoted > 0
        saw["convex-overflow"] |= ys.overflow > 0
        # the learned order (program 6): lane_scores, then the scored loop
        sk = POL.launch_lane_scores(_pad_lanes_mult32(prob), weights)[0]
        sp = POL.lane_scores_plain(prob, weights)
        torch.cuda.synchronize()
        score_err = max(score_err, float((sk.cpu() - sp.cpu()).abs().max()))
        if score_err > SCORE_ATOL:
            raise AssertionError(f"{tag}: lane_scores differ from plain by {score_err}")
        if tag in SCORED_CORPORA:
            rks = solve_ffd_sweeps(prob, slots, order_scores=sk)
            rps = sweeps_plain(prob, initial_state(prob, slots), bf, order_scores=sk)
            ffd_err = max(ffd_err, compare_results(f"{tag} scored", rks, rps))
            saw["scored-requeue"] |= int(rks.iters.sweeps) > 1
        log(f"  {tag}: pods={len(wl[0])} P={prob.num_pods} C={slots} N={prob.num_nodes} "
            f"K={prob.num_keys} V={prob.num_lanes} G={prob.num_groups} "
            f"bounds_free={bf} iters={tuple(int(x) for x in rk.iters)} "
            f"kinds={np.bincount(rk.kind.cpu().numpy(), minlength=5).tolist()} "
            f"phase1 eligible/placed/demoted/claims={eligible}/{placed}/{demoted}/{claims} "
            f"convex placed/round-demoted/overflow={ys.placed}/{ys.round_demoted}/{ys.overflow} ok")
    ffd_err = max(ffd_err, wave_kernels_phase(dev, encode, compare_results, weights))
    missing = [k for k, v in saw.items() if not v]
    if missing:
        raise AssertionError(f"phase 1 corpora do not cover: {missing}")
    if families != 0x7F:
        raise AssertionError(f"attribute: the corpora make only families {families:#x} of 0x7f fail")
    log("  attribute == plain on every corpus; every gate family failed somewhere")
    log(f"  relax_place convex mode == plain on every corpus; lane_scores within {score_err:.3g} of plain; "
        f"scored ffd_loop == plain on {', '.join(SCORED_CORPORA)}")

    # whole solves with each flag on: the kernel path against the plain CPU path
    for tag, wl in (("homogeneous-48", W.homogeneous_workload(48)), ("fuzz-1", W.fuzz_workload(1))):
        for env in ({"KARPENTER_TPU_RELAX2": "1"}, {"KARPENTER_TPU_ORDER_POLICY": "1"}):
            os.environ.update(env)
            try:
                sg = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=dev, relax=False)
                rg = sg.solve(*wl)
                sc = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False)
                rc = sc.solve(*wl)
            finally:
                for name in env:
                    os.environ.pop(name, None)
            drop = lambda d: d and {k: v for k, v in d.items() if k != "phase_s"}  # noqa: E731
            if (rg.new_claims, rg.node_pods, rg.failures) != (rc.new_claims, rc.node_pods, rc.failures) \
                    or drop(sg.last_relax2) != drop(sc.last_relax2) or sg.last_iters != sc.last_iters:
                raise AssertionError(f"{tag} {env}: TorchSolver on cuda differs from the plain CPU path")
            log(f"  solve {tag} {env}: cuda == cpu ({rg.num_scheduled()}/{len(wl[0])} scheduled, "
                f"convex {drop(sg.last_relax2)}, iters {sg.last_iters})")

    # whole solves: the kernel path against the plain CPU path, with the
    # two-phase solve on (the default) and off
    gate_cases = []
    for tag, wl, vols in (("fuzz-1", W.fuzz_workload(1), None),
                          ("topology-0", W.topology_workload(0), None),
                          ("bounds-0", W.bounds_workload(0), None),
                          ("chain-2000", W.chain_workload(2000), None),
                          ("homogeneous-48", W.homogeneous_workload(48), None),
                          ("diverse-300", W.diverse_workload(300, 40, seed=7), None),
                          ("volumes-0", vol_wl, vol_sets)):
        pods, its, tpls, nodes = wl
        for relax in (True, False):
            sg = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=dev, relax=relax)
            rg = sg.solve(pods, its, tpls, nodes, pod_volumes=vols)
            sc = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=relax)
            rc = sc.solve(pods, its, tpls, nodes, pod_volumes=vols)
            if (rg.new_claims, rg.node_pods, rg.failures) != (rc.new_claims, rc.node_pods, rc.failures):
                raise AssertionError(f"{tag} relax={relax}: TorchSolver on cuda differs from the plain CPU path")
            if (sg.last_relax, sg.relax_fallbacks) != (sc.last_relax, sc.relax_fallbacks):
                raise AssertionError(f"{tag} relax={relax}: phase 1 {sg.last_relax} != plain {sc.last_relax}")
            if rg.verify_ctx is not None and not relax:
                gate_cases.append((tag, wl, rg))
            log(f"  solve {tag} relax={relax}: cuda == cpu ({rg.num_scheduled()}/{len(pods)} scheduled, "
                f"phase 1 {sg.last_relax})")

    # gate: clean and corrupted results, kernel counts == plain counts
    def corruptions(gp, ga):
        """(name, gp, ga) variants that each trip one invariant (others may
        trip too); a variant whose precondition the result lacks is left out."""
        C = ga.claim_tpl.shape[0]
        pod_bin = ga.pod_bin.cpu().numpy()
        placed = np.flatnonzero(pod_bin >= 0)
        on_claims = pod_bin[(pod_bin >= 0) & (pod_bin < C)]
        c0 = int(np.bincount(on_claims).argmax())  # the fullest claim
        on_c0 = np.flatnonzero(pod_bin == c0)
        p0 = int(on_c0[0])
        out = []
        rep = ga.claim_reported.clone()
        rep[c0, 0] += 1.0
        out.append(("claim-requests", gp, ga._replace(claim_reported=rep)))
        out.append(("claim-capacity", gp._replace(it_alloc=torch.full_like(gp.it_alloc, -1.0)), ga))
        out.append(("instance-type-survivor", gp, ga._replace(claim_its=torch.ones_like(ga.claim_its))))
        tol = gp.pod_tol_tpl.clone()
        tol[placed] = False
        tn = gp.pod_tol_node.clone()
        tn[placed] = False
        out.append(("taint-admissibility", gp._replace(pod_tol_tpl=tol, pod_tol_node=tn), ga))
        if len(on_c0) >= 2:
            ports, conf = gp.pod_ports.clone(), gp.pod_port_conflict.clone()
            ports[on_c0[0], 0] = True
            conf[on_c0[1], 0] = True
            out.append(("host-port", gp._replace(pod_ports=ports, pod_port_conflict=conf), ga))
        # requirement-intersection: the claim publishes an empty zone set
        # while its first pod requires a zone
        zone = 0
        cr, pr = ga.claim_req, gp.pod_reqs
        cadm, ccomp, cdef = cr.admitted.clone(), cr.comp.clone(), cr.defined.clone()
        cadm[c0, zone] = False
        ccomp[c0, zone] = False
        cdef[c0, zone] = True
        padm, pcomp, pdef = pr.admitted.clone(), pr.comp.clone(), pr.defined.clone()
        padm[p0, zone] = gp.lane_valid[zone]
        pcomp[p0, zone] = False
        pdef[p0, zone] = True
        chk = ga.pod_check.clone()
        chk[p0] = True
        out.append(("requirement-intersection",
                    gp._replace(pod_reqs=type(pr)(padm, pcomp, pr.gt, pr.lt, pdef)),
                    ga._replace(claim_req=type(cr)(cadm, ccomp, cr.gt, cr.lt, cdef), pod_check=chk)))
        if (pod_bin >= C).any():
            out.append(("node-capacity", gp._replace(node_avail=torch.zeros_like(gp.node_avail)), ga))
        return out

    tripped = set()
    gate_err = 0
    for tag, (pods, its, tpls, nodes), result in gate_cases:
        gp, ga, bf = _build_args(result.verify_ctx, result, pods, None)
        cases = [("clean", gp, ga)] + corruptions(gp, ga)
        for name, g1, a1 in cases:
            cp = gdev.gate_counts_plain(g1, a1, bf).cpu().numpy()
            for blocks in GATE_CLUSTERS:
                with forced_cluster(blocks):
                    ck = gdev.launch_gate_counts(g1, a1).cpu().numpy()
                gate_err = max(gate_err, int(np.abs(ck.astype(np.int64) - cp).max()))
                if not np.array_equal(ck, cp):
                    raise AssertionError(f"gate {tag}/{name} (cluster {blocks}): kernel {ck.tolist()} != plain "
                                         f"{cp.tolist()}")
            if name == "clean" and ck.any():
                raise AssertionError(f"gate {tag}: clean result counted {ck.tolist()}")
            if name != "clean" and not ck[gdev.INVARIANTS.index(name)]:
                raise AssertionError(f"gate {tag}/{name}: corruption did not trip its invariant")
            tripped.add(name)
        log(f"  gate {tag}: {len(cases)} cases (clean + {len(cases) - 1} corrupted) kernel == plain on clusters "
            f"of {GATE_CLUSTERS} blocks")
    if tripped != {"clean", *gdev.INVARIANTS}:
        raise AssertionError(f"gate corruptions cover only {sorted(tripped)}")

    log(f"  phase 1 wall {time.perf_counter() - t_phase:.1f}s")

    # -- 2. the main path at full width --------------------------------------
    t_phase = time.perf_counter()
    log(f"phase 2: main path, {MAIN_PODS} diverse pods x 400 instance types, 1 NodePool")
    pods, its, tpls, nodes = W.diverse_workload(MAIN_PODS, 400, seed=42)

    def drive(relax):
        """One solve through the entry point a user calls, with the launch
        counts set to 0 just before it and read just after; then the smoke's
        own ``full_gate`` of the result, outside that window."""
        solver = TorchSolver(initial_claim_slots=128, device=dev, relax=relax)
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = solver.solve(pods, its, tpls, nodes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        outcome = full_gate(result, pods, its, tpls, nodes)
        torch.cuda.synchronize()
        if outcome is None or outcome.violations or outcome.counts or outcome.mode != "device":
            raise AssertionError(f"main path relax={relax}: gate rejected or could not run: {outcome}")
        if result.num_scheduled() + len(result.failures) != len(pods):
            raise AssertionError(f"main path relax={relax}: pod accounting broken")
        tm = solver.last_timing
        ctx = result.verify_ctx
        log(f"  relax={relax}: scheduled {result.num_scheduled()}/{len(pods)} claims={len(result.new_claims)} "
            f"escalations={solver.claim_escalations} phase1={solver.last_relax} fallbacks={solver.relax_fallbacks} "
            f"iters={tuple(solver.last_iters)} "
            f"P={ctx.device_problem.num_pods} C={ctx.max_claims} launches={launches}")
        log(f"  relax={relax}: solve wall {wall * 1e3:.1f} ms = encode {tm['encode'] * 1e3:.1f} + relax "
            f"{tm['relax'] * 1e3:.1f} + device {tm['device'] * 1e3:.1f} + decode {tm['decode'] * 1e3:.1f} "
            f"+ gate {tm.get('gate', 0.0) * 1e3:.1f} (+ escalation retries); "
            f"gate: mode={outcome.mode} audited={outcome.audited}")
        return solver, result, launches

    solver, result, launches = drive(True)
    for name in SOLVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    if launches["relax2_place"] or launches["lane_scores"]:
        raise AssertionError(f"main path launched a flag-gated kernel with its flag off: {launches}")
    if solver.relax_fallbacks != 0 or solver.last_relax is None or solver.last_relax["placed"] <= 0:
        raise AssertionError(f"main path: phase 1 did not place or was rejected: {solver.last_relax}, "
                             f"fallbacks {solver.relax_fallbacks}")
    sched = result.num_scheduled()
    solver_off, result_off, launches_off = drive(False)
    # the same two solves again, to separate first-solve costs from the path's
    for relax in (True, False):
        drive(relax)
    # the relax=False solve runs no phase 1 and gates nothing itself
    if launches_off != {**{name: 0 for name in kernels.LAUNCHES}, "ffd_loop": launches_off["ffd_loop"]} \
            or launches_off["ffd_loop"] <= 0 or launches["runs_screen"] != 0 or launches["attribute"] != 0:
        raise AssertionError(f"relax=False path launched {launches_off}")
    if sched != len(pods) or sched < result_off.num_scheduled():
        raise AssertionError(f"main path scheduled {sched}, relax=False {result_off.num_scheduled()} of {len(pods)}")
    ctx = result.verify_ctx
    C = ctx.max_claims
    # the phase-1 input: the solve's padded problem (its context holds the
    # repair pass's residue) with every pod active, as the relax=False solve
    # of the same batch encodes it
    active = result_off.verify_ctx.device_problem.pod_active
    if active.shape != ctx.device_problem.pod_active.shape or int(active.sum()) != len(pods):
        raise AssertionError("main path: the two paths padded the batch differently")
    prob = _pad_lanes_mult32(dataclasses.replace(ctx.device_problem, pod_active=active))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_ms(fn, reps):
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def time_launches(name, arg_sets):
        """The kernel alone: CUDA events around ``kernels.launch`` over
        argument sets built beforehand, one set per launch (the kernels
        update their state in place)."""
        times = []
        for _, args in arg_sets:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kernels.launch(name, args, stream)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def same_verdicts(tag, arg_sets, ref):
        for t, _ in arg_sets:
            if not (torch.equal(t["kind"], ref.kind) and torch.equal(t["index"], ref.index)):
                raise AssertionError(f"{tag}: a timed launch differs from the wrapper's")

    def plain_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # relax_place at the main path's shapes: kernel, plain, their agreement
    rxk = RX.relax_place(prob, C)
    rx_sets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C) for _ in range(10))]
    rx_ms, rx_all = time_launches("relax_place", rx_sets)
    same_verdicts("relax_place", rx_sets, rxk)
    rx_wrap_ms, _ = time_ms(lambda: RX.relax_place(prob, C), 5)
    # the same launch through the lanes mode's kernel at one lane (why the
    # single-lane kernel stays: PERF.md section 6)
    rx_lane_sets = [(lambda x: ((x[0], x[1]), x[2]))(RX.relax_place_lanes_args([prob], C, None)) for _ in range(5)]
    rx_lane_ms, _ = time_launches("relax2_place_lanes", rx_lane_sets)
    for (lanes_t, _), _ in rx_lane_sets:
        if not (torch.equal(lanes_t[0][0]["kind"], rxk.kind) and torch.equal(lanes_t[0][0]["index"], rxk.index)):
            raise AssertionError("relax_place: the one-lane lanes launch differs from the single launch")
    rx_work = dict(zip(RX.WORK_COUNTERS, rxk.work.cpu().tolist()))
    rxp, rx_plain_ms = plain_ms(lambda: RX.relax_place_plain(prob, C))
    relax_err = max(relax_err, compare_relax("main path", rxk, rxp))
    stats = dict(zip(("eligible", "placed", "demoted", "claims"), (int(x) for x in rxk.stats)))
    if stats != solver.last_relax:
        raise AssertionError(f"main path: phase 1 {stats} != the solve's {solver.last_relax}")
    rx_plan = int(rx_sets[0][0]["plan"][0])
    log(f"  relax_place: kernel {rx_ms:.4f} ms median of {[round(t, 4) for t in rx_all]} on a cluster of {rx_plan}; "
        f"wrapper {rx_wrap_ms:.4f} ms; plain {rx_plain_ms:.1f} ms; kernel == plain; {stats}; work {rx_work}; "
        f"the lanes kernel at one lane {rx_lane_ms:.4f} ms (the single launch {rx_ms:.4f} ms, "
        f"{(rx_lane_ms / rx_ms - 1) * 100:+.1f}%); by stage {split_by(RX.SECTIONS, rx_sets[0][0]['sections'], rx_ms)}")
    rx_by_cluster = relax_by_cluster("relax_place waterfill", prob, C, None, rxp, time_launches)

    # ffd_loop in each mode at the main path's shapes, each against its
    # plain loop on the same inputs: the carried repair pass (the main
    # path), the fresh loop (the relax=False path) and one one-pass scan
    residue, astate = _lane_align(dataclasses.replace(prob, pod_active=rxk.residue_active), rxk.state)
    rc_main = solve_ffd_sweeps_carried(residue, C, (rxk.state, rxk.kind, rxk.index))
    k1_sets = [ffd_loop_args(residue, astate, False, rxk.kind, rxk.index) for _ in range(3)]
    k1_ms, k1_all = time_launches("ffd_loop", k1_sets)
    same_verdicts("ffd_loop carried", k1_sets, rc_main)
    k1_wrap_ms, _ = time_ms(lambda: solve_ffd_sweeps_carried(residue, C, (rxk.state, rxk.kind, rxk.index)), 2)
    # the same loop through the lanes mode's kernel at one lane (why the
    # single-lane kernel stays: PERF.md section 6)
    k1_lane_sets = [(lambda x: ((x[0], x[1]), x[2]))(ffd_loop_lanes_args([residue], [astate], [rxk.kind], [rxk.index]))
                    for _ in range(3)]
    k1_lane_ms, k1_lane_all = time_launches("ffd_loop_lanes", k1_lane_sets)
    for (lanes_t, _), _ in k1_lane_sets:
        if not (torch.equal(lanes_t[0]["kind"], rc_main.kind) and torch.equal(lanes_t[0]["index"], rc_main.index)):
            raise AssertionError("ffd_loop carried: the one-lane lanes launch differs from the single launch")
    work = dict(zip(WORK_COUNTERS, rc_main.work.cpu().tolist()))
    rc_plain, k1_plain_ms = plain_ms(lambda: sweeps_plain(residue, astate, problem_bounds_free(residue),
                                                          rxk.kind, rxk.index))
    ffd_err = max(ffd_err, compare_results("main path carried", rc_main, rc_plain))
    log(f"  ffd_loop carried: kernel {k1_ms:.3f} ms median of {[round(t, 3) for t in k1_all]}, wrapper "
        f"{k1_wrap_ms:.3f} ms, plain {k1_plain_ms:.1f} ms, kernel == plain; IterCounts {iters_of(rc_main)} "
        f"(narrow, sweeps, chain commits, chain pods), work {work}; the lanes kernel at one lane {k1_lane_ms:.3f} ms "
        f"median of {[round(t, 3) for t in k1_lane_all]}")

    bf = problem_bounds_free(prob)
    rf_main = solve_ffd_sweeps(prob, C)
    fresh_sets = [ffd_loop_args(prob, initial_state(prob, C), False) for _ in range(3)]
    fresh_ms, fresh_all = time_launches("ffd_loop", fresh_sets)
    same_verdicts("ffd_loop fresh", fresh_sets, rf_main)
    work_fresh = dict(zip(WORK_COUNTERS, rf_main.work.cpu().tolist()))
    rf_plain, fresh_plain_ms = plain_ms(lambda: sweeps_plain(prob, initial_state(prob, C), bf))
    ffd_err = max(ffd_err, compare_results("main path fresh", rf_main, rf_plain))
    log(f"  ffd_loop fresh: kernel {fresh_ms:.3f} ms median of {[round(t, 3) for t in fresh_all]}, "
        f"plain {fresh_plain_ms:.1f} ms, kernel == plain; IterCounts {iters_of(rf_main)}, work {work_fresh}")

    # the one-pass scan (a relax rung's, off the 10k path) at the main path's
    # shapes over its first ONE_PASS_PODS rows, the largest pods: its plain
    # version steps one pod at a time in Python
    op_prob = dataclasses.replace(prob, pod_active=prob.pod_active & (
        torch.arange(prob.pod_active.shape[0], device=dev) < ONE_PASS_PODS))
    ro_main = solve_ffd(op_prob, C)
    op_sets = [ffd_loop_args(op_prob, initial_state(op_prob, C), True) for _ in range(2)]
    op_ms, op_all = time_launches("ffd_loop", op_sets)
    same_verdicts("ffd_loop one-pass", op_sets, ro_main)
    work_one_pass = dict(zip(WORK_COUNTERS, ro_main.work.cpu().tolist()))
    ro_plain, op_plain_ms = plain_ms(lambda: solve_ffd_plain(op_prob, initial_state(op_prob, C), bf))
    ffd_err = max(ffd_err, compare_results("main path one-pass", ro_main, ro_plain, check_iters=False))
    log(f"  ffd_loop one-pass over the first {ONE_PASS_PODS} rows: kernel {op_ms:.3f} ms median of "
        f"{[round(t, 3) for t in op_all]}, plain {op_plain_ms:.1f} ms, kernel == plain; work {work_one_pass}")
    plan = k1_sets[0][0]["plan"].cpu().tolist()
    if plan[0] <= 1:
        raise AssertionError(f"ffd_loop: the main path's launch ran on {plan[0]} block(s), not a cluster")

    # each mode at each cluster size, held to its plain loop bit for bit, and
    # the split of the leader's cycles by section (share x kernel ms); where
    # the plan keeps the type tables resident, the same launches again with
    # them streamed from device memory, to show what residency buys
    def split_of(t, ms):
        return {n: (round(share, 4), round(x, 3)) for n, (share, x) in section_split(t["sections"].cpu(), ms).items()}

    def check_mode(tag, sets, ref, one_pass):
        rk = result_of(sets[0][0], prob.num_lanes, one_pass)
        err = compare_results(tag, rk, ref, check_iters=not one_pass)
        sk, sp = numpy_fields(rk.state), numpy_fields(ref.state)
        for name in sp:  # bit for bit: the same adds in the same order at every cluster size
            if not np.array_equal(sk[name].view(np.uint8), sp[name].view(np.uint8)):
                raise AssertionError(f"{tag}: state {name} differs from plain in its bits")
        same_verdicts(tag, sets, rk)
        return err

    def streamed(sets, cl):
        for _, a in sets:
            dims = {k: getattr(a, k) for k in ("G", "R", "C", "TPL", "K", "W", "O", "T")}
            a.resident, a.smem = 0, smem_bytes(dims, cl, False)
        return sets

    modes = {
        "carried": (lambda: ffd_loop_args(residue, astate, False, rxk.kind, rxk.index), rc_plain, 3),
        "fresh": (lambda: ffd_loop_args(prob, initial_state(prob, C), False), rf_plain, 3),
        "one_pass": (lambda: ffd_loop_args(op_prob, initial_state(op_prob, C), True), ro_plain, 2),
    }
    by_cluster, sections = {}, {}
    for cl in CLUSTER_SIZES:
        row = {}
        for mode, (make, ref, reps) in modes.items():
            try:
                with forced_cluster(cl):
                    sets = [make() for _ in range(reps)]
                ms, all_ms = time_launches("ffd_loop", sets)
            except kernels.KernelDeviceError as e:
                if cl <= 8:
                    raise
                log(f"  ffd_loop at a cluster of {cl}: refused by the card ({e})")
                row = None
                break
            t = sets[0][0]
            ffd_err = max(ffd_err, check_mode(f"ffd_loop {mode} cluster {cl}", sets, ref, mode == "one_pass"))
            row[mode] = {"ms": ms, "plan": t["plan"].cpu().tolist(),
                         "work": dict(zip(WORK_COUNTERS, t["work"].cpu().tolist()))}
            sections[f"{mode}@{cl}"] = split_of(t, ms)
            log(f"  ffd_loop {mode} cluster {cl} (plan {row[mode]['plan']}): {ms:.3f} ms median of "
                f"{[round(x, 3) for x in all_ms]}, == plain; cluster barriers {row[mode]['work']['cluster_barriers']}; "
                f"sections {sections[f'{mode}@{cl}']}")
            if row[mode]["plan"][1]:
                with forced_cluster(cl):
                    ssets = streamed([make() for _ in range(reps)], cl)
                s_ms, s_all = time_launches("ffd_loop", ssets)
                if ssets[0][0]["plan"].cpu().tolist()[1] != 0:
                    raise AssertionError(f"ffd_loop {mode} cluster {cl}: the streamed launch ran resident")
                ffd_err = max(ffd_err, check_mode(f"ffd_loop {mode} cluster {cl} streamed", ssets, ref,
                                                  mode == "one_pass"))
                row[mode]["streamed_ms"] = s_ms
                log(f"  ffd_loop {mode} cluster {cl} streamed: {s_ms:.3f} ms median of "
                    f"{[round(x, 3) for x in s_all]}, == plain (resident {ms:.3f} ms)")
        if row is not None:
            by_cluster[cl] = row

    gp, ga, gbf = _build_args(ctx, result, pods, None)
    cp = gdev.gate_counts_plain(gp, ga, gbf).cpu().numpy()
    k2_plain_ms, _ = time_ms(lambda: gdev.gate_counts_plain(gp, ga, gbf), 3)
    # the solve's own tables, as full_gate hands them to the wrapper
    gtab = ctx.device_tables
    if gtab is None:
        raise AssertionError("main path gate: the solve handed the gate no tables")
    gate_layouts, k2_sets = gate_by_cluster("main path gate", lambda: gdev.gate_counts_args(gp, ga, gtab),
                                           lambda: gdev.launch_gate_counts(gp, ga, gtab), cp, time_ms,
                                           time_launches)
    ck = gdev.launch_gate_counts(gp, ga, gtab).cpu().numpy()
    gate_err = max(gate_err, int(np.abs(ck.astype(np.int64) - cp).max()))
    if not np.array_equal(ck, cp):
        raise AssertionError("main path gate: kernel != plain")
    k2_layout = "cluster%d" % gdev.gate_blocks()
    k2_ms, k2_wrap_ms = gate_layouts[k2_layout]["ms"], gate_layouts[k2_layout]["wrapper_ms"]
    log(f"  gate_counts ({k2_layout}): kernel {k2_ms:.4f} ms, wrapper {k2_wrap_ms:.4f} ms (plain {k2_plain_ms:.3f} ms)")

    # the 10k gate stage (the solve's last_timing["gate"]) by part: the host's
    # GateArgs build, the wrapper (argument build and launch), the kernel,
    # and the rest of full_gate (the host audit and skew checks, the fetch)
    def host_ms(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    g_full = host_ms(lambda: full_gate(result, pods, its, tpls, nodes))
    g_build = host_ms(lambda: _build_args(ctx, result, pods, None))
    g_call = host_ms(lambda: gdev.launch_gate_counts(gp, ga, gtab))
    gate_stage = {"full_gate_ms": g_full, "build_args_ms": g_build, "wrapper_ms": g_call - k2_ms,
                  "kernel_ms": k2_ms, "audit_and_rest_ms": g_full - g_build - g_call,
                  "solve_timing_gate_ms": solver.last_timing.get("gate", 0.0) * 1e3}
    log(f"  the 10k gate stage: full_gate {g_full:.3f} ms = GateArgs build {g_build:.3f} + wrapper "
        f"{g_call - k2_ms:.3f} + kernel {k2_ms:.4f} + audit, skew checks and fetch {g_full - g_build - g_call:.3f} "
        f"(the solve's last_timing gate {gate_stage['solve_timing_gate_ms']:.3f} ms)")

    # bounds: the bytes a launch must move (each of the kernel's inputs read
    # once, each output written once, the state it updates in place read and
    # written, its scratch not counted), and the operations this run's data
    # needs
    def io_bytes(t, state=(), scratch=()):
        total = 0
        for name, x in t.items():
            if x is not None and name not in scratch:
                total += x.numel() * x.element_size() * (2 if name in state else 1)
        return total

    def bound(nbytes_io, int_ops, flt_ops):
        bytes_s = nbytes_io / PEAK_BYTES_S
        ops_s = max(int_ops / PEAK_INT32_OPS_S, flt_ops / PEAK_FP32_OPS_S)
        return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"

    # ffd_loop's operations, from the work counters of a launch (the same
    # work as every timed launch of that mode): per bin gate the merge and
    # the intersect test over K x W packed words; per topology lane of a
    # matched group a compare and a select; per instance-type test the compat
    # words, the offerings and, in float32, an add and a compare per resource
    K, V, T, R = prob.num_keys, prob.num_lanes, prob.num_instance_types, prob.num_resources
    O, Wd, PT = prob.offer_ok.shape[1], prob.num_lanes // 32, prob.pod_ports.shape[1]
    P, N, G, TPL = prob.num_pods, prob.num_nodes, prob.num_groups, prob.num_templates
    D = prob.pod_vol_counts.shape[1]

    def ffd_bound(w, t):
        nbytes_io = io_bytes(t, FFD_STATE, FFD_SCRATCH)
        int_ops = w["bin_gates"] * 2 * K * Wd + w["topo_lanes"] * 2 + w["type_tests"] * (K * Wd + O)
        flt_ops = w["type_tests"] * 2 * R
        return (*bound(nbytes_io, int_ops, flt_ops), nbytes_io, int_ops, flt_ops)

    k1_bound, k1_by, k1_bytes, k1_int_ops, k1_flt_ops = ffd_bound(work, k1_sets[0][0])
    fresh_bound, fresh_by, _, _, _ = ffd_bound(work_fresh, fresh_sets[0][0])
    op_bound, op_by, _, _, _ = ffd_bound(work_one_pass, op_sets[0][0])
    # the latency floor of the cluster design: the leader block's block
    # barriers, each at the cost of a block barrier alone in a block of the
    # loop's size, and its cluster barriers, each at the cost of a cluster
    # barrier alone in a cluster of the loop's size
    probe = kernels.library("ffd_loop").ffd_sync_probe_launch
    probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    n_sync = 100000

    def run_probe(n, cl):
        if probe(n, cl, ctypes.c_void_p(stream)) != 0:
            raise RuntimeError("sync probe: CUDA launch error")

    def barrier_ms(cl):
        run_probe(n_sync, cl)
        return (time_ms(lambda: run_probe(n_sync, cl), 5)[0] - time_ms(lambda: run_probe(0, cl), 5)[0]) / n_sync

    sync_ms = barrier_ms(0)
    cluster_sync_ms = {cl: barrier_ms(cl) for cl in by_cluster}
    k1_latency = work["barriers"] * sync_ms + work["cluster_barriers"] * cluster_sync_ms[plan[0]]
    log(f"  ffd_loop carried: bytes {k1_bytes}, int ops {k1_int_ops:.4g}, float ops {k1_flt_ops:.4g}; "
        f"bound {k1_bound:.5f} ms ({k1_by}); one block barrier {sync_ms * 1e6:.2f} ns, one cluster barrier "
        f"{ {cl: round(x * 1e6, 2) for cl, x in cluster_sync_ms.items()} } ns -> latency floor {k1_latency:.3f} ms "
        f"({work['barriers']} + {work['cluster_barriers']} barriers); fresh bound {fresh_bound:.5f} ms ({fresh_by}), "
        f"one-pass bound {op_bound:.5f} ms ({op_by})")
    # relax_place: operations from its counted instance-type tests (K x W
    # compat words and O offerings in int32, an add and a compare per
    # resource in float32) and record lanes (a test and an add), plus the
    # per-pod screen (ports, groups, node tests, the row compare with the
    # predecessor) and the float32 demand math (max, sum, size: about 6
    # operations per pod and resource)
    rx_bytes = io_bytes(rx_sets[0][0], RX.RELAX_STATE, RX.RELAX_SCRATCH)
    rx_int_ops = (rx_work["type_tests"] * (K * Wd + O) + rx_work["record_lanes"] * 2
                  + P * (2 * PT + 3 * G + 2 + (K * Wd + 4 * K + TPL) + N * (K * Wd + D + 2)))
    rx_flt_ops = rx_work["type_tests"] * 2 * R + P * R * 6 + P * N * 2 * R
    rx_bound, rx_by = bound(rx_bytes, rx_int_ops, rx_flt_ops)
    log(f"  relax_place: bytes {rx_bytes}, int ops {rx_int_ops:.4g}, float ops {rx_flt_ops:.4g}; "
        f"bound {rx_bound:.5f} ms ({rx_by})")
    k2_bytes = io_bytes(k2_sets[0][0], (), gdev.GATE_SCRATCH)
    k2_int_ops = P * (K * (Wd + 3) + 2 * PT) + C * T * (K * Wd + O)
    k2_flt_ops = P * R + C * T * 2 * R
    k2_bound, k2_by = bound(k2_bytes, k2_int_ops, k2_flt_ops)
    # the later phases' latency floors: one launch (the probe's, with no
    # barrier), and the barrier costs above
    LATENCY.update(launch_ms=time_ms(lambda: run_probe(0, 0), 5)[0], sync_ms=sync_ms,
                   cluster_sync_ms=cluster_sync_ms)
    gate_floors(gate_layouts)
    log(f"  gate_counts: bytes {k2_bytes}, int ops {k2_int_ops:.4g}, float ops {k2_flt_ops:.4g}; "
        f"bound {k2_bound:.5f} ms ({k2_by}); one launch {LATENCY['launch_ms']:.4f} ms; latency floor by layout "
        f"{ {k: round(v['latency_floor_ms'], 5) for k, v in gate_layouts.items()} } ms")
    log(f"  phase 2 wall {time.perf_counter() - t_phase:.1f}s")
    rs = consolidation_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound)
    churn_entries, churn = churn_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound)
    stacked = serve_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, (pods, its, tpls, nodes), result)
    attr_entry = explain_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, attr_err)
    relax2_entry, lane_entry = flags_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, compare_results,
                                           compare_relax2, relax2_err, score_err)
    shard_entries, shard = shard_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, compare_results,
                                       compare_relax2)
    main = dict(workload=(pods, its, tpls, nodes), result=result, result_off=result_off, prob=prob, C=C, rxk=rxk,
                residue=residue, astate=astate)
    wave_entry = wavefront_phase(dev, main, time_ms, time_launches, plain_ms, ffd_bound, compare_results)
    provision = provision_phase(dev)
    disruption = disruption_phase(dev, time_ms, time_launches, plain_ms)
    operator = operator_phase(dev)
    rs["launches_disruption_pass"] = disruption["launches"]["runs_screen"]
    streaming = streaming_phase(dev, main, time_ms, time_launches, plain_ms, io_bytes, bound)
    rs["runs_solve"] = streaming.pop("runs_solve")
    rs["launches_runs_solve"] = rs["runs_solve"]["launches"]
    lifecycle = lifecycle_phase(dev, build_s)

    line = {
        "kernels": [
            {
                "name": "ffd_loop",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/ffd_loop.cu",
                "replaces": "karpenter_tpu/ops/ffd_sweeps.py:1922",
                "also_replaces": ["karpenter_tpu/ops/ffd_sweeps.py:1910", "karpenter_tpu/ops/ffd_step.py:483"],
                "launches": launches["ffd_loop"],
                "max_abs_err": ffd_err,
                "ms": k1_ms,
                "plain_ms": k1_plain_ms,
                "bound_ms": k1_bound,
                "bound_by": k1_by,
                "library_ms": None,
                "wrapper_ms": k1_wrap_ms,
                "one_lane_lanes_ms": k1_lane_ms,
                "latency_bound_ms": k1_latency,
                "cluster": plan[0],
                "resident": plan[1],
                "type_slice": plan[2],
                "block_barrier_ns": sync_ms * 1e6,
                "cluster_barrier_ns": {cl: x * 1e6 for cl, x in cluster_sync_ms.items()},
                "by_cluster": by_cluster,
                "sections": sections,
                "work": work,
                "fresh_ms": fresh_ms,
                "fresh_plain_ms": fresh_plain_ms,
                "fresh_bound_ms": fresh_bound,
                "fresh_work": work_fresh,
                "one_pass_pods": ONE_PASS_PODS,
                "one_pass_ms": op_ms,
                "one_pass_plain_ms": op_plain_ms,
                "one_pass_bound_ms": op_bound,
                "one_pass_work": work_one_pass,
                "launches_relax_off": launches_off["ffd_loop"],
                "launches_churn": churn["launches"]["ffd_loop"],
                "iters": iters_of(rc_main),
                "fresh_iters": iters_of(rf_main),
            },
            attr_entry,
            {
                "name": "gate_counts",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/gate_counts.cu",
                "replaces": "karpenter_tpu/verify/device.py:259",
                "launches": launches["gate_counts"],
                "max_abs_err": gate_err,
                "ms": k2_ms,
                "plain_ms": k2_plain_ms,
                "bound_ms": k2_bound,
                "bound_by": k2_by,
                "library_ms": None,
                "wrapper_ms": k2_wrap_ms,
                "launches_relax_off": launches_off["gate_counts"],
                "layout": k2_layout,
                "by_layout": gate_layouts,
                "latency_floor_ms": gate_layouts[k2_layout]["latency_floor_ms"],
                "gate_stage": gate_stage,
                "fleet_partition": shard["gate"],
            },
            {
                "name": "relax_place",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/relax_place.cu",
                "replaces": "karpenter_tpu/ops/relax.py:162",
                "launches": launches["relax_place"],
                "max_abs_err": relax_err,
                "ms": rx_ms,
                "plain_ms": rx_plain_ms,
                "bound_ms": rx_bound,
                "bound_by": rx_by,
                "library_ms": None,
                "wrapper_ms": rx_wrap_ms,
                "one_lane_lanes_ms": rx_lane_ms,
                "cluster": rx_plan,
                "by_cluster": rx_by_cluster,
                "work": rx_work,
                "stats": stats,
                "launches_relax_off": launches_off["relax_place"],
            },
            relax2_entry,
            lane_entry,
            rs,
            *churn_entries,
            stacked,
            *shard_entries,
            wave_entry,
        ],
        "churn": churn,
        "shard": shard,
        "provision": provision,
        "disruption": disruption,
        "operator": operator,
        "streaming": streaming,
        "lifecycle": lifecycle,
    }
    for entry in line["kernels"]:
        if entry["name"] in ("ffd_loop", "relax_place", "gate_counts", "runs_screen"):
            # the kernel's launches over phase 12's cooperative run
            entry["launches_operator"] = operator["launches"][entry["name"]]
        if entry["name"] in ("ffd_loop", "relax_place", "gate_counts"):
            # its launches per warm cycle of phase 13's streams
            entry["launches_warm_cycle"] = {arm: streaming[arm]["launches_per_warm_cycle"][entry["name"]]
                                            for arm in ("relax_off", "relax_on")}
    for entry in line["kernels"]:
        # whether phase 14's restart restored the entry's library from its
        # snapshot (a mode's entry follows its library)
        name = entry["name"]
        lib = kernels._LIBRARY_OF.get(name) or {"relax2_place": "relax_place", "ffd_loop_wavefront": "ffd_loop",
                                               "gate_counts_fused": "gate_counts",
                                               "runs_screen_stacked": "runs_screen"}.get(name, name)
        entry["restored"] = bool(lifecycle["restored"].get(lib, False))
    log(f"smoke wall {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def shard_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, compare_results, compare_relax2):
    """Phase 8: the partitioned solve (KARPENTER_TPU_SHARD, programs 13-14)
    and mesh health with its probe (program 18), with SHARD_ENV: the 100k
    fleet sharded against its unsharded control; the recorded stacks' lanes
    launches against single-lane launches bit for bit and against their
    plain twins on SHARD_PLAIN_LANES; the 10k fleet against the JAX
    package's EXPECT_SHARD; a device loss on the first sharded dispatch,
    recovered through the probe kernel. Returns the ``ffd_loop_lanes``,
    ``relax2_place_lanes`` and ``probe`` entries of the kernels line and the
    phase's summary."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops import relax2 as R2
    from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state
    from karpenter_tpu_torch.ops.padding import claim_axis_bucket
    from karpenter_tpu_torch.ops.ffd_sweeps import (
        FFD_SCRATCH,
        FFD_STATE,
        WORK_COUNTERS,
        ffd_loop_args,
        ffd_loop_lanes_args,
        forced_cluster,
        launch_ffd_loop,
    )
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.solver import mesh_health
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import faults
    from karpenter_tpu_torch.testing import workloads as W
    from karpenter_tpu_torch.verify import device as gdev

    t_phase = time.perf_counter()
    log(f"phase 8: the partitioned solve, {SHARD_PODS} fleet pods x 400 types in {SHARD_PARTITIONS} lanes, "
        f"and mesh health")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def solve(workload, env, entry=None, **solver_args):
        """One solve through the entry point with ``env`` set, the launch
        counts set to 0 just before it and read just after; with ``entry``
        (a parallel.mesh program) its dispatches' arguments are recorded."""
        seen = []
        orig = getattr(M, entry) if entry else None
        if entry:
            def recording(*args, **kwargs):
                seen.append(args)
                return orig(*args, **kwargs)
            setattr(M, entry, recording)
        os.environ.update(env)
        try:
            solver = TorchSolver(device=dev, **solver_args)
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = solver.solve(*workload)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            for name in env:
                os.environ.pop(name, None)
            if entry:
                setattr(M, entry, orig)
        if result.num_scheduled() + len(result.failures) != len(workload[0]):
            raise AssertionError(f"{entry or 'control'}: pod accounting broken")
        return solver, result, wall, launches, seen

    def want_launches(tag, launches, **want):
        expected = {**{name: 0 for name in kernels.LAUNCHES}, **want}
        if launches != expected:
            raise AssertionError(f"{tag}: launched {launches}, not {expected}")

    def served(tag, solver, dispatches, launches, relax2_on):
        info = solver.last_shard
        if info is None or info["reason"] is not None or info["partitions"] != SHARD_PARTITIONS \
                or info["gate_rejections"] or info["lanes"] != SHARD_PARTITIONS:
            raise AssertionError(f"{tag}: the sharded solve did not serve: {info}")
        # every dispatch (the claim ladder's re-dispatches included) one
        # lanes launch of each program, and one gate_counts per partition
        want = dict(ffd_loop_lanes=len(dispatches), gate_counts=SHARD_PARTITIONS)
        if relax2_on:
            want["relax2_place_lanes"] = len(dispatches)
        want_launches(tag, launches, **want)
        return info

    def bits(tag, ra, rb):
        """Two results of the kernel equal bit for bit: verdicts, every state
        leaf, IterCounts. (Not the work counters: the claims x types test
        skips a claim that another warp's survivor already beat, so how many
        type tests run depends on the warps' timing.)"""
        if not (torch.equal(ra.kind, rb.kind) and torch.equal(ra.index, rb.index)):
            raise AssertionError(f"{tag}: kind/index differ")
        sa, sb = numpy_fields(ra.state), numpy_fields(rb.state)
        for key in sb:
            if not np.array_equal(sa[key].view(np.uint8), sb[key].view(np.uint8)):
                raise AssertionError(f"{tag}: state {key} differs")
        ia, ib = getattr(ra, "iters", None), getattr(rb, "iters", None)
        if ia is not None and tuple(int(x) for x in ia) != tuple(int(x) for x in ib):
            raise AssertionError(f"{tag}: IterCounts differ")

    def lanes_bound(ts, works, prob):
        """The lanes launch's bound: every lane's arguments (each read once,
        the state read and written) and the operations every lane's work
        counters record, as phase 2 counts them for ffd_loop."""
        K, R, O = prob.num_keys, prob.num_resources, prob.offer_ok.shape[1]
        Wd = prob.num_lanes // 32
        nbytes = sum(io_bytes(t, FFD_STATE, FFD_SCRATCH) for t in ts)
        w = {k: sum(x[k] for x in works) for k in WORK_COUNTERS}
        int_ops = w["bin_gates"] * 2 * K * Wd + w["topo_lanes"] * 2 + w["type_tests"] * (K * Wd + O)
        flt_ops = w["type_tests"] * 2 * R
        return (*bound(nbytes, int_ops, flt_ops), nbytes, int_ops, flt_ops, w)

    # -- 8.1 the fleet at full width: sharded and its unsharded control ------
    fleet = W.fleet_workload(SHARD_PODS, 400, seed=42, neighborhoods=SHARD_NEIGHBORHOODS)
    gates_seen = []  # every partition's gate arguments, held to plain below
    real_gate = gdev.verify_gate

    def recording_gate(gp, ga, bf, tables=None):
        gates_seen.append((gp, ga, bf))
        return real_gate(gp, ga, bf, tables)

    gdev.verify_gate = recording_gate
    try:
        solver, result, wall, launches, seen = solve(fleet, SHARD_ENV, "shard_sweeps")
    finally:
        gdev.verify_gate = real_gate
    info = served("fleet", solver, seen, launches, False)
    split = dict(solver.last_timing)
    # the control: the unsharded FFD solve (relax off, the JAX package's
    # parity suite's control), starting at the claim bucket of the sharded
    # result's claims, the bucket a warm solver holds (the JAX bench measures
    # both sides after a warm-up solve); a cold start climbs the ladder one
    # re-encode of the whole batch a rung
    ctrl, cres, cwall, claunches, _ = solve(fleet, {"KARPENTER_TPU_EXPLAIN": "0"}, relax=False,
                                            initial_claim_slots=claim_axis_bucket(len(result.new_claims)))
    if ctrl.last_shard is not None:
        raise AssertionError("the control took the shard path")
    # scheduled-set parity where it holds: the partitions share no node,
    # group or finite budget, but a pod with a required pod affinity must
    # join the claim its peers landed in, whose room the unsharded solve
    # shares with every other partition's pods; so the sharded solve keeps
    # every pod the control schedules, and any pod it schedules beyond them
    # carries a required pod affinity (the JAX package's own 10k fleet:
    # 9,862 sharded, 9,829 with its FFD control, 33 affinity pods apart)
    def placed(r):
        return {i for c in r.new_claims for i in c.pod_indices} | {i for v in r.node_pods.values() for i in v}

    def affinity(i):
        a = fleet[0][i].spec.affinity
        return a is not None and a.pod_affinity is not None and bool(a.pod_affinity.required)

    lost, gained = placed(cres) - placed(result), placed(result) - placed(cres)
    if lost or any(not affinity(i) for i in gained):
        raise AssertionError(f"fleet: the sharded solve lost {len(lost)} of the control's pods or gained "
                             f"{sum(not affinity(i) for i in gained)} without a required pod affinity")
    summary = {
        "pods": SHARD_PODS, "partitions": info["partitions"], "part_pods": info["part_pods"],
        "bucket_pods": info["bucket_pods"], "pad_frac": info["pad_frac"], "max_claims": info["max_claims"],
        "dispatches": len(seen), "merged_claims": info["merged_claims"], "narrow_iters": info["narrow_iters"],
        "sweep_iters": info["sweep_iters"], "scheduled": result.num_scheduled(), "claims": len(result.new_claims),
        "wall_s": wall, "split_s": split, "control_wall_s": cwall, "control_split_s": dict(ctrl.last_timing),
        "control_scheduled": cres.num_scheduled(), "affinity_gained": len(gained),
        "control_escalations": ctrl.claim_escalations, "control_claims": len(cres.new_claims),
        "control_launches": claunches, "speedup_vs_control": cwall / wall,
    }
    log(f"  fleet sharded: {result.num_scheduled()}/{SHARD_PODS} scheduled (control {cres.num_scheduled()}: every "
        f"control pod kept, {len(gained)} more, each with a required pod affinity), "
        f"claims {len(result.new_claims)} (control {len(cres.new_claims)}), merged {info['merged_claims']}, "
        f"parts {info['part_pods']}, bucket {info['bucket_pods']}, pad_frac {info['pad_frac']}, max_claims "
        f"{info['max_claims']}, {len(seen)} dispatch(es), narrow {info['narrow_iters']}, sweeps {info['sweep_iters']}; "
        f"launches {launches}")
    log(f"  fleet sharded wall {wall * 1e3:.1f} ms = " + " + ".join(f"{k} {v * 1e3:.1f}" for k, v in split.items())
        + f"; control wall {cwall * 1e3:.1f} ms ({({k: round(v * 1e3, 1) for k, v in ctrl.last_timing.items()})}, "
        f"{ctrl.claim_escalations} escalations, launches {claunches}); speedup_vs_control "
        f"{summary['speedup_vs_control']:.3f}")

    # gate_counts at the partition shape: every partition's gate held to its
    # plain version on every cluster size, the deepest one timed
    deep = max(range(len(gates_seen)), key=lambda i: int((gates_seen[i][1].pod_bin >= 0).sum()))
    for i, (pgp, pga, pbf) in enumerate(gates_seen):
        want = gdev.gate_counts_plain(pgp, pga, pbf).cpu().numpy()
        if i == deep:
            g_rows, _ = gate_by_cluster(f"fleet partition {i} gate", lambda: gdev.gate_counts_args(pgp, pga),
                                       lambda: gdev.launch_gate_counts(pgp, pga), want, time_ms, time_launches)
            g_plain, _ = time_ms(lambda: gdev.gate_counts_plain(pgp, pga, pbf), 3)
            summary["gate"] = {"partitions": len(gates_seen), "timed": i, "rows": int(pgp.pod_requests.shape[0]),
                               "placed": int((pga.pod_bin >= 0).sum()), "claims": int(pga.claim_tpl.shape[0]),
                               "by_layout": g_rows, "plain_ms": g_plain}
            continue
        for blocks in GATE_CLUSTERS:
            with forced_cluster(blocks):
                got = gdev.launch_gate_counts(pgp, pga).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"fleet partition {i} gate (cluster {blocks}): kernel {got.tolist()} != plain")
    log(f"  fleet gates: {len(gates_seen)} partitions, each == plain on clusters of {GATE_CLUSTERS} blocks; partition {deep} "
        f"({summary['gate']['rows']} rows, {summary['gate']['placed']} placed, C = {summary['gate']['claims']}) "
        f"plain {summary['gate']['plain_ms']:.3f} ms")

    # -- 8.2 the lanes launch held: single-lane launches, plain twins ----------
    batch, C = seen[-1][:2]
    problems = M._shard_lanes(batch)
    lanes = M.shard_sweeps(batch, C)
    singles = [launch_ffd_loop(p, initial_state(p, C), one_pass=False) for p in problems]
    for b, (rk, rs) in enumerate(zip(lanes, singles)):
        bits(f"fleet lane {b}", rk, rs)
    plain, lanes_plain_ms = plain_ms(lambda: M.shard_sweeps_plain(batch, C, lanes=SHARD_PLAIN_LANES))
    lanes_err = 0.0
    for b, rp in zip(SHARD_PLAIN_LANES, plain):
        lanes_err = max(lanes_err, compare_results(f"fleet lane {b} plain", lanes[b], rp))
    sets = []
    for _ in range(3):
        ts, buf, args = ffd_loop_lanes_args(problems, [initial_state(p, C) for p in problems])
        sets.append(((ts, buf), args))
    lanes_ms, lanes_all = time_launches("ffd_loop_lanes", sets)
    for (ts, _), _ in sets:
        if any(not (torch.equal(t["kind"], r.kind) and torch.equal(t["index"], r.index)) for t, r in zip(ts, lanes)):
            raise AssertionError("ffd_loop_lanes: a timed launch differs from the wrapper's")
    lanes_wrap_ms, _ = time_ms(lambda: M.shard_sweeps(batch, C), 2)
    iters = [dict(zip(("narrow", "sweeps", "chain_commits", "chain_pods"), (int(x) for x in r.iters))) for r in lanes]
    deepest = max(range(len(lanes)), key=lambda b: iters[b]["narrow"])
    one = [ffd_loop_lanes_args([problems[deepest]], [initial_state(problems[deepest], C)]) for _ in range(3)]
    deep_ms, _ = time_launches("ffd_loop_lanes", [((ts, buf), a) for ts, buf, a in one])
    # the same lane through the single-lane kernel
    deep_sets = [ffd_loop_args(problems[deepest], initial_state(problems[deepest], C), False) for _ in range(3)]
    deep_single_ms, _ = time_launches("ffd_loop", deep_sets)
    for t, _ in deep_sets:
        if not (torch.equal(t["kind"], lanes[deepest].kind) and torch.equal(t["index"], lanes[deepest].index)):
            raise AssertionError("ffd_loop: the deepest lane's single launch differs from its lane")
    works = [dict(zip(WORK_COUNTERS, r.work.cpu().tolist())) for r in lanes]
    l_bound, l_by, l_bytes, l_int, l_flt, l_work = lanes_bound(sets[0][0][0], works, problems[0])
    log(f"  ffd_loop lanes ({len(problems)} x {problems[0].num_pods} rows, C={C}): kernel {lanes_ms:.3f} ms median of "
        f"{[round(x, 3) for x in lanes_all]}, wrapper {lanes_wrap_ms:.3f} ms; its deepest lane ({deepest}, "
        f"{iters[deepest]['narrow']} narrow iterations) alone in a one-lane launch {deep_ms:.3f} ms, in the single-lane "
        f"kernel {deep_single_ms:.3f} ms; control device "
        f"stage {ctrl.last_timing['device'] * 1e3:.1f} ms; == {len(singles)} single-lane launches bit for bit, == plain "
        f"on lanes {list(SHARD_PLAIN_LANES)} ({lanes_plain_ms:.1f} ms); IterCounts {iters}; work {l_work}; bytes "
        f"{l_bytes}, int ops {l_int:.4g}, float ops {l_flt:.4g}; bound {l_bound:.5f} ms ({l_by})")

    # -- 8.3 program 14 on the fleet -----------------------------------------
    r2_env = {**SHARD_ENV, "KARPENTER_TPU_RELAX2": "1"}
    s2, res2, wall2, launches2, seen2 = solve(fleet, r2_env, "shard_relax2_sweeps")
    info2 = served("fleet relax2", s2, seen2, launches2, True)
    r2 = s2.last_relax2
    if r2 is None or r2["reason"] is not None or not r2["sharded"] or r2["lanes"] != SHARD_PARTITIONS:
        raise AssertionError(f"fleet relax2: the convex phase did not serve: {r2}")
    batch2, C2, iters2, step2 = seen2[-1][:4]
    probs2 = M._shard_lanes(batch2)
    outs = R2.launch_relax2_place_lanes(probs2, C2, iters2, step2)
    results2, stats2 = M.shard_relax2_sweeps(batch2, C2, iters2, step2)
    r2_err = 0.0
    for b, p in enumerate(probs2):
        single = R2.launch_relax2_place(p, C2, iters2, step2)
        for key in ("kind", "index", "residue_active"):
            if not torch.equal(getattr(outs[b], key), getattr(single, key)):
                raise AssertionError(f"fleet relax2 lane {b}: convex {key} differs from a single launch")
        bits(f"fleet relax2 lane {b} convex", outs[b], single)
        if not R2.host_stats(outs[b].stats) == R2.host_stats(single.stats) == R2.host_stats(stats2[b]):
            raise AssertionError(f"fleet relax2 lane {b}: stats differ from a single launch")
        residue, state = _lane_align(dataclasses.replace(p, pod_active=single.residue_active), single.state)
        carried = launch_ffd_loop(residue, state, one_pass=False, kind0=single.kind, index0=single.index)
        bits(f"fleet relax2 lane {b} carried", results2[b], carried)
    (plain2, pstats2), r2_plain_ms = plain_ms(
        lambda: M.shard_relax2_sweeps_plain(batch2, C2, iters2, step2, lanes=SHARD_PLAIN_LANES))
    for b, rp, sp in zip(SHARD_PLAIN_LANES, plain2, pstats2):
        r2_err = max(r2_err, compare_relax2(f"fleet relax2 lane {b}", outs[b], R2.relax2_place_plain(
            probs2[b], C2, iters2, step2)))
        r2_err = max(r2_err, compare_results(f"fleet relax2 lane {b} carried plain", results2[b], rp))
        if R2.host_stats(sp) != R2.host_stats(stats2[b]):
            raise AssertionError(f"fleet relax2 lane {b}: stats {R2.host_stats(stats2[b])} != plain")
    r2_sets = [(lambda x: ((x[0], x[1]), x[2]))(RX.relax_place_lanes_args(probs2, C2, (iters2, step2)))
               for _ in range(3)]
    r2_ms, r2_all = time_launches("relax2_place_lanes", r2_sets)
    r2_wrap_ms, _ = time_ms(lambda: R2.launch_relax2_place_lanes(probs2, C2, iters2, step2), 3)
    # lane ``deepest`` alone: a one-lane lanes launch and the single launch
    cv = (iters2, step2)
    r2_one_ms, _ = time_launches("relax2_place_lanes", [
        (lambda x: ((x[0], x[1]), x[2]))(RX.relax_place_lanes_args([probs2[deepest]], C2, cv)) for _ in range(5)])
    r2_single_ms, _ = time_launches("relax_place", [
        (t, a) for t, _, a in (RX.relax_place_args(probs2[deepest], C2, cv) for _ in range(5))])
    r2_plan = int(r2_sets[0][0][0][0][0]["plan"][0])

    def lanes_split(lanes_t, ms):
        # the slowest lane's split (the launch waits for it)
        per = [int(t["sections"].sum()) for t, _ in lanes_t]
        return split_by(RX.SECTIONS, lanes_t[per.index(max(per))][0]["sections"], ms)

    r2_sections = lanes_split(r2_sets[0][0][0], r2_ms)
    # the convex lanes at each cluster size, each lane held bit for bit to the
    # default launch's (itself held to single launches and to plain)
    r2_by_cluster = {}
    for cl in CLUSTER_SIZES:
        try:
            with forced_cluster(cl):
                csets = [(lambda x: ((x[0], x[1]), x[2]))(RX.relax_place_lanes_args(probs2, C2, cv)) for _ in range(2)]
            c_ms2, c_all2 = time_launches("relax2_place_lanes", csets)
        except kernels.KernelDeviceError as e:
            if cl <= 8:
                raise
            log(f"  relax_place convex lanes at a cluster of {cl}: refused by the card ({e})")
            continue
        for (lanes_t, _), _ in csets:
            for b, ((t, st), p) in enumerate(zip(lanes_t, probs2)):
                if int(t["plan"][0]) != cl:
                    raise AssertionError(f"fleet relax2 lane {b}: planned at {cl}, ran on {int(t['plan'][0])}")
                out = RX._relax_out(t, st, p.num_lanes, cv)
                relax_bits(f"fleet relax2 lane {b} cluster {cl}", out._replace(stats=R2.stats_of(out.stats)), outs[b])
        r2_by_cluster[cl] = {"ms": c_ms2, "sections": lanes_split(csets[0][0][0], c_ms2)}
        log(f"  relax_place convex lanes cluster {cl}: {c_ms2:.4f} ms median of {[round(x, 4) for x in c_all2]}, "
            f"every lane == the default launch bit for bit; the slowest lane by stage {r2_by_cluster[cl]['sections']}")
    c_sets = []
    for _ in range(2):
        al = [_lane_align(dataclasses.replace(p, pod_active=o.residue_active), o.state) for p, o in zip(probs2, outs)]
        ts, buf, args = ffd_loop_lanes_args([a for a, _ in al], [s for _, s in al], [o.kind for o in outs],
                                            [o.index for o in outs])
        c_sets.append(((ts, buf), args))
    c_ms, _ = time_launches("ffd_loop_lanes", c_sets)
    r2_work = {k: sum(int(t["work"][i]) for (t, _) in r2_sets[0][0][0]) for i, k in enumerate(RX.WORK_COUNTERS)}
    K, R, O = probs2[0].num_keys, probs2[0].num_resources, probs2[0].offer_ok.shape[1]
    Wd, P2 = probs2[0].num_lanes // 32, probs2[0].num_pods
    r2_bytes = sum(io_bytes(t, RX.RELAX_STATE, RX.RELAX_SCRATCH) for t, _ in r2_sets[0][0][0])
    r2_int = r2_work["type_tests"] * (K * Wd + O) + r2_work["record_lanes"] * 2
    r2_flt = r2_work["type_tests"] * 2 * R + len(probs2) * P2 * R * 6 + r2_work["pgd_columns"] * PGD_COLUMN_OPS
    r2_bound, r2_by = bound(r2_bytes, r2_int, r2_flt)
    summary["relax2"] = {"wall_s": wall2, "split_s": dict(s2.last_timing), "scheduled": res2.num_scheduled(),
                         "claims": len(res2.new_claims), "merged_claims": info2["merged_claims"],
                         "dispatches": len(seen2), "relax2": r2, "carried_ms": c_ms,
                         "narrow_iters": info2["narrow_iters"], "sweep_iters": info2["sweep_iters"]}
    log(f"  fleet relax2 sharded: {res2.num_scheduled()}/{SHARD_PODS} scheduled, claims {len(res2.new_claims)}, "
        f"merged {info2['merged_claims']}, wall {wall2 * 1e3:.1f} ms {({k: round(v * 1e3, 1) for k, v in s2.last_timing.items()})}, "
        f"launches {launches2}; summed Relax2Stats {r2}")
    log(f"  relax_place convex lanes: kernel {r2_ms:.4f} ms median of {[round(x, 4) for x in r2_all]} on clusters of "
        f"{r2_plan}, wrapper {r2_wrap_ms:.4f} ms, lane {deepest} alone {r2_one_ms:.4f} ms in a one-lane launch (the "
        f"single launch {r2_single_ms:.4f} ms, {(r2_one_ms / r2_single_ms - 1) * 100:+.1f}%); the slowest lane by stage "
        f"{r2_sections}; "
        f"== single convex launches and their carried loops bit for bit, == plain on lanes "
        f"{list(SHARD_PLAIN_LANES)} (convex + carried {r2_plain_ms:.1f} ms); carried lanes launch {c_ms:.3f} ms; "
        f"work {r2_work}; bytes {r2_bytes}; bound {r2_bound:.5f} ms ({r2_by})")

    # -- 8.4 the 10k fleet against the JAX package ----------------------------
    small = W.fleet_workload(SHARD_CHECK_PODS, 400, seed=42, neighborhoods=SHARD_NEIGHBORHOODS)
    for tag, env in (("fresh", SHARD_ENV), ("relax2", r2_env)):
        s, r, w, ln, disp = solve(small, env, "shard_relax2_sweeps" if tag == "relax2" else "shard_sweeps")
        served(f"10k {tag}", s, disp, ln, tag == "relax2")
        ls = s.last_shard
        got = {"scheduled": r.num_scheduled(), "claims": len(r.new_claims), "merged_claims": ls["merged_claims"],
               "part_pods": sorted(ls["part_pods"]), "reason": ls["reason"], "max_claims": ls["max_claims"],
               "narrow_iters": ls["narrow_iters"], "sweep_iters": ls["sweep_iters"]}
        want = {k: v for k, v in EXPECT_SHARD[tag].items() if k != "relax2"}
        if got != want:
            raise AssertionError(f"10k fleet {tag}: {got} != the JAX package's {want}")
        if tag == "relax2":
            exp, info = EXPECT_SHARD["relax2"]["relax2"], s.last_relax2
            ints = {k: info[k] for k in ("eligible", "placed", "demoted", "claims", "pgd_iterations")}
            ints.update(overflow=info["rounding"]["overflow"], round_demoted=info["rounding"]["demoted"])
            if ints != {k: v for k, v in exp.items() if k not in ("residual", "capviol")} or not np.allclose(
                    [info["residual"], info["capviol"]], [exp["residual"], exp["capviol"]], rtol=STAT_RTOL,
                    atol=FLOAT_ATOL):
                raise AssertionError(f"10k fleet relax2: stats {info} != the JAX package's {exp}")
        summary[f"check_{tag}"] = {**got, "wall_s": w}
        log(f"  10k fleet {tag}: {got} == the JAX package's; wall {w * 1e3:.1f} ms")

    # -- 8.5 mesh health: a lost device, recovered through the probe ---------
    _, ctrl_small, _, _, _ = solve(small, {"KARPENTER_TPU_EXPLAIN": "0"})
    health_env = {**SHARD_ENV, "KARPENTER_TPU_MESH_HEALTH": "1", "KARPENTER_TPU_FAULTS": "device[0].loss@1"}
    mesh_health.reset()
    faults.clear()
    try:
        s, r, w, ln, _ = solve(small, health_env)
        if s.last_shard != {"reason": "single-device", "recarves": 1}:
            raise AssertionError(f"mesh health: the lost device did not stand the shard path down: {s.last_shard}")
        if r.num_scheduled() != ctrl_small.num_scheduled():
            raise AssertionError(f"mesh health: the unsharded path scheduled {r.num_scheduled()}, "
                                 f"the control {ctrl_small.num_scheduled()}")
        tr = mesh_health.tracker()
        os.environ["KARPENTER_TPU_MESH_HEALTH"] = "1"
        kernels.reset_launches()
        states = [tr.probe(force=True), tr.probe(force=True)]
        torch.cuda.synchronize()
        probe_launches = kernels.LAUNCHES["probe"]
        if states != [{0: mesh_health.STATE_PROBATION}, {0: mesh_health.STATE_HEALTHY}] or probe_launches != 2:
            raise AssertionError(f"mesh health: the probes gave {states}, {probe_launches} probe launches")
        reasons = [x["reason"] for x in tr.snapshot()["recarves"]]
        if reasons != [mesh_health.REASON_DEVICE_LOST, mesh_health.REASON_RECOVERED]:
            raise AssertionError(f"mesh health: recarves {reasons}")
        s2h, r2h, w2h, ln2h, disp = solve(small, {**SHARD_ENV, "KARPENTER_TPU_MESH_HEALTH": "1"}, "shard_sweeps")
        served("mesh health recovered", s2h, disp, ln2h, False)
        recovery_s = tr.last_recovery_s
        if recovery_s is None or tr.snapshot()["recovery_pending"]:
            raise AssertionError("mesh health: the recovery clock did not close")
    finally:
        os.environ.pop("KARPENTER_TPU_MESH_HEALTH", None)
        os.environ.pop("KARPENTER_TPU_FAULTS", None)
        faults.clear()
        mesh_health.reset()
    summary["mesh_recovery_s"] = recovery_s
    log(f"  mesh health: device[0].loss@1 -> standdown single-device, recarves 1, unsharded served "
        f"{r.num_scheduled()} (== control); 2 forced probes (2 probe launches) -> probation, healthy; the next "
        f"sharded solve served; mesh_recovery_s {recovery_s:.3f}")

    # the probe kernel alone, against its plain sum
    x = torch.arange(gdev.PROBE_VALUES, dtype=torch.float32, device=dev)
    pk = gdev.launch_probe(x)
    pp = gdev.probe_sum_plain(x)
    if not (float(pk.cpu()[0]) == float(pp.cpu()[0]) == 120.0):
        raise AssertionError(f"probe: kernel {pk} plain {pp}")
    p_err = abs(float(pk.cpu()[0]) - float(pp.cpu()[0]))
    rng = np.random.default_rng(18)
    for n in (1, 16, 32):
        v = torch.from_numpy((rng.standard_normal(n) * 1e3).astype(np.float32)).to(dev)
        vk, vp = gdev.launch_probe(v).cpu(), gdev.probe_sum_plain(v).cpu()
        if vk.view(torch.int32).item() != vp.view(torch.int32).item():
            raise AssertionError(f"probe: kernel != plain on {n} values")
        p_err = max(p_err, abs(float(vk[0]) - float(vp[0])))
    if gdev.probe_device(dev, torch.arange(16, dtype=torch.float32) + 1):
        raise AssertionError("probe: a wrong sum passed the probe")
    p_sets = [gdev.probe_args(x) for _ in range(20)]
    p_ms, _ = time_launches("probe", p_sets)
    p_wrap_ms, _ = time_ms(lambda: gdev.probe_sum(x), 20)
    _, p_plain_ms = plain_ms(lambda: gdev.probe_sum_plain(x))
    # the library's reduction of the same tensor (timed only: the probe
    # never calls it)
    p_lib_ms, _ = time_ms(lambda: torch.sum(x), 20)
    p_bound, p_by = bound(io_bytes(p_sets[0][0]), 0, gdev.PROBE_VALUES - 1)
    log(f"  probe: kernel {p_ms:.4f} ms, wrapper {p_wrap_ms:.4f} ms, plain {p_plain_ms:.3f} ms, torch.sum "
        f"{p_lib_ms:.4f} ms, == plain bit for bit (max abs err {p_err}); a wrong sum fails the probe; bound "
        f"{p_bound:.7f} ms ({p_by})")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"  shard phase wall {summary['phase_s']:.1f}s")
    entries = [
        {
            "name": "ffd_loop_lanes",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/ffd_loop.cu",
            "replaces": "karpenter_tpu/parallel/mesh.py:468",
            "launches": launches["ffd_loop_lanes"],
            "max_abs_err": lanes_err,
            "ms": lanes_ms,
            "plain_ms": lanes_plain_ms,
            "plain_lanes": len(SHARD_PLAIN_LANES),
            "bound_ms": l_bound,
            "bound_by": l_by,
            "library_ms": None,
            "wrapper_ms": lanes_wrap_ms,
            "mode": f"ffd_loop lanes, grid {len(problems)}",
            "deepest_lane_alone_ms": deep_ms,
            "deepest_lane_single_ms": deep_single_ms,
            "control_device_ms": ctrl.last_timing["device"] * 1e3,
            "iters": iters,
            "work": l_work,
            "carried_lanes_ms": c_ms,
            "launches_relax2": launches2["ffd_loop_lanes"],
        },
        {
            "name": "relax2_place_lanes",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/relax_place.cu",
            "replaces": "karpenter_tpu/parallel/mesh.py:517",
            "launches": launches2["relax2_place_lanes"],
            "max_abs_err": r2_err,
            "ms": r2_ms,
            "plain_ms": r2_plain_ms,
            "plain_lanes": len(SHARD_PLAIN_LANES),
            "bound_ms": r2_bound,
            "bound_by": r2_by,
            "library_ms": None,
            "wrapper_ms": r2_wrap_ms,
            "mode": f"relax_place convex lanes, {len(probs2)} clusters of {r2_plan}, then ffd_loop lanes seeded",
            "deepest_lane_alone_ms": r2_one_ms,
            "deepest_lane_single_ms": r2_single_ms,
            "cluster": r2_plan,
            "by_cluster": r2_by_cluster,
            "work": r2_work,
            "carried_lanes_ms": c_ms,
        },
        {
            "name": "probe",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/probe.cu",
            "replaces": "karpenter_tpu/verify/device.py:316",
            "launches": probe_launches,
            "max_abs_err": p_err,
            "ms": p_ms,
            "plain_ms": p_plain_ms,
            "bound_ms": p_bound,
            "bound_by": p_by,
            "library_ms": p_lib_ms,
            "wrapper_ms": p_wrap_ms,
            # no launch runs below one launch: phase 2's empty probe launch
            "latency_floor_ms": LATENCY["launch_ms"],
        },
    ]
    return entries, summary


def flags_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, compare_results, compare_relax2,
                relax2_err, score_err):
    """Phase 7: the flag-gated phase-1 and order paths at full width, each
    through ``TorchSolver.solve`` with the launch counts read around it,
    ``full_gate`` of the result, and IterCounts and phase-1 stats equal to
    the JAX package's (EXPECT_*): ``KARPENTER_TPU_RELAX2=1`` on phase 2's
    batch and on a 10,000-pod homogeneous bulk (relax_place's convex mode,
    program 17, then the carried ffd_loop); ``KARPENTER_TPU_ORDER_POLICY=1``
    on phase 2's batch fresh and carried (lane_scores, program 6, then the
    scored ffd_loop). Then the convex mode and lane_scores alone, through
    their wrappers and plain, at those shapes, each equal to its plain
    version, and the scored fresh loop against its plain loop once. Returns
    the ``relax2_place`` and ``lane_scores`` entries of the kernels line."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.ops import policy as POL
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops import relax2 as R2
    from karpenter_tpu_torch.ops.ffd_core import _lane_align, _pad_lanes_mult32, initial_state, problem_bounds_free
    from karpenter_tpu_torch.ops.ffd_sweeps import (
        ffd_loop_args,
        problem_tensors,
        solve_ffd_sweeps,
        solve_ffd_sweeps_carried,
        sweeps_plain,
    )
    from karpenter_tpu_torch.solver import ordering
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W
    from karpenter_tpu_torch.ops.relax_common import ordered_sum
    from karpenter_tpu_torch.verify import device as gdev
    from karpenter_tpu_torch.verify import full_gate
    from karpenter_tpu_torch.verify.gate import _build_args

    t_phase = time.perf_counter()
    log("phase 7: convex phase 1 and the learned order at full width")
    diverse = W.diverse_workload(MAIN_PODS, 400, seed=42)
    homogeneous = W.homogeneous_workload(MAIN_PODS, 400)

    def drive(tag, workload, env, relax, expect):
        """One solve through the entry point with ``env`` set, the launch
        counts set to 0 just before it and read just after; then
        ``full_gate`` and the JAX package's IterCounts, scheduled pods and
        claims."""
        os.environ.update(env)
        ordering.reset_for_tests()
        try:
            solver = TorchSolver(initial_claim_slots=128, device=dev, relax=relax)
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = solver.solve(*workload)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            for name in env:
                os.environ.pop(name, None)
        outcome = full_gate(result, *workload)
        torch.cuda.synchronize()
        gp, ga, gbf = _build_args(result.verify_ctx, result, workload[0], None)
        if outcome is None or outcome.violations or outcome.counts or outcome.mode != "device":
            raise AssertionError(f"{tag}: gate rejected or could not run: {outcome}; {claims_over(gp, ga)}")
        got = (tuple(solver.last_iters), result.num_scheduled(), len(result.new_claims))
        if got != (expect["iters"], expect["scheduled"], expect["claims"]):
            raise AssertionError(f"{tag}: iters/scheduled/claims {got} != the JAX package's {expect}")
        # the gate's per-bin sums are taken in pod order: repeated launches
        # on the result give the plain version's sums bit for bit, and its
        # counts (all zero)
        C = ga.claim_tpl.shape[0]
        pb = ga.pod_bin.long()
        want_sum = ordered_sum(torch.where((pb >= 0) & (pb < C), pb, C), gp.pod_requests, C)
        want_counts = gdev.gate_counts_plain(gp, ga, gbf)
        gsets = [gdev.gate_counts_args(gp, ga) for _ in range(GATE_REPEATS)]
        time_launches("gate_counts", gsets)
        if want_counts.any() or any(not (torch.equal(t["summed"], want_sum) and torch.equal(t["counts"], want_counts))
                                    for t, _ in gsets):
            raise AssertionError(f"{tag}: a repeated gate_counts launch differs from plain ({want_counts.tolist()})")
        log(f"  {tag}: scheduled {got[1]}/{len(workload[0])} claims={got[2]} iters={got[0]} (== JAX) "
            f"wall {wall * 1e3:.1f} ms {({k: round(v * 1e3, 1) for k, v in solver.last_timing.items()})} "
            f"launches {launches}; gate clean ({outcome.mode}); {GATE_REPEATS} more gate_counts launches: "
            f"sums bit-equal to plain, counts 0; {claims_over(gp, ga, margin=True)}")
        return solver, result, launches, wall

    def claims_over(gp, ga, margin=False):
        """The claims whose pod-order float32 load fits none of their listed
        types (with ``margin``: the tightest claim instead), each with its
        load on the binding resource against the best listed type's
        capacity + eps, in float32 and float64, and the relative slack."""
        C = ga.claim_tpl.shape[0]
        pb = ga.pod_bin.long()
        idx = torch.where((pb >= 0) & (pb < C), pb, C)
        tpl = ga.claim_tpl.long().clamp(0, gp.tpl_overhead.shape[0] - 1)
        load32 = ordered_sum(idx, gp.pod_requests, C) + gp.tpl_overhead[tpl]
        load64 = torch.zeros((C + 1, gp.pod_requests.shape[1]), dtype=torch.float64, device=dev)
        load64 = load64.index_add_(0, idx, gp.pod_requests.double())[:C] + gp.tpl_overhead[tpl].double()
        cap = gp.it_alloc.double() + 1e-6 + 1e-6 * gp.it_alloc.double().abs()  # [T, R] what fits admits
        rel = ((load32.double()[:, None, :] - cap[None]) / cap[None]).amax(-1)  # [C, T] > 0: does not fit
        best = torch.where(ga.claim_its, rel, torch.inf).amin(-1)
        best = torch.where(ga.claim_active & ga.claim_its.any(-1), best, -torch.inf)
        pick = [int(best.argmax())] if margin else torch.nonzero(best > 0).flatten().tolist()[:5]
        rows = []
        for c in pick:
            t = int(torch.where(ga.claim_its[c], rel[c], torch.inf).argmin())
            r = int(((load32[c].double() - cap[t]) / cap[t]).argmax())
            rows.append(f"claim {c} ({int((idx == c).sum())} pods) type {t} resource {r}: load f32 "
                        f"{float(load32[c, r])!r} f64 {float(load64[c, r])!r}, capacity + eps "
                        f"{float(cap[t, r])!r}, relative slack {float(best[c])!r}")
        return ("tightest " if margin else "over: ") + ("; ".join(rows) or "none")

    def full_problem(result, n):
        """The solve's padded device problem with every pod active (its
        context holds the repair pass's residue)."""
        prob = result.verify_ctx.device_problem
        active = torch.arange(prob.num_pods, device=dev) < n
        return _pad_lanes_mult32(dataclasses.replace(prob, pod_active=active))

    def want_launches(tag, launches, **want):
        expected = {**{name: 0 for name in kernels.LAUNCHES}, **want}
        if launches != expected:
            raise AssertionError(f"{tag}: launched {launches}, not {expected}")

    iters, step = R2.pgd_iters(), R2.pgd_step()
    runs = {}
    for tag, workload in (("diverse", diverse), ("homogeneous", homogeneous)):
        expect = EXPECT_RELAX2[tag]
        solver, result, launches, wall = drive(f"relax2 {tag}", workload, {"KARPENTER_TPU_RELAX2": "1"}, True, expect)
        want_launches(f"relax2 {tag}", launches, relax2_place=1, ffd_loop=1, gate_counts=1)
        info = solver.last_relax2
        if info["reason"] is not None or solver.relax_fallbacks or solver.last_relax is not None:
            raise AssertionError(f"relax2 {tag}: the convex phase did not serve: {info}")
        stats = {k: info[k] for k in ("eligible", "placed", "demoted", "claims", "pgd_iterations")}
        stats.update(overflow=info["rounding"]["overflow"], round_demoted=info["rounding"]["demoted"])
        if stats != expect["stats"] or not np.allclose([info["residual"], info["capviol"]],
                                                       [expect["residual"], expect["capviol"]],
                                                       rtol=STAT_RTOL, atol=FLOAT_ATOL):
            raise AssertionError(f"relax2 {tag}: phase-1 stats {info} != the JAX package's {expect}")
        prob = full_problem(result, len(workload[0]))
        C = result.verify_ctx.max_claims
        yk = R2.relax2_place(prob, C)
        if R2.host_stats(yk.stats)._asdict() != {**stats, "residual": info["residual"], "capviol": info["capviol"]}:
            raise AssertionError(f"relax2 {tag}: the kernel on the rebuilt problem gives {R2.host_stats(yk.stats)}")
        sets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C, convex=(iters, step)) for _ in range(5))]
        k_ms, k_all = time_launches("relax_place", sets)
        for t, _ in sets:
            if not (torch.equal(t["kind"], yk.kind) and torch.equal(t["index"], yk.index)
                    and R2.host_stats(R2.stats_of(t["stats"])) == R2.host_stats(yk.stats)):
                raise AssertionError(f"relax2 {tag}: a timed launch differs from the wrapper's")
        wrap_ms, _ = time_ms(lambda: R2.relax2_place(prob, C), 5)
        yp, p_ms = plain_ms(lambda: R2.relax2_place_plain(prob, C))
        relax2_err = max(relax2_err, compare_relax2(f"relax2 {tag}", yk, yp))
        by_cluster = relax_by_cluster(f"relax2 {tag}", prob, C, (iters, step), yp, time_launches)
        work = dict(zip(RX.WORK_COUNTERS, sets[0][0]["work"].cpu().tolist()))
        # the carried repair from the convex phase: IterCounts as the JAX
        # package's (checked in drive); kernel against plain on the bulk
        residue, astate = _lane_align(dataclasses.replace(prob, pod_active=yk.residue_active), yk.state)
        ck = solve_ffd_sweeps_carried(residue, C, (yk.state, yk.kind, yk.index))
        if tuple(int(x) for x in ck.iters) != expect["iters"]:
            raise AssertionError(f"relax2 {tag}: carried loop iters {tuple(ck.iters)} != {expect['iters']}")
        if tag == "homogeneous":
            cp = sweeps_plain(residue, astate, problem_bounds_free(residue), yk.kind, yk.index)
            compare_results(f"relax2 {tag} carried", ck, cp)
        # bound: relax_place's operation count (type tests, record lanes,
        # the per-pod screen) plus the convex trips' float32 operations
        K, V, R, O = prob.num_keys, prob.num_lanes, prob.num_resources, prob.offer_ok.shape[1]
        P, N, G, TPL = prob.num_pods, prob.num_nodes, prob.num_groups, prob.num_templates
        Wd, PT, D = V // 32, prob.pod_ports.shape[1], prob.pod_vol_counts.shape[1]
        nbytes = io_bytes(sets[0][0], RX.RELAX_STATE, RX.RELAX_SCRATCH)
        int_ops = (work["type_tests"] * (K * Wd + O) + work["record_lanes"] * 2
                   + P * (2 * PT + 3 * G + 2 + (K * Wd + 4 * K + TPL) + N * (K * Wd + D + 2)))
        flt_ops = work["type_tests"] * 2 * R + P * R * 6 + P * N * 2 * R + work["pgd_columns"] * PGD_COLUMN_OPS
        b_ms, b_by = bound(nbytes, int_ops, flt_ops)
        runs[tag] = dict(ms=k_ms, wrapper_ms=wrap_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, work=work,
                         bytes=nbytes, int_ops=int_ops, float_ops=flt_ops, launches=launches["relax2_place"],
                         solve_ms=wall * 1e3, phase1=info, iters=expect["iters"], by_cluster=by_cluster,
                         plan=int(sets[0][0]["plan"][0]), sections=split_by(RX.SECTIONS, sets[0][0]["sections"], k_ms))
        log(f"  relax2 {tag}: kernel {k_ms:.4f} ms median of {[round(x, 4) for x in k_all]} on a cluster of "
            f"{runs[tag]['plan']}, wrapper {wrap_ms:.4f} ms, plain {p_ms:.1f} ms, kernel == plain; work {work}; bytes "
            f"{nbytes}, int ops {int_ops:.4g}, float ops {flt_ops:.4g}; bound {b_ms:.5f} ms ({b_by}); by stage "
            f"{runs[tag]['sections']}")

    # the learned order: fresh (relax off) and carried from the waterfill
    pol = {}
    for tag, relax in (("fresh", False), ("carried", True)):
        expect = EXPECT_POLICY[tag]
        solver, result, launches, wall = drive(f"order-policy {tag}", diverse, {"KARPENTER_TPU_ORDER_POLICY": "1"},
                                               relax, expect)
        want = dict(lane_scores=1, ffd_loop=1)
        if relax:
            want.update(relax_place=1, gate_counts=1)
        want_launches(f"order-policy {tag}", launches, **want)
        if solver.last_relax != expect["relax"]:
            raise AssertionError(f"order-policy {tag}: phase 1 {solver.last_relax} != the JAX package's")
        pol[tag] = dict(launches=launches["lane_scores"], solve_ms=wall * 1e3, iters=expect["iters"], result=result)

    # lane_scores and the scored fresh loop at the fresh solve's problem
    result = pol["fresh"].pop("result")
    pol["carried"].pop("result")
    prob = full_problem(result, MAIN_PODS)
    C = result.verify_ctx.max_claims
    lane_w = ordering.lane_weights_static()
    # the tables the solve builds once for the scorer and the loop
    tables = problem_tensors(prob)
    scores = POL.lane_scores(prob, lane_w, tables=tables)
    sets = [POL.lane_scores_args(prob, lane_w, tables=tables) for _ in range(10)]
    s_ms, s_all = time_launches("lane_scores", sets)
    if any(not torch.equal(t["scores"], scores) for t, _ in sets):
        raise AssertionError("lane_scores: a timed launch differs from the wrapper's")
    s_wrap_ms, _ = time_ms(lambda: POL.lane_scores(prob, lane_w, tables=tables), 5)
    sp, s_plain_ms = plain_ms(lambda: POL.lane_scores_plain(prob, lane_w))
    err = float((scores - sp).abs().max())
    score_err = max(score_err, err)
    if err > SCORE_ATOL:
        raise AssertionError(f"lane_scores at full width: {err} from plain")
    rf = solve_ffd_sweeps(prob, C, order_scores=scores, tables=tables)
    if tuple(int(x) for x in rf.iters) != EXPECT_POLICY["fresh"]["iters"]:
        raise AssertionError(f"scored fresh loop iters {tuple(rf.iters)}")
    loop_sets = [ffd_loop_args(prob, initial_state(prob, C), False, order_scores=scores) for _ in range(2)]
    l_ms, _ = time_launches("ffd_loop", loop_sets)
    rp, l_plain_ms = plain_ms(lambda: sweeps_plain(prob, initial_state(prob, C), problem_bounds_free(prob),
                                                   order_scores=scores))
    compare_results("scored fresh loop", rf, rp)
    K, V, R, P = prob.num_keys, prob.num_lanes, prob.num_resources, prob.num_pods
    nbytes = io_bytes(sets[0][0])
    int_ops = P * (2 * K * (V // 32) + K + prob.pod_ports.shape[1] + prob.num_templates + 2 * prob.num_groups)
    flt_ops = P * (2 * R + 2 * POL.N_LANE_FEATURES + 8)
    b_ms, b_by = bound(nbytes, int_ops, flt_ops)
    log(f"  lane_scores: kernel {s_ms:.4f} ms median of {[round(x, 4) for x in s_all]}, wrapper {s_wrap_ms:.4f} ms "
        f"(the solve's tables), plain {s_plain_ms:.1f} ms, max |kernel - plain| {err:.3g}; bytes {nbytes}, bound "
        f"{b_ms:.5f} ms ({b_by}); one launch {LATENCY['launch_ms']:.4f} ms; "
        f"scored fresh ffd_loop {l_ms:.3f} ms, plain {l_plain_ms:.1f} ms, kernel == plain, iters "
        f"{tuple(int(x) for x in rf.iters)}")
    log(f"  flags phase wall {time.perf_counter() - t_phase:.1f}s")
    relax2_entry = {
        "name": "relax2_place",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/relax_place.cu",
        "replaces": "karpenter_tpu/ops/relax2.py:314",
        "launches": runs["diverse"]["launches"],
        "max_abs_err": relax2_err,
        "ms": runs["diverse"]["ms"],
        "plain_ms": runs["diverse"]["plain_ms"],
        "bound_ms": runs["diverse"]["bound_ms"],
        "bound_by": runs["diverse"]["bound_by"],
        "library_ms": None,
        "wrapper_ms": runs["diverse"]["wrapper_ms"],
        "mode": "relax_place convex (mode 1)",
        "runs": runs,
    }
    lane_entry = {
        "name": "lane_scores",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/lane_scores.cu",
        "replaces": "karpenter_tpu/ops/policy.py:102",
        "also_replaces": ["karpenter_tpu/ops/ffd_sweeps.py:2002", "karpenter_tpu/ops/ffd_sweeps.py:2024"],
        "launches": pol["fresh"]["launches"],
        "max_abs_err": score_err,
        "ms": s_ms,
        "plain_ms": s_plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "wrapper_ms": s_wrap_ms,
        "latency_floor_ms": LATENCY["launch_ms"],
        "scored_loop_ms": l_ms,
        "scored_loop_plain_ms": l_plain_ms,
        "runs": pol,
    }
    return relax2_entry, lane_entry


def explain_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, attr_err):
    """Phase 6: the explain pass at full width, on phase 2's batch (10,000
    diverse pods, 400 types) twice: under a NodePool cpu limit that leaves a
    large share unscheduled (claim-capacity), and without the limit but with
    tests/test_explain.py's engineered pods added (resources,
    requirements). Each is solved with ``KARPENTER_TPU_EXPLAIN`` off and on:
    the placements must be the same, the solve with the flag on must launch
    ``attribute`` once (none off), its words must equal ``attribute_plain``'s
    on the same rows and state, and the report's reasons the plain words'
    decode. Returns the ``attribute`` entry of the kernels line, timed on the
    limited batch's rows."""
    import copy
    import os

    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.obs import explain as obs_explain
    from karpenter_tpu_torch.ops import ffd_step
    from karpenter_tpu_torch.ops.ffd_core import _lane_align
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    pods, its, tpls, nodes = W.diverse_workload(MAIN_PODS, 400, seed=42)
    limited = copy.copy(tpls[0])
    limited.remaining_resources = {"cpu": EXPLAIN_CPU_LIMIT}

    def pod(name, cpu=0.5, node_selector=None):
        return Pod(metadata=ObjectMeta(name=name), spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": 1e8})], node_selector=node_selector or {}))

    engineered = pods + [pod("huge", cpu=10_000.0), pod("moon", node_selector={wk.LABEL_TOPOLOGY_ZONE: "no-such-zone"})]
    scenarios = (
        ("limit", pods, limited, lambda rep, n: rep.counts().get(obs_explain.REASON_CLAIM_CAPACITY, 0) >= n // 10),
        ("engineered", engineered, tpls[0], lambda rep, n: {i: e.reason for i, e in rep.pods.items()} == {
            n - 2: obs_explain.REASON_RESOURCES, n - 1: obs_explain.REASON_REQUIREMENTS}),
    )

    def solve(batch, tpl):
        solver = TorchSolver(initial_claim_slots=128, device=dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = solver.solve(batch, its, [tpl], nodes)
        torch.cuda.synchronize()
        return result, dict(kernels.LAUNCHES), (time.perf_counter() - t0) * 1e3

    seen = []
    real = ffd_step.attribute_pods

    def recording(problem, state, rows, tables=None):
        words = real(problem, state, rows, tables)
        seen.append((problem, state, list(rows), words, tables))
        return words

    prev = os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
    obs_explain.set_enabled(None)
    timed = None
    try:
        for name, batch, tpl, expected in scenarios:
            os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
            off, off_launches, off_ms = solve(batch, tpl)
            os.environ["KARPENTER_TPU_EXPLAIN"] = "1"
            ffd_step.attribute_pods = recording
            seen.clear()
            on, on_launches, on_ms = solve(batch, tpl)
            ffd_step.attribute_pods = real
            if off.explain is not None or off_launches["attribute"] != 0:
                raise AssertionError(f"explain {name} off: a report or an attribute launch ({off_launches})")
            if (on.new_claims, on.node_pods, on.failures) != (off.new_claims, off.node_pods, off.failures):
                raise AssertionError(f"explain {name}: placements differ from the flag-off solve")
            if on_launches["attribute"] != 1 or len(seen) != 1:
                raise AssertionError(f"explain {name}: attribute launched {on_launches['attribute']} times, not once")
            rep = on.explain
            if rep is None or rep.pods.keys() != on.failures.keys() or not expected(rep, len(batch)):
                raise AssertionError(f"explain {name}: {len(on.failures)} failures, reasons "
                                     f"{None if rep is None else rep.counts()}")
            problem, state, rows, words, tables = seen[0]
            if tables is None:
                raise AssertionError(f"explain {name}: the solve handed the explain pass no tables")
            wp, p_ms = plain_ms(lambda: ffd_step.attribute_plain(problem, state, rows))
            if not torch.equal(words.cpu(), wp.cpu()):
                raise AssertionError(f"explain {name}: attribute words differ from plain on the solve's rows")
            attr_err = max(attr_err, int((words.cpu().long() - wp.cpu().long()).abs().max()))
            plain_reasons = {
                orig: obs_explain.decode_pod(orig, obs_explain.KIND_NAMES.index(e.kind), wp[i].tolist()).reason
                for i, (orig, e) in enumerate(rep.pods.items())
            }
            if plain_reasons != {orig: e.reason for orig, e in rep.pods.items()}:
                raise AssertionError(f"explain {name}: the report's reasons differ from the plain words' decode")
            log(f"  {name}: scheduled {on.num_scheduled()}/{len(batch)}, {len(on.failures)} explained; reasons "
                f"{rep.counts()}; placements == flag off; attribute launches on/off "
                f"{on_launches['attribute']}/{off_launches['attribute']}; words == plain ({p_ms:.1f} ms plain); "
                f"solve {off_ms:.1f} ms off, {on_ms:.1f} ms on; explain overhead {rep.overhead_s * 1e3:.2f} ms")
            if timed is None:
                timed = (problem, state, rows, words, tables, p_ms, rep, on_launches["attribute"])
    finally:
        ffd_step.attribute_pods = real
        os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
        if prev is not None:
            os.environ["KARPENTER_TPU_EXPLAIN"] = prev

    # the kernel alone, through its wrapper, and plain, on the limited
    # batch's rows
    problem, state, rows, words, tables, p_ms, rep, n_launch = timed
    aprob, astate = _lane_align(problem, state)
    # the row plans: each run of byte-identical rows once (the problem's
    # pod_eqprev, the default), and every row (the problem without it)
    by_layout, works = {}, {}
    for layout, lprob in (("dedup", aprob), ("every-row", dataclasses.replace(aprob, pod_eqprev=None))):
        # the solve's own tables, as the explain pass hands them over
        lsets = [ffd_step.attribute_args(lprob, astate, rows, tables) for _ in range(5)]
        l_ms, l_all = time_launches("attribute", lsets)
        l_wrap, _ = time_ms(lambda: ffd_step.launch_attribute(lprob, astate, rows, tables), 5)
        for t, _ in lsets:
            if not torch.equal(ffd_step.attribute_words(t), words):
                raise AssertionError(f"explain: a timed attribute launch ({layout}) differs from the wrapper's")
        t, args = lsets[0]
        plan = t["plan"].cpu().tolist()
        works[layout] = dict(zip(ffd_step.ATTR_WORK_COUNTERS, t["work"].cpu().tolist()))
        # one launch, then a team's rows one after another, six team barriers a row
        per_team = -(-args.B // (plan[0] * plan[1]))
        floor = LATENCY["launch_ms"] + per_team * 6 * LATENCY["sync_ms"]
        by_layout[layout] = {"ms": l_ms, "wrapper_ms": l_wrap, "rows_attributed": args.B, "team_warps": args.TW,
                             "plan": plan, "latency_floor_ms": floor,
                             "sections": {k: round(v, 5) for k, v in ffd_step.attr_section_split(
                                 t["sections"].cpu(), l_ms).items()}}
        if layout == "dedup":
            # the timed launch's own inputs: the rows it attributes
            nbytes = io_bytes(t, (), ffd_step.ATTR_SCRATCH + ("inverse",))
        log(f"  attribute {layout}: {args.B} of {len(rows)} rows attributed, teams of {args.TW} warps, plan "
            f"(blocks, teams; lanes, groups, types resident) {plan}: kernel {l_ms:.4f} ms median of "
            f"{[round(x, 4) for x in l_all]}, wrapper {l_wrap:.4f} ms, == the wrapper's words; latency floor "
            f"{floor:.5f} ms; by section {by_layout[layout]['sections']}")
    if any(works[x][k] != works["every-row"][k] for x in works for k in ("entry_gates", "listed_type_tests")):
        raise AssertionError(f"explain: the row plans count other work for every entry: {works}")
    layout = "dedup"
    k_ms, wrap_ms = by_layout[layout]["ms"], by_layout[layout]["wrapper_ms"]
    # the bound counts what the timed launch needs: its attributed rows'
    # gates, each bin's type tests up to its first survivor
    work = works[layout]
    K, V, R = aprob.num_keys, aprob.num_lanes, aprob.num_resources
    Wd, O = V // 32, aprob.offer_ok.shape[1]
    # per bin gate the merge and intersect over K x W words; per topology
    # lane a compare and a select; per type test the compat words and the
    # offerings in int32, an add and a compare per resource in float32
    int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
    flt_ops = work["type_tests"] * 2 * R
    b_ms, b_by = bound(nbytes, int_ops, flt_ops)
    log(f"  attribute over {len(rows)} rows ({layout}): kernel {k_ms:.4f} ms, "
        f"wrapper {wrap_ms:.4f} ms, plain {p_ms:.1f} ms; work {work}; bytes {nbytes}, int ops {int_ops:.4g}, "
        f"float ops {flt_ops:.4g}; bound {b_ms:.5f} ms ({b_by})")
    log(f"  explain phase wall {time.perf_counter() - t_phase:.1f}s")
    return {
        "name": "attribute",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/attribute.cu",
        "replaces": "karpenter_tpu/ops/ffd_step.py:730",
        "launches": n_launch,
        "max_abs_err": attr_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "wrapper_ms": wrap_ms,
        "rows": len(rows),
        "work": work,
        "layout": layout,
        "by_layout": by_layout,
        "latency_floor_ms": by_layout[layout]["latency_floor_ms"],
        "explain_overhead_ms": rep.overhead_s * 1e3,
        "reasons": rep.counts(),
    }


def consolidation_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound):
    """Phase 3 (see the module docstring). Returns the ``runs_screen`` entry
    of the kernels line."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.disruption import batch
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32, initial_state
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    log(f"phase 3: consolidation screen, {SCREEN_CANDIDATES} candidates")
    n = SCREEN_CANDIDATES
    subsets = screen_subsets(n)
    B = len(subsets)
    # the checked lanes: every 20th, the last, and the last 10 large random
    # subsets (26 lanes: the checks' depth, cut so that the smoke keeps its
    # time with phase 14)
    checked = sorted(set(range(0, B, 20)) | {B - 1} | set(range(B - 10, B)))
    captured = {}
    real_lean, real_res = batch.lean_screen, batch.residual_screen

    def lean(base, variants, C, passes=3):
        captured["full"] = (base, variants, C, passes)
        return real_lean(base, variants, C, passes)

    def res(base, carried, variants, run_idx, C):
        captured["residual"] = (base, carried, variants, run_idx, C)
        return real_res(base, carried, variants, run_idx, C)

    def score(tag, base_pods, delta):
        """One score_subsets call on a fresh scorer, launch counts set to 0
        just before it and read just after; then the same call again on the
        same scorer (its base world cached)."""
        scorer, its, cands = batch.build_bench_scorer(n, base_pods=base_pods, device=dev, delta=delta)
        captured.clear()
        batch.lean_screen, batch.residual_screen = lean, res
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            verdicts = scorer.score_subsets(subsets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            stats = dict(scorer.last_screen_stats)
            kernels.reset_launches()
            t0 = time.perf_counter()
            again = scorer.score_subsets(subsets)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            launches2 = dict(kernels.LAUNCHES)
            stats2 = dict(scorer.last_screen_stats)
        finally:
            batch.lean_screen, batch.residual_screen = real_lean, real_res
        keys = [verdict_key(v) for v in verdicts]
        if keys != [verdict_key(v) for v in again]:
            raise AssertionError(f"{tag}: a repeated score_subsets call changed its verdicts")
        cons = sum(1 for v, sub in zip(verdicts, subsets) if v.consolidatable_with([cands[i] for i in sub], its))
        claims = np.bincount([v.n_new_claims for v in verdicts], minlength=3).tolist()
        sched = sum(v.all_pods_scheduled for v in verdicts)
        prob = scorer.device_problem
        modes = np.bincount(prob.run_mode[prob.run_len > 0].cpu().numpy(), minlength=3).tolist()
        log(f"  {tag}: {B} lanes, mode={stats['mode']} passes={stats.get('passes')} delta_lanes={stats.get('delta_lanes')} "
            f"fallback={stats.get('fallback_lanes')} rnr={stats.get('rnr')} outcomes={stats.get('outcomes')}; "
            f"all scheduled {sched}, consolidatable {cons}, new claims 0/1/2 = {claims}; P={prob.num_pods} "
            f"N={prob.num_nodes} T={prob.num_instance_types} V={prob.num_lanes} K={prob.num_keys} G={prob.num_groups} "
            f"R={prob.num_resources} runs single/analytic/topo={modes} max_run={M.max_run_bucket(prob)}")
        for i, (w, ln, st) in enumerate(((wall, launches, stats), (wall2, launches2, stats2))):
            log(f"  {tag} call {i + 1}: wall {w * 1e3:.1f} ms = shared {st['screen_shared_ms']:.1f} + lanes "
                f"{st['screen_lane_ms']:.1f} ms (+ host decode); {B / w:.1f} candidates/s; launches {ln}")
        return dict(scorer=scorer, keys=keys, stats=stats, cons=cons, claims=claims, sched=sched,
                    launches=launches, launches2=launches2, wall=wall, wall2=wall2, captured=dict(captured))

    a_delta = score("corpus A delta", W.pinned_base_pods(8, cpu=63.5), True)
    a_full = score("corpus A full", W.pinned_base_pods(8, cpu=63.5), False)
    b = score("corpus B", W.pinned_base_pods(8, cpu=63.5) + W.zonal_spread_pods(24), True)

    # the JAX package's contract: the delta path publishes the full screen's verdicts
    bad = [i for i, (x, y) in enumerate(zip(a_delta["keys"], a_full["keys"])) if x != y]
    if bad:
        raise AssertionError(f"corpus A: delta verdicts differ from the full screen's on lanes {bad[:10]}")
    got_a = {"delta_lanes": a_delta["stats"]["delta_lanes"], "fallback_lanes": a_delta["stats"]["fallback_lanes"],
             "rnr": a_delta["stats"]["rnr"], "consolidatable": a_delta["cons"], "new_claims": a_delta["claims"]}
    got_b = {"mode": b["stats"]["mode"], "passes": b["stats"]["passes"], "all_scheduled": b["sched"],
             "consolidatable": b["cons"], "new_claims": b["claims"]}
    if got_a != EXPECT_A or (a_full["cons"], a_full["claims"]) != (EXPECT_A["consolidatable"], EXPECT_A["new_claims"]):
        raise AssertionError(f"corpus A: {got_a} != the JAX package's {EXPECT_A}")
    if got_b != EXPECT_B or b["stats"]["outcomes"] != {"standdown-topology": B}:
        raise AssertionError(f"corpus B: {got_b} != the JAX package's {EXPECT_B}")
    for tag, r, want in (("corpus A delta", a_delta, {"runs_screen": 1, "ffd_loop": 1}),
                         ("corpus A full", a_full, {"runs_screen": 1}),
                         ("corpus B", b, {"runs_screen": 1})):
        want = {k: want.get(k, 0) for k in kernels.LAUNCHES}
        want2 = dict(want, ffd_loop=0)  # the repeat reuses the cached base world
        if r["launches"] != want or r["launches2"] != want2:
            raise AssertionError(f"{tag}: launches {r['launches']} then {r['launches2']}, expected {want} then {want2}")
    log(f"  delta == full on all {B} lanes; counts equal the JAX package's: A {got_a}, B {got_b}")

    # runs_screen against its plain version, per mode, on the checked lanes
    modes = {
        "residual": a_delta["captured"]["residual"],
        "full": a_full["captured"]["full"],
        "full-topology": b["captured"]["full"],
    }
    out = {"max_abs_err": 0.0, "work": {}, "per_mode": {}}
    for mode, cap in modes.items():
        if mode == "residual":
            base, carried, variants, run_idx, C = cap
            base = _pad_lanes_mult32(base)
            p0 = M.trim_runs(base, run_idx)
            kw = dict(max_run=M.max_run_bucket(base), passes=1, with_topo=False)
            make_args = lambda: M.runs_screen_args(p0, carried, variants.node_avail, variants.pod_active, **kw)
            wrap = lambda: M.residual_screen(base, carried, variants, run_idx, C)
            plain = lambda: M.residual_screen_plain(base, carried, variants, run_idx, C, lanes=checked)
        else:
            base, variants, C, passes = cap
            base = _pad_lanes_mult32(base)
            kw = dict(max_run=M.max_run_bucket(base), passes=passes, with_topo=M.has_topo_runs(base),
                      grp_counts0=variants.grp_counts0, grp_registered0=variants.grp_registered0)
            init = initial_state(base, C)
            make_args = lambda: M.runs_screen_args(base, init, variants.node_avail, variants.pod_active, **kw)
            wrap = lambda: M.lean_screen(base, variants, C, passes)
            plain = lambda: M.lean_screen_plain(base, variants, C, passes, lanes=checked)
        if mode == "full-topology" and not (kw["with_topo"] and kw["passes"] == 3):
            raise AssertionError("corpus B did not run the topology commit with three passes")
        rk = wrap()
        torch.cuda.synchronize()
        sets = [make_args() for _ in range(5)]
        k_ms, k_all = time_launches("runs_screen", sets)
        for t, _ in sets:
            if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
                raise AssertionError(f"runs_screen {mode}: a timed launch differs from the wrapper's")
        w_ms, _ = time_ms(wrap, 5)
        rp, p_ms = plain_ms(plain)
        sel = torch.tensor(checked, device=rk.kind.device)
        if not (torch.equal(rk.kind[sel].cpu(), rp.kind.cpu()) and torch.equal(rk.index[sel].cpu(), rp.index.cpu())):
            raise AssertionError(f"runs_screen {mode}: kind/index differ from the plain version")
        sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
        for key in sp:
            a_, b_ = sk[key][checked], sp[key]
            if a_.dtype.kind == "f":
                fin = np.isfinite(a_) & np.isfinite(b_)
                if fin.any():
                    out["max_abs_err"] = max(out["max_abs_err"], float(np.abs(a_[fin] - b_[fin]).max()))
            if not np.array_equal(a_, b_, equal_nan=a_.dtype.kind == "f"):
                raise AssertionError(f"runs_screen {mode}: state {key} differs from the plain version")
        work = dict(zip(M.RS_WORK_COUNTERS, rk.work.sum(dim=0).cpu().tolist()))
        t0 = sets[0][0]
        nbytes = io_bytes(t0, (), M.RS_SCRATCH)
        K, Wd, O, R = base.num_keys, base.num_lanes // 32, base.offer_ok.shape[1], base.num_resources
        int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
        flt_ops = work["type_tests"] * 2 * R
        b_ms, b_by = bound(nbytes, int_ops, flt_ops)
        lanes = variants.pod_active.shape[0]
        plan = t0["plan"].cpu().tolist()
        slow = int(t0["sections"].sum(dim=1).argmax())
        sections = split_by(M.RS_SECTIONS, t0["sections"][slow], k_ms)
        by_layout = screen_by_layout(f"runs_screen {mode}", make_args, rk, base.num_lanes, time_launches)
        out["per_mode"][mode] = dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, plain_lanes=len(checked), lanes=lanes,
                                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes, int_ops=int_ops, flt_ops=flt_ops,
                                     work=work, plan=plan, sections=sections, by_layout=by_layout)
        log(f"  runs_screen {mode}: {lanes} lanes, plan {plan} (layout, blocks a lane, threads a block), the slowest "
            f"lane ({slow}) by section {sections}")
        log(f"  runs_screen {mode}: {lanes} lanes, kernel {k_ms:.3f} ms median of {[round(x, 3) for x in k_all]}, "
            f"wrapper {w_ms:.3f} ms, plain {p_ms:.1f} ms on {len(checked)} lanes; kernel == plain on those lanes "
            f"(max float err {out['max_abs_err']}); bytes {nbytes}, int ops {int_ops:.4g}, float ops {flt_ops:.4g}, "
            f"bound {b_ms:.5f} ms ({b_by}); work {work}")
    main = out["per_mode"]["residual"]
    log(f"  phase 3 wall {time.perf_counter() - t_phase:.1f}s")
    return {
        "name": "runs_screen",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/runs_screen.cu",
        "replaces": "karpenter_tpu/parallel/mesh.py:321",
        "also_replaces": ["karpenter_tpu/parallel/mesh.py:232", "karpenter_tpu/ops/ffd_runs.py:519"],
        "launches": a_delta["launches"]["runs_screen"],
        "max_abs_err": out["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "wrapper_ms": main["wrapper_ms"],
        "plain_lanes": main["plain_lanes"],
        "work": main["work"],
        "modes": out["per_mode"],
        "launches_full": a_full["launches"]["runs_screen"],
        "launches_topology": b["launches"]["runs_screen"],
        "candidates_per_s": {"residual": B / a_delta["wall2"], "full": B / a_full["wall2"],
                             "full_topology": B / b["wall2"]},
        "screen_ms": {tag: {"shared": r["stats"]["screen_shared_ms"], "lanes": r["stats"]["screen_lane_ms"],
                            "wall_first": r["wall"] * 1e3, "wall_repeat": r["wall2"] * 1e3}
                      for tag, r in (("residual", a_delta), ("full", a_full), ("full_topology", b))},
    }


def churn_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound):
    """Phase 4 (see the module docstring). Returns the ``patch_world`` and
    fused ``gate_counts`` entries of the kernels line, and the phase's
    record."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.models.problem import problem_to_torch
    from karpenter_tpu_torch.ops import fused
    from karpenter_tpu_torch.ops.ffd_sweeps import forced_cluster, state_tensors
    from karpenter_tpu_torch.ops.padding import pad_problem
    from karpenter_tpu_torch.solver.encode import Encoder, template_from_nodepool
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess, default_pod_factory
    from karpenter_tpu_torch.verify import device as gdev

    t_phase = time.perf_counter()
    log(f"phase 4: steady-state churn, {CHURN_PODS} pods, {CHURN_CYCLES} cycles, "
        f"{CHURN_RATE} arrivals + {CHURN_RATE} deletes a cycle")
    its = instance_types(400)
    tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="d")), its, range(len(its)))]
    rng = random.Random(CHURN_SEED)
    proc = ChurnProcess([default_pod_factory(f"dw-{i}", rng) for i in range(CHURN_PODS)],
                        config=ChurnConfig(seed=CHURN_SEED, arrivals_per_cycle=CHURN_RATE,
                                           deletes_per_cycle=CHURN_RATE))
    resident = TorchSolver(relax=False, device_world=True, device=dev, initial_claim_slots=CHURN_SLOTS)
    legacy = TorchSolver(relax=False, device=dev, initial_claim_slots=CHURN_SLOTS)
    dw = resident._device_world
    C = CHURN_SLOTS

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    def placements(result):
        return ([(c.template_index, c.pod_indices, c.instance_type_indices, sorted(c.requests.items()))
                 for c in result.new_claims], sorted(result.node_pods.items()), sorted(result.failures))

    def fused_check(pods, tag):
        """The fused gate's counts against gate_counts_plain over
        gate_args_from_state of the same final state (one more fused solve
        of the resident world, outside the counted window)."""
        pc = torch.from_numpy(dw._pod_check(pods, dw.meta)).to(dev)
        rk, ck = fused.solve_ffd_fused_gate(dw.world, pc, C)
        problem = fused.world_problem(dw.world.t)
        gbf = gdev.gate_bounds_free(gdev.gate_problem(problem))
        ga = gdev.gate_args_from_state(rk.state, rk.kind, rk.index, pc, C)
        cp = gdev.gate_counts_plain(gdev.gate_problem(problem), ga, gbf)
        if not torch.equal(ck.cpu(), cp.cpu()) or ck.any():
            raise AssertionError(f"churn {tag}: fused counts {ck.tolist()} != plain {cp.tolist()} or nonzero")
        errs["gate"] = max(errs["gate"], int((ck.long() - cp.long()).abs().max()))
        # the fused gate alone on the same final state, on every cluster size
        t = dict(dw.world.t)
        t.update(state_tensors(rk.state, problem.lane_valid, problem.lane_numeric))
        t["kind"], t["index"] = rk.kind, rk.index
        for blocks in GATE_CLUSTERS:
            with forced_cluster(blocks):
                cl = gdev.launch_gate_counts_fused(t, pc)
            if not torch.equal(cl.cpu(), cp.cpu()):
                raise AssertionError(f"churn {tag}: fused counts (cluster {blocks}) {cl.tolist()} != plain "
                                     f"{cp.tolist()}")
        return rk, ck, pc, problem, ga, gbf

    records, totals = [], {name: 0 for name in kernels.LAUNCHES}
    errs = {"patch": 0.0, "gate": 0}
    world_checks, fused_checks = 0, 0
    for cyc in range(CHURN_CYCLES):
        if cyc:
            proc.step()
        pods = list(proc.pods)
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = resident.solve(pods, its, tpls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for name, n in launches.items():
            totals[name] += n
        outcome = dw.last_outcome
        expect = "adopt-first-encode" if cyc == 0 else ("patched", "repatched")
        if outcome != expect and outcome not in expect:
            raise AssertionError(f"churn cycle {cyc}: outcome {outcome}, expected {expect}")
        want = {**{name: 0 for name in kernels.LAUNCHES}, "ffd_loop": 1, "gate_counts": 1,
                "patch_world": int(cyc > 0)}
        if launches != want:
            raise AssertionError(f"churn cycle {cyc} ({outcome}): launches {launches}, expected {want}")
        if result.verify_ctx is None or result.verify_ctx.fused_counts != {}:
            raise AssertionError(f"churn cycle {cyc}: fused counts {result.verify_ctx}")
        if cyc:
            # patch_world against its plain version on the same arguments: the
            # swap left the previous rows in the spare buffers
            plain = fused.patch_world_plain(dw.world.spare, dw.last_patch)
            for name, value in plain.items():
                if not torch.equal(bits(dw.world.t[name]), bits(value)):
                    raise AssertionError(f"churn cycle {cyc}: patch_world {name} != plain")
                if value.numel():
                    diff = (dw.world.t[name].double() - value.double()).abs().max()
                    errs["patch"] = max(errs["patch"], float(diff))
        if cyc % 4 == 0 or cyc == CHURN_CYCLES - 1:
            cold = Encoder().encode(pods, its, tpls, num_claim_slots=C)
            ref = fused.world_tensors(problem_to_torch(pad_problem(cold.problem), dev))
            if ref.keys() != dw.world.t.keys() or any(
                    not torch.equal(bits(dw.world.t[k]), bits(ref[k])) for k in ref):
                raise AssertionError(f"churn cycle {cyc}: resident world != cold encode")
            world_checks += 1
        fused_check(pods, f"cycle {cyc}")
        fused_checks += 1
        t0 = time.perf_counter()
        ref_result = legacy.solve(pods, its, tpls)
        torch.cuda.synchronize()
        legacy_wall = time.perf_counter() - t0
        if placements(result) != placements(ref_result):
            raise AssertionError(f"churn cycle {cyc}: placements differ from the legacy arm")
        records.append(dict(cycle=cyc, outcome=outcome, wall_ms=wall * 1e3, legacy_ms=legacy_wall * 1e3,
                            detail=dict(dw.last_cycle), scheduled=result.num_scheduled(),
                            claims=len(result.new_claims), pods=len(pods)))
        log(f"  cycle {cyc:2d} {outcome:18s} wall {wall * 1e3:8.1f} ms (legacy {legacy_wall * 1e3:8.1f}) "
            f"encode {dw.last_cycle['encode_ms']:.1f} patch {dw.last_cycle['patch_ms']:.1f} "
            f"solve {dw.last_cycle['solve_ms']:.1f} decode {dw.last_cycle['decode_ms']:.1f} ms; "
            f"h2d {dw.last_cycle['h2d_bytes']} B; scheduled {result.num_scheduled()}/{len(pods)} "
            f"on {len(result.new_claims)} claims")
    if dw.counters.get("adopt-first-encode") != 1 or dw.cold_solves != 1 or any(
            k.startswith("standdown") for k in dw.counters):
        raise AssertionError(f"churn: outcomes {dw.counters}, cold solves {dw.cold_solves}")
    steady = [r for r in records if r["outcome"] in ("patched", "repatched")]
    walls = sorted(r["wall_ms"] for r in steady)

    def p(vals, q):
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    summary = dict(
        pods=CHURN_PODS, cycles=CHURN_CYCLES, churn_frac=2 * CHURN_RATE / CHURN_PODS, outcomes=dict(dw.counters),
        cold_solves=dw.cold_solves, wall_ms_p50=statistics.median(walls), wall_ms_p99=p(walls, 0.99),
        legacy_ms_p50=statistics.median(r["legacy_ms"] for r in records[1:]),
        split_ms_p50={k: statistics.median(r["detail"][k] for r in steady)
                      for k in ("encode_ms", "patch_ms", "prep_ms", "solve_ms", "decode_ms")},
        h2d_bytes_p50=statistics.median(r["detail"]["h2d_bytes"] for r in steady),
        world_bytes=steady[-1]["detail"]["world_bytes"],
        adopt_h2d_bytes=records[0]["detail"]["h2d_bytes"],
        overlap_frac_mean=statistics.mean(r["detail"]["overlap_frac"] for r in steady),
        world_checks=world_checks, fused_checks=fused_checks,
        claims_last=records[-1]["claims"], scheduled_last=records[-1]["scheduled"],
    )
    log(f"  churn: patched wall p50 {summary['wall_ms_p50']:.1f} ms, p99 {summary['wall_ms_p99']:.1f} ms; "
        f"legacy p50 {summary['legacy_ms_p50']:.1f} ms; split p50 {summary['split_ms_p50']}; "
        f"h2d p50 {summary['h2d_bytes_p50']} B of a {summary['world_bytes']} B world "
        f"(adopt {summary['adopt_h2d_bytes']} B); overlap {summary['overlap_frac_mean']:.3f}; "
        f"outcomes {summary['outcomes']}; world == cold on {world_checks} cycles, fused == plain on {fused_checks}")

    # patch_world alone: the last cycle's launch again (its table reads the
    # previous rows, now in the spare buffers, and rewrites the same world)
    stream = torch.cuda.current_stream(dev).cuda_stream
    up = dw.last_patch
    pw_ms, pw_all = time_launches("patch_world", [(None, up.args)] * 10)
    # through its wrapper: pack, upload and launch, on a copy of the world
    # before the last patch (swapped back after each call)
    w = dw.world
    pre = fused.World(
        t={k: (w.spare[k] if k in fused.PATCH_ROWS else v).clone() for k, v in w.t.items()},
        spare={k: torch.empty_like(v) for k, v in w.spare.items()}, init=w.init, lanes=w.lanes,
        shapes=w.shapes, max_claims=w.max_claims)
    args = fused.build_patch_args(dw.delta._state.problem, dw.delta.last_rows_prev, w.shapes)

    def wrapped_patch():
        fused.patch_world(pre, fused.upload_patch(args, pre))
        for name in fused.PATCH_ROWS:
            pre.t[name], pre.spare[name] = pre.spare[name], pre.t[name]

    pw_wrap_ms, _ = time_ms(wrapped_patch, 10)
    prev_rows = dict(w.spare)
    _, pw_plain_ms = plain_ms(lambda: fused.patch_world_plain(prev_rows, up))
    # bytes: the survivors' rows read once, every row written once, the
    # upload (work lists, shipped rows, full-ship leaves, leaf table) read
    # once, the full-ship leaves written once
    survivors = int(up.pieces[:, 2].sum())
    Pb = int(w.t["pod_requests"].shape[0])
    row_bytes = sum(w.t[n].numel() * w.t[n].element_size() // Pb for n in fused.PATCH_ROWS)
    pw_bytes = row_bytes * (survivors + Pb) + up.nbytes + sum(x.numel() * x.element_size() for x in up.full.values())
    pw_bound, pw_by = bound(pw_bytes, 0, 0)
    shipped = int(up.fresh[:, 1].max()) + 1 if up.fresh.shape[0] else 0
    log(f"  patch_world: kernel {pw_ms:.4f} ms median of {[round(x, 4) for x in pw_all]}, wrapper "
        f"{pw_wrap_ms:.4f} ms, plain {pw_plain_ms:.3f} ms; kernel == plain on {len(steady)} cycles; "
        f"{survivors} survivors of {Pb} rows in {up.pieces.shape[0]} pieces, {up.fresh.shape[0]} rows built from "
        f"{shipped} shipped rows; bytes up {up.nbytes}; bytes {pw_bytes}, bound {pw_bound:.5f} ms ({pw_by}); one "
        f"launch {LATENCY['launch_ms']:.4f} ms")

    # the fused gate alone and wrapped, over the last cycle's final state
    rk, ck, pc, problem, ga, gbf = fused_check(list(proc.pods), "timing")
    t = dict(w.t)
    t.update(state_tensors(rk.state, problem.lane_valid, problem.lane_numeric))
    t["kind"], t["index"] = rk.kind, rk.index
    g_layouts, g_sets = gate_by_cluster("churn fused gate", lambda: gdev.gate_fused_args(t, pc),
                                       lambda: gdev.launch_gate_counts_fused(t, pc), ck.cpu().numpy(),
                                       time_ms, time_launches)
    g_layout = "cluster%d" % gdev.gate_blocks()
    g_ms, g_wrap_ms = g_layouts[g_layout]["ms"], g_layouts[g_layout]["wrapper_ms"]
    g_plain_ms, _ = time_ms(lambda: gdev.gate_counts_plain(gdev.gate_problem(problem), ga, gbf), 3)
    K, Wd = t["lvw"].shape
    P, R = t["pod_requests"].shape
    T, O, PT = t["it_alloc"].shape[0], t["offer_ok"].shape[1], t["pod_ports"].shape[1]
    g_bytes = io_bytes(g_sets[0][0], (), gdev.GATE_FUSED_SCRATCH)
    g_int = P * (K * (Wd + 3) + 2 * PT) + C * T * (K * Wd + O) + C * K * Wd
    g_flt = P * R + C * T * 2 * R
    g_bound, g_by = bound(g_bytes, g_int, g_flt)
    log(f"  gate_counts fused ({g_layout}): kernel {g_ms:.4f} ms, wrapper {g_wrap_ms:.4f} ms, plain "
        f"{g_plain_ms:.3f} ms; P={P} C={C} N={t['node_avail'].shape[0]}; bytes {g_bytes}, int ops {g_int:.4g}, "
        f"float ops {g_flt:.4g}; bound {g_bound:.5f} ms ({g_by}); latency floor "
        f"{g_layouts[g_layout]['latency_floor_ms']:.5f} ms")
    summary["launches"] = totals
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"  churn phase wall {summary['phase_s']:.1f}s")
    return [
        {
            "name": "patch_world",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/patch_world.cu",
            "replaces": "karpenter_tpu/ops/fused.py:211",
            "launches": totals["patch_world"],
            "max_abs_err": errs["patch"],
            "ms": pw_ms,
            "plain_ms": pw_plain_ms,
            "bound_ms": pw_bound,
            "bound_by": pw_by,
            "library_ms": None,
            "wrapper_ms": pw_wrap_ms,
            "bytes": pw_bytes,
            "h2d_bytes": up.nbytes,
            "latency_floor_ms": LATENCY["launch_ms"],
            "launches_per_patched_cycle": 1,
        },
        {
            "name": "gate_counts_fused",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/gate_counts.cu",
            "replaces": "karpenter_tpu/ops/fused.py:302",
            "also_replaces": ["karpenter_tpu/ops/fused.py:271"],
            "launches": totals["gate_counts"],
            "max_abs_err": errs["gate"],
            "ms": g_ms,
            "plain_ms": g_plain_ms,
            "bound_ms": g_bound,
            "bound_by": g_by,
            "library_ms": None,
            "wrapper_ms": g_wrap_ms,
            "bytes": g_bytes,
            "launches_per_cycle": 1,
            "layout": g_layout,
            "by_layout": g_layouts,
            "latency_floor_ms": g_layouts[g_layout]["latency_floor_ms"],
            "cycles_held_to_plain": fused_checks,
        },
    ], summary


def serve_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, main_workload, main_result):
    """Phase 5 (see the module docstring). Returns the stacked
    ``runs_screen`` entry of the kernels line."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels, serve
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.serve import batch as xbatch
    from karpenter_tpu_torch.serve.dispatcher import Ticket, _Request
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    t_phase = time.perf_counter()

    def catalog(n):
        its = instance_types(n)
        return its, [template_from_nodepool(NodePool(metadata=ObjectMeta(name="serve")), its, range(len(its)))]

    def placements(result):
        return ([(c.template_index, c.pod_indices, c.instance_type_indices, sorted(c.requests.items()))
                 for c in result.new_claims], sorted(result.node_pods.items()), sorted(result.failures))

    # -- 5a. the stacked kernel through serve.batch.stacked_solve, at two shapes
    shapes = {}
    max_err = 0.0
    for tag, n_pods, n_its in (("narrow", SERVE_PODS, SERVE_ITS), ("wide", WIDE_PODS, WIDE_ITS)):
        its, tpls = catalog(n_its)
        rng = random.Random(SERVE_SEED)
        group = [_Request(tenant=f"tenant-{t}", pods=[default_pod_factory(f"sv-0-{t}-{i}", rng) for i in range(n_pods)],
                          instance_types=its, templates=tpls, kwargs={}, deadline_s=0.0, submitted_at=0.0,
                          ticket=Ticket(f"tenant-{t}"))
                 for t in range(STACK_LANES)]
        captured = {}
        real_screen = M.batched_screen

        def spy(batch, C, passes=3):
            captured["args"] = (batch, C, passes)
            out = real_screen(batch, C, passes)
            captured["result"] = out
            return out

        stats = {}
        M.batched_screen = spy
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            results = xbatch.stacked_solve(group, device=dev, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            M.batched_screen = real_screen
        lanes = list(stats["lanes"])
        want = {**{k: 0 for k in kernels.LAUNCHES}, "runs_screen": 1}
        if launches != want or len(lanes) < 2:
            raise AssertionError(f"stacked {tag}: launches {launches}, lanes {lanes}: expected one runs_screen "
                                 f"launch with at least 2 lanes")
        answered = [i for i, r in enumerate(results) if r is not None]
        if not answered:
            raise AssertionError(f"stacked {tag}: every lane stood down: {stats['reasons']}")
        # every answered lane schedules what a solo solve of its pods does
        solo = TorchSolver(device=dev)
        for i in answered:
            control = solo.solve(group[i].pods, its, tpls)
            if results[i].num_scheduled() != control.num_scheduled():
                raise AssertionError(f"stacked {tag} lane {i}: {results[i].num_scheduled()} scheduled, a solo solve "
                                     f"{control.num_scheduled()}")
        torch.cuda.synchronize()
        batch, C, passes = captured["args"]
        rk = captured["result"]
        B = batch.pod_active.shape[0]
        checked = list(range(B)) if tag == "narrow" else [0, B - 1]
        sel = torch.tensor(checked, device=rk.kind.device)

        def against_plain(name, rk, rp):
            """Kind/index and integer and bool state exact on the checked
            lanes, float state within FLOAT_RTOL; the largest float
            difference."""
            if not (torch.equal(rk.kind[sel].cpu(), rp.kind.cpu()) and torch.equal(rk.index[sel].cpu(),
                                                                                      rp.index.cpu())):
                raise AssertionError(f"stacked {tag} {name}: kind/index differ from the plain version")
            sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
            err = 0.0
            for key in sp:
                a, b = sk[key][checked], sp[key]
                if a.dtype.kind == "f":
                    if not np.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, equal_nan=True):
                        raise AssertionError(f"stacked {tag} {name}: float state {key} differs")
                    fin = np.isfinite(a) & np.isfinite(b)
                    if fin.any():
                        err = max(err, float(np.abs(a[fin] - b[fin]).max()))
                elif not np.array_equal(a, b):
                    raise AssertionError(f"stacked {tag} {name}: state {key} differs")
            return err

        # the kernel against its plain version on the same stack: the screen
        # (the serve path's three passes) and batched_solve (one pass)
        rp, p_ms = plain_ms(lambda: M.batched_screen_plain(batch, C, passes, lanes=checked))
        max_err = max(max_err, against_plain("batched_screen", rk, rp))
        rk1 = M.batched_solve(batch, C)
        rp1, p1_ms = plain_ms(lambda: M.batched_solve_plain(batch, C, lanes=checked))
        max_err = max(max_err, against_plain("batched_solve", rk1, rp1))
        # alone: CUDA events around the launch over argument sets built
        # beforehand; through the wrapper; and batched_solve alone
        max_run, with_topo = M.max_run_bucket(batch), M.has_topo_runs(batch)
        sets = [M.stacked_screen_args(batch, C, max_run=max_run, passes=passes, with_topo=with_topo) for _ in range(5)]
        k_ms, k_all = time_launches("runs_screen", sets)
        for t, _ in sets:
            if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
                raise AssertionError(f"stacked {tag}: a timed launch differs from the wrapper's")
        w_ms, _ = time_ms(lambda: M.batched_screen(batch, C, passes), 5)
        sets1 = [M.stacked_screen_args(batch, C, max_run=max_run, passes=1, with_topo=with_topo) for _ in range(5)]
        k1_ms, _ = time_launches("runs_screen", sets1)
        work = dict(zip(M.RS_WORK_COUNTERS, rk.work.sum(dim=0).cpu().tolist()))
        nbytes = io_bytes(sets[0][0], (), M.RS_SCRATCH)
        a0 = sets[0][1]  # the problem's sizes are the struct's ints (the stack leads every leaf)
        K, Wd, O, R = a0.K, a0.W, a0.O, a0.R
        int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
        flt_ops = work["type_tests"] * 2 * R
        b_ms, b_by = bound(nbytes, int_ops, flt_ops)
        dims = {f: getattr(a0, f) for f in ("B", "P", "C", "T", "V", "W", "K", "N", "G", "R", "TPL", "RN", "MR")}
        # the launch's dynamic shared memory, as runs_screen_launch sizes it
        smem_of = kernels.library("runs_screen").runs_screen_smem_bytes
        smem_of.argtypes, smem_of.restype = [ctypes.c_void_p], ctypes.c_longlong
        dims["dyn_smem_bytes"] = int(smem_of(ctypes.addressof(a0)))
        t0 = sets[0][0]
        plan = t0["plan"].cpu().tolist()
        slow = int(t0["sections"].sum(dim=1).argmax())
        sections = split_by(M.RS_SECTIONS, t0["sections"][slow], k_ms)
        log(f"  stacked {tag}: plan {plan} (layout, blocks a lane, threads a block), the slowest lane ({slow}) by "
            f"section {sections}")
        by_layout = screen_by_layout(
            f"stacked {tag}", lambda: M.stacked_screen_args(batch, C, max_run=max_run, passes=passes,
                                                            with_topo=with_topo),
            rk, t0["ln"].shape[-1], time_launches)
        shapes[tag] = dict(lanes=len(lanes), answered=len(answered), reasons=stats["reasons"], dims=dims,
                           plan=plan, sections=sections, by_layout=by_layout,
                           wall_ms=wall * 1e3, split_ms=stats["timing"], ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
                           plain_lanes=len(checked), solve_ms=k1_ms, solve_plain_ms=p1_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, int_ops=int_ops, flt_ops=flt_ops, work=work,
                           scheduled=[r.num_scheduled() if r is not None else None for r in results],
                           claims=[len(r.new_claims) if r is not None else None for r in results])
        log(f"  stacked {tag}: {len(lanes)} lanes in one launch ({len(answered)} answered, reasons "
            f"{stats['reasons']}), dims {dims}; stacked_solve wall {wall * 1e3:.1f} ms = {stats['timing']}; "
            f"kernel {k_ms:.3f} ms median of {[round(x, 3) for x in k_all]}, wrapper {w_ms:.3f} ms, plain "
            f"{p_ms:.1f} ms on {len(checked)} lanes; batched_solve kernel {k1_ms:.3f} ms, plain {p1_ms:.1f} ms; "
            f"kernel == plain (max float err {max_err}); bytes {nbytes}, int ops {int_ops:.4g}, float ops "
            f"{flt_ops:.4g}, bound {b_ms:.5f} ms ({b_by}); scheduled {shapes[tag]['scheduled']} = solo")

    # -- 5b. the serve scenario at the reference's full size
    its, tpls = catalog(SERVE_ITS)
    rng = random.Random(SERVE_SEED)
    problems = [[[default_pod_factory(f"sv-{c}-{t}-{i}", rng) for i in range(SERVE_PODS)]
                 for t in range(SERVE_TENANTS)] for c in range(SERVE_CYCLES)]
    shared = TorchSolver(device=dev)
    service = serve.SolveService(device=dev)
    supervisors = {f"tenant-{t}": serve.build_tenant_solver(f"tenant-{t}", primary=shared, fallback=OracleSolver())
                   for t in range(SERVE_TENANTS)}
    for name, solver in supervisors.items():
        service.register_tenant(name, solver=solver)
    service.start()

    def serve_pass():
        lat, outs = [], []
        t0 = time.perf_counter()
        for cycle in problems:
            tickets = [service.submit(f"tenant-{t}", cycle[t], its, tpls) for t in range(SERVE_TENANTS)]
            outs += [tk.wait(timeout=300.0) for tk in tickets]
        wall = time.perf_counter() - t0
        bad = [(o.tenant, o.status, o.reason) for o in outs if o.status != "ok"]
        if bad:
            raise AssertionError(f"serve: {len(bad)} tickets not ok: {bad[:4]}")
        return wall, sorted(o.latency_s for o in outs), outs

    try:
        serve_pass()  # warm pass
        before = service.summary()
        kernels.reset_launches()
        serve_wall, lat, outs = serve_pass()
        torch.cuda.synchronize()
        serve_launches = dict(kernels.LAUNCHES)
        after = service.summary()
    finally:
        service.close()
    completed = after["completed"] - before["completed"]
    batched = after["batched"] - before["batched"]
    if after["errors"] or completed != SERVE_TENANTS * SERVE_CYCLES:
        raise AssertionError(f"serve: {after}")
    if serve_launches["runs_screen"] <= 0:
        raise AssertionError(f"serve: the measured pass never launched the stacked runs_screen: {serve_launches}")
    control = SupervisedSolver(shared, fallback=OracleSolver())
    for _ in range(2):  # the second pass is timed
        t0 = time.perf_counter()
        for cycle in problems:
            for t in range(SERVE_TENANTS):
                control.solve(cycle[t], its, tpls)
        torch.cuda.synchronize()
        seq_wall = time.perf_counter() - t0
    # neither side's walls may hide a failover to the host oracle, a retry
    # or a rejection
    for name, sup_ in {**supervisors, "sequential control": control}.items():
        if sup_.circuit_state() != "closed" or any(sup_.counters.values()):
            raise AssertionError(f"serve: {name}: circuit {sup_.circuit_state()}, counters {sup_.counters}")
    pods_total = SERVE_TENANTS * SERVE_CYCLES * SERVE_PODS
    scenario = dict(tenants=SERVE_TENANTS, cycles=SERVE_CYCLES, pods_per_cycle=SERVE_PODS, serve_wall_s=serve_wall,
                    sequential_wall_s=seq_wall, agg_pods_per_s=pods_total / serve_wall,
                    vs_sequential=seq_wall / serve_wall, p50_cycle_s=statistics.median(lat),
                    p99_cycle_s=lat[min(len(lat) - 1, int(0.99 * len(lat)))], completed=completed, batched=batched,
                    batch_hit_rate=batched / max(completed, 1), launches=serve_launches,
                    paths={p_: sum(o.path == p_ for o in outs) for p_ in ("batched", "solo")})

    # the overload probe: a 2-deep queue, a 20 ms solver, a 50 ms budget
    class _Slow:
        def solve(self, pods, its_, tpls_, **kw):
            time.sleep(0.02)
            return type("R", (), {"num_scheduled": lambda s: 0, "new_claims": (), "node_pods": {},
                                  "failures": {}})()

    probe = serve.SolveService(queue_depth=2, batching=False, device=dev)
    probe.register_tenant("flood", solver=_Slow())
    probe.start()
    try:
        flood = [probe.submit("flood", problems[0][0][:4], its, tpls, deadline_s=0.05) for _ in range(24)]
        flood_outs = [tk.wait(timeout=60.0) for tk in flood]
    finally:
        probe.close()
    statuses = {}
    for o in flood_outs:
        key = o.status if o.status == "ok" else f"{o.status}:{o.reason}"
        statuses[key] = statuses.get(key, 0) + 1
    unclassified = sum(1 for o in flood_outs
                       if o.status not in ("ok", "overloaded", "rejected") or (o.status != "ok" and not o.reason))
    if unclassified:
        raise AssertionError(f"overload probe: {unclassified} unclassified outcomes: {statuses}")
    scenario["overload"] = dict(submitted=len(flood_outs), statuses=statuses, unclassified=unclassified)
    log(f"  serve: {SERVE_TENANTS} tenants x {SERVE_CYCLES} cycles x {SERVE_PODS} pods: serve wall "
        f"{serve_wall:.4f} s, sequential {seq_wall:.4f} s, {scenario['agg_pods_per_s']:.1f} pods/s, vs_sequential "
        f"{scenario['vs_sequential']:.3f}, p50 {scenario['p50_cycle_s']:.4f} s, p99 {scenario['p99_cycle_s']:.4f} s, "
        f"completed {completed}, batched {batched} (hit rate {scenario['batch_hit_rate']:.3f}), launches "
        f"{serve_launches}; overload probe {statuses}")

    # -- the supervised main path: phase 2's batch through SupervisedSolver
    pods, its, tpls, nodes = main_workload
    sup = SupervisedSolver(TorchSolver(initial_claim_slots=128, device=dev), fallback=OracleSolver())
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sup.solve(pods, its, tpls, nodes)
    torch.cuda.synchronize()
    sup_wall = time.perf_counter() - t0
    sup_launches = dict(kernels.LAUNCHES)
    if placements(res) != placements(main_result):
        raise AssertionError("supervised main path: placements differ from phase 2's")
    if sup.circuit_state() != "closed" or any(sup.counters.values()):
        raise AssertionError(f"supervised main path: circuit {sup.circuit_state()}, counters {sup.counters}")
    for name in ("ffd_loop", "gate_counts", "relax_place"):
        if sup_launches[name] <= 0:
            raise AssertionError(f"supervised main path never launched {name}: {sup_launches}")
    supervised = dict(wall_ms=sup_wall * 1e3, launches=sup_launches, scheduled=res.num_scheduled(),
                      circuit=sup.circuit_state(), counters=dict(sup.counters))
    log(f"  supervised main path: {res.num_scheduled()}/{len(pods)} scheduled, placements == phase 2's, circuit "
        f"closed, counters {sup.counters}; wall {sup_wall * 1e3:.1f} ms; launches {sup_launches}")
    log(f"  serve phase wall {time.perf_counter() - t_phase:.1f}s")
    wide = shapes["wide"]
    return {
        "name": "runs_screen_stacked",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/runs_screen.cu",
        "replaces": "karpenter_tpu/parallel/mesh.py:154",
        "also_replaces": ["karpenter_tpu/parallel/mesh.py:88"],
        "launches": serve_launches["runs_screen"],
        "max_abs_err": max_err,
        "ms": wide["ms"],
        "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"],
        "library_ms": None,
        "wrapper_ms": wide["wrapper_ms"],
        "plain_lanes": wide["plain_lanes"],
        "float_rtol": FLOAT_RTOL,
        "shapes": shapes,
        "serve": scenario,
        "supervised": supervised,
    }


def wave_hist_of(result):
    return None if result.wave_hist is None else [int(x) for x in result.wave_hist.cpu().tolist()]


def same_placements(tag, result, ref):
    """Raise unless ``result`` places every pod as ``ref`` does: the same
    claims (pool, template, pods, instance types) in order, node pods and
    failures; the claims' requests within FLOAT_RTOL (a chain the flag-off
    loop commits in two iterations rounds twice). Returns the largest
    relative request difference."""
    if (len(result.new_claims), result.node_pods, result.failures) != (len(ref.new_claims), ref.node_pods,
                                                                        ref.failures):
        raise AssertionError(f"{tag}: placements differ from the reference solve's")
    worst = 0.0
    for a, b in zip(result.new_claims, ref.new_claims):
        if (a.nodepool_name, a.template_index, a.pod_indices, a.instance_type_indices) != \
                (b.nodepool_name, b.template_index, b.pod_indices, b.instance_type_indices) \
                or a.requests.keys() != b.requests.keys():
            raise AssertionError(f"{tag}: placements differ from the reference solve's")
        for key, value in b.requests.items():
            diff = abs(a.requests[key] - value) / max(abs(value), 1e-30)
            if diff > FLOAT_RTOL:
                raise AssertionError(f"{tag}: claim requests {key} differ by {diff}")
            worst = max(worst, diff)
    return worst


def wave_kernels_phase(dev, encode, compare_results, weights):
    """Phase 1's wavefront corpora: ``ffd_loop`` with the wavefront on
    (csrc/wave.cuh) against ``sweeps_plain`` with it, at W = 4 and W = 2
    (3 and 1 extra lanes), in every sweeps mode: fresh, carried (from all-FAIL
    seeds, and from the waterfill's phase 1 where it places), scored (the
    committed weights), the lanes mode on two lanes and the fused launch.
    Kinds, indices, the 7 IterCounts fields and wave_hist bit-equal, the
    state as compare_results holds it. Returns the largest float state
    difference."""
    import torch

    from karpenter_tpu_torch.models.problem import problem_to_torch
    from karpenter_tpu_torch.ops import fused
    from karpenter_tpu_torch.ops import policy as POL
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state, problem_bounds_free
    from karpenter_tpu_torch.ops.ffd_sweeps import (
        fresh_carry,
        launch_ffd_loop_lanes,
        solve_ffd_sweeps,
        solve_ffd_sweeps_carried,
        sweeps_plain,
    )
    from karpenter_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    err = 0.0
    saw = {"commits": False, "retries": False, "node-lanes": False, "phase1-carried": False, "scored-requeue": False}

    def check(tag, rk, rp):
        nonlocal err
        torch.cuda.synchronize()
        err = max(err, compare_results(tag, rk, rp))
        if wave_hist_of(rk) != wave_hist_of(rp) or rk.wave_hist is None:
            raise AssertionError(f"{tag}: wave_hist {wave_hist_of(rk)} != plain {wave_hist_of(rp)}")

    for tag, wl, slots in WAVE_CORPORA(W):
        padded = encode(wl, slots)
        prob = problem_to_torch(padded, dev)
        bf = problem_bounds_free(prob)
        scores = POL.lane_scores(prob, weights)
        xp = RX.relax_place_plain(prob, slots)
        pc = torch.ones((prob.num_pods,), dtype=torch.bool, device=dev)
        for lanes in (3, 1):
            name = f"{tag} W={lanes + 1}"
            rp = sweeps_plain(prob, initial_state(prob, slots), bf, wavefront=lanes)
            check(f"{name} fresh", solve_ffd_sweeps(prob, slots, wavefront=lanes), rp)
            check(f"{name} carried", solve_ffd_sweeps_carried(prob, slots, init=fresh_carry(prob, slots),
                                                              wavefront=lanes), rp)
            if int(xp.stats[1]) > 0:
                res = dataclasses.replace(prob, pod_active=xp.residue_active)
                ares, astate = _lane_align(res, xp.state)
                cp = sweeps_plain(ares, astate, problem_bounds_free(ares), xp.kind, xp.index, wavefront=lanes)
                check(f"{name} carried from phase 1",
                      solve_ffd_sweeps_carried(res, slots, init=(xp.state, xp.kind, xp.index), wavefront=lanes), cp)
                saw["phase1-carried"] = True
            sp = sweeps_plain(prob, initial_state(prob, slots), bf, order_scores=scores, wavefront=lanes)
            check(f"{name} scored", solve_ffd_sweeps(prob, slots, order_scores=scores, wavefront=lanes), sp)
            saw["scored-requeue"] |= int(sp.iters.sweeps) > 1
            for b, lk in enumerate(launch_ffd_loop_lanes([prob, prob], [initial_state(prob, slots)] * 2,
                                                         wavefront=lanes)):
                check(f"{name} lanes mode, lane {b}", lk, rp)
            world = fused.adopt_world(padded, slots, dev)
            fk, _ = fused.solve_ffd_fused_gate(world, pc, slots, bf, wavefront=lanes)
            check(f"{name} fused", fk, rp)
            saw["commits"] |= rp.iters.wave_commits > 0
            saw["retries"] |= rp.iters.retry_lanes > 0
            saw["node-lanes"] |= prob.num_nodes > 0 and rp.iters.wave_commits > 0
            log(f"  {name}: P={prob.num_pods} N={prob.num_nodes} G={prob.num_groups} iters {tuple(rp.iters)} "
                f"wave_hist {wave_hist_of(rp)}: fresh, carried, scored, lanes, fused == plain")
    missing = [k for k, v in saw.items() if not v]
    if missing:
        raise AssertionError(f"the wavefront corpora do not cover: {missing}")
    log(f"  wavefront corpora wall {time.perf_counter() - t_phase:.1f}s")
    return err


def WAVE_CORPORA(W):
    """The wavefront's corpora (tests/test_wavefront_parity.py's seeds, a
    chain-heavy one, and fuzz/topology corpora with existing nodes)."""
    return [
        ("wave-4000", W.wave_workload(4000), 128),
        ("wave-4001", W.wave_workload(4001), 128),
        ("wave-4002", W.wave_workload(4002), 128),
        ("chain-3003", W.chain_workload(3003), 128),
        ("fuzz-3", W.fuzz_workload(3), 32),
        ("topology-8", W.topology_workload(8), 32),
    ]


def wavefront_phase(dev, main, time_ms, time_launches, plain_ms, ffd_bound, compare_results):
    """Phase 9: the wavefront at full width. Phase 2's batch through
    ``TorchSolver.solve`` with ``KARPENTER_TPU_WAVEFRONT=1`` (W = 4), fresh
    (``relax=False``) and carried (``relax=True``), the launch counts read
    around each solve: one ``ffd_loop_wavefront`` launch, ``full_gate``
    clean, IterCounts and wave_hist equal to the JAX package's
    (EXPECT_WAVE), placements equal to phase 2's flag-off solves. Then the
    mode alone and through its wrapper at phase 2's inputs, beside the
    flag-off loop's times on this run, and the carried launch against its
    plain loop. Returns the kernels-line entry."""
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.ops.ffd_core import initial_state, problem_bounds_free
    from karpenter_tpu_torch.ops.ffd_sweeps import (
        FFD_SCRATCH,
        WORK_COUNTERS,
        ffd_loop_args,
        solve_ffd_sweeps,
        solve_ffd_sweeps_carried,
        sweeps_plain,
    )
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.verify import full_gate

    t_phase = time.perf_counter()
    log("phase 9: the wavefront (KARPENTER_TPU_WAVEFRONT=1, W=4) at full width")
    pods, its, tpls, nodes = main["workload"]
    lanes = WAVE_WIDTH - 1
    solves = {}
    old = {k: os.environ.get(k) for k in ("KARPENTER_TPU_WAVEFRONT", "KARPENTER_TPU_WAVEFRONT_WIDTH")}
    os.environ["KARPENTER_TPU_WAVEFRONT"] = "1"
    os.environ["KARPENTER_TPU_WAVEFRONT_WIDTH"] = str(WAVE_WIDTH)
    try:
        for tag, relax in (("fresh", False), ("carried", True)):
            for rep in range(2):  # the second solve is the warm one
                solver = TorchSolver(initial_claim_slots=128, device=dev, relax=relax)
                kernels.reset_launches()
                t0 = time.perf_counter()
                result = solver.solve(pods, its, tpls, nodes)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
            outcome = full_gate(result, pods, its, tpls, nodes)
            torch.cuda.synchronize()
            if outcome is None or outcome.violations or outcome.counts or outcome.mode != "device":
                raise AssertionError(f"wavefront {tag}: gate rejected or could not run: {outcome}")
            want = {"ffd_loop_wavefront": 1, "ffd_loop": 0, "relax_place": int(relax), "gate_counts": int(relax)}
            if any(launches[k] != v for k, v in want.items()):
                raise AssertionError(f"wavefront {tag}: launches {launches}, want {want}")
            expect = EXPECT_WAVE[tag]
            got = dict(iters=tuple(solver.last_iters), wave_hist=solver.last_wave_hist,
                       scheduled=result.num_scheduled(), claims=len(result.new_claims))
            if got != {k: expect[k] for k in got}:
                raise AssertionError(f"wavefront {tag}: {got} != the JAX package's {expect}")
            req_err = same_placements(f"wavefront {tag}", result, main["result" if relax else "result_off"])
            tm = solver.last_timing
            log(f"  {tag}: scheduled {got['scheduled']}/{len(pods)} claims={got['claims']} iters={got['iters']} "
                f"wave_hist={got['wave_hist']} == EXPECT_WAVE; placements == flag off (claim requests within "
                f"{req_err:.3g} relative); launches {launches}; "
                f"solve wall {wall * 1e3:.1f} ms (encode {tm['encode'] * 1e3:.1f}, device {tm['device'] * 1e3:.1f})")
            solves[tag] = dict(wall_ms=wall * 1e3, launches=launches["ffd_loop_wavefront"], iters=got["iters"],
                               wave_hist=got["wave_hist"], device_ms=tm["device"] * 1e3)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # the mode alone, wrapped and plain at phase 2's inputs, beside the
    # flag-off loop on this run
    prob, C, rxk, residue, astate = main["prob"], main["C"], main["rxk"], main["residue"], main["astate"]
    bf = problem_bounds_free(prob)
    init_c = (rxk.state, rxk.kind, rxk.index)
    out = {}
    # the carried launch (the default path's mode) is held to its plain loop
    # here; the fresh one to the JAX package's IterCounts and wave_hist
    # (EXPECT_WAVE) and to its plain loop on phase 1's corpora (its 10k plain
    # loop, ~24 s, is left out so that the smoke keeps its time with phase 14)
    for tag, run_k, run_p, arg_sets in (
        ("fresh", lambda w: solve_ffd_sweeps(prob, C, wavefront=w), None,
         lambda w: [ffd_loop_args(prob, initial_state(prob, C), False, wavefront=w) for _ in range(3)]),
        ("carried", lambda w: solve_ffd_sweeps_carried(residue, C, init_c, wavefront=w),
         lambda w: sweeps_plain(residue, astate, problem_bounds_free(residue), rxk.kind, rxk.index, wavefront=w),
         lambda w: [ffd_loop_args(residue, astate, False, rxk.kind, rxk.index, wavefront=w) for _ in range(3)]),
    ):
        rk = run_k(lanes)
        sets = arg_sets(lanes)
        ms, all_ms = time_launches("ffd_loop", sets)
        for t, _ in sets:
            if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
                raise AssertionError(f"wavefront {tag}: a timed launch differs from the wrapper's")
        wrap_ms, _ = time_ms(lambda: run_k(lanes), 2)
        off_ms, off_all = time_launches("ffd_loop", arg_sets(0))
        off_wrap_ms, _ = time_ms(lambda: run_k(0), 2)
        if run_p is None:
            p_ms, err = None, 0.0
            iters = tuple(int(x) for x in rk.iters)
            if wave_hist_of(rk) != EXPECT_WAVE[tag]["wave_hist"] or iters != solves[tag]["iters"]:
                raise AssertionError(f"wavefront {tag}: kernel {iters} {wave_hist_of(rk)} vs {EXPECT_WAVE[tag]}")
        else:
            rp, p_ms = plain_ms(lambda: run_p(lanes))
            err = compare_results(f"wavefront {tag} kernel vs plain", rk, rp)
            if wave_hist_of(rk) != wave_hist_of(rp) or tuple(int(x) for x in rk.iters) != solves[tag]["iters"]:
                raise AssertionError(f"wavefront {tag}: kernel {tuple(rk.iters)} {wave_hist_of(rk)} vs plain "
                                     f"{tuple(rp.iters)} {wave_hist_of(rp)}")
        work = dict(zip(WORK_COUNTERS, rk.work.cpu().tolist()))
        b_ms, b_by, b_bytes, b_int, b_flt = ffd_bound(work, sets[0][0])
        out[tag] = dict(ms=ms, all_ms=all_ms, wrap_ms=wrap_ms, off_ms=off_ms, off_all_ms=off_all,
                        off_wrap_ms=off_wrap_ms, plain_ms=p_ms, err=err, work=work, bound_ms=b_ms, bound_by=b_by,
                        iters=tuple(int(x) for x in rk.iters), wave_hist=wave_hist_of(rk))
        log(f"  ffd_loop {tag} with the wavefront: kernel {ms:.3f} ms median of {[round(x, 3) for x in all_ms]}, "
            f"wrapper {wrap_ms:.3f} ms; flag off on this run: kernel {off_ms:.3f} ms median of "
            f"{[round(x, 3) for x in off_all]}, wrapper {off_wrap_ms:.3f} ms; "
            f"{'== EXPECT_WAVE' if p_ms is None else f'plain {p_ms:.1f} ms, kernel == plain'}; "
            f"work {work}; bytes {b_bytes}, int ops {b_int:.4g}, float ops {b_flt:.4g}, bound {b_ms:.5f} ms ({b_by})")
    log(f"  phase 9 wall {time.perf_counter() - t_phase:.1f}s")
    c = out["carried"]
    return {
        "name": "ffd_loop_wavefront",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/wave.cuh",
        "replaces": "karpenter_tpu/ops/ffd_sweeps.py:473",
        "launches": solves["carried"]["launches"],
        "max_abs_err": max(out["fresh"]["err"], c["err"]),
        "ms": c["ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None,
        "wrapper_ms": c["wrap_ms"],
        "flag_off_ms": c["off_ms"],
        "flag_off_wrapper_ms": c["off_wrap_ms"],
        "work": c["work"],
        "iters": c["iters"],
        "wave_hist": c["wave_hist"],
        "fresh": {k: out["fresh"][k] for k in ("ms", "wrap_ms", "off_ms", "off_wrap_ms", "plain_ms", "bound_ms",
                                              "work", "iters", "wave_hist")},
        "launches_fresh_solve": solves["fresh"]["launches"],
        "solves": solves,
    }


def provision_digest(pass_):
    """A ProvisioningPass in creation order, with the claims' random names
    left out: per claim its pool, its instance-type requirement values and
    its pods; the pods nominated to existing nodes; the failed pods."""
    import hashlib

    from karpenter_tpu_torch.apis import labels as wk

    rows = []
    for claim in pass_.created:
        reqs = {r.key: sorted(r.values) for r in claim.spec.requirements}
        pods = sorted(pass_.inputs.pods[i].metadata.name for i in pass_.claim_pods[claim.metadata.name])
        rows.append([claim.metadata.labels[wk.NODEPOOL_LABEL_KEY], reqs.get(wk.LABEL_INSTANCE_TYPE_STABLE, []), pods])
    nodes = sorted([name, sorted(pass_.inputs.pods[i].metadata.name for i in idx)]
                   for name, idx in pass_.result.node_pods.items())
    failed = sorted(pass_.inputs.pods[i].metadata.name for i in pass_.result.failures)
    blob = json.dumps([rows, nodes, failed], sort_keys=True).encode()
    return dict(claims=len(rows), on_claims=sum(len(r[2]) for r in rows), failed=len(failed),
                sha256=hashlib.sha256(blob).hexdigest())


def provision_phase(dev):
    """Phase 10: the entry point at the 10k shape. A FakeCloudProvider over
    400 catalog types, one ``default`` NodePool and 10,000 makeDiversePods
    pods created in the KubeClient; one ``Provisioner.reconcile()`` through
    ``SupervisedSolver(TorchSolver(), fallback=OracleSolver())`` on the card,
    with the wavefront off and on, the launch counts read around it. The
    created NodeClaims (pool, instance-type values, pods, in creation order)
    must equal the JAX package's Provisioner over JaxSolver (EXPECT_PROVISION),
    the circuit stays closed with no fallback. Prints the split: inputs
    (build_inputs), the solve (its last_timing), create_node_claims, wall."""
    import random

    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS, FakeCloudProvider, instance_types
    from karpenter_tpu_torch.events import Recorder
    from karpenter_tpu_torch.kube import KubeClient
    from karpenter_tpu_torch.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.state.informer import start_informers
    from karpenter_tpu_torch.testing import workloads as W
    from karpenter_tpu_torch.utils.clock import FakeClock

    t_phase = time.perf_counter()
    log(f"phase 10: Provisioner.reconcile() at the 10k shape ({MAIN_PODS} pods, 400 types, 1 NodePool)")
    catalog = instance_types(400)
    records = {}
    old = os.environ.get("KARPENTER_TPU_WAVEFRONT")
    try:
        for flag in ("0", "1"):
            os.environ["KARPENTER_TPU_WAVEFRONT"] = flag
            clock = FakeClock()
            kube = KubeClient(clock=clock)
            cluster = Cluster(kube, clock)
            start_informers(kube, cluster)
            cloud = FakeCloudProvider()
            cloud.instance_types = catalog
            primary = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, initial_claim_slots=128, device=dev)
            sup = SupervisedSolver(primary, fallback=OracleSolver())
            prov = Provisioner(kube, cloud, cluster, clock, Recorder(clock=clock), solver=sup)
            kube.create(NodePool(metadata=ObjectMeta(name="default", namespace="")))
            for pod in W.make_diverse_pods(MAIN_PODS, random.Random(42)):
                kube.create(pod)
            split = {"inputs": 0.0, "create": 0.0}

            def timed(key, fn):
                def run(*args, **kwargs):
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        split[key] += time.perf_counter() - t0
                return run

            prov.build_inputs = timed("inputs", prov.build_inputs)
            prov.create_node_claims = timed("create", prov.create_node_claims)
            kernels.reset_launches()
            t0 = time.perf_counter()
            pass_ = prov.reconcile()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            digest = provision_digest(pass_)
            expect = EXPECT_PROVISION[flag]
            if digest != {k: expect[k] for k in digest}:
                raise AssertionError(f"provision wavefront={flag}: {digest} != the JAX package's {expect}")
            if (tuple(primary.last_iters), primary.last_wave_hist) != (expect["iters"], expect["wave_hist"]):
                raise AssertionError(f"provision wavefront={flag}: iters {primary.last_iters} "
                                     f"{primary.last_wave_hist} != {expect['iters']} {expect['wave_hist']}")
            if sup.circuit_state() != "closed" or any(sup.counters[k] for k in (
                    "solve_fallbacks", "solve_retries", "validator_rejections")):
                raise AssertionError(f"provision wavefront={flag}: circuit {sup.circuit_state()}, {sup.counters}")
            loop = "ffd_loop_wavefront" if flag == "1" else "ffd_loop"
            # gate_counts twice: the solve's relaxed gate, then the
            # supervisor's validation of the result (as phase 5's)
            if launches[loop] != 1 or launches["relax_place"] != 1 or launches["gate_counts"] != 2:
                raise AssertionError(f"provision wavefront={flag}: launches {launches}")
            tm = primary.last_timing
            solve_s = sum(tm.values())
            log(f"  wavefront={flag}: {digest['claims']} NodeClaims for {digest['on_claims']} pods, {digest['failed']} "
                f"failed == EXPECT_PROVISION; iters {tuple(primary.last_iters)} wave_hist {primary.last_wave_hist}; "
                f"circuit closed, no fallback; launches {launches}")
            log(f"  wavefront={flag}: reconcile wall {wall * 1e3:.1f} ms = build_inputs {split['inputs'] * 1e3:.1f} + "
                f"solve {solve_s * 1e3:.1f} (" + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in tm.items())
                + f") + create_node_claims {split['create'] * 1e3:.1f} + the rest "
                f"{(wall - split['inputs'] - split['create'] - solve_s) * 1e3:.1f}")
            records[flag] = dict(wall_ms=wall * 1e3, inputs_ms=split["inputs"] * 1e3, solve_ms=solve_s * 1e3,
                                 create_ms=split["create"] * 1e3, timing_ms={k: v * 1e3 for k, v in tm.items()},
                                 launches=launches[loop], claims=digest["claims"])
    finally:
        if old is None:
            os.environ.pop("KARPENTER_TPU_WAVEFRONT", None)
        else:
            os.environ["KARPENTER_TPU_WAVEFRONT"] = old
    log(f"  phase 10 wall {time.perf_counter() - t_phase:.1f}s")
    return records


def disruption_phase(dev, time_ms, time_launches, plain_ms):
    """Phase 11 (see the module docstring). Returns the phase's record."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.nodepool import Budget, Disruption, NodePool
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS, instance_types
    from karpenter_tpu_torch.disruption import batch, consolidation, controller
    from karpenter_tpu_torch.disruption.types import DECISION_NONE
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32, initial_state
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.state.statenode import disruption_taint
    from karpenter_tpu_torch.testing.harness import Env

    t_phase = time.perf_counter()
    log(f"phase 11: the disruption pass, {DISRUPT_CANDIDATES} candidates + {DISRUPT_SURVIVORS} survivors, "
        f"100 types, 1 NodePool")
    primary = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=dev)
    sup = SupervisedSolver(primary, fallback=OracleSolver())
    env = Env(solver=sup)
    env.cloud_provider.instance_types = instance_types(100)
    pool = NodePool(metadata=ObjectMeta(name="default", namespace=""))
    pool.spec.disruption = Disruption(consolidation_policy="WhenUnderutilized", budgets=[Budget(nodes="100%")])
    env.create(pool)
    rng = random.Random(DISRUPT_SEED)
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    n_pods = 0
    for i in range(DISRUPT_CANDIDATES):
        name = f"cand-node-{i:04d}"
        pods = [
            Pod(metadata=ObjectMeta(name=f"p-{i}-{j}", labels={"app": f"a{j % 5}"}),
                spec=PodSpec(containers=[Container(requests={
                    "cpu": rng.choice([0.1, 0.25, 0.5]), "memory": rng.choice([128, 256, 512]) * 1024.0**2})]))
            for j in range(rng.randint(1, 4))
        ]
        n_pods += len(pods)
        env.create_candidate_node(name, it_name=DISRUPT_CANDIDATE_TYPE, zone=zones[i % 3], pods=pods)
    for i in range(DISRUPT_SURVIVORS):
        node, _ = env.create_candidate_node(f"big-node-{i}", it_name=DISRUPT_SURVIVOR_TYPE, zone=zones[i % 3])
        node.metadata.annotations[wk.DO_NOT_DISRUPT_ANNOTATION_KEY] = "true"
        env.kube.update(node)
    log(f"  cluster built: {len(env.nodes())} nodes, {n_pods} candidate pods, "
        f"{time.perf_counter() - t_phase:.1f}s")

    # the pass's split: each stage's wall, summed, by pass
    split = {}
    stage = {"pass": 1}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                k = f"{key}{stage['pass']}"
                split[k] = split.get(k, 0.0) + time.perf_counter() - t0
        return run

    captured = {}
    real = {
        "ctrl_get": controller.get_candidates, "cons_get": consolidation.get_candidates,
        "build": batch.build_scorer, "init": batch.UnionScorer.__init__, "score": batch.UnionScorer.score_subsets,
        "compute": consolidation.ConsolidationBase.compute_consolidation, "lean": batch.lean_screen,
        "residual": batch.residual_screen,
    }

    def lean(base, variants, C, passes=3):
        out = real["lean"](base, variants, C, passes)
        captured.setdefault("screens", []).append(("full", (base, variants, C, passes), out))
        return out

    def residual(base, carried, variants, run_idx, C):
        out = real["residual"](base, carried, variants, run_idx, C)
        captured.setdefault("screens", []).append(("residual", (base, carried, variants, run_idx, C), out))
        return out

    def build(prov, cands):
        scorer = real["build"](prov, cands)
        captured["scorer"] = scorer
        return scorer

    def score(self, subsets, passes=3):
        out = real["score"](self, subsets, passes)
        captured.setdefault("scored", []).append((list(map(tuple, subsets)), out))
        return out

    controller.get_candidates = timed("get_candidates", real["ctrl_get"])
    consolidation.get_candidates = timed("get_candidates", real["cons_get"])
    batch.build_scorer = timed("scorer_build", build)
    batch.UnionScorer.__init__ = timed("scorer_encode", real["init"])
    batch.UnionScorer.score_subsets = timed("screen", score)
    consolidation.ConsolidationBase.compute_consolidation = timed("simulate", real["compute"])
    batch.lean_screen, batch.residual_screen = lean, residual
    ctrl = env.disruption_controller()
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = ctrl.reconcile()
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches1 = dict(kernels.LAUNCHES)
        pending = ctrl.pending
        if first is not None or pending is None:
            raise AssertionError(f"disruption: the first pass returned {first}, pending {pending}")
        # the screen's own check (step 4) runs between the passes, while the
        # cluster is as the first pass saw it, outside the counted windows
        screens, scored, scorer = captured.pop("screens", []), captured.pop("scored", []), captured["scorer"]
        stats = {k: v for k, v in scorer.last_screen_stats.items() if "counts" not in k}
        stage["pass"] = 0
        check = disruption_screen_check(env, scorer, pending, scored, consolidation, DECISION_NONE)
        env.clock.step(pending.method.validation_ttl + 0.1)
        stage["pass"] = 2
        kernels.reset_launches()
        t0 = time.perf_counter()
        cmd = ctrl.reconcile()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        launches2 = dict(kernels.LAUNCHES)
    finally:
        controller.get_candidates, consolidation.get_candidates = real["ctrl_get"], real["cons_get"]
        batch.build_scorer, batch.UnionScorer.__init__ = real["build"], real["init"]
        batch.UnionScorer.score_subsets = real["score"]
        consolidation.ConsolidationBase.compute_consolidation = real["compute"]
        batch.lean_screen, batch.residual_screen = real["lean"], real["residual"]
    if cmd is None or cmd.decision == DECISION_NONE:
        raise AssertionError(f"disruption: no command executed after the TTL ({cmd})")
    launches = {k: launches1[k] + launches2[k] for k in launches1}
    taint = disruption_taint()
    tainted = sorted(n.metadata.name for n in env.nodes() if any(t.match(taint) for t in n.spec.taints))
    marked = sorted(sn.name for sn in env.cluster.nodes() if sn.marked_for_deletion())
    names = sorted(c.name for c in cmd.candidates)
    replacements = [r.metadata.name for r in cmd.replacements]
    created = [r for r in replacements if env.kube.get_opt(type(cmd.replacements[0]), r, "") is not None]
    if tainted != names or marked != names or len(created) != len(replacements) or len(ctrl.queue.items) != 1:
        raise AssertionError(f"disruption: the queue's changes differ from the command: tainted {len(tainted)}, "
                             f"marked {len(marked)}, candidates {len(names)}, replacements created {created}")
    log(f"  executed: {cmd.method} {cmd.decision}, {len(cmd.candidates)} candidates ({names[0]} ... {names[-1]}), "
        f"{len(cmd.replacements)} replacements; the queue tainted {len(tainted)} nodes, marked {len(marked)}, "
        f"created {len(created)} claims, holds {len(ctrl.queue.items)} command")

    # step 3: one screening launch, its rows against the plain screen's on
    # every lane (equal rows decode to equal verdicts)
    if launches1["runs_screen"] != 1 or len(screens) != 1 or len(scored) != 1 or launches2["runs_screen"] != 0:
        raise AssertionError(f"disruption: {launches1['runs_screen']} + {launches2['runs_screen']} runs_screen "
                             f"launches, {len(screens)} screens, {len(scored)} score calls; expected one each")
    mode, args, rk = screens[0]
    subsets, verdicts = scored[0]
    B = len(subsets)
    checked = list(range(rk.kind.shape[0]))
    if mode == "residual":
        base, carried, variants, run_idx, C = args
        plain = lambda: M.residual_screen_plain(base, carried, variants, run_idx, C, lanes=checked)  # noqa: E731
        base = _pad_lanes_mult32(base)
        p0 = M.trim_runs(base, run_idx)
        make_args = lambda: M.runs_screen_args(p0, carried, variants.node_avail, variants.pod_active,  # noqa: E731
                                               max_run=M.max_run_bucket(base), passes=1, with_topo=False)
        wrap = lambda: M.residual_screen(args[0], carried, variants, run_idx, C)  # noqa: E731
    else:
        base, variants, C, passes = args
        plain = lambda: M.lean_screen_plain(base, variants, C, passes, lanes=checked)  # noqa: E731
        base = _pad_lanes_mult32(base)
        init = initial_state(base, C)
        make_args = lambda: M.runs_screen_args(  # noqa: E731
            base, init, variants.node_avail, variants.pod_active, max_run=M.max_run_bucket(base), passes=passes,
            with_topo=M.has_topo_runs(base), grp_counts0=variants.grp_counts0,
            grp_registered0=variants.grp_registered0)
        wrap = lambda: M.lean_screen(args[0], variants, C, passes)  # noqa: E731
    rp, p_ms = plain_ms(plain)
    sel = torch.tensor(checked, device=rk.kind.device)
    if not (torch.equal(rk.kind[sel].cpu(), rp.kind.cpu()) and torch.equal(rk.index[sel].cpu(), rp.index.cpu())):
        raise AssertionError(f"disruption: the pass's runs_screen ({mode}) rows differ from the plain screen's")
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        if not np.array_equal(sk[key][checked], sp[key], equal_nan=sk[key].dtype.kind == "f"):
            raise AssertionError(f"disruption: the pass's runs_screen ({mode}) state {key} differs from plain")
    sets = [make_args() for _ in range(5)]
    k_ms, k_all = time_launches("runs_screen", sets)
    for t, _ in sets:
        if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
            raise AssertionError("disruption: a timed runs_screen launch differs from the pass's")
    w_ms, _ = time_ms(wrap, 5)
    log(f"  the pass's screen: {B} subsets ({mode}), one runs_screen launch; rows == plain on all {len(checked)} "
        f"lanes (plain {p_ms:.1f} ms); kernel {k_ms:.3f} ms median of {[round(x, 3) for x in k_all]}, wrapper "
        f"{w_ms:.3f} ms; stats {stats}")
    log(f"  screen vs sequential: {check['agree']} of {len(check['prefixes'])} prefixes agree (k = {check['k']}); "
        f"screen accepts {check['screen']}, sequential accepts {check['seq']}; {check['seconds']:.1f}s")

    # step 5: the wall split and candidates/s
    g = lambda key: split.get(key, 0.0) * 1e3  # noqa: E731
    encode1 = g("scorer_encode1")
    p1 = {"get_candidates": g("get_candidates1"), "scorer_inputs": g("scorer_build1") - encode1,
          "scorer_encode": encode1, "screen": g("screen1"), "confirmation": g("simulate1")}
    p1["rest"] = wall1 * 1e3 - sum(p1.values())
    p2 = {"validation": g("get_candidates2") + g("simulate2")}
    p2["rest"] = wall2 * 1e3 - p2["validation"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(f"  pass 1 wall {wall1 * 1e3:.1f} ms = " + ", ".join(f"{k} {v:.1f}" for k, v in p1.items())
        + f" (screen kernel alone {k_ms:.3f} ms, wrapped {w_ms:.3f}); launches {launches1}")
    log(f"  pass 2 wall {wall2 * 1e3:.1f} ms = " + ", ".join(f"{k} {v:.1f}" for k, v in p2.items())
        + f"; launches {launches2}")
    log(f"  {DISRUPT_CANDIDATES / wall1:.1f} candidates/s over the screened pass, {B / (p1['screen'] / 1e3):.1f} "
        f"screened subsets/s ({card})")
    log(f"  phase 11 wall {time.perf_counter() - t_phase:.1f}s")
    return {
        "candidates": DISRUPT_CANDIDATES, "pods": n_pods, "method": cmd.method, "decision": cmd.decision,
        "disrupted": len(cmd.candidates), "replacements": len(cmd.replacements), "launches": launches,
        "launches_pass1": launches1, "launches_pass2": launches2, "screen_mode": mode, "lanes": B,
        "plain_lanes": len(checked), "screen_kernel_ms": k_ms, "screen_wrapper_ms": w_ms, "screen_plain_ms": p_ms,
        "pass1_ms": wall1 * 1e3, "pass2_ms": wall2 * 1e3, "pass1_split_ms": p1, "pass2_split_ms": p2,
        "candidates_per_s": DISRUPT_CANDIDATES / wall1, "screened_subsets_per_s": B / (p1["screen"] / 1e3), "card": card,
        "screen_stats": stats, "k": check["k"], "prefixes": check["prefixes"], "agree": check["agree"],
        "supervisor": dict(sup.counters),
    }


def disruption_screen_check(env, scorer, pending, scored, consolidation, decision_none):
    """Phase 11's step 4: the screen's verdicts on DISRUPT_PREFIXES, the chosen
    k and k + 1 (scored by the pass's scorer, beyond the pass's own lanes in a
    launch of their own) against the sequential ``compute_consolidation`` on
    the card, with the cluster as the first pass saw it. The screen may be
    stricter, never more optimistic; they must agree on DISRUPT_AGREE."""
    t0 = time.perf_counter()
    cands = scorer.candidates
    k = len(pending.command.candidates)
    prefixes = sorted({p for p in DISRUPT_PREFIXES + (k, k + 1) if 1 <= p <= len(cands)})
    subsets, verdicts = scored[0]
    have = dict(zip(subsets, verdicts))
    missing = [tuple(range(p)) for p in prefixes if tuple(range(p)) not in have]
    if missing:
        have.update(zip(missing, scorer.score_subsets([list(s) for s in missing])))
    method = consolidation.MultiNodeConsolidation(env.provisioner, env.clock)
    screen, seq, agree = [], [], 0
    for p in prefixes:
        ok = have[tuple(range(p))].consolidatable_with(cands[:p], scorer.inputs.instance_types)
        sq = method.compute_consolidation(cands[:p]).decision != decision_none
        if ok and not sq:
            raise AssertionError(f"disruption: the screen accepts prefix {p}, the sequential path rejects it")
        screen += [p] if ok else []
        seq += [p] if sq else []
        agree += ok == sq
    ends = [p for p in (k, k + 1) if p in prefixes]
    if agree < DISRUPT_AGREE or k not in screen or any((p in screen) != (p in seq) for p in ends):
        raise AssertionError(f"disruption: screen and sequential agree on {agree} of {prefixes} (k = {k}; "
                             f"screen {screen}, sequential {seq})")
    return {"k": k, "prefixes": prefixes, "screen": screen, "seq": seq, "agree": agree,
            "seconds": time.perf_counter() - t0}


def screen_subsets(n, seed=SCREEN_SEED):
    """The subsets one consolidation pass asks about: the n/2 prefixes
    (Multi-node), the n singletons (Single-node), and 20 seeded random
    subsets of 3n/4 to n candidates."""
    rng = random.Random(seed)
    return ([list(range(k + 1)) for k in range(n // 2)] + [[k] for k in range(n)]
            + [sorted(rng.sample(range(n), rng.randint(3 * n // 4, n))) for _ in range(20)])


def verdict_key(v):
    return (v.all_pods_scheduled, v.n_new_claims, sorted(v.replacement_its or []),
            sorted(v.replacement_zones or []), sorted(v.replacement_cts or []))



def operator_phase(dev):
    """Phase 12 (see the module docstring). Returns the phase's record."""
    import contextlib

    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.disruption import batch, consolidation, controller
    from karpenter_tpu_torch.provisioning import provisioner
    from karpenter_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    log(f"phase 12: the operator, Operator.step() over {OPERATOR_PODS} pods, {OPERATOR_TYPES} types, 1 NodePool")

    # the wall of each stage, and of the disruption passes' steps by stage
    cur = {"stage": ""}
    split: dict = {}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                k = (cur["stage"], key)
                split[k] = split.get(k, 0.0) + time.perf_counter() - t0
                calls = (cur["stage"], key + "#")
                split[calls] = split.get(calls, 0) + 1
        return run

    @contextlib.contextmanager
    def stage(name):
        cur["stage"] = name
        try:
            yield
        finally:
            torch.cuda.synchronize()

    real = {
        "reconcile": controller.Controller.reconcile, "ctrl_get": controller.get_candidates,
        "cons_get": consolidation.get_candidates, "build": batch.build_scorer, "init": batch.UnionScorer.__init__,
        "score": batch.UnionScorer.score_subsets, "compute": consolidation.ConsolidationBase.compute_consolidation,
        "provision": provisioner.Provisioner.reconcile,
    }
    controller.Controller.reconcile = timed("disruption_pass", real["reconcile"])
    controller.get_candidates = timed("get_candidates", real["ctrl_get"])
    consolidation.get_candidates = timed("get_candidates", real["cons_get"])
    batch.build_scorer = timed("scorer_build", real["build"])
    batch.UnionScorer.__init__ = timed("scorer_encode", real["init"])
    batch.UnionScorer.score_subsets = timed("screen", real["score"])
    consolidation.ConsolidationBase.compute_consolidation = timed("simulate", real["compute"])
    provisioner.Provisioner.reconcile = timed("provisioner_pass", real["provision"])
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        digest, record, op = operator_scenario("karpenter_tpu_torch", {"solver_device": dev.type},
                                               W.make_diverse_pods, hooks={"stage": stage})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        controller.Controller.reconcile = real["reconcile"]
        controller.get_candidates, consolidation.get_candidates = real["ctrl_get"], real["cons_get"]
        batch.build_scorer, batch.UnionScorer.__init__ = real["build"], real["init"]
        batch.UnionScorer.score_subsets = real["score"]
        consolidation.ConsolidationBase.compute_consolidation = real["compute"]
        provisioner.Provisioner.reconcile = real["provision"]
    sup = op.supervisor
    if digest != EXPECT_OPERATOR:
        raise AssertionError(f"operator: {digest} != the JAX package's {EXPECT_OPERATOR}")
    if sup.circuit_state() != "closed" or any(sup.counters[k] for k in (
            "solve_fallbacks", "solve_retries", "validator_rejections")):
        raise AssertionError(f"operator: circuit {sup.circuit_state()}, {sup.counters}")
    if not op.status.ready():
        raise AssertionError(f"operator: not ready after the run: {op.status.statusz().get('device_faults')}")
    path = ("ffd_loop", "relax_place", "gate_counts", "runs_screen")
    if any(launches[k] < 1 for k in path):
        raise AssertionError(f"operator: a kernel of the path did not launch: {launches}")
    log(f"  final state == EXPECT_OPERATOR: {digest}")
    log(f"  circuit closed, no fallback/retry/rejection; methods {record['methods']}; "
        f"events {record['event_reasons']}")
    log(f"  launches over the run: {launches}")
    stages = record["stages_s"]
    reprovision = split.get(("consolidate", "provisioner_pass"), 0.0)
    log("  stage walls (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; re-provision (the provisioner's passes during consolidation) {reprovision:.2f}"
        + f"; settle rounds {record['rounds']}")
    passes = {}
    for name in ("settle", "consolidate"):
        n = split.get((name, "disruption_pass#"), 0)
        w = split.get((name, "disruption_pass"), 0.0) * 1e3
        parts = {k: split.get((name, k), 0.0) * 1e3 for k in ("get_candidates", "scorer_build", "scorer_encode",
                                                              "screen", "simulate")}
        parts["scorer_inputs"] = parts.pop("scorer_build") - parts["scorer_encode"]
        parts["rest"] = w - sum(parts.values())
        passes[name] = {"passes": n, "wall_ms": w, "split_ms": parts,
                        "provisioner_passes": split.get((name, "provisioner_pass#"), 0),
                        "provisioner_ms": split.get((name, "provisioner_pass"), 0.0) * 1e3}
        log(f"  disruption passes during {name}: {n}, {w:.1f} ms = "
            + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
            + f"; provisioner passes {passes[name]['provisioner_passes']} ({passes[name]['provisioner_ms']:.1f} ms)")

    threaded = operator_threaded(dev)
    log(f"  phase 12 wall {time.perf_counter() - t_phase:.1f}s")
    return {"pods": OPERATOR_PODS, "types": OPERATOR_TYPES, "digest": digest, "wall_s": wall, "stages_s": stages,
            "reprovision_s": reprovision, "rounds": record["rounds"], "launches": launches,
            "disruption_passes": passes, "methods": record["methods"], "supervisor": dict(sup.counters),
            "threaded": threaded}


def operator_threaded(dev):
    """Phase 12's threaded part: ``start()`` on two free localhost ports,
    /readyz 200 once the build thread ends, OPERATOR_THREADED_PODS pods
    provisioned under the real batch window, /metrics with ``# TYPE`` for
    every registered series, /statusz and /debug/programs parsed, then
    ``stop()``."""
    import socket
    import urllib.error
    import urllib.request

    from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.metrics.registry import REGISTRY
    from karpenter_tpu_torch.operator import Operator, Options
    from karpenter_tpu_torch.testing import workloads as W

    t0 = time.perf_counter()
    socks = [socket.socket(), socket.socket()]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    cloud = FakeCloudProvider()
    cloud.instance_types = instance_types(OPERATOR_TYPES)
    cloud.drifted = ""
    op = Operator(cloud, Options(metrics_port=ports[0], health_probe_port=ports[1], solver_device=dev.type))
    base, health = f"http://127.0.0.1:{ports[0]}", f"http://127.0.0.1:{ports[1]}"

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    op.start()
    try:
        while op._warm_thread is not None and op._warm_thread.is_alive():
            time.sleep(0.05)
        t_ready = time.perf_counter() - t0
        if get(f"{health}/readyz")[0] != 200 or get(f"{base}/readyz")[0] != 200:
            raise AssertionError(f"operator threaded: /readyz not 200 after the build: {op.status.statusz()}")
        op.kube.create(NodePool(metadata=ObjectMeta(name="default", namespace="")))
        pods = W.make_diverse_pods(OPERATOR_THREADED_PODS, random.Random(7))
        t1 = time.perf_counter()
        for p in pods:
            op.kube.create(p)
        names = {p.metadata.name for p in pods}
        nominated = set()
        while time.perf_counter() - t1 < OPERATOR_THREADED_WAIT_S:
            nominated = {e.involved_name for e in list(op.recorder.events) if e.reason == "Nominated"} & names
            if len(nominated) == len(names):
                break
            time.sleep(0.2)
        t_claims = time.perf_counter() - t1
        claims = op.kube.list(NodeClaim)
        if len(nominated) != len(names) or not claims:
            raise AssertionError(f"operator threaded: {len(nominated)} of {len(names)} pods nominated, "
                                 f"{len(claims)} NodeClaims after {t_claims:.1f}s")
        code, body = get(f"{base}/metrics")
        text = body.decode()
        missing = [name for kind, name, _ in REGISTRY.describe() if f"# TYPE {name} {kind}" not in text]
        if code != 200 or missing:
            raise AssertionError(f"operator threaded: /metrics {code}, no # TYPE for {missing}")
        code, body = get(f"{base}/statusz")
        statusz = json.loads(body)
        code2, body2 = get(f"{base}/debug/programs")
        programs = json.loads(body2)["kernels"]  # the kernel inventory beside the program registry
        if code != 200 or code2 != 200 or not statusz["ready"] or programs["built"] != len(programs["kernels"]):
            raise AssertionError(f"operator threaded: /statusz {code} ready {statusz.get('ready')}, "
                                 f"/debug/programs {code2} built {programs.get('built')}")
        launched = sum(1 for c in claims if c.status.provider_id)
    finally:
        op.stop()
    out = {"ready_s": t_ready, "claims_s": t_claims, "claims": len(claims), "launched": launched,
           "series": len(REGISTRY.describe()), "kernels_built": programs["built"],
           "launches_total": programs["launches_total"], "solver": statusz.get("solver", {}).get("counters")}
    log(f"  threaded: /readyz 200 {t_ready:.2f}s after start(); {len(names)} pods nominated onto {len(claims)} "
        f"NodeClaims ({launched} launched) {t_claims:.2f}s after their creation under the real batch window; "
        f"/metrics has # TYPE for all {out['series']} series; /statusz ready; /debug/programs "
        f"{programs['built']} kernels built")
    return out

def operator_scenario(pkg, options, make_pods, n_pods=OPERATOR_PODS, seed=OPERATOR_SEED, n_types=OPERATOR_TYPES,
                      hooks=None):
    """Phase 12's cooperative lifecycle through one package's ``Operator``
    (``pkg`` is the package's module name, ``options`` the keyword arguments
    of its ``Options``, ``make_pods(n, rng)`` its makeDiversePods): a
    FakeCloudProvider over ``n_types`` catalog types (no drift), one
    ``default`` NodePool (WhenUnderutilized, budget 100%) and ``n_pods`` pods
    on a FakeClock.

      provision    ``step()``: the pod watch's trigger, one Provisioner pass;
      launch       ``run_until_settled()``: the lifecycle controller launches;
      settle       a fake kubelet registers a Ready Node per launched claim,
                   each pod is bound to the node its last provisioning pass
                   nominated (a claim's once it has registered), until every
                   claim is initialized and every nominated pod bound (a pod
                   the solve could not place stays pending);
      scale-down   a seeded half of the pods is deleted;
      consolidate  rounds of the clock stepped past the 15 s validation TTL,
                   then settling as above with a fake ReplicaSet that
                   creates each evicted pod anew (pending); until two rounds
                   in a row change nothing.

    uuid4 is numbered for the run (claim names, provider ids, uids), so both
    packages name alike. Returns (digest, record, operator). ``hooks`` may
    wrap stages: ``hooks["stage"](name)`` is a context manager, and
    ``hooks["round"](stage, n, claims, commands)`` is called after each
    round of settling or consolidation."""
    import contextlib
    import hashlib
    import importlib
    import itertools
    import uuid

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    wk = mod("apis.labels")
    NodeClaim = mod("apis.nodeclaim").NodeClaim
    np_mod, objects = mod("apis.nodepool"), mod("apis.objects")
    fake = mod("cloudprovider.fake")
    operator = mod("operator")
    FakeClock = mod("utils.clock").FakeClock
    stage = (hooks or {}).get("stage") or (lambda name: contextlib.nullcontext())
    on_round = (hooks or {}).get("round") or (lambda *args: None)

    seq = itertools.count(1)
    real_uuid4 = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=next(seq) << 96)
    try:
        clock = FakeClock()
        cloud = fake.FakeCloudProvider()
        cloud.instance_types = fake.instance_types(n_types)
        cloud.drifted = ""
        op = operator.Operator(cloud, options=operator.Options(**options), clock=clock)
        commands, nominated = [], {}
        real_execute, real_reconcile = op.disruption._execute, op.provisioner.reconcile

        def execute(command):
            commands.append([command.method, command.decision, sorted(c.name for c in command.candidates),
                             [sorted(v for r in c.spec.requirements if r.key == wk.LABEL_INSTANCE_TYPE_STABLE
                                     for v in r.values) for c in command.replacements]])
            return real_execute(command)

        def reconcile():
            pass_ = real_reconcile()
            if pass_.inputs is not None:
                for claim in pass_.created:
                    for pi in pass_.claim_pods[claim.metadata.name]:
                        pod = pass_.inputs.pods[pi]
                        nominated[(pod.metadata.namespace, pod.metadata.name)] = ("claim", claim.metadata.name)
                for node, idx in pass_.result.node_pods.items():
                    for pi in idx:
                        pod = pass_.inputs.pods[pi]
                        nominated[(pod.metadata.namespace, pod.metadata.name)] = ("node", node)
            return pass_

        op.disruption._execute = execute
        op.provisioner.reconcile = reconcile

        pool = np_mod.NodePool(metadata=objects.ObjectMeta(name="default", namespace=""))
        pool.spec.disruption = np_mod.Disruption(consolidation_policy="WhenUnderutilized",
                                                 budgets=[np_mod.Budget(nodes="100%")])
        op.kube.create(pool)
        pods = make_pods(n_pods, random.Random(42))
        specs = {(p.metadata.namespace, p.metadata.name): p for p in pods}
        for p in pods:
            op.kube.create(p)

        def kubelet():
            """A Ready Node for every launched claim without one."""
            made = 0
            for claim in op.kube.list(NodeClaim):
                if not claim.status.provider_id or claim.status.node_name:
                    continue
                name = f"node-{claim.metadata.name}"
                if op.kube.get_opt(objects.Node, name, "") is not None:
                    continue
                op.kube.create(objects.Node(
                    metadata=objects.ObjectMeta(name=name, namespace="", labels={
                        **claim.metadata.labels, wk.LABEL_HOSTNAME: name}),
                    spec=objects.NodeSpec(provider_id=claim.status.provider_id),
                    status=objects.NodeStatus(capacity=dict(claim.status.capacity),
                                              allocatable=dict(claim.status.allocatable),
                                              conditions=[objects.NodeCondition(type="Ready")]),
                ))
                made += 1
            return made

        def bind():
            """Each pending pod onto the node its last pass nominated."""
            claims = {c.metadata.name: c for c in op.kube.list(NodeClaim)}
            nodes = {n.metadata.name: n for n in op.kube.list(objects.Node)}
            bound = 0
            for p in op.kube.list(objects.Pod):
                if p.spec.node_name or p.metadata.deletion_timestamp is not None:
                    continue
                kind, target = nominated.get((p.metadata.namespace, p.metadata.name), (None, None))
                if kind == "claim" or (kind == "node" and target not in nodes and target in claims):
                    target = claims[target].status.node_name if target in claims else ""
                node = nodes.get(target or "")
                if node is None or node.metadata.deletion_timestamp is not None:
                    continue
                p.spec.node_name = target
                p.status.phase = "Running"
                op.kube.update(p)
                bound += 1
            return bound

        def replicaset():
            """Each pod of the workload that is not deleted by the scenario
            and is gone from the store (evicted) comes back pending, as its
            owner makes it anew."""
            live = {(p.metadata.namespace, p.metadata.name) for p in op.kube.list(objects.Pod)}
            made = 0
            for key, spec in specs.items():
                if key in live or key in gone:
                    continue
                fresh = copy.deepcopy(spec)
                fresh.spec.node_name = ""
                fresh.status.phase = "Pending"
                op.kube.create(fresh)
                made += 1
            return made

        def settle(limit=40, name="settle"):
            rounds = 0
            for rounds in range(1, limit + 1):
                before = op.kube._rv
                op.run_until_settled(max_steps=80)
                replicaset()
                kubelet()
                bind()
                on_round(name, rounds, len(op.kube.list(NodeClaim)), len(commands))
                if op.kube._rv == before:
                    break
            return rounds

        gone: set = set()
        record = {"stages_s": {}, "rounds": {}}

        def timed(name, fn):
            t0 = time.perf_counter()
            with stage(name):
                out = fn()
            record["stages_s"][name] = time.perf_counter() - t0
            return out

        timed("provision", op.step)
        if not op.kube.list(NodeClaim):
            raise AssertionError("operator: the first step created no NodeClaim")
        timed("launch", op.run_until_settled)
        record["rounds"]["settle"] = timed("settle", settle)
        claims = op.kube.list(NodeClaim)
        pending = [p for p in op.kube.list(objects.Pod) if not p.spec.node_name]
        stuck = [p.metadata.name for p in pending if (p.metadata.namespace, p.metadata.name) in nominated]
        if stuck or not all(c.is_initialized() for c in claims):
            raise AssertionError(f"operator: after settling {len(stuck)} nominated pods pending ({stuck[:5]}), "
                                 f"{sum(not c.is_initialized() for c in claims)} claims not initialized")
        record["provisioned"] = {"claims": len(claims), "pods": n_pods, "unschedulable": len(pending)}

        def scale_down():
            names = sorted(specs)
            for key in random.Random(seed).sample(names, len(names) // 2):
                gone.add(key)
                op.kube.delete(objects.Pod, key[1], key[0])

        timed("scale_down", scale_down)

        def consolidate():
            # a round that resolves a pending command without a change to
            # the store is followed by the pass that computes the next one:
            # stop after two quiet rounds
            rounds = quiet = 0
            for rounds in range(1, 121):
                before = (op.kube._rv, len(commands))
                clock.step(16.0)
                settle(name=f"consolidate {rounds}")
                quiet = quiet + 1 if (op.kube._rv, len(commands)) == before and op.disruption.pending is None else 0
                if quiet == 2:
                    break
            return rounds

        record["rounds"]["consolidate"] = timed("consolidate", consolidate)

        # the digest: claims, nodes with their taints, bindings, pending pods,
        # the commands executed and the event reasons in order
        claims = op.kube.list(NodeClaim)
        nodes = op.kube.list(objects.Node)
        pods_now = op.kube.list(objects.Pod)
        state = {
            "claims": sorted([c.metadata.name, c.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                              c.metadata.labels.get(wk.LABEL_INSTANCE_TYPE_STABLE, ""),
                              c.status.node_name, c.is_initialized()] for c in claims),
            "nodes": sorted([n.metadata.name, sorted(n.metadata.labels.items()),
                             [[t.key, t.value, t.effect] for t in n.spec.taints]] for n in nodes),
            "bindings": sorted([p.metadata.namespace, p.metadata.name, p.spec.node_name]
                               for p in pods_now if p.spec.node_name),
            "pending": sorted([p.metadata.namespace, p.metadata.name] for p in pods_now if not p.spec.node_name),
            "commands": commands,
            "events": [e.reason for e in op.recorder.events],
        }
        blob = json.dumps(state, sort_keys=True, default=str).encode()
        reasons = {}
        for r in state["events"]:
            reasons[r] = reasons.get(r, 0) + 1
        digest = dict(claims=len(claims), nodes=len(nodes), bound=len(state["bindings"]),
                      pending=len(state["pending"]), commands=len(commands),
                      disrupted=sum(len(c[2]) for c in commands), evicted=reasons.get("Evicted", 0),
                      events=len(state["events"]), sha256=hashlib.sha256(blob).hexdigest())
        record["methods"] = sorted({c[0] + "/" + c[1] for c in commands})
        record["event_reasons"] = reasons
        return digest, record, op
    finally:
        uuid.uuid4 = real_uuid4


def streaming_phase(dev, main, time_ms, time_launches, plain_ms, io_bytes, bound):
    """Phase 13 (see the module docstring): the warm stream with relax off
    and on, the journal and a restart storm on the card, and the
    KARPENTER_TPU_RUNS solve. Returns the phase's record; its ``runs_solve``
    rides in the runs_screen entry."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS, instance_types
    from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32, initial_state
    from karpenter_tpu_torch.ops.ffd_runs import has_topo_runs, max_run_bucket, runs_scan_plain
    from karpenter_tpu_torch.ops.ffd_step import solve_ffd
    from karpenter_tpu_torch.ops.padding import pad_problem
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.solver import torch_backend as TB
    from karpenter_tpu_torch.solver import validator as val
    from karpenter_tpu_torch.provisioning.topology import Topology
    from karpenter_tpu_torch.solver.encode import Encoder, domains_from_instance_types, template_from_nodepool
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess, default_pod_factory
    from karpenter_tpu_torch.streaming.warm import StreamingSolver
    from karpenter_tpu_torch.testing import restart

    t_phase = time.perf_counter()
    log(f"phase 13: streaming, {STREAM_PODS} pods, {STREAM_RATE} arrivals + {STREAM_RATE} deletes a cycle")
    for name in ("KARPENTER_TPU_STATE_DIR", "KARPENTER_TPU_DELTA", "KARPENTER_TPU_RUNS", "KARPENTER_TPU_FAULTS"):
        os.environ.pop(name, None)
    its = instance_types(400)
    tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="s")), its, range(len(its)))]

    def stream():
        rng = random.Random(STREAM_SEED)
        return ChurnProcess([default_pod_factory(f"st-{i}", rng) for i in range(STREAM_PODS)],
                            config=ChurnConfig(seed=STREAM_SEED, arrivals_per_cycle=STREAM_RATE,
                                               deletes_per_cycle=STREAM_RATE))

    def where(pods, result):
        out = {}
        for name, idxs in result.node_pods.items():
            for i in idxs:
                out[pods[i].uid] = ("node", name)
        for ci, c in enumerate(result.new_claims):
            for i in c.pod_indices:
                out[pods[i].uid] = ("claim", ci)
        for i in result.failures:
            out[pods[i].uid] = ("fail", None)
        return out

    def accounted(pods, result):
        seen = [i for v in result.node_pods.values() for i in v] + list(result.failures)
        seen += [i for c in result.new_claims for i in c.pod_indices]
        return sorted(seen) == list(range(len(pods)))

    def p(vals, q):
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    def warm_stream(tag, relax, cycles, cold_arm):
        """One supervised streaming run over the stream; per cycle the
        outcome, walls, launches and split; ``cold_arm`` also solves every
        snapshot cold and holds the certified pods to it."""
        sup = SupervisedSolver(TorchSolver(relax=relax, device=dev), fallback=OracleSolver(), streaming=True)
        streaming = sup.primary
        inner_s = []  # the streaming layer's own wall per call, inside the supervisor's
        real_solve = streaming.solve

        def timed_solve(*a, **kw):
            t = time.perf_counter()
            try:
                return real_solve(*a, **kw)
            finally:
                inner_s.append(time.perf_counter() - t)

        streaming.solve = timed_solve
        cold = TorchSolver(relax=relax, device=dev) if cold_arm else None
        proc = stream()
        records = []
        for cyc in range(cycles):
            proc.step()
            pods = list(proc.pods)
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = sup.solve(pods, its, tpls)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            outcome = streaming.last_outcome
            expect = "cold-first" if cyc == 0 else "warm"
            if outcome != expect:
                raise AssertionError(f"{tag} cycle {cyc}: outcome {outcome}, expected {expect}")
            if sup.counters["solve_fallbacks"] or sup.counters["validator_rejections"]:
                raise AssertionError(f"{tag} cycle {cyc}: supervisor counters {sup.counters}")
            if not accounted(pods, result):
                raise AssertionError(f"{tag} cycle {cyc}: a pod dropped or placed twice")
            t0 = time.perf_counter()
            violations = val.validate_result(result, pods, its, tpls, level="full")
            val_ms = (time.perf_counter() - t0) * 1e3
            if violations:
                raise AssertionError(f"{tag} cycle {cyc}: {len(violations)} violations, first {violations[0]}")
            rec = dict(cycle=cyc, outcome=outcome, wall_ms=wall * 1e3, launches=launches,
                       stream_ms=inner_s[-1] * 1e3,
                       reuse_ratio=streaming.last_reuse_ratio, sub_pods=streaming.last_sub_pods,
                       certified=len(streaming.last_certified_uids), claims=len(result.new_claims),
                       scheduled=result.num_scheduled(), validate_ms=val_ms,
                       split_ms={k: v * 1e3 for k, v in streaming.last_warm_timing.items()})
            if cold is not None:
                t0 = time.perf_counter()
                ref = cold.solve(pods, its, tpls)
                torch.cuda.synchronize()
                rec["cold_ms"] = (time.perf_counter() - t0) * 1e3
                w, c = where(pods, result), where(pods, ref)
                certified = streaming.last_certified_uids
                for uid in certified:
                    if w[uid][0] != c[uid][0] or (w[uid][0] == "node" and w[uid][1] != c[uid][1]):
                        raise AssertionError(f"{tag} cycle {cyc}: certified pod {uid} at {w[uid]}, cold {c[uid]}")
                claim_uids = [u for u in certified if w[u][0] == "claim"]
                groups_w, groups_c = {}, {}
                for u in claim_uids:
                    if result.new_claims[w[u][1]].template_index != ref.new_claims[c[u][1]].template_index:
                        raise AssertionError(f"{tag} cycle {cyc}: certified pod {u} on another template")
                    groups_w.setdefault(w[u][1], set()).add(u)
                    groups_c.setdefault(c[u][1], set()).add(u)
                if sorted(map(sorted, groups_w.values())) != sorted(map(sorted, groups_c.values())):
                    raise AssertionError(f"{tag} cycle {cyc}: certified claim co-location differs from cold")
            records.append(rec)
            log(f"  {tag} cycle {cyc:2d} {outcome:10s} wall {wall * 1e3:8.1f} ms (streaming layer "
                f"{rec['stream_ms']:.1f})"
                + (f" (cold {rec['cold_ms']:8.1f})" if cold is not None else "")
                + f"; reuse {rec['reuse_ratio']:.4f}, sub-solve {rec['sub_pods']} pods, certified "
                f"{rec['certified']}; split { {k: round(v, 2) for k, v in rec['split_ms'].items()} } ms; "
                f"launches { {k: v for k, v in launches.items() if v} }; validator {val_ms:.1f} ms; "
                f"{rec['scheduled']}/{len(pods)} on {rec['claims']} claims")
        warm = [r for r in records if r["outcome"] == "warm"]
        per_cycle = {name: [r["launches"][name] for r in warm] for name in ("ffd_loop", "relax_place", "gate_counts")}
        out = dict(
            cycles=cycles, relax=relax, outcomes=dict(streaming.counters),
            warm_ms_p50=statistics.median(r["wall_ms"] for r in warm), warm_ms_p99=p([r["wall_ms"] for r in warm], 0.99),
            cold_first_ms=records[0]["wall_ms"],
            reuse_ratio_p50=statistics.median(r["reuse_ratio"] for r in warm),
            sub_pods_p50=statistics.median(r["sub_pods"] for r in warm),
            certified_p50=statistics.median(r["certified"] for r in warm),
            split_ms_p50={k: statistics.median(r["split_ms"][k] for r in warm)
                          for k in ("diff", "sub_solve", "gate", "certify", "accept")},
            stream_ms_p50=statistics.median(r["stream_ms"] for r in warm),
            validate_ms_p50=statistics.median(r["validate_ms"] for r in warm),
            launches_per_warm_cycle={name: (min(v), max(v)) for name, v in per_cycle.items()},
            launches_first=records[0]["launches"],
            launches_total={name: sum(r["launches"][name] for r in records) for name in kernels.LAUNCHES},
        )
        if cold is not None:
            out["cold_ms_p50"] = statistics.median(r["cold_ms"] for r in warm)
        log(f"  {tag}: warm p50 {out['warm_ms_p50']:.1f} ms, p99 {out['warm_ms_p99']:.1f} ms"
            + (f", paired cold p50 {out['cold_ms_p50']:.1f} ms" if cold is not None else "")
            + f"; the streaming layer p50 {out['stream_ms_p50']:.1f} ms of it, split p50 {out['split_ms_p50']} ms "
            f"(the rest: the supervisor's validation and bookkeeping); reuse p50 {out['reuse_ratio_p50']:.4f}; sub-solve p50 "
            f"{out['sub_pods_p50']} pods; launches per warm cycle (min, max) {out['launches_per_warm_cycle']}; "
            f"outcomes {out['outcomes']}")
        return out, streaming

    # -- (a) the warm stream, relax off, against the cold arm ------------------
    # every warm cycle's sub-solve launches ffd_loop; the gate launches on
    # the cold-first cycle (the supervisor's gate of a sweeps result, and
    # with relax on the two-phase solve's own) and in a warm cycle only when
    # the sub-solve's phase 1 placed pods (a merged warm result carries no
    # GateContext: the incremental gate and the supervisor's validator are
    # host checks, as in the JAX package)
    relax_off, _ = warm_stream("warm relax off", False, STREAM_CYCLES, True)
    if relax_off["launches_per_warm_cycle"]["ffd_loop"][0] < 1 or relax_off["launches_total"]["gate_counts"] < 1:
        raise AssertionError(f"warm relax off: launches {relax_off['launches_total']}")
    # -- (b) the same stream under the default flags ---------------------------
    relax_on, _ = warm_stream("warm relax on", True, STREAM_RELAX_CYCLES, False)
    if relax_on["launches_per_warm_cycle"]["ffd_loop"][0] < 1 or any(
            relax_on["launches_total"][name] < 1 for name in ("relax_place", "gate_counts")):
        raise AssertionError(f"warm relax on: launches {relax_on['launches_total']}")

    # -- (c) the journal on the card, then a restart storm ----------------------
    state_dir = tempfile.mkdtemp(prefix="ktpu-stream-journal-")
    os.environ["KARPENTER_TPU_STATE_DIR"] = state_dir
    try:
        proc = stream()
        first = StreamingSolver(TorchSolver(relax=False, device=dev))
        for _ in range(2):
            proc.step()
            first.solve(list(proc.pods), its, tpls)
        if first.last_outcome != "warm":
            raise AssertionError(f"journal: the writer's second cycle was {first.last_outcome}")
        t0 = time.perf_counter()
        fresh = StreamingSolver(TorchSolver(relax=False, device=dev))
        restore_ms = (time.perf_counter() - t0) * 1e3
        if fresh.last_restore_outcome != "restored":
            raise AssertionError(f"journal: restore outcome {fresh.last_restore_outcome}")
        proc.step()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = fresh.solve(list(proc.pods), its, tpls)
        torch.cuda.synchronize()
        restored_ms = (time.perf_counter() - t0) * 1e3
        if fresh.last_outcome != "warm" or kernels.LAUNCHES["ffd_loop"] < 1:
            raise AssertionError(f"journal: the restored stream's first cycle was {fresh.last_outcome}, "
                                 f"launches {dict(kernels.LAUNCHES)}")
        if val.validate_result(result, list(proc.pods), its, tpls, level="full"):
            raise AssertionError("journal: the restored stream's first cycle is not validator-clean")
        tag = fresh._tag()
    finally:
        os.environ.pop("KARPENTER_TPU_STATE_DIR", None)
        shutil.rmtree(state_dir, ignore_errors=True)
    journal = dict(restore_ms=restore_ms, first_cycle_ms=restored_ms, tag=tag)
    log(f"  journal: restored in {restore_ms:.1f} ms (tag {tag}); its first cycle warm in {restored_ms:.1f} ms")
    storm = restart.run_restart_storm(pod_count=STORM_PODS, cycles=STORM_CYCLES, kills=STORM_KILLS,
                                      backend="torch", device="cuda")
    log(f"  restart storm: {storm}")
    if not storm["ok"] or storm["kills"] < STORM_KILLS or "restored" not in storm["restores"]:
        raise AssertionError(f"restart storm failed: {storm}")
    journal["storm"] = {k: storm[k] for k in ("cycles", "kills", "children", "restores", "seconds")}

    # -- (d) the KARPENTER_TPU_RUNS solve on phase 2's batch ---------------------
    pods, its2, tpls2, nodes = main["workload"]
    passes = []
    real_pass = TB.runs_pass

    def recording(problem, max_claims, init=None):
        out = real_pass(problem, max_claims, init)
        passes.append((problem, max_claims, init, out))
        return out

    os.environ["KARPENTER_TPU_RUNS"] = "1"
    TB.runs_pass = recording
    try:
        solver = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=dev, initial_claim_slots=main["C"])
        if not solver.runs:
            raise AssertionError("KARPENTER_TPU_RUNS=1 did not turn the runs solve on")
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs_result = solver.solve(pods, its2, tpls2, nodes)
        torch.cuda.synchronize()
        runs_wall = time.perf_counter() - t0
        runs_launches = dict(kernels.LAUNCHES)
    finally:
        TB.runs_pass = real_pass
        os.environ.pop("KARPENTER_TPU_RUNS", None)
    if runs_launches["runs_screen"] != len(passes) or runs_launches["runs_screen"] < 1 or runs_launches["ffd_loop"]:
        raise AssertionError(f"runs solve: launches {runs_launches} over {len(passes)} passes")
    violations = val.validate_result(runs_result, pods, its2, tpls2, nodes, level="full")
    if violations:
        raise AssertionError(f"runs solve: {len(violations)} violations, first {violations[0]}")
    sweeps = main["result_off"]
    log(f"  runs solve: {len(passes)} passes, wall {runs_wall * 1e3:.1f} ms, scheduled {runs_result.num_scheduled()}"
        f" on {len(runs_result.new_claims)} claims (sweeps path {sweeps.num_scheduled()} on "
        f"{len(sweeps.new_claims)}); launches { {k: v for k, v in runs_launches.items() if v} }; validator-clean")
    # the first pass's launch at full width against ffd_loop's one-pass mode
    # on the same problem: the same FFD, one run at a time against one pod
    # at a time (tests/test_runs_solver.py's parity)
    problem, C, init, rk = passes[0]
    if init is not None:
        raise AssertionError("runs solve: the first pass carried a state")
    prob = _pad_lanes_mult32(problem)
    one = solve_ffd(prob, C)
    act = prob.pod_active
    if not (torch.equal(one.kind[act], rk.kind[act]) and torch.equal(one.index[act], rk.index[act])):
        bad = torch.nonzero(act & ((one.kind != rk.kind) | (one.index != rk.index))).flatten()[:10].tolist()
        raise AssertionError(f"runs solve: the runs_screen launch differs from ffd_loop's one pass at rows {bad}")
    P = prob.num_pods
    modes = np.bincount(prob.run_mode[prob.run_len > 0].cpu().numpy(), minlength=3).tolist()
    # the launch alone and through its wrapper, at full width
    kw = dict(max_run=max_run_bucket(prob), passes=1, with_topo=has_topo_runs(prob))
    batch1 = M.stack_problems([prob])
    sets = [M.stacked_screen_args(batch1, C, **kw) for _ in range(3)]
    k_ms, k_all = time_launches("runs_screen", sets)
    for t, _ in sets:
        if not (torch.equal(t["kind"][0], rk.kind) and torch.equal(t["index"][0], rk.index)):
            raise AssertionError("runs solve: a timed launch differs from the wrapper's")
    w_ms, _ = time_ms(lambda: real_pass(problem, C), 3)
    plan = sets[0][0]["plan"].cpu().tolist()
    work = dict(zip(M.RS_WORK_COUNTERS, rk.work.sum(dim=0).cpu().tolist()))
    nbytes = io_bytes(sets[0][0], (), M.RS_SCRATCH)
    K, Wd, O, R = prob.num_keys, prob.num_lanes // 32, prob.offer_ok.shape[1], prob.num_resources
    int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
    flt_ops = work["type_tests"] * 2 * R
    b_ms, b_by = bound(nbytes, int_ops, flt_ops)
    # bit for bit against runs_scan_plain over the batch's first
    # RUNS_CHECK_PODS pods, encoded alone: the launch through the wrapper on
    # the card, the plain scan on the host
    cut = list(pods[:RUNS_CHECK_PODS])
    topo = Topology(domains_from_instance_types(its2, tpls2), batch_pods=cut, cluster_pods=[])
    for n in nodes:
        topo.register("kubernetes.io/hostname", n.name)
    enc = Encoder(FAKE_WELL_KNOWN_LABELS).encode(cut, its2, tpls2, nodes, topology=topo, num_claim_slots=C)
    host = pad_problem(enc.problem)
    cut_dev = _pad_lanes_mult32(problem_to_torch(host, dev))
    ck = real_pass(cut_dev, C)
    cut_cpu = _pad_lanes_mult32(problem_to_torch(host, "cpu"))
    t0 = time.perf_counter()
    cp = runs_scan_plain(cut_cpu, initial_state(cut_cpu, C), max_run_bucket(cut_cpu), has_topo_runs(cut_cpu))
    cut_plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(ck.kind.cpu(), cp.kind) and torch.equal(ck.index.cpu(), cp.index)):
        raise AssertionError("runs solve: the cut's runs_screen kind/index differ from runs_scan_plain")
    sk, sp = numpy_fields(ck.state), numpy_fields(cp.state)
    for key in sp:
        if not np.array_equal(sk[key], sp[key], equal_nan=sp[key].dtype.kind == "f"):
            raise AssertionError(f"runs solve: the cut's state {key} differs from runs_scan_plain")
    cut_sets = [M.stacked_screen_args(M.stack_problems([cut_dev]), C, max_run=max_run_bucket(cut_dev), passes=1,
                                      with_topo=has_topo_runs(cut_dev)) for _ in range(3)]
    cut_ms, _ = time_launches("runs_screen", cut_sets)
    runs_solve = dict(
        launches=runs_launches["runs_screen"], passes=len(passes), wall_ms=runs_wall * 1e3, rows=P,
        runs_by_mode=modes, max_run=kw["max_run"], plan=plan, ms=k_ms, wrapper_ms=w_ms, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, int_ops=int_ops, flt_ops=flt_ops, work=work,
        scheduled=runs_result.num_scheduled(), claims=len(runs_result.new_claims),
        sweeps_scheduled=sweeps.num_scheduled(), sweeps_claims=len(sweeps.new_claims),
        check_pods=RUNS_CHECK_PODS, check_ms=cut_ms, check_plain_ms=cut_plain_ms, max_abs_err=0.0,
    )
    log(f"  runs_screen one lane of {P} rows (runs single/analytic/topo {modes}, max_run {kw['max_run']}), plan "
        f"{plan}: kernel {k_ms:.3f} ms median of {[round(x, 3) for x in k_all]}, wrapper {w_ms:.3f} ms; == ffd_loop "
        f"one pass; bytes {nbytes}, int ops {int_ops:.4g}, float ops {flt_ops:.4g}, bound {b_ms:.5f} ms ({b_by}); "
        f"work {work}; over the first {RUNS_CHECK_PODS} pods kernel {cut_ms:.3f} ms, plain {cut_plain_ms:.1f} ms, "
        f"bit-equal")
    wall = time.perf_counter() - t_phase
    log(f"  phase 13 wall {wall:.1f}s")
    return dict(relax_off=relax_off, relax_on=relax_on, journal=journal, runs_solve=runs_solve, phase_s=wall)


# -- phase 14: the program lifecycle and serve replicas ------------------------


def _free_ports(n=2):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s_ in socks:
            s_.bind(("127.0.0.1", 0))
        return [s_.getsockname()[1] for s_ in socks]
    finally:
        for s_ in socks:
            s_.close()


def _http(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _placement_digest(result):
    import hashlib

    rows = ([(c.template_index, list(c.pod_indices), list(c.instance_type_indices)) for c in result.new_claims],
            sorted((k, list(v)) for k, v in result.node_pods.items()), sorted(result.failures))
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16], result.num_scheduled(), len(result.new_claims)


def _main_solve():
    """Phase 2's batch, solved once as phase 2 solves it: (wall s, digest)."""
    import torch

    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    pods, its, tpls, nodes = W.diverse_workload(MAIN_PODS, 400, seed=42)
    solver = TorchSolver(initial_claim_slots=128, device=torch.device("cuda"))
    t0 = time.perf_counter()
    result = solver.solve(pods, its, tpls, nodes)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _placement_digest(result)


def _operator(prewarm=None):
    """A started Operator on the card (400 catalog types) and its ports."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.operator import Operator, Options

    ports = _free_ports()
    cloud = FakeCloudProvider()
    cloud.instance_types = instance_types(400)
    cloud.drifted = ""
    op = Operator(cloud, Options(metrics_port=ports[0], health_probe_port=ports[1], **(prewarm or {})))
    t0 = time.perf_counter()
    op.start()
    return op, f"http://127.0.0.1:{ports[1]}", t0


def _poll_ready(op, health, t0, limit_s=600.0):
    """Poll /readyz every 20 ms until the warm and recovery threads are done:
    [(seconds, recovery phase, status, warm alive)], and the wall until the
    threads ended."""
    from karpenter_tpu_torch.solver import aot

    threads = [t for t in (op._warm_thread, op._recovery_thread) if t is not None]
    polls = []
    while time.perf_counter() - t0 < limit_s:
        # a poll counts as during the warm (or in a recovery phase) only
        # where that held both before and after its request
        alive, phase = any(t.is_alive() for t in threads), aot.recovery_phase()
        code, _ = _http(f"{health}/readyz")
        alive_after, phase_after = any(t.is_alive() for t in threads), aot.recovery_phase()
        polls.append((round(time.perf_counter() - t0, 3), phase if phase == phase_after else "changing", code,
                      alive and alive_after))
        if not alive:
            return polls, time.perf_counter() - t0
        time.sleep(0.02)
    raise AssertionError(f"lifecycle: the warm did not end within {limit_s:.0f}s")


def lifecycle_child(mode, args):
    """One child process of phase 14 (``chip_smoke.py --lifecycle-child MODE
    ARGS``): the program registry, the snapshot entries, /readyz and the
    solves of one process, as JSON on the last line."""
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.obs import programs
    from karpenter_tpu_torch.solver import aot, warmup

    if args.get("build_dir"):
        from pathlib import Path

        kernels.BUILD_DIR = Path(args["build_dir"])
    out = {"mode": mode}
    t_proc = time.perf_counter()
    if mode == "warm":
        # steps 1 and 4: the operator's warm, then the claim ladder, then
        # the first real 10k solve
        op, health, t0 = _operator({"prewarm_max_pods": MAIN_PODS,
                                    "prewarm_screen_candidates": SCREEN_CANDIDATES})
        try:
            out["polls"], out["warm_s"] = _poll_ready(op, health, t0)
            out["ready_after"] = _http(f"{health}/readyz")[0]
        finally:
            op.stop()
        t1 = time.perf_counter()
        out["claim_buckets"] = warmup.prewarm_claim_buckets()
        torch.cuda.synchronize()
        out["claim_buckets_s"] = time.perf_counter() - t1
        # the partitioned solve's warm under SHARD=1 (the resident world
        # stands down under it, so it runs after the operator's warm)
        os.environ.pop("KARPENTER_TPU_DEVICE_WORLD", None)
        shard_env = {"KARPENTER_TPU_SHARD": "1", "KARPENTER_TPU_SHARD_MIN_DEVICES": "1",
                     "KARPENTER_TPU_SHARD_PARTITIONS": "2"}
        os.environ.update(shard_env)
        t1 = time.perf_counter()
        out["shard"] = warmup.prewarm_shard()
        torch.cuda.synchronize()
        out["shard_s"] = time.perf_counter() - t1
        for name in shard_env:
            os.environ.pop(name)
        out["launches_warm"] = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        out["solve_s"], out["digest"] = _main_solve()
        out["launches_solve"] = dict(kernels.LAUNCHES)
    elif mode == "cold":
        out["solve_s"], out["digest"] = _main_solve()
    elif mode == "restart":
        # step 2: no nvcc, an empty build directory
        op, health, t0 = _operator()
        try:
            out["polls"], out["ready_s"] = _poll_ready(op, health, t0)
            out["ready_after"] = _http(f"{health}/readyz")[0]
            out["statusz"] = json.loads(_http(f"{health}/statusz")[1])
        finally:
            op.stop()
        out["solve_s"], out["digest"] = _main_solve()
    elif mode == "corrupt":
        # step 3 without nvcc: the operator must hold /readyz at 503
        nvcc_env = {k: os.environ.get(k) for k in ("PATH", "CUDA_HOME")}
        os.environ.update(_no_nvcc_env(dict(os.environ)))
        op, health, t0 = _operator()
        try:
            out["polls"], out["ready_s"] = _poll_ready(op, health, t0)
            out["ready_after"] = _http(f"{health}/readyz")[0]
            out["statusz"] = json.loads(_http(f"{health}/statusz")[1])
        finally:
            op.stop()
        out["no_nvcc"] = {"recovery": aot.last_recovery(), "nvcc_runs": list(kernels.NVCC_RUNS)}
        # then with nvcc back, in an empty build directory: the corrupted
        # library alone is rebuilt
        for k, v in nvcc_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        from pathlib import Path

        kernels.BUILD_DIR = Path(args["rebuild_dir"])
        kernels.evict(list(kernels.SOURCES))
        aot.reset_table()
        out["recovery"] = warmup.restore_and_probe()
    else:
        raise SystemExit(f"unknown lifecycle child {mode}")
    torch.cuda.synchronize()
    out["recovery_record"] = aot.last_recovery()
    out["origins"] = kernels.library_origins()
    out["nvcc_runs"] = list(kernels.NVCC_RUNS)
    out["build_s"] = dict(kernels.BUILD_SECONDS)
    out["registry"] = programs.registry().summary()
    out["programs"] = programs.sources_by_program()
    out["entries"] = sorted(os.path.basename(f) for f in aot.snapshot_files())
    out["process_s"] = time.perf_counter() - t_proc
    print(json.dumps(out, default=str), flush=True)
    return 0


def _child(mode, env, args=None, timeout=900):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--lifecycle-child", mode,
                           json.dumps(args or {})], env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"lifecycle child {mode} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["wall_s"] = time.perf_counter() - t0
    out["stderr_tail"] = proc.stderr[-2000:]
    return out


def _brief(record):
    """A child's record without its long lists, for an error message."""
    return {k: v for k, v in record.items() if k not in ("polls", "programs")}


def _no_nvcc_env(env):
    """``env`` with no nvcc on PATH and CUDA_HOME pointing nowhere."""
    import shutil

    path = [d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    out = dict(env, PATH=os.pathsep.join(path), CUDA_HOME="/nonexistent-cuda")
    assert shutil.which("nvcc", path=out["PATH"]) is None
    return out


def _flip_byte(path):
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        at = len(data) - 4096  # inside the library's bytes, past the frame's header
        data[at] ^= 0x5A
        f.seek(0)
        f.write(data)


def lifecycle_phase(dev, build_s):
    """Phase 14 (see the module docstring): the lifecycle children, then the
    serve replicas in this process. Returns the phase's record."""
    import shutil
    import tempfile

    from karpenter_tpu_torch import kernels

    t_phase = time.perf_counter()
    state = tempfile.mkdtemp(prefix="ktpu-state-")
    builds = [tempfile.mkdtemp(prefix="ktpu-build-") for _ in range(3)]
    try:
        base = {k: v for k, v in os.environ.items() if not k.startswith("KARPENTER_TPU_")}
        base.update(KARPENTER_TPU_AOT_RESTORE="1", KARPENTER_TPU_STATE_DIR=state, KARPENTER_TPU_PROGRAMS="1",
                    PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        # 1 + 4. the operator's warm writes the snapshot (its libraries from
        # phase 0's _build/: persistent); a process that did not warm
        warm = _child("warm", dict(base, KARPENTER_TPU_DEVICE_WORLD="1"))
        cold = _child("cold", base)
        lw = warm["launches_warm"]
        missing = [k for k in ("ffd_loop", "relax_place", "gate_counts", "runs_screen", "patch_world",
                               "ffd_loop_lanes") if not lw.get(k)]
        sources = warm["registry"]["by_source"]
        if (missing or not warm["shard"] or warm["ready_after"] != 200
                or any(code != 503 for _, _, code, alive in warm["polls"] if alive)
                or len(warm["entries"]) != len(kernels.SOURCES) or warm["nvcc_runs"]
                or set(warm["origins"].values()) != {"persistent"} or not sources.get("persistent")
                or set(sources) - {"persistent", "memory"} or warm["digest"] != cold["digest"]):
            raise AssertionError(f"lifecycle warm: launches missing {missing}, {_brief(warm)}, cold {_brief(cold)}")
        entries = os.path.join(state, "aot")
        entries = os.path.join(entries, os.listdir(entries)[0])
        # 2. a restart with no nvcc and an empty build directory
        restart = _child("restart", _no_nvcc_env(base), {"build_dir": builds[0]})
        rec = restart["recovery_record"] or {}
        blocking = [(ph, code) for _, ph, code, _ in restart["polls"] if ph in ("restoring", "probing")]
        rsrc = restart["registry"]["by_source"]
        if (restart["ready_after"] != 200 or not blocking or any(code != 503 for _, code in blocking)
                or rec.get("probe") != "passed" or rec.get("aot", {}).get("restored") != len(kernels.SOURCES)
                or restart["statusz"]["recovery"]["last_restart_recovery"]["probe"] != "passed"
                or restart["nvcc_runs"] or set(restart["origins"].values()) != {"restored"}
                or len(restart["origins"]) != len(kernels.SOURCES) or not rsrc.get("restored")
                or set(rsrc) - {"restored", "memory"} or restart["digest"] != warm["digest"]):
            raise AssertionError(f"lifecycle restart: blocking polls {blocking}, {_brief(restart)}")
        # 3. one corrupted entry: without nvcc /readyz stays 503; with it
        # that library alone is rebuilt
        _flip_byte(os.path.join(entries, "probe.aot"))
        broken = _child("corrupt", base, {"build_dir": builds[1], "rebuild_dir": builds[2]})
        brec = broken["no_nvcc"]["recovery"] or {}
        if (broken["ready_after"] != 503 or "KernelCompileError" not in broken["statusz"].get("kernel_build_error", "")
                or brec.get("aot", {}).get("failures") != {"checksum": 1} or brec.get("probe") != "error"
                or brec.get("phase") != "failed" or broken["no_nvcc"]["nvcc_runs"]):
            raise AssertionError(f"lifecycle corrupt without nvcc: {_brief(broken)}")
        rrec = broken["recovery"] or {}
        if (rrec.get("aot", {}).get("failures") != {"checksum": 1}
                or rrec.get("aot", {}).get("restored") != len(kernels.SOURCES) - 1 or rrec.get("probe") != "passed"
                or broken["nvcc_runs"] != ["probe"] or broken["origins"].get("probe") != "cold"):
            raise AssertionError(f"lifecycle corrupt with nvcc: {_brief(broken)}")
        children_s = time.perf_counter() - t_phase
        replicas = replica_phase(dev)
    finally:
        shutil.rmtree(state, ignore_errors=True)
        for b in builds:
            shutil.rmtree(b, ignore_errors=True)
    restore_ms = rec["aot"]["library_ms"]
    out = {
        "warm_s": warm["warm_s"], "claim_buckets_s": warm["claim_buckets_s"],
        "warm_programs": warm["registry"]["programs"], "warm_by_source": warm["registry"]["by_source"],
        "first_solve_after_warm_s": warm["solve_s"], "first_solve_cold_process_s": cold["solve_s"],
        "digest": warm["digest"], "entries": warm["entries"],
        "recovery_s": rec["seconds"], "restart_ready_s": restart["ready_s"], "restart_solve_s": restart["solve_s"],
        "restart_by_source": rsrc, "restore_ms": restore_ms, "restore_ms_total": sum(restore_ms.values()),
        "nvcc_build_s": {k: round(v, 3) for k, v in kernels.BUILD_SECONDS.items()}, "nvcc_build_wall_s": build_s,
        "rebuild_s": broken["build_s"], "rebuild_recovery_s": rrec.get("seconds"),
        "corrupt_ready_s": broken["ready_s"], "children_s": children_s,
        "restored": {k: v == "restored" for k, v in restart["origins"].items()},
        "process_s": {c["mode"]: round(c["process_s"], 3) for c in (warm, cold, restart, broken)},
        "child_wall_s": {c["mode"]: round(c["wall_s"], 3) for c in (warm, cold, restart, broken)},
        "replicas": replicas,
        "wall_s": time.perf_counter() - t_phase,
    }
    log(f"  lifecycle warm: Operator warm (prewarm_max_pods {MAIN_PODS}, screen {SCREEN_CANDIDATES}) "
        f"{warm['warm_s']:.2f}s, /readyz 503 on all {sum(1 for p in warm['polls'] if p[3])} polls during it, 200 "
        f"after; claim ladder {warm['claim_buckets']} buckets {warm['claim_buckets_s']:.2f}s; "
        f"{warm['registry']['programs']} programs by source {warm['registry']['by_source']}; "
        f"{len(warm['entries'])} snapshot entries; launches {lw}")
    log(f"  lifecycle first 10k solve: {warm['solve_s'] * 1e3:.1f} ms after the warm, {cold['solve_s'] * 1e3:.1f} ms "
        f"in a process that did not warm; placements {warm['digest']} == {cold['digest']}")
    log(f"  lifecycle restart (no nvcc, empty build dir): recovery {rec['seconds']:.3f}s (restore "
        f"{sum(restore_ms.values()):.1f} ms over {len(restore_ms)} libraries: "
        f"{ {k: round(v, 2) for k, v in restore_ms.items()} }) against the cold build's {build_s:.1f}s (per "
        f"library {out['nvcc_build_s']}); /readyz 503 through {len(blocking)} polls in restoring/probing, 200 "
        f"after {restart['ready_s']:.2f}s; probe passed; 10k solve {restart['solve_s'] * 1e3:.1f} ms, sources "
        f"{rsrc}, nvcc runs {restart['nvcc_runs']}, placements {restart['digest']} == the warm process's")
    log(f"  lifecycle corrupted probe.aot: without nvcc /readyz {broken['ready_after']} "
        f"({broken['statusz'].get('kernel_build_error', '')[:60]}...), recovery {brec.get('phase')}; with nvcc "
        f"checksum 1, restored {rrec['aot']['restored']}, rebuilt {broken['nvcc_runs']} in "
        f"{broken['build_s']}, probe {rrec.get('probe')}, recovery {rrec.get('seconds')}s")
    log(f"  phase 14 wall {out['wall_s']:.1f}s (children {children_s:.1f}s: {out['child_wall_s']})")
    return out


def replica_phase(dev):
    """Phase 14's replicas: phase 5's serve scenario through a flat
    SolveService, ReplicaSet(1) and ReplicaSet(2) (stacking off: each
    tenant's stream is solved by its own supervised TorchSolver, so its
    placements depend on its stream alone), then ReplicaSet(2) with
    ``failover(1)`` after the third cycle."""
    import torch

    from karpenter_tpu_torch import kernels, serve
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.serve.replica import PLACE_FAILOVER, ReplicaSet
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    its = instance_types(SERVE_ITS)
    tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="serve")), its, range(len(its)))]
    rng = random.Random(SERVE_SEED)
    problems = [[[default_pod_factory(f"sv-{c}-{t}-{i}", rng) for i in range(SERVE_PODS)]
                 for t in range(SERVE_TENANTS)] for c in range(SERVE_CYCLES)]
    tenants = [f"tenant-{t}" for t in range(SERVE_TENANTS)]
    pods_total = SERVE_TENANTS * SERVE_CYCLES * SERVE_PODS

    def run(service, failover_at=None):
        for name in tenants:
            service.register_tenant(name)
        service.start()
        digests, moved = {}, {}
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            for c, cycle in enumerate(problems):
                if failover_at is not None and c == failover_at:
                    moved = service.failover(1)
                tickets = [service.submit(name, cycle[t], its, tpls) for t, name in enumerate(tenants)]
                for name, tk in zip(tenants, tickets):
                    o = tk.wait(timeout=300.0)
                    if o.status != "ok":
                        raise AssertionError(f"replicas: {name} cycle {c}: {o.status} {o.reason}")
                    digests[(name, c)] = _placement_digest(o.result)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            service.close()
        return wall, digests, launches, moved

    flat_wall, flat, flat_launches, _ = run(serve.SolveService(device=dev, batching=False))
    arms = {}
    for n in (1, 2):
        rs = ReplicaSet(n, device=dev, batching=False)
        wall, digests, launches, _ = run(rs)
        bad = [k for k in flat if digests[k] != flat[k]]
        if bad:
            raise AssertionError(f"replicas: ReplicaSet({n}) placements differ from the flat service's: {bad[:4]}")
        if not launches.get("ffd_loop"):
            raise AssertionError(f"replicas: ReplicaSet({n}) launched no ffd_loop: {launches}")
        arms[n] = dict(wall_s=wall, pods_per_s=pods_total / wall, launches=launches,
                       per_replica=sorted(i for i, _ in rs.placements().values()))
    rs = ReplicaSet(2, device=dev, batching=False)
    wall, digests, launches, moved = run(rs, failover_at=3)
    placed = rs.placements()
    if (not moved or any(placed[t] != (0, PLACE_FAILOVER) for t in moved)
            or len(digests) != len(flat) or rs.dead_replicas() != [1]):
        raise AssertionError(f"replicas: failover moved {moved}, placements {placed}")
    out = {"flat_pods_per_s": pods_total / flat_wall, "flat_wall_s": flat_wall, "flat_launches": flat_launches,
           "replicas": {str(n): arm for n, arm in arms.items()},
           "failover": {"moved": len(moved), "wall_s": wall, "tickets": len(digests),
                        "reasons": rs.snapshot()["placement_reasons"]}}
    log(f"  replicas ({SERVE_TENANTS} tenants x {SERVE_CYCLES} cycles x {SERVE_PODS} pods, stacking off): flat "
        f"{out['flat_pods_per_s']:.1f} pods/s; ReplicaSet(1) {arms[1]['pods_per_s']:.1f} pods/s, ReplicaSet(2) "
        f"{arms[2]['pods_per_s']:.1f} pods/s (tenants per replica "
        f"{[arms[2]['per_replica'].count(i) for i in (0, 1)]}); every tenant's placements equal the flat "
        f"service's; failover(1) after cycle 3 moved {len(moved)} tenants (reason failover), all "
        f"{len(digests)} tickets ok")
    return out


if __name__ == "__main__":
    sys.exit(main())
