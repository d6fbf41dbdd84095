"""Partitioned solve orchestration: encode, pad, dispatch, gate, merge.

Counterpart of the JAX package's ``shard/solve.py``. ``try_shard_solve`` is
the single entry the backend calls (solver/torch_backend.py,
``KARPENTER_TPU_SHARD``). It either returns a complete SolveResult produced
by the partitioned programs, or None after recording one classified
standdown reason (``solver_shard_fallback_total{reason}``): the caller then
runs the ordinary unsharded path, so nothing here is ever a correctness
dependency.

The pipeline:

1. **Partition** (shard/partition.py): union-find over the exact oracle
   compatibility checks splits the batch into independent sub-problems.
2. **Encode against ONE vocabulary**: every partition encodes with
   ``vocab_pods``/``vocab_reqs``/``vocab_nodes`` seeded from the FULL batch
   and a clone of ONE full-batch Topology (with every node hostname
   registered before cloning), so K/V/R/G/D/PT and the group order are
   identical across partitions by construction, the precondition for
   stacking them.
3. **Pad to a common bucket** (ops/padding.py min_pods/min_nodes/min_runs
   floors) and stack, one lane per partition.
4. **Dispatch one lane grid** (parallel/mesh.shard_sweeps, program 13: one
   ``ffd_loop`` launch, one cluster per lane, each running its own requeue
   loop to its own convergence). NO_SLOT in any lane re-dispatches every
   lane at the next claim bucket, exactly like the unsharded ladder. With
   ``KARPENTER_TPU_RELAX2`` on and a relax-applicable stack,
   parallel/mesh.shard_relax2_sweeps (program 14) runs each lane's convex
   phase 1 and its carried repair instead.
5. **Gate per partition**: each lane's decoded result carries its own
   GateContext (the padded tensors it decoded from) through the full-level
   device gate (one ``gate_counts`` launch per partition), sound because
   partitions are constraint-disjoint, so partition-local invariants ARE
   the full-problem invariants.
6. **Merge**: per-partition results concatenate on disjoint index sets;
   cross-partition claims may additionally be joined by exact host
   arithmetic (identical narrowed requirements, infinite template, no
   ports/groups/volumes, combined requests fit a shared instance type).
   Any gate violation or merge inconsistency is a ``merge-rejected``
   standdown, never a returned result.

What holds against the unsharded solve: every pod it schedules is
scheduled here too, and a pod scheduled here beyond them carries a required
pod affinity. Pods in different partitions share no node, no group and no
finite template budget, so a pod's feasibility is decided by
partition-local state; but a pod with a required pod affinity must join
the claim its peers landed in, whose room the unsharded solve shares with
every other partition's pods. So exact scheduled-set parity, which the JAX
package's docstring claims, does not hold in either package: its own 10k
fleet schedules 9,862 sharded against 9,829 with its FFD control, and the
100k fleet here 100,000 against 99,461 (ROADMAP.md C4).

Differences from the JAX package: the lanes are blocks of one launch on the
solver's device, not devices of a mesh, so the lane axis is not padded to a
device multiple (``lanes`` equals ``partitions``, and ``pad_frac`` counts
only the bucket padding). The dispatch is counted in
``solver_compile_cache_total`` and the program registry (obs/programs.py)
as the JAX package's is; its per-dispatch AOT hook has no counterpart (the
port's snapshots act at library load, solver/aot.py). An error of
the kernels or of the CUDA runtime propagates, as everywhere in this
package; any other exception is the ``error`` standdown. The wall of each
stage lands in ``solver.last_timing`` (topology, partition, encode,
dispatch, decode, gate, merge, validate).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

from karpenter_tpu_torch import shard as flags
from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.metrics.registry import (
    SHARD_FALLBACK,
    SHARD_MERGE_REJECTIONS,
    SHARD_PAD_FRACTION,
    SHARD_PARTITIONS,
    TRANSFER_BYTES,
)
from karpenter_tpu_torch.obs import flight, programs, trace
from karpenter_tpu_torch.verify.gate import _nbytes
from karpenter_tpu_torch.ops.ffd_core import KIND_CLAIM, KIND_NEW_CLAIM, KIND_NODE, KIND_NO_SLOT
from karpenter_tpu_torch.ops.ffd_sweeps import wavefront_lanes
from karpenter_tpu_torch.ops.padding import claim_axis_bucket, pad_problem
from karpenter_tpu_torch.provisioning.preferences import Preferences
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.scheduling.hostports import get_host_ports
from karpenter_tpu_torch.shard.partition import group_members, partition_pods
from karpenter_tpu_torch.solver.backend import FAIL_INCOMPATIBLE, SolveResult
from karpenter_tpu_torch.solver.encode import Encoder, _reqs_digest

log = logging.getLogger(__name__)


def _standdown(solver, reason: str, **info) -> None:
    """Record one classified fallback and return None to the caller."""
    SHARD_FALLBACK.inc({"reason": reason})
    flight.record(flight.KIND_SHARD_STANDDOWN, reason=reason)
    solver.last_shard = {"reason": reason, **info}
    with trace.span("shard_standdown", reason=reason):
        pass
    return None


def _tree_shapes(problem) -> tuple:
    """(field, shape, dtype) of every array leaf of a host problem."""
    out = []
    for f in dataclasses.fields(problem):
        value = getattr(problem, f.name)
        if value is None:
            continue
        if dataclasses.is_dataclass(value):
            out.extend((f.name + "." + name, shape, dtype) for name, shape, dtype in _tree_shapes(value))
        else:
            arr = np.asarray(value)
            out.append((f.name, arr.shape, str(arr.dtype)))
    return tuple(out)


def _free_pods(pods, groups) -> List[bool]:
    """Pods with no host ports and no topology-group membership: the only
    pods whose claims the cross-partition merge may join (everything that
    could make a join observable — port clashes, skew counts, affinity —
    is absent). Membership as shard/partition.group_members takes it."""
    return [not get_host_ports(p) and not gis for p, gis in zip(pods, group_members(pods, groups))]


def _merge_claims(
    out: SolveResult,
    claim_lanes: List[int],
    templates,
    instance_types,
    free: List[bool],
) -> int:
    """Conservatively join claims from DIFFERENT partitions that are
    observably identical: same template (with no finite budget), identical
    narrowed Requirements, only merge-free pods, and combined requests —
    counting the daemonset overhead once — fit some instance type both
    claims kept. Every check is exact host arithmetic; claims the device
    kept apart WITHIN a lane stay apart (the device already decided their
    packing). Returns the number of joins performed."""
    by_key: Dict[tuple, List[int]] = {}
    for ci, claim in enumerate(out.new_claims):
        tpl = templates[claim.template_index]
        if tpl.remaining_resources is not None:
            continue
        if not all(free[pi] for pi in claim.pod_indices):
            continue
        key = (claim.template_index, _reqs_digest(claim.requirements))
        by_key.setdefault(key, []).append(ci)

    merged_into: Dict[int, int] = {}
    joins = 0
    for (tpl_idx, _digest), members in by_key.items():
        overhead = templates[tpl_idx].daemon_overhead
        for i, ci in enumerate(members):
            if ci in merged_into:
                continue
            a = out.new_claims[ci]
            for cj in members[i + 1:]:
                if cj in merged_into or claim_lanes[cj] == claim_lanes[ci]:
                    continue
                b = out.new_claims[cj]
                shared_its = sorted(set(a.instance_type_indices) & set(b.instance_type_indices))
                if not shared_its:
                    continue
                combined: Dict[str, float] = dict(a.requests)
                for name, v in b.requests.items():
                    combined[name] = combined.get(name, 0.0) + v
                for name, v in overhead.items():
                    if name in combined:
                        combined[name] = combined[name] - float(v)
                fits = [
                    ti
                    for ti in shared_its
                    if all(
                        v <= instance_types[ti].allocatable().get(name, 0.0)
                        for name, v in combined.items()
                        if v > 0
                    )
                ]
                if not fits:
                    continue
                a.pod_indices.extend(b.pod_indices)
                a.instance_type_indices = fits
                a.requests = {k: v for k, v in combined.items() if v > 0}
                merged_into[cj] = ci
                joins += 1
    if merged_into:
        out.new_claims = [c for ci, c in enumerate(out.new_claims) if ci not in merged_into]
    return joins


def try_shard_solve(
    solver,
    pods,
    instance_types,
    templates,
    nodes,
    pod_requirements_override,
    topology,
    cluster_pods,
    domains,
    pod_volumes,
) -> Optional[SolveResult]:
    """The KARPENTER_TPU_SHARD entry (see module docstring). ``solver`` is
    the TorchSolver: its device, claim-slot ladder and ``last_shard`` /
    ``last_timing`` telemetry are shared with the unsharded path."""
    from karpenter_tpu_torch.solver.supervisor import device_fault

    try:
        return _try_shard_solve(
            solver, pods, instance_types, templates, nodes,
            pod_requirements_override, topology, cluster_pods, domains,
            pod_volumes,
        )
    except Exception as exc:
        if device_fault(exc):
            raise
        log.warning(
            "shard: partitioned solve degraded to unsharded path: %s: %s",
            type(exc).__name__, exc, exc_info=True,
        )
        return _standdown(solver, flags.REASON_ERROR, error=str(exc))


def _fetch_lanes(results, relax2_stats):
    """Every lane's verdicts, claim tensors and IterCounts, and the phase-1
    stats, on the host."""
    from karpenter_tpu_torch.ops.relax2 import host_stats
    from karpenter_tpu_torch.solver.torch_backend import fetch_claims

    kinds = [r.kind.cpu().numpy() for r in results]
    indices = [r.index.cpu().numpy() for r in results]
    claims = [fetch_claims(r.state) for r in results]
    iters = [tuple(int(x) for x in r.iters) for r in results]
    stats = None if relax2_stats is None else [host_stats(s) for s in relax2_stats]
    # host_stats fetches one int32 word per stat
    d2h = (sum(k.nbytes + i.nbytes + _nbytes(c) for k, i, c in zip(kinds, indices, claims))
           + sum(4 * len(r.iters) for r in results)  # the loop's int32 counter words
           + (0 if relax2_stats is None else sum(4 * len(s) for s in relax2_stats)))
    TRANSFER_BYTES.inc({"direction": "d2h"}, d2h)
    return kinds, indices, claims, iters, stats


def _try_shard_solve(
    solver, pods, instance_types, templates, nodes,
    pod_requirements_override, topology, cluster_pods, domains, pod_volumes,
) -> Optional[SolveResult]:
    from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
    from karpenter_tpu_torch.parallel.mesh import (
        default_mesh,
        lane_problem,
        shard_relax2_sweeps,
        shard_sweeps,
        stack_problems,
    )
    from karpenter_tpu_torch.solver import mesh_health

    solver.last_shard = None
    timing = {"topology": 0.0, "partition": 0.0, "encode": 0.0, "dispatch": 0.0, "decode": 0.0, "gate": 0.0,
              "merge": 0.0, "validate": 0.0}
    solver.last_timing = timing
    if len(pods) < flags.min_pods():
        return _standdown(solver, flags.REASON_SMALL_BATCH, pods=len(pods))
    mesh = default_mesh(flags.min_devices(), solver.device)
    if mesh is None:
        return _standdown(solver, flags.REASON_SINGLE_DEVICE)
    from karpenter_tpu_torch.obs import explain as obs_explain

    if obs_explain.enabled():
        # failure attribution reads end-of-pass bin state the shard path
        # does not fetch — explain cycles keep the unsharded path
        return _standdown(solver, flags.REASON_UNSUPPORTED_ARGS, arg="explain")
    prefs = Preferences(
        tolerate_prefer_no_schedule=any(
            t.effect == "PreferNoSchedule" for tpl in templates for t in tpl.taints
        )
    )
    if prefs.tolerate_prefer_no_schedule or any(Preferences.is_relaxable(p) for p in pods):
        # the relaxation ladder re-encodes between passes per pod — that
        # host loop has no partition-stacked equivalent
        return _standdown(solver, flags.REASON_RELAXABLE)

    t0 = time.perf_counter()
    # ONE full-batch topology: every partition solves against a clone, so
    # group order, domain censuses, and G/F shapes are identical lanes;
    # foreign groups are inert (no partition pod matches them — the
    # partitioner co-locates every group's pods).
    topo_full = (
        topology.clone()
        if topology is not None
        else Topology(domains, batch_pods=list(pods), cluster_pods=cluster_pods)
    )
    for n in nodes:
        topo_full.register(wk.LABEL_HOSTNAME, n.name)
    groups = list(topo_full.topologies.values()) + list(topo_full.inverse_topologies.values())
    timing["topology"] += time.perf_counter() - t0

    def _plan_for(mesh_):
        # re-invoked after a recarve: the partition fan-out tracks the
        # CURRENT device count, so a shrunken device list gets a shrunken plan
        t0 = time.perf_counter()
        with trace.span("shard_partition", pods=len(pods)):
            plan_ = partition_pods(
                pods, templates, nodes, groups,
                flags.target_partitions(len(mesh_)),
                pod_requirements_override,
            )
        timing["partition"] += time.perf_counter() - t0
        return plan_

    plan = _plan_for(mesh)
    if plan.reason is not None:
        return _standdown(
            solver, plan.reason,
            atomic=plan.atomic_components, splittable=plan.splittable_pods,
        )
    max_part = max(len(pt.pod_idx) for pt in plan.parts)
    ceiling = flags.max_partition_pods()
    if 0 < ceiling < max_part:
        return _standdown(solver, flags.REASON_SINGLE_PARTITION, dominant=max_part)

    encoder = Encoder(solver.well_known)
    vocab_pods = list(pods)
    max_claims = min(solver.claim_slots, claim_axis_bucket(max_part))
    claim_cap = claim_axis_bucket(max_part)

    recarves = 0
    while True:
        t0 = time.perf_counter()
        padded, metas = [], []
        with trace.span("shard_encode", partitions=len(plan.parts), max_claims=max_claims):
            for part in plan.parts:
                enc = encoder.encode(
                    [pods[i] for i in part.pod_idx],
                    instance_types,
                    templates,
                    [nodes[j] for j in part.node_idx],
                    pod_reqs_override=(
                        [pod_requirements_override[i] for i in part.pod_idx]
                        if pod_requirements_override is not None
                        else None
                    ),
                    topology=topo_full.clone(),
                    num_claim_slots=max_claims,
                    vocab_pods=vocab_pods,
                    vocab_reqs=pod_requirements_override,
                    pod_volumes=(
                        [pod_volumes[i] for i in part.pod_idx]
                        if pod_volumes is not None
                        else None
                    ),
                    vocab_nodes=nodes,
                )
                padded.append(enc)
                metas.append(enc.meta)
            max_n = max(len(pt.node_idx) for pt in plan.parts)
            max_rn = max(e.problem.num_runs for e in padded)
            padded = [
                pad_problem(e.problem, min_pods=max_part, min_nodes=max_n, min_runs=max_rn)
                for e in padded
            ]
        shapes = _tree_shapes(padded[0])
        if any(_tree_shapes(p) != shapes for p in padded[1:]):
            # the one-vocabulary construction should make this impossible;
            # if it ever fires, the unsharded path is the answer, not a crash
            return _standdown(solver, flags.REASON_SHAPE_MISMATCH)

        # one lane per partition: the lanes are blocks of one launch, so
        # the lane axis is not padded to a device multiple
        batch = stack_problems(padded)
        bucket_pods = int(np.asarray(padded[0].pod_active).shape[0])
        pad_frac = 1.0 - len(pods) / float(max(1, len(padded) * bucket_pods))
        dev_batch = problem_to_torch(batch, solver.device)
        TRANSFER_BYTES.inc({"direction": "h2d"}, sum(x.nbytes for x in numpy_fields(batch).values()))
        timing["encode"] += time.perf_counter() - t0

        # KARPENTER_TPU_RELAX2 rides the lanes too: when the stacked batch
        # is relax-applicable (infinite pools across every lane), each lane
        # runs the convex phase 1 and the carried repair (program 14)
        # instead of the fresh sweeps; the env check gates the import
        relax2_on = False
        if os.environ.get("KARPENTER_TPU_RELAX2", "0") == "1":
            from karpenter_tpu_torch.ops import relax2

            relax2_on = relax2.relax_applicable(batch)
        program_name = "shard_relax2_sweeps" if relax2_on else "shard_sweeps"
        wavefront = wavefront_lanes()

        t0 = time.perf_counter()
        from karpenter_tpu_torch.ops.ffd_core import problem_bounds_free
        from karpenter_tpu_torch.solver.torch_backend import count_program

        count_program(solver, program_name, max_claims, dev_batch)
        obs = programs.begin_dispatch(
            program_name, max_claims, dev_batch,
            statics={"partitions": len(plan.parts), "devices": len(mesh),
                     "bounds_free": bool(problem_bounds_free(batch)), "wavefront": wavefront},
            kernel="ffd_loop_lanes",
        )
        try:
            mesh_health.dispatch_check(mesh)
            with trace.span(program_name, partitions=len(plan.parts)) as sp:
                r2_stats = None
                if relax2_on:
                    results, r2_stats = shard_relax2_sweeps(
                        dev_batch, max_claims, relax2.pgd_iters(), relax2.pgd_step(), wavefront=wavefront)
                else:
                    results = shard_sweeps(dev_batch, max_claims, wavefront=wavefront)
                kinds, indices, claims_np, iters, r2_stats = _fetch_lanes(results, r2_stats)
                if obs is not None:
                    programs.stamp(sp, obs, obs.finish(problem_bytes=_nbytes(dev_batch)))
        except Exception as exc:  # classified below, or re-raised
            if mesh_health.handle_dispatch_failure(exc) is None:
                raise
            # a device died mid-dispatch: the tracker recarved around it.
            # Re-plan against the shrunken device count and re-dispatch the
            # WHOLE lane set from host-side problem data (every loop
            # iteration re-encodes/pads/stacks from host, so nothing
            # device-resident is resurrected).
            timing["dispatch"] += time.perf_counter() - t0
            recarves += 1
            mesh = default_mesh(flags.min_devices(), solver.device)
            if mesh is None:
                # below the minimum device count: the same single-device
                # standdown the first check classifies
                return _standdown(solver, flags.REASON_SINGLE_DEVICE, recarves=recarves)
            plan = _plan_for(mesh)
            if plan.reason is not None:
                return _standdown(
                    solver, plan.reason,
                    atomic=plan.atomic_components,
                    splittable=plan.splittable_pods,
                )
            max_part = max(len(pt.pod_idx) for pt in plan.parts)
            if 0 < ceiling < max_part:
                return _standdown(solver, flags.REASON_SINGLE_PARTITION, dominant=max_part)
            claim_cap = claim_axis_bucket(max_part)
            max_claims = min(solver.claim_slots, claim_cap)
            continue
        timing["dispatch"] += time.perf_counter() - t0
        programs.note_shard_lanes(
            len(plan.parts), len(padded),
            [len(pt.pod_idx) for pt in plan.parts],
            [len(pt.node_idx) for pt in plan.parts],
        )

        overflow = any(
            (kinds[li][: len(part.pod_idx)] == KIND_NO_SLOT).any()
            for li, part in enumerate(plan.parts)
        )
        if not overflow:
            break
        if max_claims >= claim_cap:
            return _standdown(solver, flags.REASON_SLOT_OVERFLOW, max_claims=max_claims)
        max_claims = min(claim_axis_bucket(max_claims + 1), claim_cap)
        solver.claim_slots = max(solver.claim_slots, max_claims)
        solver.claim_escalations += 1
        with trace.span("escalate", max_claims=max_claims):
            pass

    # -- decode + gate each partition, then merge ---------------------------
    from karpenter_tpu_torch import verify
    from karpenter_tpu_torch.solver.forensics import failure_reason
    from karpenter_tpu_torch.solver.torch_backend import decode_claim_placements

    t0 = time.perf_counter()
    out = SolveResult()
    claim_lanes: List[int] = []  # source lane per merged-in claim
    gate_rejections = 0
    with trace.span("shard_decode", partitions=len(plan.parts)):
        for li, part in enumerate(plan.parts):
            meta = metas[li]
            part_pods = [pods[i] for i in part.pod_idx]
            part_nodes = [nodes[j] for j in part.node_idx]
            part_override = (
                [pod_requirements_override[i] for i in part.pod_idx]
                if pod_requirements_override is not None
                else None
            )
            local = SolveResult()
            pod_kinds: Dict[int, tuple] = {}
            for row in range(len(meta.pod_order)):
                loc = meta.pod_order[row]
                kind, index = int(kinds[li][row]), int(indices[li][row])
                if kind in (KIND_NODE, KIND_CLAIM, KIND_NEW_CLAIM):
                    pod_kinds[loc] = (kind, index)
                else:
                    local.failures[loc] = failure_reason(
                        part_pods[loc],
                        instance_types,
                        templates,
                        pod_reqs=part_override[loc] if part_override is not None else None,
                        well_known=solver.well_known,
                    ) or FAIL_INCOMPATIBLE
            decode_claim_placements(local, meta, max_claims, claims_np[li], pod_kinds)

            # the per-partition full-level device gate: partition-local
            # invariants ARE the full-problem invariants (disjoint
            # constraints), and the lane's padded tensors are the exact
            # context the unsharded gate would see for this sub-problem
            local.verify_ctx = verify.make_context(
                padded[li], meta, max_claims, len(part_pods),
                pod_requirements_override is not None,
                device_problem=lane_problem(dev_batch, li), device=solver.device,
            )
            t_gate = time.perf_counter()
            outcome = verify.full_gate(
                local, part_pods, instance_types, templates, part_nodes,
                part_override, cluster_pods, domains,
            )
            timing["gate"] += time.perf_counter() - t_gate
            if outcome is not None and outcome.violations:
                gate_rejections += 1
                SHARD_MERGE_REJECTIONS.inc()
                return _standdown(
                    solver, flags.REASON_MERGE_REJECTED,
                    partition=li, violations=len(outcome.violations),
                )

            # fold into the global result (original pod indices)
            for name, plist in local.node_pods.items():
                out.node_pods.setdefault(name, []).extend(part.pod_idx[i] for i in plist)
            for loc, reason in local.failures.items():
                out.failures[part.pod_idx[loc]] = reason
            for claim in local.new_claims:
                claim.pod_indices = [part.pod_idx[i] for i in claim.pod_indices]
                out.new_claims.append(claim)
                claim_lanes.append(li)
    timing["decode"] += time.perf_counter() - t0 - timing["gate"]

    t0 = time.perf_counter()
    merged = 0
    if flags.merge_enabled() and pod_volumes is None:
        with trace.span("shard_merge", claims=len(out.new_claims)):
            merged = _merge_claims(
                out, claim_lanes, templates, instance_types, _free_pods(pods, groups),
            )
    timing["merge"] += time.perf_counter() - t0

    if 0 < len(pods) <= flags.full_validate_max():
        # belt-and-braces at small scale: the float64 validator over the
        # MERGED result (the per-partition gates covered everything except
        # the merge step, whose checks are exact — this confirms that)
        from karpenter_tpu_torch.solver.validator import validate_result

        t0 = time.perf_counter()
        violations = validate_result(
            out, pods, instance_types, templates, nodes,
            pod_requirements_override, cluster_pods, domains, level="full",
        )
        timing["validate"] += time.perf_counter() - t0
        if violations:
            SHARD_MERGE_REJECTIONS.inc()
            return _standdown(solver, flags.REASON_MERGE_REJECTED, violations=len(violations))

    SHARD_PARTITIONS.set(float(len(plan.parts)))
    SHARD_PAD_FRACTION.set(round(pad_frac, 6))
    solver.last_iters = None
    solver.last_wave_hist = None
    solver.last_relax = None
    solver.last_relax2 = None
    if r2_stats is not None:
        solver.last_relax2 = {
            "reason": None,
            "sharded": True,
            "lanes": len(r2_stats),
            "eligible": sum(s.eligible for s in r2_stats),
            "placed": sum(s.placed for s in r2_stats),
            "demoted": sum(s.demoted for s in r2_stats),
            "claims": sum(s.claims for s in r2_stats),
            "pgd_iterations": max(s.pgd_iterations for s in r2_stats),
            "residual": max(s.residual for s in r2_stats),
            "capviol": max(s.capviol for s in r2_stats),
            "rounding": {
                "overflow": sum(s.overflow for s in r2_stats),
                "demoted": sum(s.round_demoted for s in r2_stats),
            },
        }
    solver.last_shard = {
        "reason": None,
        "partitions": len(plan.parts),
        "lanes": len(padded),
        "bucket_pods": bucket_pods,
        "pad_frac": round(pad_frac, 6),
        "max_claims": max_claims,
        "merged_claims": merged,
        "dropped_nodes": plan.dropped_nodes,
        "splittable_pods": plan.splittable_pods,
        "atomic_components": plan.atomic_components,
        "narrow_iters": sum(it[0] for it in iters),
        "sweep_iters": sum(it[1] for it in iters),
        "gate_rejections": gate_rejections,
        "recarves": recarves,
        "part_pods": [len(pt.pod_idx) for pt in plan.parts],
        "wavefront": wavefront,
    }
    # first green solve after a device failure closes the recovery clock
    mesh_health.note_green()
    if programs.enabled():
        programs.sample_memory(pods=len(pods), cycle=trace.current_trace_id(), device=solver.device,
                               held_bytes=_nbytes(dev_batch))
    return out
