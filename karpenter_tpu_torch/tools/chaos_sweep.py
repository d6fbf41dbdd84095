"""Chaos sweep: run the fault matrix (fault class x backend x corpus) through
the supervised solver and print a survival table.

Counterpart of the JAX system's ``tools/chaos_sweep.py`` over the port.
Survival means the provisioning cycle COMPLETES: the solve returns a
SolveResult (placements, or requeued pods in salvage mode) instead of
raising, and — when the fallback answered — the placements match the
fault-free oracle baseline. Zero dropped cycles is the acceptance bar.

The injected fault classes fail over as in the JAX package. A real error of
the port's kernels or of the CUDA runtime does not: the supervisor raises it
(``solver.supervisor.device_fault``), and a row that meets one fails.

    python -m karpenter_tpu_torch.tools.chaos_sweep --quick
    python -m karpenter_tpu_torch.tools.chaos_sweep --quick --device cpu
    python -m karpenter_tpu_torch.tools.chaos_sweep --pods 60,300 --backends oracle,torch

``--quick`` runs the 60-pod corpus and the smaller fleet row; the backends
stay those of ``--backends`` (the JAX tool's ``--quick`` keeps the oracle
alone: the port's quick matrix is the one the card runs).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile
import time
from contextlib import contextmanager

# fault class -> KARPENTER_TPU_FAULTS spec driven at the primary backend;
# "hang" needs the watchdog, so a deadline is set for every cell
FAULT_SPECS = {
    "none": "",
    "compile": "solve.compile@1",
    "device": "solve.device@1",
    "device-storm": "solve.device@1..3",
    "nan": "solve.nan@1",
    "hang": "solve.hang=0.6@1",
    "encode": "solve.encode@1",
    "flaky-p25": "seed=7;solve.device@p0.25",
}

BACKENDS = ("oracle", "torch")


def build_problem(pod_count: int, its_count: int):
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.testing.workloads import make_diverse_pods

    its = instance_types(its_count)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="chaos")), its, range(len(its)))
    pods = make_diverse_pods(pod_count, random.Random(42))
    return pods, its, [tpl]


def make_backend(name: str, device=None):
    """``torch``: a ``TorchSolver`` on ``device`` (CUDA unless ``cpu``), with
    the JAX package's ``KARPENTER_TPU_RELAX`` and ``KARPENTER_TPU_DEVICE_
    WORLD`` rules read now; ``oracle``: the pure-Python ``OracleSolver``."""
    if name == "torch":
        from karpenter_tpu_torch.operator.operator import device_world_enabled, relax_enabled
        from karpenter_tpu_torch.solver.torch_backend import TorchSolver

        return TorchSolver(device=device, relax=relax_enabled(), device_world=device_world_enabled())
    if name != "oracle":
        raise ValueError(f"unknown backend {name!r} (one of {', '.join(BACKENDS)})")
    from karpenter_tpu_torch.solver.oracle import OracleSolver

    return OracleSolver()


def placements_key(result):
    return (
        tuple(
            (c.template_index, tuple(c.pod_indices), tuple(c.instance_type_indices))
            for c in result.new_claims
        ),
        tuple(sorted((k, tuple(v)) for k, v in result.node_pods.items())),
        tuple(sorted(result.failures)),
    )


@contextmanager
def _env(**values):
    """Set environment variables for the block and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _reclaim_nodes(prefix: str, count: int):
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.scheduling import Taints, label_requirements
    from karpenter_tpu_torch.solver.encode import NodeInfo

    return [
        NodeInfo(
            name=f"{prefix}-{i}",
            requirements=label_requirements({wk.LABEL_HOSTNAME: f"{prefix}-{i}"}),
            taints=Taints(()),
            available={"cpu": 8.0, "memory": 32 * 1024.0**3, "pods": 40.0},
            daemon_overhead={},
        )
        for i in range(count)
    ]


def run_matrix(pod_counts=(60,), backends=BACKENDS, its_count: int = 50, deadline_s: float = 0.25,
               device=None) -> list:
    """The fault matrix: for each corpus, backend and fault class one
    supervised solve under the class's spec. A row per cell; ``key`` is the
    result's ``placements_key`` (None for a dropped cycle) and ``error`` the
    exception that dropped it."""
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.testing import faults

    rows = []
    for pod_count in pod_counts:
        pods, its, tpls = build_problem(pod_count, its_count)
        baseline = OracleSolver().solve(pods, its, tpls)
        base_key = placements_key(baseline)
        for backend_name in backends:
            if backend_name == "torch":
                # load the kernels outside the deadline/fault window so
                # 'hang' rows time the injected sleep, not a build; an error
                # here shows again in every cell, which it drops
                try:
                    make_backend(backend_name, device).solve(pods, its, tpls)
                except Exception as exc:
                    print(f"warm solve: {backend_name}: {type(exc).__name__}: {exc}")
            for fault, spec in FAULT_SPECS.items():
                faults.install(faults.FaultInjector.from_spec(spec) if spec else None)
                sup = SupervisedSolver(
                    make_backend(backend_name, device),
                    fallback=OracleSolver(),
                    deadline_s=deadline_s if fault == "hang" else 0.0,
                    retries=1,
                    backoff_base_s=0.01,
                )
                t0 = time.perf_counter()
                error = None
                try:
                    result = sup.solve(pods, its, tpls)
                    survived = True
                except Exception as exc:  # a raised solve IS a dropped cycle
                    print(f"DROPPED CYCLE: {backend_name}/{fault}: {type(exc).__name__}: {exc}")
                    result, survived, error = None, False, f"{type(exc).__name__}: {exc}"
                finally:
                    faults.install(None)
                elapsed = time.perf_counter() - t0
                scheduled = result.num_scheduled() if result else 0
                key = placements_key(result) if result is not None else None
                parity = result is not None and (key == base_key or scheduled == baseline.num_scheduled())
                rows.append({
                    "pods": pod_count,
                    "backend": backend_name,
                    "fault": fault,
                    "survived": survived,
                    "scheduled": f"{scheduled}/{len(pods)}",
                    "parity": parity,
                    "retries": sup.counters["solve_retries"],
                    "fallbacks": sup.counters["solve_fallbacks"],
                    "s": round(elapsed, 3),
                    "key": key,
                    "base_key": base_key,
                    "error": error,
                })
    faults.clear()
    return rows


def print_matrix(rows) -> list:
    """Print the survival table; returns the failed rows."""
    header = ("pods", "backend", "fault", "survived", "scheduled", "parity", "retries", "fallbacks", "s")
    widths = {h: max(len(h), *(len(str(r[h])) for r in rows)) for h in header}
    line = "  ".join(h.ljust(widths[h]) for h in header)
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(r[h]).ljust(widths[h]) for h in header))
    failed = [r for r in rows if not r["survived"] or not r["parity"]]
    print(
        f"\n{len(rows) - len(failed)}/{len(rows)} cells survived with parity"
        + ("" if not failed else f"; FAILED: {[{h: r[h] for h in header + ('error',)} for r in failed]}")
    )
    return failed


def churn_survival(cycles: int = 8) -> bool:
    """Post-matrix row: drive the streaming solver through seeded churn with
    ``cloud.reclaim`` firings and require every cycle to complete
    validator-clean. This is the reclaim coverage for the shared fault
    grammar — the matrix above exercises solve-site faults, this exercises
    the provider-initiated kind the churn generator draws."""
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.streaming import StreamingSolver
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess, run_churn
    from karpenter_tpu_torch.testing import faults

    pods, its, tpls = build_problem(80, 20)
    nodes = _reclaim_nodes("reclaim-node", 6)
    faults.install(faults.FaultInjector.from_spec("seed=11;cloud.reclaim=1@p0.5"))
    solver = SupervisedSolver(StreamingSolver(OracleSolver()), fallback=OracleSolver())
    try:
        process = ChurnProcess(
            pods,
            nodes=nodes,
            config=ChurnConfig(seed=11, arrivals_per_cycle=4, deletes_per_cycle=2),
        )
        records = run_churn(solver, process, its, tpls, cycles, validate=True)
    finally:
        faults.install(None)
    reclaimed = sum(r["reclaimed"] for r in records)
    dirty = [r for r in records if r["violations"]]
    ok = not dirty and reclaimed > 0
    print(
        f"\nchurn survival: {len(records)} cycles, {reclaimed} nodes reclaimed "
        f"(cloud.reclaim), outcomes="
        + ",".join(str(r.get("outcome", "?")) for r in records)
        + f" -> {'OK' if ok else 'FAILED: ' + repr(dirty or 'no reclaim fired')}"
    )
    return ok


def tenant_isolation(
    tenants: int = 8,
    cycles: int = 8,
    registered: int = 0,
    classes=None,
    reclaim_spec: str = "reclaim=1@p0.5",
    label: str = "tenant isolation",
    backend: str = "oracle",
    device=None,
) -> bool:
    """Post-matrix row: the multi-tenant blast-radius bar. N churn streams
    share one SolveService; one tenant takes 100% solve faults plus spot
    reclaims while the rest run clean. The service must (a) drop zero cycles
    fleet-wide, (b) salvage or circuit-break the faulty tenant, and (c) leave
    the healthy tenants' placements BIT-IDENTICAL to a no-fault control run
    with end-to-end p99 within 1.5x of control — the cross-tenant isolation
    contract, measured rather than asserted. Batching is off in both runs so
    the control/chaos placement comparison is exact.

    ``registered`` > ``tenants`` registers that many EXTRA idle streams
    (the fleet row: 1,000 registered, 64 active — idle registrations must
    cost the active streams nothing); ``classes`` turns on the hierarchical
    dispatcher with striped class assignment (the parity bar is unchanged:
    a tenant's placements depend on its own stream, not dispatch order).
    ``backend`` is the active tenants' primary (``make_backend``); the
    service runs on ``device``."""
    import random as _random

    from karpenter_tpu_torch import serve as serve_pkg
    from karpenter_tpu_torch.obs import flight as obs_flight, slo as obs_slo
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import CIRCUIT_CLOSED
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess
    from karpenter_tpu_torch.testing import faults
    from karpenter_tpu_torch.testing.workloads import make_diverse_pods

    faulty = f"t{tenants - 1}"
    total = max(tenants, registered)
    class_names = sorted(classes) if classes else []
    _, its, tpls = build_problem(20, 20)

    def cls_of(i: int):
        return class_names[i % len(class_names)] if class_names else None

    def run(spec: str):
        service = serve_pkg.SolveService(
            batching=False, max_tenants=total,
            classes=dict(classes) if classes else None, device=device,
        )
        procs, solvers = {}, {}
        for i in range(tenants):
            tid = f"t{i}"
            solvers[tid] = serve_pkg.build_tenant_solver(
                tid, primary=make_backend(backend, device), fallback=OracleSolver(),
                retries=1, backoff_base_s=0.01,
            )
            service.register_tenant(tid, solver=solvers[tid], tenant_class=cls_of(i))
        # idle fleet: registered-but-silent streams (a cheap stub solver —
        # they never solve) proving registration scale costs the active
        # streams nothing
        for i in range(tenants, total):
            service.register_tenant(f"idle{i}", solver=OracleSolver(), tenant_class=cls_of(i))
        for i in range(tenants):
            tid = f"t{i}"
            procs[tid] = ChurnProcess(
                make_diverse_pods(20, _random.Random(1000 + i)),
                nodes=_reclaim_nodes(f"{tid}-node", 4),
                config=ChurnConfig(seed=100 + i, arrivals_per_cycle=4, deletes_per_cycle=2),
            )
        faults.install(faults.FaultInjector.from_spec(spec) if spec else None)
        outcomes = {tid: [] for tid in procs}
        keys = {tid: [] for tid in procs}
        service.start()
        try:
            for _ in range(cycles):
                tickets = []
                for tid, proc in procs.items():
                    # the cloud-site reclaim draw happens inside step(); scope
                    # it so cloud[tenant] rules hit only their target stream
                    with faults.tenant_scope(tid):
                        proc.step()
                    tickets.append((tid, service.submit(tid, list(proc.pods), its, tpls, nodes=list(proc.nodes))))
                for tid, ticket in tickets:
                    out = ticket.wait(timeout=60.0)
                    outcomes[tid].append(out)
                    keys[tid].append(placements_key(out.result) if out.result is not None else None)
        finally:
            faults.install(None)
            service.close()
        return outcomes, keys, solvers

    # SLO engine live for both runs: one hostile tenant must not push any
    # HEALTHY class's serve objectives off green — blast radius measured at
    # the burn-rate layer too, not just placement parity
    obs_slo.set_enabled(True)
    obs_flight.set_enabled(True)
    obs_slo.reset()
    obs_flight.reset()
    try:
        with _env(KARPENTER_TPU_FLIGHT_DIR=tempfile.mkdtemp(prefix="chaos-flight-")):
            control_out, control_keys, _ = run("")
            spec = f"seed=13;solve[{faulty}].device@p1.0;cloud[{faulty}].{reclaim_spec}"
            chaos_out, chaos_keys, solvers = run(spec)
        hostile_cls = cls_of(tenants - 1)
        healthy_cls = {c for c in class_names if c != hostile_cls}
        slo_red = [
            s["name"] for s in obs_slo.engine().snapshot()
            if s["status"] != "ok"
            and s["name"].startswith(("serve-latency.", "serve-shed."))
            and s["name"].split(".", 1)[1] in healthy_cls
        ]
    finally:
        obs_slo.set_enabled(None)
        obs_flight.set_enabled(None)

    dropped = [
        (tid, o.status, o.reason)
        for outs in (control_out, chaos_out)
        for tid, lst in outs.items()
        for o in lst
        if o.status != "ok"
    ]
    healthy = [f"t{i}" for i in range(tenants - 1)]
    parity_bad = [t for t in healthy if chaos_keys[t] != control_keys[t]]
    sup = solvers[faulty]
    contained = sup.counters["solve_fallbacks"] > 0 or sup.circuit_state() != CIRCUIT_CLOSED

    def p99(lats):
        ordered = sorted(lats)
        return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]

    control_p99 = p99([o.latency_s for t in healthy for o in control_out[t]])
    chaos_p99 = p99([o.latency_s for t in healthy for o in chaos_out[t]])
    # absolute slack floors the ratio bound: sub-ms oracle solves would
    # otherwise fail on scheduler jitter alone
    slow = chaos_p99 > max(1.5 * control_p99, control_p99 + 0.25)
    ok = not dropped and not parity_bad and contained and not slow and not slo_red
    print(
        f"{label}: {tenants} active / {total} registered x {cycles} cycles ({backend}), "
        f"faulty={faulty} (fallbacks={sup.counters['solve_fallbacks']}, "
        f"circuit={sup.circuit_state()}), dropped={len(dropped)}, "
        f"healthy parity={'ok' if not parity_bad else parity_bad}, "
        f"healthy p99 {chaos_p99 * 1e3:.1f}ms vs control "
        f"{control_p99 * 1e3:.1f}ms, "
        f"healthy-class slo={'green' if not slo_red else slo_red}"
        f" -> {'OK' if ok else 'FAILED: ' + repr(dropped or parity_bad or slo_red or ('not contained' if not contained else 'p99'))}"
    )
    return ok


def fleet_isolation(registered: int = 1000, active: int = 64, cycles: int = 6, backend: str = "oracle",
                    device=None) -> bool:
    """Post-matrix row: tenant isolation AT FLEET SCALE. 1,000 registered
    streams (three classes, hierarchical DWRR live), 64 of them active, one
    hostile tenant at 100% solve faults plus a reclaim STORM (every cloud
    call). Same bars as the 8-stream row — zero fleet-wide dropped cycles,
    healthy placements bit-identical to the no-fault control, healthy p99
    within 1.5x — now with 936 idle registrations that must cost the active
    streams nothing (the O(active) dispatcher contract under fire)."""
    return tenant_isolation(
        tenants=active,
        cycles=cycles,
        registered=registered,
        classes={"gold": 4.0, "silver": 2.0, "bronze": 1.0},
        reclaim_spec="reclaim=2@p1.0",
        label="fleet isolation",
        backend=backend,
        device=device,
    )


def restart_storm(kills: int = 5, cycles: int = 8, backend: str = "oracle", device=None) -> bool:
    """Post-matrix row: SIGKILL the solving process ``kills`` times mid-cycle
    under churn (testing/restart.py subprocess harness) and require full
    recovery — all cycles completed, zero dropped/duplicated pods, placements
    parity with a never-crashed control run, and every journal restore
    classified (no ``unknown`` outcomes)."""
    from karpenter_tpu_torch.testing.restart import run_restart_storm

    summary = run_restart_storm(pod_count=40, cycles=cycles, kills=kills, backend=backend,
                                device=None if device is None else str(device))
    restores = summary.get("restores", [])
    print(
        f"restart storm: {summary.get('kills', 0)} SIGKILLs over "
        f"{summary.get('children', 0)} launches, {summary.get('cycles', 0)} "
        f"cycles, parity={summary.get('parity_ok')}, "
        f"acct={summary.get('acct_ok')}, restores="
        + ",".join(restores)
        + f" -> {'OK' if summary['ok'] else 'FAILED: ' + repr(summary)}"
    )
    return bool(summary["ok"])


DEVICE_LOSS_ENV = {
    "KARPENTER_TPU_EXPLAIN": "0",
    "KARPENTER_TPU_MESH_HEALTH": "1",
    # the partitioned solve on one card: its lanes are blocks of one launch,
    # so one device is enough to take the sharded path
    "KARPENTER_TPU_SHARD": "1",
    "KARPENTER_TPU_SHARD_MIN_DEVICES": "1",
    "KARPENTER_TPU_SHARD_MIN_PODS": "1",
    "KARPENTER_TPU_SHARD_PARTITIONS": "2",
    # the SLO arm: device loss must breach the mesh-recovery objective and
    # ONLY it, with a trace-linked flight dump capturing the fault chain.
    # RECOVERY_S=0 makes any real recovery wall time a "bad" event, so the
    # breach is deterministic; TRACE=1 stamps the records with cycle ids.
    "KARPENTER_TPU_SLO": "1",
    "KARPENTER_TPU_SLO_RECOVERY_S": "0",
    "KARPENTER_TPU_TRACE": "1",
    # park the serve latency ceiling out of the way so the row isolates the
    # mesh-recovery breach
    "KARPENTER_TPU_SLO_SERVE_P99_S": "600",
}


def device_loss_row(pods_n: int = 2000, device=None) -> dict:
    """The device-loss row on one card, in this process. Shard arm: the
    first sharded solve loses device 0 (``device[0].loss@1``) at its
    dispatch; the loss is classified and recarved, the solve stands down to
    the unsharded path (``single-device``) and completes, its placements
    clean under the full validator and its scheduled set the unsharded
    control's; two forced probes (the ``probe`` kernel on the card) bring
    the device back through probation, and the next sharded solve serves.
    Serve arm: ``ReplicaSet(2)`` over ``TorchSolver`` tenants loses the
    card mid-run (classified, recarved), fails replica 1 over and finishes
    every cycle on the survivor. The SLO arm: only ``mesh-recovery``
    breached; the flight arm: a dump whose fault and recarve share a trace.
    Returns the verdict dict (``ok``)."""
    from karpenter_tpu_torch.obs import flight, slo
    from karpenter_tpu_torch.serve import build_tenant_solver
    from karpenter_tpu_torch.serve.replica import PLACE_BIG_TENANT, PLACE_FAILOVER, PLACE_HASH, PLACE_PINNED, \
        ReplicaSet
    from karpenter_tpu_torch.solver import mesh_health as mh
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver, resolve_device
    from karpenter_tpu_torch.solver.validator import validate_result
    from karpenter_tpu_torch.testing import faults

    device = resolve_device(device)
    dev_id = mh.device_id(device)
    ev = {"event": "device_loss", "pods": pods_n, "device": str(device)}
    with _env(**DEVICE_LOSS_ENV, KARPENTER_TPU_FLIGHT_DIR=tempfile.mkdtemp(prefix="chaos-flight-")):
        slo.set_enabled(None)
        flight.set_enabled(None)
        slo.reset()
        flight.reset()
        mh.reset()
        faults.clear()
        try:
            # -- shard arm: the device dies at the sharded dispatch -------------
            pods, its, tpls = build_problem(pods_n, 50)
            with _env(KARPENTER_TPU_SHARD="0"):
                control = TorchSolver(device=device).solve(pods, its, tpls)
            control_set = set(range(len(pods))) - set(control.failures)
            faults.install(faults.FaultInjector.from_spec(f"seed=5;device[{dev_id}].loss@1"))
            solver = TorchSolver(device=device)
            try:
                result = solver.solve(pods, its, tpls)
            except Exception as exc:  # a raised solve IS a dropped cycle
                ev["shard_error"] = f"{type(exc).__name__}: {exc}"
                result = None
            finally:
                faults.install(None)
            last = dict(solver.last_shard or {})
            tr = mh.tracker()
            states = [tr.probe(force=True), tr.probe(force=True)]
            recarves = tr.snapshot()["recarves"]
            classified = bool(recarves) and all(r["reason"] in mh.REASONS for r in recarves)
            violations = (validate_result(result, pods, its, tpls, [], None, [], None, level="full")
                          if result is not None else ["no result"])
            scheduled_set = set(range(len(pods))) - set(result.failures) if result is not None else set()
            # the first green sharded solve on the recovered device closes
            # the recovery clock
            after = TorchSolver(device=device)
            after.solve(pods, its, tpls)
            after_reason = (after.last_shard or {}).get("reason", "never-attempted")
            recovery_s = tr.last_recovery_s
            shard_ok = (
                result is not None
                and last == {"reason": "single-device", "recarves": 1}
                and classified
                and [r["reason"] for r in recarves] == [mh.REASON_DEVICE_LOST, mh.REASON_RECOVERED]
                and states == [{dev_id: mh.STATE_PROBATION}, {dev_id: mh.STATE_HEALTHY}]
                and not violations
                and scheduled_set == control_set
                and recovery_s is not None
                and after_reason is None
            )
            ev.update({
                "shard_ok": shard_ok,
                "shard": last,
                "recarves": [r["reason"] for r in recarves],
                "probes": [{str(k): v for k, v in s.items()} for s in states],
                "violations": len(violations) if result is not None else -1,
                "scheduled": f"{len(scheduled_set)}/{len(pods)}",
                "parity": scheduled_set == control_set,
                "mesh_recovery_s": round(recovery_s, 4) if recovery_s else None,
                "recovered_shard_reason": after_reason,
            })

            # -- serve arm: the card dies mid-run; replica 1 fails over -----------
            n_recarves = len(recarves)
            _, its_s, tpls_s = build_problem(20, 20)
            spods, _, _ = build_problem(12, 20)
            with _env(KARPENTER_TPU_SHARD="0"):
                rs = ReplicaSet(n_replicas=2, batching=False, max_tenants=16, device=device)
                tenants = [f"t{i}" for i in range(6)]
                for tid in tenants:
                    rs.register_tenant(tid, solver=build_tenant_solver(
                        tid, primary=TorchSolver(device=device), fallback=OracleSolver()))
                rs.start()
                outcomes = []
                try:
                    for cycle in range(6):
                        if cycle == 3:
                            # the dispatcher-shaped recovery (classify ->
                            # report -> recarve) then whole-replica failover
                            exc = faults.FaultDeviceLost(f"injected loss of device {dev_id}", device=dev_id)
                            ev["serve_recarved"] = mh.handle_dispatch_failure(exc) is not None
                            ev["migrated"] = len(rs.failover(1))
                        tickets = [(tid, rs.submit(tid, spods, its_s, tpls_s)) for tid in tenants]
                        outcomes.extend(t.wait(timeout=60.0) for _, t in tickets)
                finally:
                    rs.close()
                tr.probe(force=True)
                tr.probe(force=True)
            placed = rs.placements()
            known = {PLACE_PINNED, PLACE_BIG_TENANT, PLACE_HASH, PLACE_FAILOVER}
            serve_recarves = tr.snapshot()["recarves"][n_recarves:]
            serve_ok = (
                all(o.status == "ok" for o in outcomes)
                and ev.get("serve_recarved", False)
                and ev.get("migrated", 0) >= 1
                and all(reason in known for _, reason in placed.values())
                and all(idx == 0 for idx, _ in placed.values())  # survivor only
                and bool(serve_recarves)
                and all(r["reason"] in mh.REASONS for r in serve_recarves)
            )
            # -- SLO arm and flight arm ------------------------------------------
            breached = slo.engine().breached()
            slo_ok = breached == ["mesh-recovery"]
            dump_kinds: list = []
            dump_linked = False
            dumps = flight.scan_dumps()
            if dumps:
                try:
                    body = flight.load_dump(dumps[-1])
                except Exception as exc:
                    ev["flight_error"] = f"{type(exc).__name__}: {exc}"
                else:
                    dump_kinds = sorted({e.get("kind") for e in body["events"]})
                    # trace linkage: the fault and its recarve rode one cycle
                    by_trace: dict = {}
                    for e in body["events"]:
                        if e.get("trace_id"):
                            by_trace.setdefault(e["trace_id"], set()).add(e.get("kind"))
                    dump_linked = any({"mesh-fault", "mesh-recarve"} <= kinds for kinds in by_trace.values())
            flight_ok = bool(dumps) and "mesh-fault" in dump_kinds and "mesh-recarve" in dump_kinds and dump_linked
            ev.update({
                "serve_ok": serve_ok,
                "serve_outcomes": len(outcomes),
                "serve_recarves": [r["reason"] for r in serve_recarves],
                "slo_breached": breached,
                "slo_ok": slo_ok,
                "flight_dumps": len(dumps),
                "flight_dump_kinds": dump_kinds,
                "flight_ok": flight_ok,
                "ok": shard_ok and serve_ok and slo_ok and flight_ok,
            })
        finally:
            faults.clear()
            mh.reset()
            slo.set_enabled(None)
            flight.set_enabled(None)
    return ev


def device_loss(quick: bool = False, device=None) -> bool:
    """Post-matrix row: kill the card mid-pass in both consumers (see
    ``device_loss_row``): 2,000 pods with ``quick``, else 10,000."""
    import json

    ev = device_loss_row(2000 if quick else 10000, device=device)
    ok = bool(ev["ok"])
    print(
        f"device loss: shard {ev.get('scheduled')} scheduled "
        f"(parity={ev.get('parity')}, violations={ev.get('violations')}, "
        f"standdown={ev.get('shard')}, recarves={ev.get('recarves')}, "
        f"recovery={ev.get('mesh_recovery_s')}s, then sharded reason={ev.get('recovered_shard_reason')}), "
        f"serve {ev.get('serve_outcomes')} cycles "
        f"({ev.get('migrated', 0)} tenants failed over, recarves={ev.get('serve_recarves')}), "
        f"slo breached={ev.get('slo_breached')} (only-recovery={ev.get('slo_ok')}), flight "
        f"{ev.get('flight_dumps')} dumps kinds={ev.get('flight_dump_kinds')} (linked={ev.get('flight_ok')})"
        f" -> {'OK' if ok else 'FAILED: ' + json.dumps(ev, default=str)}"
    )
    return ok


def soak(budget_s: float, seed: int = 17, backend: str = "oracle", device=None) -> bool:
    """--soak: replay a SEEDED multi-subsystem fault schedule (solver faults,
    cloud reclaims, device loss + probe re-entry) through the supervised
    streaming solver under a wall-clock budget. Every cycle must complete
    and every outcome — cycle, recarve, restore — must be classified."""
    from karpenter_tpu_torch.obs import flight as obs_flight, slo as obs_slo
    from karpenter_tpu_torch.solver import mesh_health as mh
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.streaming import StreamingSolver
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess
    from karpenter_tpu_torch.testing import faults

    pods, its, tpls = build_problem(60, 20)
    nodes = _reclaim_nodes("soak-node", 6)
    spec = f"seed={seed};solve.device@p0.2;solve.nan@p0.1;cloud.reclaim=1@p0.25;device[0].loss@p0.15"
    faults.install(faults.FaultInjector.from_spec(spec))
    mh.reset()
    # flight recorder live for the whole soak: every event the subsystems
    # emit under the fault schedule must land in the CLOSED kind vocabulary
    obs_slo.set_enabled(True)
    obs_flight.set_enabled(True)
    obs_slo.reset()
    obs_flight.reset(capacity=4096)
    solver = SupervisedSolver(
        StreamingSolver(make_backend(backend, device)), fallback=OracleSolver(),
        retries=1, backoff_base_s=0.01,
    )
    process = ChurnProcess(
        pods, nodes=nodes,
        config=ChurnConfig(seed=seed, arrivals_per_cycle=4, deletes_per_cycle=2),
    )
    cycles = 0
    device_hits = 0
    dropped = []
    deadline = time.monotonic() + max(1.0, budget_s)
    try:
        with _env(KARPENTER_TPU_FLIGHT_DIR=tempfile.mkdtemp(prefix="chaos-flight-")):
            while time.monotonic() < deadline:
                process.step()
                # the mesh-consumer visit this soak models: one device-site
                # draw per cycle, recovered through the same classify ->
                # recarve -> probe path the shard/serve/world consumers run
                try:
                    mh.dispatch_check(None)
                except faults.FaultDeviceLost as exc:
                    device_hits += 1
                    if mh.handle_dispatch_failure(exc) is None:
                        dropped.append(("device", repr(exc)))
                    mh.tracker().probe(force=True)
                try:
                    result = solver.solve(list(process.pods), its, tpls, nodes=list(process.nodes))
                    if result is None:
                        dropped.append(("cycle", cycles))
                except Exception as exc:  # a raised solve IS a dropped cycle
                    dropped.append(("cycle", f"{type(exc).__name__}: {exc}"))
                cycles += 1
    finally:
        faults.install(None)
        flight_events = obs_flight.ring().snapshot()
        obs_slo.set_enabled(None)
        obs_flight.set_enabled(None)
    recarves = mh.tracker().snapshot()["recarves"] if mh.has_tracker() else []
    mh.reset()
    unclassified = [r for r in recarves if r["reason"] not in mh.REASONS]
    unclassified_flight = sorted({
        str(e.get("kind")) for e in flight_events
        if e.get("kind") not in obs_flight.KINDS
    })
    ok = (
        not dropped and not unclassified and cycles > 0
        and solver.counters["solve_fallbacks"] + solver.counters["solve_retries"] > 0
        and bool(flight_events) and not unclassified_flight
    )
    by_reason: dict = {}
    for r in recarves:
        by_reason[r["reason"]] = by_reason.get(r["reason"], 0) + 1
    print(
        f"soak: {cycles} cycles in {budget_s:.0f}s budget ({backend}), "
        f"{device_hits} device faults, "
        f"{len(recarves)} recarves ({by_reason}), "
        f"retries={solver.counters['solve_retries']}, "
        f"fallbacks={solver.counters['solve_fallbacks']}, "
        f"dropped={len(dropped)}, "
        f"flight={len(flight_events)} events "
        f"({'all classified' if not unclassified_flight else unclassified_flight})"
        f" -> {'OK' if ok else 'FAILED: ' + repr(dropped or unclassified or unclassified_flight or 'no faults fired')}"
    )
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pods", default="60,300", help="comma-separated corpus sizes (default 60,300)")
    ap.add_argument("--backends", default="oracle,torch", help="comma-separated primary backends (oracle,torch)")
    ap.add_argument("--instance-types", type=int, default=50)
    ap.add_argument("--deadline", type=float, default=0.25, help="watchdog deadline in seconds (catches 'hang')")
    ap.add_argument("--quick", action="store_true", help="the 60-pod corpus and the 200/16 fleet row")
    ap.add_argument("--soak", type=float, default=0.0, metavar="SECONDS",
                    help="also replay a seeded multi-subsystem fault schedule for this wall-clock budget")
    ap.add_argument("--device", default="cuda", help="the torch backend's device (default cuda; cpu on a host)")
    args = ap.parse_args(argv)

    from karpenter_tpu_torch.solver.torch_backend import resolve_device

    device = resolve_device(args.device)
    pod_counts = [60] if args.quick else [int(p) for p in args.pods.split(",")]
    backends = args.backends.split(",")
    # the rows after the matrix run their tenants on the port's kernels when
    # it is one of the backends and runs on the card; on the CPU its plain
    # path is the parity arm, too slow for the rows' serve-latency
    # objectives, and the rows keep the JAX tool's oracle tenants
    row_backend = "torch" if "torch" in backends and device.type == "cuda" else "oracle"
    rows = run_matrix(pod_counts, backends, args.instance_types, args.deadline, device=device)
    failed = print_matrix(rows)
    churn_ok = churn_survival()
    tenant_ok = tenant_isolation(backend=row_backend, device=device)
    fleet_ok = fleet_isolation(
        registered=200 if args.quick else 1000,
        active=16 if args.quick else 64,
        backend=row_backend, device=device,
    )
    storm_ok = restart_storm(backend=row_backend, device=device)
    device_ok = device_loss(quick=args.quick, device=device)
    soak_ok = soak(args.soak, backend=row_backend, device=device) if args.soak > 0 else True
    return 1 if (
        failed or not churn_ok or not tenant_ok or not fleet_ok
        or not storm_ok or not device_ok or not soak_ok
    ) else 0


if __name__ == "__main__":
    sys.exit(main())
