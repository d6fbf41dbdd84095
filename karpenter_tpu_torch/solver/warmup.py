"""Solver pre-warm and restart recovery.

Counterpart of the JAX package's ``solver/warmup.py``. The same functions,
with the same synthetic pods, seeds and return values, run through the real
``TorchSolver``. Where the JAX function builds its own ``JaxSolver`` (or
screens with ``mesh="auto"``), the port's takes ``solver=`` / ``device=``
(default: CUDA), so that a caller can warm on the CPU.

What a warm buys here. The port compiles nothing per shape: one library
serves every shape of its kernels. A warm buys the libraries' build or
restore (kernels.py, solver/aot.py), the lazy load of the solve's modules,
the kernels' shared-memory opt-ins, and the caching allocator's growth at
each pod and claim bucket, so that the first real batch pays none of them.

Two points differ from the JAX package:

  * when to warm: the JAX package warms when its persistent compile cache is
    on and an accelerator is attached; the port warms when the torch backend
    runs on CUDA (operator/operator._kernels_on_card), on the solver's
    device. The ``_build/`` cache is always on
    (``persistent_cache_enabled``). The warm thread first waits for a
    restart recovery to end, then builds and loads every library that is not
    loaded (kernels.load_all: the operator's startup build, so that every
    library gets its snapshot entry), then warms;
  * no hidden faults: the JAX package swallows every warm failure. Here a
    ``KernelCompileError``, or an error for which
    ``solver/supervisor.device_fault`` holds, is not swallowed: the warm
    functions raise it, and the operator's warm and recovery threads record
    it in ``Operator.status`` (a build error, or a device fault of
    ``solver-prewarm``), so /readyz answers 503. Any other exception keeps
    the JAX package's swallow-and-log.

The trace cycles are the JAX package's: ``warmup`` (kinds ``solver``,
``claim-ladder``, ``device-world``, ``screen``, ``shard``) and ``recovery``
(kind ``restart``).
"""

from __future__ import annotations

import contextvars
from typing import Callable, Optional, Sequence


def _unswallowed(exc: BaseException) -> bool:
    """The warm failures that must reach the operator's status."""
    from karpenter_tpu_torch.kernels import KernelCompileError
    from karpenter_tpu_torch.solver.supervisor import device_fault

    return isinstance(exc, KernelCompileError) or device_fault(exc)


# the device the operator's warm thread warms on (its solver's), read where
# a warm function is given no device: the warm calls keep the JAX package's
# signatures
_WARM_DEVICE: contextvars.ContextVar = contextvars.ContextVar("warm_device", default=None)


def _device(device):
    return device if device is not None else _WARM_DEVICE.get()


def _default_solver(device=None, device_world: Optional[bool] = None):
    """A TorchSolver with the operator's flag rules (operator/operator.py:
    KARPENTER_TPU_RELAX, KARPENTER_TPU_DEVICE_WORLD)."""
    from karpenter_tpu_torch.operator.operator import device_world_enabled, relax_enabled
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    return TorchSolver(device=_device(device), relax=relax_enabled(),
                       device_world=device_world_enabled() if device_world is None else device_world)


def _pod(name, rng, labels=None):
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec

    return Pod(
        metadata=ObjectMeta(name=name, labels=labels or {}),
        spec=PodSpec(containers=[Container(requests={"cpu": rng.choice([0.1, 0.5, 1.0])})]),
    )


def _catalog_template(name, catalog, instance_types_n):
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver.encode import template_from_nodepool

    its = catalog if catalog else instance_types(instance_types_n)
    return its, template_from_nodepool(NodePool(metadata=ObjectMeta(name=name)), its, range(len(its)))


def bucket_ladder(max_pods: int) -> list:
    """Every pod-axis bucket (ops/padding.pod_axis_bucket) up to
    ``max_pods``."""
    from karpenter_tpu_torch.ops.padding import pod_axis_bucket

    out, n = [], 9
    while n <= max_pods:
        b = pod_axis_bucket(n)
        out.append(b)
        n = b + 1
    return out


def claim_ladder(max_claims: int) -> list:
    """Every claim-slot bucket (ops/padding.claim_axis_bucket) up to
    ``max_claims``."""
    from karpenter_tpu_torch.ops.padding import claim_axis_bucket

    out, n = [], 1
    while n <= max_claims:
        b = claim_axis_bucket(n)
        out.append(b)
        n = b + 1
    return out


def prewarm_claim_buckets(
    solver=None, max_claims: int = 256, instance_types_n: int = 100, catalog=None, device=None,
) -> int:
    """Warm the claim-slot escalation ladder up to ``max_claims``: each
    bucket C by solving C pods with ``claim_slots`` pinned to C. Returns the
    number of buckets warmed; a swallowed failure stops the ladder."""
    import random

    from karpenter_tpu_torch.obs import trace

    if solver is None:
        solver = _default_solver(device)
    its, tpl = _catalog_template("prewarm-claims", catalog, instance_types_n)
    rng = random.Random(1)
    warmed = 0
    with trace.cycle("warmup", kind="claim-ladder", max_claims=max_claims):
        for c in claim_ladder(max_claims):
            pods = [_pod(f"warm-claims-{c}-{i}", rng) for i in range(c)]
            try:
                solver.claim_slots = c
                _warm_gate(solver.solve(pods, its, [tpl]), pods, its, [tpl])
                warmed += 1
            except Exception as exc:
                if _unswallowed(exc):
                    raise
                return warmed
    return warmed


def prewarm_solver(
    solver=None,
    pod_buckets: Sequence[int] = (9, 33),
    instance_types_n: int = 100,
    max_pods: int = 0,
    catalog=None,
    device=None,
) -> int:
    """Warm the small standard buckets with and without a zonal spread, and
    every pod bucket up to ``max_pods`` (the operator's
    ``prewarm_max_pods``) with it. Returns the number of batches solved.
    ``catalog`` (the operator's live instance types) warms the buckets
    production encodings hit."""
    import random

    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.objects import DO_NOT_SCHEDULE, LabelSelector, TopologySpreadConstraint
    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.ops.padding import pod_axis_bucket

    if solver is None:
        solver = _default_solver(device)
    its, tpl = _catalog_template("prewarm", catalog, instance_types_n)
    rng = random.Random(0)

    def make(n, topo: bool):
        pods = []
        for i in range(n):
            p = _pod(f"warm-{n}-{i}", rng, labels={"warm": "w"})
            if topo and i % 3 == 0:
                p.spec.topology_spread_constraints = [
                    TopologySpreadConstraint(
                        max_skew=1,
                        topology_key=wk.LABEL_TOPOLOGY_ZONE,
                        when_unsatisfiable=DO_NOT_SCHEDULE,
                        label_selector=LabelSelector(match_labels={"warm": "w"}),
                    )
                ]
            pods.append(p)
        return pods

    solved = 0
    buckets = list(pod_buckets)
    warmed_shapes = {pod_axis_bucket(b) for b in buckets}
    ladder = [b for b in bucket_ladder(max_pods) if b not in warmed_shapes]
    runs = [(n, topo) for n in buckets for topo in (False, True)] + [(n, True) for n in ladder]
    with trace.cycle("warmup", kind="solver", max_pods=max_pods):
        for n, topo in runs:
            try:
                pods = make(n, topo)
                _warm_gate(solver.solve(pods, its, [tpl]), pods, its, [tpl])
                solved += 1
            except Exception as exc:
                if _unswallowed(exc):
                    raise
                return solved
    return solved


def _warm_gate(result, pods, its, tpls) -> None:
    """Drive the device gate over a warm solve result at the same buckets.
    Failures are swallowed like every other warm step, kernel and device
    faults excepted."""
    try:
        from karpenter_tpu_torch import verify

        if verify.enabled() and getattr(result, "verify_ctx", None) is not None:
            verify.full_gate(result, pods, its, tpls)
    except Exception as exc:
        if _unswallowed(exc):
            raise


def prewarm_device_world(
    solver=None,
    pod_buckets: Sequence[int] = (9, 33),
    instance_types_n: int = 100,
    catalog=None,
    device=None,
) -> int:
    """Warm the resident cycle (``patch_world`` and the fused ``ffd_loop`` +
    ``gate_counts``) at the standard pod buckets: an adopting cycle, then one
    that swaps a pod so that the patch runs. No-op unless
    KARPENTER_TPU_DEVICE_WORLD is on (or the given solver has no resident
    world). The templates carry a finite limit so the relax-applicable
    standdown cannot skip the cycle. Returns cycles served by the resident
    path."""
    import dataclasses
    import random

    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.operator.operator import device_world_enabled

    if not device_world_enabled():
        return 0
    if solver is None:
        solver = _default_solver(device, device_world=True)
    if getattr(solver, "_device_world", None) is None:
        return 0
    its, tpl = _catalog_template("prewarm-world", catalog, instance_types_n)
    tpl = dataclasses.replace(tpl, remaining_resources={"cpu": 1e12})
    rng = random.Random(2)

    def make(n):
        return [_pod(f"warm-world-{n}-{i}", rng) for i in range(n)]

    served = 0
    with trace.cycle("warmup", kind="device-world"):
        for n in pod_buckets:
            try:
                pods = make(n)
                solver.solve(pods, its, [tpl])
                dw = solver._device_world
                if dw.last_outcome is None or dw.last_outcome.startswith("standdown"):
                    continue
                served += 1
                pods2 = list(pods)
                pods2[0] = make(1)[0]
                solver.solve(pods2, its, [tpl])
                if dw.last_outcome in ("patched", "repatched"):
                    served += 1
                solver.reset_streaming_state()
            except Exception as exc:
                if _unswallowed(exc):
                    raise
                return served
    return served


def prewarm_screen(n_candidates: int, device=None) -> bool:
    """Warm the consolidation screen at the eighth-pow2 candidate buckets up
    to ``n_candidates`` (disruption/batch.bench_candidate_scoring on
    ``device``). The port's screens run on one device, so there is no
    ``mesh="auto"``."""
    from karpenter_tpu_torch.disruption.batch import bench_candidate_scoring
    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.ops.padding import screen_axis_bucket

    try:
        with trace.cycle("warmup", kind="screen", candidates=n_candidates):
            n = 8
            while n <= n_candidates:
                b = screen_axis_bucket(n)
                bench_candidate_scoring(b, device=_device(device))
                n = b + 1
        return True
    except Exception as exc:
        if _unswallowed(exc):
            raise
        return False


def prewarm_shard(n_pods: int = 256, instance_types_n: int = 100, catalog=None, solver=None,
                  device=None) -> bool:
    """Warm the partitioned solve (KARPENTER_TPU_SHARD, shard/solve.py, the
    lanes modes) on a batch of ``n_pods`` splittable pods. False when the
    flag is off or below the minimum device count; True when the partitioned
    path served the batch."""
    import random

    from karpenter_tpu_torch import shard as shard_flags
    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.parallel.mesh import default_mesh

    if not shard_flags.enabled():
        return False
    if solver is None:
        solver = _default_solver(device)
    if default_mesh(shard_flags.min_devices(), solver.device) is None:
        return False
    its, tpl = _catalog_template("prewarm-shard", catalog, instance_types_n)
    rng = random.Random(2)
    pods = [_pod(f"warm-shard-{i}", rng) for i in range(max(n_pods, shard_flags.min_pods()))]
    try:
        with trace.cycle("warmup", kind="shard", pods=len(pods)):
            solver.solve(pods, its, [tpl])
            return bool(solver.last_shard and solver.last_shard.get("reason") is None)
    except Exception as exc:
        if _unswallowed(exc):
            raise
        return False


def _probe_solve(n_pods: int = 12, instance_types_n: int = 20, device=None) -> bool:
    """One small solve through the real backend, checked hard: every pod
    accounted exactly once and the fast validator clean. On the card it
    launches ``relax_place``, ``ffd_loop`` and ``gate_counts`` (the solve)
    and ``probe`` (one sum, checked); the other restored libraries passed the
    frame's checksum, the source digest and the symbol check, as the JAX
    package's restored executables outside its probe solve pass only their
    deserialization."""
    import random

    from karpenter_tpu_torch.solver import validator as val

    its, tpl = _catalog_template("recovery-probe", None, instance_types_n)
    rng = random.Random(3)
    pods = [_pod(f"probe-{i}", rng) for i in range(n_pods)]
    solver = _default_solver(device, device_world=False)
    result = solver.solve(pods, its, [tpl])
    seen: list = []
    for idxs in result.node_pods.values():
        seen.extend(idxs)
    for c in result.new_claims:
        seen.extend(c.pod_indices)
    seen.extend(result.failures)
    if sorted(seen) != list(range(n_pods)):
        return False
    if solver.device.type == "cuda":
        import torch

        from karpenter_tpu_torch.verify.device import PROBE_VALUES, probe_sum

        # the probe kernel's sum of arange(16), exact in float32; a build or
        # launch error propagates (the recovery records it)
        x = torch.arange(PROBE_VALUES, dtype=torch.float32).to(solver.device)
        if float(probe_sum(x).cpu()[0]) != 120.0:
            return False
    return not val.validate_result(result, pods, its, [tpl], level="fast")


def restore_and_probe(on_fault: Optional[Callable[[BaseException], None]] = None, device=None
                      ) -> Optional[dict]:
    """The restart-recovery sequence over solver/aot.py's phase machine
    (idle -> restoring -> probing -> ready|failed):

      1. restore every matching library snapshot (``restored``, classified
         failures);
      2. when anything restored, run the probe solve; on failure, or an
         exception in it, evict every restored library (``probe-failed``):
         later launches build instead of trusting an unproven library;
      3. record the recovery (``solver_restart_recovery_seconds``, and the
         trace id and summary in ``aot.last_recovery()`` for /statusz).

    /readyz is held false by ``aot.recovery_blocking()`` throughout. Returns
    the record, or None when snapshots are off. An exception is logged and
    recorded (phase ``failed``); a kernel build error or device fault is also
    handed to ``on_fault`` (the operator's status)."""
    import logging
    import time

    from karpenter_tpu_torch.solver import aot

    if not aot.enabled():
        return None
    from karpenter_tpu_torch.metrics.registry import RESTART_RECOVERY_SECONDS
    from karpenter_tpu_torch.obs import trace

    log = logging.getLogger(__name__)
    t0 = time.perf_counter()
    record: dict = {}
    aot.set_recovery_phase(aot.PHASE_RESTORING)
    try:
        with trace.cycle("recovery", kind="restart"):
            record["trace_id"] = trace.current_trace_id()
            record["aot"] = aot.restore()
            aot.set_recovery_phase(aot.PHASE_PROBING)
            if record["aot"]["restored"]:
                try:
                    ok = _probe_solve(device=device)
                except Exception:
                    record["probe"] = "error"
                    record["evicted"] = aot.clear_restored()
                    raise
                record["probe"] = "passed" if ok else "failed"
                if not ok:
                    record["evicted"] = aot.clear_restored()
            else:
                record["probe"] = "skipped"
        phase = aot.PHASE_FAILED if record.get("probe") == "failed" else aot.PHASE_READY
    except Exception as exc:  # noqa: BLE001 — recovery degrades, it does not take the process down
        log.warning("restart recovery failed", exc_info=True)
        record["probe"] = record.get("probe", "error")
        record["error"] = f"{type(exc).__name__}: {exc}"
        phase = aot.PHASE_FAILED
        if on_fault is not None and _unswallowed(exc):
            on_fault(exc)
    record["phase"] = phase
    record["seconds"] = round(time.perf_counter() - t0, 4)
    RESTART_RECOVERY_SECONDS.observe(record["seconds"])
    aot.finish_recovery(record, phase)
    log.info("restart recovery: %s", record)
    return record


def maybe_recover_in_background(on_fault: Optional[Callable[[BaseException], None]] = None
                                ) -> Optional["object"]:
    """Operator.start() hook: when snapshots are on, mark recovery blocking
    synchronously (a /readyz racing the thread start sees not-ready) and run
    :func:`restore_and_probe` on a daemon thread."""
    import threading

    from karpenter_tpu_torch.solver import aot

    if not aot.enabled():
        return None
    aot.set_recovery_phase(aot.PHASE_RESTORING)
    t = threading.Thread(target=restore_and_probe, kwargs={"on_fault": on_fault}, daemon=True,
                         name="karpenter-tpu/restart-recovery")
    t.start()
    return t


def warmup_ready(thread: Optional["object"]) -> bool:
    """Readiness predicate for /readyz: True once the background warm
    finished (or never ran)."""
    return thread is None or not thread.is_alive()


def persistent_cache_enabled() -> bool:
    """The port's cross-process cache is the ``_build/`` directory of
    kernels.py, always on."""
    return True


def _on_accelerator() -> bool:
    import torch

    return torch.cuda.is_available()


def maybe_prewarm_in_background(options, cloud_provider=None, on_fault=None, after=None, build=None
                                ) -> Optional["object"]:
    """Operator.start() hook. On a daemon thread: wait for ``after`` (the
    recovery thread); with ``build`` (default: when ``options.solver_device``
    is CUDA) build and load every library that is not loaded
    (kernels.load_all), handing an error to ``on_fault`` and stopping; then,
    on an accelerator, warm on the solver's device: the buckets
    (``prewarm_max_pods``), the claim ladder (``prewarm_claim_slots``, where
    the options have it), the screen (``prewarm_screen_candidates``), the
    partitioned solve and the resident cycle, over ``cloud_provider``'s live
    catalog. A kernel build error or a device fault stops the warm and goes
    to ``on_fault``; any other failure is logged and the next warm runs."""
    import threading

    if not getattr(options, "prewarm_solver", True):
        return None
    if not persistent_cache_enabled():
        return None
    device = getattr(options, "solver_device", "cuda")
    if build is None:
        build = device == "cuda"

    def probe_then_warm():
        import logging

        from karpenter_tpu_torch import kernels

        log = logging.getLogger(__name__)
        if after is not None:
            after.join()
        if build:
            try:
                kernels.load_all()
            except Exception as exc:
                log.exception("prewarm: kernel build failed")
                if on_fault is not None:
                    on_fault(exc)
                return
        if not _on_accelerator():
            return
        try:
            _warm(options, cloud_provider, device, log)
        except Exception as exc:
            log.exception("prewarm: stopped by a kernel or device fault")
            if on_fault is not None:
                on_fault(exc)

    t = threading.Thread(target=probe_then_warm, daemon=True, name="karpenter-tpu/solver-prewarm")
    t.start()
    return t


def _warm(options, cloud_provider, device, log) -> None:
    catalog = None
    if cloud_provider is not None:
        try:
            catalog = cloud_provider.get_instance_types(None)
        except Exception:
            log.warning("prewarm: live catalog unavailable, warming synthetic shape buckets only",
                        exc_info=True)

    def guarded(what, fn, *args, **kwargs):
        try:
            fn(*args, **kwargs)
        except Exception as exc:
            if _unswallowed(exc):
                raise
            log.warning("prewarm: %s warm failed", what, exc_info=True)

    _WARM_DEVICE.set(device)
    guarded("solver", prewarm_solver, max_pods=getattr(options, "prewarm_max_pods", 0), catalog=catalog)
    n_claims = getattr(options, "prewarm_claim_slots", 0)
    if n_claims:
        guarded("claim-ladder", prewarm_claim_buckets, max_claims=n_claims, catalog=catalog)
    n_screen = getattr(options, "prewarm_screen_candidates", 0)
    if n_screen:
        guarded("screen", prewarm_screen, n_screen)
    guarded("shard", prewarm_shard, catalog=catalog)
    guarded("device-world", prewarm_device_world, catalog=catalog)
    from karpenter_tpu_torch.obs import programs

    if programs.enabled():
        s = programs.registry().summary()
        log.info("prewarm: %d programs, %d launches, %.1fs load (by source: %s)",
                 s["programs"], s["launches"], s["compile_s"], s["by_source"])
