"""Operator — assembles and runs the whole framework.

Port of the JAX package's ``operator/operator.py`` (reference
pkg/operator/operator.go plus pkg/controllers/controllers.go:47-82, the
controller registry, and the Singleton loop, operator/controller/
singleton.go:53-182). Every controller exposes a poll-style reconcile and
the Operator drives them either cooperatively (``step()``: deterministic,
what tests and simulations use) or on real threads (``start()``). The
watch-driven paths (informers, the provisioning trigger) stay event-driven
through the kube store's synchronous watch fan-out either way.

Where the port differs:
  * the solve: ``Options.solver_backend == "torch"`` (the default) builds
    ``SupervisedSolver(TorchSolver(device=options.solver_device),
    fallback=OracleSolver())``, which raises without CUDA unless the caller
    asks for ``solver_device="cpu"``; ``"oracle"`` builds the host oracle
    alone. The JAX package's solver reads ``KARPENTER_TPU_RELAX`` (on when
    it is ``"1"``, the default) and ``KARPENTER_TPU_DEVICE_WORLD`` (on when
    it is neither empty nor ``"0"``) at each solve; the Operator reads both
    here, with the same rules, and hands them to ``TorchSolver``;
  * the prewarm and the restart recovery (solver/warmup.py): with the
    torch backend, ``start()`` first starts the restart recovery (the
    kernel-library snapshots of solver/aot.py, when on), then, with
    ``prewarm_solver`` and the solver on CUDA, the warm thread: after the
    recovery it builds and loads every library not restored, then warms the
    buckets. /readyz answers 503 until both end; a kernel build error (the
    warm's or the recovery probe's) keeps it at 503 for good and shows in
    /statusz, and so does a device fault in a warm (``solver-prewarm``);
  * readiness after a device fault: the port's supervisor raises an error
    of the kernels or the CUDA runtime (``supervisor.device_fault``) instead
    of failing it over, so a controller pass that raises one records it in
    ``self.status`` (/readyz 503, /statusz names it). ``step()`` records it
    and re-raises; the threaded loop records it, logs it and goes on, as it
    does every controller error. Only a clean pass of that controller that
    did device work (a primary solve that passed its gate, or a kernel
    launch) clears it: a pass with nothing to solve proves nothing. A provisioning pass that raises one sets the
    batcher's trigger again, so its pods get another pass.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from karpenter_tpu_torch.cloudprovider.metrics import MetricsCloudProvider
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.controllers.metrics_exporters import MetricsExporter
from karpenter_tpu_torch.controllers.nodeclaim_consistency import (
    ConsistencyController,
    POLL_PERIOD_SECONDS as CONSISTENCY_PERIOD,
)
from karpenter_tpu_torch.controllers.nodeclaim_disruption import DisruptionMarkerController
from karpenter_tpu_torch.controllers.nodeclaim_garbagecollection import (
    GarbageCollectionController,
    POLL_PERIOD_SECONDS as GC_PERIOD,
)
from karpenter_tpu_torch.controllers.nodeclaim_lifecycle import LifecycleController
from karpenter_tpu_torch.controllers.nodeclaim_termination import TerminationController
from karpenter_tpu_torch.controllers.node_termination import NodeTerminationController
from karpenter_tpu_torch.controllers.nodepool_controllers import (
    LeaseGarbageCollectionController,
    NodePoolCounterController,
    NodePoolHashController,
)
from karpenter_tpu_torch.disruption.controller import (
    Controller as DisruptionController,
    POLL_PERIOD_SECONDS as DISRUPTION_PERIOD,
)
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.provisioning.batcher import Batcher
from karpenter_tpu_torch.provisioning.controller import ProvisioningLoop, provision, watch_pods
from karpenter_tpu_torch.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.operator.serving import OperatorStatus
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver, device_fault
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.informer import start_informers
from karpenter_tpu_torch.utils.clock import Clock



def relax_enabled() -> bool:
    """The JAX package's KARPENTER_TPU_RELAX rule: on exactly when "1" (the
    default)."""
    return os.environ.get("KARPENTER_TPU_RELAX", "1") == "1"


def device_world_enabled() -> bool:
    """The JAX package's KARPENTER_TPU_DEVICE_WORLD rule: on when neither
    empty nor "0" (off by default)."""
    return os.environ.get("KARPENTER_TPU_DEVICE_WORLD", "0") not in ("", "0")


def _kernels_on_card(supervisor) -> bool:
    device = getattr(supervisor.primary, "device", None)
    return device is not None and device.type == "cuda"


@dataclass
class _Registered:
    name: str
    reconcile: Callable[[], object]
    period_s: float
    next_run: float = 0.0


class Operator:
    def __init__(
        self,
        cloud_provider: CloudProvider,
        options: Optional[Options] = None,
        kube: Optional[KubeClient] = None,
        clock: Optional[Clock] = None,
        recorder: Optional[Recorder] = None,
    ):
        self.options = options or Options()
        self.clock = clock or Clock()
        self.kube = kube or KubeClient(clock=self.clock)
        self.recorder = recorder or Recorder(clock=self.clock)
        # method-duration decorator around the provider (cloudprovider/metrics)
        self.cloud_provider = MetricsCloudProvider(cloud_provider)
        self.cluster = Cluster(self.kube, self.clock)
        # every controller solve (provisioning AND the disruption
        # simulations, which call provisioner.solver directly) goes through
        # the supervisor: deadline, retries, invariant gate, circuit-broken
        # oracle fallback (solver/supervisor.py)
        if self.options.solver_backend == "torch":
            from karpenter_tpu_torch.solver.torch_backend import TorchSolver

            self.supervisor = SupervisedSolver(
                TorchSolver(device=self.options.solver_device, relax=relax_enabled(),
                            device_world=device_world_enabled()),
                fallback=OracleSolver(),
            )
        else:
            self.supervisor = SupervisedSolver(OracleSolver(), fallback=None)
        # what /readyz and /statusz read; the build thread's readiness is
        # wired in by start()
        self.status = OperatorStatus(supervisor=self.supervisor)
        self.provisioner = Provisioner(
            self.kube, self.cloud_provider, self.cluster, self.clock,
            self.recorder, solver=self.supervisor,
        )
        self.batcher = Batcher(
            self.clock,
            idle_duration=self.options.batch_idle_duration_s,
            max_duration=self.options.batch_max_duration_s,
        )
        self.disruption = DisruptionController(
            self.kube, self.cluster, self.provisioner, self.cloud_provider,
            self.clock, self.recorder,
            drift_enabled=self.options.drift_enabled(),
        )
        self.lifecycle = LifecycleController(
            self.kube, self.cloud_provider, self.clock, self.recorder
        )
        self.markers = DisruptionMarkerController(
            self.kube, self.cloud_provider, self.clock,
            drift_enabled=self.options.drift_enabled(),
            cluster=self.cluster,
        )
        self.claim_termination = TerminationController(self.kube, self.cloud_provider)
        from karpenter_tpu_torch.controllers.eviction_queue import EvictionQueue

        self.eviction_queue = EvictionQueue(self.kube, self.clock, self.recorder)
        self.node_termination = NodeTerminationController(
            self.kube, self.cloud_provider, self.clock, self.recorder,
            eviction_queue=self.eviction_queue,
        )
        self.gc = GarbageCollectionController(
            self.kube, self.cloud_provider, self.clock, self.recorder
        )
        self.consistency = ConsistencyController(self.kube, self.clock, self.recorder)
        self.nodepool_hash = NodePoolHashController(self.kube)
        self.nodepool_counter = NodePoolCounterController(self.kube)
        self.lease_gc = LeaseGarbageCollectionController(self.kube)
        self.metrics_exporter = MetricsExporter(self.kube)
        self._controllers: List[_Registered] = []
        self._stop = threading.Event()
        self._wired = False

    # -- registry (controllers.go:47-82) --------------------------------------

    def wire(self) -> "Operator":
        """Attach informers/watches and register every polling controller."""
        if self._wired:
            return self
        if not self.options.disable_webhook:
            from karpenter_tpu_torch.webhooks import register_webhooks

            register_webhooks(self.kube)
        start_informers(self.kube, self.cluster)
        watch_pods(self.kube, self.batcher)
        reg = [
            ("provisioner", self._provision_once, 1.0),
            ("disruption", self.disruption.reconcile, DISRUPTION_PERIOD),
            ("nodeclaim.lifecycle", self.lifecycle.reconcile_all, 1.0),
            ("nodeclaim.markers", self.markers.reconcile_all, 10.0),
            ("nodeclaim.termination", self.claim_termination.reconcile_all, 1.0),
            ("node.termination", self.node_termination.reconcile_all, 1.0),
            # sub-second so PDB-429 backoffs (100ms base) retry promptly
            ("node.eviction_queue", self.eviction_queue.reconcile, 0.1),
            ("nodeclaim.garbagecollection", self.gc.reconcile, GC_PERIOD),
            ("nodeclaim.consistency", self.consistency.reconcile, CONSISTENCY_PERIOD),
            ("nodepool.hash", self.nodepool_hash.reconcile_all, 10.0),
            ("nodepool.counter", self.nodepool_counter.reconcile_all, 10.0),
            ("lease.garbagecollection", self.lease_gc.reconcile_all, 120.0),
            ("metrics", self.metrics_exporter.reconcile, 10.0),
        ]
        now = self.clock.now()
        self._controllers = [
            _Registered(name=n, reconcile=r, period_s=p, next_run=now)
            for n, r, p in reg
        ]
        self._wired = True
        return self

    def _provision_once(self):
        # the batcher gates real runs; in cooperative mode we only provision
        # when a trigger is pending so step() never blocks on the window
        if self.batcher._trigger.is_set():
            self.batcher._trigger.clear()
            return provision(self.provisioner, self.batcher)
        return None

    def _device_work(self):
        from karpenter_tpu_torch import kernels

        return self.supervisor.primary_solves, sum(kernels.LAUNCHES.values())

    # -- cooperative mode (deterministic; the test/simulation mode) -----------

    def step(self) -> List[str]:
        """Run every controller whose period elapsed; returns their names."""
        self.wire()
        ran = []
        now = self.clock.now()
        for c in self._controllers:
            if now >= c.next_run:
                self._reconcile(c.name, c.reconcile)
                c.next_run = now + c.period_s
                ran.append(c.name)
        return ran

    def _reconcile(self, name: str, reconcile):
        """One controller pass; a device fault is recorded in ``status``
        and re-raised. It is cleared by the controller's next clean pass
        that did device work."""
        before = self._device_work()
        try:
            out = reconcile()
        except Exception as exc:
            if device_fault(exc):
                self.status.record_device_fault(name, exc)
            raise
        after = self._device_work()
        if after[0] > before[0] or after[1] > before[1]:
            self.status.clear_device_fault(name)
        return out

    def run_until_settled(self, max_steps: int = 50) -> int:
        """Step until a full pass changes nothing in the store (test helper)."""
        self.wire()
        steps = 0
        for _ in range(max_steps):
            before = self.kube._rv
            for c in self._controllers:
                self._reconcile(c.name, c.reconcile)
            steps += 1
            if self.kube._rv == before:
                break
        return steps

    # -- threaded mode (operator.go:223) --------------------------------------

    def start(self) -> None:
        from karpenter_tpu_torch.operator import logging as oplog
        from karpenter_tpu_torch.operator import serving

        self.wire()
        self._stop.clear()
        logger = oplog.configure(self.options.log_level)
        warm_thread = recovery_thread = None
        if self.options.solver_backend == "torch":
            from karpenter_tpu_torch.solver.warmup import (
                maybe_prewarm_in_background,
                maybe_recover_in_background,
            )

            # restart recovery first (solver/aot.py): marks /readyz blocked
            # synchronously, then restores the kernel libraries and
            # probe-solves on a daemon thread
            recovery_thread = maybe_recover_in_background(on_fault=self._warm_fault)
            if _kernels_on_card(self.supervisor):
                warm_thread = maybe_prewarm_in_background(
                    self.options, self.cloud_provider, on_fault=self._warm_fault,
                    after=recovery_thread, build=True,
                )
        self._warm_thread = warm_thread
        self._recovery_thread = recovery_thread
        self.status.warmup_ready = lambda: warm_thread is None or not warm_thread.is_alive()
        self._servers = [serving.serve(self.options.metrics_port, status=self.status)]
        if self.options.health_probe_port != self.options.metrics_port:
            self._servers.append(
                serving.serve(self.options.health_probe_port, status=self.status)
            )
        if self.options.enable_profiling:
            serving.start_profiler()

        def loop(name, reconcile, period):
            while not self._stop.is_set():
                try:
                    self._reconcile(name, reconcile)
                except Exception:
                    # a controller error must never kill its loop
                    # (singleton.go requeues on error the same way); a device
                    # fault stays in self.status until a clean pass
                    logger.exception("controller %s reconcile failed", name)
                # Event.wait, not clock.sleep: stop() interrupts promptly
                self._stop.wait(period)

        # threaded mode provisions through the real batch window
        # (ProvisioningLoop blocks in Batcher.wait, singleton.go:81)
        prov_loop = ProvisioningLoop(self.provisioner, self.batcher)
        self._threads = [
            threading.Thread(
                target=loop, args=("provisioner", prov_loop.run_once, 0.0),
                daemon=True, name="karpenter-tpu/provisioner",
            )
        ]
        self._threads += [
            threading.Thread(target=loop, args=(c.name, c.reconcile, c.period_s),
                             daemon=True, name=f"karpenter-tpu/{c.name}")
            for c in self._controllers
            if c.name != "provisioner"
        ]
        for t in self._threads:
            t.start()

    def _warm_fault(self, exc: BaseException) -> None:
        """A fault of the startup build, the warm or the recovery probe: a
        device fault of a warm is recorded as one of ``solver-prewarm``,
        anything else as the build error. Either keeps /readyz at 503."""
        from karpenter_tpu_torch.kernels import KernelCompileError

        if device_fault(exc) and not isinstance(exc, KernelCompileError):
            self.status.record_device_fault("solver-prewarm", exc)
        else:
            self.status.record_build_error(exc)

    def stop(self) -> None:
        self._stop.set()
        for server in getattr(self, "_servers", []):
            server.shutdown()
            server.server_close()
        if self.options.enable_profiling:
            from karpenter_tpu_torch.operator import serving

            serving.stop_profiler()
