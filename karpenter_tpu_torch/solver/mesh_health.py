"""Degraded-mesh resilience: per-device health, recarve, probation
(``KARPENTER_TPU_MESH_HEALTH``), the JAX package's ``solver/mesh_health.py``.

The partitioned solve (shard/) and the device-resident world
(streaming/device_world.py) dispatch onto the devices they see. This module
makes a device failure a CLASSIFIED, recoverable event instead of an
unclassified exception inside a dispatch:

  state machine   healthy -> lost | degraded   (a dispatch failure, reported
                                                by the consumer that caught
                                                the typed exception)
                  lost | degraded -> probation (a re-entry probe passed)
                  probation -> healthy         (``probation_probes()``
                                                CONSECUTIVE clean probes —
                                                one good probe does not
                                                un-flap a flapping chip)
                  probation -> lost | degraded (a probe failed or the device
                                                failed again mid-probation)

  recarve         ``tracker().recarve(reason)`` classifies the event
                  (``solver_mesh_recarve_total{reason}``: device-lost /
                  device-degraded / probe-failed / recovered), re-exports
                  the per-state device census (``solver_mesh_devices``),
                  and returns the healthy device list. Consumers rebuild
                  their device lists from it: ``parallel.mesh.default_mesh``
                  excludes unhealthy devices whenever the flag is on, so the
                  next dispatch never sees the failed device.

  recovery clock  the first failure starts a timer; ``note_green()`` (called
                  by a consumer after its first successful solve on the
                  recarved mesh) observes ``solver_mesh_recovery_seconds``
                  — the measured latency cost of the contract "a device
                  failure costs latency, never a dropped cycle, a wrong
                  placement, or an unclassified outcome".

Fault injection rides the shared grammar (testing/faults.py ``device`` site:
``device[2].loss@3``, ``device[0].degraded=0.05@*``); ``dispatch_check``
is the hook consumers call once per mesh dispatch. Flag off AND no injector
installed, every hook is one module-attribute read and no tracker exists.

Devices are ``torch.device`` objects, identified by index (``device_id``):
the CUDA devices of the process (``local_devices``), or for a CPU solver
its own device (id 0). A re-entry probe runs the ``probe`` kernel on the
device (verify/device.probe_device, program 18). Every call that takes a
device list also takes an explicit one (a list of devices, or a mapping of
id to the device a probe runs on), which is how the tests drive the state
machine over ids that the host does not have.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import torch

from karpenter_tpu_torch.metrics.registry import (
    MESH_DEVICES,
    MESH_RECARVE,
    MESH_RECOVERY_SECONDS,
)
from karpenter_tpu_torch.obs import flight, slo, trace
from karpenter_tpu_torch.testing import faults

log = logging.getLogger(__name__)

# classified recarve reasons — the bounded label-value set for
# solver_mesh_recarve_total and the vocabulary of tests/test_mesh_health.py
REASON_DEVICE_LOST = "device-lost"
REASON_DEVICE_DEGRADED = "device-degraded"
REASON_PROBE_FAILED = "probe-failed"
REASON_RECOVERED = "recovered"
REASONS = (
    REASON_DEVICE_LOST, REASON_DEVICE_DEGRADED, REASON_PROBE_FAILED,
    REASON_RECOVERED,
)

STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"
STATE_LOST = "lost"
STATE_PROBATION = "probation"
STATES = (STATE_HEALTHY, STATE_DEGRADED, STATE_LOST, STATE_PROBATION)


def enabled() -> bool:
    """KARPENTER_TPU_MESH_HEALTH, default OFF: mesh carving consults the
    health tracker only when on. Off = zero overhead and a bit-identical
    dispatch path (tier-1 census pin holds the proof); fault-injection
    hooks still fire when an injector is installed, so chaos runs can
    exercise the typed exceptions without the flag."""
    return os.environ.get("KARPENTER_TPU_MESH_HEALTH", "0") not in ("", "0")


def probe_interval_s() -> float:
    """KARPENTER_TPU_MESH_PROBE_S: minimum seconds between probe passes over
    the excluded devices (default 5). ``probe(force=True)`` ignores it."""
    try:
        return max(0.0, float(os.environ.get("KARPENTER_TPU_MESH_PROBE_S", "5")))
    except ValueError:
        return 5.0


def probation_probes() -> int:
    """KARPENTER_TPU_MESH_PROBATION: consecutive clean probes a failed
    device must pass before it rejoins the mesh (default 2) — re-entry
    probation, so one lucky probe doesn't re-admit a flapping chip."""
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_MESH_PROBATION", "2")))
    except ValueError:
        return 2


def classify_failure(exc: BaseException) -> Optional[str]:
    """The recarve reason for an exception a mesh dispatch raised, or None
    when it is not a device-health event (the caller's ordinary error
    discipline then applies). Typed injected faults classify exactly; real
    runtime errors classify conservatively on the runtime's own device-loss
    markers (the CUDA runtime's lost-device and uncorrectable-ECC errors) — a
    misclassified generic error would recarve a healthy mesh."""
    if isinstance(exc, faults.FaultDeviceDegraded):
        return REASON_DEVICE_DEGRADED
    if isinstance(exc, faults.FaultDeviceLost):
        return REASON_DEVICE_LOST
    text = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, RuntimeError) and any(
        marker in text for marker in ("cudaErrorDevicesUnavailable", "cudaErrorNoDevice", "device lost",
                                      "GPU is lost", "cudaErrorECCUncorrectable")
    ):
        return REASON_DEVICE_LOST
    return None


def failed_device(exc: BaseException) -> int:
    """The device index an exception names (typed faults carry it; real
    runtime errors default to device 0 — the recarve excludes it and the
    probe path sorts out the rest)."""
    return int(getattr(exc, "device", 0))


def local_devices(device=None) -> list:
    """The devices meshes are carved from: every CUDA device of the process,
    or ``[device]`` for a solver on a non-CUDA device; with no CUDA at all,
    the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)]
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_id(d) -> int:
    """The health registry's key of a device: its index (0 for an unindexed
    device such as the CPU); an int is its own id."""
    if isinstance(d, int):
        return d
    return int(d.index or 0)


def _by_id(devices) -> Dict[int, object]:
    if isinstance(devices, Mapping):
        return {int(k): v for k, v in devices.items()}
    return {device_id(d): d for d in devices}


@dataclass
class DeviceHealth:
    state: str = STATE_HEALTHY
    reason: Optional[str] = None
    since: float = 0.0
    clean_probes: int = 0
    failures: int = 0
    history: List[str] = field(default_factory=list)


class MeshHealth:
    """Thread-safe per-device health registry. One per process
    (``tracker()``): the shard path and the device world dispatch onto the
    same local devices, so a loss either observes must shrink the mesh for
    both."""

    def __init__(self, time_fn=time.monotonic):
        self._time = time_fn
        self._lock = threading.Lock()
        self._states: Dict[int, DeviceHealth] = {}
        self._failed_at: Optional[float] = None  # recovery clock start
        self._last_probe_at: Optional[float] = None
        self.last_recovery_s: Optional[float] = None
        self.recarves: List[tuple] = []  # (reason, device) classified log

    # -- state reads -----------------------------------------------------------

    def state_of(self, device_id: int) -> str:
        with self._lock:
            ent = self._states.get(int(device_id))
            return ent.state if ent is not None else STATE_HEALTHY

    def healthy_devices(self, devices=None) -> list:
        """``devices`` (default: all local devices) minus everything not
        currently healthy — the device list meshes are carved from."""
        if devices is None:
            devices = local_devices()
        with self._lock:
            bad = {
                d for d, ent in self._states.items()
                if ent.state != STATE_HEALTHY
            }
        return [d for d in devices if device_id(d) not in bad]

    def unhealthy_ids(self) -> List[int]:
        with self._lock:
            return sorted(
                d for d, ent in self._states.items()
                if ent.state != STATE_HEALTHY
            )

    # -- transitions -----------------------------------------------------------

    def report_failure(self, device_id: int, reason: str) -> None:
        """A consumer caught a classified device failure on ``device_id``.
        Starts the recovery clock if no failure is already pending; a
        failure during probation resets the device's clean-probe streak."""
        now = self._time()
        state = (
            STATE_DEGRADED if reason == REASON_DEVICE_DEGRADED else STATE_LOST
        )
        with self._lock:
            ent = self._states.setdefault(int(device_id), DeviceHealth())
            ent.state = state
            ent.reason = reason
            ent.since = now
            ent.clean_probes = 0
            ent.failures += 1
            ent.history.append(state)
            if self._failed_at is None:
                self._failed_at = now
        flight.record(
            flight.KIND_MESH_FAULT, device=int(device_id), reason=reason,
            state=state,
        )
        log.warning(
            "mesh_health: device %d -> %s (%s, failure #%d)",
            device_id, state, reason, ent.failures,
        )

    def recarve(self, reason: str, device: Optional[int] = None) -> list:
        """Classify one recarve event and return the healthy device list the
        consumer rebuilds its mesh from. Every recarve is counted under a
        bounded reason (REASONS) and re-exports the device census gauge."""
        if reason not in REASONS:  # bounded-label contract, like admission
            raise ValueError(f"unclassified recarve reason {reason!r}")
        MESH_RECARVE.inc({"reason": reason})
        with self._lock:
            self.recarves.append((reason, device))
        healthy = self.healthy_devices()
        self._export()
        flight.record(
            flight.KIND_MESH_RECARVE, reason=reason, device=device,
            healthy=len(healthy),
        )
        if reason != REASON_RECOVERED:
            # a shrinking recarve is an incident: snapshot the ring with the
            # fault + recarve chain in it (growing back is routine)
            flight.snapshot_dump("recarve")
        with trace.span("mesh_recarve", reason=reason, healthy=len(healthy)):
            pass
        log.warning(
            "mesh_health: recarve (%s): %d healthy device(s), excluded=%s",
            reason, len(healthy), self.unhealthy_ids(),
        )
        return healthy

    def note_green(self) -> None:
        """First successful solve on the recarved mesh: close the recovery
        clock into ``solver_mesh_recovery_seconds``. No-op when no failure
        is pending, so consumers may call it after every green solve."""
        with self._lock:
            if self._failed_at is None:
                return
            elapsed = max(0.0, self._time() - self._failed_at)
            self._failed_at = None
            self.last_recovery_s = elapsed
        MESH_RECOVERY_SECONDS.observe(elapsed)
        if slo.enabled():
            slo.on_recovery(elapsed)
            flight.record(
                flight.KIND_MESH_RECOVERED, seconds=round(elapsed, 6),
            )

    # -- probes / probation ----------------------------------------------------

    def probe(self, devices=None, force: bool = False) -> Dict[int, str]:
        """Re-probe every excluded device (rate-limited to one pass per
        ``probe_interval_s()`` unless forced). A clean probe moves the
        device into probation and advances its streak; ``probation_probes``
        consecutive clean probes re-admit it (recarve reason 'recovered').
        A failed probe — real, or an injected ``device[n]`` rule matching
        this visit — zeroes the streak (reason 'probe-failed'). ``devices``:
        the devices a probe may run on (a list, or a mapping of id to
        device; default all local devices). Returns {device_id: state} for
        the devices probed."""
        now = self._time()
        with self._lock:
            if (
                not force
                and self._last_probe_at is not None
                and now - self._last_probe_at < probe_interval_s()
            ):
                return {}
            self._last_probe_at = now
            suspect = sorted(
                d for d, ent in self._states.items()
                if ent.state != STATE_HEALTHY
            )
        if not suspect:
            return {}
        if devices is None:
            devices = local_devices()
        by_id = _by_id(devices)
        out: Dict[int, str] = {}
        for dev_id in suspect:
            ok = self._probe_one(dev_id, by_id.get(dev_id))
            with self._lock:
                ent = self._states[dev_id]
                if ok:
                    ent.clean_probes += 1
                    if ent.clean_probes >= probation_probes():
                        ent.state = STATE_HEALTHY
                        ent.reason = None
                        ent.history.append(STATE_HEALTHY)
                    else:
                        ent.state = STATE_PROBATION
                        ent.reason = ent.reason or REASON_PROBE_FAILED
                        ent.history.append(STATE_PROBATION)
                else:
                    ent.clean_probes = 0
                    ent.state = STATE_LOST
                    ent.reason = REASON_PROBE_FAILED
                    ent.history.append(STATE_LOST)
                out[dev_id] = ent.state
            if ok and out[dev_id] == STATE_HEALTHY:
                self.recarve(REASON_RECOVERED, device=dev_id)
            elif not ok:
                self.recarve(REASON_PROBE_FAILED, device=dev_id)
        self._export()
        return out

    def _probe_one(self, dev_id: int, dev) -> bool:
        """One probe visit: consult the fault injector first (a probe IS a
        device-site visit — replay determinism needs it on the shared
        schedule), then run the ``probe`` kernel when the device object is
        available."""
        injector = faults.active()
        if injector is not None:
            rule = injector.draw("device")
            if rule is not None and faults.device_index(rule) == dev_id:
                return False
        if dev is None:
            return False
        from karpenter_tpu_torch.verify.device import probe_device

        return probe_device(dev)

    # -- export / introspection ------------------------------------------------

    def _export(self) -> None:
        try:
            total = len(local_devices())
        except RuntimeError:  # census export must never raise
            total = 0
        with self._lock:
            counts = {s: 0 for s in STATES}
            for ent in self._states.values():
                if ent.state != STATE_HEALTHY:
                    counts[ent.state] += 1
        excluded = sum(counts.values())
        counts[STATE_HEALTHY] = max(0, total - excluded)
        for state, count in counts.items():
            MESH_DEVICES.set(float(count), {"state": state})

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "devices": {
                    str(d): {
                        "state": ent.state,
                        "reason": ent.reason,
                        "clean_probes": ent.clean_probes,
                        "failures": ent.failures,
                    }
                    for d, ent in sorted(self._states.items())
                },
                "recarves": [
                    {"reason": r, "device": d} for r, d in self.recarves
                ],
                "recovery_pending": self._failed_at is not None,
                "last_recovery_s": self.last_recovery_s,
            }

    def reset(self) -> None:
        with self._lock:
            self._states.clear()
            self.recarves.clear()
            self._failed_at = None
            self._last_probe_at = None
            self.last_recovery_s = None


# -- process-wide tracker ------------------------------------------------------

_tracker: Optional[MeshHealth] = None
_tracker_lock = threading.Lock()


def tracker() -> MeshHealth:
    """The process-wide health registry (created on first use)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = MeshHealth()
        return _tracker


def has_tracker() -> bool:
    return _tracker is not None


def note_green() -> None:
    """Module-level shortcut consumers call after every successful mesh
    solve: closes a pending recovery clock, costs one attribute read when no
    tracker was ever created (the flag-off steady state)."""
    if _tracker is not None:
        _tracker.note_green()


def reset() -> None:
    """Drop the tracker (tests)."""
    global _tracker
    with _tracker_lock:
        _tracker = None


# -- the dispatch hook ---------------------------------------------------------


def dispatch_check(devices=None) -> None:
    """Fault-injection hook at mesh dispatch sites (shard/solve.py, the
    device-world cycle). One ``device``-site draw per dispatch; a matching
    rule whose target device participates in this dispatch is realized
    (FaultDeviceLost / FaultDeviceDegraded — the degraded kind sleeps
    first). Disabled-path cost is one module-attribute read; ``devices=None``
    means every local device participates."""
    injector = faults.active()
    if injector is None:
        return
    rule = injector.draw("device")
    if rule is None:
        return
    target = faults.device_index(rule)
    if devices is not None:
        ids = {device_id(d) for d in devices}
        if target not in ids:
            return
    faults.realize_device_fault(rule)


def handle_dispatch_failure(exc: BaseException) -> Optional[list]:
    """Shared consumer recovery step: classify ``exc``; when it is a device
    failure, mark the device, recarve, and return the healthy device list
    to rebuild a mesh from. Returns None when the exception is not a
    device-health event (the caller re-raises into its ordinary error
    discipline)."""
    reason = classify_failure(exc)
    if reason is None:
        return None
    tr = tracker()
    tr.report_failure(failed_device(exc), reason)
    return tr.recarve(reason, device=failed_device(exc))
