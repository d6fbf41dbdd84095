"""Mesh health (KARPENTER_TPU_MESH_HEALTH) and its probe (program 18):
karpenter_tpu_torch's solver/mesh_health.py on the CPU.

The state-machine cases are tests/test_mesh_health.py's, run over explicit
device lists (a probe runs on the device its id maps to; here the CPU), so
ids that this host does not have can be driven. Then the consumers on one
device: a sharded solve whose first dispatch loses device 0 recarves to no
healthy device and stands down ``single-device`` with the unsharded path
serving the same scheduled set, the probe brings the device back through
probation, and the next sharded solve serves; DeviceWorld's ``shard`` and
``device-lost`` standdowns, the first against the JAX package's resident
path on the same input; ``probe_device`` on the plain sum.
"""

import os
import random
import time

import pytest
import torch

from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.metrics.registry import MESH_DEVICES, MESH_RECARVE, MESH_RECOVERY_SECONDS
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.solver import mesh_health as mh
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import faults
from karpenter_tpu_torch.testing import workloads as port_workloads
from karpenter_tpu_torch.verify import device as gdev
from tests.test_torch_encode import reference_workloads
import tests.torch_threads  # noqa: F401  (one intra-op thread)

CPU = torch.device("cpu")
# eight device ids, each probed on the CPU
PROBE_MAP = {i: CPU for i in range(8)}
DEVICES = [torch.device("cuda", i) for i in range(8)]
SHARD_ENV = {"KARPENTER_TPU_SHARD": "1", "KARPENTER_TPU_SHARD_MIN_PODS": "2",
             "KARPENTER_TPU_SHARD_MIN_DEVICES": "1", "KARPENTER_TPU_SHARD_PARTITIONS": "8"}


@pytest.fixture(autouse=True)
def _clean_tracker():
    """The process-wide tracker and injector must not leak exclusions into
    the suites that share this process."""
    faults.install(None)
    mh.reset()
    yield
    faults.install(None)
    mh.reset()


def _inject(spec: str):
    faults.install(faults.FaultInjector.from_spec(spec))


def _ids(devices) -> list:
    return [mh.device_id(d) for d in devices]


# -- one test per recarve reason -----------------------------------------------


def test_recarve_reason_device_lost():
    _inject("seed=3;device[1].loss@1")
    before = MESH_RECARVE.value({"reason": mh.REASON_DEVICE_LOST})
    with pytest.raises(faults.FaultDeviceLost) as ei:
        mh.dispatch_check(DEVICES)
    healthy = mh.handle_dispatch_failure(ei.value)
    assert healthy is not None and 1 not in _ids(healthy)
    assert _ids(mh.tracker().healthy_devices(DEVICES)) == [0, 2, 3, 4, 5, 6, 7]
    assert mh.tracker().state_of(1) == mh.STATE_LOST
    assert MESH_RECARVE.value({"reason": mh.REASON_DEVICE_LOST}) == before + 1
    assert mh.tracker().snapshot()["recarves"][-1] == {"reason": mh.REASON_DEVICE_LOST, "device": 1}
    # the census gauge re-exported: exactly one device out of the local ones
    assert MESH_DEVICES.value({"state": mh.STATE_LOST}) == 1.0
    assert MESH_DEVICES.value({"state": mh.STATE_HEALTHY}) == float(max(0, len(mh.local_devices()) - 1))


def test_dispatch_check_ignores_devices_outside_the_dispatch():
    _inject("seed=3;device[5].loss@1")
    mh.dispatch_check(DEVICES[:2])  # device 5 does not take part: no fault
    assert not mh.has_tracker() or mh.tracker().state_of(5) == mh.STATE_HEALTHY


def test_recarve_reason_device_degraded_inflates_wall_time():
    _inject("seed=3;device[2].degraded=0.05@1")
    before = MESH_RECARVE.value({"reason": mh.REASON_DEVICE_DEGRADED})
    t0 = time.perf_counter()
    with pytest.raises(faults.FaultDeviceDegraded) as ei:
        mh.dispatch_check(DEVICES)
    assert time.perf_counter() - t0 >= 0.05  # the degraded kind sleeps first
    mh.handle_dispatch_failure(ei.value)
    assert 2 not in _ids(mh.tracker().healthy_devices(DEVICES))
    assert mh.tracker().state_of(2) == mh.STATE_DEGRADED
    assert MESH_RECARVE.value({"reason": mh.REASON_DEVICE_DEGRADED}) == before + 1


def test_recarve_reason_probe_failed():
    tr = mh.tracker()
    tr.report_failure(1, mh.REASON_DEVICE_LOST)
    before = MESH_RECARVE.value({"reason": mh.REASON_PROBE_FAILED})
    _inject("seed=3;device[1].loss@*")  # every probe visit fails
    assert tr.probe(PROBE_MAP, force=True) == {1: mh.STATE_LOST}
    assert MESH_RECARVE.value({"reason": mh.REASON_PROBE_FAILED}) == before + 1
    assert tr.state_of(1) == mh.STATE_LOST
    assert tr._states[1].clean_probes == 0  # a failed probe zeroes the streak


def test_probe_of_an_absent_device_fails():
    tr = mh.tracker()
    tr.report_failure(6, mh.REASON_DEVICE_LOST)
    assert tr.probe({0: CPU}, force=True) == {6: mh.STATE_LOST}


def test_recarve_reason_recovered_after_probation():
    tr = mh.tracker()
    tr.report_failure(3, mh.REASON_DEVICE_LOST)
    before = MESH_RECARVE.value({"reason": mh.REASON_RECOVERED})
    # first clean probe: probation, still EXCLUDED from carving
    assert tr.probe(PROBE_MAP, force=True) == {3: mh.STATE_PROBATION}
    assert 3 not in _ids(tr.healthy_devices(DEVICES))
    assert MESH_RECARVE.value({"reason": mh.REASON_RECOVERED}) == before
    # second consecutive clean probe (default KARPENTER_TPU_MESH_PROBATION=2)
    assert tr.probe(PROBE_MAP, force=True) == {3: mh.STATE_HEALTHY}
    assert 3 in _ids(tr.healthy_devices(DEVICES))
    assert MESH_RECARVE.value({"reason": mh.REASON_RECOVERED}) == before + 1


def test_probation_re_entry_failure_resets_streak(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_MESH_PROBATION", "3")
    tr = mh.tracker()
    tr.report_failure(4, mh.REASON_DEVICE_LOST)
    assert tr.probe(PROBE_MAP, force=True) == {4: mh.STATE_PROBATION}
    assert tr.probe(PROBE_MAP, force=True) == {4: mh.STATE_PROBATION}
    # a failure mid-probation throws the device back out and zeroes the streak
    tr.report_failure(4, mh.REASON_DEVICE_LOST)
    assert tr.state_of(4) == mh.STATE_LOST
    assert tr._states[4].clean_probes == 0
    assert tr.probe(PROBE_MAP, force=True) == {4: mh.STATE_PROBATION}
    assert tr.probe(PROBE_MAP, force=True) == {4: mh.STATE_PROBATION}
    assert tr.probe(PROBE_MAP, force=True) == {4: mh.STATE_HEALTHY}


def test_probe_rate_limit(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_MESH_PROBE_S", "3600")
    tr = mh.tracker()
    tr.report_failure(2, mh.REASON_DEVICE_LOST)
    assert tr.probe(PROBE_MAP) == {2: mh.STATE_PROBATION}
    assert tr.probe(PROBE_MAP) == {}  # within the interval: no pass
    assert tr.probe(PROBE_MAP, force=True) == {2: mh.STATE_HEALTHY}


def test_unclassified_recarve_reason_raises():
    with pytest.raises(ValueError, match="unclassified"):
        mh.tracker().recarve("cosmic-rays")


def test_unrelated_error_is_not_a_device_event():
    assert mh.classify_failure(ValueError("bad input")) is None
    assert mh.handle_dispatch_failure(RuntimeError("shape mismatch")) is None
    assert not mh.has_tracker()


def test_recovery_clock_closes_on_first_green():
    tr = mh.tracker()
    before = MESH_RECOVERY_SECONDS.count()
    tr.report_failure(1, mh.REASON_DEVICE_LOST)
    assert tr.snapshot()["recovery_pending"]
    mh.note_green()
    assert MESH_RECOVERY_SECONDS.count() == before + 1
    assert tr.last_recovery_s is not None and tr.last_recovery_s >= 0
    mh.note_green()  # no failure pending: no-op, consumers call it every solve
    assert MESH_RECOVERY_SECONDS.count() == before + 1


# -- the probe (program 18) on the plain sum -----------------------------------


def test_probe_device_plain():
    assert gdev.probe_device(CPU)
    assert float(gdev.probe_sum(torch.arange(16, dtype=torch.float32))[0]) == 120.0
    # a wrong sum fails the probe; so does an exception
    assert not gdev.probe_device(CPU, torch.arange(16, dtype=torch.float32) + 1)
    assert not gdev.probe_device(CPU, torch.zeros(0))
    # index order: (1e8 + 1) - 1e8 in float32 is 0, not 1
    x = torch.tensor([1e8, 1.0, -1e8], dtype=torch.float32)
    assert float(gdev.probe_sum_plain(x)[0]) == 0.0


# -- consumers on one device ---------------------------------------------------


def _solve(workload, env=None, **kwargs):
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        solver = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", **kwargs)
        return solver, solver.solve(*workload)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _scheduled(result):
    return sorted(i for c in result.new_claims for i in c.pod_indices)


def test_shard_redispatch_after_device_loss_then_recovery(monkeypatch):
    """device[0].loss@1 on the first sharded dispatch: the tracker recarves,
    no healthy device is left, and the solve stands down single-device with
    recarves=1 while the unsharded path serves the control's scheduled set;
    two forced probes (the probe on the CPU) recover the device and the next
    sharded solve serves, closing the recovery clock."""
    monkeypatch.setenv("KARPENTER_TPU_MESH_HEALTH", "1")
    workload = port_workloads.shard_plain_workload(1)
    _, control = _solve(workload)
    _inject("seed=5;device[0].loss@1")
    solver, result = _solve(workload, SHARD_ENV)
    assert solver.last_shard == {"reason": "single-device", "recarves": 1}
    assert _scheduled(result) == _scheduled(control) and result.failures == control.failures
    tr = mh.tracker()
    assert tr.state_of(0) == mh.STATE_LOST and mesh.default_mesh(1, CPU) is None
    assert tr.probe(force=True) == {0: mh.STATE_PROBATION}
    assert tr.probe(force=True) == {0: mh.STATE_HEALTHY}
    assert [r["reason"] for r in tr.snapshot()["recarves"]] == [mh.REASON_DEVICE_LOST, mh.REASON_RECOVERED]
    solver, result = _solve(workload, SHARD_ENV)
    assert solver.last_shard["reason"] is None and solver.last_shard["recarves"] == 0
    assert _scheduled(result) == _scheduled(control) and result.failures == control.failures
    assert tr.last_recovery_s is not None and not tr.snapshot()["recovery_pending"]


def test_flag_off_no_tracker():
    workload = port_workloads.shard_plain_workload(0)
    solver, _ = _solve(workload, SHARD_ENV)
    assert solver.last_shard["reason"] is None
    assert not mh.has_tracker()
    assert mesh.healthy_devices() == mh.local_devices()


def _world_pods(n=16, seed=11):
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    rng = random.Random(seed)
    return [default_pod_factory(f"dw-{i}", rng) for i in range(n)]


def _world_catalog(m):
    its = m.instance_types(8)
    return its, [m.simple_template(its)]


def test_device_world_shard_standdown_matches_jax(monkeypatch):
    """With KARPENTER_TPU_SHARD on every resident cycle stands down with
    ``shard``, in both packages; the placements are the flag-off solve's."""
    from karpenter_tpu.streaming.churn import default_pod_factory as j_factory

    rng = random.Random(11)
    j_pods = [j_factory(f"dw-{i}", rng) for i in range(16)]
    j_its, j_tpls = _world_catalog(reference_workloads)
    monkeypatch.setenv("KARPENTER_TPU_SHARD", "1")
    monkeypatch.setenv("KARPENTER_TPU_DEVICE_WORLD", "1")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")
    js = JaxSolver()
    js.solve(j_pods, j_its, j_tpls)
    its, tpls = _world_catalog(port_workloads)
    pods = _world_pods()
    solver, result = _solve((pods, its, tpls), relax=False, device_world=True)
    assert solver.last_world_outcome == js._device_world.last_outcome == "standdown-shard"
    assert solver.last_shard["reason"] == js.last_shard["reason"] == "small-batch"
    monkeypatch.delenv("KARPENTER_TPU_SHARD")
    _, plain = _solve((pods, its, tpls), relax=False)
    assert _scheduled(result) == _scheduled(plain)


def test_device_world_device_lost_then_readopt():
    """The resident world's device dies mid-cycle: the world is dropped
    (``standdown-device-lost``), the device marked lost, the legacy path
    serves the cycle, and the next cycle re-adopts from scratch."""
    its, tpls = _world_catalog(port_workloads)
    pods = _world_pods()
    dev = TorchSolver(device="cpu", relax=False, device_world=True)
    ref = TorchSolver(device="cpu", relax=False)
    dev.solve(pods, its, tpls)
    assert dev.last_world_outcome.startswith("adopt")
    _inject("seed=7;device[0].loss@1")
    try:
        result = dev.solve(pods, its, tpls)
    finally:
        faults.install(None)
    assert dev.last_world_outcome == "standdown-device-lost"
    assert dev._device_world.world is None  # never resurrected
    assert mh.tracker().state_of(0) == mh.STATE_LOST
    result2 = dev.solve(pods, its, tpls)
    assert dev.last_world_outcome.startswith("adopt")
    expect = ref.solve(pods, its, tpls)
    for got in (result, result2):
        assert _scheduled(got) == _scheduled(expect) and got.failures == expect.failures
