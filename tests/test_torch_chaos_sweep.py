"""karpenter_tpu_torch/tools/chaos_sweep.py against tools/chaos_sweep.py: the
fault matrix at 60 pods over every class of FAULT_SPECS, the port's
``oracle`` and ``torch`` (on the CPU) backends beside the JAX tool's
``oracle`` and ``jax`` backends on the same corpus (``KARPENTER_TPU_RELAX=0``,
as tests/conftest.py pins it for both packages: equal survival verdicts and
``placements_key`` per class); the tenant-isolation, device-loss and soak
rows; and a real kernel error, which must drop the cycle, not survive it."""

import sys
import time
from pathlib import Path

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tools.chaos_sweep as J  # noqa: E402
from karpenter_tpu_torch.tools import chaos_sweep as T  # noqa: E402

PODS = 60
BACKEND_PAIRS = [("oracle", "oracle"), ("torch", "jax")]


@pytest.fixture(autouse=True)
def _tenant_labels():
    """Forget the tenant label values this module's services take: each
    package's metrics keep the ids of the first 32 tenants a process sees
    (``metrics/registry.tenant_label``), so a later test in the same process
    would see its tenants as ``other``."""
    import importlib

    regs = [importlib.import_module(f"{pkg}.metrics.registry") for pkg in ("karpenter_tpu", "karpenter_tpu_torch")]
    saved = [dict(reg._tenant_label_seen) for reg in regs]
    yield
    for reg, seen in zip(regs, saved):
        with reg._tenant_label_lock:
            reg._tenant_label_seen.clear()
            reg._tenant_label_seen.update(seen)


def jax_matrix(pod_count, backend_name, deadline_s=0.25):
    """The JAX tool's matrix loop (its ``main``) for one corpus and backend:
    per fault class (survived, placements_key or None)."""
    from karpenter_tpu.solver.oracle import OracleSolver
    from karpenter_tpu.solver.supervisor import SupervisedSolver
    from karpenter_tpu.testing import faults

    pods, its, tpls = J.build_problem(pod_count, 50)
    if backend_name == "jax":
        J.make_backend("jax").solve(pods, its, tpls)  # compile outside the fault window
    out = {}
    for fault, spec in J.FAULT_SPECS.items():
        faults.install(faults.FaultInjector.from_spec(spec) if spec else None)
        sup = SupervisedSolver(J.make_backend(backend_name), fallback=OracleSolver(),
                               deadline_s=deadline_s if fault == "hang" else 0.0, retries=1, backoff_base_s=0.01)
        try:
            result = sup.solve(pods, its, tpls)
            out[fault] = (True, J.placements_key(result))
        except Exception:
            out[fault] = (False, None)
        finally:
            faults.install(None)
    faults.clear()
    return out


@pytest.fixture(scope="module")
def matrices():
    port = T.run_matrix([PODS], ["oracle", "torch"], device="cpu")
    ref = {jb: jax_matrix(PODS, jb) for _, jb in BACKEND_PAIRS}
    return port, ref


def test_fault_specs_are_the_jax_tools():
    assert T.FAULT_SPECS == J.FAULT_SPECS


@pytest.mark.parametrize("fault", list(J.FAULT_SPECS))
@pytest.mark.parametrize("pair", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_matrix_cell_equals_the_jax_sweep(matrices, pair, fault):
    port, ref = matrices
    tb, jb = pair
    (row,) = [r for r in port if r["backend"] == tb and r["fault"] == fault]
    survived, key = ref[jb][fault]
    assert row["survived"] == survived is True
    assert row["key"] == key
    assert row["parity"]


def test_chip_smoke_pins_the_jax_sweeps_fault_free_placements(monkeypatch):
    """chip_smoke.py's phase 15 holds every cell its primary answered to
    CHAOS_PRIMARY_DIGEST: the JAX sweep's fault-free placements on the quick
    corpus under the default relax, which the port's own solve equals."""
    import chip_smoke

    monkeypatch.delenv("KARPENTER_TPU_RELAX", raising=False)
    pods, its, tpls = J.build_problem(chip_smoke.CHAOS_PODS, chip_smoke.CHAOS_TYPES)
    jkey = J.placements_key(J.make_backend("jax").solve(pods, its, tpls))
    tkey = T.placements_key(T.make_backend("torch", "cpu").solve(*T.build_problem(chip_smoke.CHAOS_PODS,
                                                                                   chip_smoke.CHAOS_TYPES)))
    assert chip_smoke.placements_digest(jkey) == chip_smoke.CHAOS_PRIMARY_DIGEST
    assert tkey == jkey


def test_matrix_prints_every_cell_survived(matrices, capsys):
    port, _ = matrices
    assert T.print_matrix(port) == []
    assert f"{len(port)}/{len(port)} cells survived with parity" in capsys.readouterr().out
    assert len(port) == 2 * len(T.FAULT_SPECS)


def test_a_real_kernel_error_drops_the_cycle(capsys, monkeypatch):
    """The port's supervisor raises an error of its kernels at once: every
    cell whose primary ran fails. Only the classes whose injected fault
    fires at every attempt before the primary runs (compile and encode at
    the first call, the storm at both) fail over."""
    from karpenter_tpu_torch.kernels import KernelDeviceError
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    class Broken(TorchSolver):
        def solve(self, *args, **kwargs):
            raise KernelDeviceError("ffd_loop: CUDA launch error 700")

    monkeypatch.setattr(T, "make_backend", lambda name, device=None: Broken(device="cpu"))
    rows = T.run_matrix([PODS], ["torch"])
    dropped = {r["fault"] for r in rows if not r["survived"]}
    assert dropped == {"none", "device", "nan", "hang", "flaky-p25"}
    for r in rows:
        if r["fault"] in dropped:
            assert r["key"] is None and r["error"].startswith("KernelDeviceError") and r["fallbacks"] == 0
        else:
            assert r["fallbacks"] == 1 and r["key"] == r["base_key"]
    assert len(T.print_matrix(rows)) == len(dropped)
    assert "DROPPED CYCLE: torch/none: KernelDeviceError" in capsys.readouterr().out


def test_a_real_fault_is_not_hidden_by_a_later_injected_one():
    """A kernel error on the first attempt is raised at once: neither an
    injected fault on a retry (which would fail the cycle over to the
    oracle) nor a retry that answers hides it."""
    from karpenter_tpu_torch.kernels import KernelDeviceError
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.testing import faults

    class FirstCallBroken(OracleSolver):
        calls = 0

        def solve(self, *args, **kwargs):
            FirstCallBroken.calls += 1
            if FirstCallBroken.calls == 1:
                raise KernelDeviceError("gate_counts: CUDA launch error 700")
            return super().solve(*args, **kwargs)

    pods, its, tpls = T.build_problem(8, 10)
    sup = SupervisedSolver(FirstCallBroken(), fallback=OracleSolver(), retries=1, backoff_base_s=0.0)
    faults.install(faults.FaultInjector.from_spec("solve.device@2"))
    try:
        with pytest.raises(KernelDeviceError):
            sup.solve(pods, its, tpls)
    finally:
        faults.clear()
    assert FirstCallBroken.calls == 1
    assert sup.counters["solve_retries"] == 0 and sup.counters["solve_fallbacks"] == 0
    # without the injected fault a retry would answer: it is never made
    FirstCallBroken.calls = 0
    sup = SupervisedSolver(FirstCallBroken(), fallback=OracleSolver(), retries=1, backoff_base_s=0.0)
    with pytest.raises(KernelDeviceError):
        sup.solve(pods, its, tpls)
    assert FirstCallBroken.calls == 1
    assert sup.counters["solve_retries"] == 0 and sup.counters["solve_fallbacks"] == 0


def test_tenant_isolation_on_torch_tenants():
    assert T.tenant_isolation(tenants=4, cycles=3, backend="torch", device="cpu")


def test_tenant_isolation_fails_on_a_real_kernel_error(monkeypatch):
    """A kernel error from the hostile tenant's primary is not contained as
    a survival: its cycles resolve as errors and the row fails."""
    from karpenter_tpu_torch.kernels import KernelDeviceError
    from karpenter_tpu_torch.solver.oracle import OracleSolver

    class Broken(OracleSolver):
        def solve(self, *args, **kwargs):
            raise KernelDeviceError("relax_place: CUDA launch error 719")

    real = T.make_backend
    calls = []

    def make_backend(name, device=None):
        calls.append(name)
        # the last active tenant's primary in each run (t2 of 3)
        return Broken() if len(calls) % 3 == 0 else real(name, device)

    monkeypatch.setattr(T, "make_backend", make_backend)
    assert not T.tenant_isolation(tenants=3, cycles=2, device="cpu")


def test_device_loss_row_on_one_device():
    ev = T.device_loss_row(200, device="cpu")
    assert ev["ok"], ev
    assert ev["shard"] == {"reason": "single-device", "recarves": 1}
    assert ev["recarves"] == ["device-lost", "recovered"]
    assert ev["recovered_shard_reason"] is None and ev["mesh_recovery_s"] is not None
    assert ev["migrated"] >= 1 and ev["serve_outcomes"] == 36
    assert ev["slo_breached"] == ["mesh-recovery"]
    assert {"mesh-fault", "mesh-recarve"} <= set(ev["flight_dump_kinds"])


def test_soak_with_a_short_budget():
    t0 = time.perf_counter()
    assert T.soak(2.0)
    assert time.perf_counter() - t0 < 30


def test_churn_survival():
    assert T.churn_survival(cycles=4)


def test_make_backend_defaults_to_the_card():
    import torch

    assert T.make_backend("torch", "cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.make_backend("torch")
    with pytest.raises(ValueError):
        T.make_backend("jax")
