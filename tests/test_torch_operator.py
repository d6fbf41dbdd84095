"""The port's Operator against the JAX package's.

Every scenario of tests/test_operator.py runs through both packages
(tests/torch_port.py: the scenario's names of the JAX package rebound to the
port, the factories building the port's objects, the Operator's ``kube``
converting what the scenario hands it), first with the scenario's own
Options (the host oracle) and then, for each scenario that builds an
Operator, with ``Options(solver_backend="torch", solver_device="cpu")``
against the JAX package's ``solver_backend="jax"``. The scenario's own
assertions hold on both; the deterministic scenarios must leave the same
NodeClaims, Nodes with their taints, bindings, pending pods and event
reasons in order, execute the same disruption commands and move the same
counters. The threaded and endpoint-hammering scenarios run on real clocks
and threads, so only their own assertions are compared.

``test_prewarm_uses_live_catalog`` (:367) runs through both packages with
the backend forced to the host oracle on the CPU (the scenario asks for the
JAX backend). Also here: the warm thread that ``start()`` runs on the card
builds the kernels first and holds /readyz at 503 until it ends (here with
the build replaced; on the card tests/test_torch_kernels.py's ``cuda``
case), no thread runs on the CPU, a build failure keeps /readyz at 503 and
is named in /statusz, and so is a device fault of a controller pass; the
prewarm knobs parse and reach the warm as in the JAX package.

Also here: the endpoint scenarios of tests/test_obs_trace.py (:272),
tests/test_obs_slo.py (:186), tests/test_explain.py (:412) and
tests/test_serve.py (:288, :335), each through both packages' serving
modules; and the Operator's construction contract (the torch backend needs
CUDA unless asked for the CPU; bad backends raise; the relax and
device-world flags read with the JAX package's rules).
"""

from __future__ import annotations

import importlib
import inspect
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
import torch

import tests.test_explain as TE
import tests.test_obs_slo as TS
import tests.test_obs_trace as TT
import tests.test_operator as TOP
import tests.test_serve as TV
import tests.torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_port import assert_same_run, forced_options, to_port
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
from karpenter_tpu_torch.operator import Operator, Options
from karpenter_tpu_torch.operator import operator as op_mod
from karpenter_tpu_torch.operator import serving
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.utils.clock import FakeClock

LEFT_OUT = ()
# scenarios whose Options ask for the JAX backend: the port runs them on the
# host oracle on the CPU
PORT_OPTIONS = {"test_prewarm_uses_live_catalog": {"solver_backend": "oracle", "solver_device": "cpu"}}
# real clocks and threads: only the scenario's own assertions are compared
UNDIGESTED = (
    "test_threaded_start_serves_metrics_and_survives_errors",
    "test_debug_endpoints_untorn_json_under_live_solves",
)
# the scenarios that build an Operator (run again on the solvers)
WITH_OPERATOR = (
    "test_options_flags_env_defaults",
    "test_end_to_end_provision_and_initialize",
    "test_end_to_end_consolidates_empty_node",
    "test_threaded_start_serves_metrics_and_survives_errors",
    "test_step_respects_periods",
    "test_end_to_end_drift_replacement",
)


def _scenarios():
    return [name for name, fn in sorted(vars(TOP).items(), key=lambda kv: getattr(
        getattr(kv[1], "__code__", None), "co_firstlineno", 0))
        if name.startswith("test_") and inspect.isfunction(fn) and name not in LEFT_OUT]


SCENARIOS = _scenarios()


def test_scenario_list_is_whole():
    assert len(SCENARIOS) + len(LEFT_OUT) == 10
    assert set(WITH_OPERATOR) | set(UNDIGESTED) <= set(SCENARIOS)


@pytest.fixture(autouse=True)
def _forensics_dirs(tmp_path, monkeypatch):
    # the supervisor's quarantine and flight dumps stay in the test's tmp dir
    monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_operator_scenario(name, request):
    p_overrides = {"Options": forced_options(True, **PORT_OPTIONS[name])} if name in PORT_OPTIONS else None
    assert_same_run(getattr(TOP, name), request, p_overrides=p_overrides, digest=name not in UNDIGESTED)


@pytest.mark.parametrize("name", WITH_OPERATOR)
def test_operator_scenario_on_solvers(name, request):
    """The scenario on the JAX package's JaxSolver and the port's
    TorchSolver (the plain path on the CPU), under their supervisors."""
    built = assert_same_run(
        getattr(TOP, name), request,
        j_overrides={"Options": forced_options(False, solver_backend="jax")},
        p_overrides={"Options": forced_options(True, solver_backend="torch", solver_device="cpu")},
        digest=name not in UNDIGESTED,
    )
    for op in built:
        assert isinstance(op.supervisor.primary, TorchSolver)
        assert op.supervisor.counters["solve_fallbacks"] == 0
        assert op.supervisor.circuit_state() == "closed"


# -- the endpoint scenarios of other suites -----------------------------------
# Each borrowed scenario's own fixtures set up the JAX package's modules; the
# fixtures here set up both packages' alike.


def _both(name):
    import importlib

    return [importlib.import_module(pkg + ".obs." + name) for pkg in ("karpenter_tpu", "karpenter_tpu_torch")]


@pytest.fixture
def _tracing_on():
    from karpenter_tpu.testing import faults as jfaults
    from karpenter_tpu_torch.testing import faults as pfaults

    for trace in _both("trace"):
        trace.set_enabled(True)
        trace.reset_ring()
    jfaults.clear()
    pfaults.clear()
    yield
    jfaults.clear()
    pfaults.clear()
    for trace in _both("trace"):
        trace.set_enabled(None)
        trace.reset_ring()


@pytest.fixture
def slo_on(monkeypatch, tmp_path):
    """tests/test_obs_slo.py's fixture over both packages' engines and
    flight recorders."""
    clock = {"t": 1000.0}
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for slo, flight in zip(_both("slo"), _both("flight")):
        monkeypatch.setattr(slo, "_wall", lambda: clock["t"])
        monkeypatch.setattr(flight, "_wall", lambda: clock["t"])
        slo.set_enabled(True)
        flight.set_enabled(True)
        slo.reset()
        flight.reset()
    try:
        yield clock
    finally:
        for slo, flight in zip(_both("slo"), _both("flight")):
            slo.set_enabled(None)
            flight.set_enabled(None)
            slo.reset()
            flight.reset()


@pytest.fixture
def _explain_hygiene():
    for explain in _both("explain"):
        explain.set_enabled(None)
        explain.reset_ring()
    yield
    for explain in _both("explain"):
        explain.set_enabled(None)
        explain.reset_ring()


universe = TE.universe


def test_debug_traces_endpoint_serves_ring_and_chrome(request, _tracing_on):
    from karpenter_tpu_torch.testing.workloads import make_diverse_pods

    for trace in _both("trace"):
        trace.reset_ring()
    assert_same_run(TT.test_debug_traces_endpoint_serves_ring_and_chrome, request, digest=False,
                    p_overrides={"make_diverse_pods": make_diverse_pods})


def test_slo_endpoints_untorn_json_under_live_solves(request):
    assert_same_run(TS.test_slo_endpoints_untorn_json_under_live_solves, request, digest=False)


def test_summary_and_statusz_shape(request, _explain_hygiene):
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS

    # the scenario's JaxSolver is the port's TorchSolver on the CPU
    assert_same_run(
        TE.TestSurfaces.test_summary_and_statusz_shape, request, self_arg=True, digest=False,
        p_overrides={"JaxSolver": lambda well_known=FAKE_WELL_KNOWN_LABELS: TorchSolver(
            well_known=well_known, device="cpu")},
    )


@pytest.mark.parametrize("name", ["test_concurrent_scrapes_during_live_solves",
                                  "test_statusz_and_readyz_reflect_service"])
def test_debug_tenants_endpoint(name, request):
    import functools

    from karpenter_tpu_torch.serve.dispatcher import SolveService

    # the port's service builds its default tenant stacks on CUDA unless
    # asked for the CPU
    assert_same_run(getattr(TV.TestDebugTenantsEndpoint, name), request, self_arg=True, digest=False,
                    p_overrides={"SolveService": functools.partial(SolveService, device="cpu")})


# -- the Operator's construction contract -------------------------------------


def test_torch_backend_needs_cuda_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Operator(FakeCloudProvider(), Options())
    op = Operator(FakeCloudProvider(), Options(solver_device="cpu"), clock=FakeClock())
    assert isinstance(op.supervisor.primary, TorchSolver)
    assert op.supervisor.primary.device.type == "cpu"
    assert type(op.supervisor.fallback).__name__ == "OracleSolver"


@pytest.mark.parametrize("backend", ["jax", "JAX", "", "cuda"])
def test_bad_backend_raises_naming_the_choices(backend):
    with pytest.raises(ValueError, match="torch, oracle"):
        Options(solver_backend=backend)
    with pytest.raises(ValueError, match="torch, oracle"):
        Options.parse([], env={"SOLVER_BACKEND": backend})


def test_prewarm_knobs_parse_and_reach_the_warm(monkeypatch):
    """``prewarm_max_pods`` and ``prewarm_screen_candidates`` parse from
    flags and env as the JAX package's do, and the warm thread hands them to
    ``prewarm_solver`` and ``prewarm_screen`` (with the live catalog), as the
    JAX package's ``maybe_prewarm_in_background`` does."""
    from karpenter_tpu.operator.options import Options as JOptions
    from karpenter_tpu.solver import warmup as jwarm
    from karpenter_tpu_torch.solver import warmup

    argv, env = ["--prewarm-max-pods", "10000"], {"PREWARM_SCREEN_CANDIDATES": "200"}
    for cls in (Options, JOptions):
        opts = cls.parse(argv, env=env)
        assert (opts.prewarm_max_pods, opts.prewarm_screen_candidates) == (10000, 200)
        assert (cls().prewarm_max_pods, cls().prewarm_screen_candidates) == (0, 0)
    seen = {}
    for pkg, mod, opts in ((True, warmup, Options.parse(argv, env=env)),
                           (False, jwarm, JOptions.parse(argv, env=env))):
        calls = []
        monkeypatch.setattr(mod, "prewarm_solver", lambda max_pods=0, catalog=None: calls.append(
            ("solver", max_pods, len(catalog))))
        monkeypatch.setattr(mod, "prewarm_screen", lambda n: calls.append(("screen", n)))
        monkeypatch.setattr(mod, "prewarm_shard", lambda catalog=None: calls.append(("shard",)))
        monkeypatch.setattr(mod, "prewarm_device_world", lambda catalog=None: calls.append(("world",)))
        monkeypatch.setattr(mod, "persistent_cache_enabled", lambda: True)
        monkeypatch.setattr(mod, "_on_accelerator", lambda: True)
        if pkg:
            opts.solver_device = "cpu"
        cloud = (FakeCloudProvider if pkg else importlib.import_module(
            "karpenter_tpu.cloudprovider.fake").FakeCloudProvider)()
        t = mod.maybe_prewarm_in_background(opts, cloud)
        t.join(30)
        seen[pkg] = calls
    assert seen[True] == seen[False]
    assert seen[True][0][:2] == ("solver", 10000) and ("screen", 200) in seen[True]


def test_solver_device_parses_like_every_field():
    assert Options.parse([], env={}).solver_device == "cuda"
    assert Options.parse([], env={"SOLVER_DEVICE": "cpu"}).solver_device == "cpu"
    assert Options.parse(["--solver-device", "cpu"], env={"SOLVER_DEVICE": "cuda"}).solver_device == "cpu"


def test_options_are_the_jax_fields_that_something_reads():
    """The JAX package's Options less the four fields nothing reads (the
    apiserver client's QPS and burst, leader election, the memory limit
    fraction), plus ``solver_device``; none of the four parses as a flag."""
    import dataclasses

    from karpenter_tpu.operator.options import Options as JOptions

    unread = {"kube_client_qps", "kube_client_burst", "enable_leader_election", "memory_limit_fraction"}
    port = {f.name for f in dataclasses.fields(Options)}
    assert port == ({f.name for f in dataclasses.fields(JOptions)} - unread) | {"solver_device"}
    with pytest.raises(SystemExit):
        Options.parse(["--enable-leader-election"], env={})


@pytest.mark.parametrize("relax,world,want", [
    (None, None, (True, False)), ("1", "1", (True, True)), ("0", "0", (False, False)),
    ("true", "", (False, False)), ("", "yes", (False, True)),
])
def test_solver_flags_follow_the_jax_rules(monkeypatch, relax, world, want):
    from karpenter_tpu.ops.relax import enabled as jax_relax

    for name, value in (("KARPENTER_TPU_RELAX", relax), ("KARPENTER_TPU_DEVICE_WORLD", world)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    op = Operator(FakeCloudProvider(), Options(solver_device="cpu"), clock=FakeClock())
    solver = op.supervisor.primary
    assert (solver.relax, solver._device_world is not None) == want
    assert solver.relax == jax_relax()


# -- readiness: the kernel build and device faults -----------------------------


def _ports():
    with socket.socket() as s1, socket.socket() as s2:
        s1.bind(("127.0.0.1", 0))
        s2.bind(("127.0.0.1", 0))
        return s1.getsockname()[1], s2.getsockname()[1]


def _readyz(port) -> int:
    try:
        return urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5).status
    except urllib.error.HTTPError as exc:
        return exc.code


def _statusz(port) -> dict:
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz", timeout=5).read())


def _started(monkeypatch=None, build=None):
    """A started CPU Operator; with ``build``, one that takes its solver for
    the card's and runs ``build`` as the warm thread's kernel build
    (``kernels.load_all``)."""
    if build is not None:
        monkeypatch.setattr(op_mod, "_kernels_on_card", lambda sup: True)
        monkeypatch.setattr(kernels, "load_all", build)
    port, health = _ports()
    op = Operator(FakeCloudProvider(), Options(solver_device="cpu", metrics_port=port, health_probe_port=health))
    op.start()
    return op, port


def test_no_build_thread_on_the_cpu():
    op, port = _started()
    try:
        assert op._warm_thread is None
        assert _readyz(port) == 200
        payload = _statusz(port)
        assert payload["ready"] and payload["warmup_complete"]
        assert "kernel_build_error" not in payload
        assert [k["name"] for k in payload["kernels"]["kernels"]] == list(kernels.SOURCES)
        assert payload["recovery"] == {"phase": "idle"} and payload["programs"]["enabled"] is False
    finally:
        op.stop()


def test_build_thread_holds_readyz(monkeypatch):
    """start() on the card builds the kernels on the warm thread first;
    /readyz answers 503 until it ends (the build replaced by one that waits
    for the test)."""
    release, started = threading.Event(), threading.Event()

    def build(names=None):
        started.set()
        assert release.wait(30)
        return {}

    op, port = _started(monkeypatch, build)
    try:
        assert started.wait(10)
        assert _readyz(port) == 503
        assert _statusz(port)["warmup_complete"] is False
        release.set()
        op._warm_thread.join(10)
        assert _readyz(port) == 200
    finally:
        release.set()
        op.stop()


def test_build_failure_keeps_readyz_down_and_shows_in_statusz(monkeypatch):
    def build(names=None):
        raise kernels.KernelCompileError("kernel build failed:\nffd_loop: nvcc exit 1")

    op, port = _started(monkeypatch, build)
    try:
        op._warm_thread.join(10)
        assert _readyz(port) == 503
        payload = _statusz(port)
        assert not payload["ready"] and payload["warmup_complete"]
        assert "KernelCompileError" in payload["kernel_build_error"]
        assert "nvcc exit 1" in payload["kernel_build_error"]
    finally:
        op.stop()


class _BrokenKernel:
    """A primary whose launches fail as a refused kernel launch does."""

    device = torch.device("cpu")
    broken = True

    def solve(self, pods, *args, **kwargs):
        if self.broken:
            raise kernels.KernelDeviceError("ffd_loop: CUDA launch error 700")
        from karpenter_tpu_torch.solver.oracle import OracleSolver

        return OracleSolver().solve(pods, *args, **kwargs)


def test_device_fault_turns_readyz_down_until_a_clean_pass():
    from tests.factories import make_nodepool, make_pod

    op = Operator(FakeCloudProvider(), Options(solver_device="cpu"), clock=FakeClock())
    op.supervisor.primary = _BrokenKernel()
    op.supervisor.retries = 0
    op.kube.create(to_port(make_nodepool()))
    op.kube.create(to_port(make_pod(name="p1", cpu=1.0)))
    with pytest.raises(kernels.KernelDeviceError):
        op.step()
    # the supervisor raised instead of failing over: its circuit says nothing
    assert op.supervisor.circuit_state() == "closed"
    assert not op.status.ready()
    payload = op.status.statusz()
    assert "KernelDeviceError" in payload["device_faults"]["provisioner"]
    # the failed pass set the trigger again for its pods
    assert op.batcher._trigger.is_set()
    server = serving.serve(0, host="127.0.0.1", status=op.status)
    try:
        assert _readyz(server.server_address[1]) == 503
        # passes that solve nothing prove nothing: still 503
        op.batcher._trigger.clear()
        op.run_until_settled()
        assert _readyz(server.server_address[1]) == 503
        assert "provisioner" in op.status.statusz()["device_faults"]
        op.supervisor.primary.broken = False
        op.batcher.trigger()
        op.run_until_settled()
        assert _readyz(server.server_address[1]) == 200
        assert "device_faults" not in op.status.statusz()
        assert op.kube.list(NodeClaim)
    finally:
        server.shutdown()
        server.server_close()


def test_device_fault_retries_the_pods_of_the_failed_pass():
    """The trigger the failed pass set again is what provisions its pods
    once the device answers: no new pod arrives."""
    from tests.factories import make_nodepool, make_pod

    op = Operator(FakeCloudProvider(), Options(solver_device="cpu"), clock=FakeClock())
    op.supervisor.primary = _BrokenKernel()
    op.supervisor.retries = 0
    op.kube.create(to_port(make_nodepool()))
    op.kube.create(to_port(make_pod(name="p1", cpu=1.0)))
    with pytest.raises(kernels.KernelDeviceError):
        op.step()
    assert not op.kube.list(NodeClaim)
    op.supervisor.primary.broken = False
    op.run_until_settled()
    assert op.status.ready()
    assert len(op.kube.list(NodeClaim)) == 1


def test_disruption_fault_stays_until_a_pass_does_device_work():
    """A disruption pass with no candidates solves nothing and launches
    nothing, so it leaves the screen's fault in place; a pass that solves on
    the primary clears it."""
    from tests.factories import make_nodepool, make_pod

    op = Operator(FakeCloudProvider(), Options(solver_device="cpu"), clock=FakeClock())
    clean = op.disruption.reconcile
    calls = []

    def screen_fails_once():
        calls.append(1)
        if len(calls) == 1:
            raise kernels.KernelDeviceError("runs_screen: CUDA launch error 700")
        return clean()

    op.disruption.reconcile = screen_fails_once
    with pytest.raises(kernels.KernelDeviceError):
        op.run_until_settled()
    op.run_until_settled()
    assert len(calls) == 2
    assert not op.status.ready()
    assert "runs_screen" in op.status.statusz()["device_faults"]["disruption"]

    def solves():
        op.supervisor.solve([to_port(make_pod(name="probe", cpu=1.0))], [], [])
        return clean()

    op.disruption.reconcile = solves
    op.kube.create(to_port(make_nodepool()))
    op._reconcile("disruption", op.disruption.reconcile)
    assert op.status.ready()
