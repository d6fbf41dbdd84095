"""Solver supervisor parity: karpenter_tpu_torch's SupervisedSolver,
OracleSolver and fault injector against the JAX package's, on the
deterministic cases of tests/test_supervisor_chaos.py.

Every scenario runs twice, once through each package's supervisor with that
package's OracleSolver, fault injector, flight recorder and tracer, on the
same inputs built by the same code from each package's objects, with the
same fake primaries (CountingSolver, LyingSolver) and the same fault specs.
What each run shows must be equal: the placements, the supervisor's
counters, its circuit state after each step, the class of its last failure,
the injector's firings, the backoff sleeps, the flight record kinds with
their details, and the trace span names. Then the port's own additions:
the torch and CUDA failure classes, the device gate's errors counted as
failed attempts, and the refusals of what is not ported (the streaming
layer, explain attribution).
"""

from __future__ import annotations

import importlib
import json
import os
import random
from types import SimpleNamespace

import pytest
import torch

import bench
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.testing import workloads as TW
from tests.test_torch_encode import draw
import tests.torch_threads  # noqa: F401  (one intra-op thread)


def _side(root, diverse):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        name=root, sup=mod("solver.supervisor"), Oracle=mod("solver.oracle").OracleSolver,
        faults=mod("testing.faults"), flight=mod("obs.flight"), trace=mod("obs.trace"), slo=mod("obs.slo"),
        objects=mod("apis.objects"), NodePool=mod("apis.nodepool").NodePool,
        instance_types=mod("cloudprovider.fake").instance_types, encode=mod("solver.encode"),
        diverse=diverse,
    )


JAX = _side("karpenter_tpu", bench.make_diverse_pods)
PORT = _side("karpenter_tpu_torch", TW.make_diverse_pods)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """No ambient faults; flight dumps and quarantine files under tmp_path;
    the recorder and the tracer on and empty, on both sides."""
    monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for s in SIDES:
        s.faults.clear()
        s.flight.set_enabled(True)
        s.slo.set_enabled(True)
        s.trace.set_enabled(True)
        s.flight.reset()
        s.slo.reset()
        s.trace.reset_ring()
    yield
    for s in SIDES:
        s.faults.clear()
        s.flight.set_enabled(None)
        s.slo.set_enabled(None)
        s.trace.set_enabled(None)


def build_problem(s, pod_count=60, its_count=20, name="chaos"):
    its = s.instance_types(its_count)
    tpl = s.encode.template_from_nodepool(s.NodePool(metadata=s.objects.ObjectMeta(name=name)), its, range(len(its)))
    return s.diverse(pod_count, random.Random(42)), its, [tpl]


def small_problem(s, name="q"):
    """tests/test_supervisor_chaos.py's quarantine corpus: four 0.8-cpu pods
    against one instance type."""
    o = s.objects
    its = s.instance_types(1)
    tpl = s.encode.template_from_nodepool(s.NodePool(metadata=o.ObjectMeta(name=name)), its, range(len(its)))
    pods = [o.Pod(metadata=o.ObjectMeta(name=f"q-{i}"), spec=o.PodSpec(containers=[o.Container(requests={"cpu": 0.8})]))
            for i in range(4)]
    return pods, its, [tpl]


def placements_key(result):
    return (
        tuple(
            (c.template_index, tuple(c.pod_indices), tuple(c.instance_type_indices))
            for c in result.new_claims
        ),
        tuple(sorted((k, tuple(v)) for k, v in result.node_pods.items())),
        tuple(sorted(result.failures)),
    )


class CountingSolver:
    """Wraps a backend, counting calls; optionally fails the first N."""

    def __init__(self, inner, fail_first=0, error=None):
        self.inner = inner
        self.calls = 0
        self.fail_first = fail_first
        self.error = error or RuntimeError("device: injected")
        self.last = None

    def solve(self, *args, **kwargs):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise self.error
        self.last = self.inner.solve(*args, **kwargs)
        return self.last


class LyingSolver:
    """The oracle's answer with the second claim's pods folded into the
    first: the overpacked-commit signature the validator must catch."""

    def __init__(self, inner):
        self.inner = inner

    def solve(self, *args, **kwargs):
        result = self.inner.solve(*args, **kwargs)
        if len(result.new_claims) >= 2:
            a, b = result.new_claims[0], result.new_claims[1]
            a.pod_indices = a.pod_indices + b.pod_indices
            result.new_claims.pop(1)
        return result


def _span_names(node):
    return [node["name"], [_span_names(c) for c in node.get("children", ())]]


def observed(s, sup, results, extra=None):
    """What one scenario run shows, in a form equal across packages."""
    records = []
    for rec in s.flight.ring().snapshot():
        rec = {k: v for k, v in rec.items() if k not in ("t", "trace_id", "path", "duration_s")}
        records.append(json.loads(json.dumps(rec, default=str)))
    injector = s.faults.active()
    return dict(
        placements=[placements_key(r) for r in results],
        counters=dict(sup.counters),
        circuit=sup.circuit_state(),
        last_failure=(sup.last_failure or {}).get("class"),
        fired=list(injector.fired) if injector is not None else None,
        flight=records,
        spans=[_span_names(t["root"]) for t in reversed(s.trace.ring().snapshot())],
        **(extra or {}),
    )


def both(scenario):
    """Run ``scenario(side)`` on each package; assert what they show is
    equal; return the port's."""
    jax_view, port_view = (scenario(s) for s in SIDES)
    for key in jax_view:
        assert port_view[key] == jax_view[key], key
    return port_view


def test_fault_free_result_is_the_primary_object():
    def scenario(s):
        pods, its, tpls = build_problem(s)
        primary = CountingSolver(s.Oracle())
        sup = s.sup.SupervisedSolver(primary, fallback=s.Oracle())
        result = sup.solve(pods, its, tpls)
        assert result is primary.last
        return observed(s, sup, [result])

    view = both(scenario)
    assert set(view["counters"].values()) == {0} and view["circuit"] == "closed"
    assert view["spans"] == [["solve", [["validate", []]]]]


@pytest.mark.parametrize(
    "spec,expect_fallback",
    [("solve.compile@1", True), ("solve.encode@1", True), ("solve.nan@1", True), ("solve.device@1", False)],
)
def test_fault_class_completes_cycle_with_parity(spec, expect_fallback):
    def scenario(s):
        pods, its, tpls = build_problem(s)
        baseline = s.Oracle().solve(pods, its, tpls)
        s.faults.install(s.faults.FaultInjector.from_spec(spec))
        sup = s.sup.SupervisedSolver(s.Oracle(), fallback=s.Oracle(), retries=1, backoff_base_s=0.001)
        result = sup.solve(pods, its, tpls)
        assert placements_key(result) == placements_key(baseline)
        return observed(s, sup, [result])

    view = both(scenario)
    assert view["counters"]["solve_fallbacks"] == int(expect_fallback)
    assert view["counters"]["solve_retries"] == int(not expect_fallback)
    assert view["fired"] == [("solve", spec.split(".")[1].split("@")[0], 1)]


def test_hang_is_caught_by_deadline_then_falls_back():
    def scenario(s):
        pods, its, tpls = build_problem(s, pod_count=20)
        s.faults.install(s.faults.FaultInjector.from_spec("solve.hang=5@1..2"))
        sup = s.sup.SupervisedSolver(s.Oracle(), fallback=s.Oracle(), deadline_s=0.1, retries=1,
                                     backoff_base_s=0.001)
        return observed(s, sup, [sup.solve(pods, its, tpls)])

    view = both(scenario)
    assert view["counters"]["deadline_exceeded"] == 2 and view["counters"]["solve_fallbacks"] == 1
    assert view["last_failure"] == "deadline"


def test_persistent_failure_without_fallback_salvages_not_raises():
    def scenario(s):
        pods, its, tpls = build_problem(s, pod_count=12)
        s.faults.install(s.faults.FaultInjector.from_spec("solve.compile@*"))
        sup = s.sup.SupervisedSolver(s.Oracle(), fallback=None)
        result = sup.solve(pods, its, tpls)
        assert result.new_claims == [] and set(result.failures) == set(range(len(pods)))
        assert all("requeued" in r for r in result.failures.values())
        return observed(s, sup, [result])

    assert both(scenario)["counters"]["salvaged"] == 1


def test_failure_classification():
    """The JAX package's table holds on both; the port adds the kernels'
    typed errors and the CUDA runtime's."""
    for s in SIDES:
        sup, f = s.sup, s.faults
        assert sup.classify_failure(f.FaultCompileError("x")) == "compile"
        assert sup.classify_failure(f.FaultDeviceError("x")) == "device"
        assert sup.classify_failure(f.FaultEncodeError("x")) == "encode"
        assert sup.classify_failure(sup.DeadlineExceeded("x")) == "deadline"
        assert sup.classify_failure(sup.NaNResultError("x")) == "nan"
        assert sup.classify_failure(RuntimeError("RESOURCE_EXHAUSTED: hbm")) == "device"
        assert sup.classify_failure(RuntimeError("error during lowering")) == "compile"
        assert sup.classify_failure(ValueError("whatever")) == "unknown"
    classify = PORT.sup.classify_failure
    assert classify(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")) == "device"
    assert classify(RuntimeError("CUDA error: an illegal memory access was encountered")) == "device"
    assert classify(kernels.KernelDeviceError("runs_screen: CUDA launch error 700")) == "device"
    assert classify(kernels.KernelCompileError("kernel build failed:\nruns_screen: nvcc exit 1")) == "compile"
    # the JAX package's classifier reads the CUDA messages as unknown
    assert JAX.sup.classify_failure(RuntimeError("CUDA error: an illegal memory access was encountered")) == "unknown"


def test_kernel_errors_are_typed(monkeypatch):
    """kernels.py raises a compile-classed error when a build fails and a
    device-classed one when a launch is refused."""
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda path: False)
    with pytest.raises(kernels.KernelCompileError, match="nvcc not found"):
        kernels.nvcc_path()

    class _Lib:
        def __getattr__(self, name):
            return (lambda *a: 24) if name.endswith("_size") else (lambda *a: 700)

    monkeypatch.setattr(kernels, "library", lambda name: _Lib())
    args = kernels.make_struct("Three", ("a", "b", "c"), ())()
    before = kernels.LAUNCHES["runs_screen"]
    with pytest.raises(kernels.KernelDeviceError, match="CUDA launch error 700"):
        kernels.launch("runs_screen", args, 0)
    assert kernels.LAUNCHES["runs_screen"] == before  # a refused launch is not counted
    assert PORT.sup.classify_failure(kernels.KernelDeviceError("x")) == "device"
    assert PORT.sup.classify_failure(kernels.KernelCompileError("x")) == "compile"


def test_circuit_opens_routes_to_fallback_then_half_open_probe_closes():
    def scenario(s):
        pods, its, tpls = build_problem(s, pod_count=10)
        clock = {"t": 0.0}
        primary = CountingSolver(s.Oracle(), fail_first=2)
        sup = s.sup.SupervisedSolver(primary, fallback=s.Oracle(), retries=0, circuit_threshold=2,
                                     circuit_cooldown_s=30.0, time_fn=lambda: clock["t"], sleep_fn=lambda x: None)
        results, states, calls = [], [], []
        for step in range(4):
            if step == 3:
                clock["t"] += 31.0
                states.append(sup.circuit_state())
            results.append(sup.solve(pods, its, tpls))
            states.append(sup.circuit_state())
            calls.append(primary.calls)
        return observed(s, sup, results, dict(states=states, calls=calls))

    view = both(scenario)
    assert view["states"] == ["closed", "open", "open", "half-open", "closed"]
    assert view["calls"] == [1, 2, 2, 3]
    assert view["counters"]["solve_fallbacks"] == 3
    assert len(set(view["placements"])) == 1


def test_failed_half_open_probe_reopens():
    def scenario(s):
        pods, its, tpls = build_problem(s, pod_count=10)
        clock = {"t": 0.0}
        sup = s.sup.SupervisedSolver(CountingSolver(s.Oracle(), fail_first=10), fallback=s.Oracle(), retries=0,
                                     circuit_threshold=1, circuit_cooldown_s=30.0, time_fn=lambda: clock["t"],
                                     sleep_fn=lambda x: None)
        states = []
        sup.solve(pods, its, tpls)
        states.append(sup.circuit_state())
        clock["t"] += 31.0
        sup.solve(pods, its, tpls)  # the probe fails
        states.append(sup.circuit_state())
        clock["t"] += 15.0
        states.append(sup.circuit_state())  # the cooldown restarted at the probe
        return observed(s, sup, [], dict(states=states))

    assert both(scenario)["states"] == ["open", "open", "open"]


def test_bad_result_fails_over_and_quarantines(tmp_path, monkeypatch):
    def scenario(s):
        ring = tmp_path / "quarantine" / s.name
        monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(ring))
        pods, its, tpls = small_problem(s)
        baseline = s.Oracle().solve(pods, its, tpls)
        sup = s.sup.SupervisedSolver(LyingSolver(s.Oracle()), fallback=s.Oracle(), tenant="t")
        result = sup.solve(pods, its, tpls)
        assert placements_key(result) == placements_key(baseline)
        dumps = list((ring / "tenant-t").glob("quarantine-*.json"))
        assert len(dumps) == 1
        payload = json.loads(dumps[0].read_text())
        return observed(s, sup, [result], dict(violations=payload["violations"]))

    view = both(scenario)
    assert view["counters"]["validator_rejections"] == 1 and view["counters"]["solve_fallbacks"] == 1
    assert view["last_failure"] == "validation" and view["violations"]
    # the port's quarantine ring loads what it wrote, in the tenant's namespace
    from karpenter_tpu_torch.solver import forensics

    loaded = forensics.load_quarantine(str(tmp_path / "quarantine" / PORT.name), tenant="t")
    assert len(loaded) == 1 and loaded[0]["tenant"] == "t" and loaded[0]["violations"] == view["violations"]


def test_bad_result_without_fallback_strips_only_bad_bins():
    def scenario(s):
        pods, its, tpls = small_problem(s, name="q2")
        sup = s.sup.SupervisedSolver(LyingSolver(s.Oracle()), fallback=None)
        result = sup.solve(pods, its, tpls)
        accounted = set(result.failures)
        for c in result.new_claims:
            accounted |= set(c.pod_indices)
        assert accounted == set(range(len(pods))) and result.failures
        return observed(s, sup, [result])

    assert both(scenario)["counters"]["salvaged"] == 1


def test_fault_replay_is_deterministic():
    """The same spec and seed give the same firings and the same backoff
    sleeps (crc32 jitter) on both packages, run after run."""

    def scenario(s):
        pods, its, tpls = build_problem(s, pod_count=8)
        s.faults.install(s.faults.FaultInjector.from_spec("seed=7;solve.device@p0.4"))
        sleeps = []
        sup = s.sup.SupervisedSolver(s.Oracle(), fallback=s.Oracle(), retries=2, circuit_threshold=100,
                                     sleep_fn=sleeps.append)
        results = [sup.solve(pods, its, tpls) for _ in range(12)]
        return observed(s, sup, results, dict(sleeps=sleeps))

    first = both(scenario)
    assert first["fired"] and first["sleeps"]
    for s in SIDES:
        s.flight.reset()
        s.trace.reset_ring()
    assert both(scenario) == first
    other = PORT.faults.FaultInjector.from_spec("seed=8;solve.device@p0.4")
    for _ in range(50):
        other.draw("solve")
    inj = PORT.faults.FaultInjector.from_spec("seed=7;solve.device@p0.4")
    for _ in range(50):
        inj.draw("solve")
    assert other.fired != inj.fired


def test_tenant_scoped_fault_fires_only_for_its_tenant():
    def scenario(s):
        pods, its, tpls = build_problem(s, pod_count=6)
        s.faults.install(s.faults.FaultInjector.from_spec("solve[b].compile@2"))
        a = s.sup.SupervisedSolver(s.Oracle(), fallback=s.Oracle(), tenant="a")
        b = s.sup.SupervisedSolver(s.Oracle(), fallback=s.Oracle(), tenant="b")
        for _ in range(3):
            a.solve(pods, its, tpls)
            b.solve(pods, its, tpls)
        return observed(s, b, [], dict(a_counters=dict(a.counters)))

    view = both(scenario)
    assert view["fired"] == [("solve[b]", "compile", 2)]
    assert view["counters"]["solve_fallbacks"] == 1 and view["a_counters"]["solve_fallbacks"] == 0


def test_malformed_fault_specs_fail_fast():
    for s in SIDES:
        for bad in ("solve.compile", "oven.bake@1", "solve.ice@1", "solve.device@p1.5", "solve[].device@1",
                    "device.loss@1"):
            with pytest.raises(ValueError):
                s.faults.parse_spec(bad)


@pytest.mark.parametrize("corpus", ["chaos-60", "diverse-280"])
def test_oracle_placements_equal_the_jax_oracle(corpus):
    if corpus == "chaos-60":
        jw, tw = build_problem(JAX), build_problem(PORT)
    else:
        (jp, jits, jtpls, jnodes), (tp, tits, ttpls, tnodes), _ = draw(corpus)
        jw, tw = (jp, jits, jtpls, jnodes), (tp, tits, ttpls, tnodes)
    jr, tr = JAX.Oracle().solve(*jw), PORT.Oracle().solve(*tw)
    assert placements_key(tr) == placements_key(jr)
    assert tr.failures == jr.failures
    assert [c.requests for c in tr.new_claims] == [c.requests for c in jr.new_claims]


def test_oracle_refuses_explain(monkeypatch):
    """With KARPENTER_TPU_EXPLAIN set, the oracle no longer refuses: a solve
    that leaves pods unplaced attributes them (obs/explain.py), as the JAX
    package's oracle does, and a solve with nothing unplaced has no report."""
    from karpenter_tpu_torch.obs import explain as obs_explain

    pods, its, tpls = small_problem(PORT)
    pods = pods + [PORT.objects.Pod(metadata=PORT.objects.ObjectMeta(name="huge"), spec=PORT.objects.PodSpec(
        containers=[PORT.objects.Container(requests={"cpu": 10000.0})]))]
    assert PORT.Oracle().solve(pods, its, tpls).explain is None
    monkeypatch.setenv("KARPENTER_TPU_EXPLAIN", "1")
    try:
        result = PORT.Oracle().solve(pods, its, tpls)
        huge = len(pods) - 1
        assert result.explain.pods.keys() == result.failures.keys() == {huge}
        assert result.explain.pods[huge].reason == obs_explain.REASON_RESOURCES
        assert PORT.Oracle().solve(pods[:4], its, tpls).explain is None  # nothing to attribute
    finally:
        obs_explain.reset_ring()


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_streaming_layer_wraps_the_primary(how, tmp_path, monkeypatch):
    """``streaming=True`` or ``KARPENTER_TPU_DELTA=1`` wraps the primary in
    the StreamingSolver, as in the JAX package: a churn stream goes cold-first
    then warm with equal spans, flight records and counters in both packages,
    and its journal is written. A quarantine (a lying primary under the
    streaming layer) resets the streaming state and removes the journal."""

    def scenario(s):
        warm = importlib.import_module(f"{s.name}.streaming.warm")
        churn = importlib.import_module(f"{s.name}.streaming.churn")
        snapshot = importlib.import_module(f"{s.name}.streaming.snapshot")
        monkeypatch.setenv("KARPENTER_TPU_STATE_DIR", str(tmp_path / s.name))
        kwargs = {"streaming": True} if how == "argument" else {}
        if how == "environment":
            monkeypatch.setenv("KARPENTER_TPU_DELTA", "1")
        pods, its, tpls = build_problem(s, pod_count=40)
        sup = s.sup.SupervisedSolver(s.Oracle(), fallback=s.Oracle(), tenant="t", **kwargs)
        assert isinstance(sup.primary, warm.StreamingSolver) and sup.primary.tenant == "t"
        proc = churn.ChurnProcess(pods, config=churn.ChurnConfig(seed=4, arrivals_per_cycle=2, deletes_per_cycle=1))
        results, outcomes = [], []
        for _ in range(3):
            proc.step()
            results.append(sup.solve(proc.pods, its, tpls))
            outcomes.append(sup.primary.last_outcome)
        journaled = os.path.exists(snapshot.journal_path("t"))
        liar = s.sup.SupervisedSolver(warm.StreamingSolver(LyingSolver(s.Oracle())), fallback=s.Oracle(),
                                      tenant="liar", **kwargs)
        liar.solve(proc.pods, its, tpls)
        return observed(s, sup, results, dict(
            outcomes=outcomes, journaled=journaled, liar=dict(liar.counters),
            reset=liar.primary._prev is None, journal_left=os.path.exists(snapshot.journal_path("liar")),
            kept=os.path.exists(snapshot.journal_path("t")),
        ))

    view = both(scenario)
    assert view["outcomes"] == ["cold-first", "warm", "warm"] and view["journaled"]
    assert view["liar"]["validator_rejections"] == 1 and view["reset"] and not view["journal_left"]
    assert view["kept"]


def test_torch_primary_passes_the_device_gate_unaltered():
    """Over TorchSolver (the plain path on the CPU), the result carries its
    GateContext, the device gate owns the verdict, and the primary's result
    object comes back untouched."""
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    pods, its, tpls, nodes = TW.fuzz_workload(6)
    primary = CountingSolver(TorchSolver(device="cpu"))
    sup = PORT.sup.SupervisedSolver(primary, fallback=PORT.Oracle())
    result = sup.solve(pods, its, tpls, nodes)
    assert result is primary.last and result.verify_ctx is not None
    assert set(sup.counters.values()) == {0} and sup.circuit_state() == "closed"


def test_device_gate_error_is_a_failed_primary_attempt(monkeypatch):
    """An error of the device gate's kernel on a primary result is
    classified like a solve error (a CUDA error: device) and raised at
    once; it is never an accept, never retried and never failed over."""
    from karpenter_tpu_torch import verify
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    def broken_gate(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(verify, "full_gate", broken_gate)
    pods, its, tpls, nodes = TW.fuzz_workload(6)
    sup = PORT.sup.SupervisedSolver(TorchSolver(device="cpu"), fallback=PORT.Oracle(), retries=1,
                                    sleep_fn=lambda x: None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sup.solve(pods, its, tpls, nodes)
    assert sup.counters["solve_retries"] == 0 and sup.counters["solve_fallbacks"] == 0
    assert sup.last_failure["class"] == "device" and sup.circuit_state() == "closed"


@pytest.mark.parametrize("fallback", [True, False], ids=["fallback", "no-fallback"])
@pytest.mark.parametrize(
    "error",
    [
        kernels.KernelCompileError("kernel build failed:\nruns_screen: nvcc exit 1"),
        kernels.KernelDeviceError("runs_screen: CUDA launch error 700"),
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
    ],
    ids=["compile", "launch", "oom", "cuda-error"],
)
def test_kernel_and_cuda_errors_raise_not_fail_over(error, fallback):
    """An error of the port's own kernels or of the CUDA runtime is raised
    at once, whatever its class: no retry, no host fallback, no salvage, no
    step towards an open circuit. An injected fault of the same class still
    fails over (test_fault_class_completes_cycle_with_parity)."""
    pods, its, tpls = build_problem(PORT, pod_count=12)
    primary = CountingSolver(PORT.Oracle(), fail_first=10, error=error)
    sup = PORT.sup.SupervisedSolver(primary, fallback=PORT.Oracle() if fallback else None, retries=1,
                                    circuit_threshold=1, sleep_fn=lambda x: None)
    assert PORT.sup.device_fault(error) and not PORT.sup.device_fault(PORT.faults.FaultDeviceError("device"))
    with pytest.raises(type(error)):
        sup.solve(pods, its, tpls)
    assert primary.calls == 1 and sup.counters["solve_retries"] == 0
    assert sup.counters["solve_fallbacks"] == 0 and sup.counters["salvaged"] == 0
    assert sup.circuit_state() == "closed"


SERIES = ("SOLVE_DEADLINE_EXCEEDED", "SOLVER_CIRCUIT_STATE", "SOLVER_FALLBACK", "SOLVER_RETRIES",
          "VALIDATOR_REJECTIONS", "SERVE_ACTIVE", "SERVE_ADMISSION", "SERVE_BATCH", "SERVE_CYCLE_SECONDS",
          "SERVE_CYCLES", "SERVE_FAIRNESS_DEFICIT", "SERVE_POOL", "SERVE_QUEUE_DEPTH")


def test_metric_series_match_the_jax_package():
    """The supervisor's and the serve layer's series carry the JAX
    package's names, kinds and buckets, and one rejected, failed-over solve
    of a tenant moves the same series by the same amounts under the same
    labels."""
    jreg = importlib.import_module("karpenter_tpu.metrics.registry")
    treg = importlib.import_module("karpenter_tpu_torch.metrics.registry")
    assert treg.DURATION_BUCKETS == jreg.DURATION_BUCKETS
    for name in SERIES:
        j, t = getattr(jreg, name), getattr(treg, name)
        assert (t.name, t.kind, getattr(t, "buckets", None)) == (j.name, j.kind, getattr(j, "buckets", None)), name

    def series(reg):
        return {(kind, name, tuple(sorted(labels.items()))): value for kind, name, labels, value in reg.REGISTRY.collect()
                if name in {getattr(reg, n).name for n in SERIES} and kind != "histogram"}

    def scenario(s, reg):
        before = series(reg)
        pods, its, tpls = small_problem(s)
        sup = s.sup.SupervisedSolver(LyingSolver(s.Oracle()), fallback=s.Oracle(), tenant="metrics-t")
        sup.solve(pods, its, tpls)
        after = series(reg)
        return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0) or k not in before}

    moved = scenario(JAX, jreg)
    assert scenario(PORT, treg) == moved
    assert any(name == "karpenter_validator_rejections_total" for _, name, _ in moved)
