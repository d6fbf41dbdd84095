"""Multi-tenant solve service: karpenter_tpu_torch/serve/ on the CPU.

tests/test_serve.py's fake-solver cases with the same inputs and expected
counts (knobs, DWRR under skew, no banked credit, classified overload,
max-tenants, submit after close, the three deadline-inheritance cases, a
solver error classified), then the stacked path: the port's stacked_solve
against the JAX package's on the same 3-lane group (the same lanes batched,
the same placements per lane, validator-clean), the dispatcher stacking
compatible tenants, and a launch error in the stacked dispatch resolving the
group's tickets as ``error`` outcomes instead of re-serving them solo.
"""

import random
import threading
import time

import pytest
import torch

from karpenter_tpu.apis.nodepool import NodePool as JNodePool
from karpenter_tpu.apis.objects import ObjectMeta as JObjectMeta
from karpenter_tpu.cloudprovider.fake import instance_types as j_instance_types
from karpenter_tpu.serve import batch as j_batch
from karpenter_tpu.serve.dispatcher import Ticket as JTicket, _Request as JRequest
from karpenter_tpu.solver.encode import template_from_nodepool as j_template_from_nodepool
from karpenter_tpu.streaming.churn import default_pod_factory as j_default_pod_factory
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch import serve as serve_pkg
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import ObjectMeta
from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.serve import batch as xbatch
from karpenter_tpu_torch.serve.dispatcher import (
    STATUS_OK,
    STATUS_OVERLOADED,
    STATUS_PENDING,
    SolveService,
    Ticket,
    _Request,
)
from karpenter_tpu_torch.solver import validator as val
from karpenter_tpu_torch.solver.encode import template_from_nodepool
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.streaming.churn import default_pod_factory
from karpenter_tpu_torch.testing.workloads import make_pod

CPU = "cpu"


class _StubResult:
    new_claims = ()
    node_pods: dict = {}
    failures: dict = {}

    def num_scheduled(self):
        return 0


class _RecordingSolver:
    """Appends its tenant id to a shared log per solve; optionally blocks on
    a gate so the test can preload queues before the dispatcher runs."""

    def __init__(self, tenant, log, gate=None, delay=0.0):
        self.tenant = tenant
        self.log = log
        self.gate = gate
        self.delay = delay

    def solve(self, pods, instance_types, templates, **kwargs):
        if self.gate is not None:
            self.gate.wait(timeout=30.0)
        if self.delay:
            time.sleep(self.delay)
        self.log.append(self.tenant)
        return _StubResult()


def _pods(n):
    return [make_pod(i) for i in range(n)]


class TestKnobs:
    def test_disabled_by_default(self, monkeypatch):
        monkeypatch.delenv("KARPENTER_TPU_SERVE", raising=False)
        assert serve_pkg.enabled() is False
        monkeypatch.setenv("KARPENTER_TPU_SERVE", "1")
        assert serve_pkg.enabled() is True
        monkeypatch.setenv("KARPENTER_TPU_SERVE", "0")
        assert serve_pkg.enabled() is False

    def test_parse_weights_and_classes(self, monkeypatch):
        assert serve_pkg.parse_weights("a=4,b=1") == {"a": 4.0, "b": 1.0}
        # malformed entries are skipped, non-positive weights rejected
        assert serve_pkg.parse_weights("a=4,junk,b=0,c=-1,d=2.5") == {"a": 4.0, "d": 2.5}
        assert serve_pkg.parse_weights("") == {}
        monkeypatch.setenv("KARPENTER_TPU_SERVE_CLASSES", "gold=4,bronze=1")
        assert serve_pkg.parse_classes() == {"gold": 4.0, "bronze": 1.0}

    def test_defaults_and_current_service(self):
        assert (serve_pkg.max_tenants(), serve_pkg.queue_depth(), serve_pkg.quantum()) == (16, 8, 64.0)
        assert serve_pkg.batching_enabled() is True and serve_pkg.batch_lanes() == 8
        service = SolveService(batching=False, device=CPU)
        assert serve_pkg.current_service() is None
        service.start()
        try:
            assert serve_pkg.current_service() is service
        finally:
            service.close()
        assert serve_pkg.current_service() is None

    def test_service_and_tenant_stack_run_on_cuda_unless_asked(self):
        """The default tenant stack is a SupervisedSolver over TorchSolver;
        both it and the service run on CUDA unless given device="cpu"."""
        stack = serve_pkg.build_tenant_solver("t", device=CPU)
        assert type(stack.primary).__name__ == "TorchSolver" and stack.primary.device.type == "cpu"
        assert stack.tenant == "t"
        service = SolveService(device=CPU)
        assert service.register_tenant("u").solver.primary.device.type == "cpu"
        service.close()
        if torch.cuda.is_available():
            assert SolveService().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                SolveService()
            with pytest.raises(RuntimeError, match="device='cpu'"):
                serve_pkg.build_tenant_solver("t")


class TestFairness:
    def test_dwrr_serves_weighted_ratio_under_skew(self):
        """Two saturated streams with weights 3:1 complete work in a ~3:1
        ratio."""
        log = []
        gate = threading.Event()
        service = SolveService(queue_depth=16, quantum=1.0, batching=False, device=CPU)
        service.register_tenant("heavy", weight=3.0, solver=_RecordingSolver("heavy", log, gate))
        service.register_tenant("light", weight=1.0, solver=_RecordingSolver("light", log, gate))
        tickets = []
        try:
            for _ in range(12):
                tickets.append(service.submit("heavy", _pods(1), [], []))
                tickets.append(service.submit("light", _pods(1), [], []))
            gate.set()
            outs = [t.wait(timeout=30.0) for t in tickets]
        finally:
            service.close()
        assert all(o.status == STATUS_OK for o in outs)
        window = log[:12]
        heavy, light = window.count("heavy"), window.count("light")
        assert 8 <= heavy <= 10 and 2 <= light <= 4, window

    def test_idle_stream_does_not_bank_credit(self):
        log = []
        service = SolveService(queue_depth=16, quantum=1.0, batching=False, device=CPU)
        service.register_tenant("busy", solver=_RecordingSolver("busy", log))
        idle = service.register_tenant("idle", solver=_RecordingSolver("idle", log))
        try:
            tickets = [service.submit("busy", _pods(1), [], []) for _ in range(8)]
            assert all(t.wait(timeout=30.0).status == STATUS_OK for t in tickets)
        finally:
            service.close()
        assert idle.deficit == 0.0


class TestAdmission:
    def test_overload_resolves_every_ticket_classified(self):
        log = []
        service = SolveService(queue_depth=2, batching=False, device=CPU)
        service.register_tenant("flood", solver=_RecordingSolver("flood", log, delay=0.03))
        try:
            tickets = [service.submit("flood", _pods(1), [], []) for _ in range(12)]
            outs = [t.wait(timeout=30.0) for t in tickets]
        finally:
            service.close()
        assert all(o.status != STATUS_PENDING for o in outs)
        assert {o.status for o in outs} <= {STATUS_OK, STATUS_OVERLOADED}
        shed = [o for o in outs if o.status == STATUS_OVERLOADED]
        assert shed and all(o.reason.startswith("overloaded") for o in shed)

    def test_unregistered_tenant_past_capacity_is_classified(self):
        service = SolveService(max_tenants=1, batching=False, device=CPU)
        service.register_tenant("only", solver=_RecordingSolver("only", []))
        try:
            out = service.submit("stranger", _pods(1), [], []).wait(5.0)
        finally:
            service.close()
        assert (out.status, out.reason) == ("rejected", "rejected-max-tenants")

    def test_submit_after_close_is_classified(self):
        service = SolveService(batching=False, device=CPU)
        service.register_tenant("t", solver=_RecordingSolver("t", []))
        service.close()
        out = service.submit("t", _pods(1), [], []).wait(5.0)
        assert (out.status, out.reason) == ("rejected", "rejected-shutdown")
        assert service.healthy() is False


class TestDeadlineInheritance:
    class _Recorder:
        """A solver with a watchdog knob: records the deadline each solve
        ran under."""

        def __init__(self):
            self.deadline_s = 0.0
            self.seen = []

        def solve(self, pods, instance_types, templates, **kwargs):
            self.seen.append(self.deadline_s)
            return _StubResult()

    def _run(self, rec, tenant_deadline, request_deadline=None):
        service = SolveService(batching=False, device=CPU)
        service.register_tenant("d", deadline_s=tenant_deadline, solver=rec)
        try:
            return service.submit("d", _pods(1), [], [], deadline_s=request_deadline).wait(10.0)
        finally:
            service.close()

    def test_tenant_default_budget_reaches_the_watchdog(self):
        rec = self._Recorder()
        assert self._run(rec, 5.0).status == STATUS_OK
        assert len(rec.seen) == 1 and 0.0 < rec.seen[0] <= 5.0
        assert rec.deadline_s == 0.0  # restored afterwards

    def test_explicit_request_deadline_narrows_further(self):
        rec = self._Recorder()
        assert self._run(rec, 5.0, request_deadline=1.0).status == STATUS_OK
        assert 0.0 < rec.seen[0] <= 1.0

    def test_configured_watchdog_is_never_widened(self):
        rec = self._Recorder()
        rec.deadline_s = 0.2
        assert self._run(rec, 30.0).status == STATUS_OK
        assert rec.seen[0] <= 0.2 and rec.deadline_s == 0.2

    def test_solver_error_is_classified_not_fatal(self):
        class _Boom:
            def solve(self, *a, **k):
                raise RuntimeError("tenant solver exploded")

        log = []
        service = SolveService(batching=False, device=CPU)
        service.register_tenant("bad", solver=_Boom())
        service.register_tenant("good", solver=_RecordingSolver("good", log))
        try:
            bad = service.submit("bad", _pods(1), [], []).wait(10.0)
            good = service.submit("good", _pods(1), [], []).wait(10.0)
        finally:
            service.close()
        assert bad.status == "error" and "tenant solver exploded" in bad.reason
        assert good.status == STATUS_OK


# -- the stacked path -----------------------------------------------------------


def _group_inputs(seed=3, n_tenants=3, n_pods=4):
    """tests/test_serve.py's co-batch group: instance_types(5), one NodePool,
    4 default_pod_factory pods per tenant from random.Random(3), built in
    each package from its own objects."""
    its, jits = instance_types(5), j_instance_types(5)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="batch")), its, range(len(its)))
    jtpl = j_template_from_nodepool(JNodePool(metadata=JObjectMeta(name="batch")), jits, range(len(jits)))
    rng, jrng = random.Random(seed), random.Random(seed)
    group, jgroup = [], []
    for t in range(n_tenants):
        pods = [default_pod_factory(f"b{t}-{i}", rng) for i in range(n_pods)]
        jpods = [j_default_pod_factory(f"b{t}-{i}", jrng) for i in range(n_pods)]
        group.append(_Request(tenant=f"t{t}", pods=pods, instance_types=its, templates=[tpl], kwargs={},
                              deadline_s=0.0, submitted_at=0.0, ticket=Ticket(f"t{t}")))
        jgroup.append(JRequest(tenant=f"t{t}", pods=jpods, instance_types=jits, templates=[jtpl], kwargs={},
                               deadline_s=0.0, submitted_at=0.0, ticket=JTicket(f"t{t}")))
    return group, jgroup


def _placements_key(result):
    return (
        tuple((c.template_index, tuple(c.pod_indices), tuple(c.instance_type_indices), sorted(c.requests.items()))
              for c in result.new_claims),
        tuple(sorted((k, tuple(v)) for k, v in result.node_pods.items())),
        tuple(sorted(result.failures.items())),
    )


def test_stacked_solve_equals_the_jax_package():
    group, jgroup = _group_inputs()
    for req in group:
        assert xbatch.batchable(req, serve_pkg.build_tenant_solver(req.tenant, device=CPU))
    stats = {}
    results = xbatch.stacked_solve(group, device=CPU, stats=stats)
    jresults = j_batch.stacked_solve(jgroup, mesh=None)
    assert [r is not None for r in results] == [r is not None for r in jresults] == [True] * 3
    assert stats["lanes"] == [0, 1, 2] and stats["reasons"] == [None] * 3
    for req, res, jres in zip(group, results, jresults):
        assert _placements_key(res) == _placements_key(jres)
        assert res.num_scheduled() == len(req.pods) and not res.failures
        assert val.validate_result(res, list(req.pods), req.instance_types, req.templates, level="full") == []
        solo = TorchSolver(device=CPU).solve(req.pods, req.instance_types, req.templates)
        assert res.num_scheduled() == solo.num_scheduled()


def test_stacked_solve_classifies_its_standdowns():
    group, _ = _group_inputs()
    stats = {}
    assert xbatch.stacked_solve(group[:1], device=CPU, stats=stats) == [None]
    assert stats["reasons"] == [xbatch.STANDDOWN_SINGLE]
    # a lane of another padded shape (a bigger catalog) stands down alone
    odd = _Request(tenant="odd", pods=group[0].pods, instance_types=instance_types(40),
                   templates=[template_from_nodepool(NodePool(metadata=ObjectMeta(name="o")), instance_types(40),
                                                     range(40))],
                   kwargs={}, deadline_s=0.0, submitted_at=0.0, ticket=Ticket("odd"))
    stats = {}
    results = xbatch.stacked_solve(group[:2] + [odd], device=CPU, stats=stats)
    assert stats["reasons"] == [None, None, xbatch.STANDDOWN_SHAPE] and results[2] is None
    assert set(xbatch.STANDDOWNS) >= {r for r in stats["reasons"] if r}


class _CountingTorch(TorchSolver):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.calls = 0

    def solve(self, *a, **k):
        self.calls += 1
        return super().solve(*a, **k)


def _stacked_service(n_tenants=3):
    """A service whose 3 tenants' heads are queued before the dispatcher
    collects (the service lock is re-entrant: holding it keeps the
    dispatcher from picking the lead before its riders are queued)."""
    group, _ = _group_inputs(seed=5, n_tenants=n_tenants)
    service = SolveService(batching=True, device=CPU)
    solvers = {}
    for req in group:
        solvers[req.tenant] = _CountingTorch(device=CPU)
        service.register_tenant(req.tenant, solver=serve_pkg.build_tenant_solver(
            req.tenant, primary=solvers[req.tenant]))
    return service, group, solvers


def test_dispatcher_stacks_compatible_tenants():
    service, group, solvers = _stacked_service()
    try:
        with service._cond:
            tickets = [service.submit(r.tenant, r.pods, r.instance_types, r.templates) for r in group]
        outs = [tk.wait(timeout=120.0) for tk in tickets]
        totals = service.summary()
    finally:
        service.close()
    assert [o.status for o in outs] == [STATUS_OK] * 3
    assert [o.path for o in outs] == ["batched"] * 3
    assert totals["completed"] == 3 and totals["batched"] == 3
    assert all(s.calls == 0 for s in solvers.values())
    for req, out in zip(group, outs):
        assert out.result.num_scheduled() == len(req.pods)


def test_launch_error_in_the_stacked_dispatch_is_an_error_outcome(monkeypatch):
    """A kernel launch error in the stacked dispatch resolves every ticket of
    the group as ``error`` naming it; no tenant re-solves solo (the JAX
    package re-serves the group solo)."""

    def refused(batch, max_claims, passes=3):
        raise kernels.KernelDeviceError("runs_screen: CUDA launch error 700")

    monkeypatch.setattr(mesh, "batched_screen", refused)
    service, group, solvers = _stacked_service()
    try:
        with service._cond:
            tickets = [service.submit(r.tenant, r.pods, r.instance_types, r.templates) for r in group]
        outs = [tk.wait(timeout=60.0) for tk in tickets]
        totals = service.summary()
    finally:
        service.close()
    assert [o.status for o in outs] == ["error"] * 3
    assert all(o.reason == "KernelDeviceError: runs_screen: CUDA launch error 700" for o in outs)
    assert all(o.path == "batched" for o in outs)
    assert all(s.calls == 0 for s in solvers.values())
    assert totals["errors"] == 3 and totals["completed"] == 0
