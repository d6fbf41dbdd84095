"""The port's serve replicas (karpenter_tpu_torch/serve/replica.py,
parallel/mesh.carve_meshes) against the JAX package's.

tests/test_serve_fleet.py's ``TestCarveMeshes`` / ``TestReplicaSet`` and
tests/test_mesh_health.py's ReplicaSet cases (:232, :265, :320), over
explicit device lists and fake solvers: the same carves (by device id), the
same placements and reasons, the same failover moves and the same
``serve_replica_placements_total`` increments as the JAX package. Then two
replicas serving at once on the plain path, each tenant's placements equal
to its own solver's alone. Exact throughout.
"""

from __future__ import annotations

import zlib

import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu_torch.parallel import mesh as pmesh
from karpenter_tpu_torch.serve.dispatcher import STATUS_OK
from karpenter_tpu_torch.serve.replica import FAILOVER_SEED_S, PLACE_FAILOVER, ReplicaSet


class _StubResult:
    new_claims = ()
    node_pods: dict = {}
    failures: dict = {}

    def num_scheduled(self):
        return 0


class _RecordingSolver:
    def __init__(self, tenant, log):
        self.tenant = tenant
        self.log = log

    def solve(self, pods, its, tpls, **kwargs):
        self.log.append(self.tenant)
        return _StubResult()


def _ids(devices):
    return [int(getattr(d, "id", None) if getattr(d, "id", None) is not None else d.index) for d in devices]


def _jax_carve(n, devices=None):
    from karpenter_tpu.parallel.mesh import carve_meshes

    return [None if m is None else tuple(_ids(m.devices.flat)) for m in carve_meshes(n, devices=devices)]


def _port_carve(n, devices=None):
    return [None if m is None else tuple(_ids(m)) for m in pmesh.carve_meshes(n, devices=devices)]


def _cards(ids):
    return [torch.device("cuda", i) for i in ids]


# -- carve_meshes (tests/test_serve_fleet.py TestCarveMeshes) ----------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9])
def test_carve_equals_the_jax_packages(n):
    import jax

    assert len(jax.devices()) == 8  # conftest's 8-device host
    assert _port_carve(n, _cards(range(8))) == _jax_carve(n)


def test_contiguous_balanced_carve():
    three = pmesh.carve_meshes(3, devices=_cards(range(8)))
    assert [len(m) for m in three] == [3, 3, 2]
    assert [d for m in three for d in m] == _cards(range(8))
    assert all(m is None for m in pmesh.carve_meshes(8, devices=_cards(range(8))))
    assert len(pmesh.carve_meshes(1, devices=_cards(range(8)))[0]) == 8
    assert pmesh.carve_meshes(2, devices=[]) == [None, None]


def test_carve_deterministic_under_shrunken_list():
    import random

    import jax

    survivors = [i for i in range(8) if i != 1]
    baseline = _port_carve(3, _cards(survivors))
    for seed in range(5):
        shuffled = list(survivors)
        random.Random(seed).shuffle(shuffled)
        assert _port_carve(3, _cards(shuffled)) == baseline
    assert baseline == _jax_carve(3, [d for d in jax.devices() if int(d.id) != 1])


def test_carve_health_aware(monkeypatch):
    """Without a device list the carve takes the healthy CUDA devices
    (parallel/mesh.healthy_devices), as the JAX package takes its healthy
    devices."""
    from karpenter_tpu_torch.solver import mesh_health as mh

    monkeypatch.setenv("KARPENTER_TPU_MESH_HEALTH", "1")
    monkeypatch.setattr(mh, "local_devices", lambda device=None: _cards(range(8)))
    mh.reset()
    try:
        mh.tracker().report_failure(2, mh.REASON_DEVICE_LOST)
        for m in pmesh.carve_meshes(2):
            assert 2 not in _ids(m)
        assert len(pmesh.healthy_devices()) == 7
    finally:
        mh.reset()


# -- placement (tests/test_serve_fleet.py TestReplicaSet) ---------------------------


def _make(pkg, n=3):
    if pkg == "port":
        return ReplicaSet(n_replicas=n, meshes=[None] * n, solver_factory=lambda t: _RecordingSolver(t, []),
                          batching=False, big_tenant_pods=100, max_tenants=64, device="cpu")
    from karpenter_tpu.serve.replica import ReplicaSet as JReplicaSet

    return JReplicaSet(n_replicas=n, meshes=[None] * n, solver_factory=lambda t: _RecordingSolver(t, []),
                       batching=False, big_tenant_pods=100, max_tenants=64)


def _placements_counter(pkg):
    import importlib

    reg = importlib.import_module(("karpenter_tpu_torch" if pkg == "port" else "karpenter_tpu") + ".metrics.registry")
    return {lbl["reason"]: v for _, _, lbl, v in reg.SERVE_REPLICA_PLACEMENTS.collect()}


def _moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_placement_reasons_classified_and_sticky():
    out = {}
    for pkg in ("jax", "port"):
        before = _placements_counter(pkg)
        rs = _make(pkg, 3)
        try:
            decisions = [rs.place("pinme", pinned=2), rs.place("whale", expected_pods=500),
                         rs.place("small", expected_pods=4), rs.place("whale", expected_pods=1)]
            out[pkg] = (decisions, rs.snapshot()["placement_reasons"], _moved(before, _placements_counter(pkg)))
        finally:
            rs.close()
    assert out["port"] == out["jax"]
    decisions, reasons, moved = out["port"]
    assert decisions == [(2, "pinned"), (0, "big-tenant"), (zlib.crc32(b"small") % 3, "hash"), (0, "big-tenant")]
    assert reasons == {"pinned": 1, "big-tenant": 1, "hash": 1} == moved


def test_submit_routes_and_serves():
    rs = _make("port", 2)
    try:
        rs.start()
        tickets = [rs.submit(f"t{i}", [object()], [], []) for i in range(8)]
        assert all(t.wait(30.0).status == STATUS_OK for t in tickets)
        placed = rs.placements()
        assert len(placed) == 8 and {r for _, r in placed.values()} <= {"pinned", "big-tenant", "hash"}
        assert rs.summary()["completed"] >= 8 and rs.healthy()
        assert [r.name for r in rs.replicas] == ["r0", "r1"]
    finally:
        rs.close()


def test_mesh_count_mismatch_rejected():
    with pytest.raises(ValueError):
        ReplicaSet(n_replicas=2, meshes=[None], solver_factory=lambda t: _RecordingSolver(t, []), device="cpu")


def test_replica_devices_and_knobs(monkeypatch):
    """A slice of two or more devices puts its replica on its first card; a
    None slice keeps the service's device. The knobs read the JAX package's
    names and defaults."""
    from karpenter_tpu import serve as jserve
    from karpenter_tpu_torch import serve

    assert ReplicaSet._service_kwargs(_cards((2, 3)), {"device": "cpu", "batching": False}) == {
        "device": torch.device("cuda", 2), "batching": False}
    assert ReplicaSet._service_kwargs(None, {"device": "cpu"}) == {"device": "cpu"}
    rs = ReplicaSet(n_replicas=1, solver_factory=lambda t: _RecordingSolver(t, []), device="cpu")
    assert rs.meshes == [None] and rs.replicas[0].device.type == "cpu"
    rs.close()
    for env in ({}, {"KARPENTER_TPU_SERVE_REPLICAS": "3", "KARPENTER_TPU_SERVE_BIG_PODS": "64"},
                {"KARPENTER_TPU_SERVE_REPLICAS": "x", "KARPENTER_TPU_SERVE_BIG_PODS": "0"}):
        for k in ("KARPENTER_TPU_SERVE_REPLICAS", "KARPENTER_TPU_SERVE_BIG_PODS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert (serve.replicas(), serve.big_tenant_pods()) == (jserve.replicas(), jserve.big_tenant_pods())


# -- failover (tests/test_mesh_health.py :232, :265) --------------------------------


def test_replica_failover_tenant_accounting():
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "port":
            rs = ReplicaSet(n_replicas=3, meshes=[None, None, None], batching=False, device="cpu")
        else:
            from karpenter_tpu.serve.replica import ReplicaSet as JReplicaSet

            rs = JReplicaSet(n_replicas=3, meshes=[None, None, None], batching=False)
        before = _placements_counter(pkg)
        for i in range(9):
            rs.place(f"t{i}")
        victims = sorted(t for t, (idx, _) in rs.placements().items() if idx == 1)
        moved = rs.failover(1)
        again = rs.failover(1)
        later = [rs.place(f"t{i}")[0] for i in range(20, 40)]
        seeded = [rs.replicas[i]._wait.per_request_s() for i in (0, 2)]
        out[pkg] = dict(victims=victims, moved=moved, again=again, placements=rs.placements(), later=later,
                        snapshot={k: rs.snapshot()[k] for k in ("failovers", "dead_replicas", "placement_reasons")},
                        counter=_moved(before, _placements_counter(pkg)), healthy=rs.healthy())
        assert all(s >= FAILOVER_SEED_S for s in seeded)
        rs.close()
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["victims"] and sorted(port["moved"]) == port["victims"] and port["again"] == {}
    assert all(port["placements"][t] in ((0, PLACE_FAILOVER), (2, PLACE_FAILOVER)) for t in port["victims"])
    assert 1 not in port["later"] and port["healthy"] and port["snapshot"]["dead_replicas"] == [1]
    assert port["counter"][PLACE_FAILOVER] == len(port["victims"])


def _shard_corpus(pkg, n=6):
    from tests.test_torch_encode import reference_workloads as RW
    from karpenter_tpu_torch.testing import workloads as W

    pods, its, tpls, _ = (W if pkg == "port" else RW).diverse_workload(n, 6)
    return pods, its, tpls


def test_failover_migrated_tenants_keep_serving():
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "port":
            from karpenter_tpu_torch.solver.oracle import OracleSolver

            rs = ReplicaSet(n_replicas=2, meshes=[None, None], batching=False, device="cpu").start()
        else:
            from karpenter_tpu.serve.replica import ReplicaSet as JReplicaSet
            from karpenter_tpu.solver.oracle import OracleSolver

            rs = JReplicaSet(n_replicas=2, meshes=[None, None], batching=False).start()
        pods, its, tpls = _shard_corpus(pkg)
        tenants = [f"s{i}" for i in range(4)]
        try:
            for tid in tenants:
                rs.register_tenant(tid, solver=OracleSolver())
            first = [rs.submit(t, pods, its, tpls) for t in tenants]
            assert all(x.wait(timeout=30).status == "ok" for x in first)
            moved = rs.failover(1)
            second = [rs.submit(t, pods, its, tpls).wait(timeout=30) for t in tenants]
            assert all(x.status == "ok" for x in second)
            out[pkg] = (sorted(moved), rs.placements(), [x.result.num_scheduled() for x in second])
            assert all(idx == 0 for idx, _ in rs.placements().values())
        finally:
            rs.close()
    assert out["port"] == out["jax"]


# -- two replicas busy at once ----------------------------------------------------


def test_two_replicas_serve_at_once_like_one_solver_each():
    """Two dispatcher threads solving at once on the plain path: every
    tenant's placements equal its own TorchSolver's alone, cycle by cycle
    (the shared state audited for the card: the libraries, the ordering and
    head caches, the context-variable overrides, the launch counts)."""
    import random

    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    its = instance_types(8)
    tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="serve")), its, range(len(its)))]
    rng = random.Random(99)
    tenants = [f"tenant-{t}" for t in range(4)]
    cycles = [[[default_pod_factory(f"sv-{c}-{t}-{i}", rng) for i in range(12)] for t in range(4)] for c in range(2)]

    def digest(result):
        return ([(c.template_index, list(c.pod_indices), list(c.instance_type_indices)) for c in result.new_claims],
                sorted((k, list(v)) for k, v in result.node_pods.items()), sorted(result.failures))

    want = {}
    for t, name in enumerate(tenants):
        solo = TorchSolver(device="cpu")
        for c, cycle in enumerate(cycles):
            want[(name, c)] = digest(solo.solve(cycle[t], its, tpls))
    rs = ReplicaSet(2, meshes=[None, None], device="cpu", batching=False).start()
    try:
        for t, name in enumerate(tenants):
            rs.place(name, pinned=t % 2)  # two tenants on each replica
            rs.register_tenant(name)
        assert sorted({idx for idx, _ in rs.placements().values()}) == [0, 1]
        for c, cycle in enumerate(cycles):
            tickets = [rs.submit(name, cycle[t], its, tpls) for t, name in enumerate(tenants)]
            for name, tk in zip(tenants, tickets):
                o = tk.wait(timeout=120)
                assert o.status == "ok" and digest(o.result) == want[(name, c)], (name, c)
    finally:
        rs.close()
