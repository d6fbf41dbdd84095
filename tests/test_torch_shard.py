"""The partitioned solve (KARPENTER_TPU_SHARD, programs 13-14):
karpenter_tpu_torch's partition plans, sharded results and standdowns
against the JAX package's on the same inputs, on the CPU.

Both packages' inputs are drawn by the same generator code
(karpenter_tpu_torch.testing.workloads and its copy bound to karpenter_tpu,
tests/test_torch_encode.reference_workloads): the corpora of
tests/test_shard_parity.py. The JAX package runs on the 8 host CPU devices
of tests/conftest.py with its default one partition per device; the port
runs on one device with ``KARPENTER_TPU_SHARD_MIN_DEVICES=1`` and
``KARPENTER_TPU_SHARD_PARTITIONS=8``, so both plan 8 partitions.

Exact: partition plans (pod and node rows per part, reason, atomic and
splittable counts), node bindings, claims (template, instance types,
requirements, pod indices), failures, every integer of ``last_shard`` and
the per-lane verdicts and IterCounts of programs 13 and 14. Claim requests
within rel 1e-5 (the claim-request float sums, as tests/test_torch_solver.py
holds them); the summed Relax2Stats' two floats within rtol 1e-5 / atol 1e-6
(tests/test_torch_relax2.py's tolerance). Never compared: ``lanes`` and
``pad_frac`` (the JAX package pads the lane axis to its 8 devices, the port
runs one lane per partition) and the port's own ``part_pods``.
"""

import dataclasses
import os
import random
import types

import numpy as np
import pytest

import karpenter_tpu.parallel.mesh as j_mesh
import karpenter_tpu.shard.solve as j_shard_solve
from karpenter_tpu import shard as j_shard
from karpenter_tpu.apis import labels as j_wk
from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as J_LABELS
from karpenter_tpu.provisioning.topology import Topology as JTopology
from karpenter_tpu.solver.encode import domains_from_instance_types as j_domains
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu_torch import shard
from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.metrics.registry import SHARD_FALLBACK
from karpenter_tpu_torch.ops import relax2
from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state
from karpenter_tpu_torch.ops.ffd_sweeps import solve_ffd_sweeps, solve_ffd_sweeps_carried
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.shard import solve as shard_solve
from karpenter_tpu_torch.solver.encode import domains_from_instance_types
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import workloads as port_workloads
from tests.test_torch_encode import reference_workloads
from tests.test_torch_solver import assert_same_results
import tests.torch_threads  # noqa: F401  (one intra-op thread)

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-6
SHARD_ENV = ("KARPENTER_TPU_SHARD", "KARPENTER_TPU_SHARD_MIN_PODS", "KARPENTER_TPU_SHARD_MIN_DEVICES",
             "KARPENTER_TPU_SHARD_PARTITIONS", "KARPENTER_TPU_SHARD_MERGE", "KARPENTER_TPU_SHARD_MAX_PART_PODS",
             "KARPENTER_TPU_RELAX2", "KARPENTER_TPU_EXPLAIN")
# the keys of last_shard whose values depend on the lane axis' padding, and
# the port's own record of the wavefront's extra lanes (the JAX package keeps
# that in its program registry)
UNCOMPARED = ("lanes", "pad_frac", "part_pods", "wavefront")

# tests/test_shard_parity.py's runtime corpora: three seeds each of the
# plain, topology and ports fuzz (<= 48 pods), the claim-heavy merge batch
# and the sharded convex corpus (160 fleet pods)
CORPORA = {
    **{f"plain-{s}": (lambda s: lambda m: m.shard_plain_workload(s))(s) for s in range(3)},
    **{f"topology-{s}": (lambda s: lambda m: m.shard_topology_workload(s))(s) for s in range(3)},
    **{f"ports-{s}": (lambda s: lambda m: m.shard_ports_workload(s))(s) for s in range(3)},
    "claims-40": lambda m: m.shard_claims_workload(),
}
RELAX2_CORPUS = lambda m: m.shard_relax2_workload()  # noqa: E731
RELAX2_ENV = {"KARPENTER_TPU_RELAX2": "1", "KARPENTER_TPU_SHARD_MIN_PODS": "20"}


class _Env:
    """Sets the shard knobs for one solve and restores the environment."""

    def __init__(self, **env):
        self.env = {"KARPENTER_TPU_SHARD": "1", "KARPENTER_TPU_SHARD_MIN_PODS": "2",
                    "KARPENTER_TPU_SHARD_MIN_DEVICES": "1", "KARPENTER_TPU_SHARD_PARTITIONS": "8", **env}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in (*SHARD_ENV, *self.env)}
        for k in SHARD_ENV:
            os.environ.pop(k, None)
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _recording(module, name, sink):
    """Wrap ``module.name`` (a program entry) so that each call's arguments
    and result land in ``sink``; returns the original to restore."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        sink.append((args, out))
        return out

    setattr(module, name, wrapped)
    return orig


def _solve_jax(workload, env, **solver_args):
    """The JAX package's sharded solve, with each dispatched program's
    per-lane verdicts and IterCounts recorded."""
    lanes = []
    orig = {}

    def program(name):
        make = getattr(j_mesh, name)
        orig[name] = make

        def factory(*a, **kw):
            fn = make(*a, **kw)

            def run(batch):
                out = fn(batch)
                res = out[0] if isinstance(out, tuple) else out
                lanes.append((np.asarray(res.kind), np.asarray(res.index),
                              [tuple(int(x) for x in np.asarray(v)) for v in res.iters]))
                return out

            return run

        setattr(j_mesh, name, factory)

    for name in ("shard_sweeps_program", "shard_relax2_sweeps_program"):
        program(name)
    try:
        with _Env(**env):
            solver = JaxSolver(well_known=J_LABELS, **solver_args)
            result = solver.solve(*workload)
    finally:
        for name, fn in orig.items():
            setattr(j_mesh, name, fn)
    return solver, result, lanes


def _solve_port(workload, env, **solver_args):
    lanes = []
    restore = {name: _recording(mesh, name, lanes) for name in ("shard_sweeps", "shard_relax2_sweeps")}
    try:
        with _Env(**env):
            solver = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", **solver_args)
            result = solver.solve(*workload)
    finally:
        for name, fn in restore.items():
            setattr(mesh, name, fn)
    return solver, result, lanes


def _both(draw, **env):
    jw, tw = draw(reference_workloads), draw(port_workloads)
    js, jr, jl = _solve_jax(jw, env)
    ts, tr, tl = _solve_port(tw, env)
    return types.SimpleNamespace(js=js, jr=jr, jlanes=jl, ts=ts, tr=tr, tlanes=tl, tw=tw)


@pytest.fixture(scope="module")
def solved():
    """Each corpus solved once by each package with merge on (shared by the
    result, lane and program tests)."""
    return {name: _both(draw) for name, draw in CORPORA.items()}


def assert_same_shard(js, ts):
    j = {k: v for k, v in js.last_shard.items() if k not in UNCOMPARED}
    t = {k: v for k, v in ts.last_shard.items() if k not in UNCOMPARED}
    assert t == j


# -- partition plans -----------------------------------------------------------


def _groups(topology_cls, domains_fn, pods, its, tpls, nodes, hostname_key):
    topo = topology_cls(domains_fn(its, tpls), batch_pods=list(pods), cluster_pods=[])
    for n in nodes:
        topo.register(hostname_key, n.name)
    return list(topo.topologies.values()) + list(topo.inverse_topologies.values())


def _plan_key(plan):
    return ([(p.pod_idx, p.node_idx) for p in plan.parts], plan.reason, plan.atomic_components,
            plan.splittable_pods, plan.dropped_nodes)


def _unit_corpora(m):
    """tests/test_shard_parity.py's TestPartitioner inputs, drawn through
    ``m`` (either package's workloads module): (pods, templates, nodes,
    n_parts)."""
    from_labels = m.make_node
    its = m.instance_types(4)
    tpl = m.simple_template(its)
    budget = m.simple_template(its)
    budget.remaining_resources = {"cpu": 40.0}
    zone2 = {m.wk.LABEL_TOPOLOGY_ZONE: "test-zone-2"}
    tol = [m.Toleration(key="t", operator="Exists")]
    return {
        "splittable-17": ([m.make_pod(i) for i in range(17)], [tpl], [], 4),
        "node-sharers": ([m.make_pod(0), m.make_pod(1, tolerations=tol)]
                         + [m.make_pod(i, selector=zone2) for i in (2, 3)],
                         [tpl], [from_labels("n1", zone="test-zone-1")], 4),
        "unreachable-node": ([m.make_pod(i) for i in range(4)], [tpl],
                             [from_labels("n1", taints=[m.Taint(key="no", effect="NoSchedule")])], 4),
        "budget-glue": ([m.make_pod(i) for i in range(4)] + [m.make_pod(i, selector=zone2) for i in (4, 5)],
                        [budget], [], 4),
        "anchored-monolith": ([m.make_pod(i) for i in range(6)], [tpl], [from_labels("n1")], 4),
        "tiny": ([m.make_pod(0)], [tpl], [], 4),
    }


@pytest.mark.parametrize("name", ["splittable-17", "node-sharers", "unreachable-node", "budget-glue",
                                  "anchored-monolith", "tiny"])
def test_partition_plan_units_match_jax(name):
    jp, jt, jn, k = _unit_corpora(reference_workloads)[name]
    tp, tt, tn, _ = _unit_corpora(port_workloads)[name]
    assert _plan_key(shard.partition_pods(tp, tt, tn, [], k)) == _plan_key(j_shard.partition_pods(jp, jt, jn, [], k))


@pytest.mark.parametrize("name", list(CORPORA) + ["relax2-fleet-160"])
def test_partition_plan_corpora_match_jax(name):
    draw = CORPORA.get(name, RELAX2_CORPUS)
    (jp, jits, jtpls, jnodes), (tp, tits, ttpls, tnodes) = draw(reference_workloads), draw(port_workloads)
    jg = _groups(JTopology, j_domains, jp, jits, jtpls, jnodes, j_wk.LABEL_HOSTNAME)
    tg = _groups(Topology, domains_from_instance_types, tp, tits, ttpls, tnodes, wk.LABEL_HOSTNAME)
    jplan = j_shard.partition_pods(jp, jtpls, jnodes, jg, 8)
    tplan = shard.partition_pods(tp, ttpls, tnodes, tg, 8)
    assert _plan_key(tplan) == _plan_key(jplan)
    assert tplan.reason is not None or len(tplan.parts) >= 2


# -- sharded results -----------------------------------------------------------


@pytest.mark.parametrize("name", list(CORPORA))
def test_shard_results_match_jax(solved, name):
    r = solved[name]
    assert r.ts.last_shard["reason"] is None and r.ts.last_shard["gate_rejections"] == 0
    assert_same_shard(r.js, r.ts)
    assert_same_results(r.jr, r.tr)
    assert r.ts.last_shard["lanes"] == r.ts.last_shard["partitions"]
    pods = r.tw[0]
    placed = sorted(i for c in r.tr.new_claims for i in c.pod_indices)
    placed += sorted(i for v in r.tr.node_pods.values() for i in v)
    assert sorted(placed + list(r.tr.failures)) == list(range(len(pods)))


@pytest.mark.parametrize("name", list(CORPORA))
def test_shard_program_lanes_match_jax(solved, name):
    """Program 13, lane by lane: the port's per-lane verdicts and IterCounts
    equal the JAX program's on every real lane of every dispatch (the claim
    ladder's re-dispatches included)."""
    r = solved[name]
    parts = r.ts.last_shard["partitions"]
    assert len(r.tlanes) == len(r.jlanes) >= 1
    for (args, results), (jkind, jindex, jiters) in zip(r.tlanes, r.jlanes):
        assert len(results) == parts
        for b, res in enumerate(results):
            np.testing.assert_array_equal(res.kind.numpy(), jkind[b])
            np.testing.assert_array_equal(res.index.numpy(), jindex[b])
            assert tuple(res.iters) == tuple(it[b] for it in jiters)


def test_shard_merge_off_matches_jax():
    for name in ("claims-40", "plain-0"):
        r = _both(CORPORA[name], KARPENTER_TPU_SHARD_MERGE="0")
        assert r.ts.last_shard["reason"] is None and r.ts.last_shard["merged_claims"] == 0
        assert_same_shard(r.js, r.ts)
        assert_same_results(r.jr, r.tr)


def test_shard_claim_escalation_matches_jax():
    """NO_SLOT in any lane re-dispatches every lane at the next claim bucket:
    96 pods of 3 cpu on one 4-cpu type (one pod a claim, 12 claims a lane
    against the first bucket's 8) take the same ladder, lanes and result as
    the JAX package's."""
    def corpus(m):
        one = [m.make_instance_type("one")]
        return [m.make_pod(i, cpu=3.0) for i in range(96)], one, [m.simple_template(one)], []

    jw, tw = corpus(reference_workloads), corpus(port_workloads)
    js, jr, jl = _solve_jax(jw, {}, initial_claim_slots=1)
    ts, tr, tl = _solve_port(tw, {}, initial_claim_slots=1)
    assert ts.claim_escalations == js.claim_escalations >= 1
    assert ts.claim_slots == js.claim_slots
    assert len(tl) == len(jl) == ts.claim_escalations + 1
    for (args, results), (jkind, jindex, jiters) in zip(tl, jl):
        for b, res in enumerate(results):
            np.testing.assert_array_equal(res.kind.numpy(), jkind[b])
            assert tuple(res.iters) == tuple(it[b] for it in jiters)
    assert_same_shard(js, ts)
    assert_same_results(jr, tr)


def test_shard_merge_joins_claims(solved):
    r = solved["claims-40"]
    assert r.ts.last_shard["merged_claims"] >= 1


def test_shard_relax2_matches_jax():
    """Program 14 through the sharded solve: results, last_shard, the summed
    Relax2Stats (integers exact, the two floats within tolerance) and the
    per-lane repair verdicts and IterCounts."""
    r = _both(RELAX2_CORPUS, **RELAX2_ENV)
    assert r.ts.last_shard["reason"] is None
    assert_same_shard(r.js, r.ts)
    assert_same_results(r.jr, r.tr)
    j2, t2 = dict(r.js.last_relax2), dict(r.ts.last_relax2)
    assert t2["reason"] is None and t2["sharded"] is True and t2["placed"] > 0 and t2["demoted"] > 0
    floats = ("residual", "capviol")
    np.testing.assert_allclose([t2.pop(k) for k in floats], [j2.pop(k) for k in floats],
                               rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    j2["lanes"] = t2["lanes"]  # the JAX package counts its padded lanes
    assert t2 == j2
    parts = r.ts.last_shard["partitions"]
    for (args, (results, stats)), (jkind, jindex, jiters) in zip(r.tlanes, r.jlanes):
        assert len(results) == len(stats) == parts
        for b, res in enumerate(results):
            np.testing.assert_array_equal(res.kind.numpy(), jkind[b])
            np.testing.assert_array_equal(res.index.numpy(), jindex[b])
            assert tuple(res.iters) == tuple(it[b] for it in jiters)


def test_lanes_plain_twins_equal_single_solves(solved):
    """The plain twins of programs 13 and 14 equal the single-solve entries
    (solve_ffd_sweeps, relax2_place + solve_ffd_sweeps_carried) on each lane
    of a recorded stack."""
    (batch, C), results = solved["plain-0"].tlanes[0]
    for b, res in enumerate(results):
        single = solve_ffd_sweeps(mesh.lane_problem(batch, b), C)
        assert res.kind.tolist() == single.kind.tolist() and res.index.tolist() == single.index.tolist()
        assert tuple(res.iters) == tuple(single.iters)
    r = _solve_port(RELAX2_CORPUS(port_workloads), RELAX2_ENV)
    (batch, C, iters, step), (results, stats) = r[2][0]
    for b in (0, len(results) - 1):
        p = mesh.lane_problem(batch, b)
        out = relax2.relax2_place_plain(p, C, iters, step)
        residue, state = _lane_align(dataclasses.replace(p, pod_active=out.residue_active), out.state)
        single = solve_ffd_sweeps_carried(residue, C, (out.state, out.kind, out.index))
        assert results[b].kind.tolist() == single.kind.tolist()
        assert results[b].index.tolist() == single.index.tolist()
        assert relax2.host_stats(stats[b]) == relax2.host_stats(out.stats)
    assert initial_state(mesh.lane_problem(batch, 0), C).claim_open.shape[0] == C


# -- standdowns ----------------------------------------------------------------


def _standdown_pair(j_draw, t_draw, **env):
    js, jr, _ = _solve_jax(j_draw, env)
    ts, tr, _ = _solve_port(t_draw, env)
    return js, jr, ts, tr


def _fallback_corpus(m, kind):
    its = m.instance_types(4)
    tpl = m.simple_template(its)
    if kind == "plain":
        return [m.make_pod(i) for i in range(12)], its, [tpl], []
    if kind == "small":
        return [m.make_pod(i) for i in range(6)], its, [tpl], []
    if kind == "relaxable":
        pods = [m.make_pod(i) for i in range(10)] + [m.shard_spread_pod(10, "a", when=m.SCHEDULE_ANYWAY)]
        return pods, its, [tpl], []
    if kind == "monolith":
        return [m.make_pod(i) for i in range(12)], its, [tpl], [m.make_node("n1", cpu=64.0)]
    if kind == "budget":
        tpl.remaining_resources = {"cpu": 100.0}
        zone2 = {m.wk.LABEL_TOPOLOGY_ZONE: "test-zone-2"}
        return [m.make_pod(i) for i in range(8)] + [m.make_pod(i, selector=zone2) for i in range(8, 16)], its, [tpl], []
    if kind == "one-type":
        one = [m.make_instance_type("one")]
        return [m.make_pod(i, cpu=3.0) for i in range(16)], one, [m.simple_template(one)], []
    raise ValueError(kind)


STANDDOWNS = {
    "small-batch": ("small", {"KARPENTER_TPU_SHARD_MIN_PODS": "512"}),
    "single-device": ("plain", {"KARPENTER_TPU_SHARD_MIN_DEVICES": "16"}),
    "relaxable": ("relaxable", {}),
    "unsupported-args": ("plain", {"KARPENTER_TPU_EXPLAIN": "1"}),
    "single-partition": ("monolith", {}),
    "cross-partition-claims": ("budget", {}),
}


@pytest.mark.parametrize("reason", list(STANDDOWNS))
def test_standdown_reasons_match_jax(reason):
    kind, env = STANDDOWNS[reason]
    js, jr, ts, tr = _standdown_pair(_fallback_corpus(reference_workloads, kind),
                                     _fallback_corpus(port_workloads, kind), **env)
    assert js.last_shard["reason"] == reason
    assert ts.last_shard == js.last_shard
    if reason == "unsupported-args":
        from karpenter_tpu_torch.obs import explain

        explain.set_enabled(None)
        explain.reset_ring()
    # transparent: the unsharded path serves, as the JAX package's does
    assert sorted(i for c in tr.new_claims for i in c.pod_indices) == \
        sorted(i for c in jr.new_claims for i in c.pod_indices)
    assert tr.failures == jr.failures


def test_standdown_injected_reasons_match_jax(monkeypatch):
    """The defence-in-depth reasons no natural input reaches, forced by the
    same surgical injection on both packages."""
    from karpenter_tpu import verify as j_verify
    from karpenter_tpu_torch import verify

    plain = (_fallback_corpus(reference_workloads, "plain"), _fallback_corpus(port_workloads, "plain"))
    one_type = (_fallback_corpus(reference_workloads, "one-type"), _fallback_corpus(port_workloads, "one-type"))
    cases = {
        "shape-mismatch": (plain, [(j_shard_solve, shard_solve, "_tree_shapes",
                                    lambda: (lambda c: lambda problem: next(c))(iter(range(10**6))))]),
        "slot-overflow": (one_type, [(j_shard_solve, shard_solve, "claim_axis_bucket", lambda: lambda n: 1)]),
        "merge-rejected": (plain, [(j_verify, verify, "full_gate",
                                    lambda: lambda *a, **kw: types.SimpleNamespace(violations=["forced"]))]),
        "error": (plain, [(j_shard_solve, shard_solve, "partition_pods", lambda: _boom)]),
    }
    before = SHARD_FALLBACK.value({"reason": "error"})
    for reason, ((jw, tw), patches) in cases.items():
        with monkeypatch.context() as m:
            for jmod, tmod, attr, make in patches:
                m.setattr(jmod, attr, make())
                m.setattr(tmod, attr, make())
            js, jr, ts, tr = _standdown_pair(jw, tw)
        assert js.last_shard["reason"] == reason, js.last_shard
        assert ts.last_shard == js.last_shard
        assert sorted(i for c in tr.new_claims for i in c.pod_indices) == \
            sorted(i for c in jr.new_claims for i in c.pod_indices)
    assert SHARD_FALLBACK.value({"reason": "error"}) == before + 1
    assert set(STANDDOWNS) | set(cases) == set(shard.REASONS) == set(j_shard.REASONS)


def _boom(*a, **kw):
    raise RuntimeError("forced partitioner failure")


def test_flag_off_never_attempts():
    its = port_workloads.instance_types(4)
    s = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu")
    s.solve([port_workloads.make_pod(i) for i in range(8)], its, [port_workloads.simple_template(its)])
    assert s.last_shard is None


# -- the fleet corpus ----------------------------------------------------------


def test_make_fleet_pods_draws_like_the_bench():
    from bench import make_fleet_pods

    def key(pods):
        return [(p.metadata.name, p.metadata.labels, repr(p.spec)) for p in pods]

    want = make_fleet_pods(2000, random.Random(42), 32)
    got = port_workloads.make_fleet_pods(2000, random.Random(42), 32)
    assert key(got) == key(want)
    assert key(reference_workloads.make_fleet_pods(2000, random.Random(42), 32)) == key(want)
