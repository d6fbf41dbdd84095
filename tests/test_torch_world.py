"""The device-resident churn cycle of karpenter_tpu_torch against the JAX
package's (``TorchSolver(device_world=True)`` against ``JaxSolver`` with
``KARPENTER_TPU_DEVICE_WORLD=1, KARPENTER_TPU_RELAX=0``), on the CPU.

One seeded churn corpus (120 pods of ``default_pod_factory``, 12 instance
types, 3 nodes, 2 arrivals and 2 deletes a cycle, a spec change a cycle from
cycle 2, a node added at cycle 4) is drawn once per package and walked once.
Every check is exact (the leaves are integers, bools, or float32 rows copied
unchanged):

  * the churn stream: names, shapes, labels, delete positions;
  * the delta encode: every leaf, the meta, ``last_patch`` and
    ``last_rows_prev``, and the patched encode equal to a cold one;
  * ``build_patch_args`` equal to the JAX package's;
  * ``patch_world`` (its plain version, on CPU tensors) equal to the JAX
    package's ``_patch_world_jit`` on the same arguments, and the patched
    world in the kernels' layout equal to the cold encode's, on patches that
    permute rows and on one that does not;
  * the fused gate's counts equal to the JAX package's ``fused_gate_counts``
    on the same final state, clean and corrupted;
  * every cycle's placements equal to the legacy ``TorchSolver`` and to the
    JAX package's resident path, with the same outcome per cycle;
  * each ported standdown reason on its trigger, the reset hook, the
    synchronous mode, and a failing launch that raises and drops the world.
"""

import copy
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.apis.nodepool import NodePool as JNodePool
from karpenter_tpu.apis.objects import ObjectMeta as JObjectMeta
from karpenter_tpu.cloudprovider.fake import instance_types as j_instance_types
from karpenter_tpu.ops import fused as jfused
from karpenter_tpu.ops.padding import pad_problem as j_pad_problem
from karpenter_tpu.scheduling import Taints as JTaints
from karpenter_tpu.scheduling.requirements import label_requirements as j_label_requirements
from karpenter_tpu.solver.encode import Encoder as JEncoder
from karpenter_tpu.solver.encode import NodeInfo as JNodeInfo
from karpenter_tpu.solver.encode import template_from_nodepool as j_template_from_nodepool
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu.streaming import churn as jchurn
from karpenter_tpu.streaming.delta import DeltaEncoder as JDeltaEncoder
from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.objects import ObjectMeta, Taint, TopologySpreadConstraint
from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.models.problem import (
    numpy_fields,
    patch_args_from_numpy,
    problem_from_numpy,
    problem_to_torch,
    state_from_numpy,
)
from karpenter_tpu_torch.ops import fused
from karpenter_tpu_torch.ops.ffd_core import problem_bounds_free
from karpenter_tpu_torch.ops.padding import pad_problem
from karpenter_tpu_torch.scheduling import Taints, pod_requirements
from karpenter_tpu_torch.scheduling.requirements import label_requirements
from karpenter_tpu_torch.solver.encode import Encoder, NodeInfo, template_from_nodepool
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.streaming import churn, device_world
from karpenter_tpu_torch.streaming.delta import DeltaEncoder
from karpenter_tpu_torch.verify import device as gdev
from tests.test_torch_solver import assert_same_results
import tests.torch_threads  # noqa: F401  (one intra-op thread)

PODS, ITS, NODES, CYCLES, SLOTS = 120, 12, 3, 7, 32
SEED = 5


def _node(pkg, name):
    """One existing node, built the same way in either package."""
    info, req, taints = (
        (NodeInfo, label_requirements, Taints) if pkg == "port"
        else (JNodeInfo, j_label_requirements, JTaints)
    )
    return info(
        name=name, requirements=req({wk.LABEL_HOSTNAME: name}), taints=taints(()),
        available={"cpu": 8.0, "memory": 32e9, "pods": 40.0}, daemon_overhead={},
    )


def _catalog(pkg, pool="stream", limit=None):
    its = instance_types(ITS) if pkg == "port" else j_instance_types(ITS)
    np_cls, meta_cls, tpl_fn = (
        (NodePool, ObjectMeta, template_from_nodepool) if pkg == "port"
        else (JNodePool, JObjectMeta, j_template_from_nodepool)
    )
    tpl = tpl_fn(np_cls(metadata=meta_cls(name=pool)), its, range(len(its)))
    if limit is not None:
        tpl = dataclasses.replace(tpl, remaining_resources=limit)
    return its, [tpl]


def _spec_change(pod):
    p = copy.deepcopy(pod)
    p.spec.containers[0].requests["cpu"] = float(p.spec.containers[0].requests.get("cpu", 0.25)) + 0.25
    return p


def _stream(pkg):
    """The corpus's snapshots for one package: [(pods, nodes)] per cycle."""
    mod = churn if pkg == "port" else jchurn
    rng = random.Random(SEED)
    initial = [mod.default_pod_factory(f"base-{i}", rng) for i in range(PODS)]
    proc = mod.ChurnProcess(initial, config=mod.ChurnConfig(seed=SEED, arrivals_per_cycle=2, deletes_per_cycle=2))
    nodes = [_node(pkg, f"n-{i}") for i in range(NODES)]
    edit = random.Random(SEED + 1)
    out = []
    for cycle in range(CYCLES):
        if cycle:
            proc.step()
        if cycle >= 2:
            idx = edit.randrange(len(proc.pods))
            proc.pods[idx] = _spec_change(proc.pods[idx])
        if cycle == 4:
            nodes = nodes + [_node(pkg, "n-new")]
        out.append((list(proc.pods), list(nodes), proc))
    return out


def _fields_equal(a, b, ctx):
    fa, fb = numpy_fields(a), numpy_fields(b)
    assert fa.keys() == fb.keys(), ctx
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=f"{ctx}: {key}")


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _world_equal(t, ref, ctx):
    """Bit for bit (lane_numeric holds NaNs)."""
    assert t.keys() == ref.keys(), ctx
    for key in ref:
        assert t[key].dtype == ref[key].dtype and torch.equal(_bits(t[key]), _bits(ref[key])), f"{ctx}: {key}"


def _cold_world(pods, its, tpls, nodes):
    enc = Encoder().encode(pods, its, tpls, nodes=nodes, num_claim_slots=SLOTS)
    return fused.world_tensors(problem_to_torch(pad_problem(enc.problem), "cpu"))


@pytest.fixture(scope="module")
def corpus():
    """The corpus walked once through both packages' delta encoders."""
    its, tpls = _catalog("port")
    jits, jtpls = _catalog("jax")
    port, ref = _stream("port"), _stream("jax")
    enc, jenc = DeltaEncoder(), JDeltaEncoder()
    cycles = []
    prev = jprev = None
    for (pods, nodes, _), (jpods, jnodes, _) in zip(port, ref):
        e = enc.encode(pods, its, tpls, nodes=nodes, num_claim_slots=SLOTS)
        je = jenc.encode(jpods, jits, jtpls, nodes=jnodes, num_claim_slots=SLOTS)
        cycles.append(dict(
            pods=pods, nodes=nodes, jpods=jpods, jnodes=jnodes, enc=e, jenc=je,
            patch=dict(enc.last_patch), jpatch=dict(jenc.last_patch),
            rows_prev=enc.last_rows_prev, jrows_prev=jenc.last_rows_prev,
            prev=prev, jprev=jprev,
        ))
        prev, jprev = pad_problem(e.problem), j_pad_problem(je.problem)
    return dict(its=its, tpls=tpls, jits=jits, jtpls=jtpls, cycles=cycles, port=port, ref=ref)


def test_churn_stream_matches_jax(corpus):
    for cycle, ((pods, _, proc), (jpods, _, jproc)) in enumerate(zip(corpus["port"], corpus["ref"])):
        assert [p.metadata.name for p in pods] == [p.metadata.name for p in jpods], cycle
        assert [p.metadata.labels for p in pods] == [p.metadata.labels for p in jpods], cycle
        assert [p.spec.containers[0].requests for p in pods] == [p.spec.containers[0].requests for p in jpods]
    proc, jproc = corpus["port"][-1][2], corpus["ref"][-1][2]
    assert [[p.metadata.name for p in e.deleted] for e in proc.events] == \
        [[p.metadata.name for p in e.deleted] for e in jproc.events]
    assert len(proc.events) == CYCLES - 1 and all(len(e.arrived) == 2 for e in proc.events)


def test_delta_encoder_matches_jax_and_cold(corpus):
    modes = []
    for cycle, c in enumerate(corpus["cycles"]):
        ctx = f"cycle {cycle} ({c['patch']})"
        _fields_equal(c["enc"].problem, c["jenc"].problem, ctx)
        for f in dataclasses.fields(c["enc"].meta):
            assert list(getattr(c["enc"].meta, f.name) or []) == list(getattr(c["jenc"].meta, f.name) or []) \
                if isinstance(getattr(c["enc"].meta, f.name), list) \
                else getattr(c["enc"].meta, f.name) == getattr(c["jenc"].meta, f.name), f"{ctx}: meta.{f.name}"
        assert c["patch"] == c["jpatch"], ctx
        if c["rows_prev"] is None:
            assert c["jrows_prev"] is None, ctx
        else:
            np.testing.assert_array_equal(c["rows_prev"], c["jrows_prev"], err_msg=ctx)
        cold = Encoder().encode(c["pods"], corpus["its"], corpus["tpls"], nodes=c["nodes"], num_claim_slots=SLOTS)
        _fields_equal(c["enc"].problem, cold.problem, ctx + " vs cold")
        modes.append((c["patch"]["mode"], c["patch"]["reason"]))
    assert modes[0] == ("cold", "first-encode") and modes[4] == ("cold", "node-added")
    assert sum(m == "patched" for m, _ in modes) == CYCLES - 2, modes


def test_diff_snapshots_match_jax(corpus):
    from karpenter_tpu.streaming.delta import diff_snapshots as j_diff
    from karpenter_tpu_torch.streaming.delta import diff_snapshots

    cycles = corpus["cycles"]
    for prev, cur in zip(cycles, cycles[1:]):
        d, _, _ = diff_snapshots(prev["pods"], prev["nodes"], cur["pods"], cur["nodes"])
        jd, _, _ = j_diff(prev["jpods"], prev["jnodes"], cur["jpods"], cur["jnodes"])
        # uids are random per object: removed pods compare by name
        for delta, pods in ((d, prev["pods"]), (jd, prev["jpods"])):
            names = {p.uid: p.metadata.name for p in pods}
            delta.removed_pods = sorted(names[u] for u in delta.removed_pods)
        assert dataclasses.asdict(d) == dataclasses.asdict(jd)
        assert len(d.added_pods) == 2 and len(d.removed_pods) == 2


def _patched(corpus):
    return [(k, c) for k, c in enumerate(corpus["cycles"]) if c["patch"]["mode"] == "patched"]


def test_build_patch_args_match_jax(corpus):
    for cycle, c in _patched(corpus):
        args = fused.build_patch_args(c["enc"].problem, c["rows_prev"], fused.leaf_shapes(c["prev"]))
        jargs = jfused.build_patch_args(c["jenc"].problem, c["jrows_prev"], c["jprev"])
        assert args._fields == jargs._fields
        for f in args._fields:
            np.testing.assert_array_equal(getattr(args, f), np.asarray(getattr(jargs, f)), err_msg=f"{cycle}: {f}")
            assert getattr(args, f).dtype == np.asarray(getattr(jargs, f)).dtype, f


def _permutes(gather_idx, use_fresh):
    """Surviving rows read both from above and from below their own row:
    a patch in place would read rows already overwritten."""
    rows = np.arange(len(gather_idx))[~use_fresh]
    src = gather_idx[~use_fresh]
    return bool((src > rows).any() and (src < rows).any())


def test_patch_world_matches_jax_and_cold_encode(corpus):
    permuting = 0
    for cycle, c in _patched(corpus):
        jargs = jfused.build_patch_args(c["jenc"].problem, c["jrows_prev"], c["jprev"])
        args = patch_args_from_numpy(jargs._asdict())
        permuting += _permutes(args.gather_idx, args.use_fresh)
        world = fused.adopt_world(c["prev"], SLOTS, "cpu")
        prev_t = dict(world.t)
        up = fused.upload_patch(args, world)
        plain = fused.patch_world_plain(prev_t, up)
        fused.patch_world(world, up)
        for name, value in plain.items():
            assert torch.equal(world.t[name], value), f"{cycle}: {name}"
        # the patched world is the cold encode's, in the kernels' layout
        _world_equal(world.t, _cold_world(c["pods"], corpus["its"], corpus["tpls"], c["nodes"]), f"cycle {cycle}")
        # and the JAX package's patched world, converted the same way
        jworld = jfused._patch_world_jit(jax.device_put(c["jprev"]), jargs)
        jt = fused.world_tensors(problem_from_numpy(numpy_fields(jax.device_get(jworld)), "cpu"))
        _world_equal(world.t, jt, f"cycle {cycle} vs JAX")
        # the swap left the previous rows in the spare buffers
        for name in fused.PATCH_ROWS:
            assert torch.equal(world.spare[name], prev_t[name]), name
    assert permuting >= 2, "the corpus never permuted rows"


def test_patch_world_without_permutation():
    """A spec-change-only cycle: every survivor keeps its row."""
    its, tpls = _catalog("port")
    rng = random.Random(3)
    pods = [churn.default_pod_factory(f"p-{i}", rng) for i in range(40)]
    enc = DeltaEncoder()
    first = enc.encode(pods, its, tpls, num_claim_slots=SLOTS)
    pods2 = list(pods)
    pods2[7] = _spec_change(pods2[7])
    second = enc.encode(pods2, its, tpls, num_claim_slots=SLOTS)
    assert enc.last_patch["mode"] == "patched" and enc.last_patch["fresh_rows"] == 1
    prev = pad_problem(first.problem)
    args = fused.build_patch_args(second.problem, enc.last_rows_prev, fused.leaf_shapes(prev))
    assert not _permutes(args.gather_idx, args.use_fresh)
    world = fused.adopt_world(prev, SLOTS, "cpu")
    fused.patch_world(world, fused.upload_patch(args, world))
    _world_equal(world.t, _cold_world(pods2, its, tpls, []), "spec change")


def test_world_problem_inverts_world_tensors(corpus):
    c = corpus["cycles"][-1]
    problem = problem_to_torch(pad_problem(c["enc"].problem), "cpu")
    _fields_equal(fused.world_problem(fused.world_tensors(problem)), problem, "round trip")


def test_fused_gate_counts_match_jax(corpus):
    c = corpus["cycles"][-1]
    padded, jpadded = pad_problem(c["enc"].problem), j_pad_problem(c["jenc"].problem)
    P = padded.pod_requests.shape[0]
    check = np.zeros(P, dtype=bool)
    check[: len(c["pods"])] = True
    problem = problem_to_torch(padded, "cpu")
    bf = problem_bounds_free(problem)
    gbf = gdev.gate_bounds_free(gdev.gate_problem(problem))
    result, counts = fused.solve_ffd_fused_gate_plain(problem, torch.from_numpy(check), SLOTS, bf, gbf)
    jprob = jax.device_put(jpadded)
    jresult, jcounts = jfused.solve_ffd_fused_gate(jprob, jnp.asarray(check), SLOTS, bf, 0, gbf)
    assert torch.equal(result.kind, torch.from_numpy(np.array(jresult.kind)))
    assert torch.equal(result.index, torch.from_numpy(np.array(jresult.index)))
    assert counts.tolist() == np.asarray(jcounts).tolist() == [0] * len(gdev.INVARIANTS)
    # the same counts on the same final state, corrupted: a claim's reported
    # requests (claim-requests) and a pod's row on a claim that excludes it
    # (requirement-intersection)
    jstate = jax.device_get(jresult.state)
    c0 = int(np.flatnonzero(np.asarray(jstate.claim_open))[0])
    on_c0 = np.flatnonzero((np.asarray(jresult.kind) >= 1) & (np.asarray(jresult.kind) <= 2)
                           & (np.asarray(jresult.index) == c0))
    adm = np.asarray(jstate.claim_req.admitted).copy()
    defined = np.asarray(jstate.claim_req.defined).copy()
    comp = np.asarray(jstate.claim_req.comp).copy()
    adm[c0, 0] = False  # zone key: admits nothing
    comp[c0, 0] = False
    defined[c0, 0] = True
    pod_adm = np.asarray(jpadded.pod_reqs.admitted).copy()
    pod_def = np.asarray(jpadded.pod_reqs.defined).copy()
    pod_adm[on_c0[0], 0] = np.asarray(jpadded.lane_valid)[0]
    pod_def[on_c0[0], 0] = True
    requests = np.asarray(jstate.claim_requests).copy()
    requests[c0, 0] += 1.0
    jstate = dataclasses.replace(
        jstate, claim_requests=requests,
        claim_req=dataclasses.replace(jstate.claim_req, admitted=adm, comp=comp, defined=defined),
    )
    jpadded2 = dataclasses.replace(jpadded, pod_reqs=dataclasses.replace(jpadded.pod_reqs, admitted=pod_adm,
                                                                          defined=pod_def))
    jbad = jfused.fused_gate_counts(jax.device_put(jpadded2), jresult.kind, jresult.index,
                                    jax.device_put(jstate), jnp.asarray(check), SLOTS, gbf)
    state = state_from_numpy(numpy_fields(jstate), "cpu")
    problem2 = problem_from_numpy(numpy_fields(jpadded2), "cpu")
    bad = fused.fused_gate_counts(problem2, result.kind, result.index, state, torch.from_numpy(check), SLOTS, gbf)
    assert bad.tolist() == np.asarray(jbad).tolist()
    for name in ("claim-requests", "requirement-intersection"):
        assert bad[gdev.INVARIANTS.index(name)] > 0, name


@pytest.fixture(scope="module")
def resident_runs(corpus):
    """The corpus through the port's resident path, the port's legacy path
    and the JAX package's resident path."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KARPENTER_TPU_DEVICE_WORLD", "1")
    mp.setenv("KARPENTER_TPU_RELAX", "0")
    try:
        dw = TorchSolver(device="cpu", relax=False, device_world=True)
        legacy = TorchSolver(device="cpu", relax=False)
        js = JaxSolver()
        runs = []
        for c in corpus["cycles"]:
            r = dw.solve(c["pods"], corpus["its"], corpus["tpls"], nodes=c["nodes"])
            world = {k: v.clone() for k, v in dw._device_world.world.t.items()}
            runs.append(dict(
                r=r, outcome=dw.last_world_outcome, world=world, last_cycle=dict(dw._device_world.last_cycle),
                iters=dw.last_iters,
                legacy=legacy.solve(c["pods"], corpus["its"], corpus["tpls"], nodes=c["nodes"]),
                jr=js.solve(c["jpods"], corpus["jits"], corpus["jtpls"], nodes=c["jnodes"]),
                joutcome=js._device_world.last_outcome, jiters=js.last_iters,
            ))
    finally:
        mp.undo()
    return dict(runs=runs, solver=dw)


def test_device_world_matches_legacy_and_jax(corpus, resident_runs):
    for cycle, (c, run) in enumerate(zip(corpus["cycles"], resident_runs["runs"])):
        assert run["outcome"] == run["joutcome"], cycle
        assert not run["outcome"].startswith("standdown"), run["outcome"]
        assert_same_results(run["jr"], run["r"])
        assert_same_results(run["legacy"], run["r"])
        assert run["r"].verify_ctx.fused_counts == {}
        _world_equal(run["world"], _cold_world(c["pods"], corpus["its"], corpus["tpls"], c["nodes"]), f"{cycle}")
    outcomes = [run["outcome"] for run in resident_runs["runs"]]
    assert outcomes == ["adopt-first-encode", "patched", "repatched", "repatched", "adopt-node-added",
                        "patched", "repatched"]
    dw = resident_runs["solver"]
    assert dw._device_world.cold_solves == 2 and dw._device_world.cycles == CYCLES
    assert dw.last_iters.sweeps >= 1
    for cycle, run in enumerate(resident_runs["runs"]):
        assert tuple(run["iters"]) == tuple(int(x) for x in run["jiters"][:4]), cycle
    lc = resident_runs["runs"][-1]["last_cycle"]
    assert lc["h2d_bytes"] < lc["world_bytes"] / 4 and 0.0 <= lc["overlap_frac"] <= 1.0
    assert set(dw.last_timing) == {"encode", "patch", "relax", "device", "decode"}


def _small(pods=16, seed=11, **catalog):
    its, tpls = _catalog("port", **catalog)
    rng = random.Random(seed)
    return [churn.default_pod_factory(f"p-{i}", rng) for i in range(pods)], its, tpls


def _placements(pods, result):
    m = {}
    for name, idxs in result.node_pods.items():
        for i in idxs:
            m[pods[i].uid] = ("node", name)
    for ci, claim in enumerate(result.new_claims):
        for i in claim.pod_indices:
            m[pods[i].uid] = ("claim", ci, tuple(claim.instance_type_indices))
    for i in result.failures:
        m[pods[i].uid] = ("fail",)
    return m


def _solve_both(pods, its, tpls, relax=False, **kw):
    dw = TorchSolver(device="cpu", relax=relax, device_world=True, **kw.pop("slots", {}))
    r = dw.solve(pods, its, tpls, **kw)
    ref = TorchSolver(device="cpu", relax=relax).solve(pods, its, tpls, **kw)
    assert _placements(pods, r) == _placements(pods, ref)
    return dw, r


@pytest.mark.parametrize("case", ["cluster-pods", "override"])
def test_standdown_unsupported_args(case):
    pods, its, tpls = _small()
    kw = ({"cluster_pods": [(pods[0], dict(pods[0].metadata.labels))]} if case == "cluster-pods"
          else {"pod_requirements_override": [pod_requirements(p) for p in pods]})
    dw, _ = _solve_both(pods, its, tpls, **kw)
    assert dw.last_world_outcome == "standdown-unsupported-args"
    assert dw._device_world.world is None and dw._device_world.delta._state is None


def test_standdown_not_sweeps():
    pods, its, tpls = _small()
    tpls = [dataclasses.replace(tpls[0], taints=Taints([Taint(key="soft", value="x", effect="PreferNoSchedule")]))]
    dw, _ = _solve_both(pods, its, tpls)
    assert dw.last_world_outcome == "standdown-not-sweeps"


def test_standdown_topology():
    pods, its, tpls = _small()
    pods[0].spec.topology_spread_constraints = [TopologySpreadConstraint(max_skew=1, topology_key=wk.LABEL_HOSTNAME)]
    dw, _ = _solve_both(pods, its, tpls)
    assert dw.last_world_outcome == "standdown-topology"


def test_relax_applicable_and_a_finite_limit():
    """With relax on, a limitless NodePool lets phase 1 fire: the resident
    path stands down. A finite NodePool limit switches phase 1 off, and the
    resident path serves the cycle."""
    pods, its, tpls = _small()
    dw, _ = _solve_both(pods, its, tpls, relax=True)
    assert dw.last_world_outcome == "standdown-relax-applicable"
    pods, its, tpls = _small(limit={"cpu": 1e6})
    dw, _ = _solve_both(pods, its, tpls, relax=True)
    assert dw.last_world_outcome == "adopt-first-encode"
    assert dw.last_relax is None


def test_standdown_slot_overflow():
    from karpenter_tpu_torch.testing.workloads import make_pod

    its, tpls = _catalog("port")
    pods = [make_pod(i, cpu=7.0) for i in range(20)]  # one claim each: 12 cpu at most
    dw, r = _solve_both(pods, its, tpls, slots={"initial_claim_slots": 8})
    assert dw.last_world_outcome == "standdown-slot-overflow"
    assert dw._device_world.world is None and len(r.new_claims) == 20
    dw.solve(pods, its, tpls)  # the next cycle adopts at the escalated bucket
    assert dw.last_world_outcome == "adopt-first-encode"


def test_standdown_gate_reject(monkeypatch):
    real = device_world.solve_ffd_fused_gate

    def rejecting(*args, **kw):
        result, counts = real(*args, **kw)
        return result, counts + torch.tensor([1] + [0] * (len(counts) - 1), dtype=counts.dtype)

    pods, its, tpls = _small()
    monkeypatch.setattr(device_world, "solve_ffd_fused_gate", rejecting)
    dw, _ = _solve_both(pods, its, tpls)
    assert dw.last_world_outcome == "standdown-gate-reject"
    assert dw._device_world.world is None


def test_adopt_reasons():
    pods, its, tpls = _small(pods=24, seed=13)
    nodes = [_node("port", f"n-{i}") for i in range(3)]
    dw = TorchSolver(device="cpu", relax=False, device_world=True)
    dw.solve(pods, its, tpls, nodes=nodes)
    assert dw.last_world_outcome == "adopt-first-encode"
    dw.solve(pods, its, tpls, nodes=nodes + [_node("port", "n-new")])
    assert dw.last_world_outcome == "adopt-node-added"
    rng = random.Random(2)
    grown = pods + [churn.default_pod_factory(f"g-{i}", rng) for i in range(16)]  # 24 -> 40 pods
    dw.solve(grown, its, tpls, nodes=nodes + [_node("port", "n-new")])
    assert dw.last_world_outcome == "adopt-shape-drift"
    assert dw._device_world.counters == {"adopt-first-encode": 1, "adopt-node-added": 1, "adopt-shape-drift": 1}


def test_reset_streaming_state_drops_the_world():
    pods, its, tpls = _small()
    dw = TorchSolver(device="cpu", relax=False, device_world=True)
    dw.solve(pods, its, tpls)
    dw.solve(pods[1:], its, tpls)
    assert dw.last_world_outcome == "patched"
    dw.reset_streaming_state()
    assert dw._device_world.world is None and dw._device_world.delta._state is None
    dw.solve(pods[1:], its, tpls)
    assert dw.last_world_outcome == "adopt-first-encode"


def test_synchronous_mode_is_identical():
    its, tpls = _catalog("port")
    proc = churn.ChurnProcess([churn.default_pod_factory(f"p-{i}", random.Random(23)) for i in range(30)],
                              config=churn.ChurnConfig(seed=23, arrivals_per_cycle=2, deletes_per_cycle=2))
    sync = TorchSolver(device="cpu", relax=False, device_world=True)
    sync._device_world = device_world.DeviceWorld(sync, pipelined=False)
    pipe = TorchSolver(device="cpu", relax=False, device_world=True)
    records = []
    for solver in (sync, pipe):
        records.append(churn.run_churn(solver, copy.deepcopy(proc), its, tpls, cycles=3, validate=True))
    assert [r["outcome"] for r in records[0]] == ["adopt-first-encode", "patched", "repatched"]
    assert records[0] == [dict(r, seconds=r0["seconds"]) for r, r0 in zip(records[1], records[0])]
    assert all(r["violations"] == 0 for r in records[0])
    assert sync._device_world.last_cycle["overlap_frac"] == 0.0


def test_launch_failure_raises_and_drops_the_world(monkeypatch):
    pods, its, tpls = _small()
    dw = TorchSolver(device="cpu", relax=False, device_world=True)
    dw.solve(pods, its, tpls)

    def failing(world, up):
        raise RuntimeError("patch_world: CUDA launch error 700")

    monkeypatch.setattr(device_world, "patch_world", failing)
    with pytest.raises(RuntimeError, match="launch error"):
        dw.solve(pods[1:], its, tpls)
    assert dw._device_world.world is None and dw._device_world.delta._state is None
    monkeypatch.undo()
    dw.solve(pods[1:], its, tpls)
    assert dw.last_world_outcome == "adopt-first-encode"


@pytest.mark.slow
def test_churn_batch_slots_match_chip_smoke(monkeypatch):
    """chip_smoke.py's churn batch (its CHURN_* constants): the JAX package
    places the first snapshot on 39 claims after escalating from its default
    32 claim slots to 64, which is why the smoke gives both of its arms 64
    slots (no cycle may overflow)."""
    import chip_smoke

    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")
    jits = j_instance_types(400)
    jtpls = [j_template_from_nodepool(JNodePool(metadata=JObjectMeta(name="d")), jits, range(len(jits)))]
    rng = random.Random(chip_smoke.CHURN_SEED)
    pods = [jchurn.default_pod_factory(f"dw-{i}", rng) for i in range(chip_smoke.CHURN_PODS)]
    js = JaxSolver()
    result = js.solve(pods, jits, jtpls)
    assert result.num_scheduled() == chip_smoke.CHURN_PODS and len(result.new_claims) == 39
    assert js.claim_slots == chip_smoke.CHURN_SLOTS


@pytest.mark.parametrize("limit,expected", [
    (16.0, {"claim-capacity"}),
    (None, {"resources", "requirements"}),
])
def test_resident_cycles_explain_like_the_ordinary_solve_and_jax(monkeypatch, limit, expected):
    """With KARPENTER_TPU_EXPLAIN on, a resident cycle attributes its failed
    rows against the resident tables: on the adopting cycle and on a patched
    one, the report's pods, reasons and hints equal those of the port's
    ordinary solve and of the JAX package's resident path. One pod asks for
    more cpu than any type has, one for a zone that does not exist; a
    NodePool cpu limit leaves more pods unscheduled (claim-capacity)."""
    from karpenter_tpu.obs import explain as jox
    from karpenter_tpu_torch.obs import explain as tox

    monkeypatch.setenv("KARPENTER_TPU_DEVICE_WORLD", "1")
    monkeypatch.setenv("KARPENTER_TPU_RELAX", "0")
    resident = []  # the resident hook rebuilds its problem from the world tables
    real_world_problem = device_world.world_problem
    monkeypatch.setattr(device_world, "world_problem", lambda t: resident.append(1) or real_world_problem(t))
    batches = {}
    for pkg, mod in (("port", churn), ("jax", jchurn)):
        its, tpls = _catalog(pkg, limit=None if limit is None else {"cpu": limit})
        rng = random.Random(11)
        pods = [mod.default_pod_factory(f"p-{i}", rng) for i in range(16)]
        pods[3].spec.containers[0].requests["cpu"] = 10_000.0
        pods[7].spec.node_selector = {wk.LABEL_TOPOLOGY_ZONE: "no-such-zone"}
        batches[pkg] = (pods, its, tpls)

    def report(result):
        assert result.explain is not None and result.explain.pods.keys() == result.failures.keys()
        return {k: (e.reason, e.hint) for k, e in result.explain.pods.items()}

    for ox in (jox, tox):
        ox.set_enabled(True)
    try:
        dw = TorchSolver(device="cpu", relax=False, device_world=True)
        js = JaxSolver()
        outcomes = []
        for cycle in range(2):
            (pods, its, tpls), (jpods, jits, jtpls) = batches["port"], batches["jax"]
            if cycle:  # one pod leaves: the resident world is patched
                pods, jpods = pods[1:], jpods[1:]
            r = dw.solve(pods, its, tpls)
            jr = js.solve(jpods, jits, jtpls)
            outcomes.append(dw.last_world_outcome)
            assert outcomes[-1] == js._device_world.last_outcome, cycle
            ref = TorchSolver(device="cpu", relax=False).solve(pods, its, tpls)
            assert _placements(pods, r) == _placements(pods, ref)
            reasons = report(r)
            assert reasons == report(ref) == report(jr), cycle
            assert {reason for reason, _ in reasons.values()} == expected, reasons
        assert outcomes == ["adopt-first-encode", "patched"] and len(resident) == 2
    finally:
        for ox in (jox, tox):
            ox.set_enabled(None)
            ox.reset_ring()
