"""Batched programs parity: karpenter_tpu_torch's batched_solve and
batched_screen (plain PyTorch on the CPU) against the JAX package's
batched_solve and batched_screen (mesh=None) on tests/test_mesh.py's
problems: 8 problems of 24 pods (min_pods=24), and the affinity-retry pair
(a pod whose affinity target is queued after it fails pass one on every
lane and is placed by a retry pass).

Each package encodes the problems from its own API objects, built by the
same code from the same seeds; the two encodes are held equal leaf for leaf
first. Then kind/index and every leaf of the lanes' final states must be
equal exactly, integer, bool and float leaves alike (atol=0, rtol=0): the
plain runs scan matches the JAX package's, floats included (see
tests/test_torch_runs.py).
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.parallel import mesh as j_mesh
from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
from karpenter_tpu_torch.ops.ffd_core import KIND_FAIL
from karpenter_tpu_torch.parallel import mesh as t_mesh

SLOTS = 8


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    objects = mod("apis.objects")
    return SimpleNamespace(
        NodePool=mod("apis.nodepool").NodePool, objects=objects, labels=mod("apis.labels"),
        instance_types=mod("cloudprovider.fake").instance_types, pad_problem=mod("ops.padding").pad_problem,
        encode=mod("solver.encode"), Topology=mod("provisioning.topology").Topology,
    )


JAX, PORT = _pkg("karpenter_tpu"), _pkg("karpenter_tpu_torch")


def _problem(m, seed, num_pods=24, num_its=16, min_pods=0):
    """tests/test_mesh.py's _problem, built from package ``m``'s objects."""
    o = m.objects
    rng = random.Random(seed)
    its = m.instance_types(num_its)
    tpl = m.encode.template_from_nodepool(m.NodePool(metadata=o.ObjectMeta(name="default")), its, range(len(its)))
    pods = [
        o.Pod(
            metadata=o.ObjectMeta(name=f"p{seed}-{i}"),
            spec=o.PodSpec(containers=[o.Container(requests={
                "cpu": rng.choice([0.1, 0.5, 1.0, 2.0]),
                "memory": rng.choice([128, 512, 2048]) * 1024.0**2,
            })]),
        )
        for i in range(num_pods)
    ]
    encoded = m.encode.Encoder().encode(pods, its, [tpl], num_claim_slots=SLOTS)
    return m.pad_problem(encoded.problem, min_pods=min_pods)


def _affinity_pair(m):
    """tests/test_mesh.py's order-dependent pair: a big pod with a required
    zone affinity to a small pod that FFD queues after it."""
    o, wk = m.objects, m.labels
    its = m.instance_types(8)
    tpl = m.encode.template_from_nodepool(m.NodePool(metadata=o.ObjectMeta(name="default")), its, range(len(its)))
    affine = o.Pod(
        metadata=o.ObjectMeta(name="wants-buddy", labels={"grp": "x"}),
        spec=o.PodSpec(
            containers=[o.Container(requests={"cpu": 3.0})],
            affinity=o.Affinity(pod_affinity=o.PodAffinity(required=[o.PodAffinityTerm(
                topology_key=wk.LABEL_TOPOLOGY_ZONE,
                label_selector=o.LabelSelector(match_labels={"grp": "y"}),
            )])),
        ),
    )
    buddy = o.Pod(
        metadata=o.ObjectMeta(name="buddy", labels={"grp": "y"}),
        spec=o.PodSpec(containers=[o.Container(requests={"cpu": 0.2})],
                       node_selector={wk.LABEL_TOPOLOGY_ZONE: "test-zone-1"}),
    )
    pods = [affine, buddy]
    topo = m.Topology(m.encode.domains_from_instance_types(its, [tpl]), batch_pods=pods)
    encoded = m.encode.Encoder().encode(pods, its, [tpl], num_claim_slots=4, topology=topo)
    return m.pad_problem(encoded.problem)


def _assert_encodes_equal(jp, tp):
    jf, tf = numpy_fields(jp), numpy_fields(tp)
    assert sorted(jf) == sorted(tf)
    for key in jf:
        assert jf[key].shape == tf[key].shape, key
        np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)


def _assert_exact(jr, tr):
    np.testing.assert_array_equal(tr.kind.numpy(), np.asarray(jr.kind))
    np.testing.assert_array_equal(tr.index.numpy(), np.asarray(jr.index))
    js, ts = numpy_fields(jr.state), numpy_fields(tr.state)
    assert sorted(js) == sorted(ts)
    for key in js:
        assert js[key].shape == ts[key].shape, key
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)


@pytest.fixture(scope="module")
def corpus():
    """The 8 problems and the affinity pair x 8, each stacked by both
    packages (the port's on the CPU), the encodes held equal first."""
    out = {}
    for name, build, slots in (
        ("mesh-8", lambda m: [_problem(m, seed, min_pods=24) for seed in range(8)], SLOTS),
        ("affinity-pair", lambda m: [_affinity_pair(m)] * 8, 4),
    ):
        jps, tps = build(JAX), build(PORT)
        for jp, tp in zip(jps, tps):
            _assert_encodes_equal(jp, tp)
        out[name] = (j_mesh.stack_problems(jps), problem_to_torch(t_mesh.stack_problems(tps), "cpu"), slots)
    return out


@pytest.mark.parametrize("program,passes", [("solve", 1), ("screen", 3)])
def test_batched_programs_equal_the_jax_package(corpus, program, passes):
    jb, tb, slots = corpus["mesh-8"]
    if program == "solve":
        jr = j_mesh.batched_solve(jb, slots, mesh=None)
        tr = t_mesh.batched_solve(tb, slots)
    else:
        jr = j_mesh.batched_screen(jb, slots, mesh=None, passes=passes)
        tr = t_mesh.batched_screen(tb, slots, passes=passes)
    _assert_exact(jr, tr)
    # every lane schedules its 24 pods (tests/test_mesh.py)
    assert ((tr.kind < KIND_FAIL).sum(dim=1) == 24).all()


def test_batched_screen_retries_order_dependent_pods(corpus):
    """Pass one fails the early affinity pod on every lane; the retry pass
    places it — in both packages, with equal results."""
    jb, tb, slots = corpus["affinity-pair"]
    one = t_mesh.batched_solve(tb, slots)
    multi = t_mesh.batched_screen(tb, slots, passes=3)
    _assert_exact(j_mesh.batched_solve(jb, slots, mesh=None), one)
    _assert_exact(j_mesh.batched_screen(jb, slots, mesh=None, passes=3), multi)
    assert (one.kind[:, 0] == KIND_FAIL).all()
    assert (multi.kind[:, 0] < KIND_FAIL).all() and (multi.kind[:, 1] < KIND_FAIL).all()
    # batched_solve is the one-pass screen
    screen1 = t_mesh.batched_screen(tb, slots, passes=1)
    assert torch.equal(screen1.kind, one.kind) and torch.equal(screen1.index, one.index)


def test_stack_and_lane_round_trip(corpus):
    """stack_problems stacks host and torch problems alike; lane_problem
    takes lane b back out, leaf for leaf."""
    tps = [_problem(PORT, seed, min_pods=24) for seed in range(3)]
    host = t_mesh.stack_problems(tps)
    dev = t_mesh.stack_problems([problem_to_torch(p, "cpu") for p in tps])
    assert isinstance(host.pod_requests, np.ndarray) and isinstance(dev.pod_requests, torch.Tensor)
    for b, p in enumerate(tps):
        for stacked in (host, dev):
            _assert_encodes_equal(p, t_mesh.lane_problem(stacked, b))


def test_plain_lanes_subset_equals_the_full_stack(corpus):
    """The plain versions' ``lanes`` argument (chip_smoke.py checks a subset
    of the wide stack) gives those lanes' rows of the whole stack."""
    _, tb, slots = corpus["mesh-8"]
    full = t_mesh.batched_screen_plain(tb, slots)
    part = t_mesh.batched_screen_plain(tb, slots, lanes=[1, 6])
    sel = torch.tensor([1, 6])
    assert torch.equal(full.kind[sel], part.kind) and torch.equal(full.index[sel], part.index)
    fs, ps = numpy_fields(full.state), numpy_fields(part.state)
    for key in ps:
        np.testing.assert_array_equal(ps[key], fs[key][[1, 6]], err_msg=key)
    one = t_mesh.batched_solve_plain(tb, slots, lanes=[2])
    assert torch.equal(one.kind[0], t_mesh.batched_solve(tb, slots).kind[2])
