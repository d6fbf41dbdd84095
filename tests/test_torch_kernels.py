"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel-vs-plain tests need an NVIDIA GPU and nvcc; they carry the
``cuda`` marker and skip elsewhere (run them on the card with
``python -m pytest tests/test_torch_kernels.py -m cuda``). chip_smoke.py runs
the same comparisons at the main path's shapes. The rest runs anywhere: the
ctypes argument structs must list the C structs' fields in order, and the
launch wrappers must refuse CPU tensors instead of falling back.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
from karpenter_tpu_torch.ops import ffd_sweeps, fused, relax
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state, problem_bounds_free
from karpenter_tpu_torch.ops.ffd_step import solve_ffd_plain
from karpenter_tpu_torch.ops.padding import pad_problem
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.solver.encode import Encoder, domains_from_instance_types
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import workloads as W
from karpenter_tpu_torch.verify import device as gdev
from karpenter_tpu_torch.verify.gate import _build_args

CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _c_struct_fields(source: str, struct: str):
    text = (CSRC / source).read_text()
    body = text[text.index(f"struct {struct} {{"):]
    body = re.sub(r"//.*", "", body[: body.index("};")])
    pointers = re.findall(r"\*\s*(\w+)\s*;", body)
    ints = [x.strip() for x in re.findall(r"\bint\s+([\w\s,]+);", body)[-1].split(",")]
    return pointers, ints


@pytest.mark.parametrize(
    "source,struct,pointers,ints",
    [
        ("ffd_loop.cu", "FfdArgs", ffd_sweeps._FFD_POINTERS, ffd_sweeps._FFD_INTS),
        ("gate_counts.cu", "GateKernelArgs", gdev._GATE_POINTERS, gdev._GATE_INTS),
        ("relax_place.cu", "RelaxArgs", relax._RELAX_POINTERS, relax._RELAX_INTS),
        ("runs_screen.cu", "RunsArgs", mesh._RS_POINTERS, mesh._RS_INTS),
        ("patch_world.cu", "PatchKernelArgs", fused._PATCH_POINTERS, fused._PATCH_INTS),
    ],
)
def test_ctypes_struct_matches_c_struct(source, struct, pointers, ints):
    c_pointers, c_ints = _c_struct_fields(source, struct)
    assert c_pointers == list(pointers)
    assert c_ints == list(ints)


def _encode(workload, slots):
    pods, its, tpls, nodes = workload
    topo = Topology(domains_from_instance_types(its, tpls), batch_pods=pods, cluster_pods=[])
    for n in nodes:
        topo.register("kubernetes.io/hostname", n.name)
    enc = Encoder(FAKE_WELL_KNOWN_LABELS).encode(pods, its, tpls, nodes, topology=topo, num_claim_slots=slots)
    return pad_problem(enc.problem)


def test_launch_wrappers_refuse_cpu_tensors():
    prob = problem_to_torch(_encode(W.fuzz_workload(1), 8), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ffd_sweeps.launch_ffd_loop(prob, initial_state(prob, 8), one_pass=False)
    with pytest.raises(ValueError, match="CUDA"):
        relax.launch_relax_place(prob, 8)
    gp = gdev.gate_problem(prob)
    with pytest.raises(ValueError, match="CUDA"):
        gdev.launch_gate_counts(gp, None)
    B = 2
    with pytest.raises(ValueError, match="CUDA"):
        mesh.launch_runs_screen(
            prob, initial_state(prob, 8), prob.node_avail[None].expand(B, -1, -1).contiguous(),
            prob.pod_active[None].expand(B, -1).contiguous(), max_run=mesh.max_run_bucket(prob),
            passes=1, with_topo=mesh.has_topo_runs(prob),
        )


def _gate_inputs():
    pods, its, tpls, nodes = W.fuzz_workload(6)
    result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(pods, its, tpls, nodes)
    gp, ga, _ = _build_args(result.verify_ctx, result, pods, None)
    return gp, ga


def _screen_args():
    """One runs_screen launch's arguments: the bench scorer's union problem
    (4 candidates) in full mode over 3 lanes."""
    from karpenter_tpu_torch.disruption.batch import build_bench_scorer

    scorer = build_bench_scorer(4, device="cpu")[0]
    prob = scorer.device_problem
    B = 3
    init = initial_state(prob, scorer.num_claim_slots)
    t, args = mesh.runs_screen_args(
        prob, init, prob.node_avail[None].expand(B, -1, -1).contiguous(),
        prob.pod_active[None].expand(B, -1).contiguous(), max_run=mesh.max_run_bucket(prob), passes=3,
        with_topo=False, grp_counts0=prob.grp_counts0[None].expand(B, -1, -1).contiguous(),
        grp_registered0=prob.grp_registered0[None].expand(B, -1, -1).contiguous(),
    )
    return init, t, args


@pytest.mark.parametrize("kernel", ["ffd_loop", "gate_counts", "runs_screen"])
def test_args_builders_fill_every_pointer(kernel):
    """One launch's tensors: every struct pointer set from its tensor, the
    carried state copied (a launch leaves its input state alone), scratch
    accumulators zeroed. chip_smoke.py counts a launch's bytes from them."""
    if kernel == "ffd_loop":
        prob = problem_to_torch(_encode(W.fuzz_workload(6), 8), "cpu")
        init = initial_state(prob, 8)
        t, args = ffd_sweeps.ffd_loop_args(prob, init, one_pass=False)
        pointers, state, scratch = ffd_sweeps._FFD_POINTERS, ffd_sweeps.FFD_STATE, ffd_sweeps.FFD_SCRATCH
        ours = {x.data_ptr() for x in numpy_fields_tensors(init) if x.numel()}
        assert not any(t[name].data_ptr() in ours for name in state if t[name].numel())
    elif kernel == "runs_screen":
        init, t, args = _screen_args()
        pointers, state, scratch = mesh._RS_POINTERS, mesh.RS_STATE, mesh.RS_SCRATCH
        ours = {x.data_ptr() for x in numpy_fields_tensors(init) if x.numel()}
        # the lanes' state is the kernel's own: no buffer is shared with init
        assert not any(t[name].data_ptr() in ours for name in state + mesh.RS_INIT if t[name].numel())
        assert all(t[name].shape[0] == 3 for name in state + mesh.RS_LANE_INPUTS + ("kind", "index", "work"))
    else:
        t, args = gdev.gate_counts_args(*_gate_inputs())
        pointers, state, scratch = gdev._GATE_POINTERS, (), gdev.GATE_SCRATCH
        assert all(not t[name].any() for name in scratch)
    assert set(t) == set(pointers) and set(state) | set(scratch) <= set(pointers)
    for name in pointers:
        expected = t[name].data_ptr() if t[name] is not None else None
        assert getattr(args, name) == (expected or None), name  # ctypes reads a null pointer as None


def numpy_fields_tensors(obj):
    """Every tensor leaf of a dataclass tree."""
    out = []
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out += numpy_fields_tensors(value)
        elif isinstance(value, torch.Tensor):
            out.append(value)
    return out


def test_library_path_tracks_sources_and_flags():
    a = kernels.library_path("ffd_loop")
    assert a == kernels.library_path("ffd_loop")
    assert a.parent == kernels.BUILD_DIR and a != kernels.library_path("gate_counts")
    assert set(kernels.SOURCES) == {"ffd_loop", "gate_counts", "patch_world", "relax_place", "runs_screen"}
    assert set(kernels.LAUNCHES) == set(kernels.SOURCES)


def test_step_is_shared_by_the_loop_and_the_screen():
    """ffd_loop.cu and runs_screen.cu compile the one per-pod step of
    step.cuh: neither defines its own, and the loop writes each verdict row
    from the step's Shared::kind / index right after the call."""
    step = (CSRC / "step.cuh").read_text()
    assert "__device__ void step(const A& a, int p, Shared& s" in step
    assert "a.kind[" not in step and "a.index[" not in step
    for source in ("ffd_loop.cu", "runs_screen.cu"):
        text = (CSRC / source).read_text()
        assert '#include "step.cuh"' in text
        assert "void step(" not in text and "bool bin_gate(" not in text and "void group_prep(" not in text
    loop = (CSRC / "ffd_loop.cu").read_text()
    assert loop.count("step(a, p, s, s_gmin, s_boot, s_nothing, s_maxcap);\n      if (tid == 0) {\n"
                      "        a.kind[p] = s.kind;\n        a.index[p] = s.index;") == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CORPORA = {
    "homogeneous-48": (lambda: W.homogeneous_workload(48), 32),
    "diverse-300-overflow": (lambda: W.diverse_workload(300, 40, seed=7), 8),
    "bounds-0-free": (lambda: W.bounds_workload(0, with_nodes=False), 32),
    "chain-2000": (lambda: W.chain_workload(2000), 32),
    "chain-2001-overflow": (lambda: W.chain_workload(2001), 8),
    "fuzz-6": (lambda: W.fuzz_workload(6), 32),
    "bounds-0": (lambda: W.bounds_workload(0), 32),
    "topology-3": (lambda: W.topology_workload(3), 32),
}


def _assert_same(rk, rp):
    assert torch.equal(rk.kind.cpu(), rp.kind.cpu())
    assert torch.equal(rk.index.cpu(), rp.index.cpu())
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        if sp[key].dtype.kind == "f":
            np.testing.assert_allclose(sk[key], sp[key], rtol=1e-5, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(sk[key], sp[key], err_msg=key)


PR1_CORPORA = ("chain-2000", "chain-2001-overflow", "fuzz-6", "bounds-0", "topology-3")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PR1_CORPORA)
def test_ffd_loop_matches_plain(cuda, name):
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    bf = problem_bounds_free(prob)
    rk = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf)
    _assert_same(rk, rp)
    assert int(rk.iters.sweeps) == rp.iters.sweeps and int(rk.iters.narrow) == rp.iters.narrow
    work = dict(zip(ffd_sweeps.WORK_COUNTERS, rk.work.cpu().tolist()))
    assert work["bin_gates"] >= rp.iters.narrow and work["barriers"] >= 4 * rp.iters.narrow
    init = initial_state(prob, slots)
    rk1 = ffd_sweeps.launch_ffd_loop(prob, init, one_pass=True)
    _assert_same(rk1, solve_ffd_plain(prob, init, bf))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fuzz-6", "bounds-0"])
def test_gate_counts_matches_plain(cuda, name):
    pods, its, tpls, nodes = CORPORA[name][0]()
    result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=cuda).solve(pods, its, tpls, nodes)
    gp, ga, bf = _build_args(result.verify_ctx, result, pods, None)
    ck = gdev.launch_gate_counts(gp, ga).cpu()
    assert torch.equal(ck, gdev.gate_counts_plain(gp, ga, bf).cpu())
    assert not ck.any()
    rep = ga.claim_reported.clone()
    rep[0, 0] += 1.0
    bad = ga._replace(claim_reported=rep)
    assert torch.equal(gdev.launch_gate_counts(gp, bad).cpu(), gdev.gate_counts_plain(gp, bad, bf).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["homogeneous-48", "diverse-300-overflow", "bounds-0-free", "fuzz-6", "chain-2000"])
def test_relax_place_and_carried_loop_match_plain(cuda, name):
    """relax_place against relax_place_plain (integers and bools exact, floats
    within rtol 1e-5), then the carried ffd_loop against the seeded plain
    loop, on the card."""
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    rk = relax.relax_place(prob, slots)
    rp = relax.relax_place_plain(prob, slots)
    for key in ("kind", "index", "residue_active"):
        assert torch.equal(getattr(rk, key).cpu(), getattr(rp, key).cpu()), key
    assert [int(x) for x in rk.stats] == [int(x) for x in rp.stats]
    _assert_same(rk, rp)
    residue = dataclasses.replace(prob, pod_active=rp.residue_active)
    ck = ffd_sweeps.solve_ffd_sweeps_carried(residue, slots, init=(rp.state, rp.kind, rp.index))
    aprob, state = _lane_align(residue, rp.state)
    cp = ffd_sweeps.sweeps_plain(aprob, state, problem_bounds_free(aprob), rp.kind, rp.index)
    _assert_same(ck, cp)
    assert int(ck.iters.sweeps) == cp.iters.sweeps and int(ck.iters.narrow) == cp.iters.narrow


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["residual", "full", "full-topology"])
def test_runs_screen_matches_plain(cuda, corpus):
    """runs_screen against lean_screen_plain / residual_screen_plain at a
    small size: the bench scorer's cluster (10 candidates) with survivors
    filled by pinned base pods (lanes open claims), without them, and with
    zonal spread pods (three passes, topology runs). Exact on kind, index and
    every state leaf, floats included."""
    from karpenter_tpu_torch.disruption import batch
    from karpenter_tpu_torch.testing import workloads as wl

    n = 10
    base_pods = {
        "residual": wl.pinned_base_pods(8, cpu=63.5),
        "full": wl.pinned_base_pods(8, cpu=63.5),
        "full-topology": wl.zonal_spread_pods(6),
    }[corpus]
    scorer = batch.build_bench_scorer(n, base_pods=base_pods, device=cuda, delta=corpus == "residual")[0]
    subsets = [list(range(k + 1)) for k in range(n)] + [[k] for k in range(n)]
    seen = {}
    real_lean, real_res = batch.lean_screen, batch.residual_screen

    def lean(base, variants, C, passes=3):
        rk = real_lean(base, variants, C, passes)
        seen["full"] = (rk, mesh.lean_screen_plain(base, variants, C, passes))
        return rk

    def res(base, carried, variants, run_idx, C):
        rk = real_res(base, carried, variants, run_idx, C)
        seen["residual"] = (rk, mesh.residual_screen_plain(base, carried, variants, run_idx, C))
        return rk

    batch.lean_screen, batch.residual_screen = lean, res
    try:
        scorer.score_subsets(subsets)
    finally:
        batch.lean_screen, batch.residual_screen = real_lean, real_res
    torch.cuda.synchronize()
    rk, rp = seen["residual" if corpus == "residual" else "full"]
    assert torch.equal(rk.kind.cpu(), rp.kind.cpu()) and torch.equal(rk.index.cpu(), rp.index.cpu())
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        np.testing.assert_array_equal(sk[key], sp[key], err_msg=key)
    if corpus == "full-topology":
        assert scorer.last_screen_stats["passes"] == 3 and mesh.has_topo_runs(scorer.device_problem)


def _churn_world(n_pods=40, nodes=2, permute=True, seed=3):
    """A small resident-world corpus: (previous padded problem, the next
    snapshot's patch arguments, the next snapshot's cold padded problem)."""
    import random

    from karpenter_tpu_torch.streaming.churn import default_pod_factory
    from karpenter_tpu_torch.streaming.delta import DeltaEncoder

    from karpenter_tpu_torch.cloudprovider.fake import instance_types

    its = instance_types(12)
    tpls = [W.simple_template(its)]
    rng = random.Random(seed)
    pods = [default_pod_factory(f"p-{i}", rng) for i in range(n_pods)]
    node_list = [W.make_node(f"node-{i}") for i in range(nodes)]
    enc = DeltaEncoder()
    first = enc.encode(pods, its, tpls, nodes=node_list, num_claim_slots=8)
    if permute:
        pods2 = pods[3:] + [default_pod_factory(f"new-{i}", rng) for i in range(3)]
    else:
        pods2 = list(pods)
        pods2[5] = dataclasses.replace(pods2[5])
        pods2[5].spec = dataclasses.replace(pods2[5].spec, containers=[dataclasses.replace(
            pods2[5].spec.containers[0], requests={**pods2[5].spec.containers[0].requests, "cpu": 3.0})])
    second = enc.encode(pods2, its, tpls, nodes=node_list, num_claim_slots=8)
    assert enc.last_patch["mode"] == "patched", enc.last_patch
    prev = pad_problem(first.problem)
    args = fused.build_patch_args(second.problem, enc.last_rows_prev, fused.leaf_shapes(prev))
    return prev, args, pad_problem(Encoder().encode(pods2, its, tpls, nodes=node_list, num_claim_slots=8).problem)


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def test_resident_args_point_at_the_world():
    """The patch's leaf table and the fused gate's struct point at the
    resident world's own buffers (built on the CPU; no launch)."""
    prev, args, _ = _churn_world()
    world = fused.adopt_world(prev, 8, "cpu")
    up = fused.upload_patch(args, world)
    table = up.buffer[up.args.leaves - up.buffer.data_ptr():].view(torch.int64)
    rows = [n for n in fused.PATCH_ROWS if up.stack[n].numel()]
    assert up.args.L == len(rows) and up.args.FL == len(fused.PATCH_FULL)
    for i, name in enumerate(rows):
        prev_ptr, out_ptr, stk_ptr, row_bytes = table[4 * i: 4 * i + 4].tolist()
        assert (prev_ptr, out_ptr, stk_ptr) == (
            world.t[name].data_ptr(), world.spare[name].data_ptr(), up.stack[name].data_ptr())
        assert row_bytes * up.stack[name].shape[0] == up.stack[name].numel() * up.stack[name].element_size()
    for j, (name, _) in enumerate(fused.PATCH_FULL):
        _, out_ptr, src_ptr, nbytes = table[4 * (len(rows) + j): 4 * (len(rows) + j) + 4].tolist()
        assert (out_ptr, src_ptr, nbytes) == (
            world.t[name].data_ptr(), up.full[name].data_ptr(), up.full[name].numel() * up.full[name].element_size())
    fused.patch_world(world, up)
    t = dict(world.t)
    t.update(ffd_sweeps.state_tensors(initial_state(fused.world_problem(world.t), 8), fused.world_problem(world.t).lane_valid,
                                      world.t["ln"]))
    t["kind"] = torch.zeros((world.t["pod_requests"].shape[0],), dtype=torch.int32)
    t["index"] = torch.zeros_like(t["kind"])
    pc = torch.ones_like(t["kind"], dtype=torch.bool)
    g, gargs = gdev.gate_fused_args(t, pc)
    assert set(g) == set(gdev._GATE_POINTERS) and g["pod_bin"] is None and g["claim_neg"] is g["neg_out"]
    for name in gdev._GATE_POINTERS:
        expected = g[name].data_ptr() if g[name] is not None else None
        assert getattr(gargs, name) == (expected or None), name
    assert g["node_adm"] is world.t["nreq_adm"] and g["claim_active"] is t["claim_open"]


@pytest.mark.cuda
@pytest.mark.parametrize("permute", [True, False])
def test_patch_world_matches_plain(cuda, permute):
    """patch_world against patch_world_plain on the same arguments, bit for
    bit, and the patched world against the cold encode's: on a patch whose
    survivors move both ways (arrivals and deletes) and on a spec change,
    whose survivors keep their rows."""
    prev, args, cold = _churn_world(permute=permute)
    world = fused.adopt_world(prev, 8, cuda)
    before = {k: v.clone() for k, v in world.t.items()}
    up = fused.upload_patch(args, world)
    launches = kernels.LAUNCHES["patch_world"]
    fused.patch_world(world, up)
    assert kernels.LAUNCHES["patch_world"] == launches + 1
    plain = fused.patch_world_plain(before, up)
    torch.cuda.synchronize()
    for name, value in plain.items():
        assert torch.equal(_bits(world.t[name]), _bits(value)), name
    ref = fused.world_tensors(problem_to_torch(cold, cuda))
    for name in ref:
        assert torch.equal(_bits(world.t[name]), _bits(ref[name])), name


def _fused_corruptions(t, C):
    """Copies of ``t`` (a world with a final loop state), each corrupted to
    trip one invariant, as (invariant, tensors)."""
    kind, index = t["kind"].cpu(), t["index"].cpu()
    on_claim = ((kind == 1) | (kind == 2)).nonzero().flatten().tolist()
    c0 = int(index[on_claim[0]])
    mates = [p for p in on_claim if int(index[p]) == c0]
    assert len(mates) > 1 and (kind == 0).any()
    p0 = mates[0]
    out = []

    def variant(name, **edits):
        v = dict(t)
        for key, fn in edits.items():
            v[key] = t[key].clone()
            fn(v[key])
        out.append((name, v))

    variant("claim-requests", claim_requests=lambda x: x[c0, 0].add_(1.0))
    pad_types = (t["it_alloc"][:, 0] < 0).nonzero().flatten().tolist()
    # a padded type fits nothing: listed alone, no listed type holds the claim
    variant("claim-capacity", claim_it_ok=lambda x: (x[c0].fill_(False), x[c0, pad_types[0]].fill_(True)))
    variant("instance-type-survivor", claim_it_ok=lambda x: x[c0, pad_types[0]].fill_(True))
    variant("taint-admissibility", pod_tol_tpl=lambda x: x[p0].fill_(False))
    variant("host-port", pod_ports=lambda x: x.__setitem__((mates[:2], 0), True),
            pod_conflict=lambda x: x[p0, 0].fill_(True))
    variant("requirement-intersection", pod_adm=lambda x: x[p0, 0].fill_(0),
            pod_comp=lambda x: x[p0, 0].fill_(False), pod_def=lambda x: x[p0, 0].fill_(True),
            pod_neg=lambda x: x[p0, 0].fill_(True), claim_adm=lambda x: x[c0, 0].copy_(t["lvw"][0]),
            claim_comp=lambda x: x[c0, 0].fill_(False), claim_def=lambda x: x[c0, 0].fill_(True))
    variant("node-capacity", node_avail=lambda x: x.fill_(0.0))
    return out


@pytest.mark.cuda
def test_fused_gate_matches_plain(cuda):
    """The fused solve (ffd_loop fresh, then gate_counts in its fused mode)
    against the plain loop and gate_counts_plain over gate_args_from_state;
    then the fused gate alone on the loop's state corrupted to trip each
    invariant, against the plain gate on the same tensors."""
    prev, _, _ = _churn_world()
    C = 8
    world = fused.adopt_world(prev, C, cuda)
    P = world.t["pod_requests"].shape[0]
    pc = torch.ones((P,), dtype=torch.bool, device=cuda)
    rk, ck = fused.solve_ffd_fused_gate(world, pc, C)
    rp, cp = fused.solve_ffd_fused_gate_plain(fused.world_problem(world.t), pc, C)
    _assert_same(rk, rp)
    assert torch.equal(ck.cpu(), cp.cpu()) and not ck.any()
    V = world.t["ln"].shape[1]
    t = dict(world.t)
    t.update(ffd_sweeps.state_tensors(rk.state, fused.world_problem(world.t).lane_valid, world.t["ln"]))
    t["kind"], t["index"] = rk.kind, rk.index
    tripped = set()
    for name, v in _fused_corruptions(t, C):
        got = gdev.launch_gate_counts_fused(v, pc).cpu()
        ref = fused.fused_gate_counts(fused.world_problem(v), v["kind"], v["index"],
                                      ffd_sweeps.state_back(v, V), pc, C, False).cpu()
        assert torch.equal(got, ref), (name, got.tolist(), ref.tolist())
        assert got[gdev.INVARIANTS.index(name)] > 0, name
        tripped.add(name)
    assert tripped == set(gdev.INVARIANTS)
