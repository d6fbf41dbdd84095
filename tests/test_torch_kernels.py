"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel-vs-plain tests need an NVIDIA GPU and nvcc; they carry the
``cuda`` marker and skip elsewhere (run them on the card with
``python -m pytest tests/test_torch_kernels.py -m cuda``). chip_smoke.py runs
the same comparisons at the main path's shapes. The rest runs anywhere: the
ctypes argument structs must list the C structs' fields in order, and the
launch wrappers must refuse CPU tensors instead of falling back.
"""

import dataclasses
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS, instance_types
from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
from karpenter_tpu_torch.ops import ffd_step, ffd_sweeps, fused, relax
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
        ("attribute.cu", "AttrArgs", ffd_step._ATTR_POINTERS, ffd_step._ATTR_INTS),
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
    with pytest.raises(ValueError, match="CUDA"):
        ffd_step.launch_attribute(prob, initial_state(prob, 8), [0])
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


@pytest.mark.parametrize("kernel", ["ffd_loop", "gate_counts", "runs_screen", "attribute"])
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
    elif kernel == "attribute":
        prob = problem_to_torch(_encode(W.fuzz_workload(6), 8), "cpu")
        result = ffd_sweeps.solve_ffd_sweeps(prob, 8)
        t, args = ffd_step.attribute_args(prob, result.state, torch.arange(4))
        pointers, state, scratch = ffd_step._ATTR_POINTERS, (), ffd_step.ATTR_SCRATCH
        assert t["rows"].tolist() == [0, 1, 2, 3] and args.B == 4 and args.NB == 4
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
    assert set(kernels.SOURCES) == {"attribute", "ffd_loop", "gate_counts", "patch_world", "relax_place",
                                    "runs_screen"}
    assert set(kernels.LAUNCHES) == set(kernels.SOURCES)


def test_step_is_shared_by_the_loop_and_the_screen():
    """ffd_loop.cu and runs_screen.cu compile the one per-pod step of
    step.cuh: neither defines its own. The loop's one-pass mode writes each
    verdict row from the step's Shared::kind / index right after the call;
    its sweeps modes write every committed chain member's row after the
    narrow iteration of chain.cuh, which evaluates through the same step."""
    step = (CSRC / "step.cuh").read_text()
    assert "__device__ void step(const A& a, int p, Shared& s" in step
    assert "a.kind[" not in step and "a.index[" not in step
    for source in ("ffd_loop.cu", "runs_screen.cu"):
        text = (CSRC / source).read_text()
        assert '#include "step.cuh"' in text
        assert "void step(" not in text and "bool bin_gate(" not in text and "void group_prep(" not in text
    loop = (CSRC / "ffd_loop.cu").read_text()
    assert loop.count("step(a, p, s, s_gmin, s_boot, s_nothing, s_maxcap);\n      if (tid == 0) {\n"
                      "        a.kind[p] = s.kind;\n        a.index[p] = s.index;") == 1
    assert loop.count("narrow_iter(a, p, s, cs, s_gmin, s_boot, s_nothing, s_maxcap);") == 1
    chain = (CSRC / "chain.cuh").read_text()
    assert '#include "step.cuh"' in chain and "step_eval(a, p, s" in chain and "step_commit(a, p, s" in chain
    assert "a.kind[" not in chain and "bool bin_gate(" not in chain


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
    # 1,280 claim slots: V = 1,536 hostname lanes, W = 48 words, with groups
    "topology-3-wide": (lambda: W.topology_workload(3), 1280),
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


PR1_CORPORA = ("chain-2000", "chain-2001-overflow", "fuzz-6", "bounds-0", "topology-3", "topology-3-wide")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PR1_CORPORA)
def test_ffd_loop_matches_plain(cuda, name):
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    bf = problem_bounds_free(prob)
    rk = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf)
    _assert_same(rk, rp)
    assert tuple(int(x) for x in rk.iters) == tuple(rp.iters)
    work = dict(zip(ffd_sweeps.WORK_COUNTERS, rk.work.cpu().tolist()))
    assert work["bin_gates"] >= rp.iters.narrow and work["barriers"] >= 4 * rp.iters.narrow
    init = initial_state(prob, slots)
    rk1 = ffd_sweeps.launch_ffd_loop(prob, init, one_pass=True)
    _assert_same(rk1, solve_ffd_plain(prob, init, bf))


# chain-heavy corpora at 128 slots: chain-3000 commits through every branch
# (waterfill, round, spread mini-scan), chain-3003 most spread commits
CHAIN_CORPORA = {
    "chain-3000": (lambda: W.chain_workload(3000), 128),
    "chain-3003": (lambda: W.chain_workload(3003), 128),
    "diverse-300": (lambda: W.diverse_workload(300, 40, seed=7), 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CHAIN_CORPORA)
def test_ffd_loop_chain_commits_match_plain(cuda, name):
    """The chain commits of ffd_loop's sweeps modes against the plain loop:
    fresh, carried (seeded with all-FAIL verdict rows) and fused (the
    resident world's launch), each exact on kind/index, state and all four
    IterCounts fields."""
    make, slots = CHAIN_CORPORA[name]
    padded = _encode(make(), slots)
    prob = problem_to_torch(padded, cuda)
    bf = problem_bounds_free(prob)
    rk = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf)
    _assert_same(rk, rp)
    assert tuple(int(x) for x in rk.iters) == tuple(rp.iters) and rp.iters.chain_commits > 0
    ck = ffd_sweeps.solve_ffd_sweeps_carried(prob, slots, init=ffd_sweeps.fresh_carry(prob, slots))
    _assert_same(ck, rp)
    assert tuple(int(x) for x in ck.iters) == tuple(rp.iters)
    world = fused.adopt_world(padded, slots, cuda)
    pc = torch.ones((prob.num_pods,), dtype=torch.bool, device=cuda)
    fk, _ = fused.solve_ffd_fused_gate(world, pc, slots, bf)
    _assert_same(fk, rp)
    assert tuple(int(x) for x in fk.iters) == tuple(rp.iters)


# no kernel shape limit: K = 64 keys (40 label keys and the well-known ones,
# bucketed), V = 2,560 value lanes (W = 80 words, two 64-word chunks)
WIDE_CORPORA = {"wide-keys": W.wide_keys_workload, "wide-lanes": W.wide_lanes_workload}


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_CORPORA)
def test_wide_shapes_match_plain(cuda, name):
    """ffd_loop (sweeps and one pass) and runs_screen (stacked, one and three
    passes) at K > 32 and V > 2,048 against their plain versions."""
    prob = problem_to_torch(_encode(WIDE_CORPORA[name](), 32), cuda)
    assert prob.num_keys > 32 or prob.num_lanes > 2048
    bf = problem_bounds_free(prob)
    rk = ffd_sweeps.solve_ffd_sweeps(prob, 32)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, 32), bf)
    _assert_same(rk, rp)
    assert tuple(int(x) for x in rk.iters) == tuple(rp.iters)
    init = initial_state(prob, 32)
    _assert_same(ffd_sweeps.launch_ffd_loop(prob, init, one_pass=True), solve_ffd_plain(prob, init, bf))
    batch = mesh.stack_problems([prob, prob])
    for passes in (1, 3):
        sk = mesh.batched_screen(batch, 32, passes)
        sp = mesh.batched_screen_plain(batch, 32, passes)
        torch.cuda.synchronize()
        assert torch.equal(sk.kind.cpu(), sp.kind.cpu()) and torch.equal(sk.index.cpu(), sp.index.cpu())
        a, b = numpy_fields(sk.state), numpy_fields(sp.state)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


ATTR_CORPORA = ("fuzz-6", "bounds-0", "topology-3", "chain-2001-overflow")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ATTR_CORPORA + tuple(WIDE_CORPORA))
def test_attribute_matches_plain(cuda, name):
    """The attribute kernel against attribute_plain: the words of every
    active row against the final state of the solve, exact."""
    make, slots = CORPORA[name] if name in CORPORA else (WIDE_CORPORA[name], 32)
    prob = problem_to_torch(_encode(make(), slots), cuda)
    result = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    rows = torch.nonzero(prob.pod_active).reshape(-1)
    aprob, state = _lane_align(prob, result.state)
    words, work = ffd_step.launch_attribute(aprob, state, rows)
    plain = ffd_step.attribute_plain(prob, result.state, rows)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), plain.cpu())
    work = dict(zip(ffd_step.ATTR_WORK_COUNTERS, work.cpu().tolist()))
    assert work["bin_gates"] >= rows.numel()


@pytest.mark.cuda
def test_shared_memory_beyond_the_card_is_a_device_error(cuda):
    """A shape whose dynamic shared memory exceeds what a block of the card
    may opt into is a launch the runtime refuses: KernelDeviceError, no
    count, and the next launch runs (the refusal does not linger)."""
    make, slots = CORPORA["fuzz-6"]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    result = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    rows = torch.nonzero(prob.pod_active).reshape(-1)
    aprob, state = _lane_align(prob, result.state)
    t, args = ffd_step.attribute_args(aprob, state, rows)  # t keeps the pointed-to tensors
    args.G = 1 << 20  # 3 G ints of dynamic shared memory: 12 MiB a block
    before = kernels.LAUNCHES["attribute"]
    with pytest.raises(kernels.KernelDeviceError, match="launch error"):
        kernels.launch("attribute", args, torch.cuda.current_stream(cuda).cuda_stream)
    assert kernels.LAUNCHES["attribute"] == before
    words, _ = ffd_step.launch_attribute(aprob, state, rows)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), ffd_step.attribute_plain(prob, result.state, rows).cpu())


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
    assert tuple(int(x) for x in ck.iters) == tuple(cp.iters)


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


# -- runs_screen's stacked mode (the batched programs) -------------------------


# claim slots of a stacked corpus, where not 16: 1,280 slots put 1,280
# hostname lanes in the vocabulary (V = 1,280, W = 40 words)
_STACK_SLOTS = {"distinct-tenants": 1280}


def _distinct_tenant(t):
    """Tenant ``t`` of the distinct-tenants stack: its own catalog size
    (9 + 2t instance types), its own NodePool template and label, and 40
    topology pods (spread, affinity, anti-affinity) from its own seed that
    select its label."""
    rng = random.Random(100 + t)
    its = instance_types(9 + 2 * t)
    tpl = W.simple_template(its, name=f"tenant-{t}", labels={"team": f"t{t}"})
    pods = [W._topology_pod(rng, i) for i in range(40)]
    for pod in pods:
        pod.spec.node_selector = {**(pod.spec.node_selector or {}), "team": f"t{t}"}
    return pods, its, [tpl], []


def _stacked_corpus(name, slots=16):
    """A stack of lanes of equal padded shapes. ``distinct-tenants``: four
    tenants that share nothing but the shapes (catalog, template, vocabulary,
    pods and topology groups are each lane's own), at 1,280 claim slots.
    Else three lanes of one workload's padded problem, the second and third
    with some rows inactive: every problem table is per lane, and the lanes
    differ. ``volumes-0`` carries CSI volume counts, ``topology-3`` nodes,
    groups and filters."""
    if name == "distinct-tenants":
        lanes = [_encode(_distinct_tenant(t), _STACK_SLOTS[name]) for t in range(4)]
        return mesh.stack_problems(lanes), lanes
    if name == "volumes-0":
        (pods, its, tpls, nodes), vols = W.volume_workload(0)
        topo = Topology(domains_from_instance_types(its, tpls), batch_pods=pods, cluster_pods=[])
        for n in nodes:
            topo.register("kubernetes.io/hostname", n.name)
        host = pad_problem(Encoder(FAKE_WELL_KNOWN_LABELS).encode(
            pods, its, tpls, nodes, topology=topo, num_claim_slots=slots, pod_volumes=vols).problem)
    else:
        host = _encode(CORPORA[name][0](), slots)
    lanes = []
    for drop in (0, 3, 2):
        lane = dataclasses.replace(host, pod_active=np.array(host.pod_active, copy=True))
        if drop:
            lane.pod_active[::drop] = False
        lanes.append(lane)
    return mesh.stack_problems(lanes), lanes


def _kernel_lane_offsets():
    """lane_view's stacked offsets in csrc/runs_screen.cu: field -> the
    per-lane element count expression."""
    text = (CSRC / "runs_screen.cu").read_text()
    return dict(re.findall(r"^\s*RS_LANE\((\w+), ([^;]+)\);$", text, re.M))


@pytest.mark.parametrize("name", ["topology-3", "volumes-0", "fuzz-6", "distinct-tenants"])
def test_stacked_lane_offsets_match_the_kernel(name):
    """Every problem table and start-state leaf advances per lane in the
    kernel's stacked view, by the count lane_elems computes, which is each
    stacked tensor's per-lane size, and lane b's slice is lane b's own
    tables."""
    batch, lanes = _stacked_corpus(name)
    batch = problem_to_torch(batch, "cpu")
    slots = _STACK_SLOTS.get(name, 16)
    t, args = mesh.stacked_screen_args(batch, slots, max_run=mesh.max_run_bucket(batch), passes=3,
                                       with_topo=mesh.has_topo_runs(batch))
    assert args.stacked == 1 and args.B == len(lanes)
    assert args.lane_grp_counts0 is None and args.lane_grp_registered0 is None
    offsets = _kernel_lane_offsets()
    assert set(offsets) == set(mesh._RS_SHARED + mesh.RS_INIT)
    env = {f: getattr(args, f) for f in mesh._RS_INTS}
    env["KW"] = env["K"] * env["W"]
    expected = mesh.lane_elems(args)
    for field, expr in offsets.items():
        assert eval(expr, {}, env) == expected[field] == t[field][0].numel(), field
    for b, lane in enumerate(lanes):
        own = mesh._shared_tensors(problem_to_torch(lane, "cpu"))
        for name_, x in own.items():
            assert torch.equal(_bits(t[name_][b]), _bits(x)), (b, name_)
        assert torch.equal(t["pod_active"][b, : lane.pod_active.shape[0]], torch.from_numpy(lane.pod_active))
        init = ffd_sweeps.state_tensors(initial_state(problem_to_torch(lane, "cpu"), slots),
                                        torch.from_numpy(lane.lane_valid), torch.from_numpy(lane.lane_numeric),
                                        prefix="init_")
        for name_, x in init.items():
            assert torch.equal(_bits(t[name_][b]), _bits(x)), (b, name_)


def test_stacked_launch_refuses_cpu_tensors():
    batch, _ = _stacked_corpus("fuzz-6")
    with pytest.raises(ValueError, match="CUDA"):
        mesh.launch_stacked_screen(problem_to_torch(batch, "cpu"), 16, passes=3)


def test_distinct_tenants_share_only_their_shapes():
    """The distinct-tenants stack is what the stacked mode must not confuse:
    every lane's catalog, template, vocabulary and pods differ, each has
    topology groups, and its lane axis is wider than 32 words."""
    _, lanes = _stacked_corpus("distinct-tenants")
    for a in range(len(lanes)):
        x = lanes[a]
        assert x.num_groups > 0 and x.num_lanes > 1024
        for b in range(a):
            y = lanes[b]
            for field in ("it_alloc", "tpl_it_ok", "pod_requests", "grp_type", "pod_grp_match"):
                assert not np.array_equal(getattr(x, field), getattr(y, field)), (a, b, field)
            assert not np.array_equal(x.pod_reqs.admitted, y.pod_reqs.admitted), (a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["topology-3", "volumes-0", "fuzz-6", "chain-2000", "distinct-tenants"])
@pytest.mark.parametrize("passes", [1, 3])
def test_stacked_screen_matches_plain(cuda, name, passes):
    """runs_screen's stacked mode against batched_screen_plain: exact on
    kind, index and every state leaf, floats included."""
    batch, _ = _stacked_corpus(name)
    batch = problem_to_torch(batch, cuda)
    slots = _STACK_SLOTS.get(name, 16)
    rk = mesh.batched_screen(batch, slots, passes=passes)
    rp = mesh.batched_screen_plain(batch, slots, passes=passes)
    torch.cuda.synchronize()
    assert torch.equal(rk.kind.cpu(), rp.kind.cpu()) and torch.equal(rk.index.cpu(), rp.index.cpu())
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        np.testing.assert_array_equal(sk[key], sp[key], err_msg=key)
    assert kernels.LAUNCHES["runs_screen"] > 0
