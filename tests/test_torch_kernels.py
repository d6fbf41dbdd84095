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
from karpenter_tpu_torch.ops import ffd_step, ffd_sweeps, fused, policy, relax, relax2
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state, problem_bounds_free
from karpenter_tpu_torch.ops.ffd_step import solve_ffd_plain
from karpenter_tpu_torch.ops.padding import pad_problem
from karpenter_tpu_torch.ops.relax_common import ordered_sum
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
        ("lane_scores.cu", "LaneArgs", policy._LANE_POINTERS, policy._LANE_INTS),
        ("probe.cu", "ProbeArgs", gdev._PROBE_POINTERS, gdev._PROBE_INTS),
        ("ffd_loop.cu", "FfdLanesArgs", ("lanes",), ffd_sweeps._FFD_LANES_INTS),
        ("relax_place.cu", "RelaxLanesArgs", ("lanes",), ("L", "cluster")),
    ],
)
def test_ctypes_struct_matches_c_struct(source, struct, pointers, ints):
    c_pointers, c_ints = _c_struct_fields(source, struct)
    assert c_pointers == list(pointers)
    assert c_ints == list(ints)


def test_relax_args_float_fields_match_c_struct():
    text = (CSRC / "relax_place.cu").read_text()
    body = text[text.index("struct RelaxArgs {"):]
    body = re.sub(r"//.*", "", body[: body.index("};")])
    assert re.findall(r"\bfloat\s+(\w+)\s*;", body) == list(relax._RELAX_FLOATS)


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
        relax2.launch_relax2_place(prob, 8, 24, 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        policy.launch_lane_scores(prob, policy_weights())
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
    carried state copied (a launch leaves its input state alone), the
    gate's workspace one allocation that the kernel writes before it reads
    (nothing zeroed on the host side). chip_smoke.py counts a launch's bytes
    from them."""
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
        inverse = t.pop("inverse")  # each entry's attributed row: host-side, not a kernel argument
        assert t["rows"][inverse].tolist() == [0, 1, 2, 3] and args.B == t["rows"].numel() and args.NB >= 1
        assert int(t["mult"].sum()) == 4 and not t["work"].any() and not t["sections"].any()
    else:
        t, args = gdev.gate_counts_args(*_gate_inputs())
        pointers, state, scratch = gdev._GATE_POINTERS, (), gdev.GATE_SCRATCH
        assert len({t[name].untyped_storage().data_ptr() for name in scratch + ("counts",)}) == 1
        assert args.NB == gdev.gate_blocks() == ffd_sweeps.SOLO_CLUSTER and t["seg_cnt"].shape[0] == args.NB
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
    assert set(kernels.SOURCES) == {"attribute", "ffd_loop", "gate_counts", "lane_scores", "patch_world",
                                    "probe", "relax_place", "runs_screen"}
    # relax_place's convex mode (program 17), the lanes modes of the
    # partitioned solve (programs 13-14) and ffd_loop's wavefront count their
    # launches apart
    assert set(kernels.LAUNCHES) == set(kernels.SOURCES) | {"relax2_place", "ffd_loop_lanes", "relax2_place_lanes",
                                                            "ffd_loop_wavefront"}


def test_step_is_shared_by_the_loop_and_the_screen():
    """ffd_loop.cu and runs_screen.cu compile the one per-pod step of
    step.cuh, a template over its scope (a cluster for the loop; a cluster
    or a lone block for the screen, by its layout): neither defines its
    own. The loop's one-pass mode
    writes each verdict row from the step's Shared::kind / index right after
    the call (the cluster's leader block); its sweeps modes write every
    committed chain member's row after the narrow iteration of chain.cuh,
    which evaluates through the same step. No verdict row is written inside
    step.cuh or chain.cuh."""
    step = (CSRC / "step.cuh").read_text()
    assert "__device__ void step(const S& sc, const A& a, int p, Shared& s" in step
    assert "using BlockScope = Scope<false>;" in step and "using ClusterScope = Scope<true>;" in step
    assert "a.kind[" not in step and "a.index[" not in step
    # one algorithm for both scopes: only the Scope itself branches on them
    assert "S::cluster" not in step
    for source in ("ffd_loop.cu", "runs_screen.cu"):
        text = (CSRC / source).read_text()
        assert '#include "step.cuh"' in text
        assert "void step(" not in text and "bool bin_gate(" not in text and "void group_prep(" not in text
    loop = (CSRC / "ffd_loop.cu").read_text()
    assert loop.count("step(sc, a, p, s, red, m);\n      if (leader && tid == 0) {\n"
                      "        a.kind[p] = s.kind;\n        a.index[p] = s.index;") == 1
    assert loop.count("narrow_iter(sc, a, p, s, cs, red, m);") == 1 and "ClusterScope sc;" in loop
    screen = (CSRC / "runs_screen.cu").read_text()
    assert screen.count("step(sc, a, ") == 2
    chain = (CSRC / "chain.cuh").read_text()
    assert '#include "step.cuh"' in chain and "step_eval(sc, a, p, s" in chain and "step_commit(sc, a, p, s" in chain
    assert "a.kind[" not in chain and "bool bin_gate(" not in chain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(params=[1, 2, 4, 8])
def cluster(request):
    """Every ffd_loop launch of the test on clusters of this many blocks."""
    with ffd_sweeps.forced_cluster(request.param):
        yield request.param


@pytest.fixture(params=[1, 2, 4, 8, 16])
def relax_cluster(request):
    """Every relax_place launch of the test on clusters of this many blocks."""
    with ffd_sweeps.forced_cluster(request.param):
        yield request.param


@pytest.fixture(params=[("block", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8), ("cluster", 16)],
                ids=lambda p: f"{p[0]}{p[1]}")
def screen_layout(request):
    """Every runs_screen launch of the test in this layout."""
    with mesh.forced_screen_plan(*request.param):
        yield request.param


@pytest.fixture(params=[16, 8, 1])
def gate_cluster(request):
    """Every gate_counts launch of the test on a cluster of this many blocks."""
    with ffd_sweeps.forced_cluster(request.param):
        yield request.param


@pytest.fixture(params=["dedup", "every-row"])
def row_plan(request):
    """The attribute launches' row plan: each run of byte-identical rows
    attributed once (the problem's ``pod_eqprev``), or every row (the
    problem without it)."""
    if request.param == "dedup":
        return lambda prob: prob
    return lambda prob: dataclasses.replace(prob, pod_eqprev=None)


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
def test_ffd_loop_matches_plain(cuda, cluster, name):
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
def test_ffd_loop_chain_commits_match_plain(cuda, cluster, name):
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain-3003", "diverse-300"])
def test_ffd_loop_streamed_tables_match_plain(cuda, cluster, name):
    """The plan's other layout on a resident shape: each block reads its slice
    of the type tables from device memory (what a shape whose slice does not
    fit a block's shared memory runs), fresh and one-pass, against the plain
    loops; the launch reports the layout it ran."""
    make, slots = CHAIN_CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    bf = problem_bounds_free(prob)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for one_pass in (False, True):
        t, args = ffd_sweeps.ffd_loop_args(prob, initial_state(prob, slots), one_pass)
        assert args.resident == 1 and args.cluster == cluster
        dims = {k: getattr(args, k) for k in ("G", "R", "C", "TPL", "K", "W", "O", "T")}
        args.resident, args.smem = 0, ffd_sweeps.smem_bytes(dims, cluster, False)
        kernels.launch("ffd_loop", args, stream)
        torch.cuda.synchronize()
        assert t["plan"].cpu().tolist() == [cluster, 0, args.tslice]
        rk = ffd_sweeps.result_of(t, prob.num_lanes, one_pass)
        if one_pass:
            _assert_same(rk, solve_ffd_plain(prob, initial_state(prob, slots), bf))
        else:
            _assert_same(rk, rp)
            assert tuple(int(x) for x in rk.iters) == tuple(rp.iters)


@pytest.mark.cuda
def test_ffd_loop_lanes_beyond_the_card(cuda):
    """20 lanes of 8-block clusters (160 blocks on 132 SMs): the clusters the
    card cannot hold at once wait for a running one; every lane equals the
    plain loop."""
    make, slots = CHAIN_CORPORA["diverse-300"]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), problem_bounds_free(prob))
    with ffd_sweeps.forced_cluster(8):
        ts, _buf, args = ffd_sweeps.ffd_loop_lanes_args([prob] * 20, [initial_state(prob, slots)] * 20)
        assert args.L * args.cluster > ffd_sweeps.CARD_SMS
        kernels.launch("ffd_loop_lanes", args, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    for t in ts:
        assert t["plan"].cpu().tolist()[0] == 8
        rk = ffd_sweeps.result_of(t, prob.num_lanes)
        _assert_same(rk, rp)
        assert tuple(int(x) for x in rk.iters) == tuple(rp.iters)


@pytest.mark.cuda
def test_refused_cluster_is_a_device_error(cuda):
    """A cluster the card cannot schedule (32 blocks; an H100 holds 16 at
    most) raises KernelDeviceError: the launch is neither counted nor run on
    a smaller cluster or one block."""
    make, slots = CORPORA["fuzz-6"]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    before = dict(kernels.LAUNCHES)
    with ffd_sweeps.forced_cluster(32), pytest.raises(kernels.KernelDeviceError):
        ffd_sweeps.solve_ffd_sweeps(prob, slots)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before


# the wavefront (csrc/wave.cuh): tests/test_wavefront_parity.py's corpora, a
# chain-heavy one and fuzz/topology corpora with existing nodes (node lanes)
WAVE_CORPORA = {
    "wave-4000": (lambda: W.wave_workload(4000), 128),
    "wave-4002": (lambda: W.wave_workload(4002), 128),
    "chain-3003": (lambda: W.chain_workload(3003), 128),
    "fuzz-3": (lambda: W.fuzz_workload(3), 32),
    "topology-8": (lambda: W.topology_workload(8), 32),
}


def _assert_same_wave(rk, rp):
    _assert_same(rk, rp)
    assert tuple(int(x) for x in rk.iters) == tuple(int(x) for x in rp.iters)
    assert rk.wave_hist.cpu().tolist() == rp.wave_hist.cpu().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [3, 1])
@pytest.mark.parametrize("name", WAVE_CORPORA)
def test_ffd_loop_wavefront_matches_plain(cuda, cluster, name, lanes):
    """ffd_loop's wavefront against the plain loop in every sweeps mode:
    fresh, carried (all-FAIL seeds), scored (the committed weights), the
    lanes mode (two lanes) and the fused launch; kind/index, state, all
    seven IterCounts fields and wave_hist exact."""
    from karpenter_tpu_torch.solver import ordering

    make, slots = WAVE_CORPORA[name]
    padded = _encode(make(), slots)
    prob = problem_to_torch(padded, cuda)
    bf = problem_bounds_free(prob)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf, wavefront=lanes)
    assert rp.iters.wave_commits + rp.iters.retry_lanes > 0
    _assert_same_wave(ffd_sweeps.solve_ffd_sweeps(prob, slots, wavefront=lanes), rp)
    ck = ffd_sweeps.solve_ffd_sweeps_carried(prob, slots, init=ffd_sweeps.fresh_carry(prob, slots), wavefront=lanes)
    _assert_same_wave(ck, rp)
    scores = policy.lane_scores(prob, ordering.lane_weights_static())
    sp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf, order_scores=scores, wavefront=lanes)
    _assert_same_wave(ffd_sweeps.solve_ffd_sweeps(prob, slots, order_scores=scores, wavefront=lanes), sp)
    for lk in ffd_sweeps.launch_ffd_loop_lanes([prob, prob], [initial_state(prob, slots)] * 2, wavefront=lanes):
        _assert_same_wave(lk, rp)
    world = fused.adopt_world(padded, slots, cuda)
    pc = torch.ones((prob.num_pods,), dtype=torch.bool, device=cuda)
    fk, _ = fused.solve_ffd_fused_gate(world, pc, slots, bf, wavefront=lanes)
    _assert_same_wave(fk, rp)


# no kernel shape limit: K = 64 keys (40 label keys and the well-known ones,
# bucketed), V = 2,560 value lanes (W = 80 words, two 64-word chunks)
WIDE_CORPORA = {"wide-keys": W.wide_keys_workload, "wide-lanes": W.wide_lanes_workload}


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_CORPORA)
def test_wide_shapes_match_plain(cuda, cluster, name):
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
def test_attribute_matches_plain(cuda, row_plan, name):
    """The attribute kernel against attribute_plain: the words of every
    active row against the final state of the solve, exact. The work
    counters count what the launch needs (the gates of the rows it
    attributes, the type tests up to each bin's first survivor), and the
    comparison counters what every entry and every listed type would be,
    the same under either row plan."""
    make, slots = CORPORA[name] if name in CORPORA else (WIDE_CORPORA[name], 32)
    prob = problem_to_torch(_encode(make(), slots), cuda)
    result = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    rows = torch.nonzero(prob.pod_active).reshape(-1)
    aprob, state = _lane_align(prob, result.state)
    words, work = ffd_step.launch_attribute(row_plan(aprob), state, rows)
    plain = ffd_step.attribute_plain(prob, result.state, rows)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), plain.cpu())
    work = dict(zip(ffd_step.ATTR_WORK_COUNTERS, work.cpu().tolist()))
    _, every = ffd_step.launch_attribute(dataclasses.replace(aprob, pod_eqprev=None), state, rows)
    every = dict(zip(ffd_step.ATTR_WORK_COUNTERS, every.cpu().tolist()))
    for key in ("entry_gates", "listed_type_tests"):
        assert work[key] == every[key], key
    assert every["bin_gates"] == every["entry_gates"] >= rows.numel()
    assert work["bin_gates"] <= work["entry_gates"] and work["topo_lanes"] <= every["topo_lanes"]
    assert every["type_tests"] <= every["listed_type_tests"] and work["type_tests"] <= every["type_tests"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain-2000", "diverse-300-overflow", "homogeneous-48"])
def test_attribute_repeated_rows_match_plain(cuda, row_plan, name):
    """Rows repeated and out of order (byte-identical rows apart in the
    list, the same row twice): every entry's words equal attribute_plain's
    on the same list."""
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    result = ffd_sweeps.solve_ffd_sweeps(prob, slots)
    active = torch.nonzero(prob.pod_active).reshape(-1).cpu().numpy()
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(np.concatenate([rng.permutation(active), rng.choice(active, 17)]))
    assert prob.pod_eqprev.cpu().numpy()[rows.numpy()].any(), "the corpus has no run of byte-identical rows"
    aprob, state = _lane_align(prob, result.state)
    words, _ = ffd_step.launch_attribute(row_plan(aprob), state, rows)
    plain = ffd_step.attribute_plain(prob, result.state, rows)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), plain.cpu())


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
@pytest.mark.parametrize("blocks", [16, 4, 1])
def test_gate_shared_memory_mirror_matches_the_kernel(cuda, blocks):
    """verify/device.gate_smem_bytes is the kernel's own carve, and a gate
    over more rows than a block's shared memory holds is refused
    (KernelDeviceError, nothing launched), the next launch running."""
    import ctypes

    pods, its, tpls, nodes = CORPORA["fuzz-6"][0]()
    result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=cuda).solve(pods, its, tpls, nodes)
    gp, ga, bf = _build_args(result.verify_ctx, result, pods, None)
    want = gdev.gate_counts_plain(gp, ga, bf)
    with ffd_sweeps.forced_cluster(blocks):
        t, args = gdev.gate_counts_args(gp, ga)
    lib = kernels.library("gate_counts")
    lib.gate_counts_smem.restype = ctypes.c_longlong
    for P in (args.P, 10_240, 14_336, 100_000):
        args.P = P
        assert lib.gate_counts_smem(ctypes.byref(args)) == gdev.gate_smem_bytes(P, args.C, args.N, args.K, args.NB)
    args.P = gdev.gate_max_rows(args.C, args.N, args.K, args.NB) + 16 * args.NB
    before = kernels.LAUNCHES["gate_counts"]
    with pytest.raises(kernels.KernelDeviceError, match="launch error"):
        kernels.launch("gate_counts", args, torch.cuda.current_stream(cuda).cuda_stream)
    assert kernels.LAUNCHES["gate_counts"] == before
    with ffd_sweeps.forced_cluster(blocks):
        got = gdev.launch_gate_counts(gp, ga)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fuzz-6", "bounds-0"])
def test_gate_counts_matches_plain(cuda, gate_cluster, name):
    pods, its, tpls, nodes = CORPORA[name][0]()
    result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=cuda).solve(pods, its, tpls, nodes)
    gp, ga, bf = _build_args(result.verify_ctx, result, pods, None)
    ck = gdev.launch_gate_counts(gp, ga).cpu()
    assert torch.equal(ck, gdev.gate_counts_plain(gp, ga, bf).cpu())
    assert not ck.any()
    # the solve's own tables (its ffd_loop launch's), as full_gate hands them over
    tables = result.verify_ctx.device_tables
    assert tables is not None
    assert torch.equal(gdev.launch_gate_counts(gp, ga, tables).cpu(), ck)
    # the per-bin sums are the pod-order sums, bit for bit, on every launch
    C, N = ga.claim_tpl.shape[0], gp.node_avail.shape[0]
    pb = ga.pod_bin.long()
    ci = torch.where((pb >= 0) & (pb < C), pb, C)
    ni = torch.where((pb >= C) & (pb < C + N), pb - C, N)
    for _ in range(3):
        t, args = gdev.gate_counts_args(gp, ga)
        kernels.launch("gate_counts", args, torch.cuda.current_stream(cuda).cuda_stream)
        assert torch.equal(t["summed"].cpu(), ordered_sum(ci, gp.pod_requests, C).cpu())
        assert torch.equal(t["nsum"].cpu(), ordered_sum(ni, gp.pod_requests, N).cpu())
        assert torch.equal(t["ngot"].cpu(), torch.bincount(ni, minlength=N + 1)[:N].to(torch.int32).cpu())
    rep = ga.claim_reported.clone()
    rep[0, 0] += 1.0
    bad = ga._replace(claim_reported=rep)
    assert torch.equal(gdev.launch_gate_counts(gp, bad).cpu(), gdev.gate_counts_plain(gp, bad, bf).cpu())


def _gate_corruptions(gp, ga):
    """(name, gp, ga) variants of a result that each trip one invariant
    (others may trip too), as chip_smoke.py phase 1 makes them; a variant
    whose precondition the result lacks is left out."""
    C = ga.claim_tpl.shape[0]
    pod_bin = ga.pod_bin.cpu().numpy()
    placed = np.flatnonzero(pod_bin >= 0)
    on_claims = pod_bin[(pod_bin >= 0) & (pod_bin < C)]
    c0 = int(np.bincount(on_claims).argmax())
    on_c0 = np.flatnonzero(pod_bin == c0)
    p0 = int(on_c0[0])
    out = [("clean", gp, ga)]
    rep = ga.claim_reported.clone()
    rep[c0, 0] += 1.0
    out.append(("claim-requests", gp, ga._replace(claim_reported=rep)))
    out.append(("claim-capacity", gp._replace(it_alloc=torch.full_like(gp.it_alloc, -1.0)), ga))
    out.append(("instance-type-survivor", gp, ga._replace(claim_its=torch.ones_like(ga.claim_its))))
    tol, tn = gp.pod_tol_tpl.clone(), gp.pod_tol_node.clone()
    tol[placed] = False
    tn[placed] = False
    out.append(("taint-admissibility", gp._replace(pod_tol_tpl=tol, pod_tol_node=tn), ga))
    if len(on_c0) >= 2:
        ports, conf = gp.pod_ports.clone(), gp.pod_port_conflict.clone()
        ports[on_c0[0], 0] = True
        conf[on_c0[1], 0] = True
        out.append(("host-port", gp._replace(pod_ports=ports, pod_port_conflict=conf), ga))
    cr, pr = ga.claim_req, gp.pod_reqs
    cadm, ccomp, cdef = cr.admitted.clone(), cr.comp.clone(), cr.defined.clone()
    cadm[c0, 0], ccomp[c0, 0], cdef[c0, 0] = False, False, True
    padm, pcomp, pdef = pr.admitted.clone(), pr.comp.clone(), pr.defined.clone()
    padm[p0, 0], pcomp[p0, 0], pdef[p0, 0] = gp.lane_valid[0], False, True
    chk = ga.pod_check.clone()
    chk[p0] = True
    out.append(("requirement-intersection", gp._replace(pod_reqs=type(pr)(padm, pcomp, pr.gt, pr.lt, pdef)),
                ga._replace(claim_req=type(cr)(cadm, ccomp, cr.gt, cr.lt, cdef), pod_check=chk)))
    if (pod_bin >= C).any():
        out.append(("node-capacity", gp._replace(node_avail=torch.zeros_like(gp.node_avail)), ga))
    return out


@pytest.mark.cuda
def test_gate_counts_corruptions_match_plain(cuda, gate_cluster):
    """Results corrupted to trip each of the seven invariants, on the
    corpora of chip_smoke.py phase 1: the kernel's counts equal
    gate_counts_plain's on every variant, and every invariant fires."""
    tripped = set()
    for wl in (W.fuzz_workload(1), W.topology_workload(0), W.bounds_workload(0), W.chain_workload(2000),
               W.homogeneous_workload(48), W.diverse_workload(300, 40, seed=7)):
        pods, its, tpls, nodes = wl
        result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=cuda, relax=False).solve(pods, its, tpls, nodes)
        if result.verify_ctx is None:
            continue  # a result the device gate does not apply to (as in chip_smoke.py)
        gp, ga, bf = _build_args(result.verify_ctx, result, pods, None)
        for name, g1, a1 in _gate_corruptions(gp, ga):
            ck = gdev.launch_gate_counts(g1, a1).cpu()
            assert torch.equal(ck, gdev.gate_counts_plain(g1, a1, bf).cpu()), name
            assert (not ck.any()) if name == "clean" else ck[gdev.INVARIANTS.index(name)] > 0, name
            tripped.add(name)
    assert tripped == {"clean", *gdev.INVARIANTS}


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
    nf = len(fused._LEAF_FIELDS)
    table = up.buffer[up.args.leaves - up.buffer.data_ptr():].view(torch.int64)
    rows = [n for n in fused.PATCH_ROWS if world.t[n].numel()]
    assert up.args.L == len(rows) and up.args.FL == len(fused.PATCH_FULL)
    assert (up.args.K, up.args.W) == tuple(world.t["lvw"].shape) and up.args.lvw == world.t["lvw"].data_ptr()
    for i, name in enumerate(rows):
        prev_ptr, out_ptr, stk_ptr, row_bytes, stk_row, op, aux = table[nf * i: nf * i + nf].tolist()
        assert (prev_ptr, out_ptr) == (world.t[name].data_ptr(), world.spare[name].data_ptr())
        assert row_bytes * world.t[name].shape[0] == world.t[name].numel() * world.t[name].element_size()
        if name == "pod_neg":
            assert (stk_ptr, op) == (0, fused.OP_NEG)
            continue
        stk = up.shipped[name]
        assert stk_ptr == stk.data_ptr() and stk_row * stk.shape[0] == stk.numel() * stk.element_size()
        assert op == (fused.OP_PACK if name.endswith("_adm") else fused.OP_COPY)
        assert aux == (rows.index("pod_neg") if name == "pod_adm" else -1)
    for j, (name, _) in enumerate(fused.PATCH_FULL):
        _, out_ptr, src_ptr, nbytes, _, op, _ = table[nf * (len(rows) + j): nf * (len(rows) + j) + nf].tolist()
        assert (out_ptr, src_ptr, nbytes, op) == (
            world.t[name].data_ptr(), up.full[name].data_ptr(), up.full[name].numel() * up.full[name].element_size(),
            fused.OP_COPY)
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


def _self_splice(workload, pattern: str):
    """(padded world, patch arguments) of a patch that ships some of a
    problem's own rows again over its padded world (the patched world equals
    the world): ``thirds`` every third row, ``ends`` the first and the last
    rows, ``all`` every row, ``none`` only the pad rows."""
    prob = Encoder().encode(*workload[:3], num_claim_slots=8).problem
    prev = pad_problem(prob)
    P = np.asarray(prob.pod_requests).shape[0]
    rows_prev = np.arange(P)
    if pattern == "thirds":
        rows_prev[::3] = -1
    elif pattern == "ends":
        rows_prev[[0, P - 1]] = -1
    elif pattern == "all":
        rows_prev[:] = -1
    return prev, fused.build_patch_args(prob, rows_prev, fused.leaf_shapes(prev))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["thirds", "ends", "all", "none"])
@pytest.mark.parametrize("name", ["bounds-0", "fuzz-6", "wide-keys", "wide-lanes"])
def test_patch_world_packs_shipped_rows_on_the_card(cuda, name, pattern):
    """The upload ships rows in the encoder's form and the kernel packs them
    (lane words, polarity against the world's lanes, integer bounds among
    them): on a patch that ships a problem's own rows, kernel == plain bit
    for bit and the world is unchanged, at K > 32 and V > 2,048 too."""
    make = {"bounds-0": lambda: W.bounds_workload(0), "fuzz-6": lambda: W.fuzz_workload(6), **WIDE_CORPORA}[name]
    prev, args = _self_splice(make(), pattern)
    world = fused.adopt_world(prev, 8, cuda)
    before = {k: v.clone() for k, v in world.t.items()}
    up = fused.upload_patch(args, world)
    launches = kernels.LAUNCHES["patch_world"]
    fused.patch_world(world, up)
    assert kernels.LAUNCHES["patch_world"] == launches + 1
    plain = fused.patch_world_plain(before, up)
    torch.cuda.synchronize()
    for name_, value in plain.items():
        assert torch.equal(_bits(world.t[name_]), _bits(value)), name_
        if name_ in fused.PATCH_ROWS:
            assert torch.equal(_bits(world.t[name_]), _bits(before[name_])), name_


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
def test_fused_gate_matches_plain(cuda, gate_cluster):
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


# -- convex phase 1 (program 17), lane scores and the scored loop (program 6) --


def policy_weights(seed=None, hidden=0):
    """The committed lane head, or a seeded random head (an MLP with
    ``hidden`` units), as solver/ordering's static tuple."""
    from karpenter_tpu_torch.solver import ordering

    if seed is None:
        ordering.reset_for_tests()
        return ordering.lane_weights_static()
    rng = np.random.default_rng(seed)
    rows = tuple(tuple(float(x) for x in rng.normal(size=policy.N_LANE_FEATURES)) for _ in range(hidden))
    w = tuple(float(x) for x in rng.normal(size=hidden or policy.N_LANE_FEATURES))
    return ("mlp" if hidden else "linear", w, float(rng.normal()),
            (rows, tuple(float(x) for x in rng.normal(size=hidden))) if hidden else None)


RELAX2_CORPORA = ("homogeneous-48", "diverse-300-overflow", "bounds-0-free", "fuzz-6")


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [(24, 0.3), (1, 50.0)])
@pytest.mark.parametrize("name", RELAX2_CORPORA)
def test_relax2_place_matches_plain(cuda, name, knobs):
    """relax_place's convex mode against relax2_place_plain: kind, index,
    residue, integer and bool state and every stat exact (the residual and
    the overload bit for bit), float state within rtol 1e-5."""
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    iters, step = knobs
    before = kernels.LAUNCHES["relax2_place"]
    rk = relax2.launch_relax2_place(prob, slots, iters, step)
    assert kernels.LAUNCHES["relax2_place"] == before + 1
    rp = relax2.relax2_place_plain(prob, slots, iters, step)
    for key in ("kind", "index", "residue_active"):
        assert torch.equal(getattr(rk, key).cpu(), getattr(rp, key).cpu()), key
    assert relax2.host_stats(rk.stats) == relax2.host_stats(rp.stats)
    _assert_same(rk, rp)
    work = dict(zip(relax.WORK_COUNTERS, rk.work.cpu().tolist()))
    assert work["pgd_columns"] > 0 or relax2.host_stats(rp.stats).eligible == 0


def _assert_relax_bits(rk, rp):
    """Two phase-1 results equal bit for bit: verdicts, residue, stats (the
    raw words) and every state leaf (float leaves as their bits)."""
    for key in ("kind", "index", "residue_active"):
        assert torch.equal(getattr(rk, key).cpu(), getattr(rp, key).cpu()), key
    words = lambda st: [int(x.reshape(()).view(torch.int32)) if x.dtype == torch.float32 else int(x) for x in st]
    assert words(rk.stats) == words(rp.stats)
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        np.testing.assert_array_equal(sk[key].view(np.uint8), sp[key].view(np.uint8), err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("convex", [None, (24, 0.3)], ids=["waterfill", "convex"])
@pytest.mark.parametrize("name", ["homogeneous-48", "diverse-300-overflow", "fuzz-6", "chain-2000"])
def test_relax_place_at_each_cluster_size_matches_plain(cuda, relax_cluster, name, convex):
    """relax_place on clusters of 1 to 16 blocks: the launch runs on the
    forced cluster and equals its plain version bit for bit, in both
    modes."""
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32

    make, slots = CORPORA[name]
    prob = _pad_lanes_mult32(problem_to_torch(_encode(make(), slots), cuda))
    t, state0, args = relax.relax_place_args(prob, slots, convex)
    assert args.cluster == relax_cluster
    kernels.launch("relax_place", args, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert int(t["plan"][0]) == relax_cluster
    rk = relax._relax_out(t, state0, prob.num_lanes, convex)
    if convex is None:
        rp = relax.relax_place_plain(prob, slots)
    else:
        rk = rk._replace(stats=relax2.stats_of(rk.stats))
        rp = relax2.relax2_place_plain(prob, slots, *convex)
    _assert_relax_bits(rk, rp)
    sections = t["sections"].cpu()
    assert int(sections.sum()) > 0 and len(sections) == len(relax.SECTIONS)


@pytest.mark.cuda
def test_relax_place_refuses_a_cluster_the_card_cannot_hold(cuda):
    """A plan of 32 blocks a cluster is refused at the launch (nothing
    runs), and a plan made for another cluster than the launch's traps
    rather than run in that shape: here the refusal."""
    prob = problem_to_torch(_encode(W.fuzz_workload(6), 16), cuda)
    with ffd_sweeps.forced_cluster(32):
        with pytest.raises(kernels.KernelDeviceError):
            relax.relax_place(prob, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_relax_place_convex_lanes_at_each_cluster_size(cuda, monkeypatch, size):
    """Program 14's convex lanes on clusters of 1-8 blocks a lane equal one
    single convex launch per lane and the plain phase 1 bit for bit."""
    batch, C = _shard_batch(cuda, monkeypatch, "relax2-fleet-160")
    iters, step = relax2.pgd_iters(), relax2.pgd_step()
    problems = mesh._shard_lanes(batch)
    with ffd_sweeps.forced_cluster(size):
        lanes, _buf, args = relax.relax_place_lanes_args(problems, C, (iters, step))
        assert args.cluster == size
        kernels.launch("relax2_place_lanes", args, torch.cuda.current_stream(cuda).cuda_stream)
        torch.cuda.synchronize()
    for (t, st), p in zip(lanes, problems):
        assert int(t["plan"][0]) == size
        out = relax._relax_out(t, st, p.num_lanes, (iters, step))
        out = out._replace(stats=relax2.stats_of(out.stats))
        _assert_relax_bits(out, relax2.launch_relax2_place(p, C, iters, step))
        _assert_relax_bits(out, relax2.relax2_place_plain(p, C, iters, step))


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["residual", "full", "full-topology"])
def test_runs_screen_in_each_layout_matches_plain(cuda, screen_layout, corpus):
    """test_runs_screen_matches_plain in every layout the plan can pick and
    at every cluster size: the launch ran in the forced layout, and equals
    the plain screen exactly."""
    from karpenter_tpu_torch.disruption import batch
    from karpenter_tpu_torch.testing import workloads as wl

    n = 10
    base_pods = {
        "residual": wl.pinned_base_pods(8, cpu=63.5),
        "full": wl.pinned_base_pods(8, cpu=63.5),
        "full-topology": wl.zonal_spread_pods(6),
    }[corpus]
    scorer = batch.build_bench_scorer(n, base_pods=base_pods, device=cuda, delta=corpus == "residual")[0]
    subsets = [list(range(k + 1)) for k in range(n)] + [[k] for k in range(n)] + [[1, 3, 5, 7, 9]]
    seen = {}
    real_args = mesh._launch_args

    def recording(*a, **kw):
        out = real_args(*a, **kw)
        seen["t"] = out[0]
        return out

    real_lean, real_res = batch.lean_screen, batch.residual_screen

    def lean(base, variants, C, passes=3):
        rk = real_lean(base, variants, C, passes)
        seen["full"] = (rk, mesh.lean_screen_plain(base, variants, C, passes))
        return rk

    def res(base, carried, variants, run_idx, C):
        rk = real_res(base, carried, variants, run_idx, C)
        seen["residual"] = (rk, mesh.residual_screen_plain(base, carried, variants, run_idx, C))
        return rk

    mesh._launch_args = recording
    batch.lean_screen, batch.residual_screen = lean, res
    try:
        scorer.score_subsets(subsets)
    finally:
        mesh._launch_args = real_args
        batch.lean_screen, batch.residual_screen = real_lean, real_res
    torch.cuda.synchronize()
    layout, size = screen_layout
    assert seen["t"]["plan"].cpu().tolist() == [mesh.SCREEN_LAYOUTS.index(layout), size, 512]
    rk, rp = seen["residual" if corpus == "residual" else "full"]
    assert torch.equal(rk.kind.cpu(), rp.kind.cpu()) and torch.equal(rk.index.cpu(), rp.index.cpu())
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        np.testing.assert_array_equal(sk[key].view(np.uint8), sp[key].view(np.uint8), err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["topology-3", "volumes-0", "fuzz-6", "chain-2000", "distinct-tenants"])
def test_stacked_screen_in_each_layout_matches_plain(cuda, screen_layout, name):
    """runs_screen's stacked mode (three passes) in every layout and
    cluster size against batched_screen_plain, bit for bit."""
    batch, _ = _stacked_corpus(name)
    batch = problem_to_torch(batch, cuda)
    slots = _STACK_SLOTS.get(name, 16)
    t, args = mesh.stacked_screen_args(batch, slots, max_run=mesh.max_run_bucket(batch), passes=3,
                                       with_topo=mesh.has_topo_runs(batch))
    kernels.launch("runs_screen", args, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    layout, size = screen_layout
    assert t["plan"].cpu().tolist() == [mesh.SCREEN_LAYOUTS.index(layout), size, 512]
    rk = mesh.FFDResult(kind=t["kind"], index=t["index"], state=mesh.state_back(t, t["ln"].shape[-1]), work=t["work"])
    rp = mesh.batched_screen_plain(batch, slots, passes=3)
    assert torch.equal(rk.kind.cpu(), rp.kind.cpu()) and torch.equal(rk.index.cpu(), rp.index.cpu())
    sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
    for key in sp:
        np.testing.assert_array_equal(sk[key].view(np.uint8), sp[key].view(np.uint8), err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["committed", "linear", "mlp"])
@pytest.mark.parametrize("name", ["fuzz-6", "topology-3", "chain-2000", "diverse-300-overflow"])
def test_lane_scores_matches_plain(cuda, name, head):
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    weights = {"committed": policy_weights(), "linear": policy_weights(5), "mlp": policy_weights(6, hidden=4)}[head]
    scores, feats = policy.launch_lane_scores(prob, weights, with_features=True)
    torch.testing.assert_close(feats.cpu(), policy.lane_features(prob).cpu(), rtol=0, atol=1e-6)
    torch.testing.assert_close(scores.cpu(), policy.lane_scores_plain(prob, weights).cpu(), rtol=0, atol=1e-6)
    # the solve's launch writes the scores alone, the same ones
    bare, none = policy.launch_lane_scores(prob, weights)
    assert none is None and torch.equal(bare, scores)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [0, 4, 70, 300])
@pytest.mark.parametrize("name", ["fuzz-6", "topology-3", "diverse-300-overflow", "wide-keys", "wide-lanes"])
def test_lane_scores_over_the_solves_tables_match_plain(cuda, name, hidden):
    """The scorer over the tables the solve's loop reads (problem_tensors),
    at K > 32 and V > 2,048 and with tanh heads wider than the kernel's
    shared-memory tile: within 1e-6 of plain, one launch; the head's device
    copy made once."""
    make, slots = {**CORPORA, **{k: (v, 32) for k, v in WIDE_CORPORA.items()}}[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    weights = policy_weights(hidden + 1, hidden=hidden)
    if hidden:  # output weights scaled so that the scores stay a few units wide
        weights = (weights[0], tuple(0.1 * x for x in weights[1]), weights[2], weights[3])
    tables = ffd_sweeps.problem_tensors(prob)
    launches = kernels.LAUNCHES["lane_scores"]
    scores, feats = policy.launch_lane_scores(prob, weights, with_features=True, tables=tables)
    assert kernels.LAUNCHES["lane_scores"] == launches + 1
    torch.testing.assert_close(feats.cpu(), policy.lane_features(prob).cpu(), rtol=0, atol=1e-6)
    torch.testing.assert_close(scores.cpu(), policy.lane_scores_plain(prob, weights).cpu(), rtol=0, atol=1e-6)
    assert policy.head_weights(weights, cuda) is policy.head_weights(weights, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("relax", [False, True])
def test_policy_solve_builds_its_tables_once(cuda, monkeypatch, relax):
    """The learned order's solve on the card: the scorer and the loop read
    one build of the problem's tables (problem_tensors runs once), with one
    lane_scores and one ffd_loop launch, and places what the plain solve
    places."""
    from karpenter_tpu_torch.solver import ordering

    monkeypatch.setenv("KARPENTER_TPU_ORDER_POLICY", "1")
    ordering.reset_for_tests()
    built = []
    real = ffd_sweeps.problem_tensors

    def counting(problem):
        built.append(problem.num_pods)
        return real(problem)

    monkeypatch.setattr(ffd_sweeps, "problem_tensors", counting)
    import karpenter_tpu_torch.solver.torch_backend as TB

    monkeypatch.setattr(TB, "problem_tensors", counting)
    workload = W.diverse_workload(300, 40, seed=7)
    kernels.reset_launches()
    r = TorchSolver(device=cuda, relax=relax, initial_claim_slots=32).solve(*workload)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lane_scores"] == 1 and kernels.LAUNCHES["ffd_loop"] == 1
    assert len(built) == 1, built
    rp = TorchSolver(device="cpu", relax=relax, initial_claim_slots=32).solve(*workload)
    assert r.num_scheduled() == rp.num_scheduled() and len(r.new_claims) == len(rp.new_claims)
    ordering.reset_for_tests()


@pytest.mark.cuda
@pytest.mark.parametrize("scores", ["lane", "ties"])
@pytest.mark.parametrize("name", ["topology-3", "chain-2000", "homogeneous-48", "diverse-300-overflow"])
def test_ffd_loop_order_scores_match_plain(cuda, cluster, name, scores):
    """The scored requeue: ffd_loop fresh and carried (from phase 1) with
    order scores against the plain loop with the same scores; kind, index,
    state and all four IterCounts exact. ``ties`` scores take three values,
    signed zeros among them, so the stable order decides most of the sort."""
    make, slots = CORPORA[name]
    prob = problem_to_torch(_encode(make(), slots), cuda)
    if scores == "lane":
        sc = policy.lane_scores(prob, policy_weights())
    else:
        rng = np.random.default_rng(7)
        sc = torch.from_numpy(rng.choice(np.array([-0.0, 0.0, 1.5], np.float32), size=prob.num_pods)).to(cuda)
    bf = problem_bounds_free(prob)
    rk = ffd_sweeps.solve_ffd_sweeps(prob, slots, order_scores=sc)
    rp = ffd_sweeps.sweeps_plain(prob, initial_state(prob, slots), bf, order_scores=sc)
    _assert_same(rk, rp)
    assert tuple(int(x) for x in rk.iters) == tuple(rp.iters)
    xp = relax.relax_place_plain(prob, slots)
    if int(xp.stats.placed) > 0:
        residue = dataclasses.replace(prob, pod_active=xp.residue_active)
        ck = ffd_sweeps.solve_ffd_sweeps_carried(residue, slots, init=(xp.state, xp.kind, xp.index), order_scores=sc)
        aprob, state = _lane_align(residue, xp.state)
        cp = ffd_sweeps.sweeps_plain(aprob, state, problem_bounds_free(aprob), xp.kind, xp.index, sc)
        _assert_same(ck, cp)
        assert tuple(int(x) for x in ck.iters) == tuple(cp.iters)


def test_lanes_and_probe_wrappers_refuse_cpu_tensors():
    prob = problem_to_torch(_encode(W.fuzz_workload(1), 8), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ffd_sweeps.launch_ffd_loop_lanes([prob], [initial_state(prob, 8)])
    with pytest.raises(ValueError, match="CUDA"):
        relax.launch_relax_place_lanes([prob], 8, (24, 0.3))
    with pytest.raises(ValueError, match="CUDA"):
        gdev.launch_probe(torch.arange(16, dtype=torch.float32))


# -- the partitioned solve's lane grids (programs 13-14) and the probe (18) ---

SHARD_CORPORA = {
    "plain-0": (lambda: W.shard_plain_workload(0), {}),
    "ports-1": (lambda: W.shard_ports_workload(1), {}),
    "topology-0": (lambda: W.shard_topology_workload(0), {}),
    "relax2-fleet-160": (lambda: W.shard_relax2_workload(), {"KARPENTER_TPU_RELAX2": "1",
                                                              "KARPENTER_TPU_SHARD_MIN_PODS": "20"}),
}


def _shard_batch(device, monkeypatch, name):
    """The stacked batch and claim bucket a sharded solve of corpus ``name``
    dispatches, recorded at its dispatch (8 partitions, one device)."""
    make, env = SHARD_CORPORA[name]
    for k, v in {"KARPENTER_TPU_SHARD": "1", "KARPENTER_TPU_SHARD_MIN_PODS": "2",
                 "KARPENTER_TPU_SHARD_MIN_DEVICES": "1", "KARPENTER_TPU_SHARD_PARTITIONS": "8", **env}.items():
        monkeypatch.setenv(k, v)
    seen = {}
    entry = "shard_relax2_sweeps" if env.get("KARPENTER_TPU_RELAX2") else "shard_sweeps"
    orig = getattr(mesh, entry)

    def recording(batch, max_claims, *args, **kwargs):
        seen["batch"], seen["C"] = batch, max_claims
        return orig(batch, max_claims, *args, **kwargs)

    monkeypatch.setattr(mesh, entry, recording)
    solver = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=device)
    solver.solve(*make())
    assert solver.last_shard["reason"] is None, solver.last_shard
    return seen["batch"], seen["C"]


def _assert_bitwise(ra, rb):
    """Two kernel results equal bit for bit: verdicts, every state leaf
    (float leaves as their bits) and IterCounts. The work counters may
    differ: the claims x types test skips a claim another warp's survivor
    already beat, so the type tests counted depend on the warps' timing."""
    assert torch.equal(ra.kind, rb.kind) and torch.equal(ra.index, rb.index)
    sa, sb = numpy_fields(ra.state), numpy_fields(rb.state)
    for key in sb:
        np.testing.assert_array_equal(sa[key].view(np.uint8), sb[key].view(np.uint8), err_msg=key)
    assert tuple(int(x) for x in ra.iters) == tuple(int(x) for x in rb.iters)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plain-0", "ports-1", "topology-0"])
def test_ffd_loop_lanes_match_single_launches_and_plain(cuda, cluster, monkeypatch, name):
    """Program 13: the lanes mode's launch equals one single-lane launch per
    lane bit for bit, and the plain loop per lane."""
    batch, C = _shard_batch(cuda, monkeypatch, name)
    before = kernels.LAUNCHES["ffd_loop_lanes"]
    lanes = mesh.shard_sweeps(batch, C)
    assert kernels.LAUNCHES["ffd_loop_lanes"] == before + 1
    plain = mesh.shard_sweeps_plain(batch, C)
    problems = mesh._shard_lanes(batch)
    assert len(lanes) == len(plain) == len(problems) == batch.pod_active.shape[0]
    for p, rk, rp in zip(problems, lanes, plain):
        _assert_bitwise(rk, ffd_sweeps.launch_ffd_loop(p, initial_state(p, C), one_pass=False))
        _assert_same(rk, rp)
        assert tuple(int(x) for x in rk.iters) == tuple(rp.iters)


@pytest.mark.cuda
def test_relax_place_convex_lanes_match_single_launches_and_plain(cuda, monkeypatch):
    """Program 14: the convex lanes launch equals one convex launch per lane
    bit for bit and the plain phase 1 per lane; then the seeded ffd_loop
    lanes launch equals single carried launches and the plain carried loop."""
    batch, C = _shard_batch(cuda, monkeypatch, "relax2-fleet-160")
    iters, step = relax2.pgd_iters(), relax2.pgd_step()
    problems = mesh._shard_lanes(batch)
    before = kernels.LAUNCHES["relax2_place_lanes"]
    outs = relax2.launch_relax2_place_lanes(problems, C, iters, step)
    assert kernels.LAUNCHES["relax2_place_lanes"] == before + 1
    results, stats = mesh.shard_relax2_sweeps(batch, C, iters, step)
    plain, plain_stats = mesh.shard_relax2_sweeps_plain(batch, C, iters, step)
    for b, p in enumerate(problems):
        one = relax2.launch_relax2_place(p, C, iters, step)
        for key in ("kind", "index", "residue_active"):
            assert torch.equal(getattr(outs[b], key), getattr(one, key)), key
        assert relax2.host_stats(outs[b].stats) == relax2.host_stats(one.stats) == relax2.host_stats(stats[b])
        rp = relax2.relax2_place_plain(p, C, iters, step)
        _assert_same(outs[b], rp)
        ks, ps = relax2.host_stats(outs[b].stats), relax2.host_stats(plain_stats[b])
        assert ks._replace(residual=0.0, capviol=0.0) == ps._replace(residual=0.0, capviol=0.0)
        np.testing.assert_allclose([ks.residual, ks.capviol], [ps.residual, ps.capviol], rtol=1e-5, atol=1e-6)
        residue, state = _lane_align(dataclasses.replace(p, pod_active=one.residue_active), one.state)
        single = ffd_sweeps.launch_ffd_loop(residue, state, one_pass=False, kind0=one.kind, index0=one.index)
        _assert_bitwise(results[b], single)
        _assert_same(results[b], plain[b])
        assert tuple(int(x) for x in results[b].iters) == tuple(plain[b].iters)


@pytest.mark.cuda
def test_probe_kernel_matches_plain(cuda):
    """Program 18: the probe kernel's index-order float32 sum equals the
    plain sum bit for bit; arange(16) passes the probe, a wrong input fails
    it, and a count outside 1..32 is refused."""
    x = torch.arange(16, dtype=torch.float32, device=cuda)
    assert float(gdev.launch_probe(x).cpu()[0]) == 120.0
    rng = np.random.default_rng(18)
    for n in (1, 7, 16, 32):
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e3)
        got = gdev.launch_probe(v.to(cuda)).cpu()
        assert got.view(torch.int32).item() == gdev.probe_sum_plain(v).view(torch.int32).item()
    assert gdev.probe_device(cuda)
    assert not gdev.probe_device(cuda, torch.arange(16, dtype=torch.float32) + 1)
    with pytest.raises(ValueError):
        gdev.launch_probe(torch.zeros(33, dtype=torch.float32, device=cuda))


@pytest.mark.cuda
def test_operator_build_thread_holds_readyz(cuda):
    """``Operator.start()`` on the card builds the kernels on a thread of its
    own; /readyz answers 200 once it ends and /debug/programs lists every
    library built."""
    import json
    import socket
    import urllib.request

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.operator import Operator, Options

    with socket.socket() as s1, socket.socket() as s2:
        s1.bind(("127.0.0.1", 0))
        s2.bind(("127.0.0.1", 0))
        port, health = s1.getsockname()[1], s2.getsockname()[1]
    op = Operator(FakeCloudProvider(), Options(metrics_port=port, health_probe_port=health))
    op.start()
    try:
        assert op._warm_thread is not None
        op._warm_thread.join(900)
        assert urllib.request.urlopen(f"http://127.0.0.1:{health}/readyz", timeout=5).status == 200
        programs = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/programs", timeout=5).read())
        assert programs["kernels"]["built"] == len(kernels.SOURCES)
    finally:
        op.stop()

