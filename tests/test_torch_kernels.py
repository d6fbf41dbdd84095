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
from karpenter_tpu_torch.ops import ffd_sweeps, relax
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


def _gate_inputs():
    pods, its, tpls, nodes = W.fuzz_workload(6)
    result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(pods, its, tpls, nodes)
    gp, ga, _ = _build_args(result.verify_ctx, result, pods, None)
    return gp, ga


@pytest.mark.parametrize("kernel", ["ffd_loop", "gate_counts"])
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
    assert set(kernels.SOURCES) == {"ffd_loop", "gate_counts", "relax_place"}


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
