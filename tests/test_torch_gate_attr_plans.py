"""The launch plans of ``gate_counts`` and ``attribute``, and the tables
their wrappers take from the solve, on the CPU.

``gate_counts`` (csrc/gate_counts.cu) runs one launch on a thread-block
cluster of ``verify/device.gate_blocks()`` blocks (a lone solve's cluster,
``ops/ffd_sweeps.cluster_size``; ``forced_cluster`` overrides it), each
block's shared memory growing with its segment of the rows
(``gate_smem_bytes``). ``attribute`` (csrc/attribute.cu) attributes one row
of each run of byte-identical rows (``ops/ffd_step.attr_row_plan``) with
teams as wide as the row count allows (``attr_team_warps``). Both wrappers
read the problem's tables the solve's ``ffd_loop`` launch packed
(``FFDResult.tables``) when handed them, and cut their scratch from one
allocation (``kernels.workspace``). The kernels themselves are held to their
plain versions in every layout by tests/test_torch_kernels.py's card tests.
"""

import dataclasses
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.models.problem import problem_to_torch
from karpenter_tpu_torch.ops import ffd_step, ffd_sweeps
from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import workloads as W
from karpenter_tpu_torch.verify import device as gdev
from karpenter_tpu_torch.verify.gate import _build_args
from tests.test_torch_kernels import _encode, _gate_inputs

CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _constants(source: str, prefix: str) -> dict:
    text = (CSRC / source).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(rf"\b({prefix}\w*) = (\d+)", text)}


def test_gate_kernel_constants_match_the_wrapper():
    """The section slots the kernel writes are the wrapper's."""
    gs = _constants("gate_counts.cu", "GS")
    assert gs["GSEC"] == len(gdev.GATE_SECTIONS)
    assert "GS_BLOCK_BARRIERS = GSEC, GS_CLUSTER_BARRIERS = GSEC + 1, GSLOTS = GSEC + 2" in (
        CSRC / "gate_counts.cu").read_text()
    stages = sorted((v, k) for k, v in gs.items() if k.startswith("GS_") and v < gs["GSEC"])
    assert [k[3:].lower() for _, k in stages] == list(gdev.GATE_SECTIONS)


def test_attribute_kernel_constants_match_the_wrapper():
    asec = _constants("attribute.cu", "ASEC")
    assert asec["ASEC"] == len(ffd_step.ATTR_SECTIONS)
    names = {"PREP": "prep", "BINS": "bins", "PREP2": "prep_templates", "TPLS": "templates", "WORDS": "words",
             "NODE_GATE": "node_gate", "CLAIM_GATE": "claim_gate", "CLAIM_TYPES": "claim_types",
             "TPL_GATE": "template_gate", "TPL_TYPES": "template_types", "LOAD": "load"}
    for key, name in names.items():
        assert asec[f"ASEC_{key}"] == ffd_step.ATTR_SECTIONS.index(name), key


def test_gate_cluster_is_sixteen_blocks_unless_forced():
    """The gate runs on a lone solve's cluster; the one override of the
    cluster size (ffd_sweeps.forced_cluster) reaches it too."""
    assert gdev.gate_blocks() == ffd_sweeps.SOLO_CLUSTER == ffd_sweeps.cluster_size() == 16
    with ffd_sweeps.forced_cluster(8):
        assert gdev.gate_blocks() == 8
        with ffd_sweeps.forced_cluster(1):
            assert gdev.gate_blocks() == 1
        assert gdev.gate_blocks() == 8
    assert gdev.gate_blocks() == 16
    for blocks in (0, 65):
        with pytest.raises(ValueError):
            with ffd_sweeps.forced_cluster(blocks):
                pass


def test_forced_cluster_reaches_the_gate_in_its_thread_only():
    """Two threads whose overrides interleave each see their own."""
    seen = {}
    barrier = threading.Barrier(2)

    def run(name, blocks):
        with ffd_sweeps.forced_cluster(blocks):
            barrier.wait()
            seen[name] = gdev.gate_blocks()
            barrier.wait()

    threads = [threading.Thread(target=run, args=("a", 2)), threading.Thread(target=run, args=("b", 4))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"a": 2, "b": 4}


def test_gate_args_carry_the_plan_and_one_workspace():
    gp, ga = _gate_inputs()
    for blocks in (16, 2, 1):
        with ffd_sweeps.forced_cluster(blocks):
            t, args = gdev.gate_counts_args(gp, ga)
        assert args.NB == blocks
        assert t["seg_cnt"].shape == (args.NB, args.C + args.N) and t["blk_counts"].shape == (args.NB, 7)
        assert t["claim_flags"].shape == (args.C, 4) and t["order"].shape == (args.P,)
        bufs = {t[name].untyped_storage().data_ptr() for name in gdev.GATE_SCRATCH + ("counts",)}
        assert len(bufs) == 1
        assert all(t[name].data_ptr() % 16 == 0 for name in gdev.GATE_SCRATCH + ("counts",))


def _solved(workload=None):
    """A CPU solve's gate inputs and its device problem's tables in the
    kernels' layout (what FFDResult.tables holds after a card solve)."""
    pods, its, tpls, nodes = workload or W.fuzz_workload(6)
    result = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(pods, its, tpls, nodes)
    gp, ga, _ = _build_args(result.verify_ctx, result, pods, None)
    prob = _pad_lanes_mult32(result.verify_ctx.device_problem)
    return gp, ga, prob, ffd_sweeps.problem_tensors(prob)


def test_gate_args_read_the_solve_tables():
    """Handed the solve's tables, the gate reads its lane words and pod and
    type rows from them (the same tensors); without them it packs the same
    values; node and published claim rows are packed on each call."""
    gp, ga, _, tables = _solved()
    t1, a1 = gdev.gate_counts_args(gp, ga, tables)
    t2, a2 = gdev.gate_counts_args(gp, ga)
    def same(a, b):  # equal, NaN lanes included
        return torch.equal(a, b) or (a.is_floating_point() and torch.allclose(a, b, rtol=0, atol=0, equal_nan=True))

    for name in gdev.GATE_FROM_TABLES:
        assert t1[name] is tables[name] and same(t1[name], t2[name]), name
    for name in ("node_adm", "node_neg", "claim_adm", "claim_neg", "claim_gt"):
        assert same(t1[name], t2[name]), name
    assert (a1.P, a1.K, a1.W, a1.T) == (a2.P, a2.K, a2.W, a2.T)


def test_tables_of_another_problem_are_refused():
    gp, ga, _, tables = _solved()
    other = ffd_sweeps.problem_tensors(problem_to_torch(_encode(W.homogeneous_workload(48), 32), "cpu"))
    with pytest.raises(ValueError, match="tables hold"):
        gdev.gate_counts_args(gp, ga, other)
    prob = problem_to_torch(_encode(W.homogeneous_workload(48), 32), "cpu")
    result = ffd_sweeps.solve_ffd_sweeps(prob, 32)
    with pytest.raises(ValueError, match="tables hold"):
        ffd_step.attribute_args(prob, result.state, torch.arange(3), tables)


def test_attribute_args_read_the_solve_tables():
    prob = _pad_lanes_mult32(problem_to_torch(_encode(W.fuzz_workload(6), 8), "cpu"))
    result = ffd_sweeps.solve_ffd_sweeps(prob, 8)
    tables = ffd_sweeps.problem_tensors(prob)
    rows = torch.nonzero(prob.pod_active).reshape(-1)
    t1, a1 = ffd_step.attribute_args(prob, result.state, rows, tables)
    t2, a2 = ffd_step.attribute_args(prob, result.state, rows)
    for name in ("lvw", "pod_adm", "pod_neg", "it_adm", "tpl_neg", "offer_ok", "grp_key"):
        assert t1[name] is tables[name] and torch.equal(t1[name], t2[name]), name
    assert (a1.B, a1.K, a1.T, a1.TW) == (a2.B, a2.K, a2.T, a2.TW)


def test_gate_stage_matches_the_kernel_constants():
    """The mirror's staging area is the kernel's: the larger of a warp's
    area times the warps and the two block buffers."""
    text = (CSRC / "gate_counts.cu").read_text()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}
    warps = const["THREADS"] // 32
    assert gdev.GATE_STAGE_FLOATS == max(warps * const["WARP_STAGE"], 2 * const["BLOCK_STAGE"])
    assert "gate_smem_bytes" in text and "314,000 rows" in text


@pytest.mark.parametrize("P,C,N,K,NB", [
    (10240, 128, 0, 4, 16),   # the 10k solve's gate
    (14336, 32, 0, 4, 16),    # a partition of the 100k fleet
    (10240, 64, 0, 4, 16),    # the churn run's fused gate (64 claim slots)
    (10240, 128, 0, 4, 1),    # one block takes every row
])
def test_gate_shared_memory_fits_the_main_path(P, C, N, K, NB):
    assert gdev.gate_smem_bytes(P, C, N, K, NB) <= gdev.H100_SMEM_OPTIN


def test_gate_row_limit():
    """A block holds 8 B a row of its segment: about 314,000 rows at 16
    blocks and 128 claims on an H100, and no more."""
    top = gdev.gate_max_rows(128, 0, 4, 16)
    assert 310_000 <= top <= 316_000
    assert gdev.gate_smem_bytes(top, 128, 0, 4, 16) <= gdev.H100_SMEM_OPTIN
    assert gdev.gate_smem_bytes(top + 16, 128, 0, 4, 16) > gdev.H100_SMEM_OPTIN


def test_workspace_views_share_one_allocation():
    ws = kernels.workspace([("a", torch.float32, (3, 5)), ("b", torch.bool, (7,)), ("c", torch.int64, (2,)),
                           ("d", torch.int32, (0, 4))], "cpu")
    assert {ws[k].untyped_storage().data_ptr() for k in ws} == {ws["a"].untyped_storage().data_ptr()}
    assert [tuple(ws[k].shape) for k in "abcd"] == [(3, 5), (7,), (2,), (0, 4)]
    assert [ws[k].dtype for k in "abcd"] == [torch.float32, torch.bool, torch.int64, torch.int32]
    assert all(ws[k].data_ptr() % 16 == 0 for k in "abc")
    ws["a"].fill_(1.0)
    ws["c"].fill_(-1)
    assert ws["a"].sum() == 15 and (ws["c"] == -1).all()


def _plan_reference(eq, rows):
    """Each entry's run head, the first entry of each head, the counts."""
    head = []
    for p in range(len(eq)):
        head.append(p if not eq[p] else head[-1])
    firsts = {}
    for i, r in enumerate(rows):
        firsts.setdefault(head[r], i)
    order = sorted(firsts.values())
    index = {firsts[h]: k for k, h in enumerate(sorted(firsts, key=firsts.get))}
    inverse = [index[firsts[head[r]]] for r in rows]
    return [rows[i] for i in order], [inverse.count(k) for k in range(len(order))], inverse


@pytest.mark.parametrize("seed", range(6))
def test_attr_row_plan_matches_a_reference(seed):
    rng = np.random.default_rng(seed)
    P = int(rng.integers(2, 60))
    eq = rng.random(P) < 0.6
    eq[0] = False
    rows = rng.integers(0, P, size=int(rng.integers(2, 40))).tolist()
    urows, mult, inverse = ffd_step.attr_row_plan(eq, rows)
    ref_rows, ref_mult, ref_inverse = _plan_reference(eq.tolist(), rows)
    assert urows.tolist() == ref_rows and mult.tolist() == ref_mult and inverse.tolist() == ref_inverse
    # every entry's attributed row is byte-identical to it: in its run
    heads = np.maximum.accumulate(np.where(eq, 0, np.arange(P)))
    assert (heads[urows[inverse]] == heads[np.asarray(rows)]).all()
    urows, mult, inverse = ffd_step.attr_row_plan(None, rows)
    assert urows.tolist() == rows and mult.tolist() == [1] * len(rows) and inverse.tolist() == list(range(len(rows)))


def test_attr_team_warps_widen_for_few_rows():
    assert ffd_step.attr_team_warps(1) == 16
    assert ffd_step.attr_team_warps(ffd_step.ATTR_BLOCKS) == 16
    assert ffd_step.attr_team_warps(ffd_step.ATTR_BLOCKS + 1) == 8
    assert ffd_step.attr_team_warps(2 * ffd_step.ATTR_BLOCKS + 1) == 4
    assert ffd_step.attr_team_warps(10_000) == 4


@pytest.mark.parametrize("dedup", [True, False])
def test_attribute_args_plan_the_rows(dedup):
    prob = problem_to_torch(_encode(W.homogeneous_workload(48), 32), "cpu")
    result = ffd_sweeps.solve_ffd_sweeps(prob, 32)
    rows = torch.nonzero(prob.pod_active).reshape(-1)
    t, args = ffd_step.attribute_args(prob if dedup else dataclasses.replace(prob, pod_eqprev=None),
                                      result.state, rows)
    assert int(t["mult"].sum()) == rows.numel() and args.B == t["rows"].numel()
    assert torch.equal(t["rows"][t["inverse"]].long(), rows) if not dedup else args.B < rows.numel()
    assert args.TW == ffd_step.attr_team_warps(args.B)
    assert args.NB == max(1, min(ffd_step.ATTR_BLOCKS, -(-args.B // (16 // args.TW))))
    # the state is read where it lies: its leaves are the state's own tensors
    assert t["claim_requests"] is result.state.claim_requests or not result.state.claim_requests.is_contiguous()


def test_section_splits_and_barriers():
    s = torch.tensor([1, 3, 0, 4, 0, 2, 0, 0, 0, 21, 4])
    split = gdev.gate_section_split(s, 1.0)
    assert split == {"rows": 0.1, "row_checks": 0.3, "scatter": 0.4, "sums": 0.2}
    assert gdev.gate_barriers(s) == (21, 4)
    cyc = [2, 6, 0, 2, 0, 1, 3, 0, 0, 0, 0]
    out = ffd_step.attr_section_split(cyc, 2.0)
    assert out["prep"] == 0.4 and out["bins"] == 1.2 and out["templates"] == 0.4
    assert out["node_gate_share"] == 0.25 and out["claim_gate_share"] == 0.75
