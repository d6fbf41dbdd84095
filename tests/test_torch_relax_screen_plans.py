"""The launch plans of ``relax_place`` and ``runs_screen``, on the CPU.

``relax_place`` runs one solve on a thread-block cluster
(csrc/relax_place.cu) of the blocks ``ffd_loop``'s planner picks for the lane
count (``ops/ffd_sweeps.cluster_size``, tests/test_torch_cluster.py), under
the same override (``forced_cluster``). ``runs_screen`` (csrc/runs_screen.cu) picks a layout
per launch from the lanes, their rows and the card's SMs
(``parallel/mesh.screen_plan``): a cluster per lane or a 512-thread block
per lane; its blocks take the lanes heaviest first (``mesh.lane_order``).
Here: the planners at the shapes the main path and the tests use, their
overrides, the argument structs' plan fields, and the constants the kernels
share with their wrappers. The kernels themselves are
held to their plain versions at every cluster size and layout by
tests/test_torch_kernels.py's card tests.
"""

import re
from pathlib import Path

import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu_torch.models.problem import problem_to_torch
from karpenter_tpu_torch.ops import ffd_sweeps, relax
from karpenter_tpu_torch.ops.ffd_core import initial_state
from karpenter_tpu_torch.parallel import mesh
from karpenter_tpu_torch.testing import workloads as W
from tests.test_torch_kernels import _encode

CSRC = Path(relax.__file__).resolve().parent.parent / "csrc"


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_relax_kernel_constants_match_the_wrapper():
    """The kernel's largest cluster, its stage names and its argument
    struct's plan fields are the wrapper's; a lone solve's plan is the
    largest cluster."""
    assert _constant("relax_place.cu", "MAX_CLUSTER") == ffd_sweeps.cluster_size(1) == 16
    assert _constant("relax_place.cu", "NSEC") == len(relax.SECTIONS)
    assert relax._RELAX_INTS[-1] == "cluster" and "plan" in relax._RELAX_POINTERS
    assert relax._RelaxLanesArgs._fields_[1:] == [("L", relax.ctypes.c_int), ("cluster", relax.ctypes.c_int)]


@pytest.mark.parametrize("lanes,rows,plan", [(1, 1280, ("cluster", 8)), (8, 1280, ("cluster", 8)),
                                             (16, 1280, ("cluster", 8)), (20, 512, ("cluster", 4)),
                                             (50, 4096, ("cluster", 2)), (66, 1280, ("cluster", 2)),
                                             (8, 64, ("block", 1)), (8, 511, ("block", 1)),
                                             (67, 1280, ("block", 1)), (132, 1280, ("block", 1)),
                                             (320, 2048, ("block", 1))])
def test_screen_plan_by_lanes_and_rows(lanes, rows, plan):
    """Few lanes (at most half the SMs) of at least SCREEN_CLUSTER_ROWS rows:
    a cluster per lane of the largest power of two no larger than 8 or
    132 // lanes blocks (the serve layer's 8 wide lanes: 8); otherwise a
    512-thread block per lane (the serve layer's narrow lanes, the screen's
    320 lanes)."""
    assert tuple(mesh.screen_plan(lanes, rows)) == plan


def test_screen_plan_override():
    """forced_screen_plan sets the layout for its context only, and refuses
    a layout it does not know or a cluster outside the cluster layout."""
    with mesh.forced_screen_plan("block"):
        assert mesh.screen_plan(8, 1280) == ("block", 1)
        with mesh.forced_screen_plan("cluster", 4):
            assert mesh.screen_plan(320, 64) == ("cluster", 4)
        assert mesh.screen_plan(2, 4096) == ("block", 1)
    assert mesh.screen_plan(8, 1280) == ("cluster", 8)
    for bad in (("wave", 1), ("block", 2), ("cluster", 0), ("cluster", 65)):
        with pytest.raises(ValueError):
            with mesh.forced_screen_plan(*bad):
                pass


def test_screen_kernel_constants_match_the_wrapper():
    """The layouts' numbers, the section names, and the plan fields of the
    argument struct."""
    for i, name in enumerate(mesh.SCREEN_LAYOUTS):
        assert _constant("runs_screen.cu", f"LAYOUT_{name.upper()}") == i
    assert _constant("runs_screen.cu", "NRSEC") == len(mesh.RS_SECTIONS)
    assert mesh._RS_INTS[-2:] == ("layout", "cluster") and mesh._RS_POINTERS[-2:] == ("order", "plan")


def _screen_inputs(lanes):
    prob = problem_to_torch(_encode(W.fuzz_workload(6), 8), "cpu")
    active = prob.pod_active[None].expand(lanes, -1).clone()
    for b in range(lanes):
        active[b, : b % 5] = False  # lanes with fewer active rows
    node_avail = prob.node_avail[None].expand(lanes, -1, -1).contiguous()
    return prob, active, node_avail


@pytest.mark.parametrize("lanes", [3, 140])
def test_screen_args_carry_the_plan_and_the_lane_order(lanes):
    """runs_screen_args fills the struct's layout and cluster from the plan
    (or its override) and the lane order: the lanes by their active rows,
    most first, ties in lane order."""
    prob, active, node_avail = _screen_inputs(lanes)
    kw = dict(max_run=mesh.max_run_bucket(prob), passes=1, with_topo=mesh.has_topo_runs(prob))
    t, args = mesh.runs_screen_args(prob, initial_state(prob, 8), node_avail, active, **kw)
    layout, cluster = mesh.screen_plan(lanes, prob.num_pods)
    assert (args.layout, args.cluster) == (mesh.SCREEN_LAYOUTS.index(layout), cluster)
    counts = active.sum(dim=1).tolist()
    order = t["order"].tolist()
    assert sorted(order) == list(range(lanes)) and t["order"].dtype == torch.int32
    assert all((counts[a], -a) > (counts[b], -b) for a, b in zip(order, order[1:]))
    assert t["plan"].tolist() == [0, 0, 0] and args.order == t["order"].data_ptr()
    with mesh.forced_screen_plan("cluster", 2):
        _, forced = mesh.runs_screen_args(prob, initial_state(prob, 8), node_avail, active, **kw)
    assert (forced.layout, forced.cluster) == (mesh.SCREEN_LAYOUTS.index("cluster"), 2)


def test_lane_order_is_stable_and_descending():
    active = torch.tensor([[1, 0, 0], [1, 1, 0], [0, 0, 0], [1, 1, 0], [1, 1, 1]], dtype=torch.bool)
    assert mesh.lane_order(active).tolist() == [4, 1, 3, 0, 2]
