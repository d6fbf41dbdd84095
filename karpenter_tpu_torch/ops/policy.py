"""The learned order's device half: the per-row scorer of the sweeps requeue
(``KARPENTER_TPU_ORDER_POLICY``, program 6).

Counterpart of the JAX package's ``ops/policy.py`` (``lane_features`` :47,
``score_features`` :86, ``lane_scores`` :102). Ten feature columns per pod
row, all read from the encoded problem: the request magnitudes (log1p of the
sum and of the largest request), the requirement-key fan-out, the share of
the value lanes the row still admits, host ports, the template toleration
reach, the topology groups the row matches and owns, and the chain-head and
gate-identity bits. A head of the weights in solver/ordering.py (linear, or
one tanh hidden layer) turns them into a score; the sweeps solves
(ops/ffd_sweeps, ``order_scores``) sort each sweep's requeue by it.

Two implementations of the same function:
  * ``lane_scores_plain`` — plain PyTorch, taken for CPU tensors (the tests)
    and the yardstick on the card;
  * the ``lane_scores`` CUDA kernel (csrc/lane_scores.cu), a thread per pod
    row, taken for CUDA tensors. There is no fallback between the two.

The kernel reads the problem's tables in the kernels' layout
(``ops/ffd_sweeps.problem_tensors``): the solve builds them once and hands
the same tables to the scorer and to the ``ffd_loop`` launch that reads the
scores (``tables=``); without them the wrapper builds them itself. The
head's device copy is made once per weights version (``head_weights``), as
the JAX package bakes the weights into its program.

Both add in one stated order: the request sum over resources, and the head's
products over features (and over hidden units), in index order. The log1p
columns may differ from the JAX package's by an ulp; the scores are held to
it within 1e-6.
"""

from __future__ import annotations

import functools

import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.problem import SchedulingProblem
from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
from karpenter_tpu_torch.ops.ffd_sweeps import check_tables, problem_tensors

# bump when the feature columns change meaning (solver/ordering.py checks
# the artifact's lane_feature_version against it)
LANE_FEATURE_VERSION = 1
N_LANE_FEATURES = 10


def _bit(x, P: int, dev) -> torch.Tensor:
    if x is None:
        return torch.zeros((P,), dtype=torch.float32, device=dev)
    return x.to(torch.float32)


def lane_features(problem: SchedulingProblem) -> torch.Tensor:
    """f32[P, N_LANE_FEATURES] over the encoded pod tensors (the JAX
    package's columns, in its order)."""
    f32 = torch.float32
    req = problem.pod_requests.to(f32)
    P, R = req.shape
    dev = req.device
    total = torch.zeros((P,), dtype=f32, device=dev)
    for r in range(R):
        total = total + req[:, r]
    lv = problem.lane_valid
    n_valid = torch.clamp_min(lv.sum().to(f32), 1.0)
    admitted = (problem.pod_reqs.admitted & lv[None]).sum(dim=(1, 2)).to(f32)
    zeros = torch.zeros((P,), dtype=f32, device=dev)
    ports = problem.pod_ports.any(dim=1).to(f32) if problem.pod_ports.shape[1] else zeros
    cols = [
        torch.log1p(total),  # 0 total request magnitude
        torch.log1p(req.max(dim=1).values if R else zeros),  # 1 dominant resource magnitude
        problem.pod_reqs.defined.sum(dim=1).to(f32) / problem.num_keys,  # 2 requirement-key fan-out
        admitted / n_valid,  # 3 admitted-lane fan-out
        ports,  # 4 reserves ports
        problem.pod_tol_tpl.sum(dim=1).to(f32) / problem.num_templates,  # 5 template toleration reach
        problem.pod_grp_match.sum(dim=1).to(f32),  # 6 topology participation
        problem.pod_grp_owned.sum(dim=1).to(f32),  # 7 inverse-group ownership
        1.0 - _bit(problem.pod_eqprev_chain, P, dev),  # 8 chain head
        _bit(problem.pod_eqprev_gate, P, dev),  # 9 gate-identical to the previous row
    ]
    return torch.stack(cols, dim=1)


def _dot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w over the last axis, the products added in index order."""
    acc = x[..., 0] * float(w[0])
    for f in range(1, len(w)):
        acc = acc + x[..., f] * float(w[f])
    return acc


def score_features(feats: torch.Tensor, weights_static) -> torch.Tensor:
    """The head over a feature matrix; ``weights_static`` is solver/ordering's
    ``(arch, w, b, hidden)`` with ``hidden`` = (rows, biases) for the MLP."""
    arch, w, b, hidden = weights_static
    x = feats.to(torch.float32)
    if arch == "mlp" and hidden is not None:
        h_w, h_b = hidden
        x = torch.stack([torch.tanh(_dot(x, row) + float(bias)) for row, bias in zip(h_w, h_b)], dim=-1)
    return _dot(x, w) + float(b)


def lane_scores_plain(problem: SchedulingProblem, weights_static) -> torch.Tensor:
    """f32[P] learned priority per pod row, higher first (plain PyTorch)."""
    return score_features(lane_features(problem), weights_static)


def lane_scores(problem: SchedulingProblem, weights_static, tables=None) -> torch.Tensor:
    """The scores: one ``lane_scores`` launch for CUDA tensors (over the
    solve's ``tables`` where given), the plain version for CPU tensors."""
    if problem.lane_valid.is_cuda:
        return launch_lane_scores(_pad_lanes_mult32(problem), weights_static, tables=tables)[0]
    return lane_scores_plain(problem, weights_static)


# -- the lane_scores kernel's argument struct (csrc/lane_scores.cu LaneArgs) --

_LANE_INPUTS = ("req", "defined", "adm", "lvw", "ports", "tol_tpl", "match", "owned",
                "eqprev_chain", "eqprev_gate", "weights")
_LANE_POINTERS = _LANE_INPUTS + ("feats", "scores")
_LANE_INTS = ("P", "R", "K", "W", "PT", "TPL", "G", "hidden")
_LaneArgs = kernels.make_struct("LaneArgs", _LANE_POINTERS, _LANE_INTS)
# the kernel's table inputs: struct field <- problem_tensors name, dtype
_LANE_TABLES = (
    ("req", "pod_requests", torch.float32), ("defined", "pod_def", torch.bool), ("adm", "pod_adm", torch.int32),
    ("lvw", "lvw", torch.int32), ("ports", "pod_ports", torch.bool), ("tol_tpl", "pod_tol_tpl", torch.bool),
    ("match", "pod_match", torch.bool), ("owned", "pod_owned", torch.bool),
)


def pack_weights(weights_static, dev) -> torch.Tensor:
    """The head as one f32 array: the hidden rows [H, F] and biases [H]
    (MLP only), then the output weights and bias."""
    arch, w, b, hidden = weights_static
    vals = []
    if arch == "mlp" and hidden is not None:
        for row in hidden[0]:
            vals += [float(x) for x in row]
        vals += [float(x) for x in hidden[1]]
    vals += [float(x) for x in w] + [float(b)]
    return torch.tensor(vals, dtype=torch.float32, device=dev)


@functools.lru_cache(maxsize=16)
def head_weights(weights_static, dev) -> torch.Tensor:
    """``pack_weights`` on ``dev``, copied there once per weights version
    (``weights_static`` is solver/ordering's tuple, its own key). The
    kernels only read it."""
    return pack_weights(weights_static, dev)


def lane_scores_args(problem: SchedulingProblem, weights_static, with_features: bool = False, tables=None):
    """The kernel's tensors by struct field name and its argument struct:
    one launch's worth, as ``launch_lane_scores`` passes it. ``tables``: the
    problem's ``problem_tensors``, where the caller has them (else built
    here). The feature columns are an output only ``with_features``."""
    dev = problem.lane_valid.device
    arch, w, _, hidden = weights_static
    H = len(hidden[1]) if arch == "mlp" and hidden is not None else 0
    if len(w) != (H or N_LANE_FEATURES) or (H and any(len(r) != N_LANE_FEATURES for r in hidden[0])):
        raise ValueError(f"lane head does not fit {N_LANE_FEATURES} features (hidden {H})")
    P = problem.num_pods
    if tables is None:
        tables = problem_tensors(problem)
    else:
        check_tables(tables, P, problem.num_instance_types, problem.num_keys, problem.num_lanes)
    t = {}
    for name, table, dtype in _LANE_TABLES:
        x = tables[table]
        if x.dtype != dtype or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"lane_scores reads {table} as contiguous {dtype} on {dev}, not {x.dtype} on {x.device}")
        t[name] = x
    for name, src in (("eqprev_chain", problem.pod_eqprev_chain), ("eqprev_gate", problem.pod_eqprev_gate)):
        t[name] = None if src is None else src.contiguous()
    t["weights"] = head_weights(weights_static, dev)
    t["feats"] = torch.empty((P, N_LANE_FEATURES), dtype=torch.float32, device=dev) if with_features else None
    t["scores"] = torch.empty((P,), dtype=torch.float32, device=dev)
    dims = dict(P=P, R=t["req"].shape[1], K=t["lvw"].shape[0], W=t["lvw"].shape[1], PT=t["ports"].shape[1],
                TPL=t["tol_tpl"].shape[1], G=t["match"].shape[1], hidden=H)
    args = _LaneArgs(**{n: (t[n].data_ptr() if t[n] is not None else None) for n in _LANE_POINTERS}, **dims)
    return t, args


def launch_lane_scores(problem: SchedulingProblem, weights_static, with_features: bool = False, tables=None):
    """Run the ``lane_scores`` kernel on CUDA tensors (lanes padded to a
    multiple of 32), over the solve's ``tables`` where given: (scores
    f32[P], features f32[P, N_LANE_FEATURES] if ``with_features`` else
    None)."""
    dev = problem.lane_valid.device
    if dev.type != "cuda":
        raise ValueError("launch_lane_scores needs CUDA tensors")
    t, args = lane_scores_args(problem, weights_static, with_features, tables)
    kernels.launch("lane_scores", args, torch.cuda.current_stream(dev).cuda_stream)
    return t["scores"], t["feats"]


__all__ = [
    "LANE_FEATURE_VERSION",
    "N_LANE_FEATURES",
    "lane_features",
    "lane_scores",
    "lane_scores_plain",
    "launch_lane_scores",
    "score_features",
]
