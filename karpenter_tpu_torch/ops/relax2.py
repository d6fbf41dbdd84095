"""Convex phase 1 of the two-phase solve: projected gradient over the
fractional pod x bin assignment (``KARPENTER_TPU_RELAX2``).

Counterpart of the JAX package's ``ops/relax2.py`` (``_relax2_place_jit``,
program 17). The waterfill (ops/relax.py) places each eligible pod at its
prefix-sum level in one shot. This phase keeps the waterfill's bin-groups,
template pick and normalised demand ``w`` (ops/relax_common.plan_groups) and
solves for a fractional assignment first:

  variables   X[p, j]: the share of pod p on the j-th bin of a window of
              ``_WINDOW`` bins centred on the pod's waterfill bin ``pref``,
              inside its group's slots (``ceil(group mass) + 1`` bins);
  objective   sum w_p X[p,c] (price - 1) + (rho/2) sum_c max(0, load_c - 1)^2
              with a linear within-group bin price (``_GAMMA`` per bin index,
              ``_BETA`` per bin away from ``pref``);
  solve       a fixed number of projected-gradient trips from the waterfill
              assignment: scatter the bin loads, step along the gradient,
              clip to [0, 1], rescale rows whose mass exceeds 1.

Rounding is largest fraction first: each pod's heaviest column names its
bin; pods whose best share is below the uniform share of their window go to
repair; the rest, per bin by descending share then pod index, are admitted
while the bin's running load stays <= 1 (+1e-6). The admitted assignment
then goes through the same real-gate ladder and commit as the waterfill
(relax_common.commit_assignment), and the residue rides the carried sweeps
repair.

Two implementations of the same function:
  * ``relax2_place_plain`` — plain PyTorch, taken for CPU tensors (the tests)
    and the yardstick on the card;
  * the ``relax_place`` CUDA kernel in its convex mode (csrc/relax_place.cu),
    taken for CUDA tensors. There is no fallback between the two.

Every float sum whose rounding depends on the order of its adds is taken in
one stated order in both: a group's mass and a bin's load in pod order, a
row's mass over its 16 columns in column order, a bin's admitted load in the
rounding's sorted order. The warm start's level is the waterfill's float64
prefix sum (ops/relax.waterfill_bins). The JAX package takes the rounding's
per-bin load as a difference of float32 prefix sums over the whole sorted
batch, and the level as a difference of float32 prefix sums too; where that
rounding moves a pod across a bin boundary or a capacity edge the two
packages place it differently (ROADMAP.md, section C, rule 1).

The flag and its knobs are the JAX package's, read at call time:
``KARPENTER_TPU_RELAX2=1`` (off by default; the backend reads it, so that
this module is not imported with the flag off), ``KARPENTER_TPU_RELAX2_ITERS``
(24), ``KARPENTER_TPU_RELAX2_STEP`` (0.3), ``KARPENTER_TPU_RELAX2_TOL``
(0.01).
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from karpenter_tpu_torch.models.problem import SchedulingProblem
from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32, _statics, problem_bounds_free
from karpenter_tpu_torch.ops.relax import (
    RELAX_PASSES,
    RelaxOut,
    launch_relax_place,
    launch_relax_place_lanes,
    waterfill_bins,
)
from karpenter_tpu_torch.ops.relax_common import (
    commit_assignment,
    ordered_sum,
    plan_groups,
    relax_applicable,
)
from karpenter_tpu_torch.ops.topology_kernels import TYPE_ANTI_AFFINITY

__all__ = [
    "Relax2Stats",
    "STANDDOWN_REASONS",
    "classify_ineligible",
    "converged",
    "pgd_iters",
    "pgd_step",
    "pgd_tol",
    "relax2_place",
    "relax2_place_plain",
    "relax_applicable",
]

# the bounded standdown vocabulary (solver_relax_fallback_total{reason}), the
# JAX package's: finite-pool (NodePool limits), ports / topology / no-eligible
# (nothing eligible, by dominant blocker), non-convergence (still moving and
# capacity-violating at the trip limit), rounding-overflow (phase 1 placed
# nothing), gate-rejected (the gate refused the result; re-solved with the
# flag off), error (a host-side exception inside the phase)
STANDDOWN_REASONS = (
    "finite-pool",
    "ports",
    "topology",
    "no-eligible",
    "non-convergence",
    "rounding-overflow",
    "gate-rejected",
    "error",
)

_WINDOW = 16  # candidate bins per pod, centred on its waterfill bin
_RHO = 8.0  # quadratic capacity-violation price
_GAMMA = 0.02  # linear within-group bin price
_BETA = 0.05  # price per bin away from the waterfill bin
_MIN_REL_MASS = 1.0 - 1e-4  # rounding floor, relative to the window's uniform share
_CAPVIOL_OK = 0.05  # fractional overload the rounding absorbs
_SCAN_TOL = 1e-3  # the iterations-to-convergence counter's tolerance
_ADMIT = 1.0 + 1e-6  # a bin's admitted load bound


def pgd_iters() -> int:
    """The fixed number of projected-gradient trips."""
    return max(int(os.environ.get("KARPENTER_TPU_RELAX2_ITERS", "24")), 1)


def pgd_step() -> float:
    """The gradient step (the gradient is scaled by the pod's demand)."""
    return float(os.environ.get("KARPENTER_TPU_RELAX2_STEP", "0.3"))


def pgd_tol() -> float:
    """The host's tolerance on the last trip's max |dX| (see ``converged``)."""
    return float(os.environ.get("KARPENTER_TPU_RELAX2_TOL", "0.01"))


class Relax2Stats(NamedTuple):
    eligible: Any  # i32 pods that passed the eligibility screen
    placed: Any  # i32 pods phase 1 committed (after the ladder)
    demoted: Any  # i32 eligible pods sent to repair
    claims: Any  # i32 claims phase 1 opened
    pgd_iterations: Any  # i32 first trip whose max |dX| < _SCAN_TOL (the trip count if none)
    residual: Any  # f32 the last trip's max |dX|
    capviol: Any  # f32 the final max fractional bin overload
    overflow: Any  # i32 eligible pods whose window fell beyond the claim axis
    round_demoted: Any  # i32 eligible pods the rounding (before the ladder) demoted


def converged(residual: float, capviol: float) -> bool:
    """Round only a point that has stopped moving or that violates no bin's
    capacity by more than ``_CAPVIOL_OK``."""
    return residual <= pgd_tol() or capviol <= _CAPVIOL_OK


def classify_ineligible(problem: SchedulingProblem) -> str:
    """The dominant blocker when nothing was eligible: ``ports`` when port
    pods dominate, ``topology`` when topology-role pods do, else
    ``no-eligible``."""
    active = problem.pod_active.cpu().numpy()
    n_port = n_topo = 0
    if problem.pod_ports.shape[1] > 0:
        ports = problem.pod_ports.cpu().numpy().any(axis=1) | problem.pod_port_conflict.cpu().numpy().any(axis=1)
        n_port = int(np.sum(active & ports))
    if problem.num_groups > 0:
        blocking = problem.grp_inverse.cpu().numpy() | (problem.grp_type.cpu().numpy() == TYPE_ANTI_AFFINITY)
        topo = (problem.pod_grp_match.cpu().numpy().any(axis=1) | problem.pod_grp_owned.cpu().numpy().any(axis=1)
                | (problem.pod_grp_selects.cpu().numpy() & blocking[None, :]).any(axis=1))
        n_topo = int(np.sum(active & topo))
    if n_port >= n_topo and n_port > 0:
        return "ports"
    if n_topo > 0:
        return "topology"
    return "no-eligible"


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _pgd_step(X, valid, absc, price, w, C, step):
    """One projected-gradient trip: the bin loads (each bin's adds in pod
    order), the gradient, the clip to [0, 1] and the row rescale (a row's
    mass summed over its columns in order). Returns (X', max overload)."""
    dev = X.device
    P = X.shape[0]
    cidx = torch.where(valid, absc, C).reshape(-1).cpu().numpy()
    load = np.zeros((C + 1,), np.float32)
    np.add.at(load, np.minimum(cidx, C), (X * w[:, None]).reshape(-1).cpu().numpy())
    load = torch.from_numpy(load[:C]).to(dev)
    over = torch.clamp_min(load - 1.0, 0.0)
    overp = torch.where(valid, over[torch.clamp(absc, 0, C - 1).long()], _f32(0.0, dev))
    grad = w[:, None] * ((price - 1.0) + _RHO * overp)
    Xn = torch.where(valid, torch.clamp(X - step * grad, 0.0, 1.0), _f32(0.0, dev))
    rowsum = torch.zeros((P,), dtype=torch.float32, device=dev)
    for j in range(_WINDOW):
        rowsum = rowsum + Xn[:, j]
    Xn = Xn / torch.clamp_min(rowsum, 1.0)[:, None]
    return Xn, over.max()


def _round_lff(X, valid, absc, w, C):
    """Largest-fraction-first rounding: (slot, admitted) per pod. A pod's
    heaviest column (the first of equal ones) names its bin; a pod whose best
    share times its valid columns is below ``_MIN_REL_MASS`` goes to repair;
    each bin admits its pods by descending share, then pod index, while its
    running load (float32 adds in that order) stays <= ``_ADMIT``."""
    dev = X.device
    P = X.shape[0]
    Xm = torch.where(valid, X, _f32(-1.0, dev))
    bestj = torch.argmax(Xm, dim=1, keepdim=True)
    frac = Xm.gather(1, bestj)[:, 0]
    slot = absc.gather(1, bestj)[:, 0].to(torch.int32)
    nvalid = valid.sum(dim=1).to(torch.float32)
    cand = frac * nvalid >= _f32(_MIN_REL_MASS, dev)
    key_bin = torch.where(cand, slot, C).cpu().numpy()
    fr = frac.cpu().numpy()
    wn = w.cpu().numpy().astype(np.float32)
    order = np.lexsort((np.arange(P), -fr, key_bin))
    order = order[key_bin[order] < C]
    admitted = np.zeros((P,), bool)
    bins = key_bin[order]
    bounds = np.flatnonzero(np.diff(bins)) + 1
    for seg in np.split(order, bounds):
        if len(seg):
            load = np.cumsum(wn[seg], dtype=np.float32)
            admitted[seg] = load <= np.float32(_ADMIT)
    return slot, torch.from_numpy(admitted).to(dev)


def relax2_place_plain(problem: SchedulingProblem, max_claims: int, iters: int = None,
                       step: float = None) -> RelaxOut:
    """Plain PyTorch convex phase 1 (see module docstring); ``iters`` and
    ``step`` default to the environment's knobs."""
    iters = pgd_iters() if iters is None else int(iters)
    step = pgd_step() if step is None else float(step)
    problem = _pad_lanes_mult32(problem)
    C = int(max_claims)
    dev = problem.lane_valid.device
    i32, f32 = torch.int32, torch.float32
    statics = _statics(problem, problem_bounds_free(problem))
    plan = plan_groups(problem, C, statics)
    elig, gid, gidc, w = plan.elig, plan.gid, plan.gidc, plan.w

    # slot windows: ceil(group mass) + 1 bins per group
    gw = ordered_sum(torch.where(elig, gid, C), w[:, None], C)[:, 0]
    nbins = torch.where(plan.gvalid & (gw > 0), torch.clamp(torch.ceil(gw).to(i32) + 1, max=C),
                        torch.zeros((), dtype=i32, device=dev))
    slotbase = (torch.cumsum(nbins, 0) - nbins).to(i32)
    lo = slotbase[gidc.long()]
    hi = lo + nbins[gidc.long()]

    # warm start at the waterfill bin, which also gives identical pods
    # distinct preferred bins
    binp = waterfill_bins(w, plan.hp, gidc)
    pref = torch.minimum(lo + binp, torch.maximum(hi - 1, lo))
    offs = torch.arange(_WINDOW, dtype=i32, device=dev)[None, :]
    absc = pref[:, None] + offs - _WINDOW // 2
    valid = elig[:, None] & (absc >= lo[:, None]) & (absc < hi[:, None]) & (absc < C)
    overflow = elig & ~valid.any(dim=1)
    price = (_f32(_GAMMA, dev) * (absc - lo[:, None]).to(f32)
             + _f32(_BETA, dev) * (absc - pref[:, None]).abs().to(f32))
    X = torch.where(valid & (absc == pref[:, None]), _f32(1.0, dev), _f32(0.0, dev))

    conv, delta = -1, _f32(float("inf"), dev)
    step_t = _f32(step, dev)
    for t in range(iters):
        Xn, _ = _pgd_step(X, valid, absc, price, w, C, step_t)
        delta = (Xn - X).abs().max()
        if conv < 0 and bool(delta < _f32(_SCAN_TOL, dev)):
            conv = t + 1
        X = Xn
    _, capviol = _pgd_step(X, valid, absc, price, w, C, step_t)

    slot, admitted = _round_lff(X, valid, absc, w, C)
    assigned0 = elig & admitted & (slot < C)
    com = commit_assignment(problem, C, statics, plan, slot, assigned0, RELAX_PASSES)
    stats = Relax2Stats(
        eligible=plan.elig0.sum().to(i32),
        placed=com.assigned.sum().to(i32),
        demoted=(plan.elig0 & ~com.assigned).sum().to(i32),
        claims=com.open_c.sum().to(i32),
        pgd_iterations=torch.tensor(conv if conv >= 0 else iters, dtype=i32, device=dev),
        residual=delta.to(f32),
        capviol=capviol.to(f32),
        overflow=overflow.sum().to(i32),
        round_demoted=(elig & ~assigned0).sum().to(i32),
    )
    return RelaxOut(state=com.state, kind=com.kind, index=com.index,
                    residue_active=com.residue_active, stats=stats)


def relax2_place(problem: SchedulingProblem, max_claims: int) -> RelaxOut:
    """Convex phase 1: one ``relax_place`` launch in its convex mode for CUDA
    tensors, the plain version for CPU tensors; ``KARPENTER_TPU_RELAX2_ITERS``
    and ``_STEP`` are read here."""
    if problem.lane_valid.is_cuda:
        return launch_relax2_place(_pad_lanes_mult32(problem), int(max_claims), pgd_iters(), pgd_step())
    return relax2_place_plain(problem, max_claims)


def launch_relax2_place(problem: SchedulingProblem, C: int, iters: int, step: float) -> RelaxOut:
    """Run ``relax_place`` in its convex mode on CUDA tensors (lanes padded
    to a multiple of 32); counted as ``relax2_place`` in kernels.LAUNCHES."""
    out = launch_relax_place(problem, C, convex=(int(iters), float(step)))
    return out._replace(stats=stats_of(out.stats))


def launch_relax2_place_lanes(problems, C: int, iters: int, step: float):
    """The convex mode's lanes mode on CUDA tensors (program 14's phase 1):
    one ``relax_place`` launch, grid L, lane b over ``problems[b]``; one
    RelaxOut per lane with its Relax2Stats. Counted as
    ``relax2_place_lanes`` in kernels.LAUNCHES."""
    outs = launch_relax_place_lanes([_pad_lanes_mult32(p) for p in problems], int(C),
                                    (int(iters), float(step)))
    return [out._replace(stats=stats_of(out.stats)) for out in outs]


def host_stats(stats: Relax2Stats) -> Relax2Stats:
    """The stats as Python numbers, fetched from the device in one copy."""
    words = torch.stack([x.reshape(()).view(torch.int32) if x.dtype == torch.float32 else x.reshape(()).to(torch.int32)
                         for x in stats]).cpu()
    floats = words.view(torch.float32)
    return Relax2Stats(*(float(floats[i]) if i in (5, 6) else int(words[i]) for i in range(len(stats))))


def stats_of(raw: torch.Tensor) -> Relax2Stats:
    """Relax2Stats of the kernel's int32[9] stats word (residual and capviol
    as float32 bits)."""
    floats = raw[5:7].view(torch.float32)
    return Relax2Stats(*raw[:5], floats[0], floats[1], raw[7], raw[8])
