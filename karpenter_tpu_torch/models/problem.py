"""The tensorized scheduling problem — struct-of-arrays over a closed vocabulary.

Same data model as the JAX package's ``models/problem.py``, field for field, so
one encoded batch can feed both and every difference downstream is a solver
difference. The host encode (solver/encode.py) and padding (ops/padding.py)
build these dataclasses from numpy arrays; ``problem_to_torch`` moves them onto
a torch device for the solver.

  P  pods            K  label keys        R  resource names
  T  instance types  V  value lanes       O  offerings per type
  N  existing nodes  TPL nodepool templates

Closed-world requirement encoding (ground truth: the host-side algebra in
scheduling/requirements.py, itself mirroring reference
pkg/scheduling/requirement.go):

  admitted[k, v]  bool   vocab lane v satisfies Requirement.Has(value_v)
                         (integer Gt/Lt bounds already folded in)
  comp[k]         bool   complement set: admits values OUTSIDE the vocab too
                         (NotIn / Exists / Gt / Lt)
  gt[k], lt[k]    int32  integer bounds with +-inf sentinels
  defined[k]      bool   key present in the Requirements map

Undefined keys encode as full-admit complements (admitted=lane_valid,
comp=True, no bounds), which makes them identities under intersection:

  admitted' = admitted_a & admitted_b          comp' = comp_a & comp_b
  gt' = max(gt_a, gt_b)   lt' = min(lt_a, lt_b)   defined' = def_a | def_b
  nonempty = any(admitted') | (comp' & (gt' < lt'))

See the JAX package's module docstring for why this is exact over the closed
world.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

GT_NONE = np.int32(-(2**31) + 1)
LT_NONE = np.int32(2**31 - 1)

# Vocab key indices the encoder pins (solver/encode.py seeds these first, in
# this order, and asserts it; the device kernels index them statically).
ZONE_KEY = 0
CT_KEY = 1
HOSTNAME_KEY = 2

# run commit modes (SchedulingProblem.run_mode); the encoder still segments
# runs so its output matches the JAX package's leaf for leaf
RUN_SINGLE = 0
RUN_ANALYTIC = 1
RUN_TOPO = 2


@dataclass
class ReqTensor:
    """Requirement state for a batch of entities: arrays shaped [..., K, V] /
    [..., K]. The leading axes are entity axes (or absent for a single row)."""

    admitted: Any  # bool[..., K, V]
    comp: Any  # bool[..., K]
    gt: Any  # int32[..., K]
    lt: Any  # int32[..., K]
    defined: Any  # bool[..., K]

    @property
    def shape(self):
        return self.admitted.shape

    def row(self, idx) -> "ReqTensor":
        return ReqTensor(
            admitted=self.admitted[idx],
            comp=self.comp[idx],
            gt=self.gt[idx],
            lt=self.lt[idx],
            defined=self.defined[idx],
        )


@dataclass
class SchedulingProblem:
    """One batch of the provisioning problem, fully tensorized. Field meanings
    are those of the JAX package's SchedulingProblem (see its docstring)."""

    # vocab statics
    lane_valid: Any  # bool[K, V]
    lane_numeric: Any  # f32[K, V] (NaN if non-numeric)
    lane_lex_rank: Any  # i32[K, V] rank of the lane's value in sorted order
    key_wellknown: Any  # bool[K]
    # pods
    pod_reqs: ReqTensor
    pod_requests: Any  # f32[P, R]
    pod_tol_tpl: Any  # bool[P, TPL] pod tolerates template taints
    pod_tol_node: Any  # bool[P, N]
    pod_ports: Any  # bool[P, PT]
    pod_port_conflict: Any  # bool[P, PT]
    pod_strict_reqs: ReqTensor
    # instance types
    it_reqs: ReqTensor
    it_alloc: Any  # f32[T, R]
    it_cap: Any  # f32[T, R]
    offer_zone: Any  # i32[T, O]
    offer_ct: Any  # i32[T, O]
    offer_ok: Any  # bool[T, O]
    offer_price: Any  # f32[T, O]
    # templates
    tpl_reqs: ReqTensor
    tpl_overhead: Any  # f32[TPL, R]
    tpl_it_ok: Any  # bool[TPL, T]
    tpl_remaining: Any  # f32[TPL, R] (+inf = unlimited)
    # existing nodes
    node_reqs: ReqTensor
    node_avail: Any  # f32[N, R]
    node_overhead: Any  # f32[N, R]
    node_used_ports: Any  # bool[N, PT]
    # CSI attach limits
    pod_vol_counts: Any  # i32[P, D]
    node_vol_used: Any  # i32[N, D]
    node_vol_limits: Any  # i32[N, D]
    # topology
    grp_type: Any  # i32[G] 0 spread / 1 affinity / 2 anti-affinity
    grp_key: Any  # i32[G]
    grp_max_skew: Any  # i32[G]
    grp_min_domains: Any  # i32[G]
    grp_counts0: Any  # i32[G, V]
    grp_registered0: Any  # bool[G, V]
    grp_inverse: Any  # bool[G]
    grp_has_filter: Any  # bool[G]
    grp_filter: ReqTensor  # [G, F]
    grp_filter_valid: Any  # bool[G, F]
    pod_grp_match: Any  # bool[P, G]
    pod_grp_selects: Any  # bool[P, G]
    pod_grp_owned: Any  # bool[P, G]
    claim_hostname_lane: Any  # i32[C]
    pod_active: Any = None  # bool[P]
    run_start: Any = None  # i32[RN]
    run_len: Any = None  # i32[RN]
    run_mode: Any = None  # i32[RN]
    offer_zc: Any = None  # bool[T, Zb, Cb] or None
    pod_eqprev: Any = None  # bool[P]
    pod_eqprev_gate: Any = None  # bool[P]
    pod_eqprev_chain: Any = None  # bool[P]

    @property
    def num_runs(self) -> int:
        return self.run_start.shape[0]

    @property
    def num_groups(self) -> int:
        return self.grp_type.shape[0]

    @property
    def num_pods(self) -> int:
        return self.pod_requests.shape[0]

    @property
    def num_instance_types(self) -> int:
        return self.it_alloc.shape[0]

    @property
    def num_templates(self) -> int:
        return self.tpl_overhead.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_avail.shape[0]

    @property
    def num_keys(self) -> int:
        return self.lane_valid.shape[0]

    @property
    def num_lanes(self) -> int:
        return self.lane_valid.shape[1]

    @property
    def num_resources(self) -> int:
        return self.pod_requests.shape[1]


@dataclass
class ProblemMeta:
    """Host-side companions to a SchedulingProblem: the dictionaries needed to
    decode solver output back into API objects."""

    keys: List[str] = field(default_factory=list)
    values_per_key: List[List[str]] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    pod_order: List[int] = field(default_factory=list)  # problem row -> input pod index
    template_names: List[str] = field(default_factory=list)
    instance_type_names: List[str] = field(default_factory=list)
    node_names: List[str] = field(default_factory=list)
    zone_key_idx: int = -1
    ct_key_idx: int = -1
    hostname_key_idx: int = -1


# -- crossing between numpy and torch -----------------------------------------
#
# A problem or solver state is a tree of dataclasses whose leaves are arrays.
# ``numpy_fields`` flattens any such tree — this package's or the JAX
# package's, which share field names — into {"pod_reqs.admitted": array, ...};
# ``problem_from_numpy`` / ``state_from_numpy`` rebuild this package's
# dataclasses from such a dict as torch tensors on one device. Both packages
# then see byte-identical inputs, which is what the parity tests rely on.

_TORCH_DTYPE = {
    np.dtype(bool): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.uint8): torch.uint8,
}


def numpy_fields(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a dataclass tree into {dotted field name: numpy array}. None
    leaves are omitted; torch tensors are copied to the host."""
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        name = prefix + f.name
        if value is None:
            continue
        if dataclasses.is_dataclass(value):
            out.update(numpy_fields(value, name + "."))
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out


def _tensor(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    dtype = _TORCH_DTYPE.get(arr.dtype)
    if dtype is None:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)


def _build(cls, fields: Dict[str, np.ndarray], device, prefix: str = ""):
    kwargs = {}
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        if f.type in ("ReqTensor", ReqTensor):
            kwargs[f.name] = _build(ReqTensor, fields, device, name + ".")
        elif name in fields:
            kwargs[f.name] = _tensor(fields[name], device)
        elif f.default is dataclasses.MISSING:
            raise KeyError(f"missing field {name}")
    return cls(**kwargs)


def problem_from_numpy(fields: Dict[str, np.ndarray], device) -> SchedulingProblem:
    """SchedulingProblem of torch tensors on ``device`` from a dict of numpy
    leaves keyed by dotted field name (see ``numpy_fields``)."""
    return _build(SchedulingProblem, fields, torch.device(device))


def state_from_numpy(fields: Dict[str, np.ndarray], device):
    """FFDState of torch tensors on ``device`` from numpy leaves keyed by
    dotted field name — the carried bin state of a solve."""
    from karpenter_tpu_torch.ops.ffd_core import FFDState

    return _build(FFDState, fields, torch.device(device))


def patch_args_from_numpy(fields: Dict[str, np.ndarray]):
    """ops/fused.PatchArgs from numpy leaves keyed by field name (as
    ``_asdict()`` of either package's PatchArgs gives them), so one row patch
    can go through both packages."""
    from karpenter_tpu_torch.ops.fused import PatchArgs

    return PatchArgs(**{name: np.asarray(fields[name]) for name in PatchArgs._fields})


def problem_to_torch(problem: SchedulingProblem, device) -> SchedulingProblem:
    """Move a host (numpy) problem onto ``device``."""
    return problem_from_numpy(numpy_fields(problem), device)
