"""DeviceWorld: the encoded world stays on the device across solve cycles.

Counterpart of the JAX package's ``streaming/device_world.py``
(``KARPENTER_TPU_DEVICE_WORLD``; here ``TorchSolver(device_world=True)``).
The legacy cycle pays host encode -> full upload -> argument repack ->
solve -> gate -> fetch -> decode every time, even when the DeltaEncoder
(streaming/delta.py) proves that only a few pod rows changed. This handle
keeps the padded problem RESIDENT on the device, in the kernels' layout
(ops/fused.World), and turns each supported cycle into:

  1. host delta encode: the row splice, which also yields ``last_rows_prev``,
     the per-row map into the previous world;
  2. ``patch_world`` (ops/fused.py): one launch that rewrites the pod-axis
     leaves of the resident world from a small shipped stack (O(changed)
     bytes up instead of O(world));
  3. ``solve_ffd_fused_gate``: the fresh ``ffd_loop`` and ``gate_counts`` in
     its fused mode, enqueued back to back, then ONE batched fetch of the
     placement, the claim rows and the invariant counts.

Pipelined by default: the patch's arguments go up with a non-blocking copy
from pinned memory, and the host builds ``pod_check`` and the gate's bounds
flag while the device patches; ``last_cycle["overlap_frac"]`` reports the
share of the cycle's device wait the host spent working. ``pipelined=False``
synchronises after each launch (the measurement baseline of the split
timing; placements are identical).

Anything the resident path cannot prove is a CLASSIFIED standdown to the
untouched legacy path (``counters``), and a post-solve surprise (slot
overflow, nonzero gate counts) also drops the world and the delta state, so
a stale world never serves a later cycle. Unlike the JAX package, an
exception (a kernel build or launch error, a CUDA error, a delta-encode bug)
is not a standdown: the world is dropped and the exception propagates, so no
fault of the device path is served quietly by another path.

With ``KARPENTER_TPU_EXPLAIN`` set, the failed rows of a resident cycle are
attributed against the resident tables (``TorchSolver._explain``).

Not ported: the JAX package's standdowns for subsystems this package does
not have yet (``runs-mode``, ``shard``, ``order-policy``, ``device-lost``),
and the program registry, AOT and metrics hooks.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.models.problem import numpy_fields
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_CLAIM,
    KIND_NEW_CLAIM,
    KIND_NO_SLOT,
    KIND_NODE,
    IterCounts,
    problem_bounds_free,
)
from karpenter_tpu_torch.ops.fused import (
    PATCH_ROWS,
    World,
    adopt_world,
    build_patch_args,
    patch_world,
    solve_ffd_fused_gate,
    upload_patch,
    world_problem,
)
from karpenter_tpu_torch.ops.padding import pad_problem, pod_axis_bucket, pow2_bucket
from karpenter_tpu_torch.provisioning.preferences import Preferences
from karpenter_tpu_torch.solver.backend import FAIL_INCOMPATIBLE, SolveResult
from karpenter_tpu_torch.streaming.delta import DeltaEncoder, pod_digest


def _has_topology_constraints(p: Pod) -> bool:
    """The pod spreads or (anti-)affines (the JAX package's
    streaming/warm.py:69): delta worlds have no topology groups."""
    if p.spec.topology_spread_constraints:
        return True
    aff = p.spec.affinity
    if aff is None:
        return False
    return bool(
        (aff.pod_affinity and (aff.pod_affinity.required or aff.pod_affinity.preferred))
        or (
            aff.pod_anti_affinity
            and (aff.pod_anti_affinity.required or aff.pod_anti_affinity.preferred)
        )
    )


def _relax_would_fire(templates) -> bool:
    """Host mirror of ops/relax.relax_applicable WITHOUT encoding: phase 1
    fires exactly when no template carries a finite remaining limit. The
    fused solve has no phase 1, so with relax on such cycles stand down
    BEFORE the delta encoder advances (a post-encode bail would desync the
    resident world from the delta state)."""
    for t in templates:
        rr = getattr(t, "remaining_resources", None)
        if rr and any(np.isfinite(v) for v in rr.values()):
            return False
    return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fetch(tensors, device: torch.device) -> List[np.ndarray]:
    """Device tensors to host arrays in one batch: non-blocking copies into
    pinned buffers, then one synchronisation."""
    if device.type != "cuda":
        return [x.numpy() for x in tensors]
    outs = []
    for x in tensors:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        outs.append(host)
    torch.cuda.current_stream(device).synchronize()
    return [h.numpy() for h in outs]


class DeviceWorld:
    """Per-backend handle owning the resident world, its DeltaEncoder, and
    the patch / fused-solve cycle. Constructed by TorchSolver when
    ``device_world=True``; ``reset()`` is its ``reset_streaming_state``."""

    def __init__(self, backend, pipelined: bool = True):
        self.backend = backend
        self.pipelined = pipelined
        self.delta = DeltaEncoder(well_known_labels=backend.well_known)
        self.world: Optional[World] = None
        self.meta = None
        self.node_names: Optional[List[str]] = None
        # consecutive patches since the last adopt (0 right after an adopt):
        # the first patch reports "patched", later ones "repatched"
        self.patched_streak = 0
        self.cold_solves = 0  # full-world uploads (adopts)
        self.cycles = 0  # cycles this handle served
        self.counters: Dict[str, int] = {}
        self.last_outcome: Optional[str] = None
        self.last_cycle: Dict[str, float] = {}
        # the last patch's device arguments (ops/fused.PatchUpload), kept for
        # the caller that holds the kernel against its plain version
        self.last_patch = None
        # uid -> (pod digest, checked_requirements(pod) is not None): the
        # host's only O(P) per-cycle obligation besides the delta diff
        self._check_cache: Dict[str, tuple] = {}

    def reset(self) -> None:
        self.world = None
        self.meta = None
        self.node_names = None
        self.last_patch = None
        self.patched_streak = 0
        self.delta.reset()
        self._check_cache.clear()

    def _record(self, outcome: str) -> None:
        self.counters[outcome] = self.counters.get(outcome, 0) + 1
        self.last_outcome = outcome

    def _standdown(self, reason: str) -> None:
        self._record("standdown-" + reason)
        return None

    # -- entry -----------------------------------------------------------------

    def try_solve(
        self,
        pods: Sequence,
        instance_types: Sequence,
        templates: Sequence,
        nodes: Sequence,
        pod_requirements_override,
        topology,
        cluster_pods: Sequence,
        domains,
        pod_volumes,
        max_claims: int,
    ) -> Optional[SolveResult]:
        """One cycle through the resident path, or None on a classified
        standdown (the caller's legacy path then serves the cycle unchanged).
        A standdown before the encode leaves the world and the delta state
        untouched; they stay in lockstep for the next supported cycle. An
        exception drops both and propagates."""
        if (
            pod_requirements_override is not None
            or topology is not None
            or len(cluster_pods) > 0
            or domains is not None
            or pod_volumes is not None
        ):
            return self._standdown("unsupported-args")
        if any(
            t.effect == "PreferNoSchedule" for tpl in templates for t in tpl.taints
        ) or any(Preferences.is_relaxable(p) for p in pods):
            # the per-pass relax ladder re-encodes between launches; the
            # resident world models exactly one encode per cycle
            return self._standdown("not-sweeps")
        if any(_has_topology_constraints(p) for p in pods):
            # delta worlds are G=0 by contract (streaming/delta.py)
            return self._standdown("topology")
        if self.backend.relax and _relax_would_fire(templates):
            return self._standdown("relax-applicable")
        try:
            return self._cycle(pods, instance_types, templates, nodes, max_claims)
        except BaseException:
            self.reset()
            raise

    # -- the cycle -------------------------------------------------------------

    def _cycle(self, pods, instance_types, templates, nodes, max_claims):
        backend = self.backend
        dev = backend.device
        t0 = time.perf_counter()
        encoded = self.delta.encode(
            pods, instance_types, templates, nodes=nodes, num_claim_slots=max_claims,
        )
        spliced, meta = encoded.problem, encoded.meta
        mode = self.delta.last_patch.get("mode")
        rows_prev = self.delta.last_rows_prev
        t_encode = time.perf_counter()

        # -- stage 1: bring the resident world up to date ----------------------
        if mode == "patched" and rows_prev is not None and self.world is not None:
            drift = self._drift(spliced, nodes, meta, max_claims)
        else:
            drift = self.delta.last_patch.get("reason") or "no-world"
        if drift is None:
            stage_outcome = "patched" if self.patched_streak == 0 else "repatched"
            self.patched_streak += 1
            up = upload_patch(build_patch_args(spliced, rows_prev, self.world.shapes), self.world)
            patch_world(self.world, up)
            self.last_patch = up
            h2d = up.nbytes
            # the spare buffers the patch writes: this package's counterpart
            # of the JAX package's donated world
            donated = sum(self.world.t[n].numel() * self.world.t[n].element_size() for n in PATCH_ROWS)
        else:
            stage_outcome = "adopt-" + drift
            self.patched_streak = 0
            self.cold_solves += 1
            padded = pad_problem(spliced)
            self.world = adopt_world(padded, max_claims, dev)
            self.last_patch = None
            h2d = sum(x.nbytes for x in numpy_fields(padded).values())
            donated = 0
        if not self.pipelined:
            _sync(dev)
        self.meta = meta
        self.node_names = list(meta.node_names)
        t_patch = time.perf_counter()

        # -- stage 2 args: built on the host while the device patches ----------
        bf = problem_bounds_free(spliced)
        gbf = self._gate_bounds_free(spliced)
        pod_check = self._pod_check(pods, meta)
        pc = torch.from_numpy(pod_check)
        if dev.type == "cuda":
            pc = pc.pin_memory().to(dev, non_blocking=True)
        t_prep = time.perf_counter()

        # -- stage 2: fused solve + gate, then one batched fetch ----------------
        result, counts = solve_ffd_fused_gate(self.world, pc, max_claims, bf, gbf)
        if not self.pipelined:
            _sync(dev)
        t_dispatch = time.perf_counter()
        state = result.state
        iters = torch.stack([torch.as_tensor(x, device=dev).reshape(()) for x in result.iters])
        fetched = _fetch(
            (
                result.kind, result.index, iters, counts,
                state.claim_open, state.claim_tpl, state.claim_it_ok, state.claim_requests,
                state.claim_req.admitted, state.claim_req.comp, state.claim_req.gt,
                state.claim_req.lt, state.claim_req.defined,
            ),
            dev,
        )
        t_fetch = time.perf_counter()
        kinds, indices, iters, counts_np, *np_final = fetched
        backend.last_iters = IterCounts(*(int(x) for x in iters))
        d2h = sum(x.nbytes for x in fetched)

        # -- classified post-solve standdowns: reset, legacy serves the cycle --
        if (kinds[: len(pods)] == KIND_NO_SLOT).any():
            # the legacy path owns the escalation ladder; a world at the old
            # claim bucket is useless after it
            self.reset()
            return self._standdown("slot-overflow")
        if counts_np.any():
            self.reset()
            return self._standdown("gate-reject")

        # -- decode ------------------------------------------------------------
        from karpenter_tpu_torch import verify
        from karpenter_tpu_torch.solver.forensics import failure_reason
        from karpenter_tpu_torch.solver.torch_backend import decode_claim_placements

        out = SolveResult()
        pod_kinds: Dict[int, tuple] = {}
        failed, failed_rows = [], []
        for row in range(len(meta.pod_order)):
            orig = meta.pod_order[row]  # the batch is the full pod list
            kind, index = int(kinds[row]), int(indices[row])
            if kind in (KIND_NODE, KIND_CLAIM, KIND_NEW_CLAIM):
                pod_kinds[orig] = (kind, index)
            else:
                failed.append(orig)
                failed_rows.append(row)
        for orig in failed:
            out.failures[orig] = failure_reason(
                pods[orig], instance_types, templates, well_known=backend.well_known,
            ) or FAIL_INCOMPATIBLE
        from karpenter_tpu_torch.obs import explain as obs_explain

        if obs_explain.enabled():
            # attribution reads the resident tables: no host re-upload
            backend._explain(
                out, world_problem(self.world.t), state, meta, kinds, failed, failed_rows,
                pod_kinds, instance_types, len(pods),
            )
        decode_claim_placements(out, meta, max_claims, np_final, pod_kinds)
        # the composite gate takes the fused counts instead of launching its
        # own; screen, skew and audit still run on the published decode
        out.verify_ctx = verify.make_context(
            spliced, meta, max_claims, len(pods), False, fused_counts={},
        )
        t_decode = time.perf_counter()

        backend.last_relax = None  # the fused path never runs phase 1
        backend.last_timing = {
            "encode": t_encode - t0, "patch": t_patch - t_encode, "relax": 0.0,
            "device": t_fetch - t_patch, "decode": t_decode - t_fetch,
        }
        overlapped = (t_prep - t_patch) if self.pipelined else 0.0
        blocked = t_fetch - t_dispatch
        self.cycles += 1
        self.last_cycle = {
            "outcome": stage_outcome,
            "encode_ms": (t_encode - t0) * 1e3,
            "patch_ms": (t_patch - t_encode) * 1e3,
            "prep_ms": (t_prep - t_patch) * 1e3,
            "solve_ms": (t_fetch - t_prep) * 1e3,
            "decode_ms": (t_decode - t_fetch) * 1e3,
            "cycle_ms": (t_decode - t0) * 1e3,
            "h2d_bytes": h2d + pod_check.nbytes,
            "d2h_bytes": d2h,
            "donated_bytes": donated,
            "world_bytes": self.world.nbytes(),
            "overlap_frac": (
                overlapped / (overlapped + blocked) if (overlapped + blocked) > 0 else 0.0
            ),
        }
        self._record(stage_outcome)
        return out

    # -- helpers ---------------------------------------------------------------

    def _drift(self, spliced, nodes, meta, max_claims) -> Optional[str]:
        """None when the resident buffers can absorb this delta as a row
        patch; else the adopt reason. The delta preconditions already pin the
        K/V/R/T/TPL/O/PT axes (vocab/resource/port equality, template and
        instance-type identity): only the pod/node buckets and the node order
        can still move."""
        if self.world.max_claims != max_claims:
            return "claim-slots"
        if int(self.world.t["pod_requests"].shape[0]) != pod_axis_bucket(
            int(np.asarray(spliced.pod_requests).shape[0])
        ):
            return "shape-drift"
        n = len(nodes)
        if int(self.world.t["node_avail"].shape[0]) != (pow2_bucket(n, lo=8) if n else 0):
            return "shape-drift"
        if self.node_names != list(meta.node_names):
            return "node-axis-drift"
        if spliced.pod_eqprev is None:
            return "shape-drift"
        return None

    def _pod_check(self, pods, meta) -> np.ndarray:
        """bool[P_bucket] per padded row: would the host validator check this
        pod's requirement intersection (checked_requirements non-None)?
        Digest-cached per uid so the steady state pays O(changed)."""
        from karpenter_tpu_torch.solver.validator import checked_requirements

        st = self.delta._state
        digests = st.pod_digests if st is not None else {}
        Pb = int(self.world.t["pod_requests"].shape[0])
        pod_check = np.zeros(Pb, dtype=bool)
        for row, orig in enumerate(meta.pod_order):
            p = pods[orig]
            d = digests.get(p.uid) or pod_digest(p)
            ent = self._check_cache.get(p.uid)
            if ent is None or ent[0] != d:
                ent = (d, checked_requirements(p) is not None)
                self._check_cache[p.uid] = ent
            pod_check[row] = ent[1]
        if len(self._check_cache) > 2 * len(pods) + 64:
            live = {p.uid for p in pods}
            self._check_cache = {
                uid: ent for uid, ent in self._check_cache.items() if uid in live
            }
        return pod_check

    @staticmethod
    def _gate_bounds_free(spliced) -> bool:
        from karpenter_tpu_torch.verify import device as vdev

        return vdev.gate_bounds_free(vdev.gate_problem(spliced))
