"""The PyTorch solver backend.

Counterpart of the JAX package's ``solver/jax_backend.JaxSolver``: encodes the
batch (solver/encode.py), pads it (ops/padding.py), moves it onto the device,
runs the FFD loop, and decodes back into the host result model. Claim-slot
capacity is a dimension of the state: the backend starts from a bucketed
guess and restarts one bucket higher whenever a pod reports KIND_NO_SLOT.

Two solve modes, chosen as the JAX backend chooses them:
  * sweeps — nothing in the batch can relax: every requeue sweep runs inside
    ONE ``ffd_loop`` launch (ops/ffd_sweeps.solve_ffd_sweeps), and the result
    carries a GateContext for the device invariant gate (verify/);
  * per-pass — relaxable pods: one ``ffd_loop`` launch in its one-pass mode
    per rung of the relax ladder (provisioning/preferences.py), the bin and
    topology state carried between passes.

In sweeps mode with ``relax=True`` (the default, as the JAX package's
``KARPENTER_TPU_RELAX`` defaults to 1) and unlimited NodePools, the solve has
two phases: one ``relax_place`` launch (ops/relax.py) waterfills the
eligible bulk of the batch into claims, and the carried ``ffd_loop``
(ops/ffd_sweeps.solve_ffd_sweeps_carried) repairs the residue from phase 1's
claim landscape. Phase-1 placements are validator-equivalent to FFD rather
than identical, so every two-phase result goes through
``verify.gate_relaxed``; a violation re-solves the batch with relaxation off
(``relax_fallbacks``). With ``relax=False`` the placements equal the JAX
backend's with ``KARPENTER_TPU_RELAX=0`` pod for pod.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
GPU and without that argument they raise. Every batch goes through the
kernels on the card: there is no small-batch host dispatch.

With ``device_world=True`` (the JAX package's KARPENTER_TPU_DEVICE_WORLD,
off by default there too) the solve first tries the device-resident cycle
(streaming/device_world.py): the encoded world stays on the card across
calls, a host delta encode and one ``patch_world`` launch bring it up to the
new snapshot, and the fresh ``ffd_loop`` and the fused ``gate_counts`` run
back to back before one fetch. A classified standdown falls through to the
path above unchanged; an error propagates.

With ``KARPENTER_TPU_RELAX2=1`` (the JAX package's flag and knobs, off by
default there too) a sweeps solve tries the convex phase 1 first
(ops/relax2.py, program 17: ``relax_place`` in its convex mode), whether
``relax`` is on or not. A classified standdown (``last_relax2["reason"]``,
``solver_relax_fallback_total{reason}``) falls through to the waterfill (if
``relax``) or the plain sweeps solve; a convex result is gated like a
waterfill one, and a gate violation re-solves with the convex phase off
(``gate-rejected``). An error of the kernels or of the CUDA runtime inside
the phase propagates; only a host-side exception becomes the ``error``
standdown.

With ``KARPENTER_TPU_ORDER_POLICY`` set (solver/ordering.py), the FFD order
takes the learned host tie-break (solver/encode.ffd_order) and, unless
``KARPENTER_TPU_ORDER_POLICY_LANES=0``, the sweeps solves take the learned
requeue order (program 6: one ``lane_scores`` launch, then ``ffd_loop``
sorting each sweep's requeue by the scores), counted in
``solver_order_policy_solves_total{part="lane"}`` as the JAX backend counts
them.

With ``KARPENTER_TPU_EXPLAIN`` set (obs/explain.py), the terminal pass's
failed rows go through one ``attribute`` launch against the final state
(ops/ffd_step.attribute_pods, program 7) and the result carries an
``ExplainReport``: a reason and a hint per unscheduled pod and the
winning-candidate rationale of up to ``KARPENTER_TPU_EXPLAIN_MAX`` scheduled
ones. Placements are the same with the flag on and off.

With ``KARPENTER_TPU_SHARD`` set (the JAX package's flag and knobs, off by
default there too), a solve first tries the partitioned path (shard/, after
the resident world and before the slot ladder, as in the JAX backend): the
batch splits into independent partitions that run as the lanes of one
``ffd_loop`` launch (programs 13-14, parallel/mesh.shard_sweeps), each lane
gated on the device; ``last_shard`` records what happened. A classified
standdown falls through to the path above unchanged. On one card it needs
``KARPENTER_TPU_SHARD_MIN_DEVICES=1`` (the default 2 stands down
``single-device``, as the JAX package does on one chip) and
``KARPENTER_TPU_SHARD_PARTITIONS=N`` for N lanes.

With ``KARPENTER_TPU_WAVEFRONT`` set (the JAX package's flag, off by
default there too; ``_WIDTH`` lanes, default 4), every sweeps loop of the
solve acts on up to ``_WIDTH - 1`` further chain heads after each narrow
iteration (ops/ffd_chain.py ``wave``, csrc/wave.cuh): fresh, carried,
scored, resident and partitioned alike. Placements are those of the flag-off
solve; ``last_iters`` then counts the extra lanes' work and
``last_wave_hist`` holds the iterations by lanes consumed.

With ``KARPENTER_TPU_RUNS`` true (``1``/``true``/``yes``; read when the
solver is built, where the JAX package reads it at import; off by default in
both), the sweeps fast path is off and every pass of the per-pass loop runs
the run-compressed scan (ops/ffd_runs.py): on the card a fresh pass is one
lane of ``runs_screen``'s stacked mode (parallel/mesh.launch_stacked_screen)
and a carried pass one lane of its full mode from the carried state
(launch_runs_screen); on the CPU the plain ``solve_ffd_runs``. The resident
world stands down with ``runs-mode``.

With ``KARPENTER_TPU_TRACE`` on, a solve opens the JAX backend's spans at the
same stage boundaries (obs/trace.py): ``encode``, ``bucket`` (pad, group
remap and the problem's upload), ``relax`` / ``relax2`` (phase 1 and its
stats fetch), ``sweeps`` / ``narrow`` (the loop and its fetch), ``decode``,
and the markers ``escalate``, ``relax_fallback`` and ``relax2_standdown``;
the JAX backend's ``compile`` span has no counterpart (the kernels build
once per process). Every host-device copy of
the solve is counted in ``solver_transfer_bytes_total{direction}``: the
padded problem once per encode pass (phase 1 and the loop read the one
upload), the stats, verdicts, iteration counts and claim rows fetched.

Each dispatch (phase 1, the convex phase, each pass of the loop) is counted
in ``solver_compile_cache_total{result}`` under the JAX backend's program
key (the JAX package's program name, the claim bucket, the padded shapes:
``_program_key``, ``compile_cache_hits`` / ``_misses``) and, with
``KARPENTER_TPU_PROGRAMS`` on, recorded in the program registry
(obs/programs.py) under the JAX package's program name, its key stamped on
the span around the launch; the solve ends with a memory sample. The
kernel-library snapshots (solver/aot.py) act at library load, not here.

These are the environment flags the backend reads, as the JAX backend
reads them.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.metrics.registry import (
    COMPILE_CACHE,
    ORDER_POLICY_SOLVES,
    RELAX_FALLBACK,
    TRANSFER_BYTES,
)
from karpenter_tpu_torch.models.problem import GT_NONE, LT_NONE, problem_to_torch
from karpenter_tpu_torch.obs import programs, trace
from karpenter_tpu_torch.ops.ffd_core import (
    KIND_CLAIM,
    KIND_NEW_CLAIM,
    KIND_NODE,
    KIND_NO_SLOT,
    FFDResult,
    IterCounts,
    _pad_lanes_mult32,
)
from karpenter_tpu_torch.ops.ffd_runs import has_topo_runs, max_run_bucket, solve_ffd_runs
from karpenter_tpu_torch.ops.ffd_step import solve_ffd
from karpenter_tpu_torch.ops.ffd_sweeps import (
    problem_tensors,
    solve_ffd_sweeps,
    solve_ffd_sweeps_carried,
    wavefront_lanes,
)
from karpenter_tpu_torch.ops.padding import claim_axis_bucket, pad_problem
from karpenter_tpu_torch.ops.policy import lane_scores
from karpenter_tpu_torch.ops.relax import relax_applicable, relax_place
from karpenter_tpu_torch.provisioning.preferences import Preferences
from karpenter_tpu_torch.provisioning.topology import Topology
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.solver.backend import (
    FAIL_INCOMPATIBLE,
    Placement,
    SolveResult,
    SolverBackend,
)
from karpenter_tpu_torch.solver import ordering
from karpenter_tpu_torch.solver.encode import (
    Encoder,
    NodeInfo,
    TemplateInfo,
    domains_from_instance_types,
)
from karpenter_tpu_torch.verify.gate import _nbytes


class _SlotOverflow(Exception):
    pass


# Program keys this process has dispatched at least once (the JAX backend's
# set of the same name): (program name, claim bucket, padded leaf shapes).
# Feeds solver_compile_cache_total.
_COMPILED_PROGRAMS: set = set()


def _program_key(name: str, max_claims: int, tree) -> tuple:
    return (name, int(max_claims), programs.shape_key(tree))


def count_program(backend, name: str, max_claims: int, tree) -> bool:
    """Count one dispatch in solver_compile_cache_total and on ``backend``'s
    hit/miss counters; True for a key dispatched before."""
    key = _program_key(name, max_claims, tree)
    hit = key in _COMPILED_PROGRAMS
    _COMPILED_PROGRAMS.add(key)
    COMPILE_CACHE.inc({"result": "hit" if hit else "miss"})
    if backend is not None:
        if hit:
            backend.compile_cache_hits += 1
        else:
            backend.compile_cache_misses += 1
    return hit


def runs_enabled() -> bool:
    """KARPENTER_TPU_RUNS with the JAX backend's truth rules (off by
    default)."""
    return os.environ.get("KARPENTER_TPU_RUNS", "0").lower() in ("1", "true", "yes")


def runs_pass(problem, max_claims: int, init=None) -> FFDResult:
    """One pass of the run-compressed scan (``KARPENTER_TPU_RUNS``): on CUDA
    tensors one lane of ``runs_screen``, in its stacked mode from the initial
    state for a fresh pass and in its full mode from ``init`` for a carried
    one; on CPU tensors the plain ``solve_ffd_runs``."""
    if not problem.lane_valid.is_cuda:
        return solve_ffd_runs(problem, max_claims, init=init)
    from karpenter_tpu_torch.parallel.mesh import (
        _map_leaves,
        launch_runs_screen,
        launch_stacked_screen,
        stack_problems,
    )

    p = _pad_lanes_mult32(problem)
    if init is None:
        r = launch_stacked_screen(stack_problems([p]), max_claims, passes=1)
    else:
        r = launch_runs_screen(
            p, init, p.node_avail[None], p.pod_active[None],
            max_run=max_run_bucket(p), passes=1, with_topo=has_topo_runs(p),
        )
    return FFDResult(kind=r.kind[0], index=r.index[0], state=_map_leaves(lambda x: x[0], r.state), work=r.work)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for and
    absent (there is no silent CPU fallback)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchSolver runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def decode_claim_requirements(meta, adm_row, comp_row, gt_row, lt_row, defined_row):
    """Invert the encode for one claim row: the narrowed requirement state the
    solve committed becomes the claim's Requirements
    (nodeclaimtemplate.go:55-81), minus the hostname pin
    (nodeclaim.go:123-127)."""
    from karpenter_tpu_torch.scheduling.requirements import Requirement

    out = Requirements()
    for ki, key in enumerate(meta.keys):
        if not defined_row[ki] or key == wk.LABEL_HOSTNAME:
            continue
        vals = meta.values_per_key[ki]
        if not comp_row[ki]:
            members = [v for vi, v in enumerate(vals) if adm_row[ki][vi]]
            out.add(Requirement._make(key, False, members))
        else:
            excluded = [v for vi, v in enumerate(vals) if not adm_row[ki][vi]]
            gt = int(gt_row[ki])
            lt = int(lt_row[ki])
            out.add(
                Requirement._make(
                    key, True, excluded,
                    gt if gt != int(GT_NONE) else None,
                    lt if lt != int(LT_NONE) else None,
                )
            )
    return out


def fetch_claims(state):
    """The final claim tensors decode needs, copied to the host in one go."""
    leaves = (
        state.claim_open, state.claim_tpl, state.claim_it_ok, state.claim_requests,
        state.claim_req.admitted, state.claim_req.comp, state.claim_req.gt,
        state.claim_req.lt, state.claim_req.defined,
    )
    return tuple(x.cpu().numpy() for x in leaves)


def decode_claim_placements(out, meta, max_claims, np_final, pod_kinds) -> None:
    """Turn the fetched claim tensors into published Placements and route
    every placed pod to its node or claim."""
    slot_to_claim = {}
    if np_final is not None:
        (claim_open, claim_tpl, claim_it_ok, claim_requests,
         claim_adm, claim_comp, claim_gt, claim_lt, claim_def) = np_final
        for slot in range(max_claims):
            if slot < len(claim_open) and claim_open[slot]:
                tpl_idx = int(claim_tpl[slot])
                placement = Placement(
                    template_index=tpl_idx,
                    nodepool_name=meta.template_names[tpl_idx],
                    instance_type_indices=[
                        int(t)
                        for t in np.flatnonzero(claim_it_ok[slot])
                        if t < len(meta.instance_type_names)
                    ],
                    requirements=decode_claim_requirements(
                        meta, claim_adm[slot], claim_comp[slot],
                        claim_gt[slot], claim_lt[slot], claim_def[slot],
                    ),
                    requests={
                        name: float(claim_requests[slot, ri])
                        for ri, name in enumerate(meta.resource_names)
                        if claim_requests[slot, ri] > 0
                    },
                )
                slot_to_claim[slot] = placement
                out.new_claims.append(placement)
    for orig, (kind, index) in pod_kinds.items():
        if kind == KIND_NODE:
            out.node_pods.setdefault(meta.node_names[index], []).append(orig)
        else:
            slot_to_claim[index].pod_indices.append(orig)


def _remap_group_state(state, old_keys, new_keys, padded_problem):
    """Rebuild grp_counts/grp_registered for a changed group set: carried rows
    move to their new position (matched by group hash); new groups take their
    seeded rows from the freshly-encoded problem."""
    dev = state.grp_counts.device
    old_counts = state.grp_counts.cpu().numpy()
    old_reg = state.grp_registered.cpu().numpy()
    new_counts = np.array(padded_problem.grp_counts0)
    new_reg = np.array(padded_problem.grp_registered0)
    pos_of_old = {k: i for i, k in enumerate(old_keys)}
    V = min(old_counts.shape[1], new_counts.shape[1])
    for new_i, k in enumerate(new_keys):
        old_i = pos_of_old.get(k)
        if old_i is not None and old_i < old_counts.shape[0]:
            new_counts[new_i, :V] = old_counts[old_i, :V]
            new_reg[new_i, :V] = old_reg[old_i, :V]
    return dataclasses.replace(
        state,
        grp_counts=torch.from_numpy(new_counts).to(dev),
        grp_registered=torch.from_numpy(new_reg).to(dev),
    )


class TorchSolver(SolverBackend):
    """FFD provisioning solve on PyTorch tensors (see module docstring)."""

    def __init__(self, well_known=None, initial_claim_slots: int = 32, device=None,
                 relax: bool = True, device_world: bool = False):
        self.device = resolve_device(device)
        # the run-compressed per-pass solve (module docstring,
        # KARPENTER_TPU_RUNS)
        self.runs = runs_enabled()
        # the two-phase solve (module docstring); the JAX package's
        # KARPENTER_TPU_RELAX, on by default there too
        self.relax = relax
        # phase 1's counts (eligible/placed/demoted/claims) of the LAST solve
        # attempt; None when phase 1 did not run or placed nothing
        self.last_relax: Optional[Dict[str, int]] = None
        # the convex phase 1's record of the LAST solve (KARPENTER_TPU_RELAX2):
        # {"reason": None, counts, pgd stats, ...} when its result served,
        # {"reason": <standdown>, ...} otherwise; None when it did not run
        self.last_relax2: Optional[Dict] = None
        # two-phase results the gate rejected (each re-solved with that
        # phase 1 off)
        self.relax_fallbacks = 0
        # IterCounts of the LAST sweeps-mode solve; None before any, and after
        # a per-pass solve. last_wave_hist is its wavefront-width histogram
        # (a list of WIDTH + 1 counts), None with KARPENTER_TPU_WAVEFRONT off
        self.last_iters = None
        self.last_wave_hist = None
        self.well_known = well_known if well_known is not None else wk.WELL_KNOWN_LABELS
        # grows on overflow and persists across solves
        self.claim_slots = claim_axis_bucket(initial_claim_slots)
        self.claim_escalations = 0
        # wall seconds of the LAST solve's phases: encode (host encode + pad +
        # upload), relax (phase 1 and its stats fetch), device (the FFD loop,
        # synchronised), decode (host), gate (gate_relaxed of a two-phase
        # result); a resident cycle reports encode (the delta encode), patch,
        # relax (0), device (the fused solve and the fetch) and decode
        self.last_timing: Dict[str, float] = {}
        # the ExplainReport of the LAST solve that attributed failed pods
        # (KARPENTER_TPU_EXPLAIN); None before any
        self.last_explain = None
        # the partitioned solve's record of the LAST solve
        # (KARPENTER_TPU_SHARD): {"reason": None, partitions, lanes, ...} when
        # it served, {"reason": <standdown>, ...} otherwise; None when the
        # flag is off
        self.last_shard: Optional[Dict] = None
        # lifetime program-cache lookups (count_program)
        self.compile_cache_hits = 0
        self.compile_cache_misses = 0
        # the device-resident cycle (module docstring); None when off
        self._device_world = None
        if device_world:
            from karpenter_tpu_torch.streaming.device_world import DeviceWorld

            self._device_world = DeviceWorld(self)

    @property
    def last_world_outcome(self) -> Optional[str]:
        """The resident path's outcome of the LAST solve (``adopt-*``,
        ``patched``, ``repatched``, ``standdown-*``); None when it is off."""
        return self._device_world.last_outcome if self._device_world is not None else None

    def reset_streaming_state(self) -> None:
        """Drop the device-resident world and its delta state, so that a
        rejected result never seeds the next patched cycle (the JAX
        backend's hook of the same name). No-op when the resident path is
        off."""
        if self._device_world is not None:
            self._device_world.reset()

    def solve(
        self,
        pods: Sequence[Pod],
        instance_types: Sequence[InstanceType],
        templates: Sequence[TemplateInfo],
        nodes: Sequence[NodeInfo] = (),
        pod_requirements_override: Optional[Sequence[Requirements]] = None,
        topology: Optional[Topology] = None,
        cluster_pods: Sequence = (),
        domains: Optional[Dict[str, set]] = None,
        pod_volumes: Optional[Sequence[Dict[str, frozenset]]] = None,
    ) -> SolveResult:
        if not pods:
            return SolveResult()
        # the resident path must see the CALLER's domains: the derived
        # default below never blocks it, explicitly passed ones do
        caller_domains = domains
        if domains is None:
            domains = domains_from_instance_types(instance_types, templates)
        max_claims = min(self.claim_slots, claim_axis_bucket(len(pods)))
        self.last_relax2 = None  # never report a prior solve's convex phase 1
        # passthrough: under a caller's open cycle (the supervisor's, the
        # provisioner's) the phases land under its span; a direct call is its
        # own cycle root
        with trace.cycle("solve", backend=type(self).__name__, passthrough=True, pods=len(pods)):
            return self._solve(
                pods, instance_types, templates, nodes, pod_requirements_override, topology,
                cluster_pods, domains, caller_domains, pod_volumes, max_claims,
            )

    def _solve(self, pods, instance_types, templates, nodes, pod_requirements_override, topology,
               cluster_pods, domains, caller_domains, pod_volumes, max_claims) -> SolveResult:
        if self._device_world is not None:
            resident = self._device_world.try_solve(
                pods, instance_types, templates, nodes, pod_requirements_override,
                topology, cluster_pods, caller_domains, pod_volumes, max_claims,
            )
            if resident is not None:
                return resident
        if os.environ.get("KARPENTER_TPU_SHARD", "0") not in ("", "0"):
            # the partitioned fleet-scale path (shard/): split the batch into
            # independent sub-problems and run them as one lane grid. None =
            # classified standdown (solver_shard_fallback_total): fall through
            # unchanged. Flag off, the subsystem is never imported.
            from karpenter_tpu_torch.shard import try_shard_solve

            sharded = try_shard_solve(
                self, pods, instance_types, templates, nodes,
                pod_requirements_override, topology, cluster_pods,
                domains, pod_volumes,
            )
            if sharded is not None:
                return sharded
        allow_relax = self.relax
        allow_relax2 = True
        while True:
            try:
                result = self._solve_with_slots(
                    pods, instance_types, templates, nodes, pod_requirements_override,
                    topology, cluster_pods, domains, max_claims, pod_volumes, allow_relax,
                    allow_relax2,
                )
            except _SlotOverflow:
                if max_claims >= len(pods):
                    raise RuntimeError("claim slots exhausted at pod count") from None
                # one bucket step per overflow (claim_axis_bucket's quarter
                # steps above 128)
                max_claims = min(claim_axis_bucket(max_claims + 1), claim_axis_bucket(len(pods)))
                self.claim_slots = max(self.claim_slots, max_claims)
                self.claim_escalations += 1
                with trace.span("escalate", max_claims=max_claims):
                    pass
                continue
            relax2_used = self.last_relax2 is not None and self.last_relax2.get("reason") is None
            if self.last_relax is not None or relax2_used:
                # the two-phase contract: gate every relaxed result, the
                # waterfill's and the convex phase's alike; a violation
                # re-solves with that phase off (the JAX package's
                # solver/jax_backend.py:414-447)
                import time

                from karpenter_tpu_torch.verify import gate_relaxed

                t0 = time.perf_counter()
                violations = gate_relaxed(
                    result, pods, instance_types, templates, nodes,
                    pod_requirements_override, cluster_pods, domains,
                )
                self.last_timing["gate"] = time.perf_counter() - t0
                if violations:
                    RELAX_FALLBACK.inc({"reason": "gate-rejected"})
                    self.relax_fallbacks += 1
                    if relax2_used:
                        allow_relax2 = False
                        self.last_relax2 = {"reason": "gate-rejected"}
                    else:
                        allow_relax = False
                    with trace.span("relax_fallback", violations=len(violations)):
                        pass
                    continue
            return result

    def _explain(self, out, problem, state, meta, kinds, failed, failed_rows,
                 pod_kinds, instance_types, total_pods, tables=None):
        """The explain pass (the JAX backend's ``_explain``): attribute the
        failed rows against the final state (one ``attribute`` launch on the
        card, reading the loop's ``tables``), decode reasons, attach the bounded winning-candidate rationale
        and publish the ExplainReport (ring and metrics) on ``out``. Returns
        the raw int32[B, 3] attribution words."""
        import time

        from karpenter_tpu_torch.obs import explain as obs_explain
        from karpenter_tpu_torch.ops.ffd_step import attribute_pods

        t0 = time.perf_counter()
        with trace.span("explain", failed=len(failed)):
            words = attribute_pods(problem, state, failed_rows, tables).cpu().numpy()
            report = obs_explain.ExplainReport(
                backend=type(self).__name__,
                trace_id=trace.current_trace_id(),
                total_pods=total_pods,
                scheduled=total_pods - len(failed),
            )
            pod_requests = problem.pod_requests.cpu().numpy()
            for i, orig in enumerate(failed):
                row = failed_rows[i]
                expl = obs_explain.decode_pod(orig, int(kinds[row]), words[i])
                if expl.reason == obs_explain.REASON_RESOURCES:
                    requests = {
                        name: float(pod_requests[row, ri])
                        for ri, name in enumerate(meta.resource_names)
                        if ri < pod_requests.shape[1] and pod_requests[row, ri] > 0
                    }
                    hint = obs_explain.resource_hint(requests, instance_types)
                    if hint:
                        expl.hint = hint
                report.pods[orig] = expl
            if pod_kinds:
                report.nominations = self._nominations(problem, state, meta, pod_kinds)
            report.overhead_s = time.perf_counter() - t0
            trace.attr("reasons", report.counts())
            trace.attr("overhead_s", round(report.overhead_s, 6))
            obs_explain.publish(report)
        self.last_explain = report
        out.explain = report
        return words

    def _nominations(self, problem, state, meta, pod_kinds):
        """Winning-candidate rationale for up to KARPENTER_TPU_EXPLAIN_MAX
        scheduled pods in commit order: the chosen bin and its per-resource
        slack against the end-of-pass bin state."""
        import itertools

        from karpenter_tpu_torch.obs import explain as obs_explain

        cap = obs_explain.max_pods()
        node_requests = state.node_requests.cpu().numpy()
        claim_requests = state.claim_requests.cpu().numpy()
        claim_it_ok = state.claim_it_ok.cpu().numpy()
        node_avail = problem.node_avail.cpu().numpy()
        it_alloc = problem.it_alloc.cpu().numpy()
        R = len(meta.resource_names)
        noms = {}
        for orig, (kind, index) in itertools.islice(pod_kinds.items(), cap):
            if kind == KIND_NODE and index < len(node_avail):
                slack = node_avail[index][:R] - node_requests[index][:R]
                bin_name = meta.node_names[index]
            elif index < len(claim_requests):
                surviving = np.flatnonzero(claim_it_ok[index])
                best = it_alloc[surviving].max(axis=0) if len(surviving) else np.zeros(it_alloc.shape[1])
                slack = best[:R] - claim_requests[index][:R]
                bin_name = int(index)
            else:
                continue
            margins = {meta.resource_names[ri]: round(float(slack[ri]), 6) for ri in range(min(R, len(slack)))}
            worst = min(margins.items(), key=lambda kv: kv[1]) if margins else (None, 0.0)
            noms[orig] = {
                "kind": obs_explain.KIND_NAMES[kind],
                "bin": bin_name,
                "margin_basis": "end-of-pass",
                "margins": margins,
                "min_margin": {"resource": worst[0], "value": worst[1]},
            }
        return noms

    def _relax_phase(self, problem, max_claims):
        """Phase 1 over the padded device problem: its RelaxOut, or None when
        it placed nothing (the plain sweeps solve is then the whole solve)."""
        count_program(self, "relax_place", max_claims, problem)
        obs = programs.begin_dispatch("relax_place", max_claims, problem, kernel="relax_place")
        with trace.span("relax", program="relax_place") as sp:
            rout = relax_place(problem, max_claims)
            fetched = torch.stack(list(rout.stats)).cpu()
            TRANSFER_BYTES.inc({"direction": "d2h"}, _nbytes(fetched))
            if obs is not None:
                programs.stamp(sp, obs, obs.finish(problem_bytes=_nbytes(problem), result_bytes=_nbytes(fetched)))
            self.last_relax = dict(zip(("eligible", "placed", "demoted", "claims"), fetched.tolist()))
            if sp is not None:
                for name, value in self.last_relax.items():
                    sp.count(name, value)
        if self.last_relax["placed"] <= 0:
            self.last_relax = None
            return None
        return rout

    def _relax2_standdown(self, reason, **info):
        """A classified standdown of the convex phase 1: counted, recorded in
        ``last_relax2``, and None so that the solve goes on as with the flag
        off."""
        RELAX_FALLBACK.inc({"reason": reason})
        self.last_relax2 = {"reason": reason, **info}
        with trace.span("relax2_standdown", reason=reason):
            pass
        return None

    def _relax2_phase(self, problem, max_claims):
        """Convex phase 1 (``KARPENTER_TPU_RELAX2``) over the padded device
        problem: its RelaxOut, or None on a classified standdown. Errors of
        the kernels or of the CUDA runtime propagate (the supervisor raises
        them after its retries); any other exception is the ``error``
        standdown, as in the JAX backend."""
        import time

        from karpenter_tpu_torch.ops import relax2
        from karpenter_tpu_torch.solver.supervisor import device_fault

        t_phase = time.perf_counter()
        try:
            if not relax2.relax_applicable(problem):
                return self._relax2_standdown("finite-pool")
            count_program(self, "relax2_place", max_claims, problem)
            obs = programs.begin_dispatch("relax2_place", max_claims, problem, kernel="relax2_place")
            with trace.span("relax2", program="relax2_place") as sp:
                rout = relax2.relax2_place(problem, max_claims)
                stats = relax2.host_stats(rout.stats)
                # host_stats fetches one int32 word per stat
                TRANSFER_BYTES.inc({"direction": "d2h"}, 4 * len(rout.stats))
                if obs is not None:
                    programs.stamp(sp, obs, obs.finish(problem_bytes=_nbytes(problem),
                                                       result_bytes=4 * len(rout.stats)))
            if stats.eligible <= 0:
                return self._relax2_standdown(relax2.classify_ineligible(problem))
            if not relax2.converged(stats.residual, stats.capviol):
                return self._relax2_standdown(
                    "non-convergence", residual=stats.residual, capviol=stats.capviol,
                    pgd_iterations=stats.pgd_iterations,
                )
            if stats.placed <= 0:
                return self._relax2_standdown(
                    "rounding-overflow", eligible=stats.eligible, overflow=stats.overflow,
                    round_demoted=stats.round_demoted,
                )
            self.last_relax2 = {
                "reason": None,
                "eligible": stats.eligible,
                "placed": stats.placed,
                "demoted": stats.demoted,
                "claims": stats.claims,
                "pgd_iterations": stats.pgd_iterations,
                "residual": stats.residual,
                "capviol": stats.capviol,
                "rounding": {"overflow": stats.overflow, "demoted": stats.round_demoted},
                "phase_s": round(time.perf_counter() - t_phase, 6),
            }
            return rout
        except Exception as exc:
            if device_fault(exc):
                raise
            return self._relax2_standdown("error", error=repr(exc))

    def _solve_with_slots(
        self, pods, instance_types, templates, nodes, pod_requirements_override,
        topology, cluster_pods, domains, max_claims, pod_volumes=None, allow_relax=False,
        allow_relax2=True,
    ) -> SolveResult:
        import time

        timing = {"encode": 0.0, "relax": 0.0, "device": 0.0, "decode": 0.0}
        self.last_timing = timing
        self.last_relax = None  # never report a prior attempt's phase 1
        work = list(pods)
        copied = set()
        vocab_pods = list(pods)  # frozen vocabulary seed (originals never mutate)
        topo = (
            topology.clone()
            if topology is not None
            else Topology(domains, batch_pods=work, cluster_pods=cluster_pods)
        )
        for n in nodes:
            topo.register(wk.LABEL_HOSTNAME, n.name)
        prefs = Preferences(
            tolerate_prefer_no_schedule=any(
                t.effect == "PreferNoSchedule" for tpl in templates for t in tpl.taints
            )
        )
        encoder = Encoder(self.well_known)
        # nothing relaxable: the requeue passes are one kernel launch; any
        # relaxable pod keeps the per-pass loop (host re-encode per rung), as
        # does the run-compressed solve (KARPENTER_TPU_RUNS)
        use_runs = self.runs
        use_sweeps = not use_runs and not prefs.tolerate_prefer_no_schedule and not any(
            Preferences.is_relaxable(p) for p in work
        )
        out = SolveResult()
        pod_kinds: Dict[int, tuple] = {}  # original index -> (kind, bin index)
        state = None
        meta = None
        np_final = None
        prev_group_keys = None
        queue = list(range(len(work)))
        while queue:
            t0 = time.perf_counter()
            with trace.span("encode", queue=len(queue)):
                encoded = encoder.encode(
                    [work[i] for i in queue],
                    instance_types,
                    templates,
                    nodes,
                    pod_reqs_override=(
                        [pod_requirements_override[i] for i in queue]
                        if pod_requirements_override is not None
                        else None
                    ),
                    topology=topo,
                    num_claim_slots=max_claims,
                    vocab_pods=vocab_pods,
                    vocab_reqs=pod_requirements_override,
                    pod_volumes=(
                        [pod_volumes[i] for i in queue] if pod_volumes is not None else None
                    ),
                )
            with trace.span("bucket", max_claims=max_claims):
                host_problem, meta = pad_problem(encoded.problem), encoded.meta
                group_keys = [
                    tg.hash_key()
                    for tg in list(topo.topologies.values()) + list(topo.inverse_topologies.values())
                ]
                if state is not None and group_keys != prev_group_keys:
                    state = _remap_group_state(state, prev_group_keys, group_keys, host_problem)
                prev_group_keys = group_keys
                # the pass's one upload: phase 1 and the loop read it
                problem = problem_to_torch(host_problem, self.device)
                TRANSFER_BYTES.inc({"direction": "h2d"}, _nbytes(host_problem))
            timing["encode"] += time.perf_counter() - t0

            lanes = use_sweeps and ordering.lanes_enabled()
            if lanes:
                ORDER_POLICY_SOLVES.inc({"part": "lane"})
            rout = None
            if use_sweeps and allow_relax2 and state is None and os.environ.get("KARPENTER_TPU_RELAX2", "0") == "1":
                # convex phase 1 first; None is a classified standdown and
                # the solve goes on as with the flag off
                t0 = time.perf_counter()
                rout = self._relax2_phase(problem, max_claims)
                timing["relax"] += time.perf_counter() - t0
            if rout is None and use_sweeps and allow_relax and state is None and relax_applicable(host_problem):
                # phase 1 places the eligible bulk; the SAME sweeps loop then
                # repairs the residue carrying phase 1's claims and verdicts.
                # Sweeps mode runs one pass, so this only ever sees a fresh
                # state.
                t0 = time.perf_counter()
                rout = self._relax_phase(problem, max_claims)
                timing["relax"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            wavefront = wavefront_lanes()
            # the JAX backend's program names (the learned order's twins
            # carry _policy) and the kernel that serves each
            if use_sweeps:
                program = "solve_ffd_sweeps_carried" if rout is not None else "solve_ffd_sweeps"
                if lanes:
                    program += "_policy"
                kernel = "ffd_loop_wavefront" if wavefront else "ffd_loop"
            else:
                program = "solve_ffd_runs" if use_runs else "solve_ffd"
                kernel = "runs_screen" if use_runs else "ffd_loop"
            pass_problem = (dataclasses.replace(problem, pod_active=rout.residue_active)
                            if rout is not None else problem)
            count_program(self, program, max_claims, pass_problem)
            obs = programs.begin_dispatch(program, max_claims, pass_problem, kernel=kernel)
            carried_in = 0
            if obs is not None:
                carried_in = _nbytes(rout.state) if rout is not None else _nbytes(state)
            with trace.span("sweeps" if use_sweeps else "narrow", program=program) as sp:
                # the learned requeue order: one score per row (the rows'
                # features do not depend on which are active), read by the
                # fresh or the carried loop; on the card both launches read
                # one build of the problem's tables
                scores = tables = None
                if lanes:
                    if problem.lane_valid.is_cuda:
                        tables = problem_tensors(_pad_lanes_mult32(problem))
                    scores = lane_scores(problem, ordering.lane_weights_static(), tables=tables)
                if rout is not None:
                    problem = dataclasses.replace(problem, pod_active=rout.residue_active)
                    host_problem = dataclasses.replace(
                        host_problem, pod_active=rout.residue_active.cpu().numpy()
                    )
                    if lanes:
                        ORDER_POLICY_SOLVES.inc({"part": "lane"})
                    result = solve_ffd_sweeps_carried(problem, max_claims, init=(rout.state, rout.kind, rout.index),
                                                      order_scores=scores, wavefront=wavefront, tables=tables)
                elif use_sweeps:
                    result = solve_ffd_sweeps(problem, max_claims, order_scores=scores, wavefront=wavefront,
                                              tables=tables)
                elif use_runs:
                    result = runs_pass(problem, max_claims, init=state)
                else:
                    result = solve_ffd(problem, max_claims, init=state)
                state = result.state
                kinds = result.kind.cpu().numpy()
                indices = result.index.cpu().numpy()
                d2h = kinds.nbytes + indices.nbytes
                if use_sweeps:
                    np_final = fetch_claims(state)
                    iters = tuple(int(x) for x in result.iters)
                    self.last_iters = type(result.iters)(*iters)
                    self.last_wave_hist = None if result.wave_hist is None else result.wave_hist.cpu().tolist()
                    # the iteration counts are the loop's int32 counter words
                    d2h += _nbytes(np_final) + 4 * len(iters) + _nbytes(result.wave_hist)
                else:
                    np_final = None
                    self.last_iters = None
                    self.last_wave_hist = None
                TRANSFER_BYTES.inc({"direction": "d2h"}, d2h)
                if obs is not None:
                    programs.stamp(sp, obs, obs.finish(problem_bytes=_nbytes(problem), carried_bytes=carried_in,
                                                       result_bytes=d2h))
                if sp is not None:
                    sp.count("d2h_bytes", d2h)
                    if self.last_iters is not None:
                        for name, value in zip(IterCounts._fields, self.last_iters):
                            sp.count(name, value)
            timing["device"] += time.perf_counter() - t0
            if (kinds[: len(queue)] == KIND_NO_SLOT).any():
                raise _SlotOverflow()

            t0 = time.perf_counter()
            with trace.span("decode"):
                failed = []
                failed_rows = []  # device row per failed orig (the explain pass)
                progress = False
                for row in range(len(meta.pod_order)):
                    orig = queue[meta.pod_order[row]]
                    kind, index = int(kinds[row]), int(indices[row])
                    if kind in (KIND_NODE, KIND_CLAIM, KIND_NEW_CLAIM):
                        pod_kinds[orig] = (kind, index)
                        progress = True
                    else:
                        failed.append(orig)
                        failed_rows.append(row)
                relaxed_any = False
                if not use_sweeps:  # sweeps imply nothing is relaxable
                    for orig in failed:
                        if orig not in copied:
                            work[orig] = copy.deepcopy(work[orig])
                            copied.add(orig)
                        if prefs.relax(work[orig]) is not None:
                            relaxed_any = True
                            topo.update(work[orig])
            timing["decode"] += time.perf_counter() - t0
            if use_sweeps or (not progress and not relaxed_any):
                # terminal failures: the reference's per-template forensics,
                # reconstructed host-side (solver/forensics.py)
                from karpenter_tpu_torch.solver.forensics import failure_reason

                for orig in failed:
                    out.failures[orig] = failure_reason(
                        work[orig],
                        instance_types,
                        templates,
                        pod_reqs=(
                            pod_requirements_override[orig]
                            if pod_requirements_override is not None
                            else None
                        ),
                        well_known=self.well_known,
                    ) or FAIL_INCOMPATIBLE
                # the attribution is a separate pass over the final state:
                # placements are the same with the flag on or off
                from karpenter_tpu_torch.obs import explain as obs_explain

                if obs_explain.enabled() and state is not None:
                    self._explain(
                        out, problem, state, meta, kinds, failed, failed_rows,
                        pod_kinds, instance_types, len(pods), result.tables,
                    )
                break
            queue = failed

        t0 = time.perf_counter()
        with trace.span("decode", final=True):
            if state is not None and np_final is None:
                np_final = fetch_claims(state)
                TRANSFER_BYTES.inc({"direction": "d2h"}, _nbytes(np_final))
            decode_claim_placements(out, meta, max_claims, np_final if state is not None else None, pod_kinds)
        # the solve cycle's memory sample (obs/programs.py): the carried
        # FFDState, and on the CPU the tensors the solve holds
        if programs.enabled():
            carried = _nbytes(state) if state is not None else 0
            programs.sample_memory(carried_bytes=carried, pods=len(pods), cycle=trace.current_trace_id(),
                                   device=self.device, held_bytes=_nbytes(problem) + carried)
        if use_sweeps and meta is not None:
            # single-pass solves hand the device gate the exact padded tensors
            # this result decoded from (the repair pass's residue problem after
            # phase 1, as the JAX backend does)
            from karpenter_tpu_torch import verify

            out.verify_ctx = verify.make_context(
                host_problem, meta, max_claims, len(pods),
                pod_requirements_override is not None,
                device_problem=problem, device=self.device, device_tables=result.tables,
            )
        timing["decode"] += time.perf_counter() - t0
        return out
