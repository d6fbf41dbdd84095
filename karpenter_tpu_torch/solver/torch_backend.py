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

With ``KARPENTER_TPU_EXPLAIN`` set (obs/explain.py; the one environment
flag the backend reads, as the JAX backend reads it), the terminal pass's
failed rows go through one ``attribute`` launch against the final state
(ops/ffd_step.attribute_pods, program 7) and the result carries an
``ExplainReport``: a reason and a hint per unscheduled pod and the
winning-candidate rationale of up to ``KARPENTER_TPU_EXPLAIN_MAX`` scheduled
ones. Placements are the same with the flag on and off.

Not ported: the JAX backend's other flag-gated subsystems (shard, relax2,
learned order, AOT, program registry, trace and metrics).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.models.problem import GT_NONE, LT_NONE, problem_to_torch
from karpenter_tpu_torch.ops.ffd_core import KIND_CLAIM, KIND_NEW_CLAIM, KIND_NODE, KIND_NO_SLOT
from karpenter_tpu_torch.ops.ffd_step import solve_ffd
from karpenter_tpu_torch.ops.ffd_sweeps import solve_ffd_sweeps, solve_ffd_sweeps_carried
from karpenter_tpu_torch.ops.padding import claim_axis_bucket, pad_problem
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
from karpenter_tpu_torch.solver.encode import (
    Encoder,
    NodeInfo,
    TemplateInfo,
    domains_from_instance_types,
)


class _SlotOverflow(Exception):
    pass


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
        # the two-phase solve (module docstring); the JAX package's
        # KARPENTER_TPU_RELAX, on by default there too
        self.relax = relax
        # phase 1's counts (eligible/placed/demoted/claims) of the LAST solve
        # attempt; None when phase 1 did not run or placed nothing
        self.last_relax: Optional[Dict[str, int]] = None
        # two-phase results the gate rejected (each re-solved with relax off)
        self.relax_fallbacks = 0
        # IterCounts of the LAST sweeps-mode solve; None before any, and after
        # a per-pass solve
        self.last_iters = None
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
        if self._device_world is not None:
            resident = self._device_world.try_solve(
                pods, instance_types, templates, nodes, pod_requirements_override,
                topology, cluster_pods, caller_domains, pod_volumes, max_claims,
            )
            if resident is not None:
                return resident
        allow_relax = self.relax
        while True:
            try:
                result = self._solve_with_slots(
                    pods, instance_types, templates, nodes, pod_requirements_override,
                    topology, cluster_pods, domains, max_claims, pod_volumes, allow_relax,
                )
            except _SlotOverflow:
                if max_claims >= len(pods):
                    raise RuntimeError("claim slots exhausted at pod count") from None
                # one bucket step per overflow (claim_axis_bucket's quarter
                # steps above 128)
                max_claims = min(claim_axis_bucket(max_claims + 1), claim_axis_bucket(len(pods)))
                self.claim_slots = max(self.claim_slots, max_claims)
                self.claim_escalations += 1
                continue
            if self.last_relax is not None:
                # the two-phase contract: gate every relaxed result; a
                # violation re-solves with relaxation off
                # (the JAX package's solver/jax_backend.py:414-447)
                import time

                from karpenter_tpu_torch.verify import gate_relaxed

                t0 = time.perf_counter()
                violations = gate_relaxed(
                    result, pods, instance_types, templates, nodes,
                    pod_requirements_override, cluster_pods, domains,
                )
                self.last_timing["gate"] = time.perf_counter() - t0
                if violations:
                    self.relax_fallbacks += 1
                    allow_relax = False
                    continue
            return result

    def _explain(self, out, problem, state, meta, kinds, failed, failed_rows,
                 pod_kinds, instance_types, total_pods):
        """The explain pass (the JAX backend's ``_explain``): attribute the
        failed rows against the final state (one ``attribute`` launch on the
        card), decode reasons, attach the bounded winning-candidate rationale
        and publish the ExplainReport (ring and metrics) on ``out``. Returns
        the raw int32[B, 3] attribution words."""
        import time

        from karpenter_tpu_torch.obs import explain as obs_explain
        from karpenter_tpu_torch.obs import trace
        from karpenter_tpu_torch.ops.ffd_step import attribute_pods

        t0 = time.perf_counter()
        with trace.span("explain", failed=len(failed)):
            words = attribute_pods(problem, state, failed_rows).cpu().numpy()
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
        rout = relax_place(problem, max_claims)
        stats = torch.stack(list(rout.stats)).cpu().tolist()
        self.last_relax = dict(zip(("eligible", "placed", "demoted", "claims"), stats))
        if self.last_relax["placed"] <= 0:
            self.last_relax = None
            return None
        return rout

    def _solve_with_slots(
        self, pods, instance_types, templates, nodes, pod_requirements_override,
        topology, cluster_pods, domains, max_claims, pod_volumes=None, allow_relax=False,
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
        # relaxable pod keeps the per-pass loop (host re-encode per rung)
        use_sweeps = not prefs.tolerate_prefer_no_schedule and not any(
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
            host_problem, meta = pad_problem(encoded.problem), encoded.meta
            group_keys = [
                tg.hash_key()
                for tg in list(topo.topologies.values()) + list(topo.inverse_topologies.values())
            ]
            if state is not None and group_keys != prev_group_keys:
                state = _remap_group_state(state, prev_group_keys, group_keys, host_problem)
            prev_group_keys = group_keys
            problem = problem_to_torch(host_problem, self.device)
            timing["encode"] += time.perf_counter() - t0

            rout = None
            if use_sweeps and allow_relax and state is None and relax_applicable(host_problem):
                # phase 1 places the eligible bulk; the SAME sweeps loop then
                # repairs the residue carrying phase 1's claims and verdicts.
                # Sweeps mode runs one pass, so this only ever sees a fresh
                # state.
                t0 = time.perf_counter()
                rout = self._relax_phase(problem, max_claims)
                timing["relax"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            if rout is not None:
                problem = dataclasses.replace(problem, pod_active=rout.residue_active)
                host_problem = dataclasses.replace(
                    host_problem, pod_active=rout.residue_active.cpu().numpy()
                )
                result = solve_ffd_sweeps_carried(
                    problem, max_claims, init=(rout.state, rout.kind, rout.index)
                )
            elif use_sweeps:
                result = solve_ffd_sweeps(problem, max_claims)
            else:
                result = solve_ffd(problem, max_claims, init=state)
            state = result.state
            kinds = result.kind.cpu().numpy()
            indices = result.index.cpu().numpy()
            if use_sweeps:
                np_final = fetch_claims(state)
                self.last_iters = type(result.iters)(*(int(x) for x in result.iters))
            else:
                np_final = None
                self.last_iters = None
            timing["device"] += time.perf_counter() - t0
            if (kinds[: len(queue)] == KIND_NO_SLOT).any():
                raise _SlotOverflow()

            t0 = time.perf_counter()
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
                        pod_kinds, instance_types, len(pods),
                    )
                break
            queue = failed

        t0 = time.perf_counter()
        if state is not None and np_final is None:
            np_final = fetch_claims(state)
        decode_claim_placements(out, meta, max_claims, np_final if state is not None else None, pod_kinds)
        if use_sweeps and meta is not None:
            # single-pass solves hand the device gate the exact padded tensors
            # this result decoded from (the repair pass's residue problem after
            # phase 1, as the JAX backend does)
            from karpenter_tpu_torch import verify

            out.verify_ctx = verify.make_context(
                host_problem, meta, max_claims, len(pods),
                pod_requirements_override is not None,
                device_problem=problem, device=self.device,
            )
        timing["decode"] += time.perf_counter() - t0
        return out
