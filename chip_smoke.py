#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``karpenter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``karpenter_tpu_torch/csrc`` and runs:

  1. kernel vs plain: each kernel against its plain PyTorch version on the
     card, over seeded corpora (existing nodes, taints, host ports, Gt/Lt
     bounds, zone/hostname spread and affinity, claim-slot overflows, a
     rounding ladder that demotes pods, relaxable pods in one-pass mode,
     chain-heavy populations whose chains commit through every branch, more
     than 32 label keys and 2,560 value lanes). ``ffd_loop`` (fresh,
     carried from phase 1, one-pass) and ``relax_place`` must match exactly
     on kind/index, residue, stats, integer and bool state and all four
     IterCounts fields (narrow iterations, sweeps, chain commits, chain
     pods), and within rtol 1e-5 on float state; ``attribute`` must give the
     plain words for every active row against each solve's final state, and
     every gate family must fail somewhere; ``runs_screen`` (stacked) must
     equal its plain version at the wide shapes; ``gate_counts`` must give
     identical counts on clean results and on results corrupted to trip each
     invariant. Whole solves with ``relax`` on and off must equal the plain
     path's ``TorchSolver(device="cpu")``.
  2. the main path at full width: ``TorchSolver().solve`` (the default
     two-phase solve: ``relax_place``, the carried ``ffd_loop``, the relaxed
     gate) on 10,000 pods of the reference's diverse mix against 400 catalog
     instance types and one default NodePool, 128 claim slots with
     escalation, with the launch counts read just after it; then
     ``full_gate`` of the result (a reject fails the run); then the
     ``relax=False`` path on the same batch. Then at the main path's shapes
     each kernel alone (CUDA events around the launch, arguments built
     beforehand), its wrapper, and its plain version on the same inputs,
     which it must equal: ``relax_place``, ``ffd_loop`` carried and fresh
     (with their IterCounts) and one-pass (over the batch's first
     ONE_PASS_PODS rows, the depth cut so the whole smoke keeps its time),
     ``gate_counts``.
  3. the consolidation screen at full width: ``UnionScorer.score_subsets``
     over the bench cluster widened to 200 candidates (the 100 prefixes, the
     200 singletons and 20 seeded random subsets of 150-200 candidates: 320
     lanes in one ``runs_screen`` launch). Corpus A (8 pinned base pods
     filling the survivors) through the residual screen (``delta=True``, its
     base world on the seeded ``ffd_loop``) and through the full screen
     (``delta=False``); corpus B (A plus 24 zonal spread pods) stands the
     batch down to the full screen with three passes and a topology run.
     The delta verdicts must equal the full screen's on every lane, the
     counts must equal the JAX package's on the same subsets, and
     ``runs_screen`` must equal its plain version exactly (kind, index, every
     state leaf) in each mode on 50 lanes (every 10th, the last, the 20 large
     random subsets); then the kernel alone, through its wrapper, and its
     plain version are timed.
  4. the steady-state churn cycle (the JAX package's device-world bench
     scenario): 10,000 ``default_pod_factory`` pods against 400 catalog
     types, 200 arrivals and 200 deletes a cycle, 24 cycles, through
     ``TorchSolver(relax=False, device_world=True)`` and, in lockstep on the
     same snapshots, ``TorchSolver(relax=False)``. One adopt and 23 patched
     cycles with no standdown; placements equal to the legacy arm's on
     every cycle; the fused counts zero; per patched cycle exactly one
     ``patch_world``, one ``ffd_loop`` and one ``gate_counts`` launch (the
     counts set to 0 before each cycle and read after it); ``patch_world``
     bit-equal to its plain version on every patched cycle; the resident
     world bit-equal to the cold encode's on every fourth cycle and the
     last; the fused counts equal to ``gate_counts_plain`` over the same
     state on two cycles. Then the cycle walls, their split, the bytes up,
     and ``patch_world`` and the fused gate alone, wrapped and plain.
  5. the supervised multi-tenant serve path (the JAX package's serve
     scenario): ``runs_screen`` in its stacked mode through
     ``serve.batch.stacked_solve`` (encode, stack, one launch, decode, full
     validation) at 8 tenants x 50 pods (50 types) and 8 x 1,250 (400
     types), one launch each with every lane riding it, each lane's
     scheduled count equal to a solo ``TorchSolver`` solve, the kernel
     equal to ``batched_screen_plain`` (three passes) and
     ``batched_solve_plain`` (one) on every narrow lane and two wide ones,
     then timed alone, wrapped and plain; the 16-tenant x 6-cycle scenario
     through ``SolveService`` (a warm pass, a measured pass with its launch
     counts, every ticket ok, the stacked ``runs_screen`` launched) beside
     the same problems through one ``SupervisedSolver``, every tenant's
     supervisor and the control left with a closed circuit and no fallback,
     retry or rejection; the overload probe (a 2-deep queue, a 20 ms
     solver, a 50 ms budget: no unclassified outcome); and phase 2's batch
     through ``SupervisedSolver(TorchSolver(), fallback=OracleSolver())``,
     which must return phase 2's placements with the circuit closed and no
     fallback, retry or rejection.
  6. the explain pass at full width: phase 2's batch under a NodePool cpu
     limit that leaves about a quarter of it unscheduled (claim-capacity,
     topology), and phase
     2's batch with tests/test_explain.py's engineered pods added
     (resources, requirements), each with ``KARPENTER_TPU_EXPLAIN`` off and
     on: the same placements, one ``attribute`` launch with the flag on
     (none off), words equal to ``attribute_plain``'s on the same rows and
     state, the report's reasons equal to the plain words' decode; then the
     kernel alone, wrapped and plain on the limited batch's rows, and the
     explain overhead.
  7. a ``kernels`` JSON line: per kernel its launches on the main path, its
     time alone and through its wrapper, its bound, and the plain version's
     time; for ``ffd_loop``, ``relax_place`` and ``runs_screen`` also the
     work counters their launches recorded, from which the operation bounds
     are computed, and for ``ffd_loop`` the latency floor of its barriers and
     its fresh and one-pass modes. Bytes are those of the kernel's own
     arguments. The churn and serve phases' records ride in the same line.
  8. the card's name and power limit; the last line is the device JSON.

Any mismatch or exception exits non-zero. Needs one CUDA device; imports
only torch, numpy and karpenter_tpu_torch.
"""

import ctypes
import dataclasses
import json
import random
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bytes/s, and float32
# operations/s outside the tensor cores (an FMA counted as two). The
# kernels' mask algebra is int32/bool work: an H100 SM has 64 int32 lanes
# against 128 float32 lanes and no int32 FMA, so its int32 peak is a quarter
# of the float32 figure.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_OPS_S = 67e12
PEAK_INT32_OPS_S = PEAK_FP32_OPS_S * 64 / 128 / 2

FLOAT_RTOL = 1e-5  # float state: same adds in the same order, FMA off
FLOAT_ATOL = 1e-6

MAIN_PODS = 10000  # the north-star batch
ONE_PASS_PODS = 2500  # the one-pass scan's depth in phase 2 (its plain loop is per pod)
SOLVE_KERNELS = ("ffd_loop", "gate_counts", "relax_place")

# the consolidation screen's cluster: the bench scorer widened to the screen's
# 200-candidate basis; the JAX package's counts on these subsets, read on the
# CPU (the residual path: every lane residual, the run trim 9 wide)
SCREEN_CANDIDATES = 200
SCREEN_SEED = 3
EXPECT_A = {"delta_lanes": 320, "fallback_lanes": 0, "rnr": 9, "consolidatable": 316, "new_claims": [306, 10, 4]}
EXPECT_B = {"mode": "full", "passes": 3, "all_scheduled": 320, "consolidatable": 307, "new_claims": [306, 1, 13]}

# the steady-state churn cycle: the JAX package's device-world bench scenario
# (bench.py device_churn): 10,000 default_pod_factory pods, 2% arrivals and
# 2% deletes a cycle, 24 cycles; 64 claim slots, the bucket the batch's 39
# claims escalate to from the default 32 (read from the JAX package on the
# CPU), so that no cycle overflows
CHURN_PODS = 10000
CHURN_CYCLES = 24
CHURN_RATE = CHURN_PODS * 2 // 100
CHURN_SEED = 21
CHURN_SLOTS = 64

# the multi-tenant serve path: the JAX package's serve scenario (bench.py
# serve: 16 tenants, 6 cycles of 50 default_pod_factory pods each, 50 catalog
# types, one NodePool, seed 99) and the stacked kernel at two shapes: that
# scenario's first cycle over 8 tenants, and the north-star 10k batch split
# over 8 tenant clusters at the 400-type catalog
SERVE_TENANTS = 16
SERVE_CYCLES = 6
SERVE_PODS = 50
SERVE_ITS = 50
SERVE_SEED = 99
STACK_LANES = 8
WIDE_PODS = 1250
WIDE_ITS = 400

# the explain phase: phase 2's batch under a NodePool cpu limit that leaves a
# large share of it unscheduled (each opened claim burns the largest surviving
# type's capacity, 400 cpu at the 400-type catalog: 20 claims take 7,352 of
# the 10,000 pods on the card)
EXPLAIN_CPU_LIMIT = 8000.0


def log(msg):
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    return run(torch.device("cuda"))


def run(dev) -> int:
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
    from karpenter_tpu_torch.models.problem import numpy_fields, problem_to_torch
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops.ffd_core import _lane_align, _pad_lanes_mult32, initial_state, problem_bounds_free
    from karpenter_tpu_torch.ops.ffd_step import attribute_plain, launch_attribute, solve_ffd, solve_ffd_plain
    from karpenter_tpu_torch.ops.ffd_sweeps import (
        FFD_SCRATCH,
        FFD_STATE,
        WORK_COUNTERS,
        ffd_loop_args,
        solve_ffd_sweeps,
        solve_ffd_sweeps_carried,
        sweeps_plain,
    )
    from karpenter_tpu_torch.ops.padding import pad_problem
    from karpenter_tpu_torch.parallel import mesh
    from karpenter_tpu_torch.provisioning.topology import Topology
    from karpenter_tpu_torch.solver.encode import Encoder, domains_from_instance_types
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W
    from karpenter_tpu_torch.verify import full_gate
    from karpenter_tpu_torch.verify import device as gdev
    from karpenter_tpu_torch.verify.gate import _build_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 0. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f}s")
    for name in kernels.SOURCES:
        for line in (kernels.BUILD_DIR / f"{name}.log").read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def encode(workload, claim_slots, well_known=FAKE_WELL_KNOWN_LABELS, pod_volumes=None):
        pods, its, tpls, nodes = workload
        topo = Topology(domains_from_instance_types(its, tpls), batch_pods=pods, cluster_pods=[])
        for n in nodes:
            topo.register("kubernetes.io/hostname", n.name)
        enc = (Encoder(well_known) if well_known is not None else Encoder()).encode(
            pods, its, tpls, nodes, topology=topo, num_claim_slots=claim_slots,
            pod_volumes=pod_volumes,
        )
        return pad_problem(enc.problem)

    def compare_state(tag, state_k, state_p):
        """Integer and bool leaves exact, float leaves within rtol 1e-5;
        returns the largest float difference."""
        sk, sp = numpy_fields(state_k), numpy_fields(state_p)
        max_err = 0.0
        for name in sp:
            a, b = sk[name], sp[name]
            if a.dtype.kind == "f":
                if not np.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, equal_nan=True):
                    raise AssertionError(f"{tag}: float state {name} differs")
                finite = np.isfinite(a) & np.isfinite(b)
                if finite.any():
                    max_err = max(max_err, float(np.abs(a[finite] - b[finite]).max()))
            elif not np.array_equal(a, b):
                raise AssertionError(f"{tag}: state {name} differs")
        return max_err

    def compare_results(tag, rk, rp, check_iters=True):
        kk, kp = rk.kind.cpu().numpy(), rp.kind.cpu().numpy()
        ik, ip = rk.index.cpu().numpy(), rp.index.cpu().numpy()
        if not (np.array_equal(kk, kp) and np.array_equal(ik, ip)):
            bad = np.flatnonzero((kk != kp) | (ik != ip))
            raise AssertionError(f"{tag}: kind/index differ at rows {bad[:10].tolist()}")
        max_err = compare_state(tag, rk.state, rp.state)
        if check_iters:
            if tuple(int(x) for x in rk.iters) != tuple(int(x) for x in rp.iters):
                raise AssertionError(f"{tag}: iters differ {rk.iters} vs {rp.iters}")
        return max_err

    def iters_of(result):
        return dict(zip(("narrow", "sweeps", "chain_commits", "chain_pods"), (int(x) for x in result.iters)))

    def compare_relax(tag, rk, rp):
        for key in ("kind", "index", "residue_active"):
            if not torch.equal(getattr(rk, key).cpu(), getattr(rp, key).cpu()):
                raise AssertionError(f"{tag}: relax_place {key} differs")
        sk, sp = [int(x) for x in rk.stats], [int(x) for x in rp.stats]
        if sk != sp:
            raise AssertionError(f"{tag}: relax_place stats {sk} != plain {sp}")
        return compare_state(f"{tag} relax_place", rk.state, rp.state)

    # -- 1. kernel vs plain -------------------------------------------------
    t_phase = time.perf_counter()
    log("phase 1: kernels vs plain PyTorch on the card")
    corpora = [
        ("chain-2000", W.chain_workload(2000), 128),
        ("chain-2003", W.chain_workload(2003), 128),
        # chain commits through every branch (waterfill, round, spread
        # mini-scan), and the most spread commits
        ("chain-3000", W.chain_workload(3000), 128),
        ("chain-3003", W.chain_workload(3003), 128),
        # no kernel shape limit: K = 64 keys; V = 2,560 lanes (W = 80 words)
        ("wide-keys", W.wide_keys_workload(), 32),
        ("wide-lanes", W.wide_lanes_workload(), 32),
        ("chain-2001-overflow", W.chain_workload(2001), 8),
        ("fuzz-1", W.fuzz_workload(1), 32),
        ("fuzz-5", W.fuzz_workload(5), 32),
        ("fuzz-6", W.fuzz_workload(6), 32),
        ("bounds-0", W.bounds_workload(0), 32),
        ("topology-0", W.topology_workload(0), 64),
        ("topology-3", W.topology_workload(3), 32),
        ("topology-4", W.topology_workload(4), 32),
        ("diverse-300", W.diverse_workload(300, 40, seed=7), 32),
        # 256 claim slots mint 256 hostname lanes: V=256, 8 lane words
        ("diverse-300-wide", W.diverse_workload(300, 40, seed=7), 256),
        # phase 1: its groups overflow 8 claim slots; its rounding ladder
        # demotes pods; Gt/Lt bounds and existing nodes with eligible pods
        ("diverse-300-overflow", W.diverse_workload(300, 40, seed=7), 8),
        ("homogeneous-48", W.homogeneous_workload(48), 32),
        ("bounds-0-free", W.bounds_workload(0, with_nodes=False), 32),
        ("relax-fuzz-6", W.relax_fuzz_workload(6), 32),
    ]
    vol_wl, vol_sets = W.volume_workload(0)
    corpora = [(tag, wl, slots, None) for tag, wl, slots in corpora]
    corpora.append(("volumes-0", vol_wl, 32, vol_sets))
    ffd_err = relax_err = 0.0
    attr_err = 0
    saw = {"nodes": False, "bounded": False, "noslot": False, "ports": False, "volumes": False,
           "phase1-bounded": False, "phase1-nodes": False, "ladder-demotes": False, "slot-overflow": False,
           "chain-commits": False, "keys>32": False, "lanes>2048": False}
    families = 0  # gate families the attribute kernel saw fail, over all corpora
    for tag, wl, slots, vols in corpora:
        host = encode(wl, slots, pod_volumes=vols)
        prob = problem_to_torch(host, dev)
        bf = problem_bounds_free(prob)
        saw["nodes"] |= prob.num_nodes > 0
        saw["bounded"] |= not bf
        saw["ports"] |= bool(host.pod_ports.any())
        saw["volumes"] |= bool(host.pod_vol_counts.any())
        rk = solve_ffd_sweeps(prob, slots)
        rp = sweeps_plain(prob, initial_state(prob, slots), bf)
        torch.cuda.synchronize()
        ffd_err = max(ffd_err, compare_results(f"{tag} sweeps", rk, rp))
        saw["noslot"] |= bool((rk.kind == 4).any())
        saw["chain-commits"] |= int(rk.iters.chain_commits) > 0
        saw["keys>32"] |= prob.num_keys > 32
        saw["lanes>2048"] |= prob.num_lanes > 2048
        # the explain pass over every active row against the final state
        rows = torch.nonzero(prob.pod_active).reshape(-1)
        aprob, astate = _lane_align(prob, rk.state)
        wk_, _ = launch_attribute(aprob, astate, rows)
        wp_ = attribute_plain(prob, rk.state, rows)
        torch.cuda.synchronize()
        if not torch.equal(wk_.cpu(), wp_.cpu()):
            raise AssertionError(f"{tag}: attribute words differ from plain")
        if rows.numel():
            attr_err = max(attr_err, int((wk_.cpu().long() - wp_.cpu().long()).abs().max()))
        for word in wk_[:, 0].cpu().tolist():
            families |= (word | word >> 8 | word >> 16) & 0x7F
        if tag in ("wide-keys", "wide-lanes"):
            # runs_screen at the same shapes: two stacked lanes, 1 and 3 passes
            batch = mesh.stack_problems([prob, prob])
            for passes in (1, 3):
                sk = mesh.batched_screen(batch, slots, passes)
                sp = mesh.batched_screen_plain(batch, slots, passes)
                torch.cuda.synchronize()
                if not (torch.equal(sk.kind.cpu(), sp.kind.cpu()) and torch.equal(sk.index.cpu(), sp.index.cpu())):
                    raise AssertionError(f"{tag}: runs_screen kind/index differ from plain ({passes} passes)")
                compare_state(f"{tag} runs_screen {passes} passes", sk.state, sp.state)
        # one-pass mode, twice: fresh, then carrying the first pass's state
        ok1 = solve_ffd(prob, slots)
        op1 = solve_ffd_plain(prob, initial_state(prob, slots), bf)
        ffd_err = max(ffd_err, compare_results(f"{tag} one-pass", ok1, op1, check_iters=False))
        ok2 = solve_ffd(prob, slots, init=op1.state)
        op2 = solve_ffd_plain(prob, op1.state, bf)
        ffd_err = max(ffd_err, compare_results(f"{tag} one-pass carried", ok2, op2, check_iters=False))
        # phase 1, then the repair pass carrying it
        xk = RX.relax_place(prob, slots)
        xp = RX.relax_place_plain(prob, slots)
        relax_err = max(relax_err, compare_relax(tag, xk, xp))
        eligible, placed, demoted, claims = (int(x) for x in xp.stats)
        if placed > 0:
            res = dataclasses.replace(prob, pod_active=xp.residue_active)
            ck = solve_ffd_sweeps_carried(res, slots, init=(xp.state, xp.kind, xp.index))
            ares, astate = _lane_align(res, xp.state)
            cp = sweeps_plain(ares, astate, problem_bounds_free(ares), xp.kind, xp.index)
            ffd_err = max(ffd_err, compare_results(f"{tag} carried", ck, cp))
            saw["phase1-bounded"] |= not bf
            saw["phase1-nodes"] |= prob.num_nodes > 0
        saw["ladder-demotes"] |= demoted > 0 and claims < slots
        saw["slot-overflow"] |= demoted > 0 and claims == slots
        log(f"  {tag}: pods={len(wl[0])} P={prob.num_pods} C={slots} N={prob.num_nodes} "
            f"K={prob.num_keys} V={prob.num_lanes} G={prob.num_groups} "
            f"bounds_free={bf} iters={tuple(int(x) for x in rk.iters)} "
            f"kinds={np.bincount(rk.kind.cpu().numpy(), minlength=5).tolist()} "
            f"phase1 eligible/placed/demoted/claims={eligible}/{placed}/{demoted}/{claims} ok")
    missing = [k for k, v in saw.items() if not v]
    if missing:
        raise AssertionError(f"phase 1 corpora do not cover: {missing}")
    if families != 0x7F:
        raise AssertionError(f"attribute: the corpora make only families {families:#x} of 0x7f fail")
    log("  attribute == plain on every corpus; every gate family failed somewhere")

    # whole solves: the kernel path against the plain CPU path, with the
    # two-phase solve on (the default) and off
    gate_cases = []
    for tag, wl, vols in (("fuzz-1", W.fuzz_workload(1), None),
                          ("topology-0", W.topology_workload(0), None),
                          ("bounds-0", W.bounds_workload(0), None),
                          ("chain-2000", W.chain_workload(2000), None),
                          ("homogeneous-48", W.homogeneous_workload(48), None),
                          ("diverse-300", W.diverse_workload(300, 40, seed=7), None),
                          ("volumes-0", vol_wl, vol_sets)):
        pods, its, tpls, nodes = wl
        for relax in (True, False):
            sg = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=dev, relax=relax)
            rg = sg.solve(pods, its, tpls, nodes, pod_volumes=vols)
            sc = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=relax)
            rc = sc.solve(pods, its, tpls, nodes, pod_volumes=vols)
            if (rg.new_claims, rg.node_pods, rg.failures) != (rc.new_claims, rc.node_pods, rc.failures):
                raise AssertionError(f"{tag} relax={relax}: TorchSolver on cuda differs from the plain CPU path")
            if (sg.last_relax, sg.relax_fallbacks) != (sc.last_relax, sc.relax_fallbacks):
                raise AssertionError(f"{tag} relax={relax}: phase 1 {sg.last_relax} != plain {sc.last_relax}")
            if rg.verify_ctx is not None and not relax:
                gate_cases.append((tag, wl, rg))
            log(f"  solve {tag} relax={relax}: cuda == cpu ({rg.num_scheduled()}/{len(pods)} scheduled, "
                f"phase 1 {sg.last_relax})")

    # gate: clean and corrupted results, kernel counts == plain counts
    def corruptions(gp, ga):
        """(name, gp, ga) variants that each trip one invariant (others may
        trip too); a variant whose precondition the result lacks is left out."""
        C = ga.claim_tpl.shape[0]
        pod_bin = ga.pod_bin.cpu().numpy()
        placed = np.flatnonzero(pod_bin >= 0)
        on_claims = pod_bin[(pod_bin >= 0) & (pod_bin < C)]
        c0 = int(np.bincount(on_claims).argmax())  # the fullest claim
        on_c0 = np.flatnonzero(pod_bin == c0)
        p0 = int(on_c0[0])
        out = []
        rep = ga.claim_reported.clone()
        rep[c0, 0] += 1.0
        out.append(("claim-requests", gp, ga._replace(claim_reported=rep)))
        out.append(("claim-capacity", gp._replace(it_alloc=torch.full_like(gp.it_alloc, -1.0)), ga))
        out.append(("instance-type-survivor", gp, ga._replace(claim_its=torch.ones_like(ga.claim_its))))
        tol = gp.pod_tol_tpl.clone()
        tol[placed] = False
        tn = gp.pod_tol_node.clone()
        tn[placed] = False
        out.append(("taint-admissibility", gp._replace(pod_tol_tpl=tol, pod_tol_node=tn), ga))
        if len(on_c0) >= 2:
            ports, conf = gp.pod_ports.clone(), gp.pod_port_conflict.clone()
            ports[on_c0[0], 0] = True
            conf[on_c0[1], 0] = True
            out.append(("host-port", gp._replace(pod_ports=ports, pod_port_conflict=conf), ga))
        # requirement-intersection: the claim publishes an empty zone set
        # while its first pod requires a zone
        zone = 0
        cr, pr = ga.claim_req, gp.pod_reqs
        cadm, ccomp, cdef = cr.admitted.clone(), cr.comp.clone(), cr.defined.clone()
        cadm[c0, zone] = False
        ccomp[c0, zone] = False
        cdef[c0, zone] = True
        padm, pcomp, pdef = pr.admitted.clone(), pr.comp.clone(), pr.defined.clone()
        padm[p0, zone] = gp.lane_valid[zone]
        pcomp[p0, zone] = False
        pdef[p0, zone] = True
        chk = ga.pod_check.clone()
        chk[p0] = True
        out.append(("requirement-intersection",
                    gp._replace(pod_reqs=type(pr)(padm, pcomp, pr.gt, pr.lt, pdef)),
                    ga._replace(claim_req=type(cr)(cadm, ccomp, cr.gt, cr.lt, cdef), pod_check=chk)))
        if (pod_bin >= C).any():
            out.append(("node-capacity", gp._replace(node_avail=torch.zeros_like(gp.node_avail)), ga))
        return out

    tripped = set()
    gate_err = 0
    for tag, (pods, its, tpls, nodes), result in gate_cases:
        gp, ga, bf = _build_args(result.verify_ctx, result, pods, None)
        cases = [("clean", gp, ga)] + corruptions(gp, ga)
        for name, g1, a1 in cases:
            ck = gdev.launch_gate_counts(g1, a1).cpu().numpy()
            cp = gdev.gate_counts_plain(g1, a1, bf).cpu().numpy()
            gate_err = max(gate_err, int(np.abs(ck.astype(np.int64) - cp).max()))
            if not np.array_equal(ck, cp):
                raise AssertionError(f"gate {tag}/{name}: kernel {ck.tolist()} != plain {cp.tolist()}")
            if name == "clean" and ck.any():
                raise AssertionError(f"gate {tag}: clean result counted {ck.tolist()}")
            if name != "clean" and not ck[gdev.INVARIANTS.index(name)]:
                raise AssertionError(f"gate {tag}/{name}: corruption did not trip its invariant")
            tripped.add(name)
        log(f"  gate {tag}: {len(cases)} cases (clean + {len(cases) - 1} corrupted) kernel == plain")
    if tripped != {"clean", *gdev.INVARIANTS}:
        raise AssertionError(f"gate corruptions cover only {sorted(tripped)}")

    log(f"  phase 1 wall {time.perf_counter() - t_phase:.1f}s")

    # -- 2. the main path at full width --------------------------------------
    t_phase = time.perf_counter()
    log(f"phase 2: main path, {MAIN_PODS} diverse pods x 400 instance types, 1 NodePool")
    pods, its, tpls, nodes = W.diverse_workload(MAIN_PODS, 400, seed=42)

    def drive(relax):
        """One solve through the entry point a user calls, with the launch
        counts set to 0 just before it and read just after; then the smoke's
        own ``full_gate`` of the result, outside that window."""
        solver = TorchSolver(initial_claim_slots=128, device=dev, relax=relax)
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = solver.solve(pods, its, tpls, nodes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        outcome = full_gate(result, pods, its, tpls, nodes)
        torch.cuda.synchronize()
        if outcome is None or outcome.violations or outcome.counts or outcome.mode != "device":
            raise AssertionError(f"main path relax={relax}: gate rejected or could not run: {outcome}")
        if result.num_scheduled() + len(result.failures) != len(pods):
            raise AssertionError(f"main path relax={relax}: pod accounting broken")
        tm = solver.last_timing
        ctx = result.verify_ctx
        log(f"  relax={relax}: scheduled {result.num_scheduled()}/{len(pods)} claims={len(result.new_claims)} "
            f"escalations={solver.claim_escalations} phase1={solver.last_relax} fallbacks={solver.relax_fallbacks} "
            f"iters={tuple(solver.last_iters)} "
            f"P={ctx.device_problem.num_pods} C={ctx.max_claims} launches={launches}")
        log(f"  relax={relax}: solve wall {wall * 1e3:.1f} ms = encode {tm['encode'] * 1e3:.1f} + relax "
            f"{tm['relax'] * 1e3:.1f} + device {tm['device'] * 1e3:.1f} + decode {tm['decode'] * 1e3:.1f} "
            f"+ gate {tm.get('gate', 0.0) * 1e3:.1f} (+ escalation retries); "
            f"gate: mode={outcome.mode} audited={outcome.audited}")
        return solver, result, launches

    solver, result, launches = drive(True)
    for name in SOLVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    if solver.relax_fallbacks != 0 or solver.last_relax is None or solver.last_relax["placed"] <= 0:
        raise AssertionError(f"main path: phase 1 did not place or was rejected: {solver.last_relax}, "
                             f"fallbacks {solver.relax_fallbacks}")
    sched = result.num_scheduled()
    solver_off, result_off, launches_off = drive(False)
    # the same two solves again, to separate first-solve costs from the path's
    for relax in (True, False):
        drive(relax)
    # the relax=False solve runs no phase 1 and gates nothing itself
    if launches_off != {"attribute": 0, "ffd_loop": launches_off["ffd_loop"], "gate_counts": 0, "patch_world": 0,
                        "relax_place": 0, "runs_screen": 0} \
            or launches_off["ffd_loop"] <= 0 or launches["runs_screen"] != 0 or launches["attribute"] != 0:
        raise AssertionError(f"relax=False path launched {launches_off}")
    if sched != len(pods) or sched < result_off.num_scheduled():
        raise AssertionError(f"main path scheduled {sched}, relax=False {result_off.num_scheduled()} of {len(pods)}")
    ctx = result.verify_ctx
    C = ctx.max_claims
    # the phase-1 input: the solve's padded problem (its context holds the
    # repair pass's residue) with every pod active, as the relax=False solve
    # of the same batch encodes it
    active = result_off.verify_ctx.device_problem.pod_active
    if active.shape != ctx.device_problem.pod_active.shape or int(active.sum()) != len(pods):
        raise AssertionError("main path: the two paths padded the batch differently")
    prob = _pad_lanes_mult32(dataclasses.replace(ctx.device_problem, pod_active=active))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_ms(fn, reps):
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def time_launches(name, arg_sets):
        """The kernel alone: CUDA events around ``kernels.launch`` over
        argument sets built beforehand, one set per launch (the kernels
        update their state in place)."""
        times = []
        for _, args in arg_sets:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kernels.launch(name, args, stream)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def same_verdicts(tag, arg_sets, ref):
        for t, _ in arg_sets:
            if not (torch.equal(t["kind"], ref.kind) and torch.equal(t["index"], ref.index)):
                raise AssertionError(f"{tag}: a timed launch differs from the wrapper's")

    def plain_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # relax_place at the main path's shapes: kernel, plain, their agreement
    rxk = RX.relax_place(prob, C)
    rx_sets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C) for _ in range(10))]
    rx_ms, rx_all = time_launches("relax_place", rx_sets)
    same_verdicts("relax_place", rx_sets, rxk)
    rx_wrap_ms, _ = time_ms(lambda: RX.relax_place(prob, C), 5)
    rx_work = dict(zip(RX.WORK_COUNTERS, rxk.work.cpu().tolist()))
    rxp, rx_plain_ms = plain_ms(lambda: RX.relax_place_plain(prob, C))
    relax_err = max(relax_err, compare_relax("main path", rxk, rxp))
    stats = dict(zip(("eligible", "placed", "demoted", "claims"), (int(x) for x in rxk.stats)))
    if stats != solver.last_relax:
        raise AssertionError(f"main path: phase 1 {stats} != the solve's {solver.last_relax}")
    log(f"  relax_place: kernel {rx_ms:.4f} ms median of {[round(t, 4) for t in rx_all]}; wrapper {rx_wrap_ms:.4f} ms; "
        f"plain {rx_plain_ms:.1f} ms; kernel == plain; {stats}; work {rx_work}")

    # ffd_loop in each mode at the main path's shapes, each against its
    # plain loop on the same inputs: the carried repair pass (the main
    # path), the fresh loop (the relax=False path) and one one-pass scan
    residue, astate = _lane_align(dataclasses.replace(prob, pod_active=rxk.residue_active), rxk.state)
    rc_main = solve_ffd_sweeps_carried(residue, C, (rxk.state, rxk.kind, rxk.index))
    k1_sets = [ffd_loop_args(residue, astate, False, rxk.kind, rxk.index) for _ in range(3)]
    k1_ms, k1_all = time_launches("ffd_loop", k1_sets)
    same_verdicts("ffd_loop carried", k1_sets, rc_main)
    k1_wrap_ms, _ = time_ms(lambda: solve_ffd_sweeps_carried(residue, C, (rxk.state, rxk.kind, rxk.index)), 2)
    work = dict(zip(WORK_COUNTERS, rc_main.work.cpu().tolist()))
    rc_plain, k1_plain_ms = plain_ms(lambda: sweeps_plain(residue, astate, problem_bounds_free(residue),
                                                          rxk.kind, rxk.index))
    ffd_err = max(ffd_err, compare_results("main path carried", rc_main, rc_plain))
    log(f"  ffd_loop carried: kernel {k1_ms:.3f} ms median of {[round(t, 3) for t in k1_all]}, wrapper "
        f"{k1_wrap_ms:.3f} ms, plain {k1_plain_ms:.1f} ms, kernel == plain; IterCounts {iters_of(rc_main)} "
        f"(narrow, sweeps, chain commits, chain pods), work {work}")

    bf = problem_bounds_free(prob)
    rf_main = solve_ffd_sweeps(prob, C)
    fresh_sets = [ffd_loop_args(prob, initial_state(prob, C), False) for _ in range(3)]
    fresh_ms, fresh_all = time_launches("ffd_loop", fresh_sets)
    same_verdicts("ffd_loop fresh", fresh_sets, rf_main)
    work_fresh = dict(zip(WORK_COUNTERS, rf_main.work.cpu().tolist()))
    rf_plain, fresh_plain_ms = plain_ms(lambda: sweeps_plain(prob, initial_state(prob, C), bf))
    ffd_err = max(ffd_err, compare_results("main path fresh", rf_main, rf_plain))
    log(f"  ffd_loop fresh: kernel {fresh_ms:.3f} ms median of {[round(t, 3) for t in fresh_all]}, "
        f"plain {fresh_plain_ms:.1f} ms, kernel == plain; IterCounts {iters_of(rf_main)}, work {work_fresh}")

    # the one-pass scan (a relax rung's, off the 10k path) at the main path's
    # shapes over its first ONE_PASS_PODS rows, the largest pods: its plain
    # version steps one pod at a time in Python
    op_prob = dataclasses.replace(prob, pod_active=prob.pod_active & (
        torch.arange(prob.pod_active.shape[0], device=dev) < ONE_PASS_PODS))
    ro_main = solve_ffd(op_prob, C)
    op_sets = [ffd_loop_args(op_prob, initial_state(op_prob, C), True) for _ in range(2)]
    op_ms, op_all = time_launches("ffd_loop", op_sets)
    same_verdicts("ffd_loop one-pass", op_sets, ro_main)
    work_one_pass = dict(zip(WORK_COUNTERS, ro_main.work.cpu().tolist()))
    ro_plain, op_plain_ms = plain_ms(lambda: solve_ffd_plain(op_prob, initial_state(op_prob, C), bf))
    ffd_err = max(ffd_err, compare_results("main path one-pass", ro_main, ro_plain, check_iters=False))
    log(f"  ffd_loop one-pass over the first {ONE_PASS_PODS} rows: kernel {op_ms:.3f} ms median of "
        f"{[round(t, 3) for t in op_all]}, plain {op_plain_ms:.1f} ms, kernel == plain; work {work_one_pass}")

    gp, ga, gbf = _build_args(ctx, result, pods, None)
    ck = gdev.launch_gate_counts(gp, ga).cpu().numpy()
    k2_sets = [gdev.gate_counts_args(gp, ga) for _ in range(10)]
    k2_ms, _ = time_launches("gate_counts", k2_sets)
    k2_wrap_ms, _ = time_ms(lambda: gdev.launch_gate_counts(gp, ga), 5)
    k2_plain_ms, _ = time_ms(lambda: gdev.gate_counts_plain(gp, ga, gbf), 3)
    cp = gdev.gate_counts_plain(gp, ga, gbf).cpu().numpy()
    gate_err = max(gate_err, int(np.abs(ck.astype(np.int64) - cp).max()))
    if not np.array_equal(ck, cp) or any(not torch.equal(t["counts"].cpu(), torch.from_numpy(ck)) for t, _ in k2_sets):
        raise AssertionError("main path gate: kernel != plain")
    log(f"  gate_counts: kernel {k2_ms:.4f} ms, wrapper {k2_wrap_ms:.4f} ms (plain {k2_plain_ms:.3f} ms)")

    # bounds: the bytes a launch must move (each of the kernel's inputs read
    # once, each output written once, the state it updates in place read and
    # written, its scratch not counted), and the operations this run's data
    # needs
    def io_bytes(t, state=(), scratch=()):
        total = 0
        for name, x in t.items():
            if x is not None and name not in scratch:
                total += x.numel() * x.element_size() * (2 if name in state else 1)
        return total

    def bound(nbytes_io, int_ops, flt_ops):
        bytes_s = nbytes_io / PEAK_BYTES_S
        ops_s = max(int_ops / PEAK_INT32_OPS_S, flt_ops / PEAK_FP32_OPS_S)
        return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"

    # ffd_loop's operations, from the work counters of a launch (the same
    # work as every timed launch of that mode): per bin gate the merge and
    # the intersect test over K x W packed words; per topology lane of a
    # matched group a compare and a select; per instance-type test the compat
    # words, the offerings and, in float32, an add and a compare per resource
    K, V, T, R = prob.num_keys, prob.num_lanes, prob.num_instance_types, prob.num_resources
    O, Wd, PT = prob.offer_ok.shape[1], prob.num_lanes // 32, prob.pod_ports.shape[1]
    P, N, G, TPL = prob.num_pods, prob.num_nodes, prob.num_groups, prob.num_templates
    D = prob.pod_vol_counts.shape[1]

    def ffd_bound(w, t):
        nbytes_io = io_bytes(t, FFD_STATE, FFD_SCRATCH)
        int_ops = w["bin_gates"] * 2 * K * Wd + w["topo_lanes"] * 2 + w["type_tests"] * (K * Wd + O)
        flt_ops = w["type_tests"] * 2 * R
        return (*bound(nbytes_io, int_ops, flt_ops), nbytes_io, int_ops, flt_ops)

    k1_bound, k1_by, k1_bytes, k1_int_ops, k1_flt_ops = ffd_bound(work, k1_sets[0][0])
    fresh_bound, fresh_by, _, _, _ = ffd_bound(work_fresh, fresh_sets[0][0])
    op_bound, op_by, _, _, _ = ffd_bound(work_one_pass, op_sets[0][0])
    # the latency floor of the one-block design: its barriers, each at the
    # cost of a barrier alone in a block of the loop's size
    probe = kernels.library("ffd_loop").ffd_sync_probe_launch
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    n_sync = 100000

    def run_probe(n):
        if probe(n, ctypes.c_void_p(stream)) != 0:
            raise RuntimeError("sync probe: CUDA launch error")

    run_probe(n_sync)
    sync_ms = (time_ms(lambda: run_probe(n_sync), 5)[0] - time_ms(lambda: run_probe(0), 5)[0]) / n_sync
    k1_latency = work["barriers"] * sync_ms
    log(f"  ffd_loop carried: bytes {k1_bytes}, int ops {k1_int_ops:.4g}, float ops {k1_flt_ops:.4g}; "
        f"bound {k1_bound:.5f} ms ({k1_by}); one barrier {sync_ms * 1e6:.2f} ns -> latency floor "
        f"{k1_latency:.3f} ms; fresh bound {fresh_bound:.5f} ms ({fresh_by}), one-pass bound {op_bound:.5f} ms ({op_by})")
    # relax_place: operations from its counted instance-type tests (K x W
    # compat words and O offerings in int32, an add and a compare per
    # resource in float32) and record lanes (a test and an add), plus the
    # per-pod screen (ports, groups, node tests, the row compare with the
    # predecessor) and the float32 demand math (max, sum, size: about 6
    # operations per pod and resource)
    rx_bytes = io_bytes(rx_sets[0][0], RX.RELAX_STATE, RX.RELAX_SCRATCH)
    rx_int_ops = (rx_work["type_tests"] * (K * Wd + O) + rx_work["record_lanes"] * 2
                  + P * (2 * PT + 3 * G + 2 + (K * Wd + 4 * K + TPL) + N * (K * Wd + D + 2)))
    rx_flt_ops = rx_work["type_tests"] * 2 * R + P * R * 6 + P * N * 2 * R
    rx_bound, rx_by = bound(rx_bytes, rx_int_ops, rx_flt_ops)
    log(f"  relax_place: bytes {rx_bytes}, int ops {rx_int_ops:.4g}, float ops {rx_flt_ops:.4g}; "
        f"bound {rx_bound:.5f} ms ({rx_by})")
    k2_bytes = io_bytes(k2_sets[0][0], (), gdev.GATE_SCRATCH)
    k2_int_ops = P * (K * (Wd + 3) + 2 * PT) + C * T * (K * Wd + O)
    k2_flt_ops = P * R + C * T * 2 * R
    k2_bound, k2_by = bound(k2_bytes, k2_int_ops, k2_flt_ops)
    log(f"  gate_counts: bytes {k2_bytes}, int ops {k2_int_ops:.4g}, float ops {k2_flt_ops:.4g}; "
        f"bound {k2_bound:.5f} ms ({k2_by})")
    log(f"  phase 2 wall {time.perf_counter() - t_phase:.1f}s")
    rs = consolidation_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound)
    churn_entries, churn = churn_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound)
    stacked = serve_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, (pods, its, tpls, nodes), result)
    attr_entry = explain_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, attr_err)

    line = {
        "kernels": [
            {
                "name": "ffd_loop",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/ffd_loop.cu",
                "replaces": "karpenter_tpu/ops/ffd_sweeps.py:1922",
                "also_replaces": ["karpenter_tpu/ops/ffd_sweeps.py:1910", "karpenter_tpu/ops/ffd_step.py:483"],
                "launches": launches["ffd_loop"],
                "max_abs_err": ffd_err,
                "ms": k1_ms,
                "plain_ms": k1_plain_ms,
                "bound_ms": k1_bound,
                "bound_by": k1_by,
                "library_ms": None,
                "wrapper_ms": k1_wrap_ms,
                "latency_bound_ms": k1_latency,
                "work": work,
                "fresh_ms": fresh_ms,
                "fresh_plain_ms": fresh_plain_ms,
                "fresh_bound_ms": fresh_bound,
                "fresh_work": work_fresh,
                "one_pass_pods": ONE_PASS_PODS,
                "one_pass_ms": op_ms,
                "one_pass_plain_ms": op_plain_ms,
                "one_pass_bound_ms": op_bound,
                "one_pass_work": work_one_pass,
                "launches_relax_off": launches_off["ffd_loop"],
                "launches_churn": churn["launches"]["ffd_loop"],
                "iters": iters_of(rc_main),
                "fresh_iters": iters_of(rf_main),
            },
            attr_entry,
            {
                "name": "gate_counts",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/gate_counts.cu",
                "replaces": "karpenter_tpu/verify/device.py:259",
                "launches": launches["gate_counts"],
                "max_abs_err": gate_err,
                "ms": k2_ms,
                "plain_ms": k2_plain_ms,
                "bound_ms": k2_bound,
                "bound_by": k2_by,
                "library_ms": None,
                "wrapper_ms": k2_wrap_ms,
                "launches_relax_off": launches_off["gate_counts"],
            },
            {
                "name": "relax_place",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/relax_place.cu",
                "replaces": "karpenter_tpu/ops/relax.py:162",
                "launches": launches["relax_place"],
                "max_abs_err": relax_err,
                "ms": rx_ms,
                "plain_ms": rx_plain_ms,
                "bound_ms": rx_bound,
                "bound_by": rx_by,
                "library_ms": None,
                "wrapper_ms": rx_wrap_ms,
                "work": rx_work,
                "stats": stats,
                "launches_relax_off": launches_off["relax_place"],
            },
            rs,
            *churn_entries,
            stacked,
        ],
        "churn": churn,
    }
    log(f"smoke wall {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def explain_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, attr_err):
    """Phase 6: the explain pass at full width, on phase 2's batch (10,000
    diverse pods, 400 types) twice: under a NodePool cpu limit that leaves a
    large share unscheduled (claim-capacity), and without the limit but with
    tests/test_explain.py's engineered pods added (resources,
    requirements). Each is solved with ``KARPENTER_TPU_EXPLAIN`` off and on:
    the placements must be the same, the solve with the flag on must launch
    ``attribute`` once (none off), its words must equal ``attribute_plain``'s
    on the same rows and state, and the report's reasons the plain words'
    decode. Returns the ``attribute`` entry of the kernels line, timed on the
    limited batch's rows."""
    import copy
    import os

    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.obs import explain as obs_explain
    from karpenter_tpu_torch.ops import ffd_step
    from karpenter_tpu_torch.ops.ffd_core import _lane_align
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    pods, its, tpls, nodes = W.diverse_workload(MAIN_PODS, 400, seed=42)
    limited = copy.copy(tpls[0])
    limited.remaining_resources = {"cpu": EXPLAIN_CPU_LIMIT}

    def pod(name, cpu=0.5, node_selector=None):
        return Pod(metadata=ObjectMeta(name=name), spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": 1e8})], node_selector=node_selector or {}))

    engineered = pods + [pod("huge", cpu=10_000.0), pod("moon", node_selector={wk.LABEL_TOPOLOGY_ZONE: "no-such-zone"})]
    scenarios = (
        ("limit", pods, limited, lambda rep, n: rep.counts().get(obs_explain.REASON_CLAIM_CAPACITY, 0) >= n // 10),
        ("engineered", engineered, tpls[0], lambda rep, n: {i: e.reason for i, e in rep.pods.items()} == {
            n - 2: obs_explain.REASON_RESOURCES, n - 1: obs_explain.REASON_REQUIREMENTS}),
    )

    def solve(batch, tpl):
        solver = TorchSolver(initial_claim_slots=128, device=dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = solver.solve(batch, its, [tpl], nodes)
        torch.cuda.synchronize()
        return result, dict(kernels.LAUNCHES), (time.perf_counter() - t0) * 1e3

    seen = []
    real = ffd_step.attribute_pods

    def recording(problem, state, rows):
        words = real(problem, state, rows)
        seen.append((problem, state, list(rows), words))
        return words

    prev = os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
    obs_explain.set_enabled(None)
    timed = None
    try:
        for name, batch, tpl, expected in scenarios:
            os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
            off, off_launches, off_ms = solve(batch, tpl)
            os.environ["KARPENTER_TPU_EXPLAIN"] = "1"
            ffd_step.attribute_pods = recording
            seen.clear()
            on, on_launches, on_ms = solve(batch, tpl)
            ffd_step.attribute_pods = real
            if off.explain is not None or off_launches["attribute"] != 0:
                raise AssertionError(f"explain {name} off: a report or an attribute launch ({off_launches})")
            if (on.new_claims, on.node_pods, on.failures) != (off.new_claims, off.node_pods, off.failures):
                raise AssertionError(f"explain {name}: placements differ from the flag-off solve")
            if on_launches["attribute"] != 1 or len(seen) != 1:
                raise AssertionError(f"explain {name}: attribute launched {on_launches['attribute']} times, not once")
            rep = on.explain
            if rep is None or rep.pods.keys() != on.failures.keys() or not expected(rep, len(batch)):
                raise AssertionError(f"explain {name}: {len(on.failures)} failures, reasons "
                                     f"{None if rep is None else rep.counts()}")
            problem, state, rows, words = seen[0]
            wp, p_ms = plain_ms(lambda: ffd_step.attribute_plain(problem, state, rows))
            if not torch.equal(words.cpu(), wp.cpu()):
                raise AssertionError(f"explain {name}: attribute words differ from plain on the solve's rows")
            attr_err = max(attr_err, int((words.cpu().long() - wp.cpu().long()).abs().max()))
            plain_reasons = {
                orig: obs_explain.decode_pod(orig, obs_explain.KIND_NAMES.index(e.kind), wp[i].tolist()).reason
                for i, (orig, e) in enumerate(rep.pods.items())
            }
            if plain_reasons != {orig: e.reason for orig, e in rep.pods.items()}:
                raise AssertionError(f"explain {name}: the report's reasons differ from the plain words' decode")
            log(f"  {name}: scheduled {on.num_scheduled()}/{len(batch)}, {len(on.failures)} explained; reasons "
                f"{rep.counts()}; placements == flag off; attribute launches on/off "
                f"{on_launches['attribute']}/{off_launches['attribute']}; words == plain ({p_ms:.1f} ms plain); "
                f"solve {off_ms:.1f} ms off, {on_ms:.1f} ms on; explain overhead {rep.overhead_s * 1e3:.2f} ms")
            if timed is None:
                timed = (problem, state, rows, words, p_ms, rep, on_launches["attribute"])
    finally:
        ffd_step.attribute_pods = real
        os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
        if prev is not None:
            os.environ["KARPENTER_TPU_EXPLAIN"] = prev

    # the kernel alone, through its wrapper, and plain, on the limited
    # batch's rows
    problem, state, rows, words, p_ms, rep, n_launch = timed
    aprob, astate = _lane_align(problem, state)
    sets = [ffd_step.attribute_args(aprob, astate, rows) for _ in range(5)]
    k_ms, k_all = time_launches("attribute", sets)
    for t, _ in sets:
        if not torch.equal(t["words"], words):
            raise AssertionError("explain: a timed attribute launch differs from the wrapper's")
    wrap_ms, _ = time_ms(lambda: ffd_step.launch_attribute(aprob, astate, rows), 5)
    work = dict(zip(ffd_step.ATTR_WORK_COUNTERS, sets[0][0]["work"].cpu().tolist()))
    K, V, R = aprob.num_keys, aprob.num_lanes, aprob.num_resources
    Wd, O = V // 32, aprob.offer_ok.shape[1]
    nbytes = io_bytes(sets[0][0], (), ffd_step.ATTR_SCRATCH)
    # per bin gate the merge and intersect over K x W words; per topology
    # lane a compare and a select; per type test the compat words and the
    # offerings in int32, an add and a compare per resource in float32
    int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
    flt_ops = work["type_tests"] * 2 * R
    b_ms, b_by = bound(nbytes, int_ops, flt_ops)
    log(f"  attribute over {len(rows)} rows: kernel {k_ms:.4f} ms median of {[round(t, 4) for t in k_all]}, "
        f"wrapper {wrap_ms:.4f} ms, plain {p_ms:.1f} ms; work {work}; bytes {nbytes}, int ops {int_ops:.4g}, "
        f"float ops {flt_ops:.4g}; bound {b_ms:.5f} ms ({b_by})")
    log(f"  explain phase wall {time.perf_counter() - t_phase:.1f}s")
    return {
        "name": "attribute",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/attribute.cu",
        "replaces": "karpenter_tpu/ops/ffd_step.py:730",
        "launches": n_launch,
        "max_abs_err": attr_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "wrapper_ms": wrap_ms,
        "rows": len(rows),
        "work": work,
        "explain_overhead_ms": rep.overhead_s * 1e3,
        "reasons": rep.counts(),
    }


def consolidation_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound):
    """Phase 3 (see the module docstring). Returns the ``runs_screen`` entry
    of the kernels line."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.disruption import batch
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32, initial_state
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.testing import workloads as W

    t_phase = time.perf_counter()
    log(f"phase 3: consolidation screen, {SCREEN_CANDIDATES} candidates")
    n = SCREEN_CANDIDATES
    subsets = screen_subsets(n)
    B = len(subsets)
    # the checked lanes: every 10th, the last, and the large random subsets
    checked = sorted(set(range(0, B, 10)) | {B - 1} | set(range(B - 20, B)))
    captured = {}
    real_lean, real_res = batch.lean_screen, batch.residual_screen

    def lean(base, variants, C, passes=3):
        captured["full"] = (base, variants, C, passes)
        return real_lean(base, variants, C, passes)

    def res(base, carried, variants, run_idx, C):
        captured["residual"] = (base, carried, variants, run_idx, C)
        return real_res(base, carried, variants, run_idx, C)

    def score(tag, base_pods, delta):
        """One score_subsets call on a fresh scorer, launch counts set to 0
        just before it and read just after; then the same call again on the
        same scorer (its base world cached)."""
        scorer, its, cands = batch.build_bench_scorer(n, base_pods=base_pods, device=dev, delta=delta)
        captured.clear()
        batch.lean_screen, batch.residual_screen = lean, res
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            verdicts = scorer.score_subsets(subsets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            stats = dict(scorer.last_screen_stats)
            kernels.reset_launches()
            t0 = time.perf_counter()
            again = scorer.score_subsets(subsets)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            launches2 = dict(kernels.LAUNCHES)
            stats2 = dict(scorer.last_screen_stats)
        finally:
            batch.lean_screen, batch.residual_screen = real_lean, real_res
        keys = [verdict_key(v) for v in verdicts]
        if keys != [verdict_key(v) for v in again]:
            raise AssertionError(f"{tag}: a repeated score_subsets call changed its verdicts")
        cons = sum(1 for v, sub in zip(verdicts, subsets) if v.consolidatable_with([cands[i] for i in sub], its))
        claims = np.bincount([v.n_new_claims for v in verdicts], minlength=3).tolist()
        sched = sum(v.all_pods_scheduled for v in verdicts)
        prob = scorer.device_problem
        modes = np.bincount(prob.run_mode[prob.run_len > 0].cpu().numpy(), minlength=3).tolist()
        log(f"  {tag}: {B} lanes, mode={stats['mode']} passes={stats.get('passes')} delta_lanes={stats.get('delta_lanes')} "
            f"fallback={stats.get('fallback_lanes')} rnr={stats.get('rnr')} outcomes={stats.get('outcomes')}; "
            f"all scheduled {sched}, consolidatable {cons}, new claims 0/1/2 = {claims}; P={prob.num_pods} "
            f"N={prob.num_nodes} T={prob.num_instance_types} V={prob.num_lanes} K={prob.num_keys} G={prob.num_groups} "
            f"R={prob.num_resources} runs single/analytic/topo={modes} max_run={M.max_run_bucket(prob)}")
        for i, (w, ln, st) in enumerate(((wall, launches, stats), (wall2, launches2, stats2))):
            log(f"  {tag} call {i + 1}: wall {w * 1e3:.1f} ms = shared {st['screen_shared_ms']:.1f} + lanes "
                f"{st['screen_lane_ms']:.1f} ms (+ host decode); {B / w:.1f} candidates/s; launches {ln}")
        return dict(scorer=scorer, keys=keys, stats=stats, cons=cons, claims=claims, sched=sched,
                    launches=launches, launches2=launches2, wall=wall, wall2=wall2, captured=dict(captured))

    a_delta = score("corpus A delta", W.pinned_base_pods(8, cpu=63.5), True)
    a_full = score("corpus A full", W.pinned_base_pods(8, cpu=63.5), False)
    b = score("corpus B", W.pinned_base_pods(8, cpu=63.5) + W.zonal_spread_pods(24), True)

    # the JAX package's contract: the delta path publishes the full screen's verdicts
    bad = [i for i, (x, y) in enumerate(zip(a_delta["keys"], a_full["keys"])) if x != y]
    if bad:
        raise AssertionError(f"corpus A: delta verdicts differ from the full screen's on lanes {bad[:10]}")
    got_a = {"delta_lanes": a_delta["stats"]["delta_lanes"], "fallback_lanes": a_delta["stats"]["fallback_lanes"],
             "rnr": a_delta["stats"]["rnr"], "consolidatable": a_delta["cons"], "new_claims": a_delta["claims"]}
    got_b = {"mode": b["stats"]["mode"], "passes": b["stats"]["passes"], "all_scheduled": b["sched"],
             "consolidatable": b["cons"], "new_claims": b["claims"]}
    if got_a != EXPECT_A or (a_full["cons"], a_full["claims"]) != (EXPECT_A["consolidatable"], EXPECT_A["new_claims"]):
        raise AssertionError(f"corpus A: {got_a} != the JAX package's {EXPECT_A}")
    if got_b != EXPECT_B or b["stats"]["outcomes"] != {"standdown-topology": B}:
        raise AssertionError(f"corpus B: {got_b} != the JAX package's {EXPECT_B}")
    for tag, r, want in (("corpus A delta", a_delta, {"runs_screen": 1, "ffd_loop": 1}),
                         ("corpus A full", a_full, {"runs_screen": 1}),
                         ("corpus B", b, {"runs_screen": 1})):
        want = {k: want.get(k, 0) for k in kernels.LAUNCHES}
        want2 = dict(want, ffd_loop=0)  # the repeat reuses the cached base world
        if r["launches"] != want or r["launches2"] != want2:
            raise AssertionError(f"{tag}: launches {r['launches']} then {r['launches2']}, expected {want} then {want2}")
    log(f"  delta == full on all {B} lanes; counts equal the JAX package's: A {got_a}, B {got_b}")

    # runs_screen against its plain version, per mode, on the checked lanes
    modes = {
        "residual": a_delta["captured"]["residual"],
        "full": a_full["captured"]["full"],
        "full-topology": b["captured"]["full"],
    }
    out = {"max_abs_err": 0.0, "work": {}, "per_mode": {}}
    for mode, cap in modes.items():
        if mode == "residual":
            base, carried, variants, run_idx, C = cap
            base = _pad_lanes_mult32(base)
            p0 = M.trim_runs(base, run_idx)
            kw = dict(max_run=M.max_run_bucket(base), passes=1, with_topo=False)
            make_args = lambda: M.runs_screen_args(p0, carried, variants.node_avail, variants.pod_active, **kw)
            wrap = lambda: M.residual_screen(base, carried, variants, run_idx, C)
            plain = lambda: M.residual_screen_plain(base, carried, variants, run_idx, C, lanes=checked)
        else:
            base, variants, C, passes = cap
            base = _pad_lanes_mult32(base)
            kw = dict(max_run=M.max_run_bucket(base), passes=passes, with_topo=M.has_topo_runs(base),
                      grp_counts0=variants.grp_counts0, grp_registered0=variants.grp_registered0)
            init = initial_state(base, C)
            make_args = lambda: M.runs_screen_args(base, init, variants.node_avail, variants.pod_active, **kw)
            wrap = lambda: M.lean_screen(base, variants, C, passes)
            plain = lambda: M.lean_screen_plain(base, variants, C, passes, lanes=checked)
        if mode == "full-topology" and not (kw["with_topo"] and kw["passes"] == 3):
            raise AssertionError("corpus B did not run the topology commit with three passes")
        rk = wrap()
        torch.cuda.synchronize()
        sets = [make_args() for _ in range(5)]
        k_ms, k_all = time_launches("runs_screen", sets)
        for t, _ in sets:
            if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
                raise AssertionError(f"runs_screen {mode}: a timed launch differs from the wrapper's")
        w_ms, _ = time_ms(wrap, 5)
        rp, p_ms = plain_ms(plain)
        sel = torch.tensor(checked, device=rk.kind.device)
        if not (torch.equal(rk.kind[sel].cpu(), rp.kind.cpu()) and torch.equal(rk.index[sel].cpu(), rp.index.cpu())):
            raise AssertionError(f"runs_screen {mode}: kind/index differ from the plain version")
        sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
        for key in sp:
            a_, b_ = sk[key][checked], sp[key]
            if a_.dtype.kind == "f":
                fin = np.isfinite(a_) & np.isfinite(b_)
                if fin.any():
                    out["max_abs_err"] = max(out["max_abs_err"], float(np.abs(a_[fin] - b_[fin]).max()))
            if not np.array_equal(a_, b_, equal_nan=a_.dtype.kind == "f"):
                raise AssertionError(f"runs_screen {mode}: state {key} differs from the plain version")
        work = dict(zip(M.RS_WORK_COUNTERS, rk.work.sum(dim=0).cpu().tolist()))
        t0 = sets[0][0]
        nbytes = io_bytes(t0, (), M.RS_SCRATCH)
        K, Wd, O, R = base.num_keys, base.num_lanes // 32, base.offer_ok.shape[1], base.num_resources
        int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
        flt_ops = work["type_tests"] * 2 * R
        b_ms, b_by = bound(nbytes, int_ops, flt_ops)
        lanes = variants.pod_active.shape[0]
        out["per_mode"][mode] = dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, plain_lanes=len(checked), lanes=lanes,
                                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes, int_ops=int_ops, flt_ops=flt_ops,
                                     work=work)
        log(f"  runs_screen {mode}: {lanes} lanes, kernel {k_ms:.3f} ms median of {[round(x, 3) for x in k_all]}, "
            f"wrapper {w_ms:.3f} ms, plain {p_ms:.1f} ms on {len(checked)} lanes; kernel == plain on those lanes "
            f"(max float err {out['max_abs_err']}); bytes {nbytes}, int ops {int_ops:.4g}, float ops {flt_ops:.4g}, "
            f"bound {b_ms:.5f} ms ({b_by}); work {work}")
    main = out["per_mode"]["residual"]
    log(f"  phase 3 wall {time.perf_counter() - t_phase:.1f}s")
    return {
        "name": "runs_screen",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/runs_screen.cu",
        "replaces": "karpenter_tpu/parallel/mesh.py:321",
        "also_replaces": ["karpenter_tpu/parallel/mesh.py:232", "karpenter_tpu/ops/ffd_runs.py:519"],
        "launches": a_delta["launches"]["runs_screen"],
        "max_abs_err": out["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "wrapper_ms": main["wrapper_ms"],
        "plain_lanes": main["plain_lanes"],
        "work": main["work"],
        "modes": out["per_mode"],
        "launches_full": a_full["launches"]["runs_screen"],
        "launches_topology": b["launches"]["runs_screen"],
        "candidates_per_s": {"residual": B / a_delta["wall2"], "full": B / a_full["wall2"],
                             "full_topology": B / b["wall2"]},
        "screen_ms": {tag: {"shared": r["stats"]["screen_shared_ms"], "lanes": r["stats"]["screen_lane_ms"],
                            "wall_first": r["wall"] * 1e3, "wall_repeat": r["wall2"] * 1e3}
                      for tag, r in (("residual", a_delta), ("full", a_full), ("full_topology", b))},
    }


def churn_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound):
    """Phase 4 (see the module docstring). Returns the ``patch_world`` and
    fused ``gate_counts`` entries of the kernels line, and the phase's
    record."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.models.problem import problem_to_torch
    from karpenter_tpu_torch.ops import fused
    from karpenter_tpu_torch.ops.ffd_sweeps import state_tensors
    from karpenter_tpu_torch.ops.padding import pad_problem
    from karpenter_tpu_torch.solver.encode import Encoder, template_from_nodepool
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess, default_pod_factory
    from karpenter_tpu_torch.verify import device as gdev

    t_phase = time.perf_counter()
    log(f"phase 4: steady-state churn, {CHURN_PODS} pods, {CHURN_CYCLES} cycles, "
        f"{CHURN_RATE} arrivals + {CHURN_RATE} deletes a cycle")
    its = instance_types(400)
    tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="d")), its, range(len(its)))]
    rng = random.Random(CHURN_SEED)
    proc = ChurnProcess([default_pod_factory(f"dw-{i}", rng) for i in range(CHURN_PODS)],
                        config=ChurnConfig(seed=CHURN_SEED, arrivals_per_cycle=CHURN_RATE,
                                           deletes_per_cycle=CHURN_RATE))
    resident = TorchSolver(relax=False, device_world=True, device=dev, initial_claim_slots=CHURN_SLOTS)
    legacy = TorchSolver(relax=False, device=dev, initial_claim_slots=CHURN_SLOTS)
    dw = resident._device_world
    C = CHURN_SLOTS

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    def placements(result):
        return ([(c.template_index, c.pod_indices, c.instance_type_indices, sorted(c.requests.items()))
                 for c in result.new_claims], sorted(result.node_pods.items()), sorted(result.failures))

    def fused_check(pods, tag):
        """The fused gate's counts against gate_counts_plain over
        gate_args_from_state of the same final state (one more fused solve
        of the resident world, outside the counted window)."""
        pc = torch.from_numpy(dw._pod_check(pods, dw.meta)).to(dev)
        rk, ck = fused.solve_ffd_fused_gate(dw.world, pc, C)
        problem = fused.world_problem(dw.world.t)
        gbf = gdev.gate_bounds_free(gdev.gate_problem(problem))
        ga = gdev.gate_args_from_state(rk.state, rk.kind, rk.index, pc, C)
        cp = gdev.gate_counts_plain(gdev.gate_problem(problem), ga, gbf)
        if not torch.equal(ck.cpu(), cp.cpu()) or ck.any():
            raise AssertionError(f"churn {tag}: fused counts {ck.tolist()} != plain {cp.tolist()} or nonzero")
        errs["gate"] = max(errs["gate"], int((ck.long() - cp.long()).abs().max()))
        return rk, ck, pc, problem, ga, gbf

    records, totals = [], {name: 0 for name in kernels.LAUNCHES}
    errs = {"patch": 0.0, "gate": 0}
    world_checks, fused_checks = 0, 0
    for cyc in range(CHURN_CYCLES):
        if cyc:
            proc.step()
        pods = list(proc.pods)
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = resident.solve(pods, its, tpls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for name, n in launches.items():
            totals[name] += n
        outcome = dw.last_outcome
        expect = "adopt-first-encode" if cyc == 0 else ("patched", "repatched")
        if outcome != expect and outcome not in expect:
            raise AssertionError(f"churn cycle {cyc}: outcome {outcome}, expected {expect}")
        want = {**{name: 0 for name in kernels.LAUNCHES}, "ffd_loop": 1, "gate_counts": 1,
                "patch_world": int(cyc > 0)}
        if launches != want:
            raise AssertionError(f"churn cycle {cyc} ({outcome}): launches {launches}, expected {want}")
        if result.verify_ctx is None or result.verify_ctx.fused_counts != {}:
            raise AssertionError(f"churn cycle {cyc}: fused counts {result.verify_ctx}")
        if cyc:
            # patch_world against its plain version on the same arguments: the
            # swap left the previous rows in the spare buffers
            plain = fused.patch_world_plain(dw.world.spare, dw.last_patch)
            for name, value in plain.items():
                if not torch.equal(bits(dw.world.t[name]), bits(value)):
                    raise AssertionError(f"churn cycle {cyc}: patch_world {name} != plain")
                if value.numel():
                    diff = (dw.world.t[name].double() - value.double()).abs().max()
                    errs["patch"] = max(errs["patch"], float(diff))
        if cyc % 4 == 0 or cyc == CHURN_CYCLES - 1:
            cold = Encoder().encode(pods, its, tpls, num_claim_slots=C)
            ref = fused.world_tensors(problem_to_torch(pad_problem(cold.problem), dev))
            if ref.keys() != dw.world.t.keys() or any(
                    not torch.equal(bits(dw.world.t[k]), bits(ref[k])) for k in ref):
                raise AssertionError(f"churn cycle {cyc}: resident world != cold encode")
            world_checks += 1
        if cyc in (1, CHURN_CYCLES - 1):
            fused_check(pods, f"cycle {cyc}")
            fused_checks += 1
        t0 = time.perf_counter()
        ref_result = legacy.solve(pods, its, tpls)
        torch.cuda.synchronize()
        legacy_wall = time.perf_counter() - t0
        if placements(result) != placements(ref_result):
            raise AssertionError(f"churn cycle {cyc}: placements differ from the legacy arm")
        records.append(dict(cycle=cyc, outcome=outcome, wall_ms=wall * 1e3, legacy_ms=legacy_wall * 1e3,
                            detail=dict(dw.last_cycle), scheduled=result.num_scheduled(),
                            claims=len(result.new_claims), pods=len(pods)))
        log(f"  cycle {cyc:2d} {outcome:18s} wall {wall * 1e3:8.1f} ms (legacy {legacy_wall * 1e3:8.1f}) "
            f"encode {dw.last_cycle['encode_ms']:.1f} patch {dw.last_cycle['patch_ms']:.1f} "
            f"solve {dw.last_cycle['solve_ms']:.1f} decode {dw.last_cycle['decode_ms']:.1f} ms; "
            f"h2d {dw.last_cycle['h2d_bytes']} B; scheduled {result.num_scheduled()}/{len(pods)} "
            f"on {len(result.new_claims)} claims")
    if dw.counters.get("adopt-first-encode") != 1 or dw.cold_solves != 1 or any(
            k.startswith("standdown") for k in dw.counters):
        raise AssertionError(f"churn: outcomes {dw.counters}, cold solves {dw.cold_solves}")
    steady = [r for r in records if r["outcome"] in ("patched", "repatched")]
    walls = sorted(r["wall_ms"] for r in steady)

    def p(vals, q):
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    summary = dict(
        pods=CHURN_PODS, cycles=CHURN_CYCLES, churn_frac=2 * CHURN_RATE / CHURN_PODS, outcomes=dict(dw.counters),
        cold_solves=dw.cold_solves, wall_ms_p50=statistics.median(walls), wall_ms_p99=p(walls, 0.99),
        legacy_ms_p50=statistics.median(r["legacy_ms"] for r in records[1:]),
        split_ms_p50={k: statistics.median(r["detail"][k] for r in steady)
                      for k in ("encode_ms", "patch_ms", "prep_ms", "solve_ms", "decode_ms")},
        h2d_bytes_p50=statistics.median(r["detail"]["h2d_bytes"] for r in steady),
        world_bytes=steady[-1]["detail"]["world_bytes"],
        adopt_h2d_bytes=records[0]["detail"]["h2d_bytes"],
        overlap_frac_mean=statistics.mean(r["detail"]["overlap_frac"] for r in steady),
        world_checks=world_checks, fused_checks=fused_checks,
        claims_last=records[-1]["claims"], scheduled_last=records[-1]["scheduled"],
    )
    log(f"  churn: patched wall p50 {summary['wall_ms_p50']:.1f} ms, p99 {summary['wall_ms_p99']:.1f} ms; "
        f"legacy p50 {summary['legacy_ms_p50']:.1f} ms; split p50 {summary['split_ms_p50']}; "
        f"h2d p50 {summary['h2d_bytes_p50']} B of a {summary['world_bytes']} B world "
        f"(adopt {summary['adopt_h2d_bytes']} B); overlap {summary['overlap_frac_mean']:.3f}; "
        f"outcomes {summary['outcomes']}; world == cold on {world_checks} cycles, fused == plain on {fused_checks}")

    # patch_world alone: the last cycle's launch again (its table reads the
    # previous rows, now in the spare buffers, and rewrites the same world)
    stream = torch.cuda.current_stream(dev).cuda_stream
    up = dw.last_patch
    pw_ms, pw_all = time_launches("patch_world", [(None, up.args)] * 10)
    # through its wrapper: pack, upload and launch, on a copy of the world
    # before the last patch (swapped back after each call)
    w = dw.world
    pre = fused.World(
        t={k: (w.spare[k] if k in fused.PATCH_ROWS else v).clone() for k, v in w.t.items()},
        spare={k: torch.empty_like(v) for k, v in w.spare.items()}, init=w.init, lanes=w.lanes,
        shapes=w.shapes, max_claims=w.max_claims)
    args = fused.build_patch_args(dw.delta._state.problem, dw.delta.last_rows_prev, w.shapes)

    def wrapped_patch():
        fused.patch_world(pre, fused.upload_patch(args, pre))
        for name in fused.PATCH_ROWS:
            pre.t[name], pre.spare[name] = pre.spare[name], pre.t[name]

    pw_wrap_ms, _ = time_ms(wrapped_patch, 10)
    prev_rows = dict(w.spare)
    _, pw_plain_ms = plain_ms(lambda: fused.patch_world_plain(prev_rows, up))
    survivors = int((~up.use_fresh).sum())
    Pb = up.gather_idx.shape[0]
    pw_bytes = Pb * (4 + 1 + 4)
    for name in fused.PATCH_ROWS:
        stk = up.stack[name]
        if stk.numel():
            row = stk.numel() * stk.element_size() // stk.shape[0]
            pw_bytes += survivors * row + stk.numel() * stk.element_size() + Pb * row
    pw_bytes += 2 * sum(x.numel() * x.element_size() for x in up.full.values())
    pw_bound, pw_by = bound(pw_bytes, 0, 0)
    log(f"  patch_world: kernel {pw_ms:.4f} ms median of {[round(x, 4) for x in pw_all]}, wrapper "
        f"{pw_wrap_ms:.4f} ms, plain {pw_plain_ms:.3f} ms; kernel == plain on {len(steady)} cycles; "
        f"{survivors} survivors of {Pb} rows, {up.stack['pod_requests'].shape[0]} stack rows; "
        f"bytes {pw_bytes}, bound {pw_bound:.5f} ms ({pw_by})")

    # the fused gate alone and wrapped, over the last cycle's final state
    rk, ck, pc, problem, ga, gbf = fused_check(list(proc.pods), "timing")
    t = dict(w.t)
    t.update(state_tensors(rk.state, problem.lane_valid, problem.lane_numeric))
    t["kind"], t["index"] = rk.kind, rk.index
    g_sets = [gdev.gate_fused_args(t, pc) for _ in range(10)]
    g_ms, g_all = time_launches("gate_counts", g_sets)
    if any(not torch.equal(gt["counts"].cpu(), ck.cpu()) for gt, _ in g_sets):
        raise AssertionError("churn: a timed fused gate launch differs")
    g_wrap_ms, _ = time_ms(lambda: gdev.launch_gate_counts_fused(t, pc), 5)
    g_plain_ms, _ = time_ms(lambda: gdev.gate_counts_plain(gdev.gate_problem(problem), ga, gbf), 3)
    K, Wd = t["lvw"].shape
    P, R = t["pod_requests"].shape
    T, O, PT = t["it_alloc"].shape[0], t["offer_ok"].shape[1], t["pod_ports"].shape[1]
    g_bytes = io_bytes(g_sets[0][0], (), gdev.GATE_FUSED_SCRATCH)
    g_int = P * (K * (Wd + 3) + 2 * PT) + C * T * (K * Wd + O) + C * K * Wd
    g_flt = P * R + C * T * 2 * R
    g_bound, g_by = bound(g_bytes, g_int, g_flt)
    log(f"  gate_counts fused: kernel {g_ms:.4f} ms median of {[round(x, 4) for x in g_all]}, wrapper "
        f"{g_wrap_ms:.4f} ms, plain {g_plain_ms:.3f} ms; bytes {g_bytes}, int ops {g_int:.4g}, float ops "
        f"{g_flt:.4g}; bound {g_bound:.5f} ms ({g_by})")
    summary["launches"] = totals
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"  churn phase wall {summary['phase_s']:.1f}s")
    return [
        {
            "name": "patch_world",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/patch_world.cu",
            "replaces": "karpenter_tpu/ops/fused.py:211",
            "launches": totals["patch_world"],
            "max_abs_err": errs["patch"],
            "ms": pw_ms,
            "plain_ms": pw_plain_ms,
            "bound_ms": pw_bound,
            "bound_by": pw_by,
            "library_ms": None,
            "wrapper_ms": pw_wrap_ms,
            "bytes": pw_bytes,
            "launches_per_patched_cycle": 1,
        },
        {
            "name": "gate_counts_fused",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/gate_counts.cu",
            "replaces": "karpenter_tpu/ops/fused.py:302",
            "also_replaces": ["karpenter_tpu/ops/fused.py:271"],
            "launches": totals["gate_counts"],
            "max_abs_err": errs["gate"],
            "ms": g_ms,
            "plain_ms": g_plain_ms,
            "bound_ms": g_bound,
            "bound_by": g_by,
            "library_ms": None,
            "wrapper_ms": g_wrap_ms,
            "bytes": g_bytes,
            "launches_per_cycle": 1,
        },
    ], summary


def serve_phase(dev, time_ms, time_launches, plain_ms, io_bytes, bound, main_workload, main_result):
    """Phase 5 (see the module docstring). Returns the stacked
    ``runs_screen`` entry of the kernels line."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import kernels, serve
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.serve import batch as xbatch
    from karpenter_tpu_torch.serve.dispatcher import Ticket, _Request
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.oracle import OracleSolver
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    t_phase = time.perf_counter()

    def catalog(n):
        its = instance_types(n)
        return its, [template_from_nodepool(NodePool(metadata=ObjectMeta(name="serve")), its, range(len(its)))]

    def placements(result):
        return ([(c.template_index, c.pod_indices, c.instance_type_indices, sorted(c.requests.items()))
                 for c in result.new_claims], sorted(result.node_pods.items()), sorted(result.failures))

    # -- 5a. the stacked kernel through serve.batch.stacked_solve, at two shapes
    shapes = {}
    max_err = 0.0
    for tag, n_pods, n_its in (("narrow", SERVE_PODS, SERVE_ITS), ("wide", WIDE_PODS, WIDE_ITS)):
        its, tpls = catalog(n_its)
        rng = random.Random(SERVE_SEED)
        group = [_Request(tenant=f"tenant-{t}", pods=[default_pod_factory(f"sv-0-{t}-{i}", rng) for i in range(n_pods)],
                          instance_types=its, templates=tpls, kwargs={}, deadline_s=0.0, submitted_at=0.0,
                          ticket=Ticket(f"tenant-{t}"))
                 for t in range(STACK_LANES)]
        captured = {}
        real_screen = M.batched_screen

        def spy(batch, C, passes=3):
            captured["args"] = (batch, C, passes)
            out = real_screen(batch, C, passes)
            captured["result"] = out
            return out

        stats = {}
        M.batched_screen = spy
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            results = xbatch.stacked_solve(group, device=dev, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            M.batched_screen = real_screen
        lanes = list(stats["lanes"])
        want = {**{k: 0 for k in kernels.LAUNCHES}, "runs_screen": 1}
        if launches != want or len(lanes) < 2:
            raise AssertionError(f"stacked {tag}: launches {launches}, lanes {lanes}: expected one runs_screen "
                                 f"launch with at least 2 lanes")
        answered = [i for i, r in enumerate(results) if r is not None]
        if not answered:
            raise AssertionError(f"stacked {tag}: every lane stood down: {stats['reasons']}")
        # every answered lane schedules what a solo solve of its pods does
        solo = TorchSolver(device=dev)
        for i in answered:
            control = solo.solve(group[i].pods, its, tpls)
            if results[i].num_scheduled() != control.num_scheduled():
                raise AssertionError(f"stacked {tag} lane {i}: {results[i].num_scheduled()} scheduled, a solo solve "
                                     f"{control.num_scheduled()}")
        torch.cuda.synchronize()
        batch, C, passes = captured["args"]
        rk = captured["result"]
        B = batch.pod_active.shape[0]
        checked = list(range(B)) if tag == "narrow" else [0, B - 1]
        sel = torch.tensor(checked, device=rk.kind.device)

        def against_plain(name, rk, rp):
            """Kind/index and integer and bool state exact on the checked
            lanes, float state within FLOAT_RTOL; the largest float
            difference."""
            if not (torch.equal(rk.kind[sel].cpu(), rp.kind.cpu()) and torch.equal(rk.index[sel].cpu(),
                                                                                      rp.index.cpu())):
                raise AssertionError(f"stacked {tag} {name}: kind/index differ from the plain version")
            sk, sp = numpy_fields(rk.state), numpy_fields(rp.state)
            err = 0.0
            for key in sp:
                a, b = sk[key][checked], sp[key]
                if a.dtype.kind == "f":
                    if not np.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, equal_nan=True):
                        raise AssertionError(f"stacked {tag} {name}: float state {key} differs")
                    fin = np.isfinite(a) & np.isfinite(b)
                    if fin.any():
                        err = max(err, float(np.abs(a[fin] - b[fin]).max()))
                elif not np.array_equal(a, b):
                    raise AssertionError(f"stacked {tag} {name}: state {key} differs")
            return err

        # the kernel against its plain version on the same stack: the screen
        # (the serve path's three passes) and batched_solve (one pass)
        rp, p_ms = plain_ms(lambda: M.batched_screen_plain(batch, C, passes, lanes=checked))
        max_err = max(max_err, against_plain("batched_screen", rk, rp))
        rk1 = M.batched_solve(batch, C)
        rp1, p1_ms = plain_ms(lambda: M.batched_solve_plain(batch, C, lanes=checked))
        max_err = max(max_err, against_plain("batched_solve", rk1, rp1))
        # alone: CUDA events around the launch over argument sets built
        # beforehand; through the wrapper; and batched_solve alone
        max_run, with_topo = M.max_run_bucket(batch), M.has_topo_runs(batch)
        sets = [M.stacked_screen_args(batch, C, max_run=max_run, passes=passes, with_topo=with_topo) for _ in range(5)]
        k_ms, k_all = time_launches("runs_screen", sets)
        for t, _ in sets:
            if not (torch.equal(t["kind"], rk.kind) and torch.equal(t["index"], rk.index)):
                raise AssertionError(f"stacked {tag}: a timed launch differs from the wrapper's")
        w_ms, _ = time_ms(lambda: M.batched_screen(batch, C, passes), 5)
        sets1 = [M.stacked_screen_args(batch, C, max_run=max_run, passes=1, with_topo=with_topo) for _ in range(5)]
        k1_ms, _ = time_launches("runs_screen", sets1)
        work = dict(zip(M.RS_WORK_COUNTERS, rk.work.sum(dim=0).cpu().tolist()))
        nbytes = io_bytes(sets[0][0], (), M.RS_SCRATCH)
        a0 = sets[0][1]  # the problem's sizes are the struct's ints (the stack leads every leaf)
        K, Wd, O, R = a0.K, a0.W, a0.O, a0.R
        int_ops = work["bin_gates"] * 2 * K * Wd + work["topo_lanes"] * 2 + work["type_tests"] * (K * Wd + O)
        flt_ops = work["type_tests"] * 2 * R
        b_ms, b_by = bound(nbytes, int_ops, flt_ops)
        dims = {f: getattr(a0, f) for f in ("B", "P", "C", "T", "V", "W", "K", "N", "G", "R", "TPL", "RN", "MR")}
        # the launch's dynamic shared memory, as runs_screen_launch sizes it
        dims["dyn_smem_bytes"] = 4 * (3 * a0.G + a0.R + 4 * a0.MR + 2 * a0.N + 5 * a0.C + 2 * a0.TPL)
        shapes[tag] = dict(lanes=len(lanes), answered=len(answered), reasons=stats["reasons"], dims=dims,
                           wall_ms=wall * 1e3, split_ms=stats["timing"], ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
                           plain_lanes=len(checked), solve_ms=k1_ms, solve_plain_ms=p1_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, int_ops=int_ops, flt_ops=flt_ops, work=work,
                           scheduled=[r.num_scheduled() if r is not None else None for r in results],
                           claims=[len(r.new_claims) if r is not None else None for r in results])
        log(f"  stacked {tag}: {len(lanes)} lanes in one launch ({len(answered)} answered, reasons "
            f"{stats['reasons']}), dims {dims}; stacked_solve wall {wall * 1e3:.1f} ms = {stats['timing']}; "
            f"kernel {k_ms:.3f} ms median of {[round(x, 3) for x in k_all]}, wrapper {w_ms:.3f} ms, plain "
            f"{p_ms:.1f} ms on {len(checked)} lanes; batched_solve kernel {k1_ms:.3f} ms, plain {p1_ms:.1f} ms; "
            f"kernel == plain (max float err {max_err}); bytes {nbytes}, int ops {int_ops:.4g}, float ops "
            f"{flt_ops:.4g}, bound {b_ms:.5f} ms ({b_by}); scheduled {shapes[tag]['scheduled']} = solo")

    # -- 5b. the serve scenario at the reference's full size
    its, tpls = catalog(SERVE_ITS)
    rng = random.Random(SERVE_SEED)
    problems = [[[default_pod_factory(f"sv-{c}-{t}-{i}", rng) for i in range(SERVE_PODS)]
                 for t in range(SERVE_TENANTS)] for c in range(SERVE_CYCLES)]
    shared = TorchSolver(device=dev)
    service = serve.SolveService(device=dev)
    supervisors = {f"tenant-{t}": serve.build_tenant_solver(f"tenant-{t}", primary=shared, fallback=OracleSolver())
                   for t in range(SERVE_TENANTS)}
    for name, solver in supervisors.items():
        service.register_tenant(name, solver=solver)
    service.start()

    def serve_pass():
        lat, outs = [], []
        t0 = time.perf_counter()
        for cycle in problems:
            tickets = [service.submit(f"tenant-{t}", cycle[t], its, tpls) for t in range(SERVE_TENANTS)]
            outs += [tk.wait(timeout=300.0) for tk in tickets]
        wall = time.perf_counter() - t0
        bad = [(o.tenant, o.status, o.reason) for o in outs if o.status != "ok"]
        if bad:
            raise AssertionError(f"serve: {len(bad)} tickets not ok: {bad[:4]}")
        return wall, sorted(o.latency_s for o in outs), outs

    try:
        serve_pass()  # warm pass
        before = service.summary()
        kernels.reset_launches()
        serve_wall, lat, outs = serve_pass()
        torch.cuda.synchronize()
        serve_launches = dict(kernels.LAUNCHES)
        after = service.summary()
    finally:
        service.close()
    completed = after["completed"] - before["completed"]
    batched = after["batched"] - before["batched"]
    if after["errors"] or completed != SERVE_TENANTS * SERVE_CYCLES:
        raise AssertionError(f"serve: {after}")
    if serve_launches["runs_screen"] <= 0:
        raise AssertionError(f"serve: the measured pass never launched the stacked runs_screen: {serve_launches}")
    control = SupervisedSolver(shared, fallback=OracleSolver())
    for _ in range(2):  # the second pass is timed
        t0 = time.perf_counter()
        for cycle in problems:
            for t in range(SERVE_TENANTS):
                control.solve(cycle[t], its, tpls)
        torch.cuda.synchronize()
        seq_wall = time.perf_counter() - t0
    # neither side's walls may hide a failover to the host oracle, a retry
    # or a rejection
    for name, sup_ in {**supervisors, "sequential control": control}.items():
        if sup_.circuit_state() != "closed" or any(sup_.counters.values()):
            raise AssertionError(f"serve: {name}: circuit {sup_.circuit_state()}, counters {sup_.counters}")
    pods_total = SERVE_TENANTS * SERVE_CYCLES * SERVE_PODS
    scenario = dict(tenants=SERVE_TENANTS, cycles=SERVE_CYCLES, pods_per_cycle=SERVE_PODS, serve_wall_s=serve_wall,
                    sequential_wall_s=seq_wall, agg_pods_per_s=pods_total / serve_wall,
                    vs_sequential=seq_wall / serve_wall, p50_cycle_s=statistics.median(lat),
                    p99_cycle_s=lat[min(len(lat) - 1, int(0.99 * len(lat)))], completed=completed, batched=batched,
                    batch_hit_rate=batched / max(completed, 1), launches=serve_launches,
                    paths={p_: sum(o.path == p_ for o in outs) for p_ in ("batched", "solo")})

    # the overload probe: a 2-deep queue, a 20 ms solver, a 50 ms budget
    class _Slow:
        def solve(self, pods, its_, tpls_, **kw):
            time.sleep(0.02)
            return type("R", (), {"num_scheduled": lambda s: 0, "new_claims": (), "node_pods": {},
                                  "failures": {}})()

    probe = serve.SolveService(queue_depth=2, batching=False, device=dev)
    probe.register_tenant("flood", solver=_Slow())
    probe.start()
    try:
        flood = [probe.submit("flood", problems[0][0][:4], its, tpls, deadline_s=0.05) for _ in range(24)]
        flood_outs = [tk.wait(timeout=60.0) for tk in flood]
    finally:
        probe.close()
    statuses = {}
    for o in flood_outs:
        key = o.status if o.status == "ok" else f"{o.status}:{o.reason}"
        statuses[key] = statuses.get(key, 0) + 1
    unclassified = sum(1 for o in flood_outs
                       if o.status not in ("ok", "overloaded", "rejected") or (o.status != "ok" and not o.reason))
    if unclassified:
        raise AssertionError(f"overload probe: {unclassified} unclassified outcomes: {statuses}")
    scenario["overload"] = dict(submitted=len(flood_outs), statuses=statuses, unclassified=unclassified)
    log(f"  serve: {SERVE_TENANTS} tenants x {SERVE_CYCLES} cycles x {SERVE_PODS} pods: serve wall "
        f"{serve_wall:.4f} s, sequential {seq_wall:.4f} s, {scenario['agg_pods_per_s']:.1f} pods/s, vs_sequential "
        f"{scenario['vs_sequential']:.3f}, p50 {scenario['p50_cycle_s']:.4f} s, p99 {scenario['p99_cycle_s']:.4f} s, "
        f"completed {completed}, batched {batched} (hit rate {scenario['batch_hit_rate']:.3f}), launches "
        f"{serve_launches}; overload probe {statuses}")

    # -- the supervised main path: phase 2's batch through SupervisedSolver
    pods, its, tpls, nodes = main_workload
    sup = SupervisedSolver(TorchSolver(initial_claim_slots=128, device=dev), fallback=OracleSolver())
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sup.solve(pods, its, tpls, nodes)
    torch.cuda.synchronize()
    sup_wall = time.perf_counter() - t0
    sup_launches = dict(kernels.LAUNCHES)
    if placements(res) != placements(main_result):
        raise AssertionError("supervised main path: placements differ from phase 2's")
    if sup.circuit_state() != "closed" or any(sup.counters.values()):
        raise AssertionError(f"supervised main path: circuit {sup.circuit_state()}, counters {sup.counters}")
    for name in ("ffd_loop", "gate_counts", "relax_place"):
        if sup_launches[name] <= 0:
            raise AssertionError(f"supervised main path never launched {name}: {sup_launches}")
    supervised = dict(wall_ms=sup_wall * 1e3, launches=sup_launches, scheduled=res.num_scheduled(),
                      circuit=sup.circuit_state(), counters=dict(sup.counters))
    log(f"  supervised main path: {res.num_scheduled()}/{len(pods)} scheduled, placements == phase 2's, circuit "
        f"closed, counters {sup.counters}; wall {sup_wall * 1e3:.1f} ms; launches {sup_launches}")
    log(f"  serve phase wall {time.perf_counter() - t_phase:.1f}s")
    wide = shapes["wide"]
    return {
        "name": "runs_screen_stacked",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/runs_screen.cu",
        "replaces": "karpenter_tpu/parallel/mesh.py:154",
        "also_replaces": ["karpenter_tpu/parallel/mesh.py:88"],
        "launches": serve_launches["runs_screen"],
        "max_abs_err": max_err,
        "ms": wide["ms"],
        "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"],
        "library_ms": None,
        "wrapper_ms": wide["wrapper_ms"],
        "plain_lanes": wide["plain_lanes"],
        "float_rtol": FLOAT_RTOL,
        "shapes": shapes,
        "serve": scenario,
        "supervised": supervised,
    }


def screen_subsets(n, seed=SCREEN_SEED):
    """The subsets one consolidation pass asks about: the n/2 prefixes
    (Multi-node), the n singletons (Single-node), and 20 seeded random
    subsets of 3n/4 to n candidates."""
    rng = random.Random(seed)
    return ([list(range(k + 1)) for k in range(n // 2)] + [[k] for k in range(n)]
            + [sorted(rng.sample(range(n), rng.randint(3 * n // 4, n))) for _ in range(20)])


def verdict_key(v):
    return (v.all_pods_scheduled, v.n_new_claims, sorted(v.replacement_its or []),
            sorted(v.replacement_zones or []), sorted(v.replacement_cts or []))


if __name__ == "__main__":
    sys.exit(main())
