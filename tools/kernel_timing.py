"""Time the port's redesigned kernels on the card at the main path's shapes,
for one tree of the port, so that two trees (a parent commit and a change)
are timed on the same card in one call.

    python tools/kernel_timing.py make --out DIR [--kernels NAME,...] [--small]
    python tools/kernel_timing.py time --root TREE --inputs DIR --tag NAME [--kernels NAME,...] [--sweep]

``KERNELS`` is the table of what is timed: for each kernel, the inputs it
needs and the shapes it runs at, all at the shapes ``chip_smoke.py`` runs
(its constants):

- ``relax_place``: the waterfill and the convex mode over the 10,000-pod
  diverse batch of phase 2 and the homogeneous bulk of phase 7, the convex
  lanes mode over the 100,000-pod fleet's eight partitions of phase 8;
- ``runs_screen``: the consolidation screen's residual, full and
  full-topology launches of phase 3, the serve layer's stacked narrow and
  wide launches of phase 5;
- ``ffd_loop``: carried from the waterfill, fresh, and one-pass over 2,500
  rows of phase 2's batch, at 16 blocks;
- ``gate_counts``: the gate of the 10,000-pod solve (phase 2), the fleet's
  partitions' gates (phase 8), the fused gate over the churn run's last
  cycle (phase 4);
- ``attribute``: the explain pass over the 10,000-pod batch under an
  8,000-cpu and a 4,000-cpu NodePool limit (phase 6);
- ``patch_world``: the churn run's last row patch of the 10,000-pod world
  (phase 4);
- ``lane_scores``: the learned order's scorer over phase 7's policy
  problem (10,240 rows), with the committed head and a 64-unit tanh head.

``make`` builds the inputs of the kernels named (all by default) with this
checkout's package and saves them under DIR with ``torch.save``; ``--small``
rehearses it on the CPU at toy sizes.

``time`` imports ``karpenter_tpu_torch`` from TREE, builds each launch's
argument sets with that tree's own functions, times the launches with CUDA
events (the median of several, each on a fresh set), and prints one JSON line
per shape: the times, a digest of every output (two trees that compute the
same function print the same digest), and, where the tree has them, the work
counters, the split by section and the plan. The gate, attribute,
patch_world and lane_scores shapes also time the wrapper end to end and its
steps, and name where the wrapper's host time goes; the last two also time
one launch of the ``probe`` kernel (one warp), the floor of a launch, and
each of the three again as the device time a launch adds to a stream of
back-to-back launches (``batch_ms``). ``--sweep`` adds every cluster size, screen layout
and row plan the tree has. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import inspect
import json
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# -- make --------------------------------------------------------------------

def _sizes(small: bool) -> dict:
    import chip_smoke as CS

    if small:  # a rehearsal on the CPU at toy sizes
        return dict(main=300, fleet=2000, candidates=24, wide=60, churn=300, cycles=3)
    return dict(main=CS.MAIN_PODS, fleet=CS.SHARD_PODS, candidates=CS.SCREEN_CANDIDATES, wide=CS.WIDE_PODS,
                churn=CS.CHURN_PODS, cycles=CS.CHURN_CYCLES)


def make_solved(dev, small):
    """The 10k diverse and homogeneous problems as a solve hands them over,
    and the convex mode's knobs."""
    import torch

    from karpenter_tpu_torch.ops import relax2 as R2
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    n = _sizes(small)["main"]

    def solved_problem(workload):
        result = TorchSolver(initial_claim_slots=128, device=dev, relax=False).solve(*workload)
        ctx = result.verify_ctx
        prob = ctx.device_problem
        active = torch.arange(prob.num_pods, device=dev) < n
        return _pad_lanes_mult32(dataclasses.replace(prob, pod_active=active)), ctx.max_claims

    return {"diverse": solved_problem(W.diverse_workload(n, 400, seed=42)),
            "homogeneous": solved_problem(W.homogeneous_workload(n, 400)),
            "convex": (R2.pgd_iters(), R2.pgd_step())}


def make_fleet(dev, small):
    """The fleet's partitions as the RELAX2 sharded solve dispatches them."""
    import chip_smoke as CS
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    seen = []
    orig = M.shard_relax2_sweeps

    def recording(*args, **kwargs):
        seen.append(args)
        return orig(*args, **kwargs)

    env = {**CS.SHARD_ENV, "KARPENTER_TPU_RELAX2": "1"}
    if small:
        env["KARPENTER_TPU_SHARD_MIN_PODS"] = "64"
    M.shard_relax2_sweeps = recording
    os.environ.update(env)
    try:
        TorchSolver(device=dev).solve(*W.fleet_workload(_sizes(small)["fleet"], 400, seed=42,
                                                        neighborhoods=CS.SHARD_NEIGHBORHOODS))
    finally:
        M.shard_relax2_sweeps = orig
        for name in env:
            os.environ.pop(name, None)
    batch2, C2, iters2, step2 = seen[-1][:4]
    return {"fleet": ([_pad_lanes_mult32(p) for p in M._shard_lanes(batch2)], C2, (iters2, step2))}


def make_screens(dev, small):
    """The consolidation screen's three launches."""
    import chip_smoke as CS
    from karpenter_tpu_torch.disruption import batch as dbatch
    from karpenter_tpu_torch.testing import workloads as W

    candidates = _sizes(small)["candidates"]
    subsets = CS.screen_subsets(candidates)
    captured = {}
    real_lean, real_res = dbatch.lean_screen, dbatch.residual_screen

    def lean(base, variants, C, passes=3):
        captured["full"] = (base, variants, C, passes)
        return real_lean(base, variants, C, passes)

    def res(base, carried, variants, run_idx, C):
        captured["residual"] = (base, carried, variants, run_idx, C)
        return real_res(base, carried, variants, run_idx, C)

    screens = {}
    for tag, base_pods, delta, key in (
            ("residual", W.pinned_base_pods(8, cpu=63.5), True, "residual"),
            ("full_a", W.pinned_base_pods(8, cpu=63.5), False, "full"),
            ("full_b", W.pinned_base_pods(8, cpu=63.5) + W.zonal_spread_pods(24), True, "full")):
        scorer = dbatch.build_bench_scorer(candidates, base_pods=base_pods, device=dev, delta=delta)[0]
        captured.clear()
        dbatch.lean_screen, dbatch.residual_screen = lean, res
        try:
            scorer.score_subsets(subsets)
        finally:
            dbatch.lean_screen, dbatch.residual_screen = real_lean, real_res
        screens[tag] = (key, captured[key])
    return {"screens": screens}


def make_stacked(dev, small):
    """The serve layer's stacked launches."""
    import chip_smoke as CS
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.serve import batch as xbatch
    from karpenter_tpu_torch.serve.dispatcher import Ticket, _Request
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    stacked = {}
    for tag, n_pods, n_its in (("narrow", CS.SERVE_PODS, CS.SERVE_ITS), ("wide", _sizes(small)["wide"], CS.WIDE_ITS)):
        its = instance_types(n_its)
        tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="serve")), its, range(len(its)))]
        rng = random.Random(CS.SERVE_SEED)
        group = [_Request(tenant=f"tenant-{t}", pods=[default_pod_factory(f"sv-0-{t}-{i}", rng) for i in range(n_pods)],
                          instance_types=its, templates=tpls, kwargs={}, deadline_s=0.0, submitted_at=0.0,
                          ticket=Ticket(f"tenant-{t}"))
                 for t in range(CS.STACK_LANES)]
        cap = {}
        real = M.batched_screen

        def spy(batch, C, passes=3):
            cap["args"] = (batch, C, passes)
            return real(batch, C, passes)

        M.batched_screen = spy
        try:
            xbatch.stacked_solve(group, device=dev, stats={})
        finally:
            M.batched_screen = real
        stacked[tag] = cap["args"]
    return {"stacked": stacked}


def _gates_of(run):
    """(GateProblem, GateArgs, bounds_free, the solve's tables) of every
    device gate ``run()`` makes."""
    from karpenter_tpu_torch.verify import device as gdev

    seen = []
    real = gdev.verify_gate

    def recording(gp, ga, bf, tables=None):
        seen.append((gp, ga, bf, tables))
        return real(gp, ga, bf, tables)

    gdev.verify_gate = recording
    try:
        run()
    finally:
        gdev.verify_gate = real
    return seen


_CHURN = {}


def _churn(dev, small):
    """Phase 4's churn run through its last cycle, once per ``make``: the
    churn process and the resident solver's DeviceWorld."""
    if small not in _CHURN:
        import chip_smoke as CS
        from karpenter_tpu_torch.apis.nodepool import NodePool
        from karpenter_tpu_torch.apis.objects import ObjectMeta
        from karpenter_tpu_torch.cloudprovider.fake import instance_types
        from karpenter_tpu_torch.solver.encode import template_from_nodepool
        from karpenter_tpu_torch.solver.torch_backend import TorchSolver
        from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess, default_pod_factory

        sz = _sizes(small)
        its = instance_types(400)
        tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="d")), its, range(len(its)))]
        rng = random.Random(CS.CHURN_SEED)
        n = sz["churn"]
        proc = ChurnProcess([default_pod_factory(f"dw-{i}", rng) for i in range(n)],
                            config=ChurnConfig(seed=CS.CHURN_SEED, arrivals_per_cycle=n * 2 // 100,
                                               deletes_per_cycle=n * 2 // 100))
        resident = TorchSolver(relax=False, device_world=True, device=dev, initial_claim_slots=CS.CHURN_SLOTS)
        for cyc in range(sz["cycles"]):
            if cyc:
                proc.step()
            resident.solve(list(proc.pods), its, tpls)
        _CHURN[small] = (proc, resident._device_world)
    return _CHURN[small]


def make_gates(dev, small):
    """The gate of the 10k solve, the fleet's partitions' gates, and the
    fused gate's inputs over the churn run's last cycle as the solve hands
    them over."""
    import torch

    import chip_smoke as CS
    from karpenter_tpu_torch.ops import fused
    from karpenter_tpu_torch.ops.ffd_sweeps import state_tensors
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    sz = _sizes(small)
    out = {}
    main = W.diverse_workload(sz["main"], 400, seed=42)
    out["gate_10k"] = _gates_of(lambda: TorchSolver(initial_claim_slots=128, device=dev).solve(*main))[0]
    fleet = W.fleet_workload(sz["fleet"], 400, seed=42, neighborhoods=CS.SHARD_NEIGHBORHOODS)
    env = dict(CS.SHARD_ENV, **({"KARPENTER_TPU_SHARD_MIN_PODS": "64"} if small else {}))
    os.environ.update(env)
    try:
        out["gate_fleet"] = _gates_of(lambda: TorchSolver(device=dev).solve(*fleet))
    finally:
        for name in env:
            os.environ.pop(name, None)
    proc, dw = _churn(dev, small)
    pc = torch.from_numpy(dw._pod_check(list(proc.pods), dw.meta)).to(dev)
    rk, _ = fused.solve_ffd_fused_gate(dw.world, pc, CS.CHURN_SLOTS)
    problem = fused.world_problem(dw.world.t)
    t = {name: x.clone() for name, x in dw.world.t.items()}
    t.update(state_tensors(rk.state, problem.lane_valid, problem.lane_numeric))
    t["kind"], t["index"] = rk.kind.clone(), rk.index.clone()
    out["gate_fused_churn"] = (t, pc)
    return out


def make_explain(dev, small):
    """The explain pass's (problem, state, rows, the solve's tables) under
    two NodePool cpu limits."""
    import chip_smoke as CS
    from karpenter_tpu_torch.ops import ffd_step
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    pods, its, tpls, nodes = W.diverse_workload(_sizes(small)["main"], 400, seed=42)
    real = ffd_step.attribute_pods
    out = {}
    for limit in (CS.EXPLAIN_CPU_LIMIT, 4000.0):
        seen = []

        def recording(problem, state, rows, tables=None):
            seen.append((problem, state, list(rows), tables))
            return real(problem, state, rows, tables)

        tpl = copy.copy(tpls[0])
        tpl.remaining_resources = {"cpu": limit}
        os.environ["KARPENTER_TPU_EXPLAIN"] = "1"
        ffd_step.attribute_pods = recording
        try:
            TorchSolver(initial_claim_slots=128, device=dev).solve(pods, its, [tpl], nodes)
        finally:
            ffd_step.attribute_pods = real
            os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
        out[f"attribute_{int(limit)}"] = seen[0]
    return out


def make_patch(dev, small):
    """The churn run's last patch: its arguments (the delta encoder's splice
    of the last cycle, ``build_patch_args``) and the resident world as it
    stood before it (the previous rows, which the swap left in the spare
    buffers)."""
    from karpenter_tpu_torch.ops import fused

    _, dw = _churn(dev, small)
    w = dw.world
    args = fused.build_patch_args(dw.delta._state.problem, dw.delta.last_rows_prev, w.shapes)
    t = {k: (w.spare[k] if k in fused.PATCH_ROWS else v).clone() for k, v in w.t.items()}
    return {"patch_world": {"args": args._asdict(), "t": t, "init": w.init, "lanes": w.lanes, "shapes": w.shapes,
                            "max_claims": w.max_claims}}


def make_policy(dev, small):
    """Phase 7's scorer input: the ``ORDER_POLICY=1`` fresh solve's padded
    problem with every pod active, and the committed lane head."""
    import torch

    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
    from karpenter_tpu_torch.solver import ordering
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.testing import workloads as W

    n = _sizes(small)["main"]
    os.environ["KARPENTER_TPU_ORDER_POLICY"] = "1"
    ordering.reset_for_tests()
    try:
        result = TorchSolver(initial_claim_slots=128, device=dev, relax=False).solve(*W.diverse_workload(n, 400, seed=42))
        weights = ordering.lane_weights_static()
    finally:
        os.environ.pop("KARPENTER_TPU_ORDER_POLICY", None)
        ordering.reset_for_tests()
    prob = result.verify_ctx.device_problem
    active = torch.arange(prob.num_pods, device=dev) < n
    return {"lane_scores": (_pad_lanes_mult32(dataclasses.replace(prob, pod_active=active)), weights)}


MAKERS = {"solved": make_solved, "fleet": make_fleet, "screens": make_screens, "stacked": make_stacked,
          "gates": make_gates, "explain": make_explain, "patch": make_patch, "policy": make_policy}


def make(out: Path, names, small: bool = False) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as CS

    if not small and not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device")
    dev = torch.device("cpu" if small else "cuda")
    out.mkdir(parents=True, exist_ok=True)
    if not small:
        from karpenter_tpu_torch import kernels

        kernels.build()  # one nvcc per source, all at once
    for name in CS.FLAG_ENV:
        os.environ.pop(name, None)
    inputs = {}
    for group in dict.fromkeys(g for name in names for g in KERNELS[name][0]):
        t0 = time.perf_counter()
        inputs.update(MAKERS[group](dev, small))
        log(f"make: {group} {time.perf_counter() - t0:.1f}s")
    torch.save(inputs, out / "inputs.pt")


# -- time --------------------------------------------------------------------

def digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for x in tensors:
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes() if x.numel() else b"")
        else:
            h.update(repr(x).encode())
    return h.hexdigest()[:16]


# the layouts and cluster sizes ``--sweep`` times beside each plan's own
SWEEP_LAYOUTS = (("block", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8))
SWEEP_CLUSTERS = (1, 2, 4, 8, 16)
SWEEP_GATE_CLUSTERS = (16, 8, 4)


class Timer:
    """What every kernel's timing shares: the tree's kernels, the stream,
    the repetitions, and the JSON lines printed."""

    def __init__(self, tag: str, reps: int, sweep: bool):
        import torch

        from karpenter_tpu_torch import kernels

        self.torch, self.kernels = torch, kernels
        self.tag, self.reps, self.sweep = tag, reps, sweep
        self.dev = torch.device("cuda")
        self.stream = torch.cuda.current_stream(self.dev).cuda_stream
        self.rows = []

    def time_sets(self, name, sets, counter=None):
        torch = self.torch
        times = []
        for _, args in sets:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            self.kernels.launch(name, args, self.stream, counter=counter)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def batch_ms(self, name, args, n=50):
        """Device time a launch of ``args`` adds to a stream of ``n``
        back-to-back launches: CUDA events around the run, over n (the
        median of 7 runs); for kernels near the cost of a launch, where one
        event pair a launch measures mostly the events."""
        torch = self.torch
        self.kernels.launch(name, args, self.stream)
        times = []
        for _ in range(7):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                self.kernels.launch(name, args, self.stream)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / n)
        return statistics.median(times)

    def host_ms(self, fn, n=7):
        """Host wall of ``fn`` to the end of its device work, median."""
        times = []
        for _ in range(n):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            self.torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def wrapper_ops(self, fn):
        """Where a wrapper call's host time goes: its PyTorch operations by
        self CPU time (the profiler's CPU activity), the top ten and the total."""
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            self.torch.cuda.synchronize()
        ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        return {"ops": sum(e.count for e in ev), "self_ms": round(sum(e.self_cpu_time_total for e in ev) / 1e3, 4),
                "top": [(e.key, e.count, round(e.self_cpu_time_total / 1e3, 4)) for e in ev[:10]]}

    @staticmethod
    def split(sections, names, ms):
        cyc = [int(x) for x in sections]
        total = sum(cyc) or 1
        return {n: round(c / total * ms, 4) for n, c in zip(names, cyc) if c}

    def launch_floor(self):
        """One launch timed the same way: the ``probe`` kernel (one warp
        summing 16 values), median of the repetitions; once per tree."""
        if not hasattr(self, "_floor"):
            from karpenter_tpu_torch.verify import device as gdev

            x = self.torch.arange(16, dtype=self.torch.float32, device=self.dev)
            sets = [gdev.probe_args(x) for _ in range(max(self.reps, 10))]
            self._floor = {"ms": self.time_sets("probe", sets)[0], "batch_ms": self.batch_ms("probe", sets[0][1])}
        return self._floor

    def emit(self, shape, ms, times, dig, extra=None):
        row = {"kind": "shape", "tag": self.tag, "shape": shape, "ms": ms, "times": [round(x, 4) for x in times],
               "digest": dig, **(extra or {})}
        self.rows.append(row)
        print(json.dumps(row), flush=True)


def time_relax_place(tm: Timer, inputs) -> None:
    from karpenter_tpu_torch.ops import ffd_sweeps as FS
    from karpenter_tpu_torch.ops import relax as RX

    rx_out = ("kind", "index", "residue", "stats") + RX.RELAX_STATE
    has_sections = "sections" in RX._RELAX_POINTERS

    def state_digest(t):
        return digest(*(t.get(n) for n in rx_out))

    def sections(ts, ms):
        if not has_sections:
            return None
        return tm.split(tm.torch.stack([t["sections"] for t in ts]).sum(0).cpu(), RX.SECTIONS, ms)

    def single(shape, prob, C, convex):
        if tm.sweep and "plan" in RX._RELAX_POINTERS:
            for cl in SWEEP_CLUSTERS:
                with FS.forced_cluster(cl):
                    csets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C, convex) for _ in range(3))]
                ms, times = tm.time_sets("relax_place", csets)
                tm.emit(f"{shape} @{cl}", ms, times, state_digest(csets[0][0]),
                        {"sections": sections([csets[0][0]], ms)})
        sets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C, convex) for _ in range(tm.reps))]
        ms, times = tm.time_sets("relax_place", sets)
        digs = {state_digest(t) for t, _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"{shape}: launches differ")
        t = sets[0][0]
        tm.emit(shape, ms, times, digs.pop(), {"sections": sections([t], ms),
                                               "plan": t["plan"].cpu().tolist() if "plan" in t else None})

    def lanes(shape, probs, C, convex):
        sets = []
        for _ in range(tm.reps):
            lts, buf, args = RX.relax_place_lanes_args(probs, C, convex)
            sets.append(((lts, buf), args))
        ms, times = tm.time_sets("relax2_place_lanes", sets)
        digs = {digest(*(state_digest(t) for t, _ in lts)) for (lts, _), _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"{shape}: launches differ")
        lts = sets[0][0][0]
        sec = None
        if has_sections:
            # the slowest lane's split (the launch waits for it)
            per = [int(t["sections"].sum()) for t, _ in lts]
            sec = sections([lts[per.index(max(per))][0]], ms)
        tm.emit(shape, ms, times, digs.pop(), {"sections": sec, "lanes": len(probs),
                                               "lane_digests": [state_digest(t) for t, _ in lts]})

    prob, C = inputs["diverse"]
    hprob, hC = inputs["homogeneous"]
    convex = tuple(inputs["convex"])
    single("relax waterfill 10k", prob, C, None)
    single("relax convex diverse 10k", prob, C, convex)
    single("relax convex homogeneous 10k", hprob, hC, convex)
    lanes("relax waterfill one lane 10k", [prob], C, None)
    fprobs, fC, fconvex = inputs["fleet"]
    lanes("relax convex lanes fleet 8x", fprobs, fC, tuple(fconvex))
    deep = max(range(len(fprobs)), key=lambda b: int(fprobs[b].pod_active.sum()))
    lanes(f"relax convex one lane fleet lane {deep}", [fprobs[deep]], fC, tuple(fconvex))
    single(f"relax convex single fleet lane {deep}", fprobs[deep], fC, tuple(fconvex))


def time_runs_screen(tm: Timer, inputs) -> None:
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32, initial_state
    from karpenter_tpu_torch.parallel import mesh as M

    rs_out = ("kind", "index") + tuple(M.RS_STATE)
    has_sections = hasattr(M, "RS_SECTIONS")

    def state_digest(t):
        return digest(*(t.get(n) for n in rs_out))

    def screen(shape, make_args):
        if tm.sweep and hasattr(M, "forced_screen_plan"):
            for layout, cl in SWEEP_LAYOUTS:
                with M.forced_screen_plan(layout, cl):
                    lsets = [make_args() for _ in range(3)]
                ms, times = tm.time_sets("runs_screen", lsets)
                lt = lsets[0][0]
                slow = int(lt["sections"].sum(1).argmax())
                tm.emit(f"{shape} @{layout}{cl}", ms, times, state_digest(lt),
                        {"sections": {"slowest_lane": slow,
                                      "split": tm.split(lt["sections"][slow].cpu(), M.RS_SECTIONS, ms)}})
        sets = [make_args() for _ in range(tm.reps)]
        ms, times = tm.time_sets("runs_screen", sets)
        digs = {state_digest(t) for t, _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"{shape}: launches differ")
        t = sets[0][0]
        sec = None
        if has_sections:
            per = t["sections"].sum(1)
            slow = int(per.argmax())
            cyc = sorted(int(x) for x in per.cpu())
            sec = {"slowest_lane": slow, "split": tm.split(t["sections"][slow].cpu(), M.RS_SECTIONS, ms),
                   "lanes_summed": tm.split(t["sections"].sum(0).cpu(), M.RS_SECTIONS, ms),
                   "lane_cycles": {"max": cyc[-1], "p90": cyc[len(cyc) * 9 // 10], "median": cyc[len(cyc) // 2],
                                   "min": cyc[0], "sum": sum(cyc)}}
        tm.emit(shape, ms, times, digs.pop(), {"sections": sec, "lanes": int(t["kind"].shape[0]),
                                               "plan": t["plan"].cpu().tolist() if "plan" in t else None})

    for stag, (key, cap) in inputs["screens"].items():
        if key == "residual":
            base, carried, variants, run_idx, SC = cap
            base = _pad_lanes_mult32(base)
            p0 = M.trim_runs(base, run_idx)
            kw = dict(max_run=M.max_run_bucket(base), passes=1, with_topo=False)
            screen(f"screen {stag}", lambda: M.runs_screen_args(p0, carried, variants.node_avail,
                                                                 variants.pod_active, **kw))
        else:
            base, variants, SC, passes = cap
            base = _pad_lanes_mult32(base)
            kw = dict(max_run=M.max_run_bucket(base), passes=passes, with_topo=M.has_topo_runs(base),
                      grp_counts0=variants.grp_counts0, grp_registered0=variants.grp_registered0)
            init = initial_state(base, SC)
            screen(f"screen {stag}", lambda: M.runs_screen_args(base, init, variants.node_avail,
                                                                 variants.pod_active, **kw))
    for stag, (batch, SC, passes) in inputs["stacked"].items():
        mr, wt = M.max_run_bucket(batch), M.has_topo_runs(batch)
        screen(f"stacked {stag}", lambda: M.stacked_screen_args(batch, SC, max_run=mr, passes=passes, with_topo=wt))


def time_ffd_loop(tm: Timer, inputs) -> None:
    """At 16 blocks: carried from the waterfill, fresh, one-pass."""
    from karpenter_tpu_torch.ops import ffd_sweeps as FS
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state

    torch = tm.torch
    prob, C = inputs["diverse"]
    forced = getattr(FS, "forced_cluster", None)
    rxo = RX.relax_place(prob, C)
    kind0, index0 = rxo.kind, rxo.index
    residue, astate = _lane_align(dataclasses.replace(prob, pod_active=rxo.residue_active), rxo.state)
    op_prob = dataclasses.replace(prob, pod_active=prob.pod_active & (
        torch.arange(prob.pod_active.shape[0], device=tm.dev) < 2500))
    loops = {
        "ffd_loop carried 10k": lambda: FS.ffd_loop_args(residue, astate, False, kind0, index0),
        "ffd_loop fresh 10k": lambda: FS.ffd_loop_args(prob, initial_state(prob, C), False),
        "ffd_loop one-pass 2500": lambda: FS.ffd_loop_args(op_prob, initial_state(op_prob, C), True),
    }
    for shape, fn in loops.items():
        with forced(16) if forced else contextlib.nullcontext():
            sets = [fn() for _ in range(3)]
        ms, times = tm.time_sets("ffd_loop", sets)
        t = sets[0][0]
        dig = digest(t["kind"], t["index"], *(t[n] for n in FS.FFD_STATE if n in t))
        tm.emit(shape, ms, times, dig, {"plan": t["plan"].cpu().tolist() if "plan" in t else None})


def _takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def time_gate_counts(tm: Timer, inputs) -> None:
    """The 10k gate, a fleet partition's (the first and the deepest), the
    fused churn gate; each wrapper with the solve's tables where the tree
    takes them."""
    from karpenter_tpu_torch.ops import ffd_sweeps as FS
    from karpenter_tpu_torch.verify import device as gdev

    torch = tm.torch
    takes_tables = _takes(gdev.gate_counts_args, "tables")
    # the cluster override: this tree's gate reads ffd_sweeps.forced_cluster
    # when it plans by gate_blocks
    forced = FS.forced_cluster if hasattr(gdev, "gate_blocks") else None

    def sections(t, ms):
        split = getattr(gdev, "gate_section_split", None)
        if split is None or "sections" not in t:
            return None
        return {k: round(v, 5) for k, v in split(t["sections"].cpu(), ms).items()}

    def bin_sizes(t):
        """The rows of each bin, from the launch's own inputs: its longest
        bin is one lane's chain of adds."""
        C, N = t["claim_tpl"].shape[0], t["node_avail"].shape[0]
        if t.get("pod_bin") is not None:
            b = t["pod_bin"].long()
        else:
            kind, index = t["kind"].long(), t["index"].long()
            b = torch.where((kind == 1) | (kind == 2), index, torch.where(kind == 0, C + index, -1))
        b = b[(b >= 0) & (b < C + N)]
        sizes = torch.bincount(b, minlength=C + N).cpu()
        return {"longest": int(sizes.max()) if sizes.numel() else 0, "bins": int((sizes > 0).sum()),
                "at_least_1024": int((sizes >= 1024).sum()), "placed": int(sizes.sum())}

    def shape(name, build, wrap):
        layouts = [None] + (list(SWEEP_GATE_CLUSTERS) if tm.sweep and forced else [])
        for layout in layouts:
            with forced(layout) if layout else contextlib.nullcontext():
                sets = [build() for _ in range(tm.reps)]
                ms, times = tm.time_sets("gate_counts", sets)
            t = sets[0][0]
            outs = ("counts", "summed", "nsum", "ngot")
            digs = {digest(*(s[n] for n in outs)) for s, _ in sets}
            if len(digs) != 1:
                raise AssertionError(f"{name}: launches differ")
            extra = {"counts": t["counts"].cpu().tolist(), "sections": sections(t, ms),
                     "plan": getattr(sets[0][1], "NB", None),
                     "barriers": list(gdev.gate_barriers(t["sections"].cpu())) if hasattr(gdev, "gate_barriers")
                     else None}
            if layout is None:
                extra["bins"] = bin_sizes(t)
                extra["args_ms"] = tm.host_ms(build)
                extra["wrapper_ms"] = tm.host_ms(wrap)
                extra["wrapper_ops"] = tm.wrapper_ops(wrap)
            tm.emit(name + (f" @cluster{layout}" if layout else ""), ms, times, digs.pop(), extra)

    def unfused(name, gp, ga, tables):
        kw = {"tables": tables} if takes_tables else {}
        shape(name, lambda: gdev.gate_counts_args(gp, ga, **kw), lambda: gdev.launch_gate_counts(gp, ga, **kw))

    gp, ga, _, tables = inputs["gate_10k"]
    unfused("gate 10k", gp, ga, tables)
    fleet = inputs["gate_fleet"]
    deep = max(range(len(fleet)), key=lambda i: int((fleet[i][1].pod_bin >= 0).sum()))
    for i in sorted({0, deep}):
        fgp, fga, _, ftables = fleet[i]
        unfused(f"gate fleet partition {i}", fgp, fga, ftables)
    ft, pc = inputs["gate_fused_churn"]
    shape("gate fused churn", lambda: gdev.gate_fused_args(ft, pc), lambda: gdev.launch_gate_counts_fused(ft, pc))


def time_attribute(tm: Timer, inputs) -> None:
    """The explain rows at each limit, with the solve's tables where the
    tree takes them; ``--sweep`` adds every row attributed (the problem
    without its ``pod_eqprev`` runs)."""
    from karpenter_tpu_torch.ops import ffd_step
    from karpenter_tpu_torch.ops.ffd_core import _lane_align

    names = getattr(ffd_step, "ATTR_SECTIONS", None)
    words = getattr(ffd_step, "attribute_words", lambda t: t["words"])
    kw_of = (lambda tables: {"tables": tables}) if _takes(ffd_step.attribute_args, "tables") else (lambda tables: {})

    def sections(t, ms):
        if names is None or "sections" not in t:
            return None
        cyc = [int(x) for x in t["sections"].cpu()]
        split = getattr(ffd_step, "attr_section_split", None)
        if split is not None:
            return {k: round(v, 5) for k, v in split(cyc, ms).items()}
        return dict(zip(names, cyc))

    for key in sorted(k for k in inputs if k.startswith("attribute_")):
        problem, state, rows, tables = inputs[key]
        aprob, astate = _lane_align(problem, state)
        kw = kw_of(tables)
        layouts = [None] + (["every-row"] if tm.sweep and hasattr(ffd_step, "attr_row_plan") else [])
        for layout in layouts:
            lprob = dataclasses.replace(aprob, pod_eqprev=None) if layout else aprob
            sets = [ffd_step.attribute_args(lprob, astate, rows, **kw) for _ in range(tm.reps)]
            ms, times = tm.time_sets("attribute", sets)
            t = sets[0][0]
            digs = {digest(words(s)) for s, _ in sets}
            if len(digs) != 1:
                raise AssertionError(f"{key}: launches differ")
            extra = {"rows": len(rows), "work": dict(zip(ffd_step.ATTR_WORK_COUNTERS, t["work"].cpu().tolist())),
                     "sections": sections(t, ms),
                     "cycles": dict(zip(names, (int(x) for x in t["sections"].cpu()))) if names else None,
                     "attributed": getattr(sets[0][1], "B", None), "team_warps": getattr(sets[0][1], "TW", None),
                     "plan": t["plan"].cpu().tolist() if "plan" in t else None}
            if layout is None:
                extra["args_ms"] = tm.host_ms(lambda: ffd_step.attribute_args(aprob, astate, rows, **kw))
                extra["wrapper_ms"] = tm.host_ms(lambda: ffd_step.launch_attribute(aprob, astate, rows, **kw))
                extra["wrapper_ops"] = tm.wrapper_ops(lambda: ffd_step.launch_attribute(aprob, astate, rows, **kw))
            tm.emit(f"{key.replace('_', ' ')} cpu" + (f" @{layout}" if layout else ""), ms, times, digs.pop(), extra)


def time_patch_world(tm: Timer, inputs) -> None:
    """The churn run's last patch: the kernel alone (the same launch again:
    it reads the previous rows and writes the spare buffers), the wrapper
    (upload and launch) and the wrapper's steps, on a copy of the world
    before the patch; the kernel's output held to the plain version."""
    from karpenter_tpu_torch.ops import fused

    torch = tm.torch
    rec = inputs["patch_world"]
    args = fused.PatchArgs(**rec["args"])
    w = fused.World(t={k: v.clone() for k, v in rec["t"].items()},
                    spare={k: torch.empty_like(rec["t"][k]) for k in fused.PATCH_ROWS}, init=rec["init"],
                    lanes=rec["lanes"], shapes=rec["shapes"], max_claims=rec["max_claims"])
    prev = {k: v.clone() for k, v in w.t.items()}
    up = fused.upload_patch(args, w)
    ms, times = tm.time_sets("patch_world", [(None, up.args)] * tm.reps)
    dig = digest(*(w.spare[n] for n in fused.PATCH_ROWS), *(w.t[n] for n, _ in fused.PATCH_FULL))
    plain = fused.patch_world_plain(prev, up)
    for name in fused.PATCH_ROWS:
        got = w.spare[name]
        if not torch.equal(got.view(torch.int32) if got.is_floating_point() else got,
                           plain[name].view(torch.int32) if got.is_floating_point() else plain[name]):
            raise AssertionError(f"patch_world: {name} != plain")

    def swap():
        for name in fused.PATCH_ROWS:
            w.t[name], w.spare[name] = w.spare[name], w.t[name]

    def wrapped():
        fused.patch_world(w, fused.upload_patch(args, w))
        swap()

    def launch_only():
        fused.patch_world(w, up)
        swap()

    steps = {"upload": lambda: fused.upload_patch(args, w), "launch_and_swap": launch_only,
             "pinned_alloc": lambda: torch.empty((up.nbytes,), dtype=torch.uint8, pin_memory=True)}
    if hasattr(fused, "_stack_rows") and not hasattr(fused, "patch_plan"):
        steps["pack_stack_rows"] = lambda: fused._stack_rows(args, w.lanes)  # the host pack of the shipped rows
    if hasattr(fused, "patch_plan"):
        steps["plan"] = lambda: fused.patch_plan(args.gather_idx, args.use_fresh, args.fresh_sel)
    use = args.use_fresh
    extra = {"batch_ms": tm.batch_ms("patch_world", up.args),
             "rows": int(use.shape[0]), "fresh_rows": int(use.sum()), "survivors": int((~use).sum()),
             "stack_rows": int(args.requests.shape[0]), "h2d_bytes": up.nbytes,
             "wrapper_ms": tm.host_ms(wrapped, 11), "steps_ms": {k: tm.host_ms(f, 11) for k, f in steps.items()},
             "wrapper_ops": tm.wrapper_ops(wrapped), "launch_floor_ms": tm.launch_floor()}
    for key in ("NP", "NF", "FC"):
        if hasattr(up.args, key):
            extra[key] = getattr(up.args, key)
    tm.emit("patch_world churn last cycle", ms, times, dig, extra)


def time_lane_scores(tm: Timer, inputs) -> None:
    """Phase 7's scorer over 10,240 rows with the committed head and a
    64-unit tanh head: the kernel alone, the wrapper (with the solve's
    tables where the tree takes them) and its argument build, the scores
    against the plain version's."""
    import numpy as np

    from karpenter_tpu_torch.ops import ffd_sweeps as FS
    from karpenter_tpu_torch.ops import policy as POL

    prob, committed = inputs["lane_scores"]
    kw = {"tables": FS.problem_tensors(prob)} if _takes(POL.lane_scores_args, "tables") else {}
    rng = np.random.default_rng(64)
    mlp = ("mlp", tuple(float(x) for x in rng.normal(size=64)), float(rng.normal()),
           (tuple(tuple(float(x) for x in rng.normal(size=POL.N_LANE_FEATURES)) for _ in range(64)),
            tuple(float(x) for x in rng.normal(size=64))))
    for name, head in (("committed", committed), ("mlp64", mlp)):
        sets = [POL.lane_scores_args(prob, head, **kw) for _ in range(tm.reps)]
        ms, times = tm.time_sets("lane_scores", sets)
        digs = {digest(t["scores"]) for t, _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"lane_scores {name}: launches differ")
        err = float((sets[0][0]["scores"] - POL.lane_scores_plain(prob, head)).abs().max())
        steps = {"args": lambda: POL.lane_scores_args(prob, head, **kw)}
        if hasattr(POL, "pack_weights"):
            steps["pack_weights"] = lambda: POL.pack_weights(head, tm.dev)
        extra = {"batch_ms": tm.batch_ms("lane_scores", sets[0][1]), "rows": prob.num_pods, "max_abs_err": err,
                 "wrapper_ms": tm.host_ms(lambda: POL.lane_scores(prob, head, **kw), 11),
                 "steps_ms": {k: tm.host_ms(f, 11) for k, f in steps.items()},
                 "wrapper_ops": tm.wrapper_ops(lambda: POL.lane_scores(prob, head, **kw)),
                 "launch_floor_ms": tm.launch_floor(), "with_tables": bool(kw)}
        tm.emit(f"lane_scores 10k {name}", ms, times, digs.pop(), extra)


# kernel -> (the input groups it needs, its timing)
KERNELS = {
    "relax_place": (("solved", "fleet"), time_relax_place),
    "runs_screen": (("screens", "stacked"), time_runs_screen),
    "ffd_loop": (("solved",), time_ffd_loop),
    "gate_counts": (("gates",), time_gate_counts),
    "attribute": (("explain",), time_attribute),
    "patch_world": (("patch",), time_patch_world),
    "lane_scores": (("policy",), time_lane_scores),
}


def time_tree(root: Path, inputs_dir: Path, tag: str, names, reps: int, sweep: bool = False) -> list:
    sys.path.insert(0, str(root))
    import torch

    from karpenter_tpu_torch import kernels

    assert Path(kernels.__file__).resolve().is_relative_to(root.resolve()), kernels.__file__
    t0 = time.perf_counter()
    kernels.build(list(names))
    build_s = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in (kernels.BUILD_DIR / f"{name}.log").read_text(errors="replace")
                    .splitlines() if "registers" in line or "spill" in line] for name in names}
    inputs = torch.load(inputs_dir / "inputs.pt", weights_only=False)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"kind": "head", "tag": tag, "root": str(root), "card": gpu, "build_s": build_s,
                      "ptxas": ptxas}), flush=True)
    tm = Timer(tag, reps, sweep)
    for name in names:  # the kernels ``make`` was given
        KERNELS[name][1](tm, inputs)
    return tm.rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def kernel_list(text):
        names = [x for x in text.split(",") if x]
        bad = [x for x in names if x not in KERNELS]
        if bad:
            raise argparse.ArgumentTypeError(f"unknown kernels {bad}; known: {list(KERNELS)}")
        return names

    m = sub.add_parser("make")
    m.add_argument("--out", type=Path, required=True)
    m.add_argument("--kernels", type=kernel_list, default=list(KERNELS))
    m.add_argument("--small", action="store_true", help="toy sizes on the CPU (a rehearsal of this step)")
    t = sub.add_parser("time")
    t.add_argument("--root", type=Path, required=True)
    t.add_argument("--inputs", type=Path, required=True)
    t.add_argument("--tag", required=True)
    t.add_argument("--kernels", type=kernel_list, default=list(KERNELS))
    t.add_argument("--reps", type=int, default=7)
    t.add_argument("--sweep", action="store_true", help="also every cluster size, screen layout and row plan")
    args = ap.parse_args()
    if args.cmd == "make":
        make(args.out, args.kernels, args.small)
    else:
        time_tree(args.root, args.inputs, args.tag, args.kernels, args.reps, args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
