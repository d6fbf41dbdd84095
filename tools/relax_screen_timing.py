"""Time ``relax_place``, ``runs_screen`` and ``ffd_loop`` on the card at the
main path's shapes, for one tree of the port, so that two trees (a parent
commit and a change) are timed on the same card in one call.

    python tools/relax_screen_timing.py make --out DIR
    python tools/relax_screen_timing.py time --root TREE --inputs DIR --tag NAME [--out FILE]

``make`` builds the inputs with this checkout's package, at the shapes
``chip_smoke.py`` times (its constants): the 10,000-pod diverse batch of
phase 2 (``relax_place``'s waterfill and convex mode, ``ffd_loop`` carried,
fresh and one-pass over 2,500 rows), the 10,000-pod homogeneous bulk of
phase 7 (convex), the 100,000-pod fleet's eight partitions of phase 8
(convex lanes), the consolidation screen's residual, full and full-topology
launches of phase 3, and the serve layer's stacked narrow and wide launches
of phase 5. It saves them under DIR with ``torch.save``.

``time`` imports ``karpenter_tpu_torch`` from TREE, builds each launch's
argument sets with that tree's own functions, times the launches with CUDA
events (the median of several, each on a fresh set), and prints one JSON line
per shape: the times, a digest of every output (verdicts, state, stats: two
trees that compute the same function print the same digest), and, where the
tree's kernels count them, the section split (each section's share of the
leader's cycles times the median). ``ffd_loop`` runs at 16 blocks where the
tree has ``forced_cluster``. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
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

def make(out: Path, small: bool = False) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as CS
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.disruption import batch as dbatch
    from karpenter_tpu_torch.ops import relax2 as R2
    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
    from karpenter_tpu_torch.parallel import mesh as M
    from karpenter_tpu_torch.serve import batch as xbatch
    from karpenter_tpu_torch.serve.dispatcher import Ticket, _Request
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver
    from karpenter_tpu_torch.streaming.churn import default_pod_factory
    from karpenter_tpu_torch.testing import workloads as W

    if not small and not torch.cuda.is_available():
        raise SystemExit("relax_screen_timing: no CUDA device")
    dev = torch.device("cpu" if small else "cuda")
    # --small: a rehearsal of this step on the CPU at toy sizes
    main_pods, fleet_pods = (300, 2000) if small else (CS.MAIN_PODS, CS.SHARD_PODS)
    candidates, wide_pods = (24, 60) if small else (CS.SCREEN_CANDIDATES, CS.WIDE_PODS)
    out.mkdir(parents=True, exist_ok=True)
    if not small:
        from karpenter_tpu_torch import kernels

        kernels.build()  # one nvcc per source, all at once
    for name in CS.FLAG_ENV:
        os.environ.pop(name, None)
    inputs = {}

    def solved_problem(workload, n):
        solver = TorchSolver(initial_claim_slots=128, device=dev, relax=False)
        result = solver.solve(*workload)
        ctx = result.verify_ctx
        prob = ctx.device_problem
        active = torch.arange(prob.num_pods, device=dev) < n
        return _pad_lanes_mult32(dataclasses.replace(prob, pod_active=active)), ctx.max_claims

    t0 = time.perf_counter()
    inputs["diverse"] = solved_problem(W.diverse_workload(main_pods, 400, seed=42), main_pods)
    inputs["homogeneous"] = solved_problem(W.homogeneous_workload(main_pods, 400), main_pods)
    inputs["convex"] = (R2.pgd_iters(), R2.pgd_step())
    log(f"make: 10k problems {time.perf_counter() - t0:.1f}s")

    # the fleet's partitions as the RELAX2 sharded solve dispatches them
    t0 = time.perf_counter()
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
        TorchSolver(device=dev).solve(*W.fleet_workload(fleet_pods, 400, seed=42,
                                                        neighborhoods=CS.SHARD_NEIGHBORHOODS))
    finally:
        M.shard_relax2_sweeps = orig
        for name in env:
            os.environ.pop(name, None)
    batch2, C2, iters2, step2 = seen[-1][:4]
    inputs["fleet"] = ([_pad_lanes_mult32(p) for p in M._shard_lanes(batch2)], C2, (iters2, step2))
    log(f"make: fleet lanes {time.perf_counter() - t0:.1f}s")

    # the consolidation screen's three launches
    t0 = time.perf_counter()
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
    inputs["screens"] = screens
    log(f"make: screens {time.perf_counter() - t0:.1f}s")

    # the serve layer's stacked launches
    t0 = time.perf_counter()
    stacked = {}
    for tag, n_pods, n_its in (("narrow", CS.SERVE_PODS, CS.SERVE_ITS), ("wide", wide_pods, CS.WIDE_ITS)):
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
    inputs["stacked"] = stacked
    log(f"make: stacked {time.perf_counter() - t0:.1f}s")
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


def time_tree(root: Path, inputs_dir: Path, tag: str, reps: int, sweep: bool = False) -> list:
    sys.path.insert(0, str(root))
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.problem import numpy_fields
    from karpenter_tpu_torch.ops import ffd_sweeps as FS
    from karpenter_tpu_torch.ops import relax as RX
    from karpenter_tpu_torch.ops.ffd_core import _lane_align, initial_state
    from karpenter_tpu_torch.parallel import mesh as M

    assert Path(kernels.__file__).resolve().is_relative_to(root.resolve()), kernels.__file__
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.build(["relax_place", "runs_screen", "ffd_loop"])
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in ("relax_place", "runs_screen", "ffd_loop"):
        ptxas[name] = [line.strip() for line in (kernels.BUILD_DIR / f"{name}.log").read_text(errors="replace")
                       .splitlines() if "registers" in line or "spill" in line]
    inputs = torch.load(inputs_dir / "inputs.pt", weights_only=False)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    head = {"tag": tag, "root": str(root), "card": gpu, "build_s": build_s, "ptxas": ptxas}
    print(json.dumps({"kind": "head", **head}), flush=True)

    def time_sets(name, sets, counter=None):
        times = []
        for _, args in sets:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kernels.launch(name, args, stream, counter=counter)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def split(sections, names, ms):
        cyc = [int(x) for x in sections]
        total = sum(cyc) or 1
        return {n: round(c / total * ms, 4) for n, c in zip(names, cyc) if c}

    def emit(shape, ms, times, dig, extra=None):
        row = {"kind": "shape", "tag": tag, "shape": shape, "ms": ms, "times": [round(x, 4) for x in times],
               "digest": dig, **(extra or {})}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def state_digest(t, names):
        return digest(*(t.get(n) for n in names))

    rx_out = ("kind", "index", "residue", "stats") + RX.RELAX_STATE
    has_rx_sections = "sections" in RX._RELAX_POINTERS

    def rx_sections(ts, ms):
        if not has_rx_sections:
            return None
        total = torch.stack([t["sections"] for t in ts]).sum(0).cpu()
        return split(total, RX.SECTIONS, ms)

    def relax_single(shape, prob, C, convex):
        if sweep and "plan" in RX._RELAX_POINTERS:
            for cl in SWEEP_CLUSTERS:
                with FS.forced_cluster(cl):
                    csets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C, convex) for _ in range(3))]
                ms, times = time_sets("relax_place", csets)
                emit(f"{shape} @{cl}", ms, times, state_digest(csets[0][0], rx_out),
                     {"sections": rx_sections([csets[0][0]], ms)})
        sets = [(t, a) for t, _, a in (RX.relax_place_args(prob, C, convex) for _ in range(reps))]
        ms, times = time_sets("relax_place", sets)
        digs = {state_digest(t, rx_out) for t, _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"{shape}: launches differ")
        t = sets[0][0]
        emit(shape, ms, times, digs.pop(), {"sections": rx_sections([t], ms),
                                            "plan": t["plan"].cpu().tolist() if "plan" in t else None})
        return sets[0][0]

    def relax_lanes(shape, probs, C, convex):
        sets = []
        for _ in range(reps):
            lanes, buf, args = RX.relax_place_lanes_args(probs, C, convex)
            sets.append(((lanes, buf), args))
        ms, times = time_sets("relax2_place_lanes", sets)
        digs = {digest(*(state_digest(t, rx_out) for t, _ in lanes)) for (lanes, _), _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"{shape}: launches differ")
        lanes = sets[0][0][0]
        sec = None
        if has_rx_sections:
            # the slowest lane's split (the launch waits for it)
            per = [int(t["sections"].sum()) for t, _ in lanes]
            sec = rx_sections([lanes[per.index(max(per))][0]], ms)
        emit(shape, ms, times, digs.pop(), {"sections": sec, "lanes": len(probs),
                                            "lane_digests": [state_digest(t, rx_out) for t, _ in lanes]})

    prob, C = inputs["diverse"]
    hprob, hC = inputs["homogeneous"]
    convex = tuple(inputs["convex"])
    relax_single("relax waterfill 10k", prob, C, None)
    relax_single("relax convex diverse 10k", prob, C, convex)
    relax_single("relax convex homogeneous 10k", hprob, hC, convex)
    relax_lanes("relax waterfill one lane 10k", [prob], C, None)
    fprobs, fC, fconvex = inputs["fleet"]
    relax_lanes("relax convex lanes fleet 8x", fprobs, fC, tuple(fconvex))
    deep = max(range(len(fprobs)), key=lambda b: int(fprobs[b].pod_active.sum()))
    relax_lanes(f"relax convex one lane fleet lane {deep}", [fprobs[deep]], fC, tuple(fconvex))
    relax_single(f"relax convex single fleet lane {deep}", fprobs[deep], fC, tuple(fconvex))

    # runs_screen
    rs_out = ("kind", "index") + tuple(M.RS_STATE)
    has_rs_sections = hasattr(M, "RS_SECTIONS")

    def screen(shape, make_args):
        if sweep and hasattr(M, "forced_screen_plan"):
            for layout, cl in SWEEP_LAYOUTS:
                with M.forced_screen_plan(layout, cl):
                    lsets = [make_args() for _ in range(3)]
                ms, times = time_sets("runs_screen", lsets)
                lt = lsets[0][0]
                slow = int(lt["sections"].sum(1).argmax())
                emit(f"{shape} @{layout}{cl}", ms, times, state_digest(lt, rs_out),
                     {"sections": {"slowest_lane": slow, "split": split(lt["sections"][slow].cpu(), M.RS_SECTIONS, ms)}})
        sets = [make_args() for _ in range(reps)]
        ms, times = time_sets("runs_screen", sets)
        digs = {state_digest(t, rs_out) for t, _ in sets}
        if len(digs) != 1:
            raise AssertionError(f"{shape}: launches differ")
        t = sets[0][0]
        sec = None
        if has_rs_sections:
            per = t["sections"].sum(1)
            slow = int(per.argmax())
            cyc = sorted(int(x) for x in per.cpu())
            sec = {"slowest_lane": slow, "split": split(t["sections"][slow].cpu(), M.RS_SECTIONS, ms),
                   "lanes_summed": split(t["sections"].sum(0).cpu(), M.RS_SECTIONS, ms),
                   "lane_cycles": {"max": cyc[-1], "p90": cyc[len(cyc) * 9 // 10], "median": cyc[len(cyc) // 2],
                                   "min": cyc[0], "sum": sum(cyc)}}
        emit(shape, ms, times, digs.pop(), {"sections": sec, "lanes": int(t["kind"].shape[0]),
                                            "plan": t["plan"].cpu().tolist() if "plan" in t else None})

    from karpenter_tpu_torch.ops.ffd_core import _pad_lanes_mult32
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

    # ffd_loop at 16 blocks: carried from the waterfill, fresh, one-pass
    forced = getattr(FS, "forced_cluster", None)
    rxo = RX.relax_place(prob, C)
    kind0, index0 = rxo.kind, rxo.index
    residue, astate = _lane_align(dataclasses.replace(prob, pod_active=rxo.residue_active), rxo.state)
    op_prob = dataclasses.replace(prob, pod_active=prob.pod_active & (
        torch.arange(prob.pod_active.shape[0], device=dev) < 2500))
    loops = {
        "ffd_loop carried 10k": lambda: FS.ffd_loop_args(residue, astate, False, kind0, index0),
        "ffd_loop fresh 10k": lambda: FS.ffd_loop_args(prob, initial_state(prob, C), False),
        "ffd_loop one-pass 2500": lambda: FS.ffd_loop_args(op_prob, initial_state(op_prob, C), True),
    }
    for shape, fn in loops.items():
        with forced(16) if forced else contextlib.nullcontext():
            sets = [fn() for _ in range(3)]
        ms, times = time_sets("ffd_loop", sets)
        t = sets[0][0]
        dig = digest(t["kind"], t["index"], *(t[n] for n in FS.FFD_STATE if n in t))
        emit(shape, ms, times, dig, {"plan": t["plan"].cpu().tolist() if "plan" in t else None})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("make")
    m.add_argument("--out", type=Path, required=True)
    m.add_argument("--small", action="store_true", help="toy sizes on the CPU (a rehearsal of this step)")
    t = sub.add_parser("time")
    t.add_argument("--root", type=Path, required=True)
    t.add_argument("--inputs", type=Path, required=True)
    t.add_argument("--tag", required=True)
    t.add_argument("--reps", type=int, default=5)
    t.add_argument("--sweep", action="store_true", help="also every cluster size and screen layout the tree has")
    args = ap.parse_args()
    if args.cmd == "make":
        make(args.out, args.small)
    else:
        time_tree(args.root, args.inputs, args.tag, args.reps, args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
