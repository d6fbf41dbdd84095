"""Restart-storm harness: SIGKILL a solving process mid-cycle, over and over.

Counterpart of the JAX package's ``testing/restart.py``. The child half
drives a ``StreamingSolver`` through seeded churn in a real subprocess with a
``proc.crash`` fault scheduled (testing/faults.py: ``os.kill(SIGKILL)`` at
the N-th crash-point visit), and the parent half relaunches it after every
kill, varying N so deaths land at every phase boundary of the journal path:
cycle entry, before the journal write, between the temporary write and the
rename (utils/persist.py), and after the rename.

The churn stream is a pure function of (seed, cycle#), so a relaunched child
replays the churn frontier up to the last completed cycle without solving,
restores the journal (``StreamingSolver.__init__``) and goes on solving.
Whatever phase the kill hit, the journal holds the last accepted cycle's
state, so the re-solve of the interrupted cycle runs against the state the
never-crashed control run used, and a deterministic inner solve of the same
inputs gives the same output. The parent asserts that every cycle's
placements digest, re-solved ones included, equals the control's, that every
pod is accounted exactly once, and that every restore outcome is classified.

The child's inner backend is ``--backend oracle`` (the default, as in the JAX
harness, so its digests can be held to the JAX package's control) or
``--backend torch`` (``TorchSolver`` on ``--device``, CUDA by default).

Child protocol (stdout, line-oriented):

    RESTORE <outcome>            journal restore classification at startup
    CYCLE <idx> <digest> <pods> acct=ok|FAIL
    DONE

Run a child directly: ``python -m karpenter_tpu_torch.testing.restart
--backend torch --device cpu --cycles 4``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional


def stable_pod_factory(name: str, rng: random.Random):
    """churn.default_pod_factory with a deterministic uid: a relaunched
    process replaying the churn frontier must rebuild pods whose identity
    digests match the journal, as real uids (assigned once by the API
    server) do and fresh uuid4s do not."""
    from karpenter_tpu_torch.streaming.churn import default_pod_factory

    p = default_pod_factory(name, rng)
    p.metadata.uid = f"uid-{name}"
    return p


def base_problem(pod_count: int, its_count: int):
    """The deterministic base world shared by the children and the
    in-process control run."""
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver.encode import template_from_nodepool

    its = instance_types(its_count)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="restart")), its, range(len(its)))
    rng = random.Random(97)
    pods = [stable_pod_factory(f"base-{i}", rng) for i in range(pod_count)]
    return pods, its, [tpl]


def result_digest(result) -> str:
    """Stable placements digest (the parity token printed per cycle)."""
    key = (
        tuple(
            (c.template_index, tuple(c.pod_indices), tuple(c.instance_type_indices))
            for c in result.new_claims
        ),
        tuple(sorted((k, tuple(v)) for k, v in result.node_pods.items())),
        tuple(sorted(result.failures.items())),
    )
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


def accounted(result, n_pods: int) -> bool:
    """Zero dropped, zero duplicated: every pod index appears exactly once
    across node placements, new claims and failures."""
    seen: List[int] = []
    for idxs in result.node_pods.values():
        seen.extend(idxs)
    for c in result.new_claims:
        seen.extend(c.pod_indices)
    seen.extend(result.failures)
    return sorted(seen) == list(range(n_pods))


def _churn(pods, seed: int, arrivals: int, deletes: int):
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess

    return ChurnProcess(
        pods, [], pod_factory=stable_pod_factory,
        config=ChurnConfig(seed=seed, arrivals_per_cycle=arrivals, deletes_per_cycle=deletes),
    )


def inner_backend(backend: str = "oracle", device: Optional[str] = None):
    """The streaming layer's inner solve: ``OracleSolver`` or ``TorchSolver``
    on ``device`` (CUDA when None)."""
    if backend == "oracle":
        from karpenter_tpu_torch.solver.oracle import OracleSolver

        return OracleSolver()
    if backend == "torch":
        from karpenter_tpu_torch.solver.torch_backend import TorchSolver

        return TorchSolver(device=device or "cuda")
    raise ValueError(f"unknown backend {backend!r}")


def child_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pods", type=int, default=40)
    ap.add_argument("--its", type=int, default=3)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--arrivals", type=int, default=3)
    ap.add_argument("--deletes", type=int, default=2)
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--start-cycle", type=int, default=0,
                    help="churn cycles already completed: replayed, not solved")
    ap.add_argument("--backend", choices=("oracle", "torch"), default="oracle")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="TorchSolver's device (--backend torch; default cuda)")
    args = ap.parse_args(argv)

    from karpenter_tpu_torch.streaming.warm import StreamingSolver

    pods, its, tpls = base_problem(args.pods, args.its)
    proc = _churn(pods, args.seed, args.arrivals, args.deletes)
    # replay the frontier: churn is (seed, cycle#)-deterministic, so stepping
    # without solving rebuilds the dead process's pod state
    for _ in range(args.start_cycle):
        proc.step()

    solver = StreamingSolver(inner_backend(args.backend, args.device))
    print(f"RESTORE {solver.last_restore_outcome or 'disabled'}", flush=True)
    for cycle in range(args.start_cycle, args.cycles):
        proc.step()
        result = solver.solve(proc.pods, its, tpls, nodes=proc.nodes)
        ok = accounted(result, len(proc.pods))
        print(
            f"CYCLE {cycle} {result_digest(result)} {len(proc.pods)} acct={'ok' if ok else 'FAIL'}",
            flush=True,
        )
        if not ok:
            return 3
    print("DONE", flush=True)
    return 0


# -- parent: the storm ---------------------------------------------------------

# crash-point visit numbers the storm rotates through. With the journal on,
# each cycle visits 4 proc sites (cycle.enter, journal.pre-write,
# persist.pre-rename, journal.post-write), so 2/3/4 die at each phase of the
# child's first cycle and 5/6 let one cycle complete before dying in the
# second: every phase boundary gets hit, and most children make progress.
KILL_SCHEDULE = (2, 5, 3, 6, 4, 7, 1, 8)


def run_restart_storm(
    pod_count: int = 40,
    its_count: int = 3,
    cycles: int = 8,
    kills: int = 5,
    seed: int = 5,
    arrivals: int = 3,
    deletes: int = 2,
    state_dir: Optional[str] = None,
    max_children: int = 40,
    backend: str = "oracle",
    device: Optional[str] = None,
) -> Dict[str, object]:
    """Kill a churn-solving child ``kills`` times mid-cycle, relaunching with
    frontier replay after each death, then let it finish clean. Returns the
    summary (keys below, ``control`` the control run's digests); raises
    nothing: callers gate on ``ok``."""
    t0 = time.perf_counter()
    from karpenter_tpu_torch.streaming import snapshot
    from karpenter_tpu_torch.streaming.warm import StreamingSolver

    # control: the never-crashed run, in-process, journal off
    pods, its, tpls = base_problem(pod_count, its_count)
    proc = _churn(pods, seed, arrivals, deletes)
    solver = StreamingSolver(inner_backend(backend, device))
    control: List[str] = []
    for _ in range(cycles):
        proc.step()
        result = solver.solve(proc.pods, its, tpls, nodes=proc.nodes)
        if not accounted(result, len(proc.pods)):
            return {"ok": False, "error": "control run dropped pods"}
        control.append(result_digest(result))

    owned_dir = state_dir is None
    if owned_dir:
        state_dir = tempfile.mkdtemp(prefix="ktpu-restart-storm-")
    env = dict(os.environ)
    env["KARPENTER_TPU_STATE_DIR"] = state_dir
    env.pop("KARPENTER_TPU_FAULTS", None)
    # -m karpenter_tpu_torch.testing.restart must resolve from any cwd
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH")
    env["PYTHONPATH"] = pkg_parent + os.pathsep + existing if existing else pkg_parent

    base_cmd = [
        sys.executable, "-m", "karpenter_tpu_torch.testing.restart",
        "--pods", str(pod_count), "--its", str(its_count),
        "--seed", str(seed), "--arrivals", str(arrivals),
        "--deletes", str(deletes), "--cycles", str(cycles),
        "--backend", backend,
    ] + (["--device", device] if device else [])

    completed = 0
    killed = 0
    children = 0
    digests: Dict[int, List[str]] = {}
    restores: List[str] = []
    acct_ok = True
    error = None

    while completed < cycles and children < max_children:
        child_env = dict(env)
        scheduled_kill = killed < kills
        if scheduled_kill:
            visit = KILL_SCHEDULE[killed % len(KILL_SCHEDULE)]
            child_env["KARPENTER_TPU_FAULTS"] = f"proc.crash@{visit}"
        children += 1
        run = subprocess.run(
            base_cmd + ["--start-cycle", str(completed)],
            env=child_env, capture_output=True, text=True, timeout=600,
        )
        for line in run.stdout.splitlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "RESTORE":
                restores.append(parts[1])
            elif parts[0] == "CYCLE":
                idx = int(parts[1])
                digests.setdefault(idx, []).append(parts[2])
                completed = max(completed, idx + 1)
                if parts[4] != "acct=ok":
                    acct_ok = False
        if scheduled_kill and run.returncode == -9:
            killed += 1
        elif run.returncode not in (0, -9):
            error = f"child exited {run.returncode}: {run.stderr.strip().splitlines()[-1:] or run.stdout[-200:]}"
            break

    parity_ok = completed >= cycles and all(
        d == control[idx] for idx, ds in digests.items() for d in ds
    )
    classified = all(r in snapshot.OUTCOMES or r == "disabled" for r in restores)
    ok = error is None and completed >= cycles and killed >= kills and parity_ok and acct_ok and classified
    if owned_dir:
        import shutil

        shutil.rmtree(state_dir, ignore_errors=True)
    return {
        "ok": ok,
        "error": error,
        "cycles": completed,
        "kills": killed,
        "children": children,
        "parity_ok": parity_ok,
        "acct_ok": acct_ok,
        "restores": restores,
        "restores_classified": classified,
        "control": control,
        "seconds": time.perf_counter() - t0,
    }


if __name__ == "__main__":
    sys.exit(child_main())
