"""Print the digest of chip_smoke.py's phase-12 operator scenario through one
package on this host's CPU.

    JAX_PLATFORMS=cpu python tools/operator_digest.py --package jax [--pods N]
    python tools/operator_digest.py --package torch [--pods N]

``--package jax`` runs the JAX package's ``Operator(Options(solver_backend=
"jax"))`` (makeDiversePods from bench.py); ``--package torch`` runs the
port's ``Operator(Options(solver_device="cpu"))`` (the plain PyTorch path),
or with ``--device cuda`` its kernels on the card (built first, outside the
timed run; the kernels' launch counts are printed).
Both call ``chip_smoke.operator_scenario``; at the default ``OPERATOR_PODS`` the JAX
digest is chip_smoke.py's ``EXPECT_OPERATOR``. Prints the digest and the
stage walls as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return 0.0


def main(argv=None) -> int:
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--pods", type=int, default=chip_smoke.OPERATOR_PODS)
    ap.add_argument("--types", type=int, default=chip_smoke.OPERATOR_TYPES)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu", help="the port's solver device")
    ap.add_argument("--progress", action="store_true", help="print each stage and round as it ends")
    ap.add_argument("--max-rss-gb", type=float, default=0.0,
                    help="exit with code 3 once the process holds more host memory than this (0: no limit)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    hooks = {}
    if args.progress:
        import contextlib

        @contextlib.contextmanager
        def stage(name):
            print(f"[{time.perf_counter() - t_start:8.1f}s] {name} ...", flush=True)
            yield
            print(f"[{time.perf_counter() - t_start:8.1f}s] {name} done, rss {_rss_gb():.2f} GB", flush=True)

        def round_(name, n, claims, commands):
            print(f"[{time.perf_counter() - t_start:8.1f}s]   {name} round {n}: {claims} claims, {commands} commands",
                  flush=True)

        hooks = {"stage": stage, "round": round_}
    if args.max_rss_gb > 0:
        import os
        import threading

        def guard():
            while True:
                if _rss_gb() > args.max_rss_gb:
                    print(f"host memory above {args.max_rss_gb} GB: exiting", flush=True)
                    os._exit(3)
                time.sleep(1.0)

        threading.Thread(target=guard, daemon=True).start()
    launches = None
    if args.package == "jax":
        from bench import make_diverse_pods

        pkg, options = "karpenter_tpu", {"solver_backend": "jax"}
    else:
        from karpenter_tpu_torch.testing.workloads import make_diverse_pods

        from karpenter_tpu_torch import kernels

        pkg, options = "karpenter_tpu_torch", {"solver_device": args.device}
        if args.device == "cuda":
            kernels.build()
        launches = kernels.LAUNCHES
        kernels.reset_launches()
    t0 = time.perf_counter()
    digest, record, op = chip_smoke.operator_scenario(pkg, options, make_diverse_pods, n_pods=args.pods,
                                                      n_types=args.types, hooks=hooks)
    print(json.dumps({"package": pkg, "pods": args.pods, "types": args.types, "digest": digest,
                      "record": record, "supervisor": dict(op.supervisor.counters),
                      "wall_s": time.perf_counter() - t0, "launches": launches}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
