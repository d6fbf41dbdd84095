"""Print the scheduled-set comparison of chip_smoke.py's phase-8 fleet through
one package: the partitioned solve (``chip_smoke.SHARD_ENV``: 8 partitions)
against the unsharded FFD control (relax off).

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/fleet_parity.py --package jax [--pods N]
    python tools/fleet_parity.py --package torch [--device cuda] [--pods N]

``--package jax`` runs the JAX package's ``JaxSolver`` over ``bench.
make_fleet_pods`` (the control under ``KARPENTER_TPU_RELAX=0``);
``--package torch`` runs the port's ``TorchSolver`` over
``testing/workloads.fleet_workload`` (the same pods), on the card unless
given ``--device cpu``, its control starting at the claim bucket of the
sharded result, as phase 8 runs it. At the default ``SHARD_PODS`` the JAX
line is chip_smoke.py's ``EXPECT_FLEET``. Prints one JSON line: both solves'
scheduled counts, the control's pods the sharded solve does not place
(``lost``), the count it places beyond them (``gained``), and how many of
either carry no required pod affinity.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--pods", type=int, default=chip_smoke.SHARD_PODS)
    ap.add_argument("--device", default="cuda", help="the port's device (default cuda)")
    args = ap.parse_args(argv)

    os.environ["KARPENTER_TPU_EXPLAIN"] = "0"
    if args.package == "jax":
        from bench import make_fleet_pods

        pkg = "karpenter_tpu"
        objs = importlib.import_module(f"{pkg}.apis.objects")
        nodepool = importlib.import_module(f"{pkg}.apis.nodepool")
        fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
        encode = importlib.import_module(f"{pkg}.solver.encode")
        Solver = importlib.import_module(f"{pkg}.solver.jax_backend").JaxSolver
        its = fake.instance_types(400)
        tpl = encode.template_from_nodepool(nodepool.NodePool(metadata=objs.ObjectMeta(name="default")), its,
                                            range(len(its)))
        pods = make_fleet_pods(args.pods, random.Random(42), neighborhoods=chip_smoke.SHARD_NEIGHBORHOODS)
        workload = (pods, its, [tpl], [])

        def sharded():
            return Solver()

        def control(_claims):
            os.environ["KARPENTER_TPU_RELAX"] = "0"
            return Solver()
    else:
        from karpenter_tpu_torch import kernels
        from karpenter_tpu_torch.ops.padding import claim_axis_bucket
        from karpenter_tpu_torch.solver.torch_backend import TorchSolver
        from karpenter_tpu_torch.testing import workloads as W

        if args.device != "cpu":
            kernels.build()
        workload = W.fleet_workload(args.pods, 400, seed=42, neighborhoods=chip_smoke.SHARD_NEIGHBORHOODS)

        def sharded():
            return TorchSolver(device=args.device)

        def control(claims):
            return TorchSolver(device=args.device, relax=False, initial_claim_slots=claim_axis_bucket(claims))

    def placed(r):
        return {i for c in r.new_claims for i in c.pod_indices} | {i for v in r.node_pods.values() for i in v}

    def affinity(i):
        a = workload[0][i].spec.affinity
        return a is not None and a.pod_affinity is not None and bool(a.pod_affinity.required)

    os.environ.update(chip_smoke.SHARD_ENV)
    t0 = time.perf_counter()
    solver = sharded()
    result = solver.solve(*workload)
    sharded_s = time.perf_counter() - t0
    for name in chip_smoke.SHARD_ENV:
        if name != "KARPENTER_TPU_EXPLAIN":
            os.environ.pop(name)
    t0 = time.perf_counter()
    cres = control(len(result.new_claims)).solve(*workload)
    control_s = time.perf_counter() - t0
    lost, gained = placed(cres) - placed(result), placed(result) - placed(cres)
    print(json.dumps({
        "package": args.package, "pods": args.pods, "shard_reason": (solver.last_shard or {}).get("reason"),
        "scheduled": result.num_scheduled(), "control": cres.num_scheduled(), "lost": sorted(lost),
        "gained": len(gained), "without_affinity": sum(not affinity(i) for i in lost | gained),
        "sharded_s": round(sharded_s, 1), "control_s": round(control_s, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
