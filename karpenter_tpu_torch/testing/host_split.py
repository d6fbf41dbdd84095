"""Host-side cost of the resident churn cycle's encode, on the CPU.

    python -m karpenter_tpu_torch.testing.host_split [--pods 10000] [--profile]

Builds ``chip_smoke.py``'s churn batch (``default_pod_factory`` pods from
``random.Random(21)``, ``instance_types(400)``, one NodePool, 64 claim
slots), steps the churn process (2% arrivals and 2% deletes a cycle) and
prints, for three cycles, the wall ms of the delta encode's patch
(``streaming/delta.DeltaEncoder``) beside a cold ``Encoder.encode`` of the
same snapshot, and with ``--profile`` the functions that dominate one
patched encode (cProfile, cumulative). Host timings only: nothing here
touches a GPU.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import random
import time


def main(argv=None) -> int:
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import ObjectMeta
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver.encode import Encoder, template_from_nodepool
    from karpenter_tpu_torch.streaming.churn import ChurnConfig, ChurnProcess, default_pod_factory
    from karpenter_tpu_torch.streaming.delta import DeltaEncoder

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pods", type=int, default=10000)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    its = instance_types(400)
    tpls = [template_from_nodepool(NodePool(metadata=ObjectMeta(name="d")), its, range(len(its)))]
    rng = random.Random(21)
    rate = args.pods * 2 // 100
    proc = ChurnProcess([default_pod_factory(f"dw-{i}", rng) for i in range(args.pods)],
                        config=ChurnConfig(seed=21, arrivals_per_cycle=rate, deletes_per_cycle=rate))
    enc = DeltaEncoder()
    enc.encode(proc.pods, its, tpls, num_claim_slots=args.slots)
    for cycle in range(1, 4):
        proc.step()
        t0 = time.perf_counter()
        if args.profile and cycle == 3:
            prof = cProfile.Profile()
            prof.enable()
        enc.encode(proc.pods, its, tpls, num_claim_slots=args.slots)
        if args.profile and cycle == 3:
            prof.disable()
        patched_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        Encoder().encode(proc.pods, its, tpls, num_claim_slots=args.slots)
        cold_ms = (time.perf_counter() - t0) * 1e3
        print(f"cycle {cycle}: delta encode {patched_ms:.1f} ms ({enc.last_patch['mode']}, "
              f"{enc.last_patch['fresh_rows']} fresh rows), cold encode {cold_ms:.1f} ms", flush=True)
    if args.profile:
        pstats.Stats(prof).sort_stats("cumulative").print_stats(12)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
