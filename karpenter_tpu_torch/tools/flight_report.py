"""Dev tool: render a flight-recorder capture as a causal timeline.

Counterpart of the JAX system's ``tools/flight_report.py`` over the port.
Reads classified flight events from a framed ``flight-*.bin`` dump (written
by ``karpenter_tpu_torch.obs.flight.snapshot_dump`` on an SLO breach or
classified fault), from a live ``/debug/flight`` endpoint URL, or replays an
incident locally with ``--demo`` (supervised ``TorchSolver`` cycles, then a
gate-audit mismatch), then prints the events chronologically
with per-event offsets and a trace-lineage grouping — which solve cycle the
breach rode in on, what the recorder saw around it:

    flight dump reason=slo-breach objective=gate-integrity events=9
      +0.000s solve-cycle      [t-4f2a..] pods=120 scheduled=118 ...
      ...
      +2.113s slo-breach       [t-9c01..] objective=gate-integrity ...

    python -m karpenter_tpu_torch.tools.flight_report /path/to/flight-....bin
    python -m karpenter_tpu_torch.tools.flight_report http://localhost:8080/debug/flight
    python -m karpenter_tpu_torch.tools.flight_report --demo --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

from karpenter_tpu_torch.obs import flight

_SKIP_KEYS = ("t", "kind", "trace_id")


def _load(source: str) -> dict:
    """A dump body from a framed .bin path or a /debug/flight URL. Both
    normalize to {"events": [...], ...context}."""
    if source.startswith("http://") or source.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(source) as resp:
            payload = json.load(resp)
        payload.setdefault("reason", "live")
        return payload
    return flight.load_dump(source)


def _detail(rec: dict) -> str:
    return " ".join(
        f"{k}={rec[k]}" for k in sorted(rec) if k not in _SKIP_KEYS
    )


def _short_trace(rec: dict) -> str:
    tid = rec.get("trace_id")
    return f"[{str(tid)[:12]}]" if tid else "[-]"


def render(body: dict) -> str:
    """The timeline text for one capture body ({"events": [...], ...})."""
    events = body.get("events") or []
    head = [
        "flight "
        + " ".join(
            f"{k}={body[k]}"
            for k in ("reason", "objective", "pid", "captured_unix")
            if body.get(k) is not None
        )
        + f" events={len(events)}"
    ]
    if not events:
        head.append("  (empty ring — nothing recorded before capture)")
        return "\n".join(head)
    t0 = events[0].get("t", 0.0)
    for rec in events:
        head.append(
            f"  +{rec.get('t', t0) - t0:7.3f}s {rec.get('kind', '?'):<17}"
            f" {_short_trace(rec):<15} {_detail(rec)}"
        )
    # trace lineage: which events share a solve/serve trace — the causal
    # chain a breach belongs to, vs. bystander records in the same window
    lineage: dict = {}
    for rec in events:
        lineage.setdefault(rec.get("trace_id") or "(no trace)", []).append(rec)
    head.append("")
    head.append(f"trace lineage ({len(lineage)} chains):")
    for tid, chain in lineage.items():
        kinds = " -> ".join(r.get("kind", "?") for r in chain)
        head.append(f"  {str(tid)[:20]:<22} {len(chain):>3} events: {kinds}")
    return "\n".join(head)


def _demo(device=None) -> dict:
    """An incident: four supervised ``TorchSolver`` solve cycles on
    ``device`` (CUDA unless ``cpu``) with tracing on, then a gate-audit
    mismatch that breaches the gate-integrity objective and dumps."""
    import os
    import tempfile

    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.obs import slo, trace
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    solver = SupervisedSolver(TorchSolver(device=device), fallback=None)
    its = instance_types(8)
    tpl = template_from_nodepool(NodePool(metadata=ObjectMeta(name="demo")), its, range(len(its)))
    pods = [
        Pod(
            metadata=ObjectMeta(name=f"demo-{i}"),
            spec=PodSpec(containers=[Container(requests={"cpu": 0.25 if i % 10 else 10_000.0})]),
        )
        for i in range(40)
    ]
    tmp = tempfile.mkdtemp(prefix="flight-demo-")
    saved = os.environ.get("KARPENTER_TPU_FLIGHT_DIR")
    os.environ["KARPENTER_TPU_FLIGHT_DIR"] = tmp
    slo.set_enabled(True)
    flight.set_enabled(True)
    trace.set_enabled(True)
    try:
        slo.reset()
        flight.reset()
        for _ in range(4):
            solver.solve(pods, its, [tpl])
        with trace.cycle("solve", backend="TorchSolver"):
            flight.record(flight.KIND_GATE_AUDIT, trace_id=trace.current_trace_id(), outcome="mismatch")
            slo.on_gate(ok=False)  # min_events=1 objective: one bad event breaches
        path = flight.scan_dumps(tmp)[-1]
        return flight.load_dump(path)
    finally:
        slo.set_enabled(None)
        flight.set_enabled(None)
        trace.set_enabled(None)
        if saved is None:
            os.environ.pop("KARPENTER_TPU_FLIGHT_DIR", None)
        else:
            os.environ["KARPENTER_TPU_FLIGHT_DIR"] = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "source", nargs="?",
        help="flight-*.bin dump path or /debug/flight URL",
    )
    ap.add_argument(
        "--demo", action="store_true",
        help="replay a breach locally and render its dump",
    )
    ap.add_argument("--device", default="cuda", help="the demo solves' device (default cuda; cpu on a host)")
    args = ap.parse_args(argv)
    if args.demo:
        body = _demo(args.device)
    elif args.source:
        body = _load(args.source)
    else:
        ap.error("need a dump path / URL, or --demo")
    print(render(body))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
