"""Dev tool: render a captured solve-cycle trace as a text waterfall.

Counterpart of the JAX system's ``tools/trace_report.py`` over the port.
Reads traces from a ``/debug/traces`` JSON dump (a file or a live endpoint
URL), or replays a synthetic solve locally with ``--demo``, and prints one
waterfall per cycle:

    trace t-4f2a... solve backend=TorchSolver 1.6325s
      [################..............................] encode    0.0021s  1.3%
      ...

``--chrome OUT.json`` instead writes the Chrome trace-event export for the
same traces — load it at https://ui.perfetto.dev or chrome://tracing.

    python -m karpenter_tpu_torch.tools.trace_report traces.json
    python -m karpenter_tpu_torch.tools.trace_report http://localhost:8080/debug/traces
    python -m karpenter_tpu_torch.tools.trace_report --demo --device cpu --chrome t.json
"""

from __future__ import annotations

import argparse
import json
import sys

from karpenter_tpu_torch.obs import trace

BAR_WIDTH = 44


def _load(source: str) -> list:
    """Trace dicts from a file path or http(s) URL; accepts either the
    /debug/traces envelope ({"traces": [...]}) or a bare list."""
    if source.startswith("http://") or source.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(source) as resp:
            payload = json.load(resp)
    else:
        with open(source) as f:
            payload = json.load(f)
    if isinstance(payload, dict):
        return payload.get("traces", [payload] if "root" in payload else [])
    return payload


def _walk(node: dict, depth: int, out: list) -> None:
    out.append((depth, node))
    for child in node.get("children", ()):
        _walk(child, depth + 1, out)


def render_waterfall(trace_dict: dict) -> str:
    """One cycle as an indented span waterfall: bar position = offset within
    the cycle, bar length = span duration, annotated with attrs/counters."""
    total = max(trace_dict.get("duration_s", 0.0), 1e-12)
    rows: list = []
    _walk(trace_dict["root"], 0, rows)
    name_w = max(len("  " * d + n["name"]) for d, n in rows)
    lines = [
        "trace {} {} backend={} {:.4f}s".format(
            trace_dict.get("trace_id", "?"),
            trace_dict.get("name", "?"),
            trace_dict.get("backend"),
            trace_dict.get("duration_s", 0.0),
        )
    ]
    for depth, node in rows:
        off = node.get("offset_s", 0.0)
        dur = node.get("duration_s", 0.0)
        lo = int(round(off / total * BAR_WIDTH))
        hi = int(round((off + dur) / total * BAR_WIDTH))
        hi = min(max(hi, lo + 1), BAR_WIDTH)
        bar = "." * lo + "#" * (hi - lo) + "." * (BAR_WIDTH - hi)
        label = "  " * depth + node["name"]
        extras = []
        for k, v in node.get("attrs", {}).items():
            extras.append(f"{k}={v}")
        for k, v in node.get("counters", {}).items():
            extras.append(f"{k}={v:g}")
        lines.append(
            "  [{}] {:<{}} {:>9.4f}s {:>5.1f}%{}".format(
                bar, label, name_w, dur, dur / total * 100.0,
                ("  " + " ".join(extras)) if extras else "",
            )
        )
    phases = trace_dict.get("phases")
    if phases:
        top = sorted(phases.items(), key=lambda kv: -kv[1])
        lines.append(
            "  self time: "
            + "  ".join(f"{k}={v:.4f}s" for k, v in top)
        )
    return "\n".join(lines)


def _demo_traces(device=None) -> list:
    """Solve a small batch with tracing forced on and return the captured
    ring — an offline way to eyeball the waterfall with no operator running.
    The solve is a ``TorchSolver`` on ``device`` (CUDA unless ``cpu``)."""
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    solver = TorchSolver(device=device)
    trace.set_enabled(True)
    trace.reset_ring()

    its = instance_types(50)
    tpl = template_from_nodepool(
        NodePool(metadata=ObjectMeta(name="demo")), its, range(len(its))
    )
    pods = [
        Pod(
            metadata=ObjectMeta(name=f"demo-{i}"),
            spec=PodSpec(containers=[Container(requests={"cpu": 0.25})]),
        )
        for i in range(48)
    ]
    sup = SupervisedSolver(solver, fallback=None)
    try:
        sup.solve(pods, its, [tpl])  # the kernels' first use
        sup.solve(pods, its, [tpl])  # steady-state cycle
    finally:
        trace.set_enabled(None)
    return trace.ring().snapshot()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?", help="traces JSON file or /debug/traces URL")
    ap.add_argument("--demo", action="store_true", help="trace a local synthetic solve")
    ap.add_argument("--chrome", metavar="OUT", help="write Chrome trace-event JSON here")
    ap.add_argument("--last", type=int, default=0, help="render only the N most recent")
    ap.add_argument("--device", default="cuda", help="the demo solve's device (default cuda; cpu on a host)")
    args = ap.parse_args(argv)

    if args.demo:
        traces = _demo_traces(args.device)
    elif args.source:
        traces = _load(args.source)
    else:
        ap.error("give a traces source or --demo")
    if args.last:
        traces = traces[: args.last]
    if not traces:
        print("no traces captured", file=sys.stderr)
        return 1
    if args.chrome:
        with open(args.chrome, "w") as f:
            f.write(trace.chrome_trace_json(traces, indent=1))
        print(f"wrote {len(traces)} trace(s) to {args.chrome} (Perfetto-loadable)")
        return 0
    for tr in traces:
        print(render_waterfall(tr))
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
