"""Dev tool: render placement-explainability reports as text.

Counterpart of the JAX system's ``tools/explain.py`` over the port. Reads
reports from a ``/debug/explain`` JSON dump (a file or a live endpoint
URL), or runs a synthetic solve locally with ``--demo``, and prints one
summary per report plus a per-pod gate waterfall:

    report TorchSolver trace=t-4f2a... pods=4 scheduled=2 unschedulable=2
      pod 1  resources     fits no instance type by cpu
        family     resources requirements taints host-ports topology claim-cap volume
        node       (no candidates)
        claim      (no candidates)
        template   X          .           .      .          .        .         .

Cells: ``X`` the family fails on every candidate of the class (blocker),
``+`` some candidate fails ONLY this family (near miss — the counterfactual
fix), ``x`` fails on at least one candidate, ``.`` clean.

    python -m karpenter_tpu_torch.tools.explain explain.json
    python -m karpenter_tpu_torch.tools.explain http://localhost:8080/debug/explain
    python -m karpenter_tpu_torch.tools.explain --demo
    python -m karpenter_tpu_torch.tools.explain --demo --device cpu --pod 2
"""

from __future__ import annotations

import argparse
import json
import sys

from karpenter_tpu_torch.obs import explain

_COL = max(len(n) for n in explain.FAMILY_NAMES) + 2


def _load(source: str) -> list:
    """Report dicts from a file path or http(s) URL; accepts the
    /debug/explain envelope ({"reports": [...]}) or a bare list/report."""
    if source.startswith("http://") or source.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(source) as resp:
            payload = json.load(resp)
    else:
        with open(source) as f:
            payload = json.load(f)
    if isinstance(payload, dict):
        return payload.get("reports", [payload] if "pods" in payload else [])
    return payload


def _cell(fam: str, info: dict) -> str:
    if fam in info.get("blockers", ()):
        return "X"
    if fam in info.get("near", ()):
        return "+"
    if fam in info.get("union", ()):
        return "x"
    return "."


def render_pod(pod: dict, indent: str = "  ") -> str:
    lines = [
        f"{indent}pod {pod['pod']:<5} {pod['reason']:<15} {pod['hint']}"
        f"  [{pod['derivation']}]"
    ]
    header = f"{indent}  {'family':<10}" + "".join(
        f"{n:<{_COL}}" for n in explain.FAMILY_NAMES
    )
    lines.append(header)
    for cls in explain.CLASS_NAMES:
        info = pod.get("classes", {}).get(cls, {})
        if info.get("empty"):
            lines.append(f"{indent}  {cls:<10}(no candidates)")
            continue
        cells = "".join(f"{_cell(n, info):<{_COL}}" for n in explain.FAMILY_NAMES)
        lines.append(f"{indent}  {cls:<10}{cells}")
    return "\n".join(lines)


def render_report(rep: dict, only_pod=None) -> str:
    head = (
        f"report {rep.get('backend', '?')} trace={rep.get('trace_id')} "
        f"pods={rep.get('total_pods')} scheduled={rep.get('scheduled')} "
        f"unschedulable={rep.get('unschedulable')} "
        f"overhead={rep.get('overhead_s', 0):.4f}s"
    )
    lines = [head]
    reasons = rep.get("reasons", {})
    if reasons:
        lines.append(
            "  reasons: "
            + ", ".join(f"{k}={v}" for k, v in sorted(reasons.items()))
        )
    for key, pod in sorted(rep.get("pods", {}).items(), key=lambda kv: int(kv[0])):
        if only_pod is not None and int(key) != only_pod:
            continue
        lines.append(render_pod(pod))
    noms = rep.get("nominations", {})
    if noms and only_pod is None:
        lines.append(f"  nominations ({len(noms)} scheduled pods):")
        for key, nom in sorted(noms.items(), key=lambda kv: int(kv[0])):
            mm = nom.get("min_margin", {})
            lines.append(
                f"    pod {key:<5} {nom.get('kind'):<10} bin={nom.get('bin')} "
                f"tightest={mm.get('resource')}={mm.get('value')}"
            )
    return "\n".join(lines)


def _demo_reports(device=None) -> list:
    """Solve a small batch with explain forced on and return the captured
    ring — three pods engineered to produce three different verdicts. The
    solve is a ``TorchSolver`` on ``device`` (CUDA unless ``cpu``)."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.cloudprovider.fake import (
        FAKE_WELL_KNOWN_LABELS,
        instance_types,
    )
    from karpenter_tpu_torch.solver.encode import template_from_nodepool
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    solver = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device=device)

    explain.set_enabled(True)
    explain.reset_ring()

    its = instance_types(8)
    tpl = template_from_nodepool(
        NodePool(metadata=ObjectMeta(name="demo")), its, range(len(its))
    )

    def pod(i, cpu=0.25, selector=None):
        return Pod(
            metadata=ObjectMeta(name=f"demo-{i}"),
            spec=PodSpec(
                containers=[Container(requests={"cpu": cpu})],
                node_selector=selector or {},
            ),
        )

    pods = [
        pod(0),
        pod(1, cpu=10_000.0),  # -> resources: fits no instance type by cpu
        pod(2, selector={wk.LABEL_TOPOLOGY_ZONE: "the-moon"}),  # -> requirements
        pod(3),
    ]
    try:
        solver.solve(pods, its, [tpl])
    finally:
        explain.set_enabled(None)
    return explain.ring().snapshot()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?", help="explain JSON file or /debug/explain URL")
    ap.add_argument("--demo", action="store_true", help="explain a local synthetic solve")
    ap.add_argument("--pod", type=int, default=None, help="drill into one pod index")
    ap.add_argument("--last", type=int, default=0, help="render only the N most recent")
    ap.add_argument("--device", default="cuda", help="the demo solve's device (default cuda; cpu on a host)")
    args = ap.parse_args(argv)

    if args.demo:
        reports = _demo_reports(args.device)
    elif args.source:
        reports = _load(args.source)
    else:
        ap.error("give a reports source or --demo")
    if args.last:
        reports = reports[: args.last]
    if not reports:
        print("no explain reports captured", file=sys.stderr)
        return 1
    for rep in reports:
        print(render_report(rep, only_pod=args.pod))
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
