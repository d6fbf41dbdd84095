"""Seeded churn load generator: arrivals and deletes, one solve cycle at a time.

Counterpart of the JAX package's ``streaming/churn.py``: the same config and
the same seed give the same pod stream (names, shapes, labels, delete
positions), which is what lets the tests and ``chip_smoke.py`` drive both
packages, or two solvers of this one, through byte-identical snapshots.

Not ported: the provider spot-reclaim hook (``cloud.reclaim`` of the JAX
package's fault grammar), which waits for a port of ``testing/faults.py``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
from karpenter_tpu_torch.solver.encode import NodeInfo
from karpenter_tpu_torch.utils import resources as res


def default_pod_factory(name: str, rng: random.Random) -> Pod:
    """A plausible mixed-size arrival: cpu/memory drawn from a small set of
    shapes so FFD runs still form (identical shapes compress)."""
    cpu, mem = rng.choice(
        ((0.25, 0.5e9), (0.5, 1e9), (1.0, 2e9), (2.0, 4e9), (4.0, 8e9))
    )
    return Pod(
        metadata=ObjectMeta(name=name, labels={"app": rng.choice(("web", "api", "batch"))}),
        spec=PodSpec(
            containers=[Container(requests={res.CPU: cpu, res.MEMORY: mem})]
        ),
    )


@dataclass
class ChurnConfig:
    seed: int = 0
    arrivals_per_cycle: int = 8
    deletes_per_cycle: int = 4
    min_pods: int = 1  # deletes never drain the batch below this


@dataclass
class ChurnEvent:
    cycle: int
    arrived: List[Pod] = field(default_factory=list)
    deleted: List[Pod] = field(default_factory=list)


class ChurnProcess:
    """Mutable cluster snapshot advanced one solve cycle at a time. ``pods``
    and ``nodes`` are the current snapshot; ``step()`` applies one cycle of
    churn and returns what changed."""

    def __init__(
        self,
        pods: Sequence[Pod],
        nodes: Sequence[NodeInfo] = (),
        pod_factory: Callable[[str, random.Random], Pod] = default_pod_factory,
        config: Optional[ChurnConfig] = None,
    ):
        self.config = config or ChurnConfig()
        self.rng = random.Random(self.config.seed)
        self.pods: List[Pod] = list(pods)
        self.nodes: List[NodeInfo] = list(nodes)
        self.pod_factory = pod_factory
        self.cycle = 0
        self.events: List[ChurnEvent] = []

    def step(self) -> ChurnEvent:
        ev = ChurnEvent(cycle=self.cycle)
        self.cycle += 1
        n_del = min(
            self.config.deletes_per_cycle,
            max(0, len(self.pods) - self.config.min_pods),
        )
        if n_del:
            for pos in sorted(
                self.rng.sample(range(len(self.pods)), n_del), reverse=True
            ):
                ev.deleted.append(self.pods.pop(pos))
        for j in range(self.config.arrivals_per_cycle):
            p = self.pod_factory(f"churn-{ev.cycle}-{j}", self.rng)
            ev.arrived.append(p)
            self.pods.append(p)
        self.events.append(ev)
        return ev


def run_churn(
    solver,
    process: ChurnProcess,
    instance_types,
    templates,
    cycles: int,
    validate: bool = False,
) -> List[Dict[str, object]]:
    """Drive ``solver`` through ``cycles`` churn steps. Returns one record per
    cycle: pod count, wall seconds, and, when the solver serves cycles from a
    resident world (``TorchSolver(device_world=True)``), that cycle's outcome.
    ``validate=True`` runs the full-level host validator on every cycle's
    result and records the violation count."""
    records: List[Dict[str, object]] = []
    for _ in range(cycles):
        ev = process.step()
        start = time.perf_counter()
        result = solver.solve(
            process.pods, instance_types, templates, nodes=process.nodes
        )
        seconds = time.perf_counter() - start
        rec: Dict[str, object] = {
            "cycle": ev.cycle,
            "pods": len(process.pods),
            "nodes": len(process.nodes),
            "arrived": len(ev.arrived),
            "deleted": len(ev.deleted),
            "scheduled": result.num_scheduled(),
            "failures": len(result.failures),
            "seconds": seconds,
        }
        outcome = getattr(solver, "last_world_outcome", None)
        if outcome is not None:
            rec["outcome"] = outcome
        if validate:
            from karpenter_tpu_torch.solver import validator as val

            violations = val.validate_result(
                result,
                list(process.pods),
                instance_types,
                templates,
                nodes=process.nodes,
                level="full",
            )
            rec["violations"] = len(violations)
        records.append(rec)
    return records
