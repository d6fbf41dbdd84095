"""Seeded churn load generator: arrivals, deletes and spot reclaims, one
solve cycle at a time.

Counterpart of the JAX package's ``streaming/churn.py``: the same config and
the same seed give the same pod stream (names, shapes, labels, delete
positions), which is what lets the tests and ``chip_smoke.py`` drive both
packages, or two solvers of this one, through byte-identical snapshots.
Provider-initiated spot reclaims come through the shared fault grammar
(testing/faults.py, ``cloud.reclaim``): one 'cloud' draw per cycle, its
targets picked by ``faults.reclaim_targets`` from the injector's own
(seed, call#) hash, so a chaos spec replays the same reclaims:

    KARPENTER_TPU_FAULTS="seed=7;cloud.reclaim=2@p0.1"
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis.objects import Container, ObjectMeta, Pod, PodSpec
from karpenter_tpu_torch.solver.encode import NodeInfo
from karpenter_tpu_torch.testing import faults
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
    reclaimed: List[str] = field(default_factory=list)  # node names


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
        # provider-initiated spot reclaim, through the shared fault grammar:
        # one 'cloud' draw per cycle, width = rule.param
        inj = faults.active()
        if inj is not None and self.nodes:
            rule = inj.draw("cloud")
            if rule is not None and rule.kind == "reclaim":
                ev.reclaimed = faults.reclaim_targets(
                    rule, [n.name for n in self.nodes], inj.seed, inj.calls("cloud")
                )
                gone = set(ev.reclaimed)
                self.nodes = [n for n in self.nodes if n.name not in gone]
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
    cycle: pod count, wall seconds, and the cycle's outcome: the streaming
    layer's outcome and reuse ratio when the solver is (or supervises) a
    ``StreamingSolver``, else the resident world's when it serves cycles from
    one (``TorchSolver(device_world=True)``).
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
            "reclaimed": len(ev.reclaimed),
            "scheduled": result.num_scheduled(),
            "failures": len(result.failures),
            "seconds": seconds,
        }
        # streaming telemetry: the solver itself, or the supervised primary
        src = solver
        if getattr(src, "last_outcome", None) is None:
            src = getattr(solver, "primary", solver)
        outcome = getattr(src, "last_outcome", None)
        if outcome is not None:
            rec["outcome"] = outcome
            rec["reuse_ratio"] = getattr(src, "last_reuse_ratio", 0.0)
        else:
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
