"""Serve replicas: N dispatchers, each owning a carved device slice.

Counterpart of the JAX package's ``serve/replica.py``. One dispatcher thread
serializes every tenant's solves; a ``ReplicaSet`` runs N ``SolveService``
replicas side by side, each with its own dispatcher thread and its own slice
of the local devices (parallel/mesh.carve_meshes). A replica IS a
SolveService (``name=f"r{i}"``), so every per-replica property (fairness,
isolation, classified admission) is unchanged.

Placement is sticky and classified (``serve_replica_placements_total``):

  pinned      the operator said so (tests, forced co-location)
  big-tenant  expected pods >= KARPENTER_TPU_SERVE_BIG_PODS: replica 0,
              which owns the largest carved slice
  hash        everyone else: stable crc32(tenant) % n
  failover    the original replica died (``failover``); the tenant was
              re-hashed over the surviving replicas

A failover seeds each survivor's wait estimator with 2x the worst
per-request estimate (at least ``FAILOVER_SEED_S``), so admission
backpressure engages before the first migrated solve lands.

Devices (a deliberate difference). A slice of two or more devices puts its
replica on the slice's first card: the port's stacked dispatch runs on one
device. A ``None`` slice keeps the service's default device (its
``device=`` argument, else CUDA), as the JAX package's ``mesh=None`` keeps
the default device; on one H100 every replica runs on ``cuda:0``. Replicas
launch on each thread's current stream, the default stream: no replica has
a CUDA stream of its own. ``torch.cuda.max_memory_allocated`` is
process-wide, so a replica's memory sample (obs/programs.py) includes the
other replicas' tensors.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.metrics.registry import SERVE_REPLICA_PLACEMENTS
from karpenter_tpu_torch.serve.dispatcher import SolveService

PLACE_PINNED = "pinned"
PLACE_BIG_TENANT = "big-tenant"
PLACE_HASH = "hash"
PLACE_FAILOVER = "failover"

# seed for the survivors' wait estimators when nobody has a measurement yet
FAILOVER_SEED_S = 0.05


class ReplicaSet:
    """N SolveService replicas over carved device slices, with classified
    sticky tenant placement. Knobs fill the gaps
    (KARPENTER_TPU_SERVE_REPLICAS, KARPENTER_TPU_SERVE_BIG_PODS)."""

    def __init__(
        self,
        n_replicas: Optional[int] = None,
        meshes: Optional[Sequence] = None,
        big_tenant_pods: Optional[int] = None,
        **service_kwargs,
    ):
        from karpenter_tpu_torch import serve as cfg

        self.n = max(1, int(n_replicas if n_replicas is not None else cfg.replicas()))
        self.big_tenant_pods = big_tenant_pods if big_tenant_pods is not None else cfg.big_tenant_pods()
        if meshes is None:
            if self.n == 1:
                # one replica owns everything: the flat service's device
                meshes = [None]
            else:
                from karpenter_tpu_torch.parallel.mesh import carve_meshes

                meshes = carve_meshes(self.n)
        if len(meshes) != self.n:
            raise ValueError(f"{len(meshes)} meshes for {self.n} replicas")
        self.meshes = list(meshes)
        self.replicas: List[SolveService] = [
            SolveService(name=f"r{i}", **self._service_kwargs(meshes[i], service_kwargs))
            for i in range(self.n)
        ]
        # sticky placement: tenant -> (replica index, classified reason)
        self._placements: Dict[str, Tuple[int, str]] = {}
        self._dead: set = set()
        self._failovers = 0
        self._lock = threading.Lock()

    @staticmethod
    def _service_kwargs(mesh, service_kwargs: dict) -> dict:
        """A slice of devices puts its replica on the slice's first device."""
        if not mesh:
            return dict(service_kwargs)
        return {**service_kwargs, "device": mesh[0]}

    def _survivors(self) -> List[int]:
        """Live replica indices, ascending (caller holds the lock)."""
        return [i for i in range(self.n) if i not in self._dead]

    # -- placement ------------------------------------------------------------

    def place(
        self,
        tenant_id: str,
        expected_pods: int = 0,
        pinned: Optional[int] = None,
    ) -> Tuple[int, str]:
        """Resolve (and remember) a tenant's replica; the first decision
        sticks."""
        with self._lock:
            existing = self._placements.get(tenant_id)
            if existing is not None:
                return existing
            live = self._survivors()
            if not live:
                raise RuntimeError("no live replicas (all failed over)")
            if pinned is not None:
                decision = (live[pinned % len(live)], PLACE_PINNED)
            elif expected_pods >= self.big_tenant_pods:
                decision = (live[0], PLACE_BIG_TENANT)
            else:
                decision = (live[zlib.crc32(tenant_id.encode()) % len(live)], PLACE_HASH)
            self._placements[tenant_id] = decision
        SERVE_REPLICA_PLACEMENTS.inc({"reason": decision[1]})
        return decision

    def failover(self, dead_idx: int, close_timeout: float = 5.0) -> Dict[str, int]:
        """Declare replica ``dead_idx`` dead and migrate every tenant placed
        on it to the survivors (reason ``failover``, re-registered with the
        same weight, deadline and class on a fresh solver stack). Returns
        ``{tenant: new_replica}``; a second call for the same replica moves
        nothing."""
        dead_idx = int(dead_idx)
        with self._lock:
            if dead_idx in self._dead or not (0 <= dead_idx < self.n):
                return {}
            self._dead.add(dead_idx)
            live = self._survivors()
            if not live:
                return {}
            moved: Dict[str, int] = {}
            for tenant, (idx, _reason) in list(self._placements.items()):
                if idx != dead_idx:
                    continue
                new_idx = live[zlib.crc32(tenant.encode()) % len(live)]
                self._placements[tenant] = (new_idx, PLACE_FAILOVER)
                moved[tenant] = new_idx
            self._failovers += len(moved)
        dead = self.replicas[dead_idx]
        # seed before re-registering: backpressure should precede the surge
        worst = max(
            [FAILOVER_SEED_S, dead._wait.per_request_s()]
            + [self.replicas[i]._wait.per_request_s() for i in live]
        )
        for i in live:
            self.replicas[i]._wait.seed(2.0 * worst)
        for tenant, new_idx in moved.items():
            state = dead._tenants.get(tenant)
            try:
                self.replicas[new_idx].register_tenant(
                    tenant,
                    weight=state.weight if state is not None else None,
                    deadline_s=state.deadline_s if state is not None else 0.0,
                    tenant_class=state.cls if state is not None else None,
                )
            except ValueError:
                # survivor at tenant capacity: submit classifies the miss
                pass
        for _ in moved:
            SERVE_REPLICA_PLACEMENTS.inc({"reason": PLACE_FAILOVER})
        # drain the dead dispatcher: anything queued there resolves
        # classified (rejected-shutdown), never silently dropped
        try:
            dead.close(timeout=close_timeout)
        except Exception:
            pass
        return moved

    def dead_replicas(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)

    def replica_for(self, tenant_id: str, expected_pods: int = 0) -> SolveService:
        idx, _ = self.place(tenant_id, expected_pods=expected_pods)
        return self.replicas[idx]

    # -- the SolveService surface, routed -------------------------------------

    def register_tenant(self, tenant_id: str, expected_pods: int = 0, **kwargs):
        return self.replica_for(tenant_id, expected_pods=expected_pods).register_tenant(tenant_id, **kwargs)

    def submit(self, tenant_id: str, pods, instance_types, templates, **kwargs):
        return self.replica_for(tenant_id, expected_pods=len(pods)).submit(
            tenant_id, pods, instance_types, templates, **kwargs)

    def solve(self, tenant_id: str, pods, instance_types, templates, **kwargs):
        return self.replica_for(tenant_id, expected_pods=len(pods)).solve(
            tenant_id, pods, instance_types, templates, **kwargs)

    def start(self) -> "ReplicaSet":
        for r in self.replicas:
            r.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        for r in self.replicas:
            r.close(timeout=timeout)

    def healthy(self) -> bool:
        """Live replicas only: a failed-over replica is expected-dead."""
        with self._lock:
            live = self._survivors()
        return bool(live) and all(self.replicas[i].healthy() for i in live)

    # -- introspection --------------------------------------------------------

    def placements(self) -> Dict[str, Tuple[int, str]]:
        with self._lock:
            return dict(self._placements)

    def snapshot(self) -> Dict:
        placed = self.placements()
        reasons: Dict[str, int] = {}
        for _, reason in placed.values():
            reasons[reason] = reasons.get(reason, 0) + 1
        return {
            "replicas": [r.snapshot() for r in self.replicas],
            "placements": len(placed),
            "placement_reasons": reasons,
            "dead_replicas": self.dead_replicas(),
            "failovers": self._failovers,
        }

    def summary(self) -> Dict:
        out: Dict = {"replicas": self.n, "placements": len(self._placements)}
        totals: Dict[str, int] = {}
        for r in self.replicas:
            for key, value in r.summary().items():
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    totals[key] = totals.get(key, 0) + value
        out.update(totals)
        out["healthy"] = self.healthy()
        return out
