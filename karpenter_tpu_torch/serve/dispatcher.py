"""The serve dispatcher: bounded queues, hierarchical DWRR, classified
admission.

Counterpart of the JAX package's ``serve/dispatcher.py``.

One dispatcher thread drains every tenant's queue — solves are serialized
onto the device exactly as the single-tenant operator serializes cycles, so
per-tenant solver state needs no locking and device contention is structural,
not emergent. Fairness and isolation live at the queue boundary:

  admission (``submit``, caller's thread)
      a request is either queued or resolved immediately with a CLASSIFIED
      outcome: ``overloaded-queue-full`` (its tenant's bounded queue is
      full), ``overloaded-predicted-wait`` (the decayed queue-wait estimate
      already exceeds the admit/request deadline — shedding at the door
      beats timing out after burning device time),
      ``overloaded-saturated`` (class-aware shedding under sustained
      over-subscription: a lower class's slice of the admit bound is
      exhausted while higher classes still admit), ``rejected-max-tenants``,
      ``rejected-shutdown``. serve_admission_total counts every decision by
      tenant CLASS (bounded label; per-tenant detail in ``snapshot``).

  fairness (``_collect``, dispatcher thread)
      hierarchical deficit-weighted round robin in pod-units. Tenant classes
      sit above tenants: the class ready-ring rotates classes whose balance
      covers their candidate; within a class, the tenant ready-ring rotates
      members the same way. Replenish is per level — members of a blocked
      class earn ``weight x quantum`` when none can afford its head, classes
      earn ``class_weight x quantum`` when every backlogged class is gated.
      An emptied queue forfeits its balance at BOTH levels (no hoarding
      credit while idle). With one class registered the class level
      disappears entirely and the schedule is bit-identical to the flat
      16-tenant DWRR. Only READY (backlogged) streams are ever swept: a
      ready-ring per class makes each decision O(active), so 990 idle
      registered tenants cost the dispatcher nothing.

  execution (``_execute``)
      the request's wall-clock budget (explicit per-request deadline, else
      the tenant's default) is inherited by the solve: the tenant solver's
      watchdog deadline is narrowed to the REMAINING budget for the call.
      Already-expired requests resolve as ``overloaded-expired`` without
      touching the device. Cross-tenant batchable groups take one stacked
      launch (serve/batch.py) on the service's device, with riders found
      through the shared per-shape program pool (serve/pool.py) in
      O(family). A lane that stands down for a classified reason is served
      by its tenant's solo solve; an error of the stacked dispatch itself
      resolves every ticket of the group as ``error`` with the exception
      named, and the group is not re-served solo (the reference re-serves
      it; see serve/batch.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.metrics.registry import (
    SERVE_ACTIVE,
    SERVE_ADMISSION,
    SERVE_BATCH,
    SERVE_CYCLE_SECONDS,
    SERVE_CYCLES,
    SERVE_FAIRNESS_DEFICIT,
    SERVE_POOL,
    SERVE_QUEUE_DEPTH,
)
from karpenter_tpu_torch.obs import flight, slo
from karpenter_tpu_torch.serve.estimator import WaitEstimator
from karpenter_tpu_torch.serve.pool import ProgramPool, shape_family
from karpenter_tpu_torch.solver.backend import SolveResult

# classified admission / completion outcome vocabulary (the bounded metric
# label-value sets; tools/metrics_lint.py checks the cls axis separately)
STATUS_OK = "ok"
STATUS_OVERLOADED = "overloaded"
STATUS_REJECTED = "rejected"
STATUS_ERROR = "error"
STATUS_PENDING = "pending"

ADMIT_ACCEPTED = "accepted"
ADMIT_QUEUE_FULL = "overloaded-queue-full"
ADMIT_PREDICTED_WAIT = "overloaded-predicted-wait"
ADMIT_SATURATED = "overloaded-saturated"
ADMIT_EXPIRED = "overloaded-expired"
ADMIT_MAX_TENANTS = "rejected-max-tenants"
ADMIT_SHUTDOWN = "rejected-shutdown"


@dataclass
class ServeOutcome:
    """What a submitted request resolved to. ``status`` is always one of the
    STATUS_* constants; an unserved request carries its admission class in
    ``reason`` — the caller can always tell shed from failed from served."""

    status: str
    tenant: str = ""
    reason: str = ""
    result: Optional[SolveResult] = None
    latency_s: float = 0.0
    path: str = ""  # "solo" | "batched" | "" (never solved)


class Ticket:
    """The caller's handle on a submitted request."""

    def __init__(self, tenant: str):
        self._tenant = tenant
        self._event = threading.Event()
        self._outcome: Optional[ServeOutcome] = None

    def resolve(self, outcome: ServeOutcome) -> None:
        self._outcome = outcome
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> ServeOutcome:
        """Block for the outcome; a timeout returns a non-final ``pending``
        outcome (the request is still queued or running)."""
        if self._event.wait(timeout):
            assert self._outcome is not None
            return self._outcome
        return ServeOutcome(status=STATUS_PENDING, tenant=self._tenant)


@dataclass
class _Request:
    tenant: str
    pods: Sequence
    instance_types: Sequence
    templates: Sequence
    kwargs: Dict
    deadline_s: float  # effective wall budget (0 = none)
    submitted_at: float
    ticket: Ticket
    cost: float = field(init=False)

    def __post_init__(self):
        # DWRR service cost in pod-units: fairness is about device time,
        # which scales with batch size, not request count
        self.cost = float(max(1, len(self.pods)))


@dataclass
class TenantClass:
    """One tier of the class hierarchy: its DWRR balance, its ready-ring of
    backlogged member streams, and its aggregate accounting. The class set
    is operator config (KARPENTER_TPU_SERVE_CLASSES) — a bounded label."""

    name: str
    weight: float = 1.0
    deficit: float = 0.0
    queued: int = 0
    served_pods: float = 0.0
    ring: List[str] = field(default_factory=list)

    def snapshot(self) -> Dict:
        return {
            "class": self.name,
            "weight": self.weight,
            "deficit": round(self.deficit, 3),
            "queued": self.queued,
            "ready": len(self.ring),
            "served_pods": round(self.served_pods, 1),
        }


class SolveService:
    """The multi-tenant solve service. Stacked dispatches, and the tenant
    stacks the default factory builds, run on ``device``: CUDA unless
    ``device="cpu"``."""

    def __init__(
        self,
        solver_factory=None,
        max_tenants: Optional[int] = None,
        queue_depth: Optional[int] = None,
        quantum: Optional[float] = None,
        admit_deadline_s: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
        classes: Optional[Dict[str, float]] = None,
        batching: Optional[bool] = None,
        batch_lanes: Optional[int] = None,
        device=None,
        name: str = "",
        time_fn=time.monotonic,
    ):
        from karpenter_tpu_torch import serve as cfg
        from karpenter_tpu_torch.serve.tenant import build_tenant_solver
        from karpenter_tpu_torch.solver.torch_backend import resolve_device

        # the card the stacked dispatches and the default tenant stacks run
        # on: CUDA unless the caller asks for the CPU
        self.device = resolve_device(device)
        self._solver_factory = solver_factory or (
            lambda tenant_id: build_tenant_solver(tenant_id, device=self.device)
        )
        self.max_tenants = max_tenants if max_tenants is not None else cfg.max_tenants()
        self.queue_depth = queue_depth if queue_depth is not None else cfg.queue_depth()
        self.quantum = quantum if quantum is not None else cfg.quantum()
        self.admit_deadline_s = (
            admit_deadline_s
            if admit_deadline_s is not None
            else cfg.admit_deadline_s()
        )
        self.weights = weights if weights is not None else cfg.parse_weights()
        self.batching = batching if batching is not None else cfg.batching_enabled()
        self.batch_lanes = (
            batch_lanes if batch_lanes is not None else cfg.batch_lanes()
        )
        self.name = name
        self._time = time_fn
        self._cond = threading.Condition()
        self._tenants: Dict[str, "TenantState"] = {}
        self._order: List[str] = []  # registration order (introspection only)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # class hierarchy: configured classes exist up front; tenants landing
        # in an unconfigured class mint it at weight 1 (tolerant, like
        # parse_weights). One class total == the flat DWRR fast path.
        self.class_weights = dict(
            classes if classes is not None else cfg.parse_classes()
        )
        if not self.class_weights:
            self.class_weights = {cfg.DEFAULT_CLASS: 1.0}
        self._classes: Dict[str, TenantClass] = {
            cname: TenantClass(name=cname, weight=w)
            for cname, w in self.class_weights.items()
        }
        self._max_class_weight = max(
            c.weight for c in self._classes.values()
        )
        self._class_ring: List[str] = []  # classes with ready members
        self._backlog = 0  # total queued requests (maintained, never summed)
        self._pool = ProgramPool()
        self._wait = WaitEstimator(
            half_life_s=cfg.ewma_half_life_s(),
            floor=cfg.ewma_floor(),
            time_fn=time_fn,
        )
        # scheduling-cost telemetry: the O(active) contract is measured, not
        # asserted — scans / decisions must track the READY population
        self._decisions = 0
        self._scans = 0
        self._replenish_rounds = 0

    # -- tenant registry ------------------------------------------------------

    def _class_for(self, cname: str) -> TenantClass:
        c = self._classes.get(cname)
        if c is None:
            c = TenantClass(name=cname, weight=self.class_weights.get(cname, 1.0))
            self._classes[cname] = c
            self._max_class_weight = max(self._max_class_weight, c.weight)
        return c

    def register_tenant(
        self,
        tenant_id: str,
        weight: Optional[float] = None,
        deadline_s: float = 0.0,
        solver=None,
        tenant_class: Optional[str] = None,
    ):
        """Create (or return) a tenant stream. Raises ValueError at the
        tenant capacity bound — ``submit`` classifies that as
        ``rejected-max-tenants`` instead of raising at the caller.
        Registration is O(1): a registered-but-idle tenant costs the
        dispatcher nothing until its first request."""
        from karpenter_tpu_torch import serve as cfg
        from karpenter_tpu_torch.serve.tenant import TenantState

        with self._cond:
            existing = self._tenants.get(tenant_id)
            if existing is not None:
                return existing
            if len(self._tenants) >= self.max_tenants:
                raise ValueError(
                    f"tenant capacity {self.max_tenants} reached "
                    f"(KARPENTER_TPU_SERVE_MAX_TENANTS)"
                )
            cname = tenant_class if tenant_class is not None else cfg.DEFAULT_CLASS
            self._class_for(cname)
            state = TenantState(
                tenant_id,
                solver if solver is not None else self._solver_factory(tenant_id),
                weight=(
                    weight
                    if weight is not None
                    else self.weights.get(tenant_id, 1.0)
                ),
                deadline_s=deadline_s,
                queue_depth=self.queue_depth,
                cls=cname,
            )
            self._tenants[tenant_id] = state
            self._order.append(tenant_id)
            return state

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "SolveService":
        from karpenter_tpu_torch import serve as cfg

        with self._cond:
            if self._closed:
                raise RuntimeError("SolveService is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"karpenter-tpu/serve-dispatcher{self.name and '-' + self.name}",
                )
                self._thread.start()
        if not self.name:
            cfg._set_current(self)
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop dispatching and resolve everything still queued as
        ``rejected-shutdown`` — shutdown shedding is classified like any
        other unserved outcome."""
        from karpenter_tpu_torch import serve as cfg

        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        drained: List[Tuple[_Request, str]] = []
        with self._cond:
            for state in self._tenants.values():
                while state.queue:
                    drained.append((state.queue.popleft(), state.cls))
                    state.counters["shed"] += 1
                state.ready = False
            for c in self._classes.values():
                c.queued = 0
                c.deficit = 0.0
                c.ring = []
                SERVE_QUEUE_DEPTH.set(0, {"cls": c.name})
                SERVE_ACTIVE.set(0, {"cls": c.name})
            self._class_ring = []
            self._backlog = 0
            self._pool = ProgramPool()
        for req, cname in drained:
            SERVE_ADMISSION.inc({"cls": cname, "outcome": ADMIT_SHUTDOWN})
            req.ticket.resolve(ServeOutcome(
                status=STATUS_REJECTED, tenant=req.tenant, reason=ADMIT_SHUTDOWN,
            ))
        if cfg.current_service() is self:
            cfg._set_current(None)

    def healthy(self) -> bool:
        """Readiness contribution: closed or a dead dispatcher thread means
        queued requests would wait forever."""
        with self._cond:
            if self._closed:
                return False
            return self._thread is None or self._thread.is_alive()

    # -- admission ------------------------------------------------------------

    def submit(
        self,
        tenant_id: str,
        pods: Sequence,
        instance_types: Sequence,
        templates: Sequence,
        deadline_s: Optional[float] = None,
        **kwargs,
    ) -> Ticket:
        """Admit one solve request. Always returns a Ticket; an unadmitted
        request's ticket is already resolved with its classification.
        O(1) in the registered-tenant count: the backlog is a maintained
        counter, never a sweep."""
        ticket = Ticket(tenant_id)

        def refuse(status: str, outcome: str, cls_label: str) -> Ticket:
            # the cls label stays bounded: classes are operator config, and
            # unregistered ids never mint anything ("-" is the placeholder)
            SERVE_ADMISSION.inc({"cls": cls_label, "outcome": outcome})
            if slo.enabled():
                slo.on_serve_admission(cls_label, False)
                flight.record(
                    flight.KIND_ADMISSION, outcome=outcome,
                    cls=cls_label, tenant=tenant_id,
                )
            ticket.resolve(ServeOutcome(
                status=status, tenant=tenant_id, reason=outcome,
            ))
            return ticket

        with self._cond:
            state = self._tenants.get(tenant_id)
            if self._closed:
                return refuse(
                    STATUS_REJECTED, ADMIT_SHUTDOWN,
                    state.cls if state is not None else "-",
                )
            if state is None:
                try:
                    state = self.register_tenant(tenant_id)
                except ValueError:
                    return refuse(STATUS_REJECTED, ADMIT_MAX_TENANTS, "-")
            c = self._classes[state.cls]
            effective_deadline = (
                deadline_s if deadline_s is not None else state.deadline_s
            ) or 0.0
            if len(state.queue) >= state.queue_depth:
                state.counters["shed"] += 1
                return refuse(STATUS_OVERLOADED, ADMIT_QUEUE_FULL, c.name)
            # predicted-wait shedding: with a wait bound configured (the
            # service-wide admit deadline and/or this request's own budget)
            # and a solve-rate estimate in hand, a request that would wait
            # past its bound is shed NOW instead of expiring in queue. The
            # estimate is the TIME-DECAYED per-request service EWMA
            # (serve/estimator.py): stale estimates from a previous busy
            # period decay instead of over-shedding the next burst's head.
            per_req = self._wait.per_request_s()
            if per_req > 0:
                bound = min(
                    self.admit_deadline_s or float("inf"),
                    effective_deadline or float("inf"),
                )
                predicted = self._backlog * per_req
                if bound != float("inf") and predicted > bound:
                    state.counters["shed"] += 1
                    return refuse(
                        STATUS_OVERLOADED, ADMIT_PREDICTED_WAIT, c.name
                    )
                # class-aware saturation shedding: under sustained over-
                # subscription each class owns a (w_c / w_max) slice of the
                # admit bound, so lower classes shed at the door while the
                # top class still admits. One registered class => factor 1
                # => this branch never fires (flat admission, bit-identical).
                if len(self._classes) > 1 and self.admit_deadline_s > 0:
                    factor = c.weight / self._max_class_weight
                    if factor < 1.0 and predicted > self.admit_deadline_s * factor:
                        state.counters["shed"] += 1
                        return refuse(
                            STATUS_OVERLOADED, ADMIT_SATURATED, c.name
                        )
            req = _Request(
                tenant=tenant_id, pods=pods, instance_types=instance_types,
                templates=templates, kwargs=kwargs,
                deadline_s=effective_deadline, submitted_at=self._time(),
                ticket=ticket,
            )
            self._enqueue_locked(state, c, req)
            state.counters["submitted"] += 1
            SERVE_ADMISSION.inc({"cls": c.name, "outcome": ADMIT_ACCEPTED})
            slo.on_serve_admission(c.name, True)
            started = self._thread is not None
            self._cond.notify_all()
        if not started:
            self.start()
        return ticket

    def solve(
        self,
        tenant_id: str,
        pods: Sequence,
        instance_types: Sequence,
        templates: Sequence,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
        **kwargs,
    ) -> ServeOutcome:
        """submit + wait: the blocking convenience the churn streams use."""
        return self.submit(
            tenant_id, pods, instance_types, templates,
            deadline_s=deadline_s, **kwargs,
        ).wait(timeout)

    # -- ready-ring maintenance (all under the service lock) ------------------

    def _enqueue_locked(self, state, c: TenantClass, req: _Request) -> None:
        state.queue.append(req)
        c.queued += 1
        self._backlog += 1
        SERVE_QUEUE_DEPTH.set(c.queued, {"cls": c.name})
        if not state.ready:
            state.ready = True
            if not c.ring:
                self._class_ring.append(c.name)
            c.ring.append(state.id)
            SERVE_ACTIVE.set(len(c.ring), {"cls": c.name})
        if self.batching and len(state.queue) == 1:
            self._note_head_locked(state)

    def _note_head_locked(self, state) -> None:
        """Keep the program pool's family index pointing at this stream's
        current head (serve/pool.py). Eligibility is re-verified at gather
        time — the pool is an index, not a promise."""
        from karpenter_tpu_torch.serve import batch as xbatch

        if not state.queue:
            self._pool.clear(state.id)
            return
        head = state.queue[0]
        self._pool.note_head(
            state.id, head, xbatch.batchable(head, state.solver)
        )

    def _forfeit_locked(self, state) -> None:
        """Tenant-level idle forfeit: an emptied stream leaves the ring with
        a zero balance — no hoarding credit while idle."""
        state.ready = False
        if state.deficit:
            state.deficit = 0.0

    def _drop_from_ring_locked(self, c: TenantClass, state) -> None:
        """Remove an emptied stream from its class ring, forfeiting at both
        levels when the class itself goes idle."""
        try:
            c.ring.remove(state.id)
        except ValueError:
            pass
        self._forfeit_locked(state)
        if not c.ring:
            if c.name in self._class_ring:
                self._class_ring.remove(c.name)
            # class-level idle forfeit: an emptied class loses its balance
            if c.deficit:
                c.deficit = 0.0
                if len(self._classes) > 1:
                    SERVE_FAIRNESS_DEFICIT.set(0.0, {"cls": c.name})
        SERVE_ACTIVE.set(len(c.ring), {"cls": c.name})

    def _rotate_locked(self, c: TenantClass, state) -> None:
        """A served (or expired) stream yields its turn: tenant to the back
        of its class ring, class to the back of the class ring."""
        try:
            c.ring.remove(state.id)
        except ValueError:
            pass
        if state.queue:
            c.ring.append(state.id)
        else:
            self._forfeit_locked(state)
        if c.name in self._class_ring:
            self._class_ring.remove(c.name)
        if c.ring:
            self._class_ring.append(c.name)
        elif c.deficit:
            c.deficit = 0.0
            if len(self._classes) > 1:
                SERVE_FAIRNESS_DEFICIT.set(0.0, {"cls": c.name})
        SERVE_ACTIVE.set(len(c.ring), {"cls": c.name})

    # -- dispatch loop --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                # O(1) idle check: the backlog is maintained at enqueue/pop,
                # never recomputed by sweeping 1,000 registered tenants
                while not self._closed and self._backlog == 0:
                    self._cond.wait(0.5)
                if self._closed:
                    return
                picked, cobatch = self._collect_locked()
            if picked is None:
                continue
            self._execute(picked, cobatch)

    def _pop_locked(self, state) -> Optional[_Request]:
        """Pop a tenant's head request, resolving it immediately when its
        wall budget already expired in queue (``overloaded-expired`` — the
        device never sees it). Returns None when the pop produced no
        runnable request."""
        req = state.queue.popleft()
        c = self._classes[state.cls]
        c.queued -= 1
        self._backlog -= 1
        SERVE_QUEUE_DEPTH.set(c.queued, {"cls": c.name})
        if self.batching:
            self._note_head_locked(state)
        if req.deadline_s > 0 and (
            self._time() - req.submitted_at
        ) >= req.deadline_s:
            state.counters["shed"] += 1
            SERVE_ADMISSION.inc({"cls": c.name, "outcome": ADMIT_EXPIRED})
            if slo.enabled():
                slo.on_serve_admission(c.name, False)
                flight.record(
                    flight.KIND_ADMISSION, outcome=ADMIT_EXPIRED,
                    cls=c.name, tenant=state.id,
                )
            req.ticket.resolve(ServeOutcome(
                status=STATUS_OVERLOADED, tenant=state.id,
                reason=ADMIT_EXPIRED,
                latency_s=self._time() - req.submitted_at,
            ))
            return None
        return req

    def _affordable_member_locked(self, c: TenantClass):
        """First stream in the class ring whose balance covers its head —
        the intra-class DWRR candidate. O(ready members of this class)."""
        for tid in c.ring:
            self._scans += 1
            state = self._tenants[tid]
            if state.queue and state.queue[0].cost <= state.deficit:
                return state
        return None

    def _collect_locked(self) -> Tuple[Optional[_Request], List[_Request]]:
        """One hierarchical DWRR decision, O(active). Sweeps the ready
        classes for one whose balance covers its intra-class candidate;
        replenish is per level and only for backlogged parties (guaranteed
        to terminate: balances grow, costs don't). With one registered class
        the class level vanishes and this IS the flat DWRR schedule."""
        hierarchical = len(self._classes) > 1
        while True:
            if not self._class_ring:
                return None, []
            for cname in list(self._class_ring):
                c = self._classes[cname]
                if not c.ring:
                    continue
                pick = self._affordable_member_locked(c)
                while pick is None:
                    # intra-class replenish: this class has backlog but no
                    # member can afford its head — members earn their keep
                    # independently of the other classes' pace
                    for tid in c.ring:
                        member = self._tenants[tid]
                        member.deficit += member.weight * self.quantum
                    pick = self._affordable_member_locked(c)
                if hierarchical and pick.queue[0].cost > c.deficit:
                    continue  # the class balance gates its candidate
                self._decisions += 1
                req = self._pop_locked(pick)
                if req is not None:
                    # pay BEFORE rotating: a pop-to-empty rotate forfeits the
                    # balance, and charging after the forfeit would bank a
                    # negative deficit against the stream's next busy period
                    pick.deficit -= req.cost
                    c.served_pods += req.cost
                    if hierarchical:
                        c.deficit -= req.cost
                        SERVE_FAIRNESS_DEFICIT.set(c.deficit, {"cls": cname})
                self._rotate_locked(c, pick)
                if req is None:
                    return None, []
                return req, self._gather_cobatch_locked(req, pick)
            # every backlogged class is gated by its class balance:
            # class-level replenish (idle classes are not in the ring and
            # earn nothing)
            for cname in self._class_ring:
                c = self._classes[cname]
                c.deficit += c.weight * self.quantum
                SERVE_FAIRNESS_DEFICIT.set(c.deficit, {"cls": cname})
            self._replenish_rounds += 1

    def _gather_cobatch_locked(self, lead: _Request, lead_state) -> List[_Request]:
        """Other tenants' batchable heads that can ride the lead request's
        device dispatch — each still pays its own deficit at both levels
        (stacking changes the dispatch, not the accounting). Riders come
        from the shared program pool's shape-family index: O(family), not a
        sweep of the registry."""
        from karpenter_tpu_torch.serve import batch as xbatch

        if not self.batching:
            return []
        if not xbatch.batchable(lead, lead_state.solver):
            return []
        hierarchical = len(self._classes) > 1
        out: List[_Request] = []
        for tid in self._pool.candidates(shape_family(lead)):
            if len(out) + 1 >= self.batch_lanes:
                break
            state = self._tenants.get(tid)
            if state is None or state is lead_state or not state.queue:
                continue
            head = state.queue[0]
            if head.cost > state.deficit:
                continue
            c = self._classes[state.cls]
            if hierarchical and head.cost > c.deficit:
                continue
            if not xbatch.batchable(head, state.solver):
                continue
            req = self._pop_locked(state)
            if req is None:
                if not state.queue:
                    self._drop_from_ring_locked(c, state)
                continue
            state.deficit -= req.cost
            c.served_pods += req.cost
            if hierarchical:
                c.deficit -= req.cost
                SERVE_FAIRNESS_DEFICIT.set(c.deficit, {"cls": c.name})
            if not state.queue:
                self._drop_from_ring_locked(c, state)
            out.append(req)
        SERVE_POOL.inc({"result": "hit" if out else "alone"})
        return out

    # -- execution ------------------------------------------------------------

    def _execute(self, lead: _Request, cobatch: List[_Request]) -> None:
        group = [lead] + cobatch
        started = self._time()
        stacked: List[Optional[SolveResult]] = [None] * len(group)
        if len(group) > 1:
            from karpenter_tpu_torch.serve import batch as xbatch

            try:
                stacked = xbatch.stacked_solve(group, device=self.device)
            except Exception as exc:  # noqa: BLE001 — every ticket of the group resolves, naming it
                # not a stand-down: a kernel, CUDA or decode error in the
                # stacked dispatch is the group's outcome, not re-served solo
                for req in group:
                    self._finish_error(req, exc, path="batched")
                return
        for req, pre in zip(group, stacked):
            if pre is not None:
                SERVE_BATCH.inc({"result": "hit"})
                self._finish_ok(req, pre, path="batched")
            else:
                if len(group) > 1:
                    SERVE_BATCH.inc({"result": "fallback"})
                self._execute_solo(req)
        # the admission estimator learns per-request SERVICE time: dispatch
        # wall amortized across the group (queue wait excluded — predicted
        # wait is backlog x service, so queue-inclusive feeding would
        # double-count the queue and over-shed sustained load)
        elapsed = self._time() - started
        if elapsed >= 0:
            self._wait.observe(elapsed / len(group))

    def _execute_solo(self, req: _Request) -> None:
        state = self._tenants[req.tenant]
        solver = state.solver
        # deadline inheritance: the tenant watchdog gets the REMAINING wall
        # budget for this call (never widened past its configured value)
        configured = getattr(solver, "deadline_s", None)
        override = configured is not None and req.deadline_s > 0
        if override:
            remaining = req.deadline_s - (self._time() - req.submitted_at)
            if remaining <= 0:
                state.counters["shed"] += 1
                SERVE_ADMISSION.inc(
                    {"cls": state.cls, "outcome": ADMIT_EXPIRED}
                )
                if slo.enabled():
                    slo.on_serve_admission(state.cls, False)
                    flight.record(
                        flight.KIND_ADMISSION, outcome=ADMIT_EXPIRED,
                        cls=state.cls, tenant=req.tenant,
                    )
                req.ticket.resolve(ServeOutcome(
                    status=STATUS_OVERLOADED, tenant=req.tenant,
                    reason=ADMIT_EXPIRED,
                    latency_s=self._time() - req.submitted_at,
                ))
                return
            solver.deadline_s = (
                min(configured, remaining) if configured > 0 else remaining
            )
        try:
            result = solver.solve(
                req.pods, req.instance_types, req.templates, **req.kwargs
            )
        except Exception as exc:  # noqa: BLE001 — a tenant solve must never kill the loop
            self._finish_error(req, exc, path="solo")
            return
        finally:
            if override:
                solver.deadline_s = configured
        self._finish_ok(req, result, path="solo")

    def _finish_error(self, req: _Request, exc: Exception, path: str) -> None:
        state = self._tenants[req.tenant]
        state.counters["errors"] += 1
        flight.record(
            flight.KIND_SERVE_COMPLETE, cls=state.cls, tenant=req.tenant,
            status=STATUS_ERROR, error=type(exc).__name__,
        )
        req.ticket.resolve(ServeOutcome(
            status=STATUS_ERROR, tenant=req.tenant,
            reason=f"{type(exc).__name__}: {exc}",
            latency_s=self._time() - req.submitted_at, path=path,
        ))

    def _finish_ok(self, req: _Request, result: SolveResult, path: str) -> None:
        state = self._tenants[req.tenant]
        latency = self._time() - req.submitted_at
        state.counters["completed"] += 1
        if path == "batched":
            state.counters["batched"] += 1
        state.record_latency(latency)
        SERVE_CYCLES.inc({"cls": state.cls, "path": path})
        SERVE_CYCLE_SECONDS.observe(latency)
        if slo.enabled():
            slo.on_serve_latency(state.cls, latency)
            flight.record(
                flight.KIND_SERVE_COMPLETE, cls=state.cls, tenant=req.tenant,
                latency_s=round(latency, 6), path=path,
            )
        req.ticket.resolve(ServeOutcome(
            status=STATUS_OK, tenant=req.tenant, result=result,
            latency_s=latency, path=path,
        ))

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._cond:
            tenants = [
                self._tenants[tid].snapshot() for tid in self._order
            ]
            return {
                "closed": self._closed,
                "dispatcher_alive": (
                    self._thread is not None and self._thread.is_alive()
                ),
                "name": self.name,
                "device": str(self.device),
                "batching": self.batching,
                "batch_lanes": self.batch_lanes,
                "quantum": self.quantum,
                "queue_depth": self.queue_depth,
                "max_tenants": self.max_tenants,
                "admit_deadline_s": self.admit_deadline_s,
                "backlog": self._backlog,
                "ewma_solve_s": round(self._wait.per_request_s(), 6),
                "wait_estimator": self._wait.snapshot(),
                "classes": [
                    c.snapshot() for c in self._classes.values()
                ],
                "sched": {
                    "decisions": self._decisions,
                    "scans": self._scans,
                    "replenish_rounds": self._replenish_rounds,
                },
                "pool": self._pool.snapshot(),
                "tenants": tenants,
            }

    def summary(self) -> Dict:
        """Fleet totals, not per-tenant rows (those are in ``snapshot``)."""
        with self._cond:
            totals = {"submitted": 0, "completed": 0, "shed": 0, "errors": 0,
                      "batched": 0}
            circuits: Dict[str, int] = {}
            for state in self._tenants.values():
                for key in totals:
                    totals[key] += state.counters[key]
                circuit = state.circuit_state()
                if circuit is not None:
                    circuits[circuit] = circuits.get(circuit, 0) + 1
            return {
                "tenants": len(self._tenants),
                "classes": len(self._classes),
                "queued": self._backlog,
                "healthy": self.healthy(),
                "batching": self.batching,
                "circuits": circuits,
                **totals,
            }
