"""Seeded, schedule-driven fault injection (``KARPENTER_TPU_FAULTS``).

Counterpart of the JAX package's ``testing/faults.py``, with the same spec
grammar and the same seeded replay, ported for the solver supervisor's
solve site (solver/supervisor.py) and the serve layer's tenant scopes:

    KARPENTER_TPU_FAULTS="seed=7;solve.compile@1;solve.nan@2..3;solve[t3].device@*"

Grammar — ``;``-separated entries, optional leading ``seed=N``:

    entry  := site ['[' tenant ']'] '.' kind ['=' param] '@' sched
    site   := 'solve' | 'create' | 'delete' | 'cloud' | 'proc' | 'device'
    kind   := solve: compile | device | encode | nan | hang
              create/delete: ice | ratelimit | timeout
              cloud: reclaim
              proc: crash
              device: loss | degraded
    param  := float   (solve.hang: duration in seconds, default 30;
                       cloud.reclaim: nodes reclaimed per firing, default 1)
    sched  := N       fire on the N-th call to the site (1-based)
            | N..M    fire on calls N through M inclusive
            | pP      fire with probability P per call (seeded, per-call
                      deterministic: the draw for call n depends only on
                      (seed, site, n), never on interleaving)
            | *       fire on every call

Every site of the grammar parses, so a spec written for the JAX package
parses here too, and this package draws every one: the solve site, the
mesh-device site (solver/mesh_health.py: one draw per health-hooked dispatch
or probe), the fake cloud provider's create and delete sites
(cloudprovider/fake.FakeCloudProvider, raising ``cloud_exception``), the
cloud site (the churn generator's spot reclaims, streaming/churn.py, over
``reclaim_targets``) and the process site (``crash_point``: the crash-point
visits of the streaming cycle, its journal and utils/persist.py, which the
restart harness testing/restart.py schedules). The optional
``[tenant]`` selector scopes a rule to one tenant stream of the serve layer:
it matches only while that tenant's scope is active (``tenant_scope``) and
counts that tenant's visits to the site. Probabilistic draws hash
``(seed, site, call#)`` with crc32, never the per-process salted
``hash()``. The injector records every firing in ``fired``. Hook sites call
:func:`active`, which is ``None`` unless an injector was installed or the
environment variable is set.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

SITES = ("solve", "create", "delete", "cloud", "proc", "device")
SOLVE_KINDS = ("compile", "device", "encode", "nan", "hang")
CLOUD_KINDS = ("ice", "ratelimit", "timeout")
# the sites below parse as in the JAX package. 'device' models one mesh
# device failing (its selector is the device index; drawn by
# solver/mesh_health.py), 'cloud' provider-initiated events (drawn once per
# churn cycle, streaming/churn.py) and 'proc' process death: 'crash' SIGKILLs
# the process at the N-th crash-point visit. Only the subprocess restart
# harness (testing/restart.py) schedules it: an in-process test that
# schedules proc.crash kills the test runner.
DEVICE_KINDS = ("loss", "degraded")
RECLAIM_KINDS = ("reclaim",)
PROC_KINDS = ("crash",)


class InjectedFault(RuntimeError):
    """Base for injected solver faults."""


class FaultCompileError(InjectedFault):
    """Injected kernel compile failure (classified 'compile')."""


class FaultDeviceError(InjectedFault):
    """Injected device/runtime failure (classified 'device', retryable)."""


class FaultEncodeError(InjectedFault):
    """Injected host-side encode failure (classified 'encode')."""


class FaultDeviceLost(FaultDeviceError):
    """Injected loss of ONE mesh device (``device[n].loss``): buffers and
    in-flight launches on that device are gone. Subclasses FaultDeviceError
    so the supervisor's retry classification ('device', retryable) applies
    unchanged; ``.device`` carries the lost index so the mesh-health layer
    knows what to exclude."""

    def __init__(self, message: str, device: int = 0):
        super().__init__(message)
        self.device = int(device)


class FaultDeviceDegraded(FaultDeviceLost):
    """Injected degraded mesh device (``device[n].degraded``): the dispatch
    wall time was inflated before this raised, a limping card rather than a
    dead one. Classified device-degraded by the mesh-health layer."""


@dataclass
class FaultRule:
    site: str
    kind: str
    param: float = 0.0
    start: int = 0  # 1-based inclusive; 0 = not schedule-based
    end: int = 0
    prob: float = -1.0  # >= 0 = probabilistic; -1 = schedule-based
    tenant: str = ""  # "" = any scope (global counter); else serve/ selector

    def site_key(self) -> str:
        return f"{self.site}[{self.tenant}]" if self.tenant else self.site

    def matches(self, n: int, seed: int) -> bool:
        if self.prob >= 0.0:
            draw = random.Random(
                zlib.crc32(f"{seed}:{self.site_key()}:{n}".encode())
            ).random()
            return draw < self.prob
        return self.start <= n <= self.end


def parse_spec(spec: str) -> Tuple[List[FaultRule], int]:
    """Parse a KARPENTER_TPU_FAULTS spec into (rules, seed). Raises
    ValueError on malformed entries — a typo'd chaos schedule silently
    injecting nothing would be worse than failing fast."""
    rules: List[FaultRule] = []
    seed = 0
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[len("seed="):])
            continue
        if "@" not in entry:
            raise ValueError(f"fault entry {entry!r}: missing '@sched'")
        head, sched = entry.rsplit("@", 1)
        param = 0.0
        if "=" in head:
            head, param_s = head.split("=", 1)
            param = float(param_s)
        tenant = ""
        if "[" in head:
            # site[tenant].kind — split on the bracket first so tenant ids
            # may contain dots (the serve layer uses cluster names as ids)
            site, rest = head.split("[", 1)
            if "]." not in rest:
                raise ValueError(
                    f"fault entry {entry!r}: expected site[tenant].kind"
                )
            tenant, kind = rest.split("].", 1)
            if not tenant:
                raise ValueError(f"fault entry {entry!r}: empty tenant selector")
        else:
            if "." not in head:
                raise ValueError(f"fault entry {entry!r}: expected site.kind")
            site, kind = head.split(".", 1)
        if site not in SITES:
            raise ValueError(f"fault entry {entry!r}: unknown site {site!r}")
        if site == "solve":
            allowed = SOLVE_KINDS
        elif site == "cloud":
            allowed = RECLAIM_KINDS
        elif site == "proc":
            allowed = PROC_KINDS
        elif site == "device":
            allowed = DEVICE_KINDS
            # the bracket selector is the device INDEX here, not a tenant
            if not tenant or not tenant.isdigit():
                raise ValueError(
                    f"fault entry {entry!r}: device rules need a device[N] "
                    f"index selector"
                )
        else:
            allowed = CLOUD_KINDS
        if kind not in allowed:
            raise ValueError(
                f"fault entry {entry!r}: kind {kind!r} not valid for {site!r}"
            )
        rule = FaultRule(site=site, kind=kind, param=param, tenant=tenant)
        if sched == "*":
            rule.start, rule.end = 1, 2**31
        elif sched.startswith("p"):
            rule.prob = float(sched[1:])
            if not 0.0 <= rule.prob <= 1.0:
                raise ValueError(f"fault entry {entry!r}: probability out of range")
        elif ".." in sched:
            a, b = sched.split("..", 1)
            rule.start, rule.end = int(a), int(b)
        else:
            rule.start = rule.end = int(sched)
        rules.append(rule)
    return rules, seed


# the tenant whose work is currently executing (serve/ dispatcher and the
# per-tenant SupervisedSolver set it around solves) — a contextvar so it
# follows the work across the deadline watchdog's copy_context() worker
_tenant_var: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "karpenter_tpu_fault_tenant", default=None
)


def current_tenant() -> Optional[str]:
    return _tenant_var.get()


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]):
    """Mark everything inside the block as belonging to ``tenant`` for
    tenant-selected fault rules (``site[tenant].kind``). ``None`` is the
    anonymous scope tenant rules never match."""
    token = _tenant_var.set(tenant)
    try:
        yield
    finally:
        _tenant_var.reset(token)


class FaultInjector:
    """Per-site call counter + first-matching-rule dispatch. ``fired`` logs
    (site, kind, call#) tuples so a chaos test can assert that the same spec
    and seed replay the same fault sequence. Tenant-selected rules keep their
    own per-(site, tenant) counters and log the selector as the site."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        rules, seed = parse_spec(spec)
        return cls(rules, seed)

    def reset(self) -> None:
        self._counts.clear()
        self.fired.clear()

    def calls(self, site: str) -> int:
        return self._counts.get(site, 0)

    def draw(self, site: str) -> Optional[FaultRule]:
        """Advance the site's call counter and return the first matching rule
        (or None). Call exactly once per hooked operation. Inside a
        ``tenant_scope`` the per-(site, tenant) counter advances too, and
        tenant-selected rules match against it — the tenant's schedule is
        independent of how other streams interleave on the shared site."""
        n = self._counts.get(site, 0) + 1
        self._counts[site] = n
        tenant = current_tenant()
        n_tenant = 0
        if tenant is not None:
            tkey = f"{site}[{tenant}]"
            n_tenant = self._counts.get(tkey, 0) + 1
            self._counts[tkey] = n_tenant
        for rule in self.rules:
            if rule.site != site:
                continue
            if rule.site == "device":
                # the selector names WHICH device fails, not when: device
                # rules always match against the global site counter (one
                # visit per health-hooked mesh dispatch or probe)
                if rule.matches(n, self.seed):
                    self.fired.append((rule.site_key(), rule.kind, n))
                    return rule
                continue
            if rule.tenant:
                if tenant != rule.tenant:
                    continue
                if rule.matches(n_tenant, self.seed):
                    self.fired.append((rule.site_key(), rule.kind, n_tenant))
                    return rule
            elif rule.matches(n, self.seed):
                self.fired.append((site, rule.kind, n))
                return rule
        return None


# -- fault realization helpers ------------------------------------------------


def raise_solve_fault(rule: FaultRule) -> None:
    """Raise the typed exception for a solve-site rule (hang/nan are handled
    in-line by the supervisor, not raised)."""
    if rule.kind == "compile":
        raise FaultCompileError(f"injected compile failure (call schedule {rule})")
    if rule.kind == "device":
        raise FaultDeviceError(f"injected device failure (call schedule {rule})")
    if rule.kind == "encode":
        raise FaultEncodeError(f"injected encode failure (call schedule {rule})")


def device_index(rule: FaultRule) -> int:
    """The mesh-device index a ``device``-site rule targets (the bracket
    selector; parse_spec guarantees it is an integer)."""
    return int(rule.tenant or 0)


def realize_device_fault(rule: FaultRule) -> None:
    """Raise the typed exception for a device-site rule. ``degraded``
    inflates the dispatch's wall time first (``param`` seconds, default
    0.02), the limping-card signature, then raises so the mesh-health layer
    classifies and recarves exactly like a loss."""
    dev = device_index(rule)
    if rule.kind == "degraded":
        time.sleep(rule.param if rule.param > 0 else 0.02)
        raise FaultDeviceDegraded(
            f"injected degraded device {dev} (call schedule {rule})", device=dev
        )
    raise FaultDeviceLost(
        f"injected loss of device {dev} (call schedule {rule})", device=dev
    )


def corrupt_result(result) -> None:
    """NaN-poison a SolveResult in place (the 'nan' kind): every new claim's
    request tensor gets a NaN, the signature of a diverged device reduction."""
    for claim in result.new_claims:
        for key in list(claim.requests):
            claim.requests[key] = float("nan")


def reclaim_targets(rule: FaultRule, names: Sequence[str], seed: int, call: int) -> List[str]:
    """Pick which live nodes a ``cloud.reclaim`` firing takes: a pure
    function of (seed, call#) over the sorted name list, so a replay with the
    same spec reclaims the same nodes whatever the listing order upstream.
    ``rule.param`` is the reclaim width (default 1)."""
    pool = sorted(names)
    if not pool:
        return []
    count = min(int(rule.param) if rule.param else 1, len(pool))
    rng = random.Random(zlib.crc32(f"{seed}:cloud.reclaim:{call}".encode()))
    return rng.sample(pool, count)


def crash_point(point: str) -> None:
    """Phase-boundary hook for ``proc.crash``: callers mark kill-eligible
    sites (cycle entry, journal pre/post-write, persist pre-rename) with a
    named visit. Each visit advances the shared 'proc' counter; the scheduled
    firing SIGKILLs the process (no atexit, no cleanup: the death an OOM kill
    or a node preemption delivers). With no injector it is one attribute
    read."""
    injector = active()
    if injector is None:
        return
    rule = injector.draw("proc")
    if rule is not None and rule.kind == "crash":
        import logging
        import signal

        logging.getLogger(__name__).warning("proc.crash firing at %s (call %d)", point, injector.calls("proc"))
        os.kill(os.getpid(), signal.SIGKILL)


def cloud_exception(rule: FaultRule) -> Exception:
    """The typed cloud-provider error for a create/delete-site rule."""
    from karpenter_tpu_torch.cloudprovider.types import (
        CreateTimeoutError,
        InsufficientCapacityError,
        RateLimitError,
    )

    if rule.kind == "ice":
        return InsufficientCapacityError("injected: insufficient capacity")
    if rule.kind == "ratelimit":
        return RateLimitError("injected: API rate limit exceeded")
    return CreateTimeoutError("injected: create timed out")


# -- ambient installation -----------------------------------------------------

_injector: Optional[FaultInjector] = None
_env_injector: Optional[FaultInjector] = None
_env_spec: Optional[str] = None


def install(injector: Optional[FaultInjector]) -> None:
    """Install a process-wide injector (tests). Overrides the env spec."""
    global _injector
    _injector = injector


def clear() -> None:
    global _injector, _env_injector, _env_spec
    _injector = None
    _env_injector = None
    _env_spec = None


def active() -> Optional[FaultInjector]:
    """The injector hook sites consult: the installed one, else one built
    from KARPENTER_TPU_FAULTS (rebuilt if the env value changed), else None."""
    global _env_injector, _env_spec
    if _injector is not None:
        return _injector
    spec = os.environ.get("KARPENTER_TPU_FAULTS")
    if not spec:
        _env_injector = None
        _env_spec = None
        return None
    if spec != _env_spec:
        _env_injector = FaultInjector.from_spec(spec)
        _env_spec = spec
    return _env_injector
