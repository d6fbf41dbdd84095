"""Running a JAX-package test scenario through the port.

The port's test modules hold the port to the JAX package by running the same
scenario twice: through the JAX package's harness (tests/harness.Env) and
through the port's (karpenter_tpu_torch.testing.harness.Env). The scenarios
build the JAX package's API objects (tests/factories.py); the port's harness
converts each object it is handed into the port's class of the same name
(``to_port``), field by field, at its kube boundary (``PortKube``).

``run_scenario`` runs a scenario function with its ``Env`` bound to one
harness (also where the function imports it from ``tests.harness``). With
``port=True`` it also rebinds what the scenario names of the
JAX package to the port: its module globals (classes, functions, modules and
the helpers of the test modules and of tests/factories.py that name them, so
the factories build the port's objects) and its function-level imports
(``from karpenter_tpu.x import y`` resolves in ``karpenter_tpu_torch.x``;
``from tests.harness import Env`` gives the port's Env).

``assert_same_run`` runs a scenario through both packages and compares what
it left: the Envs and Operators it built (claims, nodes with their taints,
bindings, pending pods, event reasons in order), the disruption commands
executed, and the counters it moved (label sets and values; the
program-cache lookups of the solves only, since the two harnesses' solvers
differ in whether a gate follows each solve).
"""

from __future__ import annotations

import builtins
import contextlib
import enum
import importlib
import inspect
import itertools
import os
import types
import uuid

import tests.factories as factories
from karpenter_tpu.apis import labels as wk
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing.harness import Env as PEnv

_J, _P = "karpenter_tpu.", "karpenter_tpu_torch."


def port_name(name: str) -> str:
    """The port's module path for a JAX-package module path."""
    if name == "karpenter_tpu" or name.startswith(_J):
        return "karpenter_tpu_torch" + name[len("karpenter_tpu"):]
    return name


def port_class(cls):
    """The port's class (or function) of the same module path and name as a
    JAX-package one; anything else as it is."""
    if not cls.__module__.startswith(_J):
        return cls
    out = importlib.import_module(port_name(cls.__module__))
    for part in cls.__qualname__.split("."):
        out = getattr(out, part)
    return out


def to_port(x):
    """A copy of ``x`` with every JAX-package object replaced, field by
    field, by an object of the port's class of the same name."""
    if x is None or isinstance(x, (str, bytes, int, float, bool)):
        return x
    if isinstance(x, type):
        return port_class(x)
    if type(x).__module__.startswith(_J) and isinstance(x, (list, dict)):
        # a JAX-package container class (scheduling.Taints is a list)
        y = port_class(type(x))(to_port(list(x.items()) if isinstance(x, dict) else list(x)))
        y.__dict__.update({k: to_port(v) for k, v in getattr(x, "__dict__", {}).items()})
        return y
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return type(x)(to_port(v) for v in x)
    if isinstance(x, dict):
        return {to_port(k): to_port(v) for k, v in x.items()}
    cls = type(x)
    if not cls.__module__.startswith(_J):
        return x
    pcls = port_class(cls)
    if isinstance(x, enum.Enum):
        return pcls(x.value)
    y = object.__new__(pcls)
    if not hasattr(x, "__dict__"):
        for k in (k for c in cls.__mro__ for k in getattr(c, "__slots__", ())):
            if hasattr(x, k):
                setattr(y, k, to_port(getattr(x, k)))
        return y
    for k, v in vars(x).items():
        y.__dict__[k] = to_port(v)
    return y


# what the kube writes back into the object it is handed (create, update)
_WRITTEN_BACK = ("resource_version", "generation", "creation_timestamp")


class PortKube:
    """The port's KubeClient, handed JAX-package objects and classes. What
    the store writes back into an object it is handed lands in the caller's
    object too, so a scenario can update an object it created."""

    def __init__(self, kube):
        self._kube = kube

    def __getattr__(self, name):
        fn = getattr(self._kube, name)
        if not callable(fn):
            return fn

        def call(*args, **kwargs):
            ported = [to_port(a) for a in args]
            out = fn(*ported, **{k: to_port(v) for k, v in kwargs.items()})
            for a, p in zip(args, ported):
                if a is not p and hasattr(a, "metadata") and hasattr(p, "metadata"):
                    for field in _WRITTEN_BACK:
                        setattr(a.metadata, field, getattr(p.metadata, field))
            return out

        return call


def relax() -> bool:
    # the JAX backend reads KARPENTER_TPU_RELAX (the suite's conftest turns
    # it off); the port's backend takes it as an argument
    return os.environ.get("KARPENTER_TPU_RELAX", "1") != "0"


def port_solver(well_known=FAKE_WELL_KNOWN_LABELS):
    return SupervisedSolver(TorchSolver(device="cpu", well_known=well_known, relax=relax()),
                            fallback=OracleSolver())


class PortEnv(PEnv):
    """The port's harness over the supervised CPU solve, with a kube that
    converts what the scenario hands it."""

    def __init__(self, solver=None):
        super().__init__(solver=solver if solver is not None else port_solver())
        self.kube = PortKube(self.kube)


class BarePortEnv(PortEnv):
    """The port's harness over ``TorchSolver(device="cpu")`` alone."""

    def __init__(self):
        super().__init__(solver=TorchSolver(device="cpu", well_known=FAKE_WELL_KNOWN_LABELS, relax=relax()))


class _NoCounterpart:
    """What the port's run sees for a JAX class or function that has no
    counterpart in the port and that no override names: using it fails the
    scenario, so it never runs JAX code in the port's run."""

    def __init__(self, jax_obj, exc):
        self.__dict__["_what"] = f"{jax_obj.__module__}.{jax_obj.__qualname__} has no port counterpart ({exc})"

    def __getattr__(self, attr):
        raise AssertionError(self._what)

    def __call__(self, *args, **kwargs):
        raise AssertionError(self._what)


class _Rebound:
    """A scenario's functions made anew with ``Env`` (also as imported from
    ``tests.harness`` inside a function) bound to ``env`` and ``overrides``
    applied; with ``port``, also with its names of the JAX package rebound
    to the port (see the module docstring). The helpers of the test modules
    that a scenario names are made anew alike."""

    def __init__(self, env, overrides, port):
        self.env = env
        self.overrides = overrides
        self.port = port
        self.done = {}
        self.harness = types.SimpleNamespace(Env=env)
        self.builtins = dict(vars(builtins), __import__=self.import_)

    def import_(self, name, globals=None, locals=None, fromlist=(), level=0):
        if name == "tests.harness" and fromlist:
            return self.harness
        return builtins.__import__(port_name(name) if self.port else name, globals, locals, fromlist, level)

    def value(self, v):
        if isinstance(v, types.FunctionType) and v.__module__.startswith("tests.test_"):
            return self.function(v)
        if not self.port:
            return v
        if isinstance(v, types.FunctionType) and v.__module__ == "tests.factories":
            return self.function(v)
        if isinstance(v, types.ModuleType):
            return importlib.import_module(port_name(v.__name__)) if v.__name__.startswith(_J) else v
        if isinstance(v, (type, types.FunctionType)) and v.__module__.startswith(_J):
            try:
                return port_class(v)
            except (ImportError, AttributeError) as exc:
                return _NoCounterpart(v, exc)
        return v

    def function(self, fn):
        if fn not in self.done:
            # a function takes its builtins (and so ``__import__``) from its
            # globals when it is made
            g = {"__builtins__": self.builtins}
            self.done[fn] = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
            g.update((k, self.value(v)) for k, v in fn.__globals__.items()
                     if k != "__builtins__" and k not in self.overrides)
            g.update(Env=self.env, **self.overrides)
        return self.done[fn]


def run_scenario(fn, env_cls, overrides=None, digest=None, port=False, args=()):
    """Run scenario ``fn`` (on ``args``) with its module's ``Env`` (and
    ``overrides``) replaced, and with ``port`` its names of the JAX package
    rebound to the port; the digests of the Envs it built, in order, and the
    Envs."""
    envs = []

    def factory(*args, **kwargs):
        env = env_cls(*args, **kwargs)
        envs.append(env)
        return env

    factories._seq = itertools.count()  # the same generated pod names in both runs
    _Rebound(factory, overrides or {}, port).function(fn)(*args)
    return [digest(e) for e in envs] if digest is not None else [], envs


# -- disruption scenarios ----------------------------------------------------


def _pkg(env) -> str:
    return "karpenter_tpu_torch" if isinstance(env, PEnv) or type(env).__module__.startswith(_P) \
        or getattr(env, "port", False) else "karpenter_tpu"


def _reqs(reqs):
    return sorted((r.key, r.operator, tuple(sorted(r.values or ()))) for r in reqs)


def command_digest(cmd) -> tuple:
    """An executed command: method, type, decision, candidates, and each
    replacement's requirements and instance-type names."""
    return (
        cmd.method,
        cmd.consolidation_type,
        cmd.decision,
        [c.name for c in cmd.candidates],
        [
            (_reqs(r.spec.requirements),
             sorted(v for q in r.spec.requirements if q.key == wk.LABEL_INSTANCE_TYPE_STABLE for v in q.values))
            for r in cmd.replacements
        ],
    )


def disruption_digest(env) -> dict:
    """What a disruption scenario left: every NodeClaim and Node with its
    labels, requirements and taints, the pod bindings, the pending pods, the
    recorder's event reasons in order, and the commands executed."""
    objects = importlib.import_module(_pkg(env) + ".apis.objects")
    claim_cls = importlib.import_module(_pkg(env) + ".apis.nodeclaim").NodeClaim
    pods = env.kube.list(objects.Pod)
    return {
        "claims": [
            (c.metadata.name, sorted(c.metadata.labels.items()), _reqs(c.spec.requirements),
             [(t.key, t.value, t.effect) for t in c.spec.taints])
            for c in env.kube.list(claim_cls)
        ],
        "nodes": [
            (n.metadata.name, sorted(n.metadata.labels.items()), [(t.key, t.value, t.effect) for t in n.spec.taints])
            for n in env.kube.list(objects.Node)
        ],
        "bindings": sorted((p.metadata.namespace, p.metadata.name, p.spec.node_name) for p in pods if p.spec.node_name),
        "pending": sorted((p.metadata.namespace, p.metadata.name) for p in pods if not p.spec.node_name),
        "events": [e.reason for e in env.recorder.events],
    }


@contextlib.contextmanager
def _recorded_run(package: str, executed: list):
    """Record every command a ``package`` Controller executes, and number the
    uuids the run draws (NodeClaim names take their first 8 hex digits), so
    both packages' runs name their claims alike."""
    ctrl = importlib.import_module(package + ".disruption.controller").Controller
    orig_execute, orig_uuid = ctrl._execute, uuid.uuid4
    seq = itertools.count(1)

    def execute(self, command):
        executed.append(command_digest(command))
        return orig_execute(self, command)

    ctrl._execute = execute
    uuid.uuid4 = lambda: uuid.UUID(int=next(seq) << 96)
    # the gate's audit draws are seeded by a per-process call count: start
    # both packages' runs from the same count
    importlib.import_module(package + ".verify.gate")._audit_calls = 0
    try:
        yield
    finally:
        ctrl._execute, uuid.uuid4 = orig_execute, orig_uuid


def run_disruption(fn, port: bool, overrides=None, args=()):
    """One run of disruption scenario ``fn`` through one package's harness:
    the JAX package's (tests.harness.Env over JaxSolver) or the port's
    (``PortEnv``, the supervised CPU solve). Returns (digests of its Envs,
    the commands executed, the Envs)."""
    digests, executed, _, envs = run_pair_side(fn, port, overrides, args)
    return digests, executed, envs


def scenario_args(fn, request, skip_self=False) -> tuple:
    """The fixtures a scenario function takes (``monkeypatch``), from the
    calling test's ``request`` (less ``self`` for a test class's method)."""
    names = list(inspect.signature(fn).parameters)
    return tuple(request.getfixturevalue(name) for name in names[1 if skip_self else 0:])


def assert_same_disruption(fn, request, port_overrides=None):
    """``assert_same_run`` of a disruption scenario; the port's supervised
    solve never fails over."""
    for env in assert_same_run(fn, request, p_overrides=port_overrides):
        sup = env.provisioner.solver
        assert sup.counters["solve_fallbacks"] == 0 and sup.circuit_state() == "closed"


# -- operators and counters -------------------------------------------------


def operator_class(port: bool):
    """The Operator the scenario builds in one package's run. In the port's
    run its ``kube`` converts what the scenario hands it (``PortKube``); its
    controllers keep the store itself."""
    from karpenter_tpu.operator import Operator as JOperator
    from karpenter_tpu_torch.operator import Operator as POperator

    if not port:
        return JOperator

    class PortOperator(POperator):
        port = True

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.kube = PortKube(self.kube)

    return PortOperator


def forced_options(port: bool, **forced):
    """One package's Options with ``forced`` fields over what the scenario
    asks for (``Options.parse`` included)."""
    cls = importlib.import_module((_P if port else _J) + "operator.options").Options

    class Forced(cls):
        def __init__(self, **kwargs):
            super().__init__(**{**kwargs, **forced})

    return Forced


def counters(port: bool) -> dict:
    """Every counter series of one package's registry: {name: {labels:
    value}}."""
    reg = importlib.import_module((_P if port else _J) + "metrics.registry").REGISTRY
    return {m.name: {tuple(sorted(labels.items())): v for _, _, labels, v in m.collect()}
            for _, m in sorted(reg._metrics.items()) if m.kind == "counter"}


def moved(before: dict, after: dict, names) -> dict:
    """The counters of ``names`` a run moved: {name: {labels: delta}}."""
    out = {}
    for name in names:
        b, a = before.get(name, {}), after.get(name, {})
        delta = {k: v - b.get(k, 0.0) for k, v in a.items() if v != b.get(k, 0.0)}
        if delta:
            out[name] = delta
    return out


# bytes moved between host and device: the two packages copy different
# tensors, so only the directions are compared
BYTES_COUNTERS = ("karpenter_solver_transfer_bytes_total",)
# program-cache lookups: the JAX harness's Env solves on a bare JaxSolver,
# the port's on a SupervisedSolver, whose validation runs the device gate
# after each solve; so the gate's lookups (verify/gate._device_counts) are
# taken out of each side's counts and the solves' lookups compared exactly
COMPILE_CACHE = "karpenter_solver_compile_cache_total"


@contextlib.contextmanager
def _fresh_program_caches(pkg: str):
    """One package's program-cache sets empty while the block runs (and
    merged back after), so that a scenario's hits and misses do not depend
    on what the tests before it dispatched in this process."""
    sets = [getattr(importlib.import_module(pkg + mod), name)
            for mod, name in ((".solver.jax_backend" if pkg == _J[:-1] else ".solver.torch_backend",
                               "_COMPILED_PROGRAMS"), (".verify.gate", "_SEEN_GATE_PROGRAMS"))]
    saved = [set(s) for s in sets]
    for s in sets:
        s.clear()
    try:
        yield
    finally:
        for s, old in zip(sets, saved):
            s |= old


@contextlib.contextmanager
def _gate_lookups(pkg: str, out: dict):
    """Count one package's gate program-cache lookups by result while the
    block runs."""
    gate = importlib.import_module(pkg + ".verify.gate")
    real = gate._device_counts

    def counted(*args, **kwargs):
        seen = len(gate._SEEN_GATE_PROGRAMS)
        try:
            return real(*args, **kwargs)
        finally:
            result = "miss" if len(gate._SEEN_GATE_PROGRAMS) > seen else "hit"
            out[(("result", result),)] = out.get((("result", result),), 0) + 1

    gate._device_counts = counted
    try:
        yield
    finally:
        gate._device_counts = real


def run_pair_side(fn, port: bool, overrides=None, args=()):
    """One package's run of scenario ``fn``: (digests of the Envs and
    Operators it built, in order, the commands executed, the counters it
    moved, the Envs and Operators)."""
    from tests.harness import Env as JEnv

    built: list = []
    op_cls = operator_class(port)

    def operator(*a, **kw):
        op = op_cls(*a, **kw)
        built.append(op)
        return op

    executed: list = []
    gate_lookups: dict = {}
    before = counters(port)
    pkg = _P[:-1] if port else _J[:-1]
    with _recorded_run(pkg, executed), _fresh_program_caches(pkg), _gate_lookups(pkg, gate_lookups):
        _, envs = run_scenario(fn, PortEnv if port else JEnv, {"Operator": operator, **(overrides or {})},
                               port=port, args=args)
    after = counters(port)
    # the solves' program-cache lookups: the gate's taken out (COMPILE_CACHE)
    for labels, n in gate_lookups.items():
        after.setdefault(COMPILE_CACHE, {})[labels] = after.get(COMPILE_CACHE, {}).get(labels, 0.0) - n
    return [disruption_digest(e) for e in envs + built], executed, (before, after), envs + built


def assert_same_run(fn, request, j_overrides=None, p_overrides=None, digest=True, self_arg=False):
    """Run ``fn`` through both packages: its own assertions hold on each,
    and with ``digest`` the two must leave the same claims, nodes, bindings,
    pending pods and events, execute the same commands and move the same
    counters (of the series the port registers; the bytes counters by
    label set; the program-cache lookups of the solves, COMPILE_CACHE). A
    scenario that is a test class's method gets ``self_arg``."""
    args = ((None,) if self_arg else ()) + scenario_args(fn, request, skip_self=self_arg)
    jd, jx, (jb, ja), _ = run_pair_side(fn, False, j_overrides, args)
    pargs = ((None,) if self_arg else ()) + tuple(to_port(a) for a in args[1 if self_arg else 0:])
    pd, px, (pb, pa), built = run_pair_side(fn, True, p_overrides, pargs)
    if not digest:
        return built
    assert px == jx, f"commands: port {px} != JAX {jx}"
    assert len(pd) == len(jd)
    for i, (p, j) in enumerate(zip(pd, jd)):
        bad = [k for k in j if p[k] != j[k]]
        assert not bad, f"run {i}: " + "; ".join(f"{k}: port {p[k]} != JAX {j[k]}" for k in bad)
    names = [n for n in pa if n in ja]
    jm, pm = moved(jb, ja, names), moved(pb, pa, names)
    for name in BYTES_COUNTERS:
        for m in (jm, pm):
            if name in m:
                m[name] = sorted(m[name])
    assert pm == jm, f"counters: port {pm} != JAX {jm}"
    return built
