"""The Provisioner entry point of the port against the JAX package's.

Every scenario of tests/test_provisioning.py runs twice: through the JAX
package's harness (tests/harness.Env over ``JaxSolver``) and through the
port's (karpenter_tpu_torch.testing.harness.Env over
``SupervisedSolver(TorchSolver(device="cpu"), fallback=OracleSolver())``).
The scenario's own assertions run against both. Then the two runs must
agree on what they produced: the created NodeClaims in creation order (pool,
requirements, labels, taints, requests), every pod's binding, the pods left
pending, and the recorder's event reasons in order. NodeClaim names carry a
random suffix, so they are compared by creation order.

The scenarios build the JAX package's API objects (tests/factories.py); the
port's harness converts each object it is handed into the port's class of the
same name (``to_port``), field by field, at its kube boundary
(tests/torch_port.py).

Left out of the 36 scenarios, and why: ``test_full_pass_through_jax_backend``,
which names the JAX backend; its scenario runs here through the port's
backend (``test_full_pass_through_port_backend``). ``test_batcher_window``
and ``test_pod_watch_triggers_batcher`` drive the port's batcher and pod
watch (provisioning/batcher.py, controller.py).

One scenario runs the port's backend without the supervisor:
``test_packs_in_flight_claims_before_launching_new_nodes`` places a pod on a
launched but unregistered NodeClaim, and the supervisor's validator rejects
that placement (node-capacity: the in-flight node has no allocatable yet) in
both packages, so the supervised stacks of both fall back and end alike
(``test_in_flight_claim_rejected_by_both_supervisors``), while the JAX
harness's bare ``JaxSolver`` places it.

Also: a sample of tests/test_topology_families.py and
tests/test_affinity_families.py shapes as provisioning passes, one pass with
``KARPENTER_TPU_WAVEFRONT=1`` (IterCounts and the width histogram equal the
JAX package's), the validation errors, and the Provisioner's default solver,
which needs the card and raises on this CPU-only host.
"""

from __future__ import annotations

import importlib
import inspect

import pytest

import tests.test_provisioning as TP
import tests.torch_port as torch_port
import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.apis.objects import (
    IN,
    Affinity,
    LabelSelector,
    NodeSelectorRequirement,
    PodAffinity,
    PodAffinityTerm,
    TopologySpreadConstraint,
)
from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS as J_FAKE_LABELS
from tests.factories import make_anti_affinity_pod, make_node, make_nodepool, make_pod
from tests.harness import Env as JEnv
from tests.torch_port import BarePortEnv, PortEnv, to_port
from tests.torch_port import relax as _relax
from karpenter_tpu_torch.apis import validation as p_validation
from karpenter_tpu_torch.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS, FakeCloudProvider
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.kube import KubeClient
from karpenter_tpu_torch.provisioning import provisioner as p_provisioner
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.state import Cluster
from karpenter_tpu_torch.testing.harness import Env as PEnv
from karpenter_tpu_torch.utils.clock import FakeClock


@pytest.fixture(autouse=True)
def _forensics_dirs(tmp_path, monkeypatch):
    # the supervisor's quarantine and flight dumps stay in the test's tmp dir
    monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


def _claim_class(env):
    return (p_provisioner.NodeClaim if isinstance(env, PEnv) else importlib.import_module(
        "karpenter_tpu.apis.nodeclaim").NodeClaim)


def _pod_class(env):
    return importlib.import_module(("karpenter_tpu_torch" if isinstance(env, PEnv) else "karpenter_tpu")
                                   + ".apis.objects").Pod


def digest(env) -> dict:
    """What a run produced, with claim names replaced by their creation
    ordinal."""
    claims = env.kube.list(_claim_class(env))
    names = {c.metadata.name: f"claim{i}" for i, c in enumerate(claims)}

    def norm(s: str) -> str:
        for name, alias in names.items():
            s = s.replace(name, alias)
        return s

    pods = env.kube.list(_pod_class(env))
    return {
        "claims": [
            (
                c.metadata.labels.get(wk.NODEPOOL_LABEL_KEY),
                sorted((r.key, r.operator, tuple(sorted(r.values))) for r in c.spec.requirements),
                sorted((k, norm(v)) for k, v in c.metadata.labels.items()),
                [(t.key, t.value, t.effect) for t in c.spec.taints],
                sorted(c.spec.resource_requests.items()),
            )
            for c in claims
        ],
        "bindings": sorted((p.metadata.namespace, p.metadata.name, norm(p.spec.node_name))
                           for p in pods if p.spec.node_name),
        "pending": sorted((p.metadata.namespace, p.metadata.name) for p in pods if not p.spec.node_name),
        "events": [e.reason for e in env.recorder.events],
    }


def run_scenario(fn, env_cls, overrides=None):
    """Run scenario ``fn`` with its module's ``Env`` (and ``overrides``)
    replaced; the digests of the Envs it built, in order, and the Envs."""
    return torch_port.run_scenario(fn, env_cls, overrides, digest=digest)


# The scenarios below name ``Env``, which ``run_scenario`` binds to the harness
# of one package or the other.

_PORT_OVERRIDES = {
    "validate_pod": lambda pod: p_provisioner.validate_pod(to_port(pod)),
    "ValidationError": p_provisioner.ValidationError,
}

# tests/test_provisioning.py's scenarios in source order, less the one the
# module docstring names
EXCLUDED = ("test_full_pass_through_jax_backend",)
SCENARIOS = sorted(
    (name for name, fn in vars(TP).items()
     if name.startswith("test_") and inspect.isfunction(fn) and name not in EXCLUDED),
    key=lambda name: getattr(TP, name).__code__.co_firstlineno,
)


def test_scenario_list_is_whole():
    assert len(SCENARIOS) + len(EXCLUDED) == 36


# the scenario the supervisors' validator rejects (module docstring)
UNSUPERVISED = ("test_packs_in_flight_claims_before_launching_new_nodes",)


@pytest.mark.parametrize("name", SCENARIOS)
def test_provisioning_scenario(name):
    fn = getattr(TP, name)
    jd, _ = run_scenario(fn, JEnv)
    td, envs = run_scenario(fn, BarePortEnv if name in UNSUPERVISED else PortEnv, _PORT_OVERRIDES)
    assert td == jd
    for env in envs:
        sup = env.provisioner.solver
        if isinstance(sup, SupervisedSolver):
            assert sup.counters["solve_fallbacks"] == 0 and sup.circuit_state() == "closed"


def test_in_flight_claim_rejected_by_both_supervisors():
    """The in-flight scenario under each package's supervised stack: both
    validators reject the placement on the unregistered claim, both fall
    back, and the runs end alike (the scenario's own assertion on the
    placement fails in both)."""
    from karpenter_tpu.solver.jax_backend import JaxSolver
    from karpenter_tpu.solver.oracle import OracleSolver as JOracle
    from karpenter_tpu.solver.supervisor import SupervisedSolver as JSupervised

    fn = getattr(TP, UNSUPERVISED[0])
    runs = []
    for env_cls, overrides in (
        (lambda: JEnv(solver=JSupervised(JaxSolver(well_known=J_FAKE_LABELS), fallback=JOracle())), None),
        (PortEnv, _PORT_OVERRIDES),
    ):
        envs = []

        def factory(env_cls=env_cls, envs=envs):
            envs.append(env_cls())
            return envs[-1]

        with pytest.raises(AssertionError):
            run_scenario(fn, factory, overrides)
        runs.append((digest(envs[0]), envs[0].provisioner.solver.counters["solve_fallbacks"]))
    assert runs[0] == runs[1]
    assert runs[1][1] >= 1


def _port_backend_pass():
    """tests/test_provisioning.py ``test_full_pass_through_jax_backend``'s
    scenario (``Env`` is the harness ``run_scenario`` hands it)."""
    env = Env()
    env.create(make_nodepool())
    env.create(make_node(name="n1", provider_id="p1", nodepool="default",
                         capacity={"cpu": 2.0, "memory": 8 * 1024.0**3, "pods": 110.0},
                         registered=True, initialized=True))
    pods = [make_pod(cpu=1.0) for _ in range(4)]
    env.expect_provisioned(*pods)
    for p in pods:
        env.expect_scheduled(p)
    assert len(env.nodeclaims()) >= 1


def test_full_pass_through_port_backend():
    """The whole pass through the port's backend alone (no supervisor, the
    default well-known labels), against the JAX package's over JaxSolver."""
    from karpenter_tpu.solver.jax_backend import JaxSolver

    jd, _ = run_scenario(_port_backend_pass, lambda: JEnv(solver=JaxSolver()))
    td, envs = run_scenario(_port_backend_pass, lambda: PortEnv(solver=TorchSolver(device="cpu", relax=_relax())))
    assert td == jd
    assert envs[0].provisioner.solver.last_iters is not None


# -- provisioning passes of the topology and affinity families ----------------


def _spread(key, skew=1, when="DoNotSchedule", app="web", min_domains=None):
    return TopologySpreadConstraint(max_skew=skew, topology_key=key, when_unsatisfiable=when,
                                    label_selector=LabelSelector(match_labels={"app": app}),
                                    min_domains=min_domains)


def _aff(key, app="db"):
    return Affinity(pod_affinity=PodAffinity(required=[
        PodAffinityTerm(topology_key=key, label_selector=LabelSelector(match_labels={"app": app}))]))


def family_zonal_spread():
    # test_topology_families: zonal DoNotSchedule spread over the fake zones
    env = Env()
    env.create(make_nodepool())
    env.expect_provisioned(*[make_pod(cpu=0.5, labels={"app": "web"},
                                      topology_spread=[_spread(wk.LABEL_TOPOLOGY_ZONE)]) for _ in range(9)])


def family_capacity_type_spread():
    # TestCapacityTypeSpread: spread over capacity types, the pool limited to
    # on-demand so the skew caps the batch
    env = Env()
    env.create(make_nodepool(requirements=[
        NodeSelectorRequirement(wk.CAPACITY_TYPE_LABEL_KEY, IN, [wk.CAPACITY_TYPE_ON_DEMAND])]))
    env.expect_provisioned(*[make_pod(cpu=1.0, labels={"app": "web"},
                                      topology_spread=[_spread(wk.CAPACITY_TYPE_LABEL_KEY)]) for _ in range(5)])


def family_min_domains():
    # TestMinDomainsFamilies: minDomains above the zone count forces min 0
    env = Env()
    env.create(make_nodepool())
    env.expect_provisioned(*[make_pod(cpu=0.5, labels={"app": "web"}, topology_spread=[
        _spread(wk.LABEL_TOPOLOGY_ZONE, min_domains=5)]) for _ in range(6)])


def family_hostname_spread_two_rounds():
    # hostname spread across two passes: the second sees the first's nodes
    env = Env()
    env.create(make_nodepool())
    env.expect_provisioned(*[make_pod(cpu=0.5, labels={"app": "web"},
                                      topology_spread=[_spread(wk.LABEL_HOSTNAME, skew=2)]) for _ in range(4)])
    env.expect_provisioned(*[make_pod(cpu=0.5, labels={"app": "web"},
                                      topology_spread=[_spread(wk.LABEL_HOSTNAME, skew=2)]) for _ in range(3)])


def family_self_affinity_hostname():
    # TestSelfAffinity: self-affinity pods co-locate on one fresh hostname
    env = Env()
    env.create(make_nodepool())
    env.expect_provisioned(*[make_pod(cpu=0.2, labels={"app": "db"}, affinity=_aff(wk.LABEL_HOSTNAME))
                             for _ in range(10)])


def family_affinity_zone_peers():
    # affinity to peers placed in the same batch, by zone
    env = Env()
    env.create(make_nodepool())
    peers = [make_pod(cpu=0.5, labels={"app": "db"}) for _ in range(2)]
    followers = [make_pod(cpu=0.5, affinity=_aff(wk.LABEL_TOPOLOGY_ZONE)) for _ in range(4)]
    env.expect_provisioned(*followers, *peers)


def family_anti_affinity_hostname():
    # TestAntiAffinityOrdering: hostname anti-affinity opens a claim per pod
    env = Env()
    env.create(make_nodepool())
    env.expect_provisioned(*[make_anti_affinity_pod(cpu=0.5) for _ in range(4)])


FAMILIES = [family_zonal_spread, family_capacity_type_spread, family_min_domains,
            family_hostname_spread_two_rounds, family_self_affinity_hostname,
            family_affinity_zone_peers, family_anti_affinity_hostname]


@pytest.mark.parametrize("scenario", FAMILIES, ids=lambda f: f.__name__)
def test_family_provisioning(scenario):
    jd, _ = run_scenario(scenario, JEnv)
    td, _ = run_scenario(scenario, PortEnv)
    assert td == jd


def _wave_batch():
    env = Env()
    env.create(make_nodepool())
    pods = []
    for i in range(40):
        letter = "abcde"[i % 5]
        if i % 3 == 0:
            pods.append(make_pod(cpu=0.5, labels={"app": letter},
                                 topology_spread=[_spread(wk.LABEL_TOPOLOGY_ZONE, app=letter)]))
        else:
            pods.append(make_pod(cpu=[0.25, 1.0, 1.5][i % 3], labels={"app": letter}))
    env.expect_provisioned(*pods)
    return env


def test_wavefront_provisioning_pass(monkeypatch):
    """One pass with ``KARPENTER_TPU_WAVEFRONT=1``: the same claims, bindings
    and events, and the solver's IterCounts and width histogram equal the
    JAX package's (the extra lanes act)."""
    monkeypatch.setenv("KARPENTER_TPU_WAVEFRONT", "1")
    jd, jenvs = run_scenario(_wave_batch, JEnv)
    td, tenvs = run_scenario(_wave_batch, PortEnv)
    assert td == jd
    js = jenvs[0].provisioner.solver
    ts = tenvs[0].provisioner.solver.primary
    assert tuple(ts.last_iters) == tuple(int(x) for x in js.last_iters)
    assert ts.last_wave_hist == js.last_wave_hist
    assert ts.last_iters.wave_commits + ts.last_iters.retry_lanes > 0


# -- validation ----------------------------------------------------------------


def _bad_pools():
    from karpenter_tpu.apis.objects import Taint

    return {
        "restricted-label": make_nodepool(labels={wk.LABEL_HOSTNAME: "x"}),
        "bad-operator": make_nodepool(requirements=[NodeSelectorRequirement("team", "Sometimes", ["a"])]),
        "in-without-values": make_nodepool(requirements=[NodeSelectorRequirement("team", IN, [])]),
        "bad-taint-effect": make_nodepool(taints=[Taint(key="k", value="v", effect="Sometimes")]),
        "weight-out-of-range": make_nodepool(weight=1000),
        "fine": make_nodepool(),
    }


@pytest.mark.parametrize("case", sorted(_bad_pools()))
def test_validate_nodepool_errors(case):
    from karpenter_tpu.apis.validation import validate_nodepool

    pool = _bad_pools()[case]
    errors = p_validation.validate_nodepool(to_port(pool))
    assert errors == validate_nodepool(pool)
    assert bool(errors) == (case != "fine")


def _bad_pods():
    from karpenter_tpu.apis.objects import PodAntiAffinity

    return {
        "restricted-selector": make_pod(node_selector={wk.LABEL_HOSTNAME: "pin"}),
        "zero-skew": make_pod(topology_spread=[TopologySpreadConstraint(max_skew=0, topology_key="zone")]),
        "spread-without-key": make_pod(topology_spread=[TopologySpreadConstraint(max_skew=1, topology_key="")]),
        "affinity-without-key": make_pod(affinity=Affinity(pod_anti_affinity=PodAntiAffinity(
            required=[PodAffinityTerm(topology_key="", label_selector=LabelSelector(match_labels={"a": "b"}))]))),
    }


@pytest.mark.parametrize("case", sorted(_bad_pods()))
def test_validate_pod_errors(case):
    from karpenter_tpu.provisioning.provisioner import ValidationError, validate_pod

    pod = _bad_pods()[case]
    with pytest.raises(ValidationError) as jerr:
        validate_pod(pod)
    with pytest.raises(p_provisioner.ValidationError) as terr:
        p_provisioner.validate_pod(to_port(pod))
    assert str(terr.value) == str(jerr.value)


# -- the default solver ----------------------------------------------------------


def test_default_solver_needs_the_card(monkeypatch):
    """``Provisioner(solver=None)`` builds the supervised solve on the card;
    without CUDA it raises instead of solving on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clock = FakeClock()
    kube = KubeClient(clock=clock)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_provisioner.Provisioner(kube, FakeCloudProvider(), Cluster(kube, clock), clock, Recorder(clock=clock))
    with pytest.raises(RuntimeError, match="CUDA"):
        PEnv()


def test_fake_labels_match():
    assert FAKE_WELL_KNOWN_LABELS == J_FAKE_LABELS
