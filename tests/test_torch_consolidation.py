"""The port's consolidation methods against the JAX package's, and the screen
as the disruption controller drives it.

Every scenario of tests/test_consolidation_families.py,
tests/test_consolidation_replace_families.py and
tests/test_consolidation_ttl_families.py runs through both packages' harnesses
as tests/test_torch_disruption.py runs its scenarios (tests/torch_port.py):
its own assertions hold on both, and the commands executed, the NodeClaims
and Nodes left with their taints, the pod bindings, the event reasons and
the counters moved must be equal. None is left out.

Also:
  * ``build_scorer``'s verdicts against the JAX package's on the same
    clusters, one relax-free and one with a zonal spread (the full screen);
  * one ``runs_screen`` dispatch and one scorer build per reconcile pass;
  * the scorer runs on the solver's device, and without a solver device on
    the package default (CUDA), which raises without a card;
  * an error of the port's kernels (``KernelDeviceError``) inside the screen
    propagates out of ``Controller.reconcile()``, where any other error (a
    ``ValueError``) falls back to the sequential search, as in the JAX
    package.
"""

from __future__ import annotations

import inspect
import logging

import pytest
import torch

import tests.test_consolidation_families as TF
import tests.test_consolidation_replace_families as TR
import tests.test_consolidation_ttl_families as TT
import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.apis.objects import LabelSelector, TopologySpreadConstraint
from karpenter_tpu.disruption.batch import build_scorer
from karpenter_tpu.disruption.consolidation import MultiNodeConsolidation, sort_candidates
from karpenter_tpu.disruption.helpers import get_candidates
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.disruption import batch as p_batch
from karpenter_tpu_torch.disruption import consolidation as p_consolidation
from karpenter_tpu_torch.disruption import helpers as p_helpers
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
from tests.factories import make_pod
from tests.test_disruption import make_underutilized_pool
from tests.torch_port import PortEnv, assert_same_disruption, run_disruption


def scenarios(module):
    """A test module's scenarios in source order."""
    return [
        (module, name) for name, fn in sorted(vars(module).items(), key=lambda kv: getattr(
            kv[1], "__code__", None) and kv[1].__code__.co_firstlineno or 0)
        if name.startswith("test_") and inspect.isfunction(fn) and fn.__module__ == module.__name__
    ]


SCENARIOS = scenarios(TF) + scenarios(TR) + scenarios(TT)


def test_scenario_list_is_whole():
    assert len(SCENARIOS) == 12 + 12 + 11


@pytest.fixture(autouse=True)
def _forensics_dirs(tmp_path, monkeypatch):
    # the supervisor's quarantine and flight dumps stay in the test's tmp dir
    monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


@pytest.mark.parametrize("module,name", SCENARIOS, ids=lambda x: x if isinstance(x, str) else x.__name__[6:])
def test_consolidation_scenario(module, name, request):
    assert_same_disruption(getattr(module, name), request)


# -- the screen's verdicts -------------------------------------------------------

VERDICTS: list = []


def _score(scorer, subsets):
    # the JAX package's screen on one device; the port's takes no mesh
    return scorer.score_subsets(subsets, mesh=None)


def _ordered(env):
    method = MultiNodeConsolidation(env.provisioner, env.clock)
    return sort_candidates(get_candidates(env.clock, env.kube, env.cluster, env.cloud_provider,
                                          method.should_disrupt))


def _record_verdicts(env):
    """Every prefix and singleton of the cost-ordered candidates through
    ``build_scorer``: the verdicts, the consolidation verdicts and the
    screen's mode."""
    ordered = _ordered(env)
    scorer = build_scorer(env.provisioner, ordered)
    subsets = [list(range(k + 1)) for k in range(len(ordered))] + [[i] for i in range(len(ordered))]
    verdicts = _score(scorer, subsets)
    VERDICTS.append((
        [c.name for c in ordered],
        [(v.all_pods_scheduled, v.n_new_claims, sorted(v.replacement_its),
          sorted(v.replacement_zones or ()), sorted(v.replacement_cts or ())) for v in verdicts],
        [v.consolidatable_with([ordered[i] for i in s], scorer.inputs.instance_types)
         for v, s in zip(verdicts, subsets)],
        scorer.last_screen_stats["mode"],
    ))


def _relax_free_cluster():
    env = Env()  # noqa: F821  (bound by run_scenario)
    env.create(make_underutilized_pool())
    for i in range(8):
        env.create_candidate_node(
            f"m{i}", zone=f"test-zone-{1 + i % 3}",
            it_name="small-instance-type" if i % 2 else "default-instance-type",
            pods=[make_pod(name=f"mp{i}-{j}", cpu=0.1 + 0.6 * ((i + j) % 3)) for j in range(1 + i % 3)])
    _record_verdicts(env)


def _zonal_spread_cluster():
    env = Env()  # noqa: F821
    env.create(make_underutilized_pool())
    spread = TopologySpreadConstraint(max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE,
                                      when_unsatisfiable="DoNotSchedule",
                                      label_selector=LabelSelector(match_labels={"app": "spread"}))
    for i in range(6):
        env.create_candidate_node(
            f"z{i}", zone=f"test-zone-{1 + i % 3}",
            it_name="small-instance-type" if i % 3 else "default-instance-type",
            pods=[make_pod(name=f"zp{i}", cpu=0.5 + 0.25 * (i % 2), labels={"app": "spread"},
                           topology_spread=[spread])])
    _record_verdicts(env)


@pytest.mark.parametrize("cluster,mode", [(_relax_free_cluster, "delta"), (_zonal_spread_cluster, "full")],
                         ids=["relax-free", "zonal-spread"])
def test_build_scorer_verdicts_match_jax(cluster, mode):
    """The port's ``build_scorer`` over the live provisioner gives the JAX
    package's verdicts on every prefix and singleton of the same cluster."""
    VERDICTS.clear()
    run_disruption(cluster, False)
    run_disruption(cluster, True, {"_score": lambda scorer, subsets: scorer.score_subsets(subsets)})
    jax_v, port_v = VERDICTS
    assert port_v == jax_v
    assert port_v[3] == mode
    assert any(port_v[2]) and not all(port_v[2])


# -- one screen per pass, on the solver's device ---------------------------------


def _session_cluster():
    env = PortEnv()
    env.create(make_underutilized_pool())
    big = [make_pod(name=f"b{i}", cpu=1.2, owner_kind="ReplicaSet") for i in range(2)]
    env.create_candidate_node("n-host", pods=big)
    for name in ("n1", "n2", "n3"):
        env.create_candidate_node(name, it_name="small-instance-type",
                                  pods=[make_pod(name=f"p-{name}", cpu=0.1, owner_kind="ReplicaSet")])
    return env


def test_one_screen_dispatch_per_pass(monkeypatch):
    """A pass builds one scorer and dispatches one screen (``runs_screen`` on
    the card): Multi's prefixes carry Single's singletons."""
    calls = []
    for name in ("lean_screen", "residual_screen"):
        real = getattr(p_batch, name)
        monkeypatch.setattr(p_batch, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    builds = []
    real_build = p_batch.build_scorer
    monkeypatch.setattr(p_batch, "build_scorer", lambda prov, cands: builds.append(len(cands)) or real_build(prov, cands))
    env = _session_cluster()
    ctrl = env.disruption_controller()
    assert ctrl.reconcile() is None and ctrl.pending is not None
    assert builds == [4] and calls == ["residual_screen"]
    assert kernels.LAUNCHES["runs_screen"] == 0  # CPU tensors take the plain screen
    # the revalidation pass re-simulates; it screens nothing
    env.clock.step(ctrl.pending.method.validation_ttl + 0.1)
    assert ctrl.reconcile() is not None
    assert builds == [4] and calls == ["residual_screen"]


def test_scorer_takes_the_solver_device(monkeypatch):
    env = _session_cluster()
    method = p_consolidation.MultiNodeConsolidation(env.provisioner, env.clock)
    ordered = p_consolidation.sort_candidates(p_helpers.get_candidates(
        env.clock, env.kube, env.cluster, env.cloud_provider, method.should_disrupt))
    assert p_batch.build_scorer(env.provisioner, ordered).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env.provisioner.solver = SupervisedSolver(OracleSolver())
    with pytest.raises(RuntimeError, match="CUDA"):
        p_batch.build_scorer(env.provisioner, ordered)


# -- screen errors -----------------------------------------------------------------


def _failing_screen(monkeypatch, exc):
    def fail(self, subsets, passes=3):
        raise exc

    monkeypatch.setattr(p_batch.UnionScorer, "score_subsets", fail)


def test_kernel_error_in_screen_propagates(monkeypatch):
    """A kernel or CUDA error inside the screen is raised out of the
    controller's pass, not swallowed into the sequential search."""
    _failing_screen(monkeypatch, kernels.KernelDeviceError("runs_screen: CUDA launch error 700"))
    searched = []
    monkeypatch.setattr(p_consolidation.MultiNodeConsolidation, "_binary_search",
                        lambda self, ordered, deadline: searched.append(len(ordered)))
    env = _session_cluster()
    with pytest.raises(kernels.KernelDeviceError, match="runs_screen"):
        env.disruption_controller().reconcile()
    assert searched == []


def test_cuda_runtime_error_in_screen_propagates(monkeypatch):
    _failing_screen(monkeypatch, RuntimeError("CUDA error: an illegal memory access was encountered"))
    env = _session_cluster()
    with pytest.raises(RuntimeError, match="CUDA error"):
        env.disruption_controller().reconcile()


def test_other_screen_error_falls_back(monkeypatch, caplog):
    """Any other error keeps the JAX package's logged fallback: Multi's binary
    search finds the command the screened pass finds."""
    control = _session_cluster().reconcile_disruption()
    assert control is not None and control.method == "multi-node-consolidation"
    _failing_screen(monkeypatch, ValueError("a screen input out of range"))
    searched = []
    real_search = p_consolidation.MultiNodeConsolidation._binary_search
    monkeypatch.setattr(p_consolidation.MultiNodeConsolidation, "_binary_search",
                        lambda self, ordered, deadline: searched.append(len(ordered)) or real_search(
                            self, ordered, deadline))
    env = _session_cluster()
    with caplog.at_level(logging.ERROR, logger=p_consolidation.__name__):
        cmd = env.reconcile_disruption()
    assert searched == [4]
    assert "batched multi-node screen failed; using binary search" in caplog.text
    assert cmd is not None
    assert (cmd.method, cmd.decision, [c.name for c in cmd.candidates]) == (
        control.method, control.decision, [c.name for c in control.candidates])
