"""The port's disruption controller against the JAX package's: the disruption
suite, the orchestration queue, the condition-driven methods and the batched
screen.

Every scenario of tests/test_disruption.py, tests/test_orchestration_families.py,
tests/test_condition_method_families.py and tests/test_batch.py runs twice:
through the JAX package's harness (tests.harness.Env over ``JaxSolver``) and
through the port's (karpenter_tpu_torch.testing.harness.Env over
``SupervisedSolver(TorchSolver(device="cpu"), fallback=OracleSolver())``),
with what the scenario names of the JAX package rebound to the port
(tests/torch_port.py): scenarios that call a disruption class directly (the
``Queue`` of the orchestration families, ``MultiNodeConsolidation`` and
``get_candidates`` of test_disruption.py :259, the method-level tests of
test_batch.py) call the port's class in the port's run. The scenario's own
assertions hold on both. Then the two runs must agree exactly on the
commands executed (method, decision, candidates, the replacements'
requirements and instance types), every NodeClaim and Node left with its
taints, the pod bindings, the recorder's event reasons in order and the
counters the run moved (tests/torch_port.assert_same_run); and the port's
supervised solve never fails over.

The port's ``UnionScorer.score_subsets`` takes no ``mesh``: test_batch.py's
``screen_decisions`` helper runs without it in the port's run, and
``test_staying_candidate_anti_affinity_blocks_subset``, which passes
``mesh=None`` itself, runs as a twin here with the keyword dropped for the
port (``test_staying_candidate_twin``).

The four scenarios of test_condition_method_families.py that drive the
marker controller (``controllers/nodeclaim_disruption.
DisruptionMarkerController``: :176, :188, :202, :218) run here like the rest.
"""

from __future__ import annotations

import inspect

import pytest

import tests.test_batch as TB
import tests.test_condition_method_families as TC
import tests.test_disruption as TD
import tests.test_orchestration_families as TO
import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.apis.objects import Affinity, LabelSelector, PodAffinityTerm, PodAntiAffinity
from karpenter_tpu.disruption.batch import build_scorer
from karpenter_tpu.disruption.consolidation import MultiNodeConsolidation
from karpenter_tpu.disruption.types import DECISION_NONE
from tests.factories import make_pod
from tests.torch_port import assert_same_disruption

TWINNED = ("test_staying_candidate_anti_affinity_blocks_subset",)


def scenarios(module, left_out=()):
    """A test module's scenarios in source order, less ``left_out``."""
    return [
        (module, name) for name, fn in sorted(vars(module).items(), key=lambda kv: getattr(
            kv[1], "__code__", None) and kv[1].__code__.co_firstlineno or 0)
        if name.startswith("test_") and inspect.isfunction(fn) and fn.__module__ == module.__name__
        and name not in left_out
    ]


SCENARIOS = (scenarios(TD) + scenarios(TO) + scenarios(TC) + scenarios(TB, TWINNED))


def test_scenario_list_is_whole():
    # 23 + 5 + 11 + 6 scenarios, less the twin
    assert len(SCENARIOS) + len(TWINNED) == 45


@pytest.fixture(autouse=True)
def _forensics_dirs(tmp_path, monkeypatch):
    # the supervisor's quarantine and flight dumps stay in the test's tmp dir
    monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


def _port_screen_decisions(env, ordered):
    """tests/test_batch.py ``screen_decisions`` without ``mesh``."""
    from karpenter_tpu_torch.disruption.batch import build_scorer as port_build_scorer

    scorer = port_build_scorer(env.provisioner, ordered)
    assert scorer is not None
    verdicts = scorer.score_subsets([list(range(k + 1)) for k in range(len(ordered))])
    return [v.consolidatable_with(ordered[: k + 1], scorer.inputs.instance_types) for k, v in enumerate(verdicts)]


PORT_OVERRIDES = {"screen_decisions": _port_screen_decisions}


@pytest.mark.parametrize("module,name", SCENARIOS, ids=lambda x: x if isinstance(x, str) else x.__name__[6:])
def test_disruption_scenario(module, name, request):
    assert_same_disruption(getattr(module, name), request, PORT_OVERRIDES)


# -- twins ---------------------------------------------------------------------

candidates_of = TB.candidates_of
VERDICTS: list = []


def _score(scorer, subsets):
    # the JAX package's screen on one device; the port's takes no mesh
    return scorer.score_subsets(subsets, mesh=None)


def _staying_candidate_twin():
    """tests/test_batch.py ``test_staying_candidate_anti_affinity_blocks_subset``
    with its screen calls through ``_score``."""
    env = Env()  # noqa: F821  (bound by run_scenario)
    env.create(TB.underutilized_pool())
    anti = Affinity(pod_anti_affinity=PodAntiAffinity(required=[PodAffinityTerm(
        topology_key=wk.LABEL_HOSTNAME, label_selector=LabelSelector(match_labels={"app": "web"}))]))
    env.create_candidate_node("n-anti", it_name="default-instance-type",
                              pods=[make_pod(name="guard", cpu=3.9, labels={"app": "web"}, affinity=anti)])
    env.create_candidate_node("n-mover", it_name="small-instance-type",
                              pods=[make_pod(name="web1", cpu=0.1, labels={"app": "web"})])
    env.create_candidate_node("n-host", it_name="default-instance-type", pods=[make_pod(name="h", cpu=0.5)])
    ordered = candidates_of(env)
    by_name = {c.name: i for i, c in enumerate(ordered)}
    scorer = build_scorer(env.provisioner, ordered)
    verdicts = _score(scorer, [[by_name["n-mover"]]])
    assert verdicts[0].all_pods_scheduled

    env2 = Env()  # noqa: F821
    env2.create(TB.underutilized_pool())
    env2.create_candidate_node("n-anti", it_name="default-instance-type",
                               pods=[make_pod(name="guard", cpu=0.5, labels={"app": "web"}, affinity=anti)])
    env2.create_candidate_node("n-mover", it_name="small-instance-type",
                               pods=[make_pod(name="web1", cpu=0.1, labels={"app": "web"})])
    ordered2 = candidates_of(env2)
    by_name2 = {c.name: i for i, c in enumerate(ordered2)}
    scorer2 = build_scorer(env2.provisioner, ordered2)
    v2 = _score(scorer2, [[by_name2["n-mover"]]])
    seq2 = MultiNodeConsolidation(env2.provisioner, env2.clock).compute_consolidation([ordered2[by_name2["n-mover"]]])
    screen_ok = v2[0].consolidatable_with([ordered2[by_name2["n-mover"]]], scorer2.inputs.instance_types)
    assert not (screen_ok and seq2.decision == DECISION_NONE)
    VERDICTS.append((verdicts[0].all_pods_scheduled, screen_ok, seq2.decision))



def test_staying_candidate_twin(request):
    VERDICTS.clear()
    assert_same_disruption(_staying_candidate_twin, request,
                           {"_score": lambda scorer, subsets: scorer.score_subsets(subsets)})
    assert VERDICTS[0] == VERDICTS[1]
