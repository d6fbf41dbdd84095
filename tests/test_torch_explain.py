"""Placement explainability on the port: the explain pass (program 7,
ops/ffd_step.attribute_pods) and its report, against the JAX package.

Exact throughout: ``family_bitmask`` equals the JAX twin on random fail
matrices; the attribution words of ``attribute_pods`` (the plain version the
CPU runs; the ``attribute`` kernel is held to it on the card) equal the JAX
package's on solved corpora, for the failed rows and, where few fail, for
every active row; and on the tests/test_explain.py universe ``TorchSolver``
and the port's ``OracleSolver`` give the reasons, hints and report keys that
``JaxSolver`` and the JAX oracle give. With the flag on, placements are the
flag-off ones, the counter moves by the reasons, and a supervised solve hands
the report through unchanged.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from karpenter_tpu.obs import explain as jox
from karpenter_tpu.ops import masks as jmasks
from karpenter_tpu.ops.ffd import solve_ffd_sweeps as j_solve_ffd_sweeps
from karpenter_tpu.ops.ffd_step import attribute_pods as j_attribute_pods
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu.solver.oracle import OracleSolver as JOracleSolver
from karpenter_tpu_torch.metrics import registry as treg
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy, state_from_numpy
from karpenter_tpu_torch.obs import explain as tox
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_step import attribute_pods
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.supervisor import SupervisedSolver
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from tests.test_torch_encode import encode_both
import tests.torch_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(autouse=True)
def _explain_hygiene():
    """Every test starts flag-unforced with empty report rings."""
    for ox in (jox, tox):
        ox.set_enabled(None)
        ox.reset_ring()
    yield
    for ox in (jox, tox):
        ox.set_enabled(None)
        ox.reset_ring()


def test_family_bitmask_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    for _ in range(100):
        E = int(rng.integers(1, 9))
        fails = rng.random((tox.NUM_FAMILIES, E)) < 0.4
        cand = rng.random(E) < 0.7
        ours = masks.family_bitmask(torch.from_numpy(fails), torch.from_numpy(cand))
        ref = jmasks.family_bitmask(jnp.asarray(fails), jnp.asarray(cand))
        assert ours.tolist() == [int(x) for x in ref]
        assert tuple(ours.tolist()) == tox.encode_family_bits([list(r) for r in fails], list(cand))


# (corpus, claim slots, rows): the failed rows of the solve (chain-2001 at 8
# slots fails 132 rows with KIND_NO_SLOT), or every active row where few fail
ATTR_CASES = [
    ("chain-2001", 8, "failed"),
    ("topology-3", 32, "failed"),
    ("fuzz-6", 32, "all"),
    ("volumes-0", 32, "all"),
]


@pytest.mark.parametrize("name,slots,which", ATTR_CASES)
def test_attribute_words_match_jax(name, slots, which):
    jp, _, _, _ = encode_both(name, claim_slots=slots)
    jr = j_solve_ffd_sweeps(jp, slots)
    active = np.asarray(jp.pod_active)
    rows = np.flatnonzero(active & (np.asarray(jr.kind) >= 3)) if which == "failed" else np.flatnonzero(active)
    assert rows.size
    state = numpy_fields(jr.state)
    words = attribute_pods(problem_from_numpy(numpy_fields(jp), "cpu"), state_from_numpy(state, "cpu"), rows)
    np.testing.assert_array_equal(words.numpy(), j_attribute_pods(jp, jr.state, rows))


def _universe(pkg: str, case: str):
    """tests/test_explain.py's universe, built from one package's classes:
    (pods, instance types, templates)."""
    m = {name: importlib.import_module(f"{pkg}.{name}") for name in
         ("apis.objects", "apis.labels", "apis.nodepool", "cloudprovider.fake", "solver.encode", "scheduling")}
    obj = m["apis.objects"]
    its = m["cloudprovider.fake"].instance_types(8)
    tpl = m["solver.encode"].template_from_nodepool(
        m["apis.nodepool"].NodePool(metadata=obj.ObjectMeta(name="default")), its, range(len(its))
    )

    def pod(name, cpu=0.5, node_selector=None):
        return obj.Pod(metadata=obj.ObjectMeta(name=name), spec=obj.PodSpec(
            containers=[obj.Container(requests={"cpu": cpu, "memory": 1e8})], node_selector=node_selector or {}))

    if case == "taints":
        taint = obj.Taint(key="team", value="x", effect="NoSchedule")
        return [pod("plain")], its, [dataclasses.replace(tpl, taints=m["scheduling"].Taints([taint]))]
    zone = m["apis.labels"].LABEL_TOPOLOGY_ZONE
    return [pod("ok-0"), pod("huge", cpu=10_000.0), pod("moon", node_selector={zone: "no-such-zone"}),
            pod("ok-1")], its, [tpl]


def _well_known(pkg: str):
    return importlib.import_module(f"{pkg}.cloudprovider.fake").FAKE_WELL_KNOWN_LABELS


def _solve(backend: str, case: str):
    if backend in ("jax", "jax-oracle"):
        cls = JaxSolver if backend == "jax" else JOracleSolver
        return cls(well_known=_well_known("karpenter_tpu")).solve(*_universe("karpenter_tpu", case))
    wk = _well_known("karpenter_tpu_torch")
    solver = TorchSolver(well_known=wk, device="cpu") if backend == "torch" else OracleSolver(well_known=wk)
    return solver.solve(*_universe("karpenter_tpu_torch", case))


def _reasons(result):
    return {k: (v.reason, v.hint) for k, v in result.explain.pods.items()}


@pytest.mark.parametrize("case", ["engineered", "taints"])
def test_reasons_and_hints_match_jax_and_the_oracles(case):
    jox.set_enabled(True)
    tox.set_enabled(True)
    results = {b: _solve(b, case) for b in ("jax", "jax-oracle", "torch", "torch-oracle")}
    ref = results["jax"]
    for backend, result in results.items():
        assert result.failures.keys() == ref.failures.keys() == result.explain.pods.keys(), backend
        assert _reasons(result) == _reasons(ref), backend
    expected = {1: tox.REASON_RESOURCES, 2: tox.REASON_REQUIREMENTS} if case == "engineered" else {
        0: tox.REASON_TAINTS}
    assert {k: r for k, (r, _) in _reasons(results["torch"]).items()} == expected
    assert results["torch"].explain.nominations.keys() == ref.explain.nominations.keys()


def test_flag_on_keeps_placements_and_counts_bounded_reasons():
    off = _solve("torch", "engineered")
    assert off.explain is None and len(tox.ring()) == 0
    before = {r: treg.UNSCHEDULABLE_PODS.value(labels={"reason": r}) for r in tox.REASONS}
    tox.set_enabled(True)
    on = _solve("torch", "engineered")
    assert on.failures.keys() == off.failures.keys()
    assert on.node_pods == off.node_pods
    assert [(c.template_index, sorted(c.pod_indices), c.instance_type_indices) for c in on.new_claims] == [
        (c.template_index, sorted(c.pod_indices), c.instance_type_indices) for c in off.new_claims]
    rep = on.explain
    assert all(e.hint for e in rep.pods.values()) and "cpu" in rep.pods[1].hint
    assert tox.ring().last()["reasons"] == {tox.REASON_RESOURCES: 1, tox.REASON_REQUIREMENTS: 1}
    after = {r: treg.UNSCHEDULABLE_PODS.value(labels={"reason": r}) for r in tox.REASONS}
    assert {r: after[r] - before[r] for r in tox.REASONS if after[r] != before[r]} == {
        tox.REASON_RESOURCES: 1, tox.REASON_REQUIREMENTS: 1}
    assert rep.overhead_s >= 0.0 and set(rep.nominations) == {0, 3}


def test_explain_series_match_the_jax_package():
    jreg = importlib.import_module("karpenter_tpu.metrics.registry")
    for name in ("UNSCHEDULABLE_PODS", "EXPLAIN_OVERHEAD"):
        j, t = getattr(jreg, name), getattr(treg, name)
        assert (t.name, t.kind, t.help, getattr(t, "buckets", None)) == (
            j.name, j.kind, j.help, getattr(j, "buckets", None)), name
    assert tox.REASONS == jox.REASONS and tox.FAMILY_NAMES == jox.FAMILY_NAMES


def test_supervised_solve_hands_the_report_through():
    tox.set_enabled(True)
    wk = _well_known("karpenter_tpu_torch")
    primary = TorchSolver(well_known=wk, device="cpu")
    sup = SupervisedSolver(primary, fallback=OracleSolver(well_known=wk))
    result = sup.solve(*_universe("karpenter_tpu_torch", "engineered"))
    assert result.explain is primary.last_explain
    assert sup.counters["solve_fallbacks"] == 0
    assert sup.status()["explain"]["reasons"] == {tox.REASON_RESOURCES: 1, tox.REASON_REQUIREMENTS: 1}
