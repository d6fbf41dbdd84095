"""The port's lifecycle controllers, webhooks and cloud-provider fault paths
against the JAX package's.

Every scenario of tests/test_lifecycle.py (launch, register, initialize,
liveness, the disruption markers, claim termination, garbage collection,
consistency, the drain with its PDBs, the nodepool hash and counter, lease
GC, the eviction queue's backoff, requirements drift), of
tests/test_termination_families.py (the four-group drain order and what it
waits for) and of tests/test_webhooks.py (admission, ChangeMonitor, the CRD
export), and the two cloud-provider fault scenarios of
tests/test_supervisor_chaos.py (``create.ice`` and ``create.ratelimit``
through the lifecycle controller) run through both packages
(tests/torch_port.py: the scenario's names of the JAX package rebound to the
port's modules, the factories building the port's objects). The scenario's
own assertions hold on both; the two runs must leave the same NodeClaims,
Nodes with their taints, bindings, pending pods and event reasons in order,
and move the same counters with the same labels.
"""

from __future__ import annotations

import inspect

import pytest

import tests.test_lifecycle as TL
import tests.test_supervisor_chaos as TC
import tests.test_termination_families as TF
import tests.test_webhooks as TW
import tests.torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_port import assert_same_run

CHAOS = ("test_ice_fault_requeues_pods_and_next_cycle_provisions",
         "test_ratelimit_fault_backs_off_then_launches")


def scenarios(module, only=None):
    """A test module's scenarios in source order (``only``: these)."""
    return [
        (module, name) for name, fn in sorted(vars(module).items(), key=lambda kv: getattr(
            getattr(kv[1], "__code__", None), "co_firstlineno", 0))
        if name.startswith("test_") and inspect.isfunction(fn) and fn.__module__ == module.__name__
        and (only is None or name in only)
    ]


SCENARIOS = scenarios(TL) + scenarios(TF) + scenarios(TW) + scenarios(TC, CHAOS)


def test_scenario_list_is_whole():
    assert [len(scenarios(m)) for m in (TL, TF, TW)] == [23, 8, 4]
    assert len(SCENARIOS) == 23 + 8 + 4 + 2


@pytest.fixture(autouse=True)
def _forensics_dirs(tmp_path, monkeypatch):
    # the supervisor's quarantine and flight dumps stay in the test's tmp dir
    monkeypatch.setenv("KARPENTER_TPU_QUARANTINE_DIR", str(tmp_path / "quarantine"))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


@pytest.mark.parametrize("module,name", SCENARIOS, ids=lambda x: x if isinstance(x, str) else x.__name__[6:])
def test_lifecycle_scenario(module, name, request):
    assert_same_run(getattr(module, name), request)
