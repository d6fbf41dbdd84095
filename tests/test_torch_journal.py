"""The streaming journal (streaming/snapshot.py), the process-crash site and
the restart storm (testing/restart.py), on the CPU.

Every restore outcome class is produced by its defect and classified, never
raised: a missing, truncated, corrupt, checksum-failing or version-skewed
frame, a journal of another device tag (``isa-mismatch``), a stale one, one
the full validator rejects, one whose payload does not unpickle (``error``),
and a journal the JAX package wrote into the same state directory (its frame
kind is not this package's: ``corrupt``, before anything is unpickled). A
restored journal makes the fresh stream's first cycle warm; its payload holds
no ``torch.Tensor``. Tenants' journals live in their own namespaces.

Two tests start subprocesses: ``proc.crash`` ends a child with SIGKILL, and a
small storm (2 kills, 16 pods, 4 cycles) finishes with every cycle's digest
equal to the control run's, whose digests equal the JAX package's control.
"""

from __future__ import annotations

import io
import os
import pickle
import subprocess
import sys

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)
from karpenter_tpu_torch.metrics.registry import RESTORE_FALLBACK, STATE_RESTORE
from karpenter_tpu_torch.streaming import churn, snapshot
from karpenter_tpu_torch.streaming.warm import StreamingSolver
from karpenter_tpu_torch.solver.oracle import OracleSolver
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.testing import faults, restart
from karpenter_tpu_torch.utils import persist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def state_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_STATE_DIR", str(tmp_path / "state"))
    monkeypatch.delenv("KARPENTER_TPU_FAULTS", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_STATE_MAX_AGE_S", raising=False)
    faults.clear()
    yield tmp_path / "state"
    faults.clear()


def _stream(inner, cycles=3, tenant=None, seed=0):
    """A StreamingSolver over ``cycles`` churn cycles of 30 pods; returns it,
    the churn process and the catalog."""
    pods, its, tpls = restart.base_problem(30, 4)
    proc = churn.ChurnProcess(pods, pod_factory=restart.stable_pod_factory,
                              config=churn.ChurnConfig(seed=seed, arrivals_per_cycle=2, deletes_per_cycle=1))
    solver = StreamingSolver(inner, tenant=tenant)
    for _ in range(cycles):
        proc.step()
        solver.solve(proc.pods, its, tpls)
    return solver, proc, its, tpls


def _moves(fn):
    def snap():
        return {(m.name, tuple(sorted(k.items()))): v for m in (STATE_RESTORE, RESTORE_FALLBACK)
                for _, _, k, v in m.collect()}

    before = snap()
    out = fn()
    after = snap()
    return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class _NoTorch(pickle.Unpickler):
    """Unpickles, recording every module a class is loaded from."""

    modules: set = set()

    def find_class(self, module, name):
        _NoTorch.modules.add(module)
        return super().find_class(module, name)


def test_restored_journal_makes_the_first_cycle_warm(state_dir):
    solver, proc, its, tpls = _stream(TorchSolver(device="cpu", relax=False))
    assert solver.last_outcome == "warm"
    path = snapshot.journal_path()
    header, payload = persist.load_framed(path, kind=snapshot.JOURNAL_KIND)
    assert header["meta"]["isa"] == snapshot.device_tag(solver.inner)
    assert header["meta"]["isa"].endswith("/cpu")
    _NoTorch.modules = set()
    state = _NoTorch(io.BytesIO(payload)).load()
    assert not any(m == "torch" or m.startswith("torch.") for m in _NoTorch.modules)
    assert state.result.verify_ctx is None and len(state.pods) == len(proc.pods)

    fresh, moved = _moves(lambda: StreamingSolver(TorchSolver(device="cpu", relax=False)))
    assert fresh.last_restore_outcome == "restored" and fresh.restored_from_journal
    assert moved == {("karpenter_solver_state_restore_total", (("outcome", "restored"),)): 1.0}
    proc.step()
    fresh.solve(proc.pods, its, tpls)
    assert fresh.last_outcome == "warm"


def _defect(name, path, monkeypatch):
    """Damage the journal at ``path`` the way ``name`` says (``stale``: a
    maximum age below the journal's)."""
    blob = open(path, "rb").read()
    header, payload = persist.load_framed(path, kind=snapshot.JOURNAL_KIND)
    if name == "stale":
        monkeypatch.setenv("KARPENTER_TPU_STATE_MAX_AGE_S", "-1")
    elif name == "missing":
        os.remove(path)
    elif name == "truncated":
        open(path, "wb").write(blob[: len(blob) // 2])
    elif name == "corrupt":
        open(path, "wb").write(b"garbage" + blob[7:])
    elif name == "checksum":
        open(path, "wb").write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    elif name == "version-skew":
        persist.write_framed(path, payload, kind=snapshot.JOURNAL_KIND, version=snapshot.JOURNAL_VERSION + 1,
                             meta=header["meta"])
    elif name == "isa-mismatch":
        persist.write_framed(path, payload, kind=snapshot.JOURNAL_KIND, version=snapshot.JOURNAL_VERSION,
                             meta={**header["meta"], "isa": "torch-0/cuda:H100:sm_90"})
    elif name == "validator":
        state = pickle.loads(payload)
        claim = state.result.new_claims[0]
        claim.pod_indices = claim.pod_indices + state.result.new_claims[1].pod_indices
        del state.result.new_claims[1]
        snapshot.save(state, header["meta"]["isa"])
    elif name == "error":
        persist.write_framed(path, b"not a pickle", kind=snapshot.JOURNAL_KIND, version=snapshot.JOURNAL_VERSION,
                             meta=header["meta"])


@pytest.mark.parametrize("defect", ["missing", "truncated", "corrupt", "checksum", "version-skew",
                                    "isa-mismatch", "stale", "validator", "error"])
def test_every_defect_is_a_classified_cold_start(state_dir, defect, monkeypatch):
    solver, proc, its, tpls = _stream(OracleSolver())
    _defect(defect, snapshot.journal_path(), monkeypatch)
    fresh, moved = _moves(lambda: StreamingSolver(OracleSolver()))
    assert fresh.last_restore_outcome == defect and not fresh.restored_from_journal
    want = {("karpenter_solver_state_restore_total", (("outcome", defect),)): 1.0}
    if defect != "missing":
        want[("karpenter_restore_fallback_total", (("reason", f"journal-{defect}"),))] = 1.0
    assert moved == want
    proc.step()
    fresh.solve(proc.pods, its, tpls)
    assert fresh.last_outcome == "cold-first"


def test_a_jax_journal_is_never_restored(state_dir):
    """The JAX package's stream journaled into the same directory: the
    port classifies it ``corrupt`` (its frame kind) and raises nothing."""
    from karpenter_tpu.solver.oracle import OracleSolver as JOracle
    from karpenter_tpu.streaming import snapshot as j_snapshot
    from karpenter_tpu.streaming.warm import StreamingSolver as JStreaming
    from karpenter_tpu.testing import restart as j_restart

    pods, its, tpls = j_restart.base_problem(20, 3)
    JStreaming(JOracle()).solve(pods, its, tpls)
    assert os.path.exists(j_snapshot.journal_path()) and snapshot.journal_path() == j_snapshot.journal_path()
    fresh = StreamingSolver(OracleSolver())
    assert fresh.last_restore_outcome == "corrupt" and fresh._prev is None


def test_tenant_journals_are_namespaced(state_dir):
    a, proc, its, tpls = _stream(OracleSolver(), tenant="team/a")
    _stream(OracleSolver(), tenant="team-b", seed=1)
    assert snapshot.journal_path("team/a") != snapshot.journal_path("team-b")
    assert os.path.exists(snapshot.journal_path("team/a")) and not os.path.exists(snapshot.journal_path())
    a.reset_streaming_state()  # the quarantine hook removes only its own journal
    assert not os.path.exists(snapshot.journal_path("team/a"))
    assert os.path.exists(snapshot.journal_path("team-b"))
    fresh = StreamingSolver(OracleSolver())
    fresh.set_tenant("team-b")
    assert fresh.last_restore_outcome == "restored"


def test_proc_crash_kills_the_child(tmp_path):
    env = dict(os.environ, KARPENTER_TPU_FAULTS="proc.crash@1", KARPENTER_TPU_STATE_DIR=str(tmp_path),
               PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.testing.restart", "--pods", "8", "--cycles", "2"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == -9
    assert run.stdout.splitlines() == ["RESTORE missing"]


def test_restart_storm_matches_the_control_and_the_jax_control(tmp_path):
    from karpenter_tpu.solver.oracle import OracleSolver as JOracle
    from karpenter_tpu.streaming.warm import StreamingSolver as JStreaming
    from karpenter_tpu.testing import restart as j_restart

    out = restart.run_restart_storm(pod_count=16, cycles=4, kills=2, state_dir=str(tmp_path / "storm"))
    assert out["ok"], out
    assert out["kills"] == 2 and out["parity_ok"] and out["acct_ok"] and out["restores_classified"]
    assert "restored" in out["restores"]

    pods, its, tpls = j_restart.base_problem(16, 3)
    proc = j_restart._churn(pods, 5, 3, 2)
    control = JStreaming(JOracle())
    digests = []
    for _ in range(4):
        proc.step()
        digests.append(j_restart.result_digest(control.solve(proc.pods, its, tpls, nodes=proc.nodes)))
    assert out["control"] == digests
