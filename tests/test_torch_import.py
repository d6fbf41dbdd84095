"""karpenter_tpu_torch stands alone: importing the package and every module
in it (the solver, the supervisor and its fallback, the serve layer, the
observability hooks) pulls in neither jax nor the JAX package, entry points
refuse to run without a GPU unless asked for the CPU, and chip_smoke.py
fails (printing no result) where there is no CUDA device."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import tests.torch_threads  # noqa: F401  (one intra-op thread)

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import karpenter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, "karpenter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "karpenter_tpu" or m.startswith("karpenter_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=str(REPO), env=_env(),
        capture_output=True, text=True, timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "karpenter_tpu_torch.solver.torch_backend" in report["modules"]
    assert "karpenter_tpu_torch.verify.gate" in report["modules"]
    # the supervised serve path and what it stands on; the chain commits,
    # the explain pass, the streaming layer, the program lifecycle and the
    # serve replicas
    for name in ("metrics.registry", "obs.trace", "obs.slo", "obs.flight", "utils.persist", "testing.faults",
                 "solver.forensics", "solver.oracle", "solver.supervisor", "parallel.mesh", "serve",
                 "serve.estimator", "serve.pool", "serve.tenant", "serve.batch", "serve.dispatcher",
                 "ops.ffd_chain", "obs.explain", "streaming.warm", "streaming.residual",
                 "streaming.snapshot", "testing.restart", "verify.incremental", "obs.programs", "solver.aot",
                 "solver.warmup", "serve.replica"):
        assert f"karpenter_tpu_torch.{name}" in report["modules"], name
    assert report["bad"] == []


def test_torch_solver_needs_a_gpu_or_an_explicit_cpu():
    from karpenter_tpu_torch.solver.torch_backend import TorchSolver

    assert TorchSolver(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert TorchSolver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchSolver()


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: chip_smoke.py would run for real")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            # alone, without the package beside it
            (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=str(cwd), env={**os.environ, "PYTHONPATH": ""},
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
