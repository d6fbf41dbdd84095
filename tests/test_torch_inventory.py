"""The port covers the JAX system: every module of ``karpenter_tpu/`` has a
counterpart of the same path in ``karpenter_tpu_torch/``, every file under
``tools/`` that imports ``karpenter_tpu`` has a counterpart under
``karpenter_tpu_torch/tools/``, and every name a ``karpenter_tpu``
``__init__`` exports is exported by the port's package of the same path —
or the module, tool or name stands on a list below with its reason. The
lists are ROADMAP.md's queue C entries ("Deliberate differences"), which
must name each one; an entry whose counterpart exists is stale and fails."""

import ast
import importlib
from pathlib import Path

import pytest

import tests.torch_threads  # noqa: F401  (one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "karpenter_tpu"
PORT_PKG = REPO / "karpenter_tpu_torch"

MODULES_WITHOUT_COUNTERPART = {
    "solver/jax_backend.py": "JaxSolver: the port's backend is solver/torch_backend.py (TorchSolver)",
    "utils/jaxtools.py": "bounds the mmaps of XLA executables; the port compiles no XLA program",
    "ops/ffd.py": "an import facade over ops/ffd_*.py; the port's callers import each ffd_* module",
}

TOOLS_WITHOUT_COUNTERPART = {
    "_profharness.py": "the shared setup of the profile_*.py probes of JAX programs",
    "kernel_census.py": "counts the jaxpr equations of one narrow step; the port has no jaxpr (chip_smoke.py "
                        "records its kernels' work counters and sections)",
    "metrics_lint.py": "lints the JAX package's registry; tests/test_torch_metrics.py holds the port's "
                       "registry to it series for series",
    "perf_gate.py": "gates bench.py rows of the JAX package against BENCH history; the port's benchmark "
                    "comes with its own",
    "profile_chain.py": "a profile probe of a JAX program (the port's kernels are timed by chip_smoke.py and "
                        "tools/kernel_timing.py)",
    "profile_kernels.py": "a jax.profiler probe of a JAX program",
    "profile_scan.py": "a profile probe of a JAX program",
    "profile_screen.py": "a jax.profiler probe of a JAX program",
    "profile_solve.py": "a profile probe of JaxSolver",
    "profile_step.py": "a profile probe of a JAX program",
    "train_order.py": "host numpy training over a corpus; the port loads the artifact it writes "
                      "(solver/order_policy.v1.bin)",
}

NAMES_WITHOUT_COUNTERPART = {
    "parallel.make_mesh": "builds a jax.sharding.Mesh; the port runs a batch's lanes as blocks of one launch on "
                          "one card (no mesh object)",
    "parallel.shard_batch": "places a batch on a JAX mesh; the port has none to place it on",
}


def jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def jax_tools():
    out = []
    for p in sorted((REPO / "tools").glob("*.py")):
        tree = ast.parse(p.read_text())
        mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        if any(m == "karpenter_tpu" or m.startswith("karpenter_tpu.") for m in mods):
            out.append(p.name)
    return out


def init_exports():
    """(package, name) for every name a ``karpenter_tpu`` ``__init__``
    imports from the package or lists in ``__all__``."""
    out = []
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        pkg = ".".join(init.parent.relative_to(JAX_PKG).parts)
        names = set()
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").startswith(
                    "karpenter_tpu"):
                names |= {a.asname or a.name for a in node.names}
            if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__" for t in node.targets):
                names |= {e.value for e in node.value.elts}
        out += [(pkg, n) for n in sorted(names)]
    return out


@pytest.mark.parametrize("module", jax_modules())
def test_every_module_has_a_counterpart(module):
    has = (PORT_PKG / module).exists()
    if module in MODULES_WITHOUT_COUNTERPART:
        assert not has, f"{module} has a counterpart now: take it off the list"
    else:
        assert has, f"karpenter_tpu/{module} has no counterpart in karpenter_tpu_torch/ and is not listed"


@pytest.mark.parametrize("tool", jax_tools())
def test_every_tool_has_a_counterpart(tool):
    has = (PORT_PKG / "tools" / tool).exists()
    if tool in TOOLS_WITHOUT_COUNTERPART:
        assert not has, f"tools/{tool} has a counterpart now: take it off the list"
    else:
        assert has, f"tools/{tool} has no counterpart in karpenter_tpu_torch/tools/ and is not listed"
        mod = importlib.import_module(f"karpenter_tpu_torch.tools.{tool[:-3]}")
        assert callable(getattr(mod, "main", None))


@pytest.mark.parametrize("pkg,name", init_exports(), ids=lambda x: x)
def test_every_init_export_has_a_counterpart(pkg, name):
    key = f"{pkg}.{name}" if pkg else name
    port = importlib.import_module(".".join(filter(None, ["karpenter_tpu_torch", pkg])))
    exported = hasattr(port, name)
    if not exported:
        try:  # a submodule the package's name resolves to (``from pkg import mod``)
            importlib.import_module(f"{port.__name__}.{name}")
            exported = True
        except ImportError:
            pass
    if key in NAMES_WITHOUT_COUNTERPART:
        assert not exported, f"{key} is exported now: take it off the list"
    else:
        assert exported, f"karpenter_tpu.{key} has no counterpart in {port.__name__} and is not listed"


def test_the_lists_are_complete_and_named_in_the_roadmap():
    assert set(MODULES_WITHOUT_COUNTERPART) <= set(jax_modules())
    assert set(TOOLS_WITHOUT_COUNTERPART) <= set(jax_tools())
    assert {k for k in NAMES_WITHOUT_COUNTERPART} <= {f"{p}.{n}" for p, n in init_exports()}
    roadmap = (REPO / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("### C."):]
    for entry in (*MODULES_WITHOUT_COUNTERPART, *TOOLS_WITHOUT_COUNTERPART, *NAMES_WITHOUT_COUNTERPART):
        assert f"`{entry}`" in section, f"ROADMAP.md queue C does not name {entry}"


def test_the_port_tools_named_in_the_roadmap_run_as_modules():
    for name in ("load_harness", "chaos_sweep", "explain", "trace_report", "flight_report"):
        mod = importlib.import_module(f"karpenter_tpu_torch.tools.{name}")
        assert callable(mod.main)
        assert "--device" in Path(mod.__file__).read_text()
