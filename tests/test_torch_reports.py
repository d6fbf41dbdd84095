"""The port's dump renderers (karpenter_tpu_torch/tools/{explain,trace_report,
flight_report}.py) against the JAX system's tools/ of the same names: dumps
the port makes on the CPU (an explain report, solve traces, a flight-recorder
dump) render to the same text through both, from memory, from a file and
from the port's live endpoints; ``--demo`` runs with ``--device cpu`` and the
default device is the card."""

import json
import sys
from pathlib import Path

import pytest
import torch

import tests.torch_threads  # noqa: F401  (one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tools.explain as JE  # noqa: E402
import tools.flight_report as JF  # noqa: E402
import tools.trace_report as JT  # noqa: E402
from karpenter_tpu_torch.tools import explain as TE  # noqa: E402
from karpenter_tpu_torch.tools import flight_report as TF  # noqa: E402
from karpenter_tpu_torch.tools import trace_report as TT  # noqa: E402


@pytest.fixture(scope="module")
def explain_reports():
    from karpenter_tpu_torch.obs import explain

    try:
        return TE._demo_reports("cpu")
    finally:
        explain.reset_ring()


@pytest.fixture(scope="module")
def traces():
    from karpenter_tpu_torch.obs import trace

    try:
        return TT._demo_traces("cpu")
    finally:
        trace.reset_ring()


@pytest.fixture(scope="module")
def flight_body():
    from karpenter_tpu_torch.obs import flight, slo

    try:
        return TF._demo("cpu")
    finally:
        flight.reset()
        slo.reset()


@pytest.fixture
def endpoint():
    """The port's endpoint server on a free localhost port."""
    from karpenter_tpu_torch.operator import serving

    server = serving.serve(0, host="127.0.0.1")
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


# -- explain ------------------------------------------------------------------


def test_explain_report_renders_alike(explain_reports):
    assert len(explain_reports) == 1
    (rep,) = explain_reports
    assert rep["backend"] == "TorchSolver" and rep["unschedulable"] == 2
    text = TE.render_report(rep)
    assert text == JE.render_report(rep)
    assert "resources" in text and "requirements" in text
    for pod in rep["pods"].values():
        assert TE.render_pod(pod) == JE.render_pod(pod)
    for key in rep["pods"]:
        assert TE.render_report(rep, only_pod=int(key)) == JE.render_report(rep, only_pod=int(key))


def test_explain_demo_matches_the_jax_demo_pod_for_pod(explain_reports):
    """The port's demo solve explains the JAX tool's demo pods as the JAX
    package does: the same failed pods, reasons, hints and gate waterfalls."""
    from karpenter_tpu.obs import explain as j_explain

    try:
        (jrep,) = JE._demo_reports()
    finally:
        j_explain.reset_ring()
    (rep,) = explain_reports
    assert sorted(rep["pods"]) == sorted(jrep["pods"])
    assert rep["reasons"] == jrep["reasons"]
    for key in rep["pods"]:
        assert TE.render_pod(rep["pods"][key]) == JE.render_pod(jrep["pods"][key])


def test_explain_reads_a_dump_file_and_the_live_endpoint(explain_reports, tmp_path, endpoint, capsys):
    from karpenter_tpu_torch.obs import explain

    path = tmp_path / "explain.json"
    path.write_text(json.dumps({"reports": explain_reports}, default=str))
    assert TE._load(str(path)) == JE._load(str(path)) == json.loads(json.dumps(explain_reports, default=str))
    assert TE.main([str(path)]) == 0
    from_file = capsys.readouterr().out
    assert JE.main([str(path)]) == 0
    assert capsys.readouterr().out == from_file
    ring = explain.reset_ring()
    try:
        for rep in explain_reports:
            ring.append(rep)
        url = f"{endpoint}/debug/explain"
        assert TE._load(url) == JE._load(url)
        assert TE.main([url]) == 0
        assert capsys.readouterr().out == from_file
    finally:
        explain.reset_ring()


# -- traces -----------------------------------------------------------------------


def test_trace_waterfall_renders_alike(traces):
    assert len(traces) == 2
    for tr in traces:
        assert tr["name"] == "solve"
        text = TT.render_waterfall(tr)
        assert text == JT.render_waterfall(tr)
        for stage in ("encode", "sweeps", "decode"):
            assert stage in text


def test_trace_chrome_export_and_the_live_endpoint(traces, tmp_path, endpoint, capsys):
    from karpenter_tpu_torch.obs import trace

    path = tmp_path / "traces.json"
    path.write_text(json.dumps({"traces": traces}))
    outs = {}
    for name, tool in (("torch", TT), ("jax", JT)):
        out = tmp_path / f"chrome-{name}.json"
        assert tool.main([str(path), "--chrome", str(out)]) == 0
        outs[name] = out.read_text()
    capsys.readouterr()
    assert outs["torch"] == outs["jax"] == trace.chrome_trace_json(traces, indent=1)
    assert json.loads(outs["torch"])["traceEvents"]
    assert TT.main([str(path)]) == 0
    from_file = capsys.readouterr().out
    assert JT.main([str(path)]) == 0
    assert capsys.readouterr().out == from_file
    ring = trace.reset_ring()
    try:
        for tr in reversed(traces):
            ring.append(tr)
        url = f"{endpoint}/debug/traces"
        assert TT._load(url) == JT._load(url) == traces
        assert TT.main([url]) == 0
        assert capsys.readouterr().out == from_file
    finally:
        trace.reset_ring()


# -- flight -------------------------------------------------------------------------


def test_flight_dump_renders_alike(flight_body):
    kinds = [e["kind"] for e in flight_body["events"]]
    assert kinds.count("solve-cycle") == 4 and "gate-audit" in kinds
    assert flight_body["reason"] == "slo-breach" and flight_body["objective"] == "gate-integrity"
    text = TF.render(flight_body)
    assert text == JF.render(flight_body)
    assert "trace lineage" in text
    assert TF.render({"events": []}) == JF.render({"events": []})


def test_flight_reads_a_dump_file_and_the_live_endpoint(tmp_path, endpoint, capsys):
    """A dump the port's recorder writes loads and renders alike through
    both tools, and so does its live ring at /debug/flight."""
    import os

    from karpenter_tpu_torch.obs import flight

    saved = os.environ.get("KARPENTER_TPU_FLIGHT_DIR")
    os.environ["KARPENTER_TPU_FLIGHT_DIR"] = str(tmp_path)
    flight.set_enabled(True)
    try:
        flight.reset()
        flight.record(flight.KIND_SOLVE_CYCLE, trace_id="t-1", pods=4, scheduled=3, failed=1, duration_s=0.01)
        flight.record(flight.KIND_SOLVE_RETRY, trace_id="t-1", attempt=1, **{"class": "device"})
        flight.record(flight.KIND_MESH_FAULT, trace_id="t-2", device=0, reason="device-lost")
        path = flight.snapshot_dump("recarve")
        assert path is not None
        assert TF._load(path) == JF._load(path)
        assert TF.main([path]) == 0
        from_file = capsys.readouterr().out
        assert JF.main([path]) == 0
        assert capsys.readouterr().out == from_file
        assert "mesh-fault" in from_file and "reason=recarve" in from_file
        url = f"{endpoint}/debug/flight"
        live = TF._load(url)
        assert live == JF._load(url) and live["reason"] == "live"
        assert TF.render(live) == JF.render(live)
    finally:
        flight.set_enabled(None)
        flight.reset()
        if saved is None:
            os.environ.pop("KARPENTER_TPU_FLIGHT_DIR", None)
        else:
            os.environ["KARPENTER_TPU_FLIGHT_DIR"] = saved


# -- the entry points ------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["explain", "trace_report", "flight_report"])
def test_demo_runs_on_the_cpu(tool, tmp_path, capsys):
    from karpenter_tpu_torch.obs import explain, flight, slo, trace

    mod = {"explain": TE, "trace_report": TT, "flight_report": TF}[tool]
    try:
        assert mod.main(["--demo", "--device", "cpu"]) == 0
    finally:
        explain.reset_ring()
        trace.reset_ring()
        flight.reset()
        slo.reset()
    out = capsys.readouterr().out
    want = {"explain": "report TorchSolver", "trace_report": "backend=TorchSolver", "flight_report": "slo-breach"}
    assert want[tool] in out


@pytest.mark.parametrize("tool", ["explain", "trace_report", "flight_report", "load_harness", "chaos_sweep"])
def test_tools_default_to_the_card(tool):
    """Without ``--device cpu`` each tool solves on CUDA, and raises where
    there is none."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the tool would run for real")
    mod = importlib.import_module(f"karpenter_tpu_torch.tools.{tool}")
    argv = ["--demo"] if tool in ("explain", "trace_report", "flight_report") else ["--quick"] \
        if tool == "chaos_sweep" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
