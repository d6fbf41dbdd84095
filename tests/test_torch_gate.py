"""Invariant-gate parity: karpenter_tpu_torch's verify_gate (plain PyTorch,
CPU tensors) against the JAX package's verify_gate on the same GateProblem /
GateArgs — clean results and results corrupted to trip each of the seven
invariants — with identical integer counts; and the composite full_gate of
both packages on the same solve results, clean and corrupted."""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.solver.jax_backend import JaxSolver
from karpenter_tpu.verify import device as jdev
from karpenter_tpu.verify import full_gate as j_full_gate
from karpenter_tpu.verify.gate import _build_args as j_build_args
from karpenter_tpu_torch.models.problem import ReqTensor as TReq
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.verify import device as tdev
from karpenter_tpu_torch.verify import full_gate as t_full_gate
from tests.test_torch_encode import draw
import tests.torch_threads  # noqa: F401  (one intra-op thread)

GATE_WORKLOADS = ["fuzz-1", "fuzz-6", "bounds-0", "diverse-280"]

_SOLVES = {}


def _jax_case(name):
    """(workload, port workload, JAX result, gp, ga, bounds_free) — one JAX
    solve per workload for the whole module."""
    if name not in _SOLVES:
        wl, t_wl, _ = draw(name)
        pods, its, tpls, nodes = wl
        result = JaxSolver(well_known=FAKE_WELL_KNOWN_LABELS).solve(pods, its, tpls, nodes)
        assert result.verify_ctx is not None
        gp, ga, bf = j_build_args(result.verify_ctx, result, pods, None)
        gp = type(gp)(*(_np_leaf(x) for x in gp))
        ga = type(ga)(*(_np_leaf(x) for x in ga))
        _SOLVES[name] = (wl, t_wl, result, gp, ga, bf)
    return _SOLVES[name]


def _np_leaf(x):
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: np.array(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return np.array(x)


def _torch_leaf(x):
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return TReq(*(torch.from_numpy(np.ascontiguousarray(getattr(x, f.name))) for f in dataclasses.fields(x)))
    return torch.from_numpy(np.ascontiguousarray(x))


def _counts_both(gp, ga, bf):
    jc = np.asarray(jdev.verify_gate(gp, ga, bf))
    tgp = tdev.GateProblem(*(_torch_leaf(x) for x in gp))
    tga = tdev.GateArgs(*(_torch_leaf(x) for x in ga))
    tc = tdev.verify_gate(tgp, tga, bf).numpy()
    return jc, tc


def _corrupt(kind, gp, ga):
    """A copy of (gp, ga) that trips ``kind``; None when this result lacks
    what the corruption needs (two pods on one claim, pods on a node)."""
    C = ga.claim_tpl.shape[0]
    pod_bin = ga.pod_bin
    placed = np.flatnonzero(pod_bin >= 0)
    on_claims = pod_bin[(pod_bin >= 0) & (pod_bin < C)]
    c0 = int(np.bincount(on_claims).argmax())
    on_c0 = np.flatnonzero(pod_bin == c0)
    if kind == "clean":
        return gp, ga
    if kind == "claim-requests":
        rep = ga.claim_reported.copy()
        rep[c0, 0] += 1.0
        return gp, ga._replace(claim_reported=rep)
    if kind == "claim-capacity":
        return gp._replace(it_alloc=np.full_like(gp.it_alloc, -1.0)), ga
    if kind == "instance-type-survivor":
        return gp, ga._replace(claim_its=np.ones_like(ga.claim_its))
    if kind == "taint-admissibility":
        tol, tn = gp.pod_tol_tpl.copy(), gp.pod_tol_node.copy()
        tol[placed] = False
        tn[placed] = False
        return gp._replace(pod_tol_tpl=tol, pod_tol_node=tn), ga
    if kind == "host-port":
        if len(on_c0) < 2:
            return None
        ports, conf = gp.pod_ports.copy(), gp.pod_port_conflict.copy()
        ports[on_c0[0], 0] = True
        conf[on_c0[1], 0] = True
        return gp._replace(pod_ports=ports, pod_port_conflict=conf), ga
    if kind == "requirement-intersection":
        zone, p0 = 0, int(on_c0[0])
        cr, pr = ga.claim_req, gp.pod_reqs
        cadm, ccomp, cdef = cr.admitted.copy(), cr.comp.copy(), cr.defined.copy()
        cadm[c0, zone] = False
        ccomp[c0, zone] = False
        cdef[c0, zone] = True
        padm, pcomp, pdef = pr.admitted.copy(), pr.comp.copy(), pr.defined.copy()
        padm[p0, zone] = gp.lane_valid[zone]
        pcomp[p0, zone] = False
        pdef[p0, zone] = True
        chk = ga.pod_check.copy()
        chk[p0] = True
        return (
            gp._replace(pod_reqs=dataclasses.replace(pr, admitted=padm, comp=pcomp, defined=pdef)),
            ga._replace(claim_req=dataclasses.replace(cr, admitted=cadm, comp=ccomp, defined=cdef),
                        pod_check=chk),
        )
    if kind == "node-capacity":
        if not (pod_bin >= C).any():
            return None
        return gp._replace(node_avail=np.zeros_like(gp.node_avail)), ga
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["clean", *jdev.INVARIANTS])
@pytest.mark.parametrize("name", GATE_WORKLOADS)
def test_verify_gate_counts_parity(name, kind):
    _, _, _, gp, ga, bf = _jax_case(name)
    corrupted = _corrupt(kind, gp, ga)
    if corrupted is None:
        # this workload lacks the precondition; the identical clean counts
        # still have to hold
        corrupted = (gp, ga)
        kind = "clean"
    jc, tc = _counts_both(*corrupted, bf)
    np.testing.assert_array_equal(tc, jc)
    if kind == "clean":
        assert not jc.any()
    else:
        assert jc[jdev.INVARIANTS.index(kind)] > 0


def test_corruptions_cover_every_invariant():
    tripped = set()
    for name in GATE_WORKLOADS:
        _, _, _, gp, ga, _ = _jax_case(name)
        tripped |= {k for k in jdev.INVARIANTS if _corrupt(k, gp, ga) is not None}
    assert tripped == set(jdev.INVARIANTS)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("name", ["fuzz-6", "bounds-0"])
def test_full_gate_parity(name, corrupt):
    (pods, its, tpls, nodes), (t_pods, t_its, t_tpls, t_nodes), jres, _, _, _ = _jax_case(name)
    # the JAX result is a KARPENTER_TPU_RELAX=0 solve (tests/conftest.py)
    tres = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(
        t_pods, t_its, t_tpls, t_nodes)
    if corrupt:
        # a published claim whose requests disagree with its pods
        for res in (jres, tres):
            res.new_claims[0].requests["cpu"] = res.new_claims[0].requests.get("cpu", 0.0) + 5.0
    jo = j_full_gate(jres, pods, its, tpls, nodes)
    to = t_full_gate(tres, t_pods, t_its, t_tpls, t_nodes)
    if corrupt:
        for res in (jres, tres):
            res.new_claims[0].requests["cpu"] -= 5.0
    assert jo is not None and to is not None
    assert (to.mode, to.counts) == (jo.mode, jo.counts)
    assert [str(v) for v in to.violations] == [str(v) for v in jo.violations]
    assert bool(to.violations) == corrupt


def test_full_gate_raises_when_the_device_program_fails(monkeypatch):
    """A failing device program (on the card: a kernel that does not build or
    launch) reaches the caller; the gate does not move to the host validator
    on its own."""
    _, (t_pods, t_its, t_tpls, t_nodes), _, _, _, _ = _jax_case("fuzz-6")
    tres = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu").solve(t_pods, t_its, t_tpls, t_nodes)

    def failing(*args, **kwargs):
        raise RuntimeError("gate_counts: CUDA launch error 700")

    monkeypatch.setattr(tdev, "verify_gate", failing)
    with pytest.raises(RuntimeError, match="launch error"):
        t_full_gate(tres, t_pods, t_its, t_tpls, t_nodes)


def test_full_gate_is_none_only_where_it_does_not_apply():
    _, (t_pods, t_its, t_tpls, t_nodes), _, _, _, _ = _jax_case("fuzz-6")
    tres = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu").solve(t_pods, t_its, t_tpls, t_nodes)
    assert t_full_gate(tres, t_pods, t_its, t_tpls, t_nodes) is not None
    assert t_full_gate(tres, t_pods[:-1], t_its, t_tpls, t_nodes) is None  # another batch
    tres.verify_ctx = None  # a multi-pass solve attaches no context
    assert t_full_gate(tres, t_pods, t_its, t_tpls, t_nodes) is None


def test_audit_mismatch_records_a_flight_event(monkeypatch):
    """A device accept the float64 audit overturns (a result corrupted past
    float32 error, the device program's counts forced to accept, the audit
    at rate 1.0): both packages count the mismatch, record one ``gate-audit``
    flight event with equal fields, and answer with the host's violations."""
    from karpenter_tpu.obs import flight as j_flight
    from karpenter_tpu.verify import gate as j_gate
    from karpenter_tpu_torch.obs import flight as t_flight
    from karpenter_tpu_torch.verify import gate as t_gate

    (pods, its, tpls, nodes), (t_pods, t_its, t_tpls, t_nodes), jres, _, _, _ = _jax_case("fuzz-6")
    tres = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(
        t_pods, t_its, t_tpls, t_nodes)
    monkeypatch.setenv("KARPENTER_TPU_VERIFY_AUDIT_FRAC", "1.0")
    outcomes, records = [], []
    for gate, flight, res, args in ((j_gate, j_flight, jres, (pods, its, tpls, nodes)),
                                    (t_gate, t_flight, tres, (t_pods, t_its, t_tpls, t_nodes))):
        monkeypatch.setattr(gate, "_device_counts", lambda *a, **k: {})
        res.new_claims[0].requests["cpu"] = res.new_claims[0].requests.get("cpu", 0.0) + 5.0
        flight.set_enabled(True)
        flight.reset()
        try:
            outcome = gate.full_gate(res, *args)
            records.append([{k: v for k, v in r.items() if k not in ("t", "trace_id")}
                            for r in flight.ring().snapshot()])
        finally:
            flight.set_enabled(None)
            flight.reset()
            res.new_claims[0].requests["cpu"] -= 5.0
        outcomes.append((outcome.mode, outcome.audit_outcome, [str(v) for v in outcome.violations]))
    assert outcomes[1] == outcomes[0] and outcomes[1][:2] == ("host-confirm", "mismatch") and outcomes[1][2]
    assert records[1] == records[0] == [{"kind": "gate-audit", "outcome": "mismatch"}]


def test_gate_spans_match_jax():
    """ROADMAP C8: a traced full gate opens ``gate`` over ``gate_program`` in both
    packages, with the reject reason on a rejected result."""
    from karpenter_tpu.obs import trace as j_trace
    from karpenter_tpu_torch.obs import trace as t_trace

    (pods, its, tpls, nodes), (t_pods, t_its, t_tpls, t_nodes), jres, _, _, _ = _jax_case("fuzz-6")
    tres = TorchSolver(well_known=FAKE_WELL_KNOWN_LABELS, device="cpu", relax=False).solve(
        t_pods, t_its, t_tpls, t_nodes)
    j_full_gate(jres, pods, its, tpls, nodes)  # the JAX gate program's compile, outside the trace

    def spans(node):
        return (node["name"], node.get("attrs", {}).get("reject"), tuple(spans(c) for c in node.get("children", ())))

    trees = []
    for trace, gate, res, args in ((j_trace, j_full_gate, jres, (pods, its, tpls, nodes)),
                                   (t_trace, t_full_gate, tres, (t_pods, t_its, t_tpls, t_nodes))):
        trace.set_enabled(True)
        trace.reset_ring()
        try:
            for bump in (0.0, 5.0):
                res.new_claims[0].requests["cpu"] = res.new_claims[0].requests.get("cpu", 0.0) + bump
                with trace.cycle("verify"):
                    gate(res, *args)
                res.new_claims[0].requests["cpu"] -= bump
            trees.append([spans(t["root"]) for t in reversed(trace.ring().snapshot())])
        finally:
            trace.set_enabled(None)
    assert trees[1] == trees[0]
    assert trees[1][0] == ("verify", None, (("gate", None, (("gate_program", None, ()),)),))
    assert trees[1][1][2][0][1] is not None  # the rejected gate names its reason
