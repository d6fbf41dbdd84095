"""Topology-run commit: one scan step places a whole run of identical
topology-interacting pods through a light per-pod inner loop.

Plain PyTorch counterpart of the JAX package's ``ops/topo_runs.py``. Per pod
it makes the per-pod step's choices (ops/ffd_step.make_step): the first
existing node whose fresh row passes the topology gate, else the open claim
with the fewest pods that passes compatibility, topology and the
instance-type gate, else a fresh claim from the first accepting template.
What differs from stepping the members one by one is the node capacity: it
is the integer capacity of each node at the start of the run
(ops/ffd_core._capacity) less the members already placed there, and the
members' node requests, pod counts and ports are applied in bulk after the
run (``requests + taken * pod_requests``). Eligibility (solver/encode.py
RUN_TOPO): identical rows, no host ports, no CSI volumes.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.models.problem import HOSTNAME_KEY, SchedulingProblem
from karpenter_tpu_torch.ops import masks
from karpenter_tpu_torch.ops.ffd_core import (
    _BIG,
    KIND_CLAIM,
    KIND_FAIL,
    KIND_NEW_CLAIM,
    KIND_NO_SLOT,
    KIND_NODE,
    FFDState,
    PodRow,
    _add_times,
    _bcast,
    _capacity,
    _first_true,
    _fresh_template_rows,
    _intersect_rows,
    _make_it_gate,
    _mix_req_rows,
)
from karpenter_tpu_torch.ops.topology_kernels import PodTopoStatics, record, topo_gate


def make_topo_run_commit(problem: SchedulingProblem, statics, C: int, max_run: int):
    lv, ln = statics.lv, statics.ln
    wellknown, no_allow = statics.wellknown, statics.no_allow
    it_gate = _make_it_gate(problem, statics)
    N = problem.num_nodes
    G = problem.num_groups
    dev = lv.device
    arange_c = torch.arange(C, device=dev)
    mint = problem.claim_hostname_lane.shape[0] > 0
    host_groups = problem.grp_key == HOSTNAME_KEY
    true = torch.ones((), dtype=torch.bool, device=dev)

    def commit(state: FFDState, pod: PodRow, start: int, length: int, active_arr):
        kind_row = torch.full((max_run,), KIND_FAIL, dtype=torch.int32, device=dev)
        index_row = torch.full((max_run,), -1, dtype=torch.int32, device=dev)
        act = active_arr[start:start + max_run].tolist()
        if N > 0:
            # resource capacity and port conflicts are invariant across the
            # run; requirement rows are re-read per pod (an earlier member
            # can narrow a node's row)
            node_port_ok = ~(state.node_used_ports & pod.conflict[None, :]).any(dim=-1)
            node_res_cap = _capacity(problem.node_avail, state.node_requests, pod.requests[None, :])
            taken = torch.zeros((N,), dtype=torch.int32, device=dev)
        for i in range(min(length, max_run)):
            if not act[i]:
                continue
            # a member's own select row (records read it everywhere; gates
            # read it only at matched groups, where it equals the head's)
            sel = problem.pod_grp_selects[start + i] if G > 0 else pod.grp_selects
            topo_pod = PodTopoStatics(
                strict_admitted=pod.strict.admitted, grp_match=pod.grp_match,
                grp_selects=sel, grp_owned=pod.grp_owned,
            )

            # -- 1. existing nodes on their fresh rows
            if N > 0:
                node_merged = _intersect_rows(state.node_req, pod.req)
                node_compat = masks.compatible_ok(state.node_req, _bcast(pod.req), lv, ln, no_allow)
                node_topo_ok, node_final = topo_gate(
                    problem, state.grp_counts, state.grp_registered, topo_pod, node_merged, no_allow
                )
                n_ok = pod.tol_node & node_compat & node_port_ok & (node_res_cap - taken > 0) & node_topo_ok
                if bool(n_ok.any()):
                    n = int(_first_true(n_ok))
                    final = node_final.row(n)
                    state.grp_counts, state.grp_registered = record(
                        problem, state.grp_counts, state.grp_registered, topo_pod, final,
                        no_allow, true, lv, ln,
                    )
                    state.node_req = _mix_req_rows(state.node_req, node_final, torch.arange(N, device=dev) == n)
                    taken[n] += 1
                    kind_row[i], index_row[i] = KIND_NODE, n
                    continue

            # -- 2. claims in fewest-pods order, each verified exactly
            opt = (
                state.claim_open & pod.tol_tpl[state.claim_tpl.long()]
                & ~(state.claim_used_ports & pod.conflict[None, :]).any(dim=-1)
            )
            rank = torch.where(opt, state.claim_npods * C + arange_c, torch.full_like(arange_c, _BIG))
            picked = None
            for c in torch.argsort(rank, stable=True).tolist():
                if not bool(opt[c]):
                    break
                row = state.claim_req.row(c)
                compat = masks.compatible_ok(row, pod.req, lv, ln, wellknown)
                merged1 = _bcast(masks.intersect(row, pod.req))
                ok_t, final1 = topo_gate(
                    problem, state.grp_counts, state.grp_registered, topo_pod, merged1, wellknown
                )
                requests2 = state.claim_requests[c] + pod.requests
                itok2 = it_gate(final1, requests2[None, :], state.claim_it_ok[c][None, :])[0]
                if bool(compat) and bool(ok_t[0]) and bool(itok2.any()):
                    picked = (c, final1, requests2, itok2)
                    break
            if picked is not None:
                c, final1, requests2, itok2 = picked
                state.grp_counts, state.grp_registered = record(
                    problem, state.grp_counts, state.grp_registered, topo_pod, final1.row(0),
                    wellknown, true, lv, ln,
                )
                state.claim_req = _mix_req_rows(state.claim_req, final1, arange_c == c)
                state.claim_requests[c] = requests2
                state.claim_it_ok[c] = itok2
                state.claim_npods[c] += 1
                state.claim_used_ports[c] |= pod.ports
                kind_row[i], index_row[i] = KIND_CLAIM, c
                continue

            # -- 3. a fresh template claim
            closed = ~state.claim_open
            has_slot = bool(closed.any())
            free_slot_t = _first_true(closed)
            tpl_merged, tpl_compat, host_onehot = _fresh_template_rows(
                problem, lv, ln, wellknown, pod.req, free_slot_t
            )
            reg_for_tpl = state.grp_registered
            if mint:
                reg_for_tpl = reg_for_tpl | (host_groups[:, None] & host_onehot[None, :])
            tpl_ok_t, tpl_final = topo_gate(
                problem, state.grp_counts, reg_for_tpl, topo_pod, tpl_merged, wellknown
            )
            tpl_requests2 = problem.tpl_overhead + pod.requests[None, :]
            within = masks.fits(problem.it_cap[None, :, :], state.remaining[:, None, :])
            tpl_it_ok2 = it_gate(tpl_final, tpl_requests2, problem.tpl_it_ok & within)
            tpl_ok = pod.tol_tpl & tpl_compat & tpl_ok_t & tpl_it_ok2.any(dim=-1)
            if not (has_slot and bool(tpl_ok.any())):
                # with no free slot the verdict reads NO_SLOT (the backend's
                # slot-growth retry decides)
                kind_row[i] = KIND_FAIL if has_slot else KIND_NO_SLOT
                continue
            j = int(_first_true(tpl_ok))
            slot = int(free_slot_t)
            slot_req = tpl_final.row(j)
            row_itok = tpl_it_ok2[j]
            max_cap = torch.where(row_itok[:, None], problem.it_cap, torch.zeros_like(problem.it_cap)).max(dim=0).values
            state.grp_counts, state.grp_registered = record(
                problem, state.grp_counts, reg_for_tpl, topo_pod, slot_req, wellknown, true, lv, ln,
            )
            state.claim_req = _mix_req_rows(state.claim_req, _bcast(slot_req), arange_c == slot)
            state.claim_requests[slot] = tpl_requests2[j]
            state.claim_it_ok[slot] = row_itok
            state.claim_open[slot] = True
            state.claim_npods[slot] += 1
            state.claim_tpl[slot] = j
            state.claim_used_ports[slot] |= pod.ports
            state.remaining[j] = state.remaining[j] - max_cap
            kind_row[i], index_row[i] = KIND_NEW_CLAIM, slot

        # bulk-apply the node fills (rows were committed in the loop)
        if N > 0:
            state.node_requests = _add_times(state.node_requests, taken[:, None], pod.requests[None, :])
            state.node_npods = state.node_npods + taken
            state.node_used_ports = state.node_used_ports | ((taken > 0)[:, None] & pod.ports[None, :])
        return kind_row, index_row

    return commit
