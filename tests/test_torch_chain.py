"""Chain commits: the port's plain sweeps against the JAX package's
``solve_ffd_sweeps`` on chain-heavy populations (the counterpart of
tests/test_chain_parity.py).

The JAX sweeps loop batches chain-identical pods (``pod_eqprev_chain``)
through four commit branches (single, waterfill, closed-form spread round,
spread mini-scan); ops/ffd_chain.py ports them. On the same padded problem
both packages must agree on per-row (kind, index), every integer and bool leaf
of the final state, and all four IterCounts fields; float leaves are held to
rtol 1e-5 (they agree bit for bit on these seeds: a chain commit's
``requests + k * request`` rounds once in both packages). The differential
solves each problem a second time with ``pod_eqprev_chain`` replaced by byte
identity ``pod_eqprev``: both packages again agree, and the placements equal
the chain run's.
"""

import dataclasses

import numpy as np
import pytest

from karpenter_tpu.apis import labels as wk
from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.ops.ffd import solve_ffd_sweeps as j_solve_ffd_sweeps
from karpenter_tpu.ops.padding import pad_problem
from karpenter_tpu.provisioning.topology import Topology
from karpenter_tpu.solver.encode import Encoder, domains_from_instance_types
from karpenter_tpu_torch.models.problem import numpy_fields, problem_from_numpy
from karpenter_tpu_torch.ops.ffd_sweeps import solve_ffd_sweeps
from tests.test_torch_encode import reference_workloads
from tests.test_torch_ffd import assert_same_result
import tests.torch_threads  # noqa: F401  (one intra-op thread)

SLOTS = 128
# chain-3000 commits through every branch (waterfill, round, spread
# mini-scan); chain-3003 has the most spread commits
SEEDS = (3000, 3003)


def _encode(seed: int):
    pods, its, templates, nodes = reference_workloads.chain_workload(seed)
    topo = Topology(domains_from_instance_types(its, templates), batch_pods=pods, cluster_pods=[])
    for n in nodes:
        topo.register(wk.LABEL_HOSTNAME, n.name)
    encoded = Encoder(FAKE_WELL_KNOWN_LABELS).encode(pods, its, templates, nodes, topology=topo,
                                                     num_claim_slots=SLOTS)
    return pad_problem(encoded.problem)


@pytest.fixture(scope="module")
def solved():
    """Per seed and variant (chain identity, byte identity): the JAX and the
    port's result on the same padded problem."""
    out = {}
    for seed in SEEDS:
        jp = _encode(seed)
        assert jp.pod_eqprev_chain is not None
        for variant, problem in (("chain", jp), ("byte", dataclasses.replace(jp, pod_eqprev_chain=jp.pod_eqprev))):
            jr = j_solve_ffd_sweeps(problem, SLOTS)
            tr = solve_ffd_sweeps(problem_from_numpy(numpy_fields(problem), "cpu"), SLOTS)
            out[seed, variant] = (jr, tr)
    return out


@pytest.mark.parametrize("variant", ["chain", "byte"])
@pytest.mark.parametrize("seed", SEEDS)
def test_chain_family_parity(solved, seed, variant):
    jr, tr = solved[seed, variant]
    assert_same_result(jr, tr)


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_vs_byte_chains(solved, seed):
    """Chain identity batches more than byte identity and places the same."""
    (_, chain), (_, byte) = solved[seed, "chain"], solved[seed, "byte"]
    np.testing.assert_array_equal(chain.kind.numpy(), byte.kind.numpy())
    np.testing.assert_array_equal(chain.index.numpy(), byte.index.numpy())
    assert chain.iters.narrow <= byte.iters.narrow


def test_chain_commits_fire(solved):
    """Chain commits fire on every seed, each consuming more than one pod,
    and on some seed the chains hold more pods than the solve has narrow
    iterations."""
    fired = [solved[seed, "chain"][1].iters for seed in SEEDS]
    assert all(it.chain_commits > 0 and it.chain_pods > it.chain_commits for it in fired)
    assert any(it.narrow < it.chain_pods for it in fired)
