"""Host encode parity: karpenter_tpu_torch's Encoder + pad_problem against the
JAX package's, leaf by leaf.

The port keeps its own copy of the numpy encode (solver/encode.py,
ops/padding.py), so the padded SchedulingProblem both packages feed their
solvers must be byte-identical for equal API objects.

Equal objects are drawn twice, once per package, by the same generator code
with the same seeds: karpenter_tpu_torch.testing.workloads (drawn like the
JAX package's bench and parity-suite generators), and a copy of that module
bound to karpenter_tpu's classes. Drawing both sides (rather than copying
objects across) matters: the encoder interns label values in set-iteration
order, so the two sides must build their sets in the same order.
"""

import types
from pathlib import Path

import numpy as np
import pytest

from karpenter_tpu.apis import labels as wk
from karpenter_tpu.cloudprovider.fake import FAKE_WELL_KNOWN_LABELS
from karpenter_tpu.ops.padding import pad_problem
from karpenter_tpu.provisioning.topology import Topology
from karpenter_tpu.solver.encode import Encoder, domains_from_instance_types
from karpenter_tpu_torch.models.problem import numpy_fields
from karpenter_tpu_torch.ops.padding import pad_problem as t_pad_problem
from karpenter_tpu_torch.provisioning.topology import Topology as TTopology
from karpenter_tpu_torch.solver.encode import Encoder as TEncoder
from karpenter_tpu_torch.solver.encode import domains_from_instance_types as t_domains
from karpenter_tpu_torch.testing import workloads as port_workloads
import tests.torch_threads  # noqa: F401  (one intra-op thread)


def _reference_workloads():
    """karpenter_tpu_torch/testing/workloads.py bound to karpenter_tpu."""
    path = Path(port_workloads.__file__)
    src = path.read_text().replace("karpenter_tpu_torch.", "karpenter_tpu.")
    mod = types.ModuleType("reference_workloads")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


reference_workloads = _reference_workloads()

# name -> draw(module) -> (pods, instance types, templates, nodes[, pod volumes])
WORKLOADS = {
    "diverse-280": lambda m: m.diverse_workload(280, 40),
    "chain-2000": lambda m: m.chain_workload(2000),
    "chain-2003": lambda m: m.chain_workload(2003),
    "fuzz-1": lambda m: m.fuzz_workload(1),
    "fuzz-6": lambda m: m.fuzz_workload(6),
    "topology-3": lambda m: m.topology_workload(3),
    "topology-8": lambda m: m.topology_workload(8),
    "bounds-0": lambda m: m.bounds_workload(0),
    "volumes-0": lambda m: m.volume_workload(0),
    # beyond tier-1 (slow fuzz seeds) and the slot-overflow case
    "chain-2001": lambda m: m.chain_workload(2001),
    "chain-2002": lambda m: m.chain_workload(2002),
    "chain-2004": lambda m: m.chain_workload(2004),
    "bounds-1": lambda m: m.bounds_workload(1),
    # no kernel shape limit: K > 32 label keys, V > 2,048 value lanes
    "wide-keys": lambda m: m.wide_keys_workload(),
    "wide-lanes": lambda m: m.wide_lanes_workload(),
    # the two-phase solve's corpora (tests/test_solver_relax_parity.py families)
    "homog-48": lambda m: m.homogeneous_workload(48),
    "bounds-0-free": lambda m: m.bounds_workload(0, with_nodes=False),
    **{f"rfuzz-{s}": (lambda s: lambda m: m.relax_fuzz_workload(s))(s) for s in range(8)},
    **{f"rtopo-{s}": (lambda s: lambda m: m.relax_topology_workload(s))(s) for s in range(8)},
}


def draw(name):
    """(JAX-package workload, port workload, pod volumes or None)."""
    j, t = WORKLOADS[name](reference_workloads), WORKLOADS[name](port_workloads)
    if name.startswith("volumes-"):
        (j, vols), (t, _) = j, t
        return j, t, vols
    return j, t, None


def encode_both(name, claim_slots=32, well_known=FAKE_WELL_KNOWN_LABELS):
    """(jax padded problem, jax meta, port padded problem, port meta) of one
    workload encoded by each package from equal API objects."""
    workload, t_workload, pod_volumes = draw(name)
    pods, its, tpls, nodes = workload
    topo = Topology(domains_from_instance_types(its, tpls), batch_pods=pods, cluster_pods=[])
    for n in nodes:
        topo.register(wk.LABEL_HOSTNAME, n.name)
    enc = Encoder(well_known).encode(pods, its, tpls, nodes, topology=topo,
                                     num_claim_slots=claim_slots, pod_volumes=pod_volumes)
    t_pods, t_its, t_tpls, t_nodes = t_workload
    t_topo = TTopology(t_domains(t_its, t_tpls), batch_pods=t_pods, cluster_pods=[])
    for n in t_nodes:
        t_topo.register(wk.LABEL_HOSTNAME, n.name)
    t_enc = TEncoder(well_known).encode(
        t_pods, t_its, t_tpls, t_nodes, topology=t_topo, num_claim_slots=claim_slots,
        pod_volumes=pod_volumes,
    )
    return pad_problem(enc.problem), enc.meta, t_pad_problem(t_enc.problem), t_enc.meta


TIER1 = ["diverse-280", "chain-2000", "chain-2003", "fuzz-1", "fuzz-6", "topology-3",
         "topology-8", "bounds-0", "volumes-0"]


@pytest.mark.parametrize("name", TIER1)
def test_encode_pad_leaf_parity(name):
    jp, jmeta, tp, tmeta = encode_both(name)
    if name.startswith("volumes-"):
        assert jp.pod_vol_counts.any()
    jf, tf = numpy_fields(jp), numpy_fields(tp)
    assert sorted(jf) == sorted(tf)
    for key in jf:
        a, b = jf[key], tf[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), key
    for field in ("keys", "values_per_key", "resource_names", "pod_order",
                  "template_names", "instance_type_names", "node_names"):
        assert getattr(jmeta, field) == getattr(tmeta, field), field


def test_generators_draw_like_the_reference_suites():
    """The shared generators reproduce the JAX package's bench and parity
    generators draw for draw."""
    import random

    from bench import make_diverse_pods
    from tests.test_chain_parity import _population
    from tests.test_solver_parity import TestRandomizedTopologyParity

    def key(pods):
        return [(p.metadata.name, p.metadata.labels, repr(p.spec)) for p in pods]

    assert key(reference_workloads.chain_workload(2003)[0]) == key(_population(2003)[0])
    assert key(reference_workloads.diverse_workload(280, 40)[0]) == key(
        make_diverse_pods(280, random.Random(42))
    )
    rng = random.Random(1000 + 3)
    rng.choice([6, 10])
    rng.random()
    n = rng.randint(10, 60)
    gen = TestRandomizedTopologyParity()
    assert key(reference_workloads.topology_workload(3)[0]) == key(
        [gen._make_topology_pod(rng, i) for i in range(n)]
    )
