"""The learned order's host half: flags, the weights artifact, and the FFD
tie-break (``KARPENTER_TPU_ORDER_POLICY``).

Counterpart of the JAX package's ``solver/ordering.py``:

  * the flag reads. ``enabled()`` turns on the learned tie-break inside
    ``solver/encode.ffd_order``, the one ordering every backend shares
    (the device solver, ``OracleSolver``, the delta encoder), so the flag
    moves them together. ``lanes_enabled()`` also has the backend's sweeps
    solves sort each requeue by the lane head's scores (ops/policy.py);
    ``KARPENTER_TPU_ORDER_POLICY_LANES=0`` keeps the tie-break alone.
  * the weights artifact: one framed file (utils/persist.py) carrying both
    heads, ``host`` (features of the Pod objects, scored before the FFD
    sort) and ``lane`` (features of the encoded problem, ops/policy.py). The
    package carries its own copy, ``order_policy.v1.bin`` beside this
    module, byte for byte the JAX package's; ``KARPENTER_TPU_ORDER_POLICY
    _WEIGHTS`` names another file. A load failure is classified (the persist
    reasons, ``corrupt`` for a bad payload, ``version-skew`` for another
    feature layout) and degrades to zero weights: every score ties, and the
    stable sort keeps the static order exactly.
    ``solver_order_policy_loads_total{outcome}`` records every resolution.
  * the host head: numpy over the pod list, computed as the JAX package
    computes it, so the two packages' tie-breaks are equal.

Flag off, ``ffd_order`` builds the static sort keys unchanged.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from karpenter_tpu_torch.metrics.registry import (
    ORDER_POLICY_LOADS,
    ORDER_POLICY_SCORE_SECONDS,
    ORDER_POLICY_SOLVES,
)

FLAG = "KARPENTER_TPU_ORDER_POLICY"
LANES_FLAG = "KARPENTER_TPU_ORDER_POLICY_LANES"
WEIGHTS_ENV = "KARPENTER_TPU_ORDER_POLICY_WEIGHTS"

WEIGHTS_KIND = "order-policy"
WEIGHTS_VERSION = 1
HOST_FEATURE_VERSION = 1
N_HOST_FEATURES = 10

_DEFAULT_ARTIFACT = os.path.join(os.path.dirname(__file__), "order_policy.v1.bin")


def enabled() -> bool:
    """The learned tie-break is on (read per call)."""
    return os.environ.get(FLAG, "") not in ("", "0")


def lanes_enabled() -> bool:
    """The device half is on: the backend takes the policy sweeps entries."""
    return enabled() and os.environ.get(LANES_FLAG, "1") != "0"


def builtin_weights() -> Dict:
    """Zero weights: every score ties, so the stable sorts keep the static
    order. The target of every classified load failure."""
    return {
        "arch": "linear",
        "feature_version": HOST_FEATURE_VERSION,
        "lane_feature_version": 1,
        "host": {"w": [0.0] * N_HOST_FEATURES, "b": 0.0, "hidden": None},
        "lane": {"w": [0.0] * 10, "b": 0.0, "hidden": None},
    }


_lock = threading.Lock()
_cache: Optional[Dict] = None
_cache_path: Optional[str] = None


def artifact_path() -> str:
    return os.environ.get(WEIGHTS_ENV) or _DEFAULT_ARTIFACT


def reset_for_tests() -> None:
    global _cache, _cache_path
    with _lock:
        _cache = None
        _cache_path = None


def _load_artifact(path: str) -> Dict:
    from karpenter_tpu_torch.ops.policy import LANE_FEATURE_VERSION
    from karpenter_tpu_torch.utils.persist import PersistError, load_framed

    try:
        _header, payload = load_framed(path, kind=WEIGHTS_KIND, min_version=WEIGHTS_VERSION)
        weights = json.loads(payload.decode())
    except PersistError as exc:
        ORDER_POLICY_LOADS.inc({"outcome": exc.reason})
        return builtin_weights()
    except Exception:  # noqa: BLE001 — a malformed payload is corruption too
        ORDER_POLICY_LOADS.inc({"outcome": "corrupt"})
        return builtin_weights()
    if (
        weights.get("feature_version") != HOST_FEATURE_VERSION
        or weights.get("lane_feature_version") != LANE_FEATURE_VERSION
    ):
        ORDER_POLICY_LOADS.inc({"outcome": "version-skew"})
        return builtin_weights()
    ORDER_POLICY_LOADS.inc({"outcome": "loaded"})
    return weights


def active_weights() -> Dict:
    """The weights in force: the artifact (cached per path), else zeros.
    Never raises."""
    global _cache, _cache_path
    with _lock:
        path = artifact_path()
        if _cache is not None and _cache_path == path:
            return _cache
    loaded = _load_artifact(path)
    with _lock:
        _cache = loaded
        _cache_path = path
        return _cache


def _head_static(head: Dict):
    hidden = head.get("hidden")
    hidden_t = None
    if hidden:
        hidden_t = (
            tuple(tuple(float(x) for x in row) for row in hidden["w"]),
            tuple(float(x) for x in hidden["b"]),
        )
    arch = "mlp" if hidden_t is not None else "linear"
    return (arch, tuple(float(x) for x in head["w"]), float(head["b"]), hidden_t)


def lane_weights_static():
    """The lane head as ``(arch, w, b, hidden)``, what ops/policy reads."""
    return _head_static(active_weights()["lane"])


# -- the host head (Pod objects) -----------------------------------------------


def host_features(pods: Sequence, requests_of=None, signatures=None) -> np.ndarray:
    """f32[n, N_HOST_FEATURES] over API Pod objects. Identical pods give
    identical rows."""
    from karpenter_tpu_torch.solver.encode import constraint_signature
    from karpenter_tpu_torch.utils import resources as res

    if requests_of is None:
        requests_of = res.pod_requests
    n = len(pods)
    if signatures is None:
        signatures = [constraint_signature(p) for p in pods]
    sig_count: Dict[str, int] = {}
    for s in signatures:
        sig_count[s] = sig_count.get(s, 0) + 1
    feats = np.zeros((n, N_HOST_FEATURES), np.float32)
    for i, p in enumerate(pods):
        requests = requests_of(p)
        spec = p.spec
        aff = spec.affinity
        node_terms = len(aff.node_affinity.required) if aff and aff.node_affinity else 0
        pod_aff = len(aff.pod_affinity.required) if aff and aff.pod_affinity else 0
        pod_anti = len(aff.pod_anti_affinity.required) if aff and aff.pod_anti_affinity else 0
        has_ports = any(c.ports for c in spec.containers)
        extra = sum(1 for k in requests if k not in (res.CPU, res.MEMORY))
        feats[i] = (
            np.log1p(requests.get(res.CPU, 0.0)),
            np.log1p(requests.get(res.MEMORY, 0.0) / 2.0**20),
            float(extra),
            float(len(spec.node_selector) + node_terms),
            float(len(spec.tolerations)),
            float(has_ports),
            float(len(spec.topology_spread_constraints)),
            float(pod_aff),
            float(pod_anti),
            sig_count[signatures[i]] / max(n, 1),
        )
    return feats


def _eval_head(feats: np.ndarray, head_static) -> np.ndarray:
    arch, w, b, hidden = head_static
    x = feats
    if arch == "mlp" and hidden is not None:
        w1 = np.asarray(hidden[0], np.float32)
        b1 = np.asarray(hidden[1], np.float32)
        x = np.tanh(x @ w1.T + b1)
    return (x @ np.asarray(w, np.float32) + np.float32(b)).astype(np.float32)


def order_scores(pods: Sequence, requests_of=None, signatures=None) -> np.ndarray:
    """f32[n] learned priority per pod (higher sorts earlier within its
    resource tier): the ``ffd_order`` hook, timed by
    solver_order_policy_score_seconds."""
    t0 = time.perf_counter()
    feats = host_features(pods, requests_of, signatures)
    scores = _eval_head(feats, _head_static(active_weights()["host"]))
    ORDER_POLICY_SCORE_SECONDS.observe(time.perf_counter() - t0)
    ORDER_POLICY_SOLVES.inc({"part": "host"})
    return scores
