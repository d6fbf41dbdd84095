"""Crash-consistent streaming-state journal: warm solves that survive exec.

Counterpart of the JAX package's ``streaming/snapshot.py``. The warm path's
advantage lives in ``StreamingSolver._prev`` (streaming/warm.py), process
memory, so a restart used to re-solve the whole world cold. This module
journals the accepted cycle state (the previous snapshot's pods and nodes
with their identity digests, the accepted ``SolveResult``, the FFD queue
order and the certified prefix: ``_StreamState``) through the framed files of
utils/persist.py (temporary write, fsync, atomic rename, sha256, version
header), so a freshly started process re-enters the warm path on its first
cycle.

Safety before speed, in three layers:

  1. every way the file can be wrong is a classified cold start
     (``karpenter_solver_state_restore_total{outcome}``, :data:`OUTCOMES`):
     loading never raises into the solve path;
  2. a decoded journal is admitted only behind the full-level host
     validator (outcome ``validator`` when rejected);
  3. an admitted journal only seeds the delta diff: the next cycle still
     diffs the live world against it, and any divergence falls out as the
     ordinary ``cold-world-changed`` / ``cold-threshold`` outcomes.

``reset_streaming_state`` (the supervisor's quarantine hook) also removes
the journal: a quarantined result must not come back after a crash.

Two points differ from the JAX package:

  * the tag in the frame's header is this package's own (``device_tag``):
    the torch build and the device of the backend that solves (the CUDA
    device's name and compute capability, ``cpu`` for a CPU ``TorchSolver``,
    ``host`` for a host-only backend such as ``OracleSolver``), where the JAX
    package writes its host's CPU-feature tag. A journal written by a run on
    another device or torch build is classified ``isa-mismatch``: a CPU run's
    journal is never restored on the card;
  * the frame's kind is ``stream-journal-torch``, so a journal the JAX
    package wrote into the same ``KARPENTER_TPU_STATE_DIR`` is classified
    ``corrupt`` before anything is unpickled (unpickling it would import the
    JAX package). The journaled result carries no ``verify_ctx``
    (streaming/warm.py strips it: it holds the solve's device tensors), and
    the payload holds no ``torch.Tensor``.

Enabled by ``KARPENTER_TPU_STATE_DIR``; cadence via
``KARPENTER_TPU_STATE_SNAPSHOT_EVERY`` (journal every Nth accepted cycle,
default 1), staleness bound via ``KARPENTER_TPU_STATE_MAX_AGE_S`` (default
900 s).
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import time
from typing import Optional, Tuple

log = logging.getLogger(__name__)

JOURNAL_VERSION = 1
JOURNAL_KIND = "stream-journal-torch"

# classified restore outcomes (the bounded metric label-value set)
OUTCOMES = (
    "restored", "missing", "truncated", "corrupt", "checksum",
    "version-skew", "isa-mismatch", "stale", "validator", "error",
)


def enabled() -> bool:
    return bool(os.environ.get("KARPENTER_TPU_STATE_DIR"))


def journal_path(namespace: Optional[str] = None) -> Optional[str]:
    """Journal file location; ``namespace`` (the serve layer passes the
    tenant id) isolates each tenant stream's journal, so one tenant's
    invalidation or corruption never costs another its warm restart."""
    root = os.environ.get("KARPENTER_TPU_STATE_DIR")
    if not root:
        return None
    if namespace:
        safe = re.sub(r"[^A-Za-z0-9._-]", "-", namespace)
        return os.path.join(root, "stream", safe, "journal.snap")
    return os.path.join(root, "stream", "journal.snap")


def cadence() -> int:
    try:
        return max(1, int(os.environ.get("KARPENTER_TPU_STATE_SNAPSHOT_EVERY", "1")))
    except ValueError:
        return 1


def max_age_s() -> float:
    try:
        return float(os.environ.get("KARPENTER_TPU_STATE_MAX_AGE_S", "900"))
    except ValueError:
        return 900.0


def device_tag(backend) -> str:
    """The journal's tag: the torch build and the device of the backend that
    solves. Walks ``primary`` / ``inner`` wrappers to the backend; one with a
    ``device`` attribute (``TorchSolver``) names it, any other is ``host``."""
    import torch

    seen = set()
    while id(backend) not in seen:
        seen.add(id(backend))
        nxt = getattr(backend, "primary", None) or getattr(backend, "inner", None)
        if nxt is None:
            break
        backend = nxt
    dev = getattr(backend, "device", None)
    if not isinstance(dev, torch.device):
        where = "host"
    elif dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        where = f"cuda:{torch.cuda.get_device_name(dev)}:sm_{major}{minor}"
    else:
        where = dev.type
    return f"torch-{torch.__version__}/{where}"


_warned: set = set()


def _warn_once(tag: str, msg: str, *args) -> None:
    if tag in _warned:
        return
    _warned.add(tag)
    log.warning(msg, *args)


def save(state, tag: str, namespace: Optional[str] = None) -> bool:
    """Journal one accepted ``_StreamState`` under ``tag``. Best-effort: a
    journal failure costs the next process a cold solve, never this one
    anything, so every failure is a warning and a counter, never an
    exception. Returns success."""
    from karpenter_tpu_torch.metrics.registry import RESTORE_FALLBACK
    from karpenter_tpu_torch.testing import faults
    from karpenter_tpu_torch.utils import persist

    path = journal_path(namespace)
    if path is None:
        return False
    try:
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as exc:  # noqa: BLE001 — an unpicklable field, not a bug here
        RESTORE_FALLBACK.inc({"reason": "journal-persist-error"})
        _warn_once(
            "pickle", "stream journal: state not picklable, journaling "
            "disabled for this cycle: %s: %s", type(exc).__name__, exc,
        )
        return False
    faults.crash_point("journal.pre-write")
    try:
        persist.write_framed(
            path, payload, kind=JOURNAL_KIND, version=JOURNAL_VERSION,
            meta={
                "isa": tag,
                "pods": len(state.pods),
                "nodes": len(state.nodes),
                "certified": len(state.certified_uids),
            },
        )
    except OSError as exc:
        RESTORE_FALLBACK.inc({"reason": "journal-persist-error"})
        _warn_once("write", "stream journal: write failed: %s: %s", type(exc).__name__, exc)
        return False
    faults.crash_point("journal.post-write")
    return True


def invalidate(namespace: Optional[str] = None) -> None:
    """Remove the on-disk journal (quarantine / reset): a state the live
    process rejected must not be what the next process restores."""
    path = journal_path(namespace)
    if path is None:
        return
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
    except OSError as exc:
        _warn_once("invalidate", "stream journal: invalidate failed: %s: %s", type(exc).__name__, exc)


def load(tag: str, namespace: Optional[str] = None) -> Tuple[str, Optional[object]]:
    """Restore the journal: ``(outcome, state)``, outcome one of
    :data:`OUTCOMES`, state a ``_StreamState`` only for ``restored``. Counts
    every attempt in ``solver_state_restore_total{outcome}`` and every
    degradation in ``restore_fallback_total{reason=journal-*}``; a restore
    is never unclassified and never raises."""
    from karpenter_tpu_torch.metrics.registry import RESTORE_FALLBACK, STATE_RESTORE
    from karpenter_tpu_torch.utils.persist import PersistError, load_framed

    def classify(outcome: str) -> Tuple[str, None]:
        STATE_RESTORE.inc({"outcome": outcome})
        # "missing" is the normal first boot, not a degradation
        if outcome not in ("restored", "missing"):
            RESTORE_FALLBACK.inc({"reason": f"journal-{outcome}"})
        return outcome, None

    path = journal_path(namespace)
    if path is None:
        return classify("missing")
    try:
        header, payload = load_framed(path, kind=JOURNAL_KIND, min_version=JOURNAL_VERSION)
    except PersistError as exc:
        return classify(exc.reason)
    if header.get("meta", {}).get("isa") != tag:
        return classify("isa-mismatch")
    age = time.time() - float(header.get("created_unix", 0.0))
    if age > max_age_s():
        return classify("stale")
    try:
        state = pickle.loads(payload)
    except Exception:  # noqa: BLE001 — checksummed, but be exhaustive
        return classify("error")
    try:
        from karpenter_tpu_torch.solver import validator as val

        violations = val.validate_result(
            state.result, state.pods, state.instance_types, state.templates,
            nodes=state.nodes, level="full",
        )
    except Exception:  # noqa: BLE001 — a malformed state that crashes the gate
        return classify("error")
    if violations:
        _warn_once(
            "validator", "stream journal: restored state rejected by the "
            "full validator gate (%d violations), cold start", len(violations),
        )
        return classify("validator")
    STATE_RESTORE.inc({"outcome": "restored"})
    return "restored", state
