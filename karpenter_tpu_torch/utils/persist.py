"""Crash-consistent framed files: a magic line, a JSON header (kind,
version, payload length and sha256), then the payload.

Counterpart of the JAX package's ``utils/persist.py``, for the flight
recorder's dumps (obs/flight.py) and the streaming journal
(streaming/snapshot.py). ``write_framed`` writes a temporary file, fsyncs it
and renames it into place, so a reader sees the previous file or the new
one, never a torn one. ``load_framed`` raises :class:`PersistError` with a
classified reason: ``missing``, ``truncated``, ``corrupt``, ``checksum`` or
``version-skew``. The ``persist.pre-rename`` crash point
(testing/faults.crash_point, the ``proc.crash`` site) fires between the
temporary write and the rename: a kill scheduled there must leave the
previous file intact.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple

MAGIC = b"KTPUSNAP1\n"
FRAME_VERSION = 1


class PersistError(Exception):
    """A framed file failed to load; ``reason`` is one of the classified
    failure strings in the module docstring."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail


def _payload_digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def write_framed(
    path: str,
    payload: bytes,
    kind: str,
    version: int,
    meta: Optional[Dict] = None,
) -> str:
    """Atomically persist ``payload`` under the frame. ``kind`` names the
    producer ("aot-entry", "stream-journal"), ``version`` is the CALLER's
    schema version (checked by the caller on load; the frame has its own).
    Returns the final path. Raises OSError on I/O failure — persistence
    callers decide whether that is fatal (it never is: snapshots are an
    optimization)."""
    header = {
        "frame_version": FRAME_VERSION,
        "kind": kind,
        "version": int(version),
        "created_unix": time.time(),
        "payload_len": len(payload),
        "payload_sha256": _payload_digest(payload),
        "meta": dict(meta or {}),
    }
    header_bytes = json.dumps(header, sort_keys=True).encode()
    blob = MAGIC + f"{len(header_bytes):08x}\n".encode() + header_bytes + payload
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    # the torn-write crash site: a SIGKILL here must leave the previous file
    # untouched (loaders ignore temporary files)
    from karpenter_tpu_torch.testing import faults

    faults.crash_point("persist.pre-rename")
    os.replace(tmp, path)
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:
        pass  # non-POSIX-dir fsync; the rename itself already happened
    return path


def load_framed(
    path: str,
    kind: str,
    min_version: int = 1,
    max_version: Optional[int] = None,
) -> Tuple[Dict, bytes]:
    """Read and verify a framed file; returns ``(header, payload)`` or raises
    a classified :class:`PersistError` (module docstring). Accepted caller
    versions are ``[min_version, max_version]`` (max defaults to min)."""
    if not os.path.exists(path):
        raise PersistError("missing", path)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise PersistError("missing", str(exc)) from exc
    if len(blob) < len(MAGIC) + 9:
        raise PersistError("truncated", f"{len(blob)} bytes")
    if not blob.startswith(MAGIC):
        raise PersistError("corrupt", "bad magic")
    off = len(MAGIC)
    try:
        header_len = int(blob[off:off + 8].decode(), 16)
    except ValueError as exc:
        raise PersistError("corrupt", "unparseable header length") from exc
    off += 9  # 8 hex digits + newline
    header_bytes = blob[off:off + header_len]
    if len(header_bytes) < header_len:
        raise PersistError("truncated", "header cut short")
    try:
        header = json.loads(header_bytes.decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise PersistError("corrupt", "unparseable header json") from exc
    if header.get("frame_version") != FRAME_VERSION:
        raise PersistError(
            "version-skew", f"frame_version={header.get('frame_version')}"
        )
    if header.get("kind") != kind:
        raise PersistError(
            "corrupt", f"kind={header.get('kind')!r}, wanted {kind!r}"
        )
    version = header.get("version")
    hi = max_version if max_version is not None else min_version
    if not isinstance(version, int) or not min_version <= version <= hi:
        raise PersistError("version-skew", f"version={version}")
    payload = blob[off + header_len:]
    want_len = header.get("payload_len")
    if not isinstance(want_len, int) or len(payload) < want_len:
        raise PersistError(
            "truncated", f"payload {len(payload)} < {want_len} bytes"
        )
    payload = payload[:want_len]
    if _payload_digest(payload) != header.get("payload_sha256"):
        raise PersistError("checksum", "payload sha256 mismatch")
    return header, payload
