"""Program registry: per-program dispatch, load and device-memory telemetry.

Counterpart of the JAX package's ``obs/programs.py``. A "program" is one
kernel entry with its mode (the names of ``kernels.LAUNCHES``), dispatched
by one of the solver's sites. Every site registers its dispatches here under
a stable program key: the JAX package's program name (the ``__name__`` its
site passes, e.g. ``relax_place``, ``solve_ffd_sweeps_carried``,
``verify_gate``), the claim bucket, the padded shapes, the statics, the
program-keying flags and the device tag. So one scenario gives the same
``program`` label values in both packages; each record also names the
kernel that served it (``kernel``).

Where the sources come from (a deliberate difference). The JAX package
compiles one executable per key; the port compiles nothing per shape, and
one library serves every shape of its kernels. So:

  cold        the key's first dispatch launched a library that ``nvcc``
              built in this process;
  persistent  ... a library loaded from an existing ``_build/`` file (the
              counterpart of the JAX package's on-disk compile cache);
  restored    ... a library restored from a snapshot (solver/aot.py);
  memory      every other dispatch: a key seen before, or a first dispatch
              whose libraries were in use already.

A library counts for the first dispatch on the thread that first launched
it after its load (``kernels.first_uses``); where one dispatch first-launches
several, ``cold`` wins over ``persistent`` over ``restored``. On the CPU the
plain versions load no library: a key's first dispatch there is ``cold``,
as the JAX package's is on a host without a persistent cache.
``solver_compile_seconds{program,source}`` observes the wall of a key's
first dispatch that is not ``memory``: the load, the module's first run and
the launch.

Memory samples (``sample_memory``): on the card, the caching allocator's
``torch.cuda.memory_allocated`` / ``max_memory_allocated`` (source
``allocator``). These are process-wide: with serve replicas on one card, one
replica's sample includes the other's tensors. On the CPU there are no
allocator stats: the sample reports the bytes of the tensors the solve holds
(``held_bytes``, source ``solve_tensors``) with a running peak, where the JAX
package sums ``jax.live_arrays()``.

There is no jaxpr: ``KARPENTER_TPU_PROGRAMS_EQNS`` leaves ``eqns`` null. The
program key goes on the span the port opens around the launch
(``program_key``, ``cache_source``); the JAX package stamps its ``compile``
span, which the port lacks.

Same contract as the JAX package's: off (``KARPENTER_TPU_PROGRAMS`` unset)
every public call returns at once, and the accounting is host-side Python,
so placements are bit-identical. Sinks: ``solver_compile_seconds``,
``solver_program_launches_total``, ``solver_device_bytes``,
``solver_persistent_cache_total``, ``/debug/programs`` and
``/statusz["programs"]`` (operator/serving.py).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_perf = time.perf_counter
_wall = time.time

_enabled_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force the registry on/off (tests, bench); ``None`` restores the env
    flag."""
    global _enabled_override
    _enabled_override = value


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("KARPENTER_TPU_PROGRAMS", "") not in ("", "0")


def eqns_enabled() -> bool:
    """The JAX package's equation-count sub-flag. The port has no jaxpr, so
    nothing counts under it: ``eqns`` stays null."""
    return enabled() and os.environ.get("KARPENTER_TPU_PROGRAMS_EQNS", "") not in ("", "0")


# cache sources, in the order a dispatch tries them
SOURCE_MEMORY = "memory"
SOURCE_RESTORED = "restored"
SOURCE_PERSISTENT = "persistent"
SOURCE_COLD = "cold"
# a first dispatch's source when it first-launched several libraries
_PRECEDENCE = (SOURCE_COLD, SOURCE_PERSISTENT, SOURCE_RESTORED)

# memory sample sources
MEMORY_ALLOCATOR = "allocator"
MEMORY_SOLVE_TENSORS = "solve_tensors"


# -- program keys -------------------------------------------------------------
# The JAX package's program-keying flags: two processes differing in any of
# them run different programs from the same shapes.
PROGRAM_FLAGS = (
    "KARPENTER_TPU_WAVEFRONT",
    "KARPENTER_TPU_WAVEFRONT_WIDTH",
    "KARPENTER_TPU_PACKED_GATES",
    "KARPENTER_TPU_CLAIM_WINDOW",
    "KARPENTER_TPU_STRIDE",
    "KARPENTER_TPU_RUNS",
    "KARPENTER_TPU_SCAN_UNROLL",
    "KARPENTER_TPU_TOPO_CHAIN",
    "KARPENTER_TPU_SPREAD_CHAIN",
    "KARPENTER_TPU_ABLATE",
    "KARPENTER_TPU_RELAX",
    "KARPENTER_TPU_RELAX_PASSES",
    "KARPENTER_TPU_RELAX2",
    "KARPENTER_TPU_RELAX2_ITERS",
    "KARPENTER_TPU_RELAX2_STEP",
    "KARPENTER_TPU_SCREEN_DELTA",
    "KARPENTER_TPU_SCREEN_DELTA_MAX_RUNS",
)


def flag_config() -> Dict[str, str]:
    """The program-keying flags currently set (unset flags omitted)."""
    return {f: os.environ[f] for f in PROGRAM_FLAGS if os.environ.get(f)}


def _digest(text: str, n: int = 8) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:n]


def flag_digest() -> str:
    return _digest(repr(sorted(flag_config().items())))


@functools.lru_cache(maxsize=None)
def _tag(index: Optional[int]) -> str:
    import torch

    if index is None:
        where = "cpu"
    else:
        major, minor = torch.cuda.get_device_capability(index)
        where = f"cuda{torch.version.cuda}-{torch.cuda.get_device_name(index)}-sm_{major}{minor}"
    return re.sub(r"[^A-Za-z0-9._-]", "-", f"torch-{torch.__version__}-{where}")


def isa_tag() -> str:
    """The port's device tag (the JAX package keys its host's CPU features):
    the torch build, and the current CUDA device's name and compute
    capability with the CUDA runtime version, or ``cpu`` without CUDA. The
    form of streaming/snapshot.device_tag, made safe for a directory name
    and a program key."""
    import torch

    return _tag(torch.cuda.current_device() if torch.cuda.is_available() else None)


def _leaves(tree):
    """Every tensor or array leaf of a (nested) tuple, list, dict or
    dataclass, in field order."""
    if tree is None:
        return
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def shape_digest(tree) -> str:
    """Digest of the padded leaf shapes/dtypes, hashed so keys stay
    printable."""
    return _digest(repr([(tuple(leaf.shape), str(leaf.dtype)) for leaf in _leaves(tree)]))


def shape_key(tree) -> tuple:
    """The leaf shapes/dtypes themselves (the compile-cache key's)."""
    return tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in _leaves(tree))


def on_card(tree) -> bool:
    """Whether any tensor leaf lies on a CUDA device."""
    return any(getattr(getattr(leaf, "device", None), "type", None) == "cuda" for leaf in _leaves(tree))


def program_key(name: str, claims: int, shapes, statics=None) -> str:
    """Stable program identity: the JAX package's program name x claim
    bucket x padded shapes x static args x flag config x device tag."""
    parts = [name, f"C{int(claims)}", f"s{shape_digest(shapes)}"]
    if statics:
        parts.append("a" + _digest(repr(sorted(statics.items()))))
    parts.append("f" + flag_digest())
    parts.append(isa_tag())
    return "/".join(parts)


def program_label(name: str, claims: int) -> str:
    """The Prometheus ``program`` label: name + claim bucket only (the full
    key lives in /debug/programs)."""
    return f"{name}/C{int(claims)}"


def library_loads() -> Dict[str, int]:
    """Loaded libraries by origin (kernels.library_origins)."""
    from karpenter_tpu_torch import kernels

    out: Dict[str, int] = {}
    for origin in kernels.library_origins().values():
        out[origin] = out.get(origin, 0) + 1
    return out


# -- the registry -------------------------------------------------------------


class ProgramRecord:
    """Lifetime accounting for one program key."""

    __slots__ = (
        "key", "label", "name", "claims", "kernel", "first_seen_unix", "launches",
        "compiles", "compile_s_total", "compile_s_last", "sources", "eqns",
        "statics", "bytes_last", "bytes_total",
    )

    def __init__(self, key: str, label: str, name: str, claims: int, statics=None, kernel=None):
        self.key = key
        self.label = label
        self.name = name
        self.claims = int(claims)
        self.kernel = kernel
        self.first_seen_unix = _wall()
        self.launches = 0
        self.compiles = 0
        self.compile_s_total = 0.0
        self.compile_s_last: Optional[float] = None
        self.sources: Dict[str, int] = {}
        self.eqns: Optional[int] = None
        self.statics = dict(statics) if statics else {}
        self.bytes_last: Dict[str, int] = {}
        self.bytes_total: Dict[str, int] = {}

    def to_dict(self) -> Dict:
        return {
            "key": self.key,
            "program": self.label,
            "name": self.name,
            "kernel": self.kernel,
            "claims": self.claims,
            "first_seen_unix": self.first_seen_unix,
            "launches": self.launches,
            "compiles": self.compiles,
            "compile_s_total": round(self.compile_s_total, 6),
            "compile_s_last": (
                round(self.compile_s_last, 6) if self.compile_s_last is not None else None
            ),
            "sources": dict(self.sources),
            "eqns": self.eqns,
            "statics": dict(self.statics),
            "bytes_last": dict(self.bytes_last),
            "bytes_total": dict(self.bytes_total),
        }


class ProgramRegistry:
    """Process-global program inventory + device-memory sample ring."""

    def __init__(self, memory_samples: int = 64):
        self._lock = threading.Lock()
        self._programs: Dict[str, ProgramRecord] = {}
        self._seen: set = set()
        self._memory: deque = deque(maxlen=max(1, memory_samples))
        self._live_peak = 0  # running peak of the CPU samples
        self._shard: Optional[Dict] = None

    # -- dispatch accounting ---------------------------------------------------

    def seen(self, key: str) -> bool:
        with self._lock:
            return key in self._seen

    def mark_seen(self, key: str) -> bool:
        """True when the key was new (this dispatch may pay a load)."""
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    def observe(
        self,
        key: str,
        label: str,
        name: str,
        claims: int,
        *,
        source: str,
        wall_s: Optional[float] = None,
        eqns: Optional[int] = None,
        statics=None,
        kernel: Optional[str] = None,
        problem_bytes: int = 0,
        carried_bytes: int = 0,
        result_bytes: int = 0,
        donated_bytes: int = 0,
    ) -> ProgramRecord:
        """Record one dispatch of ``key``; for a source other than memory
        ``wall_s`` is its load cost."""
        from karpenter_tpu_torch.metrics.registry import (
            PERSISTENT_CACHE,
            PROGRAM_COMPILE_SECONDS,
            PROGRAM_LAUNCHES,
        )

        with self._lock:
            rec = self._programs.get(key)
            if rec is None:
                rec = ProgramRecord(key, label, name, claims, statics, kernel)
                self._programs[key] = rec
            rec.launches += 1
            rec.sources[source] = rec.sources.get(source, 0) + 1
            if eqns is not None:
                rec.eqns = eqns
            if source != SOURCE_MEMORY:
                rec.compiles += 1
                if wall_s is not None:
                    rec.compile_s_total += wall_s
                    rec.compile_s_last = wall_s
            for kind, nbytes in (
                ("problem", problem_bytes), ("carried", carried_bytes),
                ("result", result_bytes), ("donated", donated_bytes),
            ):
                rec.bytes_last[kind] = int(nbytes)
                rec.bytes_total[kind] = rec.bytes_total.get(kind, 0) + int(nbytes)
        PROGRAM_LAUNCHES.inc({"program": label})
        if source != SOURCE_MEMORY:
            if wall_s is not None:
                PROGRAM_COMPILE_SECONDS.observe(wall_s, {"program": label, "source": source})
            if source == SOURCE_PERSISTENT:
                result = "hit"
            elif source == SOURCE_RESTORED:
                result = "restored"
            else:
                result = "miss"
            PERSISTENT_CACHE.inc({"result": result})
        return rec

    # -- device-memory sampling ------------------------------------------------

    def _device_memory(self, device=None, held_bytes: int = 0):
        """(live_bytes, peak_bytes, source): the caching allocator's stats on
        the card, else the solve's tensor bytes with a running peak."""
        import torch

        if device is not None and getattr(device, "type", device) == "cuda":
            live = int(torch.cuda.memory_allocated(device))
            peak = int(torch.cuda.max_memory_allocated(device))
            return live, peak, MEMORY_ALLOCATOR
        live = int(held_bytes)
        with self._lock:
            self._live_peak = max(self._live_peak, live)
            peak = self._live_peak
        return live, peak, MEMORY_SOLVE_TENSORS

    def sample_memory(
        self, carried_bytes: int = 0, pods: Optional[int] = None,
        cycle: Optional[str] = None, donated_bytes: int = 0,
        world_bytes: int = 0, device=None, held_bytes: int = 0,
    ) -> Optional[Dict]:
        """One per-solve-cycle sample: live/peak bytes (module docstring:
        process-wide on the card) + the carried FFDState footprint + the
        bytes reused in place. ``world_bytes`` is the resident DeviceWorld,
        reported under the carried_state gauge kind too."""
        from karpenter_tpu_torch.metrics.registry import DEVICE_BYTES

        live, peak, how = self._device_memory(device, held_bytes)
        sample = {
            "unix": _wall(),
            "live_bytes": live,
            "peak_bytes": peak,
            "carried_state_bytes": int(carried_bytes),
            "donated_bytes": int(donated_bytes),
            "source": how,
        }
        if world_bytes:
            sample["world_bytes"] = int(world_bytes)
        if pods is not None:
            sample["pods"] = int(pods)
        if cycle is not None:
            sample["cycle"] = cycle
        with self._lock:
            self._memory.append(sample)
        DEVICE_BYTES.set(live, {"kind": "live"})
        DEVICE_BYTES.set(peak, {"kind": "peak"})
        DEVICE_BYTES.set(int(carried_bytes) + int(world_bytes), {"kind": "carried_state"})
        DEVICE_BYTES.set(int(donated_bytes), {"kind": "donated"})
        return sample

    def note_shard_lanes(self, partitions: int, lanes: int, pod_counts, node_counts) -> None:
        """The last partitioned solve's lane layout."""
        with self._lock:
            self._shard = {
                "unix": _wall(),
                "partitions": int(partitions),
                "lanes": int(lanes),
                "pods_per_partition": [int(c) for c in pod_counts],
                "nodes_per_partition": [int(c) for c in node_counts],
            }

    # -- views -----------------------------------------------------------------

    def snapshot(self) -> Dict:
        """The /debug/programs payload."""
        with self._lock:
            programs = [r.to_dict() for r in self._programs.values()]
            memory = list(self._memory)
            shard = dict(self._shard) if self._shard else None
        programs.sort(key=lambda r: (-r["compile_s_total"], r["key"]))
        loads = library_loads()
        return {
            "enabled": enabled(),
            "isa": isa_tag(),
            "flags": flag_config(),
            "persistent_cache_hits": loads.get(SOURCE_PERSISTENT, 0),
            "library_loads": loads,
            "totals": {
                "programs": len(programs),
                "launches": sum(r["launches"] for r in programs),
                "compiles": sum(r["compiles"] for r in programs),
                "compile_s": round(sum(r["compile_s_total"] for r in programs), 6),
            },
            "programs": programs,
            "memory": {
                "samples": memory,
                "last": memory[-1] if memory else None,
            },
            "shard": shard,
        }

    def summary(self) -> Dict:
        """The /statusz one-liner."""
        with self._lock:
            records = list(self._programs.values())
            last_mem = self._memory[-1] if self._memory else None
        by_source: Dict[str, int] = {}
        for r in records:
            for src, n in r.sources.items():
                by_source[src] = by_source.get(src, 0) + n
        out = {
            "enabled": enabled(),
            "programs": len(records),
            "launches": sum(r.launches for r in records),
            "compile_s": round(sum(r.compile_s_total for r in records), 3),
            "by_source": by_source,
        }
        if last_mem is not None:
            out["device_memory"] = last_mem
        return out

    def reset(self) -> None:
        """Drop all records and the seen-set (tests). Loaded libraries stay
        loaded: pair with kernels.evict when dispatches must read cold."""
        with self._lock:
            self._programs.clear()
            self._seen.clear()
            self._memory.clear()
            self._live_peak = 0
            self._shard = None


_registry: Optional[ProgramRegistry] = None
_registry_lock = threading.Lock()


def registry() -> ProgramRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = ProgramRegistry()
    return _registry


def reset() -> None:
    registry().reset()


# -- dispatch observation helper ----------------------------------------------


class _Dispatch:
    """Handle returned by begin_dispatch: call ``finish()`` after the launch
    and its fetches. Classification happens at finish time (module
    docstring)."""

    __slots__ = ("key", "label", "name", "claims", "statics", "kernel", "first", "card", "uses0", "t0")

    def __init__(self, key, label, name, claims, statics, kernel, first, card, uses0):
        self.key = key
        self.label = label
        self.name = name
        self.claims = claims
        self.statics = statics
        self.kernel = kernel
        self.first = first
        self.card = card
        self.uses0 = uses0
        self.t0 = _perf()

    def finish(
        self,
        problem_bytes: int = 0,
        carried_bytes: int = 0,
        result_bytes: int = 0,
        donated_bytes: int = 0,
        eqns: Optional[int] = None,
        source_override: Optional[str] = None,
    ) -> str:
        from karpenter_tpu_torch import kernels

        wall = _perf() - self.t0
        uses = {origin for _, origin in kernels.first_uses()[self.uses0:]}
        if not self.first:
            source = SOURCE_MEMORY
        elif source_override is not None:
            source = source_override
        elif uses:
            source = next(s for s in _PRECEDENCE if s in uses)
        elif self.card:
            source = SOURCE_MEMORY
        else:
            source = SOURCE_COLD
        registry().observe(
            self.key, self.label, self.name, self.claims,
            source=source, wall_s=wall, eqns=eqns, statics=self.statics, kernel=self.kernel,
            problem_bytes=problem_bytes, carried_bytes=carried_bytes,
            result_bytes=result_bytes, donated_bytes=donated_bytes,
        )
        return source


def begin_dispatch(name: str, claims: int, shapes, statics=None, kernel: Optional[str] = None
                   ) -> Optional[_Dispatch]:
    """Start observing one dispatch; None when the registry is off (callers
    guard with ``if obs:``). ``kernel`` names the kernel that serves it."""
    if not enabled():
        return None
    from karpenter_tpu_torch import kernels

    key = program_key(name, claims, shapes, statics)
    label = program_label(name, claims)
    first = registry().mark_seen(key)
    return _Dispatch(key, label, name, claims, statics, kernel, first, on_card(shapes),
                     len(kernels.first_uses()))


def sample_memory(
    carried_bytes: int = 0, pods: Optional[int] = None,
    cycle: Optional[str] = None, donated_bytes: int = 0,
    world_bytes: int = 0, device=None, held_bytes: int = 0,
) -> Optional[Dict]:
    """Module-level convenience with the off-path short-circuit."""
    if not enabled():
        return None
    return registry().sample_memory(
        carried_bytes, pods=pods, cycle=cycle, donated_bytes=donated_bytes,
        world_bytes=world_bytes, device=device, held_bytes=held_bytes,
    )


def note_shard_lanes(partitions: int, lanes: int, pod_counts, node_counts) -> None:
    """Module-level convenience with the off-path short-circuit."""
    if not enabled():
        return
    registry().note_shard_lanes(partitions, lanes, pod_counts, node_counts)


def stamp(span, obs: Optional[_Dispatch], source: Optional[str]) -> None:
    """Put the program key and its source on the span around the launch."""
    if span is not None and obs is not None:
        span.attrs["program_key"] = obs.key
        span.attrs["cache_source"] = source


def sources_by_program() -> List[Dict]:
    """(program, kernel, sources) of every record, by program label."""
    snap = registry().snapshot()
    return sorted(({"program": r["program"], "kernel": r["kernel"], "sources": r["sources"]}
                   for r in snap["programs"]), key=lambda r: r["program"])
