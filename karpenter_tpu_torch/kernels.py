"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``_build/`` beside this file
(git-ignored), at first use. The file name carries a digest of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.
``build()`` starts one ``nvcc`` per source at once. The libraries are loaded
with ``ctypes``; each exports ``<name>_launch(const Args*, cudaStream_t)``,
which returns ``cudaGetLastError()`` after its launch, and an args-size
function the wrappers check their ``ctypes.Structure`` against.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it.

Failures raise typed exceptions, which the solver supervisor classifies by
class name (solver/supervisor.classify_failure): a build that fails raises
:class:`KernelCompileError` (class ``compile``: the same sources fail the
same way again), a launch that the CUDA runtime refuses raises
:class:`KernelDeviceError` (class ``device``; the supervisor raises it). A shape whose
dynamic shared memory exceeds what a block of the card may opt into is such a
refused launch: each ``*_launch`` sizes its shared memory from the shape and
returns the runtime's error when the card cannot hold it.

Each loaded library keeps its origin (``library_origins``): ``cold`` when
``nvcc`` built it in this process, ``persistent`` when it was loaded from an
existing ``_build/`` file, ``restored`` when solver/aot.py restored it from
a snapshot (``install``). Each library's first launch on a thread after
its load is recorded for the program registry (obs/programs.py:
``first_uses``), and a library's first load writes its snapshot entry when
solver/aot.py is on.
``nvcc`` is found on ``PATH``, else under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``); ``NVCC_RUNS`` lists the libraries it built here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

SOURCES = {
    "attribute": "attribute.cu",
    "ffd_loop": "ffd_loop.cu",
    "gate_counts": "gate_counts.cu",
    "lane_scores": "lane_scores.cu",
    "patch_world": "patch_world.cu",
    "probe": "probe.cu",
    "relax_place": "relax_place.cu",
    "runs_screen": "runs_screen.cu",
}
# each entry's library and its exported (launch, args-size) symbols: one
# entry per library under its own name, plus the lanes modes, which are
# launch functions of their own in the same library
_SYMBOLS = {
    "attribute": ("attribute_launch", "attribute_args_size"),
    "ffd_loop": ("ffd_loop_launch", "ffd_loop_args_size"),
    "gate_counts": ("gate_counts_launch", "gate_args_size"),
    "lane_scores": ("lane_scores_launch", "lane_scores_args_size"),
    "patch_world": ("patch_world_launch", "patch_world_args_size"),
    "probe": ("probe_launch", "probe_args_size"),
    "relax_place": ("relax_place_launch", "relax_place_args_size"),
    "runs_screen": ("runs_screen_launch", "runs_screen_args_size"),
    "ffd_loop_lanes": ("ffd_loop_lanes_launch", "ffd_loop_lanes_args_size"),
    "relax2_place_lanes": ("relax_place_lanes_launch", "relax_place_lanes_args_size"),
}
# the library of each lanes mode
_LIBRARY_OF = {"ffd_loop_lanes": "ffd_loop", "relax2_place_lanes": "relax_place"}

# -fmad=false: masks.cuh's fits() must round like the plain PyTorch version
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel; a mode with a program of its own counts under its own
# name (relax_place's convex mode as relax2_place; the lanes modes of the
# partitioned solve as ffd_loop_lanes and relax2_place_lanes; ffd_loop with
# the wavefront on, csrc/wave.cuh, as ffd_loop_wavefront, in its lanes mode
# as ffd_loop_lanes)
LAUNCHES: Dict[str, int] = {
    name: 0 for name in (*SOURCES, "relax2_place", "ffd_loop_lanes", "relax2_place_lanes", "ffd_loop_wavefront")
}


class KernelCompileError(RuntimeError):
    """A kernel did not build: no ``nvcc``, or ``nvcc`` failed (its output
    is in the message)."""


class KernelDeviceError(RuntimeError):
    """The CUDA runtime refused a kernel launch (its error code is in the
    message)."""


_lock = threading.Lock()
# one build at a time in a process: the operator's start() builds on a
# thread of its own while a controller's first launch may build the same
# library (each writes the same temporary file)
_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
# per loaded library: its file and its origin (cold, persistent, restored)
_paths: Dict[str, Path] = {}
_origin: Dict[str, str] = {}
# libraries some thread has used since they were loaded
_used: set = set()
# the libraries nvcc built in this process, in build order, and each
# build's wall (seconds from the start of its batch of builds to its exit)
NVCC_RUNS: List[str] = []
BUILD_SECONDS: Dict[str, float] = {}
# per thread: (library, origin) of each library's first use on that thread
_tls = threading.local()

ORIGIN_COLD = "cold"
ORIGIN_PERSISTENT = "persistent"
ORIGIN_RESTORED = "restored"


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelCompileError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def source_digest(name: str) -> str:
    """The digest of a library's sources and flags (its file name's)."""
    digest = hashlib.sha256()
    for f in (SOURCES[name], *sorted(p.name for p in CSRC.glob("*.cuh"))):
        digest.update((CSRC / f).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def symbols(name: str) -> List[Tuple[str, str]]:
    """The (launch, args-size) symbols a library must export."""
    return [syms for entry, syms in _SYMBOLS.items() if _LIBRARY_OF.get(entry, entry) == name]


def library_origins() -> Dict[str, str]:
    """Each loaded library's origin."""
    with _lock:
        return dict(_origin)


def loaded_path(name: str) -> Optional[Path]:
    with _lock:
        return _paths.get(name)


def first_uses() -> List[Tuple[str, str]]:
    """This thread's record of first uses: (library, origin) each time a
    library was used for the first time since it was loaded."""
    uses = getattr(_tls, "uses", None)
    if uses is None:
        uses = _tls.uses = []
    return uses


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. A library that is
    loaded already (restored from a snapshot, say) is built. Returns the
    library paths; raises KernelCompileError with the compiler's output if
    any build fails. The ptxas
    report (registers, shared memory, spills) lands in ``_build/<name>.log``."""
    names = list(SOURCES) if names is None else list(names)
    with _build_lock:
        return _build(names)


def _build(names) -> Dict[str, Path]:
    loaded = {n: p for n, p in list(_paths.items()) if n in names}
    paths = {n: library_path(n) for n in names if n not in loaded}
    if paths:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[n])]
        with open(BUILD_DIR / f"{n}.log", "wb") as log:
            procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
        NVCC_RUNS.append(n)
    # each build's wall from the common start to its own exit
    pending = dict(procs)
    while pending:
        for n, (proc, _) in list(pending.items()):
            if proc.poll() is not None:
                BUILD_SECONDS[n] = time.perf_counter() - t0
                del pending[n]
        if pending:
            time.sleep(0.05)
    failures = []
    for n, (proc, tmp) in procs.items():
        if proc.returncode != 0:
            log = (BUILD_DIR / f"{n}.log").read_bytes()
            failures.append(f"{n}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise KernelCompileError("kernel build failed:\n" + "\n".join(failures))
    return {**paths, **loaded}


def _open(name: str, path: Path) -> ctypes.CDLL:
    """dlopen a library and type its exported symbols; a missing symbol
    raises AttributeError."""
    lib = ctypes.CDLL(str(path))
    for launch, size in symbols(name):
        getattr(lib, launch).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, launch).restype = ctypes.c_int
        getattr(lib, size).argtypes = []
        getattr(lib, size).restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use. Its first load
    writes its snapshot entry (solver/aot.py) when snapshots are on."""
    fresh = False
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _open(name, path)
            _libs[name], _paths[name] = lib, path
            _origin[name] = ORIGIN_COLD if name in NVCC_RUNS else ORIGIN_PERSISTENT
            fresh = True
    if fresh:
        from karpenter_tpu_torch.solver import aot

        aot.persist_library(name, path)
    return lib


def install(name: str, path: Path) -> ctypes.CDLL:
    """Load a restored library (solver/aot.py) in place of a build: later
    calls of ``library(name)`` return it, with origin ``restored``. Raises
    OSError or AttributeError when the file does not load or lacks a
    symbol."""
    lib = _open(name, path)
    with _lock:
        _libs[name], _paths[name] = lib, path
        _origin[name] = ORIGIN_RESTORED
        _used.discard(name)
    return lib


def evict(names: Iterable[str]) -> None:
    """Forget loaded libraries: the next use of each builds or loads it
    under ``_build/`` again (ctypes cannot unload a library, so the evicted
    file stays mapped but is never called again)."""
    with _lock:
        for name in names:
            _libs.pop(name, None)
            _paths.pop(name, None)
            _origin.pop(name, None)
            _used.discard(name)


def load_all() -> Dict[str, str]:
    """Build every library that is not loaded (one nvcc per source, all at
    once) and load each: the operator's startup step. Returns the origins."""
    build()
    for name in SOURCES:
        library(name)
    return library_origins()


def launch(name: str, args: ctypes.Structure, stream: int, counter: Optional[str] = None) -> None:
    """Launch kernel ``name`` (a library, or a lanes mode of one) with its
    argument struct on a CUDA stream handle; raises KernelDeviceError on a
    launch error. Counts the launch under ``counter`` (default ``name``)."""
    lib_name = _LIBRARY_OF.get(name, name)
    lib = library(lib_name)
    if lib_name not in _used:
        with _lock:
            if lib_name not in _used and lib_name in _origin:
                _used.add(lib_name)
                first_uses().append((lib_name, _origin[lib_name]))
    launch_sym, size_sym = _SYMBOLS[name]
    expected = getattr(lib, size_sym)()
    if expected != ctypes.sizeof(args):
        raise RuntimeError(
            f"{name}: argument struct is {ctypes.sizeof(args)} bytes, the kernel expects {expected}"
        )
    rc = getattr(lib, launch_sym)(ctypes.addressof(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelDeviceError(f"{name}: CUDA launch error {rc}")
    # two dispatcher threads (serve replicas) may launch at once: a bare
    # += on the dict can lose a count
    with _count_lock:
        LAUNCHES[counter or name] += 1


def make_struct(name: str, pointer_fields: Iterable[str], int_fields: Iterable[str],
                float_fields: Iterable[str] = ()):
    """A ctypes.Structure class with the given pointer fields, then int32
    fields, then float32 fields — the layout of the C argument structs in
    csrc/."""
    fields = ([(f, ctypes.c_void_p) for f in pointer_fields] + [(f, ctypes.c_int) for f in int_fields]
              + [(f, ctypes.c_float) for f in float_fields])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def workspace(spec: Iterable[Tuple[str, "torch.dtype", Tuple[int, ...]]], device) -> dict:
    """One uninitialised allocation cut into a view per (name, dtype, shape),
    each at a 16-byte boundary: a launch's scratch and outputs in one
    allocator call."""
    import torch

    spec = list(spec)
    offsets, at = [], 0
    for _, dtype, shape in spec:
        n = 1
        for d in shape:
            n *= int(d)
        nbytes = n * dtype.itemsize
        offsets.append((at, nbytes))
        at += (nbytes + 15) // 16 * 16
    buf = torch.empty((max(at, 16),), dtype=torch.uint8, device=device)
    out = {}
    for (name, dtype, shape), (off, nbytes) in zip(spec, offsets):
        out[name] = buf[off:off + nbytes].view(dtype).view(shape)
    return out
