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
:class:`KernelDeviceError` (class ``device``, retried). A shape whose
dynamic shared memory exceeds what a block of the card may opt into is such a
refused launch: each ``*_launch`` sizes its shared memory from the shape and
returns the runtime's error when the card cannot hold it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

SOURCES = {
    "attribute": "attribute.cu",
    "ffd_loop": "ffd_loop.cu",
    "gate_counts": "gate_counts.cu",
    "patch_world": "patch_world.cu",
    "relax_place": "relax_place.cu",
    "runs_screen": "runs_screen.cu",
}
# each library's exported (launch, args-size) symbols
_SYMBOLS = {
    "attribute": ("attribute_launch", "attribute_args_size"),
    "ffd_loop": ("ffd_loop_launch", "ffd_loop_args_size"),
    "gate_counts": ("gate_counts_launch", "gate_args_size"),
    "patch_world": ("patch_world_launch", "patch_world_args_size"),
    "relax_place": ("relax_place_launch", "relax_place_args_size"),
    "runs_screen": ("runs_screen_launch", "runs_screen_args_size"),
}

# -fmad=false: masks.cuh's fits() must round like the plain PyTorch version
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}


class KernelCompileError(RuntimeError):
    """A kernel did not build: no ``nvcc``, or ``nvcc`` failed (its output
    is in the message)."""


class KernelDeviceError(RuntimeError):
    """The CUDA runtime refused a kernel launch (its error code is in the
    message)."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelCompileError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for f in (SOURCES[name], *sorted(p.name for p in CSRC.glob("*.cuh"))):
        digest.update((CSRC / f).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Returns the library
    paths; raises KernelCompileError with the compiler's output if any
    build fails. The ptxas
    report (registers, shared memory, spills) lands in ``_build/<name>.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{n}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise KernelCompileError("kernel build failed:\n" + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            launch, size = _SYMBOLS[name]
            getattr(lib, launch).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            getattr(lib, launch).restype = ctypes.c_int
            getattr(lib, size).argtypes = []
            getattr(lib, size).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(name: str, args: ctypes.Structure, stream: int) -> None:
    """Launch kernel ``name`` with its argument struct on a CUDA stream
    handle; raises KernelDeviceError on a launch error. Counts the launch."""
    lib = library(name)
    launch_sym, size_sym = _SYMBOLS[name]
    expected = getattr(lib, size_sym)()
    if expected != ctypes.sizeof(args):
        raise RuntimeError(
            f"{name}: argument struct is {ctypes.sizeof(args)} bytes, the kernel expects {expected}"
        )
    rc = getattr(lib, launch_sym)(ctypes.addressof(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelDeviceError(f"{name}: CUDA launch error {rc}")
    LAUNCHES[name] += 1


def make_struct(name: str, pointer_fields: Iterable[str], int_fields: Iterable[str]):
    """A ctypes.Structure class with the given pointer fields, then int32
    fields — the layout of the C argument structs in csrc/."""
    fields = [(f, ctypes.c_void_p) for f in pointer_fields] + [(f, ctypes.c_int) for f in int_fields]
    return type(name, (ctypes.Structure,), {"_fields_": fields})
