"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -I csrc -o build/kernels/<name>-<hash>.so csrc/<name>.cu

under ``build/kernels/`` at the repository root (git-ignored).  The file
name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a built one is reused.  No PyTorch header is compiled, which
keeps a build to seconds.  Every pointer and the stream pass as
``c_void_p``; each C entry point returns ``cudaGetLastError()``.

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them — the way a cold process builds every kernel in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("lane_probe", "spmm_ell", "probe_push", "flash_attention")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()  # one build and one load per library


def nvcc() -> str:
    """The CUDA compiler: ``$NVCC``, else ``nvcc`` on PATH, else the toolkit's."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hash of sources + flags in the name)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def _finish(name: str, job) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)


def build_all(names=KERNELS) -> None:
    """Build every named kernel library that is not built yet, in parallel."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    Safe to call from several threads: the first caller builds and loads,
    the others wait for it."""
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def bind(lib: ctypes.CDLL, symbol: str, n_ptrs: int, n_ints: int,
         n_floats: int = 0):
    """Declare ``int symbol(void* x n_ptrs, int x n_ints, float x n_floats,
    void* stream)``."""
    fn = getattr(lib, symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
