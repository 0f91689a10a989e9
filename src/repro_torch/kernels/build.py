"""Build and load the CUDA kernel libraries (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``. All sources build in parallel,
at first use, into ``_build/`` next to this file (listed in .gitignore).
A library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and a current one is loaded as it is.

Nothing here runs at import time: this module imports on a machine
without ``nvcc`` or a GPU, where only the plain versions run.
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

__all__ = ["SOURCES", "build_all", "load_library", "check", "KernelBuildError",
           "CudaKernelError"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("ell_spmv", "seg_spmv", "ell_spmm", "seg_spmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed or is missing."""


class CudaKernelError(RuntimeError):
    """A kernel launch returned a CUDA error (``cudaGetLastError``)."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME "
                           "(/usr/local/cuda); the cuda backend needs it")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all sources at once.

    Returns the seconds each compile took (empty when all were built).
    Raises :class:`KernelBuildError` with nvcc's output on failure. The
    library is written under a temporary name and renamed into place, so
    concurrent builders never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.is_file():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.spmv_error_string.restype = ctypes.c_char_p
            lib.spmv_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`CudaKernelError` when a launch returned an error."""
    if code != 0:
        msg = lib.spmv_error_string(code).decode()
        raise CudaKernelError(f"{what}: CUDA error {code} ({msg})")
