"""Build and load the package's CUDA kernels.

At first use, every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The library lands in ``build/`` next to this file,
named by a hash of the sources and flags, so an unchanged tree reuses it
and an edited one rebuilds.  Any failure to find nvcc, compile or load
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every entry point returns a cudaError_t as int
_SIGNATURES = {
    "yag_scatter_cells": (_P, _P, _P, _I, _I, _I, _P),
    "yag_smear_quantize": (_P, _P, _P, _P, _I, _I, _I, _P),
    "yag_smear_smem_bytes": (_I,),
    "yag_window_sum": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

CUDA_ROOTS = ("/usr/local/cuda",)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the compile this process ran, if any


def find_nvcc() -> str:
    """Path of nvcc: $PATH first, then $CUDA_HOME and CUDA_ROOTS."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, sorted(CSRC_DIR.glob("*.cuh"))


def _library_path(srcs, headers) -> Path:
    h = hashlib.sha256()
    for f in srcs + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libyag_kernels_{h.hexdigest()[:16]}.so"


def _compile(srcs, target: Path):
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0


def library():
    """The loaded kernel library, compiled first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            srcs, headers = _sources()
            path = _library_path(srcs, headers)
            if not path.exists():
                _compile(srcs, path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
