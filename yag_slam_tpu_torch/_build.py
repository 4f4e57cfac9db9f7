"""Build and load the package's native libraries.

Three libraries, each built at first use into ``build/`` next to this file,
named by a hash of its sources and flags (an unchanged tree reuses it, an
edited one rebuilds), compiled in a temporary directory and moved into
place with ``os.replace`` (so concurrent processes never load a half-written
file), and loaded with ``ctypes`` through a plain C interface:

- the CUDA kernels: every ``csrc/*.cu`` file compiled by ``nvcc`` for
  Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
  the objects linked into one shared library (:func:`library`);
- the host reference matcher ``native/refbaseline.cpp``, compiled by the
  host C++ compiler (``$CXX``, else ``c++``) with ``CXX_FLAGS``
  (:func:`native_library`); its hash also covers the compiler and the
  host, since ``-march=native`` ties the binary to the machine;
- the host ops ``native/hostops.cpp`` (beam compaction, validation-run
  segmentation, CARMEN parsing: the per-scan host path) and the host SPA
  solve ``native/spa_lm.cpp`` (LM over a block sparse Cholesky), compiled
  into one library by the same compiler with ``HOSTOPS_FLAGS``
  (:func:`hostops_library`); its hash covers both sources; no
  ``-march=native``, and ``-ffp-contract=off`` so that no product and sum
  is fused into an FMA, whatever the compiler's defaults: the ops then
  round as their numpy twins do.

Any failure to find a compiler, compile or load raises: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
NATIVE_SOURCE = _PKG_DIR / "native" / "refbaseline.cpp"
HOSTOPS_SOURCE = _PKG_DIR / "native" / "hostops.cpp"
SPA_LM_SOURCE = _PKG_DIR / "native" / "spa_lm.cpp"
BUILD_DIR = _PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# the host build: -march=native on purpose (the baseline is measured on the
# host that builds it), plus what a shared library needs
CXX_FLAGS = ("-O3", "-std=c++17", "-march=native", "-fPIC", "-shared", "-pthread")
# the host ops: setup.py's flags for the JAX package's hostops.cpp, no
# contraction, plus what a shared library needs
HOSTOPS_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
_F = ctypes.c_float
# C entry point -> argtypes; every entry point returns a cudaError_t as int
_SIGNATURES = {
    "yag_scatter_cells": (_P, _P, _P, _I, _I, _I, _P),
    "yag_world_scatter": (*(_P,) * 12, *(_I,) * 8, _P, _I, _P),
    "yag_smear_quantize": (_P, _P, _P, _P, _I, _I, _I, _P),
    "yag_smear_grid": (_P, _P, _P, _I, _I, _I, _P),
    "yag_smear_smem_bytes": (_I,),
    "yag_window_sum": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "yag_lattice_window_sum": (*(_P,) * 5, _L, _P, _P, _P, *(_I,) * 7, _P, _I, _P),
    "yag_render_endpoints": (_P, _P, _I, _L, _D, _P, _P, _P, _I, _P, _P),
    "yag_render_trace": (_P, _P, _L, _F, _F, _F, _I, _I, _I, _P, _P, _I, _P, _P),
    "yag_sweep": (_P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P),
    "yag_score_reduce": (_P, _P, _P, _L, *(_P,) * 4, *(_I,) * 10, _P, _I, _P),
    "yag_program_trig": (_P, _P, _P, _L, _I, _P),
}

# C entry point of the host library -> argtypes; it returns an error code
_NATIVE_SIGNATURES = {
    "yag_refbaseline_match_scan": (_P, _P, _P, _L, _P, _P, _L, *(_D,) * 9, _I, _I, _I, _P),
}

# C entry point of the host-ops library -> argtypes; each returns an error
# code (an errno for yag_parse_carmen)
_HOSTOPS_SIGNATURES = {
    "yag_compact_beams": (_P, _L, _D, _D, _D, _L, _P, _P, _P),
    "yag_segment_runs": (_P, _P, _L, _P, _P, _P),
    "yag_scan_views": (_P, _P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P),
    "yag_parse_carmen": (ctypes.c_char_p, _L, _P, _P, _P),
    "yag_carmen_copy": (_P, _P, _P, _P),
    "yag_carmen_free": (_P,),
    "yag_spa_lm": (_P, _L, _P, _L, _P, _P, _L, _D, _D, _P, _P, _P, _P, _P),
}

CUDA_ROOTS = ("/usr/local/cuda",)

_lock = threading.Lock()
_lib = None
_native = None
_hostops = None
build_seconds = None  # wall time of the nvcc build this process ran, if any
native_build_seconds = None  # the same for the host library
hostops_build_seconds = None  # the same for the host-ops library


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


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else c++ on $PATH."""
    found = os.environ.get("CXX") or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler ($CXX or c++): the native "
                           "library cannot be built")
    return found


def _hashed_path(prefix, files, flags) -> Path:
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"


def _library_path(srcs, headers) -> Path:
    return _hashed_path("libyag_kernels", srcs + headers, NVCC_FLAGS)


def _native_path(cxx) -> Path:
    # -march=native ties the binary to the host that built it: a checkout
    # copied to another machine, or built by another compiler, rebuilds
    host = (cxx, platform.node(), platform.machine())
    return _hashed_path("libyag_native", [NATIVE_SOURCE], (*CXX_FLAGS, *host))


def _hostops_sources():
    return [HOSTOPS_SOURCE, SPA_LM_SOURCE]


def _hostops_path(cxx) -> Path:
    return _hashed_path("libyag_hostops", _hostops_sources(), (*HOSTOPS_FLAGS, cxx))


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )


def _build_into(target: Path, build) -> float:
    """build(tmp dir, file name) compiles the library there; it is then
    moved to `target` in one step.  Returns the build's wall seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / target.name
        build(Path(tmp), so)
        os.replace(so, target)
    return time.perf_counter() - t0


def _nvcc_build(srcs):
    nvcc = find_nvcc()

    def build(tmp, so):
        objs = [str(tmp / f"{src.stem}.o") for src in srcs]
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                                 for src, obj in zip(srcs, objs)]))
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), *objs])

    return build


def _load(path, signatures):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, compiled first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            srcs, headers = _sources()
            path = _library_path(srcs, headers)
            if not path.exists():
                build_seconds = _build_into(path, _nvcc_build(srcs))
            _lib = _load(path, _SIGNATURES)
        return _lib


def native_library():
    """The loaded host reference-matcher library, compiled first if
    needed."""
    global _native, native_build_seconds
    with _lock:
        if _native is None:
            cxx = find_cxx()
            path = _native_path(cxx)
            if not path.exists():
                native_build_seconds = _build_into(path, lambda tmp, so: _run(
                    [cxx, *CXX_FLAGS, "-o", str(so), str(NATIVE_SOURCE)]))
            _native = _load(path, _NATIVE_SIGNATURES)
        return _native


def hostops_library():
    """The loaded host-ops library, compiled first if needed."""
    global _hostops, hostops_build_seconds
    with _lock:
        if _hostops is None:
            cxx = find_cxx()
            path = _hostops_path(cxx)
            if not path.exists():
                hostops_build_seconds = _build_into(path, lambda tmp, so: _run(
                    [cxx, *HOSTOPS_FLAGS, "-o", str(so), *map(str, _hostops_sources())]))
            _hostops = _load(path, _HOSTOPS_SIGNATURES)
        return _hostops
