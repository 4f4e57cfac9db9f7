"""The reference matcher as native host code.

Counterpart of the refbaseline half of ``yag_slam_tpu/native/__init__.py``:
``refbaseline.cpp`` (the reference algorithm in multithreaded C++, held to
the float64 oracle at 1e-12) behind one ``extern "C"`` function, built by
the host C++ compiler at first use and loaded with ``ctypes``
(``yag_slam_tpu_torch/_build.py``).  It runs on the host CPU whatever
device the rest of the port uses: it is the baseline the card is measured
against.  The JAX package's hostops half (``compact_beams``,
``segment_runs``, ``parse_carmen``) has no counterpart here: the port runs
numpy versions of those functions.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from yag_slam_tpu_torch import _build

# yag_refbaseline_match_scan's error codes (refbaseline.cpp)
_ERRORS = {1: "bad argument (no query point, or base offsets not rising)",
           2: "out of memory"}


def refbaseline_available() -> bool:
    """Whether the host library could be built and loaded."""
    try:
        _build.native_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def refbaseline_match_scan(query, base_scans, config, penalty=True,
                           do_fine=True, n_threads=None):
    """Reference-equivalent CPU scan match (the benchmark baseline, see
    native/refbaseline.cpp).  Same contract as the reference's
    Scan2DMatcherPy.match_scan (yag_slam/scan_matching.py:175-222):
    returns (response, covariance (3,3), (x, y, theta)).

    `config` needs keys: search_size, resolution, smear_deviation,
    range_threshold, coarse_search_angle_offset, coarse_angle_resolution.
    Raises if the library cannot be built or the native call fails.
    """
    lib = _build.native_library()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    search = float(config["search_size"])
    res = float(config["resolution"])
    smear = float(config["smear_deviation"])
    rng_t = float(config["range_threshold"])
    ang_size = float(config.get("coarse_search_angle_offset", 0.349))
    ang_res = float(config.get("coarse_angle_resolution", 0.0349))

    p = query.corrected_pose
    cx, cy, ct = float(p.x), float(p.y), float(p.euler[-1])

    pts = [s.points() for s in base_scans]
    offsets = np.zeros(len(pts) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(wx) for wx, _ in pts])
    xs = _f64(np.concatenate([wx for wx, _ in pts]) if pts else np.zeros(0))
    ys = _f64(np.concatenate([wy for _, wy in pts]) if pts else np.zeros(0))
    qx, qy = (_f64(a) for a in query.points_local())
    out = np.zeros(8, dtype=np.float64)

    # lattice counts are derived inside the library from the actual
    # shifted endpoints per pass (np.arange length semantics: the float
    # shift by the search center can change the count by one at exact
    # multiples, and the fine pass centers on the coarse best pose)
    err = lib.yag_refbaseline_match_scan(
        _ptr(xs), _ptr(ys), _ptr(offsets), len(pts), _ptr(qx), _ptr(qy), len(qx),
        cx, cy, ct, search, res, smear, rng_t, ang_size, ang_res,
        int(bool(penalty)), int(bool(do_fine)), int(n_threads), _ptr(out),
    )
    if err:
        raise RuntimeError(f"refbaseline match failed: {_ERRORS.get(err, err)}")
    r, x, y, t, XX, YY, XY, TH = (float(v) for v in out)
    covar = np.array([[XX, XY, 0.0], [XY, YY, 0.0], [0.0, 0.0, TH]])
    return r, covar, (x, y, t)
