"""The port's native host code: the host ops and the reference matcher.

Counterpart of ``yag_slam_tpu/native/__init__.py``, with two libraries
built by the host C++ compiler at first use and loaded with ``ctypes``
(``yag_slam_tpu_torch/_build.py``), each behind plain ``extern "C"``
functions:

- ``hostops.cpp``: :func:`compact_beams`, :func:`segment_runs` and
  :func:`parse_carmen`, the per-scan host path (``core/scan.py``,
  ``matching/correlation.py``) and the log reader (``io/carmen.py``), and
  :func:`scan_views`, both per-scan ops over a stack of scans in one call
  (the matcher's views of a batch's new scans); and, from ``spa_lm.cpp``
  in the same library, :func:`spa_lm`, the host pose-graph solve of
  ``graphopt/spa.py`` (LM over a block sparse Cholesky).
  Their numpy and Python twins stay in those modules (``*_ref``, and
  ``graphopt.spa._host_lm``), for the tests and the harnesses.  ``CALLS``
  counts the calls of each op (plain ints; callers may reset them), so a
  run can show that it went through them.
- ``refbaseline.cpp``: the reference algorithm in multithreaded C++,
  held to the float64 oracle at 1e-12, the baseline the card is measured
  against.

Both run on the host CPU whatever device the rest of the port uses.  A
missing compiler or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from yag_slam_tpu_torch import _build

# yag_refbaseline_match_scan's error codes (refbaseline.cpp)
_ERRORS = {1: "bad argument (no query point, or base offsets not rising)",
           2: "out of memory"}
# the host ops' error codes (hostops.cpp, spa_lm.cpp); yag_parse_carmen
# returns errno
_CAPACITY, _BAD_ARGUMENT, _NO_MEMORY = 1, 2, 3
_CARMEN_META = 8   # min_angle max_angle inc max_range x y theta timestamp

CALLS = {"compact_beams": 0, "segment_runs": 0, "scan_views": 0, "parse_carmen": 0,
         "spa_lm": 0}
# yag_spa_lm's stop reasons, by code (spa_lm.cpp)
SPA_REASONS = ("converged", "max_iters", "lambda_blowup", "empty")
# what the last spa_lm call factored: blocks of L below its diagonal
SPA_FILL = {"blocks": 0}


def reset_calls():
    for k in CALLS:
        CALLS[k] = 0


def available() -> bool:
    """Whether the host-ops library could be built and loaded."""
    try:
        _build.hostops_library()
    except (RuntimeError, OSError):
        return False
    return True


def refbaseline_available() -> bool:
    """Whether the host library could be built and loaded."""
    try:
        _build.native_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a):
    return a.ctypes.data


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _hostops_failed(name, err):
    raise RuntimeError(f"{name} failed: " + ("bad argument" if err == _BAD_ARGUMENT
                                             else f"error {err}"))


def compact_beams(ranges, min_angle, angle_increment, range_threshold, cap):
    """Native twin of core.scan.beam_points_padded_ref: the beams kept by
    the reference's rule, projected to the local frame and packed at the
    front of zeroed (cap,) float64 arrays.  Returns (xs, ys, n); raises
    ValueError when more than `cap` beams are kept."""
    lib = _build.hostops_library()
    r = _f64(ranges).ravel()
    cap = int(cap)
    xys = np.empty((2, cap))   # xs, ys: one buffer, one address to take
    xs = _ptr(xys)
    n = ctypes.c_int64()
    err = lib.yag_compact_beams(_ptr(r), r.size, float(min_angle), float(angle_increment),
                                float(range_threshold), cap, xs, xs + 8 * cap,
                                ctypes.byref(n))
    CALLS["compact_beams"] += 1
    if err == _CAPACITY:
        raise ValueError(f"scan has {n.value} valid beams > point capacity {cap}")
    if err:
        _hostops_failed("compact_beams", err)
    return xys[0], xys[1], n.value


def segment_runs(px, py, n):
    """Native twin of matching.correlation.segment_validation_runs_ref over
    the first `n` points: (anchor int32, term int32, has_run bool), each
    (n,)."""
    lib = _build.hostops_library()
    n = int(n)
    pxc, pyc = _f64(px[:n]), _f64(py[:n])
    if pxc.shape != (n,) or pyc.shape != (n,):
        raise ValueError(f"segment_runs needs {n} points, got {pxc.shape} and {pyc.shape}")
    anchor = np.empty(n, dtype=np.int32)
    term = np.empty(n, dtype=np.int32)
    has = np.empty(n, dtype=np.uint8)
    err = lib.yag_segment_runs(_ptr(pxc), _ptr(pyc), n, _ptr(anchor), _ptr(term), _ptr(has))
    CALLS["segment_runs"] += 1
    if err:
        _hostops_failed("segment_runs", err)
    return anchor, term, has.view(bool)


def scan_views(scans, cap):
    """:func:`compact_beams` then :func:`segment_runs` of each of `scans`
    (objects with ``ranges``, ``min_angle``, ``angle_increment`` and
    ``range_threshold``) in one call, as (k, cap) rows: xs, ys (float64),
    anchor, term (int32), has_run (bool), zero past each scan's count,
    and the counts n (k,) int64.  Raises ValueError when a scan keeps more
    than `cap` beams."""
    lib = _build.hostops_library()
    k, cap = len(scans), int(cap)
    ranges = [s.ranges for s in scans]
    flat = np.concatenate(ranges, axis=None, dtype=np.float64) if k else np.zeros(0)
    offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum([np.size(r) for r in ranges], out=offsets[1:])
    geom = np.array([(s.min_angle, s.angle_increment, s.range_threshold) for s in scans],
                    dtype=np.float64).reshape(k, 3).T.copy()
    # one buffer a pair of outputs: fewer addresses to take
    xys = np.empty((2, k, cap))
    runs = np.empty((2, k, cap), dtype=np.int32)
    has = np.empty((k, cap), dtype=np.uint8)
    n = np.zeros(k, dtype=np.int64)
    g, xy, ru = _ptr(geom), _ptr(xys), _ptr(runs)
    err = lib.yag_scan_views(_ptr(flat), _ptr(offsets), g, g + 8 * k, g + 16 * k, k, cap,
                             xy, xy + 8 * k * cap, _ptr(n), ru, ru + 4 * k * cap, _ptr(has))
    CALLS["scan_views"] += 1
    if err == _CAPACITY:
        raise ValueError(f"scan has {n.max()} valid beams > point capacity {cap}")
    if err:
        _hostops_failed("scan_views", err)
    return dict(lx=xys[0], ly=xys[1], anchor=runs[0], term=runs[1], has_run=has.view(bool),
                n=n)


def parse_carmen(path, max_scans=None):
    """Native twin of io.carmen.load_carmen_log_ref: the laser scans of a
    CARMEN log as CarmenScan records with float64 ranges.  Lines that do
    not parse are skipped.  Raises OSError (FileNotFoundError for a
    missing file) when the log cannot be opened."""
    from yag_slam_tpu_torch.io.carmen import CarmenScan

    lib = _build.hostops_library()
    handle = ctypes.c_void_p()
    n_scans, n_values = ctypes.c_int64(), ctypes.c_int64()
    err = lib.yag_parse_carmen(os.fsencode(path), int(max_scans or -1), ctypes.byref(handle),
                               ctypes.byref(n_scans), ctypes.byref(n_values))
    CALLS["parse_carmen"] += 1
    if err:
        raise OSError(err, os.strerror(err), str(path))
    try:
        ranges = np.empty(n_values.value)
        counts = np.empty(n_scans.value, dtype=np.int64)
        meta = np.empty((n_scans.value, _CARMEN_META))
        err = lib.yag_carmen_copy(handle, _ptr(ranges), _ptr(counts), _ptr(meta))
        if err:
            _hostops_failed("parse_carmen", err)
    finally:
        lib.yag_carmen_free(handle)
    per_scan = np.split(ranges, np.cumsum(counts)[:-1]) if len(counts) else []
    return [CarmenScan(r, *m) for r, m in zip(per_scan, meta.tolist())]


def spa_lm(poses, eidx, means, infos, max_iters, lam0, conv_tol):
    """Native twin of graphopt.spa._host_lm, with its arguments and
    results: LM on poses (N, 3) float64 (node 0 the gauge) over edges
    eidx (E, 2), means (E, 3) and infos (E, 3, 3), each step solved by a
    block sparse Cholesky in a minimum-degree order.  Returns (poses,
    cost, iters, reason), reason in SPA_REASONS."""
    lib = _build.hostops_library()
    p = _f64(poses).reshape(-1, 3)
    n = p.shape[0]
    ei = np.ascontiguousarray(eidx, dtype=np.int64).reshape(-1, 2)
    e = ei.shape[0]
    m = _f64(means).reshape(e, 3)
    w = _f64(infos).reshape(e, 3, 3)
    out = np.empty((n, 3))
    cost = ctypes.c_double()
    iters, reason, fill = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    err = lib.yag_spa_lm(_ptr(p), n, _ptr(ei), e, _ptr(m), _ptr(w), int(max_iters),
                         float(lam0), float(conv_tol), _ptr(out), ctypes.byref(cost),
                         ctypes.byref(iters), ctypes.byref(reason), ctypes.byref(fill))
    CALLS["spa_lm"] += 1
    if err:
        raise RuntimeError("spa_lm failed: " + {_BAD_ARGUMENT: "node index out of range",
                                                 _NO_MEMORY: "out of memory"}.get(err,
                                                                                  f"error {err}"))
    SPA_FILL["blocks"] = fill.value
    return out, cost.value, iters.value, SPA_REASONS[reason.value]


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
