"""The matcher's four device kernels, each beside its plain PyTorch twin.

Dispatch goes by the device of the tensors: CPU tensors run the plain
version (``*_ref``); CUDA tensors launch the hand-written kernel from
``csrc/`` or raise.  Nothing falls back from CUDA to the plain version.

``LAUNCHES`` counts kernel launches (plain ints; callers may reset them),
so a run can show that its main path went through the kernels: the
wrappers here, and ``program_kernels``' fused wrappers, whose launches
build the occupancy grid or sum the lattice's windows from the points in
place of cell tables, count into it as scatter_cells and window_sum
launches.  A wrapper called while its thread captures a CUDA graph
(:func:`captured_launches`) counts into the capture instead: those
launches run at each replay, which adds them (:func:`add_launches`).
Another module's wrappers that run inside the matcher's graphs keep their
own table and count through :func:`_count` too, once the table is
registered (:func:`register_launches`).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from yag_slam_tpu_torch import _build

LAUNCHES = {"scatter_cells": 0, "smear_quantize": 0, "smear_grid": 0,
            "window_sum": 0}

# Per wrapper: its CUDA source, the Pallas kernels it replaces as
# "file:line" of each kernel's def (the first is the one it stands in for
# on the matcher's large-grid path), and pieces of the CUDA kernels' names
# that pick its launches out of a profiler trace (a trace reader matches
# program_kernels.KERNELS' first: the fused window sum's kernels are
# window_sum's, fed by the query points).
_TPU = "yag_slam_tpu/matching/pallas_kernels.py"
KERNELS = {
    "scatter_cells": dict(
        source="yag_slam_tpu_torch/csrc/grid_build.cu",
        replaces=[f"{_TPU}:931", f"{_TPU}:1058"],
        symbols=("scatter_cells_kernel",)),
    "smear_quantize": dict(
        source="yag_slam_tpu_torch/csrc/grid_build.cu",
        replaces=[f"{_TPU}:333", f"{_TPU}:1058"],
        symbols=("QuantizeTable", "QuantizeMaskStore")),
    "smear_grid": dict(
        source="yag_slam_tpu_torch/csrc/grid_build.cu",
        replaces=[f"{_TPU}:203"],
        symbols=("RankTable", "FloatStore")),
    "window_sum": dict(
        source="yag_slam_tpu_torch/csrc/window_sum.cu",
        replaces=[f"{_TPU}:578", f"{_TPU}:823", f"{_TPU}:687"],
        symbols=("window_sum_kernel", "window_sum_split_kernel")),
}


_capture = threading.local()

# every table that _count counts into, LAUNCHES first
_TABLES = [LAUNCHES]


def register_launches(table):
    """Let :func:`_count` count the names of `table` (another module's
    launch counts) into it, and into a capture like LAUNCHES' names."""
    if any(set(t) & set(table) for t in _TABLES if t is not table):
        raise ValueError(f"launch names already counted: {sorted(table)}")
    if not any(t is table for t in _TABLES):
        _TABLES.append(table)


def _table(name):
    for t in _TABLES:
        if name in t:
            return t
    raise KeyError(f"no launch table counts {name!r}")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count(name):
    counts = getattr(_capture, "counts", None)
    if counts is None:
        _table(name)[name] += 1
    else:
        counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """Within, this thread's launches count into the yielded dict and not
    into their tables: a CUDA graph capture records launches that run only
    when the graph replays.  The dict holds LAUNCHES' names, and those of
    registered tables that the capture launched."""
    counts = dict.fromkeys(LAUNCHES, 0)
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = None


def add_launches(counts):
    """Count the launches of one replay of a graph whose capture recorded
    `counts`."""
    for k, v in counts.items():
        _table(k)[k] += v


def _on_cuda(*tensors) -> bool:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _require(t, dtype, shape, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Occupancy scatter
# ---------------------------------------------------------------------------

def scatter_cells_ref(sy, sx, rows: int):
    """Plain version of :func:`scatter_cells`."""
    N, M = sy.shape
    occ = torch.zeros((N, rows * rows), dtype=torch.uint8, device=sy.device)
    ok = (sy >= 0) & (sy < rows) & (sx >= 0) & (sx < rows)
    n_idx = torch.arange(N, device=sy.device)[:, None].expand(N, M)
    lin = sy.long() * rows + sx.long()
    occ[n_idx[ok], lin[ok]] = 1
    return occ.view(N, rows, rows)


def scatter_cells(sy, sx, rows: int):
    """The (N, rows, rows) uint8 grid that is 1 at (sy, sx) and 0 elsewhere.

    sy, sx: (N, M) int32 cells; lanes with sy < 0, and cells outside the
    grid, store nothing.

    Replaces pallas_kernels.py:scatter_occupancy_pallas and the scatter
    half of build_grid_fused (their serialized per-point read-modify-write
    loop over deduplicated cells).  On the H100 one launch writes the whole
    grid into an uninitialised allocation: each block zeroes a band of one
    job's rows with 16-byte stores, then stores the ones of the lanes whose
    row is in its band (csrc/grid_build.cu).  Equal-value stores need no
    dedup sort and no atomics.  Bound by the grid's N * rows^2 bytes, not
    the N * M scattered bytes.
    """
    if not _on_cuda(sy, sx):
        return scatter_cells_ref(sy, sx, rows)
    N, M = sy.shape
    _require(sy, torch.int32, (N, M), "sy")
    _require(sx, torch.int32, (N, M), "sx")
    occ = torch.empty((N, rows, rows), dtype=torch.uint8, device=sy.device)
    if occ.numel() == 0:
        return occ
    lib = _build.library()
    err = lib.yag_scatter_cells(sy.data_ptr(), sx.data_ptr(), occ.data_ptr(),
                                N, M, rows, _stream(sy))
    _count("scatter_cells")
    _check(err, "scatter_cells")
    return occ


# ---------------------------------------------------------------------------
# Separable max-smear: float32 grid, or quantized with the full-grid mask
# ---------------------------------------------------------------------------

def smear_grid_ref(occ, taps, S: int, h: int):
    """Plain version of :func:`smear_grid` (same f32 product order)."""
    x = occ.to(torch.float32)
    t = [taps[d] for d in range(2 * h + 1)]     # 0-dim float32 tensors
    a1 = t[h] * x[:, :, h:h + S]
    for d in range(h):
        m = torch.maximum(x[:, :, d:d + S], x[:, :, 2 * h - d:2 * h - d + S])
        a1 = torch.maximum(a1, t[d] * m)
    a2 = t[h] * a1[:, h:h + S, :]
    for d in range(h):
        m = torch.maximum(a1[:, d:d + S, :], a1[:, 2 * h - d:2 * h - d + S, :])
        a2 = torch.maximum(a2, t[d] * m)
    return a2


def quantize_mask(grid, lim):
    """floor(100 x) in float32, cells at or past lim = (row_hi, col_hi)
    zeroed, as uint8: the store stage of :func:`smear_quantize` as plain
    tensor ops (the staged build runs it after :func:`smear_grid`)."""
    S = grid.shape[-1]
    q = torch.floor(grid * 100.0)
    ar = torch.arange(S, device=grid.device, dtype=torch.int32)
    row_ok = ar[None, :] < lim[:, 0:1]
    col_ok = ar[None, :] < lim[:, 1:2]
    q = torch.where(row_ok[:, :, None] & col_ok[:, None, :], q, 0.0)
    return q.to(torch.uint8)


def smear_quantize_ref(occ, lim, taps, S: int, h: int):
    """Plain version of :func:`smear_quantize`."""
    return quantize_mask(smear_grid_ref(occ, taps, S, h), lim)


def _smear_checks(occ, taps, S, h):
    N = occ.shape[0]
    R = S + 2 * h
    if h < 0:
        raise ValueError(f"smear half-width must be >= 0, got {h}")
    _require(occ, torch.uint8, (N, R, R), "occ")
    _require(taps, torch.float32, (2 * h + 1,), "taps")
    lib = _build.library()
    smem = lib.yag_smear_smem_bytes(h)
    if smem > 227 * 1024:
        raise ValueError(f"smear half-width {h} needs {smem} B of shared memory")
    return lib


def smear_quantize(occ, lim, taps, S: int, h: int):
    """(N, S+2h, S+2h) uint8 occupancy -> (N, S, S) uint8 quantized grid.

    Weighted max over the 2h+1 float32 taps along columns, then along rows,
    then floor(100 x) in float32, then zero every cell at or past
    lim = (G - soy, G - sox).  h = 0 (one tap) is a plain copy scaled by it.

    Contract on the card: every occ value is 0 or 1 (scatter_cells writes
    only zeros and ones), and the taps are symmetric, positive and
    non-increasing away from the centre (correlation.check_smear_taps,
    where the taps are made; not checked here, which would sync).  The
    plain version takes any input.

    Replaces pallas_kernels.py:smear_quantize_pallas and the smear half of
    build_grid_fused.  On the H100 it uses the {0,1} identity: pass 1's
    value is the tap at the distance d to the nearest occupied cell of the
    row, so the output is an integer max of lookups Q[|dy|][d] in a table
    of floor(100 * tap * tap); each staged row that holds an occupied cell
    max-updates the 2h + 1 outputs it reaches in a shared-memory tile
    (csrc/grid_build.cu).  No float arithmetic runs per cell; on the main
    path's sparse grids it is bound by the grid's bytes.  Its 128 x 256
    tiles pay off once they give every SM a block (the sequential
    matcher's 3072^2 grid); smaller grids (the loop matcher's 4 x 768^2),
    and h > 31, run the float32 tap chain with a quantizing store.
    """
    if not _on_cuda(occ, lim, taps):
        return smear_quantize_ref(occ, lim, taps, S, h)
    N = occ.shape[0]
    lib = _smear_checks(occ, taps, S, h)
    _require(lim, torch.int32, (N, 2), "lim")
    out = torch.empty((N, S, S), dtype=torch.uint8, device=occ.device)
    if N == 0:
        return out
    err = lib.yag_smear_quantize(occ.data_ptr(), lim.data_ptr(),
                                 taps.data_ptr(), out.data_ptr(), N, S, h,
                                 _stream(occ))
    _count("smear_quantize")
    _check(err, "smear_quantize")
    return out


def smear_grid(occ, taps, S: int, h: int):
    """(N, S+2h, S+2h) uint8 occupancy -> (N, S, S) float32 smeared grid:
    :func:`smear_quantize` without the quantize and the mask.

    Contract on the card, as for :func:`smear_quantize`: every occ value is
    0 or 1 (every caller's grid comes from scatter_cells), and the taps are
    symmetric, positive and non-increasing away from the centre
    (correlation.check_smear_taps, where the taps are made).  The plain
    version takes any input.

    Replaces pallas_kernels.py:smear_grid_pallas (the staged build's
    smear, whose output the matcher hands out as its meta grid, and the
    conversion of a saved map).  On the H100 it uses smear_quantize's {0,1}
    identity kernel with another table and store: the output is max over
    dy of F[|dy|][d], F = tap * tap in float32, so the shared tile holds
    each output's rank among the (h+1)^2 values of F and the write-out
    maps ranks back to floats, 16 bytes per store (csrc/grid_build.cu).
    Bound by the 4 * S^2 bytes of the float32 output.  Grids whose tiles
    do not give half the SMs a block (a saved map's), and h > 14, run the
    float32 tap chain of the plain version in 32 x 64 output tiles.
    Either way floor(100 x) of its output masked at lim is smear_quantize's
    output bit for bit.
    """
    if not _on_cuda(occ, taps):
        return smear_grid_ref(occ, taps, S, h)
    N = occ.shape[0]
    lib = _smear_checks(occ, taps, S, h)
    out = torch.empty((N, S, S), dtype=torch.float32, device=occ.device)
    if N == 0:
        return out
    err = lib.yag_smear_grid(occ.data_ptr(), taps.data_ptr(), out.data_ptr(),
                             N, S, h, _stream(occ))
    _count("smear_grid")
    _check(err, "smear_grid")
    return out


# ---------------------------------------------------------------------------
# Lattice window sum
# ---------------------------------------------------------------------------

def window_sum_ref(q, gy0, gx0, n_pts, ny: int, nx: int, stride: int):
    """Plain version of :func:`window_sum` (one angle at a time, so the
    (N, P, NY, NX) gather stays bounded)."""
    N, S, _ = q.shape
    _, K, P = gy0.shape
    dev = q.device
    qf = q.reshape(N, S * S).to(torch.int32)
    jy = torch.arange(ny, device=dev, dtype=torch.int64) * stride
    ix = torch.arange(nx, device=dev, dtype=torch.int64) * stride
    lane_ok = torch.arange(P, device=dev)[None, :] < n_pts[:, None]   # (N, P)
    out = torch.empty((N, K, ny, nx), dtype=torch.int32, device=dev)
    for k in range(K):
        y = gy0[:, k, :, None].long() + jy          # (N, P, NY)
        x = gx0[:, k, :, None].long() + ix          # (N, P, NX)
        ok = ((y >= 0) & (y < S))[:, :, :, None] & ((x >= 0) & (x < S))[:, :, None, :]
        ok = ok & lane_ok[:, :, None, None]
        lin = y.clamp(0, S - 1)[:, :, :, None] * S + x.clamp(0, S - 1)[:, :, None, :]
        vals = torch.gather(qf, 1, lin.flatten(1)).reshape(lin.shape)
        out[:, k] = torch.where(ok, vals, 0).sum(dim=1, dtype=torch.int32)
    return out


def window_sum(q, gy0, gx0, n_pts, ny: int, nx: int, stride: int):
    """raw[n,k,j,i] = sum over p < n_pts[n] of
    q[n, gy0[n,k,p] + stride*j, gx0[n,k,p] + stride*i], reads outside
    [0, S) giving 0.  q (N, S, S) uint8; gy0, gx0 (N, K, P) int32;
    n_pts (N,) int32.  Returns (N, K, ny, nx) int32 (exact).

    Replaces pallas_kernels.py:score_windows_pallas (strides 1 and 2 on a
    phase-split layout), score_windows_mxu_pallas (one-hot selection
    matmuls) and score_windows_hybrid_pallas (a one-hot row-select matmul
    plus a lane roll, at unit stride on the phase-split layout that folds
    the lattice stride): all three compute this window sum, and their
    layouts exist for the TPU's lane alignment.  On the H100, with few
    outputs (the sequential passes) a warp's 32 lanes split each output's
    points and shuffles add them; with many (the loop matcher's batches)
    each lane sums one output, neighbouring lanes reading neighbouring
    bytes.  A block of 1-8 warps per (output tile, angle, job) stages the
    points' origin cells in shared memory and reads the uint8 grid through
    L2; the stride is an argument, so no phase split is built.  Bound by
    launch latency: the lattice touches few distinct grid bytes.
    """
    if not _on_cuda(q, gy0, gx0, n_pts):
        return window_sum_ref(q, gy0, gx0, n_pts, ny, nx, stride)
    N, S, _ = q.shape
    _, K, P = gy0.shape
    _require(q, torch.uint8, (N, S, S), "q")
    _require(gy0, torch.int32, (N, K, P), "gy0")
    _require(gx0, torch.int32, (N, K, P), "gx0")
    _require(n_pts, torch.int32, (N,), "n_pts")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    out = torch.empty((N, K, ny, nx), dtype=torch.int32, device=q.device)
    if N * K * ny * nx == 0:
        return out
    lib = _build.library()
    err = lib.yag_window_sum(q.data_ptr(), gy0.data_ptr(), gx0.data_ptr(),
                             n_pts.data_ptr(), out.data_ptr(), N, S, K, P,
                             ny, nx, stride, _stream(q))
    _count("window_sum")
    _check(err, "window_sum")
    return out
