"""The matcher's three device kernels, each beside its plain PyTorch twin.

Dispatch goes by the device of the tensors: CPU tensors run the plain
version (``*_ref``); CUDA tensors launch the hand-written kernel from
``csrc/`` or raise.  Nothing falls back from CUDA to the plain version.

``LAUNCHES`` counts kernel launches per wrapper (plain ints; callers may
reset them), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch

from yag_slam_tpu_torch import _build

LAUNCHES = {"scatter_cells": 0, "smear_quantize": 0, "window_sum": 0}

# Per wrapper: its CUDA source, and the Pallas kernels it replaces as
# "file:line" of each kernel's def (the first is the one it stands in for
# on the matcher's large-grid path).
_TPU = "yag_slam_tpu/matching/pallas_kernels.py"
KERNELS = {
    "scatter_cells": dict(
        source="yag_slam_tpu_torch/csrc/grid_build.cu",
        replaces=[f"{_TPU}:931", f"{_TPU}:1058"]),
    "smear_quantize": dict(
        source="yag_slam_tpu_torch/csrc/grid_build.cu",
        replaces=[f"{_TPU}:333", f"{_TPU}:1058"]),
    "window_sum": dict(
        source="yag_slam_tpu_torch/csrc/window_sum.cu",
        replaces=[f"{_TPU}:578", f"{_TPU}:823"]),
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """Store 1 into a zeroed (N, rows, rows) uint8 grid at (sy, sx).

    sy, sx: (N, M) int32 cells; lanes with sy < 0, and cells outside the
    grid, store nothing.

    Replaces pallas_kernels.py:scatter_occupancy_pallas and the scatter
    half of build_grid_fused (their serialized per-point read-modify-write
    loop over deduplicated cells).  On the H100 it is one thread per lane;
    equal-value races are benign, so no dedup sort.  Bound by the zero
    fill of the grid (N * rows^2 bytes), not the N * M scattered bytes.
    """
    if not _on_cuda(sy, sx):
        return scatter_cells_ref(sy, sx, rows)
    N, M = sy.shape
    _require(sy, torch.int32, (N, M), "sy")
    _require(sx, torch.int32, (N, M), "sx")
    occ = torch.zeros((N, rows, rows), dtype=torch.uint8, device=sy.device)
    if N * M == 0:
        return occ
    lib = _build.library()
    err = lib.yag_scatter_cells(sy.data_ptr(), sx.data_ptr(), occ.data_ptr(),
                                N, M, rows, _stream(sy))
    LAUNCHES["scatter_cells"] += 1
    _check(err, "scatter_cells")
    return occ


# ---------------------------------------------------------------------------
# Separable max-smear + quantize + full-grid mask
# ---------------------------------------------------------------------------

def smear_quantize_ref(occ, lim, taps, S: int, h: int):
    """Plain version of :func:`smear_quantize` (same f32 product order)."""
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
    q = torch.floor(a2 * 100.0)
    ar = torch.arange(S, device=occ.device, dtype=torch.int32)
    row_ok = ar[None, :] < lim[:, 0:1]
    col_ok = ar[None, :] < lim[:, 1:2]
    q = torch.where(row_ok[:, :, None] & col_ok[:, None, :], q, 0.0)
    return q.to(torch.uint8)


def smear_quantize(occ, lim, taps, S: int, h: int):
    """(N, S+2h, S+2h) uint8 occupancy -> (N, S, S) uint8 quantized grid.

    Weighted max over the 2h+1 float32 taps along columns, then along rows,
    then floor(100 x) in float32, then zero every cell at or past
    lim = (G - soy, G - sox).

    Replaces pallas_kernels.py:smear_quantize_pallas and the smear half of
    build_grid_fused.  On the H100 each block stages a 32 x 64 output tile
    plus its h-cell halo in shared memory and runs both passes there, so
    the float32 partials never reach device memory; at S = 3072, h = 10 it
    is bound by the 2 x (h + 1) max/multiply chain per cell, not bytes.
    """
    if not _on_cuda(occ, lim, taps):
        return smear_quantize_ref(occ, lim, taps, S, h)
    N = occ.shape[0]
    R = S + 2 * h
    if h < 1:
        raise ValueError(f"smear half-width must be >= 1, got {h}")
    _require(occ, torch.uint8, (N, R, R), "occ")
    _require(lim, torch.int32, (N, 2), "lim")
    _require(taps, torch.float32, (2 * h + 1,), "taps")
    lib = _build.library()
    smem = lib.yag_smear_smem_bytes(h)
    if smem > 227 * 1024:
        raise ValueError(f"smear half-width {h} needs {smem} B of shared memory")
    out = torch.empty((N, S, S), dtype=torch.uint8, device=occ.device)
    if N == 0:
        return out
    err = lib.yag_smear_quantize(occ.data_ptr(), lim.data_ptr(),
                                 taps.data_ptr(), out.data_ptr(), N, S, h,
                                 _stream(occ))
    LAUNCHES["smear_quantize"] += 1
    _check(err, "smear_quantize")
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
        vals = torch.gather(qf, 1, lin.reshape(N, -1)).reshape(lin.shape)
        out[:, k] = torch.where(ok, vals, 0).sum(dim=1, dtype=torch.int32)
    return out


def window_sum(q, gy0, gx0, n_pts, ny: int, nx: int, stride: int):
    """raw[n,k,j,i] = sum over p < n_pts[n] of
    q[n, gy0[n,k,p] + stride*j, gx0[n,k,p] + stride*i], reads outside
    [0, S) giving 0.  q (N, S, S) uint8; gy0, gx0 (N, K, P) int32;
    n_pts (N,) int32.  Returns (N, K, ny, nx) int32 (exact).

    Replaces pallas_kernels.py:score_windows_pallas (strides 1 and 2 on a
    phase-split layout) and score_windows_mxu_pallas (one-hot selection
    matmuls).  On the H100 one block per (angle, job, 256 outputs) stages
    the points' origin cells in shared memory and reads the uint8 grid
    through L2; the stride is an argument, so no phase split is built.
    Bound by L2 load latency of N*K*NY*NX*P byte reads.
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
    LAUNCHES["window_sum"] += 1
    _check(err, "window_sum")
    return out
