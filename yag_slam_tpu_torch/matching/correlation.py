"""Correlation-grid scan matching: the numeric core, in PyTorch.

Counterpart of ``yag_slam_tpu/matching/correlation.py``, with the same
semantics (banker's rounding into grid cells, int-truncated 100x scoring,
tie-averaged argmax within 1e-8, windowed covariance with the reference's
half-open windows).  The device work goes through the three kernels of
:mod:`yag_slam_tpu_torch.matching.kernels`; everything here is plain
tensor code around them.

Float-to-int casts: padded point lanes sit at 1e9 m, i.e. ~1e11 cells.  A
float->int32 cast out of range is undefined in PyTorch (and differs between
CPU and CUDA), so every cell index is clamped in floating point first.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yag_slam_tpu_torch.matching import kernels as K

# |cell index| bound applied before the int32 cast; far above any grid
# size and exactly representable in float32
_IDX_CLAMP = float(2**30)


# ---------------------------------------------------------------------------
# Smear kernel and point validation (host side)
# ---------------------------------------------------------------------------

def kernel_half_size(res: float, smear_deviation: float) -> int:
    """Half-width of the smear kernel; full size = 4*round(smear/res)+1."""
    size = int(4 * np.round(smear_deviation / res) + 1)
    return size // 2


def gaussian_kernel_1d(res: float, smear_deviation: float) -> np.ndarray:
    """1-D factor of the separable Gaussian smear kernel (float64)."""
    h = kernel_half_size(res, smear_deviation)
    offs = (np.arange(2 * h + 1) - h) * res
    return np.exp(-0.5 * offs**2 / smear_deviation**2)


def segment_validation_runs(px, py, n):
    """Host-side, pose-independent half of the back-facing-surface filter:
    group the first `n` beam points into runs that end when a point moves
    more than 0.2 m from the run's anchor.

    Returns (anchor_idx int32, term_idx int32, has_run bool), each (n,).
    Point 0 and a trailing unflushed run have has_run=False.
    """
    from yag_slam_tpu import native

    if native.available():
        return native.segment_runs(px, py, n)
    anchor = np.zeros(n, dtype=np.int32)
    term = np.zeros(n, dtype=np.int32)
    has = np.zeros(n, dtype=bool)
    if n < 2:
        return anchor, term, has
    msd = 0.2**2
    fp = 0
    run_start = 1
    for i in range(1, n):
        if (px[fp] - px[i]) ** 2 + (py[fp] - py[i]) ** 2 > msd:
            anchor[run_start : i + 1] = fp
            term[run_start : i + 1] = i
            has[run_start : i + 1] = True
            fp = i
            run_start = i + 1
    return anchor, term, has


def keep_mask_for_viewpoint(wx, wy, anchor_idx, term_idx, has_run, valid, vx, vy):
    """Per-point keep decision of the back-facing-surface filter: a point is
    kept iff its run was flushed and cross(term - anchor, viewpoint -
    anchor) > 0.  wx, wy (..., P) world points; anchor/term index the same
    point axis."""
    a = anchor_idx.long()
    t = term_idx.long()
    ax = torch.gather(wx, -1, a)
    ay = torch.gather(wy, -1, a)
    tx = torch.gather(wx, -1, t)
    ty = torch.gather(wy, -1, t)
    ss = (tx - ax) * (vy - ay) - (ty - ay) * (vx - ax)
    return has_run & valid & (ss > 0.0)


# ---------------------------------------------------------------------------
# Grid build
# ---------------------------------------------------------------------------

def _true_div(x, v: float):
    # divide by a device scalar: CUDA turns division by a Python scalar into
    # a multiply by its reciprocal, which rounds differently
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def world_to_grid_idx(w, origin, res: float):
    """Banker's-rounded cell index, round((w - origin) / res), as int32."""
    g = torch.round(_true_div(w - origin, res))
    return g.clamp(-_IDX_CLAMP, _IDX_CLAMP).to(torch.int32)


def occupancy_cells(wx, wy, keep, ox, oy, sox, soy, *, G: int, S: int,
                    h: int, res: float):
    """Scatter cells of the kept world points in the (S+2h)^2 halo layout
    of :func:`kernels.scatter_cells`: (sy, sx), each (N, B*P) int32, with
    sy = -1 for points outside the full G x G grid or the padded subgrid.

    wx, wy, keep: (N, B, P); ox, oy: (N,) full-grid origins; sox, soy: (N,)
    subgrid origins in cells."""
    N = wx.shape[0]
    R = S + 2 * h
    gx = world_to_grid_idx(wx, ox[:, None, None], res)
    gy = world_to_grid_idx(wy, oy[:, None, None], res)
    inb = (gx >= 0) & (gx < G) & (gy >= 0) & (gy < G) & keep
    sx = gx - sox.to(torch.int32)[:, None, None] + h
    sy = gy - soy.to(torch.int32)[:, None, None] + h
    ok = (inb & (sx >= 0) & (sx < R) & (sy >= 0) & (sy < R)).reshape(N, -1)
    sy = torch.where(ok, sy.reshape(N, -1), -1).to(torch.int32).contiguous()
    sx = torch.where(ok, sx.reshape(N, -1), 0).to(torch.int32).contiguous()
    return sy, sx


def build_quantized_grid(wx, wy, keep, ox, oy, sox, soy, *, G: int, S: int,
                         h: int, res: float, taps):
    """Quantized smeared correlation subgrids, (N, S, S) uint8.

    Arguments as :func:`occupancy_cells`, plus taps: the (2h+1,) float32
    smear taps.  Points outside the full G x G grid are dropped; every cell
    whose full-grid index is >= G is zero.  Same contract as the JAX
    package's build_quantized_grid_fused and build_quantized_grid_strip,
    in uint8 instead of bfloat16.
    """
    sy, sx = occupancy_cells(wx, wy, keep, ox, oy, sox, soy,
                             G=G, S=S, h=h, res=res)
    occ = K.scatter_cells(sy, sx, S + 2 * h)
    lim = torch.stack([G - soy.to(torch.int32), G - sox.to(torch.int32)],
                      dim=1).contiguous()
    return K.smear_quantize(occ, lim, taps, S, h)


# ---------------------------------------------------------------------------
# Candidate-lattice scoring + best-pose reduction
# ---------------------------------------------------------------------------

class LatticeSpec(NamedTuple):
    """Static lattice dimensions (candidate counts) for one search pass."""

    nx: int
    ny: int
    nt: int

    @classmethod
    def from_search(cls, cx, cy, ct, xy_size, xy_res, ang_size, ang_res):
        # np.arange length semantics, as the reference builds its lattices
        nx = len(np.arange(-xy_size + cx, xy_size + cx, xy_res))
        ny = len(np.arange(-xy_size + cy, xy_size + cy, xy_res))
        nt = len(np.arange(-ang_size + ct, ang_size + ct, ang_res))
        return cls(nx, ny, nt)


def _lattice_penalty(xvals, yvals, tvals, ct, ox, oy, *, grid_size, grid_res,
                     dist_var_penalty, ang_var_penalty, karto=None,
                     cx=None, cy=None):
    """Batched distance/angle penalty factor (N, NX, NY, NT).

    Default: the reference's unclamped penalty centered half a cell past
    the true grid center.  karto=(dist_var, ang_var, min_dist, min_ang):
    OpenKarto's semantics instead, offsets from the pass's search center
    (cx, cy), variances used directly, clamped at the minimum penalties."""
    G = grid_size
    if karto is not None:
        if cx is None or cy is None:
            raise ValueError("karto penalties need the pass's search center")
        dv, av, md, ma = karto
        sqd = (xvals[:, :, None] - cx[:, None, None]) ** 2 + (
            yvals[:, None, :] - cy[:, None, None]
        ) ** 2
        dist_pen = torch.clamp(1.0 - 0.2 * sqd / dv, min=md)
        sqa = (tvals - ct[:, None]) ** 2
        ang_pen = torch.clamp(1.0 - 0.2 * sqa / av, min=ma)
        return dist_pen[:, :, :, None] * ang_pen[:, None, None, :]
    sx = ox + G * grid_res / 2.0
    sy = oy + G * grid_res / 2.0
    sqd = (xvals[:, :, None] - sx[:, None, None]) ** 2 + (
        yvals[:, None, :] - sy[:, None, None]
    ) ** 2
    dist_pen = 1.0 - 0.2 * sqd / (dist_var_penalty * grid_res)
    sqa = (tvals - ct[:, None]) ** 2
    ang_pen = 1.0 - 0.2 * sqa / (ang_var_penalty * grid_res)
    return dist_pen[:, :, :, None] * ang_pen[:, None, None, :]


def score_lattice(
    qgrid,       # (N, S, S) uint8 quantized subgrids, full-grid masked
    pts_x,       # (N, P) query points (padded lanes far away)
    pts_y,
    n_pts,       # (N,) float
    cx, cy, ct,  # (N,)
    ox, oy,      # (N,)
    sox, soy,    # (N,) int
    *,
    spec: LatticeSpec,
    xy_size, xy_res, ang_size, ang_res,
    grid_size: int,
    grid_res: float,
    penalize: bool,
    dist_var_penalty: float = 0.5,
    ang_var_penalty: float = 1.0,
    karto_penalties: tuple | None = None,
):
    """Score the whole (x, y, theta) candidate lattice of one search pass.

    Index math of the JAX package's score_lattice_patch_batched (and of its
    Pallas scorers): each point's cell is rounded once at the lattice
    origin, then walked by the integer stride xy_res / grid_res.  The
    window sum runs in :func:`kernels.window_sum`.

    Returns (out (N, NX, NY, NT), xvals (N, NX), yvals (N, NY),
    tvals (N, NT)) in the points' dtype.
    """
    NX, NY, NT = spec
    dtype = pts_x.dtype
    dev = pts_x.device
    stride = int(round(xy_res / grid_res))
    if abs(stride * grid_res - xy_res) >= 1e-12 * max(1.0, abs(xy_res)):
        raise ValueError(f"lattice step {xy_res} is not a multiple of {grid_res}")

    xvals = (cx - xy_size)[:, None] + torch.arange(NX, dtype=dtype, device=dev)[None, :] * xy_res
    yvals = (cy - xy_size)[:, None] + torch.arange(NY, dtype=dtype, device=dev)[None, :] * xy_res
    tvals = (ct - ang_size)[:, None] + torch.arange(NT, dtype=dtype, device=dev)[None, :] * ang_res

    c, s = torch.cos(tvals), torch.sin(tvals)                    # (N, NT)
    rx = c[:, :, None] * pts_x[:, None, :] - s[:, :, None] * pts_y[:, None, :]
    ry = s[:, :, None] * pts_x[:, None, :] + c[:, :, None] * pts_y[:, None, :]

    gx0 = world_to_grid_idx(xvals[:, 0, None, None] + rx, ox[:, None, None], grid_res)
    gy0 = world_to_grid_idx(yvals[:, 0, None, None] + ry, oy[:, None, None], grid_res)
    sgx0 = (gx0 - sox.to(torch.int32)[:, None, None]).contiguous()
    sgy0 = (gy0 - soy.to(torch.int32)[:, None, None]).contiguous()

    n_int = torch.round(n_pts).to(torch.int32).contiguous()
    raw = K.window_sum(qgrid, sgy0, sgx0, n_int, NY, NX, stride)  # (N, NT, NY, NX)
    raw = raw.permute(0, 3, 2, 1)                                  # (N, NX, NY, NT)

    out = raw.to(dtype) / n_pts[:, None, None, None]
    if penalize:
        out = out * _lattice_penalty(
            xvals, yvals, tvals, ct, ox, oy, grid_size=grid_size,
            grid_res=grid_res, dist_var_penalty=dist_var_penalty,
            ang_var_penalty=ang_var_penalty, karto=karto_penalties,
            cx=cx, cy=cy,
        )
    out = out / 100.0
    return out, xvals, yvals, tvals


def reduce_best_pose(out, xvals, yvals, tvals):
    """Batched argmax + tie-averaging + windowed covariance.

    out (N, NX, NY, NT); xvals (N, NX), yvals (N, NY), tvals (N, NT).
    - first-maximum argmax in C order over (x, y, theta);
    - best pose = mean of all candidates within 1e-8 of the max response;
    - xy second moments over the half-open [i-5, min(n-1, i+6)) windows at
      the argmax theta slice, normalized by window mass and response;
    - theta second moment over the same style of window at the argmax (i, j).

    Returns (N, 8): (response, bx, by, bt, XX, YY, XY, TH).
    """
    N, NX, NY, NT = out.shape
    dev = out.device
    flat = out.reshape(N, -1)
    m = torch.argmax(flat, dim=1)
    ii = m // (NY * NT)
    jj = (m % (NY * NT)) // NT
    kk = m % NT
    response = flat.max(dim=1).values

    ties = out >= (response - 1e-8)[:, None, None, None]
    nties = ties.sum(dim=(1, 2, 3)).to(out.dtype)
    zero = torch.zeros((), dtype=out.dtype, device=dev)
    bx = torch.where(ties, xvals[:, :, None, None], zero).sum(dim=(1, 2, 3)) / nties
    by = torch.where(ties, yvals[:, None, :, None], zero).sum(dim=(1, 2, 3)) / nties
    bt = torch.where(ties, tvals[:, None, None, :], zero).sum(dim=(1, 2, 3)) / nties

    def window(ar, c, n):
        lo = torch.clamp(c - 5, min=0)
        hi = torch.clamp(c + 6, max=n - 1)
        return (ar[None, :] >= lo[:, None]) & (ar[None, :] < hi[:, None])

    mask_i = window(torch.arange(NX, device=dev), ii, NX)      # (N, NX)
    mask_j = window(torch.arange(NY, device=dev), jj, NY)
    mask_k = window(torch.arange(NT, device=dev), kk, NT)
    mask_ij = mask_i[:, :, None] & mask_j[:, None, :]

    n_idx = torch.arange(N, device=dev)
    slice_k = out[n_idx, :, :, kk]                             # (N, NX, NY)
    norm = torch.where(mask_ij, slice_k, zero).sum(dim=(1, 2))
    dx = xvals[:, :, None] - bx[:, None, None]
    dy = yvals[:, None, :] - by[:, None, None]
    XX = torch.where(mask_ij, slice_k * dx**2, zero).sum(dim=(1, 2))
    YY = torch.where(mask_ij, slice_k * dy**2, zero).sum(dim=(1, 2))
    XY = torch.where(mask_ij, slice_k * dx * dy, zero).sum(dim=(1, 2))

    slice_ij = out[n_idx, ii, jj, :]                           # (N, NT)
    th_norm = torch.where(mask_k, slice_ij, zero).sum(dim=1)
    TH = torch.where(mask_k, slice_ij * (tvals - bt[:, None]) ** 2, zero).sum(dim=1)

    return torch.stack(
        [response, bx, by, bt,
         XX / norm / response, YY / norm / response, XY / norm / response,
         TH / th_norm],
        dim=1,
    )
