"""Correlation-grid scan matching: the numeric core, in PyTorch.

Counterpart of ``yag_slam_tpu/matching/correlation.py``, with the same
semantics (banker's rounding into grid cells, int-truncated 100x scoring,
tie-averaged argmax within 1e-8, windowed covariance with the reference's
half-open windows).  The device work goes through the four kernels of
:mod:`yag_slam_tpu_torch.matching.kernels`; everything here is plain
tensor code around them, and the pieces the matcher's program kernels
(:mod:`yag_slam_tpu_torch.matching.program_kernels`) run on the card
compose their plain twins.  The element-path scorer
(:func:`score_lattice_element`, rounding per candidate) is plain tensor
code, as its JAX counterpart is plain XLA.

Float-to-int casts: padded point lanes sit at 1e9 m, i.e. ~1e11 cells.  A
float->int32 cast out of range is undefined in PyTorch (and differs between
CPU and CUDA), so every cell index is clamped in floating point first.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yag_slam_tpu_torch import native
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


def gaussian_kernel_2d(res: float, smear_deviation: float) -> np.ndarray:
    """The 2-D smear kernel, the outer product of the 1-D factor."""
    k1 = gaussian_kernel_1d(res, smear_deviation)
    return np.outer(k1, k1)


def check_smear_taps(taps: np.ndarray) -> np.ndarray:
    """`taps` (2h+1,) host array, returned as it is once checked to be
    symmetric, positive and non-increasing away from the centre: the shape
    under which :func:`kernels.smear_quantize`'s lookup table equals the
    tap chain.  Checked where the taps are made, never per launch."""
    t = np.asarray(taps)
    h = (len(t) - 1) // 2
    if len(t) != 2 * h + 1 or not (t > 0).all() or not np.array_equal(t, t[::-1]) \
            or not (np.diff(t[:h + 1]) >= 0).all():
        raise ValueError(f"smear taps must be symmetric, positive and "
                         f"non-increasing away from the centre: {t}")
    return taps


def segment_validation_runs(px, py, n):
    """Host-side, pose-independent half of the back-facing-surface filter:
    group the first `n` beam points into runs that end when a point moves
    more than 0.2 m from the run's anchor.

    Returns (anchor_idx int32, term_idx int32, has_run bool), each (n,).
    Point 0 and a trailing unflushed run have has_run=False.  Runs the
    native host op, which raises if its library cannot be built.
    """
    return native.segment_runs(px, py, n)


def segment_validation_runs_ref(px, py, n):
    """The Python twin of :func:`segment_validation_runs` (the JAX
    package's path without its extension), for the tests."""
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

# (value, dtype, device) -> 0-dim divisor tensor
_DIVISORS = {}


def divisor(v: float, dtype, device):
    """`v` as a 0-dim tensor of `dtype` on `device`, made once by a fill
    (no copy from the host, so no wait) and cached: the CUDA graphs of the
    matcher read it by address."""
    key = (v, dtype, torch.device(device))
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS.setdefault(key, torch.full((), v, dtype=dtype, device=device))
    return d


def _true_div(x, v: float):
    # divide by a device scalar: CUDA turns division by a Python scalar into
    # a multiply by its reciprocal, which rounds differently
    return x / divisor(v, x.dtype, x.device)


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
    R = S + 2 * h
    gx = world_to_grid_idx(wx, ox[:, None, None], res)
    gy = world_to_grid_idx(wy, oy[:, None, None], res)
    inb = (gx >= 0) & (gx < G) & (gy >= 0) & (gy < G) & keep
    sx = gx - sox.to(torch.int32)[:, None, None] + h
    sy = gy - soy.to(torch.int32)[:, None, None] + h
    ok = (inb & (sx >= 0) & (sx < R) & (sy >= 0) & (sy < R)).flatten(1)
    sy = torch.where(ok, sy.flatten(1), -1).to(torch.int32).contiguous()
    sx = torch.where(ok, sx.flatten(1), 0).to(torch.int32).contiguous()
    return sy, sx


def _full_grid_limits(G: int, sox, soy):
    """(N, 2) int32 (G - soy, G - sox): subgrid rows/cols at or past these
    lie outside the full G x G grid."""
    return torch.stack([G - soy.to(torch.int32), G - sox.to(torch.int32)],
                       dim=1).contiguous()


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
    return grid_from_cells(sy, sx, _full_grid_limits(G, sox, soy), S=S, h=h,
                           taps=taps)[0]


def build_grid_staged(wx, wy, keep, ox, oy, sox, soy, *, G: int, S: int,
                      h: int, res: float, taps):
    """The staged build: the smeared float32 subgrids first, then quantize
    and the full-grid mask as separate steps, as the JAX matcher's staged
    path does when it hands the grid out.

    Arguments as :func:`build_quantized_grid`.  Returns (q (N, S, S) uint8,
    equal to build_quantized_grid's, and grid (N, S, S) float32, the
    smeared grid before quantize and mask).
    """
    sy, sx = occupancy_cells(wx, wy, keep, ox, oy, sox, soy,
                             G=G, S=S, h=h, res=res)
    return grid_from_cells(sy, sx, _full_grid_limits(G, sox, soy), S=S, h=h,
                           taps=taps, staged=True)


def grid_from_cells(sy, sx, lim, *, S: int, h: int, taps, staged: bool = False):
    """The grid build from the scatter cells on: :func:`kernels.scatter_cells`
    of (sy, sx) (as :func:`occupancy_cells` gives them), then
    :func:`grid_from_occupancy`."""
    return grid_from_occupancy(K.scatter_cells(sy, sx, S + 2 * h), lim, S=S, h=h, taps=taps,
                               staged=staged)


def grid_from_occupancy(occ, lim, *, S: int, h: int, taps, staged: bool = False):
    """The grid build from the (N, S + 2h, S + 2h) uint8 occupancy on (as
    :func:`kernels.scatter_cells` or ``program_kernels.world_scatter`` give
    it): :func:`kernels.smear_quantize` with the full-grid limits `lim` (N,
    2) int32.  Returns (q (N, S, S) uint8, None); with `staged`, the staged
    route (:func:`kernels.smear_grid`, then :func:`kernels.quantize_mask`)
    and its float32 grid before quantize and mask: (q, grid), q the same
    bits."""
    if staged:
        grid = K.smear_grid(occ, taps, S, h)
        return K.quantize_mask(grid, lim), grid
    return K.smear_quantize(occ, lim, taps, S, h), None


def build_correlation_grid(wx, wy, keep, ox, oy, *, grid_size: int,
                           res: float, taps):
    """The full G x G smeared correlation grid of kept world points
    (any shape), float32: points whose cell lies outside the grid are
    dropped, the others composite the kernel by max, clipped at the
    borders.  The JAX package's build_correlation_grid, through the
    scatter_cells and smear_grid kernels."""
    G = grid_size
    h = (taps.shape[0] - 1) // 2
    dev = wx.device
    zero = torch.zeros(1, dtype=torch.int32, device=dev)

    def origin(v):
        return torch.as_tensor(v, dtype=wx.dtype, device=dev).reshape(1)

    sy, sx = occupancy_cells(
        wx.reshape(1, 1, -1), wy.reshape(1, 1, -1), keep.reshape(1, 1, -1),
        origin(ox), origin(oy), zero, zero, G=G, S=G, h=h, res=res)
    occ = K.scatter_cells(sy, sx, G + 2 * h)
    return K.smear_grid(occ, taps, G, h)[0]


def quantize_grid(cgrid):
    """floor(100 * value) in the grid's dtype: the reference scores with
    int-truncated 100x grid lookups, and values are non-negative."""
    return torch.floor(cgrid * 100.0)


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
                     cx=None, cy=None, symmetric=True):
    """Batched distance/angle penalty factor (N, NX, NY, NT).

    Default: the reference's unclamped penalty centered half a cell past
    the true grid center; symmetric=False centers it on the search center
    (cx, cy) instead, as the reference's non-symmetric search does.
    karto=(dist_var, ang_var, min_dist, min_ang):
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
    if symmetric:
        sx = ox + G * grid_res / 2.0
        sy = oy + G * grid_res / 2.0
    else:
        sx, sy = cx, cy
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
    stride = lattice_stride(xy_res, grid_res)
    xvals, yvals, tvals = lattice_values(
        cx, cy, ct, spec=spec, xy_size=xy_size, xy_res=xy_res, ang_size=ang_size,
        ang_res=ang_res, dtype=pts_x.dtype)
    sgy0, sgx0, n_int = lattice_origin_cells(pts_x, pts_y, n_pts, xvals, yvals, tvals,
                                             ox, oy, sox, soy, grid_res)
    raw = K.window_sum(qgrid, sgy0, sgx0, n_int, spec.ny, spec.nx, stride)
    out = lattice_scores(
        raw, n_pts, xvals, yvals, tvals, cx, cy, ct, ox, oy, grid_size=grid_size,
        grid_res=grid_res, penalize=penalize, dist_var_penalty=dist_var_penalty,
        ang_var_penalty=ang_var_penalty, karto_penalties=karto_penalties)
    return out, xvals, yvals, tvals


def lattice_stride(xy_res, grid_res) -> int:
    """The lattice step in grid cells; raises unless it is an integer."""
    stride = int(round(xy_res / grid_res))
    if abs(stride * grid_res - xy_res) >= 1e-12 * max(1.0, abs(xy_res)):
        raise ValueError(f"lattice step {xy_res} is not a multiple of {grid_res}")
    return stride


def lattice_values(cx, cy, ct, *, spec: LatticeSpec, xy_size, xy_res, ang_size,
                   ang_res, dtype):
    """A pass's candidate coordinates around its centers cx, cy, ct (N,):
    (xvals (N, NX), yvals (N, NY), tvals (N, NT)) in `dtype`."""
    NX, NY, NT = spec
    dev = cx.device
    xvals = (cx - xy_size)[:, None] + torch.arange(NX, dtype=dtype, device=dev)[None, :] * xy_res
    yvals = (cy - xy_size)[:, None] + torch.arange(NY, dtype=dtype, device=dev)[None, :] * xy_res
    tvals = (ct - ang_size)[:, None] + torch.arange(NT, dtype=dtype, device=dev)[None, :] * ang_res
    return xvals, yvals, tvals


def lattice_origin_cells(pts_x, pts_y, n_pts, xvals, yvals, tvals, ox, oy, sox, soy,
                         grid_res):
    """Each query point's subgrid cell at the lattice origin (xvals[:, 0],
    yvals[:, 0]) for each angle, rounded once: (sgy0, sgx0) (N, NT, P)
    int32, and the point counts n_pts (N,) rounded to int32, as
    :func:`kernels.window_sum` takes them."""
    c, s = torch.cos(tvals), torch.sin(tvals)                    # (N, NT)
    rx = c[:, :, None] * pts_x[:, None, :] - s[:, :, None] * pts_y[:, None, :]
    ry = s[:, :, None] * pts_x[:, None, :] + c[:, :, None] * pts_y[:, None, :]

    gx0 = world_to_grid_idx(xvals[:, 0, None, None] + rx, ox[:, None, None], grid_res)
    gy0 = world_to_grid_idx(yvals[:, 0, None, None] + ry, oy[:, None, None], grid_res)
    sgx0 = (gx0 - sox.to(torch.int32)[:, None, None]).contiguous()
    sgy0 = (gy0 - soy.to(torch.int32)[:, None, None]).contiguous()
    n_int = torch.round(n_pts).to(torch.int32).contiguous()
    return sgy0, sgx0, n_int


def lattice_scores(raw, n_pts, xvals, yvals, tvals, cx, cy, ct, ox, oy, *,
                   grid_size: int, grid_res: float, penalize: bool,
                   dist_var_penalty: float = 0.5, ang_var_penalty: float = 1.0,
                   karto_penalties: tuple | None = None):
    """The window sums `raw` (N, NT, NY, NX) int32 as responses (N, NX, NY,
    NT) in the lattice values' dtype: divided by the point counts, times
    the penalty where `penalize`, over 100."""
    raw = raw.permute(0, 3, 2, 1)                                  # (N, NX, NY, NT)
    out = raw.to(xvals.dtype) / n_pts[:, None, None, None]
    if penalize:
        out = out * _lattice_penalty(
            xvals, yvals, tvals, ct, ox, oy, grid_size=grid_size,
            grid_res=grid_res, dist_var_penalty=dist_var_penalty,
            ang_var_penalty=ang_var_penalty, karto=karto_penalties,
            cx=cx, cy=cy,
        )
    return out / 100.0


def score_lattice_element(
    qgrid,       # (S, S) quantized grid, in the points' dtype
    pts_x,       # (P,) query points (padded lanes far away)
    pts_y,
    n_pts,       # 0-dim
    cx, cy, ct,  # 0-dim
    ox, oy,      # 0-dim
    *,
    spec: LatticeSpec,
    xy_size, xy_res, ang_size, ang_res,
    grid_size: int,
    grid_res: float,
    penalize: bool,
    dist_var_penalty: float = 0.5,
    ang_var_penalty: float = 1.0,
    karto_penalties: tuple | None = None,
    symmetric: bool = True,
    sub_size: int | None = None,
    sox: int = 0,
    soy: int = 0,
):
    """Score one search pass's lattice by element reads, rounding every
    candidate's world coordinate into its own cell: the JAX package's
    score_lattice.  Any lattice step works (no integer stride needed).

    Reads outside the full G x G grid or the (S, S) subgrid at (sox, soy)
    give 0.  Penalties as :func:`score_lattice`, plus symmetric=False (the
    distance penalty centered on the search center).  The (NX, NY, P)
    gather runs one angle at a time, so it stays bounded.

    Returns (out (NX, NY, NT), xvals (NX,), yvals (NY,), tvals (NT,)).
    """
    NX, NY, NT = spec
    G = grid_size
    S = G if sub_size is None else sub_size
    dtype = pts_x.dtype
    dev = pts_x.device
    xvals = (cx - xy_size) + torch.arange(NX, dtype=dtype, device=dev) * xy_res
    yvals = (cy - xy_size) + torch.arange(NY, dtype=dtype, device=dev) * xy_res
    tvals = (ct - ang_size) + torch.arange(NT, dtype=dtype, device=dev) * ang_res

    c, s = torch.cos(tvals), torch.sin(tvals)
    rx = c[:, None] * pts_x[None, :] - s[:, None] * pts_y[None, :]     # (NT, P)
    ry = s[:, None] * pts_x[None, :] + c[:, None] * pts_y[None, :]

    qflat = torch.cat([qgrid.reshape(-1).to(dtype),
                       torch.zeros(1, dtype=dtype, device=dev)])
    raw = torch.empty((NX, NY, NT), dtype=dtype, device=dev)
    for k in range(NT):
        gx = world_to_grid_idx(xvals[:, None] + rx[k][None, :], ox, grid_res)
        gy = world_to_grid_idx(yvals[:, None] + ry[k][None, :], oy, grid_res)
        sgx = gx.long() - sox
        sgy = gy.long() - soy
        ok_x = (gx >= 0) & (gx < G) & (sgx >= 0) & (sgx < S)        # (NX, P)
        ok_y = (gy >= 0) & (gy < G) & (sgy >= 0) & (sgy < S)        # (NY, P)
        lin = sgy[None, :, :] * S + sgx[:, None, :]                  # (NX, NY, P)
        lin = torch.where(ok_x[:, None, :] & ok_y[None, :, :], lin, S * S)
        raw[:, :, k] = qflat[lin].sum(dim=-1)

    out = raw / n_pts
    if penalize:
        cx, cy, ct, ox, oy = (v.reshape(1) for v in (cx, cy, ct, ox, oy))
        out = out * _lattice_penalty(
            xvals[None], yvals[None], tvals[None], ct, ox, oy,
            grid_size=G, grid_res=grid_res, dist_var_penalty=dist_var_penalty,
            ang_var_penalty=ang_var_penalty, karto=karto_penalties,
            cx=cx, cy=cy, symmetric=symmetric,
        )[0]
    out = out / 100.0
    return out, xvals, yvals, tvals


def reduce_best_pose(out, xvals, yvals, tvals):
    """Batched argmax + tie-averaging + windowed covariance.

    out (N, NX, NY, NT); xvals (N, NX), yvals (N, NY), tvals (N, NT).
    - first-maximum argmax in C order over (x, y, theta);
    - best pose = mean of all candidates within 1e-8 of the max response;
    - xy second moments over the half-open [i-5, min(n-1, i+6)) windows at
      the argmax theta slice, normalized by window mass and response;
    - theta second moment over the same style of window at the argmax (i, j);
    - sums accumulate in float64, results come back in out's dtype.

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
    dt = out.dtype

    def total(x, dims):
        # sums accumulate in float64: the device's reduction order follows
        # the batch's shape, and float64 partials keep a job's float32
        # result independent of the batch it rides in
        return x.sum(dim=dims, dtype=torch.float64)

    nties = ties.sum(dim=(1, 2, 3)).to(torch.float64)
    zero = torch.zeros((), dtype=dt, device=dev)
    bx = (total(torch.where(ties, xvals[:, :, None, None], zero), (1, 2, 3)) / nties).to(dt)
    by = (total(torch.where(ties, yvals[:, None, :, None], zero), (1, 2, 3)) / nties).to(dt)
    bt = (total(torch.where(ties, tvals[:, None, None, :], zero), (1, 2, 3)) / nties).to(dt)

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
    norm = total(torch.where(mask_ij, slice_k, zero), (1, 2))
    dx = xvals[:, :, None] - bx[:, None, None]
    dy = yvals[:, None, :] - by[:, None, None]
    XX = total(torch.where(mask_ij, slice_k * dx**2, zero), (1, 2))
    YY = total(torch.where(mask_ij, slice_k * dy**2, zero), (1, 2))
    XY = total(torch.where(mask_ij, slice_k * dx * dy, zero), (1, 2))

    slice_ij = out[n_idx, ii, jj, :]                           # (N, NT)
    th_norm = total(torch.where(mask_k, slice_ij, zero), 1)
    TH = total(torch.where(mask_k, slice_ij * (tvals - bt[:, None]) ** 2, zero), 1)

    r = response.to(torch.float64)
    moments = torch.stack([XX / norm / r, YY / norm / r, XY / norm / r,
                           TH / th_norm], dim=1).to(dt)
    return torch.cat([torch.stack([response, bx, by, bt], dim=1), moments], dim=1)


def find_best_pose(qgrid, pts_x, pts_y, n_pts, cx, cy, ct, ox, oy, **kw):
    """One search pass on the element path: :func:`score_lattice_element`
    (same keywords) then :func:`reduce_best_pose`.  Returns the (8,)
    (response, bx, by, bt, XX, YY, XY, TH)."""
    out, xv, yv, tv = score_lattice_element(
        qgrid, pts_x, pts_y, n_pts, cx, cy, ct, ox, oy, **kw)
    return reduce_best_pose(out[None], xv[None], yv[None], tv[None])[0]
