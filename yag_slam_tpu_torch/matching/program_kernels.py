"""The matcher's device program around its smear: three kernels, each
beside its plain PyTorch twin.

``CorrelativeScanMatcher._compute`` runs, for a batch of jobs:

1. :func:`world_scatter`: the base scans' points to world, the back-face
   keep mask, their cells and the occupancy grid of those cells, in one
   launch (``kernels.scatter_cells``' bands, the cells computed in the
   kernel);
2. the smear (``kernels.smear_quantize``);
3. per search pass, :func:`lattice_window_sum` (the query points' cells at
   the lattice origin and the window sums over them, in one launch of
   ``kernels.window_sum``'s kernel fed by the points) and
   :func:`score_reduce` (responses, penalty, the tie-averaged best pose and
   its windowed moments, written into the packed (N, 2, 8) result).

The JAX package compiles all of this into one XLA program around its
Pallas kernels; the plain twins (``*_ref``) are the port's tensor ops for
the same arithmetic, the code the matcher ran before these kernels.

Dispatch goes by the device of the tensors, as in ``kernels.py``: CPU
tensors run the twin; CUDA tensors launch the hand-written kernel or
raise.  Nothing falls back from CUDA to the twin.  The kernels take the
twins' float32 or float64 and do their arithmetic step for step as PyTorch
does it on the card: each product, sum and quotient rounded on its own, a
division by a Python number as a product with its reciprocal, a division
by a tensor exact (csrc/program_math.cuh).

``LAUNCHES`` counts the kernels' launches, apart from ``kernels.LAUNCHES``
but through ``kernels._count``, so that launches captured in the matcher's
CUDA graphs count at each replay.  A launch of :func:`world_scatter` or
:func:`lattice_window_sum` does the work of ``kernels.scatter_cells`` or
``kernels.window_sum`` from the points in place of cell tables, and also
counts there: ``kernels.LAUNCHES`` counts every occupancy scatter and
window sum, this table the fused ones.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from yag_slam_tpu_torch import _build
from yag_slam_tpu_torch.matching import correlation as C
from yag_slam_tpu_torch.matching import kernels as K
from yag_slam_tpu_torch.matching.kernels import _check, _on_cuda, _require, _stream

LAUNCHES = {"world_scatter": 0, "lattice_window_sum": 0, "score_reduce": 0}
K.register_launches(LAUNCHES)

# Per wrapper: its CUDA source, what it replaces in the JAX package
# ("file:line"; the Pallas kernel it fuses first, where it fuses one, then
# the XLA lines around the Pallas kernels there), and pieces of its CUDA
# kernel's name in a profiler trace (the fused window sum's: its cell
# source, a template argument of window_sum's kernels).
_TPU = "yag_slam_tpu/matching/pallas_kernels.py"
_JM = "yag_slam_tpu/matching/matcher.py"
_JC = "yag_slam_tpu/matching/correlation.py"
KERNELS = {
    "world_scatter": dict(
        source="yag_slam_tpu_torch/csrc/grid_build.cu",
        replaces=[f"{_TPU}:931", f"{_JM}:661", f"{_JM}:666", f"{_JC}:109", f"{_JC}:132"],
        symbols=("world_scatter_kernel",)),
    "lattice_window_sum": dict(
        source="yag_slam_tpu_torch/csrc/window_sum.cu",
        replaces=[f"{_TPU}:578", f"{_JC}:697", f"{_JM}:722"],
        symbols=("LatticeCells",)),
    "score_reduce": dict(
        source="yag_slam_tpu_torch/csrc/match_program.cu",
        replaces=[f"{_JC}:1014", f"{_JC}:573", f"{_JC}:743", f"{_JM}:792",
                  f"{_JM}:803"],
        symbols=("score_reduce_kernel",)),
}

# padded query lanes sit this far away (metres), as in the matcher
FAR = 1.0e9

# score_reduce: threads a block at most, the shared memory of a block at
# most (an H100's 227 KB); a job takes a cluster of REDUCE_CLUSTER blocks
# (csrc/match_program.cu) where its lattice has REDUCE_CLUSTER_AT
# candidates or more and the batch's blocks come to at most
# REDUCE_BLOCKS_PER_SM a SM, or where one block's shared memory cannot
# hold its responses (measured on an H100 with
# tools/score_reduce_shapes.py: PERF.md)
REDUCE_MAX_THREADS = 1024
REDUCE_MAX_SMEM = 232448
REDUCE_CLUSTER = 8
REDUCE_CLUSTER_AT = 7000
REDUCE_BLOCKS_PER_SM = 3


# world_scatter: blocks a SM at most, the fewest rows a band has (fewer,
# larger bands on a small grid, so fewer blocks compute the cells; chosen
# on an H100 with tools/fused_pairs.py --band-rows: PERF.md), and the
# blocks of a cluster, which share the cells they compute
# (csrc/grid_build.cu's kScatterCluster)
SCATTER_BLOCKS_PER_SM = 2
SCATTER_MIN_BAND_ROWS = 30
SCATTER_CLUSTER = 8


class ScatterShape(NamedTuple):
    """How world_scatter lays N jobs' grids out: each job's rows in
    `bands` bands of `band_rows` rows (the last ones may be empty), a
    block a band, a job's bands in clusters of SCATTER_CLUSTER blocks."""

    band_rows: int
    bands: int


def scatter_shape(N: int, R: int, sms: int, min_rows: int = SCATTER_MIN_BAND_ROWS):
    """world_scatter's launch shape for N jobs' (R, R) grids on a card of
    `sms` SMs: bands of at least `min_rows` rows (at most the grid), more
    where the batch would take over SCATTER_BLOCKS_PER_SM blocks a SM;
    then rounded up to whole clusters of SCATTER_CLUSTER blocks, the rows
    spread over them (the last bands may be empty)."""
    rows = min(R, max(min_rows, _ceil(N * R, SCATTER_BLOCKS_PER_SM * sms)))
    bands = _ceil(_ceil(R, rows), SCATTER_CLUSTER) * SCATTER_CLUSTER
    return ScatterShape(_ceil(R, bands), bands)


class PassLattice(NamedTuple):
    """One search pass's candidate lattice: its counts, its half-extent
    and step in x and y (metres), in theta (radians), and its step in grid
    cells (xy_res / grid res, an integer)."""

    nx: int
    ny: int
    nt: int
    xy_size: float
    xy_res: float
    ang_size: float
    ang_res: float
    stride: int

    @property
    def spec(self):
        return C.LatticeSpec(self.nx, self.ny, self.nt)

    @classmethod
    def make(cls, spec, xy_size, xy_res, ang_size, ang_res, grid_res):
        return cls(*spec, xy_size, xy_res, ang_size, ang_res,
                   C.lattice_stride(xy_res, grid_res))


class ReduceShape(NamedTuple):
    """How score_reduce lays a job out on the card: a cluster of `cluster`
    blocks of `threads` threads; job thread g owns the lattice columns (i,
    j) at j * nx + i = g, g + job_threads, ... (`cols` at most) and all
    their angles; the responses stay in the blocks' shared memory where
    `in_shared`, else in scratch rows in device memory."""

    threads: int
    cluster: int
    cols: int
    in_shared: bool

    @property
    def job_threads(self):
        return self.threads * self.cluster


def _ceil(a, b):
    return -(-a // b)


def _reduce_header_bytes(warps, es):
    # ReduceShared<T>: per warp slot the float64 tie (4) and moment (6)
    # partials, the argmax's value and index; 8-byte aligned
    return (warps * (10 * 8 + es + 4) + 7) // 8 * 8


def _layout(lat: PassLattice, es: int, c: int) -> ReduceShape:
    # a cluster of c blocks: a thread a lattice column, at most 1024 a
    # block (then several columns a thread), in multiples of 32
    nxy = lat.nx * lat.ny
    cols = _ceil(nxy, REDUCE_MAX_THREADS * c)
    threads = 32 * _ceil(_ceil(nxy, cols), 32 * c)
    smem = _reduce_header_bytes(c * threads // 32, es) + cols * lat.nt * threads * es
    return ReduceShape(threads, c, cols, smem <= REDUCE_MAX_SMEM)


def reduce_shape(lat: PassLattice, dtype, n_jobs: int, sms: int) -> ReduceShape:
    """score_reduce's launch shape for a pass's lattice and float dtype, a
    batch of `n_jobs` jobs and a card of `sms` SMs: one block a job, or a
    cluster of REDUCE_CLUSTER blocks where the lattice has
    REDUCE_CLUSTER_AT candidates or more and the batch's clusters come to
    at most REDUCE_BLOCKS_PER_SM blocks a SM, or where one block cannot
    hold the responses; scratch rows in device memory where the cluster
    cannot hold them either."""
    es = torch.finfo(dtype).bits // 8
    one = _layout(lat, es, 1)
    wide = (lat.nx * lat.ny * lat.nt >= REDUCE_CLUSTER_AT
            and n_jobs * REDUCE_CLUSTER <= REDUCE_BLOCKS_PER_SM * sms)
    if one.in_shared and not wide:
        return one
    return _layout(lat, es, REDUCE_CLUSTER)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _origin_offset(G: int, res: float) -> float:
    # the full grid's origin sits this far below the job's center (a Python
    # float, subtracted in the tensors' dtype)
    return 0.5 * (G - 1) * res


def _doubles(*vals):
    return (ctypes.c_double * len(vals))(*map(float, vals))


def _float_kind(t):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {t.dtype}")
    return int(t.dtype == torch.float64)


def _require_center(center, dtype, N, name):
    # (N, 3) rows of unit stride; rows may sit apart (a pass's center is a
    # column block of the packed result)
    if center.dtype != dtype or tuple(center.shape) != (N, 3) or center.stride(1) != 1:
        raise ValueError(f"{name}: expected ({N}, 3) {dtype} rows of unit stride, got "
                         f"{tuple(center.shape)} {center.dtype} strides {center.stride()}")


# ---------------------------------------------------------------------------
# World points to the occupancy grid
# ---------------------------------------------------------------------------

def world_cells_ref(lx, ly, anchor, term, has_run, mask, pose, center, vp, sub, *,
                    G: int, S: int, h: int, res: float):
    """The scatter cells of a batch's base points, and its full-grid
    limits, as plain tensor ops: the first half of :func:`world_scatter_ref`.

    Arguments as :func:`world_scatter`'s.  A point goes to world at its
    scan's pose; it is kept when its run was flushed, its slot is in use
    and cross(term - anchor, viewpoint - anchor) > 0 (the run's anchor and
    terminal points taken to world the same way); its cell is round((w -
    origin) / res).  Returns (sy, sx) (N, B * P) int32 in the (S + 2h)^2
    halo layout of ``kernels.scatter_cells``, sy = -1 for points dropped,
    outside the full grid or the padded subgrid, and lim (N, 2) int32 =
    (G - soy, G - sox), the limits ``kernels.smear_quantize`` masks at."""
    pc = torch.cos(pose[..., 2:3])
    ps = torch.sin(pose[..., 2:3])
    wx = pose[..., 0:1] + pc * lx - ps * ly
    wy = pose[..., 1:2] + ps * lx + pc * ly
    keep = C.keep_mask_for_viewpoint(
        wx, wy, anchor, term, has_run, mask[..., None],
        vp[:, 0, None, None], vp[:, 1, None, None],
    )
    off = _origin_offset(G, res)
    ox, oy = center[:, 0] - off, center[:, 1] - off
    sox, soy = sub[:, 0], sub[:, 1]
    sy, sx = C.occupancy_cells(wx, wy, keep, ox, oy, sox, soy, G=G, S=S, h=h, res=res)
    return sy, sx, C._full_grid_limits(G, sox, soy)


def world_scatter_ref(lx, ly, anchor, term, has_run, mask, pose, center, vp, sub, *,
                      G: int, S: int, h: int, res: float):
    """Plain version of :func:`world_scatter`: :func:`world_cells_ref`,
    then ``kernels.scatter_cells_ref`` of its cells."""
    sy, sx, lim = world_cells_ref(lx, ly, anchor, term, has_run, mask, pose, center, vp,
                                  sub, G=G, S=S, h=h, res=res)
    return K.scatter_cells_ref(sy, sx, S + 2 * h), lim


def world_scatter(lx, ly, anchor, term, has_run, mask, pose, center, vp, sub, *,
                  G: int, S: int, h: int, res: float):
    """The occupancy grid of a batch's base points, and its full-grid
    limits.

    lx, ly (N, B, P) the base scans' points in their frames, anchor, term
    (N, B, P) int32 and has_run (N, B, P) bool their validation runs, mask
    (N, B) bool the jobs' base slots in use, pose (N, B, 3) the base
    scans' poses, center (N, 3) the jobs' search centers (the full G x G
    grid is centered on each), vp (N, 2) the viewpoints, sub (N, 2) int32
    the subgrids' origins (sox, soy) in cells.

    Returns occ (N, S + 2h, S + 2h) uint8, 1 at the cells of the kept
    points inside the full grid and the padded subgrid (the
    :func:`world_cells_ref` cells), 0 elsewhere, as
    ``kernels.smear_quantize`` and ``kernels.smear_grid`` take it; and lim
    (N, 2) int32 = (G - soy, G - sox).

    Replaces the world transform, the keep mask and the cells of the JAX
    matcher's _make_core (XLA, fused around the Pallas build kernels) and
    pallas_kernels.py:scatter_occupancy_pallas.  On the card one launch
    (csrc/grid_build.cu): scatter_cells' bands, a job's bands in clusters
    of blocks (:func:`scatter_shape`); each block computes the cells of
    its share of the job's points into shared memory while it zeroes its
    band, then reads every block's cells of its cluster through
    distributed shared memory and stores the ones in its band; so the
    cells never reach device memory.  Counts a launch of
    ``kernels.scatter_cells`` too.
    """
    if not _on_cuda(lx, ly, anchor, term, has_run, mask, pose, center, vp, sub):
        return world_scatter_ref(lx, ly, anchor, term, has_run, mask, pose, center, vp, sub,
                                 G=G, S=S, h=h, res=res)
    N, B, P = lx.shape
    dt = lx.dtype
    is_double = _float_kind(lx)
    _require(ly, dt, (N, B, P), "ly")
    _require(anchor, torch.int32, (N, B, P), "anchor")
    _require(term, torch.int32, (N, B, P), "term")
    _require(has_run, torch.bool, (N, B, P), "has_run")
    _require(mask, torch.bool, (N, B), "mask")
    _require(pose, dt, (N, B, 3), "pose")
    _require(center, dt, (N, 3), "center")
    _require(vp, dt, (N, 2), "vp")
    _require(sub, torch.int32, (N, 2), "sub")
    R = S + 2 * h
    dev = lx.device
    occ = torch.empty((N, R, R), dtype=torch.uint8, device=dev)
    lim = torch.empty((N, 2), dtype=torch.int32, device=dev)
    if N == 0:
        return occ, lim
    err = _build.library().yag_world_scatter(
        lx.data_ptr(), ly.data_ptr(), anchor.data_ptr(), term.data_ptr(),
        has_run.data_ptr(), mask.data_ptr(), pose.data_ptr(), center.data_ptr(),
        vp.data_ptr(), sub.data_ptr(), occ.data_ptr(), lim.data_ptr(), N, B, P, G, S, h,
        *scatter_shape(N, R, _sm_count(dev.index)), _doubles(res, _origin_offset(G, res)),
        is_double, _stream(lx))
    K._count("world_scatter")
    K._count("scatter_cells")
    _check(err, "world_scatter")
    return occ, lim


# ---------------------------------------------------------------------------
# Window sums at the lattice's cells of the query points
# ---------------------------------------------------------------------------

def lattice_cells_ref(qlx, qly, n_q, center, job_center, sub, lat: PassLattice, *,
                      G: int, res: float):
    """One search pass's query cells at the lattice origin, as plain
    tensor ops: the first half of :func:`lattice_window_sum_ref`.

    Arguments as :func:`lattice_window_sum`'s.  Returns (sgy0, sgx0) (N, NT,
    P) int32: each point's subgrid cell turned by each candidate angle and
    moved to the lattice's first candidate (padded lanes at FAR), rounded
    once; and n_int (N,) int32, the point counts; as ``kernels.window_sum``
    takes them."""
    dtype = qlx.dtype
    P = qlx.shape[-1]
    valid = torch.arange(P, device=qlx.device)[None, :] < n_q[:, None]
    qx = torch.where(valid, qlx, FAR)
    qy = torch.where(valid, qly, FAR)
    off = _origin_offset(G, res)
    ox, oy = job_center[:, 0] - off, job_center[:, 1] - off
    xvals, yvals, tvals = C.lattice_values(
        center[:, 0], center[:, 1], center[:, 2], spec=lat.spec, xy_size=lat.xy_size,
        xy_res=lat.xy_res, ang_size=lat.ang_size, ang_res=lat.ang_res, dtype=dtype)
    return C.lattice_origin_cells(qx, qy, n_q.to(dtype), xvals, yvals, tvals, ox, oy,
                                  sub[:, 0], sub[:, 1], res)


def lattice_window_sum_ref(q, qlx, qly, n_q, center, job_center, sub, lat: PassLattice, *,
                           G: int, res: float):
    """Plain version of :func:`lattice_window_sum`: :func:`lattice_cells_ref`,
    then ``kernels.window_sum_ref`` over its cells."""
    cells = lattice_cells_ref(qlx, qly, n_q, center, job_center, sub, lat, G=G, res=res)
    return K.window_sum_ref(q, *cells, lat.ny, lat.nx, lat.stride)


def lattice_window_sum(q, qlx, qly, n_q, center, job_center, sub, lat: PassLattice, *,
                       G: int, res: float):
    """One search pass's window sums (N, NT, NY, NX) int32.

    q (N, S, S) uint8 the quantized grids, qlx, qly (N, P) the query points
    in their frame (lanes at or past n_q (N,) int32 are padding), center
    (N, 3) the pass's search centers (a device tensor: the fine pass's are
    columns 1-3 of the coarse result, rows of unit stride that sit apart),
    job_center (N, 3) the jobs' centers (the full grid's), sub (N, 2)
    int32 the subgrids' origins, `lat` the pass's lattice.

    raw[n, k, j, i] is the sum over the job's first n_q points of q at the
    point's subgrid cell turned by candidate angle k, moved to the
    lattice's first candidate and rounded (:func:`lattice_cells_ref`),
    plus (stride j, stride i); reads outside the grid give 0.

    Replaces the query padding of the JAX matcher's _make_core, the
    lattice-origin cells of its score_lattice_patch_batched and the window
    sum of pallas_kernels.py:score_windows_pallas (and its mxu and hybrid
    forms).  On the card one launch of window_sum's kernel fed by the
    points (csrc/window_sum.cu): each block, which owns one (angle, job),
    turns and rounds the job's points as it stages them in shared memory,
    so the cells never reach device memory.  Counts a launch of
    ``kernels.window_sum`` too.
    """
    if not _on_cuda(q, qlx, qly, n_q, center, job_center, sub):
        return lattice_window_sum_ref(q, qlx, qly, n_q, center, job_center, sub, lat, G=G,
                                      res=res)
    N, S, _ = q.shape
    P = qlx.shape[-1]
    dt = qlx.dtype
    is_double = _float_kind(qlx)
    _require(q, torch.uint8, (N, S, S), "q")
    _require(qlx, dt, (N, P), "qlx")
    _require(qly, dt, (N, P), "qly")
    _require(n_q, torch.int32, (N,), "n_q")
    _require_center(center, dt, N, "center")
    _require(job_center, dt, (N, 3), "job_center")
    _require(sub, torch.int32, (N, 2), "sub")
    if lat.stride < 1:
        raise ValueError(f"stride must be >= 1, got {lat.stride}")
    out = torch.empty((N, lat.nt, lat.ny, lat.nx), dtype=torch.int32, device=q.device)
    if out.numel() == 0:
        return out
    params = _doubles(lat.xy_size, lat.xy_res, lat.ang_size, lat.ang_res, res,
                      _origin_offset(G, res))
    err = _build.library().yag_lattice_window_sum(
        q.data_ptr(), qlx.data_ptr(), qly.data_ptr(), n_q.data_ptr(), center.data_ptr(),
        center.stride(0), job_center.data_ptr(), sub.data_ptr(), out.data_ptr(), N, S,
        lat.nt, P, lat.ny, lat.nx, lat.stride, params, is_double, _stream(q))
    K._count("lattice_window_sum")
    K._count("window_sum")
    _check(err, "lattice_window_sum")
    return out


# ---------------------------------------------------------------------------
# Scores, the best pose and its moments
# ---------------------------------------------------------------------------

def reduce_params(lat: PassLattice, G: int, res: float, karto=None):
    """score_reduce's float64 parameters: the lattice, the full grid's
    origin offset and half extent, the reference penalty's variances times
    the grid's resolution (correlation.lattice_scores' defaults 0.5 and
    1.0, as the twin uses them) and OpenKarto's four where given."""
    return _doubles(lat.xy_size, lat.xy_res, lat.ang_size, lat.ang_res, _origin_offset(G, res),
                    G * res / 2.0, 0.5 * res, 1.0 * res, *(karto or (0.0,) * 4))


def score_reduce_ref(raw, n_q, center, job_center, packed, row: int, lat: PassLattice, *,
                     G: int, res: float, penalize: bool, karto=None,
                     copy_fine: bool = False, stats=None):
    """Plain version of :func:`score_reduce`."""
    dtype = packed.dtype
    cx, cy, ct = center[:, 0], center[:, 1], center[:, 2]
    off = _origin_offset(G, res)
    ox, oy = job_center[:, 0] - off, job_center[:, 1] - off
    xvals, yvals, tvals = C.lattice_values(
        cx, cy, ct, spec=lat.spec, xy_size=lat.xy_size, xy_res=lat.xy_res,
        ang_size=lat.ang_size, ang_res=lat.ang_res, dtype=dtype)
    out = C.lattice_scores(
        raw, n_q.to(dtype), xvals, yvals, tvals, cx, cy, ct, ox, oy, grid_size=G,
        grid_res=res, penalize=penalize, karto_penalties=karto)
    best = C.reduce_best_pose(out, xvals, yvals, tvals)
    if stats is not None:
        N, NX, NY, NT = out.shape
        m = torch.argmax(out.reshape(N, -1), dim=1)
        ties = out >= (best[:, 0] - 1e-8)[:, None, None, None]
        stats.copy_(torch.stack([m // (NY * NT), (m % (NY * NT)) // NT, m % NT,
                                 ties.sum(dim=(1, 2, 3))], dim=1))
    packed[:, row] = best
    if copy_fine:
        packed[:, 1] = best
    return packed


def score_reduce(raw, n_q, center, job_center, packed, row: int, lat: PassLattice, *,
                 G: int, res: float, penalize: bool, karto=None,
                 copy_fine: bool = False, stats=None):
    """One search pass's result, written into row `row` of `packed` (N, 2,
    8) in place: (response, x, y, theta, XX, YY, XY, TH) per job; with
    `copy_fine`, into row 1 as well (the coarse result stands for a fine
    pass not run).  Returns `packed`.

    raw (N, NT, NY, NX) int32 the pass's window sums (:func:`lattice_window_sum`),
    n_q (N,) int32 the query point counts, center (N, 3) the pass's search
    centers (rows of unit stride: the fine pass's are columns 1-3 of row 0
    of `packed`), job_center (N, 3) the jobs' centers.  A candidate's
    response is raw / n_q, times the penalty where `penalize` (the
    reference's, centered half a cell past the full grid's center, or with
    ``karto`` = (dist_var, ang_var, min_dist, min_ang) OpenKarto's, from the
    pass's center and clamped), over 100.  Then correlation.reduce_best_pose:
    the first maximum in C order over (x, y, theta), the mean pose of the
    candidates within 1e-8 of it, the windowed second moments; sums in
    float64.  `stats`, an (N, 4) int64 tensor where given, receives each
    job's argmax (i, j, theta) and tie count, for the checks.

    Replaces the tail of the JAX package's score_lattice_patch_batched, its
    _lattice_penalty, and the vmapped reduce_best_pose of _make_core.  On
    the card a job is a cluster of blocks shaped by :func:`reduce_shape`:
    each response is computed once into shared memory (the (N, NX, NY,
    NT) responses never reach device memory unless they do not fit there),
    then three warp-shuffle reductions, one barrier each
    (csrc/match_program.cu).  Its float64 sums run in the job's fixed
    order, not torch's: in float32 the pose and moments may come back an
    ulp apart from the twin's.
    """
    if not _on_cuda(raw, n_q, center, job_center, packed):
        return score_reduce_ref(raw, n_q, center, job_center, packed, row, lat, G=G,
                                res=res, penalize=penalize, karto=karto,
                                copy_fine=copy_fine, stats=stats)
    N = raw.shape[0]
    dt = packed.dtype
    is_double = _float_kind(packed)
    _require(raw, torch.int32, (N, lat.nt, lat.ny, lat.nx), "raw")
    _require(n_q, torch.int32, (N,), "n_q")
    _require_center(center, dt, N, "center")
    _require(job_center, dt, (N, 3), "job_center")
    _require(packed, dt, (N, 2, 8), "packed")
    if stats is not None:
        _require(stats, torch.int64, (N, 4), "stats")
    if row not in (0, 1):
        raise ValueError(f"row must be 0 or 1, got {row}")
    if N == 0:
        return packed
    mode = 0 if not penalize else (1 if karto is None else 2)
    shape = reduce_shape(lat, dt, N, _sm_count(raw.device.index))
    scratch = None if shape.in_shared else torch.empty(
        (N, shape.cluster, shape.cols * lat.nt * shape.threads), dtype=dt, device=raw.device)
    err = _build.library().yag_score_reduce(
        raw.data_ptr(), n_q.data_ptr(), center.data_ptr(), center.stride(0),
        job_center.data_ptr(), packed.data_ptr(), None if stats is None else stats.data_ptr(),
        None if scratch is None else scratch.data_ptr(), row, int(copy_fine), N, lat.nx,
        lat.ny, lat.nt, shape.threads, shape.cluster, shape.cols, mode,
        reduce_params(lat, G, res, karto), is_double, _stream(raw))
    K._count("score_reduce")
    _check(err, "score_reduce")
    return packed
