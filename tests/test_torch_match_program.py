"""The matcher's program kernels (matching/program_kernels.py) on the CPU.

There is no card here, so each wrapper runs its plain twin (``*_ref``):
- the twins against the JAX package's arithmetic, run in float64 as the
  conftest sets it: integer cells bit-equal, scores and poses within
  1e-12 relative;
- score_reduce's own steps (its rounding, its float64 sums in the order of
  its block's threads and tree) emulated in numpy against its twin:
  response, argmax and tie count bit-equal, pose and moments within an ulp
  in float32 and 1e-12 relative in float64;
- the fused wrappers (world_scatter, lattice_window_sum) on the CPU equal
  to their twins' composition and to the JAX package's cells, scattered or
  summed in numpy;
- ``_compute`` bit-equal to the composition it replaced (kept here, with
  its pass scorer ``_score_pass``);
- the CUDA dispatch with a fake library: the kernel launches, counts
  through ``kernels._count`` (captures included), raises on an error, and
  never runs the twin.
Inputs come from numpy seeds at the tour's and bench's shapes cut small.
"""
import ast
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yag_slam_tpu.matching import correlation as JC
from yag_slam_tpu_torch import _build
from yag_slam_tpu_torch.matching import correlation as TC
from yag_slam_tpu_torch.matching import kernels as K
from yag_slam_tpu_torch.matching import program_kernels as PK
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

from test_matching import TEST_CFG, make_room_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
G, S, H, RES = 101, 64, 2, 0.05
OFF = 0.5 * (G - 1) * RES
KARTO = (0.3, 0.2, 0.5, 0.9)      # dist_var, ang_var, min_dist, min_ang
# a coarse-like pass (stride 2) and a fine-like one (stride 1); "wide" has
# more candidates than 1024; then the main path's shapes: the tour's fine
# pass (one warp a job), its coarse pass (640 threads a job) and the loop
# matcher's coarse pass (1600 columns: two a thread)
LATTICES = {
    "coarse": PK.PassLattice(9, 9, 5, 0.2, 0.1, 0.08, 0.04, 2),
    "fine": PK.PassLattice(4, 4, 5, 0.1, 0.05, 0.05, 0.02, 1),
    "wide": PK.PassLattice(15, 15, 5, 0.35, 0.05, 0.05, 0.02, 1),
    "tour_fine": PK.PassLattice(4, 4, 10, 0.02, 0.01, 0.0175, 0.0035, 1),
    "tour_coarse": PK.PassLattice(25, 25, 10, 0.25, 0.02, 0.1745, 0.0349, 2),
    "loop_coarse": PK.PassLattice(40, 40, 10, 2.0, 0.1, 0.1745, 0.0349, 2),
}
# an H100's SMs: the card the launch shapes are chosen on
SMS = 132
WORLD_KEYS = ("lx", "ly", "anchor", "term", "has_run", "mask", "pose", "center", "vp", "sub")


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _bits(t):
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


def _close(got, want, rtol=RTOL):
    """Equal where both are NaN, else within rtol of each other (or equal:
    0 and -0 are)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=0)


# -- world_cells ---------------------------------------------------------------------

def _world_inputs(seed, N, B, P):
    """A batch's staged job arrays, float64: scans of P lanes (the last
    lanes past each scan's count far away, as the library pads them),
    their validation runs, base slots in use, poses, centers, viewpoints
    and subgrid origins (some past the full grid's high edge)."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(-np.pi, np.pi, (N, B, P)), axis=-1)
    r = rng.uniform(0.3, 2.4, (N, B, P))
    lx, ly = r * np.cos(ang), r * np.sin(ang)
    anchor = np.zeros((N, B, P), np.int32)
    term = np.zeros((N, B, P), np.int32)
    has_run = np.zeros((N, B, P), bool)
    for n in range(N):
        for b in range(B):
            k = int(rng.integers(P // 2, P + 1))
            lx[n, b, k:] = ly[n, b, k:] = 1.0e9
            anchor[n, b, :k], term[n, b, :k], has_run[n, b, :k] = \
                TC.segment_validation_runs_ref(lx[n, b], ly[n, b], k)
    mask = rng.uniform(size=(N, B)) > 0.25
    mask[:, 0] = True
    pose = np.concatenate([rng.uniform(-0.8, 0.8, (N, B, 2)),
                           rng.uniform(-np.pi, np.pi, (N, B, 1))], axis=-1)
    center = np.concatenate([rng.uniform(-0.4, 0.4, (N, 2)),
                             rng.uniform(-np.pi, np.pi, (N, 1))], axis=-1)
    sub = rng.integers(0, G - S, (N, 2)).astype(np.int32)
    sub[-1, 0] = G - S + 10               # the last job's subgrid overhangs the grid
    return dict(lx=lx, ly=ly, anchor=anchor, term=term, has_run=has_run, mask=mask,
                pose=pose, center=center, vp=center[:, :2].copy(), sub=sub)


def _jax_world_cells(inp):
    """The JAX matcher's _make_core arithmetic (matcher.py:660-670) through
    keep_mask_for_viewpoint and world_to_grid_idx, composed into the
    scatter cells of the port's occupancy_cells (numpy from there on)."""
    pose = jnp.asarray(inp["pose"])
    pc, ps = jnp.cos(pose[..., 2:3]), jnp.sin(pose[..., 2:3])
    lx, ly = jnp.asarray(inp["lx"]), jnp.asarray(inp["ly"])
    wx = pose[..., 0:1] + pc * lx - ps * ly
    wy = pose[..., 1:2] + ps * lx + pc * ly
    vp = jnp.asarray(inp["vp"])
    keep = np.asarray(JC.keep_mask_for_viewpoint(
        wx, wy, jnp.asarray(inp["anchor"]), jnp.asarray(inp["term"]),
        jnp.asarray(inp["has_run"]), jnp.asarray(inp["mask"])[..., None],
        vp[:, 0][:, None, None], vp[:, 1][:, None, None]))
    center = jnp.asarray(inp["center"])
    ox, oy = center[:, 0] - OFF, center[:, 1] - OFF
    gx = np.asarray(JC.world_to_grid_idx(wx, ox[:, None, None], RES)).astype(np.int64)
    gy = np.asarray(JC.world_to_grid_idx(wy, oy[:, None, None], RES)).astype(np.int64)
    N = gx.shape[0]
    R = S + 2 * H
    sox, soy = inp["sub"][:, 0, None, None], inp["sub"][:, 1, None, None]
    sx, sy = gx - sox + H, gy - soy + H
    ok = ((gx >= 0) & (gx < G) & (gy >= 0) & (gy < G) & keep
          & (sx >= 0) & (sx < R) & (sy >= 0) & (sy < R)).reshape(N, -1)
    lim = np.stack([G - inp["sub"][:, 1], G - inp["sub"][:, 0]], axis=1)
    return (np.where(ok, sy.reshape(N, -1), -1), np.where(ok, sx.reshape(N, -1), 0), lim,
            int(keep.sum()))


@pytest.mark.parametrize("seed,N,B,P", [(0, 1, 4, 64), (1, 2, 3, 37), (2, 4, 2, 16)])
def test_world_cells_ref_matches_the_jax_program(seed, N, B, P):
    inp = _world_inputs(seed, N, B, P)
    got = PK.world_cells_ref(*(_t(inp[k]) for k in WORLD_KEYS), G=G, S=S, h=H, res=RES)
    *want, kept = _jax_world_cells(inp)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    cells = (got[0] >= 0).sum()
    assert 0 < cells < kept <= N * B * P      # some kept points fall outside the subgrid
    assert got[2][-1, 1] == S - 10          # the overhang's full-grid limit


# -- lattice_cells -------------------------------------------------------------------

def _query_inputs(seed, N, P):
    rng = np.random.default_rng(seed)
    qlx = rng.uniform(-3.0, 3.0, (N, P))
    qly = rng.uniform(-3.0, 3.0, (N, P))
    n_q = rng.integers(P // 3, P + 1, N).astype(np.int32)
    center = np.concatenate([rng.uniform(-0.3, 0.3, (N, 2)),
                             rng.uniform(-np.pi, np.pi, (N, 1))], axis=-1)
    job = center + rng.uniform(-0.06, 0.06, (N, 3))
    sub = rng.integers(0, G - S, (N, 2)).astype(np.int32)
    return qlx, qly, n_q, center, job, sub


def _jax_lattice_cells(qlx, qly, n_q, center, job, sub, lat):
    """The lattice-origin cells of the JAX package's
    score_lattice_patch_batched (correlation.py:688-705), with the JAX
    matcher's query padding (matcher.py:720-724)."""
    P = qlx.shape[1]
    lane = jnp.arange(P)
    pts_x = jnp.where(lane[None, :] < n_q[:, None], qlx, 1.0e9)
    pts_y = jnp.where(lane[None, :] < n_q[:, None], qly, 1.0e9)
    cx, cy, ct = (jnp.asarray(center[:, i]) for i in range(3))
    ox, oy = jnp.asarray(job[:, 0]) - OFF, jnp.asarray(job[:, 1]) - OFF
    dtype = jnp.float64
    xvals = (cx - lat.xy_size)[:, None] + jnp.arange(lat.nx, dtype=dtype)[None, :] * lat.xy_res
    yvals = (cy - lat.xy_size)[:, None] + jnp.arange(lat.ny, dtype=dtype)[None] * lat.xy_res
    tvals = (ct - lat.ang_size)[:, None] + jnp.arange(lat.nt, dtype=dtype)[None] * lat.ang_res
    c, s = jnp.cos(tvals), jnp.sin(tvals)
    rx = c[:, :, None] * pts_x[:, None, :] - s[:, :, None] * pts_y[:, None, :]
    ry = s[:, :, None] * pts_x[:, None, :] + c[:, :, None] * pts_y[:, None, :]
    gx0 = JC.world_to_grid_idx(xvals[:, 0, None, None] + rx, ox[:, None, None], RES)
    gy0 = JC.world_to_grid_idx(yvals[:, 0, None, None] + ry, oy[:, None, None], RES)
    return (np.asarray(gy0 - sub[:, 1, None, None]), np.asarray(gx0 - sub[:, 0, None, None]))


@pytest.mark.parametrize("name", ["coarse", "fine"])
@pytest.mark.parametrize("seed,N,P", [(3, 1, 64), (4, 3, 29)])
def test_lattice_cells_ref_matches_the_jax_offsets(name, seed, N, P):
    lat = LATTICES[name]
    qlx, qly, n_q, center, job, sub = _query_inputs(seed, N, P)
    sgy0, sgx0, n_int = PK.lattice_cells_ref(
        _t(qlx), _t(qly), _t(n_q), _t(center), _t(job), _t(sub), lat, G=G, res=RES)
    wy, wx = _jax_lattice_cells(qlx, qly, n_q, center, job, sub, lat)
    assert sgy0.shape == sgx0.shape == (N, lat.nt, P) and sgy0.dtype == torch.int32
    np.testing.assert_array_equal(n_int.numpy(), n_q)
    for n in range(N):
        k = int(n_q[n])
        np.testing.assert_array_equal(sgy0[n, :, :k].numpy(), wy[n, :, :k])
        np.testing.assert_array_equal(sgx0[n, :, :k].numpy(), wx[n, :, :k])
        # padded lanes: the far sentinel, turned, lands ~1e9 m off in x or y
        far = np.maximum(np.abs(sgx0[n, :, k:].numpy() + sub[n, 0]),
                         np.abs(sgy0[n, :, k:].numpy() + sub[n, 1]))
        assert (far >= 10 ** 7).all()


# -- the fused wrappers on the CPU ----------------------------------------------------

@pytest.mark.parametrize("N,R,min_rows,shape", [
    (1, 3092, 1, (12, 264)), (1, 788, 1, (3, 264)), (64, 1556, 1, (195, 8)),
    (4, 772, 1, (11, 72)), (1, 788, 36, (33, 24)), (2, 68, 1, (1, 72)),
    (1, 50, 10 ** 6, (7, 8)), (1, 5, 1, (1, 8)), (1, 788, None, (25, 32)),
    (4, 772, None, (25, 32)), (1, 1812, None, (29, 64)), (1, 3092, None, (30, 104))])
def test_scatter_shape(N, R, min_rows, shape):
    """Bands for about two blocks a SM on 132 SMs at most, each of min_rows
    (None: SCATTER_MIN_BAND_ROWS) rows at least before the rounding to
    whole clusters of 8; the bands cover the grid, and fewer than a cluster
    of them are empty."""
    got = PK.scatter_shape(N, R, SMS, *(() if min_rows is None else (min_rows,)))
    assert tuple(got) == shape
    rows, bands = got
    C = PK.SCATTER_CLUSTER
    assert C == 8 and bands % C == 0 and rows * bands >= R and rows * (bands - C) < R


def _scatter_np(sy, sx, R):
    """(N, R, R) uint8, 1 at each job's cells (sy >= 0), in numpy."""
    occ = np.zeros((sy.shape[0], R, R), np.uint8)
    for n in range(sy.shape[0]):
        ok = sy[n] >= 0
        occ[n, sy[n][ok], sx[n][ok]] = 1
    return occ


def _world_args(inp, dtype):
    return [_t(inp[k], dtype if np.asarray(inp[k]).dtype == np.float64 else None)
            for k in WORLD_KEYS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed,N,B,P", [(20, 1, 4, 64), (21, 4, 3, 37), (22, 64, 2, 16)])
def test_world_scatter_scatters_the_world_cells(seed, N, B, P, dtype):
    """world_scatter's CPU route is world_cells_ref's cells scattered, lim
    included; in float64 the grid of the JAX program's cells.  Some kept
    points fall outside the subgrid, and the last job's subgrid overhangs
    the full grid."""
    inp = _world_inputs(seed, N, B, P)
    args = _world_args(inp, dtype)
    R = S + 2 * H
    occ, lim = PK.world_scatter(*args, G=G, S=S, h=H, res=RES)
    sy, sx, lim_twin = PK.world_cells_ref(*args, G=G, S=S, h=H, res=RES)
    assert occ.dtype == torch.uint8 and occ.shape == (N, R, R) and lim.dtype == torch.int32
    assert torch.equal(occ, K.scatter_cells_ref(sy, sx, R)) and torch.equal(lim, lim_twin)
    assert torch.equal(occ, torch.as_tensor(_scatter_np(sy.numpy(), sx.numpy(), R)))
    assert 0 < int(occ.sum()) and int((sy >= 0).sum()) < N * B * P
    if dtype == torch.float64:
        want_sy, want_sx, want_lim, _ = _jax_world_cells(inp)
        np.testing.assert_array_equal(occ.numpy(), _scatter_np(want_sy, want_sx, R))
        np.testing.assert_array_equal(lim.numpy(), want_lim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_world_scatter_of_an_unused_base_and_of_no_job(dtype):
    """No base slot in use: an all-zero grid, lim still (G - soy, G - sox);
    no job: empty outputs."""
    inp = _world_inputs(23, 3, 2, 16)
    inp["mask"][:] = False
    occ, lim = PK.world_scatter(*_world_args(inp, dtype), G=G, S=S, h=H, res=RES)
    assert occ.shape == (3, S + 2 * H, S + 2 * H) and int(occ.sum()) == 0
    np.testing.assert_array_equal(lim.numpy(), np.stack([G - inp["sub"][:, 1],
                                                         G - inp["sub"][:, 0]], axis=1))
    none = {k: v[:0] for k, v in inp.items()}
    occ, lim = PK.world_scatter(*_world_args(none, dtype), G=G, S=S, h=H, res=RES)
    assert occ.shape == (0, S + 2 * H, S + 2 * H) and lim.shape == (0, 2)


def _window_np(q, gy0, gx0, n, ny, nx, stride):
    """The window sums of cells (N, K, P) over q (N, S, S) in numpy: each
    job's first n[j] points, reads off the grid 0."""
    N, Sq, _ = q.shape
    out = np.zeros((N, gy0.shape[1], ny, nx), np.int64)
    for j in range(N):
        for k in range(gy0.shape[1]):
            for p in range(max(0, min(int(n[j]), gy0.shape[2]))):
                y = gy0[j, k, p] + stride * np.arange(ny)[:, None]
                x = gx0[j, k, p] + stride * np.arange(nx)[None, :]
                ok = (y >= 0) & (y < Sq) & (x >= 0) & (x < Sq)
                out[j, k] += np.where(ok, q[j, np.clip(y, 0, Sq - 1), np.clip(x, 0, Sq - 1)], 0)
    return out.astype(np.int32)


def _lattice_case(seed, N, P):
    """A pass's inputs: query points, their counts, centers, and a
    quantized grid of random scores (N, S, S) uint8."""
    qlx, qly, n_q, center, job, sub = _query_inputs(seed, N, P)
    q = np.random.default_rng(seed + 100).integers(0, 101, (N, S, S)).astype(np.uint8)
    return q, qlx, qly, n_q, center, job, sub


@pytest.mark.parametrize("name", ["coarse", "fine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed,N,P", [(24, 1, 64), (25, 4, 29), (26, 64, 16)])
def test_lattice_window_sum_sums_the_lattice_cells(name, dtype, seed, N, P):
    """lattice_window_sum's CPU route is window_sum_ref over
    lattice_cells_ref's cells, padded lanes and all; in float64 the numpy
    sum over the JAX package's cells.  The fine pass's center is a strided
    view, as the matcher passes it (columns 1-3 of the packed result)."""
    lat = LATTICES[name]
    q, qlx, qly, n_q, center, job, sub = _lattice_case(seed, N, P)
    args = [_t(qlx, dtype), _t(qly, dtype), _t(n_q)]
    c = _t(center, dtype)
    if name == "fine":
        packed = torch.zeros((N, 2, 8), dtype=dtype)
        packed[:, 0, 1:4] = c
        c = packed[:, 0, 1:4]
        assert c.stride(0) == 16
    rest = [_t(job, dtype), _t(sub)]
    raw = PK.lattice_window_sum(_t(q), *args, c, *rest, lat, G=G, res=RES)
    cells = PK.lattice_cells_ref(*args, c, *rest, lat, G=G, res=RES)
    assert raw.dtype == torch.int32 and raw.shape == (N, lat.nt, lat.ny, lat.nx)
    assert torch.equal(raw, K.window_sum_ref(_t(q), *cells, lat.ny, lat.nx, lat.stride))
    assert raw.sum() > 0
    if dtype == torch.float64:
        wy, wx = _jax_lattice_cells(qlx, qly, n_q, center, job, sub, lat)
        np.testing.assert_array_equal(
            raw.numpy(), _window_np(q, wy, wx, n_q, lat.ny, lat.nx, lat.stride))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lattice_window_sum_of_no_point_and_of_no_job(dtype):
    """n_q = 0 sums nothing; a count past the capacity sums every lane; no
    job gives an empty result."""
    lat = LATTICES["coarse"]
    q, qlx, qly, _, center, job, sub = _lattice_case(27, 3, 20)
    n_q = np.array([0, 20, 31], np.int32)
    f = [_t(a, dtype) for a in (qlx, qly)]
    raw = PK.lattice_window_sum(_t(q), *f, _t(n_q), _t(center, dtype), _t(job, dtype),
                                _t(sub), lat, G=G, res=RES)
    assert int(raw[0].abs().sum()) == 0
    full = PK.lattice_window_sum(_t(q), *f, _t(np.full(3, 20, np.int32)), _t(center, dtype),
                                 _t(job, dtype), _t(sub), lat, G=G, res=RES)
    assert torch.equal(raw[1:], full[1:]) and int(full[1:].sum()) > 0
    none = PK.lattice_window_sum(_t(q[:0]), *(t[:0] for t in f), _t(n_q[:0]),
                                 _t(center[:0], dtype), _t(job[:0], dtype), _t(sub[:0]), lat,
                                 G=G, res=RES)
    assert none.shape == (0, lat.nt, lat.ny, lat.nx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_point_counts_round_to_themselves(dtype):
    """The plain chain counts rint((T) n_q) points where the fused window
    sum counts n_q: the same for every count up to 2^24, far past any point
    capacity."""
    n = torch.arange(0, 2 ** 24 + 1, dtype=torch.int32)
    assert torch.equal(torch.round(n.to(dtype)).to(torch.int32), n)


# -- score_reduce against JAX ---------------------------------------------------------

def _raw_case(kind, lat, seed):
    """(raw (N, NT, NY, NX) int32, n_q (N,) int32) of a named case."""
    rng = np.random.default_rng(seed)
    shape = (lat.nt, lat.ny, lat.nx)
    if kind == "random":
        raw = rng.integers(0, 6000, (3, *shape))
        n_q = rng.integers(40, 64, 3)
    elif kind == "ties":        # every candidate ties: the zero-response lattice
        raw = np.zeros((2, *shape), np.int64)
        n_q = np.array([60, 1])
    elif kind == "padded":      # a batch's last row: no base slot in use
        raw = rng.integers(0, 6000, (3, *shape))
        raw[2] = 0
        n_q = np.array([61, 44, 52])
    elif kind == "nan":         # no query point: sums / 0 are inf, 0 / 0 NaN
        raw = rng.integers(0, 6000, (3, *shape))
        raw[0, 0, 0, :3] = 0
        raw[2] = 0
        n_q = np.array([0, 50, 0])
    elif kind == "signed_zero":  # all zero: a penalty below 0 makes -0
        raw = np.zeros((2, *shape), np.int64)
        n_q = np.array([60, 3])
    else:                       # "edges": the maximum on each face of the lattice
        faces = [(slice(None), slice(None), 0), (slice(None), slice(None), -1),
                 (slice(None), 0, slice(None)), (slice(None), -1, slice(None)),
                 (0, slice(None), slice(None)), (-1, slice(None), slice(None))]
        raw = rng.integers(0, 50, (len(faces), *shape))
        for n, face in enumerate(faces):
            at = rng.integers(0, 10 ** 6, shape)
            raw[n][face] += 10 ** 5 * (at[face] == at[face].max())
        n_q = rng.integers(40, 64, len(faces))
    return raw.astype(np.int32), n_q.astype(np.int32)


def _centers(seed, N):
    rng = np.random.default_rng(seed)
    center = np.concatenate([rng.uniform(-0.3, 0.3, (N, 2)),
                             rng.uniform(-np.pi, np.pi, (N, 1))], axis=-1)
    return center, center + rng.uniform(-0.06, 0.06, (N, 3))


def _jax_reduce(raw, n_q, center, job, lat, penalize, karto):
    """The tail of score_lattice_patch_batched (correlation.py:734-744),
    its _lattice_penalty, and the JAX matcher's vmapped reduce_best_pose."""
    dtype = jnp.float64
    cx, cy, ct = (jnp.asarray(center[:, i]) for i in range(3))
    ox, oy = jnp.asarray(job[:, 0]) - OFF, jnp.asarray(job[:, 1]) - OFF
    xvals = (cx - lat.xy_size)[:, None] + jnp.arange(lat.nx, dtype=dtype)[None, :] * lat.xy_res
    yvals = (cy - lat.xy_size)[:, None] + jnp.arange(lat.ny, dtype=dtype)[None] * lat.xy_res
    tvals = (ct - lat.ang_size)[:, None] + jnp.arange(lat.nt, dtype=dtype)[None] * lat.ang_res
    if penalize:
        penalty = JC._lattice_penalty(
            xvals, yvals, tvals, ct, ox, oy, grid_size=G, grid_res=RES,
            dist_var_penalty=0.5, ang_var_penalty=1.0, karto=karto, cx=cx, cy=cy)
    else:
        penalty = jnp.ones((), dtype=dtype)
    raw = jnp.asarray(raw).transpose(0, 3, 2, 1)
    out = raw.astype(dtype) / jnp.asarray(n_q, dtype)[:, None, None, None] * penalty / 100.0
    return np.asarray(jnp.stack(jax.vmap(JC.reduce_best_pose)(out, xvals, yvals, tvals), axis=1))


def _ref_reduce(raw, n_q, center, job, lat, penalize, karto, dtype=torch.float64):
    N = raw.shape[0]
    packed = torch.full((N, 2, 8), 7.0, dtype=dtype)
    stats = torch.empty((N, 4), dtype=torch.int64)
    PK.score_reduce_ref(_t(raw), _t(n_q), _t(center, dtype), _t(job, dtype), packed, 0, lat,
                        G=G, res=RES, penalize=penalize, karto=karto, copy_fine=True,
                        stats=stats)
    assert torch.equal(_bits(packed[:, 0]), _bits(packed[:, 1]))
    return packed[:, 0], stats


PENALTIES = {"none": (False, None), "reference": (True, None), "karto": (True, KARTO)}


@pytest.mark.parametrize("penalty", list(PENALTIES))
@pytest.mark.parametrize("kind", ["random", "ties", "edges", "padded"])
def test_score_reduce_ref_matches_the_jax_reduction(kind, penalty):
    penalize, karto = PENALTIES[penalty]
    lat = LATTICES["coarse"]
    raw, n_q = _raw_case(kind, lat, 5)
    center, job = _centers(6, raw.shape[0])
    got, stats = _ref_reduce(raw, n_q, center, job, lat, penalize, karto)
    want = _jax_reduce(raw, n_q, center, job, lat, penalize, karto)
    _close(got.numpy(), want)
    if kind == "ties":
        assert (stats[:, 3] == lat.nx * lat.ny * lat.nt).all()
        assert got[:, 4:].isnan().all()       # the moments are 0 / 0
    if kind == "edges" and penalty != "reference":
        # each row's maximum on its face: i = 0, NX - 1, j = 0, NY - 1,
        # theta = 0, NT - 1
        (i, j, k) = stats[:, :3].T.tolist()
        assert [i[0], i[1], j[2], j[3], k[4], k[5]] == [
            0, lat.nx - 1, 0, lat.ny - 1, 0, lat.nt - 1]
    if kind == "padded":
        assert stats[2, 3] == lat.nx * lat.ny * lat.nt and got[2, 0].abs() == 0


# -- score_reduce's own steps, emulated -------------------------------------------------

def _tree32(part):
    """A butterfly over the last axis's 32 entries as lane 0 holds it: the
    tree part[:s] += part[s:2s] for s = 16, ..., 1."""
    part = part.copy()
    s = 16
    while s:
        part[..., :s] = part[..., :s] + part[..., s:2 * s]
        s //= 2
    return part[..., 0]


def _job_sum(terms):
    """The kernel's float64 sum over a job: terms (job threads, L), row g
    the terms thread g adds in turn from 0.0 (0 where it has none: a sum
    is never -0, so adding +0 changes nothing); then a butterfly over each
    warp's 32 lanes; then the warps' partials, lane l adding those of
    warps l, l + 32, ... in turn from 0.0, and a butterfly over the
    lanes."""
    terms = np.asarray(terms, dtype=np.float64)
    part = np.zeros(terms.shape[0])
    for col in terms.T:
        part = part + col
    warps = _tree32(part.reshape(-1, 32))
    lanes = np.zeros(32)
    for w, p in enumerate(warps):
        lanes[w % 32] = lanes[w % 32] + p
    return _tree32(lanes)


def _thread_terms(vals, shape, lat):
    """(job threads, cols * NT): thread g's responses in the order it
    meets them, its columns ji = g + c * job_threads and their angles,
    from `vals` (NT, NY, NX); NaN where it has none; and where it has
    one."""
    TT = shape.job_threads
    g = np.arange(TT)[:, None, None]
    ji = g + np.arange(shape.cols)[None, :, None] * TT
    q = np.arange(lat.nt)[None, None, :]
    ok = np.broadcast_to(ji < lat.nx * lat.ny, (TT, shape.cols, lat.nt))
    flat = vals.reshape(lat.nt, -1)
    out = np.full((TT, shape.cols, lat.nt), np.nan, dtype=vals.dtype)
    out[ok] = flat[np.broadcast_to(q, ok.shape)[ok], np.broadcast_to(ji, ok.shape)[ok]]
    return out.reshape(TT, -1), ok.reshape(TT, -1)


def _window_terms(terms, TT):
    """Window cell w to thread w mod TT, each thread's in turn: (TT, L)."""
    terms = np.asarray(terms, dtype=np.float64)
    cols = -(-len(terms) // TT) or 1
    out = np.zeros(cols * TT)
    out[:len(terms)] = terms
    return out.reshape(cols, TT).T


@np.errstate(invalid="ignore", divide="ignore")
def _emulate_score_reduce(raw, n_q, center, job, lat, penalize, karto, dtype, cuda_div):
    """score_reduce_kernel step by step in numpy (each operation rounded to
    `dtype`).  A division by a Python number: a product with its reciprocal
    where `cuda_div` (PyTorch's CUDA division, which the kernel follows),
    else a division (PyTorch's CPU one, which the twin runs here).
    Returns (rows (N, 8), stats (N, 4), values (N, NT, NY, NX))."""
    T = np.float32 if dtype == torch.float32 else np.float64

    def sdiv(a, c):
        return a * (T(1) / T(c)) if cuda_div else a / T(c)

    N = raw.shape[0]
    shape = PK.reduce_shape(lat, dtype, N, SMS)
    TT = shape.job_threads
    rows = np.empty((N, 8), T)
    stats = np.empty((N, 4), np.int64)
    values = np.empty(raw.shape, T)
    ii_, jj_, qq_ = np.arange(lat.nx), np.arange(lat.ny), np.arange(lat.nt)
    for n in range(N):
        cx, cy, ct = T(center[n, 0]), T(center[n, 1]), T(center[n, 2])
        xv = (cx - T(lat.xy_size)) + ii_.astype(T) * T(lat.xy_res)
        yv = (cy - T(lat.xy_size)) + jj_.astype(T) * T(lat.xy_res)
        tv = (ct - T(lat.ang_size)) + qq_.astype(T) * T(lat.ang_res)
        v = raw[n].astype(T) / T(n_q[n])                     # (NT, NY, NX)
        if penalize:
            if karto:
                sx, sy, dc, ac = cx, cy, karto[0], karto[1]
            else:
                sx = (T(job[n, 0]) - T(OFF)) + T(G * RES / 2.0)
                sy = (T(job[n, 1]) - T(OFF)) + T(G * RES / 2.0)
                dc, ac = 0.5 * RES, 1.0 * RES
            dx, dy = xv - sx, yv - sy
            sqd = dx[None, :] * dx[None, :] + dy[:, None] * dy[:, None]   # (NY, NX)
            dpen = T(1) - sdiv(T(0.2) * sqd, dc)
            da = tv - ct
            apen = T(1) - sdiv(T(0.2) * (da * da), ac)
            if karto:
                dpen, apen = np.maximum(dpen, T(karto[2])), np.maximum(apen, T(karto[3]))
            v = v * (dpen[None] * apen[:, None, None])
        v = sdiv(v, 100.0)
        values[n] = v
        flat = v.transpose(2, 1, 0).reshape(-1)              # C order over (x, y, theta)
        m = int(np.argmax(flat))
        ii, jj, kk = m // (lat.ny * lat.nt), (m % (lat.ny * lat.nt)) // lat.nt, m % lat.nt
        response = flat[m]
        # the ties, over each thread's columns and angles in turn
        got, ok = _thread_terms(v, shape, lat)
        with np.errstate(invalid="ignore"):
            tie = ok & (got >= response - T(1e-8))
        q3, j3, i3 = np.meshgrid(qq_, jj_, ii_, indexing="ij")
        cnt = _job_sum(tie)
        sums = [_job_sum(np.where(tie, _thread_terms(c.astype(np.float64), shape, lat)[0], 0))
                for c in (xv[i3], yv[j3], tv[q3])]
        bx, by, bt = (T(s / cnt) for s in sums)
        i0, i1 = max(0, ii - 5), min(lat.nx - 1, ii + 6)
        j0, j1 = max(0, jj - 5), min(lat.ny - 1, jj + 6)
        q0, q1 = max(0, kk - 5), min(lat.nt - 1, kk + 6)
        wi, wj = np.meshgrid(np.arange(i0, i1), np.arange(j0, j1), indexing="ij")
        wi, wj = wi.reshape(-1), wj.reshape(-1)               # window order w = i * wj + j
        s = v[kk, wj, wi]
        ddx, ddy = xv[wi] - bx, yv[wj] - by
        norm, XX, YY, XY = (_job_sum(_window_terms(a, TT)) for a in (
            s, s * (ddx * ddx), s * (ddy * ddy), (s * ddx) * ddy))
        sq = v[q0:q1, jj, ii]
        dt = tv[q0:q1] - bt
        thn, TH = (_job_sum(_window_terms(a, TT)) for a in (sq, sq * (dt * dt)))
        r = np.float64(response)
        with np.errstate(invalid="ignore", divide="ignore"):
            rows[n] = [response, bx, by, bt, T(XX / norm / r), T(YY / norm / r),
                       T(XY / norm / r), T(TH / thn)]
        stats[n] = ii, jj, kk, int(cnt)
    return rows, stats, values


def _ulps(a, b):
    a, b = np.asarray(a), np.asarray(b)
    ia = a.view(np.int32 if a.dtype == np.float32 else np.int64).astype(np.int64)
    ib = b.view(np.int32 if b.dtype == np.float32 else np.int64).astype(np.int64)
    top = -(2 ** 31) if a.dtype == np.float32 else -(2 ** 63)
    ka, kb = np.where(ia < 0, top - ia, ia), np.where(ib < 0, top - ib, ib)
    return np.where(np.isnan(a) & np.isnan(b), 0, np.abs(ka - kb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("penalty", list(PENALTIES))
@pytest.mark.parametrize("kind,lattice", [("random", "coarse"), ("random", "wide"),
                                          ("ties", "fine"), ("edges", "wide"),
                                          ("padded", "fine"), ("random", "tour_fine"),
                                          ("random", "tour_coarse"), ("edges", "loop_coarse"),
                                          ("nan", "fine"), ("signed_zero", "loop_coarse")])
def test_score_reduce_kernel_steps_emulated(kind, lattice, penalty, dtype):
    """The kernel's steps in numpy, with the CPU's division, equal the twin:
    every candidate's response bit for bit, the response, argmax and tie
    count bit-equal, the pose and moments within one ulp in float32 (their
    float64 sums run in another order) and 1e-12 relative in float64.  With
    CUDA's division by a Python number (what the kernel runs on the card)
    the candidates move by a few float32 ulps of the lattice's largest
    score (the penalty's 1 - x cancels)."""
    penalize, karto = PENALTIES[penalty]
    lat = LATTICES[lattice]
    raw, n_q = _raw_case(kind, lat, 8)
    center, job = _centers(9, raw.shape[0])
    T = np.float32 if dtype == torch.float32 else np.float64
    rows, stats, values = _emulate_score_reduce(raw, n_q, center, job, lat, penalize, karto,
                                                dtype, cuda_div=False)
    got, want_stats = _ref_reduce(raw, n_q, center, job, lat, penalize, karto, dtype)
    got = got.numpy()
    # every candidate's response, against the twin's (N, NX, NY, NT) scores
    ct, jc = _t(center, dtype), _t(job, dtype)
    xv, yv, tv = TC.lattice_values(ct[:, 0], ct[:, 1], ct[:, 2], spec=lat.spec,
                                   xy_size=lat.xy_size, xy_res=lat.xy_res,
                                   ang_size=lat.ang_size, ang_res=lat.ang_res, dtype=dtype)
    scores = TC.lattice_scores(_t(raw), _t(n_q).to(dtype), xv, yv, tv, ct[:, 0], ct[:, 1],
                               ct[:, 2], jc[:, 0] - OFF, jc[:, 1] - OFF, grid_size=G,
                               grid_res=RES, penalize=penalize, karto_penalties=karto)
    np.testing.assert_array_equal(values.transpose(0, 3, 2, 1).view(np.int64 if T is np.float64
                                                                    else np.int32),
                                  scores.numpy().view(np.int64 if T is np.float64 else np.int32))
    np.testing.assert_array_equal(stats, want_stats.numpy())
    np.testing.assert_array_equal(rows[:, 0].view(got.dtype), got[:, 0])
    np.testing.assert_array_equal(np.isnan(rows), np.isnan(got))
    if dtype == torch.float32:
        assert _ulps(rows, got).max() <= 1
    else:
        _close(rows, got)
    if kind == "signed_zero" and penalty == "reference":
        # +0 and -0 tie; the first in C order gives the response its sign
        assert (values == 0).all() and np.signbit(values).any() and not np.signbit(values).all()
    if kind == "nan":
        assert np.isnan(rows[[0, 2], 0]).all() and (stats[[0, 2], 3] == 0).all()
    cuda_rows, cuda_stats, cuda_values = _emulate_score_reduce(
        raw, n_q, center, job, lat, penalize, karto, dtype, cuda_div=True)
    scale = np.abs(values[np.isfinite(values)]).max(initial=1.0)
    np.testing.assert_allclose(cuda_values, values, rtol=0, atol=8 * np.finfo(T).eps * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lattice", sorted(LATTICES))
def test_score_reduce_shape_follows_the_pass(lattice, dtype):
    """A thread a lattice column where a block can have one each, in
    multiples of 32 threads, at most 1024 a block; the job's threads cover
    every column; its responses fit its blocks' shared memory; one block or
    a cluster of eight, whatever the batch."""
    lat = LATTICES[lattice]
    for jobs in (1, 4, 17, 64):
        _check_shape(lat, dtype, PK.reduce_shape(lat, dtype, jobs, SMS))


def _check_shape(lat, dtype, shape):
    nxy = lat.nx * lat.ny
    es = 8 if dtype == torch.float64 else 4
    assert shape.threads % 32 == 0 and shape.cluster in (1, PK.REDUCE_CLUSTER)
    assert shape.threads <= PK.REDUCE_MAX_THREADS
    assert shape.cols == -(-nxy // (PK.REDUCE_MAX_THREADS * shape.cluster))
    assert nxy <= shape.job_threads * shape.cols < nxy + 32 * shape.cluster * shape.cols
    assert shape.in_shared and (PK._reduce_header_bytes(shape.job_threads // 32, es)
                                + shape.cols * lat.nt * shape.threads * es
                                <= PK.REDUCE_MAX_SMEM)


def test_score_reduce_shape_spreads_what_one_block_cannot_hold():
    """The tour's fine pass takes one warp, its coarse pass one block
    (6,250 candidates, below REDUCE_CLUSTER_AT), the loop's coarse pass a
    cluster of eight while the batch's blocks come to at most three a SM,
    else one block of two columns a thread; responses past one block's
    shared memory take a cluster whatever the batch, and past eight
    blocks' scratch rows."""
    f32, f64 = torch.float32, torch.float64
    assert PK.reduce_shape(LATTICES["tour_fine"], f32, 1, SMS) == (32, 1, 1, True)
    assert PK.reduce_shape(LATTICES["tour_coarse"], f32, 1, SMS) == (640, 1, 1, True)
    assert PK.reduce_shape(LATTICES["tour_coarse"], f64, 64, SMS) == (640, 1, 1, True)
    assert PK.reduce_shape(LATTICES["loop_coarse"], f32, 4, SMS) == (224, 8, 1, True)
    assert PK.reduce_shape(LATTICES["loop_coarse"], f32, 49, SMS) == (224, 8, 1, True)
    assert PK.reduce_shape(LATTICES["loop_coarse"], f32, 50, SMS) == (800, 1, 2, True)
    assert PK.reduce_shape(LATTICES["loop_coarse"], f32, 50, 144) == (224, 8, 1, True)
    big = PK.PassLattice(32, 32, 40, 0.5, 0.02, 0.1, 0.005, 1)     # 320 KB in float64
    huge = PK.PassLattice(64, 64, 400, 0.5, 0.02, 0.1, 0.005, 1)   # 13 MB in float64
    wide = PK.PassLattice(40, 40, 100, 0.5, 0.02, 0.1, 0.005, 1)   # 1.3 MB in float64
    assert PK.reduce_shape(big, f64, 1, SMS) == (128, 8, 1, True)
    assert PK.reduce_shape(big, f64, 64, SMS) == (128, 8, 1, True)
    assert PK.reduce_shape(big, f32, 64, SMS) == (1024, 1, 1, True)
    assert PK.reduce_shape(huge, f64, 1, SMS) == (512, 8, 1, False)
    assert PK.reduce_shape(wide, f64, 64, SMS) == (224, 8, 1, True)
    assert PK._reduce_header_bytes(5, 8) % 8 == 0
    few = PK.PassLattice(20, 20, 30, 0.5, 0.02, 0.1, 0.005, 1)     # 96 KB in float64
    assert PK.reduce_shape(few, f64, 1, SMS) == (64, 8, 1, True)
    assert PK.reduce_shape(few, f64, 64, SMS) == (416, 1, 1, True)
    for lat in (big, huge, wide, few):
        for dt in (f32, f64):
            for jobs in (1, 64):
                shape = PK.reduce_shape(lat, dt, jobs, SMS)
                if shape.in_shared:
                    _check_shape(lat, dt, shape)


def _emulated_equals_the_twin(raw, n_q, lat, seed, dtype):
    center, job = _centers(seed, raw.shape[0])
    rows, stats, _ = _emulate_score_reduce(raw, n_q, center, job, lat, True, None, dtype,
                                           cuda_div=False)
    got, want_stats = _ref_reduce(raw, n_q, center, job, lat, True, None, dtype)
    got = got.numpy()
    np.testing.assert_array_equal(stats, want_stats.numpy())
    np.testing.assert_array_equal(rows[:, 0].view(got.dtype), got[:, 0])
    if dtype == torch.float32:
        assert _ulps(rows, got).max() <= 1
    else:
        _close(rows, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_score_reduce_kernel_steps_emulated_on_a_cluster(kind, dtype):
    """With the job spread over a cluster of eight blocks (more than 32
    warps: lane l of the last reduction adds warps l, l + 32, ...), the
    emulated kernel still equals the twin: response, argmax and tie count
    bit-equal, the rest within an ulp in float32 and 1e-12 relative in
    float64."""
    lat = LATTICES["loop_coarse"]
    raw, n_q = _raw_case(kind, lat, 12)
    shape = PK.reduce_shape(lat, dtype, raw.shape[0], SMS)
    assert shape.cluster == 8 and shape.job_threads > 1024 and shape.cols == 1
    _emulated_equals_the_twin(raw, n_q, lat, 13, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_score_reduce_kernel_steps_emulated_past_the_sms(dtype):
    """A loop coarse batch of 50 jobs, whose clusters of eight would come to
    more than three blocks a SM: one block a job, each thread two lattice
    columns (its terms of both in turn); the emulated kernel equals the
    twin."""
    lat = LATTICES["loop_coarse"]
    rng = np.random.default_rng(14)
    raw = rng.integers(0, 6000, (50, lat.nt, lat.ny, lat.nx)).astype(np.int32)
    n_q = rng.integers(40, 64, 50).astype(np.int32)
    shape = PK.reduce_shape(lat, dtype, 50, SMS)
    assert shape.cluster == 1 and shape.cols == 2
    _emulated_equals_the_twin(raw, n_q, lat, 15, dtype)


# -- _compute against the composition it replaced ------------------------------------------

_FAR = 1.0e9


def _score_pass(m, q2d, inp, center, fine, penalty, coarse_offset):
    """One pass of matcher `m` as plain tensor code (correlation.score_lattice)
    around `center` = (cx, cy, ct), each (N,): the coarse pass, or with
    `fine` the fine one.  `inp` holds the padded query lanes (qx, qy), their
    counts n_pts, the full-grid origins (ox, oy) and the subgrid origins
    (sox, soy).  Returns score_lattice's (out, xvals, yvals, tvals);
    reduce_best_pose of them is what ``_compute``'s lattice_window_sum and
    score_reduce give for the pass."""
    lat = m._lattices(coarse_offset)[int(bool(fine))]
    return TC.score_lattice(
        q2d, inp["qx"], inp["qy"], inp["n_pts"], *center, inp["ox"], inp["oy"], inp["sox"],
        inp["soy"], grid_size=m.grid_size, grid_res=m.config.resolution, penalize=penalty,
        karto_penalties=m.config.karto_penalty_tuple(), spec=lat.spec, xy_size=lat.xy_size,
        xy_res=lat.xy_res, ang_size=lat.ang_size, ang_res=lat.ang_res)


def _pre_change_compute(m, st, S, penalty, do_fine, coarse_offset):
    """CorrelativeScanMatcher._compute as it was before the program kernels:
    _world_points, build_quantized_grid / build_grid_staged, _score_pass and
    reduce_best_pose, the packed result stacked."""
    G, res = m.grid_size, m.config.resolution
    P = st["lx"].shape[-1]
    center, pose, vp = st["center"], st["pose"], st["vp"]
    cx, cy, ct = center[:, 0], center[:, 1], center[:, 2]
    pc = torch.cos(pose[..., 2:3])
    ps = torch.sin(pose[..., 2:3])
    wx = pose[..., 0:1] + pc * st["lx"] - ps * st["ly"]
    wy = pose[..., 1:2] + ps * st["lx"] + pc * st["ly"]
    keep = TC.keep_mask_for_viewpoint(
        wx, wy, st["anchor"], st["term"], st["has_run"], st["mask"][..., None],
        vp[:, 0, None, None], vp[:, 1, None, None])
    valid = torch.arange(P, device=wx.device)[None, :] < st["n_q"][:, None]
    inp = dict(wx=wx, wy=wy, keep=keep, ox=cx - 0.5 * (G - 1) * res,
               oy=cy - 0.5 * (G - 1) * res, sox=st["sub"][:, 0], soy=st["sub"][:, 1],
               qx=torch.where(valid, st["qlx"], _FAR), qy=torch.where(valid, st["qly"], _FAR),
               n_pts=st["n_q"].to(m.dtype), cx=cx, cy=cy, ct=ct)
    points = tuple(inp[k] for k in ("wx", "wy", "keep", "ox", "oy", "sox", "soy"))
    build = dict(G=G, S=S, h=m._half, res=res, taps=st["taps"])
    grid0 = None
    if m.return_meta:
        q2d, grid = TC.build_grid_staged(*points, **build)
        grid0 = grid[0]
    else:
        q2d = TC.build_quantized_grid(*points, **build)
    coarse = TC.reduce_best_pose(*_score_pass(m, q2d, inp, (cx, cy, ct), False, penalty,
                                              coarse_offset))
    fine = coarse
    if do_fine:
        fine = TC.reduce_best_pose(*_score_pass(
            m, q2d, inp, (coarse[:, 1], coarse[:, 2], coarse[:, 3]), True, penalty,
            coarse_offset))
    return torch.stack([coarse, fine], dim=1), grid0


@pytest.fixture(scope="module")
def room():
    base = [make_room_scan(0.1 * i, 0.02 * i, 0.03 * i, seed=i + 1) for i in range(4)]
    queries = [make_room_scan(0.13, -0.05, 0.05, seed=10),
               make_room_scan(0.05, 0.04, -0.02, seed=11),
               make_room_scan(0.21, 0.01, 0.08, seed=12)]
    for q in queries:
        q.corrected_pose = q.odom_pose
    return base, queries


@pytest.mark.parametrize("dtype,meta,karto", [(torch.float64, False, False),
                                              (torch.float32, False, False),
                                              (torch.float32, True, False),
                                              (torch.float64, False, True)])
def test_compute_equals_the_composition_it_replaced(room, dtype, meta, karto):
    base, queries = room
    cfg = dict(TEST_CFG, use_karto_penalties=True) if karto else TEST_CFG
    m = CorrelativeScanMatcher(cfg, device="cpu", dtype=dtype, return_meta=meta)
    args, P, S = m._prepare([(q, base[i:]) for i, q in enumerate(queries)], n_pad=4)
    st = m._stage(args)
    off = m.config.coarse_search_angle_offset
    for penalty, do_fine in ((True, True), (False, False), (True, False)):
        got, grid = m._compute(st, S, penalty, do_fine, off)
        want, want_grid = _pre_change_compute(m, st, S, penalty, do_fine, off)
        assert torch.equal(_bits(got), _bits(want))
        assert (grid is None) == (not meta) and (grid is None or torch.equal(grid, want_grid))
    assert got[:3, :, 0].min() > 0 and got[3, 0, 0] == 0     # the padded row scores 0


# -- the CUDA dispatch, without a card ---------------------------------------------------

class _FakeLibrary:
    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if name not in ("yag_world_scatter", "yag_lattice_window_sum", "yag_score_reduce"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or self.err


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers see their tensors as CUDA tensors; a twin fails the test
    if it runs."""
    monkeypatch.setattr(PK, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(PK, "_stream", lambda t: 0)
    monkeypatch.setattr(PK, "_sm_count", lambda index: SMS)
    for name in ("world_scatter_ref", "lattice_window_sum_ref", "score_reduce_ref",
                 "world_cells_ref", "lattice_cells_ref"):
        monkeypatch.setattr(PK, name, lambda *a, **k: pytest.fail("a plain twin ran"))

    def use(err):
        lib = _FakeLibrary(err)
        monkeypatch.setattr(_build, "library", lambda: lib)
        return lib

    return use


def _calls(dtype=torch.float32):
    """One call of each wrapper at small shapes (N 2, B 3, P 5; coarse)."""
    inp = _world_inputs(10, 2, 3, 5)
    w = _world_args(inp, dtype)
    lat = LATTICES["coarse"]
    q = [_t(inp["lx"][:, 0], dtype), _t(inp["ly"][:, 0], dtype),
         _t(np.array([5, 3], dtype=np.int32))]
    center = _t(inp["center"], dtype)
    packed = torch.zeros((2, 2, 8), dtype=dtype)
    grid = torch.zeros((2, S, S), dtype=torch.uint8)
    raw = torch.zeros((2, lat.nt, lat.ny, lat.nx), dtype=torch.int32)
    return dict(
        world_scatter=lambda: PK.world_scatter(*w, G=G, S=S, h=H, res=RES),
        lattice_window_sum=lambda: PK.lattice_window_sum(grid, *q, packed[:, 0, 1:4], center,
                                                         w[-1], lat, G=G, res=RES),
        score_reduce=lambda: PK.score_reduce(raw, q[2], packed[:, 0, 1:4], center, packed, 1,
                                             lat, G=G, res=RES, penalize=True, karto=KARTO))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tensors_launch_the_kernels_and_never_the_twins(fake_card, dtype):
    lib = fake_card(0)
    PK.reset_launches()
    K.reset_launches()
    calls = _calls(dtype)
    occ, lim = calls["world_scatter"]()
    assert occ.shape == (2, S + 2 * H, S + 2 * H) and occ.dtype == torch.uint8
    assert lim.shape == (2, 2) and lim.dtype == torch.int32
    raw = calls["lattice_window_sum"]()
    assert raw.shape == (2, 5, 9, 9) and raw.dtype == torch.int32
    calls["score_reduce"]()
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 1)
    # the fused launches are launches of scatter_cells' and window_sum's kernel
    assert K.LAUNCHES == dict(dict.fromkeys(K.LAUNCHES, 0), scatter_cells=1, window_sum=1)
    (w_name, w), (l_name, lc), (r_name, r) = lib.calls
    is_double = int(dtype == torch.float64)
    # 2 jobs of 68 rows: 3 bands each (SCATTER_MIN_BAND_ROWS), then a cluster of 8
    assert w_name == "yag_world_scatter" and w[12:20] == (2, 3, 5, G, S, H, 9, 8)
    assert w[-2] == is_double and list(w[20]) == [RES, OFF]
    # the fine pass's center: row 0 of the packed result, 16 elements apart
    assert l_name == "yag_lattice_window_sum" and lc[5] == 16
    assert lc[9:16] == (2, S, 5, 5, 9, 9, 2) and lc[-2] == is_double
    assert list(lc[16]) == [0.2, 0.1, 0.08, 0.04, RES, OFF]
    # no stats, no scratch rows; the coarse lattice's 81 columns: 96 threads
    assert r_name == "yag_score_reduce" and r[3] == 16 and r[6] is None and r[7] is None
    assert r[8:18] == (1, 0, 2, 9, 9, 5, 96, 1, 1, 2) and list(r[18])[-4:] == list(KARTO)
    fake_card(9)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} kernel launch failed: cudaError 9"):
            call()
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 2)


def test_captured_launches_count_at_each_replay(fake_card):
    """A launch inside a capture counts into the capture, not into
    LAUNCHES; each replay adds the capture's counts to the program
    kernels' own table and to the kernels' the fused ones launch."""
    fake_card(0)
    PK.reset_launches()
    K.reset_launches()
    calls = _calls()
    with K.captured_launches() as counts:
        for call in calls.values():
            call()
        K._count("window_sum")
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)
    assert counts == dict(dict.fromkeys(K.LAUNCHES, 0), window_sum=2, scatter_cells=1,
                          **dict.fromkeys(PK.LAUNCHES, 1))
    for _ in range(3):
        K.add_launches(counts)
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 3) and K.LAUNCHES["window_sum"] == 6
    PK.reset_launches()
    K.reset_launches()
    with pytest.raises(ValueError, match="already counted"):
        K.register_launches({"world_scatter": 0})


def test_cuda_wrappers_check_their_inputs(fake_card):
    lib = fake_card(0)
    inp = _world_inputs(11, 1, 2, 4)
    w = [_t(inp[k]) for k in WORLD_KEYS]
    bad = list(w)
    bad[2] = bad[2].long()
    with pytest.raises(TypeError, match="anchor"):
        PK.world_scatter(*bad, G=G, S=S, h=H, res=RES)
    with pytest.raises(TypeError, match="float32 or float64"):
        PK.world_scatter(*(t.half() if t.dtype == torch.float64 else t for t in w),
                         G=G, S=S, h=H, res=RES)
    lat = LATTICES["fine"]
    raw = torch.zeros((1, lat.nt, lat.ny, lat.nx + 1), dtype=torch.int32)
    packed = torch.zeros((1, 2, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="raw"):
        PK.score_reduce(raw, _t(np.array([3], np.int32)), w[7], w[7], packed, 0, lat,
                        G=G, res=RES, penalize=False)
    grid = torch.zeros((1, S, S), dtype=torch.uint8)
    with pytest.raises(ValueError, match="center"):
        PK.lattice_window_sum(grid, w[0][:, 0], w[1][:, 0], _t(np.array([3], np.int32)),
                              w[7][:, :2], w[7], w[9], lat, G=G, res=RES)
    with pytest.raises(TypeError, match="q: expected torch.uint8"):
        PK.lattice_window_sum(grid.int(), w[0][:, 0], w[1][:, 0], _t(np.array([3], np.int32)),
                              w[7], w[7], w[9], lat, G=G, res=RES)
    assert not lib.calls


def test_cuda_program_kernels_without_a_card_raise(monkeypatch):
    """No card and no nvcc here: a CUDA tensor's world_scatter and
    lattice_window_sum raise at the kernels' build, and never run their
    twins."""
    monkeypatch.setattr(PK, "_on_cuda", lambda *ts: True)
    for name in ("world_scatter_ref", "lattice_window_sum_ref"):
        monkeypatch.setattr(PK, name, lambda *a, **k: pytest.fail("twin ran"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_library_path", lambda *a: _build.BUILD_DIR / "absent.so")
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    inp = _world_inputs(12, 1, 2, 4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        PK.world_scatter(*(_t(inp[k]) for k in WORLD_KEYS), G=G, S=S, h=H, res=RES)
    q, qlx, qly, n_q, center, job, sub = _lattice_case(12, 1, 8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        PK.lattice_window_sum(_t(q), _t(qlx), _t(qly), _t(n_q), _t(center), _t(job), _t(sub),
                              LATTICES["coarse"], G=G, res=RES)


def test_wrappers_dispatch_only_by_device():
    """Each wrapper takes its twin only on the CPU, first thing, with no
    try / except; it counts a launch through kernels._count after the
    library call."""
    tree = ast.parse(inspect.getsource(PK))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    for name in PK.KERNELS:
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
        first = fn.body[1]
        assert isinstance(first, ast.If) and ast.unparse(first.test).startswith("not _on_cuda(")
        assert ast.unparse(first.body[0]).startswith(f"return {name}_ref(")
        rest = ast.unparse(ast.Module(body=fn.body[2:], type_ignores=[]))
        assert "_ref(" not in rest and f"K._count('{name}')" in rest
        assert rest.index(f"yag_{name}(") < rest.index(f"K._count('{name}')")


def test_program_kernels_name_what_they_replace():
    """match_program.cu is built with the other sources, its entry points
    are declared, and every "file:line" a kernel replaces is the JAX line
    it stands for."""
    assert "match_program.cu" in {p.name for p in _build._sources()[0]}
    assert "program_math.cuh" in {p.name for p in _build._sources()[1]}
    for name in ("yag_world_scatter", "yag_lattice_window_sum", "yag_score_reduce"):
        assert name in _build._SIGNATURES
    text = "".join(p.read_text() for p in _build._sources()[0])
    for name in ("yag_world_cells", "yag_lattice_cells", "world_cells_kernel",
                 "lattice_cells_kernel"):
        assert name not in _build._SIGNATURES and name not in text
    assert set(PK.KERNELS) == set(PK.LAUNCHES) and not set(PK.KERNELS) & set(K.KERNELS)
    starts = {"yag_slam_tpu/matching/pallas_kernels.py:931": "def scatter_occupancy_pallas(",
              "yag_slam_tpu/matching/pallas_kernels.py:578": "def score_windows_pallas(",
              "yag_slam_tpu/matching/matcher.py:661": "pc = jnp.cos(",
              "yag_slam_tpu/matching/matcher.py:666": "keep = C.keep_mask_for_viewpoint(",
              "yag_slam_tpu/matching/matcher.py:722": "qx = jnp.where(",
              "yag_slam_tpu/matching/matcher.py:792": "jax.vmap(C.reduce_best_pose)",
              "yag_slam_tpu/matching/matcher.py:803": "jax.vmap(C.reduce_best_pose)",
              "yag_slam_tpu/matching/correlation.py:109": "def keep_mask_for_viewpoint(",
              "yag_slam_tpu/matching/correlation.py:132": "def world_to_grid_idx(",
              "yag_slam_tpu/matching/correlation.py:573": "def _lattice_penalty(",
              "yag_slam_tpu/matching/correlation.py:697": "gx0 = world_to_grid_idx(",
              "yag_slam_tpu/matching/correlation.py:743": "out = raw.astype(dtype)",
              "yag_slam_tpu/matching/correlation.py:1014": "def reduce_best_pose("}
    named = set()
    for info in PK.KERNELS.values():
        assert os.path.isfile(os.path.join(REPO, info["source"]))
        for ref in info["replaces"]:
            path, line = ref.rsplit(":", 1)
            text = open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1]
            assert text.strip().startswith(starts[ref]), ref
            named.add(ref)
    assert named == set(starts)


def test_program_kernels_import_no_jax():
    """The module imports neither JAX nor the JAX package, by its source
    and in a fresh interpreter."""
    tree = ast.parse(inspect.getsource(PK))
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "yag_slam_tpu")}
    code = ("import sys; import yag_slam_tpu_torch.matching.program_kernels; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'yag_slam_tpu')))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
