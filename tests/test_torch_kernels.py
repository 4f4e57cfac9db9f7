"""The port's kernel modules against the JAX package on the CPU.

Same numpy-seeded inputs through both; the JAX Pallas kernels run in
interpret mode, the port's wrappers take their plain PyTorch versions
(CPU tensors).  Grids and raw window sums are integers and must be
bit-equal; scaled lattice scores agree to 1e-12 (float64 on both sides).
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.matching import correlation as JC
from yag_slam_tpu_torch.matching import correlation as TC
from yag_slam_tpu_torch.matching import kernels as K


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# -- grid build --------------------------------------------------------------

def _grid_inputs():
    """Inputs of the JAX package's fused-vs-staged test (G=700, S=512,
    out-of-grid points, far-sentinel lanes), with the second job's subgrid
    moved 40 cells past the full grid's high edge so the mask fires."""
    G, S, res = 700, 512, 0.01
    taps = tuple(float(v) for v in JC.gaussian_kernel_1d(res, 0.025))
    h = (len(taps) - 1) // 2
    N, B, P = 2, 2, 128
    rng = np.random.default_rng(11)
    wx = rng.uniform(-1.0, 8.0, (N, B, P))
    wy = rng.uniform(-1.0, 8.0, (N, B, P))
    wx[:, :, -4:] = 1e9
    wy[:, :, -4:] = 1e9
    keep = rng.uniform(size=(N, B, P)) > 0.2
    ox = np.array([0.0, -0.3])
    oy = np.array([0.1, 0.0])
    sox = np.array([0, G - S + 40], dtype=np.int32)
    soy = np.array([2, G - S + 40], dtype=np.int32)
    # occupied cells on the last full-grid column and row of job 1, whose
    # smear would spill past the grid's high edge without the mask
    edge = ox[1] + (G - 1 - np.arange(8)) * res
    wx[1, 0, :8], wy[1, 0, :8] = edge, oy[1] + 600 * res
    wx[1, 1, :8], wy[1, 1, :8] = ox[1] + 600 * res, oy[1] + (G - 1 - np.arange(8)) * res
    keep[1, :, :8] = True
    return dict(G=G, S=S, res=res, taps=taps, h=h, wx=wx, wy=wy, keep=keep,
                ox=ox, oy=oy, sox=sox, soy=soy)


@pytest.fixture(scope="module")
def jax_grids():
    d = _grid_inputs()
    Cpad = ((d["S"] + 2 * d["h"] + 127) // 128) * 128
    args = (d["wx"], d["wy"], d["keep"], d["ox"], d["oy"], d["sox"], d["soy"])
    kw = dict(G=d["G"], S=d["S"], h=d["h"], Cpad=Cpad, res=d["res"],
              taps=d["taps"], interpret=True)
    return d, {
        "fused": JC.build_quantized_grid_fused(*args, **kw),
        "strip_pallas_scatter": JC.build_quantized_grid_strip(
            *args, pallas_scatter=True, **kw),
        "strip_xla_scatter": JC.build_quantized_grid_strip(
            *args, pallas_scatter=False, **kw),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "variant", ["fused", "strip_pallas_scatter", "strip_xla_scatter"])
def test_build_quantized_grid_matches_jax(jax_grids, variant, dtype):
    d, ref = jax_grids
    q = TC.build_quantized_grid(
        _t(d["wx"], dtype), _t(d["wy"], dtype), _t(d["keep"]),
        _t(d["ox"], dtype), _t(d["oy"], dtype), _t(d["sox"]), _t(d["soy"]),
        G=d["G"], S=d["S"], h=d["h"], res=d["res"],
        taps=_t(np.float32(d["taps"])),
    )
    assert q.dtype == torch.uint8 and q.shape == (2, d["S"], d["S"])
    expect = np.asarray(ref[variant].astype(np.float32))
    np.testing.assert_array_equal(q.numpy().astype(np.float32), expect)
    # the overhanging job's cells past the full grid really were masked,
    # and the smear would have reached them
    lim_x = d["G"] - d["sox"][1]
    lim_y = d["G"] - d["soy"][1]
    assert expect[1, :, lim_x:].max() == 0 and expect[1, :, lim_x - 1].max() > 0
    assert expect[1, lim_y:, :].max() == 0 and expect[1, lim_y - 1, :].max() > 0


def test_scatter_cells_matches_jax_pallas_scatter():
    """Port scatter vs build_occupancy_pallas (interpret) on the inputs of
    the JAX package's scatter test; the layouts differ only by their
    padding, so the overlapping (S+2h)^2 window must match cell for cell."""
    G, S, h, res = 451, 512, 5, 0.01
    Cpad = ((S + 2 * h + 127) // 128) * 128
    N, B, P = 2, 2, 64
    rng = np.random.default_rng(7)
    wx = rng.uniform(-1.0, 6.0, (N, B, P))
    wy = rng.uniform(-1.0, 6.0, (N, B, P))
    wx[:, :, -4:] = 1e9
    wy[:, :, -4:] = 1e9
    keep = rng.uniform(size=(N, B, P)) > 0.2
    ox = np.array([0.0, -0.3])
    oy = np.array([0.1, 0.0])
    sox = np.array([0, 3], dtype=np.int32)
    soy = np.array([2, 0], dtype=np.int32)

    ref = np.asarray(JC.build_occupancy_pallas(
        wx, wy, keep, ox, oy, sox, soy, G=G, S=S, h=h, Cpad=Cpad, res=res,
        dtype=np.float64, interpret=True))
    sy, sx = TC.occupancy_cells(
        _t(wx), _t(wy), _t(keep), _t(ox), _t(oy), _t(sox), _t(soy),
        G=G, S=S, h=h, res=res)
    occ = K.scatter_cells(sy, sx, S + 2 * h).numpy()
    row0 = 128 - h   # JAX rows sit at +128, the port's at +h
    window = ref[:, row0:row0 + S + 2 * h, : S + 2 * h]
    np.testing.assert_array_equal(occ.astype(np.float64), window)
    assert occ.sum() > 50   # the window holds real cells


# -- window sum ----------------------------------------------------------------

def _lattice_inputs(stride, n_per_job):
    """Inputs of the JAX package's scorer tests: windows overhanging every
    grid edge, far-sentinel lanes, per-job point counts."""
    G, S, N, res = 451, 512, 2, 0.01
    xy_res = res * stride
    spec = JC.LatticeSpec.from_search(0.0, 0.0, 0.0, 12.5 * xy_res, xy_res,
                                      0.1745, 0.0349)
    rng = np.random.default_rng(11)
    q2d = np.floor(rng.uniform(0, 100, (N, S, S)))
    q2d[:, G:, :] = 0.0
    q2d[:, :, G:] = 0.0
    P = 96
    px = rng.uniform(-1.0, 6.0, (N, P))
    py = rng.uniform(-1.0, 6.0, (N, P))
    for j in range(N):
        px[j, n_per_job[j]:] = 1e9
        py[j, n_per_job[j]:] = 1e9
    n_pts = np.asarray(n_per_job, dtype=np.float64)
    args = (px, py, n_pts, np.array([0.3, 4.2]), np.array([0.2, 4.4]),
            np.array([0.0, 0.4]), np.zeros(N), np.zeros(N),
            np.zeros(N, dtype=np.int32), np.zeros(N, dtype=np.int32))
    kw = dict(spec=spec, xy_size=12.5 * xy_res, xy_res=xy_res, ang_size=0.1745,
              ang_res=0.0349, grid_size=G, grid_res=res, penalize=True)
    return q2d, args, kw, S


@pytest.mark.parametrize("scorer,stride", [
    ("roll", 1), ("roll", 2),
    ("mxu", 1), ("mxu", 2), ("mxu", 3),
    ("patch", 1), ("patch", 2),
])
def test_score_lattice_matches_jax(scorer, stride):
    n_per_job = [96 - 8, 96 - 23] if scorer == "mxu" else [96 - 8, 96 - 8]
    q2d, args, kw, S = _lattice_inputs(stride, n_per_job)
    jkw = dict(kw, sub_size=S, dtype=np.float64)
    if scorer == "roll":
        ref = JC.score_lattice_vmem_batched(q2d, *args, interpret=True,
                                            hybrid=False, **jkw)
    elif scorer == "mxu":
        ref = JC.score_lattice_mxu_batched(q2d, *args, interpret=True, **jkw)
    else:
        ref = JC.score_lattice_patch_batched(q2d, *args, **jkw)
    got = TC.score_lattice(_t(q2d.astype(np.uint8)), *map(_t, args), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)


def test_window_sum_plain_matches_loop():
    """window_sum's plain version against a direct per-point loop, with
    negative starts, reads past S and a per-job point count."""
    rng = np.random.default_rng(3)
    N, S, K_, P, ny, nx, stride = 2, 40, 3, 17, 5, 6, 3
    q = rng.integers(0, 101, (N, S, S)).astype(np.uint8)
    gy0 = rng.integers(-20, S + 5, (N, K_, P)).astype(np.int32)
    gx0 = rng.integers(-20, S + 5, (N, K_, P)).astype(np.int32)
    n_pts = np.array([P, 9], dtype=np.int32)
    want = np.zeros((N, K_, ny, nx), dtype=np.int64)
    for n in range(N):
        for k in range(K_):
            for p in range(n_pts[n]):
                for j in range(ny):
                    for i in range(nx):
                        y = gy0[n, k, p] + stride * j
                        x = gx0[n, k, p] + stride * i
                        if 0 <= y < S and 0 <= x < S:
                            want[n, k, j, i] += q[n, y, x]
    got = K.window_sum(_t(q), _t(gy0), _t(gx0), _t(n_pts), ny, nx, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_world_to_grid_idx_clamps_far_lanes():
    """Far-sentinel lanes (~1e11 cells) clamp before the int32 cast."""
    w = torch.tensor([1e9, -1e9, 0.015, 0.025, -0.005], dtype=torch.float64)
    g = TC.world_to_grid_idx(w, 0.0, 0.01)
    assert g.dtype == torch.int32
    assert g.tolist() == [2**30, -(2**30), 2, 2, 0]   # half to even
