"""Localize against a saved map: the port's map conversion, full-grid
build, element-path scorer and match_scan_sets_with_map against the JAX
package on the CPU.

Grids are float32 on both sides (float32 taps) and must be bit-equal.  The
element scorer and the localization run in float64 on both sides and
agree within 1e-12 (lattice scores) and 1e-9 (response, poses,
covariance).
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.mapping import occupancy as JO
from yag_slam_tpu.matching import correlation as JC
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu_torch.mapping import occupancy_grid_map_to_correlation_grid
from yag_slam_tpu_torch.matching import correlation as TC
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

from test_matching_extra import CFG, world_scans

TOL = 1e-9


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def saved_map():
    """The JAX package's localize fixture (test_matching_extra.py): a
    0.05 m occupancy image of four 720-beam scans."""
    map_scans = world_scans(
        [[0.0, 0.0, 0.0], [1.0, 0.5, 1.0], [-1.0, -0.5, -1.0],
         [0.5, -1.0, 2.0]],
        seed=3, n_beams=720,
    )
    return JO.create_occupancy_grid(map_scans, resolution=0.05,
                                    range_threshold=5.0)


def _queries(poses, offset=(0.08, -0.06), seed=4):
    queries = world_scans(poses, seed=seed)
    truth = [(q.corrected_pose.x, q.corrected_pose.y) for q in queries]
    for q in queries:
        p = q.corrected_pose
        q.corrected_pose = Transform.from_xyt(p.x + offset[0], p.y + offset[1],
                                              p.euler[-1])
    return queries, truth


@pytest.mark.parametrize("smear", [0.05, 0.025, 0.1])
def test_map_to_correlation_grid_matches_jax(saved_map, smear):
    """h = 2, 0 and 4 at 0.05 m; bit-equal float32 grids."""
    im = saved_map.image
    want = JO.occupancy_grid_map_to_correlation_grid(im, 0.05, smear)
    got = occupancy_grid_map_to_correlation_grid(im, 0.05, smear, device="cpu")
    assert got.dtype == np.float32 and got.shape == im.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0 and (got == 1.0).sum() == (im == 0).sum()


def test_build_correlation_grid_matches_jax():
    """Full-grid build of random points, some outside the grid."""
    rng = np.random.default_rng(5)
    G, res = 300, 0.02
    wx = rng.uniform(-0.5, 6.5, (3, 100))
    wy = rng.uniform(-0.5, 6.5, (3, 100))
    keep = rng.uniform(size=(3, 100)) > 0.3
    k1 = JC.gaussian_kernel_1d(res, 0.05)
    want = JC.build_correlation_grid(wx, wy, keep, 0.1, -0.2, grid_size=G,
                                     res=res, k1=k1.astype(np.float32),
                                     dtype=np.float32)
    got = TC.build_correlation_grid(_t(wx), _t(wy), _t(keep), 0.1, -0.2,
                                    grid_size=G, res=res,
                                    taps=_t(k1.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.max() == 1.0


@pytest.mark.parametrize("variant", ["plain", "symmetric", "non_symmetric",
                                     "karto", "subgrid"])
def test_score_lattice_element_matches_jax(variant):
    """Per-candidate rounding at a lattice step that is no multiple of the
    cell (0.01 m on 0.05 m cells), far-sentinel lanes, reads off the grid."""
    rng = np.random.default_rng(8)
    G, res = 200, 0.05
    q = np.floor(rng.uniform(0, 100, (G, G)))
    P = 128
    px = rng.uniform(-4.0, 4.0, P)
    py = rng.uniform(-4.0, 4.0, P)
    px[-10:] = 1e9
    py[-10:] = 1e9
    spec = JC.LatticeSpec.from_search(0.0, 0.0, 0.0, 0.25, 0.01, 0.1, 0.01)
    kw = dict(spec=spec, xy_size=0.25, xy_res=0.01, ang_size=0.1, ang_res=0.01,
              grid_size=G, grid_res=res, penalize=variant != "plain")
    if variant == "non_symmetric":
        kw["symmetric"] = False
    if variant == "karto":
        kw["karto_penalties"] = (0.3, 0.35, 0.5, 0.9)
    qgrid = q
    if variant == "subgrid":
        kw.update(sub_size=128, sox=30, soy=50)
        qgrid = q[50:178, 30:158]
    scal = (float(P - 10), 5.03, 4.97, 0.02, 0.013, -0.021)
    want = JC.score_lattice(np.concatenate([qgrid.ravel(), [0.0]]), px, py,
                            *scal, dtype=np.float64, **kw)
    got = TC.score_lattice_element(
        _t(qgrid), _t(px), _t(py), *(torch.tensor(v, dtype=torch.float64) for v in scal),
        **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    assert got[0].max() > 0.1
    best = TC.find_best_pose(
        _t(qgrid), _t(px), _t(py), *(torch.tensor(v, dtype=torch.float64) for v in scal),
        **kw)
    want_best = JC.find_best_pose(
        np.concatenate([qgrid.ravel(), [0.0]]), px, py, *scal, dtype=np.float64, **kw)
    np.testing.assert_allclose(best.numpy(), np.asarray(want_best), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("penalty,do_fine", [(False, True), (True, True),
                                             (False, False)])
def test_match_scan_sets_with_map_matches_jax(saved_map, penalty, do_fine):
    grid = saved_map
    cgrid = JO.occupancy_grid_map_to_correlation_grid(grid.image, 0.05, 0.05)
    port_grid = occupancy_grid_map_to_correlation_grid(grid.image, 0.05, 0.05,
                                                       device="cpu")
    cfg = dict(CFG, resolution=0.05)
    jm = JaxMatcher(cfg, loop=True, dtype=np.float64)
    tm = CorrelativeScanMatcher(cfg, loop=True, device="cpu", dtype=torch.float64)
    queries, truth = _queries([[0.2, 0.1, 0.3], [0.25, 0.1, 0.3]])
    a = jm.match_scan_sets_with_map(cgrid, grid.offset.x, grid.offset.y,
                                    queries, penalty=penalty, do_fine=do_fine)
    b = tm.match_scan_sets_with_map(port_grid, grid.offset.x, grid.offset.y,
                                    queries, penalty=penalty, do_fine=do_fine)
    assert b.response == pytest.approx(a.response, abs=TOL)
    np.testing.assert_allclose(b.covariance, a.covariance, rtol=TOL, atol=TOL)
    assert len(b.best_pose) == len(queries) and b.meta is None
    for pa, pb, (tx, ty) in zip(a.best_pose, b.best_pose, truth):
        np.testing.assert_allclose([pb.x, pb.y, pb.euler[-1]],
                                   [pa.x, pa.y, pa.euler[-1]], rtol=0, atol=TOL)
        assert abs(pb.x - tx) < 0.1 and abs(pb.y - ty) < 0.1
    assert b.response > 0.3


def test_match_scan_sets_with_map_takes_a_tensor_grid(saved_map):
    grid = saved_map
    cgrid = occupancy_grid_map_to_correlation_grid(grid.image, 0.05, 0.05,
                                                   device="cpu")
    tm = CorrelativeScanMatcher(dict(CFG, resolution=0.05), loop=True,
                                device="cpu", dtype=torch.float32)
    queries, _ = _queries([[0.2, 0.1, 0.3]])
    a = tm.match_scan_sets_with_map(cgrid, grid.offset.x, grid.offset.y, queries)
    b = tm.match_scan_sets_with_map(torch.from_numpy(cgrid), grid.offset.x,
                                    grid.offset.y, queries)
    assert a.response == b.response and a.response > 0.3
    with pytest.raises(ValueError):
        tm.match_scan_sets_with_map(cgrid, 0.0, 0.0, [])
