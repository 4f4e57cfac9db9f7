"""The port matcher's meta, scan-set, async and mega paths, against the JAX
package's matcher on the CPU (float64 on both sides).

The JAX matcher is built as in test_torch_matcher.py (use_patch=True,
use_pallas=False): its staged grid build, whose smear is smear_grid_xla,
plus the window-gather scorer.  Response, best pose and covariance agree
within 1e-9.  The meta grid is the port's float32 smear (float32 taps, as
on the card) against the JAX package's float64 smear (float64 taps):
within META_TOL, the float32 rounding of values <= 1.
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu_torch.matching import Scan2DMatcher
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

from test_matching import TEST_CFG, _arc_scan, make_room_scan
from test_matching_extra import CFG as EXTRA_CFG, world_scans

TOL = 1e-9
META_TOL = 1e-6
# smear = resolution / 2 is the smallest smear the config takes; its kernel
# has one tap (half-width h = 0)
H0_CFG = dict(TEST_CFG, smear_deviation=0.01)


def _pair(cfg, return_meta=False, loop=False):
    jm = JaxMatcher(cfg, loop=loop, dtype=np.float64, use_patch=True,
                    use_pallas=False, return_meta=return_meta)
    tm = CorrelativeScanMatcher(cfg, loop=loop, device="cpu",
                                dtype=torch.float64, return_meta=return_meta)
    return jm, tm


def _pose(p):
    return [p.x, p.y, p.euler[-1]]


def _assert_same(a, b, tol=TOL):
    assert b.response == pytest.approx(a.response, abs=tol)
    pa = a.best_pose if isinstance(a.best_pose, list) else [a.best_pose]
    pb = b.best_pose if isinstance(b.best_pose, list) else [b.best_pose]
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        np.testing.assert_allclose(_pose(y), _pose(x), rtol=0, atol=tol)
    np.testing.assert_allclose(b.covariance, a.covariance, rtol=tol, atol=tol)


def _assert_meta(a, b):
    """JAX meta (float64 smear) against the port's (float32 smear)."""
    assert a.meta is not None and b.meta is not None
    assert b.meta["grid"].dtype == np.float64
    assert b.meta["grid"].shape == a.meta["grid"].shape
    np.testing.assert_allclose(b.meta["grid"], a.meta["grid"], rtol=0,
                               atol=META_TOL)
    np.testing.assert_array_equal(b.meta["kernel"], a.meta["kernel"])
    assert b.meta["grid"].max() == 1.0


def _equal(a, b):
    """Identical results (the same program on the same inputs)."""
    assert a.response == b.response
    assert _pose(a.best_pose) == _pose(b.best_pose)
    np.testing.assert_array_equal(a.covariance, b.covariance)


@pytest.fixture(scope="module")
def room():
    base = [make_room_scan(0.0, 0.0, 0.0, seed=1),
            make_room_scan(0.1, 0.02, 0.03, seed=2),
            make_room_scan(0.2, -0.03, 0.06, seed=3)]
    query = make_room_scan(0.13, -0.05, 0.05, seed=4)
    query.corrected_pose = query.odom_pose
    return base, query


@pytest.fixture(scope="module")
def scan_sets():
    """The JAX package's scan-set fixture (test_matching_extra.py): two
    query scans offset by a common (0.07, -0.05) m error, three base scans."""
    base = world_scans([[0.0, 0.0, 0.0], [0.5, 0.1, 0.2], [1.0, 0.2, 0.3]],
                       seed=1)
    queries = world_scans([[0.3, -0.2, 0.1], [0.8, -0.1, 0.2]], seed=2)
    truth = [(q.corrected_pose.x, q.corrected_pose.y) for q in queries]
    for q in queries:
        p = q.corrected_pose
        q.corrected_pose = Transform.from_xyt(p.x + 0.07, p.y - 0.05, p.euler[-1])
    return base, queries, truth


# -- h = 0 -------------------------------------------------------------------

@pytest.mark.parametrize("return_meta", [False, True])
def test_one_tap_smear_matches_jax(room, return_meta):
    """smear = resolution / 2 gives a one-tap kernel (h = 0), which the
    JAX package serves through its staged build."""
    base, query = room
    jm, tm = _pair(H0_CFG, return_meta=return_meta)
    assert tm._half == 0 and len(tm._taps) == 1
    a = jm.match_scan(query, base, True, True)
    b = tm.match_scan(query, base, True, True)
    assert a.response > 0.3
    _assert_same(a, b)
    if return_meta:
        _assert_meta(a, b)
    for a, b in zip(jm.match_many([(query, base), (base[2], base[:2])]),
                    tm.match_many([(query, base), (base[2], base[:2])])):
        _assert_same(a, b)


# -- return_meta ---------------------------------------------------------------

@pytest.mark.parametrize("do_fine", [True, False])
def test_meta_grid_matches_jax(room, do_fine):
    base, query = room
    jm, tm = _pair(TEST_CFG, return_meta=True)
    a = jm.match_scan(query, base, True, do_fine)
    b = tm.match_scan(query, base, True, do_fine)
    _assert_same(a, b)
    _assert_meta(a, b)
    # the grid is the subgrid before quantize and mask: its cells quantize
    # to what the matcher scored
    assert b.meta["grid"].shape[0] in (512, 768, 1024)


def test_meta_after_response_expansion_matches_jax():
    base = [_arc_scan(0.0, 0.0, 0.0)]
    query = _arc_scan(0.0, 0.0, 0.5)
    query.corrected_pose = query.odom_pose
    jm, tm = _pair(TEST_CFG, return_meta=True)
    a = jm.match_scan(query, base, False, True)
    b = tm.match_scan(query, base, False, True)
    assert a.response > 0.0
    _assert_same(a, b)
    _assert_meta(a, b)


def test_meta_path_gives_the_plain_results(room):
    """The staged build scores the same quantized grid: results equal the
    matcher without meta; match_many carries no meta."""
    base, query = room
    tm_meta = CorrelativeScanMatcher(TEST_CFG, device="cpu", dtype=torch.float64,
                                     return_meta=True)
    tm = CorrelativeScanMatcher(TEST_CFG, device="cpu", dtype=torch.float64)
    a, b = tm.match_scan(query, base), tm_meta.match_scan(query, base)
    _equal(a, b)
    assert a.meta is None and b.meta is not None
    jobs = [(query, base), (base[2], base[:2])]
    for a, b in zip(tm.match_many(jobs), tm_meta.match_many(jobs)):
        _equal(a, b)
        assert b.meta is None


# -- scan sets -------------------------------------------------------------------

@pytest.mark.parametrize("penalty", [False, True])
def test_match_scan_sets_matches_jax(scan_sets, penalty):
    base, queries, truth = scan_sets
    jm, tm = _pair(EXTRA_CFG, return_meta=not penalty)
    a = jm.match_scan_sets(queries, base, penalty=penalty, do_fine=True)
    b = tm.match_scan_sets(queries, base, penalty=penalty, do_fine=True)
    _assert_same(a, b)
    assert isinstance(b.best_pose, list) and len(b.best_pose) == 2
    if penalty:
        assert b.meta is None
    else:
        _assert_meta(a, b)
        assert b.response > 0.4
        for bp, (tx, ty) in zip(b.best_pose, truth):
            assert abs(bp.x - tx) < 0.05 and abs(bp.y - ty) < 0.05
    # the widened point cap is kept, and the library holds every base scan
    # and the dummy query at it
    assert tm._point_cap == jm._point_cap
    assert tm.library.P == tm._point_cap


def test_match_scan_sets_rejects_empty(scan_sets):
    base, queries, _ = scan_sets
    tm = CorrelativeScanMatcher(EXTRA_CFG, device="cpu")
    with pytest.raises(ValueError):
        tm.match_scan_sets([], base)
    with pytest.raises(ValueError):
        tm.match_scan_sets(queries, [])


# -- async, mega, capacities ---------------------------------------------------------

def _jobs(room):
    base, query = room
    far = _arc_scan(0.0, 0.0, 0.5)      # needs response expansion
    far.corrected_pose = far.odom_pose
    return [(query, base), (base[2], base[:2]), (far, [_arc_scan(0.0, 0.0, 0.0)]),
            (make_room_scan(-0.1, 0.1, -0.04, seed=9), base[1:]),
            (query, base[:1])]


def test_match_many_mega_equals_match_many(room):
    jobs = _jobs(room)
    tm = CorrelativeScanMatcher(TEST_CFG, device="cpu", dtype=torch.float64)
    want = tm.match_many(jobs)
    for chunk in (2, 16):
        got = tm.match_many_mega(jobs, chunk=chunk)
        assert len(got) == len(jobs)
        for a, b in zip(want, got):
            _equal(a, b)
    assert tm.match_many_mega([]) == []


def test_match_many_mega_matches_jax(room):
    jobs = _jobs(room)
    jm, tm = _pair(TEST_CFG)
    for a, b in zip(jm.match_many_mega(jobs, chunk=2),
                    tm.match_many_mega(jobs, chunk=2)):
        _assert_same(a, b)


def test_async_handles_equal_blocking_calls(room):
    base, query = room
    jobs = _jobs(room)
    tm = CorrelativeScanMatcher(TEST_CFG, device="cpu", dtype=torch.float64,
                                return_meta=True)
    h1 = tm.match_scan_async(query, base)
    h2 = tm.match_many_async(jobs)          # in flight together
    r1 = h1.result()
    assert h1.result() is r1                # assembled once
    _equal(r1, tm.match_scan(query, base))
    np.testing.assert_array_equal(r1.meta["grid"], tm.match_scan(query, base).meta["grid"])
    for a, b in zip(h2.result(), tm.match_many(jobs)):
        _equal(a, b)
    empty = tm.match_many_async([])
    assert empty.result() == [] and tm.match_many([]) == []
    with pytest.raises(ValueError):
        tm.match_scan_async(query, [])


def test_capacities_and_alias(room):
    base, query = room
    assert Scan2DMatcher is CorrelativeScanMatcher
    tm = Scan2DMatcher(TEST_CFG, device="cpu", dtype=torch.float64,
                       point_capacity=1024, base_capacity=4)
    jm = JaxMatcher(TEST_CFG, dtype=np.float64, use_patch=True, use_pallas=False,
                    point_capacity=1024, base_capacity=4)
    _assert_same(jm.match_scan(query, base), tm.match_scan(query, base))
    assert tm.library.P == 1024
    with pytest.raises(ValueError, match="base_capacity"):
        tm.match_scan(query, base * 2)
