"""The port's CorrelativeScanMatcher against the JAX package's on the CPU.

The JAX matcher is built with use_patch=True, use_pallas=False in float64:
its staged grid build plus score_lattice_patch_batched, whose index math
(round once at the lattice origin, then step by the integer stride) is the
one the port's window-sum kernel shares.  Per match, response, best pose
and covariance agree within 1e-9.
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

from test_matching import TEST_CFG, _arc_scan, make_room_scan

TOL = 1e-9


def _pair(cfg, loop=False):
    jm = JaxMatcher(cfg, loop=loop, dtype=np.float64, use_patch=True,
                    use_pallas=False)
    tm = CorrelativeScanMatcher(cfg, loop=loop, device="cpu",
                                dtype=torch.float64)
    return jm, tm


def _assert_same(a, b):
    assert b.response == pytest.approx(a.response, abs=TOL)
    pa, pb = a.best_pose, b.best_pose
    np.testing.assert_allclose([pb.x, pb.y, pb.euler[-1]],
                               [pa.x, pa.y, pa.euler[-1]], rtol=0, atol=TOL)
    np.testing.assert_allclose(b.covariance, a.covariance, rtol=TOL, atol=TOL)
    assert b.meta is None


@pytest.fixture(scope="module")
def room():
    base = [make_room_scan(0.0, 0.0, 0.0, seed=1),
            make_room_scan(0.1, 0.02, 0.03, seed=2),
            make_room_scan(0.2, -0.03, 0.06, seed=3)]
    query = make_room_scan(0.13, -0.05, 0.05, seed=4)
    query.corrected_pose = query.odom_pose
    return base, query


@pytest.mark.parametrize("penalty", [True, False])
@pytest.mark.parametrize("do_fine", [True, False])
def test_match_scan_matches_jax(room, penalty, do_fine):
    base, query = room
    jm, tm = _pair(TEST_CFG)
    a = jm.match_scan(query, base, penalty, do_fine)
    b = tm.match_scan(query, base, penalty, do_fine)
    assert a.response > 0.3
    _assert_same(a, b)


def test_match_many_matches_jax(room):
    base, query = room
    jobs = [(query, base), (query, base[:1]), (base[2], base[:2]),
            (make_room_scan(-0.1, 0.1, -0.04, seed=9), base[1:])]
    jm, tm = _pair(TEST_CFG)
    ra = jm.match_many(jobs, penalty=True, do_fine=True)
    rb = tm.match_many(jobs, penalty=True, do_fine=True)
    assert len(ra) == len(rb) == len(jobs)
    for a, b in zip(ra, rb):
        _assert_same(a, b)


def test_response_expansion_matches_jax():
    """Queries whose yaw guess lies outside the coarse window score exactly
    0 and are recovered only through the widened retries; one job needs
    none.  Both match_many (batched retries) and match_scan."""
    base = [_arc_scan(0.0, 0.0, 0.0)]
    queries = [_arc_scan(0.0, 0.0, 0.45), _arc_scan(0.0, 0.0, 0.5),
               _arc_scan(0.0, 0.0, 0.02)]
    for q in queries:
        q.corrected_pose = q.odom_pose
    jm, tm = _pair(TEST_CFG)
    jobs = [(q, base) for q in queries]
    ra = jm.match_many(jobs, penalty=False, do_fine=False)
    rb = tm.match_many(jobs, penalty=False, do_fine=False)
    for a, b in zip(ra, rb):
        assert a.response > 0.0
        _assert_same(a, b)
    _assert_same(jm.match_scan(queries[1], base, False, True),
                 tm.match_scan(queries[1], base, False, True))


def test_degenerate_zero_response_matches_jax():
    """With expansion off, a zero-response match takes the host fixup of
    the full-lattice tie mean; both packages must report the same pose."""
    cfg = dict(TEST_CFG, use_response_expansion=False)
    base = [_arc_scan(0.0, 0.0, 0.0)]
    query = _arc_scan(0.0, 0.0, 0.5)
    query.corrected_pose = query.odom_pose
    jm, tm = _pair(cfg)
    a = jm.match_scan(query, base, False, True)
    b = tm.match_scan(query, base, False, True)
    assert a.response <= 0.0
    _assert_same(a, b)


def test_karto_penalty_mode_matches_jax(room):
    base, query = room
    cfg = dict(TEST_CFG, use_karto_penalties=True,
               angle_variance_penalty=0.02, distance_variance_penalty=0.05)
    jm, tm = _pair(cfg)
    a = jm.match_scan(query, base, True, True)
    b = tm.match_scan(query, base, True, True)
    assert a.response > 0.3
    _assert_same(a, b)


def test_loop_preset_matches_jax(room):
    """The loop-matcher preset (res 0.05, 4 m window) with the test range."""
    base, query = room
    jm, tm = _pair({"range_threshold": 5.0}, loop=True)
    _assert_same(jm.match_scan(query, base, False, False),
                 tm.match_scan(query, base, False, False))


def test_library_slots_shared_by_scan_copies(room):
    """A scan copy (the loop-closure temp scan) reuses its original's
    library slot, and every stored view holds its scan's point count."""
    base, query = room
    _, tm = _pair(TEST_CFG)
    tm.match_scan(query, base)
    n_slots = len(tm.library._scans)
    tm.match_scan(query.copy(), base)
    assert len(tm.library._scans) == n_slots
    lib = tm.library.fields
    for s in base + [query]:
        slot = tm.library._slots[id(s._points_cache)]
        assert int(lib["n"][slot]) == s.num_valid_beams


def test_library_grows_and_rewidens():
    """Past its initial slots the library doubles and keeps every stored
    view; a wider point capacity re-uploads every scan at the new width."""
    _, tm = _pair(TEST_CFG)
    scans = [make_room_scan(0.01 * i, 0.0, 0.0, n_beams=90, seed=i)
             for i in range(130)]
    lib = tm.library
    slots = lib.ensure(scans, 128)
    assert list(slots) == list(range(130)) and lib.K_cap == 256
    wide = make_room_scan(0.0, 0.0, 0.0, n_beams=200, seed=200)
    lib.ensure([wide], 256)
    f = lib.fields
    assert f["lx"].shape == (256, 256)
    for s, slot in zip(scans + [wide], list(slots) + [130]):
        v = s._points_cache[("matcher_view", 256)]
        assert int(f["n"][slot]) == v["n"] == s.num_valid_beams
        np.testing.assert_array_equal(f["lx"][slot].numpy(), v["lx"])
