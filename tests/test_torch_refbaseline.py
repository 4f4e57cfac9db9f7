"""The port's reference matcher: ``native/refbaseline.cpp`` built by the host
C++ compiler and loaded with ctypes, held to the float64 numpy oracle
(tests/oracle.py) at the bounds of tests/test_native.py, and
``RefBaselineScanMatcher`` on top of it.  Every test here runs on the CPU:
the library builds with the host compiler at first use."""
import numpy as np
import pytest

from oracle import oracle_match_scan
from test_matching import TEST_CFG
from test_matching import make_room_scan as jax_room_scan
from yag_slam_tpu_torch import _build, native
from yag_slam_tpu_torch.core.scan import LocalizedRangeScan
from yag_slam_tpu_torch.matching import matcher as M
from yag_slam_tpu_torch.matching.refmatcher import RefBaselineScanMatcher


def room_scan(x, y, t, n_beams=180, seed=0):
    """tests/test_matching.py's room scan as the port's LocalizedRangeScan
    (the same ranges: the helper's seeded noise)."""
    s = jax_room_scan(x, y, t, n_beams=n_beams, seed=seed)
    return LocalizedRangeScan(s.ranges, -np.pi, np.pi, 2 * np.pi / n_beams, 0.0, 30.0,
                              5.0, x, y, t)


@pytest.fixture(scope="module")
def room():
    base = [room_scan(0.1 * i, 0.05 * i, 0.02 * i, n_beams=240, seed=i) for i in range(4)]
    query = room_scan(0.17, 0.08, 0.05, n_beams=240, seed=9)
    query.corrected_pose = query.odom_pose
    return query, base


@pytest.mark.parametrize("penalty,do_fine", [(True, True), (True, False), (False, True)])
def test_refbaseline_matches_oracle(room, penalty, do_fine):
    """The C++ baseline is faithful to the reference algorithm (float64
    oracle), at test_native.py's bounds: response and pose 1e-12, xy
    covariance 1e-10, TH (it hangs off the argmax cell, which ulp-level
    sums may move within a score tie) relative 0.25."""
    query, base = room
    r, covar, (x, y, t) = native.refbaseline_match_scan(
        query, base, TEST_CFG, penalty=penalty, do_fine=do_fine)
    qp = query.corrected_pose
    o_resp, (o_x, o_y, o_t), o_cov, _ = oracle_match_scan(
        query.points_local(), (qp.x, qp.y, qp.euler[-1]),
        [s.points() for s in base], TEST_CFG, penalty, do_fine)
    assert r > 0.3
    assert r == pytest.approx(o_resp, abs=1e-12)
    assert (x, y, t) == pytest.approx((o_x, o_y, o_t), abs=1e-12)
    np.testing.assert_allclose(covar[:2, :2], o_cov[:2, :2], rtol=0, atol=1e-10)
    assert covar[2, 2] == pytest.approx(o_cov[2, 2], rel=0.25, abs=1e-6)


def test_thread_count_does_not_change_the_result(room):
    """Each theta column is scored by one worker with the same arithmetic,
    so one thread and eight give the same bits."""
    query, base = room
    a = native.refbaseline_match_scan(query, base, TEST_CFG, n_threads=1)
    b = native.refbaseline_match_scan(query, base, TEST_CFG, n_threads=8)
    assert a[0] == b[0] and a[2] == b[2]
    np.testing.assert_array_equal(a[1], b[1])


def test_library_is_built_by_the_host_compiler():
    """Available here; the library is built from native/refbaseline.cpp
    into build/, named by a hash of the source, CXX_FLAGS, the compiler
    and the host (-march=native binds the binary to the host)."""
    assert native.refbaseline_available()
    path = _build._native_path(_build.find_cxx())
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libyag_native_") and path.suffix == ".so"
    assert _build._native_path("/another/c++") != path
    assert _build.NATIVE_SOURCE.name == "refbaseline.cpp"
    assert "-march=native" in _build.CXX_FLAGS and "-shared" in _build.CXX_FLAGS
    assert "Python.h" not in _build.NATIVE_SOURCE.read_text()


def _fresh_build(monkeypatch, tmp_path, source):
    src = tmp_path / "refbaseline.cpp"
    src.write_text(source)
    monkeypatch.setattr(_build, "NATIVE_SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_native", None)


def test_failed_build_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path, "this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.native_library()
    assert not native.refbaseline_available()
    with pytest.raises(RuntimeError, match="failed"):
        RefBaselineScanMatcher(TEST_CFG)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path, _build.NATIVE_SOURCE.read_text())
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        _build.native_library()


def test_native_error_code_raises(room):
    """A query with no point is refused by the library and raises."""
    _, base = room
    empty = LocalizedRangeScan([np.nan] * 10, -1.0, 1.0, 0.2, 0.0, 30.0, 5.0, 0, 0, 0)
    with pytest.raises(RuntimeError, match="bad argument"):
        native.refbaseline_match_scan(empty, base, TEST_CFG)


def test_matcher_wraps_the_native_match(room):
    query, base = room
    m = RefBaselineScanMatcher(TEST_CFG)
    res = m.match_scan(query, base)
    r, covar, (x, y, t) = native.refbaseline_match_scan(query, base, TEST_CFG)
    assert res.response == r and res.meta is None
    np.testing.assert_array_equal(res.covariance, covar)
    assert (res.best_pose.x, res.best_pose.y, res.best_pose.euler[-1]) == \
        pytest.approx((x, y, t), abs=1e-15)
    assert m.device.type == "cpu"


def test_matcher_match_many_is_match_scan_per_job(room):
    query, base = room
    m = RefBaselineScanMatcher(TEST_CFG, n_threads=2)
    jobs = [(query, base), (base[2], base[:2]), (query, base[1:2])]
    many = m.match_many(jobs, penalty=False, do_fine=True)
    for (q, bs), got in zip(jobs, many):
        want = m.match_scan(q, bs, False, True)
        assert got.response == want.response
        np.testing.assert_array_equal(got.covariance, want.covariance)
        assert got.best_pose.x == want.best_pose.x


def test_matcher_refuses_an_empty_base(room):
    with pytest.raises(ValueError, match="at least one base scan"):
        RefBaselineScanMatcher(TEST_CFG).match_scan(room[0], [])


def test_response_expansion_schedule(monkeypatch, room):
    """A zero returned response widens the coarse angle by 20 degrees per
    retry, at most 3 retries, and stops at the first positive response;
    covariance sanitation then applies."""
    query, base = room
    offsets = []

    def fake(q, bs, cfg, penalty, do_fine, n_threads):
        offsets.append(cfg["coarse_search_angle_offset"])
        r = 0.5 if len(offsets) == 3 else 0.0
        return r, -np.eye(3), (1.0, 2.0, 0.3)

    monkeypatch.setattr(native, "refbaseline_match_scan", fake)
    m = RefBaselineScanMatcher(TEST_CFG)
    res = m.match_scan(query, base)
    base_off = m.config.coarse_search_angle_offset
    assert offsets == pytest.approx([base_off, base_off + M._EXPANSION_STEP,
                                     base_off + 2 * M._EXPANSION_STEP])
    assert res.response == 0.5
    np.testing.assert_array_equal(res.covariance, M.sanitize_covariance(-np.eye(3), m.config))

    def never(q, bs, cfg, penalty, do_fine, n_threads):
        offsets.append(cfg["coarse_search_angle_offset"])
        return 0.0, np.eye(3), (0.0, 0.0, 0.0)

    offsets.clear()
    monkeypatch.setattr(native, "refbaseline_match_scan", never)
    assert m.match_scan(query, base).response == 0.0
    assert len(offsets) == 1 + M._EXPANSION_TRIES

    offsets.clear()
    off = RefBaselineScanMatcher(dict(TEST_CFG, use_response_expansion=False))
    assert off.match_scan(query, base).response == 0.0 and len(offsets) == 1
