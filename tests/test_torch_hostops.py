"""The port's host ops (``native/hostops.cpp`` through ``native``) against
their numpy / Python twins, against the JAX package's Python path and
against the JAX package's own ``hostops.cpp``, built here as the CPython
extension setup.py makes of it; the matcher and a CPU tour on the native
path; a failed build raises.  Every test runs on the CPU: both libraries
build with the host compiler."""
import importlib.util
import subprocess
import sysconfig
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest
import torch

import yag_slam_tpu.native as jax_native
from yag_slam_tpu.core import scan as jax_scan
from yag_slam_tpu.io import carmen as jax_carmen
from yag_slam_tpu.matching import correlation as jax_corr
from yag_slam_tpu_torch import _build, native
from yag_slam_tpu_torch.core import scan
from yag_slam_tpu_torch.io import carmen, simulator
from yag_slam_tpu_torch.io.benchmark import generate_benchmark_log
from yag_slam_tpu_torch.matching import correlation
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

REPO = Path(__file__).resolve().parent.parent
# setup.py's flags for the JAX package's extension
JAX_EXT_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# small matcher configs for the CPU runs (grids of a few hundred cells)
SEQ = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 0.5, "smear_deviation": 0.05}
LOOP = {"range_threshold": 5.0, "resolution": 0.1, "search_size": 2.0, "smear_deviation": 0.1}


@pytest.fixture(scope="module")
def tour(tmp_path_factory):
    """The building tour's CARMEN log (413 scans of 180 beams)."""
    log, _, n = generate_benchmark_log(str(tmp_path_factory.mktemp("tour") / "tour.clf"),
                                       step=0.4, laps=1, n_beams=180, seed=0)
    return log, n


@pytest.fixture(scope="module")
def jax_ext(tmp_path_factory):
    """The JAX package's hostops.cpp compiled as its CPython extension into
    a temporary directory, with setup.py's flags, and imported."""
    out = tmp_path_factory.mktemp("jax_ext") / ("_hostops" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run([_build.find_cxx(), *JAX_EXT_FLAGS, f"-I{sysconfig.get_paths()['include']}",
                    "-o", str(out), str(REPO / "yag_slam_tpu" / "native" / "hostops.cpp")],
                   check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location("_hostops", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_python(monkeypatch):
    """The JAX package's Python path, whatever its build."""
    monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)


@pytest.fixture
def jax_extension(monkeypatch, jax_ext):
    """The JAX package's native path, on the extension built here."""
    monkeypatch.setattr(jax_native, "_hostops", jax_ext)
    monkeypatch.setattr(jax_native, "HAVE_NATIVE", True)


def _ranges(case, tour_log):
    """(ranges, min_angle, angle_increment): seeded 360-beam scans with 10 %
    NaN and ranges past the 20 m threshold, or the tour's scan 60."""
    if case == "tour":
        rec = carmen.load_carmen_log_ref(tour_log)[60]
        return np.asarray(rec.ranges), rec.min_angle, rec.angle_increment
    rng = np.random.default_rng(case)
    r = rng.uniform(0.0, 30.0, 360)
    r[rng.uniform(size=360) < 0.1] = np.nan
    return r, rng.uniform(-np.pi, 0.0), rng.uniform(0.001, 2 * np.pi / 360)


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, "tour"])
def test_compact_beams_bit_equal_to_the_twins(tour, jax_python, case):
    r, min_angle, inc = _ranges(case, tour[0])
    args = (r, min_angle, inc, 20.0, 512)
    got = scan.beam_points_padded(*args)
    assert got[2] == np.count_nonzero(~(np.isnan(r) | (r > 20.0))) > 0
    assert not got[0][got[2]:].any() and not got[1][got[2]:].any()
    _equal(got, scan.beam_points_padded_ref(*args))
    _equal(got, jax_scan.beam_points_padded(*args))
    _equal(native.compact_beams(*args), got)


def _walk(n, seed=1):
    walk = np.cumsum(np.random.default_rng(seed).uniform(0.0, 0.12, (n + 7, 2)), axis=0)
    return walk[:, 0], walk[:, 1]          # longer than n: only n are read


@pytest.mark.parametrize("n", [0, 1, 2, 300])
def test_segment_runs_bit_equal_to_the_twins(jax_python, n):
    px, py = _walk(n)
    got = correlation.segment_validation_runs(px, py, n)
    assert [a.dtype for a in got] == [np.int32, np.int32, np.bool_]
    _equal(got, correlation.segment_validation_runs_ref(px, py, n))
    _equal(got, jax_corr.segment_validation_runs(px, py, n))
    if n == 300:
        assert 0 < got[2].sum() < n


def test_segment_runs_at_the_boundary(jax_python):
    """A point exactly 0.2 m from the anchor stays in the run (the test is
    > 0.2**2); the next one past it ends the run there."""
    px = np.array([0.0, 0.1, 0.2, 0.3, 0.32, 0.34])
    py = np.zeros_like(px)
    assert (px[0] - px[2]) ** 2 == 0.2 ** 2
    anchor, term, has = got = correlation.segment_validation_runs(px, py, len(px))
    np.testing.assert_array_equal(has, [False, True, True, True, False, False])
    np.testing.assert_array_equal(term[:4], [0, 3, 3, 3])
    np.testing.assert_array_equal(anchor[:4], [0, 0, 0, 0])
    _equal(got, correlation.segment_validation_runs_ref(px, py, len(px)))
    _equal(got, jax_corr.segment_validation_runs(px, py, len(px)))


def _log_lines(fmt, rng, n_scans=6, n=90):
    lines = []
    for i in range(n_scans):
        vals = " ".join(f"{v:.3f}" for v in rng.uniform(0.1, 20.0, n))
        pose = " ".join(f"{v:.6f}" for v in (0.1 * i, -0.2 * i, 0.05 * i) * 2)
        if fmt == "flaser":
            lines.append(f"FLASER {n} {vals} {pose} {100.0 + i:.6f} host {1.0 + i:.6f}")
        else:
            rem = " ".join(f"{v:.2f}" for v in rng.uniform(0.0, 1.0, 3 * i))
            lines.append(f"ROBOTLASER1 0 -1.570796 3.141593 0.034907 81.900000 0.01 "
                         f"{i % 2} {n} {vals} {3 * i} {rem} {pose} 0.2 0.05 0.5 0.3 0.0 "
                         f"{200.0 + i:.6f} host {1.0 + i:.6f}")
    lines.insert(2, "ODOM 1.0 2.0 0.3 0.0 0.0 0.0 5.0 host 5.0")
    return lines


def _same_scans(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a.ranges, np.ndarray) and a.ranges.dtype == np.float64
        np.testing.assert_array_equal(a.ranges, np.asarray(b.ranges, dtype=np.float64))
        assert astuple(a)[1:] == astuple(b)[1:]


@pytest.mark.parametrize("fmt", ["flaser", "robotlaser1"])
def test_parse_carmen_equals_the_python_parser(tmp_path, jax_python, fmt):
    """Both formats, remissions included; max_scans None and 0 read every
    scan, 3 the first three."""
    path = tmp_path / "log.clf"
    path.write_text("\n".join(_log_lines(fmt, np.random.default_rng(2))) + "\n")
    for max_scans in (None, 0, 3):
        got = carmen.load_carmen_log(path, max_scans)
        assert len(got) == (3 if max_scans else 6)
        _same_scans(got, carmen.load_carmen_log_ref(path, max_scans))
        _same_scans(got, jax_carmen.load_carmen_log(path, max_scans))
        _same_scans(native.parse_carmen(str(path), max_scans), got)


# lines the JAX package's Python parser raises on and its native one skips
MALFORMED = [
    "FLASER 3 1.0 2.0",
    "FLASER 0",
    "FLASER abc 1.0",
    "ROBOTLASER1 0 -1.57 3.14 0.01 80.0 0.01 0 2 1.0",
    "ROBOTLASER1 0 -1.57 3.14 0.01 80.0 0.01 0 2 1.0 2.0 5 0.1 0.2",
    "ROBOTLASER1 0 -1.57 3.14",
]


def test_port_equals_the_jax_extension(tmp_path, tour, jax_extension):
    """The port's C ABI and the JAX package's CPython extension give the
    same bits for every op, malformed log lines included (both skip
    them; the Python parsers raise)."""
    for case in (0, 1, "tour"):
        r, min_angle, inc = _ranges(case, tour[0])
        got = native.compact_beams(r, min_angle, inc, 20.0, 512)
        _equal(got, jax_native.compact_beams(r, min_angle, inc, 20.0, 512))
        _equal(native.segment_runs(*got), jax_native.segment_runs(*got))
    lines = _log_lines("robotlaser1", np.random.default_rng(4))
    for i, bad in enumerate(MALFORMED):
        lines.insert(2 * i, bad)
    path = tmp_path / "log.clf"
    path.write_text("\n".join(lines + ["", "FLASER 2 1.0 2.0 0 0 0 0 0 0"]) + "\n")
    got = carmen.load_carmen_log(path)
    assert len(got) == 7 and got[-1].timestamp == 0.0
    _same_scans(got, jax_native.parse_carmen(str(path)))
    _same_scans(carmen.load_carmen_log(path, 2), jax_native.parse_carmen(str(path), 2))
    with pytest.raises((ValueError, ZeroDivisionError)):
        carmen.load_carmen_log_ref(path)
    _same_scans(carmen.load_carmen_log(tour[0]), jax_native.parse_carmen(tour[0]))
    # a count no line can hold: the JAX extension would try to allocate it,
    # the port skips the line unread
    path.write_text("FLASER 99999999999999 1.0 2.0\n" + lines[1] + "\n")
    assert len(carmen.load_carmen_log(path)) == 1


def test_refusals(tmp_path):
    """More kept beams than the capacity, a missing log and too few points
    raise as the JAX extension does (ValueError, FileNotFoundError)."""
    r = np.linspace(1.0, 10.0, 200)
    with pytest.raises(ValueError, match="200 valid beams > point capacity 128"):
        scan.beam_points_padded(r, -np.pi, 0.01, 20.0, 128)
    with pytest.raises(FileNotFoundError) as e:
        carmen.load_carmen_log(tmp_path / "missing.clf")
    assert e.value.filename == str(tmp_path / "missing.clf")
    with pytest.raises(ValueError, match="needs 5 points"):
        native.segment_runs(np.zeros(3), np.zeros(3), 5)


def twin_scan_views(scans, cap):
    """native.scan_views composed of the numpy / Python twins."""
    k = len(scans)
    out = dict(lx=np.zeros((k, cap)), ly=np.zeros((k, cap)),
               anchor=np.zeros((k, cap), dtype=np.int32), term=np.zeros((k, cap), dtype=np.int32),
               has_run=np.zeros((k, cap), dtype=bool), n=np.zeros(k, dtype=np.int64))
    for i, s in enumerate(scans):
        lx, ly, n = scan.beam_points_padded_ref(s.ranges, s.min_angle, s.angle_increment,
                                                s.range_threshold, cap)
        out["lx"][i], out["ly"][i], out["n"][i] = lx, ly, n
        runs = correlation.segment_validation_runs_ref(lx, ly, n)
        for f, v in zip(("anchor", "term", "has_run"), runs):
            out[f][i, :n] = v
    return out


def test_matcher_same_with_native_or_twin_views(monkeypatch):
    """tests/test_native.py's full-pipeline check on the port: a match on
    the CPU gives the same bits whether the views came from the native ops
    (one batched call for the match's four new scans) or from their twins."""
    world = simulator.SimWorld.office()

    def run():
        rng = np.random.default_rng(3)
        mk = lambda p: simulator.simulate_scan(world, np.array(p), n_beams=180,  # noqa: E731
                                               range_threshold=5.0, noise=0.004, rng=rng)
        base = [mk([0.2 * i, 0.1, 0.0]) for i in range(3)]
        query = mk([0.15, 0.12, 0.03])
        m = CorrelativeScanMatcher(dict(LOOP, resolution=0.05, smear_deviation=0.05),
                                   loop=True, device="cpu", dtype=torch.float64)
        return m.match_scan(query, base, True, True)

    native.reset_calls()
    a = run()
    assert native.CALLS["scan_views"] == 1
    monkeypatch.setattr(native, "scan_views", twin_scan_views)
    native.reset_calls()
    b = run()
    assert native.CALLS["scan_views"] == 0
    assert a.response == b.response > 0.3
    assert (a.best_pose.x, a.best_pose.y, a.best_pose.euler[-1]) == \
        (b.best_pose.x, b.best_pose.y, b.best_pose.euler[-1])
    np.testing.assert_array_equal(a.covariance, b.covariance)


def test_a_cpu_tour_goes_through_every_op(tour, monkeypatch):
    log, _ = tour
    views_made = []
    batched = native.scan_views
    monkeypatch.setattr(native, "scan_views",
                        lambda scans, cap: views_made.append(len(scans)) or batched(scans, cap))
    native.reset_calls()
    scans = carmen.carmen_to_localized_scans(carmen.load_carmen_log(log, 12),
                                             range_threshold=5.0)
    slam = GraphSlam(CorrelativeScanMatcher(SEQ, device="cpu"),
                     CorrelativeScanMatcher(LOOP, loop=True, device="cpu"))
    for s in scans:
        slam.process_scan(s)
    assert len(slam.graph.vertices) > 1
    assert native.CALLS["parse_carmen"] == 1
    # each scan's view at each point capacity the matchers took (they widen
    # as wider scans arrive) is compacted and segmented once, and cached;
    # the matchers make them in batches, never one op per scan
    views = [k for s in scans for k in s._points_cache if k[0] == "matcher_view"]
    assert len(views) >= len(scans)
    assert sum(views_made) == len(views) and 0 < len(views_made) <= len(views)
    assert native.CALLS["compact_beams"] == native.CALLS["segment_runs"] == 0


def _fresh_build(monkeypatch, tmp_path, source):
    src = tmp_path / "hostops.cpp"
    src.write_text(source)
    monkeypatch.setattr(_build, "HOSTOPS_SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_hostops", None)


@pytest.mark.parametrize("fault,match", [("bad_source", "failed"),
                                         ("no_compiler", "no host C\\+\\+ compiler")])
def test_failed_build_raises(monkeypatch, tmp_path, fault, match):
    """No fallback: without the library the first view and the first log
    load raise."""
    if fault == "bad_source":
        _fresh_build(monkeypatch, tmp_path, "this is not C++\n")
    else:
        _fresh_build(monkeypatch, tmp_path, _build.HOSTOPS_SOURCE.read_text())
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    s = scan.LocalizedRangeScan(np.ones(20), -1.0, 1.0, 0.1, 0.0, 30.0, 5.0, 0, 0, 0)
    with pytest.raises(RuntimeError, match=match):
        s.local_points_padded(128)
    with pytest.raises(RuntimeError, match=match):
        carmen.load_carmen_log(tmp_path / "hostops.cpp")
    assert not native.available()


def test_library_is_built_with_the_hostops_flags():
    """Built from native/hostops.cpp into build/ with HOSTOPS_FLAGS, named
    by a hash of source, flags and compiler; no Python C-API, and no
    -march=native or contraction that would part it from numpy."""
    assert native.available()
    path = _build._hostops_path(_build.find_cxx())
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libyag_hostops_") and path.suffix == ".so"
    assert _build._hostops_path("/another/c++") != path
    assert "-ffp-contract=off" in _build.HOSTOPS_FLAGS
    assert "-march=native" not in _build.HOSTOPS_FLAGS
    src = _build.HOSTOPS_SOURCE.read_text()
    assert "Python.h" not in src and 'extern "C"' in src
