"""The port's own host modules (core, io, utils.metrics) against the JAX
package's originals on seeded inputs: the copies compute the same values."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

from yag_slam_tpu.core import config as jax_config
from yag_slam_tpu.core import scan as jax_scan
from yag_slam_tpu.core import transform as jax_tf
from yag_slam_tpu.io import benchmark as jax_benchmark
from yag_slam_tpu.io import carmen as jax_carmen
from yag_slam_tpu.io import simulator as jax_sim
from yag_slam_tpu.matching import correlation as jax_corr
from yag_slam_tpu.utils import metrics as jax_metrics
from yag_slam_tpu_torch.core import config, scan, transform
from yag_slam_tpu_torch.io import benchmark, carmen, simulator
from yag_slam_tpu_torch.matching import correlation
from yag_slam_tpu_torch.utils import metrics


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-50.0, 50.0, (n, 3))
    p[:, 2] = rng.uniform(-np.pi, np.pi, n)
    p[:4, 2] = [np.pi, -np.pi, np.pi - 1e-12, 0.0]   # wrap boundary
    return p


@pytest.mark.parametrize("fmt", ["flaser", "robotlaser1"])
def test_generate_benchmark_log_equals_jax(tmp_path, fmt):
    """Same log bytes, ground truth, parsed records and scans."""
    kw = dict(step=0.4, laps=1, n_beams=180, seed=0, fmt=fmt)
    log, gt, n = benchmark.generate_benchmark_log(str(tmp_path / "port.clf"), **kw)
    jlog, jgt, jn = jax_benchmark.generate_benchmark_log(str(tmp_path / "jax.clf"), **kw)
    assert n == jn == 413
    with open(log, "rb") as a, open(jlog, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(np.loadtxt(gt), np.loadtxt(jgt))
    recs, jrecs = carmen.load_carmen_log(log), jax_carmen.load_carmen_log(jlog)
    assert len(recs) == len(jrecs) == n
    # the native parser gives float64 ranges where the Python one gives a list
    for a, b in zip(recs, jrecs):
        assert a.ranges.dtype == np.float64
        np.testing.assert_array_equal(a.ranges, np.asarray(b.ranges))
        assert astuple(a)[1:] == astuple(b)[1:]
    refs = carmen.load_carmen_log_ref(log)
    assert all(astuple(a) == astuple(b) for a, b in zip(refs, jrecs))
    scans = carmen.carmen_to_localized_scans(recs[:50])
    jscans = jax_carmen.carmen_to_localized_scans(jrecs[:50])
    for s, j in zip(scans, jscans):
        assert isinstance(s, scan.LocalizedRangeScan)
        np.testing.assert_array_equal(s.ranges, j.ranges)
        assert s.odom_pose.quaternion == j.odom_pose.quaternion
        assert s.odom_pose.position == j.odom_pose.position
        for a, b in zip(s.local_points_padded(256), j.local_points_padded(256)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_algebra_equals_jax(seed):
    p, q = _poses(seed), _poses(seed + 100)
    for a, b in zip(p, q):
        ta, tb = transform.Transform.from_xyt(*a), transform.Transform.from_xyt(*b)
        ja, jb = jax_tf.Transform.from_xyt(*a), jax_tf.Transform.from_xyt(*b)
        for got, want in ((ta + tb, ja + jb), (ta - tb, ja - jb),
                          (ta.inverse(), ja.inverse())):
            assert got.position == want.position
            assert got.quaternion == want.quaternion
            assert got.euler == want.euler
        # the algebra reads its operands by attribute: mixed operands agree
        mixed = ta + jb
        assert (mixed.position, mixed.quaternion) == ((ja + jb).position,
                                                      (ja + jb).quaternion)


@pytest.mark.parametrize("fn", ["se2_compose", "se2_relative"])
def test_se2_pairs_equal_jax(fn):
    a, b = _poses(3), _poses(4)
    np.testing.assert_array_equal(getattr(transform, fn)(a, b),
                                  getattr(jax_tf, fn)(a, b))
    np.testing.assert_array_equal(getattr(transform, fn)(a[5], b[5]),
                                  getattr(jax_tf, fn)(a[5], b[5]))


def test_se2_unary_ops_equal_jax():
    a = _poses(5)
    np.testing.assert_array_equal(transform.se2_inverse(a), jax_tf.se2_inverse(a))
    np.testing.assert_array_equal(transform.se2_wrap(a[:, 2] * 7.0),
                                  jax_tf.se2_wrap(a[:, 2] * 7.0))
    px, py = np.linspace(-3, 3, 50), np.linspace(2, -2, 50)
    for got, want in zip(transform.se2_apply(a[7], px, py), jax_tf.se2_apply(a[7], px, py)):
        np.testing.assert_array_equal(got, want)
    assert transform.se2_wrap(4.0) == jax_tf.se2_wrap(4.0)


def test_se2_helpers_take_no_tensor():
    """No jax.numpy (or any other array library) branch: tensors are refused."""
    with pytest.raises(TypeError, match="numpy arrays or numbers"):
        transform.se2_compose(torch.zeros(3), np.zeros(3))
    with pytest.raises(TypeError, match="numpy arrays or numbers"):
        transform.se2_compose(np.zeros(3), torch.zeros(3))
    with pytest.raises(TypeError, match="numpy arrays or numbers"):
        transform.se2_wrap(torch.zeros(3))


@pytest.mark.parametrize("cap", [256, 512])
def test_beam_points_and_validation_runs_equal_jax(cap):
    rng = np.random.default_rng(cap)
    ranges = rng.uniform(0.1, 30.0, 360)
    ranges[rng.uniform(size=360) < 0.1] = np.nan
    args = (ranges, -np.pi, np.pi / 180.0, 20.0, cap)
    got, want = scan.beam_points_padded(*args), jax_scan.beam_points_padded(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    xs, ys, n = got
    for a, b in zip(correlation.segment_validation_runs(xs, ys, n),
                    jax_corr.segment_validation_runs(xs, ys, n)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="point capacity"):
        scan.beam_points_padded(ranges, -np.pi, np.pi / 180.0, 40.0, 128)


@pytest.mark.parametrize("loop", [False, True])
def test_make_config_equals_jax(loop):
    d = {"search_size": 0.3, "smear_deviation": 0.07, "___name": "x"}
    assert config.make_config(d, loop).to_dict() == jax_config.make_config(d, loop).to_dict()
    assert config.make_config(None, loop).to_dict() == jax_config.make_config(None, loop).to_dict()
    assert config.REFERENCE_CONFIG_KEYS == jax_config.REFERENCE_CONFIG_KEYS
    with pytest.raises(ValueError, match="Smear deviation"):
        config.make_config({"smear_deviation": 1.0}, loop)


def test_simulator_equals_jax():
    gt = simulator.square_loop_trajectory(side=5.0, step=0.5, laps=2, start=(-2.5, -2.5))
    np.testing.assert_array_equal(gt, jax_sim.square_loop_trajectory(
        side=5.0, step=0.5, laps=2, start=(-2.5, -2.5)))
    odom = simulator.drifted_odometry(gt, yaw_bias=0.003, seed=7)
    np.testing.assert_array_equal(odom, jax_sim.drifted_odometry(gt, yaw_bias=0.003, seed=7))
    s = simulator.simulate_scan(simulator.SimWorld.office(), gt[3], n_beams=250,
                                noise=0.004, rng=np.random.default_rng(3),
                                odom_pose_xyt=odom[3])
    j = jax_sim.simulate_scan(jax_sim.SimWorld.office(), gt[3], n_beams=250,
                              noise=0.004, rng=np.random.default_rng(3),
                              odom_pose_xyt=odom[3])
    np.testing.assert_array_equal(s.ranges, j.ranges)
    assert s.corrected_pose.quaternion == j.corrected_pose.quaternion


def test_metrics_equal_jax():
    rng = np.random.default_rng(9)
    gt = rng.uniform(-10, 10, (80, 2))
    est = gt @ np.array([[0.6, -0.8], [0.8, 0.6]]).T + [1.0, -2.0] \
        + rng.normal(0, 0.05, (80, 2))
    for align in (True, False):
        assert metrics.ate_rmse(est, gt, align) == jax_metrics.ate_rmse(est, gt, align)
    assert metrics.ate_rmse(est, gt) < 0.1 < metrics.ate_rmse(est, gt, align=False)
