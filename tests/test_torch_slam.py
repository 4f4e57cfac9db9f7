"""The port's SLAM slice against the JAX package's on the CPU, float64.

The 2-lap square sequence of test_slam_e2e goes through both GraphSlams
(the JAX one with window-path matchers, see test_torch_matcher): vertex,
edge and loop-closure counts must be identical and every pose within
1e-6 m / 1e-6 rad.  Also: occupancy images, checkpoint bytes, and a run
carried over from the JAX package mid-way.
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.mapping.occupancy import create_occupancy_grid as jax_grid
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu.slam.graph_slam import GraphSlam as JaxGraphSlam
from yag_slam_tpu_torch.interop import graph_slam_from_state
from yag_slam_tpu_torch.mapping.occupancy import create_occupancy_grid
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

from test_slam_e2e import LOOP_CFG, SEQ_CFG, build_sequence

POSE_TOL = 1e-6
SLAM_KW = dict(scan_buffer_len=10, loop_search_dist=2.0,
               loop_search_min_chain_size=5, min_response_coarse=0.35,
               min_response_fine=0.45)


def jax_slam():
    mk = lambda cfg, loop: JaxMatcher(  # noqa: E731
        cfg, loop=loop, dtype=np.float64, use_patch=True, use_pallas=False)
    return JaxGraphSlam(mk(SEQ_CFG, False), mk(LOOP_CFG, True), **SLAM_KW)


def torch_slam():
    mk = lambda cfg, loop: CorrelativeScanMatcher(  # noqa: E731
        cfg, loop=loop, device="cpu", dtype=torch.float64)
    return GraphSlam(mk(SEQ_CFG, False), mk(LOOP_CFG, True), **SLAM_KW)


def _poses(slam):
    return np.array([[v.obj.corrected_pose.x, v.obj.corrected_pose.y,
                      v.obj.corrected_pose.euler[-1]]
                     for v in slam.graph.vertices])


def _assert_same_graph(a, b, same_stats=True):
    assert len(b.graph.vertices) == len(a.graph.vertices)
    assert len(b.graph.edges) == len(a.graph.edges)
    if same_stats:
        assert b.stats["loop_closures"] == a.stats["loop_closures"]
    assert ([(e.source.obj.num, e.target.obj.num) for e in b.graph.edges]
            == [(e.source.obj.num, e.target.obj.num) for e in a.graph.edges])
    np.testing.assert_allclose(_poses(b), _poses(a), rtol=0, atol=POSE_TOL)


# the JAX run's state is captured after these many scans
SNAPSHOTS = (60, 70)


@pytest.fixture(scope="module")
def runs():
    gt, odom, scans_a = build_sequence(laps=2)
    _, _, scans_b = build_sequence(laps=2)
    ja, tb = jax_slam(), torch_slam()
    out_a, states = [], {}
    for i, s in enumerate(scans_a):
        if i in SNAPSHOTS:
            states[i] = ja.serialize()
        out_a.append(ja.process_scan(s))
    out_b = [tb.process_scan(s) for s in scans_b]
    return gt, odom, ja, tb, out_a, out_b, states


def test_slice_matches_jax(runs):
    gt, odom, ja, tb, out_a, out_b, _ = runs
    assert tb.stats["loop_closures"] >= 1
    _assert_same_graph(ja, tb)
    for (ra, ca), (rb, cb) in zip(out_a, out_b):
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert bool(ca) == bool(cb)
            assert rb.response == pytest.approx(ra.response, abs=1e-9)
    est = _poses(tb)[:, :2]
    slam_ate = np.sqrt(np.mean(np.sum((est - gt[:, :2]) ** 2, axis=1)))
    odom_ate = np.sqrt(np.mean(np.sum((odom[:, :2] - gt[:, :2]) ** 2, axis=1)))
    assert slam_ate < 0.5 * odom_ate


def test_occupancy_grid_matches_jax(runs):
    _, _, ja, tb, _, _, _ = runs
    scans_a = [v.obj for v in ja.graph.vertices]
    scans_b = [v.obj for v in tb.graph.vertices]
    a = jax_grid(scans_a, 0.05, 5.0)
    b = create_occupancy_grid(scans_b, 0.05, 5.0)
    assert (b.width, b.height) == (a.width, a.height)
    assert b.offset == pytest.approx(a.offset, abs=1e-9)
    np.testing.assert_array_equal(b.image, a.image)
    assert {0, 200, 255} <= set(np.unique(b.image).tolist())
    np.testing.assert_array_equal(tb.make_occupancy_grid(0.05, 5.0).image,
                                  b.image)


def test_checkpoint_bytes_roundtrip(runs, tmp_path):
    """A JAX-package checkpoint loads in the port and re-serializes to the
    identical bytes; the port's own file round trip keeps the graph."""
    _, _, ja, tb, _, _, _ = runs
    blob = ja.binarize()
    restored = GraphSlam.unbinarize(blob, device="cpu", dtype=torch.float64)
    assert restored.binarize() == blob
    path = tmp_path / "map.graph"
    tb.to_file(str(path))
    again = GraphSlam.from_file(str(path), device="cpu", dtype=torch.float64)
    assert again.binarize() == tb.binarize()
    _assert_same_graph(tb, again, same_stats=False)   # stats are not saved


def test_state_carried_over_mid_run(runs):
    """graph_slam_from_state on the JAX run's state after 60 scans; the
    port then processes the next 10 scans and must match the JAX run's
    results and its state after 70."""
    _, _, _, _, out_a, _, states = runs
    a, b = SNAPSHOTS
    _, _, scans = build_sequence(laps=2)
    tb = graph_slam_from_state(states[a], device="cpu", dtype=torch.float64)
    assert tb.loop_matcher.config.resolution == LOOP_CFG["resolution"]
    for i in range(a, b):
        rb, cb = tb.process_scan(scans[i])
        ra, ca = out_a[i]
        assert bool(cb) == bool(ca)
        assert rb.response == pytest.approx(ra.response, abs=1e-9)
    ja_b = graph_slam_from_state(states[b], device="cpu", dtype=torch.float64)
    _assert_same_graph(ja_b, tb, same_stats=False)
    assert any(bool(c) for _, c in out_a[1:a]), "a closure before the hand-over"
