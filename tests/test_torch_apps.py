"""The port's application layer (OnlineMapper, ThreadedOnlineMapper, the
offline CLI) on the CPU, the mappers in float64, the CLI in its float32
default; against the JAX package's OnlineMapper where both can run the
same matchers.

The JAX mapper gets window-path matchers (use_patch=True,
use_pallas=False) through its seq_matcher / loop_matcher overrides.  Bar:
the same gating decisions, vertex, edge and closure counts, poses within
1e-6.  The ROS-style map images are rendered from those poses, which agree
to 1e-6 but not to the last bit, so a beam ending on a cell boundary may
flip a cell: at most MAP_FLIPS of the pixels differ.  Rendered from the
same scans, the two packages' occupancy grids are equal.
"""
import os

import numpy as np
import pytest
import torch

from yag_slam_tpu.apps.online import OnlineMapper as JaxOnlineMapper
from yag_slam_tpu.io.benchmark import generate_benchmark_log
from yag_slam_tpu.io.simulator import SimWorld, simulate_scan, square_loop_trajectory
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu_torch.apps import offline_mapper
from yag_slam_tpu_torch.apps.online import (
    DEFAULT_LOOP_CONFIG, DEFAULT_SEQ_CONFIG, OnlineMapper, ThreadedOnlineMapper,
)

from test_apps import SMALL_LOOP, SMALL_SEQ, feed
from test_splicing import make_map_image
from test_torch_slam import _assert_same_graph

# The suite runs several pytest workers side by side; one intra-op thread
# per process keeps torch's per-core OpenMP pools from oversubscribing the
# cores, which slows these tests manyfold.
torch.set_num_threads(1)

MAP_FLIPS = 1e-4

MAPPER_KW = dict(
    seq_config=SMALL_SEQ, loop_config=SMALL_LOOP,
    min_distance=0.4, min_rotation=0.4,
    range_threshold=5.0, loop_search_distance=2.0,
    loop_search_min_chain_size=5,
    min_response_coarse=0.35, min_response_fine=0.45,
)


def port_mapper(**kw):
    return OnlineMapper(device="cpu", dtype=torch.float64, **dict(MAPPER_KW, **kw))


def jax_mapper(**kw):
    mk = lambda cfg, loop: JaxMatcher(  # noqa: E731
        cfg, loop=loop, dtype=np.float64, use_patch=True, use_pallas=False)
    return JaxOnlineMapper(seq_matcher=mk(SMALL_SEQ, False),
                           loop_matcher=mk(SMALL_LOOP, True),
                           **dict(MAPPER_KW, **kw))


def _xyt(p):
    return [p.x, p.y, p.euler[-1]]


@pytest.fixture(scope="module")
def fed():
    """A full lap through both mappers, with map callbacks every 5 scans."""
    maps = {"port": [], "jax": []}
    t = port_mapper(map_callback=lambda im, g: maps["port"].append(im))
    j = jax_mapper(map_callback=lambda im, g: maps["jax"].append(im))
    gt, odom, out_t = feed(t, n_poses=40)
    _, _, out_j = feed(j, n_poses=40)
    return t, j, out_t, out_j, maps, gt


def test_online_mapper_matches_jax(fed):
    t, j, out_t, out_j, maps, _ = fed
    assert [r[0] for r in out_t] == [r[0] for r in out_j]
    assert [bool(r[2]) for r in out_t] == [bool(r[2]) for r in out_j]
    assert sum(r[0] for r in out_t) == len(t.slam.graph.vertices) >= 10
    _assert_same_graph(j.slam, t.slam)
    np.testing.assert_allclose(_xyt(t.map_to_odom()), _xyt(j.map_to_odom()),
                               rtol=0, atol=1e-6)


def test_map_callback_images_match_jax(fed):
    from yag_slam_tpu.mapping.occupancy import create_occupancy_grid as jax_grid
    from yag_slam_tpu_torch.mapping.occupancy import create_occupancy_grid

    t, _, _, _, maps, _ = fed
    assert maps["port"] and len(maps["port"]) == len(maps["jax"])
    for a, b in zip(maps["port"], maps["jax"]):
        assert a.shape == b.shape
        assert (a != b).mean() <= MAP_FLIPS
    assert set(np.unique(maps["port"][-1])) <= {-1, 0, 100}
    scans = [v.obj for v in t.slam.graph.vertices]
    np.testing.assert_array_equal(create_occupancy_grid(scans, 0.05, 12.0, device="cpu").image,
                                  jax_grid(scans, 0.05, 12.0).image)


def test_online_mapper_tracks_the_truth(fed):
    t, _, out_t, _, _, gt = fed
    kept = [i for i, r in enumerate(out_t) if r[0]]
    est = np.array([_xyt(v.obj.corrected_pose)[:2] for v in t.slam.graph.vertices])
    assert np.sqrt(np.mean(np.sum((est - gt[kept, :2]) ** 2, axis=1))) < 0.2
    m2o = t.map_to_odom()
    assert abs(m2o.x) < 0.5 and abs(m2o.y) < 0.5


@pytest.mark.parametrize("thetas,expected", [
    # the motion gate rejects a scan that has not moved
    ([0.0, 0.0, 0.0], [True, False, False]),
    # crossing +-pi is a 0.083 rad turn, under the 0.4 gate; 0.5 rad is not
    ([3.1, -3.1, -2.7], [True, False, True]),
])
def test_motion_gate(thetas, expected):
    mapper = port_mapper()
    scan = simulate_scan(SimWorld.office(), np.array([0.0, 0.0, 3.1]),
                         n_beams=200, range_threshold=5.0)
    got = [mapper.add_scan(scan.ranges, scan.min_angle, scan.max_angle,
                           scan.angle_increment, 0.0, 30.0,
                           (0.001 * i, 0.0, th))[0]
           for i, th in enumerate(thetas)]
    assert got == expected


def test_default_configs_are_the_nodes():
    assert DEFAULT_SEQ_CONFIG["resolution"] == 0.01
    assert DEFAULT_SEQ_CONFIG["smear_deviation"] == 0.07
    assert DEFAULT_LOOP_CONFIG["resolution"] == 0.05
    assert DEFAULT_LOOP_CONFIG["search_size"] == 4.0
    m = OnlineMapper(device="cpu")
    assert m.slam.seq_matcher.config.resolution == 0.01
    assert m.slam.seq_matcher.dtype == torch.float32
    assert m.slam.loop_matcher.config.smear_deviation == 0.03


def test_localization_mapper_batch_stream_bootstrap():
    """add_scans_batch_stream on a fresh localization mapper (base map,
    no running scans, pending initial_pose) splices the first scan per
    scan, then streams the rest without duplicate node ids."""
    grid = make_map_image()
    world = SimWorld.rectangle(10.0, 6.0)
    pose0 = np.array([-2.4, 0.1, 0.2])
    mapper = OnlineMapper(
        seq_config={"range_threshold": 5.0, "resolution": 0.02,
                    "search_size": 0.5, "smear_deviation": 0.05},
        loop_config=SMALL_LOOP,
        device="cpu", dtype=torch.float64,
        min_distance=0.2, min_rotation=0.2, range_threshold=5.0,
        base_map=(grid.image, grid.resolution, [grid.offset.x, grid.offset.y]),
        initial_pose=tuple(pose0),
    )
    n_base = len(mapper.slam.graph.vertices)
    assert n_base >= 2 and not mapper.slam.running_scans
    assert mapper.slam.seq_matcher.dtype == torch.float64

    rng = np.random.default_rng(3)
    poses = [pose0 + [0.3 * i, 0.02 * i, 0.0] for i in range(4)]
    prepared = []
    for p in poses:
        scan = simulate_scan(world, p, n_beams=500, range_threshold=5.0,
                             noise=0.003, rng=rng)
        s = mapper._prepare_scan(scan.ranges, scan.min_angle, scan.max_angle,
                                 scan.angle_increment, 0.0, 30.0, tuple(p))
        assert s is not None
        prepared.append(s)
    # preparing does not stamp the pending initial_pose on the scans
    assert abs(prepared[1].odom_pose.x - poses[1][0]) < 1e-9

    out = mapper.add_scans_batch_stream(prepared, sync_every=2)
    assert len(out) == len(prepared)
    assert mapper.initial_pose is None
    vs = mapper.slam.graph.vertices
    assert len(vs) == n_base + len(prepared)
    assert [v.obj.num for v in vs[n_base:]] == list(range(n_base, n_base + 4))
    # the bootstrap linked the first live scan to the base map
    first = vs[n_base]
    assert any(e.target.obj.num < n_base for e in first.edges)
    for v, p in zip(vs[n_base:], poses):
        assert np.hypot(v.obj.corrected_pose.x - p[0],
                        v.obj.corrected_pose.y - p[1]) < 0.3


def test_threaded_mapper_equals_the_per_scan_mapper():
    """Scans enqueued at once: the worker takes the first alone and the
    backlog as streamed blocks, the map thread renders alongside, and the
    graph equals the synchronous mapper's."""
    gt = square_loop_trajectory(side=5.0, step=0.5, laps=1, start=(-2.5, -2.5))[:24]
    rng = np.random.default_rng(0)
    world = SimWorld.office()
    scans = [simulate_scan(world, p, n_beams=200, range_threshold=5.0,
                           noise=0.004, rng=rng) for p in gt]
    args = [(s.ranges, s.min_angle, s.max_angle, s.angle_increment, 0.0, 30.0,
             tuple(p)) for s, p in zip(scans, gt)]
    ref = port_mapper()
    for a in args:
        ref.add_scan(*a)
    maps = []
    mapper = ThreadedOnlineMapper(
        device="cpu", dtype=torch.float64,
        map_callback=lambda im, g: maps.append(im), **MAPPER_KW)
    try:
        for a in args:
            mapper.enqueue_scan(*a)
        assert mapper.drain(timeout=120)
    finally:
        mapper.close()
    assert len(mapper.slam.graph.vertices) == len(ref.slam.graph.vertices) >= 20
    _assert_same_graph(ref.slam, mapper.slam)
    assert maps


@pytest.fixture(scope="module")
def carmen_log(tmp_path_factory):
    d = tmp_path_factory.mktemp("log")
    log, gt, n = generate_benchmark_log(str(d / "tour.clf"), step=0.4, laps=1,
                                        n_beams=180, seed=0)
    return log, gt


CLI_SMALL = ["--max-scans", "40", "--range-threshold", "8", "--resolution", "0.02",
             "--search-size", "0.3", "--smear-deviation", "0.05",
             "--loop-search-size", "2.0", "--min-distance", "0.3",
             "--device", "cpu"]


def test_cli_stream_equals_per_scan_on_a_carmen_log(carmen_log, tmp_path):
    log, gt = carmen_log
    base = ["--carmen", log, "--gt", gt, "--no-map-image"] + CLI_SMALL
    a = offline_mapper.main(base + ["--out", str(tmp_path / "a")])
    b = offline_mapper.main(base + ["--out", str(tmp_path / "b"), "--stream",
                                    "--sync-every", "4"])
    for k in ("vertices", "edges", "loop_closures", "integrated"):
        assert a[k] == b[k]
    assert a["integrated"] == a["vertices"] >= 20
    assert a["ate_rmse"] == pytest.approx(b["ate_rmse"], abs=1e-6)
    assert a["ate_rmse"] < a["ate_rmse_odom"]
    assert "pipeline" not in a and b["pipeline"]["synced"] > 0
    assert os.path.exists(str(tmp_path / "a.graph"))


def test_cli_synthetic_with_map_image(tmp_path):
    out = str(tmp_path / "sim")
    s = offline_mapper.main(["--synthetic-laps", "2", "--out", out,
                             "--device", "cpu"])
    assert s["vertices"] > 60 and s["loop_closures"] >= 1
    assert s["ate_rmse"] < 0.3 and s["ate_rmse"] < s["ate_rmse_odom"]
    assert os.path.exists(out + ".graph") and s["map_size"][0] > 0
    s2 = offline_mapper.main(["--synthetic-laps", "2", "--out", out + "_s",
                              "--device", "cpu", "--stream", "--no-map-image"])
    assert (s2["vertices"], s2["loop_closures"]) == (s["vertices"], s["loop_closures"])
    assert s2["ate_rmse"] == pytest.approx(s["ate_rmse"], abs=1e-6)
