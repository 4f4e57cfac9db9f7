"""The port's raytracing, free-space segmentation and map splicing against
the JAX package's, on the CPU.

Segment labels, centroids and adjacency edges are equal to the JAX
package's.  Ray lengths are float32 in both; the sample positions
sx + k cos(a) go through each library's float32 cos/sin, which may differ
in the last bit, and a sample that sits on a .5 boundary then rounds to the
other pixel.  So lengths agree within RAY_TOL, except on a few rays that
end one step (1 px) apart: at most one in 10,000 of the map sweeps, and
two of the 120 rays from a half-pixel origin, where every angle whose
cosine is a half in real arithmetic samples exact .5 positions.
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.io.simulator import SimWorld, simulate_scan
from yag_slam_tpu.mapping.raytrace import trace_rays as jax_trace_rays
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu.slam.graph_slam import GraphSlam as JaxGraphSlam
from yag_slam_tpu.splicing import splice as jax_splice
from yag_slam_tpu.splicing.segmentation import spatial_segments as jax_segments
from yag_slam_tpu_torch.mapping.raytrace import run_raytracing_sweep, trace_rays
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
from yag_slam_tpu_torch.splicing import splice
from yag_slam_tpu_torch.splicing.segmentation import spatial_segments

from test_mapping import oracle_trace
from test_splicing import make_map_image

# The suite runs several pytest workers side by side; one intra-op thread
# per process keeps torch's per-core OpenMP pools from oversubscribing the
# cores, which slows these tests manyfold.
torch.set_num_threads(1)

RAY_TOL = 1e-3          # px; float32 length rounding is ~1e-4 px here
MAX_STEP_RAYS = 1e-4    # share of map-sweep rays allowed one step apart
HALF_PIXEL_FAR = 2      # rays allowed one step apart from a half-pixel origin
DENSITY = 30
SWEEP = np.arange(-180, 180, 0.25)[:-1][::-1]
SEQ_CFG = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
           "smear_deviation": 0.05}


def assert_rays_close(got, ref, max_far=None):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    far = d > RAY_TOL
    if max_far is None:
        max_far = MAX_STEP_RAYS * d.size
    assert far.sum() <= max_far, (far.sum(), d.size)
    assert (d[far] <= 1.0 + RAY_TOL).all(), d[far]


@pytest.fixture(scope="module")
def rendered():
    """The two-room map of test_splicing, segmented by both packages."""
    grid = make_map_image()
    im = grid.image
    return grid, im, jax_splice.segment_map(im, density=DENSITY), \
        splice.segment_map(im, density=DENSITY, device="cpu")


def test_spatial_segments_match_jax():
    mask = np.zeros((60, 100), bool)
    mask[10:50, 10:90] = True
    mask[20:30, 30:40] = False
    for k in (1, 4, 9):
        seg = spatial_segments(mask, k, device="cpu")
        np.testing.assert_array_equal(seg, jax_segments(mask, k))
        assert set(np.unique(seg[~mask])) == {0}
    assert not spatial_segments(np.zeros((5, 5), bool), 3, device="cpu").any()


def test_segment_map_centroids_and_edges_match_jax(rendered):
    _, _, seg_j, seg_t = rendered
    assert seg_t.max() >= 2
    np.testing.assert_array_equal(seg_t, seg_j)
    assert splice.determine_centroids(seg_t) == jax_splice.determine_centroids(seg_j)
    edges = splice.create_edges(seg_t)
    assert edges and edges == jax_splice.create_edges(seg_j)


def _random_image():
    """test_mapping's image: walls, obstacles and unknown patches."""
    rng = np.random.default_rng(5)
    img = np.full((120, 160), 255, dtype=np.uint8)
    img[:3, :] = 0
    img[-3:, :] = 0
    img[:, :3] = 0
    img[:, -3:] = 0
    for _ in range(25):
        r, c = rng.integers(10, 110), rng.integers(10, 150)
        img[r:r + 3, c:c + 3] = 0
    for _ in range(10):
        r, c = rng.integers(10, 110), rng.integers(10, 150)
        img[r:r + 4, c:c + 4] = 200
    return img


@pytest.mark.parametrize("sx,sy", [(80.0, 60.0), (20.5, 33.5), (140.25, 100.0)])
def test_trace_rays_match_jax_and_oracle(sx, sy):
    img = _random_image()
    angles = np.arange(-180, 180, 3.0)
    ex, ey, ln = trace_rays(img, angles, sx, sy, device="cpu")
    jex, jey, jln = jax_trace_rays(img, angles, sx, sy)
    assert ln.dtype == np.float32 and ln.shape == angles.shape
    for got, ref in ((ln, jln), (ex, jex), (ey, jey)):
        assert_rays_close(got, ref, max_far=HALF_PIXEL_FAR if sx % 1 == 0.5 else 0)
    for a, got in zip(angles, ln):
        assert abs(got - oracle_trace(img, a, sx, sy)) < 1.5
    # unknown space poisons: some ray runs 1000 px past its stop
    assert (ln > 1000).any() == (jln > 1000).any()


def test_sweeps_from_every_centroid_match_jax(rendered):
    """The 1439-ray sweeps of map_to_graph from every region centroid."""
    _, im, seg_j, _ = rendered
    cents = jax_splice.determine_centroids(seg_j)
    got = [trace_rays(im, SWEEP, *cents[k], device="cpu")[2] for k in sorted(cents)]
    ref = [jax_trace_rays(im, SWEEP, *cents[k])[2] for k in sorted(cents)]
    assert_rays_close(np.concatenate(got), np.concatenate(ref))


def test_run_raytracing_sweep_api():
    img = np.full((60, 60), 255, dtype=np.uint8)
    img[0:2, :] = 0
    img[-2:, :] = 0
    img[:, 0:2] = 0
    img[:, -2:] = 0
    rays = run_raytracing_sweep(img, np.arange(0, 360, 10.0), 30, 30, device="cpu")
    assert len(rays) == 36
    assert all(10 < r.length < 45 for r in rays)
    ex, ey, ln = trace_rays(img, np.arange(0, 360, 10.0), 30, 30, device="cpu")
    assert [r.length for r in rays] == [float(v) for v in ln]
    assert rays[0].end_x == float(ex[0]) and rays[0].end_y == float(ey[0])


@pytest.fixture(scope="module")
def graphs(rendered):
    grid, im, _, _ = rendered
    origin = [grid.offset.x, grid.offset.y]
    jslam = JaxGraphSlam(
        JaxMatcher(SEQ_CFG, dtype=np.float64, use_patch=True, use_pallas=False),
        None, loop_search_min_chain_size=2)
    tslam = GraphSlam(
        CorrelativeScanMatcher(SEQ_CFG, device="cpu", dtype=torch.float64),
        None, loop_search_min_chain_size=2)
    jslam = jax_splice.map_to_graphslam(jslam, im, grid.resolution, origin,
                                        density=DENSITY)
    tslam = splice.map_to_graphslam(tslam, im, grid.resolution, origin,
                                    density=DENSITY)
    return jslam, tslam


def test_map_to_graphslam_matches_jax(graphs):
    """The same synthetic scans at the same poses, the same ranges (to the
    ray bar, in metres), the same adjacency edges and the same renumbering
    of the connected regions."""
    jslam, tslam = graphs
    jv, tv = jslam.graph.vertices, tslam.graph.vertices
    assert len(tv) == len(jv) >= 2
    assert [v.obj.num for v in tv] == [v.obj.num for v in jv]
    np.testing.assert_allclose([[v.obj.corrected_pose.x, v.obj.corrected_pose.y]
                                for v in tv],
                               [[v.obj.corrected_pose.x, v.obj.corrected_pose.y]
                                for v in jv], rtol=0, atol=1e-12)
    res = 0.05
    assert_rays_close(np.concatenate([v.obj.ranges for v in tv]) / res,
                      np.concatenate([v.obj.ranges for v in jv]) / res)
    assert len(tslam.graph.edges) == len(jslam.graph.edges) >= 1
    pairs = lambda s: sorted((e.source.obj.num, e.target.obj.num)  # noqa: E731
                             for e in s.graph.edges)
    assert pairs(tslam) == pairs(jslam)


def test_map_to_graphslam_and_continue(graphs):
    """The node's flow: round-trip to rebuild the optimizer's indices, then
    localize a fresh scan against the injected map (splice bootstrap)."""
    _, tslam = graphs
    slam2 = GraphSlam.deserialize(tslam.serialize(), device="cpu",
                                  dtype=torch.float64)
    assert len(slam2.graph.vertices) == len(tslam.graph.vertices)
    world = SimWorld.rectangle(10.0, 6.0)
    pose = np.array([-2.4, 0.1, 0.2])
    scan = simulate_scan(world, pose, n_beams=500, range_threshold=5.0)
    nearby = slam2.search.crude_radius_search(scan.odom_pose, 5)
    assert nearby
    res = slam2.seq_matcher.match_scan(scan, [v.obj for v in nearby], do_fine=True)
    assert res.response > 0.2
    assert abs(res.best_pose.x - pose[0]) < 0.3
    assert abs(res.best_pose.y - pose[1]) < 0.3
