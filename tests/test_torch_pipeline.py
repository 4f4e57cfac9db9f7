"""The port's OnlineMatchPipeline against the JAX package's pipeline and the
port's own blocking loop, on the CPU in float64.

The JAX matchers run the window path (use_patch=True, use_pallas=False), as
in test_torch_matcher.py.  Bars: responses and poses within 1e-9,
covariances within rtol 1e-9, and the same ``stats`` as the JAX pipeline.
The streams are those of test_pipeline.py.
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.core.scan import LocalizedRangeScan
from yag_slam_tpu.core.transform import Transform, se2_compose as host_compose
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu.matching.pipeline import OnlineMatchPipeline as JaxPipeline
from yag_slam_tpu_torch.matching import matcher as port_matcher_module
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.matching.pipeline import OnlineMatchPipeline, se2_compose

from test_pipeline import CFG, make_stream

# The suite runs several pytest workers side by side; one intra-op thread
# per process keeps torch's per-core OpenMP pools from oversubscribing the
# cores, which slows these tests manyfold.
torch.set_num_threads(1)

TOL = 1e-9
WINDOW = 6
N_SCANS = 20


# a wider grid than the scans need, so that a subgrid smaller than the
# grid is picked
WIDE_CFG = dict(CFG, range_threshold=12.0)


def jax_matcher(cfg=CFG):
    return JaxMatcher(cfg, dtype=np.float64, use_patch=True, use_pallas=False)


def port_matcher(cfg=CFG):
    return CorrelativeScanMatcher(cfg, device="cpu", dtype=torch.float64)


def _xyt(p):
    return [p.x, p.y, p.euler[-1]]


def blocking_loop(scans, window=WINDOW):
    """The port's blocking online loop: one match_scan per scan, the prior
    composed from the previous corrected pose and the odometry delta."""
    m = port_matcher()
    results = []
    for k in range(window, len(scans)):
        scan, last = scans[k], scans[k - 1]
        scan.corrected_pose = last.corrected_pose + (scan.odom_pose - last.odom_pose)
        res = m.match_scan(scan, scans[k - window:k], True, True)
        scan.corrected_pose = res.best_pose
        results.append(res)
    return results


def run_pipeline(cls, matcher, scans, invalid_call=None, window=WINDOW, **kw):
    """Seed, push every later scan (draining as it goes), flush.  With
    `invalid_call` = n, the n-th sync-time subgrid check reports a miss."""
    pipe = cls(matcher, window=window, **kw)
    if invalid_call is not None:
        real, calls = pipe._subgrid_valid, []

        def fake(base, center, sub_used):
            calls.append(center)
            return False if len(calls) == invalid_call else real(base, center, sub_used)

        pipe._subgrid_valid = fake
    pipe.seed(scans[:window])
    got = []
    for s in scans[window:]:
        pipe.push(s)
        got += pipe.drain()
    got += pipe.flush()
    return pipe, got


def assert_same_results(got, ref, scans_got, scans_ref):
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.response == pytest.approx(a.response, abs=TOL)
        np.testing.assert_allclose(_xyt(b.best_pose), _xyt(a.best_pose), rtol=0, atol=TOL)
        np.testing.assert_allclose(b.covariance, a.covariance, rtol=TOL, atol=1e-12)
    for a, b in zip(scans_ref, scans_got):
        np.testing.assert_allclose(_xyt(b.corrected_pose), _xyt(a.corrected_pose),
                                   rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def reference():
    scans, _ = make_stream(n=N_SCANS)
    return scans, blocking_loop(scans)


MODES = {
    "streaming": dict(block_dispatch=False, sync_every=4),
    "block": dict(block_dispatch=True, sync_every=5),
    "block_lag": dict(block_dispatch=True, sync_every=2, lag_blocks=1),
    "block_lag4": dict(block_dispatch=True, sync_every=4, lag_blocks=1),
    "streaming_lag": dict(block_dispatch=False, sync_every=4, lag_blocks=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_matches_blocking_loop_and_jax(reference, mode):
    """Every mode (streaming, block with a partial block at flush, lagged
    readback) equals the blocking loop and the JAX pipeline in that mode."""
    scans_ref, ref = reference
    scans, _ = make_stream(n=N_SCANS)
    pipe, got = run_pipeline(OnlineMatchPipeline, port_matcher(), scans, **MODES[mode])
    assert_same_results(got, ref, scans[WINDOW:], scans_ref[WINDOW:])
    jscans, _ = make_stream(n=N_SCANS)
    jpipe, jgot = run_pipeline(JaxPipeline, jax_matcher(), jscans, **MODES[mode])
    assert_same_results(got, jgot, scans[WINDOW:], jscans[WINDOW:])
    assert pipe.stats == jpipe.stats == {
        "synced": N_SCANS - WINDOW, "redo_sweeps": 0, "redo_matches": 0}


@pytest.mark.parametrize("case,kw,invalid_call,redo", [
    # the 3rd check of the first sync of 8 fails: entries 2..7 are redone
    ("mid_batch", dict(sync_every=8), 3, (1, 6)),
    # a miss in a drained group also redoes the still-lagged group
    ("lagged_fold", dict(sync_every=2, block_dispatch=True, lag_blocks=1), 2, None),
])
def test_redo_sweep_matches_jax(reference, case, kw, invalid_call, redo):
    scans_ref, ref = reference
    scans, _ = make_stream(n=N_SCANS)
    pipe, got = run_pipeline(OnlineMatchPipeline, port_matcher(), scans,
                             invalid_call=invalid_call, **kw)
    assert_same_results(got, ref, scans[WINDOW:], scans_ref[WINDOW:])
    jscans, _ = make_stream(n=N_SCANS)
    jpipe, _ = run_pipeline(JaxPipeline, jax_matcher(), jscans,
                            invalid_call=invalid_call, **kw)
    assert pipe.stats == jpipe.stats
    assert pipe.stats["redo_sweeps"] >= 1
    if redo is not None:
        assert (pipe.stats["redo_sweeps"], pipe.stats["redo_matches"]) == redo


BURST = range(8, 12)     # scans that see nothing the window holds
BURST_STEP = 0.9         # m between burst scans: their own points never meet


def burst_stream():
    """test_pipeline's stream with four scans in a row replaced by scans
    whose every beam ends 0.05 m from the sensor, in free space: no point
    of theirs meets an occupied cell at any lattice pose, so each coarse
    response is 0 and response expansion runs."""
    scans, _ = make_stream(n=N_SCANS)
    a = scans[BURST[0]]
    for j, k in enumerate(BURST):
        s = scans[k]
        x, y, t = a.odom_pose.x, a.odom_pose.y + BURST_STEP * j, a.odom_pose.euler[-1]
        burst = LocalizedRangeScan(np.full(len(s.ranges), 0.05), s.min_angle,
                                   s.max_angle, s.angle_increment, 0.0, 30.0,
                                   CFG["range_threshold"], x, y, t)
        scans[k] = burst
    return scans


def test_expansion_burst_in_one_block():
    """Four empty-response scans inside one block of 8: the sync finds the
    first, and the sweep redoes the block's rest through match_scan (which
    widens the angle search); port and JAX agree on every result and on
    the redo counters.

    Against the blocking loop only the scans before the burst are held:
    a zero-response pose is the mean of np.arange's lattice at the float
    center (the matcher's zero-response fixup), and a last-bit difference
    of the center (the device's SE(2) composition against the host's
    quaternion one) can add a boundary candidate and move it by a step,
    in the JAX pipeline alike."""
    ref_scans = burst_stream()
    ref = blocking_loop(ref_scans)
    scans = burst_stream()
    pipe, got = run_pipeline(OnlineMatchPipeline, port_matcher(), scans,
                             sync_every=8, block_dispatch=True)
    for k in BURST:
        assert ref[k - WINDOW].response == got[k - WINDOW].response == 0.0
    n_before = BURST[0] - WINDOW
    assert_same_results(got[:n_before], ref[:n_before], scans[WINDOW:BURST[0]],
                        ref_scans[WINDOW:BURST[0]])
    jscans = burst_stream()
    jpipe, jgot = run_pipeline(JaxPipeline, jax_matcher(), jscans,
                               sync_every=8, block_dispatch=True)
    assert_same_results(got, jgot, scans[WINDOW:], jscans[WINDOW:])
    assert pipe.stats == jpipe.stats
    # the first block holds scans 6-13; the burst starts at its 3rd entry
    assert pipe.stats["redo_sweeps"] == 1
    assert pipe.stats["redo_matches"] == 8 - (BURST[0] - WINDOW)


def test_subgrid_valid_semantics():
    """The check passes when the exact-pose base occupancy (+ smear halo)
    fits the subgrid used and fails when it leaks past an edge."""
    window = 4
    scans, _ = make_stream(n=window + 1)
    m = port_matcher(WIDE_CFG)
    pipe = OnlineMatchPipeline(m, window=window)
    pipe.seed(scans[:window])
    pipe.push(scans[window])
    pipe.flush()
    base = scans[:window]
    center = np.array([scans[window].corrected_pose.x,
                       scans[window].corrected_pose.y, 0.0])
    sox, soy, S = m._subgrid_for(base, center[0], center[1], m._point_cap)
    assert S < m.grid_size
    assert pipe._subgrid_valid(base, center, (sox, soy, S))
    assert pipe._subgrid_valid(base, center, (0, 0, m.grid_size))
    assert not pipe._subgrid_valid(base, center, (sox - S // 2, soy, S))
    assert not pipe._subgrid_valid(base, center, (sox, soy - S // 2, S))


def test_margin_cells_widens_the_subgrid():
    """_subgrid_for's margin moves the subgrid's origin by the margin (or
    picks a larger bucket), as in the JAX matcher."""
    scans, _ = make_stream(n=5)
    pm, jm = port_matcher(WIDE_CFG), jax_matcher(WIDE_CFG)
    P = pm._ensure_point_cap(scans)
    jm._ensure_point_cap(scans)
    c = scans[4].corrected_pose
    for margin in (0, 9, 40):
        got = pm._subgrid_for(scans[:4], c.x, c.y, P, margin_cells=margin)
        assert got == jm._subgrid_for(scans[:4], c.x, c.y, P, margin_cells=margin)
    assert pm._subgrid_for(scans[:4], c.x, c.y, P, margin_cells=9) != \
        pm._subgrid_for(scans[:4], c.x, c.y, P)


def test_pipeline_corrects_odometry_drift():
    """With strong odometry noise the chained poses still land nearer the
    truth than odometry: the pipeline matches, it does not only integrate."""
    scans, true_poses = make_stream(drift=0.03)
    pipe, results = run_pipeline(OnlineMatchPipeline, port_matcher(), scans,
                                 sync_every=16)
    assert all(r.response > 0.3 for r in results)
    errs = [np.hypot(s.corrected_pose.x - t[0], s.corrected_pose.y - t[1])
            for s, t in zip(scans[WINDOW:], true_poses[WINDOW:])]
    odo = [np.hypot(s.odom_pose.x - t[0], s.odom_pose.y - t[1])
           for s, t in zip(scans[WINDOW:], true_poses[WINDOW:])]
    assert np.mean(errs) < np.mean(odo) and np.mean(errs) < 0.06


def test_pose_tensor_grows_with_the_library(reference, monkeypatch):
    """A library that starts at 8 slots doubles twice during the stream;
    the pose tensor follows it and the results do not change."""
    monkeypatch.setattr(port_matcher_module, "_LIBRARY_INITIAL_CAP", 8)
    scans_ref, ref = reference
    scans, _ = make_stream(n=N_SCANS)
    m = port_matcher()
    pipe, got = run_pipeline(OnlineMatchPipeline, m, scans, sync_every=3,
                             block_dispatch=True)
    assert m.library.K_cap == 32 and pipe._poses.shape == (32, 3)
    assert_same_results(got, ref, scans[WINDOW:], scans_ref[WINDOW:])


def test_push_before_seed_raises():
    with pytest.raises(RuntimeError, match="seed"):
        OnlineMatchPipeline(port_matcher()).push(make_stream(n=1)[0][0])


def test_device_compose_matches_host_compose():
    """The device pose chain's SE(2) composition equals core.transform's,
    the wrap across +-pi included."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-5, 5, (64, 3))
    b = rng.uniform(-1, 1, (64, 3))
    a[:, 2] = rng.uniform(-np.pi, np.pi, 64)
    b[:, 2] = rng.uniform(-np.pi, np.pi, 64)
    a[0, 2], b[0, 2] = 3.1, 0.2          # wraps past +pi
    got = se2_compose(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, host_compose(a, b), rtol=0, atol=1e-12)
    assert got[0, 2] < 0
    t = Transform.from_xyt(*a[1]) + Transform.from_xyt(*b[1])
    np.testing.assert_allclose(got[1], _xyt(t), rtol=0, atol=1e-12)
