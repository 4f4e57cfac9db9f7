"""GraphSlam.process_scan_stream in the port, against the JAX package's
process_scan_stream and the port's own per-scan process_scan, on the CPU
in float64.

The 2-lap square sequence of test_slam_e2e closes loops inside blocks, so
the block tail after a closure is redone through the blocking path and the
pipeline re-seeded.  Bar: the same vertex, edge and closure counts, the
same edges and closure flags, poses within 1e-6 m / 1e-6 rad.
"""
import numpy as np
import pytest
import torch

from test_slam_e2e import build_sequence
from test_torch_slam import _assert_same_graph, jax_slam, torch_slam

# The suite runs several pytest workers side by side; one intra-op thread
# per process keeps torch's per-core OpenMP pools from oversubscribing the
# cores, which slows these tests manyfold.
torch.set_num_threads(1)

MODES = {
    "block8": dict(sync_every=8, block_dispatch=True),
    "streaming5": dict(sync_every=5, block_dispatch=False),
}


@pytest.fixture(scope="module")
def per_scan():
    """The port's per-scan run: results and the SLAM state."""
    _, _, scans = build_sequence(laps=2)
    slam = torch_slam()
    return slam, [slam.process_scan(s) for s in scans]


@pytest.fixture(scope="module")
def jax_stream():
    _, _, scans = build_sequence(laps=2)
    slam = jax_slam()
    return slam, slam.process_scan_stream(scans, **MODES["block8"])


def _closed(out):
    return [None if r is None else bool(c) for r, c in out]


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_matches_per_scan_and_jax(per_scan, jax_stream, mode):
    slam_ref, out_ref = per_scan
    _, _, scans = build_sequence(laps=2)
    slam = torch_slam()
    out = slam.process_scan_stream(scans, **MODES[mode])
    assert len(out) == len(out_ref) == len(scans)
    assert slam.stats["loop_closures"] >= 1
    _assert_same_graph(slam_ref, slam)
    assert _closed(out) == _closed(out_ref)
    for (ra, _), (rb, _) in zip(out_ref, out):
        if ra is not None:
            assert rb.response == pytest.approx(ra.response, abs=1e-9)
    assert slam.stats["scans_processed"] == len(scans)
    assert slam.stats["stream_synced"] >= len(scans) - 1 - slam.stats["stream_redo_matches"]

    jslam, jout = jax_stream
    _assert_same_graph(jslam, slam)
    assert _closed(out) == _closed(jout)


def test_closure_inside_a_block_redoes_the_tail(per_scan):
    """At least one closure of the sequence fires before the last scan of
    its block of 8, so the streamed run above went through the redo of a
    block's tail and the re-seed."""
    _, out_ref = per_scan
    closed_at = [i for i, (r, c) in enumerate(out_ref) if r is not None and c]
    # scan 0 is the map's first; blocks of 8 then cover scans 1-8, 9-16, ...
    assert any((i - 1) % 8 != 7 for i in closed_at), closed_at


def test_stream_continues_a_per_scan_run():
    """Per-scan for the first lap, streamed for the second: the same
    graph as the per-scan run throughout."""
    _, _, scans_a = build_sequence(laps=2)
    _, _, scans_b = build_sequence(laps=2)
    a, b = torch_slam(), torch_slam()
    for s in scans_a:
        a.process_scan(s)
    half = len(scans_b) // 2
    for s in scans_b[:half]:
        b.process_scan(s)
    b.process_scan_stream(scans_b[half:], sync_every=8)
    _assert_same_graph(a, b)
    np.testing.assert_array_equal([s.num for s in b.running_scans],
                                  [s.num for s in a.running_scans])
