"""The port's host job assembly against the JAX matcher's, bit for bit.

``CorrelativeScanMatcher._prepare`` assembles a batch in one pass over
its distinct scans (library slots, poses and subgrids from per-scan
tables).  Each case runs the same jobs through the port's ``_prepare`` /
``_assemble_jobs`` / ``_subgrid_for`` and through the JAX matcher's
per-job ``_ensure_point_cap``, ``_base_bucket`` and ``_assemble_jobs``
on twin scans (the same ranges and poses in each package's scan type),
and holds every job array, P and S to the JAX package's: float arrays
bit for bit, the slot indices by value (int32 there, int64 here).  The
batched view op (``native.scan_views``) is held to the per-scan native
ops and to their numpy / Python twins.  Everything runs on the CPU.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import inputs  # noqa: E402
from benchmark.cells import karto  # noqa: E402
from yag_slam_tpu.core.scan import LocalizedRangeScan as JaxScan  # noqa: E402
from yag_slam_tpu.core.transform import Transform as JaxTransform  # noqa: E402
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher  # noqa: E402
from yag_slam_tpu_torch import native  # noqa: E402
from yag_slam_tpu_torch.core import scan as scan_mod  # noqa: E402
from yag_slam_tpu_torch.core.scan import LocalizedRangeScan  # noqa: E402
from yag_slam_tpu_torch.core.transform import Transform  # noqa: E402
from yag_slam_tpu_torch.matching import correlation  # noqa: E402
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher  # noqa: E402

SEQ = karto()["sequential"]          # the batch cell's configuration (G = 4051)
WINDOW, BATCH = 10, 64               # the batch cell's jobs and batch
NAMES = ("idx", "mask", "pose", "q_idx", "center", "vp", "sub")


def twin_scans(seed, n_scans, n_beams=inputs.OFFICE_BEAMS):
    """The office stream as port scans and as JAX scans, from the same
    ranges and poses."""
    ranges, poses = inputs.office_stream(n_scans, seed, n_beams)
    inc = (inputs.OFFICE_MAX_ANGLE - inputs.OFFICE_MIN_ANGLE) / n_beams

    def make(cls):
        return [cls(r, inputs.OFFICE_MIN_ANGLE, inputs.OFFICE_MAX_ANGLE, inc, 0.0,
                    inputs.OFFICE_MAX_RANGE, SEQ["range_threshold"], *p)
                for r, p in zip(ranges, poses)]

    return make(LocalizedRangeScan), make(JaxScan)


def window_jobs(scans):
    """The batch cell's jobs: every query from WINDOW on but the last,
    against the WINDOW scans before it."""
    return [(scans[i], scans[i - WINDOW:i]) for i in range(WINDOW, len(scans) - 1)]


def matchers(dtype=torch.float32, **kw):
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return (CorrelativeScanMatcher(SEQ, device="cpu", dtype=dtype, **kw),
            JaxMatcher(SEQ, dtype=np_dtype, use_patch=True, use_pallas=False, **kw))


def jax_prepare(jm, jobs, n_pad=None):
    """The JAX matcher's match_many assembly: its args, P and S."""
    P = jm._ensure_point_cap([q for q, _ in jobs] + [s for _, bs in jobs for s in bs])
    B = jm._base_bucket(max(len(bs) for _, bs in jobs))
    idx, mask, pose, q_idx, center, sub, S = jm._assemble_jobs(jobs, P, B, n_pad)
    return (idx, mask, pose, q_idx, center, center[:, :2], sub), P, S


def assert_same_args(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        if name in ("idx", "q_idx"):
            assert g.dtype == np.int64 and np.array_equal(g, w), name
        else:
            assert g.dtype == w.dtype, name
            assert np.ascontiguousarray(g).tobytes() == np.ascontiguousarray(w).tobytes(), name


def assert_same_prepare(pm, jm, pjobs, jjobs, n_pad=None):
    args, P, S = pm._prepare(pjobs, n_pad=n_pad)
    want, jP, jS = jax_prepare(jm, jjobs, n_pad)
    assert (P, S) == (jP, jS)
    assert_same_args(args, want)
    return args, P, S


def batches(jobs, size=BATCH):
    return [jobs[i:i + size] for i in range(0, len(jobs), size)]


def pad_of(n):
    return 1 << (n - 1).bit_length()


def assert_library_holds_the_views(m):
    """Every stored scan's library row equals its per-scan native view."""
    lib = m.library.fields
    for s in m.library._scans:
        slot = m.library._slots[id(s._points_cache)]
        lx, ly, n = native.compact_beams(s.ranges, s.min_angle, s.angle_increment,
                                         s.range_threshold, m.library.P)
        runs = native.segment_runs(lx, ly, n)
        assert int(lib["n"][slot]) == n
        np.testing.assert_array_equal(lib["lx"][slot].numpy(), lx.astype(m.np_dtype))
        np.testing.assert_array_equal(lib["ly"][slot].numpy(), ly.astype(m.np_dtype))
        for f, r in zip(("anchor", "term", "has_run"), runs):
            np.testing.assert_array_equal(lib[f][slot, :n].numpy(), r)
            assert not lib[f][slot, n:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_x64_batches_equal_the_jax_assembly(dtype):
    """The batch cell's traffic: two fresh 150-scan streams in batches of 64
    padded as match_many pads them (the library crosses 128 and 256 slots),
    then the same jobs again on warm scans, which make no view."""
    pm, jm = matchers(dtype)
    streams = [twin_scans(seed, 150) for seed in (0, 1)]
    pjobs = [j for p, _ in streams for j in window_jobs(p)]
    jjobs = [j for _, js in streams for j in window_jobs(js)]
    assert len(pjobs) == 278
    native.reset_calls()
    for pb, jb in zip(batches(pjobs), batches(jjobs)):
        assert_same_prepare(pm, jm, pb, jb, n_pad=pad_of(len(pb)))
    fresh_calls = native.CALLS["scan_views"]
    assert 0 < fresh_calls <= 2 * len(batches(pjobs))
    assert pm.library.K_cap == 512 and len(pm.library._scans) == 298
    for pb, jb in zip(batches(pjobs), batches(jjobs)):
        assert_same_prepare(pm, jm, pb, jb, n_pad=pad_of(len(pb)))
    assert native.CALLS["scan_views"] == fresh_calls
    assert_library_holds_the_views(pm)


def test_ragged_base_lists_and_padded_rows():
    """Base lists of 1-7 scans under a bucket of 8 (and of 16, fixed by
    base_capacity), rows padded past the jobs, a query that is also a base
    scan of another job, a job whose bases lie far apart (the full grid:
    sub (0, 0)) and one whose only base lies far from the origin."""
    p, j = twin_scans(2, 40)
    far = twin_scans(3, 4)
    for scans in far:
        T = type(scans[0].corrected_pose)
        for s, xyt in zip(scans, ((-12.0, -12.0, 0.3), (-30.0, -30.0, 1.0), (6.0, 6.0, -0.5),
                                  (-27.0, -29.0, 0.2))):
            s.corrected_pose = T.from_xyt(*xyt)

    def jobs(scans, extra):
        out = [(scans[20 + k], scans[20 - 1 - k:20]) for k in range(7)]
        out.append((scans[5], [scans[20], scans[6]]))
        out.append((extra[0], extra[:3]))
        out.append((extra[1], extra[3:]))      # one base, its box far from the origin
        return out

    for base_capacity in (None, 16):
        pm, jm = matchers(base_capacity=base_capacity)
        args, _, S = assert_same_prepare(pm, jm, jobs(p, far[0]), jobs(j, far[1]), n_pad=16)
        idx, mask, pose, _, _, _, sub = args
        assert mask.shape[1] == (base_capacity or 8) and not mask[10:].any()
        assert not idx[~mask].any() and not pose[~mask].any() and not sub[10:].any()
        assert tuple(sub[8]) == (0, 0) and S == pm._max_sub()
        assert_library_holds_the_views(pm)


def test_a_pose_change_between_batches_moves_the_subgrids():
    """SPA moves the base scans between two batches (a new Transform on
    each): the second batch reads the new poses and boxes."""
    p, j = twin_scans(4, 40)
    pm, jm = matchers()
    pjobs, jjobs = window_jobs(p), window_jobs(j)
    first, _, _ = assert_same_prepare(pm, jm, pjobs, jjobs)
    for scans, T in ((p, Transform), (j, JaxTransform)):
        for k, s in enumerate(scans[::3]):
            c = s.corrected_pose
            s.corrected_pose = T.from_xyt(c.x + 0.013 * k, c.y - 0.4, c.euler[-1] + 0.02)
    second, _, _ = assert_same_prepare(pm, jm, pjobs, jjobs)
    assert not np.array_equal(first[2], second[2]) and not np.array_equal(first[6], second[6])


def test_a_loop_closure_copy_shares_the_slot_not_the_pose():
    """LocalizedRangeScan.copy (the loop-closure temp scan) shares the
    points cache, so the library slot, at another pose: both poses and
    boxes are read in one batch, the copy as a base scan and as a query."""
    p, j = twin_scans(5, 30)
    copies = []
    for scans, T in ((p, Transform), (j, JaxTransform)):
        c = scans[12].copy()
        c.corrected_pose = T.from_xyt(1.7, -2.2, 0.4)
        copies.append(c)

    def jobs(scans, c):
        return [(scans[20], scans[10:20]), (scans[21], [c, *scans[14:19]]),
                (c, scans[2:8]), (scans[22], [scans[12], c, scans[13]])]

    pm, jm = matchers()
    args, _, _ = assert_same_prepare(pm, jm, jobs(p, copies[0]), jobs(j, copies[1]))
    idx, _, pose, q_idx, _, _, _ = args
    assert idx[3, 0] == idx[3, 1] == q_idx[2] and not np.array_equal(pose[3, 0], pose[3, 1])
    assert len(pm.library._scans) == len(jm.library._scans)


def test_a_wider_scan_grows_the_point_capacity_mid_stream():
    """180-beam scans take P = 256; a batch that brings 360-beam scans
    takes 512 and re-queues the library at the new width."""
    narrow, wide = twin_scans(6, 30, n_beams=180), twin_scans(7, 30)
    pm, jm = matchers()
    _, P, _ = assert_same_prepare(pm, jm, window_jobs(narrow[0])[:8], window_jobs(narrow[1])[:8])
    assert P == 256
    pjobs = window_jobs(narrow[0])[8:12] + window_jobs(wide[0])[:6]
    jjobs = window_jobs(narrow[1])[8:12] + window_jobs(wide[1])[:6]
    _, P, _ = assert_same_prepare(pm, jm, pjobs, jjobs, n_pad=16)
    assert P == 512 == pm.library.P
    assert_library_holds_the_views(pm)


def test_the_library_crosses_its_capacity_inside_one_batch():
    """140 distinct scans in one batch: the library grows from 128 slots
    in the middle of the batch's one ensure, and slots still follow the
    jobs' first touch."""
    streams = [twin_scans(seed, 11) for seed in range(10, 24)]
    pjobs = [(s[10], s[:10]) for s, _ in streams]
    jjobs = [(s[10], s[:10]) for _, s in streams]
    pm, jm = matchers()
    args, _, _ = assert_same_prepare(pm, jm, pjobs, jjobs, n_pad=16)
    assert pm.library.K_cap == 256 and len(pm.library._scans) == 154
    assert args[3][13] == 11 * 13 + 10 and not args[3][14:].any()
    assert_library_holds_the_views(pm)


@pytest.mark.parametrize("margin", [0, 9, 40])
def test_subgrid_for_with_a_margin_equals_the_jax_matcher(margin):
    """_subgrid_for, the one-job call of the batched subgrids, at the
    chained pipeline's margins, for centers on and off the query."""
    p, j = twin_scans(8, 25)
    pm, jm = matchers()
    P = pm._ensure_point_cap(p)
    assert P == jm._ensure_point_cap(j)
    for i in (10, 17, 24):
        c = p[i].corrected_pose
        for cx, cy in ((c.x, c.y), (c.x + 0.37, c.y - 1.1)):
            got = pm._subgrid_for(p[i - 10:i], cx, cy, P, margin_cells=margin)
            assert got == jm._subgrid_for(j[i - 10:i], cx, cy, P, margin_cells=margin)
            assert all(type(v) is int for v in got)


# -- the batched view op ----------------------------------------------------------

def view_scans():
    """Scans of 180 and 360 beams, one with no valid beam (NaN and
    beyond the threshold) and one with every beam valid."""
    scans = twin_scans(9, 4, n_beams=180)[0] + twin_scans(9, 3)[0]
    none = scans[1].ranges.copy()
    none[::2] = np.nan
    none[1::2] = 99.0
    full = np.full(180, 3.0)
    for r in (none, full):
        scans.append(LocalizedRangeScan(r, -np.pi / 2, np.pi / 2, np.pi / 180, 0.0, 30.0,
                                        SEQ["range_threshold"], 0.3, 0.2, 0.1))
    return scans


def test_scan_views_equal_the_per_scan_ops_and_their_twins():
    scans = view_scans()
    cap = 512
    native.reset_calls()
    rows = native.scan_views(scans, cap)
    assert native.CALLS == dict(compact_beams=0, segment_runs=0, scan_views=1, parse_carmen=0,
                                spa_lm=0)
    assert rows["lx"].shape == rows["anchor"].shape == (len(scans), cap)
    assert rows["has_run"].dtype == bool and rows["n"][-2] == 0 and rows["n"][-1] == 180
    for i, s in enumerate(scans):
        args = (s.ranges, s.min_angle, s.angle_increment, s.range_threshold, cap)
        for compact, segment in ((native.compact_beams, native.segment_runs),
                                 (scan_mod.beam_points_padded_ref,
                                  correlation.segment_validation_runs_ref)):
            lx, ly, n = compact(*args)
            assert rows["n"][i] == n
            np.testing.assert_array_equal(rows["lx"][i], lx)
            np.testing.assert_array_equal(rows["ly"][i], ly)
            for f, r in zip(("anchor", "term", "has_run"), segment(lx, ly, n)):
                np.testing.assert_array_equal(rows[f][i], np.pad(r, (0, cap - n)))
    empty = native.scan_views([], cap)
    assert empty["lx"].shape == (0, cap) and empty["n"].shape == (0,)


def test_scan_views_refuses_a_scan_over_capacity():
    scans = view_scans()
    with pytest.raises(ValueError, match="scan has 180 valid beams > point capacity 128"):
        native.scan_views(scans[:1] + scans[-1:], 128)
    with pytest.raises(ValueError, match="valid beams > point capacity 128"):
        native.compact_beams(scans[-1].ranges, scans[-1].min_angle, scans[-1].angle_increment,
                             scans[-1].range_threshold, 128)
