"""The matcher's CUDA-graph dispatch (matching/graphs.py), on the CPU.

No card here: the graph cache runs on CPU tensors with a stand-in for its
CUDA graph (capture runs the body once and keeps its outputs; replay runs
it again into the same outputs, as a CUDA graph overwrites its static
outputs), and its launches are emulated.  The split ``_run`` (staging, then
``_compute``) is held bit-equal to the eager ``_run`` as it was before the
split, and to the JAX package at test_torch_matcher's tolerance.
"""
import numpy as np
import pytest
import torch

from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu_torch.matching import correlation as C
from yag_slam_tpu_torch.matching import graphs
from yag_slam_tpu_torch.matching import kernels as K
from yag_slam_tpu_torch.matching.matcher import _LIBRARY_INITIAL_CAP, CorrelativeScanMatcher

from test_matching import TEST_CFG, make_room_scan
from test_torch_match_program import _score_pass
from test_torch_matcher import _assert_same

# the launches one emulated capture records
CAPTURED = {"scatter_cells": 1, "smear_quantize": 1, "smear_grid": 0, "window_sum": 2}


class StandInGraph:
    """CPU stand-in for graphs.CudaGraph."""

    made = 0

    def __init__(self, device):
        StandInGraph.made += 1
        self.fn = self.out = None

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        for k, n in CAPTURED.items():
            for _ in range(n):
                K._count(k)
        return self.out

    def replay(self):
        for static, new in zip(self.out, self.fn()):
            if static is not None:
                static.copy_(new)


def _bits(t):
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


def _equal(a, b):
    return torch.equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def room():
    base = [make_room_scan(0.1 * i, 0.02 * i, 0.03 * i, seed=i + 1) for i in range(4)]
    queries = [make_room_scan(0.13, -0.05, 0.05, seed=10),
               make_room_scan(0.05, 0.04, -0.02, seed=11),
               make_room_scan(0.21, 0.01, 0.08, seed=12)]
    for q in queries:
        q.corrected_pose = q.odom_pose
    return base, queries


def _matcher(**kw):
    return CorrelativeScanMatcher(TEST_CFG, device="cpu", dtype=torch.float64, **kw)


def _seed_run(m, args, P, penalty, do_fine, coarse_offset, S, queries=None):
    """``_job_inputs`` and ``_run`` as they were before the split, verbatim
    but for ``torch.as_tensor`` (the CPU tensors are the same)."""
    G = m.grid_size
    res = m.config.resolution
    idx, mask, pose, q_idx, center, vp, sub = (torch.as_tensor(a) for a in args)
    lib = m.library.fields
    base_lx, base_ly = lib["lx"][idx], lib["ly"][idx]
    if queries is None:
        qlx, qly, n_q = lib["lx"][q_idx], lib["ly"][q_idx], lib["n"][q_idx]
    else:
        qlx, qly, n_q = (torch.as_tensor(a) for a in queries)
    cx, cy, ct = center[:, 0], center[:, 1], center[:, 2]
    pc, ps = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
    wx = pose[..., 0:1] + pc * base_lx - ps * base_ly
    wy = pose[..., 1:2] + ps * base_lx + pc * base_ly
    keep = C.keep_mask_for_viewpoint(wx, wy, lib["anchor"][idx], lib["term"][idx],
                                     lib["has_run"][idx], mask[..., None],
                                     vp[:, 0, None, None], vp[:, 1, None, None])
    valid = torch.arange(P)[None, :] < n_q[:, None]
    inp = dict(wx=wx, wy=wy, keep=keep, ox=cx - 0.5 * (G - 1) * res,
               oy=cy - 0.5 * (G - 1) * res, sox=sub[:, 0], soy=sub[:, 1],
               qx=torch.where(valid, qlx, 1.0e9), qy=torch.where(valid, qly, 1.0e9),
               n_pts=n_q.to(m.dtype), cx=cx, cy=cy, ct=ct)
    points = tuple(inp[k] for k in ("wx", "wy", "keep", "ox", "oy", "sox", "soy"))
    build = dict(G=G, S=S, h=m._half, res=res, taps=m._taps)
    grid0 = None
    if m.return_meta:
        q2d, grid = C.build_grid_staged(*points, **build)
        grid0 = grid[0]
    else:
        q2d = C.build_quantized_grid(*points, **build)
    coarse = C.reduce_best_pose(*_score_pass(m, q2d, inp, (cx, cy, ct), False, penalty,
                                             coarse_offset))
    fine = coarse
    if do_fine:
        fine = C.reduce_best_pose(*_score_pass(
            m, q2d, inp, (coarse[:, 1], coarse[:, 2], coarse[:, 3]), True, penalty,
            coarse_offset))
    return torch.stack([coarse, fine], dim=1), grid0


def _explicit(m, base, query, P):
    """A scan-set style call: explicit query points, as
    ``_match_explicit_query`` makes them."""
    B = m._base_bucket(len(base))
    (idx, mask, pose, q_idx, _, _, _), _ = m._assemble_jobs([(base[0], base)], P, B)
    p = query.corrected_pose
    center = np.array([[p.x, p.y, p.euler[-1]]])
    sox, soy, S = m._subgrid_for(base, p.x, p.y, P)
    lx, ly, n = query.local_points_padded(P)
    q_lx, q_ly = np.where(np.arange(P) < n, lx, 1.0e9), np.where(np.arange(P) < n, ly, 1.0e9)
    args = (idx, mask, pose, q_idx, center, center[:, :2],
            np.array([[sox, soy]], dtype=np.int32))
    return args, S, (q_lx[None], q_ly[None], np.array([n], dtype=np.int32))


# -- the divisor -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("res", [0.01, 0.02, 0.05])
def test_cached_divisor_divides_as_a_fresh_tensor(dtype, res):
    """The cached 0-dim divisor (made by a fill, no host copy) is bit-equal
    to a fresh torch.tensor(res), and so is every quotient."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(-30.0, 30.0, 4096), dtype=dtype)
    fresh = torch.tensor(res, dtype=dtype)
    assert _equal(C.divisor(res, dtype, "cpu"), fresh)
    assert _equal(C._true_div(x, res), x / fresh)
    assert C.divisor(res, dtype, "cpu") is C.divisor(res, dtype, torch.device("cpu"))


# -- the split _run --------------------------------------------------------------

@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("explicit", [False, True])
def test_split_run_equals_the_eager_run(room, meta, explicit):
    """_compute(_stage(...)) gives the packed result (and meta grid) of
    _run as it was before the split, bit for bit."""
    base, queries = room
    m = _matcher(return_meta=meta)
    if explicit:
        P = m._ensure_point_cap(base + queries[:1])
        m.library.ensure(base, P)
        args, S, q = _explicit(m, base, queries[0], P)
    else:
        args, P, S = m._prepare([(q, base[:k + 2]) for k, q in enumerate(queries)])
        q = None
    off = m.config.coarse_search_angle_offset
    want, want_grid = _seed_run(m, args, P, True, True, off, S, q)
    got, got_grid = m._run(args, P, True, True, off, S, q)
    direct, direct_grid = m._compute(m._stage(args, q), S, True, True, off)
    assert _equal(got, want) and _equal(direct, want)
    if meta:
        assert _equal(got_grid, want_grid) and _equal(direct_grid, want_grid)
    else:
        assert got_grid is None and direct_grid is None


def test_split_run_matches_jax(room):
    """match_many (its batch padded to four rows) and match_scan through
    the split _run against the JAX package at test_torch_matcher's
    tolerance."""
    base, queries = room
    jm = JaxMatcher(TEST_CFG, dtype=np.float64, use_patch=True, use_pallas=False)
    tm = _matcher()
    jobs = [(q, base[:k + 2]) for k, q in enumerate(queries)]
    for a, b in zip(jm.match_many(jobs), tm.match_many(jobs)):
        assert a.response > 0.3
        _assert_same(a, b)
    _assert_same(jm.match_scan(queries[1], base), tm.match_scan(queries[1], base))


# -- the graph cache ---------------------------------------------------------------

def _cache():
    return graphs.GraphCache(graph=StandInGraph)


def _via(cache, m):
    """Route m._run through `cache` (on the CPU _run runs eagerly)."""
    m._run = lambda *a, **k: cache.run(m, *a, **k)
    return m


def test_one_capture_per_key_at_its_second_use(room):
    base, queries = room
    cache, m = _cache(), _matcher()
    args, P, S = m._prepare([(queries[0], base)])
    off = m.config.coarse_search_angle_offset
    want, _ = m._run(args, P, True, True, off, S)
    for use in range(1, 6):
        got, _ = cache.run(m, args, P, True, True, off, S)
        assert _equal(got, want)
        captured = use >= graphs.CAPTURE_AT_USE
        assert cache.stats["captures"] == int(captured)
        assert cache.stats["eager"] == min(use, graphs.CAPTURE_AT_USE - 1)
        assert cache.stats["replays"] == max(0, use - graphs.CAPTURE_AT_USE + 1)
    # other flags are other keys
    cache.run(m, args, P, False, True, off, S)
    cache.run(m, args, P, True, False, off, S)
    assert len(cache._entries) == 3 and cache.stats["captures"] == 1


def test_padded_batches_share_a_key(room):
    """match_many pads its rows to a power of two: batches of three and
    four jobs share one key, and the padding changes no result."""
    base, queries = room
    cache = _cache()
    m = _via(cache, _matcher())
    plain = _matcher()
    jobs3 = [(q, base[:k + 2]) for k, q in enumerate(queries)]
    jobs4 = jobs3 + [(queries[0], base)]
    for jobs in (jobs3, jobs4, jobs3):
        for a, b in zip(m.match_many(jobs), plain.match_many(jobs)):
            assert a.response == b.response and np.array_equal(a.covariance, b.covariance)
            assert (a.best_pose.x, a.best_pose.y) == (b.best_pose.x, b.best_pose.y)
    assert len(cache._entries) == 1
    (key,) = cache._entries
    assert key.N == 4 and cache.stats == dict(cache.stats, eager=1, captures=1, replays=2)


def test_replays_leave_earlier_results_intact(room):
    """Two dispatches at one key, the first result kept while the graph
    runs again (a batch in flight, a pipeline block, mega's chunks): each
    equals its own eager result."""
    base, queries = room
    cache, m = _cache(), _matcher()
    off = m.config.coarse_search_angle_offset
    runs = []
    for q in queries:
        args, P, S = m._prepare([(q, base)])
        runs.append((args, P, S))
    Ss = {S for _, _, S in runs}
    assert len(Ss) == 1          # one key
    want = [m._run(args, P, True, True, off, S)[0] for args, P, S in runs]
    got = [cache.run(m, args, P, True, True, off, S)[0] for args, P, S in runs]
    assert cache.stats["replays"] == 2
    assert not _equal(want[1], want[2])
    for a, b in zip(got, want):
        assert _equal(a, b)


def test_a_second_matcher_reuses_the_entry(room):
    base, queries = room
    cache = _cache()
    made = StandInGraph.made
    for m in (_matcher(), _matcher(), _matcher()):
        args, P, S = m._prepare([(queries[1], base)])
        got, _ = cache.run(m, args, P, True, True, m.config.coarse_search_angle_offset, S)
        assert _equal(got, m._run(args, P, True, True, m.config.coarse_search_angle_offset,
                                  S)[0])
    assert len(cache._entries) == 1 and StandInGraph.made == made + 1
    assert cache.stats["replays"] == 2


def test_launches_count_at_each_replay(room):
    """A capture's launches do not count (nothing ran); each replay adds
    them; eager uses on the CPU launch nothing."""
    base, queries = room
    cache, m = _cache(), _matcher()
    args, P, S = m._prepare([(queries[2], base)])
    off = m.config.coarse_search_angle_offset
    K.reset_launches()
    for use in range(1, 5):
        cache.run(m, args, P, True, True, off, S)
        replays = max(0, use - graphs.CAPTURE_AT_USE + 1)
        assert K.LAUNCHES == {k: n * replays for k, n in CAPTURED.items()}
    (entry,) = cache._entries.values()
    assert entry.launches == CAPTURED
    K.reset_launches()


def test_library_growth_changes_no_result_and_no_capture(room):
    """The library's rows are gathered outside the graph, so its growth
    past the initial slots (a reallocation of every field) neither
    changes a result nor causes a recapture."""
    base, queries = room
    cache, m = _cache(), _matcher()
    jobs = [(queries[0], base)]
    off = m.config.coarse_search_angle_offset
    args, P, S = m._prepare(jobs)
    want, _ = m._run(args, P, True, True, off, S)
    for _ in range(2):
        cache.run(m, args, P, True, True, off, S)
    fields = m.library.fields
    others = [make_room_scan(0.001 * i, 0.0, 0.0, n_beams=90, seed=100 + i)
              for i in range(_LIBRARY_INITIAL_CAP + 10)]
    m.library.ensure(others, P)
    assert m.library.K_cap == 2 * _LIBRARY_INITIAL_CAP
    assert m.library.fields["lx"] is not fields["lx"]
    args2, P2, S2 = m._prepare(jobs)
    assert (P2, S2) == (P, S) and np.array_equal(args2[0], args[0])
    got, _ = cache.run(m, args2, P, True, True, off, S)
    assert _equal(got, want)
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 2


def test_device_args_are_copied_into_the_static_inputs(room):
    """The chained pipeline passes device tensors: they are copied into
    the same static inputs as host arrays, with the same result."""
    base, queries = room
    cache, m = _cache(), _matcher()
    args, P, S = m._prepare([(queries[1], base)])
    off = m.config.coarse_search_angle_offset
    want, _ = m._run(args, P, True, True, off, S)
    for a in (args, tuple(torch.as_tensor(x) for x in args), args):
        got, _ = cache.run(m, a, P, True, True, off, S)
        assert _equal(got, want)
    with pytest.raises(ValueError, match="expected shape"):
        cache.run(m, (args[0], args[1][:, :1]) + args[2:], P, True, True, off, S)
