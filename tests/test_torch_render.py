"""The port's map render against its numpy twin and the JAX package's on
the CPU.

``mapping.occupancy.create_occupancy_grid`` (one host gather, then the
two stages of ``mapping.render_kernel``, the endpoints and the image, here
their plain versions) must
give, exactly (the same image, width and height, the same float64 offset
to the bit), the render of :func:`_numpy_render`: the JAX package's host
loop in numpy float64 and its ``_render_counts`` as numpy float32
operations, each rounded on its own.  Against the JAX package itself the
grid and offset are the same to the bit and the image at most
``JAX_CELL_TOL`` of its cells apart: XLA compiles ``x0 + dx * t`` into a
fused multiply-add in float32 mode, and with x64 on (the conftest's) it
divides ``(px - ox) / res`` in float64 (its origin is a numpy float64); so
a step within a rounding of a cell's edge can land in the next cell there
(one cell of ~1e5 in the inputs below, for the port before this render
too).  Inputs come from numpy seeds: mixed beam counts, inf / nan ranges
and ranges outside [min_range, max_range], beams past range_threshold, a
single scan, more beams than one chunk of the plain trace, a tour's
prefixes at their corrected poses; the trace alone on a grid its beams
leave; chip_smoke's endpoint cases (scans of 0 to 1,081 beams in one
table).  The CUDA dispatch is checked without a card: a wrapper on a CUDA
tensor launches its kernel or raises, and never runs its plain version,
and a render launches the endpoints and the trace in image mode.
"""
import ast
import ctypes
import inspect
import os
import re

import numpy as np
import pytest
import torch

from yag_slam_tpu.mapping import occupancy as jax_occupancy
from yag_slam_tpu_torch import LocalizedRangeScan, Transform, _build
from yag_slam_tpu_torch.io.benchmark import building_tour_trajectory, building_world
from yag_slam_tpu_torch.io.simulator import simulate_scan
from yag_slam_tpu_torch.mapping import occupancy
from yag_slam_tpu_torch.mapping import render_kernel as R

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan(rng, n, x, y, t, *, min_range=0.1, max_range=20.0, spread=8.0, holes=0.0):
    """A scan of n beams at (x, y, t) with ranges up to `spread` m; a
    share `holes` of them inf, nan, below min_range or above max_range."""
    r = rng.uniform(0.0, spread, n)
    bad = rng.uniform(size=n) < holes
    r[bad] = rng.choice([np.inf, np.nan, -np.inf, 0.5 * min_range, max_range + 1.0,
                         min_range, max_range], bad.sum())
    inc = 2 * np.pi / max(n, 1) * rng.uniform(0.5, 1.0)
    a0 = -np.pi + rng.uniform(0, 0.5)
    return LocalizedRangeScan(r, a0, a0 + inc * (n - 1), inc, min_range, max_range, 12.0,
                              x, y, t)


def _random_scans(seed, counts, **kw):
    rng = np.random.default_rng(seed)
    return [_scan(rng, n, *rng.uniform(-3, 3, 2), rng.uniform(-np.pi, np.pi), **kw)
            for n in counts]


# the share of cells the JAX package's render may set otherwise (see above)
JAX_CELL_TOL = 1e-4


def _loop_endpoints(scans, rt):
    """The JAX package's host loop (numpy, float64), which the gather and
    beam_endpoints replace: the valid beams' origins, ends and hit flags."""
    origins, ends, hits = [], [], []
    for scan in scans:
        p = scan.corrected_pose
        x, y, t = p.x, p.y, p.euler[-1]
        r = np.asarray(scan.ranges, dtype=np.float64)
        n = len(r)
        angles = t + scan.min_angle + np.arange(n) * scan.angle_increment
        ok = np.isfinite(r) & (r > scan.min_range) & (r <= scan.max_range)
        rr = np.where(ok, r, 0.0)
        clipped = np.minimum(rr, rt)
        ex = x + clipped * np.cos(angles)
        ey = y + clipped * np.sin(angles)
        origins.append(np.stack([np.full(n, x), np.full(n, y)], axis=1)[ok])
        ends.append(np.stack([ex, ey], axis=1)[ok])
        hits.append((rr < rt)[ok])
    return np.concatenate(origins), np.concatenate(ends), np.concatenate(hits)


def _numpy_counts(origins, ends, hits, ox, oy, res, width, height, max_steps):
    """Passes and hits of the JAX package's _render_counts as numpy
    float32 operations, each rounded on its own."""
    f32 = np.float32
    x0, y0 = origins.astype(f32).T
    x1, y1 = ends.astype(f32).T
    ox, oy, res = f32(ox), f32(oy), f32(res)
    dx, dy = x1 - x0, y1 - y0
    n = np.minimum(np.ceil(np.maximum(np.abs(dx) / res, np.abs(dy) / res)), f32(max_steps))
    inv = f32(1.0) / np.maximum(n, f32(1.0))
    k = np.arange(max_steps, dtype=f32)
    t = k[None, :] * inv[:, None]

    def cells(p, o, lim):
        return np.clip(np.rint((p - o) / res), -1, lim).astype(np.int64)

    cx = cells(x0[:, None] + dx[:, None] * t, ox, width)
    cy = cells(y0[:, None] + dy[:, None] * t, oy, height)
    ok = (k[None, :] < n[:, None]) & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    passes = np.bincount((cy * width + cx)[ok], minlength=width * height)
    ex, ey = cells(x1, ox, width), cells(y1, oy, height)
    end_ok = (ex >= 0) & (ex < width) & (ey >= 0) & (ey < height)
    lin = (ey * width + ex)[end_ok]
    passes += np.bincount(lin, minlength=width * height)
    hit = np.bincount(lin, weights=hits[end_ok], minlength=width * height).astype(np.int64)
    return passes.reshape(height, width), hit.reshape(height, width)


def _numpy_image(passes, hits, mpt):
    visited = passes > mpt
    occupied = visited & (hits.astype(np.float32)
                          >= np.float32(0.1) * passes.astype(np.float32)) & (hits > 0)
    return np.where(occupied, 0, np.where(visited, 255, 200)).astype(np.uint8)


def _numpy_render(scans, res, rt, mpt):
    origins, ends, hits = _loop_endpoints(scans, rt)
    xs = np.concatenate([origins[:, 0], ends[:, 0]])
    ys = np.concatenate([origins[:, 1], ends[:, 1]])
    ox, oy = xs.min() - res, ys.min() - res
    width = int(np.ceil((xs.max() - ox) / res)) + 2
    height = int(np.ceil((ys.max() - oy) / res)) + 2
    max_steps = int(np.ceil(rt / res)) + 2
    passes, hit = _numpy_counts(origins, ends, hits, ox, oy, res, width, height, max_steps)
    return dict(image=_numpy_image(passes, hit, mpt), width=width, height=height,
                offset=(ox, oy))


def _same_grid(scans, res, rt, mpt=occupancy.MIN_PASS_THROUGH):
    got = occupancy.create_occupancy_grid(scans, res, rt, mpt, device="cpu")
    twin = _numpy_render(scans, res, rt, mpt)
    assert (got.width, got.height) == (twin["width"], twin["height"])
    assert (got.offset.x, got.offset.y) == twin["offset"]
    assert got.image.dtype == np.uint8
    np.testing.assert_array_equal(got.image, twin["image"])
    jax_grid = jax_occupancy.create_occupancy_grid(scans, res, rt, mpt)
    assert (got.width, got.height) == (jax_grid.width, jax_grid.height)
    assert (got.offset.x, got.offset.y) == (jax_grid.offset.x, jax_grid.offset.y)
    assert (got.image != jax_grid.image).mean() <= JAX_CELL_TOL
    return got


CASES = {
    # mixed beam counts, every kind of invalid range, beams past the
    # 5 m threshold (clipped, no hit)
    "mixed": dict(seed=0, counts=[180, 7, 361, 1, 90, 180], res=0.05, rt=5.0, holes=0.2),
    "single": dict(seed=1, counts=[180], res=0.05, rt=12.0, holes=0.0),
    "single_one_beam": dict(seed=2, counts=[1], res=0.1, rt=12.0, holes=0.0),
    # 9,400 beams: the plain trace crosses a chunk of 8,192
    "two_chunks": dict(seed=3, counts=[2000, 3000, 4400], res=0.1, rt=6.0, holes=0.1),
    # every beam past range_threshold: no hit anywhere
    "all_clipped": dict(seed=4, counts=[200, 200], res=0.05, rt=0.5, holes=0.0),
    "coarse": dict(seed=5, counts=[180] * 8, res=0.25, rt=12.0, holes=0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_equals_jax(case):
    c = CASES[case]
    scans = _random_scans(c["seed"], c["counts"], holes=c["holes"])
    got = _same_grid(scans, c["res"], c["rt"])
    assert set(np.unique(got.image).tolist()) <= {0, 200, 255}


@pytest.mark.parametrize("mpt", [0, 5])
def test_render_min_pass_through_equals_jax(mpt):
    _same_grid(_random_scans(6, [180, 180, 90], holes=0.1), 0.05, 8.0, mpt)


def test_render_with_no_valid_beam_raises():
    scans = _random_scans(7, [20, 30], holes=1.0)
    for s in scans:
        s.ranges[:] = np.inf
    with pytest.raises(ValueError):
        jax_occupancy.create_occupancy_grid(scans, 0.05, 5.0)
    with pytest.raises(ValueError, match="no valid beam"):
        occupancy.create_occupancy_grid(scans, 0.05, 5.0, device="cpu")
    with pytest.raises(ValueError, match="at least one scan"):
        occupancy.create_occupancy_grid([], device="cpu")


@pytest.fixture(scope="module")
def tour60():
    """60 scans of the building tour (180 beams, 20 m), each at its
    corrected pose: the true pose plus a small seeded offset, as a SLAM
    pass leaves it."""
    world = building_world()
    gt = building_tour_trajectory(step=0.4, laps=1)[:60]
    rng = np.random.default_rng(8)
    scans = []
    for pose in gt:
        s = simulate_scan(world, pose, n_beams=180, max_range=20.0, noise=0.01, rng=rng)
        x, y, t = pose + rng.normal(0.0, [0.02, 0.02, 0.005])
        s.corrected_pose = Transform.from_xyt(x, y, t)
        scans.append(s)
    return scans


@pytest.mark.parametrize("k", list(range(5, 61, 5)))
def test_tour_prefixes_equal_jax(tour60, k):
    """Every fifth prefix, as the online mapper renders them."""
    got = _same_grid(tour60[:k], 0.05, 12.0)
    assert (got.image == occupancy.GRID_OCCUPIED).any() and (got.image == occupancy.GRID_FREE).any()


@pytest.mark.parametrize("case", ["mixed", "two_chunks"])
def test_beam_endpoints_equal_the_host_loop(case):
    """The gathered table and beam_endpoints' plain version give the host
    loop's float32 origins and ends and its hits on the valid beams, and its
    float64 bounding box to the bit."""
    c = CASES[case]
    scans = _random_scans(c["seed"], c["counts"], holes=c["holes"])
    table, ranges = occupancy._gather(scans, torch.device("cpu"))
    assert table.shape == (len(scans), len(R.COLS)) and table.dtype == torch.float64
    assert table[:, 7].tolist() == list(np.cumsum([0] + c["counts"][:-1]))
    seg, flag, box = R.beam_endpoints(table, ranges, c["rt"])
    origins, ends, hits = _loop_endpoints(scans, c["rt"])
    valid = (flag & 1).bool().numpy()
    assert valid.sum() == len(origins) < len(flag)
    np.testing.assert_array_equal(seg.numpy()[valid, :2], origins.astype(np.float32))
    np.testing.assert_array_equal(seg.numpy()[valid, 2:], ends.astype(np.float32))
    np.testing.assert_array_equal(((flag >> 1) & 1).bool().numpy()[valid], hits)
    assert not ((flag >> 1) & 1).bool().numpy()[~valid].any()
    xs, ys = np.concatenate([origins[:, 0], ends[:, 0]]), np.concatenate([origins[:, 1], ends[:, 1]])
    assert box.tolist() == [xs.min(), ys.min(), xs.max(), ys.max()]


def _jax_image(seg, flag, ox, oy, res, width, height, max_steps, mpt):
    """The JAX package's _render_counts on the same beams (its padded
    layout: invalid lanes masked by `valid`)."""
    s = seg.numpy()
    f = flag.numpy()
    return np.asarray(jax_occupancy._render_counts(
        s[:, 0], s[:, 1], s[:, 2], s[:, 3], (f & 2) > 0, (f & 1) > 0,
        np.float32(ox), np.float32(oy), np.float32(res), width=width, height=height,
        max_steps=max_steps, min_pass_through=mpt))


@pytest.mark.parametrize("frame", [(-1.0, -2.0, 40, 30), (0.5, 0.25, 25, 70),
                                   (-4.0, -4.0, 200, 200)])
def test_trace_on_a_grid_the_beams_leave(frame):
    """beam_counts and beam_image on a given frame that cuts through the
    beams (steps and ends outside it count nowhere, through the dump
    slot): passes, hits and image those of the numpy twin, the image
    within JAX_CELL_TOL of the JAX package's _render_counts."""
    ox, oy, width, height = frame
    res, rt, max_steps = 0.05, 6.0, int(np.ceil(6.0 / 0.05)) + 2
    scans = _random_scans(9, [180, 360, 45, 180], holes=0.1)
    scans[1].corrected_pose = Transform.from_xyt(-0.3, 0.1, 0.4)
    table, ranges = occupancy._gather(scans, torch.device("cpu"))
    seg, flag, _ = R.beam_endpoints(table, ranges, rt)
    counts = R.beam_counts(seg, flag, ox, oy, res, width, height, max_steps)
    assert counts.shape == (2, height, width) and counts.dtype == torch.int32
    passes, hits = counts.numpy()
    valid = (flag & 1).bool().numpy()
    s, f = seg.numpy()[valid], flag.numpy()[valid]
    want_p, want_h = _numpy_counts(s[:, :2], s[:, 2:], (f & 2) > 0, ox, oy, res, width,
                                   height, max_steps)
    np.testing.assert_array_equal(passes, want_p)
    np.testing.assert_array_equal(hits, want_h)
    assert 0 < hits.sum() < passes.sum() < valid.sum() * max_steps
    image = R.beam_image(seg, flag, ox, oy, res, width, height, max_steps, 2)
    assert image.shape == (height, width) and image.dtype == torch.uint8
    image = image.numpy()
    np.testing.assert_array_equal(image, _numpy_image(want_p, want_h, 2))
    jax_image = _jax_image(seg, flag, ox, oy, res, width, height, max_steps, 2)
    assert (image != jax_image).mean() <= JAX_CELL_TOL


def test_cpu_render_leaves_launch_counts_at_zero():
    R.reset_launches()
    occupancy.create_occupancy_grid(_random_scans(10, [90, 90]), 0.05, 5.0, device="cpu")
    assert all(v == 0 for v in R.LAUNCHES.values()), R.LAUNCHES


class _FakeLibrary:
    """The kernel library's entry points, recording their calls (name and
    arguments) and returning `err`; the endpoints' stand-in writes a box of
    (0, 0) - (1, 1) so that a render goes on to its grid."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if not name.startswith("yag_render_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            if name == "yag_render_endpoints":
                box = np.array([0.0, 0.0, 1.0, 1.0])
                ctypes.memmove(args[9], box.ctypes.data, box.nbytes)
            return self.err

        return call


@pytest.fixture
def fake_card(monkeypatch):
    """Every render wrapper sees its tensors as CUDA tensors; each plain
    version raises if it is called; the endpoints' scratch is made anew."""
    monkeypatch.setattr(R, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(R, "_stream", lambda t: 0)
    monkeypatch.setattr(R, "_END_SCRATCH", {})
    for name in ("beam_endpoints_ref", "beam_counts_ref", "beam_image_ref",
                 "classify_cells_ref"):
        monkeypatch.setattr(R, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} ran"))

    def use(err):
        lib = _FakeLibrary(err)
        monkeypatch.setattr(_build, "library", lambda: lib)
        return lib

    return use


def _wrapper_calls():
    table = torch.zeros((2, len(R.COLS)), dtype=torch.float64)
    seg = torch.zeros((5, 4), dtype=torch.float32)
    flag = torch.ones(5, dtype=torch.uint8)
    return [("render_endpoints", lambda: R.beam_endpoints(table, torch.ones(5, dtype=torch.float64), 5.0)),
            ("render_counts", lambda: R.beam_image(seg, flag, 0.0, 0.0, 0.05, 4, 3, 10, 2)),
            ("render_counts", lambda: R.beam_counts(seg, flag, 0.0, 0.0, 0.05, 4, 3, 10))]


# yag_render_trace's arguments: its min_pass_through and image pointer
_TRACE_MPT, _TRACE_IMAGE = 11, 12


def test_cuda_tensors_launch_the_kernels_and_never_the_plain_versions(fake_card):
    """On a CUDA tensor each wrapper calls its C entry point once and
    counts one launch: the endpoints, the trace in image mode (an image
    pointer) and in counts mode (none); a failed launch raises."""
    lib = fake_card(0)
    R.reset_launches()
    for name, call in _wrapper_calls():
        call()
    assert [c[0] for c in lib.calls] == ["yag_render_endpoints", "yag_render_trace",
                                         "yag_render_trace"]
    (_, end), (_, image), (_, counts) = lib.calls
    assert end[8] == R.END_MAX_BLOCKS and end[7] == R._END_SCRATCH[(torch.device("cpu"), 0)].data_ptr()
    assert image[_TRACE_IMAGE] is not None and image[_TRACE_MPT] == 2
    assert counts[_TRACE_IMAGE] is None
    assert R.LAUNCHES == {"render_endpoints": 1, "render_counts": 2}
    fake_card(9)
    for name, call in _wrapper_calls():
        with pytest.raises(RuntimeError, match=f"{name} kernel launch failed: cudaError 9"):
            call()
    assert R.LAUNCHES == {"render_endpoints": 2, "render_counts": 4}


def test_a_render_launches_the_endpoints_and_the_trace_in_image_mode(fake_card):
    """occupancy._render_counts on a CUDA table: yag_render_endpoints, then
    yag_render_trace in image mode on the grid of the box, and nothing else;
    one launch of each wrapper; the endpoints' scratch made once and kept."""
    lib = fake_card(0)
    R.reset_launches()
    table, ranges = occupancy._gather(_random_scans(11, [90, 0, 45]), torch.device("cpu"))
    for _ in range(2):
        image, ox, oy, width, height = occupancy._render_counts(table, ranges, 0.05, 5.0, 3)
        assert (ox, oy, width, height) == occupancy._frame([0.0, 0.0, 1.0, 1.0], 0.05, 5.0)[:4]
        assert image.shape == (height, width) and width > 20
    assert [c[0] for c in lib.calls] == ["yag_render_endpoints", "yag_render_trace"] * 2
    assert lib.calls[1][1][_TRACE_MPT] == 3 and lib.calls[1][1][_TRACE_IMAGE] is not None
    assert lib.calls[0][1][7] == lib.calls[2][1][7] and len(R._END_SCRATCH) == 1
    assert R.LAUNCHES == {"render_endpoints": 2, "render_counts": 2}


def test_render_counts_runs_only_the_dispatching_wrappers():
    """occupancy._render_counts, which holds all of a render's device
    work, calls the endpoints and the image wrappers (which dispatch by
    device), not the counts, and no plain version; create_occupancy_grid
    reaches it through the module global, once a render; the wrappers take
    their plain version only on the CPU, with no try / except around a
    launch; the counts and the image launch through one _trace."""
    src = inspect.getsource(occupancy._render_counts)
    names = {n.attr for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Attribute)}
    assert {"beam_endpoints", "beam_image"} <= names
    assert not names & {"beam_counts", "classify_cells"}
    assert not any(n.endswith("_ref") for n in names)
    calls = [n.func.id for n in ast.walk(ast.parse(inspect.getsource(
        occupancy.create_occupancy_grid))) if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Name)]
    assert calls.count("_render_counts") == 1
    tree = ast.parse(inspect.getsource(R))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert not {"classify_cells", "render_classify"} & set(fns)
    for name in KERNEL_OF:
        fn = fns[name]
        first = fn.body[1]     # after the docstring
        assert isinstance(first, ast.If) and "_on_cuda" in ast.unparse(first.test)
        assert ast.unparse(first.test).startswith("not ")
        assert ast.unparse(first.body[0]).startswith(f"return {fn.name}_ref(")
        rest = ast.unparse(ast.Module(body=fn.body[2:], type_ignores=[]))
        launch = f"LAUNCHES['{KERNEL_OF[fn.name]}'] += 1"
        assert "_ref(" not in rest and (launch in rest or "_trace(seg, flag" in rest)
    trace = ast.unparse(fns["_trace"])
    assert "LAUNCHES['render_counts'] += 1" in trace and "_ref(" not in trace


KERNEL_OF = {"beam_endpoints": "render_endpoints", "beam_counts": "render_counts",
             "beam_image": "render_counts"}


def test_render_kernels_are_in_the_library_build():
    """render.cu is one of the CUDA sources the library builds; its two
    entry points are declared and the classify kernel is gone; the kernel
    table names it and the JAX package's functions it replaces."""
    srcs, _ = _build._sources()
    assert "render.cu" in {p.name for p in srcs}
    for name in ("yag_render_endpoints", "yag_render_trace"):
        assert name in _build._SIGNATURES
    assert not any("classify" in name for name in _build._SIGNATURES)
    assert set(R.KERNELS) == set(R.LAUNCHES) == {"render_endpoints", "render_counts"}
    for info in R.KERNELS.values():
        assert os.path.isfile(os.path.join(REPO, info["source"]))
        path, line = info["replaces"].rsplit(":", 1)
        text = open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1]
        assert text.startswith(("def _render_counts(", "def create_occupancy_grid("))
    src = open(os.path.join(REPO, R.KERNELS["render_counts"]["source"])).read()
    for info in R.KERNELS.values():     # a kernel, with or without launch bounds
        assert all(re.search(rf"__global__ void (__launch_bounds__\([^)]*\)\s*)?{s}\(", src)
                   for s in info["symbols"])
    assert "classify_kernel" not in src and "cudaMemsetAsync(done" not in src


def test_map_cell_tour_renders_on_the_cpu():
    """chip_smoke.map_cell_tour, which phase 5 and tools/render_kernels.py
    render on the card: the map cell's tour cut to its first scans, each at
    its odometry pose, and a stand-in SLAM pass whose vertices are those
    scans and whose map is their render on the given device."""
    smoke = _smoke()
    scans, slam = smoke.map_cell_tour("cpu", 12)
    assert len(scans) == 12 and [v.obj for v in slam.graph.vertices] == scans
    assert all((s.corrected_pose.x, s.corrected_pose.y, s.corrected_pose.yaw)
               == (s.odom_pose.x, s.odom_pose.y, s.odom_pose.yaw) for s in scans)
    grid = slam.make_occupancy_grid(0.05, 12.0)
    want = occupancy.create_occupancy_grid(scans, 0.05, 12.0, device="cpu")
    assert (grid.width, grid.height) == (want.width, want.height) and grid.width > 50
    np.testing.assert_array_equal(grid.image, want.image)


def _smoke():
    import importlib.util
    import sys

    if REPO not in sys.path:      # chip_smoke imports the root-level *_torch.py harnesses
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", ["one_origin", "zero_steps", "clipped", "mixed_warp"])
def test_trace_cases_equal_the_numpy_twin(name):
    """chip_smoke's trace cases (phase 5 holds the kernel to the plain
    version on each): many beams from one cell, beams of 0 and 1 steps,
    beams clipped at max_steps, long, short and invalid beams within each
    warp's beams.  The plain version's passes and hits equal the numpy
    twin's; the image is within JAX_CELL_TOL of the JAX package's."""
    smoke = _smoke()
    assert name in smoke.TRACE_CASES
    seg_np, flag_np, frame = smoke.trace_case(name)
    ox, oy, res, width, height, max_steps = frame
    seg, flag = torch.as_tensor(seg_np), torch.as_tensor(flag_np)
    counts = R.beam_counts(seg, flag, *frame)
    passes, hits = counts.numpy()
    valid = (flag_np & 1) > 0
    s, f = seg_np[valid], flag_np[valid]
    want_p, want_h = _numpy_counts(s[:, :2], s[:, 2:], (f & 2) > 0, ox, oy, res, width,
                                   height, max_steps)
    np.testing.assert_array_equal(passes, want_p)
    np.testing.assert_array_equal(hits, want_h)
    dx = np.abs(seg_np[:, 2] - seg_np[:, 0]) / np.float32(res)
    dy = np.abs(seg_np[:, 3] - seg_np[:, 1]) / np.float32(res)
    n = np.minimum(np.ceil(np.maximum(dx, dy)), max_steps)[valid]
    assert 0 < hits.sum() < passes.sum() <= n.sum() + valid.sum()
    if name == "one_origin":
        assert len(np.unique(seg_np[:, :2], axis=0)) == 1 and passes.max() >= valid.sum()
    if name == "zero_steps":
        assert (n == 0).any() and (n == 1).any() and (n > 32).any()
    if name == "clipped":
        assert (n == max_steps).all()
    if name == "mixed_warp":
        assert not valid.all() and n.max() > 200 and n.min() <= 2
    image = R.beam_image(seg, flag, *frame, 2).numpy()
    np.testing.assert_array_equal(image, _numpy_image(want_p, want_h, 2))
    jax_image = _jax_image(seg, flag, ox, oy, res, width, height, max_steps, 2)
    assert (image != jax_image).mean() <= JAX_CELL_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_image_equals_the_twins_and_jax(case):
    """The image wrapper's plain path on each case's beams and grid: the
    numpy twin's image exactly, classify_cells_ref of beam_counts_ref
    exactly, and within JAX_CELL_TOL of the JAX package's _render_counts."""
    c = CASES[case]
    _image_equals_the_twins(_random_scans(c["seed"], c["counts"], holes=c["holes"]),
                            c["res"], c["rt"])


@pytest.mark.parametrize("k", [5, 30, 60])
def test_beam_image_equals_the_twins_and_jax_on_tour_prefixes(tour60, k):
    _image_equals_the_twins(tour60[:k], 0.05, 12.0)


def _image_equals_the_twins(scans, res, rt, mpt=occupancy.MIN_PASS_THROUGH):
    table, ranges = occupancy._gather(scans, torch.device("cpu"))
    seg, flag, box = R.beam_endpoints(table, ranges, rt)
    ox, oy, width, height, max_steps = occupancy._frame(box.tolist(), res, rt)
    frame = (*occupancy._f32(ox, oy, res), width, height, max_steps)
    image = R.beam_image(seg, flag, *frame, mpt)
    assert image.shape == (height, width) and image.dtype == torch.uint8
    assert torch.equal(image, R.classify_cells_ref(R.beam_counts_ref(seg, flag, *frame), mpt))
    valid = (flag & 1).bool().numpy()
    s, f = seg.numpy()[valid], flag.numpy()[valid]
    want_p, want_h = _numpy_counts(s[:, :2], s[:, 2:], (f & 2) > 0, *frame)
    np.testing.assert_array_equal(image.numpy(), _numpy_image(want_p, want_h, mpt))
    jax_image = _jax_image(seg, flag, *frame, mpt)
    assert (image.numpy() != jax_image).mean() <= JAX_CELL_TOL
    assert set(np.unique(image.numpy()).tolist()) <= {0, 200, 255}


@pytest.mark.parametrize("name", ["mixed", "empty_ends", "past_one_round"])
def test_endpoint_cases_equal_the_host_loop(name):
    """chip_smoke's endpoint cases (phase 5 holds the kernel to the plain
    version on each): scans of 0, 1, 180, 360 and 1,081 beams in one table,
    empty scans first and last, one scan with no valid range, more beams
    than the kernel takes in one round.  The plain version gives the JAX
    package's host loop's float32 origins and ends, hits and float64 box;
    the two small cases render as the numpy twin and the JAX package do."""
    smoke = _smoke()
    assert set(smoke.ENDPOINT_CASES) == {"mixed", "empty_ends", "past_one_round"}
    scans, rt = smoke.endpoint_case(name)
    n = [len(s.ranges) for s in scans]
    assert set(smoke.ENDPOINT_BEAM_COUNTS) <= set(n)
    table, ranges = occupancy._gather(scans, torch.device("cpu"))
    first = table[:, 7].numpy()
    assert first.tolist() == np.cumsum([0] + n[:-1]).tolist()
    assert len(set(np.diff(first).tolist())) >= 4      # uneven steps, 0 among them
    seg, flag, box = R.beam_endpoints(table, ranges, rt)
    origins, ends, hits = _loop_endpoints(scans, rt)
    valid = (flag & 1).bool().numpy()
    assert valid.sum() == len(origins) < len(flag)
    np.testing.assert_array_equal(seg.numpy()[valid, :2], origins.astype(np.float32))
    np.testing.assert_array_equal(seg.numpy()[valid, 2:], ends.astype(np.float32))
    np.testing.assert_array_equal(((flag >> 1) & 1).bool().numpy()[valid], hits)
    xs, ys = np.concatenate([origins[:, 0], ends[:, 0]]), np.concatenate([origins[:, 1], ends[:, 1]])
    assert box.tolist() == [xs.min(), ys.min(), xs.max(), ys.max()]
    if name == "mixed":
        lo, hi = int(first[7]), int(first[8])
        assert hi - lo == 180 and not valid[lo:hi].any()
    if name == "empty_ends":
        assert n[0] == n[1] == n[-1] == 0
    if name == "past_one_round":
        assert len(ranges) > R.END_MAX_BLOCKS * 256
    else:
        _same_grid(scans, 0.05, rt)


def test_trace_cases_run_on_the_cpu():
    """chip_smoke.trace_cases on the plain path: every case, and the image
    of no beam, every cell unknown."""
    rows = _smoke().trace_cases(torch.device("cpu"))
    assert [r["case"] for r in rows] == [*_smoke().TRACE_CASES, "no_beams"]
    seg, flag = torch.zeros((0, 4)), torch.zeros(0, dtype=torch.uint8)
    image = R.beam_image(seg, flag, 0.0, 0.0, 0.05, 7, 5, 10, 2)
    assert image.shape == (5, 7) and bool((image == occupancy.GRID_UNKNOWN).all())
