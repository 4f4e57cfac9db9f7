"""The splice's batched sweep, centroids and edges against the one-start
march and the JAX package's splice, on the CPU.

``raytrace.trace_sweeps_ref`` (the plain twin of ``csrc/sweep.cu``) must
give, bit for bit and row for row, what ``trace_rays`` gives from each
start, and what the one-start march below gives: the earlier
``trace_rays``' tensor ops, kept here as they were.  Against the JAX
package's ``trace_rays`` the lengths agree within test_torch_splicing's
RAY_TOL / MAX_STEP_RAYS (float32 cos / sin may round apart in the last
bit; see there).  ``determine_centroids`` (one bincount pass) is equal to
the JAX package's, and ``create_edges`` (every boundary window at once)
returns its list in its order, on the rendered map and on seeded label
images with labels at the border, a missing id and one segment.
``map_to_graph`` makes one sweep call, for all centroids in id order.
The edge inputs of chip_smoke's phase 11 (pixels at and beside the
thresholds, NaN, +-inf and negative values; starts on the border, outside
the image and on .5 pixels; max_steps 1 and 2; 50 angles, 650 rays) are
held the same way, and the long-ray map is checked to run long rays.
The CUDA dispatch is checked without a card: a sweep on a CUDA tensor
launches its kernel or raises, and never runs its plain version.
"""
import ast
import inspect
import os
import re

import numpy as np
import pytest
import torch

from yag_slam_tpu.mapping.raytrace import trace_rays as jax_trace_rays
from yag_slam_tpu.splicing import splice as jax_splice
import chip_smoke
from yag_slam_tpu_torch import _build
from yag_slam_tpu_torch.mapping import raytrace as RT
from yag_slam_tpu_torch.splicing import splice

from test_splicing import make_map_image
from test_torch_splicing import (
    DENSITY, HALF_PIXEL_FAR, SWEEP, _random_image, assert_rays_close)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_start_march(img, angles_deg, sx, sy, max_steps=None):
    """The earlier trace_rays on the CPU: one start, all (angle, step)
    samples as an (A, max_steps) float32 tensor, sx and sy Python floats;
    max_steps the image's diagonal plus 2 unless given."""
    img = torch.as_tensor(np.asarray(img).astype(np.float32))
    h, w = img.shape
    max_steps = max_steps or int(np.ceil(np.hypot(h, w))) + 2
    ang = torch.as_tensor(np.deg2rad(np.asarray(angles_deg, dtype=np.float64)).astype(np.float32))
    sx, sy = float(sx), float(sy)
    c, s = torch.cos(ang), torch.sin(ang)
    k = torch.arange(max_steps, dtype=torch.float32)
    px = sx + c[:, None] * k[None, :]
    py = sy + s[:, None] * k[None, :]
    xi = torch.round(px).to(torch.int32)
    yi = torch.round(py).to(torch.int32)
    vals = img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
    val_stop = vals < 210
    out_border = (yi < 1) | (xi < 1) | (xi >= w - 1) | (yi >= h - 1)
    border_next = torch.cat([out_border[:, 1:], torch.ones((len(ang), 1), dtype=torch.bool)],
                            dim=1)
    first = (val_stop | border_next).to(torch.uint8).argmax(dim=1)
    val_at = vals.gather(1, first[:, None])[:, 0]
    stopped = val_stop.gather(1, first[:, None])[:, 0]
    poison = stopped & (val_at > 180) & (val_at < 210)
    dist = (first + 1).to(torch.float32) + torch.where(poison, 1000.0, 0.0)
    ex = sx + c * dist
    ey = sy + s * dist
    ln = torch.sqrt((ex - sx) ** 2 + (ey - sy) ** 2)
    return ex.numpy(), ey.numpy(), ln.numpy()


@pytest.fixture(scope="module")
def rendered():
    """test_splicing's two-room map, its labels and every centroid."""
    grid = make_map_image()
    im = grid.image
    seg = splice.segment_map(im, density=DENSITY, device="cpu")
    cents = splice.determine_centroids(seg)
    return grid, im, seg, np.array([cents[k] for k in range(len(cents))])


RANDOM_STARTS = {
    "integer": [(80.0, 60.0), (20.0, 33.0), (140.0, 100.0), (5.0, 5.0)],
    "half_pixel": [(20.5, 33.5), (80.5, 60.0), (100.0, 40.5), (60.5, 90.5)],
}


def _check_rows(img, angles, starts):
    """trace_sweeps_ref over all starts, row s == trace_rays and the
    one-start march from start s, lengths and ends, bit for bit."""
    img_t, c, s, st, max_steps = RT._upload(img, angles, starts, torch.device("cpu"))
    ln, ex, ey = (t.numpy() for t in RT.trace_sweeps_ref(img_t, c, s, st, max_steps,
                                                         ends=True))
    assert ln.shape == (len(starts), len(angles)) and ln.dtype == np.float32
    np.testing.assert_array_equal(RT.trace_sweeps(img, angles, starts, device="cpu"), ln)
    for i, (sx, sy) in enumerate(starts):
        for got, want in zip((ex[i], ey[i], ln[i]), RT.trace_rays(img, angles, sx, sy,
                                                                 device="cpu")):
            np.testing.assert_array_equal(got, want)
        for got, want in zip((ex[i], ey[i], ln[i]), one_start_march(img, angles, sx, sy)):
            np.testing.assert_array_equal(got, want)
    return ln


@pytest.mark.parametrize("kind", sorted(RANDOM_STARTS))
def test_sweeps_equal_the_one_start_march_on_the_random_image(kind):
    img = _random_image()
    angles = np.arange(-180, 180, 1.5)
    ln = _check_rows(img, angles, RANDOM_STARTS[kind])
    assert (ln > 1000).any()      # an unknown patch poisons some ray


def test_sweeps_equal_the_one_start_march_at_every_centroid(rendered):
    _, im, _, starts = rendered
    assert len(starts) >= 2
    _check_rows(im, SWEEP, starts)


def test_sweeps_in_small_chunks_equal_one_chunk(rendered, monkeypatch):
    """The plain version's chunking over starts changes no bit."""
    _, im, _, starts = rendered
    whole = RT.trace_sweeps(im, SWEEP, starts, device="cpu")
    monkeypatch.setattr(RT, "_SAMPLE_CHUNK", 1)
    np.testing.assert_array_equal(RT.trace_sweeps(im, SWEEP, starts, device="cpu"), whole)


def test_sweeps_match_jax_at_every_centroid(rendered):
    _, im, _, starts = rendered
    got = RT.trace_sweeps(im, SWEEP, starts, device="cpu")
    ref = np.stack([jax_trace_rays(im, SWEEP, x, y)[2] for x, y in starts])
    assert_rays_close(got, ref)


@pytest.mark.parametrize("kind", sorted(RANDOM_STARTS))
def test_sweeps_match_jax_on_the_random_image(kind):
    img = _random_image()
    angles = np.arange(-180, 180, 3.0)
    starts = RANDOM_STARTS[kind]
    got = RT.trace_sweeps(img, angles, starts, device="cpu")
    for row, (sx, sy) in zip(got, starts):
        # at 60 and 120 degrees (a cosine of a half) a start on whole or
        # half pixels samples exact .5 positions, which the last bit of a
        # float32 cosine rounds either way (the port's length is the
        # oracle's there: (20, 33) at 120 degrees ends 1 px past JAX's)
        assert_rays_close(row, jax_trace_rays(img, angles, sx, sy)[2], max_far=HALF_PIXEL_FAR)


def test_sweep_of_no_start_or_no_angle_is_empty():
    img = _random_image()
    assert RT.trace_sweeps(img, np.arange(0, 360, 10.0), np.zeros((0, 2)),
                           device="cpu").shape == (0, 36)
    assert RT.trace_sweeps(img, [], [(50.0, 50.0)], device="cpu").shape == (1, 0)


# -- phase 11's edge inputs and long-ray map ----------------------------------------

EDGE = chip_smoke.sweep_edge_inputs()


def test_edge_inputs_hold_every_edge():
    """The image holds each edge value; the starts lie on the 1-px border,
    outside the image and on .5 pixels; neither the angles nor the rays
    fill a warp or a block evenly."""
    im, angles, starts = EDGE
    for v in chip_smoke.SWEEP_EDGE_VALUES:
        assert (np.isnan(im).any() if np.isnan(v) else (im == np.float32(v)).any()), v
    assert np.float32(chip_smoke.SWEEP_EDGE_VALUES[2]) < 210 < 255
    h, w = im.shape
    x, y = starts[:, 0], starts[:, 1]
    assert ((x == 1) | (y == 1) | (x == w - 2) | (y == h - 2)).sum() >= 4
    assert ((x < 0) | (y < 0) | (x > w - 1) | (y > h - 1)).sum() >= 3
    assert ((x % 1 == 0.5) | (y % 1 == 0.5)).sum() >= 4
    assert len(angles) % 32 and len(starts) * len(angles) % 32
    assert chip_smoke.SWEEP_EDGE_STEPS[:2] == (1, 2)


@pytest.mark.parametrize("max_steps", chip_smoke.SWEEP_EDGE_STEPS)
def test_sweeps_equal_the_one_start_march_on_the_edge_inputs(max_steps):
    im, angles, starts = EDGE
    img_t, c, s, st, own = RT._upload(im, angles, starts, torch.device("cpu"))
    m = max_steps or own
    ln, ex, ey = (t.numpy() for t in RT.trace_sweeps_ref(img_t, c, s, st, m, ends=True))
    assert ln.shape == (13, 50) and np.isfinite(ln).all()
    for i, (sx, sy) in enumerate(starts):
        for got, want in zip((ex[i], ey[i], ln[i]), one_start_march(im, angles, sx, sy, m)):
            np.testing.assert_array_equal(got, want)
    if max_steps is None:
        # the image's own steps: trace_rays and trace_sweeps take the same
        np.testing.assert_array_equal(RT.trace_sweeps(im, angles, starts, device="cpu"), ln)
    else:
        assert (np.floor(ln) <= m + 1000).all()


def test_sweeps_match_jax_on_the_edge_inputs():
    im, angles, starts = EDGE
    got = RT.trace_sweeps(im, angles, starts, device="cpu")
    ref = np.stack([jax_trace_rays(im, angles, x, y)[2] for x, y in starts])
    assert_rays_close(got, ref)
    assert (got > 1000).any()     # an unknown pixel poisons some ray


def test_long_ray_map_runs_long_rays():
    """Phase 11's long-ray map: walled in, its rays hundreds of steps long
    on average, the longest past a thousand, some poisoned (every 40th of
    the splice's angles)."""
    im, starts = chip_smoke.long_ray_map()
    n = chip_smoke.SWEEP_LONG_SIZE
    assert im.shape == (n, n) and (im[[0, -1]] == 0).all() and (im[:, [0, -1]] == 0).all()
    assert starts.shape == (chip_smoke.SWEEP_LONG_STARTS, 2)
    img_t, c, s, st, m = RT._upload(im, chip_smoke.SPLICE_ANGLES[::40], starts,
                                    torch.device("cpu"))
    first, poison = RT.first_events(img_t, c, s, st, m)
    assert (first + 1).double().mean() > 300 and int(first.max()) + 1 > 1000
    assert poison.any()


def test_phase_11_sweep_cases():
    """Phase 11's cases: every centroid first, then one start, the long-ray
    map and the edge inputs at max_steps 1, 2 and their own."""
    im, angles, starts = EDGE
    cases = chip_smoke.sweep_cases(im, starts[:3], torch.device("cpu"))
    assert [name for name, _ in cases] == [
        "3 centroids", "one start", "long-ray map", "edge inputs, max_steps 1",
        "edge inputs, max_steps 2", "edge inputs, max_steps 80"]
    assert [args[3].shape[0] for _, args in cases] == [3, 1, 16, 13, 13, 13]
    assert all(args[1].shape[0] == 1439 for _, args in cases[:3])
    row = chip_smoke.sweep_case(*cases[3], timed=False)
    assert row["max_abs_err"] == 0 and row["longest"] == 1 and row["steps"] == 650


# -- centroids and edges -----------------------------------------------------------

def voronoi_labels(seed, h, w, n, holes=3):
    """Labels 1..n of the nearest of n random sites, with `holes` zeroed
    rectangles; regions reach the border."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform([0, 0], [h, w], (n, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    d = (yy[..., None] - sites[:, 0]) ** 2 + (xx[..., None] - sites[:, 1]) ** 2
    seg = (d.argmin(axis=-1) + 1).astype(np.int32)
    for _ in range(holes):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        seg[y0:y0 + rng.integers(2, 9), x0:x0 + rng.integers(2, 9)] = 0
    return seg


def label_cases():
    missing = voronoi_labels(3, 40, 56, 7)
    missing[missing == 4] = 2               # id 4 (key 3) missing
    one = np.zeros((30, 30), np.int32)
    one[5:25, 3:30] = 1                    # one segment, at the right border
    stripes = np.repeat(np.arange(1, 7, dtype=np.int32), 5)[None, :].repeat(12, 0)
    return {"voronoi_a": voronoi_labels(0, 48, 64, 9), "voronoi_b": voronoi_labels(1, 33, 71, 14),
            "voronoi_dense": voronoi_labels(2, 60, 60, 40, holes=6), "missing_id": missing,
            "one_segment": one, "stripes": stripes, "empty": np.zeros((8, 9), np.int32)}


LABELS = label_cases()


@pytest.mark.parametrize("name", sorted(LABELS))
def test_centroids_equal_jax(name):
    seg = LABELS[name]
    got, want = splice.determine_centroids(seg), jax_splice.determine_centroids(seg)
    assert got == want and list(got) == list(want)
    if name == "missing_id":
        assert 3 not in got and 2 in got and 4 in got


def test_centroids_equal_jax_on_the_rendered_map(rendered):
    _, _, seg, _ = rendered
    got, want = splice.determine_centroids(seg), jax_splice.determine_centroids(seg)
    assert got == want and list(got) == list(want) == list(range(len(want)))


@pytest.mark.parametrize("min_shared", [1, 4])
@pytest.mark.parametrize("name", sorted(LABELS))
def test_edges_equal_jax_in_order(name, min_shared):
    seg = LABELS[name]
    got = splice.create_edges(seg, min_shared=min_shared)
    assert got == jax_splice.create_edges(seg, min_shared=min_shared)
    assert all(type(a) is int and type(b) is int and a < b for a, b in got)
    if name.startswith("voronoi"):
        assert len(got) >= 3


@pytest.mark.parametrize("min_shared", [1, 4])
def test_edges_equal_jax_in_order_on_the_rendered_map(rendered, min_shared):
    _, _, seg, _ = rendered
    got = splice.create_edges(seg, min_shared=min_shared)
    assert got and got == jax_splice.create_edges(seg, min_shared=min_shared)


# -- the splice --------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs(rendered):
    grid, im, _, _ = rendered
    origin = [grid.offset.x, grid.offset.y]
    return (splice.map_to_graph(im, grid.resolution, origin, density=DENSITY, device="cpu"),
            jax_splice.map_to_graph(im, grid.resolution, origin, density=DENSITY))


def test_map_to_graph_matches_jax(graphs):
    """The same scans (number, order, poses, beam layout) with ranges within
    the ray bar, and the same edges in the same order."""
    (scans, edges), (jscans, jedges) = graphs
    assert len(scans) == len(jscans) >= 2 and [s.num for s in scans] == list(range(len(scans)))
    for s, j in zip(scans, jscans):
        assert (s.corrected_pose.x, s.corrected_pose.y) == (j.corrected_pose.x, j.corrected_pose.y)
        assert s.ranges.dtype == np.asarray(j.ranges).dtype and len(s.ranges) == 1439
        assert (s.min_angle, s.angle_increment) == (j.min_angle, j.angle_increment)
    res = 0.05
    assert_rays_close(np.concatenate([s.ranges for s in scans]) / res,
                      np.concatenate([j.ranges for j in jscans]) / res)
    assert edges == jedges and edges


def test_map_to_graph_ranges_are_the_one_start_march_s(graphs, rendered):
    """Each scan's ranges are the one-start march from its centroid, in
    metres, poisoned past 20 m, bit for bit."""
    grid, im, _, starts = rendered
    (scans, _), _ = graphs
    for scan, (x, y) in zip(scans, starts):
        ranges = one_start_march(im, SWEEP, x, y)[2] * grid.resolution
        np.testing.assert_array_equal(scan.ranges, np.where(ranges > 20.0, 100.0, ranges))


def test_map_to_graph_makes_one_sweep_call(rendered, monkeypatch):
    """One sweep of every centroid in id order, and no trace_rays."""
    grid, im, seg, starts = rendered
    calls = []
    real = RT.sweep
    monkeypatch.setattr(RT, "sweep", lambda *a, **k: calls.append(a[3].clone()) or real(*a, **k))
    monkeypatch.setattr(splice, "trace_rays", lambda *a, **k: pytest.fail("trace_rays ran"))
    monkeypatch.setattr(splice, "segment_map", lambda *a, **k: seg)
    splice.map_to_graph(im, grid.resolution, [0.0, 0.0], density=DENSITY, device="cpu")
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0].numpy(), starts.astype(np.float32))


def test_cpu_sweep_leaves_launch_counts_at_zero(rendered):
    _, im, _, starts = rendered
    RT.reset_launches()
    RT.trace_sweeps(im, SWEEP[:10], starts, device="cpu")
    RT.trace_rays(im, SWEEP[:10], *starts[0], device="cpu")
    assert RT.LAUNCHES == {"splice_sweep": 0}


# -- the CUDA dispatch, without a card ----------------------------------------------

class _FakeLibrary:
    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if name != "yag_sweep":
            raise AttributeError(name)
        return lambda *args: self.calls.append(args) or self.err


@pytest.fixture
def fake_card(monkeypatch):
    """The sweep sees its tensors as CUDA tensors; its plain version fails
    the test if it runs."""
    monkeypatch.setattr(RT, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(RT, "_stream", lambda t: 0)
    monkeypatch.setattr(RT, "trace_sweeps_ref", lambda *a, **k: pytest.fail("plain version ran"))

    def use(err):
        lib = _FakeLibrary(err)
        monkeypatch.setattr(_build, "library", lambda: lib)
        return lib

    return use


def _inputs(S=3, A=5):
    return (torch.zeros((7, 9), dtype=torch.float32), torch.ones(A), torch.zeros(A),
            torch.full((S, 2), 3.0), 14)


@pytest.mark.parametrize("ends", [False, True])
def test_cuda_tensors_launch_the_kernel_and_never_the_plain_version(fake_card, ends):
    lib = fake_card(0)
    RT.reset_launches()
    out = RT.sweep(*_inputs(), ends=ends)
    assert RT.LAUNCHES == {"splice_sweep": 1} and len(lib.calls) == 1
    args = lib.calls[0]
    assert args[1:3] == (7, 9) and args[5] == 5 and args[7:9] == (3, 14)
    assert (args[10] is not None) == ends and (args[11] is not None) == ends
    for t in (out if ends else (out,)):
        assert t.shape == (3, 5) and t.dtype == torch.float32
    fake_card(9)
    with pytest.raises(RuntimeError, match="splice_sweep kernel launch failed: cudaError 9"):
        RT.sweep(*_inputs(), ends=ends)
    assert RT.LAUNCHES == {"splice_sweep": 2}


def test_cuda_sweep_checks_its_inputs(fake_card):
    lib = fake_card(0)
    img, c, s, st, m = _inputs()
    with pytest.raises(TypeError, match="img"):
        RT.sweep(img.double(), c, s, st, m)
    with pytest.raises(ValueError, match="starts"):
        RT.sweep(img, c, s, st[:, :1].contiguous(), m)
    with pytest.raises(ValueError, match="sin"):
        RT.sweep(img, c, s[:4], st, m)
    with pytest.raises(ValueError, match="max_steps"):
        RT.sweep(img, c, s, st, 0)
    assert RT.sweep(img, c, s, st[:0], m).shape == (0, 5) and not lib.calls


def test_cuda_sweep_without_a_card_raises(monkeypatch):
    """Here there is no card and no nvcc: a CUDA tensor's sweep raises at
    the kernel's build; the trace entry points raise at the device."""
    monkeypatch.setattr(RT, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(RT, "trace_sweeps_ref", lambda *a, **k: pytest.fail("plain version ran"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_library_path", lambda *a: _build.BUILD_DIR / "absent.so")
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        RT.sweep(*_inputs())
    if not torch.cuda.is_available():
        img = _random_image()
        for call in (lambda: RT.trace_sweeps(img, [0.0], [(5.0, 5.0)]),
                     lambda: RT.trace_rays(img, [0.0], 5.0, 5.0, device="cuda"),
                     lambda: splice.map_to_graph(img, 0.05, [0, 0], device="cuda")):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_sweep_dispatches_only_by_device():
    """The wrapper takes its plain version only on the CPU, first thing,
    with no try / except around the launch; it counts a launch after the
    library call."""
    tree = ast.parse(inspect.getsource(RT))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "sweep")
    first = fn.body[1]
    assert isinstance(first, ast.If) and ast.unparse(first.test).startswith("not _on_cuda(")
    assert ast.unparse(first.body[0]).startswith("return trace_sweeps_ref(")
    rest = ast.unparse(ast.Module(body=fn.body[2:], type_ignores=[]))
    assert "_ref(" not in rest and "LAUNCHES['splice_sweep'] += 1" in rest
    assert rest.index("yag_sweep(") < rest.index("LAUNCHES['splice_sweep'] += 1")
    # map_to_graph sweeps through trace_sweeps once, outside its scan loop
    mtg = ast.parse(inspect.getsource(splice.map_to_graph))
    names = [n.func.id for n in ast.walk(mtg) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)]
    assert names.count("trace_sweeps") == 1 and "trace_rays" not in names
    loop = next(n for n in ast.walk(mtg) if isinstance(n, ast.For))
    assert "trace_sweeps" not in ast.unparse(loop)


def test_sweep_kernel_is_in_the_library_build():
    """sweep.cu is one of the CUDA sources the library builds; its entry
    point is declared; the kernel table names the JAX function it
    replaces."""
    srcs, _ = _build._sources()
    assert "sweep.cu" in {p.name for p in srcs}
    assert "yag_sweep" in _build._SIGNATURES and len(_build._SIGNATURES["yag_sweep"]) == 13
    assert set(RT.KERNELS) == set(RT.LAUNCHES) == {"splice_sweep"}
    info = RT.KERNELS["splice_sweep"]
    path, line = info["replaces"].rsplit(":", 1)
    text = open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1]
    assert text.startswith("def _trace_rays_device(")
    src = open(os.path.join(REPO, info["source"])).read()
    assert all(re.search(rf"__global__ void (__launch_bounds__\([^)]*\)\s*)?{s}\(", src)
               for s in info["symbols"])
    assert 'extern "C" int yag_sweep(' in src
    # every float32 product and sum of the march is rounded on its own: a
    # step's position (pixel, and x in a chunk inside the border, rounded
    # by the adder) and the end; the steps ahead count by sums
    body = src[src.index("__device__ __forceinline__ int2 pixel("):src.index('extern "C"')]
    assert "__fadd_rn(q.sx, __fmul_rn(q.c, kf))" in body
    assert "__fadd_rn(__fadd_rn(q.sx, __fmul_rn(q.c, kn)), kMagic)" in body
    assert "__fadd_rn(q.sy, __fmul_rn(q.s, kn))" in body
    assert "__fadd_rn(q.sx, __fmul_rn(q.c, dist))" in body
    assert "pixel(q, __fadd_rn(kf, (float)(i + 1)))" in body
    assert not re.search(r"[^_]\b(?:q\.[cs]|kf|kn|dist|dx|dy) \* ", body)
