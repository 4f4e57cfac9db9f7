"""The benchmark's map cell (tour833-maps) on the CPU: its float64
reference (benchmark/map_oracle.py) against the port's plain path on a
60-scan prefix of the tour, its rules on hand-made inputs, the float16 and
bfloat16 controls against the cell's limits, and the cell itself run small."""
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import cells, holds, map_oracle, measure, spread  # noqa: E402
from benchmark import run as entry  # noqa: E402
from yag_slam_tpu_torch import LocalizedRangeScan  # noqa: E402
from yag_slam_tpu_torch.mapping import occupancy  # noqa: E402
from yag_slam_tpu_torch.mapping.raytrace import trace_rays  # noqa: E402
from yag_slam_tpu_torch.splicing import splice  # noqa: E402

SPEC = json.loads((pathlib.Path(REPO) / "BENCHMARK.json").read_text())
MAPS = next(w for w in SPEC["workloads"] if w["name"] == "tour833-maps")
BARS, TR = MAPS["correct"], MAPS["traffic"]
RES, RT = TR["resolution_m"], TR["range_threshold_m"]
# the tests' size: a 60-scan prefix of seed 0's tour, one render every 20
# scans, one segment a ~600k free-pixel mass (the cell's density is 5)
N, STEP, DENSITY = 60, 20, 1
SMALL = dict(scans=N, render_prefix_step=STEP, renders_per_pass=3, render_passes=1,
             warm_passes=0, splice_density=DENSITY, splice_repeats=1, trace_renders=2)


@pytest.fixture(scope="module")
def tour60():
    """The cell's set-up on the port's CPU float32 path at 60 scans: the
    corrected scans, the saved map and its origin, the reference's renders
    at the held prefixes, and the splice with its recorded labels."""
    scans, closures, image, origin = cells.map_setup("cpu", torch.float32, 0, N, RES, RT)
    records = [map_oracle.scan_record(s) for s in scans]
    refs = {k: map_oracle.render(records[:k], RES, RT) for k in cells.held_prefixes(N, STEP)}
    return dict(scans=scans, closures=closures, image=image, origin=origin, records=records,
                refs=refs, splice=cells.spliced(image, RES, origin, DENSITY, "cpu"))


# -- the reference against the port ------------------------------------------------

@pytest.mark.parametrize("k", [20, 40, 60])
def test_the_port_s_renders_are_the_reference_s(tour60, k):
    grid = cells.grid_of(cells.render_map(tour60["scans"][:k], RES, RT, "cpu"))
    gap = cells.hold_render(grid, tour60["refs"][k], BARS["render_cell_tol"])
    assert gap["ok"] and gap["same_grid"] and gap["tri_state"], gap
    assert gap["cell_share"] <= BARS["render_cell_tol"]
    assert (grid["image"] == map_oracle.FREE).mean() > 0.05
    assert (grid["image"] == map_oracle.OCCUPIED).mean() > 0.005


def test_the_port_s_splice_is_the_reference_s(tour60):
    """Labels, segment count, centroids, edges and every sweep within the
    cell's bars; at this size every segment's pixels are the reference's,
    so every scan's rays are held."""
    checks, report = cells.hold_splice(tour60["image"], RES, tour60["origin"], DENSITY,
                                       *tour60["splice"], BARS, TR["rays_per_sweep"])
    assert all(c["ok"] for c in checks), checks
    assert report["segments"] == report["reference_segments"] == report["same_segments"] >= 8
    assert report["edges"] > 0 and report["edges_apart_own_labels"] == 0
    assert report["reference_label_edges_apart"] == 0 and report["ids_apart"] == []
    assert report["centroid_apart_px"] <= 1e-9
    assert report["rays"]["rays"] == report["segments"] * 1439


def _bent(scans, dx=0.0, roll=0):
    """Copies of the splice's scans: the fourth moved `dx` metres in x,
    every scan's ranges rolled by `roll` angle steps."""
    out = []
    for i, s in enumerate(scans):
        x, y, th = cells.xyt(s.corrected_pose)
        o = LocalizedRangeScan(np.roll(s.ranges, roll), s.min_angle, s.max_angle,
                               s.angle_increment, s.min_range, s.max_range, s.range_threshold,
                               x + (dx if i == 3 else 0.0), y, th)
        o.num = s.num
        out.append(o)
    return out


@pytest.mark.parametrize("change, failing", [
    (dict(dx=1e-3 * RES), ["segment_centroids_apart_px"]),
    (dict(dx=-6.0 * RES), ["segment_centroids_apart_px", "segment_centroids_from_reference_px"]),
    (dict(roll=1), ["sweep_rays_apart_share"]),
    (dict(roll=-4), ["sweep_rays_apart_share"]),
])
def test_the_splice_check_refuses_a_moved_centroid_or_angle_table(tour60, change, failing):
    """A scan a thousandth of a pixel off its segment's centroid, or six
    pixels off, or every sweep along an angle table shifted by a step or
    more, fails the checks the reference's own centroids and angle table
    make."""
    scans, edges, labels = tour60["splice"]
    checks, _ = cells.hold_splice(tour60["image"], RES, tour60["origin"], DENSITY,
                                  _bent(scans, **change), edges, labels, BARS,
                                  TR["rays_per_sweep"])
    assert [c["name"] for c in checks if not c["ok"]] == failing


def test_the_sweep_angle_table_is_the_splice_s():
    """-180 degrees upward in 0.25-degree steps, 1,439 of them, reversed;
    the splice's scans span -pi to pi less a step."""
    deg = map_oracle.SWEEP_DEG
    assert len(deg) == TR["rays_per_sweep"] == 1439
    assert deg[-1] == -180.0 and deg[0] == 179.5 and (np.diff(deg) == -0.25).all()


def test_the_saved_map_is_stored_top_row_first(tour60):
    grid = cells.render_map(tour60["scans"], RES, RT, "cpu")
    np.testing.assert_array_equal(tour60["image"], grid.image[::-1])
    assert tour60["origin"] == (grid.offset.x, grid.offset.y)
    assert tour60["closures"] >= 1 and len(tour60["scans"]) == N


@pytest.mark.parametrize("pick", [0, 5, 11])
def test_the_reference_sweep_is_trace_rays(tour60, pick):
    im = tour60["image"]
    starts = sorted(map_oracle.centroids(tour60["splice"][2]).items())
    x, y = starts[pick % len(starts)][1]
    deg = map_oracle.SWEEP_DEG
    got = trace_rays(im, deg, x, y, device="cpu")[2]
    ref = map_oracle.sweep(im, [(x, y)], np.deg2rad(deg))[0]
    gap = map_oracle.sweep_gaps(got, ref, BARS["ray_length_tol_px"])
    assert gap["share_apart"] <= BARS["ray_step_share_tol"] and gap["max_gap"] < 1e-3
    assert (ref > 1000).any() and (ref < 1000).any()
    r = map_oracle.ranges(ref, RES)
    assert set(r[r > 20.0]) == {100.0} and (r <= 20.0).any()


# -- the controls ------------------------------------------------------------------

@pytest.fixture(scope="module")
def controls():
    """The controls read at the cell's size: the whole tour of seed 0 at its
    ground-truth poses, rendered by the reference (a ~565 x 325 px map,
    ~285 segments at the cell's density 5) at every prefix the cell holds
    in any pass, swept from 24 of its centroids.  (At the 60-scan prefix
    the pixel coordinates stay under 364, where float16 still resolves a
    quarter pixel.)"""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        records, gt, _ = cells.tour_records(0, tmp)
    recs = [dict(map_oracle.scan_record(s), pose=tuple(g))
            for s, g in zip(cells._scans(records, TR["scans"]), gt)]
    refs = {k: map_oracle.render(recs[:k], RES, RT)
            for k in cells.all_held_prefixes(TR["scans"], TR["render_prefix_step"],
                                             TR["render_passes"])}
    image = np.ascontiguousarray(refs[TR["scans"]]["image"][::-1])
    labels = map_oracle.segments(image, TR["splice_density"])
    cents = map_oracle.centroids(labels)
    starts = [cents[k] for k in sorted(cents)[::max(1, len(cents) // 24)]]
    return {p: map_oracle.control_readings(recs, refs, image, labels, TR["splice_density"],
                                           RES, RT, BARS["ray_length_tol_px"], p, starts)
            for p in holds.PRECISIONS}


@pytest.mark.parametrize("precision", holds.PRECISIONS)
def test_a_lower_precision_render_fails_the_render_check(controls, precision):
    shares = controls[precision]["render_cell_share"]
    assert sorted(shares) == [95, 190, 280, 375, 415, 465, 560, 650, 745, 833]
    assert all(v > BARS["render_cell_tol"] for v in shares.values()), shares


@pytest.mark.parametrize("precision", holds.PRECISIONS)
def test_a_lower_precision_k_means_fails_the_label_check(controls, precision):
    assert controls[precision]["label_flip_share"] > BARS["label_flip_tol"]
    assert controls[precision]["segments"][1] > 200


@pytest.mark.parametrize("precision", holds.PRECISIONS)
def test_lower_precision_centroids_fail_the_centroid_checks(controls, precision):
    """Centroids kept in float16 or bfloat16 fail the rule check; a
    bfloat16 k-means moves centroids past centroid_tol_px too (a float16
    one fails on its label flips)."""
    assert controls[precision]["centroid_apart_px"] > BARS["centroid_rule_tol_px"]
    assert (controls[precision]["moved_centroid_apart_px"] > BARS["centroid_tol_px"]) == \
        (precision == "bfloat16")


@pytest.mark.parametrize("precision", holds.PRECISIONS)
def test_lower_precision_angles_fail_the_sweep_check(controls, precision):
    rays = controls[precision]["rays"]
    assert rays["rays"] >= 24 * 1439 and rays["share_apart"] > BARS["ray_step_share_tol"]


# -- the reference's rules on hand-made inputs --------------------------------------

def _scan(ranges, x=0.0, y=0.0, th=0.0, min_angle=0.0, inc=0.1):
    return LocalizedRangeScan(np.asarray(ranges, dtype=np.float64), min_angle,
                              min_angle + inc * (len(ranges) - 1), inc, 0.0, 30.0, RT, x, y, th)


def test_render_rule_on_one_beam():
    """A 0.5 m beam along +x: samples at 0..9 cells, the endpoint's cell one
    pass and one hit more; three of them make the cells free and the
    endpoint occupied; a beam past the threshold marks no hit."""
    recs = [map_oracle.scan_record(_scan([0.5])) for _ in range(3)]
    ref = map_oracle.render(recs, RES, RT)
    assert ref["origin"] == (-RES, -RES) and ref["height"] == 3 and ref["width"] >= 13
    row = ref["image"][1]
    assert row[1:11].tolist() == [map_oracle.FREE] * 10 and row[11] == map_oracle.OCCUPIED
    assert row[0] == map_oracle.UNKNOWN and (row[12:] == map_oracle.UNKNOWN).all()
    assert (ref["image"][[0, 2]] == map_oracle.UNKNOWN).all()
    far = map_oracle.render([map_oracle.scan_record(_scan([13.0]))] * 3, RES, RT)
    assert map_oracle.OCCUPIED not in far["image"]
    port = occupancy.create_occupancy_grid([_scan([0.5])] * 3, resolution=RES,
                                           range_threshold=RT, device="cpu")
    np.testing.assert_array_equal(port.image, ref["image"])


def test_render_rule_hits_against_passes():
    """A cell is occupied when 10 hits >= passes: one beam ending in a cell
    that nine other beams pass is occupied (1 hit, 10 passes), one that
    ten others pass is free (1 hit, 11 passes)."""
    def image(n_passing):
        recs = [map_oracle.scan_record(_scan([0.5]))]
        recs += [map_oracle.scan_record(_scan([1.0])) for _ in range(n_passing)]
        return map_oracle.render(recs, RES, RT)["image"][1]

    assert image(9)[11] == map_oracle.OCCUPIED and image(10)[11] == map_oracle.FREE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_free_space_is_an_opening(seed):
    rng = np.random.default_rng(seed)
    im = np.zeros((90, 70), dtype=np.uint8)
    for x0, y0, w, h in rng.integers(0, 60, (6, 4)):
        im[y0:y0 + h // 3 + 12, x0:x0 + w // 3 + 12] = 255
    im[rng.random(im.shape) < 0.02] = 254
    im[rng.random(im.shape) < 0.02] = 0
    want = ndimage.binary_opening(im >= 254, structure=np.ones((11, 11), bool))
    np.testing.assert_array_equal(map_oracle.free_space(im), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1])
def test_edges_follow_the_splice_s_rule(seed):
    """The reference's edges of a label image are the port's
    create_edges'."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((80, 90), dtype=np.int64)
    labels[5:75, 5:85] = 1 + (np.arange(5, 85)[None, :] // 20) + 4 * (np.arange(5, 75)[:, None] // 35)
    labels[rng.random(labels.shape) < 0.01] = 0
    want = set(splice.create_edges(labels))
    assert map_oracle.edges(labels) == want and len(want) >= 7


def test_sweep_rule_in_a_box():
    """A 21 x 21 box of free space, walls 0 at x = 15 and unknown (190) at
    y = 3: a ray into the wall ends one step past it, a ray into the
    unknown 1,000 px further, and a ray through an open border at the
    border."""
    im = np.full((21, 21), 255, dtype=np.uint8)
    im[:, 15] = 0
    im[3, :] = 190
    deg = np.array([0.0, -90.0, 180.0])
    got = map_oracle.sweep(im, [(10.0, 10.0)], np.deg2rad(deg))[0]
    assert got.tolist() == [6.0, 1008.0, 10.0]
    np.testing.assert_allclose(trace_rays(im, deg, 10.0, 10.0, device="cpu")[2], got, atol=1e-4)


def test_k_means_rule_on_two_blobs():
    """Two 50 x 50 rooms: 5,000 free pixels make two segments, one a room,
    as the port's segmentation labels them."""
    im = np.zeros((60, 130), dtype=np.uint8)
    im[5:55, 5:55] = 255
    im[5:55, 75:125] = 255
    labels = map_oracle.segments(im, 1)
    assert set(np.unique(labels)) == {0, 1, 2}
    assert len(np.unique(labels[5:55, 5:55])) == len(np.unique(labels[5:55, 75:125])) == 1
    np.testing.assert_array_equal(labels, splice.segment_map(im, density=1, device="cpu"))


# -- the cell ----------------------------------------------------------------------

def test_render_prefixes_are_the_mapper_s():
    ks = cells.render_prefixes(TR["scans"], TR["render_prefix_step"])
    assert len(ks) == TR["renders_per_pass"] == 167 and ks[:2] == [5, 10] and ks[-2:] == [830, 833]
    held = [cells.held_prefixes(TR["scans"], TR["render_prefix_step"], p, 3) for p in range(3)]
    assert held == [[95, 375, 415, 650, 833], [190, 415, 465, 745, 833], [280, 415, 560, 833]]
    assert cells.all_held_prefixes(TR["scans"], TR["render_prefix_step"], 3) == \
        [95, 190, 280, 375, 415, 465, 560, 650, 745, 833]
    assert cells.render_prefixes(N, STEP) == [20, 40, 60]
    assert cells.held_prefixes(N, STEP) == [20, 40, 60]
    assert cells.render_prefixes(10, 5) == [5, 10] and cells.held_prefixes(10, 5) == [5, 10]


def test_maps_cell_on_the_cpu(tmp_path):
    """60 scans, prefixes 20 / 40 / 60, one pass, one splice: every metric,
    check and span is there and the verdict is correct; the traced run's
    wraps are undone."""
    render_fn, splice_fns = occupancy.create_occupancy_grid, {
        k: getattr(splice, k) for k in cells.SPLICE_SPANS}
    r = cells.tour833_maps("cpu", 0, out_dir=str(tmp_path), **SMALL)
    assert list(r["metrics"]) == [m["name"] for m in MAPS["metrics"]]
    assert r["metrics"]["peak_device_mb"] is None
    assert all(np.isfinite(v) and v > 0 for k, v in r["metrics"].items() if k != "peak_device_mb")
    assert r["correct"], [c for c in r["checks"] if not c["ok"]]
    assert sorted(c["name"] for c in r["checks"]) == sorted([
        "renders_tri_state", "pass0_render20_cell_share", "pass0_render40_cell_share",
        "pass0_render60_cell_share", "splice_repeats_agree", "segment_label_flip_share",
        "segment_count", "segment_centroids_apart_px", "segment_centroids_from_reference_px",
        "segment_edges_apart", "same_segment_edges_apart", "sweep_rays_apart_share",
        "sweep_rays"])
    assert r["detail"]["render_samples"] == 3 and len(r["detail"]["splice_ms"]) == 1
    pl = r["per_layer"]
    spans = pl["spans"]
    assert spans["create_occupancy_grid"]["calls"] == spans["_render_counts"]["calls"] == 3
    assert spans["map_to_graph"]["calls"] == spans["segment_map"]["calls"] == 1
    assert spans["determine_centroids"]["calls"] == spans["create_edges"]["calls"] == 1
    # every segment's sweep is one trace_sweeps call inside map_to_graph
    assert "trace_rays" not in spans and r["detail"]["splice"]["segments"] >= 2
    assert pl["renders"]["window"]["count"] == 2 and pl["splice"]["window"]["count"] == 1
    assert pl["renders"]["device_idle_share"] is None and pl["graph_pool_mb"] is None
    assert pl["peak_allocated_mb"] is None
    assert occupancy.create_occupancy_grid is render_fn
    assert all(getattr(splice, k) is fn for k, fn in splice_fns.items())
    assert (tmp_path / "tour833-maps-seed0-spans.json").is_file()
    assert (tmp_path / "tour833-maps-seed0-renders-trace.json").is_file()
    lines = "\n".join(entry.report(r, "a card line", "a host CPU"))
    assert all(f"{k}: " in lines for k in r["metrics"]) and "peak_device_mb: not measured" in lines
    got = spread.readings(json.loads(json.dumps(r)))
    assert got["maps"]["render_cell_share"] == 0.0 and got["maps"]["edges_apart"] == [0, 0, 0]


def test_maps_cell_refuses_a_prefix_count_that_is_not_its_own():
    with pytest.raises(ValueError, match="renders a pass"):
        cells.tour833_maps("cpu", 0, **dict(SMALL, renders_per_pass=4))


def test_recorded_restores_the_module():
    """Spans.wrap with a list records each call's (args, result); restore
    puts the module's function back after a failure too."""
    fn, calls, spans = splice.create_edges, [], measure.Spans()
    labels = np.zeros((3, 3), dtype=np.int64)
    with pytest.raises(RuntimeError):
        spans.wrap(splice, "create_edges", "create_edges", calls)
        try:
            out = splice.create_edges(labels)
            assert len(calls) == 1 and calls[0][0][0] is labels and calls[0][1] is out
            raise RuntimeError("out")
        finally:
            spans.restore()
    assert splice.create_edges is fn and [r["name"] for r in spans.records] == ["create_edges"]


def test_spread_reads_a_run_without_the_memory_metric(tmp_path, capsys):
    """An earlier tree's run (no peak_device_mb) reads null there; the
    bounded metrics' spread is computed as before."""
    def run(v, peak):
        metrics = dict(matches_per_s=v, setup_s=1.0)
        if peak is not None:
            metrics["peak_device_mb"] = peak
        return dict(cell="office360-batch64", seed=0, traffic={}, card="c", host_cpu="h",
                    correct=True, checks=[], metrics=metrics,
                    detail=dict(oracle={"batch": dict(worst={}, expanded=0)}))

    paths = []
    for i, (v, peak) in enumerate([(100.0, None), (125.0, 51.0), (80.0, 52.0)]):
        p = tmp_path / f"run{i}.out"
        p.write_text("a line\n" + json.dumps(run(v, peak)) + "\n")
        paths.append(str(p))
    spread.main(paths)
    out = json.loads(capsys.readouterr().out)["office360-batch64 {}"]
    assert out["reported"]["peak_device_mb"] == [None, 51.0, 52.0]
    assert out["metrics"]["matches_per_s"]["bound_pct"] == 38


def test_spread_splits_the_rate_by_repeat():
    runs = [dict(detail=dict(repeats=[dict(scans_per_s=a), dict(scans_per_s=b)]))
            for a, b in [(100.0, 300.0), (50.0, 300.0), (100.0, 330.0)]]
    out = spread.repeat_spread(runs)
    assert out["repeat0"]["median"] == 100.0 and out["repeat0"]["max_rel_from_median"] == 0.5
    assert out["repeat1"]["values"] == [300.0, 300.0, 330.0]
    assert spread.repeat_spread([dict(detail=dict())]) is None
