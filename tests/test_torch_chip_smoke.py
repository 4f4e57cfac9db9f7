"""chip_smoke.py's host-side arithmetic: the trace reader and the pose gap."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:      # chip_smoke imports the root-level *_torch.py harnesses
    sys.path.insert(0, REPO)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from yag_slam_tpu_torch.mapping.raytrace import KERNELS as SWEEP_KERNELS
from yag_slam_tpu_torch.mapping.render_kernel import KERNELS as RENDER_KERNELS
from yag_slam_tpu_torch.matching.kernels import KERNELS
from yag_slam_tpu_torch.matching.program_kernels import KERNELS as PROGRAM_KERNELS

NAMES = {k: v["symbols"] for k, v in KERNELS.items()}


def test_device_timeline_merges_only_device_events():
    events = [
        dict(cat="kernel", name="void (anonymous namespace)::smear_identity_kernel<"
             "(anonymous namespace)::QuantizeTable>(unsigned char const*, float const*, "
             "(anonymous namespace)::QuantizeTable, int, int)", ts=100.0, dur=10.0),
        dict(cat="kernel", name="at::native::elementwise_kernel", ts=105.0, dur=10.0),
        dict(cat="kernel", name="window_sum_kernel(int)", ts=108.0, dur=2.0),
        dict(cat="kernel", name="void (anonymous namespace)::smear_chain_kernel<"
             "(anonymous namespace)::FloatStore>(int)", ts=111.0, dur=1.0),
        # smear_quantize on a small grid takes the chain kernel
        dict(cat="kernel", name="void (anonymous namespace)::smear_chain_kernel<"
             "(anonymous namespace)::QuantizeMaskStore>(int)", ts=140.0, dur=3.0),
        # smear_grid on a large grid takes the identity kernel
        dict(cat="kernel", name="void (anonymous namespace)::smear_identity_kernel<"
             "(anonymous namespace)::RankTable>(unsigned char const*, float const*, "
             "(anonymous namespace)::RankTable, int, int)", ts=300.0, dur=2.0),
        dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=130.0, dur=4.0),
        dict(cat="gpu_memset", name="Memset", ts=200.0, dur=1.0),
        # host-side events never count as device time
        dict(cat="cpu_op", name="aten::add", ts=0.0, dur=1000.0),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=99.0, dur=5.0),
        dict(ph="M", name="process_name"),
    ]
    tl = smoke.device_timeline(events, NAMES)
    assert tl["events"] == 8
    # union of [100, 115), [130, 134), [140, 143), [200, 201), [300, 302) in us
    assert tl["busy_ms"] == pytest.approx((15.0 + 4.0 + 3.0 + 1.0 + 2.0) / 1e3)
    parts = tl["parts"]
    assert parts["smear_quantize"] == dict(ms=pytest.approx(0.013), count=2)
    assert parts["window_sum"] == dict(ms=pytest.approx(0.002), count=1)
    assert parts["smear_grid"] == dict(ms=pytest.approx(0.003), count=2)
    assert parts["scatter_cells"] == dict(ms=0.0, count=0)
    assert parts["other_kernels"] == dict(ms=pytest.approx(0.010), count=1)
    assert parts["memcpy_memset"] == dict(ms=pytest.approx(0.005), count=2)


@pytest.mark.parametrize("events", [[], [dict(cat="cpu_op", name="aten::mm", ts=0, dur=9)]])
def test_device_timeline_without_device_events(events):
    tl = smoke.device_timeline(events, NAMES)
    assert tl["busy_ms"] == 0.0 and tl["events"] == 0


def test_pose_gap_wraps_heading():
    a = np.array([[0.0, 0.0, np.pi - 0.001], [1.0, 2.0, 0.5]])
    b = np.array([[0.003, 0.004, -np.pi + 0.001], [1.0, 2.0, 0.5]])
    dxy, dth = smoke.pose_gap(a, b)
    assert dxy == pytest.approx(0.005)
    assert dth == pytest.approx(0.002)



NEW_PATHS = ("stream", "cli", "threaded", "lifelong", "spa_tour", "sharded",
             "sharded_slam", "ab_compare", "bench", "profile_match")


def _run_summary(zero=None):
    """A phase summary as run_slam returns it, with one launch on every
    path for every kernel (smear_grid only on its own paths); `zero` =
    (path, kernel) sets that count to 0."""
    def n(path, **kw):
        counts = {k: kw.get(k, 1) for k in (*KERNELS, *PROGRAM_KERNELS)}
        if zero and zero[0] == path:
            counts[zero[1]] = 0
        return counts

    case = dict(case="c", max_abs_err=0, ms=0.1, plain_ms=1.0, kernel_ms=0.05,
                bound_ms=0.01, bound_by="bytes", library_ms=None, library="none",
                share=0.2)
    checks = {k: [dict(case)] for k in (*KERNELS, *PROGRAM_KERNELS)}
    slam = dict(
        scans=4,
        launches=n("slam", smear_grid=0),
        matcher_api=dict(launches=dict(meta=n("meta"), scan_sets=n("scan_sets"),
                                       mega=n("mega", smear_grid=0))),
        localize=dict(launches=n("localize", world_scatter=0, lattice_window_sum=0,
                                 window_sum=0, score_reduce=0),
                      smear_case=dict(case, case="tour_map")),
        stream=dict(launches=n("stream", smear_grid=0),
                    modes=dict(launches=n("pipeline", smear_grid=0))),
        entry_points=dict(launches=dict(cli=n("cli", smear_grid=0),
                                        threaded=n("threaded", smear_grid=0))),
        lifelong=dict(launches=dict(n("lifelong", smear_grid=0), splice_sweep=1), splices=1,
                      sweep=dict(cases=[dict(case, case="376 centroids")])),
        spa=dict(tour=dict(launches=n("spa_tour", smear_grid=0))),
        last_modules=dict(sharded=dict(launches=n("sharded", smear_grid=0)),
                          sharded_slam=dict(launches=n("sharded_slam", smear_grid=0)),
                          ab_compare=dict(launches=n("ab_compare", smear_grid=0))),
        bench=dict(launches=n("bench", smear_grid=0),
                   profile=dict(launches=n("profile_match")),
                   rows={"64": dict(launches_per_match=dict.fromkeys(PROGRAM_KERNELS,
                                                                     0.03125))}),
        render=dict(renders=4, launches={k: 4 for k in RENDER_KERNELS},
                    cases={k: [dict(case, case="k=833"), dict(case, case="k=5")]
                           for k in RENDER_KERNELS}),
    )
    if zero and zero[0] == "render":
        slam["render"]["launches"][zero[1]] = 0
    if zero == ("lifelong", "splice_sweep"):
        slam["lifelong"]["launches"]["splice_sweep"] = 0
    return checks, slam


def test_kernel_lines_count_launches_by_path():
    from yag_slam_tpu_torch.matching import kernels as K

    checks, slam = _run_summary()
    rows = {r["name"]: r for r in smoke.kernel_lines(K, checks, slam)}
    assert set(rows) == (set(KERNELS) | set(PROGRAM_KERNELS) | set(RENDER_KERNELS)
                         | set(SWEEP_KERNELS))
    for k in smoke.SLAM_KERNELS + smoke.PROGRAM_KERNELS:
        assert set(NEW_PATHS) <= set(rows[k]["launches_by_path"])
        assert rows[k]["launches"] == sum(rows[k]["launches_by_path"].values())
    assert set(rows["smear_grid"]["launches_by_path"]) == {"meta", "scan_sets", "localize",
                                                           "profile_match"}
    assert rows["window_sum"]["route"] == "cuda"
    for r in rows.values():
        # the keys the result line must carry for every kernel
        assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launches",
                "max_abs_err", "replaces", "source"} <= set(r)
        assert r["ms"] == 0.05 and r["wrapper_ms"] == 0.1
    assert rows["window_sum"]["launches_per_scan"] == 0.25
    assert rows["smear_grid"]["launches_per_scan"] == 0.0
    for k in RENDER_KERNELS:
        assert rows[k]["launches_by_path"] == {"render": 4}
        assert rows[k]["launches_per_render"] == 1.0 and rows[k]["case"] == "k=833"
        assert rows[k]["replaces"].startswith("yag_slam_tpu/mapping/occupancy.py:")
    sweep = rows["splice_sweep"]
    assert sweep["launches_by_path"] == {"lifelong": 1} and sweep["launches"] == 1
    assert sweep["launches_per_splice"] == 1.0 and sweep["case"] == "376 centroids"
    assert sweep["replaces"] == "yag_slam_tpu/mapping/raytrace.py:25"
    assert sweep["source"] == "yag_slam_tpu_torch/csrc/sweep.cu" and sweep["route"] == "cuda"
    # the sweep's launch is not a matcher kernel's: the lifelong path's
    # matcher rows count only their own
    assert rows["window_sum"]["launches_by_path"]["lifelong"] == 1


def test_kernel_lines_fail_when_the_splice_skips_the_sweep():
    from yag_slam_tpu_torch.matching import kernels as K

    checks, slam = _run_summary(zero=("lifelong", "splice_sweep"))
    with pytest.raises(AssertionError, match="splice_sweep never launched on the lifelong path"):
        smoke.kernel_lines(K, checks, slam)
    del slam["lifelong"]["launches"]["splice_sweep"]
    with pytest.raises(AssertionError, match="splice_sweep never launched on the lifelong path"):
        smoke.kernel_lines(K, checks, slam)


def test_counted_resets_and_merges_every_module_s_launches(monkeypatch):
    """Phase 11 counts the matcher's kernels and the sweep from 0 around
    the splice, in one dict."""
    import torch

    from yag_slam_tpu_torch.mapping import raytrace as RT
    from yag_slam_tpu_torch.matching import kernels as K

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(K, "LAUNCHES", dict.fromkeys(K.LAUNCHES, 7))
    monkeypatch.setattr(RT, "LAUNCHES", {"splice_sweep": 5})

    def run():
        K.LAUNCHES["window_sum"] += 2
        RT.LAUNCHES["splice_sweep"] += 1
        return "out"

    out, launches = smoke.counted(K, run, RT)
    assert out == "out"
    assert launches == dict(dict.fromkeys(K.LAUNCHES, 0), window_sum=2, splice_sweep=1)
    assert smoke.counted(K, lambda: None)[1] == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("kernel", sorted(RENDER_KERNELS))
def test_kernel_lines_fail_when_the_render_skips_a_kernel(kernel):
    from yag_slam_tpu_torch.matching import kernels as K

    checks, slam = _run_summary(zero=("render", kernel))
    with pytest.raises(AssertionError, match=f"{kernel} never launched on the render path"):
        smoke.kernel_lines(K, checks, slam)


@pytest.mark.parametrize("path", NEW_PATHS)
def test_kernel_lines_fail_when_a_path_skips_a_kernel(path):
    from yag_slam_tpu_torch.matching import kernels as K

    checks, slam = _run_summary(zero=(path, "smear_quantize"))
    with pytest.raises(AssertionError, match=f"smear_quantize never launched on the {path}"):
        smoke.kernel_lines(K, checks, slam)


def test_kernel_lines_fail_when_the_staged_stage_skips_smear_grid():
    from yag_slam_tpu_torch.matching import kernels as K

    checks, slam = _run_summary(zero=("profile_match", "smear_grid"))
    with pytest.raises(AssertionError, match="smear_grid never launched on the profile_match"):
        smoke.kernel_lines(K, checks, slam)


def test_phase_14_counts_from_zero_and_prints_its_line(monkeypatch, capsys):
    """Phase 14's bookkeeping on the CPU: launches counted from 0 before
    bench_torch's rows (a stale count of an earlier path is not carried)
    and before one composed pass of profile_match_torch's stages (plain
    path here: no launch); the first batched jobs held card against host
    (both the plain path here); a line per row; a {"bench": ...} line
    that JSON takes.  bench_device and the stage timing (CUDA events) are
    stood in for; the stages run for real at 2 jobs."""
    import bench_torch
    import profile_match_torch
    import torch

    from yag_slam_tpu_torch.matching import kernels as K

    scans = bench_torch.build_stream(n_scans=16)
    row = dict(median=12.5, spread=[11.0, 13.0],
               launches_per_match={k: 1.0 for k in K.KERNELS})

    def bench_device(stream, device, repeats):
        assert stream is scans and device.type == "cpu" and repeats == bench_torch.REPEATS
        for k in smoke.SLAM_KERNELS:
            K.LAUNCHES[k] += 3
        return {"stream": row, "lockstep": row, "match_response": 0.97}

    real_setup = profile_match_torch.setup
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(bench_torch, "build_stream", lambda: scans)
    monkeypatch.setattr(bench_torch, "bench_device", bench_device)
    monkeypatch.setattr(profile_match_torch, "setup",
                        lambda device: real_setup(2, device=device, scans=scans))
    monkeypatch.setattr(profile_match_torch, "profile", lambda ctx: dict(shapes={"N": ctx["N"]}))
    monkeypatch.setattr(profile_match_torch, "report", lambda r, name, gpu: print("table"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(K, "LAUNCHES", dict(K.LAUNCHES, scatter_cells=99))
    out = smoke.bench_rows(torch.device("cpu"), "label")
    assert out["launches"] == {"scatter_cells": 3, "smear_quantize": 3, "smear_grid": 0,
                               "window_sum": 3, **dict.fromkeys(PROGRAM_KERNELS, 0)}
    assert out["profile"] == dict(shapes={"N": 2},
                                  launches={k: 0 for k in (*K.KERNELS, *PROGRAM_KERNELS)})
    assert out["held_jobs"] == smoke.BENCH_HELD_JOBS == 4
    # the CPU's plain path on both sides: no gap in either precision
    assert out["worst_gap"] == {d: dict(response=0.0, dxy_m=0.0, dth_rad=0.0, cov_rel=0.0,
                                        counts=0.0)
                                for d in ("torch.float64", "torch.float32")}
    assert set(out["rows"]) == {"stream", "lockstep", "match_response"}
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("phase 14: bench ") for ln in lines) == 2
    assert "phase 14: table" in lines
    assert json.loads(json.dumps({"bench": out}))["bench"]["launches"]["window_sum"] == 3


def test_flip_counts_is_the_largest_step_of_the_quantized_smear():
    """One cell's move changes a lookup of the benchmark's smeared grid by
    at most 13 counts: 100 x (exp(-0.5) - exp(-0.72)) = 11.97, rounded up,
    plus one for the floor; at 0.05 m cells 100 x (exp(-0.5) - exp(-2))
    = 47.12, so 49."""
    import bench_torch

    assert smoke.flip_counts(bench_torch.CFG) == 13
    assert smoke.flip_counts(dict(bench_torch.CFG, resolution=0.05)) == 49


def test_phase_12_prints_its_cells_through_profile_spa_torch(capsys):
    """Phase 12 (a) is profile_spa_torch.crossover with phase 12's log
    lines: one per cell, as before."""
    import torch

    rows = smoke.spa_crossover(torch.device("cpu"), "label", sizes=(100,), cg_sizes=())
    assert [r["solver"] for r in rows] == ["host", "dense:mixed", "dense:f64"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(ln.startswith("phase 12: SPA 105 nodes ") for ln in lines)
    assert lines[2].startswith("phase 12: SPA 105 nodes dense:f64: ")
    assert "LM iterations, host reads {'lm': " in lines[2] and lines[2].endswith("rad (label)")
    assert smoke.SPA_CG_SIZES == (100, 1000, 4000)


def test_solve_times_times_each_solve():
    """Phase 12's per-solve timer wraps the optimizer's compute and keeps
    its result."""
    from yag_slam_tpu_torch.graphopt.spa import SPA2d
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa

    class Slam:
        opt = populate_spa(SPA2d(device="cpu"), *noisy_loop_pose_graph(8))

    times = smoke.solve_times(Slam)
    assert Slam.opt.compute() > 0.0 and Slam.opt.compute() >= 0.0
    assert len(times) == 2 and all(t > 0 for t in times)


def test_quiet_captures_standard_output():
    out, lines = smoke.quiet(lambda: print("a\nb") or 7)
    assert out == 7 and lines == ["a", "b"]


def test_bound_takes_the_larger_limit():
    b = smoke.bound(3.35e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = smoke.bound(3.35e6, ops=67e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    # the smear's float32 chain: 31 ops per element at h = 10, as counted
    assert smoke.smear_ops(1, 3072, 10) == 31 * (3072 * 3092 + 3072 * 3072)


@pytest.mark.parametrize("stride,nx,ny", [(1, 4, 4), (2, 5, 3), (3, 2, 6)])
def test_window_conv_yardstick_equals_the_window_sum(stride, nx, ny):
    """The grouped conv2d form of window_sum (phase 3's library call) on the
    CPU, for one job and for three (one group each, stencils of different
    spans padded to one size): the same sums as the plain version, and the
    byte count the bound uses."""
    import torch

    from yag_slam_tpu_torch.matching import kernels as K

    rng = np.random.default_rng(stride)
    S, K_, P_ = 48, 3, 20
    n_live = 17
    for N in (1, 3):
        q = torch.as_tensor(rng.integers(0, 101, (N, S, S)).astype(np.uint8))
        gy0 = rng.integers(-10, S + 5, (N, K_, P_)).astype(np.int32)
        gx0 = rng.integers(-10, S + 5, (N, K_, P_)).astype(np.int32)
        gy0[1:] //= 2                      # the other jobs' stencils span less
        gy0, gx0 = torch.as_tensor(gy0), torch.as_tensor(gx0)
        raw = K.window_sum_ref(q, gy0, gx0, torch.full((N,), n_live, dtype=torch.int32),
                               ny, nx, stride)
        call, what = smoke.window_conv(q, gy0, gx0, n_live, ny, nx, stride, raw)
        assert torch.equal(call()[0].view(N, K_, ny, nx).round().to(torch.int32), raw)
        assert "F.conv2d" in what and f"{N} group" in what
        # distinct cells read, by brute force
        cells = {(n, int(gy0[n, k, p]) + stride * j, int(gx0[n, k, p]) + stride * i)
                 for n in range(N) for k in range(K_) for p in range(n_live)
                 for j in range(ny) for i in range(nx)}
        inside = sum(0 <= y < S and 0 <= x < S for _, y, x in cells)
        want = inside + 8 * N * K_ * n_live + 4 * N + 4 * N * K_ * ny * nx
        assert smoke.window_bytes(q, gy0, gx0, n_live, ny, nx, stride) == want


def test_phase_13_builds_the_jax_tests_inputs():
    """chip_smoke's serpentine graph and 2-lap square loop are
    tests/test_parallel.py's, built on the port's own helpers."""
    from test_parallel import _serpentine_grid_graph
    from yag_slam_tpu.io import simulator as jsim
    from yag_slam_tpu_torch.graphopt.spa import SPA2d

    a, b = SPA2d(device="cpu"), SPA2d(device="cpu")
    assert smoke.serpentine_graph(a, 8, 12) == _serpentine_grid_graph(b, 8, 12) == 96
    for k in ("poses", "edge_idx", "edge_means"):
        assert getattr(a._solver, k) == getattr(b._solver, k)
    gt, scans = smoke.square_loop_scans()
    jgt = jsim.square_loop_trajectory(side=5.0, step=0.5, laps=2, start=(-2.5, -2.5))
    odom = jsim.drifted_odometry(jgt, yaw_bias=0.0025, seed=1)
    rng = np.random.default_rng(101)
    want = [jsim.simulate_scan(jsim.SimWorld.office(), jgt[i], n_beams=250,
                               range_threshold=5.0, noise=0.004, rng=rng,
                               odom_pose_xyt=odom[i]) for i in range(len(jgt))]
    np.testing.assert_array_equal(gt, jgt)
    assert len(scans) == len(want) == 88
    for a, b in zip(scans, want):
        np.testing.assert_array_equal(a.ranges, b.ranges)
        assert (a.odom_pose.x, a.odom_pose.y) == (b.odom_pose.x, b.odom_pose.y)


def test_cpu_model_names_the_host():
    model = smoke.cpu_model()
    assert model.endswith(" CPUs") and len(model) > len(" CPUs")


def test_host_ops_phase_holds_native_to_the_twins(tmp_path):
    """Phase 4a on the CPU box over the whole tour log: the parse and the
    413 views agree, and the line carries the times and the capacity."""
    from yag_slam_tpu_torch.io.benchmark import generate_benchmark_log

    log, _, n = generate_benchmark_log(str(tmp_path / "tour.clf"), step=0.4, laps=1,
                                       n_beams=180, seed=0)
    out = smoke.host_ops(log)
    assert out["scans"] == n == 413 and out["cap"] == 256
    assert out["max_abs_err_m"] <= smoke.HOSTOPS_TOL
    assert 0 <= out["not_bit_equal"] <= out["points"]
    for k in ("parse_ms", "parse_ref_ms", "view_us", "view_ref_us", "view_batched_us", "load_s"):
        assert out[k] > 0.0
    assert out["cpu"].endswith(" CPUs")


@pytest.fixture(scope="module")
def program_jobs():
    """Three queries against base windows of the room, and their matcher."""
    import torch
    from test_matching import TEST_CFG, make_room_scan
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

    base = [make_room_scan(0.1 * i, 0.02 * i, 0.03 * i, seed=i + 1) for i in range(4)]
    queries = [make_room_scan(0.13, -0.05, 0.05, seed=10),
               make_room_scan(0.05, 0.04, -0.02, seed=11),
               make_room_scan(0.21, 0.01, 0.08, seed=12)]
    for q in queries:
        q.corrected_pose = q.odom_pose
    m = CorrelativeScanMatcher(TEST_CFG, device="cpu", dtype=torch.float32)
    return m, [(q, base[i:]) for i, q in enumerate(queries)]


def test_program_case_holds_the_kernels_to_an_all_plain_chain(program_jobs):
    """Phase 3b's case on the CPU (every wrapper runs its twin): it passes,
    with a row per kernel and pass."""
    m, jobs = program_jobs
    rows, trig = smoke.program_case("room", m, jobs, 4, True, True, "cpu", timing=False)
    assert [len(rows[k]) for k in ("world_scatter", "lattice_window_sum",
                                   "score_reduce")] == [1, 2, 2]
    assert all(r["max_abs_err"] == 0 for v in rows.values() for r in v)
    assert all(r["rows_apart"] == 0 and r["max_ulps"] == 0 for r in rows["score_reduce"])
    assert trig.numel() > 0


def test_fused_cases_hold_the_fused_wrappers_to_their_twins_on_the_cpu():
    """Phase 3b's edge cases of the fused wrappers on the CPU (each runs its
    twin): a row per kernel, case and dtype, the cells where there are
    any."""
    rows = smoke.fused_cases("cpu")
    cases = {(r["kernel"], r["case"]) for r in rows}
    assert len(rows) == len(cases) == 12
    assert {r["case"] for r in rows if r["kernel"] == "world_scatter"} == {
        f"{c}_{d}" for c in ("unused_base", "many_bases", "outside", "no_job")
        for d in ("float32", "float64")}
    cells = {r["case"]: r["cells"] for r in rows if r["kernel"] == "world_scatter"}
    assert cells["unused_base_float32"] == cells["no_job_float64"] == 0
    assert cells["many_bases_float32"] > 0 and cells["outside_float64"] > 0


def _spoil_world_scatter(result, row):
    occ, lim = result
    return occ * 0, lim      # drop every kept point


def _spoil_lattice_window_sum(result, row):
    return result + 1


def _spoil_score_reduce(result, row):
    result[:, row, 1] += 0.01      # x off by half a cell
    return result


@pytest.mark.parametrize("kernel,spoil,match", [
    ("world_scatter", _spoil_world_scatter, "world_scatter room"),
    ("lattice_window_sum", _spoil_lattice_window_sum, "lattice_window_sum room_coarse"),
    ("score_reduce", _spoil_score_reduce, "score_reduce room_coarse"),
])
def test_program_case_fails_when_a_kernel_differs_from_its_twin(program_jobs, monkeypatch,
                                                                kernel, spoil, match):
    """A wrapper whose result differs from its twin's makes phase 3b's case
    raise, where the kernels and the plain chain part."""
    from yag_slam_tpu_torch.matching import program_kernels as PK

    wrapper = getattr(PK, kernel)

    def spoiled(*args, **kw):
        row = args[5] if kernel == "score_reduce" else 0
        return spoil(wrapper(*args, **kw), row)

    monkeypatch.setattr(PK, kernel, spoiled)
    m, jobs = program_jobs
    with pytest.raises(AssertionError, match=match):
        smoke.program_case("room", m, jobs, 4, True, True, "cpu", timing=False)
