#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, one line each; any failure raises (non-zero exit):
  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from yag_slam_tpu_torch/csrc;
  3. compare each kernel with its plain PyTorch version on the card, at the
     SLAM main path's shapes (bit equality), and time both;
  4. run the building-tour CARMEN log through the port's GraphSlam at the
     default matcher configs in float32 on the card: require a loop
     closure, ATE below odometry's and every kernel launched; then hold
     the tour's first 300 scans against the plain path on the host CPU in
     float32, and its first 50 in float64, pose by pose;
  5. render the occupancy grid, round-trip a checkpoint file and continue
     5 scans on the restored instance;
  6. trace a window of scans with torch.profiler and report the device's
     busy time and idle share (kernel, memcpy and memset events only).
The last lines are a JSON line of per-kernel results, the nvidia-smi line
and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (G, S, h) of the default sequential and loop matchers at the building
# tour, and the points per scan (P lanes, 180 beams used)
SEQ_G, SEQ_S, SEQ_H = 4051, 3072, 10
LOOP_G, LOOP_S, LOOP_H = 881, 768, 2
P, N_BEAMS = 256, 180
TIMING_REPS = 20
HOLD_BACK = 5   # scans processed after the checkpoint round trip
# The tour's first scans rerun on the host by the plain path, each as
# (dtype, scans, tolerance m, tolerance rad) for the card run's poses.
# float32: the first 300 scans (7 closures), same counts and poses within
# 1e-6; later closures meet near-ties that the card's and the CPU's
# rounding resolve apart.  float64: the first 50 (no closure yet), same
# vertex and closure counts; float32 may resolve a near-tie one lattice
# step away from float64, so poses within two sequential cells (2 x 0.01 m)
# and two fine angle steps (2 x 0.00349 rad).
HOST_RUNS = ((torch.float32, 300, 1e-6, 1e-6), (torch.float64, 50, 0.02, 0.00698))
PROFILE_SCANS = (150, 210)   # the traced window of phase 6
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps=TIMING_REPS, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(x, y):
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


# -- phase 3 -------------------------------------------------------------------

def grid_case(rng, dev, *, N, S, h, G, so, B=16):
    """Scatter cells and full-grid bounds of N jobs with B*P lanes each."""
    R = S + 2 * h
    M = B * P
    sy = rng.integers(0, R, (N, M)).astype(np.int32)
    sx = rng.integers(0, R, (N, M)).astype(np.int32)
    sy[rng.uniform(size=(N, M)) < 0.3] = -1        # empty lanes
    lim = np.tile(np.array([G - so, G - so], dtype=np.int32), (N, 1))
    return (torch.as_tensor(sy, device=dev), torch.as_tensor(sx, device=dev),
            torch.as_tensor(lim, device=dev))


def check_kernels(K, taps_seq, taps_loop, dev):
    """Kernel vs plain version at the main path's shapes; returns
    {kernel: [case dicts]} and the grids for the window-sum cases."""
    rng = np.random.default_rng(0)
    results = {k: [] for k in K.KERNELS}
    grids = {}
    cases = [
        ("seq", dict(N=1, S=SEQ_S, h=SEQ_H, G=SEQ_G, so=500), taps_seq),
        ("seq_masked", dict(N=1, S=SEQ_S, h=SEQ_H, G=SEQ_G,
                            so=SEQ_G - SEQ_S + 100), taps_seq),
        ("loop", dict(N=4, S=LOOP_S, h=LOOP_H, G=LOOP_G, so=0), taps_loop),
    ]
    for name, c, taps in cases:
        sy, sx, lim = grid_case(rng, dev, **c)
        S, h = c["S"], c["h"]
        R = S + 2 * h
        occ = K.scatter_cells(sy, sx, R)
        occ_ref = K.scatter_cells_ref(sy, sx, R)
        err = max_abs_err(occ, occ_ref)
        results["scatter_cells"].append(dict(
            case=name, shape=[c["N"], sy.shape[1], R], max_abs_err=err,
            ms=cuda_ms(lambda: K.scatter_cells(sy, sx, R)),
            plain_ms=cuda_ms(lambda: K.scatter_cells_ref(sy, sx, R))))
        q = K.smear_quantize(occ, lim, taps, S, h)
        q_ref = K.smear_quantize_ref(occ, lim, taps, S, h)
        err_q = max_abs_err(q, q_ref)
        if name == "seq_masked" and int(q[:, :, int(lim[0, 1]):].max()) != 0:
            raise AssertionError("full-grid mask did not zero the overhang")
        results["smear_quantize"].append(dict(
            case=name, shape=[c["N"], S, S], h=h, max_abs_err=err_q,
            ms=cuda_ms(lambda: K.smear_quantize(occ, lim, taps, S, h)),
            plain_ms=cuda_ms(lambda: K.smear_quantize_ref(occ, lim, taps, S, h))))
        grids[name] = q
        log(f"phase 3: {name} grid build S={S} h={h} N={c['N']}: "
            f"scatter err {err}, smear err {err_q}")

    lattices = [
        ("seq_coarse", "seq", (25, 25, 10), 2),
        ("seq_fine", "seq", (4, 4, 10), 1),
        ("loop_coarse", "loop", (40, 40, 10), 2),
    ]
    for name, grid, (nx, ny, nt), stride in lattices:
        q = grids[grid]
        N, S, _ = q.shape
        gy0 = torch.as_tensor(rng.integers(-60, S + 10, (N, nt, P)).astype(np.int32), device=dev)
        gx0 = torch.as_tensor(rng.integers(-60, S + 10, (N, nt, P)).astype(np.int32), device=dev)
        n_pts = torch.full((N,), N_BEAMS, dtype=torch.int32, device=dev)
        raw = K.window_sum(q, gy0, gx0, n_pts, ny, nx, stride)
        raw_ref = K.window_sum_ref(q, gy0, gx0, n_pts, ny, nx, stride)
        err = max_abs_err(raw, raw_ref)
        if int(raw.max()) <= 0:
            raise AssertionError(f"{name}: window sums are all zero")
        results["window_sum"].append(dict(
            case=name, shape=[N, nt, ny, nx], stride=stride, points=N_BEAMS,
            max_abs_err=err,
            ms=cuda_ms(lambda: K.window_sum(q, gy0, gx0, n_pts, ny, nx, stride)),
            plain_ms=cuda_ms(lambda: K.window_sum_ref(q, gy0, gx0, n_pts, ny, nx, stride))))
        log(f"phase 3: window sum {name} N={N} {nx}x{ny}x{nt} s={stride}: err {err}")
    for k, rows in results.items():
        for r in rows:
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{k} {r['case']}: kernel != plain ({r})")
            log(f"phase 3: {k} {r['case']}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms")
    return results


# -- phase 4 / 5 / 6 -----------------------------------------------------------

def ate(est_xy, gt_xy):
    err = np.asarray(est_xy) - np.asarray(gt_xy)
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def pose_gap(a, b):
    """Largest position (m) and heading (rad) difference of two (n, 3)
    [x, y, theta] pose arrays."""
    dxy = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max()
    dth = np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2])))).max()
    return float(dxy), float(dth)


def graph_state(slam):
    """Corrected poses and (vertex, edge, closure) counts, copied out."""
    poses = slam.graph.as_arrays()[0]
    return poses, (len(slam.graph.vertices), len(slam.graph.edges),
                   slam.stats["loop_closures"])


def device_timeline(events, names):
    """Device time in the events of a Chrome trace: the union of kernel,
    memcpy and memset intervals (host-side events are ignored), plus the
    time and count of the kernels named `names` (by `<name>_kernel`), of
    all other kernels, and of copies and sets.  Times in ms."""
    spans, parts = [], {n: [0.0, 0] for n in (*names, "other_kernels", "memcpy_memset")}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        spans.append((a, a + d))
        if e["cat"] != "kernel":
            key = "memcpy_memset"
        else:
            key = next((n for n in names if f"{n}_kernel" in e["name"]), "other_kernels")
        parts[key][0] += d / 1e3
        parts[key][1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(busy_ms=busy / 1e3, events=len(spans),
                parts={k: dict(ms=v[0], count=v[1]) for k, v in parts.items()})


def run_slam(tmp, gpu, dev):
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    def scans_of(records):   # fresh scan objects: a run mutates its scans
        return carmen_to_localized_scans(records, range_threshold=20.0)

    log_path, gt_path, n = generate_benchmark_log(
        os.path.join(tmp, "building.clf"), step=0.4, laps=1, n_beams=N_BEAMS,
        seed=0)
    carmen = load_carmen_log(log_path)
    scans = scans_of(carmen)
    gt = np.loadtxt(gt_path)
    odom = np.array([[c.odom_x, c.odom_y] for c in carmen])
    if len(scans) != n or len(gt) != n:
        raise AssertionError(f"log has {len(scans)} scans, expected {n}")
    log(f"phase 4: building tour, {n} scans of {N_BEAMS} beams")

    # one match on a small input: the card (float32, kernels) against the
    # plain path on the CPU (float64)
    pair = scans_of(carmen[:2])
    results = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        m = CorrelativeScanMatcher(device=device, dtype=dtype)
        results.append(m.match_scan(pair[1], [pair[0]]))
    a, b = results
    dxy = np.hypot(a.best_pose.x - b.best_pose.x, a.best_pose.y - b.best_pose.y)
    dth = abs(a.best_pose.euler[-1] - b.best_pose.euler[-1])
    if not (dxy <= 0.01 and dth <= 0.0035 and abs(a.response - b.response) < 1e-3):
        raise AssertionError(f"card vs CPU match differs: {a} vs {b}")
    log(f"phase 4: one match card f32 vs cpu f64: |dxy| {dxy:.2e} m, "
        f"|dth| {dth:.2e} rad, response {a.response:.6f} vs {b.response:.6f}")

    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    main, rest = scans[:-HOLD_BACK], scans[-HOLD_BACK:]
    torch.cuda.synchronize()
    K.reset_launches()
    match_ms, scan_ms, card_at = [], [], {}
    t_all = time.perf_counter()
    for i, s in enumerate(main):
        t0 = time.perf_counter()
        m0 = slam.stats["match_time_total"]
        slam.process_scan(s)
        scan_ms.append(1e3 * (time.perf_counter() - t0))
        match_ms.append(1e3 * (slam.stats["match_time_total"] - m0))
        if any(i + 1 == r[1] for r in HOST_RUNS):
            card_at[i + 1] = graph_state(slam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = dict(K.LAUNCHES)

    est = np.array([[v.obj.corrected_pose.x, v.obj.corrected_pose.y]
                    for v in slam.graph.vertices])
    nm = len(main)
    ate_slam = ate(est, gt[:nm, :2])
    ate_odom = ate(odom[:nm], gt[:nm, :2])
    st = slam.stats
    summary = dict(
        scans=nm, seconds=wall, scans_per_s=nm / wall,
        median_match_ms=statistics.median(match_ms[1:]),
        median_scan_ms=statistics.median(scan_ms[1:]),
        loop_closures=st["loop_closures"], loop_chains_tried=st["loop_chains_tried"],
        spa_runs=st["opt_runs"],
        spa_ms_mean=1e3 * st["opt_time_total"] / max(st["opt_runs"], 1),
        seq_match_s=st["match_time_total"], spa_s=st["opt_time_total"],
        ate_slam_m=ate_slam, ate_odom_m=ate_odom, launches=launches,
        gpu=gpu,
    )
    log(f"phase 4: {nm} scans in {wall:.3f} s = {summary['scans_per_s']:.3f} scans/s; "
        f"median seq match {summary['median_match_ms']:.3f} ms; "
        f"SPA {summary['spa_ms_mean']:.3f} ms x {st['opt_runs']}; "
        f"{st['loop_closures']} closures ({gpu})")
    log(f"phase 4: ATE slam {ate_slam:.4f} m vs odometry {ate_odom:.4f} m; "
        f"launches {launches}")
    if st["loop_closures"] < 1:
        raise AssertionError("no loop closure on the building tour")
    if not ate_slam < ate_odom:
        raise AssertionError(f"ATE {ate_slam} not below odometry {ate_odom}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    # the tour's first scans again, on the host CPU (plain path): drift
    # that builds up across scans shows here
    summary["host_runs"] = []
    for dtype, n_scans, tol_m, tol_rad in HOST_RUNS:
        host = GraphSlam.default(device="cpu", dtype=dtype)
        t0 = time.perf_counter()
        for s in scans_of(carmen[:n_scans]):
            host.process_scan(s)
        host_s = time.perf_counter() - t0
        host_poses, host_counts = graph_state(host)
        card_poses, card_counts = card_at[n_scans]
        pdxy, pdth = pose_gap(card_poses, host_poses)
        summary["host_runs"].append(dict(
            dtype=str(dtype), scans=n_scans, card_counts=card_counts,
            host_counts=host_counts, max_dxy_m=pdxy, max_dth_rad=pdth,
            host_s=host_s))
        log(f"phase 4: first {n_scans} scans card f32 vs cpu {dtype}: (vertices, "
            f"edges, closures) {card_counts} vs {host_counts}; max |dxy| {pdxy:.3e} m "
            f"(tol {tol_m}), max |dth| {pdth:.3e} rad (tol {tol_rad})")
        same = (card_counts == host_counts if dtype == torch.float32 else
                (card_counts[0], card_counts[2]) == (host_counts[0], host_counts[2]))
        if not (same and pdxy <= tol_m and pdth <= tol_rad):
            raise AssertionError(f"card run drifted from the host {dtype} run")

    grid = slam.make_occupancy_grid()
    vals = set(np.unique(grid.image).tolist())
    if grid.image.shape != (grid.height, grid.width) or not vals <= {0, 200, 255} \
            or 0 not in vals or 255 not in vals:
        raise AssertionError(f"bad occupancy grid {grid.image.shape} {vals}")
    log(f"phase 5: occupancy grid {grid.width}x{grid.height}, "
        f"{int((grid.image == 0).sum())} occupied cells")

    path = os.path.join(tmp, "map.graph")
    slam.to_file(path)
    restored = GraphSlam.from_file(path, device=dev, dtype=torch.float32)
    if restored.binarize() != slam.binarize():
        raise AssertionError("checkpoint round trip changed the state")
    responses = []
    for s in rest:
        res, _ = restored.process_scan(s)
        responses.append(res.response)
    if len(restored.graph.vertices) != n or min(responses) < 0.3:
        raise AssertionError(f"restored run: {len(restored.graph.vertices)} "
                             f"vertices, responses {responses}")
    log(f"phase 5: checkpoint round trip ok; {HOLD_BACK} more scans, "
        f"responses {[round(r, 4) for r in responses]}")
    summary["restored_responses"] = responses

    summary["profile"] = profile_window(scans_of(carmen[:PROFILE_SCANS[1]]), dev, tmp, gpu)
    return summary


def profile_window(scans, dev, tmp, gpu):
    """Phase 6: a fresh run up to PROFILE_SCANS[0], then the window traced
    on the card; device time from the trace against host wall time."""
    from torch.profiler import ProfilerActivity, profile

    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    lo, hi = PROFILE_SCANS
    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    for s in scans[:lo]:
        slam.process_scan(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in scans[lo:hi]:
            slam.process_scan(s)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        tl = device_timeline(json.load(f)["traceEvents"], tuple(K.KERNELS))
    if tl["parts"]["other_kernels"]["count"] + sum(
            tl["parts"][k]["count"] for k in K.KERNELS) == 0:
        raise AssertionError("the trace holds no kernel on the card")
    tl.update(scans=[lo, hi], window_ms=window_ms,
              idle_share=1.0 - tl["busy_ms"] / window_ms)
    parts = ", ".join(f"{k} {v['ms']:.3f} ms x {v['count']}" for k, v in tl["parts"].items())
    log(f"phase 6: scans {lo}-{hi - 1} traced: device busy {tl['busy_ms']:.3f} ms "
        f"of {window_ms:.3f} ms, idle share {tl['idle_share']:.4f}; {parts} ({gpu})")
    return tl


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    log(f"phase 1: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; {gpu}")

    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.matching import correlation as C
    from yag_slam_tpu_torch.matching import kernels as K

    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    taps = {res: torch.as_tensor(C.gaussian_kernel_1d(res, 0.05).astype(np.float32),
                                 device=dev) for res in (0.01, 0.05)}
    checks = check_kernels(K, taps[0.01], taps[0.05], dev)
    with tempfile.TemporaryDirectory() as tmp:
        slam = run_slam(tmp, gpu, dev)
    out = dict(gpu=gpu, device=name, kernels=checks, slam=slam)

    # the port and the host modules it shares run without JAX
    jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    if jax_mods:
        raise AssertionError(f"JAX was imported: {jax_mods[:5]}")

    kernels = []
    for k, info in K.KERNELS.items():
        main_case = checks[k][0]
        kernels.append(dict(
            name=k, route="cuda" if info["source"].endswith(".cu") else "triton",
            source=info["source"], replaces=info["replaces"][0],
            also_replaces=info["replaces"][1:],
            launches=slam["launches"][k],
            max_abs_err=max(r["max_abs_err"] for r in checks[k]),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            case=main_case["case"], cases=checks[k],
        ))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
