#!/usr/bin/env python3
"""The map render's kernels at the benchmark's size on the CUDA card.

    python3 tools/render_kernels.py [--scans 833] [--out chiprun_out/render.json]

The building tour of the map cell (two laps, 833 scans of 180 beams, seed
0), each scan at its odometry pose, through ``chip_smoke.render_phase``:
the render kernels' launches counted over ``create_occupancy_grid``, the
waits of a render, every stage bit-equal to its plain version and timed
(kernel, wrapper, plain, whole render) beside its bound at the prefixes
k = 5, half and all.  Then ``render_trace_kernel`` of
``csrc/render.cu`` against a warp-aggregated variant built here from the
same source (the peers of a cell, found with ``__match_any_sync``, add
their count with one ``atomicAdd``): counts equal, device ms by
``device_ms`` in turns.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the variant: the trace's step atomic, aggregated over the warp's lanes
# that hit the same cell
STEP_ATOMIC = '''    if (cx >= 0 && cx < width && cy >= 0 && cy < height)
      atomicAdd(passes + (size_t)cy * width + cx, 1);'''
AGGREGATED = '''    const bool in = cx >= 0 && cx < width && cy >= 0 && cy < height;
    const unsigned m = __ballot_sync(__activemask(), in);
    if (in) {
      const int idx = cy * width + cx;
      const unsigned peers = __match_any_sync(m, idx);
      if ((threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(passes + idx, __popc(peers));
    }'''


def variant_source(src):
    """csrc/render.cu with its trace kernel's step atomic aggregated and
    its C entry point renamed yag_render_trace_aggregated."""
    if STEP_ATOMIC not in src:
        raise RuntimeError("csrc/render.cu's step atomic is not where the variant expects it")
    return src.replace(STEP_ATOMIC, AGGREGATED).replace(
        "yag_render_trace(", "yag_render_trace_aggregated(")


def tour_scans(n):
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)

    with tempfile.TemporaryDirectory() as tmp:
        log, _, _ = generate_benchmark_log(os.path.join(tmp, "tour.clf"), step=0.4, laps=2,
                                           n_beams=180, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log), range_threshold=20.0)
    return scans[:n]


def aggregated_library(tmp):
    from yag_slam_tpu_torch import _build

    src = os.path.join(tmp, "render_aggregated.cu")
    with open(src, "w") as f:
        f.write(variant_source((_build.CSRC_DIR / "render.cu").read_text()))
    so = os.path.join(tmp, "librender_aggregated.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    fn = lib.yag_render_trace_aggregated
    fn.argtypes = list(_build._SIGNATURES["yag_render_trace"])
    fn.restype = ctypes.c_int
    return lib


def compare_trace(scans, dev, lib_agg, prefixes):
    """The trace kernel and its aggregated variant on the same beams:
    counts equal, device ms of each over four rounds in turns."""
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.mapping import occupancy as O
    from yag_slam_tpu_torch.mapping import render_kernel as R
    from yag_slam_tpu_torch.utils.profiling import device_ms

    lib = _build.library()
    out = []
    for k in prefixes:
        table, ranges = O._gather(scans[:k], dev)
        seg, flag, box = R.beam_endpoints(table, ranges, 12.0)
        ox, oy, W, H, steps = O._frame(box.tolist(), 0.05, 12.0)
        f32 = O._f32(ox, oy, 0.05)
        B = ranges.shape[0]
        ref = R.beam_counts_ref(seg, flag, *f32, W, H, steps)
        got = {v: torch.empty_like(ref) for v in ("kernel", "aggregated")}
        fns = {"kernel": lib.yag_render_trace, "aggregated": lib_agg.yag_render_trace_aggregated}

        def launch(v):
            err = fns[v](seg.data_ptr(), flag.data_ptr(), B, *f32, W, H, steps,
                         got[v].data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{v}: cudaError {err}")

        times = {v: [] for v in fns}
        for order in (("kernel", "aggregated"), ("aggregated", "kernel")) * 2:
            for v in order:
                times[v].append(device_ms(lambda v=v: launch(v), reps=50))
        torch.cuda.synchronize()
        equal = {v: torch.equal(g, ref) for v, g in got.items()}
        if not all(equal.values()):
            raise AssertionError(f"k = {k}: trace counts differ from the plain version {equal}")
        row = dict(k=k, beams=B, grid=[W, H], ms={v: sorted(t) for v, t in times.items()})
        print(f"trace k = {k} ({B} beams, grid {W}x{H}): counts equal; device ms "
              f"kernel {row['ms']['kernel']}, aggregated {row['ms']['aggregated']}", flush=True)
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=833)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_kernels.py needs a CUDA card")
    import chip_smoke
    from yag_slam_tpu_torch.mapping import occupancy as O
    from yag_slam_tpu_torch.utils.profiling import gpu_line

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    scans = tour_scans(args.scans)
    # render_phase renders the vertices' scans: the tour at its odometry
    # poses stands in for a SLAM pass's graph
    slam = types.SimpleNamespace(
        graph=types.SimpleNamespace(vertices=[types.SimpleNamespace(obj=s) for s in scans]),
        make_occupancy_grid=lambda res, rt: O.create_occupancy_grid(scans, res, rt, device=dev))
    phase = chip_smoke.render_phase(slam, dev, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        trace = compare_trace(scans, dev, aggregated_library(tmp), (len(scans) // 2, len(scans)))
    result = dict(gpu=gpu, scans=len(scans), render=phase, trace_variants=trace)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(gpu)
    print(json.dumps(dict(whole_render_ms=phase["whole_render_ms"], launches=phase["launches"],
                          trace_variants=trace)))


if __name__ == "__main__":
    main()
