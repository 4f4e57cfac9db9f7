#!/usr/bin/env python3
"""The map render's kernels at the benchmark's size on the CUDA card.

    python3 tools/render_kernels.py [--scans 833] [--out chiprun_out/render.json]

The building tour of the map cell (two laps, 833 scans of 180 beams, seed
0), each scan at its odometry pose, through ``chip_smoke.render_phase``:
the render kernels' launches counted over ``create_occupancy_grid``, the
waits of a render, every stage bit-equal to its plain version and timed
(kernel, wrapper, plain, whole render) beside its bound and the event
floor at the prefixes k = 5, half and all; then phase 5's trace and
endpoint cases, each bit-equal to its plain version.  Prints one line a
stage and prefix (bare kernel ms), then the whole renders and launches.
To time an earlier tree's kernels the same way, run its own copy of this
tool in turns with this one.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=833)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_kernels.py needs a CUDA card")
    import chip_smoke
    from yag_slam_tpu_torch.utils.profiling import gpu_line

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    scans, slam = chip_smoke.map_cell_tour(dev, args.scans)
    phase = chip_smoke.render_phase(slam, dev, gpu)
    result = dict(gpu=gpu, scans=len(scans), render=phase,
                  trace_cases=chip_smoke.trace_cases(dev),
                  endpoint_cases=chip_smoke.endpoint_cases(dev))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(gpu)
    stages = dict(phase["cases"], **{"counts mode": phase.get("counts_mode", [])})
    for name, rows in stages.items():
        print(f"{name}: " + ", ".join(f"{r['case']} {r['kernel_ms']:.4f} ms" for r in rows)
              + f" (event floor {phase.get('floor_ms', float('nan')):.4f})")
    print(json.dumps(dict(whole_render_ms=phase["whole_render_ms"], launches=phase["launches"])))


if __name__ == "__main__":
    main()
