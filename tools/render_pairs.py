#!/usr/bin/env python3
"""Device time of the map render's stages, in this tree or an unpacked
earlier one, on the map cell's tour.

    python3 tools/render_pairs.py [--tree DIR] [--reps N]

Imports ``yag_slam_tpu_torch`` from DIR (default: this tree), gathers the
map cell's building tour (two laps, 833 scans of 180 beams, seed 0, each
scan at its odometry pose) at the prefixes k = 5, 416 and 833, and times
by device time (``utils.profiling.device_ms``, median of N) each stage
as the tree's wrappers run it, whatever launches, memsets or fills that
takes:

  endpoints  ``render_kernel.beam_endpoints``;
  image      the counts and the image: ``beam_image`` where the tree has
             it, else ``beam_counts`` then ``classify_cells``;
  counts     ``beam_counts`` alone (the passes and hits);
  floor      a one-element ``add_``, what device_ms reads for the
             smallest launch;

and the whole render (``create_occupancy_grid``, host wall to the image on
the host, median of N).  Prints one JSON line: per prefix the times, the
tree, the card and its power limit.  Run two trees in turns in one call to
compare them.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS, PREFIXES = 833, (5, 416, 833)
RES, RANGE = 0.05, 12.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("render_pairs.py needs a CUDA card")
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)
    from yag_slam_tpu_torch.mapping import occupancy as O
    from yag_slam_tpu_torch.mapping import render_kernel as R
    from yag_slam_tpu_torch.utils.profiling import device_ms, gpu_line

    assert os.path.abspath(R.__file__).startswith(os.path.join(tree, "yag_slam_tpu_torch", ""))
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(os.path.join(tmp, "tour.clf"), step=0.4,
                                                laps=2, n_beams=180, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path),
                                          range_threshold=20.0)[:SCANS]
    mpt = O.MIN_PASS_THROUGH
    one = torch.zeros(1, device=dev)
    rows = {}
    for k in PREFIXES:
        table, ranges = O._gather(scans[:k], dev)
        seg, flag, box = R.beam_endpoints(table, ranges, RANGE)
        ox, oy, W, H, max_steps = O._frame(box.tolist(), RES, RANGE)
        frame = (*O._f32(ox, oy, RES), W, H, max_steps)
        if hasattr(R, "beam_image"):
            image = lambda: R.beam_image(seg, flag, *frame, mpt)       # noqa: E731
        else:
            image = lambda: R.classify_cells(R.beam_counts(seg, flag, *frame), mpt)  # noqa: E731

        def whole():
            t0 = time.perf_counter()
            O.create_occupancy_grid(scans[:k], RES, RANGE, device=dev)
            return 1e3 * (time.perf_counter() - t0)

        whole()
        rows[k] = dict(
            endpoints=device_ms(lambda: R.beam_endpoints(table, ranges, RANGE), reps=args.reps),
            image=device_ms(image, reps=args.reps),
            counts=device_ms(lambda: R.beam_counts(seg, flag, *frame), reps=args.reps),
            floor=device_ms(lambda: one.add_(1), reps=args.reps),
            whole_render_ms=statistics.median(whole() for _ in range(args.reps)),
            beams=int(ranges.shape[0]), grid=[W, H])
    print(json.dumps(dict(tree=tree, gpu=gpu_line(), reps=args.reps, prefixes=rows)))


if __name__ == "__main__":
    main()
