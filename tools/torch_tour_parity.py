#!/usr/bin/env python
"""Whole-tour parity of the PyTorch port with the JAX package on the CPU.

Runs the port's GraphSlam (device="cpu", float64) and the JAX package's
(CPU backend, float64, the window-sum path the port's CPU lane is held to)
scan by scan over the 413-scan building tour at the default matcher
configs, and compares vertex, edge and closure counts and every pose after
each scan.  Prints the first scan where the two part (counts differ or a
pose moves by more than 1e-6), and a JSON summary as the last line.

    JAX_PLATFORMS=cpu python tools/torch_tour_parity.py [--scans N] [--out FILE]

About two minutes per package on 8 CPU cores, under 1 GB of memory.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yag_slam_tpu.core.config import default_config, default_config_loop  # noqa: E402
from yag_slam_tpu.io.carmen import carmen_to_localized_scans as jax_scans  # noqa: E402
from yag_slam_tpu.io.carmen import load_carmen_log as jax_load  # noqa: E402
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher  # noqa: E402
from yag_slam_tpu.slam.graph_slam import GraphSlam as JaxGraphSlam  # noqa: E402
from yag_slam_tpu_torch.io import carmen_to_localized_scans as port_scans  # noqa: E402
from yag_slam_tpu_torch.io import generate_benchmark_log, load_carmen_log  # noqa: E402
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam  # noqa: E402

POSE_TOL = 1e-6


def poses(slam):
    return np.array([[v.obj.corrected_pose.x, v.obj.corrected_pose.y,
                      v.obj.corrected_pose.euler[-1]] for v in slam.graph.vertices])


def counts(slam):
    return (len(slam.graph.vertices), len(slam.graph.edges), slam.stats["loop_closures"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, help="only the tour's first SCANS scans")
    ap.add_argument("--out", help="also write the summary and per-scan gaps as JSON here")
    args = ap.parse_args()
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        log, gt_path, _ = generate_benchmark_log(os.path.join(tmp, "tour.clf"), step=0.4,
                                                 laps=1, n_beams=180, seed=0)
        ja_scans = jax_scans(jax_load(log), range_threshold=20.0)
        tb_scans = port_scans(load_carmen_log(log), range_threshold=20.0)
        gt = np.loadtxt(gt_path)
    ja_scans, tb_scans = ja_scans[:args.scans], tb_scans[:args.scans]
    mk = lambda cfg, loop: JaxMatcher(cfg, loop=loop, dtype=np.float64,  # noqa: E731
                                      use_patch=True, use_pallas=False)
    ja = JaxGraphSlam(mk(default_config, False), mk(default_config_loop, True))
    tb = GraphSlam.default(device="cpu", dtype=torch.float64)
    first_part, worst, per_scan, jax_s, port_s = None, 0.0, [], 0.0, 0.0
    for i, (a, b) in enumerate(zip(ja_scans, tb_scans)):
        t0 = time.perf_counter()
        ja.process_scan(a)
        t1 = time.perf_counter()
        tb.process_scan(b)
        port_s += time.perf_counter() - t1
        jax_s += t1 - t0
        pa, pb = poses(ja), poses(tb)
        ca, cb = counts(ja), counts(tb)
        gap = float(np.abs(pa - pb).max()) if pa.shape == pb.shape else float("inf")
        worst = max(worst, gap)
        if first_part is None and (ca != cb or gap > POSE_TOL):
            first_part = dict(scan=i, jax_counts=ca, port_counts=cb, gap=gap)
            print(f"parted at scan {i}: {ca} vs {cb}, max pose gap {gap:.3e}", flush=True)
        per_scan.append([i, ca, cb, gap])
        if i % 50 == 0:
            print(f"scan {i}: jax {ca}, port {cb}, gap {gap:.3e}", flush=True)
    pa, pb = poses(ja), poses(tb)
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p[:, :2] - gt[:len(p), :2]) ** 2, 1))))  # noqa: E731
    out = dict(scans=len(ja_scans), jax_counts=counts(ja), port_counts=counts(tb),
               worst_pose_gap=worst, first_part=first_part, jax_s=jax_s, port_s=port_s,
               ate_jax_m=ate(pa), ate_port_m=ate(pb))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, per_scan=per_scan), f)
    print(json.dumps(out))
    return 0 if first_part is None else 1


if __name__ == "__main__":
    sys.exit(main())
