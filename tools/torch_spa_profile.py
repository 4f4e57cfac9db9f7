#!/usr/bin/env python
"""Where a device SPA solve spends its time on the card.

Traces one SPA2d.compute(100, 1e-4, True, 1e-9, 200) of the noisy
square-loop benchmark graph per (size, solver) with torch.profiler and
prints the solve's host ms, its LM iterations and host reads, the device
busy time (union of kernel, memcpy and memset intervals) and the ops with
the most host time.  Needs one CUDA card.

    python3 tools/torch_spa_profile.py [--sizes 100 1000] [--solvers dense:f64 ...]
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from yag_slam_tpu_torch.graphopt import spa as S  # noqa: E402
from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa  # noqa: E402


def device_busy_ms(prof):
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[100, 1000])
    ap.add_argument("--solvers", nargs="+", default=["dense:f64", "dense:mixed", "cg:f64"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_spa_profile: CUDA is not available")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for n in args.sizes:
        graph = noisy_loop_pose_graph(n)
        for col in args.solvers:
            solver, precision = col.split(":")

            def solve():
                spa = populate_spa(S.SPA2d(solver=solver, precision=precision,
                                           device="cuda"), *graph)
                torch.cuda.synchronize()
                S.reset_host_reads()
                t0 = time.perf_counter()
                spa.compute(100, 1e-4, True, 1e-9, 200)
                return 1e3 * (time.perf_counter() - t0)

            solve()   # warm-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ms = solve()
            busy, n_dev = device_busy_ms(prof)
            print(f"{len(graph[0])} nodes {col}: {ms:.3f} ms host, reads {dict(S.HOST_READS)}, "
                  f"device busy {busy:.3f} ms over {n_dev} device events ({gpu})", flush=True)
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=args.top),
                  flush=True)


if __name__ == "__main__":
    main()
