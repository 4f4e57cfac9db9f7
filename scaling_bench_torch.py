#!/usr/bin/env python3
"""Scaling harness of the PyTorch port: sharded loop-closure match
throughput at 1..N ranks, and the distributed SPA's weak scaling.

    python3 scaling_bench_torch.py                        # one card: world size 1
    torchrun --nproc-per-node N scaling_bench_torch.py    # N cards, NCCL

Counterpart of scaling_bench.py.  A plain process is world size 1 on a
one-rank NCCL group (``parallel.default_mesh``); under torchrun the world
is the launched one.  At each world size n in 1, 2, 4, 8, ... up to the
world, a 1-D "dp" mesh over the first n ranks runs:

- ``ShardedLoopMatcher`` over 32 loop-closure jobs (3-scan chains of
  180-beam office scans) at the loop config (range 5 m, resolution
  0.05 m, search 2 m), penalty and fine pass off: jobs/s of the best of 3
  after one warm call;
- ``DistributedSPA`` (cg, mixed) on a noisy square loop of 512 nodes per
  rank, ``compute(10, 1e-4, True, 1e-9, 25)``: ms of the best of 3 after
  one warm call (flat solve time is ideal weak scaling).

Rank 0 prints scaling_bench.py's JSON lines: one per size and row, then
an efficiency line for each row once there are two sizes or more.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

LOOP_CFG = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
            "smear_deviation": 0.05}
N_JOBS = 32
REPEATS = 3
EDGES_PER_RANK = 512
SPA_ARGS = (10, 1.0e-4, True, 1.0e-9, 25)


def build_jobs(n_jobs, n_beams=180):
    """scaling_bench.py's jobs: per job a 3-scan chain and a query near
    its start, in the office world, seed 0."""
    from yag_slam_tpu_torch.io.simulator import SimWorld, simulate_scan

    world = SimWorld.office()
    rng = np.random.default_rng(0)
    jobs = []
    for j in range(n_jobs):
        base_pose = np.array([0.25 * (j % 12) - 1.5, 0.2 * (j % 10) - 1.0, 0.05 * j])
        chain = [
            simulate_scan(world, base_pose + [0.3 * i, 0.05, 0.0], n_beams=n_beams,
                          range_threshold=5.0, noise=0.004, rng=rng)
            for i in range(3)
        ]
        query = simulate_scan(world, base_pose + [0.1, 0.05, 0.02], n_beams=n_beams,
                              range_threshold=5.0, noise=0.004, rng=rng)
        jobs.append((query, chain))
    return jobs


def world_sizes(world):
    return [n for n in (1, 2, 4, 8, 16, 32) if n <= world]


def sub_mesh(n, full):
    """A 1-D "dp" mesh over the first n ranks (every rank must call this);
    None on the ranks outside it."""
    from torch.distributed.device_mesh import DeviceMesh

    if n == dist.get_world_size():
        return full
    mesh = DeviceMesh(full.device_type, list(range(n)), mesh_dim_names=("dp",))
    return mesh if dist.get_rank() < n else None


def _best_ms(device, fn, repeats):
    """fn() once to warm, then the best of `repeats` timed calls (the card
    synchronised before each clock starts and stops); (ms, last result)."""
    out = fn()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best, out


def efficiency_line(metric, device, eff):
    return {"metric": metric, "backend": device.type,
            "efficiency": {str(n): e for n, e in eff.items()}}


def run(device="cuda", n_jobs=N_JOBS, repeats=REPEATS, edges_per_rank=EDGES_PER_RANK,
        emit=print):
    """Both rows at every world size, on the process group this process
    is in (a one-rank group is started where there is none).  Rank 0
    passes each JSON line to `emit`; returns {"match": {n: results},
    "spa": {n: poses}} on the ranks of each mesh."""
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.parallel import DistributedSPA, ShardedLoopMatcher, default_mesh

    full = default_mesh(device=device)
    dev = torch.device(full.device_type, torch.cuda.current_device()) \
        if full.device_type == "cuda" else torch.device("cpu")
    lead = dist.get_rank() == 0
    sizes = world_sizes(dist.get_world_size())
    jobs = build_jobs(n_jobs)
    out = {"match": {}, "spa": {}}

    rates = {}
    for n in sizes:
        mesh = sub_mesh(n, full)
        if mesh is None:
            continue
        matcher = ShardedLoopMatcher(CorrelativeScanMatcher(LOOP_CFG, loop=True, device=dev),
                                     mesh)
        ms, res = _best_ms(dev, lambda: matcher.match_many(jobs, penalty=False,
                                                           do_fine=False), repeats)
        rates[n] = n_jobs / ms * 1e3
        out["match"][n] = res
        if lead:
            emit({"devices": n, "jobs_per_s": rates[n], "ms": ms,
                  "responses_ok": bool(min(r.response for r in res) > 0)})
    if lead and len(rates) > 1:
        base = rates[sizes[0]]
        emit(efficiency_line("scaling_efficiency", dev,
                             {n: rates[n] / (base * n / sizes[0]) for n in sizes[1:]}))

    times = {}
    for n in sizes:
        mesh = sub_mesh(n, full)
        if mesh is None:
            continue
        graph = noisy_loop_pose_graph(edges_per_rank * n)

        def solve():
            spa = populate_spa(DistributedSPA(mesh), *graph)
            return spa, spa.compute(*SPA_ARGS)

        times[n], (spa, cost) = _best_ms(dev, solve, repeats)
        out["spa"][n] = [[v.x, v.y, v.yaw] for v in spa.nodes]
        if lead:
            emit({"dist_spa_devices": n, "nodes": edges_per_rank * n,
                  "solve_ms": times[n], "chi2": float(cost)})
    if lead and len(times) > 1:
        base = times[sizes[0]]
        emit(efficiency_line("dist_spa_weak_scaling_efficiency", dev,
                             {n: base / times[n] for n in sizes[1:]}))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("scaling_bench_torch: CUDA is not available; it runs on cards "
                         "(one rank per card)")
    try:
        run("cuda", emit=lambda line: print(json.dumps(line), flush=True))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
