#!/usr/bin/env python3
"""score_reduce at one block and at a cluster of eight a job, on the card.

    python3 tools/score_reduce_shapes.py [--rounds 2] [--out chiprun_out/shapes.json]

Phase 3b's main-path batches (chip_smoke.program_cases: the tour's
sequential match, the loop matcher's coarse batch of 4 jobs, the office
batch of 64 jobs) and loop matcher batches of 1 to 64 jobs (LOOP_JOBS)
(tour scans against chains 25-15 scans back) through
chip_smoke.program_case with score_reduce's job forced onto one block and
onto a cluster of eight blocks in turn (program_kernels.reduce_shape
replaced for the run), the two in opposite orders in alternate rounds:
every pass held to its plain twin as phase 3b holds it, and the bare
kernel's device ms (device_ms) of each pass at each size, beside the shape
that program_kernels.reduce_shape picks for it; then the timing's floor, a
one-thread launch.  Then score_reduce alone on square lattices of 25 to
48 columns a side (size_sweep), at 4 to 64 jobs, at both sizes in turn.
What the rule in program_kernels.reduce_shape
(REDUCE_CLUSTER_AT, REDUCE_BLOCKS_PER_SM) is chosen from.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

MAIN_CASES = ("seq", "loop", "x64")
LOOP_JOBS = (1, 16, 32, 40, 49, 50, 56, 64)
# square lattices of 10 angles around the loop's 40 x 40, and their batches
SIDES = (25, 27, 28, 32, 36, 40, 48)
SIDE_JOBS = (4, 49, 50, 64)


def loop_batches(dev):
    """(name, matcher, jobs, n_pad, penalty, do_fine) of loop matcher
    coarse batches of each size in LOOP_JOBS."""
    import chip_smoke
    from yag_slam_tpu_torch.core.config import default_config_loop
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    tour = chip_smoke.tour_scans()
    m = M(default_config_loop, loop=True, device=dev)
    out = []
    for n in LOOP_JOBS:
        qs = np.linspace(100, len(tour) - 1, n).astype(int)
        out.append((f"loop{n}", m, [(tour[q], tour[q - 25:q - 15]) for q in qs], None, False,
                    False))
    return out


def size_sweep(dev, clusters, rounds):
    """score_reduce alone on random window sums over the square lattices
    of SIDES (the loop's steps, 10 angles, the reference penalty, float32)
    in batches of SIDE_JOBS, forced onto each cluster size in turn, each
    held to its twin (chip_smoke.hold_reduce): {case: {cluster: [ms]}}."""
    import chip_smoke
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.utils.profiling import device_ms

    rng = np.random.default_rng(5)
    rule, out = PK.reduce_shape, {}
    try:
        for side in SIDES:
            lat = PK.PassLattice(side, side, 10, 0.05 * side, 0.1, 0.1745, 0.0349, 2)
            for n in SIDE_JOBS:
                raw = torch.as_tensor(rng.integers(0, 6000, (n, 10, side, side)),
                                      dtype=torch.int32, device=dev)
                n_q = torch.full((n,), 60, dtype=torch.int32, device=dev)
                center = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32,
                                         device=dev)
                kw = dict(G=881, res=0.05, penalize=True, copy_fine=True)
                want = torch.zeros((n, 2, 8), device=dev)
                want_stats = torch.zeros((n, 4), dtype=torch.int64, device=dev)
                PK.score_reduce_ref(raw, n_q, center, center, want, 0, lat, stats=want_stats,
                                    **kw)
                case = f"side{side}_x{n}"
                for r in range(rounds):
                    for c in (clusters if r % 2 == 0 else clusters[::-1]):
                        PK.reduce_shape = lambda lat, dt, n, s, c=c: PK._layout(lat, 4, c)
                        got = torch.zeros_like(want)
                        stats = torch.zeros_like(want_stats)
                        PK.score_reduce(raw, n_q, center, center, got, 0, lat, stats=stats,
                                        **kw)
                        chip_smoke.hold_reduce(f"{case} cluster {c}", got[:, 0], want[:, 0],
                                               stats, want_stats)
                        out.setdefault(case, {}).setdefault(c, []).append(device_ms(
                            lambda: PK.score_reduce(raw, n_q, center, center, got, 0, lat,
                                                    **kw)))
                    PK.reduce_shape = rule
                out[case]["rule"] = rule(lat, torch.float32, n, PK._sm_count(0)).cluster
    finally:
        PK.reduce_shape = rule
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("score_reduce_shapes.py needs a CUDA card")
    import chip_smoke
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.utils.profiling import device_ms, gpu_line

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    sms = PK._sm_count(0)
    cases = [c for c in chip_smoke.program_cases(dev) if c[0] in MAIN_CASES] + loop_batches(dev)
    rule = PK.reduce_shape
    times, picked = {}, {}
    try:
        for r in range(args.rounds):
            for c in ((1, PK.REDUCE_CLUSTER) if r % 2 == 0 else (PK.REDUCE_CLUSTER, 1)):
                PK.reduce_shape = lambda lat, dt, n, s, c=c: PK._layout(
                    lat, torch.finfo(dt).bits // 8, c)
                for name, m, jobs, n_pad, penalty, do_fine in cases:
                    rows, _ = chip_smoke.program_case(name, m, jobs, n_pad, penalty, do_fine,
                                                      dev)
                    for row in rows["score_reduce"]:
                        times.setdefault(row["case"], {}).setdefault(c, []).append(
                            dict(kernel_ms=row["kernel_ms"], shape=row["reduce_shape"]))
                        lat = row["lattice"]
                        picked[row["case"]] = (row["N"], lat, rule(
                            PK.PassLattice(*lat, 0, 0, 0, 0, 1),
                            getattr(torch, row["dtype"][6:]), row["N"], sms).cluster)
    finally:
        PK.reduce_shape = rule
    # the floor of the timing: a launch of one thread's cos and sin
    x = torch.zeros(1, device=dev)
    lib = _build.library()
    floor_ms = device_ms(lambda: lib.yag_program_trig(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), 1, 0, torch.cuda.current_stream().cuda_stream))
    print(f"floor: one one-thread launch {floor_ms:.4f} ms; {sms} SMs", flush=True)
    out = {}
    for case, by_c in times.items():
        n, lat, chosen = picked[case]
        out[case] = dict(jobs=n, lattice=lat, rule_cluster=chosen, clusters={
            c: dict(shape=v[0]["shape"], kernel_ms=[x["kernel_ms"] for x in v],
                    median_ms=statistics.median(x["kernel_ms"] for x in v))
            for c, v in by_c.items()})
        print(f"{case} ({n} jobs, lattice {lat}; the rule: cluster {chosen}): " + "; ".join(
            f"cluster {c} {tuple(v['shape'].values())} {v['median_ms']:.4f} ms "
            f"{v['kernel_ms']}" for c, v in out[case]["clusters"].items()) + f" ({gpu})",
            flush=True)
    sweep = size_sweep(dev, (1, PK.REDUCE_CLUSTER), args.rounds)
    for case, by_c in sweep.items():
        print(f"{case} (the rule: cluster {by_c['rule']}): " + "; ".join(
            f"cluster {c} {statistics.median(v):.4f} ms {v}" for c, v in by_c.items()
            if c != "rule") + f" ({gpu})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(gpu=gpu, sms=sms, floor_ms=floor_ms, cases=out, sizes=sweep), f,
                      indent=1)
    print(gpu)


if __name__ == "__main__":
    main()
