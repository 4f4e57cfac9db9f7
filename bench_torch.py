#!/usr/bin/env python3
"""Benchmark of the PyTorch port: correlative scan matches/s on one CUDA card.

    python3 bench_torch.py

Prints ONE JSON line with every key of ``bench.py``'s line (the JAX
package's benchmark), plus ``device`` (the card's name), ``power_limit``
(nvidia-smi's power.limit), ``host_cpu``, ``repeats``, ``spread`` (min and
max beside every median) and ``launches_per_match`` (kernel launches per
match of each device row).  Progress goes to stderr.

Workload (bench.py's): the reference's full default sequential
configuration (range threshold 20 m, resolution 0.01 m, search 0.5 m, so
G = 4051; coarse 25 x 25 x 10 and fine 4 x 4 x 10 lattices) on 360-beam
scans of the simulated office, matched against a 10-scan sliding window
over a distinct scan stream, so no cache can flatter the numbers.  Rows,
each through the port's public API:

- pipeline modes: ``OnlineMatchPipeline`` (device-chained sequential
  matching) in streaming mode, block mode and two lagged small-block modes,
  60 matches a stream after a warm stream (seed 1);
- lockstep: one-deep ``match_scan_async`` (match i launched before match
  i-1's result is read), 40 jobs;
- batched: ``match_many_mega(jobs, chunk=16)`` over 128 jobs, and one-deep
  ``match_many_async`` in batches of 16 and 64;
- SPA: host ``SPA2d()`` ("auto" is host at this size), ``solver="cg"`` and
  ``solver="dense"`` on the card, 500 nodes of
  ``io.benchmark.noisy_loop_pose_graph``, ``compute(100, 1e-4, True,
  1e-9, 50)``, after one warm call;
- baseline: the reference matcher as multithreaded host C++
  (``native.refbaseline_match_scan``) over the same jobs, for 20 s at this
  configuration and for 10 s at range threshold 12 m.

Every device rate and SPA time is the median of ``REPEATS`` timed repeats,
each pipeline and batch repeat on a fresh stream: pipeline mode i's repeat
r on seed 0 (i = r = 0: bench.py's stream) or 2 + i + 4r; the lockstep and
batched rows' repeat r on seed 0 (r = 0) or 100 + r.  The card is
synchronised before every clock starts and before it stops.  The mega
results must be finite and equal ``match_many``'s job by job, and the warm
match's response positive; any failure raises.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

CFG = {
    # the reference's default_config: range_threshold 20 m, resolution
    # 0.01 m, search 0.5 m => G = 4051
    "range_threshold": 20.0,
    "resolution": 0.01,
    "search_size": 0.5,
    "smear_deviation": 0.05,
}
N_BASE = 10
BATCH = 16
REPEATS = 3
# pipeline mode -> (sync_every, block_dispatch, lag_blocks), as bench.py's
MODES = {
    "stream": (8, False, 0),
    "block": (8, True, 0),
    "lowlat_s2_l1": (2, True, 1),
    "lowlat_s4_l1": (4, True, 1),
}
PIPE_SCANS = N_BASE + 60
LOCKSTEP_JOBS = 40
WARM_SEED = 1
SPA_NODES = 500
SPA_ARGS = (100, 1.0e-4, True, 1.0e-9, 50)

_T0 = time.time()


def _log(msg):
    print(f"[bench_torch +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def build_stream(n_scans=150, n_beams=360, seed=0):
    """bench.py's scan stream: n_scans scans of the office world along a
    diagonal, noise 0.004 m, from `seed`."""
    from yag_slam_tpu_torch.io.simulator import SimWorld, simulate_scan

    world = SimWorld.office()
    rng = np.random.default_rng(seed)
    return [
        simulate_scan(
            world,
            np.array([0.05 * i - 2.0, 0.04 * i - 1.5, 0.02 * i]),
            n_beams=n_beams,
            range_threshold=CFG["range_threshold"],
            noise=0.004,
            rng=rng,
        )
        for i in range(n_scans)
    ]


def pipeline_seed(mode_index, repeat):
    return 0 if mode_index == repeat == 0 else 2 + mode_index + len(MODES) * repeat


def batch_seed(repeat):
    return 0 if repeat == 0 else 100 + repeat


def lockstep_jobs(scans):
    """bench.py's lockstep jobs: queries N_BASE + 2 .. N_BASE + 41, each
    against the N_BASE scans before it."""
    return [(scans[i], scans[i - N_BASE:i])
            for i in range(N_BASE + 2, min(N_BASE + 2 + LOCKSTEP_JOBS, len(scans)))]


def batch_jobs(scans):
    """bench.py's batched jobs: every query from N_BASE on but the last."""
    return [(scans[i], scans[i - N_BASE:i]) for i in range(N_BASE, len(scans) - 1)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _clock(device):
    _sync(device)
    return time.perf_counter()


def run_lockstep(m, jobs):
    """One-deep lockstep loop: match i is launched before match i-1's
    result is read.  Returns the results."""
    out, pending = [], None
    for q, bs in jobs:
        h = m.match_scan_async(q, bs, True, True)
        if pending is not None:
            out.append(pending.result())
        pending = h
    out.append(pending.result())
    return out


def run_batched(m, jobs, size):
    """match_many_async in batches of `size`, one deep (batch k launched
    before batch k-1's results are read); the jobs past the last full batch
    are left out, as bench.py does.  Returns the results."""
    n_batches = max(1, len(jobs) // size)
    out, pending = [], None
    for b in range(n_batches):
        h = m.match_many_async(jobs[b * size:(b + 1) * size], True, True)
        if pending is not None:
            out += pending.result()
        pending = h
    return out + pending.result()


def same_result(a, b):
    return (a.response == b.response
            and a.best_pose.x == b.best_pose.x and a.best_pose.y == b.best_pose.y
            and a.best_pose.euler[-1] == b.best_pose.euler[-1]
            and np.array_equal(a.covariance, b.covariance))


def check_mega(mega, many):
    """The mega results are finite and equal match_many's job by job."""
    if len(mega) != len(many):
        raise AssertionError(f"{len(mega)} mega results for {len(many)} jobs")
    for j, (a, b) in enumerate(zip(mega, many)):
        if not (np.isfinite(a.response) and np.isfinite(a.covariance).all()
                and np.isfinite([a.best_pose.x, a.best_pose.y, a.best_pose.euler[-1]]).all()):
            raise AssertionError(f"mega job {j}: non-finite result {a}")
        if not same_result(a, b):
            raise AssertionError(f"mega job {j} differs from match_many: {a} vs {b}")


class _Row:
    """Rates of one device row over its repeats, and the kernel launches
    of its timed runs."""

    def __init__(self):
        self.rates, self.matches, self.launches = [], 0, {}

    def timed(self, device, n_matches, fn):
        from yag_slam_tpu_torch.matching import kernels as K
        from yag_slam_tpu_torch.matching import program_kernels as PK

        def launches():
            return dict(K.LAUNCHES, **PK.LAUNCHES)

        before = launches()
        t0 = _clock(device)
        out = fn()
        dt = _clock(device) - t0
        self.rates.append(n_matches / dt)
        self.matches += n_matches
        for k, v in launches().items():
            self.launches[k] = self.launches.get(k, 0) + v - before[k]
        return out

    def summary(self):
        return dict(median=statistics.median(self.rates),
                    spread=[min(self.rates), max(self.rates)],
                    launches_per_match={k: v / self.matches for k, v in self.launches.items()})


def bench_device(scans, device="cuda", repeats=REPEATS):
    """The device rows on `scans` (bench.py's 150-scan stream, seed 0).
    Returns {row: {"median", "spread", "launches_per_match"}} (rows: the
    pipeline modes, "lockstep", "mega", "16", "64") and "match_response",
    the warm single match's response."""
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.matching.pipeline import OnlineMatchPipeline

    m = CorrelativeScanMatcher(CFG, device=device)
    _log("warm: single match, batched x16 and x64 (the kernels build here)")
    res = m.match_scan(scans[N_BASE], scans[:N_BASE], True, True)
    m.match_many([(scans[N_BASE + 1], scans[1:N_BASE + 1])] * BATCH, True, True)
    m.match_many([(scans[N_BASE + 1], scans[1:N_BASE + 1])] * 64, True, True)
    if not res.response > 0.0:
        raise AssertionError(f"the warm match's response is {res.response}")

    rows = {}
    warm = build_stream(PIPE_SCANS, seed=WARM_SEED)
    for i, (mode, (sync_every, block, lag)) in enumerate(MODES.items()):
        pipe = OnlineMatchPipeline(m, window=N_BASE, sync_every=sync_every,
                                   block_dispatch=block, lag_blocks=lag)
        _log(f"warm: pipeline {mode}")
        pipe.seed(warm[:N_BASE])
        for s in warm[N_BASE:]:
            pipe.push(s)
        pipe.flush()
        row = rows[mode] = _Row()
        for r in range(repeats):
            seed = pipeline_seed(i, r)
            stream = scans[:PIPE_SCANS] if seed == 0 else build_stream(PIPE_SCANS, seed=seed)
            _log(f"timed: pipeline {mode}, repeat {r} (seed {seed})")
            pipe.seed(stream[:N_BASE])

            def push_all():
                for s in stream[N_BASE:]:
                    pipe.push(s)
                return pipe.flush()

            done = row.timed(device, len(stream) - N_BASE, push_all)
            if len(done) != len(stream) - N_BASE:
                raise AssertionError(f"pipeline {mode}: {len(done)} results")

    for name in ("lockstep", "mega", str(BATCH), "64"):
        rows[name] = _Row()
    for r in range(repeats):
        seed = batch_seed(r)
        stream = scans if seed == 0 else build_stream(len(scans), seed=seed)
        jobs = lockstep_jobs(stream)
        _log(f"timed: lockstep, repeat {r} (seed {seed})")
        rows["lockstep"].timed(device, len(jobs), lambda: run_lockstep(m, jobs))
        jobs = batch_jobs(stream)
        mega_jobs = jobs[:len(jobs) // BATCH * BATCH]
        _log(f"timed: mega, {len(mega_jobs)} jobs, repeat {r}")
        mega = rows["mega"].timed(device, len(mega_jobs),
                                  lambda: m.match_many_mega(mega_jobs, chunk=BATCH))
        check_mega(mega, m.match_many(mega_jobs))
        for size in (BATCH, 64):
            n = max(1, len(jobs) // size) * size
            _log(f"timed: batched x{size}, repeat {r}")
            rows[str(size)].timed(device, min(n, len(jobs)),
                                  lambda: run_batched(m, jobs, size))
    _log("device rows done")
    out = {k: v.summary() for k, v in rows.items()}
    out["match_response"] = res.response
    return out


def bench_spa(n_nodes=SPA_NODES, repeats=REPEATS, solver=None, device="cuda"):
    """SPA2d's solve time on a noisy square loop of n_nodes:
    solver=None is "auto" (host sparse float64 LM at this size); "cg" and
    "dense" run on `device` in mixed precision.  One warm call, then
    `repeats` timed solves of fresh instances.  Returns (median ms, [min,
    max] ms, node count)."""
    from yag_slam_tpu_torch.graphopt.spa import SPA2d
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa

    graph = noisy_loop_pose_graph(n_nodes)

    def build():
        kw = {} if solver is None else dict(solver=solver)
        return populate_spa(SPA2d(device=device, **kw), *graph)

    spa = build()
    spa.compute(*SPA_ARGS)
    times = []
    for _ in range(repeats):
        spa2 = build()
        t0 = _clock(device)
        spa2.compute(*SPA_ARGS)
        times.append(1e3 * (_clock(device) - t0))
    return statistics.median(times), [min(times), max(times)], len(spa._solver.poses)


def bench_reference_native(scans, seconds=20.0, range_threshold=None):
    """The reference matcher as multithreaded host C++ over the batched
    jobs, cycled for `seconds` after one warm call.  Returns matches/s."""
    from yag_slam_tpu_torch import native

    cfg = dict(CFG, coarse_search_angle_offset=0.349, coarse_angle_resolution=0.0349)
    if range_threshold is not None:
        cfg["range_threshold"] = range_threshold
    jobs = batch_jobs(scans)
    native.refbaseline_match_scan(jobs[0][0], jobs[0][1], cfg)
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds:
        q, bs = jobs[done % len(jobs)]
        native.refbaseline_match_scan(q, bs, cfg)
        done += 1
    return done / (time.perf_counter() - t0)


def result_line(dev_rows, spa, baseline, baseline_12m, device_name, gpu, cpu):
    """bench.py's JSON object from the rows' results, with the port's keys
    added.  `spa` = {"host" | "cg" | "dense": bench_spa's tuple}."""
    modes = {k: dev_rows[k]["median"] for k in MODES}
    batched = {k: dev_rows[k]["median"] for k in ("mega", str(BATCH), "64")}
    single = max(modes["stream"], modes["block"])
    value = max(single, max(batched.values()))
    rows = list(MODES) + ["lockstep", "mega", str(BATCH), "64"]
    return {
        "metric": "scan_matches_per_sec",
        "value": value,
        "unit": "matches/s",
        "vs_baseline": value / baseline,
        "single_stream": single,
        "single_stream_by_mode": modes,
        "single_stream_lowlat": max(v for k, v in modes.items() if k.startswith("lowlat")),
        "single_stream_lockstep": dev_rows["lockstep"]["median"],
        "batched": max(batched.values()),
        "batched_by_size": batched,
        "baseline_cpu_native": baseline,
        "baseline_cpu_native_12m": baseline_12m,
        "single_vs_baseline": single / baseline,
        "backend": "cuda",
        "match_response": dev_rows["match_response"],
        "spa_solve_ms_host": spa["host"][0],
        "spa_nodes_host": spa["host"][2],
        "spa_solve_ms_device_cg": spa["cg"][0],
        "spa_nodes_device_cg": spa["cg"][2],
        "spa_solve_ms_device_dense_mixed": spa["dense"][0],
        "device": device_name,
        "power_limit": gpu.split(",")[-1].strip(),
        "host_cpu": cpu,
        "repeats": REPEATS,
        "spread": dict(
            single_stream_by_mode={k: dev_rows[k]["spread"] for k in MODES},
            single_stream_lockstep=dev_rows["lockstep"]["spread"],
            batched_by_size={k: dev_rows[k]["spread"] for k in batched},
            spa_solve_ms_host=spa["host"][1], spa_solve_ms_device_cg=spa["cg"][1],
            spa_solve_ms_device_dense_mixed=spa["dense"][1]),
        "launches_per_match": {k: dev_rows[k]["launches_per_match"] for k in rows},
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: CUDA is not available; the benchmark runs on a card")
    from yag_slam_tpu_torch.utils.profiling import cpu_model, gpu_line

    # the mixed-precision SPA steps need true float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    _log(f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    scans = build_stream()
    dev_rows = bench_device(scans, device=dev)
    spa = {}
    for name, solver in (("host", None), ("cg", "cg"), ("dense", "dense")):
        _log(f"spa {name}")
        spa[name] = bench_spa(solver=solver, device=dev)
    _log("cpu baseline 20 m")
    baseline = bench_reference_native(scans)
    _log("cpu baseline 12 m")
    baseline_12m = bench_reference_native(scans, seconds=10.0, range_threshold=12.0)
    print(json.dumps(result_line(dev_rows, spa, baseline, baseline_12m,
                                 torch.cuda.get_device_name(0), gpu, cpu_model())))


if __name__ == "__main__":
    main()
