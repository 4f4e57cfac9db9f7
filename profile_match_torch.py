#!/usr/bin/env python3
"""Stage-by-stage device time of the PyTorch port's batched match core at
the benchmark's shapes, each stage beside the least time the card could
take for it.

    python3 profile_match_torch.py [--batch 16] [--out FILE]

The jobs are profile_match.py's: queries N_BASE + 1 .. N_BASE + batch of
bench_torch.py's stream (seed 0), each against the N_BASE scans before
it, at the benchmark's configuration (G = 4051), float32, penalty and fine
pass on.  The stages are those of ``CorrelativeScanMatcher._run``:

  inputs          library gathers (``_stage``);
  occupancy       base points to world, the keep mask, their cells and the
                  occupancy grid of those cells (``world_scatter``: the
                  ``scatter_cells`` kernel fed by the points);
  smear_quantize  the ``smear_quantize`` kernel;
  staged          the staged route instead: ``smear_grid`` then
                  ``quantize_mask`` (what ``_run`` runs with meta; its
                  grid must equal smear_quantize's bit for bit);
  coarse_score    the coarse lattice's window sums at the query points'
                  origin cells (``lattice_window_sum``: the ``window_sum``
                  kernel at stride 2, fed by the points);
  coarse_reduce   its scores and best pose (``score_reduce``);
  fine_score      the fine lattice's window sums around the coarse poses
                  (stride 1);
  fine_reduce     its scores and best pose;
  end_to_end      the whole ``_run`` (on the card: staging, one CUDA
                  graph replay, the clone of its output).

Each stage runs on materialised inputs (the earlier stages' outputs,
computed once), timed by CUDA events: ``ms`` with the card kept busy by
a spin of ``STAGE_SPIN`` cycles (~11 ms) while the host queues the
launches (``utils.profiling.device_ms``: the device's time, unless the
stage waits for the card itself, as ``syncs`` shows), ``wall_ms``
without (host launch gaps show).  ``syncs`` counts the calls in one run
of the stage that make the host wait for the card (torch.cuda's sync
debug mode).  The bound is ``utils.profiling.bound``: the stage's inputs
read once and outputs written once at 3.35 TB/s, or its float32
operations at 67 TFLOP/s, whichever is larger; the kernels' stages count
their bytes and operations as ``chip_smoke.py`` phase 3b does (a score
stage reads only the distinct grid cells its windows touch), the other
stages their tensors' bytes.  The end-to-end bound is the sum of the
route's stage bounds (every stage but ``staged``), beside the sum of the
route's stage times.  Last, ``TRACE_RUNS`` whole ``_run`` calls are traced
with torch.profiler: per call the kernels, copies and fills on the card,
their summed device time, and the idle share of the wall time.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import warnings

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
STAGES = ("inputs", "occupancy", "smear_quantize", "staged", "coarse_score",
          "coarse_reduce", "fine_score", "fine_reduce")
ROUTE = tuple(s for s in STAGES if s != "staged")
# the spin before each timed stage: longer than any stage's host launches
STAGE_SPIN = 20_000_000
TRACE_RUNS = 5


def build_stream(n_scans=150, n_beams=360, seed=0):
    """bench_torch.py's scan stream: n_scans scans of the office world
    along a diagonal, noise 0.004 m, from `seed`."""
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


def setup(batch=16, device="cuda", dtype=torch.float32, scans=None):
    """The matcher and the assembled arrays of `batch` jobs, with their
    shapes: N jobs, B base-scan bucket, P point lanes, S subgrid side, G
    grid side, h smear half-width."""
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

    scans = build_stream() if scans is None else scans
    m = CorrelativeScanMatcher(CFG, device=device, dtype=dtype)
    jobs = [(scans[N_BASE + i + 1], scans[i + 1:N_BASE + i + 1]) for i in range(batch)]
    P = m._ensure_point_cap([q for q, _ in jobs] + [s for _, bs in jobs for s in bs])
    B = m._base_bucket(N_BASE)
    args, S = m._assemble_jobs(jobs, P, B)
    return dict(m=m, jobs=jobs, args=args, N=batch, B=B, P=P, S=S, G=m.grid_size,
                h=m._half, offset=m.config.coarse_search_angle_offset)


def compose(ctx):
    """Run the stages once, in order, each on the outputs of the ones
    before it.  Returns (packed (N, 2, 8), {stage: output}, {stage: fn}),
    packed being what ``batched_core`` returns for the same jobs; raises
    if the staged route's grid differs from smear_quantize's."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK

    m, args, S, G, h = (ctx[k] for k in ("m", "args", "S", "G", "h"))
    res, taps, offset = m.config.resolution, m._taps, ctx["offset"]
    out, fns = {}, {}

    def stage(name, fn):
        fns[name] = fn
        out[name] = fn()
        return out[name]

    st = stage("inputs", lambda: m._stage(args))
    occ, lim = stage("occupancy", lambda: PK.world_scatter(
        *(st[k] for k in ("lx", "ly", "anchor", "term", "has_run", "mask", "pose", "center",
                          "vp", "sub")), G=G, S=S, h=h, res=res))
    q2d = stage("smear_quantize", lambda: K.smear_quantize(occ, lim, taps, S, h))
    staged = stage("staged", lambda: K.quantize_mask(K.smear_grid(occ, taps, S, h), lim))
    if not torch.equal(staged, q2d):
        raise AssertionError("the staged route's grid differs from smear_quantize's")
    jc, n_q = st["center"], st["n_q"]
    packed = torch.empty((n_q.shape[0], 2, 8), dtype=m.dtype, device=n_q.device)
    for row, (name, lat) in enumerate(zip(("coarse", "fine"), m._lattices(offset))):
        center = jc if row == 0 else packed[:, 0, 1:4]
        raw = stage(f"{name}_score", lambda c=center, lat=lat: PK.lattice_window_sum(
            q2d, st["qlx"], st["qly"], n_q, c, jc, st["sub"], lat, G=G, res=res))
        stage(f"{name}_reduce", lambda c=center, r=raw, row=row, lat=lat: PK.score_reduce(
            r, n_q, c, jc, packed, row, lat, G=G, res=res, penalize=True,
            karto=m.config.karto_penalty_tuple()))
    return packed, out, fns


def nbytes(*xs):
    """Bytes of tensors and arrays (nested in tuples, lists and dicts)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        else:
            total += x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes
    return total


def stage_work(ctx, out, fns):
    """{stage: (bytes, ops)} that each stage must move and compute."""
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.utils.profiling import smear_bytes, smear_ops, window_cells

    m, args, N, B, P, S, G, h = (ctx[k] for k in ("m", "args", "N", "B", "P", "S", "G", "h"))
    lib = m.library.fields
    row = sum(lib[k].element_size() for k in ("lx", "ly", "anchor", "term", "has_run"))
    st = out["inputs"]
    world = tuple(st[k] for k in ("lx", "ly", "anchor", "term", "has_run", "mask", "pose",
                                  "center", "vp", "sub"))
    queries = tuple(st[k] for k in ("qlx", "qly", "n_q", "center", "sub"))
    work = {
        # library rows of the base and query scans, the job arrays, the outputs
        "inputs": (N * B * P * row + N * (2 * P * lib["lx"].element_size() + 4)
                   + nbytes(args, world, queries), 0),
        "occupancy": (nbytes(world, out["occupancy"]), 0),
        "smear_quantize": (smear_bytes(N, S, h, 1) + 8 * N, 0),
        # the staged route also writes the float32 grid (the meta grid)
        "staged": (smear_bytes(N, S, h, 1 + 4) + 8 * N, smear_ops(N, S, h)),
    }
    q, n_q = out["smear_quantize"], st["n_q"]
    # the fine pass's centers: row 0 of the packed result
    centers = (st["center"], out["fine_reduce"][:, 0, 1:4])
    for name, lat, center in zip(("coarse", "fine"), m._lattices(ctx["offset"]), centers):
        gy0, gx0, _ = PK.lattice_cells_ref(st["qlx"], st["qly"], n_q, center, st["center"],
                                           st["sub"], lat, G=G, res=m.config.resolution)
        cells = sum(window_cells(q[j:j + 1], gy0[j:j + 1], gx0[j:j + 1], int(n_q[j]),
                                 lat.ny, lat.nx, lat.stride) for j in range(N))
        work[f"{name}_score"] = (cells + nbytes(queries, center, out[f"{name}_score"]), 0)
        # the sums read, one row of the result written
        work[f"{name}_reduce"] = (nbytes(out[f"{name}_score"], st["n_q"])
                                  + out[f"{name}_reduce"].nbytes // 2, 0)
    return work


def host_syncs(fn):
    """How many calls in one fn() made the host wait for the card."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def trace(fn, runs=TRACE_RUNS):
    """fn() `runs` times under torch.profiler (CUDA activity): per call
    the kernels, copies and fills the card ran, their summed device
    milliseconds, the host wall milliseconds and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    count = {c: 0 for c in ("kernel", "gpu_memcpy", "gpu_memset")}
    busy = 0.0
    for e in events:
        if e.get("cat") in count:
            count[e["cat"]] += 1
            busy += e.get("dur", 0.0) / 1e3
    if count["kernel"] == 0:
        raise AssertionError("the trace holds no kernel on the card")
    return dict(kernels=count["kernel"] / runs, copies=count["gpu_memcpy"] / runs,
                fills=count["gpu_memset"] / runs, busy_ms=busy / runs,
                wall_ms=wall_ms / runs, idle_share=1.0 - busy / wall_ms)


def profile(ctx):
    """Time every stage of setup()'s `ctx` and the whole _run on the card;
    returns the results (shapes, per stage ms, wall_ms, syncs and bound,
    the route's sums and the end-to-end row)."""
    from yag_slam_tpu_torch.utils.profiling import bound, cuda_ms, device_ms

    m, args, P, S = ctx["m"], ctx["args"], ctx["P"], ctx["S"]
    packed, out, fns = compose(ctx)
    want = m.batched_core(P, ctx["B"], True, True, S)(*args)
    if not torch.equal(packed, want):
        raise AssertionError("the composed stages differ from batched_core")
    work = stage_work(ctx, out, fns)
    stages = {}
    for name in STAGES:
        fn = fns[name]
        stages[name] = dict(ms=device_ms(fn, spin=STAGE_SPIN), wall_ms=cuda_ms(fn),
                            syncs=host_syncs(fn),
                            **bound(*work[name]))
        stages[name]["share"] = stages[name]["bound_ms"] / stages[name]["ms"]

    def e2e():
        return m._run(args, P, True, True, ctx["offset"], S)

    sum_bytes = sum(work[s][0] for s in ROUTE)
    sum_ops = sum(work[s][1] for s in ROUTE)
    end = dict(ms=device_ms(e2e, spin=STAGE_SPIN), wall_ms=cuda_ms(e2e), syncs=host_syncs(e2e),
               **bound(sum_bytes, sum_ops))
    end["share"] = end["bound_ms"] / end["ms"]
    return dict(
        shapes={k: ctx[k] for k in ("N", "B", "P", "S", "G", "h")},
        trace=trace(e2e), stages=stages, route=list(ROUTE),
        stages_sum_ms=sum(stages[s]["ms"] for s in ROUTE),
        stages_sum_wall_ms=sum(stages[s]["wall_ms"] for s in ROUTE),
        end_to_end=end,
    )


def report(results, device_name, gpu):
    """Print the shapes line and the stage table."""
    sh = results["shapes"]
    print(f"shapes: N={sh['N']} B={sh['B']} P={sh['P']} S={sh['S']} G={sh['G']} "
          f"h={sh['h']} device={device_name} ({gpu})")
    print(f"{'stage':15s} {'ms':>9s} {'wall ms':>9s} {'syncs':>5s} {'bound us':>9s} "
          f"{'by':>10s} {'share':>6s} {'GB/s':>8s}")
    rows = dict(results["stages"], end_to_end=results["end_to_end"])
    for name, r in rows.items():
        print(f"{name:15s} {r['ms']:9.4f} {r['wall_ms']:9.4f} {r['syncs']:5d} "
              f"{1e3 * r['bound_ms']:9.3f} {r['bound_by']:>10s} {r['share']:6.3f} "
              f"{r['bytes'] / r['ms'] / 1e6:8.1f}")
    print(f"route stages' sum {results['stages_sum_ms']:.4f} ms (wall "
          f"{results['stages_sum_wall_ms']:.4f}) vs end to end "
          f"{results['end_to_end']['ms']:.4f} ms (wall {results['end_to_end']['wall_ms']:.4f}); "
          f"{sh['N']} jobs, {sh['N'] / results['end_to_end']['wall_ms'] * 1e3:.1f} matches/s "
          f"by the wall time")
    t = results["trace"]
    print(f"traced _run: {t['kernels']:.1f} kernels, {t['copies']:.1f} copies, "
          f"{t['fills']:.1f} fills per call; device busy {t['busy_ms']:.4f} of "
          f"{t['wall_ms']:.4f} ms, idle share {t['idle_share']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_match_torch: CUDA is not available; it profiles a card")
    from yag_slam_tpu_torch.utils.profiling import gpu_line

    dev = torch.device("cuda", 0)
    name, gpu = torch.cuda.get_device_name(0), gpu_line()
    results = profile(setup(args.batch, device=dev))
    report(results, name, gpu)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(results, device=name, gpu=gpu), f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
