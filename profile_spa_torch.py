#!/usr/bin/env python3
"""SPA solver crossover of the PyTorch port: host sparse float64 LM against
the card's dense and matrix-free PCG solvers, in mixed and float64
precision, across graph sizes.

    python3 profile_spa_torch.py [--out FILE]

Counterpart of profile_spa.py: the same sizes (100-4000 nodes of
``io.benchmark.noisy_loop_pose_graph``), the same columns and
``compute(100, 1e-4, True, 1e-9, 200)``.  Each cell: one warm call (the
card's libraries load on a first call), then the best of 3 timed solves,
or the warm call alone where it takes over 5 s; its ms, LM iterations
and host reads (``graphopt.spa.HOST_READS``).  Each device cell is held
to host (cost within 1e-3 relative, poses within 2e-3) at the sizes where
the JAX package's same solver meets those bars on the CPU; elsewhere it
must end finite and below its initial cost.  A cell that misses its bar
raises.  TF32 is turned off: the mixed steps need true float32.

The host column is the native solve (``native.spa_lm``, the host solver's
path).  Its row also times that solve bare on the packed arrays beside its
plain numpy + SuperLU version, ``graphopt.spa._host_lm``, on the same
arrays (:func:`host_pair`), and holds the two to each other at the tests'
bars (tests/test_torch_spa_native.py): the same stop reason and LM
iterations, poses within 1e-8, cost within 1e-10 relative.
``chip_smoke.py`` phase 12 runs :func:`crossover` with its cg columns at
100, 1000 and 4000 nodes only.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import time

import numpy as np
import torch

SIZES = (100, 500, 1000, 2000, 4000)
COLUMNS = (("host", "f64"), ("dense", "mixed"), ("dense", "f64"), ("cg", "mixed"),
           ("cg", "f64"))
ARGS = (100, 1e-4, True, 1e-9, 200)
REPS = 3
# a cell whose warm call takes longer is timed by that call alone
SLOW_MS = 5000.0
COST_RTOL, POSE_TOL = 1e-3, 2e-3
# the native host solve against its numpy version (the tests' bars)
HOST_COST_RTOL, HOST_POSE_TOL = 1e-10, 1e-8
CONV_TOL = 1.0e-4   # SPA2d.compute's default LM stop
# the sizes at which each device solver is held to host: those at which
# the JAX package's same solver reaches host's optimum within the bars on
# the CPU.  Its float32 factorization (dense:mixed) parts from 1000 nodes
# on, its 200 CG iterations per LM step (cg) from 300 on; there a cell
# must end finite and below its initial cost.
HELD = {"dense:f64": SIZES, "dense:mixed": (100, 500), "cg:mixed": (100,),
        "cg:f64": (100,)}


def column(solver, precision):
    return solver if solver == "host" else f"{solver}:{precision}"


def pose_gap(a, b):
    """Largest position (m) and heading (rad) difference of two (n, 3)
    [x, y, theta] pose arrays."""
    dxy = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max()
    dth = np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2])))).max()
    return float(dxy), float(dth)


def _best(fn):
    """One warm call, then the best of REPS (the warm call alone where it
    takes over SLOW_MS): (best ms, every timed ms, the best call's
    result)."""
    def timed():
        t0 = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t0), out

    warm = timed()
    runs = [timed() for _ in range(REPS)] if warm[0] < SLOW_MS else [warm]
    ms, out = min(runs, key=lambda r: r[0])
    return ms, [r[0] for r in runs], out


def host_pair(graph):
    """The native host solve and graphopt.spa._host_lm, each bare on the
    arrays the host solver packs for `graph` with compute's ARGS: their
    best-of ms, the native solve's stop reason, LM iterations and fill
    (blocks of L below its diagonal), and how far the numpy result lies
    from the native one."""
    from yag_slam_tpu_torch import native
    from yag_slam_tpu_torch.graphopt import spa as S
    from yag_slam_tpu_torch.io.benchmark import populate_spa

    s = populate_spa(S.SPA2d(solver="host", device="cpu"), *graph)._solver
    args = (np.asarray(s.poses, dtype=np.float64), np.asarray(s.edge_idx, dtype=np.int64),
            np.asarray(s.edge_means, dtype=np.float64), np.stack(s.edge_infos),
            ARGS[0], ARGS[1], CONV_TOL)
    native_ms, native_runs, (p_n, c_n, it_n, why_n) = _best(lambda: native.spa_lm(*args))
    fill = native.SPA_FILL["blocks"]
    numpy_ms, numpy_runs, (p_p, c_p, it_p, why_p) = _best(lambda: S._host_lm(*args))
    return dict(native_ms=native_ms, native_ms_runs=native_runs, numpy_ms=numpy_ms,
                numpy_ms_runs=numpy_runs, reason=why_n, numpy_reason=why_p,
                native_iters=it_n, numpy_iters=it_p, fill_blocks=fill,
                numpy_cost_rel=abs(c_p - c_n) / abs(c_n) if c_n else abs(c_p),
                numpy_pose_gap=float(np.abs(p_p - p_n).max()))


def crossover(device="cuda", sizes=SIZES, cg_sizes=SIZES, log=print, label=""):
    """Every column at every size (cg at `cg_sizes` only) on `device`,
    each cell logged as it ends; returns the rows.  Raises if a device
    cell misses its bar."""
    from yag_slam_tpu_torch.graphopt import spa as S
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa

    on_card = torch.device(device).type == "cuda"
    if on_card and (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the mixed SPA steps need true float32")
    rows, bad = [], []
    for n in sizes:
        graph = noisy_loop_pose_graph(n)
        guesses, edges, info = graph
        cost0 = S._np_cost(np.asarray(guesses), np.array([e[0] for e in edges]),
                           np.array([e[1] for e in edges]),
                           np.broadcast_to(np.asarray(info), (len(edges), 3, 3)))
        host = None
        for solver, precision in COLUMNS:
            name = column(solver, precision)
            if solver == "cg" and n not in cg_sizes:
                continue

            def solve():
                spa = populate_spa(S.SPA2d(solver=solver, precision=precision,
                                           device=device), *graph)
                if on_card:
                    torch.cuda.synchronize()
                S.reset_host_reads()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    cost = spa.compute(*ARGS, verbose=True)
                ms = 1e3 * (time.perf_counter() - t0)
                last = buf.getvalue().splitlines()[-1]
                iters = int(re.search(r"after (\d+) iters", last).group(1))
                return dict(cost=cost, ms=ms, iters=iters, reads=dict(S.HOST_READS),
                            poses=np.asarray(spa._solver.poses))

            warm = solve()      # the card's libraries load on a first call
            runs = [solve() for _ in range(REPS)] if warm["ms"] < SLOW_MS else [warm]
            best = min(runs, key=lambda r: r["ms"])
            row = dict(nodes=len(guesses), edges=len(edges), solver=name,
                       ms=best["ms"], ms_runs=[r["ms"] for r in runs], iters=best["iters"],
                       host_reads=best["reads"], cost=best["cost"], initial_cost=cost0)
            if host is None:
                host = best
                pair = host_pair(graph)
                row.update(pair)
                if not (pair["reason"] == pair["numpy_reason"]
                        and pair["native_iters"] == pair["numpy_iters"]
                        and pair["numpy_cost_rel"] <= HOST_COST_RTOL
                        and pair["numpy_pose_gap"] <= HOST_POSE_TOL):
                    bad.append(f"host at {n} nodes parted from its numpy version: {pair}")
            else:
                dxy, dth = pose_gap(best["poses"], host["poses"])
                row.update(cost_rel_vs_host=abs(best["cost"] - host["cost"]) / host["cost"],
                           dxy_vs_host_m=dxy, dth_vs_host_rad=dth)
            rows.append(row)
            if "dxy_vs_host_m" in row:
                gap = (f"; vs host: cost {row['cost_rel_vs_host']:.2e} rel, |dxy| "
                       f"{row['dxy_vs_host_m']:.2e} m, |dth| {row['dth_vs_host_rad']:.2e} rad")
            else:
                gap = (f"; bare: native {row['native_ms']:.3f} ms vs numpy _host_lm "
                       f"{row['numpy_ms']:.3f} ms ({row['numpy_ms'] / row['native_ms']:.1f}x), "
                       f"{row['reason']} after {row['native_iters']} vs {row['numpy_reason']} "
                       f"after {row['numpy_iters']}, fill {row['fill_blocks']} blocks, numpy "
                       f"{row['numpy_pose_gap']:.2e} apart, cost {row['numpy_cost_rel']:.2e} rel")
            log(f"SPA {row['nodes']} nodes {name}: {row['ms']:.3f} ms (best of "
                f"{len(runs)}), {row['iters']} LM iterations, host reads {row['host_reads']}, "
                f"chi2 {row['cost']:.6g}{gap} ({label})")
            if solver == "host":
                continue
            if n in HELD[name]:
                row["held_to_host"] = True
                if not (row["cost_rel_vs_host"] <= COST_RTOL
                        and max(row["dxy_vs_host_m"], row["dth_vs_host_rad"]) <= POSE_TOL):
                    bad.append(f"{name} at {n} nodes parted from host")
            elif not (np.isfinite(row["cost"]) and row["cost"] <= cost0):
                bad.append(f"{name} at {n} nodes ended at cost {row['cost']} (from {cost0})")
    if bad:
        raise AssertionError(f"SPA on {device}: {bad}")
    return rows


def table(rows):
    """profile_spa.py's table: a line per size, best ms per column ("-"
    where the cell did not run), then host's chi2."""
    names = [column(s, p) for s, p in COLUMNS]
    lines = [f"{'nodes':>6} | " + " | ".join(f"{s:>11}" for s in names)
             + "  (best-of-3 ms; cost must agree)"]
    for n in dict.fromkeys(r["nodes"] for r in rows):
        cells = {r["solver"]: r for r in rows if r["nodes"] == n}
        lines.append(f"{n:>6} | " + " | ".join(
            f"{cells[s]['ms']:>11.1f}" if s in cells else f"{'-':>11}" for s in names)
            + f"   chi2={cells['host']['cost']:.4g}")
    lines.append("host bare, best-of-3 ms: " + ", ".join(
        f"{r['nodes']} nodes native {r['native_ms']:.3f} / numpy {r['numpy_ms']:.3f}"
        for r in rows if r["solver"] == "host"))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_spa_torch: CUDA is not available; it times a card's solvers")
    from yag_slam_tpu_torch.utils.profiling import gpu_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({gpu})")
    rows = crossover(torch.device("cuda", 0), label=gpu)
    for line in table(rows):
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(gpu=gpu, rows=rows), f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
