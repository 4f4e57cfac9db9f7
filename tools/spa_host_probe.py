#!/usr/bin/env python3
"""The host SPA solve on a tour-shaped graph, native against numpy, on
this machine's CPU.

    python3 tools/spa_host_probe.py [--serpentine R]

The graph: 833 nodes two laps of a circle (832 noisy odometry edges) and
46 loop edges from the second lap to the first, as the tour833-online
cell's graph is shaped at its last solve.  Prints, best of 20 (of 3 for
numpy): the bare native solve (``native.spa_lm``) at 0 and 1 LM
iterations and to convergence (what the ordering and set-up take, and
an iteration), the numpy + SuperLU ``graphopt.spa._host_lm`` on the same
arrays, ``PoseGraphSolver.optimize`` through the native solve (the
packing included), and the factor's fill.  With ``--serpentine R``,
also one native solve of ``chip_smoke.serpentine_graph`` at R x R nodes.
Host CPU only: no device number.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LAM0, CTOL, MAX_ITERS = 1.0e-4, 1.0e-4, 100


def tour_shaped(seed=0):
    from yag_slam_tpu_torch.core.transform import se2_compose, se2_relative

    rng = np.random.default_rng(seed)
    true = [np.zeros(3)]
    for _ in range(832):
        true.append(se2_compose(true[-1], np.array([0.4, 0.0, 2 * np.pi / 416])))
    info = np.diag([100.0, 100.0, 400.0])
    poses, eidx, means, infos = [true[0]], [], [], []
    for i in range(832):
        m = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.01, 3)
        poses.append(se2_compose(poses[-1], m))
        eidx.append([i, i + 1])
        means.append(m)
        infos.append(info)
    for k in np.linspace(420, 832, 46).astype(int):
        eidx.append([k - 416, k])
        means.append(se2_relative(true[k], true[k - 416]))
        infos.append(5 * info)
    return np.array(poses), np.array(eidx), np.array(means), np.array(infos)


def best_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return min(times), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serpentine", type=int, default=0)
    args = ap.parse_args(argv)
    from yag_slam_tpu_torch import native
    from yag_slam_tpu_torch.graphopt import spa as S

    p, e, m, w = tour_shaped()
    native.spa_lm(p, e, m, w, MAX_ITERS, LAM0, CTOL)   # builds the library
    for iters in (0, 1, MAX_ITERS):
        ms, (_, cost, it, why) = best_ms(lambda: native.spa_lm(p, e, m, w, iters, LAM0, CTOL),
                                         20)
        print(f"native, max_iters {iters}: {ms:.3f} ms ({why} after {it}, cost {cost:.6g})")
    print(f"fill: {native.SPA_FILL['blocks']} blocks of L below its diagonal")
    ms, (_, cost, it, why) = best_ms(lambda: S._host_lm(p, e, m, w, MAX_ITERS, LAM0, CTOL), 3)
    print(f"numpy _host_lm: {ms:.3f} ms ({why} after {it}, cost {cost:.6g})")
    solver = S.PoseGraphSolver(device="cpu")
    for i, q in enumerate(p):
        solver.add_node(*q, i)
    for (i, j), mean, info in zip(e, m, w):
        solver.add_constraint(int(i), int(j), *mean, info)

    def optimize():
        solver.poses = p.tolist()
        return solver.optimize(MAX_ITERS, LAM0, 1e-9, False, 50, CTOL)

    ms, _ = best_ms(optimize, 20)
    print(f"PoseGraphSolver.optimize (native, packing included): {ms:.3f} ms")
    if args.serpentine:
        import importlib.util

        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(ROOT, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        sp = S.PoseGraphSolver(device="cpu")
        smoke.serpentine_graph(sp, args.serpentine, args.serpentine)
        arrays = (np.asarray(sp.poses), np.asarray(sp.edge_idx), np.asarray(sp.edge_means),
                  np.stack(sp.edge_infos))
        ms, (_, cost, it, why) = best_ms(
            lambda: native.spa_lm(*arrays, MAX_ITERS, LAM0, CTOL), 1)
        print(f"serpentine {len(sp.poses)} nodes, {len(sp.edge_idx)} edges: native "
              f"{ms:.1f} ms ({why} after {it}), fill {native.SPA_FILL['blocks']} blocks")


if __name__ == "__main__":
    main()
