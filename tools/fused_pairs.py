#!/usr/bin/env python3
"""Device time of the matcher's grid build and window sums, in this tree or
an unpacked earlier one, at phase 3b's main-path batches.

    python3 tools/fused_pairs.py [--tree DIR] [--reps N] [--band-rows R,R,...]

Imports ``yag_slam_tpu_torch`` from DIR (default: this tree), stages the
batches that ``chip_smoke.py`` phase 3b runs (the building tour's
sequential match, the loop matcher's coarse batch of 4, the office batch of
61 jobs padded to 64, the sequential match in float64) and two more
sequential matches of the tour whose subgrids are the tour's most common
(3072, 1792 and 2560 cells a side: 60, 56 and 24 of its first 190
matches) and times, by
device time (``utils.profiling.device_ms``), each program step as the
tree runs it:

  scatter  the base points to the (N, R, R) occupancy grid: one
           ``world_scatter`` launch where the tree has it, else
           ``world_cells`` then ``scatter_cells``;
  coarse   the coarse pass's window sums: one ``lattice_window_sum``
           launch, else ``lattice_cells`` then ``window_sum``;
  fine     the same for the fine pass, centered on a strided view of a
           packed result as in ``_compute``.

The outputs are the same bits either way (the CPU tests and phase 3b hold
them).  With ``--band-rows``, a fused tree's scatter is also timed as a
bare launch at the shape ``program_kernels.scatter_shape`` gives for
each of those least band rows (what SCATTER_MIN_BAND_ROWS is chosen
from).  Prints one JSON line: per case the step times, which design ran,
the card and its power limit.  Run two trees in turns in one call to
compare them.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_QUERY, LOOP_QUERIES, X64_JOBS = 120, (150, 200, 250, 300), 61
WIDE_QUERIES = {"seq_3072": 19, "seq_1792": 33, "seq_2560": 10}  # tour queries at those


def tour_scans():
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)

    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(
            os.path.join(tmp, "tour.clf"), step=0.4, laps=1, n_beams=180, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path))
    for s in scans:
        s.corrected_pose = s.odom_pose
    return scans


def cases(dev):
    """(name, matcher, jobs, n_pad) of phase 3b's main-path batches."""
    import torch

    import bench_torch
    from yag_slam_tpu_torch.core.config import default_config, default_config_loop
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    tour = tour_scans()
    seq = [(tour[SEQ_QUERY], tour[SEQ_QUERY - 10:SEQ_QUERY])]
    loop = [(tour[q], tour[q - 25:q - 15]) for q in LOOP_QUERIES]
    x64 = bench_torch.batch_jobs(bench_torch.build_stream())[:X64_JOBS]
    return [("seq", M(default_config, device=dev), seq, None),
            ("loop", M(default_config_loop, loop=True, device=dev), loop, None),
            ("x64", M(bench_torch.CFG, device=dev), x64, 64),
            ("seq_f64", M(default_config, device=dev, dtype=torch.float64), seq, None),
            *((name, M(default_config, device=dev), [(tour[q], tour[q - 10:q])], None)
              for name, q in WIDE_QUERIES.items())]


def steps(m, jobs, n_pad):
    """{step: fn} of one batch as the imported tree runs it, its design, and
    (fused trees) a bare world_scatter launch at given band rows."""
    import torch

    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK

    args, _, S = m._prepare(jobs, n_pad=n_pad)
    st = m._stage(args)
    G, h, res = m.grid_size, m._half, m.config.resolution
    w = [st[k] for k in ("lx", "ly", "anchor", "term", "has_run", "mask", "pose", "center",
                         "vp", "sub")]
    fused = hasattr(PK, "world_scatter")
    if fused:
        occ, lim = PK.world_scatter(*w, G=G, S=S, h=h, res=res)
    else:
        sy, sx, lim = PK.world_cells(*w, G=G, S=S, h=h, res=res)
        occ = K.scatter_cells(sy, sx, S + 2 * h)
    q2d = K.smear_quantize(occ, lim, st["taps"], S, h)
    jc = st["center"]
    packed = torch.zeros((jc.shape[0], 2, 8), dtype=jc.dtype, device=jc.device)
    packed[:, 0, 1:4] = jc
    out, bare = {}, None
    if fused:
        out["scatter"] = lambda: PK.world_scatter(*w, G=G, S=S, h=h, res=res)
        lib = _build.library()
        ptrs = [t.data_ptr() for t in (*w, occ, lim)]
        params = PK._doubles(res, PK._origin_offset(G, res))
        (N, B, P), R = st["lx"].shape, S + 2 * h
        sms = torch.cuda.get_device_properties(jc.device).multi_processor_count

        def bare(min_rows):
            """(shape, a bare launch) at this least band size."""
            shape = PK.scatter_shape(N, R, sms, min_rows)

            def launch():
                err = lib.yag_world_scatter(*ptrs, N, B, P, G, S, h, *shape, params,
                                            int(jc.dtype == torch.float64),
                                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"world_scatter: cudaError {err}")

            return shape, launch
    else:
        out["scatter"] = lambda: K.scatter_cells(
            *PK.world_cells(*w, G=G, S=S, h=h, res=res)[:2], S + 2 * h)
    for name, lat, center in zip(("coarse", "fine"), m._lattices(
            m.config.coarse_search_angle_offset), (jc, packed[:, 0, 1:4])):
        largs = (st["qlx"], st["qly"], st["n_q"], center, jc, st["sub"], lat)
        if fused:
            out[name] = lambda a=largs: PK.lattice_window_sum(q2d, *a, G=G, res=res)
        else:
            out[name] = lambda a=largs, lat=lat: K.window_sum(
                q2d, *PK.lattice_cells(*a, G=G, res=res), lat.ny, lat.nx, lat.stride)
    return out, "fused" if fused else "pair", bare


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="the tree whose package is measured")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--band-rows", default="",
                    help="comma-separated least band rows to time the fused scatter at")
    args = ap.parse_args(argv)
    band_rows = [int(b) for b in args.band_rows.split(",") if b]
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_pairs: CUDA is not available; it times a card")
    import yag_slam_tpu_torch
    from yag_slam_tpu_torch.utils.profiling import device_ms, gpu_line

    if not os.path.abspath(yag_slam_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {yag_slam_tpu_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    out = {}
    for name, m, jobs, n_pad in cases(dev):
        fns, design, bare = steps(m, jobs, n_pad)
        out[name] = dict(design=design, **{k: device_ms(fn, reps=args.reps)
                                           for k, fn in fns.items()})
        if bare and band_rows:
            out[name]["bands"] = {}
            for b in band_rows:
                shape, launch = bare(b)
                out[name]["bands"][b] = dict(shape._asdict(), ms=device_ms(launch, reps=args.reps))
    print(json.dumps(dict(tree=args.tree, cases=out, gpu=gpu_line())))


if __name__ == "__main__":
    main()
