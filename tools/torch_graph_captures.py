#!/usr/bin/env python3
"""CUDA-graph captures per timed repeat of the tour833-online workload.

    python3 tools/torch_graph_captures.py [--seed 0]

Runs the cell's warm-up and timed repeats as ``benchmark/cells.py`` runs
them (60 scans of seed + 1000, then 5 fresh ``GraphSlam`` runs over the
833-scan tour) with the matcher's CUDA graphs counted around each: per
phase the eager ``_run`` calls, the captures and their host milliseconds,
the replays, the scans per second, the slowest scan and the size of the
graphs' memory pool after it; then the keys in
the cache, the device memory they hold (their pool and static tensors:
what dropping them frees) and the peak device memory, allocated and
reserved.  One JSON line last.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_graph_captures.py needs a CUDA card")

    from benchmark import cells, measure
    from yag_slam_tpu_torch.matching.graphs import GRAPHS

    torch.set_num_threads(cells.spec()["host_threads"])
    tr = cells.traffic(cells.workload("tour833-online"), {})
    dtype = getattr(torch, cells.karto()["dtype"])
    with tempfile.TemporaryDirectory() as tmp:
        warm, _, _ = cells.tour_records(args.seed + tr["warm_seed_offset"], tmp)
        records, _, _ = cells.tour_records(args.seed, tmp)
    n = tr["scans"]
    torch.cuda.reset_peak_memory_stats()
    rows = []

    def pool_mb():
        """The segments of the graphs' memory pools, in MB."""
        pools = {tuple(pool) for pool, _ in GRAPHS._pools.values()}
        segments = torch.cuda.memory._snapshot()["segments"]
        return sum(sg["total_size"] for sg in segments
                   if tuple(sg.get("segment_pool_id", ())) in pools) / 1e6

    def counted(name, scans, slam):
        before = dict(GRAPHS.stats)
        lat = []
        t0 = time.perf_counter()
        for s in scans:
            t = time.perf_counter()
            slam.process_scan(s)
            lat.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = {k: GRAPHS.stats[k] - before[k] for k in before}
        row = dict(phase=name, scans=len(scans), scans_per_s=len(scans) / wall,
                   pool_mb=pool_mb(),
                   eager=d["eager"], captures=d["captures"],
                   ms_per_capture=1e3 * d["capture_s"] / d["captures"] if d["captures"] else None,
                   capture_ms=1e3 * d["capture_s"], replays=d["replays"],
                   slowest_scan_ms=1e3 * max(lat))
        rows.append(row)
        print(f"{name}: {row['scans_per_s']:.3f} scans/s, {row['eager']} eager _runs, "
              f"{row['captures']} captures ({row['capture_ms']:.3f} ms), {row['replays']} "
              f"replays, slowest scan {row['slowest_scan_ms']:.3f} ms; the graphs' pool "
              f"{row['pool_mb']:.1f} MB", flush=True)

    counted("warm-up", cells._scans(warm, tr["warm_scans"]), cells.new_slam("cuda", dtype))
    for r in range(tr["repeats"]):
        counted(f"repeat {r}", cells._scans(records, n), cells.new_slam("cuda", dtype))
    out = dict(rows=rows, keys=len(GRAPHS._entries),
               captured_keys=sum(e.graph is not None for e in GRAPHS._entries.values()),
               peak_mb=torch.cuda.max_memory_allocated() / 1e6,
               peak_reserved_mb=torch.cuda.max_memory_reserved() / 1e6, seed=args.seed,
               card=measure.card_line(), host_cpu=measure.host_cpu())
    # what the graphs hold (their pool and static tensors): the reserved
    # memory that dropping them frees, once garbage and unused cached
    # blocks are gone
    gc.collect()
    torch.cuda.empty_cache()
    with_graphs = torch.cuda.memory_reserved()
    GRAPHS._entries.clear()
    GRAPHS._pools.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["graphs_mb"] = (with_graphs - torch.cuda.memory_reserved()) / 1e6
    print(f"keys {out['keys']} ({out['captured_keys']} captured), holding "
          f"{out['graphs_mb']:.1f} MB; peak device memory {out['peak_mb']:.1f} MB "
          f"allocated, {out['peak_reserved_mb']:.1f} MB reserved; {out['card']}; "
          f"{out['host_cpu']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
