#!/usr/bin/env python3
"""Where a tour833-online scan's time goes, the closing scans apart.

    python3 tools/torch_closing_scans.py [--seed 0] [--repeats 2] [--device cuda]

Runs the cell's warm-up and `--repeats` fresh ``GraphSlam`` runs over the
833-scan tour as ``benchmark/cells.py`` runs them (no profiler), each
layer's calls in a span (``benchmark/measure.Spans``): ``process_scan``,
``seq_matcher.match_scan``, ``loop_matcher.match_many``,
``seq_matcher.match_many``, ``run_opt``, ``opt.compute`` and
``search.update_all``.  A repeat's scans are split into closing scans
(those that ran ``run_opt``: a loop closure and its SPA solve), the scans
at or above the nearest-rank p99 of all scans, and the rest; for each
group: how many, their mean ms, and the mean ms a scan of each layer, with
the write-back after a solve apart (``run_opt`` less ``opt.compute``:
the 833 ``Transform`` rebuilds from ``SPA2d.nodes`` and
``search.update_all``); plus the CUDA-graph captures the group's scans
made (``matching.graphs.GRAPHS.stats``) and the p50 and p99.  One JSON line
last.  ``--device cpu`` runs the plain path (with ``--scans``, a shorter
tour) for a check of the script itself.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LAYERS = ("seq_matcher.match_scan", "loop_matcher.match_many", "seq_matcher.match_many",
          "run_opt", "opt.compute", "search.update_all")


def spanned(slam, spans):
    spans.wrap(slam, "process_scan", "process_scan")
    spans.wrap(slam.seq_matcher, "match_scan", "seq_matcher.match_scan")
    spans.wrap(slam.loop_matcher, "match_many", "loop_matcher.match_many")
    spans.wrap(slam.seq_matcher, "match_many", "seq_matcher.match_many")
    spans.wrap(slam, "run_opt", "run_opt")
    spans.wrap(slam.opt, "compute", "opt.compute")
    spans.wrap(slam.search, "update_all", "search.update_all")
    return slam


def per_scan(records):
    """Each top-level process_scan span: its ms and the ms of each layer
    inside it (spans nest by their parent index)."""
    top = {}
    for i, r in enumerate(records):
        root = i
        while records[root]["parent"] is not None:
            root = records[root]["parent"]
        if records[root]["name"] != "process_scan":
            continue
        row = top.setdefault(root, {"ms": 1e3 * (records[root]["end"]
                                                 - records[root]["start"])})
        if i != root:
            row[r["name"]] = row.get(r["name"], 0.0) + 1e3 * (r["end"] - r["start"])
    return [top[k] for k in sorted(top)]


def group(rows):
    out = dict(scans=len(rows), mean_ms=statistics.mean(r["ms"] for r in rows) if rows else None,
               captures=sum(r["captures"] for r in rows))
    for name in LAYERS:
        out[name] = statistics.mean(r.get(name, 0.0) for r in rows) if rows else None
    if rows:
        out["write_back"] = out["run_opt"] - out["opt.compute"]
        out["transforms_and_nodes"] = out["write_back"] - out["search.update_all"]
        out["rest"] = out["mean_ms"] - sum(out[k] for k in LAYERS[:3]) - out["run_opt"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=None, help="a shorter tour")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("torch_closing_scans.py needs a CUDA card (or --device cpu)")

    from benchmark import cells, measure
    from yag_slam_tpu_torch import native
    from yag_slam_tpu_torch.matching.graphs import GRAPHS

    torch.set_num_threads(cells.spec()["host_threads"])
    tr = cells.traffic(cells.workload("tour833-online"), {})
    dtype = getattr(torch, cells.karto()["dtype"])
    with tempfile.TemporaryDirectory() as tmp:
        warm, _, _ = cells.tour_records(args.seed + tr["warm_seed_offset"], tmp)
        records, _, _ = cells.tour_records(args.seed, tmp)
    n = args.scans or tr["scans"]
    slam = cells.new_slam(args.device, dtype)
    for s in cells._scans(warm, tr["warm_scans"]):
        slam.process_scan(s)
    measure.sync(args.device)

    out = dict(seed=args.seed, device=args.device, scans=n, repeats=[])
    for r in range(args.repeats):
        spans = measure.Spans()
        slam = spanned(cells.new_slam(args.device, dtype), spans)
        native.reset_calls()
        captures = []
        t0 = measure.clock(args.device)
        for s in cells._scans(records, n):
            before = GRAPHS.stats["captures"]
            slam.process_scan(s)
            captures.append(GRAPHS.stats["captures"] - before)
        wall = measure.clock(args.device) - t0
        rows = per_scan(spans.records)
        for row, c in zip(rows, captures):
            row["captures"] = c
        timed = rows[1:]   # the cell's latencies leave out each run's first scan
        lat = [row["ms"] for row in timed]
        p99 = measure.percentile(lat, 99)
        closing = [row for row in timed if "run_opt" in row]
        tail = [row for row in timed if row["ms"] >= p99]
        rest = [row for row in timed if "run_opt" not in row and row["ms"] < p99]
        rep = dict(repeat=r, scans_per_s=n / wall, p50_ms=measure.percentile(lat, 50),
                   p99_ms=p99, max_ms=max(lat), solves=slam.stats["opt_runs"],
                   native_spa_calls=native.CALLS.get("spa_lm"),
                   closing_in_tail=sum("run_opt" in row for row in tail),
                   closing=group(closing), tail=group(tail), rest=group(rest))
        out["repeats"].append(rep)
        c = rep["closing"]
        print(f"repeat {r}: {rep['scans_per_s']:.3f} scans/s, p50 {rep['p50_ms']:.3f} ms, "
              f"p99 {p99:.3f} ms ({rep['closing_in_tail']} of the {len(tail)} scans at or "
              f"above it close a loop), max {rep['max_ms']:.3f} ms; {rep['solves']} "
              f"solves ({rep['native_spa_calls']} native)", flush=True)
        if closing:
            print(f"  closing scans: {c['scans']}, {c['mean_ms']:.3f} ms each: match_scan "
                  f"{c['seq_matcher.match_scan']:.3f}, loop batches "
                  f"{c['loop_matcher.match_many']:.3f} + {c['seq_matcher.match_many']:.3f}, "
                  f"opt.compute {c['opt.compute']:.3f}, write-back {c['write_back']:.3f} "
                  f"(transforms and nodes {c['transforms_and_nodes']:.3f}, update_all "
                  f"{c['search.update_all']:.3f}), rest {c['rest']:.3f}; "
                  f"{c['captures']} captures", flush=True)
        for name in ("tail", "rest"):
            g = rep[name]
            if g["scans"]:
                print(f"  {name}: {g['scans']} scans, {g['mean_ms']:.3f} ms each, "
                      f"{g['captures']} captures, loop batches "
                      f"{g['loop_matcher.match_many'] + g['seq_matcher.match_many']:.3f} ms",
                      flush=True)
    if args.device != "cpu":
        out.update(card=measure.card_line(), host_cpu=measure.host_cpu())
        print(f"card: {out['card']}; host: {out['host_cpu']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
