#!/usr/bin/env python3
"""Parent/change pairs of one benchmark cell on the CUDA card.

    python3 tools/bench_pairs.py --cell tour833-online --parent build/parent \\
        [--pairs 4] [--seed 0] [--out chiprun_out/pairs-tour.jsonl]

Runs ``benchmark/run.py --cell C --seed S`` of the tree at --parent (an
unpacked earlier commit) and of this tree in turns, one process a run, the
side that goes first alternating from pair to pair (parent first in the
first).  Each run's last line (the cell's JSON result) goes to --out as one
line with its side and pair.  Then prints, for every metric and for the
traced run's per-layer numbers (SPA ms a solve, the spans), each side's
median and runs, the change's median over the parent's, and the pairs the
change won; the card line and host CPU; and, last, one JSON object with all
of it.  Exits 1 when any run fails or is not correct.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# metric -> whether higher is better, as BENCHMARK.json's cells state it
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    HIGHER = {m["name"]: m["direction"] == "higher"
              for w in json.load(_f)["workloads"] for m in w["metrics"]}


def run_cell(tree, cell, seed):
    """One run of the cell from `tree`: its JSON result (None on failure)
    and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--cell", cell, "--seed",
                           str(seed)], cwd=tree, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode not in (0, 1) or not lines:
        print(f"run in {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}",
              file=sys.stderr)
        return None, wall
    return json.loads(lines[-1]), wall


def layer_numbers(result):
    """The traced run's per-layer scalars: SPA ms a solve, idle share, each
    span's ms a scan (tour) or a call (batch)."""
    pl = result["per_layer"]
    out = {k: pl[k] for k in ("spa_ms_per_solve", "device_idle_share", "traced_scans_per_s",
                              "traced_matches_per_s", "device_busy_ms_per_scan",
                              "device_busy_ms_per_dispatch")
           if isinstance(pl.get(k), (int, float))}
    for name, v in pl.get("spans", {}).items():
        for key in ("ms_per_scan", "self_ms_per_scan", "ms_per_call"):
            if key in v:
                out[f"{name}.{key}"] = v[key]
    return out


def summarize(runs):
    sides = {s: [r for r in runs if r["side"] == s] for s in ("parent", "change")}
    names = list(sides["change"][0]["result"]["metrics"])
    out = {}
    for name in names:
        vals = {s: [r["result"]["metrics"][name] for r in rs] for s, rs in sides.items()}
        higher = HIGHER.get(name, False)
        wins = sum((c > p) if higher else (c < p)
                   for p, c in zip(vals["parent"], vals["change"]))
        med = {s: statistics.median(v) for s, v in vals.items()}
        out[name] = dict(parent=vals["parent"], change=vals["change"], parent_median=med[
            "parent"], change_median=med["change"], ratio=med["change"] / med["parent"],
            change_won=wins, pairs=len(vals["change"]))
    layers = {}
    for s, rs in sides.items():
        for r in rs:
            for k, v in layer_numbers(r["result"]).items():
                layers.setdefault(k, {}).setdefault(s, []).append(v)
    for k, v in layers.items():
        out[f"layer {k}"] = dict(
            parent=v.get("parent", []), change=v.get("change", []),
            parent_median=statistics.median(v["parent"]) if v.get("parent") else None,
            change_median=statistics.median(v["change"]) if v.get("change") else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--parent", required=True, help="the parent's unpacked tree")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="JSON lines of every run")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_pairs.py needs a CUDA card")
    parent = os.path.abspath(args.parent)
    runs, ok = [], True
    for k in range(args.pairs):
        order = ("parent", "change") if k % 2 == 0 else ("change", "parent")
        for side in order:
            result, wall = run_cell(parent if side == "parent" else ROOT, args.cell,
                                    args.seed)
            if result is None or not result["correct"]:
                ok = False
            if result is None:
                continue
            rec = dict(side=side, pair=k, wall_s=wall, result=result)
            runs.append(rec)
            m = result["metrics"]
            print(f"pair {k} {side}: " + ", ".join(f"{n} {v:.6g}" for n, v in m.items())
                  + f"; correct {result['correct']}; spa ms a solve "
                  f"{result['per_layer'].get('spa_ms_per_solve')}; {wall:.1f} s", flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(dict(side=side, pair=k, wall_s=wall,
                                            result=result)) + "\n")
    if not runs or not any(r["side"] == "parent" for r in runs) or \
            not any(r["side"] == "change" for r in runs):
        raise SystemExit("bench_pairs.py: a side has no run")
    summary = summarize(runs)
    for name, v in summary.items():
        if "ratio" in v:
            print(f"{name}: parent median {v['parent_median']:.6g}, change median "
                  f"{v['change_median']:.6g} ({100 * (v['ratio'] - 1):+.1f} %), change won "
                  f"{v['change_won']} of {v['pairs']} pairs")
        elif v["parent_median"] is not None and v["change_median"] is not None:
            print(f"{name}: parent median {v['parent_median']:.6g}, change median "
                  f"{v['change_median']:.6g}")
    card, cpu = runs[0]["result"]["card"], runs[0]["result"]["host_cpu"]
    print(f"card: {card}\nhost_cpu: {cpu}")
    print(json.dumps(dict(cell=args.cell, seed=args.seed, pairs=args.pairs, ok=ok, card=card,
                          host_cpu=cpu, summary=summary)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
