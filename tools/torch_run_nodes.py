#!/usr/bin/env python3
"""What the card runs for one captured matcher `_run` of the building tour,
in this tree or an unpacked earlier one.

    python3 tools/torch_run_nodes.py [--tree DIR] [--scans 200] [--runs 5]

Imports ``yag_slam_tpu_torch`` from DIR (default: this tree), runs the
tour's first --scans scans through ``GraphSlam.default`` on the card in
float32 (so the matchers' keys are captured), then traces with
torch.profiler --runs replays of the captured graph of the sequential key
used most and of the loop matcher's coarse key used most, and --runs
whole scans after them. Prints one JSON line: per key its shapes, the
device nodes of a replay (kernels, copies, fills), their busy ms and the
kernels by name; the card's busy ms a scan; the card and its power limit.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace(fn, runs):
    """fn() `runs` times under torch.profiler: device nodes and busy ms a
    run, and the kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") in DEVICE_CATS and "dur" in e]
    count = collections.Counter(e["cat"] for e in events)
    names = collections.Counter(e["name"].split("(")[0].split("<")[0][:60]
                                for e in events if e["cat"] == "kernel")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(nodes=len(events) / runs, kernels=count["kernel"] / runs,
                copies=count["gpu_memcpy"] / runs, fills=count["gpu_memset"] / runs,
                busy_ms=busy / 1e3 / runs,
                by_name={k: v / runs for k, v in names.most_common(12)})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="the tree whose package is measured")
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_run_nodes: CUDA is not available; it traces a card")
    import yag_slam_tpu_torch
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)
    from yag_slam_tpu_torch.matching.graphs import GRAPHS
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(os.path.join(tmp, "tour.clf"), step=0.4,
                                                laps=1, n_beams=180, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path))
    slam = GraphSlam.default(device="cuda", dtype=torch.float32)
    for s in scans[:args.scans]:
        slam.process_scan(s)
    torch.cuda.synchronize()
    out = dict(tree=os.path.abspath(args.tree),
               package=os.path.dirname(os.path.abspath(yag_slam_tpu_torch.__file__)),
               scans=args.scans, keys={})
    for kind in ("sequential", "loop_coarse"):
        entries = [(k, e) for k, e in GRAPHS._entries.items() if e.graph is not None
                   and (k.config == slam.loop_matcher.config) == (kind == "loop_coarse")
                   and k.penalty == (kind == "sequential")]
        if not entries:
            continue
        key, e = max(entries, key=lambda ke: ke[1].uses)
        for _ in range(3):
            # a trace that lost device events (a kernel not seen the same
            # number of times each replay) is taken again
            t = trace(e.graph.replay, args.runs)
            if all(float(v).is_integer() for v in t["by_name"].values()):
                break
        out["keys"][kind] = dict(N=key.N, B=key.B, P=key.P, S=key.S, uses=e.uses, replay=t)
    rest = iter(scans[args.scans:])
    out["scan"] = trace(lambda: slam.process_scan(next(rest)), args.runs)
    out["gpu"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
