#!/usr/bin/env python3
"""Registers, spills and shared memory of each CUDA kernel, as ptxas reports them.

    python3 tools/ptxas_usage.py [--csrc DIR ...] [--match NAME ...] [--out FILE]

Compiles every ``*.cu`` of each csrc directory (default: the package's
``yag_slam_tpu_torch/csrc``; an earlier tree's to compare) with the
package's nvcc flags plus ``-Xptxas -v`` into objects in a temporary
directory, and reads ptxas's account of each kernel it compiled for
sm_90a: registers, stack frame, spill stores and loads (bytes), static
shared memory (dynamic shared memory is the launch's), barriers.  Kernel
names are demangled with cu++filt or c++filt where the toolkit has one;
``--match`` keeps the kernels whose name holds one of the strings.  Only
the build flags differ from the package's build (the flag is for the
reading).  Needs nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ENTRY = re.compile(r"Compiling entry function '(\S+)' for '(\w+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?(?:, (\d+) bytes smem)?")


def parse(text):
    """{mangled kernel: {registers, barriers, smem, stack, spill_stores,
    spill_loads}} from ptxas -v's lines."""
    out, name = {}, None
    for line in text.splitlines():
        if m := ENTRY.search(line):
            name = m.group(1)
            out[name] = dict(arch=m.group(2))
        elif name and (m := FRAME.search(line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := USED.search(line)):
            out[name].update(registers=int(m.group(1)), barriers=int(m.group(2) or 0),
                             smem=int(m.group(3) or 0))
    return out


def demangle(names):
    """{mangled: demangled} by the toolkit's cu++filt, else c++filt."""
    from yag_slam_tpu_torch import _build

    cand = os.path.join(os.path.dirname(_build.find_nvcc()), "cu++filt")
    tool = cand if os.path.isfile(cand) else shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = res.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def usage(csrc):
    from yag_slam_tpu_torch import _build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
            res = subprocess.run(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, src + ".o"), os.path.join(csrc, src)],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr[-4000:]}")
            kernels = parse(res.stdout + res.stderr)
            names = demangle(list(kernels))
            for mangled, info in kernels.items():
                out[f"{src}: {names[mangled]}"] = info
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append",
                    help="a directory of CUDA sources (repeatable); default the package's")
    ap.add_argument("--match", action="append", help="keep kernels whose name holds this")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    dirs = args.csrc or [os.path.join(ROOT, "yag_slam_tpu_torch", "csrc")]
    result = {}
    for d in dirs:
        kernels = usage(d)
        if args.match:
            kernels = {k: v for k, v in kernels.items() if any(m in k for m in args.match)}
        result[d] = kernels
        for k, v in kernels.items():
            print(f"{d} | {k} | {v}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
