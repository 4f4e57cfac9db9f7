#!/usr/bin/env python3
"""The splice's sweep kernel, this tree's and other sources', timed in turns on the CUDA card.

    python3 tools/sweep_kernels.py [--parent PATH] [--design NAME=PATH ...] [--turns 2]
                                   [--out FILE]

Each source (this tree's ``csrc/sweep.cu``; ``--parent``: the parent
tree's copy; ``--design``: any other) is compiled with this tree's nvcc
flags into a library of its own, all at once, and its ``yag_sweep`` entry
point is called through ctypes by its parameters' names (with a zeroed
scratch where it takes one).  The cases are phase 11's of chip_smoke.py
(``sweep_cases``) on the map a SLAM pass on the card makes of the one-lap
building tour, as phase 4 makes it: every centroid of the card's
segmentation, one start, the long-ray map and the edge inputs.  Every
source's lengths and ends are first held bit-equal to the plain version's
on every case; then each of the timed cases is timed bare
(``device_ms``) in turns: the sources in order, then in reverse, ``--turns``
times.  Prints the card, then a line a case and source: the median of its
turns' ms, each turn's ms, and the bound.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# ctypes type of each parameter of yag_sweep, by name
_INTS = {"h", "w", "n_angles", "n_starts", "max_steps"}


def splice_map(dev):
    """Phase 4's map and the centroids of phase 11: GraphSlam.default on
    the card (float32) over the one-lap building tour less its last
    HOLD_BACK scans, its occupancy image top row first, segmented on the
    card at the splice's density."""
    import chip_smoke
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
    from yag_slam_tpu_torch.splicing import splice

    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(os.path.join(tmp, "building.clf"), step=0.4,
                                                laps=1, n_beams=chip_smoke.N_BEAMS, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path), range_threshold=20.0)
    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    for s in scans[:-chip_smoke.HOLD_BACK]:
        slam.process_scan(s)
    im = np.ascontiguousarray(slam.make_occupancy_grid().image[::-1])
    cents = splice.determine_centroids(splice.segment_map(im, density=5, device=dev))
    return im, np.array([cents[k] for k in range(len(cents))])


def build(sources, out_dir):
    """{name: loaded library} of each {name: .cu path}, compiled in
    parallel by nvcc with the package's flags (this tree's csrc on the
    include path)."""
    from yag_slam_tpu_torch import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, src = item
        so = out_dir / f"sweep_{name}.so"
        _build._run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
                     "-o", str(so), str(src)])
        return name, ctypes.CDLL(str(so))

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def parameters(src):
    """The parameter names of the source's yag_sweep, in order."""
    text = Path(src).read_text()
    m = re.search(r'extern "C" int yag_sweep\((.*?)\)', text, re.S)
    if m is None:
        raise SystemExit(f"{src}: no yag_sweep entry point")
    return [re.findall(r"\w+", p)[-1] for p in m.group(1).split(",")]


class Kernel:
    """A source's yag_sweep on one case's inputs."""

    def __init__(self, lib, names, args, ends):
        img, c, s, st, max_steps = args
        (H, W), S, A = img.shape, st.shape[0], c.shape[0]
        dev = img.device
        self.out = [torch.empty((S, A), dtype=torch.float32, device=dev)
                    for _ in range(3 if ends else 1)]
        # the counters, and room for a class map of the image at 2 bits a pixel
        self.scratch = torch.zeros(2 + (H * W + 15) // 16 + 16, dtype=torch.int32, device=dev)
        value = dict(img=img.data_ptr(), h=H, w=W, cosv=c.data_ptr(), sinv=s.data_ptr(),
                     n_angles=A, starts=st.data_ptr(), n_starts=S, max_steps=max_steps,
                     length=self.out[0].data_ptr(),
                     end_x=self.out[1].data_ptr() if ends else None,
                     end_y=self.out[2].data_ptr() if ends else None,
                     scratch=self.scratch.data_ptr(),
                     stream=torch.cuda.current_stream().cuda_stream)
        self.fn = lib.yag_sweep
        self.fn.argtypes = [ctypes.c_int if n in _INTS else ctypes.c_void_p for n in names]
        self.fn.restype = ctypes.c_int
        self.args = [value[n] for n in names]

    def __call__(self):
        err = self.fn(*self.args)
        if err != 0:
            raise RuntimeError(f"yag_sweep failed: cudaError {err}")
        return self.out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent tree's csrc/sweep.cu")
    ap.add_argument("--design", action="append", default=[], metavar="NAME=PATH",
                    help="another sweep.cu to time beside them")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_kernels.py needs a CUDA card")
    import chip_smoke
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.mapping import raytrace as RT
    from yag_slam_tpu_torch.utils.profiling import device_ms, gpu_line

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    sources = {"tree": _build.CSRC_DIR / "sweep.cu"}
    if args.parent:
        sources = {"parent": Path(args.parent), **sources}
    for d in args.design:
        name, path = d.split("=", 1)
        sources[name] = Path(path)
    libs = build(sources, _build.BUILD_DIR / "sweep_kernels")
    names = {k: parameters(p) for k, p in sources.items()}
    im, starts = splice_map(dev)
    print(gpu, flush=True)
    results = []
    for i, (case, inputs) in enumerate(chip_smoke.sweep_cases(im, starts, dev)):
        ref = RT.trace_sweeps_ref(*inputs, ends=True)
        for k, lib in libs.items():
            got = Kernel(lib, names[k], inputs, ends=True)()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{k}: differs from the plain version on {case}")
        row = chip_smoke.sweep_case(case, inputs, timed=False)
        row["ms"] = {k: [] for k in libs}
        if i < chip_smoke.SWEEP_TIMED_CASES:
            kernels = {k: Kernel(lib, names[k], inputs, ends=False) for k, lib in libs.items()}
            for turn in range(args.turns):
                order = list(kernels) if turn % 2 == 0 else list(kernels)[::-1]
                for k in order:
                    row["ms"][k].append(device_ms(kernels[k]))
            for k, ms in row["ms"].items():
                print(f"{case}: {k} {statistics.median(ms):.4f} ms (turns "
                      + " ".join(f"{t:.4f}" for t in ms)
                      + f"); bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
                      f"{row['steps']} steps, longest {row['longest']} ({gpu})", flush=True)
        results.append(row)
    print(f"every source bit-equal to the plain version on all {len(results)} cases "
          f"(lengths and ends)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(gpu=gpu, sources={k: str(p) for k, p in sources.items()},
                           cases=results), f, indent=1)


if __name__ == "__main__":
    main()
