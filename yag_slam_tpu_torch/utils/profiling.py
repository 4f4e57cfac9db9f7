"""Observability: stage timers and device-trace hooks for the port.

Counterpart of ``yag_slam_tpu/utils/profiling.py``: ``StageTimer`` is host
code; ``block_and_time`` waits for the card with
``torch.cuda.synchronize`` around each call; ``device_trace`` records a
``torch.profiler`` trace of the CPU and, when present, the CUDA activity
and writes it as a Chrome trace.

The port's own measurement helpers follow (``chip_smoke.py`` and the
root-level ``*_torch.py`` harnesses share them): the card's and the host
CPU's names, device time by CUDA events (``cuda_ms``, ``device_ms``), and
the least time the card could take for a piece of work (``bound``) with
the byte and operation counts of the grid-build and window-sum kernels.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulating named timers: ``with timer("match"): ...``"""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self):
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    1000.0 * self.totals[name] / max(self.counts[name], 1), 3
                ),
            }
            for name in sorted(self.totals)
        }

    def report(self):
        for name, row in self.summary().items():
            print(
                f"[timer] {name}: {row['count']}x, mean {row['mean_ms']} ms, "
                f"total {row['total_s']} s"
            )


# the Chrome trace's file name inside device_trace's log_dir
TRACE_FILE = "trace.json"


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir="yag_slam_tpu_torch_trace"):
    """Trace the block with torch.profiler (CUDA activity too when a card
    is there) and write it as a Chrome trace, ``TRACE_FILE`` in the
    directory `log_dir`; yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _synchronize()
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def block_and_time(fn, *args, repeats=10, **kwargs):
    """Time `fn` with the card idle before and after every call; returns
    (mean seconds over `repeats` calls after one warm-up, last result)."""
    result = fn(*args, **kwargs)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn(*args, **kwargs)
        _synchronize()
    return (time.perf_counter() - t0) / repeats, result


# -- measurement on the card ---------------------------------------------------

# Published peaks of one H100 SXM (NVIDIA's H100 datasheet): HBM
# bytes/s, float32 and float64 operations/s outside the tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S, F64_OPS_PER_S = 3.35e12, 67e12, 34e12
TIMING_REPS = 20
SPIN_CYCLES = 1_000_000      # the card's spin before each device_ms launch


def gpu_line():
    """The card's name and power limit as nvidia-smi prints them
    ("NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cpu_model():
    """The host CPU's model name from lscpu; where it reads "unknown" (a
    virtual machine may hide it), the vendor, family and model numbers."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    fields = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    fields = {k.strip().lower(): v.strip() for k, v in fields.items()}
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = (f"{fields.get('vendor id', 'unknown vendor')} family "
                 f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}")
    return f"{model}, {os.cpu_count()} CPUs"


def cuda_ms(fn, reps=TIMING_REPS, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=TIMING_REPS, warmup=3, spin=SPIN_CYCLES):
    """Median device milliseconds of fn(), by CUDA events around it with
    the card kept busy (a spin of `spin` cycles) while the host queues the
    events and the launches, so host launch time is not counted (unless fn
    waits for the card itself, or its launches take the host longer than
    the spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes, ops=0, ops_per_s=F32_OPS_PER_S):
    """The least time the card could take: each input byte read once and
    each output byte written once at the HBM rate, or the operations at
    the card's peak (float32 unless `ops_per_s` says otherwise), whichever
    is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return dict(bytes=int(n_bytes), ops=int(ops), bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def smear_ops(N, S, h):
    """The float32 chain of the smear: per pass-1 element (S x (S + 2h) of
    them) and per output, one multiply for the centre and a max, a
    multiply and a max per tap pair (3h + 1 ops)."""
    return (3 * h + 1) * N * (S * (S + 2 * h) + S * S)


def smear_bytes(N, S, h, out_bytes):
    """A smear's input grids, its outputs of `out_bytes` each and its taps."""
    return N * (S + 2 * h) ** 2 + out_bytes * N * S * S + 4 * (2 * h + 1)


def window_cells(q, gy0, gx0, n_pts, ny, nx, stride):
    """The distinct in-grid cells (bytes of the uint8 grids) that the
    lattice windows of the first n_pts points read."""
    N, S, _ = q.shape
    dev = q.device
    y = gy0[:, :, :n_pts, None].long() + stride * torch.arange(ny, device=dev)
    x = gx0[:, :, :n_pts, None].long() + stride * torch.arange(nx, device=dev)
    inside = ((y >= 0) & (y < S))[..., :, None] & ((x >= 0) & (x < S))[..., None, :]
    lin = (torch.arange(N, device=dev)[:, None, None, None, None] * S * S
           + y[..., :, None] * S + x[..., None, :])
    touched = torch.zeros(N * S * S, dtype=torch.bool, device=dev)
    touched[lin[inside]] = True
    return int(touched.sum())


def window_bytes(q, gy0, gx0, n_pts, ny, nx, stride):
    """What the lattice needs: the distinct in-grid bytes its windows read,
    the live points' cells, the counts and the int32 output."""
    N = q.shape[0]
    K_ = gy0.shape[1]
    return (window_cells(q, gy0, gx0, n_pts, ny, nx, stride) + 8 * N * K_ * n_pts
            + 4 * N + 4 * N * K_ * ny * nx)
