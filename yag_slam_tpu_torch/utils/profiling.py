"""Observability: stage timers and device-trace hooks for the port.

Counterpart of ``yag_slam_tpu/utils/profiling.py``: ``StageTimer`` is host
code; ``block_and_time`` waits for the card with
``torch.cuda.synchronize`` around each call; ``device_trace`` records a
``torch.profiler`` trace of the CPU and, when present, the CUDA activity
and writes it as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
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
