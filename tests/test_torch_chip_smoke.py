"""chip_smoke.py's host-side arithmetic: the trace reader and the pose gap."""
import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from yag_slam_tpu_torch.matching.kernels import KERNELS

NAMES = {k: v["symbol"] for k, v in KERNELS.items()}


def test_device_timeline_merges_only_device_events():
    events = [
        dict(cat="kernel", name="void (anonymous namespace)::smear_kernel<"
             "(anonymous namespace)::QuantizeMaskStore>(unsigned char const*, "
             "float const*, (anonymous namespace)::QuantizeMaskStore, int, int)",
             ts=100.0, dur=10.0),
        dict(cat="kernel", name="at::native::elementwise_kernel", ts=105.0, dur=10.0),
        dict(cat="kernel", name="window_sum_kernel(int)", ts=108.0, dur=2.0),
        dict(cat="kernel", name="void (anonymous namespace)::smear_kernel<"
             "(anonymous namespace)::FloatStore>(int)", ts=111.0, dur=1.0),
        dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=130.0, dur=4.0),
        dict(cat="gpu_memset", name="Memset", ts=200.0, dur=1.0),
        # host-side events never count as device time
        dict(cat="cpu_op", name="aten::add", ts=0.0, dur=1000.0),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=99.0, dur=5.0),
        dict(ph="M", name="process_name"),
    ]
    tl = smoke.device_timeline(events, NAMES)
    assert tl["events"] == 6
    # union of [100, 115), [130, 134), [200, 201) in us
    assert tl["busy_ms"] == pytest.approx((15.0 + 4.0 + 1.0) / 1e3)
    parts = tl["parts"]
    assert parts["smear_quantize"] == dict(ms=pytest.approx(0.010), count=1)
    assert parts["window_sum"] == dict(ms=pytest.approx(0.002), count=1)
    assert parts["smear_grid"] == dict(ms=pytest.approx(0.001), count=1)
    assert parts["scatter_cells"] == dict(ms=0.0, count=0)
    assert parts["other_kernels"] == dict(ms=pytest.approx(0.010), count=1)
    assert parts["memcpy_memset"] == dict(ms=pytest.approx(0.005), count=2)


@pytest.mark.parametrize("events", [[], [dict(cat="cpu_op", name="aten::mm", ts=0, dur=9)]])
def test_device_timeline_without_device_events(events):
    tl = smoke.device_timeline(events, NAMES)
    assert tl["busy_ms"] == 0.0 and tl["events"] == 0


def test_pose_gap_wraps_heading():
    a = np.array([[0.0, 0.0, np.pi - 0.001], [1.0, 2.0, 0.5]])
    b = np.array([[0.003, 0.004, -np.pi + 0.001], [1.0, 2.0, 0.5]])
    dxy, dth = smoke.pose_gap(a, b)
    assert dxy == pytest.approx(0.005)
    assert dth == pytest.approx(0.002)

