"""Log readers, the benchmark-log generator and the synthetic worlds the
port runs on: host code (numpy), laid out as ``yag_slam_tpu.io``."""
from yag_slam_tpu_torch.io.benchmark import generate_benchmark_log
from yag_slam_tpu_torch.io.carmen import carmen_to_localized_scans, load_carmen_log
from yag_slam_tpu_torch.io.simulator import (
    SimWorld,
    raycast_world,
    simulate_scan,
    square_loop_trajectory,
)

__all__ = [
    "SimWorld",
    "raycast_world",
    "simulate_scan",
    "square_loop_trajectory",
    "generate_benchmark_log",
    "carmen_to_localized_scans",
    "load_carmen_log",
]
