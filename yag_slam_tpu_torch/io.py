"""Log readers and the benchmark-log generator the port runs on.

They are host code (numpy, no JAX) shared with the JAX package, so a log
loads into the same ``LocalizedRangeScan`` objects for both.
"""
from yag_slam_tpu.io.benchmark import generate_benchmark_log
from yag_slam_tpu.io.carmen import carmen_to_localized_scans, load_carmen_log

__all__ = ["generate_benchmark_log", "carmen_to_localized_scans", "load_carmen_log"]
