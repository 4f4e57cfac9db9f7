from yag_slam_tpu_torch.utils.profiling import StageTimer, block_and_time, device_trace

__all__ = ["StageTimer", "block_and_time", "device_trace"]
