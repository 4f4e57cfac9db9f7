from yag_slam_tpu_torch.utils.metrics import ate_rmse, trajectory_from_slam, umeyama_2d
from yag_slam_tpu_torch.utils.profiling import StageTimer, block_and_time, device_trace
from yag_slam_tpu_torch.utils.viz import plot_slam, save_slam_figure

__all__ = ["ate_rmse", "trajectory_from_slam", "umeyama_2d",
           "StageTimer", "block_and_time", "device_trace",
           "plot_slam", "save_slam_figure"]
