"""Host value types of the port: poses, scans and matcher configs (numpy
only), laid out as ``yag_slam_tpu.core``."""
from yag_slam_tpu_torch.core.config import (
    ScanMatcherConfig,
    default_config,
    default_config_loop,
    make_config,
)
from yag_slam_tpu_torch.core.scan import LaserScanConfig, LocalizedRangeScan
from yag_slam_tpu_torch.core.transform import Pose2, Transform

__all__ = [
    "Transform",
    "Pose2",
    "LocalizedRangeScan",
    "LaserScanConfig",
    "ScanMatcherConfig",
    "default_config",
    "default_config_loop",
    "make_config",
]
