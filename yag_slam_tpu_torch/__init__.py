"""yag_slam_tpu_torch — the SLAM main path of yag_slam_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port beside the JAX package, which stays the reference.  The layout
mirrors ``yag_slam_tpu``: ``matching`` (correlative scan matcher; its four
device kernels live in ``matching/kernels.py`` and ``csrc/``), ``graphopt``
(pose graph; host sparse, dense and matrix-free SPA), ``slam`` (GraphSlam,
checkpoints), ``mapping`` (occupancy grids), ``splicing`` (lifelong
mapping), ``parallel`` (sharded loop matching and SPA on
``torch.distributed``), ``native`` (the reference matcher as host C++),
``apps`` (online mappers, offline CLI, the A/B harness against the
reference matcher, the ROS1 node), the host modules ``core`` (poses, scans,
configs), ``io`` (CARMEN logs, synthetic worlds) and ``utils``, and
``interop`` (carry a JAX-package state over).  It imports neither JAX nor
any module of the JAX package: the host modules are the port's own copies.

Every public entry point runs on ``device="cuda"`` unless the caller asks
for ``device="cpu"``; without a card it raises.  CPU tensors run the
kernels' plain PyTorch versions; CUDA tensors run the kernels, which are
compiled with nvcc at first use.
"""

__version__ = "0.1.0"

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
    "__version__",
]
