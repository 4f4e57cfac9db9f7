"""yag_slam_tpu_torch — the SLAM main path of yag_slam_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port beside the JAX package, which stays the reference.  The layout
mirrors ``yag_slam_tpu``: ``matching`` (correlative scan matcher; its three
device kernels live in ``matching/kernels.py`` and ``csrc/``), ``graphopt``
(pose graph, host sparse SPA), ``slam`` (GraphSlam, checkpoints),
``mapping`` (occupancy grids) and ``interop`` (carry a JAX-package state
over).  It shares the JAX-free host modules ``yag_slam_tpu.core``,
``yag_slam_tpu.io`` and ``yag_slam_tpu.native`` and never imports JAX.

CPU tensors run the kernels' plain PyTorch versions; CUDA tensors run the
kernels, which are compiled with nvcc at first use.
"""

__version__ = "0.1.0"
