"""Trajectory evaluation metrics: the port's own copy of
``yag_slam_tpu/utils/metrics.py``."""
from __future__ import annotations

import numpy as np


def umeyama_2d(src, dst):
    """Least-squares rigid alignment (R, t) mapping src -> dst, both (N,2)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cs = src - mu_s
    cd = dst - mu_d
    cov = cd.T @ cs / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(2)
    if np.linalg.det(U @ Vt) < 0:
        S[1, 1] = -1
    R = U @ S @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_rmse(est_xy, gt_xy, align=True):
    """Absolute trajectory error RMSE over (N,2) position arrays."""
    est_xy = np.asarray(est_xy, dtype=np.float64)
    gt_xy = np.asarray(gt_xy, dtype=np.float64)
    if align:
        R, t = umeyama_2d(est_xy, gt_xy)
        est_xy = est_xy @ R.T + t
    err = est_xy - gt_xy
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def trajectory_from_slam(slam):
    """(N,2) corrected positions from a GraphSlam instance, in vertex order."""
    return np.array(
        [
            [v.obj.corrected_pose.x, v.obj.corrected_pose.y]
            for v in slam.graph.vertices
        ]
    )
