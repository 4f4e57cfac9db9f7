"""Synthetic 2D lidar worlds: the port's own copy of
``yag_slam_tpu/io/simulator.py``.

Ground-truth-known worlds, so trajectory and ATE checks run without
external data.
"""
from __future__ import annotations

import numpy as np

from yag_slam_tpu_torch.core.scan import LocalizedRangeScan
from yag_slam_tpu_torch.core.transform import se2_compose, se2_relative


class SimWorld:
    """A set of wall segments (N, 2, 2): [segment, endpoint, xy]."""

    def __init__(self, segments):
        self.segments = np.asarray(segments, dtype=np.float64)

    @classmethod
    def rectangle(cls, w, h, cx=0.0, cy=0.0):
        x0, x1 = cx - w / 2, cx + w / 2
        y0, y1 = cy - h / 2, cy + h / 2
        return cls(
            [
                [[x0, y0], [x1, y0]],
                [[x1, y0], [x1, y1]],
                [[x1, y1], [x0, y1]],
                [[x0, y1], [x0, y0]],
            ]
        )

    @classmethod
    def office(cls):
        """A 14x10 room with interior walls and a pillar: enough structure
        that scan matching is well-conditioned everywhere."""
        world = cls.rectangle(14.0, 10.0).segments.tolist()
        world += cls.rectangle(1.0, 1.0, cx=-3.0, cy=1.5).segments.tolist()
        world += cls.rectangle(0.8, 0.8, cx=3.0, cy=-1.0).segments.tolist()
        world += [
            [[-7.0, -1.5], [-4.5, -1.5]],  # wall stub from left
            [[2.0, 5.0], [2.0, 2.5]],      # wall stub from top
            [[5.5, -5.0], [5.5, -2.5]],    # wall stub from bottom
        ]
        return cls(world)

    def __add__(self, other):
        return SimWorld(np.concatenate([self.segments, other.segments]))


def raycast_world(world: SimWorld, x, y, angles, max_range=100.0):
    """Vectorized ray/segment intersection: ranges (len(angles),)."""
    p = world.segments[:, 0]  # (S, 2)
    q = world.segments[:, 1]
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)  # (A, 2)
    o = np.array([x, y])

    e = q - p  # (S, 2)
    # solve o + t*d = p + u*e, i.e. [d, -e] [t; u] = p - o  (per ray x segment)
    denom = d[:, None, 0] * (-e[None, :, 1]) - d[:, None, 1] * (-e[None, :, 0])
    rel = (p - o)[None, :, :]  # (1, S, 2)
    t_num = rel[..., 0] * (-e[None, :, 1]) - rel[..., 1] * (-e[None, :, 0])
    u_num = d[:, None, 0] * rel[..., 1] - d[:, None, 1] * rel[..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t_num / denom
        u = u_num / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    ranges = t.min(axis=1)
    return np.minimum(ranges, max_range)


def simulate_scan(
    world,
    pose_xyt,
    n_beams=360,
    min_angle=-np.pi,
    max_angle=np.pi,
    max_range=30.0,
    range_threshold=12.0,
    noise=0.0,
    rng=None,
    odom_pose_xyt=None,
):
    """Simulate one scan at the ground-truth pose; the odometry pose may
    differ (drifted)."""
    inc = (max_angle - min_angle) / n_beams
    angles = pose_xyt[2] + min_angle + np.arange(n_beams) * inc
    ranges = raycast_world(world, pose_xyt[0], pose_xyt[1], angles, max_range)
    if noise and rng is not None:
        ranges = ranges + rng.normal(0, noise, n_beams)
    op = odom_pose_xyt if odom_pose_xyt is not None else pose_xyt
    # the corrected pose starts at odometry; the caller keeps the truth
    return LocalizedRangeScan(
        ranges, min_angle, max_angle, inc, 0.0, max_range, range_threshold,
        op[0], op[1], op[2],
    )


def square_loop_trajectory(side=6.0, step=0.5, laps=1, start=(-3.0, -3.0)):
    """Ground-truth poses walking a square loop, heading along the path."""
    poses = []
    x, y = start
    pose = np.array([x, y, 0.0])
    steps_per_side = int(round(side / step))
    for _ in range(laps):
        for _ in range(4):
            for _ in range(steps_per_side):
                pose = se2_compose(pose, np.array([step, 0.0, 0.0]))
                poses.append(pose.copy())
            pose = se2_compose(pose, np.array([0.0, 0.0, np.pi / 2]))
            poses.append(pose.copy())
    return np.array(poses)


def drifted_odometry(gt_poses, yaw_bias=0.002, xy_noise=0.004, yaw_noise=0.002,
                     seed=0):
    """Dead-reckoned odometry: ground-truth deltas corrupted by bias and
    noise, accumulated from the first pose."""
    rng = np.random.default_rng(seed)
    odom = [gt_poses[0].copy()]
    for i in range(1, len(gt_poses)):
        delta = se2_relative(gt_poses[i], gt_poses[i - 1])
        delta = delta + np.array(
            [
                rng.normal(0, xy_noise),
                rng.normal(0, xy_noise),
                yaw_bias + rng.normal(0, yaw_noise),
            ]
        )
        odom.append(se2_compose(odom[-1], delta))
    return np.array(odom)
