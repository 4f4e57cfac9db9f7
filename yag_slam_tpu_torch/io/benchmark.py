"""Benchmark inputs: the port's own copy of ``yag_slam_tpu/io/benchmark.py``.

A multi-room floor plan, a long tour that revisits the corridor (loop
closures), drifted wheel odometry, and a writer of standard CARMEN
`FLASER` (or `ROBOTLASER1`) lines, so a generated log goes through the
same loader as a real Intel log: given the real `intel.clf`,
``yag-slam-tpu-torch-mapper --carmen intel.clf --gt ...`` runs it as it is.
Also the noisy square-loop pose graph that SPA is timed on.
"""
from __future__ import annotations

import numpy as np

from yag_slam_tpu_torch.core.transform import se2_compose, se2_relative
from yag_slam_tpu_torch.io.simulator import (
    SimWorld,
    drifted_odometry,
    raycast_world,
)


def building_world():
    """A ~28 x 16 m office building: outer shell, central corridor, four
    rooms with door gaps, and some furniture-scale clutter."""
    segs = []

    def rect(x0, y0, x1, y1):
        segs.extend([
            [[x0, y0], [x1, y0]], [[x1, y0], [x1, y1]],
            [[x1, y1], [x0, y1]], [[x0, y1], [x0, y0]],
        ])

    # outer shell
    rect(-14.0, -8.0, 14.0, 8.0)
    # corridor walls (y = -1.5 and y = 1.5) with door gaps
    for y in (-1.5, 1.5):
        segs.append([[-14.0, y], [-9.0, y]])
        segs.append([[-7.0, y], [-2.0, y]])
        segs.append([[0.0, y], [5.0, y]])
        segs.append([[7.0, y], [14.0, y]])
    # room dividers (vertical), gaps at the corridor
    for x in (-7.0, 0.0, 7.0):
        segs.append([[x, 1.5], [x, 8.0]])
        segs.append([[x, -8.0], [x, -1.5]])
    # clutter
    for cx, cy, s in [(-10.5, 4.5, 0.8), (-3.5, 5.0, 0.6), (3.5, 4.0, 0.7),
                      (10.5, 5.0, 0.6), (-10.5, -4.5, 0.7), (-3.5, -5.0, 0.6),
                      (3.5, -4.5, 0.8), (10.5, -4.5, 0.6)]:
        rect(cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2)
    return SimWorld(segs)


def _walk(waypoints, step):
    """Piecewise-linear tour with heading along travel and in-place turns
    at the corners (at most ~0.35 rad per pose, so sequential matching
    tracks)."""
    poses = []
    heading = None
    pos = np.asarray(waypoints[0], dtype=np.float64)
    for wp in waypoints[1:]:
        wp = np.asarray(wp, dtype=np.float64)
        d = wp - pos
        dist = float(np.hypot(d[0], d[1]))
        if dist < 1e-9:
            continue
        target = float(np.arctan2(d[1], d[0]))
        if heading is None:
            heading = target
            poses.append(np.array([pos[0], pos[1], heading]))
        # turn in place
        dth = (target - heading + np.pi) % (2 * np.pi) - np.pi
        n_turn = max(1, int(np.ceil(abs(dth) / 0.35)))
        for k in range(1, n_turn + 1):
            poses.append(np.array([pos[0], pos[1], heading + dth * k / n_turn]))
        heading = target
        # walk
        n_fwd = max(1, int(round(dist / step)))
        for k in range(1, n_fwd + 1):
            p = pos + d * (k / n_fwd)
            poses.append(np.array([p[0], p[1], heading]))
        pos = wp
    return np.array(poses)


def building_tour_trajectory(step=0.4, laps=2):
    """Tour visiting all four rooms via the corridor, `laps` times; the
    corridor re-traversals create the loop-closure opportunities."""
    wp_lap = [
        (-12.0, 0.0), (-8.0, 0.0),          # corridor west
        (-8.0, 4.5), (-12.0, 4.5),          # room NW
        (-8.0, 4.5), (-8.0, 0.0),           # back to corridor
        (-4.0, 0.0), (-4.0, -4.5), (-9.0, -4.5),  # room SW
        (-4.0, -4.5), (-4.0, 0.0),
        (2.5, 0.0), (2.5, 4.5), (-1.0, 4.5),      # room N-center
        (2.5, 4.5), (2.5, 0.0),
        (9.5, 0.0), (9.5, -4.5), (12.5, -4.5),    # room SE
        (9.5, -4.5), (9.5, 0.0),
        (12.0, 0.0), (-12.0, 0.0),          # full corridor return
    ]
    waypoints = [wp_lap[0]]
    for _ in range(laps):
        waypoints.extend(wp_lap[1:])
    return _walk(waypoints, step)


def write_carmen_log(path, world, gt_poses, odom_poses, n_beams=180,
                     max_range=81.9, noise=0.01, seed=0, fmt="flaser"):
    """Write standard CARMEN laser lines and a `<path>.gt` sidecar with the
    ground-truth poses.  Returns (path, gt_path).

    fmt="flaser": classic `FLASER` lines (180 deg field of view, the SICK
    layout the format implies: the Intel/MIT logs' tag).
    fmt="robotlaser1": CARMEN v2 `ROBOTLASER1` lines in the field layout
    of real logger output (carmen readlog.c): laser params, readings,
    remissions, laser and robot poses, tv/rv/safety/turn_axis, timestamp
    hostname logger_timestamp."""
    rng = np.random.default_rng(seed)
    inc = np.pi / n_beams
    rel_angles = -np.pi / 2 + np.arange(n_beams) * inc
    lines = []
    for i, (gt, od) in enumerate(zip(gt_poses, odom_poses)):
        angles = gt[2] + rel_angles
        ranges = raycast_world(world, gt[0], gt[1], angles, max_range)
        if noise:
            ranges = ranges + rng.normal(0, noise, n_beams)
        vals = " ".join(f"{r:.3f}" for r in ranges)
        ts = 0.05 * i
        if fmt == "flaser":
            lines.append(
                f"FLASER {n_beams} {vals} "
                f"{od[0]:.6f} {od[1]:.6f} {od[2]:.6f} "
                f"{od[0]:.6f} {od[1]:.6f} {od[2]:.6f} "
                f"{ts:.6f} simbot {ts:.6f}\n"
            )
        elif fmt == "robotlaser1":
            lines.append(
                f"ROBOTLASER1 0 {-np.pi / 2:.6f} {np.pi:.6f} {inc:.6f} "
                f"{max_range:.6f} 0.010000 0 {n_beams} {vals} 0 "
                f"{od[0]:.6f} {od[1]:.6f} {od[2]:.6f} "
                f"{od[0]:.6f} {od[1]:.6f} {od[2]:.6f} "
                f"0.200000 0.050000 0.500000 0.300000 0.000000 "
                f"{ts:.6f} simbot {ts:.6f}\n"
            )
        else:
            raise ValueError(f"unknown CARMEN line format {fmt!r}")
    with open(path, "w") as ff:
        ff.writelines(lines)
    gt_path = str(path) + ".gt"
    np.savetxt(gt_path, np.asarray(gt_poses))
    return path, gt_path


def noisy_loop_pose_graph(n_nodes, seed=0, noise=0.01,
                          info_diag=(100.0, 100.0, 400.0)):
    """The SPA benchmark graph: a noisy square loop of ~`n_nodes` nodes
    with odometry-chained guesses and one exact closure edge, the same
    graph as the JAX package's for the same arguments.

    Returns (guesses, edges, info): guesses is a list of (3,) xyt
    arrays; edges is a list of ((i, j), mean(3,)); info is the 3x3
    information matrix as nested lists."""
    rng = np.random.default_rng(seed)
    side = max(n_nodes // 4, 1)
    true = [np.array([0.0, 0.0, 0.0])]
    for _ in range(4):
        for _ in range(side):
            true.append(se2_compose(true[-1], np.array([0.5, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    guesses = [true[0]]
    edges = []
    for i in range(len(true) - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, noise, 3)
        guesses.append(se2_compose(guesses[-1], mean))
        edges.append(((i, i + 1), mean))
    edges.append(((len(true) - 1, 0), se2_relative(true[0], true[-1])))
    info = np.diag(list(info_diag)).tolist()
    return guesses, edges, info


def populate_spa(spa, guesses, edges, info):
    """Load a (guesses, edges, info) graph into any SPA2d-contract
    solver; returns the solver."""
    for i, g in enumerate(guesses):
        spa.add_node(g[0], g[1], g[2], i)
    for (i, j), mean in edges:
        spa.add_constraint(i, j, mean[0], mean[1], mean[2], info)
    return spa


def generate_benchmark_log(path, step=0.4, laps=2, n_beams=180, seed=0,
                           yaw_bias=0.0015, xy_noise=0.003, yaw_noise=0.0015,
                           fmt="flaser"):
    """End to end: building world + tour + drifted odometry -> CARMEN log.
    Returns (log_path, gt_path, n_scans)."""
    world = building_world()
    gt = building_tour_trajectory(step=step, laps=laps)
    odom = drifted_odometry(gt, yaw_bias=yaw_bias, xy_noise=xy_noise,
                            yaw_noise=yaw_noise, seed=seed)
    log, gtp = write_carmen_log(path, world, gt, odom, n_beams=n_beams,
                                seed=seed, fmt=fmt)
    return log, gtp, len(gt)
