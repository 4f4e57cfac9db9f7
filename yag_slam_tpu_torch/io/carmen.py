"""CARMEN log-format loader (Intel Research Lab, MIT, ... sequences): the
port's own copy of ``yag_slam_tpu/io/carmen.py``, for classic `FLASER`
lines and newer `ROBOTLASER1` lines.  Logs are read by the native host op
(``native.parse_carmen``); the pure-Python parser stays as
:func:`load_carmen_log_ref` and :func:`parse_carmen_line`, for the tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from yag_slam_tpu_torch import native


@dataclass
class CarmenScan:
    ranges: list
    min_angle: float
    max_angle: float
    angle_increment: float
    max_range: float
    odom_x: float
    odom_y: float
    odom_theta: float
    timestamp: float


def parse_carmen_line(line):
    """Parse one CARMEN log line; returns a CarmenScan or None."""
    parts = line.split()
    if not parts:
        return None
    tag = parts[0]
    if tag == "FLASER":
        # FLASER num r_1..r_n x y theta odom_x odom_y odom_theta ts host log_ts
        n = int(parts[1])
        ranges = [float(v) for v in parts[2 : 2 + n]]
        x, y, th = (float(v) for v in parts[2 + n : 5 + n])
        ts = float(parts[8 + n]) if len(parts) > 8 + n else 0.0
        fov = math.pi
        inc = fov / n
        return CarmenScan(
            ranges, -fov / 2.0, fov / 2.0 - inc, inc, 81.9, x, y, th, ts
        )
    if tag == "ROBOTLASER1":
        # CARMEN v2 layout (carmen readlog.c, CARMEN_ROBOT_LASER_...):
        # ROBOTLASER1 laser_type start_angle field_of_view angular_res
        #   maximum_range accuracy remission_mode
        #   num_readings r_1..r_n num_remissions rem_1..rem_m
        #   laser_x laser_y laser_theta robot_x robot_y robot_theta
        #   laser_tv laser_rv forward_safety_dist side_safety_dist
        #   turn_axis timestamp hostname logger_timestamp
        start = float(parts[2])
        fov = float(parts[3])
        inc = float(parts[4])
        max_range = float(parts[5])
        n = int(parts[8])
        ranges = [float(v) for v in parts[9 : 9 + n]]
        i = 9 + n
        n_rem = int(parts[i])
        i += 1 + n_rem
        lx, ly, lth = (float(v) for v in parts[i : i + 3])
        # i+3..i+5 robot pose; i+6..i+10 tv/rv/safety/turn_axis
        ts = float(parts[i + 11]) if len(parts) > i + 11 else 0.0
        return CarmenScan(
            ranges, start, start + fov - inc, inc, max_range, lx, ly, lth, ts
        )
    return None


def load_carmen_log(path, max_scans=None):
    """Load the laser scans of a CARMEN log file (float64 ranges), at most
    `max_scans` of them when it is given and not 0.  Lines that do not
    parse are skipped, as the JAX package's native parser skips them.
    Runs the native host op, which raises if its library cannot be
    built."""
    return native.parse_carmen(path, max_scans)


def load_carmen_log_ref(path, max_scans=None):
    """The pure-Python twin of :func:`load_carmen_log` (the JAX package's
    path without its extension: list ranges, and a line that does not
    parse raises), for the tests."""
    scans = []
    with open(path) as ff:
        for line in ff:
            s = parse_carmen_line(line)
            if s is not None:
                scans.append(s)
                if max_scans and len(scans) >= max_scans:
                    break
    return scans


def carmen_to_localized_scans(carmen_scans, range_threshold=20.0):
    """CARMEN scans -> LocalizedRangeScan stream (odometry poses)."""
    from yag_slam_tpu_torch.core.scan import LocalizedRangeScan

    return [
        LocalizedRangeScan(
            cs.ranges, cs.min_angle, cs.max_angle, cs.angle_increment,
            0.0, cs.max_range, range_threshold,
            cs.odom_x, cs.odom_y, cs.odom_theta,
        )
        for cs in carmen_scans
    ]
