"""Scan model: the port's own copy of ``yag_slam_tpu/core/scan.py``.

`LocalizedRangeScan` is a single array-backed object: ranges + beam
geometry + two planar poses (odometric and corrected).  The matcher's
device view is produced on demand as padded arrays.

Projection semantics follow the reference: a beam is kept iff its range is
not NaN and not greater than `range_threshold` (zeros and negatives are
kept), and the beam angle is ``pose_theta + min_angle + i *
angle_increment`` (``max_angle`` is unused by the projection, a reference
quirk kept as it is).  The padded view is compacted by the native host
op (``native.compact_beams``; the matcher makes the views of a batch's
new scans with ``native.scan_views``, the same arithmetic over a stack of
scans); :func:`beam_points_padded_ref` is its numpy twin, for the tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from yag_slam_tpu_torch import native
from yag_slam_tpu_torch.core.transform import Transform


@dataclass(frozen=True)
class LaserScanConfig:
    """Beam geometry value type (the reference's serde surface)."""

    min_angle: float
    max_angle: float
    angular_resolution: float
    min_range: float
    max_range: float
    range_threshold: float
    sensor_name: str = ""


def project_beams(ranges, x, y, theta, min_angle, angle_increment, range_threshold):
    """Vectorized beam projection with the reference's keep rule.

    Returns (xs, ys) of the kept beams, as float64 numpy arrays.
    """
    r = np.asarray(ranges, dtype=np.float64)
    idx = np.arange(len(r))
    keep = ~(np.isnan(r) | (r > range_threshold))
    r = r[keep]
    angles = theta + min_angle + idx[keep] * angle_increment
    return x + r * np.cos(angles), y + r * np.sin(angles)


def beam_points_padded(ranges, min_angle, angle_increment, range_threshold, cap):
    """Local-frame beam endpoints, compacted then padded to `cap` lanes.

    Kept beams are packed contiguously at the front (the order of the
    reference's filtered point lists, so the sequential validation-run
    segmentation sees the same sequence), followed by zeroed padding.

    Returns (xs, ys, n_valid) with float64 arrays of shape (cap,); raises
    ValueError when more than `cap` beams are kept.  Runs the native host
    op, which raises if its library cannot be built.
    """
    return native.compact_beams(ranges, min_angle, angle_increment, range_threshold, cap)


def beam_points_padded_ref(ranges, min_angle, angle_increment, range_threshold, cap):
    """The numpy twin of :func:`beam_points_padded` (the JAX package's path
    without its extension), for the tests."""
    r = np.asarray(ranges, dtype=np.float64)
    keep = ~(np.isnan(r) | (r > range_threshold))
    idx = np.nonzero(keep)[0]
    n = len(idx)
    if n > cap:
        raise ValueError(f"scan has {n} valid beams > point capacity {cap}")
    xs = np.zeros(cap, dtype=np.float64)
    ys = np.zeros(cap, dtype=np.float64)
    rr = r[idx]
    angles = min_angle + idx * angle_increment
    xs[:n] = rr * np.cos(angles)
    ys[:n] = rr * np.sin(angles)
    return xs, ys, n


class LocalizedRangeScan:
    """A 2D lidar scan with dual pose state (odometric + corrected).

    Constructor signature, properties and (de)serialization layout match
    the reference model, so saved graphs are interchangeable with the JAX
    package's and the reference's.
    """

    def __init__(
        self,
        ranges,
        min_angle,
        max_angle,
        angle_increment,
        min_range,
        max_range,
        range_threshold,
        x,
        y,
        t,
    ):
        self.ranges = np.array(ranges, dtype=np.float64).copy()
        self.min_angle = float(min_angle)
        self.max_angle = float(max_angle)
        self.angle_increment = float(angle_increment)
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.range_threshold = float(range_threshold)

        self._odom_pose = Transform.from_xyt(x, y, t)
        self._corrected_pose = Transform.from_xyt(x, y, t)
        self._id = 0
        self._points_cache = {}

    # -- identity ----------------------------------------------------------
    @property
    def num(self):
        return self._id

    @num.setter
    def num(self, val):
        self._id = int(val)

    # -- poses -------------------------------------------------------------
    @property
    def odom_pose(self) -> Transform:
        return self._odom_pose

    @odom_pose.setter
    def odom_pose(self, val: Transform):
        self._odom_pose = val

    @property
    def corrected_pose(self) -> Transform:
        return self._corrected_pose

    @corrected_pose.setter
    def corrected_pose(self, val: Transform):
        # the points cache holds only pose-independent (local-frame) views,
        # so pose updates never invalidate it
        self._corrected_pose = val

    # -- projection --------------------------------------------------------
    def points(self, odom=False):
        """World-frame beam endpoints under the corrected (or odom) pose."""
        p = self.odom_pose if odom else self.corrected_pose
        return self.points_for_pose2d(p.x, p.y, p.euler[-1])

    def points_local(self):
        key = "local"
        if key not in self._points_cache:
            self._points_cache[key] = self.points_for_pose2d(0.0, 0.0, 0.0)
        return self._points_cache[key]

    def points_for_pose2d(self, x, y, t):
        return project_beams(
            self.ranges, x, y, t, self.min_angle, self.angle_increment,
            self.range_threshold,
        )

    def local_points_padded(self, cap):
        """Compacted+padded local-frame endpoints for the device kernels
        (cached; pose-independent)."""
        key = ("padded", cap)
        if key not in self._points_cache:
            self._points_cache[key] = beam_points_padded(
                self.ranges, self.min_angle, self.angle_increment,
                self.range_threshold, cap,
            )
        return self._points_cache[key]

    @property
    def num_valid_beams(self):
        # cached beside the views, which also take the ranges as fixed
        n = self._points_cache.get("num_valid_beams")
        if n is None:
            r = self.ranges
            n = int(np.count_nonzero(~(np.isnan(r) | (r > self.range_threshold))))
            self._points_cache["num_valid_beams"] = n
        return n

    # -- lifecycle ---------------------------------------------------------
    def copy(self):
        """Reference semantics: the copy's odom pose collapses onto the
        corrected pose (the temp scan of loop closure).

        The copy *shares* the (pose-independent) points cache, so the
        matcher's views, and the copy's device-library slot, alias the
        original's instead of being recomputed and uploaded again.
        """
        p = self.corrected_pose
        out = LocalizedRangeScan(
            self.ranges.copy(), self.min_angle, self.max_angle,
            self.angle_increment, self.min_range, self.max_range,
            self.range_threshold, p.x, p.y, p.euler[-1],
        )
        out._points_cache = self._points_cache
        return out

    # -- serde -------------------------------------------------------------
    @classmethod
    def deserialize(cls, args):
        return cls._deserialize(**args)

    @classmethod
    def _deserialize(
        cls, ranges, min_angle, max_angle, angle_increment, min_range,
        max_range, range_threshold, odom_pose, corrected_pose, num,
    ):
        out = cls(
            ranges, min_angle, max_angle, angle_increment, min_range,
            max_range, range_threshold, 0.0, 0.0, 0.0,
        )
        odom_pose = {k: v for k, v in odom_pose.items() if k != "___name"}
        corrected_pose = {k: v for k, v in corrected_pose.items() if k != "___name"}
        out.odom_pose = Transform(**odom_pose)
        out.corrected_pose = Transform(**corrected_pose)
        out.num = num
        return out

    @classmethod
    def from_json(cls, d, x, y, t, invert=True):
        """Build from a ROS-LaserScan-style dict."""
        ranges = d["ranges"]
        if invert:
            ranges = ranges[::-1]
        return cls(
            ranges, d["angle_min"], d["angle_max"], d["angle_increment"],
            d["range_min"], d["range_max"], d["range_max"] * 0.9, x, y, t,
        )

    def __repr__(self):
        p = self.corrected_pose
        return (
            f"LocalizedRangeScan(num={self.num}, beams={len(self.ranges)}, "
            f"pose=({p.x:.3f}, {p.y:.3f}, {p.euler[-1]:.3f}))"
        )
