"""Pose algebra on the host: the port's own copy of
``yag_slam_tpu/core/transform.py``.

Two representations live here:

1. ``Transform`` — a quaternion-backed SE(3) pose with the public surface
   the reference gets from the external ``tiny_tf`` package (``+``/``-``
   composition, ``inverse``, ``from_pose2d`` / ``from_xyt`` /
   ``from_position_euler`` constructors, ``.euler`` / ``.quaternion``
   properties).  Checkpoints serialize it with the field order
   (x, y, z, qx, qy, qz, qw), as the JAX package and the reference do.

2. ``se2_*`` — stateless numpy functions over ``(..., 3)`` arrays
   ``[x, y, theta]``.  They take numpy arrays, numpy scalars and Python
   numbers only and raise on anything else; the device pose chain of the
   pipeline has its own tensor functions (``matching/pipeline.py``).

Composition convention (as tiny_tf):
``a + b``  = a ∘ b     (apply b in a's frame)
``a - b``  = b⁻¹ ∘ a   (a expressed in b's frame)
so that ``(a - b) + b == a``; the SLAM loop's odometry dead-reckoning
``corrected = last.corrected + (query.odom - last.odom)`` relies on it.

The algebra reads its operands only through ``x, y, z`` and
``quaternion``, so a pose object of the JAX package composes with these.
"""
from __future__ import annotations

import math
from collections import namedtuple

import numpy as np

Pose2 = namedtuple("Pose2", ["x", "y", "yaw"])


def _quat_multiply(q1, q2):
    """Hamilton product of quaternions given as (x, y, z, w) tuples."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


def _quat_conjugate(q):
    x, y, z, w = q
    return (-x, -y, -z, w)


def _quat_rotate(q, v):
    """Rotate vector v (3-tuple) by quaternion q (x, y, z, w)."""
    qv = (v[0], v[1], v[2], 0.0)
    rx, ry, rz, _ = _quat_multiply(_quat_multiply(q, qv), _quat_conjugate(q))
    return (rx, ry, rz)


def quaternion_from_euler(roll, pitch, yaw):
    """ZYX-convention (yaw about z, then pitch about y, then roll about x)."""
    cr, sr = math.cos(roll / 2.0), math.sin(roll / 2.0)
    cp, sp = math.cos(pitch / 2.0), math.sin(pitch / 2.0)
    cy, sy = math.cos(yaw / 2.0), math.sin(yaw / 2.0)
    return (
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    )


def euler_from_quaternion(q):
    """Inverse of :func:`quaternion_from_euler`; returns (roll, pitch, yaw)."""
    x, y, z, w = q
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = math.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (w * y - z * x)
    sinp = max(-1.0, min(1.0, sinp))
    pitch = math.asin(sinp)

    return (roll, pitch, _yaw(x, y, z, w))


def _yaw(x, y, z, w):
    """The yaw of :func:`euler_from_quaternion` alone."""
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    return math.atan2(siny_cosp, cosy_cosp)


class Transform:
    """Quaternion-backed SE(3) pose, API-compatible with the reference's
    pose type (``tiny_tf.tf.Transform``)."""

    __slots__ = ("x", "y", "z", "qx", "qy", "qz", "qw")

    def __init__(self, x=0.0, y=0.0, z=0.0, qx=0.0, qy=0.0, qz=0.0, qw=1.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)
        self.qx = float(qx)
        self.qy = float(qy)
        self.qz = float(qz)
        self.qw = float(qw)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_position_euler(cls, x, y, z, roll, pitch, yaw):
        qx, qy, qz, qw = quaternion_from_euler(roll, pitch, yaw)
        return cls(x, y, z, qx, qy, qz, qw)

    @classmethod
    def from_pose2d(cls, pose):
        """From anything with .x/.y/.yaw (the reference's Pose2 value type)."""
        return cls.from_position_euler(pose.x, pose.y, 0.0, 0.0, 0.0, pose.yaw)

    @classmethod
    def from_xyt(cls, x, y, t):
        return cls.from_position_euler(x, y, 0.0, 0.0, 0.0, t)

    @classmethod
    def from_xyt_deg(cls, x, y, t_deg):
        return cls.from_xyt(x, y, math.radians(t_deg))

    @classmethod
    def from_xytheta(cls, xyt):
        """From a length-3 array-like [x, y, theta]."""
        x, y, t = (float(v) for v in np.asarray(xyt).reshape(3))
        return cls.from_xyt(x, y, t)

    # -- properties --------------------------------------------------------
    @property
    def quaternion(self):
        return (self.qx, self.qy, self.qz, self.qw)

    @property
    def position(self):
        return (self.x, self.y, self.z)

    @property
    def euler(self):
        return euler_from_quaternion(self.quaternion)

    @property
    def yaw(self):
        """``euler[2]``, without the roll and pitch."""
        return _yaw(self.qx, self.qy, self.qz, self.qw)

    @property
    def xytheta(self):
        """Planar [x, y, yaw] as a float64 numpy array."""
        return np.array([self.x, self.y, self.euler[2]], dtype=np.float64)

    # -- algebra -----------------------------------------------------------
    def __add__(self, other):
        """self ∘ other."""
        tx, ty, tz = _quat_rotate(self.quaternion, (other.x, other.y, other.z))
        qx, qy, qz, qw = _quat_multiply(self.quaternion, other.quaternion)
        return Transform(self.x + tx, self.y + ty, self.z + tz, qx, qy, qz, qw)

    def __sub__(self, other):
        """self expressed in other's frame: other⁻¹ ∘ self, so that
        ``b + (a - b) == a``."""
        return other.inverse() + self

    def inverse(self):
        """A method (not a property), as the reference's pose type has it."""
        qinv = _quat_conjugate(self.quaternion)
        tx, ty, tz = _quat_rotate(qinv, (-self.x, -self.y, -self.z))
        return Transform(tx, ty, tz, *qinv)

    # -- misc --------------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, Transform):
            return NotImplemented
        return self.position == other.position and self.quaternion == other.quaternion

    def __repr__(self):
        r, p, yw = self.euler
        return (
            f"Transform(x={self.x:.4f}, y={self.y:.4f}, z={self.z:.4f}, "
            f"rpy=({r:.4f}, {p:.4f}, {yw:.4f}))"
        )


# ---------------------------------------------------------------------------
# SE(2) array ops on the host: (..., 3) float arrays [x, y, theta]
# ---------------------------------------------------------------------------

def _np_like(x):
    """numpy for host values (arrays, numpy scalars, Python numbers);
    anything else is refused, so a tensor never reaches these helpers."""
    if isinstance(x, (np.ndarray, np.generic, float, int)):
        return np
    raise TypeError(f"se2 helpers take numpy arrays or numbers, got {type(x).__name__}")


def se2_wrap(theta):
    """Wrap angles to (-pi, pi]."""
    xp = _np_like(theta)
    return theta - 2.0 * xp.pi * xp.floor((theta + xp.pi) / (2.0 * xp.pi))


def se2_compose(a, b):
    """a ∘ b for (..., 3) pose arrays."""
    xp = _np_like(a)
    _np_like(b)
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bt = b[..., 0], b[..., 1], b[..., 2]
    c, s = xp.cos(at), xp.sin(at)
    return xp.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, se2_wrap(at + bt)], axis=-1
    )


def se2_inverse(a):
    xp = _np_like(a)
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    c, s = xp.cos(at), xp.sin(at)
    return xp.stack(
        [-(c * ax + s * ay), -(-s * ax + c * ay), se2_wrap(-at)], axis=-1
    )


def se2_relative(a, b):
    """b⁻¹ ∘ a — `a` expressed in `b`'s frame (matches Transform.__sub__)."""
    return se2_compose(se2_inverse(b), a)


def se2_apply(pose, pts_x, pts_y):
    """Transform local points into the pose's frame."""
    xp = _np_like(pts_x)
    _np_like(pose)
    x, y, t = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = xp.cos(t), xp.sin(t)
    return x + c * pts_x - s * pts_y, y + s * pts_x + c * pts_y
