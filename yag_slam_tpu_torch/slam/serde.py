"""Portable serialization: ``___name``-tagged dicts -> msgpack -> zlib.

The same wire format as ``yag_slam_tpu/slam/serde.py`` (type tags, field
orders, numpy arrays as lists), so checkpoints written by either package
load in the other.  ``LinkLabel`` is the port's own class.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from yag_slam_tpu.core.config import (
    REFERENCE_CONFIG_KEYS,
    ScanMatcherConfig,
    make_config,
)
from yag_slam_tpu.core.scan import LaserScanConfig, LocalizedRangeScan
from yag_slam_tpu.core.transform import Pose2, Transform
from yag_slam_tpu_torch.graphopt.graph import LinkLabel

SerdeConfig = namedtuple("SerdeConfig", ["cls", "variables", "factory"])
NAME = "___name"


def _serialize(obj):
    n = obj.__class__.__name__
    if n in _configs:
        d = {v: _serialize(getattr(obj, v)) for v in _configs[n].variables}
        if n == "ScanMatcherConfig":
            # extension fields enter the checkpoint only when non-default,
            # keeping the reference's 11-key layout otherwise
            defaults = ScanMatcherConfig()
            for f in sorted(obj.__dataclass_fields__):
                if f not in REFERENCE_CONFIG_KEYS and (
                    getattr(obj, f) != getattr(defaults, f)
                ):
                    d[f] = _serialize(getattr(obj, f))
        d[NAME] = n
        return d
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    return obj


def _deserialize(d):
    if isinstance(d, dict) and NAME in d:
        cfg = _configs[d[NAME]]
        if cfg.factory:
            return cfg.factory({k: v for k, v in d.items() if k != NAME})
        return cfg.cls(*[_deserialize(d[v]) for v in cfg.variables])
    return d


_configs = {
    "LocalizedRangeScan": SerdeConfig(
        LocalizedRangeScan,
        ["ranges", "min_angle", "max_angle", "angle_increment", "min_range",
         "max_range", "range_threshold", "odom_pose", "corrected_pose", "num"],
        LocalizedRangeScan.deserialize,
    ),
    "Pose2": SerdeConfig(Pose2, ["x", "y", "yaw"], None),
    "LaserScanConfig": SerdeConfig(
        LaserScanConfig,
        ["min_angle", "max_angle", "angular_resolution", "min_range",
         "max_range", "range_threshold", "sensor_name"],
        None,
    ),
    # field order is the reference's dir()-alphabetical 11 keys
    "ScanMatcherConfig": SerdeConfig(
        ScanMatcherConfig, list(REFERENCE_CONFIG_KEYS), make_config,
    ),
    # the reference's C++ matcher shell serializes as {config: ...}
    "Wrapper": SerdeConfig(dict, ["config"], None),
    "LinkLabel": SerdeConfig(LinkLabel, ["mean", "covariance"], None),
    "Transform": SerdeConfig(
        Transform, ["x", "y", "z", "qx", "qy", "qz", "qw"], None
    ),
}
