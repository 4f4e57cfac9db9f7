"""Matcher configuration: the port's own copy of
``yag_slam_tpu/core/config.py``.

A plain frozen dataclass with the reference's 11 keys and defaults, so it
serializes into checkpoints exactly like the reference's and the JAX
package's (``slam/serde.py`` registers the type with its public fields).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ScanMatcherConfig:
    """The reference's `default_config` keys and defaults.

    `angle_variance_penalty`, `distance_variance_penalty` and
    `minimum_angle_penalty` are carried for config, serde and checkpoint
    parity but by default are NOT consumed by the scoring: the reference's
    Python matcher hardcodes dist_var=0.5, ang_var=1.0 and leaves the
    minimum-penalty clamps out, and the JAX package and the port follow it.

    `use_karto_penalties=True` opts into OpenKarto's C++ matcher semantics
    instead: penalties max(1 - 0.2*offset^2/variance, minimum) with the
    offsets measured from the search center and the variance keys used
    directly.  `minimum_distance_penalty` (Karto default 0.5) completes
    that key set; it and the switch are extensions, written into
    checkpoints only when not default (the wire format stays the
    reference's otherwise)."""

    angle_variance_penalty: float = 0.3
    distance_variance_penalty: float = 0.5
    coarse_search_angle_offset: float = 0.349
    coarse_angle_resolution: float = 0.0349
    fine_search_angle_resolution: float = 0.00349
    use_response_expansion: bool = True
    range_threshold: float = 20.0
    minimum_angle_penalty: float = 0.9
    search_size: float = 0.5
    resolution: float = 0.01
    smear_deviation: float = 0.05
    # -- extensions beyond the reference's 11 keys (see docstring) --
    use_karto_penalties: bool = False
    minimum_distance_penalty: float = 0.5

    def karto_penalty_tuple(self):
        """(dist_var, ang_var, min_dist, min_ang) for the scoring when
        `use_karto_penalties`, else None."""
        if not self.use_karto_penalties:
            return None
        return (
            float(self.distance_variance_penalty),
            float(self.angle_variance_penalty),
            float(self.minimum_distance_penalty),
            float(self.minimum_angle_penalty),
        )

    def replace(self, **kw) -> "ScanMatcherConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def validate(self) -> "ScanMatcherConfig":
        lo, hi = 0.5 * self.resolution, 10.0 * self.resolution
        if not (lo <= self.smear_deviation <= hi):
            # the reference's constraint
            raise ValueError(
                f"Smear deviation must be between {lo} and {hi}, "
                f"got {self.smear_deviation}"
            )
        return self


# The reference's 11 config keys in its serde order (alphabetical): the
# checkpoint wire format.  Extension fields are written only when not
# default.
REFERENCE_CONFIG_KEYS = tuple(sorted([
    "angle_variance_penalty", "distance_variance_penalty",
    "coarse_search_angle_offset", "coarse_angle_resolution",
    "fine_search_angle_resolution", "use_response_expansion",
    "range_threshold", "minimum_angle_penalty", "search_size",
    "resolution", "smear_deviation",
]))

# the reference's default sequential config
default_config = ScanMatcherConfig().to_dict()

# the reference's loop-closure overrides
default_config_loop = dict(
    default_config,
    coarse_search_angle_offset=0.349,
    coarse_angle_resolution=0.0349,
    resolution=0.05,
    search_size=4.0,
    smear_deviation=0.05,
)


def make_config(d: dict | None = None, loop: bool = False) -> ScanMatcherConfig:
    """Overlay a user dict on the defaults and validate, as the
    reference's make_config does."""
    params = dict(default_config_loop if loop else default_config)
    if d:
        params.update({k: v for k, v in d.items() if k != "___name"})
    return ScanMatcherConfig(**params).validate()


def print_config(config) -> None:
    for field in dataclasses.fields(config):
        print(f"{field.name}: {getattr(config, field.name)}")
