"""Reference-equivalent matcher behind the standard matcher contract.

Counterpart of ``yag_slam_tpu/matching/refmatcher.py``.  Wraps
``native.refbaseline_match_scan`` (native/refbaseline.cpp: the reference
algorithm as multithreaded C++, held to the float64 oracle at 1e-12) in a
class with the surface GraphSlam consumes from any matcher (`match_scan`,
`match_many`, `.config`): dropping it in for `CorrelativeScanMatcher`
drives the whole reference pipeline and gives a reference *trajectory*,
the A side of apps/ab_compare.py.
"""
from __future__ import annotations

import numpy as np
import torch

from yag_slam_tpu_torch import _build, native
from yag_slam_tpu_torch.core.config import ScanMatcherConfig, make_config
from yag_slam_tpu_torch.core.transform import Transform
from yag_slam_tpu_torch.matching.matcher import (
    _EXPANSION_STEP,
    _EXPANSION_TRIES,
    ScanMatcherResult,
    sanitize_covariance,
)


class RefBaselineScanMatcher:
    """The reference scan matcher (C++ reimplementation) behind the
    matcher contract.

    It runs on the host CPU by its nature and takes no `device`: it is the
    reference the card is measured against.  `device` reads cpu, so a
    GraphSlam built on it keeps its optimizer and maps on the host.

    Semantics notes:
    - coarse + fine run inside one native call; response expansion
      therefore triggers on the *returned* response (the fine response
      when `do_fine`) rather than on the internal coarse response the
      device matcher can observe.  In the reference pipeline expansion
      only matters on the loop coarse match (do_fine=False), where the two
      triggers are identical.
    - covariance sanitation matches CorrelativeScanMatcher's (the
      unclamped-penalty quirk can make the reference's window moments
      indefinite; one indefinite information matrix corrupts the SPA
      solve) so an A/B comparison isolates the matcher, not the guard.
    """

    device = torch.device("cpu")

    def __init__(self, config_dict=None, loop: bool = False, *,
                 config: ScanMatcherConfig | None = None,
                 sanitize: bool = True, n_threads: int | None = None):
        _build.native_library()     # builds at first use; raises if it cannot
        self.config = config if config is not None else make_config(
            config_dict, loop
        )
        self.sanitize = sanitize
        self.n_threads = n_threads

    def _cfg_dict(self, coarse_offset=None):
        cfg = self.config
        return {
            "search_size": cfg.search_size,
            "resolution": cfg.resolution,
            "smear_deviation": cfg.smear_deviation,
            "range_threshold": cfg.range_threshold,
            "coarse_search_angle_offset": (
                cfg.coarse_search_angle_offset
                if coarse_offset is None
                else coarse_offset
            ),
            "coarse_angle_resolution": cfg.coarse_angle_resolution,
        }

    def match_scan(self, query, base_scans, penalty=True, do_fine=True):
        if not base_scans:
            raise ValueError("match_scan needs at least one base scan")
        r, covar, (x, y, t) = native.refbaseline_match_scan(
            query, base_scans, self._cfg_dict(), penalty, do_fine,
            self.n_threads,
        )
        if r <= 0.0 and self.config.use_response_expansion:
            # the device matcher's widening schedule (20 deg per retry, 3
            # retries, after OpenKarto's response expansion)
            for attempt in range(_EXPANSION_TRIES):
                off = (
                    self.config.coarse_search_angle_offset
                    + (attempt + 1) * _EXPANSION_STEP
                )
                r, covar, (x, y, t) = native.refbaseline_match_scan(
                    query, base_scans, self._cfg_dict(off), penalty,
                    do_fine, self.n_threads,
                )
                if r > 0.0:
                    break
        covar = np.asarray(covar)
        if self.sanitize:
            covar = sanitize_covariance(covar, self.config)
        return ScanMatcherResult(
            float(r), covar,
            Transform.from_position_euler(x, y, 0, 0, 0, t), None,
        )

    def match_many(self, jobs, penalty=True, do_fine=True):
        return [self.match_scan(q, bs, penalty, do_fine) for q, bs in jobs]
