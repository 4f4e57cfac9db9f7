from yag_slam_tpu_torch.matching.matcher import (
    CorrelativeScanMatcher,
    Scan2DMatcher,
    ScanMatcherResult,
)

__all__ = ["CorrelativeScanMatcher", "Scan2DMatcher", "ScanMatcherResult"]
