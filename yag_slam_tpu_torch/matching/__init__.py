from yag_slam_tpu_torch.matching.matcher import (
    CorrelativeScanMatcher,
    ScanMatcherResult,
)

__all__ = ["CorrelativeScanMatcher", "ScanMatcherResult"]
