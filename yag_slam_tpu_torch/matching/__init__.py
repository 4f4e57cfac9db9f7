from yag_slam_tpu_torch.matching.matcher import (
    CorrelativeScanMatcher,
    Scan2DMatcher,
    ScanMatcherResult,
)
from yag_slam_tpu_torch.matching.refmatcher import RefBaselineScanMatcher

# Drop-in aliases for the reference's two matcher classes (yag_slam's
# scan_matching.Scan2DMatcherCpp and Scan2DMatcherPy): both map onto the
# one implementation here.
Scan2DMatcherCpp = CorrelativeScanMatcher
Scan2DMatcherPy = CorrelativeScanMatcher

__all__ = [
    "CorrelativeScanMatcher",
    "RefBaselineScanMatcher",
    "Scan2DMatcher",
    "Scan2DMatcherCpp",
    "Scan2DMatcherPy",
    "ScanMatcherResult",
]
