from yag_slam_tpu_torch.slam.graph_slam import GraphSlam, make_near_scan_visitor
from yag_slam_tpu_torch.slam.serde import _deserialize, _serialize

__all__ = ["GraphSlam", "make_near_scan_visitor", "_serialize", "_deserialize"]
