from yag_slam_tpu_torch.slam.graph_slam import GraphSlam, make_near_scan_visitor

__all__ = ["GraphSlam", "make_near_scan_visitor"]
