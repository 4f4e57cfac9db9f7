from yag_slam_tpu_torch.graphopt.graph import (
    Edge,
    Graph,
    LinkLabel,
    RadiusHashSearch,
    Vertex,
    do_breadth_first_traversal,
)
from yag_slam_tpu_torch.graphopt.spa import PoseGraphSolver, SPA2d

__all__ = [
    "Edge",
    "Graph",
    "LinkLabel",
    "RadiusHashSearch",
    "Vertex",
    "do_breadth_first_traversal",
    "SPA2d",
    "PoseGraphSolver",
]
