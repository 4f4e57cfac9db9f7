from yag_slam_tpu_torch.splicing.segmentation import open_free_space, spatial_segments
from yag_slam_tpu_torch.splicing.splice import (
    create_edges,
    determine_centroids,
    map_to_graph,
    map_to_graphslam,
    pixel_to_meters,
    segment_map,
)

__all__ = [
    "create_edges",
    "determine_centroids",
    "map_to_graph",
    "map_to_graphslam",
    "open_free_space",
    "pixel_to_meters",
    "segment_map",
    "spatial_segments",
]
