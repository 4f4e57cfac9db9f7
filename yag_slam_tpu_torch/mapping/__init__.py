from yag_slam_tpu_torch.mapping.occupancy import (
    GRID_FREE,
    GRID_OCCUPIED,
    GRID_UNKNOWN,
    OccupancyGrid,
    create_occupancy_grid,
    occupancy_grid_map_to_correlation_grid,
)
from yag_slam_tpu_torch.mapping.raytrace import run_raytracing_sweep, trace_rays

__all__ = [
    "OccupancyGrid",
    "create_occupancy_grid",
    "occupancy_grid_map_to_correlation_grid",
    "run_raytracing_sweep",
    "trace_rays",
    "GRID_OCCUPIED",
    "GRID_UNKNOWN",
    "GRID_FREE",
]
