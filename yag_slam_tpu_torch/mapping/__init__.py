from yag_slam_tpu_torch.mapping.occupancy import (
    GRID_FREE,
    GRID_OCCUPIED,
    GRID_UNKNOWN,
    OccupancyGrid,
    create_occupancy_grid,
    occupancy_grid_map_to_correlation_grid,
)

__all__ = [
    "OccupancyGrid",
    "create_occupancy_grid",
    "occupancy_grid_map_to_correlation_grid",
    "GRID_OCCUPIED",
    "GRID_UNKNOWN",
    "GRID_FREE",
]
