from yag_slam_tpu_torch.mapping.occupancy import (
    GRID_FREE,
    GRID_OCCUPIED,
    GRID_UNKNOWN,
    OccupancyGrid,
    create_occupancy_grid,
)

__all__ = [
    "OccupancyGrid",
    "create_occupancy_grid",
    "GRID_OCCUPIED",
    "GRID_UNKNOWN",
    "GRID_FREE",
]
