"""The multi-device paths on ``torch.distributed``: the mesh
(``sharding``), sharded loop-closure matching (``loop_search``) and the
edge-sharded SPA solve (``dist_spa``)."""
from yag_slam_tpu_torch.parallel.dist_spa import DistributedSPA
from yag_slam_tpu_torch.parallel.loop_search import ShardedLoopMatcher
from yag_slam_tpu_torch.parallel.sharding import default_mesh

__all__ = ["default_mesh", "ShardedLoopMatcher", "DistributedSPA"]
