"""Sharded loop-closure candidate matching on ``torch.distributed``.

Counterpart of ``yag_slam_tpu/parallel/loop_search.py``.  Loop closure fans
the query scan out against many candidate chains; each (query, chain) job
is independent, so the batch shards over a data-parallel mesh axis.  The
run is SPMD: every rank calls ``match_many`` with the same jobs, fills its
own replicated scan library (the "weights" of this workload) through the
job assembly of *all* jobs, scores its contiguous slice of the jobs, and
all-gathers the (tiny) packed results.  The reduction back to "which chain
closed" is host logic, as in the reference's first-accept walk.
"""
from __future__ import annotations

import torch.distributed as dist

from yag_slam_tpu_torch.parallel.sharding import _mesh_axis

# torch 2.13 deprecates all_gather_into_tensor for all_gather_single; both
# gather equal-sized tensors along dim 0
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class ShardedLoopMatcher:
    """Wraps a CorrelativeScanMatcher to run `match_many` sharded over a
    mesh axis.

    Drop-in as GraphSlam's `loop_matcher`: single-chain matches and the
    config delegate to the wrapped matcher, so
    ``GraphSlam(seq, ShardedLoopMatcher(loop, mesh))`` fans loop-closure
    candidates across the mesh with no orchestrator changes.  The mesh's
    device type must be the matcher's: nothing is moved between devices.
    """

    def __init__(self, matcher, mesh, axis="dp"):
        if mesh.device_type != matcher.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot shard a matcher on "
                             f"{matcher.device}")
        self.matcher = matcher
        self.mesh = mesh
        self.axis = axis
        self._group, self._size, self._rank = _mesh_axis(mesh, axis)

    @property
    def config(self):
        return self.matcher.config

    def match_scan(self, query, base_scans, penalty=True, do_fine=True):
        return self.matcher.match_scan(query, base_scans, penalty, do_fine)

    def match_many(self, jobs, penalty=False, do_fine=False):
        """Same contract as CorrelativeScanMatcher.match_many, sharded over
        the mesh (jobs padded to a multiple of the axis size).  Every rank
        must call it with the same jobs.  As in the JAX package, no
        response-expansion retries run on this path."""
        if not jobs:
            return []
        m = self.matcher
        N = len(jobs)
        n_local = -(-N // self._size)
        args, P, S = m._prepare(jobs, n_pad=n_local * self._size)
        lo = self._rank * n_local
        local = tuple(a[lo:lo + n_local] for a in args)
        core = m.batched_core(P, args[0].shape[1], bool(penalty), bool(do_fine), S)
        packed_local = core(*local).contiguous()      # (n_local, 2, 8)
        packed = packed_local.new_empty((n_local * self._size, *packed_local.shape[1:]))
        _all_gather(packed, packed_local, group=self._group)
        packed = packed.cpu().numpy()
        coarse, fine = packed[:, 0], packed[:, 1]
        return [m._assemble(coarse[j], fine[j], do_fine) for j in range(N)]
