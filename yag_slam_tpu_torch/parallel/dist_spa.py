"""Distributed sparse pose adjustment on ``torch.distributed``.

Counterpart of ``yag_slam_tpu/parallel/dist_spa.py``.  The global SPA
normal equations are a sum of independent per-edge contributions:
H = Σ_e J_e^T Ω_e J_e, b = Σ_e J_e^T Ω_e r_e.  Sharding the edge list over
a mesh axis (each rank a contiguous slice, poses replicated) makes every
reduction an all-reduce:

- **"cg" (default)**: matrix-free block-Jacobi-preconditioned CG, the
  port's ``graphopt.spa.lm_run_cg`` with ``reduce`` an all-reduce SUM: per
  LM iteration the rhs, the block-diagonal preconditioner and every CG
  Hessian-vector product are assembled from the local edge shard and
  summed over the mesh.  Per-rank memory is O(E/n + N·3); no (3N, 3N)
  object exists.
- **"dense"**: all-reduce the dense (3N, 3N) normal equations once per LM
  iteration and solve replicated.  Small graphs and cross-checks only:
  per-rank memory is O(N²).

The LM and CG loops branch on the host (one read of the stop flag per LM
iteration, one per CG chunk).  Every flag is computed from all-reduced or
replicated values, so all ranks take the same branches and the
collectives stay matched.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from yag_slam_tpu_torch._device import resolve_device
from yag_slam_tpu_torch.graphopt.spa import (
    PoseGraphSolver,
    _cap,
    _masked_cost,
    _NodeView,
    _read,
    _wrap,
    build_normal_equations,
    lm_run_cg,
)
from yag_slam_tpu_torch.parallel.sharding import _mesh_axis


def _all_reduce_sum(group):
    """The `reduce` of the SPA loops: the sum over `group` of each rank's
    partial, on a contiguous copy the collective may overwrite."""
    def reduce(x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    return reduce


def _mesh_device(mesh):
    dev = resolve_device(mesh.device_type)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev


def _edge_program(mesh, axis, run):
    """Wrap run(poses, eidx, means, infos, emask, free_mask, *scalars,
    reduce) into the program the make_* functions return: it takes the whole edge
    list (host arrays or tensors; its length a multiple of the axis size),
    puts this rank's contiguous shard and the replicated poses on the
    mesh's device, and returns (poses, cost, iterations)."""
    group, size, rank = _mesh_axis(mesh, axis)
    dev = _mesh_device(mesh)
    reduce = _all_reduce_sum(group)

    def program(poses, eidx, means, infos, emask, free_mask, *scalars):
        poses = torch.as_tensor(poses, device=dev)
        e_cap = len(eidx)
        if e_cap % size:
            raise ValueError(f"{e_cap} edges do not shard over {size} ranks")
        lo, hi = rank * (e_cap // size), (rank + 1) * (e_cap // size)

        def shard(a, dtype):
            return torch.as_tensor(a[lo:hi], device=dev).to(dtype)

        return run(poses, shard(eidx, torch.int64), shard(means, poses.dtype),
                   shard(infos, poses.dtype), shard(emask, torch.bool),
                   torch.as_tensor(free_mask, device=dev).to(torch.bool),
                   *(torch.as_tensor(v, dtype=poses.dtype, device=dev) for v in scalars),
                   reduce=reduce)

    return program


def make_distributed_lm_run_cg(mesh, n_cap, max_iters, cg_iters, axis="dp",
                               mixed=True):
    """Build the sharded matrix-free LM program: edges sharded over `axis`,
    poses replicated, all-reduced rhs, preconditioner and HVPs (see
    graphopt.spa._lm_candidate_cg).  mixed=True (default) runs the float32
    inner CG + float64 refinement step (graphopt.spa._lm_candidate_cg_mixed):
    the per-CG-iteration all-reduce moves float32 bytes, with one float64
    all-reduce per refinement step.

    The program takes (poses, eidx, means, infos, emask, free_mask, lam0,
    ctol, cg_rtol) with the whole edge list and returns (poses, cost,
    iterations)."""
    def run(poses, eidx, means, infos, emask, free_mask, lam0, ctol, cg_rtol, *, reduce):
        return lm_run_cg(poses, eidx, means, infos, emask, free_mask, lam0, ctol, cg_rtol,
                         n_cap=n_cap, max_iters=max_iters, cg_iters=cg_iters,
                         reduce=reduce, mixed=mixed)

    return _edge_program(mesh, axis, run)


def make_distributed_lm_run(mesh, n_cap, max_iters, axis="dp"):
    """The dense-replicated variant: all-reduce the (3N, 3N) normal
    equations, solve on every rank.  O(N²) per-rank memory: small graphs
    and cross-checks only; the "cg" path is the scalable one.

    The program takes (poses, eidx, means, infos, emask, free_mask, lam0,
    tol) with the whole edge list and returns (poses, cost, iterations).
    Its LM rule is the JAX package's for this path: lambda halves on an
    accepted step, and it stops once the decrease is below
    tol * max(cost, 1)."""
    def run(poses, eidx, means, infos, emask, free_mask, lam0, tol, *, reduce):
        fm = free_mask[:, None].to(poses.dtype)
        cost = reduce(_masked_cost(poses, eidx, means, infos, emask))
        p, lam, it, done = poses, lam0, 0, False
        while not done and it < max_iters:
            H_l, b_l = build_normal_equations(p, eidx, means, infos, emask, free_mask,
                                              n_cap=n_cap)
            H, b = reduce(H_l), reduce(b_l)
            # LU solve that neither raises nor syncs on a singular system:
            # its non-finite step is rejected below, as JAX's NaN is
            delta, _ = torch.linalg.solve_ex(H + torch.diag(lam * torch.diagonal(H)), -b)
            cand = p + delta.reshape(n_cap, 3) * fm
            cand[:, 2] = _wrap(cand[:, 2])
            new_cost = reduce(_masked_cost(cand, eidx, means, infos, emask))
            accept = torch.isfinite(new_cost) & (new_cost <= cost)
            decrease = cost - new_cost
            p = torch.where(accept, cand, p)
            lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1.0e-12), lam * 4.0)
            done_t = (accept & (decrease < tol * torch.clamp_min(new_cost, 1.0))) | (
                ~accept & (lam > 1.0e8))
            cost = torch.where(accept, new_cost, cost)
            it += 1
            done = _read(done_t, "lm")
        return p, cost, it

    return _edge_program(mesh, axis, run)


class DistributedSPA:
    """SPA2d-shaped solver whose normal-equation assembly shards edges over
    a device mesh.  Same add_node / add_constraint / compute / nodes
    contract as graphopt.spa.SPA2d; runs on the mesh's device type.

    solver="cg" (default): matrix-free all-reduced PCG, O(E/n + N) per
    rank.  solver="dense": replicated dense solve, small graphs only.
    Every rank must add the same graph and call compute together.
    """

    def __init__(self, mesh, axis="dp", dtype=None, solver="cg", mixed=True):
        if solver not in ("cg", "dense"):
            raise ValueError(f"solver must be 'cg' or 'dense', got {solver!r}")
        self.device = _mesh_device(mesh)
        self.mesh = mesh
        self.axis = axis
        self.solver = solver
        self.mixed = mixed  # float32 inner CG + float64 refinement (cg path)
        self._size = _mesh_axis(mesh, axis)[1]
        self._solver = PoseGraphSolver(dtype=dtype, device=self.device)
        self._programs = {}

    def add_node(self, x, y, yaw, node_id):
        self._solver.add_node(x, y, yaw, node_id)

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        self._solver.add_constraint(from_id, to_id, dx, dy, dyaw, info)

    @property
    def nodes(self):
        return [_NodeView(x, y, yaw) for x, y, yaw in self._solver.poses]

    def compute(self, niter=100, s_lambda=1.0e-4, use_csparse=True,
                init_tol=1.0e-9, max_cg_iters=50, verbose=False,
                conv_tol=1.0e-4):
        """Run LM; returns the final cost.  cg: `init_tol` is the CG
        relative-residual stop and `conv_tol` the LM stop; dense: `init_tol`
        is the LM stop (as in the JAX package).  `use_csparse` is accepted
        for signature parity."""
        s = self._solver
        n = len(s.poses)
        e = len(s.edge_idx)
        if n < 2 or e == 0:
            return 0.0
        n_dev = self._size
        n_cap = _cap(n)
        e_cap = _cap(max(e, n_dev))
        e_cap = ((e_cap + n_dev - 1) // n_dev) * n_dev

        dtype = s.dtype or torch.float64
        poses = np.zeros((n_cap, 3))
        poses[:n] = np.asarray(s.poses)
        eidx = np.zeros((e_cap, 2), dtype=np.int64)
        eidx[:e] = np.asarray(s.edge_idx, dtype=np.int64)
        means = np.zeros((e_cap, 3))
        means[:e] = np.asarray(s.edge_means)
        infos = np.zeros((e_cap, 3, 3))
        infos[:e] = np.stack(s.edge_infos)
        emask = np.zeros(e_cap, dtype=bool)
        emask[:e] = True
        free = np.zeros(n_cap, dtype=bool)
        free[1:n] = True

        key = (self.solver, n_cap, e_cap, niter, max_cg_iters, self.mixed)
        prog = self._programs.get(key)
        if prog is None:
            if self.solver == "cg":
                prog = make_distributed_lm_run_cg(self.mesh, n_cap, niter, max_cg_iters,
                                                  self.axis, mixed=self.mixed)
            else:
                prog = make_distributed_lm_run(self.mesh, n_cap, niter, self.axis)
            self._programs[key] = prog

        poses_t = torch.as_tensor(poses, dtype=dtype, device=self.device)
        tols = (conv_tol, init_tol) if self.solver == "cg" else (init_tol,)
        final, cost, iters = prog(poses_t, eidx, means, infos, emask, free, s_lambda, *tols)
        out = final[:n].to(torch.float64).cpu().numpy()
        s.poses = [[float(x), float(y), float(t)] for x, y, t in out]
        cost = float(cost)
        if verbose:
            print(f"[dist-spa] {int(iters)} iters, chi2 {cost:.6g}")
        return cost
