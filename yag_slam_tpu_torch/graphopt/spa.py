"""Sparse pose adjustment (SPA) for the port: the host sparse float64 LM.

Counterpart of the host path of ``yag_slam_tpu/graphopt/spa.py``
(``_np_residuals`` / ``_np_cost`` / ``_host_lm``), which that package's
"auto" solver picks for every graph up to 65,536 nodes, i.e. on the whole
SLAM main path.  Normal equations are assembled with vectorized numpy and
solved exactly with SuperLU (scipy).  The device solvers are not ported.
"""
from __future__ import annotations

import numpy as np


def _np_wrap(t):
    return t - 2.0 * np.pi * np.floor((t + np.pi) / (2.0 * np.pi))


def _np_residuals(poses, eidx, means):
    pi = poses[eidx[:, 0]]
    pj = poses[eidx[:, 1]]
    c, s = np.cos(pi[:, 2]), np.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    r = np.stack(
        [lx - means[:, 0], ly - means[:, 1],
         _np_wrap(pj[:, 2] - pi[:, 2] - means[:, 2])], axis=-1
    )
    return r, lx, ly, c, s


def _np_cost(poses, eidx, means, infos):
    r, *_ = _np_residuals(poses, eidx, means)
    return float(np.einsum("ei,eij,ej->", r, infos, r))


def _host_lm(poses, eidx, means, infos, max_iters, lam0, conv_tol):
    """LM with exact sparse f64 steps.  poses (N,3) f64 (node 0 is the
    gauge), eidx (E,2) int, means (E,3), infos (E,3,3).  Returns
    (poses, cost, iters, reason) with reason in {"converged", "max_iters",
    "lambda_blowup", "empty"}."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = poses.shape[0]
    nf = n - 1  # free nodes (gauge excluded)
    if nf < 1:
        return poses, 0.0, 0, "empty"

    # a free node with no incident constraint would make H singular: pin it
    # with a unit diagonal (zero rhs -> zero update)
    degree = np.zeros(n, dtype=np.int64)
    np.add.at(degree, eidx.ravel(), 1)
    dangling = np.zeros(3 * nf)
    iso = np.flatnonzero(degree[1:] == 0)
    if iso.size:
        dangling[np.repeat(3 * iso, 3) + np.tile(np.arange(3), iso.size)] = 1.0

    def assemble(p):
        r, lx, ly, c, s = _np_residuals(p, eidx, means)
        E = eidx.shape[0]
        z = np.zeros(E)
        o = np.ones(E)
        Ji = np.empty((E, 3, 3))
        Ji[:, 0] = np.stack([-c, -s, ly], axis=-1)
        Ji[:, 1] = np.stack([s, -c, -lx], axis=-1)
        Ji[:, 2] = np.stack([z, z, -o], axis=-1)
        Jj = np.empty((E, 3, 3))
        Jj[:, 0] = np.stack([c, s, z], axis=-1)
        Jj[:, 1] = np.stack([-s, c, z], axis=-1)
        Jj[:, 2] = np.stack([z, z, o], axis=-1)
        JiW = np.einsum("eki,ekl->eil", Ji, infos)
        JjW = np.einsum("eki,ekl->eil", Jj, infos)
        blocks = np.concatenate(
            [
                np.einsum("eil,elj->eij", JiW, Ji),
                np.einsum("eil,elj->eij", JiW, Jj),
                np.einsum("eil,elj->eij", JjW, Ji),
                np.einsum("eil,elj->eij", JjW, Jj),
            ]
        )
        bi = np.einsum("eil,el->ei", JiW, r)
        bj = np.einsum("eil,el->ei", JjW, r)

        rows_n = np.concatenate([eidx[:, 0], eidx[:, 0], eidx[:, 1], eidx[:, 1]])
        cols_n = np.concatenate([eidx[:, 0], eidx[:, 1], eidx[:, 0], eidx[:, 1]])
        # drop gauge rows/cols; remap node k -> free index k-1
        keep = (rows_n > 0) & (cols_n > 0)
        blocks = blocks[keep]
        rows_n = rows_n[keep] - 1
        cols_n = cols_n[keep] - 1
        off = np.arange(3)
        rr = np.broadcast_to(
            3 * rows_n[:, None, None] + off[None, :, None], blocks.shape
        ).ravel()
        cc = np.broadcast_to(
            3 * cols_n[:, None, None] + off[None, None, :], blocks.shape
        ).ravel()
        H = sp.coo_matrix(
            (blocks.ravel(), (rr, cc)), shape=(3 * nf, 3 * nf)
        ).tocsc()
        if iso.size:
            H = H + sp.diags(dangling)
        b = np.zeros((n, 3))
        np.add.at(b, eidx[:, 0], bi)
        np.add.at(b, eidx[:, 1], bj)
        return H, b[1:].ravel()

    p = poses.copy()
    cost = _np_cost(p, eidx, means, infos)
    lam = lam0
    it = 0
    reason = "max_iters"
    H, b = assemble(p)
    while it < max_iters:
        it += 1
        d = np.maximum(H.diagonal(), 1e-12)
        try:
            lu = spla.splu((H + lam * sp.diags(d)).tocsc())
            delta = lu.solve(-b)
        except RuntimeError:
            delta = None
        accept = False
        if delta is not None and np.all(np.isfinite(delta)):
            cand = p.copy()
            cand[1:] += delta.reshape(nf, 3)
            cand[:, 2] = _np_wrap(cand[:, 2])
            new_cost = _np_cost(cand, eidx, means, infos)
            accept = np.isfinite(new_cost) and new_cost <= cost
        if accept:
            decrease = cost - new_cost
            p, cost = cand, new_cost
            lam = max(lam / 3.0, 1e-12)
            if decrease <= conv_tol * new_cost + 1e-15:
                reason = "converged"
                break
            H, b = assemble(p)
        else:
            lam *= 4.0
            if lam > 1e8:
                reason = "lambda_blowup"
                break
    return p, cost, it, reason


class _NodeView:
    __slots__ = ("x", "y", "yaw")

    def __init__(self, x, y, yaw):
        self.x = x
        self.y = y
        self.yaw = yaw


class SPA2d:
    """Pose-graph optimizer with the reference's SPA2d surface
    (add_node / add_constraint / compute / .nodes)."""

    def __init__(self):
        self.poses = []        # [x, y, yaw] per node, insertion order
        self.edge_idx = []
        self.edge_means = []
        self.edge_infos = []
        self.id_to_index = {}

    def add_node(self, x, y, yaw, node_id):
        if node_id in self.id_to_index:
            raise ValueError(f"duplicate node id {node_id}")
        self.id_to_index[node_id] = len(self.poses)
        self.poses.append([float(x), float(y), float(yaw)])

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        """`info` is the 3x3 information matrix of the relative pose."""
        self.edge_idx.append(
            [self.id_to_index[from_id], self.id_to_index[to_id]]
        )
        self.edge_means.append([float(dx), float(dy), float(dyaw)])
        self.edge_infos.append(np.asarray(info, dtype=np.float64))

    def compute(self, niter=100, s_lambda=1.0e-4, use_csparse=True,
                init_tol=1.0e-9, max_cg_iters=50, verbose=False,
                conv_tol=1.0e-4):
        """Run LM to convergence; returns the final cost.  `use_csparse`,
        `init_tol` and `max_cg_iters` are accepted for signature parity and
        unused: the solve is always exact sparse f64.  `conv_tol` is the
        relative cost decrease that stops LM."""
        n = len(self.poses)
        if n < 2 or not self.edge_idx:
            return 0.0
        out, cost, iters, reason = _host_lm(
            np.asarray(self.poses, dtype=np.float64),
            np.asarray(self.edge_idx, dtype=np.int64),
            np.asarray(self.edge_means, dtype=np.float64),
            np.stack(self.edge_infos),
            niter, s_lambda, conv_tol,
        )
        if verbose:
            print(f"[spa] {reason} after {iters} iters, chi2 {cost:.6g}")
        self.poses = [[float(x), float(y), float(t)] for x, y, t in out]
        return cost

    @property
    def nodes(self):
        return [_NodeView(x, y, yaw) for x, y, yaw in self.poses]
