"""Sparse pose adjustment (SPA): Levenberg-Marquardt over SE(2) edges.

Counterpart of ``yag_slam_tpu/graphopt/spa.py``, both halves:
- the host solver, sparse float64 LM, which "auto" picks for every graph
  up to ``AUTO_HOST_NODE_LIMIT`` nodes: native C++ over a block sparse
  Cholesky (``native.spa_lm``, ``native/spa_lm.cpp``); its plain numpy +
  SuperLU version (``_np_residuals`` / ``_np_cost`` / ``_host_lm``), the
  JAX package's host solver, stays here for the tests and the harnesses;
- the device solvers in plain PyTorch on the solver's device: a dense
  LM (Cholesky of the full 3N x 3N system) in float64 or in mixed
  precision (float32 factorization, float64 matrix-free refinement), and
  a matrix-free block-Jacobi PCG in either precision.

The JAX package runs each device LM loop (and each CG loop) as one
``lax.while_loop``.  Here the loops run on the host: one device-to-host
read of the stop flags per LM iteration, and one per ``CG_CHUNK`` CG
iterations, inside which a stopped carry is frozen by ``torch.where`` on
the loop condition (so the result equals the while_loop's).
``HOST_READS`` counts those reads.  Scatter-adds (``index_add_``) stand
where JAX uses ``.at[].add``; the one-hot matmul assembly, which the JAX
package picks on TPU only, is kept as a plain function for the tests.

Conventions, as in the JAX package: a constraint's mean is the pose of
`to` in `from`'s frame, constraints carry an information matrix, the
first node added is the gauge (held fixed), and ``compute(niter,
s_lambda, use_csparse, init_tol, max_cg_iters)`` mirrors the reference's
``opt.compute(100, 1.0e-4, True, 1.0e-9, 50)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from yag_slam_tpu_torch import native
from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device

# CG iterations run between two reads of the loop's stop flag
CG_CHUNK = 10

# device-to-host reads of the LM and CG loops' stop flags, by loop (plain
# ints; callers may reset them)
HOST_READS = {"lm": 0, "cg": 0}


def reset_host_reads():
    for k in HOST_READS:
        HOST_READS[k] = 0


def _read(t, loop):
    HOST_READS[loop] += 1
    return t.tolist()


def _identity(x):
    return x


# Batched 3-vector products of the CG loop.  torch.einsum spends ~0.1 ms of
# host time per call on the card's host, several times a matmul's, and the
# loop is bound by host time (PERF.md).
def _bmv(A, x):
    """A @ x per batch element: (..., 3, 3), (..., 3) -> (..., 3)."""
    return (A @ x[..., None])[..., 0]


def _bmtv(A, x):
    """A^T @ x per batch element: (..., 3, 3), (..., 3) -> (..., 3)."""
    return (x[..., None, :] @ A)[..., 0, :]


# -- edge math -------------------------------------------------------------------

def _wrap(theta):
    return theta - 2.0 * math.pi * torch.floor((theta + math.pi) / (2.0 * math.pi))


def edge_residuals(poses, eidx, means):
    """Batched SE(2) edge residuals r_e = t2v(T_i^-1 T_j) - mean (E, 3)."""
    pi = poses[eidx[:, 0]]
    pj = poses[eidx[:, 1]]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    lt = pj[:, 2] - pi[:, 2]
    return torch.stack(
        [lx - means[:, 0], ly - means[:, 1], _wrap(lt - means[:, 2])], dim=-1
    )


def edge_jacobians(poses, eidx):
    """Analytic Jacobians (E,3,3) of the residual wrt node i and node j."""
    pi = poses[eidx[:, 0]]
    pj = poses[eidx[:, 1]]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    Ji = torch.stack(
        [
            torch.stack([-c, -s, ly], dim=-1),
            torch.stack([s, -c, -lx], dim=-1),
            torch.stack([z, z, -o], dim=-1),
        ],
        dim=-2,
    )
    Jj = torch.stack(
        [
            torch.stack([c, s, z], dim=-1),
            torch.stack([-s, c, z], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    return Ji, Jj


def _masked_cost(poses, eidx, means, infos, emask):
    r = edge_residuals(poses, eidx, means)
    per_edge = torch.einsum("ei,eij,ej->e", r, infos, r)
    return torch.where(emask, per_edge, 0.0).sum()


def graph_cost(poses, eidx, means, infos, emask, *, n_cap):
    return _masked_cost(poses, eidx, means, infos, emask)


def _edge_blocks(poses, eidx, means, infos, emask):
    """Per-edge residuals, Jacobians and masked weights (shared by the
    matrix-free path)."""
    r = edge_residuals(poses, eidx, means)
    Ji, Jj = edge_jacobians(poses, eidx)
    W = torch.where(emask[:, None, None], infos, 0.0)
    return r, Ji, Jj, W


# -- dense assembly --------------------------------------------------------------

def build_normal_equations(poses, eidx, means, infos, emask, free_mask, *, n_cap):
    """Assemble H = J^T W J and b = J^T W r over the edge list.

    Returns H (3N,3N), b (3N,), with rows/cols of fixed or padded nodes
    replaced by identity/zero so they solve to a zero update.  The blocks
    are scattered straight into the (3N, 3N) matrix and the gauge rows are
    masked in place, so no (N, N, 3, 3) temporary exists.
    """
    N = n_cap
    dtype = poses.dtype
    r, Ji, Jj, W = _edge_blocks(poses, eidx, means, infos, emask)

    JiW = torch.einsum("eki,ekl->eil", Ji, W)  # Ji^T W  (E,3,3)
    JjW = torch.einsum("eki,ekl->eil", Jj, W)
    Hii = torch.einsum("eil,elj->eij", JiW, Ji)
    Hij = torch.einsum("eil,elj->eij", JiW, Jj)
    Hjj = torch.einsum("eil,elj->eij", JjW, Jj)
    bi = torch.einsum("eil,el->ei", JiW, r)
    bj = torch.einsum("eil,el->ei", JjW, r)

    i = eidx[:, 0]
    j = eidx[:, 1]
    ar = torch.arange(3, device=poses.device)

    def flat(rows, cols):
        # (E, 3, 3) element indices of the blocks (rows, cols) in H
        return ((3 * rows[:, None, None] + ar[None, :, None]) * (3 * N)
                + 3 * cols[:, None, None] + ar[None, None, :])

    H = torch.zeros(3 * N, 3 * N, dtype=dtype, device=poses.device)
    H.view(-1).index_add_(
        0,
        torch.cat([flat(i, i), flat(i, j), flat(j, i), flat(j, j)]).reshape(-1),
        torch.cat([Hii, Hij, Hij.transpose(-1, -2), Hjj]).reshape(-1),
    )
    b = torch.zeros(N, 3, dtype=dtype, device=poses.device)
    b.index_add_(0, i, bi)
    b.index_add_(0, j, bj)

    # Gauge + padding: zero rows/cols, identity diagonal, zero rhs.
    fm = free_mask.to(dtype)
    fm3 = fm.repeat_interleave(3)
    H.mul_(fm3[:, None]).mul_(fm3[None, :])
    H.diagonal().add_(1.0 - fm3)
    b = b * fm[:, None]
    return H, b.reshape(3 * N)


def _edge_onehots(eidx, n_cap, dtype):
    """One-hot edge-endpoint selection matrices Si, Sj (E, N), the JAX
    package's TPU form of the segment sums (no solver here uses them:
    scatter-add is native on the card)."""
    ar = torch.arange(n_cap, device=eidx.device)
    Si = (eidx[:, 0:1] == ar[None, :]).to(dtype)
    Sj = (eidx[:, 1:2] == ar[None, :]).to(dtype)
    return Si, Sj


def build_normal_equations_matmul(poses, eidx, means, infos, emask,
                                  free_mask, *, n_cap, onehots=None):
    """Dense assembly with no scatter: H = A^T W A with the (3E, 3N) block
    Jacobian built from one-hot broadcasts.  Same output contract as
    `build_normal_equations` (gauge/padded rows as identity, zero rhs)."""
    N = n_cap
    dtype = poses.dtype
    r, Ji, Jj, W = _edge_blocks(poses, eidx, means, infos, emask)
    Si, Sj = onehots if onehots is not None else _edge_onehots(eidx, n_cap, dtype)
    fm = free_mask.to(dtype)
    # zero the gauge/padded columns of A up front: their H rows/cols
    # vanish in the products
    Sif = Si * fm[None, :]
    Sjf = Sj * fm[None, :]
    WJi = torch.einsum("ers,esc->erc", W, Ji)
    WJj = torch.einsum("ers,esc->erc", W, Jj)
    E = eidx.shape[0]

    def expand(left_i, left_j):
        return (
            torch.einsum("en,erc->ernc", Sif, left_i)
            + torch.einsum("en,erc->ernc", Sjf, left_j)
        ).reshape(3 * E, 3 * N)

    A = expand(Ji, Jj)        # (3E, 3N) block Jacobian
    WA = expand(WJi, WJj)     # (3E, 3N) = W @ A (block-diagonal W)
    H = A.T @ WA
    b = A.T @ torch.einsum("ers,es->er", W, r).reshape(-1)
    # identity rows for fixed/padded nodes
    H = H + torch.diag((1.0 - fm).repeat_interleave(3))
    return H, b


# -- dense LM --------------------------------------------------------------------

def _cholesky(A):
    """Lower Cholesky factor of A and whether A was positive definite.
    ``cholesky_ex`` neither raises nor syncs; a non-PD system must be
    turned into a NaN candidate by the caller, as JAX's NaN factor does."""
    L, info = torch.linalg.cholesky_ex(A)
    return L, info == 0


def _candidate(poses, delta, free_mask, pd):
    """poses + the masked update, heading wrapped; all NaN where the damped
    system was not positive definite (the LM loop then rejects the step
    and raises lambda)."""
    cand = poses + delta * free_mask[:, None].to(poses.dtype)
    cand[:, 2] = _wrap(cand[:, 2])
    return torch.where(pd, cand, math.nan)


def _damped_solve(H, b, poses, free_mask, lam):
    """Solve (H + lam*diag(H)) delta = -b by Cholesky and apply the update."""
    n_cap = poses.shape[0]
    Haug = H.clone()
    Haug.diagonal().add_(lam * H.diagonal())
    L, pd = _cholesky(Haug)
    delta = torch.cholesky_solve(-b[:, None], L).reshape(n_cap, 3)
    return _candidate(poses, delta, free_mask, pd)


def lm_candidate(poses, eidx, means, infos, emask, free_mask, lam, *, n_cap):
    """One damped step: solve (H + lam*diag(H)) delta = -b, return the
    candidate poses and their cost.  (Standalone; the LM loop reuses H, b
    across rejected steps instead.)"""
    H, b = build_normal_equations(poses, eidx, means, infos, emask, free_mask, n_cap=n_cap)
    cand = _damped_solve(H, b, poses, free_mask, lam)
    return cand, graph_cost(cand, eidx, means, infos, emask, n_cap=n_cap)


def _lm_update(cost, new_cost, lam, ctol):
    """The LM accept/damping rule of every device loop: (accept, new
    lambda, done) as device tensors."""
    accept = torch.isfinite(new_cost) & (new_cost <= cost)
    decrease = cost - new_cost
    new_lam = torch.where(accept, torch.clamp_min(lam * (1.0 / 3.0), 1.0e-12), lam * 4.0)
    done = (accept & (decrease <= ctol * new_cost + 1.0e-15)) | (
        ~accept & (new_lam > 1.0e8)
    )
    return accept, new_lam, done


def lm_run(poses, eidx, means, infos, emask, free_mask, lam0, ctol, *,
           n_cap, max_iters):
    """The dense float64 Levenberg-Marquardt loop; returns (poses, cost,
    iterations).

    Convergence: stop after an accepted step whose cost decrease is below
    `ctol` relative (+1e-15 absolute floor so exactly-consistent graphs
    terminate), or when lambda passes 1e8.  Normal equations are assembled
    only when a step is accepted; rejected steps only re-factorize with a
    larger lambda.  One host read (accept, done) per iteration.
    """
    cost = graph_cost(poses, eidx, means, infos, emask, n_cap=n_cap)
    H, b = build_normal_equations(poses, eidx, means, infos, emask, free_mask, n_cap=n_cap)
    p, lam, it, done = poses, lam0, 0, False
    while not done and it < max_iters:
        cand = _damped_solve(H, b, p, free_mask, lam)
        new_cost = graph_cost(cand, eidx, means, infos, emask, n_cap=n_cap)
        accept, lam, done_t = _lm_update(cost, new_cost, lam, ctol)
        p = torch.where(accept, cand, p)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        accepted, done = _read(torch.stack([accept, done_t]), "lm")
        if accepted and not done:
            H, b = build_normal_equations(p, eidx, means, infos, emask, free_mask,
                                          n_cap=n_cap)
    return p, cost, it


# -- mixed-precision and matrix-free steps -----------------------------------------
#
# The pose-chain normal equations are ill-conditioned (cond ~ N^2), so a
# plain float32 Newton step is too inexact.  Iterative refinement splits the
# difference: factorize (or iterate) in float32, compute the residual of the
# damped system matrix-free in float64 (O(E) edge einsums, no dense float64
# object), and re-solve the correction in float32.

def _damped_system_f64(poses, eidx, means, infos, emask, free_mask, lam,
                       reduce=_identity, blocks=None):
    """Damped normal equations in the poses' dtype, matrix-free: returns
    (b_neg (N,3), avp, diag (N,3), D (N,3,3)) with gauge/padding handled
    as in the dense assembly (identity rows scaled by (1 + lam)).
    `reduce` sums edge-shard partials; `blocks` lets the caller reuse
    precomputed `_edge_blocks` output."""
    dtype = poses.dtype
    n_cap = poses.shape[0]
    r, Ji, Jj, W = (blocks if blocks is not None
                    else _edge_blocks(poses, eidx, means, infos, emask))
    fm = free_mask.to(dtype)
    JiWr = torch.einsum("eji,ejl,el->ei", Ji, W, r)
    JjWr = torch.einsum("eji,ejl,el->ei", Jj, W, r)
    b = torch.zeros(n_cap, 3, dtype=dtype, device=poses.device)
    b.index_add_(0, eidx[:, 0], JiWr)
    b.index_add_(0, eidx[:, 1], JjWr)
    b_neg = -reduce(b) * fm[:, None]
    D = _hessian_diag_blocks(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=reduce)
    diag = torch.diagonal(D, dim1=-2, dim2=-1)  # (N, 3) = diag(H)
    hvp = _make_hvp(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=reduce)

    def avp(v):
        # identity rows for fixed/padded nodes also get the + lam*diag
        # term (diag = 1 there), matching Haug = H + lam*diag(H) exactly
        return hvp(v) + lam * diag * v

    return b_neg, avp, diag, D


def _lm_candidate_mixed(poses, eidx, means, infos, emask, free_mask, lam,
                        *, n_cap, refine_iters=2):
    """One damped LM step: float32 Cholesky factorization + float64
    matrix-free iterative refinement.  Returns (candidate poses, cost)."""
    f32 = torch.float32
    H32, _ = build_normal_equations(
        poses.to(f32), eidx, means.to(f32), infos.to(f32), emask, free_mask, n_cap=n_cap,
    )
    # H32 + diag(lam * diag(H32)), in place: no second (3N, 3N) matrix
    H32.diagonal().add_(lam.to(f32) * H32.diagonal())
    L32, pd = _cholesky(H32)
    b_neg, avp, _, _ = _damped_system_f64(poses, eidx, means, infos, emask, free_mask, lam)

    def solve32(rhs64):
        delta = torch.cholesky_solve(rhs64.reshape(-1, 1).to(f32), L32)
        return delta.to(poses.dtype).reshape(n_cap, 3)

    x = solve32(b_neg)
    for _ in range(refine_iters):
        resid = b_neg - avp(x)
        x = x + solve32(resid)
    cand = _candidate(poses, x, free_mask, pd)
    return cand, graph_cost(cand, eidx, means, infos, emask, n_cap=n_cap)


def lm_run_mixed(poses, eidx, means, infos, emask, free_mask, lam0, ctol, *,
                 n_cap, max_iters, refine_iters=2):
    """The LM loop with mixed-precision dense steps (same accept and
    convergence logic as lm_run); one host read per iteration."""
    cost = graph_cost(poses, eidx, means, infos, emask, n_cap=n_cap)
    p, lam, it, done = poses, lam0, 0, False
    while not done and it < max_iters:
        cand, new_cost = _lm_candidate_mixed(
            p, eidx, means, infos, emask, free_mask, lam,
            n_cap=n_cap, refine_iters=refine_iters,
        )
        accept, lam, done_t = _lm_update(cost, new_cost, lam, ctol)
        p = torch.where(accept, cand, p)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        done = _read(done_t, "lm")
    return p, cost, it


def _hessian_diag_blocks(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=_identity):
    """Block-diagonal of H as (N, 3, 3): the PCG preconditioner and the
    Marquardt damping diagonal.  `reduce` sums edge-shard partials (the
    identity on one device); gauge handling comes after the reduction so
    identity rows are not multiplied by the shard count."""
    Dii = torch.einsum("eki,ekl,elj->eij", Ji, W, Ji)
    Djj = torch.einsum("eki,ekl,elj->eij", Jj, W, Jj)
    D = torch.zeros(n_cap, 3, 3, dtype=dtype, device=Ji.device)
    D.index_add_(0, eidx[:, 0], Dii)
    D.index_add_(0, eidx[:, 1], Djj)
    D = reduce(D)
    fm = free_mask.to(dtype)
    eye = torch.eye(3, dtype=dtype, device=Ji.device)
    return D * fm[:, None, None] + (1.0 - fm)[:, None, None] * eye


def _make_hvp(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=_identity):
    """Matrix-free H @ v over the (possibly sharded) edge list (v: (N, 3))."""
    i = eidx[:, 0]
    j = eidx[:, 1]
    fm = free_mask.to(dtype)

    def hvp(v):
        # fixed/padded nodes act as identity rows (consistent with the
        # dense assembly's gauge handling); their rhs is zero.  The
        # identity term is added after the cross-shard reduction.
        vf = v * fm[:, None]
        Wr = _bmv(W, _bmv(Ji, vf[i]) + _bmv(Jj, vf[j]))
        JiWr = _bmtv(Ji, Wr)
        JjWr = _bmtv(Jj, Wr)
        out = torch.zeros(n_cap, 3, dtype=dtype, device=v.device)
        out.index_add_(0, i, JiWr)
        out.index_add_(0, j, JjWr)
        return reduce(out) * fm[:, None] + (1.0 - fm)[:, None] * v

    return hvp


def _inv3x3(m):
    """Batched closed-form 3x3 inverse, any float dtype."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    Ii = a * e - b * d
    det = a * A + b * B + c * C
    adj = torch.stack(
        [torch.stack([A, D, G], dim=-1),
         torch.stack([B, E, H], dim=-1),
         torch.stack([C, F, Ii], dim=-1)], dim=-2,
    )
    return adj / det[..., None, None]


def _dot(a, b):
    return (a * b).sum()


def _pcg(avp, precond, x, res, p, rz, thresh, cg_iters):
    """Preconditioned CG from the carry (x, res, p, rz) while the residual's
    squared norm exceeds `thresh`, for at most `cg_iters` iterations; the
    same result as the JAX package's while_loop.  The iterations run in
    chunks of CG_CHUNK: inside a chunk, a stopped carry stays frozen
    (torch.where on the loop condition), and the stop flag is read once
    per chunk."""
    it = torch.zeros((), dtype=torch.int64, device=x.device)
    go = (it < cg_iters) & (_dot(res, res) > thresh)
    steps = 0
    while steps < cg_iters:
        for _ in range(min(CG_CHUNK, cg_iters - steps)):
            Ap = avp(p)
            alpha = rz / torch.clamp_min(_dot(p, Ap), 1e-30)
            x_new = x + alpha * p
            res_new = res - alpha * Ap
            z = precond(res_new)
            rz_new = _dot(res_new, z)
            beta = rz_new / torch.clamp_min(rz, 1e-30)
            p = torch.where(go, z + beta * p, p)
            x = torch.where(go, x_new, x)
            res = torch.where(go, res_new, res)
            rz = torch.where(go, rz_new, rz)
            it = it + go
            go = (it < cg_iters) & (_dot(res, res) > thresh)
        steps += min(CG_CHUNK, cg_iters - steps)
        if steps < cg_iters and not _read(go, "cg"):
            break
    return x


def _lm_candidate_cg(poses, eidx, means, infos, emask, free_mask, lam,
                     cg_rtol, *, n_cap, cg_iters, reduce=_identity):
    """Damped step via block-Jacobi-preconditioned conjugate gradients:
    the matrix-free path, where no (3N, 3N) object exists.

    With an edge-sharded graph, the edge arrays are the local shard and
    `reduce` sums every edge reduction (rhs, preconditioner diagonal,
    HVP, cost) across the shards."""
    dtype = poses.dtype
    r, Ji, Jj, W = _edge_blocks(poses, eidx, means, infos, emask)
    fm = free_mask.to(dtype)

    b = torch.zeros(n_cap, 3, dtype=dtype, device=poses.device)
    JiWr = torch.einsum("eji,ejl,el->ei", Ji, W, r)
    JjWr = torch.einsum("eji,ejl,el->ei", Jj, W, r)
    b.index_add_(0, eidx[:, 0], JiWr)
    b.index_add_(0, eidx[:, 1], JjWr)
    b = -reduce(b) * fm[:, None]

    D = _hessian_diag_blocks(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=reduce)
    hvp = _make_hvp(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=reduce)
    eye = torch.eye(3, dtype=dtype, device=poses.device)[None]
    # Marquardt damping on the block diagonal
    damped_diag = D + lam * D * eye
    D_diag = D * eye

    def avp(v):
        base = hvp(v)
        extra = lam * _bmv(D_diag, v)
        return base + extra * fm[:, None]

    Minv = _inv3x3(damped_diag + 1e-12 * eye)

    def precond(v):
        return _bmv(Minv, v)

    x = torch.zeros_like(b)
    res = b - avp(x)
    z = precond(res)
    rr0 = _dot(res, res)
    # relative residual stop (the C++ SPA's initTol plays this role)
    thresh = torch.clamp_min(cg_rtol * cg_rtol * rr0, 1e-30)
    x = _pcg(avp, precond, x, res, z, _dot(res, z), thresh, cg_iters)

    cand = poses + x * fm[:, None]
    cand[:, 2] = _wrap(cand[:, 2])
    return cand, reduce(_masked_cost(cand, eidx, means, infos, emask))


def _lm_candidate_cg_mixed(poses, eidx, means, infos, emask, free_mask, lam,
                           cg_rtol, *, n_cap, cg_iters, refine_iters=2,
                           reduce=_identity):
    """Damped LM step via float32 block-Jacobi PCG + float64 matrix-free
    iterative refinement: the mixed-precision sibling of
    `_lm_candidate_cg` (same gauge conventions, same lam*diag(H) damping
    as the dense paths).  Each refinement recomputes the damped system's
    residual in float64 and re-solves the correction in float32."""
    dtype = poses.dtype
    f32 = torch.float32
    fm = free_mask.to(dtype)
    blocks = _edge_blocks(poses, eidx, means, infos, emask)
    r, Ji, Jj, W = blocks
    b_neg, avp64, diag, D = _damped_system_f64(
        poses, eidx, means, infos, emask, free_mask, lam, reduce=reduce, blocks=blocks,
    )

    # float32 inner operator + block-Jacobi preconditioner
    fm32 = free_mask.to(f32)
    lam32 = lam.to(f32)
    diag32 = diag.to(f32)
    hvp32 = _make_hvp(Ji.to(f32), Jj.to(f32), W.to(f32), eidx, free_mask, n_cap, f32,
                      reduce=reduce)

    def avp32(v):
        return hvp32(v) + lam32 * diag32 * v

    eye = torch.eye(3, dtype=dtype, device=poses.device)[None]
    M = D + lam * D * eye  # damped block diagonal (lam*diag on-diagonal)
    Minv32 = _inv3x3(M.to(f32) + 1e-12 * eye.to(f32))

    def precond(v):
        return _bmv(Minv32, v)

    def solve32(rhs64):
        rhs = (rhs64 * fm[:, None]).to(f32)
        z = precond(rhs)   # x0 = 0, so the residual is rhs
        thresh = torch.clamp_min((cg_rtol * cg_rtol).to(f32) * _dot(rhs, rhs), 1e-30)
        x = _pcg(avp32, precond, torch.zeros_like(rhs), rhs, z, _dot(rhs, z), thresh,
                 cg_iters)
        return (x * fm32[:, None]).to(dtype)

    x = solve32(b_neg)
    for _ in range(refine_iters):
        x = x + solve32(b_neg - avp64(x))

    cand = poses + x * fm[:, None]
    cand[:, 2] = _wrap(cand[:, 2])
    return cand, reduce(_masked_cost(cand, eidx, means, infos, emask))


def lm_run_cg(poses, eidx, means, infos, emask, free_mask, lam0, ctol, cg_rtol, *,
              n_cap, max_iters, cg_iters, reduce=_identity, mixed=False, refine_iters=2):
    """The LM loop with matrix-free PCG steps (same accept and convergence
    logic as `lm_run`).  `reduce` sums edge-shard partials (an all-reduce
    for an edge-sharded graph; the identity on one device).  With `mixed`,
    each step runs the float32 inner CG + float64 refinement
    (`_lm_candidate_cg_mixed`).  One host read per LM iteration, plus one
    per CG_CHUNK CG iterations."""
    cost = reduce(_masked_cost(poses, eidx, means, infos, emask))
    p, lam, it, done = poses, lam0, 0, False
    while not done and it < max_iters:
        if mixed:
            cand, new_cost = _lm_candidate_cg_mixed(
                p, eidx, means, infos, emask, free_mask, lam, cg_rtol,
                n_cap=n_cap, cg_iters=cg_iters, refine_iters=refine_iters, reduce=reduce,
            )
        else:
            cand, new_cost = _lm_candidate_cg(
                p, eidx, means, infos, emask, free_mask, lam, cg_rtol,
                n_cap=n_cap, cg_iters=cg_iters, reduce=reduce,
            )
        accept, lam, done_t = _lm_update(cost, new_cost, lam, ctol)
        p = torch.where(accept, cand, p)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        done = _read(done_t, "lm")
    return p, cost, it


def _cap(n, minimum=16):
    c = minimum
    while c < n:
        c *= 2
    return c


# -- host solver: sparse float64 LM ------------------------------------------------

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
    "lambda_blowup", "empty"}.  The plain version of ``native.spa_lm``,
    which the host solver runs."""
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


# -- solver facades ----------------------------------------------------------------

class PoseGraphSolver:
    """LM solver over growing node/edge lists.

    `solver`:
      - "host"  -- exact sparse float64 LM on the host CPU (native C++,
        block sparse Cholesky: ``native.spa_lm``), whatever `device` is;
      - "dense" -- Cholesky of the full 3N x 3N system on `device`;
      - "cg"    -- matrix-free block-Jacobi PCG over the edge list on
        `device`;
      - "auto"  -- host up to `auto_host_limit` nodes, then dense up to
        `dense_node_limit` nodes, then cg.
    `precision` applies to the device paths only: "mixed" runs float32
    factorization/CG with float64 matrix-free refinement, "f64" runs every
    step in float64.  `dtype` (default float64) is the device poses'
    dtype.  `device` is resolved only when a device path runs, so a
    host-path solver never needs a card.
    """

    DENSE_NODE_LIMIT = 1024
    # The JAX package's limit, kept: the H100's crossover is measured by
    # chip_smoke.py (phase 12, PERF.md), and moving the limit would change
    # what GraphSlam.process_scan computes.
    AUTO_HOST_NODE_LIMIT = 65536

    def __init__(self, dtype=None, solver="auto", dense_node_limit=None,
                 auto_host_limit=None, precision="mixed", *, device=DEFAULT_DEVICE):
        self.dtype = dtype
        self.solver = solver
        self.precision = precision
        self.dense_node_limit = dense_node_limit or self.DENSE_NODE_LIMIT
        self.auto_host_limit = auto_host_limit or self.AUTO_HOST_NODE_LIMIT
        self.device = device
        self.poses = []  # python lists; packed per solve
        self.edge_idx = []
        self.edge_means = []
        self.edge_infos = []
        self.id_to_index = {}

    # -- graph construction -------------------------------------------------
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

    def set_pose(self, node_id, x, y, yaw):
        self.poses[self.id_to_index[node_id]] = [float(x), float(y), float(yaw)]

    def _use_host(self, n):
        if self.solver == "host":
            return True
        return self.solver == "auto" and n <= self.auto_host_limit

    # -- solve --------------------------------------------------------------
    def optimize(self, max_iters=100, init_lambda=1.0e-4, tol=1.0e-9,
                 verbose=False, max_cg_iters=50, conv_tol=1.0e-4):
        """Run LM to convergence; returns the final cost.

        `conv_tol` is the LM stop: relative cost decrease of an accepted
        step (all paths).  `tol` is the CG relative-residual stop and only
        affects the "cg" path; the host and dense paths solve exactly.
        """
        n = len(self.poses)
        e = len(self.edge_idx)
        if n < 2 or e == 0:
            return 0.0

        if self._use_host(n):
            out, cost, iters, reason = native.spa_lm(
                np.asarray(self.poses, dtype=np.float64),
                np.asarray(self.edge_idx, dtype=np.int64),
                np.asarray(self.edge_means, dtype=np.float64),
                np.stack(self.edge_infos),
                max_iters, init_lambda, conv_tol,
            )
            if verbose:
                print(f"[spa] {reason} after {iters} iters, chi2 {cost:.6g}")
            self.poses = [[float(x), float(y), float(t)] for x, y, t in out]
            return cost

        dev = resolve_device(self.device)
        n_cap = _cap(n)
        e_cap = _cap(e)
        poses = np.zeros((n_cap, 3))
        poses[:n] = np.asarray(self.poses)
        eidx = np.zeros((e_cap, 2), dtype=np.int64)
        eidx[:e] = np.asarray(self.edge_idx, dtype=np.int64)
        means = np.zeros((e_cap, 3))
        means[:e] = np.asarray(self.edge_means)
        infos = np.zeros((e_cap, 3, 3))
        infos[:e] = np.stack(self.edge_infos)
        emask = np.zeros(e_cap, dtype=bool)
        emask[:e] = True
        free = np.zeros(n_cap, dtype=bool)
        free[1:n] = True  # node 0 is the gauge

        use_cg = self.solver == "cg" or (
            self.solver == "auto" and n > self.dense_node_limit
        )
        dtype = self.dtype or torch.float64

        def put(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=dev)

        args = (put(poses), put(eidx, torch.int64), put(means), put(infos),
                put(emask, torch.bool), put(free, torch.bool),
                put(init_lambda), put(conv_tol))
        mixed = self.precision == "mixed"
        if use_cg:
            final_poses, cost, iters = lm_run_cg(
                *args, put(tol), n_cap=n_cap, max_iters=max_iters,
                cg_iters=max_cg_iters, mixed=mixed,
            )
        elif mixed:
            final_poses, cost, iters = lm_run_mixed(*args, n_cap=n_cap, max_iters=max_iters)
        else:
            final_poses, cost, iters = lm_run(*args, n_cap=n_cap, max_iters=max_iters)
        cost = float(cost)
        if verbose:
            print(f"[spa] stopped after {iters} iters, chi2 {cost:.6g}")
        out = final_poses[:n].to(torch.float64).cpu().numpy()
        self.poses = [[float(x), float(y), float(t)] for x, y, t in out]
        return cost


class _NodeView:
    __slots__ = ("x", "y", "yaw")

    def __init__(self, x, y, yaw):
        self.x = x
        self.y = y
        self.yaw = yaw


class SPA2d:
    """Pose-graph optimizer with the reference's SPA2d surface
    (add_node / add_constraint / compute / .nodes) over a
    :class:`PoseGraphSolver` (``self._solver``)."""

    def __init__(self, dtype=None, solver="auto", precision="mixed", *,
                 device=DEFAULT_DEVICE):
        self._solver = PoseGraphSolver(dtype=dtype, solver=solver, precision=precision,
                                       device=device)

    def add_node(self, x, y, yaw, node_id):
        self._solver.add_node(x, y, yaw, node_id)

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        """`info` is the 3x3 information matrix of the relative pose."""
        self._solver.add_constraint(from_id, to_id, dx, dy, dyaw, info)

    def compute(self, niter=100, s_lambda=1.0e-4, use_csparse=True,
                init_tol=1.0e-9, max_cg_iters=50, verbose=False,
                conv_tol=1.0e-4):
        """Run LM to convergence; returns the final cost.  `use_csparse` is
        accepted for signature parity (the solver picks host, dense or PCG
        by graph size or the constructor's `solver`); `init_tol` is the CG
        residual stop of the cg path; `conv_tol` is the relative cost
        decrease that stops LM."""
        return self._solver.optimize(
            max_iters=niter, init_lambda=s_lambda, tol=init_tol,
            verbose=verbose, max_cg_iters=max_cg_iters, conv_tol=conv_tol,
        )

    @property
    def nodes(self):
        return [_NodeView(x, y, yaw) for x, y, yaw in self._solver.poses]
