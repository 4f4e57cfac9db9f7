"""Free-space segmentation for map splicing, in plain PyTorch on a device.

Counterpart of ``yag_slam_tpu/splicing/segmentation.py`` (plain XLA there,
no Pallas kernel).  The reference segments a saved map's free space with
SLIC superpixels; on a binary free-space mask at near-zero compactness
that is a spatial clustering of the masked pixel coordinates, so this is
masked Lloyd's k-means on (x, y): the same numpy-seeded initial centers,
the float32 distance |p|^2 - 2 p.c + |c|^2 (the cross term a matmul, as
in the JAX package), argmin, and 12 iterations.  The per-segment sums of
the integer pixel coordinates are float64 ``index_add_`` sums, exact in
any order, so the CUDA atomics' order does not move a center.
"""
from __future__ import annotations

import numpy as np
import torch

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device


def _sq_dists(pts, centers):
    """(M, K) float32 |p - c|^2 as |p|^2 - 2 p.c + |c|^2."""
    return (
        (pts * pts).sum(dim=1, keepdim=True)
        - 2.0 * (pts @ centers.T)
        + (centers * centers).sum(dim=1)[None, :]
    )


def _kmeans(pts, centers, n_iters: int):
    """pts (M, 2) float32, centers (K, 2) float32 -> assignments (M,)."""
    K = centers.shape[0]
    pts64 = pts.to(torch.float64)
    ones = torch.ones(pts.shape[0], dtype=torch.float64, device=pts.device)
    for _ in range(n_iters):
        assign = torch.argmin(_sq_dists(pts, centers), dim=1)
        sums = torch.zeros((K, 2), dtype=torch.float64, device=pts.device)
        cnts = torch.zeros((K,), dtype=torch.float64, device=pts.device)
        sums.index_add_(0, assign, pts64)
        cnts.index_add_(0, assign, ones)
        means = (sums / cnts.clamp(min=1.0)[:, None]).to(torch.float32)
        centers = torch.where(cnts[:, None] > 0, means, centers)
    return torch.argmin(_sq_dists(pts, centers), dim=1)


def spatial_segments(mask, n_segments, n_iters=12, seed=0, *,
                     device=DEFAULT_DEVICE):
    """Cluster the True pixels of `mask` (H, W) into `n_segments` spatially
    compact regions on `device`.  Returns an (H, W) int32 array: 0 =
    background, segment ids 1..K (the reference's SLIC label contract)."""
    device = resolve_device(device)
    mask = np.asarray(mask).astype(bool)
    ys, xs = np.nonzero(mask)
    m = len(xs)
    if m == 0 or n_segments < 1:
        return np.zeros(mask.shape, dtype=np.int32)
    n_segments = min(n_segments, m)

    rng = np.random.default_rng(seed)
    init_idx = rng.choice(m, size=n_segments, replace=False)
    pts = np.stack([xs, ys], axis=1).astype(np.float32)
    assign = _kmeans(torch.as_tensor(pts, device=device),
                     torch.as_tensor(pts[init_idx], device=device), n_iters)
    out = np.zeros(mask.shape, dtype=np.int32)
    out[ys, xs] = assign.cpu().numpy() + 1
    return out


def open_free_space(free_mask, size=11):
    """Morphological opening of the free-space mask (host, scipy).

    The reference dilates and erodes the inverted image (a closing of the
    non-free space), which on the free mask is an opening: thin free
    slivers and specks go before segmentation."""
    from scipy import ndimage

    st = np.ones((size, size), bool)
    return ndimage.binary_opening(np.asarray(free_mask).astype(bool),
                                  structure=st)
