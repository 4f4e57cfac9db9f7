"""Occupancy-grid rendering from scans, as plain PyTorch on the device.

Counterpart of ``yag_slam_tpu/mapping/occupancy.py`` with the same value
contract (occupied=0, unknown=200, free=255) and OpenKarto's rule: every
beam marks free cells from the sensor to min(range, range_threshold),
beams shorter than the threshold also mark a hit at the endpoint, and a
cell with more than MIN_PASS_THROUGH visits is occupied when
hits >= 0.1 * passes.  The trace is one dominant-axis DDA step per
(beam, step) pair, counted with ``index_add_``; positions are float32 as
in the JAX package.  There is no custom kernel in the rendering: the JAX
package's version is plain XLA as well.  Converting a saved map into a
correlation grid (:func:`occupancy_grid_map_to_correlation_grid`) runs
the matcher's scatter_cells and smear_grid kernels on CUDA.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from yag_slam_tpu_torch.core.transform import Pose2

GRID_OCCUPIED = 0
GRID_UNKNOWN = 200
GRID_FREE = 255

# OpenKarto defaults
MIN_PASS_THROUGH = 2
OCCUPANCY_THRESHOLD = 0.1

# beams traced per batch; bounds the (beams, steps) temporaries
_BEAM_CHUNK = 8192


@dataclass
class OccupancyGrid:
    image: np.ndarray  # (H, W) uint8; row 0 at offset.y (lower-left origin)
    width: int
    height: int
    offset: Pose2
    resolution: float


def _render_counts(origin_x, origin_y, end_x, end_y, is_hit, ox, oy, res, *,
                   width, height, max_steps, min_pass_through):
    """Pass/hit counts of all beams -> (height, width) uint8 image."""
    dev = origin_x.device
    size = width * height
    passes = torch.zeros(size, dtype=torch.int32, device=dev)
    hits = torch.zeros(size, dtype=torch.int32, device=dev)
    k = torch.arange(max_steps, dtype=origin_x.dtype, device=dev)
    for b0 in range(0, origin_x.shape[0], _BEAM_CHUNK):
        sl = slice(b0, b0 + _BEAM_CHUNK)
        x0, y0, x1, y1 = origin_x[sl], origin_y[sl], end_x[sl], end_y[sl]
        dx = x1 - x0
        dy = y1 - y0
        adx = torch.abs(dx) / res
        ady = torch.abs(dy) / res
        n_steps = torch.ceil(torch.maximum(adx, ady)).clamp(0, max_steps).to(torch.int32)
        inv = 1.0 / torch.clamp(n_steps.to(dx.dtype), min=1.0)
        # positions strictly before the endpoint cell: k/n_steps for k<n_steps
        t = k[None, :] * inv[:, None]
        px = x0[:, None] + dx[:, None] * t
        py = y0[:, None] + dy[:, None] * t
        cx = torch.round((px - ox) / res).clamp(-1, width).to(torch.int32)
        cy = torch.round((py - oy) / res).clamp(-1, height).to(torch.int32)
        step_ok = (
            (k[None, :] < n_steps[:, None].to(dx.dtype))
            & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
        )
        lin = (cy * width + cx)[step_ok].long()
        passes.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))

        ex = torch.round((x1 - ox) / res).clamp(-1, width).to(torch.int32)
        ey = torch.round((y1 - oy) / res).clamp(-1, height).to(torch.int32)
        end_ok = (ex >= 0) & (ex < width) & (ey >= 0) & (ey < height)
        end_lin = (ey * width + ex)[end_ok].long()
        # the endpoint also counts as a visit (Karto updates pass and hit)
        passes.index_add_(0, end_lin, torch.ones_like(end_lin, dtype=torch.int32))
        hits.index_add_(0, end_lin, is_hit[sl][end_ok].to(torch.int32))

    passes = passes.view(height, width)
    hits = hits.view(height, width)
    visited = passes > min_pass_through
    occupied = visited & (
        hits.to(torch.float32) >= OCCUPANCY_THRESHOLD * passes.to(torch.float32)
    ) & (hits > 0)
    image = torch.full((height, width), GRID_UNKNOWN, dtype=torch.uint8, device=dev)
    image[visited] = GRID_FREE
    image[occupied] = GRID_OCCUPIED
    return image


def create_occupancy_grid(scans, resolution=0.05, range_threshold=12.0,
                          min_pass_through=MIN_PASS_THROUGH, *, device=DEFAULT_DEVICE):
    """Render all scans into an occupancy image on `device`; returns an
    OccupancyGrid with the image on the host.  A cell is visited (free or
    occupied) when more than `min_pass_through` beams pass it."""
    device = resolve_device(device)
    if not scans:
        raise ValueError("create_occupancy_grid needs at least one scan")

    origins = []
    ends = []
    hits = []
    for scan in scans:
        p = scan.corrected_pose
        x, y, t = p.x, p.y, p.euler[-1]
        r = np.asarray(scan.ranges, dtype=np.float64)
        n = len(r)
        angles = t + scan.min_angle + np.arange(n) * scan.angle_increment
        ok = np.isfinite(r) & (r > scan.min_range) & (r <= scan.max_range)
        rr = np.where(ok, r, 0.0)
        clipped = np.minimum(rr, range_threshold)
        ex = x + clipped * np.cos(angles)
        ey = y + clipped * np.sin(angles)
        origins.append(np.stack([np.full(n, x), np.full(n, y)], axis=1)[ok])
        ends.append(np.stack([ex, ey], axis=1)[ok])
        hits.append((rr < range_threshold)[ok])

    origins = np.concatenate(origins)
    ends = np.concatenate(ends)
    hits = np.concatenate(hits)

    all_x = np.concatenate([origins[:, 0], ends[:, 0]])
    all_y = np.concatenate([origins[:, 1], ends[:, 1]])
    ox = all_x.min() - resolution
    oy = all_y.min() - resolution
    width = int(np.ceil((all_x.max() - ox) / resolution)) + 2
    height = int(np.ceil((all_y.max() - oy) / resolution)) + 2
    max_steps = int(np.ceil(range_threshold / resolution)) + 2

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    def scalar(v):
        # float32 device scalars: the JAX package rounds them to float32
        # too, and a device divisor keeps division exact on CUDA
        return torch.tensor(v, dtype=torch.float32, device=device)

    image = _render_counts(
        f32(origins[:, 0]), f32(origins[:, 1]), f32(ends[:, 0]), f32(ends[:, 1]),
        torch.as_tensor(hits, device=device), scalar(ox), scalar(oy),
        scalar(resolution), width=width, height=height, max_steps=max_steps,
        min_pass_through=min_pass_through,
    )
    return OccupancyGrid(
        image=image.cpu().numpy(),
        width=width,
        height=height,
        offset=Pose2(float(ox), float(oy), 0.0),
        resolution=resolution,
    )


def occupancy_grid_map_to_correlation_grid(map_im, res, smear_deviation=0.05,
                                           occupied_value=0, *,
                                           device=DEFAULT_DEVICE):
    """Convert a saved occupancy image into a correlation grid: every cell
    equal to `occupied_value` smeared by the matcher's Gaussian max-smear
    at `res`, unquantized.  Returns an (H, W) float32 numpy array, bit-equal
    to the JAX package's function of the same name (float32 taps; the
    occupied cells go through the same world-to-cell rounding)."""
    from yag_slam_tpu_torch.matching import correlation as C

    device = resolve_device(device)
    map_im = np.asarray(map_im)
    occ_y, occ_x = np.where(map_im == occupied_value)
    h, w = map_im.shape[:2]
    taps = torch.as_tensor(
        C.check_smear_taps(C.gaussian_kernel_1d(res, smear_deviation).astype(np.float32)),
        device=device)
    grid = C.build_correlation_grid(
        torch.as_tensor(occ_x.astype(np.float64) * res, device=device),
        torch.as_tensor(occ_y.astype(np.float64) * res, device=device),
        torch.ones(len(occ_x), dtype=torch.bool, device=device), 0.0, 0.0,
        grid_size=max(h, w), res=res, taps=taps,
    )
    return grid[:h, :w].cpu().numpy()
