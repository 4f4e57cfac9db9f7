"""Occupancy-grid rendering from scans, on the device.

Counterpart of ``yag_slam_tpu/mapping/occupancy.py`` with the same value
contract (occupied=0, unknown=200, free=255) and OpenKarto's rule: every
beam marks free cells from the sensor to min(range, range_threshold),
beams shorter than the threshold also mark a hit at the endpoint, and a
cell with more than MIN_PASS_THROUGH visits is occupied when
hits >= 0.1 * passes.  The trace is one dominant-axis DDA step per
(beam, step) pair; endpoints are float64 and positions float32 as in the
JAX package.

A render is one pass over the scans on the host, gathering their poses,
beam layouts and ranges into one float64 table, one copy of it to the
device, and the two stages of :mod:`mapping.render_kernel` there, one
launch each (hand written CUDA on a card, ``csrc/render.cu``: the beams'
endpoints and box, then the trace with the image in its merge; their
plain PyTorch twins on the CPU).  The host waits for the card twice: for the bounding box, which
sizes the grid, and for the image.  Converting a saved map into a
correlation grid (:func:`occupancy_grid_map_to_correlation_grid`) runs
the matcher's scatter_cells and smear_grid kernels on CUDA.
"""
from __future__ import annotations

import math
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


@dataclass
class OccupancyGrid:
    image: np.ndarray  # (H, W) uint8; row 0 at offset.y (lower-left origin)
    width: int
    height: int
    offset: Pose2
    resolution: float


def _gather(scans, device):
    """One pass over the scans: their table (k, 8) float64, one row
    ``render_kernel.COLS`` a scan (the pose [x, y, yaw] first), and every
    scan's ranges after it, in one host buffer (pinned for a card) copied
    to `device` at once.  Returns the (table, ranges) views on `device`."""
    rows, ranges, n = [], [], 0
    for scan in scans:
        p = scan.corrected_pose
        r = scan.ranges
        rows += (p.x, p.y, p.yaw, scan.min_angle, scan.angle_increment, scan.min_range,
                 scan.max_range, n)
        ranges.append(r)
        n += len(r)
    k = len(ranges)
    buf = torch.empty(8 * k + n, dtype=torch.float64, pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:8 * k] = rows
    np.concatenate(ranges, out=host[8 * k:])
    buf = buf.to(device, non_blocking=True)
    return buf[:8 * k].view(k, 8), buf[8 * k:]


def _render_counts(table, ranges, resolution, range_threshold, min_pass_through):
    """All of a render's device work, from the gathered table to the image
    on the host: the beams' endpoints and box, the one wait for the box,
    the grid sized from it as the JAX package sizes it, and the image
    traced and classified in one launch.  Returns (image (H, W) uint8, ox,
    oy, width, height)."""
    from yag_slam_tpu_torch.mapping import render_kernel as R

    seg, flag, box = R.beam_endpoints(table, ranges, range_threshold)
    ox, oy, width, height, max_steps = _frame(box.tolist(), resolution, range_threshold)
    image = R.beam_image(seg, flag, *_f32(ox, oy, resolution), width, height, max_steps,
                         min_pass_through)
    return image.cpu().numpy(), ox, oy, width, height


def _frame(box, resolution, range_threshold):
    """The grid of the beams' box [min x, min y, max x, max y] (float64):
    (ox, oy, width, height, max_steps), one cell and a margin around the
    beams, as the JAX package sizes it."""
    minx, miny, maxx, maxy = box
    if not all(map(math.isfinite, box)):
        raise ValueError(f"create_occupancy_grid: no valid beam to bound the grid (box {box})")
    ox = minx - resolution
    oy = miny - resolution
    width = int(np.ceil((maxx - ox) / resolution)) + 2
    height = int(np.ceil((maxy - oy) / resolution)) + 2
    max_steps = int(np.ceil(range_threshold / resolution)) + 2
    return ox, oy, width, height, max_steps


def _f32(*values):
    """The values rounded to float32, as Python floats: the grid's scalars
    (the JAX package rounds them to float32 too)."""
    return [float(np.float32(v)) for v in values]


def create_occupancy_grid(scans, resolution=0.05, range_threshold=12.0,
                          min_pass_through=MIN_PASS_THROUGH, *, device=DEFAULT_DEVICE):
    """Render all scans into an occupancy image on `device`; returns an
    OccupancyGrid with the image on the host.  A cell is visited (free or
    occupied) when more than `min_pass_through` beams pass it."""
    device = resolve_device(device)
    if not scans:
        raise ValueError("create_occupancy_grid needs at least one scan")
    table, ranges = _gather(scans, device)
    image, ox, oy, width, height = _render_counts(
        table, ranges, resolution, range_threshold, min_pass_through)
    return OccupancyGrid(
        image=image,
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
