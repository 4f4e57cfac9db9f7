"""Raytracing over a saved occupancy-grid image (the lifelong-mapping path),
in plain PyTorch on a device.

Counterpart of ``yag_slam_tpu/mapping/raytrace.py`` (plain XLA there too,
no Pallas kernel).  The behaviour is the reference's ray marcher: 1-pixel
steps along the ray; a pixel value < 210 stops the ray after one more
step; a stopping value in (180, 210) is unknown space and throws the
endpoint 1000 px further (so synthetic scans ignore it); the ray also
stops when the next position leaves the 1-px interior border.

All (ray, step) sample positions are made at once as an (A, max_steps)
float32 tensor, the image is gathered once, and the first stop event per
ray is the argmax of the event mask: a few launches per sweep.
"""
from __future__ import annotations

import numpy as np
import torch

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device


def _trace_rays(img, angles_rad, sx: float, sy: float, max_steps: int):
    """img (H, W) float32, angles (A,) float32 -> end_x, end_y, length."""
    h, w = img.shape
    c = torch.cos(angles_rad)
    s = torch.sin(angles_rad)
    k = torch.arange(max_steps, dtype=torch.float32, device=img.device)
    px = sx + c[:, None] * k[None, :]          # (A, S) position at step k
    py = sy + s[:, None] * k[None, :]
    xi = torch.round(px).to(torch.int32)       # half to even, as jnp.round
    yi = torch.round(py).to(torch.int32)
    vals = img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]

    # stop events in the reference's order: a value stop is read at step k
    # (the ray ends at k+1); a border stop at step k+1 (the ray ends
    # there, its value unread)
    val_stop = vals < 210
    out_border = (yi < 1) | (xi < 1) | (xi >= w - 1) | (yi >= h - 1)
    border_next = torch.cat(
        [out_border[:, 1:],
         torch.ones((out_border.shape[0], 1), dtype=torch.bool, device=img.device)],
        dim=1,
    )
    event = val_stop | border_next
    # first event per ray; the padded last column is always one
    first = event.to(torch.uint8).argmax(dim=1)

    val_at = vals.gather(1, first[:, None])[:, 0]
    stopped_on_value = val_stop.gather(1, first[:, None])[:, 0]
    poison = stopped_on_value & (val_at > 180) & (val_at < 210)
    # the endpoint is the position at step first+1 (the reference steps
    # once past the stopping pixel), 1000 px further when poisoned
    dist = (first + 1).to(torch.float32) + torch.where(poison, 1000.0, 0.0)
    ex = sx + c * dist
    ey = sy + s * dist
    length = torch.sqrt((ex - sx) ** 2 + (ey - sy) ** 2)
    return ex, ey, length


def trace_rays(img, angles_deg, sx, sy, *, device=DEFAULT_DEVICE):
    """Sweep of rays from pixel (sx, sy) on `device`; returns (end_x, end_y,
    length_px) float32 numpy arrays."""
    device = resolve_device(device)
    img = np.asarray(img)
    h, w = img.shape[:2]
    max_steps = int(np.ceil(np.hypot(h, w))) + 2
    angles = np.deg2rad(np.asarray(angles_deg, dtype=np.float64)).astype(np.float32)
    ex, ey, ln = _trace_rays(
        torch.as_tensor(img.astype(np.float32), device=device),
        torch.as_tensor(angles, device=device),
        float(sx), float(sy), max_steps,
    )
    return ex.cpu().numpy(), ey.cpu().numpy(), ln.cpu().numpy()


class _Ray:
    __slots__ = ("end_x", "end_y", "length")

    def __init__(self, ex, ey, ln):
        self.end_x = ex
        self.end_y = ey
        self.length = ln


def run_raytracing_sweep(img, angles_deg, sx, sy, *, device=DEFAULT_DEVICE):
    """Reference-shaped API: a list of objects with .end_x, .end_y and
    .length (pixels), one per angle."""
    ex, ey, ln = trace_rays(img, angles_deg, sx, sy, device=device)
    return [_Ray(float(a), float(b), float(c)) for a, b, c in zip(ex, ey, ln)]
