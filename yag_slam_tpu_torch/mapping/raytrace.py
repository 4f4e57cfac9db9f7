"""Raytracing over a saved occupancy-grid image (the lifelong-mapping path).

Counterpart of ``yag_slam_tpu/mapping/raytrace.py`` (plain XLA there, one
program a start, no Pallas kernel).  The behaviour is the reference's ray
marcher: 1-pixel steps along the ray; a pixel value < 210 stops the ray
after one more step; a stopping value in (180, 210) is unknown space and
throws the endpoint 1000 px further (so synthetic scans ignore it); the ray
also stops when the next position leaves the 1-px interior border.

:func:`sweep` marches every ray of every start at once.  Dispatch goes by
the device of the tensors, as in ``mapping/render_kernel.py``: CPU tensors
run the plain version :func:`trace_sweeps_ref`; CUDA tensors launch the
hand-written kernel of ``csrc/sweep.cu`` or raise.  Nothing falls back from
CUDA to the plain version.  :func:`trace_sweeps` (the splice's call: all
starts, one copy up and one back) and :func:`trace_rays` (one start) take
numpy arrays and a device.

``LAUNCHES`` counts the kernel's launches, apart from the matcher's
``matching.kernels.LAUNCHES``.
"""
from __future__ import annotations

import numpy as np
import torch

from yag_slam_tpu_torch import _build
from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from yag_slam_tpu_torch.matching.kernels import _check, _on_cuda, _require, _stream

LAUNCHES = {"splice_sweep": 0}

# The wrapper's CUDA source, what it replaces in the JAX package ("file:line"
# of the def; plain XLA there, not Pallas) and its kernel's name in a
# profiler trace.
KERNELS = {
    "splice_sweep": dict(source="yag_slam_tpu_torch/csrc/sweep.cu",
                         replaces="yag_slam_tpu/mapping/raytrace.py:25",
                         symbols=("sweep_kernel",)),
}

# (start, angle, step) samples the plain version takes at a time; bounds
# its temporaries
_SAMPLE_CHUNK = 1 << 22


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def first_events(img, cos, sin, starts, max_steps: int):
    """Every ray's first stop event and whether it poisons: (S, A) int64
    step and bool, by the plain version's gather of all its samples."""
    h, w = img.shape
    dev = img.device
    k = torch.arange(max_steps, dtype=torch.float32, device=dev)
    ck = cos[:, None] * k[None, :]              # (A, max_steps)
    sk = sin[:, None] * k[None, :]
    S, A = starts.shape[0], cos.shape[0]
    first = torch.empty((S, A), dtype=torch.int64, device=dev)
    poison = torch.empty((S, A), dtype=torch.bool, device=dev)
    last = torch.ones((1, A, 1), dtype=torch.bool, device=dev)
    chunk = max(1, _SAMPLE_CHUNK // max(1, A * max_steps))
    for s0 in range(0, S, chunk):
        st = starts[s0:s0 + chunk]
        px = st[:, 0, None, None] + ck[None]     # (chunk, A, max_steps) at step k
        py = st[:, 1, None, None] + sk[None]
        xi = torch.round(px).to(torch.int32)     # half to even, as jnp.round
        yi = torch.round(py).to(torch.int32)
        vals = img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]

        # stop events in the reference's order: a value stop is read at
        # step k (the ray ends at k+1); a border stop at step k+1 (the ray
        # ends there, its value unread)
        val_stop = vals < 210
        out_border = (yi < 1) | (xi < 1) | (xi >= w - 1) | (yi >= h - 1)
        border_next = torch.cat([out_border[..., 1:], last.expand(st.shape[0], A, 1)], dim=2)
        event = val_stop | border_next
        # first event per ray; the padded last column is always one
        f = event.to(torch.uint8).argmax(dim=2)
        val_at = vals.gather(2, f[..., None])[..., 0]
        stopped_on_value = val_stop.gather(2, f[..., None])[..., 0]
        first[s0:s0 + chunk] = f
        poison[s0:s0 + chunk] = stopped_on_value & (val_at > 180) & (val_at < 210)
    return first, poison


def trace_sweeps_ref(img, cos, sin, starts, max_steps: int, *, ends: bool = False):
    """Plain version of :func:`sweep`: all (start, angle, step) samples,
    chunked over the starts, and the first event of each ray by an argmax."""
    first, poison = first_events(img, cos, sin, starts, max_steps)
    sx, sy = starts[:, 0, None], starts[:, 1, None]
    # the endpoint is the position at step first+1 (the reference steps
    # once past the stopping pixel), 1000 px further when poisoned
    dist = (first + 1).to(torch.float32) + torch.where(poison, 1000.0, 0.0)
    ex = sx + cos[None, :] * dist
    ey = sy + sin[None, :] * dist
    length = torch.sqrt((ex - sx) ** 2 + (ey - sy) ** 2)
    return (length, ex, ey) if ends else length


def sweep(img, cos, sin, starts, max_steps: int, *, ends: bool = False):
    """(S, A) float32 lengths in pixels of the rays from each start along
    each angle through `img`; with `ends`, also their end x and end y.

    img: (H, W) float32; cos, sin: (A,) float32, the angles' cosines and
    sines; starts: (S, 2) float32 ``[x, y]`` pixel positions.  A ray's step
    k samples ``start + (cos, sin) * k`` (a product and a sum, each rounded
    in float32) at the pixel it rounds to, half to even; see the module
    note and csrc/sweep.cu for its stop events.

    Replaces the JAX package's _trace_rays_device, one program a start,
    with one launch for all of them: a thread a ray reads its next 24
    steps at once and tests them in order, and a chunk whose ends lie
    inside the border skips the border tests (csrc/sweep.cu).  On the card
    the kernel takes max_steps <= 2^24, sides below 2^22 pixels and fewer
    than 2^31 pixels and rays, and raises past them.
    """
    if not _on_cuda(img, cos, sin, starts):
        return trace_sweeps_ref(img, cos, sin, starts, max_steps, ends=ends)
    H, W = img.shape
    A, S = cos.shape[0], starts.shape[0]
    _require(img, torch.float32, (H, W), "img")
    _require(cos, torch.float32, (A,), "cos")
    _require(sin, torch.float32, (A,), "sin")
    _require(starts, torch.float32, (S, 2), "starts")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    out = [torch.empty((S, A), dtype=torch.float32, device=img.device)
           for _ in range(3 if ends else 1)]
    if out[0].numel() == 0:
        return tuple(out) if ends else out[0]
    ex, ey = (out[1].data_ptr(), out[2].data_ptr()) if ends else (None, None)
    err = _build.library().yag_sweep(
        img.data_ptr(), H, W, cos.data_ptr(), sin.data_ptr(), A, starts.data_ptr(), S,
        max_steps, out[0].data_ptr(), ex, ey, _stream(img))
    LAUNCHES["splice_sweep"] += 1
    _check(err, "splice_sweep")
    return tuple(out) if ends else out[0]


def _upload(img, angles_deg, starts, device):
    """The image, the angles in radians (rounded to float32 from float64)
    and the starts (float32) as one float32 buffer, copied to `device` in
    one copy; returns the image, cos, sin and starts on the device and the
    sweep's max_steps (the image's diagonal, plus 2)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    angles = np.deg2rad(np.asarray(angles_deg, dtype=np.float64)).astype(np.float32)
    starts = np.asarray(starts, dtype=np.float64).reshape(-1, 2).astype(np.float32)
    A = angles.shape[0]
    buf = torch.as_tensor(np.concatenate(
        [img.astype(np.float32).ravel(), angles, starts.ravel()]), device=device)
    angles_t = buf[h * w:h * w + A]
    return (buf[:h * w].view(h, w), torch.cos(angles_t), torch.sin(angles_t),
            buf[h * w + A:].view(-1, 2), int(np.ceil(np.hypot(h, w))) + 2)


def trace_sweeps(img, angles_deg, starts, *, device=DEFAULT_DEVICE):
    """Sweeps of rays from every pixel start (S, 2) ``[x, y]`` along every
    angle (degrees) through `img` on `device`, the image copied up once and
    the lengths back once: (S, A) float32 lengths in pixels, row s the
    sweep from start s."""
    device = resolve_device(device)
    img_t, c, s, st, max_steps = _upload(img, angles_deg, starts, device)
    return sweep(img_t, c, s, st, max_steps).cpu().numpy()


def trace_rays(img, angles_deg, sx, sy, *, device=DEFAULT_DEVICE):
    """Sweep of rays from pixel (sx, sy) on `device`; returns (end_x, end_y,
    length_px) float32 numpy arrays."""
    device = resolve_device(device)
    img_t, c, s, st, max_steps = _upload(img, angles_deg, [float(sx), float(sy)], device)
    ln, ex, ey = torch.stack(sweep(img_t, c, s, st, max_steps, ends=True))[:, 0].cpu().numpy()
    return ex, ey, ln


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
