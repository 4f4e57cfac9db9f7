"""The map render's two device stages, each beside its plain PyTorch twin.

:func:`mapping.occupancy.create_occupancy_grid` runs them in order: the
beams' endpoints and the bounding box (:func:`beam_endpoints`), then, once
the host has sized the grid from the box, the traced counts classified
into the image (:func:`beam_image`).  :func:`beam_counts` is the trace
alone, the passes and hits, from the same launch in its counts mode.
Dispatch goes by the device of the tensors, as in ``matching/kernels.py``:
CPU tensors run the plain version (``*_ref``); CUDA tensors launch the
hand-written kernel of ``csrc/render.cu`` or raise.  Nothing falls back
from CUDA to the plain version.

The plain versions do the kernels' arithmetic operation for operation and
never wait for the card: cells outside the grid go to a dump slot past its
end, not through a boolean compaction.

``LAUNCHES`` counts the kernel launches per wrapper, apart from the
matcher's ``matching.kernels.LAUNCHES``; the image and the counts both
count under ``render_counts``.
"""
from __future__ import annotations

import torch

from yag_slam_tpu_torch import _build
from yag_slam_tpu_torch.mapping.occupancy import (
    GRID_FREE, GRID_OCCUPIED, GRID_UNKNOWN, OCCUPANCY_THRESHOLD)
from yag_slam_tpu_torch.matching.kernels import _check, _on_cuda, _require, _stream

LAUNCHES = {"render_endpoints": 0, "render_counts": 0}

# Per wrapper: its CUDA source, what it replaces in the JAX package
# ("file:line" of the def; plain numpy and XLA there, not Pallas), and its
# kernels' names in a profiler trace.
_JAX = "yag_slam_tpu/mapping/occupancy.py"
KERNELS = {
    "render_endpoints": dict(source="yag_slam_tpu_torch/csrc/render.cu",
                             replaces=f"{_JAX}:122", symbols=("render_endpoints_kernel",)),
    "render_counts": dict(source="yag_slam_tpu_torch/csrc/render.cu",
                          replaces=f"{_JAX}:53",
                          symbols=("render_trace_kernel", "render_merge_kernel")),
}

# the table's columns, one row a scan
COLS = ("x", "y", "yaw", "min_angle", "angle_increment", "min_range", "max_range",
        "first_beam")

# beams the plain trace takes at a time; bounds its (beams, steps)
# temporaries
_BEAM_CHUNK = 8192

_VALID, _HIT = 1, 2

# blocks of the endpoints kernel at most (256 beams each: 1 M beams in one
# round, a grid-stride loop past that), and the partial boxes its scratch
# holds
END_MAX_BLOCKS = 4096
# the endpoints kernel's scratch per (device, stream); see _end_scratch
_END_SCRATCH = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Beam endpoints and the bounding box
# ---------------------------------------------------------------------------

def beam_endpoints_ref(table, ranges, range_threshold: float):
    """Plain version of :func:`beam_endpoints` (float64, numpy's order)."""
    dev = table.device
    first = table[:, 7].to(torch.int64)
    beam = torch.arange(ranges.shape[0], device=dev)
    scan = torch.searchsorted(first, beam, right=True) - 1
    x, y, yaw, a0, inc, rmin, rmax = (table[:, c][scan] for c in range(7))
    angle = (yaw + a0) + (beam - first[scan]).to(torch.float64) * inc
    ok = torch.isfinite(ranges) & (ranges > rmin) & (ranges <= rmax)
    rr = torch.where(ok, ranges, 0.0)
    clipped = torch.clamp(rr, max=range_threshold)
    ex = x + clipped * torch.cos(angle)
    ey = y + clipped * torch.sin(angle)
    seg = torch.stack([x, y, ex, ey], dim=1).to(torch.float32)
    flag = ok.to(torch.uint8) * _VALID + (ok & (rr < range_threshold)).to(torch.uint8) * _HIT
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    box = torch.stack([
        torch.where(ok, torch.minimum(x, ex), inf).min(),
        torch.where(ok, torch.minimum(y, ey), inf).min(),
        torch.where(ok, torch.maximum(x, ex), -inf).max(),
        torch.where(ok, torch.maximum(y, ey), -inf).max(),
    ]) if ranges.shape[0] else torch.stack([inf, inf, -inf, -inf])
    return seg, flag, box


def _end_scratch(t):
    """The endpoints kernel's scratch on t's device and current stream:
    float64 (1 + 4 * END_MAX_BLOCKS,), a uint32 counter in its first word
    and a partial box a block after it, zeroed when first made here and
    kept; each launch's last block sets the counter back to 0.  Kernels on
    one stream run one after the other, so no two launches share a scratch
    at once: ThreadedOnlineMapper's map thread, the one that renders, and
    its worker both queue on the device's current stream, and a caller on
    another stream gets a scratch of its own."""
    key = (t.device, _stream(t))
    buf = _END_SCRATCH.get(key)
    if buf is None:
        buf = _END_SCRATCH.setdefault(key, torch.zeros(
            1 + 4 * END_MAX_BLOCKS, dtype=torch.float64, device=t.device))
    return buf


def beam_endpoints(table, ranges, range_threshold: float):
    """Every beam's endpoint, its flag and the bounding box of the beams.

    table: (k, 8) float64, one row a scan with the columns of ``COLS``
    (``first_beam``: where the scan's beams start in `ranges`, ascending
    from 0); ranges: (B,) float64, every scan's ranges in turn.  A beam is
    valid when its range is finite, above min_range and at most max_range;
    its end lies min(range, range_threshold) along
    ``yaw + min_angle + i * angle_increment`` (i: its index in its scan),
    and it is a hit when valid and its range is below range_threshold.

    Returns seg (B, 4) float32 ``[x0, y0, x1, y1]`` (origin and end, each
    computed in float64 and rounded once), flag (B,) uint8 (1 valid, 2 hit)
    and box (4,) float64 ``[min x, min y, max x, max y]`` over the valid
    beams' origins and ends (``inf`` / ``-inf`` when no beam is valid).

    The numpy loop over the scans in the JAX package's
    create_occupancy_grid, as one launch: a thread a beam, its scan found
    by a binary search of the first beams, the box folded from a partial a
    block by the last block to finish (csrc/render.cu).
    """
    if not _on_cuda(table, ranges):
        return beam_endpoints_ref(table, ranges, range_threshold)
    k, B = table.shape[0], ranges.shape[0]
    _require(table, torch.float64, (k, len(COLS)), "table")
    _require(ranges, torch.float64, (B,), "ranges")
    if k == 0:
        raise ValueError("beam_endpoints needs at least one scan")
    dev = table.device
    seg = torch.empty((B, 4), dtype=torch.float32, device=dev)
    flag = torch.empty(B, dtype=torch.uint8, device=dev)
    box = torch.empty(4, dtype=torch.float64, device=dev)
    err = _build.library().yag_render_endpoints(
        table.data_ptr(), ranges.data_ptr(), k, B, range_threshold, seg.data_ptr(),
        flag.data_ptr(), _end_scratch(table).data_ptr(), END_MAX_BLOCKS, box.data_ptr(),
        _stream(table))
    LAUNCHES["render_endpoints"] += 1
    _check(err, "render_endpoints")
    return seg, flag, box


# ---------------------------------------------------------------------------
# The DDA counts
# ---------------------------------------------------------------------------

def beam_counts_ref(seg, flag, ox: float, oy: float, res: float, width: int,
                    height: int, max_steps: int):
    """Plain version of :func:`beam_counts` (same float32 operations)."""
    dev = seg.device
    size = width * height
    # the scalars as float32 device tensors: a device divisor keeps the
    # division exact on CUDA
    ox, oy, res = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (ox, oy, res))
    counts = torch.zeros((2, size + 1), dtype=torch.int32, device=dev)   # + a dump slot
    passes, hits = counts[0], counts[1]
    k = torch.arange(max_steps, dtype=torch.float32, device=dev)
    ones = torch.ones(_BEAM_CHUNK * max_steps, dtype=torch.int32, device=dev)

    def cells(p, o, lim):
        return torch.round((p - o) / res).clamp(-1, lim).to(torch.int32)

    for b0 in range(0, seg.shape[0], _BEAM_CHUNK):
        x0, y0, x1, y1 = seg[b0:b0 + _BEAM_CHUNK].unbind(1)
        f = flag[b0:b0 + _BEAM_CHUNK]
        valid = (f & _VALID) > 0
        dx = x1 - x0
        dy = y1 - y0
        adx = torch.abs(dx) / res
        ady = torch.abs(dy) / res
        n_steps = torch.ceil(torch.maximum(adx, ady)).clamp(0, max_steps).to(torch.int32)
        inv = 1.0 / torch.clamp(n_steps.to(torch.float32), min=1.0)
        # positions strictly before the endpoint cell: k/n_steps for k<n_steps
        t = k[None, :] * inv[:, None]
        cx = cells(x0[:, None] + dx[:, None] * t, ox, width)
        cy = cells(y0[:, None] + dy[:, None] * t, oy, height)
        step_ok = (valid[:, None] & (k[None, :] < n_steps[:, None].to(torch.float32))
                   & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height))
        lin = torch.where(step_ok, cy * width + cx, size).view(-1).long()
        passes.index_add_(0, lin, ones[:lin.shape[0]])

        ex, ey = cells(x1, ox, width), cells(y1, oy, height)
        end_ok = valid & (ex >= 0) & (ex < width) & (ey >= 0) & (ey < height)
        end_lin = torch.where(end_ok, ey * width + ex, size).long()
        # the endpoint also counts as a visit (Karto updates pass and hit)
        passes.index_add_(0, end_lin, ones[:end_lin.shape[0]])
        hits.index_add_(0, end_lin, ((f & _HIT) > 0).to(torch.int32))
    return counts[:, :size].reshape(2, height, width)


def _trace(seg, flag, ox, oy, res, width, height, max_steps, min_pass_through, image):
    """One launch of yag_render_trace: into `image` (image mode), or, with
    image None, into the counts it returns (counts mode)."""
    B = seg.shape[0]
    _require(seg, torch.float32, (B, 4), "seg")
    _require(flag, torch.uint8, (B,), "flag")
    # the counts, and behind them in the same allocation the column-major
    # scratch of the beams longer in y
    buf = torch.empty((3, height, width), dtype=torch.int32, device=seg.device)
    counts = buf[:2]
    if counts.numel() == 0:
        return counts
    err = _build.library().yag_render_trace(
        seg.data_ptr(), flag.data_ptr(), B, ox, oy, res, width, height, max_steps,
        counts.data_ptr(), buf[2].data_ptr(), min_pass_through,
        None if image is None else image.data_ptr(), _stream(seg))
    LAUNCHES["render_counts"] += 1
    _check(err, "render_counts")
    return counts


def beam_counts(seg, flag, ox: float, oy: float, res: float, width: int, height: int,
                max_steps: int):
    """(2, height, width) int32: passes and hits of every cell.

    seg, flag: :func:`beam_endpoints`' beams; ox, oy, res: the grid's
    origin and resolution, float32 values.  Each valid beam counts a pass
    at each of its ``n = min(ceil(max(|dx|, |dy|) / res), max_steps)``
    steps ``k < n`` at ``x0 + dx * (k * (1 / n))``, strictly before its
    endpoint's cell, then a pass at its endpoint, and a hit there when it
    is a hit; a cell is ``round((p - o) / res)``, half to even, and cells
    outside the grid count nowhere.

    Replaces the JAX package's _render_counts' (beams, steps) arrays and
    their scatter-adds: a warp a beam, its lanes over the beam's steps,
    each run of lanes on one cell adding its length into the int32 counts
    with one atomicAdd (exact in any order); a beam longer in y than in x
    counts its passes into a column-major scratch, added into the passes
    by the merge kernel, so that a warp's adds fall on consecutive
    addresses either way (csrc/render.cu, counts mode).
    """
    if not _on_cuda(seg, flag):
        return beam_counts_ref(seg, flag, ox, oy, res, width, height, max_steps)
    return _trace(seg, flag, ox, oy, res, width, height, max_steps, 0, None)


# ---------------------------------------------------------------------------
# The image
# ---------------------------------------------------------------------------

def classify_cells_ref(counts, min_pass_through: int):
    """(H, W) uint8 image of (2, H, W) int32 passes and hits: a cell with
    more than `min_pass_through` passes is free, or occupied when it has a
    hit and ``hits >= 0.1 * passes`` in float32; every other cell is
    unknown (the JAX package's _render_counts' last step)."""
    passes, hits = counts[0], counts[1]
    visited = passes > min_pass_through
    occupied = visited & (
        hits.to(torch.float32) >= OCCUPANCY_THRESHOLD * passes.to(torch.float32)
    ) & (hits > 0)

    def value(v):
        return torch.tensor(v, dtype=torch.uint8, device=counts.device)

    return torch.where(occupied, value(GRID_OCCUPIED),
                       torch.where(visited, value(GRID_FREE), value(GRID_UNKNOWN)))


def beam_image_ref(seg, flag, ox: float, oy: float, res: float, width: int, height: int,
                   max_steps: int, min_pass_through: int):
    """Plain version of :func:`beam_image`."""
    return classify_cells_ref(
        beam_counts_ref(seg, flag, ox, oy, res, width, height, max_steps), min_pass_through)


def beam_image(seg, flag, ox: float, oy: float, res: float, width: int, height: int,
               max_steps: int, min_pass_through: int):
    """(height, width) uint8 image of the beams: :func:`beam_counts`' passes
    and hits classified by :func:`classify_cells_ref`'s rule (occupied 0,
    unknown 200, free 255).  The JAX package's _render_counts whole, as one
    launch of the trace in image mode: the merge kernel that adds the
    column-major passes classifies each cell as it goes, so the passes are
    never written back and no kernel reads them again (csrc/render.cu)."""
    if not _on_cuda(seg, flag):
        return beam_image_ref(seg, flag, ox, oy, res, width, height, max_steps,
                              min_pass_through)
    image = torch.empty((height, width), dtype=torch.uint8, device=seg.device)
    _trace(seg, flag, ox, oy, res, width, height, max_steps, min_pass_through, image)
    return image
