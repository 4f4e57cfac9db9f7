"""Lifelong mapping: turn a saved occupancy-grid image back into a pose
graph of synthetic scans, so mapping and localization can go on against
an old map.

Counterpart of ``yag_slam_tpu/splicing/splice.py``, host code around the
port's device modules: segment the free space (k-means, on the device),
take each region's centroid, link regions that share a boundary, trace a
1439-ray synthetic scan from each centroid through the map (on the
device; ranges over 20 m are poisoned), and inject the scans into a
GraphSlam with near-zero-covariance adjacency edges.

The centroids come from one ``np.bincount`` pass over the labels, the edges
from every boundary pixel's window at once, and every centroid's sweep from
one ``trace_sweeps`` call (one kernel launch on the card).
"""
from __future__ import annotations

import numpy as np

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from yag_slam_tpu_torch.core.scan import LocalizedRangeScan
# trace_rays: one start's sweep, kept in this namespace beside the splice's
# batched call (callers and tracers reach it here)
from yag_slam_tpu_torch.mapping.raytrace import trace_rays, trace_sweeps  # noqa: F401
from yag_slam_tpu_torch.splicing.segmentation import (
    open_free_space,
    spatial_segments,
)


def pixel_to_meters(resolution, origin, h, x, y):
    """The reference's image-to-world convention (y axis flipped)."""
    return (x * resolution) + origin[0], ((h - y) * resolution) + origin[1]


def segment_map(imin, verbose=False, density=1, seed=0, *,
                device=DEFAULT_DEVICE):
    """Segment the free space of a map image into spatially compact
    regions (about one per 600k free-pixel mass times `density`, the
    reference's segment count)."""
    device = resolve_device(device)
    im = np.asarray(imin).copy()
    free = im >= 254
    free = open_free_space(free, size=11)
    n_segments = int(free.sum() * 255 // 600000 * density)
    n_segments = max(n_segments, 1)
    return spatial_segments(free, n_segments, seed=seed, device=device)


def determine_centroids(segments):
    """Segment id (0-based) -> (x, y) pixel centroid, for the ids present
    (label 0, no segment, left out; labels are non-negative), in ascending
    order.  The coordinate sums of one bincount pass are exact in float64,
    so each centroid is bit-equal to the mean of its pixels' coordinates."""
    seg = np.asarray(segments)
    labels = seg.ravel()
    h, w = seg.shape
    counts = np.bincount(labels)
    xs = np.bincount(labels, weights=np.tile(np.arange(w, dtype=np.float64), h))
    ys = np.bincount(labels, weights=np.repeat(np.arange(h, dtype=np.float64), w))
    return {int(sid) - 1: (float(xs[sid] / counts[sid]), float(ys[sid] / counts[sid]))
            for sid in np.flatnonzero(counts) if sid}


# the window of a boundary pixel (y, x): rows y-2..y+1, columns x-2..x+1
_WINDOW = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1).reshape(16, 2)


def create_edges(segments, min_shared=4):
    """Region-adjacency edges: segment pairs sharing at least `min_shared`
    boundary pixels, in the order of each pair's first boundary pixel in
    row-major order.

    A pixel is on a boundary where its label differs from the one below or
    to its right; it counts for a pair when the non-zero labels of its
    window ``seg[max(0, y-2):y+2, max(0, x-2):x+2]`` are exactly that pair.
    The windows of all boundary pixels are gathered at once from the label
    image padded with zeros (label 0 counts for no segment)."""
    seg = np.asarray(segments)
    h, w = seg.shape
    boundary = np.zeros(seg.shape, dtype=bool)
    boundary[:-1, :] |= (seg[:-1, :] != seg[1:, :])
    boundary[:, :-1] |= (seg[:, :-1] != seg[:, 1:])
    ys, xs = np.nonzero(boundary)
    padded = np.zeros((h + 3, w + 3), dtype=np.int64)
    padded[2:h + 2, 2:w + 2] = seg
    win = np.sort(padded[ys[:, None] + _WINDOW[:, 0], xs[:, None] + _WINDOW[:, 1]], axis=1)
    new_label = (win != 0) & np.concatenate(
        [np.ones((len(win), 1), dtype=bool), win[:, 1:] != win[:, :-1]], axis=1)
    rows = win[new_label.sum(axis=1) == 2]
    # a sorted row: its zeros, then its smaller label, then its larger
    lo = rows[np.arange(len(rows)), (rows == 0).sum(axis=1)]
    span = int(seg.max(initial=0)) + 1
    keys, first, freq = np.unique(lo * span + rows[:, -1], return_index=True,
                                  return_counts=True)
    shared = freq > min_shared - 1
    pairs = keys[shared][np.argsort(first[shared])]
    return [(int(k // span) - 1, int(k % span) - 1) for k in pairs]


def map_to_graph(map_image, resolution, origin, density=1, *,
                 device=DEFAULT_DEVICE):
    """Synthetic scans (one per free-space region centroid) and adjacency
    edges from a saved map image: a 1439-ray sweep (-180..180 deg at 0.25
    deg, reversed, as the reference zips reversed sweep angles onto
    forward range slots), ranges over 20 m poisoned to 100 (invalid)."""
    device = resolve_device(device)
    im = np.asarray(map_image)
    segments = segment_map(im, density=density, device=device)
    centroid_map = determine_centroids(segments)
    edges = create_edges(segments)
    angles = np.arange(-180, 180, 0.25)[:-1]
    starts = [centroid_map[cm] for cm in range(len(centroid_map))]
    sweeps = trace_sweeps(im, angles[::-1], np.reshape(starts, (-1, 2)), device=device)

    scans = []
    for cm, ((x_px, y_px), lengths) in enumerate(zip(starts, sweeps)):
        ranges = lengths * resolution
        ranges = np.where(ranges > 20.0, 100.0, ranges)
        x, y = pixel_to_meters(resolution, origin, im.shape[0], x_px, y_px)
        scan = LocalizedRangeScan(
            ranges, -np.pi, np.pi - np.deg2rad(0.25), np.deg2rad(0.25),
            0.0, 30.0, 20.0, x, y, 0.0,
        )
        scan.num = cm
        scans.append(scan)
    return scans, edges


def map_to_graphslam(slam, map_image, resolution, origin, density=1, *,
                     device=None):
    """Inject a map image into a GraphSlam as vertices and near-zero-
    covariance adjacency edges; segmentation and raytracing run on
    `device` (default: the SLAM's device).  Isolated regions are dropped
    and the rest renumbered; round-trip the result through
    serialize/deserialize to rebuild the optimizer's indices, as the
    reference's node does."""
    if device is None:
        device = slam.device
    scans, edges = map_to_graph(map_image, resolution, origin, density,
                                device=device)
    scan_map = {s.num: s for s in scans}
    in_edges = set(e[0] for e in edges) | set(e[1] for e in edges)

    for scan in scans:
        slam.add_vertex(scan)
    for frm, to in edges:
        slam.link_scans(
            scan_map[frm], scan_map[to], None, (np.identity(3) * 1e-12)
        )
    slam.graph.vertices = [
        v for v in slam.graph.vertices if v.obj.num in in_edges
    ]
    for ii, v in enumerate(slam.graph.vertices):
        v.obj.num = ii
    return slam
