"""Lifelong mapping: turn a saved occupancy-grid image back into a pose
graph of synthetic scans, so mapping and localization can go on against
an old map.

Counterpart of ``yag_slam_tpu/splicing/splice.py``, host code around the
port's device modules: segment the free space (k-means, on the device),
take each region's centroid, link regions that share a boundary, trace a
1439-ray synthetic scan from each centroid through the map (on the
device; ranges over 20 m are poisoned), and inject the scans into a
GraphSlam with near-zero-covariance adjacency edges.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from yag_slam_tpu_torch.core.scan import LocalizedRangeScan
from yag_slam_tpu_torch.mapping.raytrace import trace_rays
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
    """Segment id (0-based) -> (x, y) pixel centroid."""
    centroid_map = {}
    for sid in np.unique(segments):
        if sid == 0:
            continue
        yvals, xvals = np.nonzero(segments == sid)
        centroid_map[sid - 1] = (float(np.mean(xvals)), float(np.mean(yvals)))
    return centroid_map


def create_edges(segments, min_shared=4):
    """Region-adjacency edges: segment pairs sharing at least `min_shared`
    boundary pixels."""
    seg = np.asarray(segments)
    boundary = np.zeros(seg.shape, dtype=bool)
    boundary[:-1, :] |= (seg[:-1, :] != seg[1:, :])
    boundary[:, :-1] |= (seg[:, :-1] != seg[:, 1:])
    counts = defaultdict(int)
    for y, x in zip(*np.nonzero(boundary)):
        window = seg[max(0, y - 2) : y + 2, max(0, x - 2) : x + 2]
        uniques = sorted(int(u) - 1 for u in np.unique(window) if u)
        if len(uniques) == 2:
            counts[tuple(uniques)] += 1
    return [pair for pair, freq in counts.items() if freq > min_shared - 1]


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

    scans = []
    for cm in range(len(centroid_map)):
        x_px, y_px = centroid_map[cm]
        _, _, lengths = trace_rays(im, angles[::-1], x_px, y_px, device=device)
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
