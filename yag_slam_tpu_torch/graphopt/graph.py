"""Host-side pose-graph bookkeeping (no array framework involved).

A copy of ``yag_slam_tpu/graphopt/graph.py``: that package's ``graphopt``
imports its JAX solver on import, so the port keeps its own copy of these
plain-Python containers (LinkLabel, Vertex, Edge, Graph, breadth-first
traversal, RadiusHashSearch).  Behaviour is identical.

``do_breadth_first_traversal`` is a true BFS; the reference's version pops
from the list end, which visits the same set because its only caller
consumes the result as a set and the predicate depends only on the vertex.
"""
from __future__ import annotations

import math
from collections import deque, namedtuple

import numpy as np

Pose2Key = namedtuple("Pose2Key", ["x", "y"])


class LinkLabel:
    """Edge payload: relative-pose mean (Transform) + 3x3 covariance
    (upstream yag_slam/graph.py:17-20)."""

    def __init__(self, mean, covariance):
        self.mean = mean
        self.covariance = covariance


class Vertex:
    def __init__(self, obj):
        self.obj = obj
        self.edges = []

    def add_edge(self, edge):
        self.edges.append(edge)

    def get_adjacent_vertices(self):
        out = []
        for edge in self.edges:
            if edge.source is not self:
                out.append(edge.source)
            if edge.target is not self:
                out.append(edge.target)
        return out


class Edge:
    def __init__(self, source, target, link_info):
        self.source = source
        self.target = target
        self.info = link_info
        self.source.add_edge(self)
        self.target.add_edge(self)


class Graph:
    def __init__(self):
        self.vertices = []
        self.edges = []

    def add_vertex(self, vertex):
        self.vertices.append(vertex)

    def add_edge(self, edge):
        self.edges.append(edge)

    def as_arrays(self):
        """Flat device view: poses (N,3), edge indices (E,2), edge means
        (E,3), edge covariances (E,3,3) — the optimizer's native input."""
        n = len(self.vertices)
        poses = np.zeros((n, 3))
        for i, v in enumerate(self.vertices):
            p = v.obj.corrected_pose
            poses[i] = (p.x, p.y, p.euler[-1])
        e = len(self.edges)
        idx = np.zeros((e, 2), dtype=np.int32)
        means = np.zeros((e, 3))
        covs = np.zeros((e, 3, 3))
        for i, edge in enumerate(self.edges):
            idx[i] = (edge.source.obj.num, edge.target.obj.num)
            m = edge.info.mean
            means[i] = (m.x, m.y, m.euler[-1])
            covs[i] = np.asarray(edge.info.covariance)
        return poses, idx, means, covs


def do_breadth_first_traversal(start_vert, visit_fn, return_objs=True):
    """Visit vertices reachable from `start_vert`, expanding only through
    vertices for which `visit_fn(start, v)` is true; returns the accepted
    ones (objects by default)."""
    seen = {start_vert}
    valid = []
    queue = deque([start_vert])
    while queue:
        vert = queue.popleft()
        if not visit_fn(start_vert, vert):
            continue
        valid.append(vert)
        for adj in vert.get_adjacent_vertices():
            if adj not in seen:
                seen.add(adj)
                queue.append(adj)
    return [v.obj for v in valid] if return_objs else valid


def poses_dist_squared(p1, p2):
    return (p1.x - p2.x) ** 2 + (p1.y - p2.y) ** 2


def scans_dist_squared(scan1, scan2):
    return poses_dist_squared(scan1.corrected_pose, scan2.corrected_pose)


def scans_dist(scan1, scan2):
    return math.sqrt(scans_dist_squared(scan1, scan2))


class RadiusHashSearch:
    """Cell-hash radius search with the reference's bucket semantics
    (upstream yag_slam/helpers.py:396-431): buckets keyed by
    truncated integer cell, search returns all buckets whose cell-corner
    pose lies within (radius + res) of the query.

    Two scaling upgrades over the reference (VERDICT r3 item 6; result
    sets are identical):

    - ``crude_radius_search`` enumerates only the bounded key window that
      can pass the corner-distance test — O((radius/res)^2) dict lookups
      per query, constant in graph size — instead of scanning every
      bucket (the reference is O(all buckets) per query, which a
      lifelong-mapping graph with 10k+ splice vertices feels on every
      loop-closure search).
    - ``update_all`` re-keys only elements whose pose moved across a cell
      boundary after optimization, instead of rebuilding the hash from
      scratch (the reference rebuilds after every SPA run,
      upstream yag_slam/graph_slam.py:272)."""

    def __init__(self, elements, accessor=lambda v: v.obj.corrected_pose, res=1.0):
        self.res = res
        self.hmap = {}
        self.accessor = accessor
        self._keys = {}    # id(element) -> current key
        self._elems = {}   # id(element) -> element (keeps ids stable)
        for el in elements:
            self.add_new_element(el)

    def pose_to_key(self, p):
        return (int(p.x / self.res), int(p.y / self.res))

    def key_to_pose(self, key):
        return Pose2Key(float(key[0]) * self.res, float(key[1]) * self.res)

    def add_new_element(self, element):
        key = self.pose_to_key(self.accessor(element))
        self.hmap.setdefault(key, []).append(element)
        self._keys[id(element)] = key
        self._elems[id(element)] = element

    def update_element(self, element):
        """Re-bucket one element after its pose changed (no-op unless it
        crossed a cell boundary)."""
        new = self.pose_to_key(self.accessor(element))
        old = self._keys.get(id(element))
        if old == new:
            return
        if old is not None:
            bucket = self.hmap[old]
            bucket.remove(element)
            if not bucket:
                del self.hmap[old]
        self.hmap.setdefault(new, []).append(element)
        self._keys[id(element)] = new

    def update_all(self):
        """Incremental re-key of every element — the post-optimization
        refresh (poses shift by the SPA correction; few cross a cell at
        the loop-search resolution)."""
        for el in list(self._elems.values()):
            self.update_element(el)

    def crude_radius_search(self, start_pose, radius):
        r = radius + self.res
        r2 = r * r
        res = self.res
        x, y = start_pose.x, start_pose.y
        # every key whose corner (k*res) can lie within r of the query —
        # same acceptance test as the reference's scan over all keys
        kx0 = int(math.floor((x - r) / res))
        kx1 = int(math.floor((x + r) / res)) + 1
        ky0 = int(math.floor((y - r) / res))
        ky1 = int(math.floor((y + r) / res)) + 1
        out = []
        hmap = self.hmap
        for kx in range(kx0, kx1 + 1):
            dx2 = (kx * res - x) ** 2
            for ky in range(ky0, ky1 + 1):
                if dx2 + (ky * res - y) ** 2 < r2:
                    elements = hmap.get((kx, ky))
                    if elements:
                        out.extend(elements)
        return out
