"""Online graph-SLAM orchestration on the PyTorch matchers.

Counterpart of ``yag_slam_tpu/slam/graph_slam.py`` with the same state
machine: per scan, dead-reckon a pose guess from odometry, match it against
the running-scan window, add the vertex and its edges, search for
loop-closure chains, coarse-match them on the loop matcher and fine-match
the survivors on the sequential matcher, and run SPA on a closure.  Control
flow stays on the host; the matchers run on their device.

The JAX package's two deliberate divergences from the reference are kept:
the fine-response gate rejects (the reference rejects only in verbose
mode), and the chain distance gate compares squared distance with the
squared radius.
"""
from __future__ import annotations

import time
import zlib

import msgpack
import numpy as np
import torch

from yag_slam_tpu.core.config import default_config, default_config_loop
from yag_slam_tpu.core.transform import Pose2, Transform
from yag_slam_tpu_torch.graphopt.graph import (
    Edge,
    Graph,
    LinkLabel,
    RadiusHashSearch,
    Vertex,
    do_breadth_first_traversal,
    scans_dist_squared,
)
from yag_slam_tpu_torch.graphopt.spa import SPA2d
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.slam.serde import _deserialize, _serialize


def make_near_scan_visitor(distance):
    """Predicate for the near-scan graph traversal."""
    distsq = distance**2

    def near_scan_visitor(first_node, current_node):
        return scans_dist_squared(first_node.obj, current_node.obj) < distsq

    return near_scan_visitor


def _config_dict(d):
    return {k: v for k, v in d.items() if k != "___name"}


class GraphSlam:
    """Online 2D graph SLAM (sequential matching + loop closure + SPA)."""

    def __init__(
        self,
        seq_matcher,
        loop_matcher,
        scan_buffer_len=10,
        loop_search_dist=3,
        loop_search_min_chain_size=10,
        min_response_coarse=0.35,
        min_response_fine=0.45,
        verbose=False,
    ):
        self.seq_matcher = seq_matcher
        self.loop_matcher = loop_matcher
        self.scan_buffer_len = scan_buffer_len
        self.graph = Graph()
        self.loop_search_dist = loop_search_dist
        self.loop_search_min_chain_size = loop_search_min_chain_size
        self.near_scan_visitor = make_near_scan_visitor(loop_search_dist)
        self.running_scans = []
        self.opt = SPA2d()
        self.search = RadiusHashSearch([], res=self.loop_search_dist)
        self.min_response_coarse = min_response_coarse
        self.min_response_fine = min_response_fine
        self.verbose = verbose
        self.stats = {
            "scans_processed": 0,
            "loop_closures": 0,
            "loop_chains_tried": 0,
            "opt_runs": 0,
            "opt_time_total": 0.0,
            "match_time_total": 0.0,
        }

    @property
    def device(self):
        return self.seq_matcher.device

    # -- factories -----------------------------------------------------------
    @classmethod
    def default(cls, *, device, dtype=torch.float32, **kwargs):
        """Default sequential + loop matcher configs on `device`."""
        return cls(
            CorrelativeScanMatcher(default_config, device=device, dtype=dtype),
            CorrelativeScanMatcher(default_config_loop, loop=True,
                                   device=device, dtype=dtype),
            **kwargs,
        )

    # -- serialization -------------------------------------------------------
    def serialize(self):
        out = {}
        out["scans"] = [_serialize(v.obj) for v in self.graph.vertices]
        out["edges"] = [
            [e.source.obj.num, e.target.obj.num, _serialize(e.info)]
            for e in self.graph.edges
        ]
        out["running_scans"] = [s.num for s in self.running_scans]
        out["seq_matcher_config"] = _serialize(self.seq_matcher.config)
        out["loop_matcher_config"] = (
            _serialize(self.loop_matcher.config) if self.loop_matcher else None
        )
        out["scan_buffer_len"] = self.scan_buffer_len
        out["loop_search_dist"] = self.loop_search_dist
        out["loop_search_min_chain_size"] = self.loop_search_min_chain_size
        out["min_response_coarse"] = self.min_response_coarse
        out["min_response_fine"] = self.min_response_fine
        return out

    def binarize(self):
        return zlib.compress(msgpack.packb(self.serialize()))

    @classmethod
    def unbinarize(cls, blob, *, device, dtype=torch.float32):
        return cls.deserialize(msgpack.unpackb(zlib.decompress(blob)),
                               device=device, dtype=dtype)

    def to_file(self, path):
        with open(path, "wb") as ff:
            ff.write(self.binarize())

    @classmethod
    def from_file(cls, path, *, device, dtype=torch.float32):
        with open(path, "rb") as ff:
            return cls.unbinarize(ff.read(), device=device, dtype=dtype)

    @classmethod
    def deserialize(cls, d, *, device, dtype=torch.float32):
        """Rebuild from a serialized state (either package's), with port
        matchers on `device`."""
        loop_matcher = (
            CorrelativeScanMatcher(_config_dict(d["loop_matcher_config"]),
                                   device=device, dtype=dtype)
            if d["loop_matcher_config"]
            else None
        )
        obj = cls(
            CorrelativeScanMatcher(_config_dict(d["seq_matcher_config"]),
                                   device=device, dtype=dtype),
            loop_matcher,
            d["scan_buffer_len"],
            d["loop_search_dist"],
            d["loop_search_min_chain_size"],
            d["min_response_coarse"],
            d["min_response_fine"],
        )
        for s in d["scans"]:
            obj.add_vertex(_deserialize(s))

        vs = obj.graph.vertices
        for from_num, to_num, info in d["edges"]:
            new_edge = Edge(vs[from_num], vs[to_num], _deserialize(info))
            obj.graph.add_edge(new_edge)
            diff = new_edge.info.mean
            obj.opt.add_constraint(
                from_num, to_num, diff.x, diff.y, diff.euler[-1],
                np.linalg.inv(np.array(new_edge.info.covariance)).tolist(),
            )

        obj.running_scans = [vs[i].obj for i in d["running_scans"]]
        return obj

    # -- graph construction --------------------------------------------------
    def add_vertex(self, scan):
        vertex = Vertex(scan)
        self.graph.add_vertex(vertex)
        p = vertex.obj.corrected_pose
        self.opt.add_node(p.x, p.y, p.euler[-1], vertex.obj.num)
        self.search.add_new_element(vertex)

    def add_edges(self, scan, covariance):
        last_scan = self.running_scans[-1]
        self.link_scans(last_scan, scan, scan.corrected_pose, covariance)
        if self.loop_matcher:
            self.link_to_closest_scan_in_chain(
                scan, self.running_scans, scan.corrected_pose, covariance
            )

    def link_scans(self, from_scan, to_scan, mean, covariance, supl=None):
        to_vert = self.graph.vertices[to_scan.num]
        from_vert = self.graph.vertices[from_scan.num]
        for edge in from_vert.edges:
            if edge.target is to_vert:
                return  # already linked
        diff = to_scan.corrected_pose - from_scan.corrected_pose
        self.graph.add_edge(Edge(from_vert, to_vert, LinkLabel(diff, covariance)))
        # the optimizer takes the information matrix
        self.opt.add_constraint(
            from_scan.num, to_scan.num, diff.x, diff.y, diff.euler[-1],
            np.linalg.inv(np.array(covariance)).tolist(),
        )

    def link_to_closest_scan_in_chain(self, scan, chain, mean, covariance, supl=None):
        closest = min(chain, key=lambda c: scans_dist_squared(c, scan))
        self.link_scans(closest, scan, mean, covariance, supl)

    # -- loop closure ----------------------------------------------------------
    def find_possible_loop_closure_chains(self, scan):
        """Candidate chains: consecutive-numbered old scans within the loop
        search radius, excluding scans already near-linked to the query."""
        vert = self.graph.vertices[scan.num]
        near_linked = set(do_breadth_first_traversal(vert, self.near_scan_visitor))
        chains = []

        candidates = self.search.crude_radius_search(
            scan.corrected_pose, self.loop_search_dist
        )
        candidates.sort(key=lambda v: v.obj.num)

        dist_gate = self.loop_search_dist**2

        current_chain = []
        # pairwise walk: the last candidate (the query itself) is only seen
        # as v2, as in the reference's zip iteration
        for v1, v2 in zip(candidates, candidates[1:]):
            other_scan = v1.obj
            if other_scan is scan or other_scan in near_linked:
                current_chain = []
                continue
            if scans_dist_squared(scan, other_scan) <= dist_gate:
                current_chain.append(other_scan)
            if len(current_chain) >= self.loop_search_min_chain_size:
                chains.append(current_chain)
                current_chain = []
            if (v2.obj.num - v1.obj.num) > 1:
                current_chain = []

        if current_chain:
            chains.append(current_chain)
        return chains

    def try_to_close_loop(self, scan):
        """Coarse-match every candidate chain in one batch, fine-match the
        survivors in one batch, link the first that passes both gates."""
        if not self.loop_matcher:
            return False

        chains = self.find_possible_loop_closure_chains(scan)
        if chains and self.verbose:
            print(f"Found {len(chains)} chains for loop closure")
        coarse_results = self.loop_matcher.match_many(
            [(scan, chain) for chain in chains], penalty=False, do_fine=False,
        )

        survivors = []
        for chain, res_coarse in zip(chains, coarse_results):
            self.stats["loop_chains_tried"] += 1
            if res_coarse.response < self.min_response_coarse:
                if self.verbose:
                    print("Loop closure coarse response too low: "
                          f"{res_coarse.response} < {self.min_response_coarse}")
                continue
            if res_coarse.covariance[0][0] > 3.0 or res_coarse.covariance[1][1] > 3.0:
                print("WARN: coarse covariance too high during loop closure")
            tmpscan = scan.copy()
            tmpscan.corrected_pose = res_coarse.best_pose
            survivors.append((chain, res_coarse, tmpscan))

        fine_results = self.seq_matcher.match_many(
            [(tmp, chain) for chain, _, tmp in survivors],
            penalty=False, do_fine=True,
        )

        closed = False
        for (chain, res_coarse, tmpscan), res in zip(survivors, fine_results):
            if res.response < self.min_response_fine:
                if self.verbose:
                    print(f"Loop closure fine response too low: {res.response}")
                continue
            scan.corrected_pose = res.best_pose
            self.link_to_closest_scan_in_chain(
                scan, chain, res.best_pose, res.covariance,
                supl={"coarse": res_coarse, "fine": res},
            )
            closed = True
            break

        if closed:
            if self.verbose:
                print("successful loop closure")
            self.stats["loop_closures"] += 1
            self.run_opt()
        return closed

    def run_opt(self):
        begin = time.perf_counter()
        self.opt.compute(100, 1.0e-4, True, 1.0e-9, 50)
        elapsed = time.perf_counter() - begin
        self.stats["opt_runs"] += 1
        self.stats["opt_time_total"] += elapsed
        if self.verbose:
            print(f"opt took {elapsed} seconds")
        for node, vtx in zip(self.opt.nodes, self.graph.vertices):
            vtx.obj.corrected_pose = Transform.from_pose2d(
                Pose2(node.x, node.y, node.yaw)
            )
        self.search.update_all()

    # -- main entry ------------------------------------------------------------
    def process_scan(self, scan):
        """Ingest one scan; returns (match_result, closed_loop), or
        (None, None) for the first scan."""
        query = scan
        self.stats["scans_processed"] += 1

        if len(self.running_scans) == 0:
            query.num = 0
            self.running_scans.append(query)
            self.add_vertex(query)
            return None, None

        last_scan = self.running_scans[-1]
        query.num = last_scan.num + 1

        # dead-reckoned initial guess from odometry
        odom_diff = query.odom_pose - last_scan.odom_pose
        query.corrected_pose = last_scan.corrected_pose + odom_diff

        t0 = time.perf_counter()
        res = self.seq_matcher.match_scan(query, self.running_scans, True, True)
        self.stats["match_time_total"] += time.perf_counter() - t0
        query.corrected_pose = res.best_pose

        closed = self._post_match(query, res)
        return res, closed

    def _post_match(self, query, res):
        """Vertex + edges, loop closure, window update."""
        self.add_vertex(query)
        self.add_edges(query, res.covariance)
        closed = self.try_to_close_loop(query)
        self.running_scans.append(query)
        self.running_scans = self.running_scans[-self.scan_buffer_len:]
        return closed

    # -- mapping ---------------------------------------------------------------
    def make_occupancy_grid(self, resolution=0.05, range_threshold=12):
        from yag_slam_tpu_torch.mapping.occupancy import create_occupancy_grid

        return create_occupancy_grid(
            [v.obj for v in self.graph.vertices], resolution, range_threshold,
            device=self.device,
        )
