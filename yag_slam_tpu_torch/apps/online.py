"""ROS-free online mapping front end on the port.

Counterpart of ``yag_slam_tpu/apps/online.py``: the reference node's
behaviour as a plain library (motion gating, the scan-queue worker, map
rendering with the node's value remap and despeckling, the map->odom
transform, checkpoints, and the base-map splice bootstrap), with its
matchers on one torch device.  Nothing here imports ROS or JAX.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from yag_slam_tpu_torch.core.scan import LocalizedRangeScan
from yag_slam_tpu_torch.core.transform import Transform
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
from yag_slam_tpu_torch.splicing.splice import map_to_graphslam

# the reference node's parameter defaults
DEFAULT_SEQ_CONFIG = {
    "angle_variance_penalty": 0.349,
    "distance_variance_penalty": 0.3,
    "coarse_search_angle_offset": 0.349,
    "coarse_angle_resolution": 0.0349,
    "fine_search_angle_resolution": 0.00349,
    "use_response_expansion": True,
    "range_threshold": 20,
    "minimum_angle_penalty": 0.9,
    "search_size": 0.3,
    "resolution": 0.01,
    "smear_deviation": 0.07,
}
DEFAULT_LOOP_CONFIG = dict(
    DEFAULT_SEQ_CONFIG,
    search_size=4.0,
    resolution=0.05,
    smear_deviation=0.03,
)


def render_ros_style_map(slam, resolution=0.05, range_threshold=12.0,
                         despeckle_min_size=5):
    """Occupancy image remapped to ROS occupancy values (occupied 0 -> 100,
    unknown 200 -> -1, free 255 -> 0), small occupied components removed.
    Returns (ros_image, grid)."""
    from scipy import ndimage

    grid = slam.make_occupancy_grid(resolution=resolution,
                                    range_threshold=range_threshold)
    im = grid.image.copy()

    occ = im == 0
    labels, n = ndimage.label(occ)
    if n:
        sizes = ndimage.sum(occ, labels, index=np.arange(1, n + 1))
        small = np.isin(labels, np.nonzero(sizes < despeckle_min_size)[0] + 1)
        im[small] = 255

    out = im.astype(np.int16)
    out[im == 0] = 100
    out[im == 200] = -1
    out[im == 255] = 0
    return out, grid


class OnlineMapper:
    """Synchronous online-mapping core on `device` (one thread; see
    :class:`ThreadedOnlineMapper` for the node's queue and worker).
    ``seq_matcher`` / ``loop_matcher`` override the matchers built from
    the configs."""

    def __init__(
        self,
        seq_config=None,
        loop_config=None,
        *,
        device=DEFAULT_DEVICE,
        dtype=torch.float32,
        min_distance=0.5,
        min_rotation=0.5,
        range_threshold=20.0,
        range_threshold_for_map=12.0,
        map_resolution=0.05,
        scan_buffer_len=10,
        loop_search_min_chain_size=10,
        loop_search_distance=4.0,
        min_response_coarse=0.6,
        min_response_fine=0.7,
        base_map=None,          # (image, resolution, origin) to splice into
        initial_pose=None,      # (x, y, theta) when localizing in base_map
        map_callback=None,      # called with (ros_style_image, grid)
        map_every_n_scans=5,
        seq_matcher=None,
        loop_matcher=None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.min_distance = min_distance
        self.min_rotation = min_rotation
        self.range_threshold = range_threshold
        self.range_threshold_for_map = range_threshold_for_map
        self.map_resolution = map_resolution
        self.map_callback = map_callback
        self.map_every_n_scans = map_every_n_scans

        if base_map is not None:
            # the node's looser gates and short chains when localizing
            # against a base map
            loop_search_min_chain_size = 2
            min_response_coarse = 0.25
            min_response_fine = 0.35

        seq = seq_matcher or CorrelativeScanMatcher(
            dict(DEFAULT_SEQ_CONFIG, **(seq_config or {})),
            device=self.device, dtype=dtype,
        )
        loop = loop_matcher or CorrelativeScanMatcher(
            dict(DEFAULT_LOOP_CONFIG, **(loop_config or {})), loop=True,
            device=self.device, dtype=dtype,
        )
        self.slam = GraphSlam(
            seq, loop,
            scan_buffer_len=scan_buffer_len,
            loop_search_dist=loop_search_distance,
            loop_search_min_chain_size=loop_search_min_chain_size,
            min_response_coarse=min_response_coarse,
            min_response_fine=min_response_fine,
        )

        self._base_scans = []
        self.initial_pose = initial_pose
        if base_map is not None:
            image, resolution, origin = base_map
            self.slam = map_to_graphslam(self.slam, image, resolution, origin,
                                         density=5, device=self.device)
            # rebuild the optimizer's indices, as the node does
            self.slam = GraphSlam.deserialize(self.slam.serialize(),
                                              device=self.device, dtype=dtype)
            self._base_scans = [v.obj for v in self.slam.graph.vertices]

        self._last_pose = None
        self._scan_counter = 0

    # -- gating ----------------------------------------------------------------
    def _should_integrate(self, pose_xyt):
        if self._last_pose is None:
            self._last_pose = pose_xyt
            return True
        p, last = pose_xyt, self._last_pose
        # crossing +-pi is a small rotation: wrap the yaw difference
        dyaw = (p[2] - last[2] + np.pi) % (2.0 * np.pi) - np.pi
        if ((p[0] - last[0]) ** 2 + (p[1] - last[1]) ** 2 < self.min_distance**2
                and abs(dyaw) < self.min_rotation):
            return False
        self._last_pose = pose_xyt
        return True

    # -- main entry -------------------------------------------------------------
    def _prepare_scan(
        self, ranges, angle_min, angle_max, angle_increment, range_min,
        range_max, odom_pose, invert=False,
    ):
        """Motion-gate and build the LocalizedRangeScan; None if the scan
        is not integrated.  A pending initial_pose is applied at ingestion
        (to exactly one scan), not here."""
        pose = (
            (odom_pose.x, odom_pose.y, odom_pose.euler[-1])
            if hasattr(odom_pose, "euler")
            else tuple(float(v) for v in odom_pose)
        )
        if not self._should_integrate(pose):
            return None

        r = np.asarray(ranges, dtype=np.float64)
        if invert:
            r = r[::-1]
        return LocalizedRangeScan(
            r, angle_min, angle_max, angle_increment, range_min, range_max,
            self.range_threshold, pose[0], pose[1], pose[2],
        )

    def _after_scan(self, closed):
        self._scan_counter += 1
        if self.map_callback and (
            self._scan_counter % self.map_every_n_scans == 0 or closed
        ):
            self.map_callback(*self.render_map())

    def add_scan(
        self, ranges, angle_min, angle_max, angle_increment, range_min,
        range_max, odom_pose, invert=False,
    ):
        """Feed one scan (odom_pose = (x, y, theta) of the sensor in the
        odom frame).  Returns (integrated, match_result, closed)."""
        scan = self._prepare_scan(
            ranges, angle_min, angle_max, angle_increment, range_min,
            range_max, odom_pose, invert,
        )
        if scan is None:
            return False, None, None
        res, closed = self._ingest_prepared(scan)
        self._after_scan(closed)
        return True, res, closed

    def _ingest_prepared(self, scan):
        """Ingest one prepared scan: apply a pending initial_pose to it,
        splice-bootstrap it against a loaded base map when that applies,
        else GraphSlam.process_scan."""
        pending_init = self.initial_pose is not None
        if pending_init:
            scan.odom_pose = Transform.from_xyt(*self.initial_pose)
            scan.corrected_pose = Transform.from_xyt(*self.initial_pose)
            self.initial_pose = None

        if (not self.slam.running_scans and self._base_scans
                and pending_init):
            # splice bootstrap: localize the first live scan against the
            # injected base map
            scan.num = max(v.obj.num for v in self.slam.graph.vertices) + 1
            nearby = self.slam.search.crude_radius_search(scan.odom_pose, 5)
            res = self.slam.seq_matcher.match_scan(
                scan, [v.obj for v in nearby], do_fine=True
            )
            scan.corrected_pose = res.best_pose
            self.slam.add_vertex(scan)
            self.slam.link_scans(scan, nearby[0].obj, None, res.covariance)
            self.slam.running_scans.append(scan)
            closed = True
        else:
            res, closed = self.slam.process_scan(scan)
        return res, closed

    def add_scans_batch(self, prepared_scans):
        """Process prepared scans through the streamed SLAM path (the
        threaded mapper's backlog branch).  Returns [(match_result,
        closed)]."""
        return self.add_scans_batch_stream(prepared_scans)

    def add_scans_batch_stream(self, prepared_scans, sync_every=8):
        """Streamed ingestion of prepared scans (GraphSlam.process_scan_
        stream).  The bootstrap states the stream cannot express run per
        scan first: a pending initial_pose applies to exactly one scan, and
        a fresh localization mapper (base map, no running scans) splices
        its first scan."""
        out = []
        scans = list(prepared_scans)
        while scans and (
            self.initial_pose is not None
            or (self._base_scans and not self.slam.running_scans)
        ):
            res, closed = self._ingest_prepared(scans.pop(0))
            out.append((res, closed))
            self._after_scan(closed)
        if scans:
            tail = self.slam.process_scan_stream(scans, sync_every=sync_every)
            for _, closed in tail:
                self._after_scan(closed)
            out.extend(tail)
        return out

    # -- outputs ---------------------------------------------------------------
    def map_to_odom(self):
        """map->odom correction from the last corrected pose."""
        if not self.slam.running_scans:
            return Transform()
        ls = self.slam.running_scans[-1]
        odom_to_map = ls.odom_pose + ls.corrected_pose.inverse()
        return odom_to_map.inverse()

    def render_map(self):
        return render_ros_style_map(
            self.slam, self.map_resolution, self.range_threshold_for_map
        )

    def save_graph(self, path):
        self.slam.to_file(path)
        return path


class ThreadedOnlineMapper(OnlineMapper):
    """The node's queue and worker arrangement: callers enqueue scans
    without waiting for matching, a worker thread integrates them (a
    backlog as one streamed block), and a map thread renders.  Both
    threads use the mapper's device; the matcher disables autograd in each
    of them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._user_map_callback = self.map_callback
        self.map_callback = None  # invoked on the map thread instead
        self._queue = queue.Queue()
        self._map_queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._map_thread = threading.Thread(target=self._map_run, daemon=True)
        self._worker.start()
        self._map_thread.start()

    def enqueue_scan(self, *args, **kwargs):
        self._queue.put((args, kwargs))

    def _run(self):
        counter = 0
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [item]
            # backpressure: when scans arrive faster than they are
            # processed, take the backlog (up to 16) as one streamed block;
            # a bootstrap state (first scan, pending initial_pose) goes per
            # scan
            can_batch = (
                bool(self.slam.running_scans) and self.initial_pose is None
            )
            if can_batch:
                while len(batch) < 16:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
            if len(batch) == 1 or not can_batch:
                n_done = 0
                closed_any = False
                for args, kwargs in batch:
                    integrated, _, closed = self.add_scan(*args, **kwargs)
                    n_done += bool(integrated)
                    closed_any |= bool(closed)
                    self._queue.task_done()
            else:
                scans = []
                for args, kwargs in batch:
                    s = self._prepare_scan(*args, **kwargs)
                    if s is not None:
                        scans.append(s)
                out = self.add_scans_batch(scans) if scans else []
                for _ in batch:
                    self._queue.task_done()
                n_done = len(scans)
                closed_any = any(bool(c) for _, c in out)
            if n_done:
                counter += n_done
                if (counter >= self.map_every_n_scans or closed_any) and \
                        self._map_queue.qsize() == 0:
                    self._map_queue.put(True)
                    counter = 0

    def _map_run(self):
        while not self._stop.is_set():
            try:
                self._map_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if self._user_map_callback and self.slam.graph.vertices:
                self._user_map_callback(*self.render_map())
            self._map_queue.task_done()

    def drain(self, timeout=60.0):
        """Wait until every enqueued scan is processed (counted by
        task_done: the worker takes a backlog off the queue before it
        processes it).  True when all were."""
        deadline = time.time() + timeout
        while self._queue.unfinished_tasks and time.time() < deadline:
            time.sleep(0.05)
        return self._queue.unfinished_tasks == 0

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)
        self._map_thread.join(timeout=2)
