"""Correlative scan matcher, in PyTorch.

Counterpart of ``yag_slam_tpu/matching/matcher.py``: same config keys,
same ``ScanMatcherResult``, same ``match_scan`` / ``match_many`` /
``match_many_mega`` contract, their ``*_async`` handles, the scan-set
paths (``match_scan_sets``, ``match_scan_sets_with_map``) and the opt-in
``return_meta``.

- a **device-resident scan library** holds every scan's matcher view
  (compacted beam endpoints + validation-run structure) in (K, P) tensors,
  uploaded in batches; a match carries only slot indices, poses and the
  search center;
- the host picks a tight, bucketed **subgrid** around the occupied bounding
  box of each match; cells outside it are provably zero, so building and
  scoring against it is exact;
- each dispatch builds the quantized grids (the base points' occupancy in
  one ``scatter_cells`` launch fed by the points, ``program_kernels.
  world_scatter``, then ``smear_quantize``; with ``return_meta`` the staged
  ``smear_grid`` -> quantize build, which keeps the float32 grid), scores
  the coarse and fine lattices (one ``window_sum`` launch a pass fed by the
  query points, ``program_kernels.lattice_window_sum``) and reduces them on
  the device (``score_reduce``): on the card four launches for a coarse
  pass, six with the fine one; then it copies one (N, 2, 8) tensor to the
  host, without blocking until a handle's ``.result()`` asks for it;
- on CUDA that device program is a CUDA graph per batch shape, shared by
  the process's matchers (:mod:`yag_slam_tpu_torch.matching.graphs`): a
  dispatch stages its inputs with one non-blocking copy, replays the graph
  and clones its outputs; ``match_many`` pads its batch to a power of two
  so that nearby sizes share a graph;
- localizing against a saved map scores the map's quantized grid on the
  element path (``correlation.find_best_pose``), whose lattice step need
  not be a multiple of the cell.
"""
from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from yag_slam_tpu_torch import native
from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from yag_slam_tpu_torch.core.config import ScanMatcherConfig, make_config
from yag_slam_tpu_torch.core.transform import Transform
from yag_slam_tpu_torch.matching import correlation as C
from yag_slam_tpu_torch.matching import program_kernels as PK
from yag_slam_tpu_torch.matching.graphs import GRAPHS

ScanMatcherResult = namedtuple(
    "ScanMatcherResult", ["response", "covariance", "best_pose", "meta"]
)

# Far-away sentinel for padded point lanes: maps out of any grid, so the
# lane contributes exactly 0 to every score.
_FAR = PK.FAR

# The fine pass's angular extent is a literal in the reference matcher.
_FINE_ANGLE_SIZE = 0.0349 * 0.5

# Response expansion: retry with a wider angle search when the coarse
# response is 0; 20 degrees per retry, 3 retries.
_EXPANSION_STEP = math.radians(20.0)
_EXPANSION_TRIES = 3

# Subgrid side buckets (cells), as in the JAX package, so both pick the
# same subgrid for the same match.
_SUB_BUCKETS = (512, 768, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 4096,
                8192)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

# scan slots allocated up front; the library doubles when full
_LIBRARY_INITIAL_CAP = 128

# the matcher's cache of yaws by quaternion is emptied at this size
_YAW_CACHE = 1 << 16

# the bbox of no scan: the identity of min / max
_EMPTY_BOX = np.array([np.inf, -np.inf, np.inf, -np.inf])

# The localize-against-map coarse pass's literal search: +-0.25 m at
# 0.01 m, +-0.1 rad at 0.01 rad, on a 0.05 m grid, unpenalized.
_MAP_COARSE = dict(xy_size=0.25, xy_res=0.01, ang_size=0.1, ang_res=0.01,
                   grid_res=0.05)


def sanitize_covariance(covar, cfg):
    """Replace a non-finite or non-positive-definite match covariance by a
    "know nothing inside the search window" prior (the reference's
    unclamped penalty can drive window moments negative, and one indefinite
    information matrix corrupts the whole pose-graph solve)."""
    xy_var = (0.5 * cfg.search_size) ** 2
    th_var = (0.5 * cfg.coarse_search_angle_offset) ** 2
    fallback_needed = not np.isfinite(covar).all()
    if not fallback_needed:
        xx, yy, xy, th = covar[0, 0], covar[1, 1], covar[0, 1], covar[2, 2]
        fallback_needed = (
            xx <= 0.0 or yy <= 0.0 or th <= 0.0 or xx * yy - xy * xy <= 0.0
        )
    if fallback_needed:
        return np.diag([xy_var, xy_var, th_var])
    return covar


def _next_bucket(n: int, quantum: int = 128) -> int:
    b = quantum
    while b < n:
        b *= 2
    return b


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scan_matcher_view(scan, cap: int):
    """Cached, pose-independent host view of a scan: compacted local beam
    endpoints + validation-run structure.  Shares the cache key of the JAX
    package, so both matchers reuse one view of a scan."""
    return scan_matcher_views([scan], cap)[0]


def scan_matcher_views(scans, cap: int):
    """:func:`scan_matcher_view` of each scan; the views not cached yet are
    made together by one native call (one per shared points cache)."""
    key = ("matcher_view", cap)
    new = {}
    for s in scans:
        if key not in s._points_cache:
            new.setdefault(id(s._points_cache), s)
    if new:
        made = native.scan_views(list(new.values()), cap)
        for i, s in enumerate(new.values()):
            s._points_cache[key] = dict(
                lx=made["lx"][i], ly=made["ly"][i], anchor=made["anchor"][i],
                term=made["term"][i], has_run=made["has_run"][i], n=int(made["n"][i]))
    return [s._points_cache[key] for s in scans]


class DeviceScanLibrary:
    """Device-resident store of scan matcher views: (K, P) tensors per
    field, addressed by slot.

    Uploads are deferred: ``ensure`` assigns slots, queues the scans and
    makes their host views; the next read of ``.fields`` copies every queued
    scan in one host-to-device transfer per field.  Slots are keyed by the
    identity of the scan's shared points cache, so ``LocalizedRangeScan.copy``
    (the loop-closure temp scans) aliases the original's slot."""

    def __init__(self, dtype, initial_cap=None, *, device=DEFAULT_DEVICE):
        self.dtype = dtype
        self.initial_cap = initial_cap   # None: _LIBRARY_INITIAL_CAP
        self.device = resolve_device(device)
        self._fields = None
        self.P = 0
        self.K_cap = 0
        self._slots = {}
        self._scans = []   # strong refs keep identity keys unique
        self._pending = []  # (slot, scan) queued for the next flush

    @property
    def fields(self):
        self.flush()
        return self._fields

    def _field_zeros(self, K, P):
        z = lambda dt: torch.zeros((K, P), dtype=dt, device=self.device)  # noqa: E731
        return dict(
            lx=z(self.dtype), ly=z(self.dtype), anchor=z(torch.int32),
            term=z(torch.int32), has_run=z(torch.bool),
            n=torch.zeros((K,), dtype=torch.int32, device=self.device),
        )

    def flush(self):
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        np_dtype = _NP_DTYPES[self.dtype]
        views = scan_matcher_views([s for _, s in pending], self.P)
        rows = dict(
            lx=_stack([v["lx"] for v in views], np_dtype),
            ly=_stack([v["ly"] for v in views], np_dtype),
            anchor=_stack([v["anchor"] for v in views]),
            term=_stack([v["term"] for v in views]),
            has_run=_stack([v["has_run"] for v in views]),
            n=np.asarray([v["n"] for v in views], dtype=np.int32),
        )
        slots, *vals = _to_device_all(
            [np.asarray([sl for sl, _ in pending], dtype=np.int64), *rows.values()],
            self.device)
        for k, v in zip(rows, vals):
            self._fields[k].index_copy_(0, slots, v)

    def ensure(self, scans, P):
        """Give every scan a slot at point capacity P and make the views of
        the scans queued for upload; returns the slots aligned with
        `scans`."""
        if self._fields is None:
            self.P = P
            self.K_cap = self.initial_cap or _LIBRARY_INITIAL_CAP
            self._fields = self._field_zeros(self.K_cap, P)
        elif P > self.P:
            # wider scans: re-queue every stored scan at the new width
            self.P = P
            self._fields = self._field_zeros(self.K_cap, P)
            self._pending = [
                (self._slots[id(s._points_cache)], s) for s in self._scans
            ]
        out = []
        for s in scans:
            slot = self._slots.get(id(s._points_cache))
            if slot is None:
                slot = len(self._scans)
                if slot >= self.K_cap:
                    self.flush()
                    new_cap = self.K_cap * 2
                    grown = self._field_zeros(new_cap, self.P)
                    for k in grown:
                        grown[k][: self.K_cap] = self._fields[k]
                    self._fields = grown
                    self.K_cap = new_cap
                self._slots[id(s._points_cache)] = slot
                self._scans.append(s)
                self._pending.append((slot, s))
            out.append(slot)
        # the queued scans' views, in one native call
        scan_matcher_views([s for _, s in self._pending], self.P)
        return np.asarray(out, dtype=np.int64)


def _stack(rows, dtype=None):
    """np.stack of equal-length 1-D rows (cast to `dtype`), in one
    concatenate: np.stack's per-row reshapes cost more than the copy."""
    return np.concatenate(rows, dtype=dtype).reshape(len(rows), -1)


def _to_device(a, device):
    """Host array -> tensor on `device` without waiting for the device (see
    :func:`_to_device_all`)."""
    return _to_device_all([a], device)[0]


def _to_device_all(arrays, device):
    """Host arrays -> tensors on `device` without waiting for the device: on
    CUDA through one pinned staging buffer that holds them all and one
    non-blocking transfer (the caching host allocator keeps the buffer until
    the copy ran)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if device.type != "cuda":
        return [torch.from_numpy(a) for a in arrays]
    # 8-byte aligned slots, so that every view of the copy is aligned
    offsets = np.cumsum([0] + [-(-a.nbytes // 8) * 8 for a in arrays]).tolist()
    host = torch.empty(offsets[-1], dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a
    dev = host.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a).dtype).view(a.shape)
            for a, o in zip(arrays, offsets)]


def _host_copy_async(t):
    """Start copying `t` to the host without blocking; returns a function
    that waits for the copy and gives the numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


class _MatchHandle:
    """In-flight batch dispatched by match_scan_async / match_many_async.
    `.result()` waits for the packed device output, retries the jobs whose
    coarse response came back empty (one widened batch per expansion
    attempt) and assembles one ScanMatcherResult (match_scan_async) or
    the list of them (match_many_async)."""

    __slots__ = ("_m", "_pending", "_args", "_P", "_penalty", "_do_fine",
                 "_S", "_single", "_n", "_res")

    def __init__(self, matcher, pending, args, P, penalty, do_fine, S, single, n):
        self._m = matcher
        self._pending = pending
        self._args = args
        self._P = P
        self._penalty = penalty
        self._do_fine = do_fine
        self._S = S
        self._single = single
        self._n = n
        self._res = None

    def result(self):
        if self._res is None:
            res = self._m._finish(self._pending, self._args, self._P,
                                  self._penalty, self._do_fine, self._S,
                                  with_meta=self._single, n=self._n)
            self._res = res[0] if self._single else res
            self._pending = self._args = None
        return self._res


class _EmptyBatchHandle:
    """Trivial handle for an empty match_many_async batch."""

    __slots__ = ()

    def result(self):
        return []


class CorrelativeScanMatcher:
    """Correlative scan matcher (coarse-to-fine, with response expansion)
    running on one torch device.

    ``device`` defaults to cuda (raising without a card): CUDA tensors go
    through the hand-written kernels; ``device="cpu"`` runs their plain
    PyTorch versions.  ``meta`` is None unless ``return_meta=True``: then
    match_scan and the scan-set paths carry {'grid': job 0's smeared grid
    before quantize and mask, 'kernel': the 2-D smear kernel}, as the
    reference's matchers do.
    ``point_capacity`` / ``base_capacity`` fix the point and base-scan
    buckets up front (the point cap still grows for wider scans).  The
    JAX package's TPU route switches have no counterpart: the device
    decides."""

    def __init__(self, config_dict=None, loop: bool = False, *,
                 config: ScanMatcherConfig | None = None, device=DEFAULT_DEVICE,
                 dtype=torch.float32, point_capacity: int | None = None,
                 base_capacity: int | None = None, return_meta: bool = False,
                 sanitize_covariance: bool = True):
        self.device = resolve_device(device)
        if dtype not in _NP_DTYPES:
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.config = config if config is not None else make_config(config_dict, loop)
        cfg = self.config
        self.grid_size = int(
            cfg.search_size / cfg.resolution
            + 1
            + 2 * cfg.range_threshold / cfg.resolution
        )
        self.dtype = dtype
        self.np_dtype = _NP_DTYPES[dtype]
        self.return_meta = return_meta
        self.sanitize_covariance = sanitize_covariance
        self._point_cap = point_capacity
        self._base_cap = base_capacity
        self._k1 = C.gaussian_kernel_1d(cfg.resolution, cfg.smear_deviation)
        self._half = (len(self._k1) - 1) // 2
        # float32 taps, as the TPU kernels use them; checked once here for
        # the shape the smear_quantize kernel relies on
        self._taps = torch.as_tensor(
            C.check_smear_taps(self._k1.astype(np.float32)), device=self.device)
        self.library = DeviceScanLibrary(dtype, device=self.device)
        self._yaws = {}
        # the subgrid sides a match may take: the buckets below the largest
        # subgrid, then the largest
        s_max = self._max_sub()
        self._sub_sizes = np.array([b for b in _SUB_BUCKETS if b < s_max] + [s_max])

    # -- capacity management ------------------------------------------------
    def _ensure_point_cap(self, scans) -> int:
        need = max(s.num_valid_beams for s in scans)
        if self._point_cap is None or self._point_cap < need:
            self._point_cap = _next_bucket(need)
        return self._point_cap

    def _base_bucket(self, n: int) -> int:
        if self._base_cap is not None:
            if n > self._base_cap:
                raise ValueError(f"{n} base scans > base_capacity {self._base_cap}")
            return self._base_cap
        return _pow2(n)

    # -- subgrid selection ----------------------------------------------------
    def _max_sub(self):
        return _round_up(self.grid_size, 128)

    def _xyt(self, p):
        """(x, y, yaw) of a pose; the yaw (three atan2 / asin) is computed
        once per quaternion."""
        q = (p.qx, p.qy, p.qz, p.qw)
        t = self._yaws.get(q)
        if t is None:
            if len(self._yaws) >= _YAW_CACHE:
                self._yaws.clear()
            t = self._yaws[q] = p.euler[-1]
        return p.x, p.y, t

    def _world_bboxes(self, scans, P):
        """(K, 4) float64: each scan's world-frame bbox (x min, x max, y
        min, y max) of its padded view at its corrected pose (the padding
        puts the pose's own position into the box).  Cached per (pose, P)
        on the scan's shared points cache, which holds one pose's box (a
        loop-closure copy shares the cache at another pose); the boxes not
        cached are computed together."""
        out, miss = [], []
        for k, s in enumerate(scans):
            x, y, t = self._xyt(s.corrected_pose)
            key = ("wbbox", P, x, y, t)
            hit = s._points_cache.get(key)
            if hit is None:
                miss.append((k, s, key))
            out.append(hit)
        if miss:
            views = scan_matcher_views([s for _, s, _ in miss], P)
            lx = _stack([v["lx"] for v in views])
            ly = _stack([v["ly"] for v in views])
            # per pose: x, y and the scalar cos / sin of its yaw (numpy's
            # array loops may round differently in the last bit)
            pc = np.array([(key[2], key[3], np.cos(key[4]), np.sin(key[4]))
                           for _, _, key in miss])
            x, y, c, sn = pc[:, 0:1], pc[:, 1:2], pc[:, 2:3], pc[:, 3:4]
            # x + c * lx - sn * ly and y + sn * lx + c * ly, in place
            wx, tmp = c * lx, sn * ly
            wx += x
            wx -= tmp
            wy = np.multiply(sn, lx, out=tmp)
            wy += y
            wy += np.multiply(c, ly, out=lx)
            boxes = np.empty((len(miss), 4))
            wx.min(1, out=boxes[:, 0])
            wx.max(1, out=boxes[:, 1])
            wy.min(1, out=boxes[:, 2])
            wy.max(1, out=boxes[:, 3])
            for (k, s, key), box in zip(miss, boxes.tolist()):
                cache = s._points_cache
                for old in [o for o in cache if o[0] == "wbbox"]:
                    del cache[old]
                cache[key] = out[k] = tuple(box)
        return np.array(out, dtype=np.float64).reshape(len(scans), 4)

    def _subgrids(self, boxes, centers, margin_cells=0):
        """Host-side tight occupied-bbox subgrids of N jobs: their origins
        (sox, soy) (N, 2) and sides S (N,), int64, from `boxes` (N, B, 4),
        the world bboxes of each job's base scans (rows past a job's scans:
        _EMPTY_BOX), and the search centers' xy (N, 2) float64.  Exact:
        every base point inside the full grid lands inside the subgrid (+
        smear halo), so all other cells are zero.  `margin_cells` widens the
        box on every side: the chained pipeline's host pose estimates can
        lag the device's poses by a bounded number of cells."""
        res = self.config.resolution
        G = self.grid_size
        h = self._half
        mc = int(margin_cells)
        # (x, y) columns: the full grid's origin, the boxes' low and high
        # corners in its cells, widened by 1 + mc, clipped to the grid
        o = centers - 0.5 * (G - 1) * res
        lo = np.floor((boxes[..., 0::2].min(axis=1) - o) / res) - (1 + mc)
        hi = np.ceil((boxes[..., 1::2].max(axis=1) - o) / res) + (1 + mc)
        lo = np.minimum(np.maximum(lo, 0), G - 1).astype(np.int64)
        hi = np.minimum(np.maximum(hi, 0), G - 1).astype(np.int64)
        span = (hi - lo).max(axis=1) + (1 + 2 * h + 4)
        sizes = self._sub_sizes
        S = sizes[np.minimum(np.searchsorted(sizes, span), len(sizes) - 1)]
        so = np.minimum(np.maximum(lo - (h + 2), 0), (G - S)[:, None])
        so[S >= G] = 0
        return so, S

    def _subgrid_for(self, base_scans, center_x, center_y, P,
                     margin_cells: int = 0):
        """:meth:`_subgrids` of one job: (sox, soy, S)."""
        boxes = self._world_bboxes(base_scans, P)[None]
        so, S = self._subgrids(boxes, np.array([[center_x, center_y]], dtype=np.float64),
                               margin_cells)
        return int(so[0, 0]), int(so[0, 1]), int(S[0])

    # -- the match program ------------------------------------------------------
    def _lattices(self, coarse_offset):
        """The (coarse, fine) passes' lattices (program_kernels.PassLattice)."""
        cfg = self.config
        res = cfg.resolution
        coarse = (cfg.search_size * 0.5, res * 2, coarse_offset * 0.5,
                  cfg.coarse_angle_resolution)
        fine = (res * 2, res, _FINE_ANGLE_SIZE, cfg.fine_search_angle_resolution)
        return tuple(PK.PassLattice.make(C.LatticeSpec.from_search(0.0, 0.0, 0.0, *lat),
                                         *lat, res) for lat in (coarse, fine))

    def _stage(self, args, queries=None):
        """A batch's device inputs as fresh tensors (the eager staging; on
        CUDA, :data:`graphs.GRAPHS` stages into an entry's static tensors
        instead): the job arrays (idx, mask, pose, q_idx, center, vp, sub),
        the base scans' library rows (lx, ly, anchor, term, has_run; (N, B,
        P)), the query rows (qlx, qly (N, P), n_q (N,)) and the smear taps,
        as the dict :meth:`_compute` reads.  Query points come from the
        library (args' slots) or from `queries` = (q_lx (N, P), q_ly, n_q
        (N,)) host arrays.  The args may be host arrays or tensors already
        on the device (the chained pipeline passes device poses and
        centers)."""
        dev = self.device

        def tensor(a):
            return a if isinstance(a, torch.Tensor) else _to_device(a, dev)

        st = dict(zip(("idx", "mask", "pose", "q_idx", "center", "vp", "sub"),
                      map(tensor, args)))
        lib = self.library.fields
        for k in ("lx", "ly", "anchor", "term", "has_run"):
            st[k] = lib[k][st["idx"]]                      # (N, B, P)
        if queries is None:
            q = st["q_idx"]
            st.update(qlx=lib["lx"][q], qly=lib["ly"][q], n_q=lib["n"][q])
        else:
            st.update(zip(("qlx", "qly", "n_q"), map(tensor, queries)))
        st["taps"] = self._taps
        return st

    @torch.no_grad()
    def _run(self, args, P, penalty, do_fine, coarse_offset, S, queries=None):
        """Grid build + coarse (+ fine) pass for a batch of jobs on the
        device (args and queries as :meth:`_stage` takes them, at point
        capacity P and subgrid S).  Returns the packed (N, 2, 8) device
        tensor [coarse, fine] x (response, x, y, theta, XX, YY, XY, TH),
        and job 0's float32 grid before quantize and mask when the matcher
        returns meta (else None), both fresh tensors.  On CUDA through the
        process's CUDA graphs (:mod:`graphs`); on the CPU eagerly."""
        if self.device.type == "cuda":
            return GRAPHS.run(self, args, P, penalty, do_fine, coarse_offset, S, queries)
        return self._compute(self._stage(args, queries), S, penalty, do_fine,
                             coarse_offset)

    def _compute(self, st, S, penalty, do_fine, coarse_offset):
        """The device program of :meth:`_run` on staged inputs (`st` as
        :meth:`_stage` gives it): the base points' occupancy grid
        (program_kernels.world_scatter), its smear, then per pass the
        window sums at the query points' lattice cells and the reduction
        into the packed result (program_kernels.lattice_window_sum,
        program_kernels.score_reduce): on the card one launch each.  Reads
        only `st`'s tensors and Python constants and never waits for the
        card, so a CUDA graph can capture it: the fine pass's center is the
        coarse row of the result, on the device."""
        G, h, res = self.grid_size, self._half, self.config.resolution
        occ, lim = PK.world_scatter(
            *(st[k] for k in ("lx", "ly", "anchor", "term", "has_run", "mask", "pose",
                              "center", "vp", "sub")), G=G, S=S, h=h, res=res)
        q2d, grid = C.grid_from_occupancy(occ, lim, S=S, h=h, taps=st["taps"],
                                          staged=self.return_meta)
        job_center, n_q = st["center"], st["n_q"]
        packed = torch.empty((n_q.shape[0], 2, 8), dtype=self.dtype, device=n_q.device)
        center = job_center
        for row, lat in enumerate(self._lattices(coarse_offset)[:1 + bool(do_fine)]):
            raw = PK.lattice_window_sum(q2d, st["qlx"], st["qly"], n_q, center, job_center,
                                        st["sub"], lat, G=G, res=res)
            PK.score_reduce(raw, n_q, center, job_center, packed, row, lat, G=G, res=res,
                            penalize=penalty, karto=self.config.karto_penalty_tuple(),
                            copy_fine=not do_fine)
            center = packed[:, 0, 1:4]
        return packed, None if grid is None else grid[0]

    def batched_core(self, P, B, penalty, do_fine, S, coarse_offset=None):
        """The batch match function, for composition (the sharded loop
        matcher, parallel/loop_search.py): ``core(idx, mask, pose, q_idx,
        center, vp, sub)`` runs the grid build and the coarse (+ fine)
        passes on the given slice of job arrays (as ``_assemble_jobs``
        makes them at point cap P and base bucket B) and returns the packed
        (N_local, 2, 8) device tensor, with no host copy and no response
        expansion."""
        if coarse_offset is None:
            coarse_offset = self.config.coarse_search_angle_offset

        def core(*args):
            if len(args) != 7 or args[0].shape[1] != B:
                raise ValueError(f"core takes the 7 job arrays at base bucket {B}")
            return self._run(args, P, bool(penalty), bool(do_fine), coarse_offset, S)[0]

        return core

    # -- job assembly -----------------------------------------------------------
    @staticmethod
    def _distinct_scans(jobs):
        """The jobs' scans, each once, in the order the jobs first touch
        them (each job's base scans, then its query; the order in which
        they take library slots), and where each job's scans sit in that
        list: its base scans' positions (one list for all jobs, in job
        order) and its query's ((n,) int64)."""
        pos, scans, base, query = {}, [], [], []
        for q, base_scans in jobs:
            for s in base_scans:
                k = pos.get(id(s))
                if k is None:
                    k = pos[id(s)] = len(scans)
                    scans.append(s)
                base.append(k)
            k = pos.get(id(q))
            if k is None:
                k = pos[id(q)] = len(scans)
                scans.append(q)
            query.append(k)
        return scans, np.asarray(base, dtype=np.int64), np.asarray(query, dtype=np.int64)

    def _assemble_jobs(self, jobs, P, B, n_pad=None):
        """Host-side per-job metadata: library slots, poses, search
        centers, viewpoints (the centers' xy) and subgrids, gathered from
        tables of the batch's distinct scans.  With `n_pad`, the arrays have
        n_pad rows; the rows past the jobs are zero with `mask` False."""
        return self._gather_jobs(jobs, self._distinct_scans(jobs), P, B, n_pad)

    def _gather_jobs(self, jobs, distinct, P, B, n_pad):
        """:meth:`_assemble_jobs` given the jobs' :meth:`_distinct_scans`."""
        n = len(jobs)
        N = n_pad or n
        scans, base_pos, q_pos = distinct
        K = len(scans)
        # per-scan tables with one more row, the empty entry, that position
        # -1 reads: slot 0, pose 0, the empty box
        slots = np.zeros(K + 1, dtype=np.int64)
        slots[:K] = self.library.ensure(scans, P)
        xyt = np.array([self._xyt(s.corrected_pose) for s in scans] + [(0.0, 0.0, 0.0)])
        in_base = np.zeros(K, dtype=bool)
        in_base[base_pos] = True
        in_base = in_base.nonzero()[0]
        boxes = np.empty((K + 1, 4))
        boxes[-1] = _EMPTY_BOX
        boxes[in_base] = self._world_bboxes([scans[k] for k in in_base.tolist()], P)

        at = np.empty((N, B), dtype=np.int64)
        at.fill(-1)
        at[:n][np.arange(B) < np.array([len(bs) for _, bs in jobs])[:, None]] = base_pos
        q_at = np.empty(N, dtype=np.int64)
        q_at.fill(-1)
        q_at[:n] = q_pos
        poses = xyt.astype(self.np_dtype)
        center = poses[q_at]
        so, S = self._subgrids(boxes[at[:n]], xyt[q_pos, :2])
        sub = np.zeros((N, 2), dtype=np.int32)
        sub[:n] = so
        return ((slots[at], at >= 0, poses[at], slots[q_at], center, center[:, :2], sub),
                int(S.max(initial=0)))

    def _prepare(self, jobs, n_pad=None):
        if any(not bs for _, bs in jobs):
            raise ValueError("every job needs at least one base scan")
        distinct = self._distinct_scans(jobs)
        P = self._ensure_point_cap(distinct[0])
        B = self._base_bucket(max(len(bs) for _, bs in jobs))
        args, S = self._gather_jobs(jobs, distinct, P, B, n_pad)
        return args, P, S

    # -- public API -----------------------------------------------------------
    def match_scan(self, query, base_scans, penalty=True, do_fine=True):
        """Match `query` against `base_scans`; returns ScanMatcherResult
        with the covariance assembled from the coarse xy moments and the
        fine theta moment."""
        return self.match_scan_async(query, base_scans, penalty,
                                     do_fine).result()

    def match_scan_async(self, query, base_scans, penalty=True, do_fine=True):
        """Dispatch one match without blocking on the device; the handle's
        `.result()` waits, applies response expansion if the coarse
        response came back empty, and returns the ScanMatcherResult."""
        if not base_scans:
            raise ValueError("match_scan needs at least one base scan")
        return self._dispatch([(query, base_scans)], penalty, do_fine,
                              single=True)

    def match_many(self, jobs, penalty=True, do_fine=True):
        """Score independent (query, base_scans) jobs in one batch.  Jobs
        whose coarse response is empty are retried together, one widened
        batch per expansion attempt."""
        return self.match_many_async(jobs, penalty, do_fine).result()

    def match_many_async(self, jobs, penalty=True, do_fine=True):
        """Dispatch a batch of independent jobs without blocking; the
        handle's `.result()` gives the list of ScanMatcherResult (an empty
        batch gets a trivial handle whose result is [])."""
        if not jobs:
            return _EmptyBatchHandle()
        return self._dispatch(jobs, penalty, do_fine, single=False)

    def _dispatch(self, jobs, penalty, do_fine, single):
        # rows pad to a power of two (the rows past the jobs have no base
        # scan, and their results are dropped), so that batches of nearby
        # sizes share one CUDA graph
        args, P, S = self._prepare(jobs, n_pad=_pow2(len(jobs)))
        packed, grid0 = self._run(args, P, bool(penalty), bool(do_fine),
                                  self.config.coarse_search_angle_offset, S)
        return _MatchHandle(self, (_host_copy_async(packed), grid0), args, P,
                            penalty, do_fine, S, single, len(jobs))

    def match_many_mega(self, jobs, penalty=True, do_fine=True, chunk=16):
        """Score an arbitrarily long job list in device chunks of `chunk`
        jobs with one host copy at the end; results equal
        :meth:`match_many`'s (jobs needing response expansion are retried
        afterwards as widened batches)."""
        if not jobs:
            return []
        args, P, S = self._prepare(jobs)
        offset = self.config.coarse_search_angle_offset
        packs = [
            self._run(tuple(a[i:i + chunk] for a in args), P, bool(penalty),
                      bool(do_fine), offset, S)[0]
            for i in range(0, len(jobs), chunk)
        ]
        pending = (_host_copy_async(torch.cat(packs)), None)
        return self._finish(pending, args, P, penalty, do_fine, S,
                            with_meta=False, n=len(jobs))

    def _finish(self, pending, args, P, penalty, do_fine, S, with_meta, n):
        """Blocking tail of a dispatched batch of `n` jobs (the rows past
        them are padding): wait for the packed result, retry the jobs whose
        coarse response is empty, assemble.  With `with_meta`, job 0's
        result carries the grid of its last attempt."""
        wait, grid0 = pending
        packed = wait()[:n]
        offset = self.config.coarse_search_angle_offset
        need = [
            j for j in range(len(packed))
            if float(packed[j, 0, 0]) <= 0.0 and self.config.use_response_expansion
        ]
        retried = (
            self._expansion_retries(args, need, P, penalty, do_fine, S)
            if need else {}
        )
        center = args[4]
        results = []
        for j in range(len(packed)):
            c, f, off, grid = retried.get(
                j, (packed[j, 0], packed[j, 1], offset, grid0 if j == 0 else None))
            results.append(self._assemble(
                c, f, do_fine, center=center[j], coarse_offset=off,
                grid=grid if with_meta else None))
        return results

    def _expansion_retries(self, args, rows, P, penalty, do_fine, S):
        """Response expansion: one widened batch over all empty-response
        rows per attempt; a row adopts the first attempt with a positive
        coarse response, or the last attempt.  Returns
        {row: (coarse, fine, coarse_offset, grid)}, grid being the
        attempt's grid for the batch's first row (else None)."""
        cfg = self.config
        rows_a = np.asarray(rows, dtype=np.int64)
        sub_args = tuple(a[rows_a] for a in args)
        out = {}
        remaining = set(range(len(rows_a)))
        for attempt in range(_EXPANSION_TRIES):
            coarse_offset = (
                cfg.coarse_search_angle_offset + (attempt + 1) * _EXPANSION_STEP
            )
            packed, grid0 = self._run(sub_args, P, bool(penalty),
                                      bool(do_fine), coarse_offset, S)
            packed = packed.cpu().numpy()
            last = attempt == _EXPANSION_TRIES - 1
            for k in sorted(remaining):
                coarse, fine = packed[k, 0], packed[k, 1]
                if float(coarse[0]) > 0.0 or last:
                    out[int(rows_a[k])] = (coarse, fine, coarse_offset,
                                           grid0 if k == 0 else None)
                    remaining.discard(k)
            if not remaining:
                break
        return out

    @staticmethod
    def _arange_mean(start, stop, step):
        """Mean of np.arange(start, stop, step), the reference's lattice at
        a float center."""
        vals = np.arange(start, stop, step)
        return float(vals.mean()) if len(vals) else start

    def _degenerate_fixup(self, coarse, fine, do_fine, center_xyt,
                          coarse_offset):
        """Reference-exact best pose for zero-response matches: when the
        device result is the full-lattice tie mean, recompute it on the host
        with np.arange at the actual centers (the reference's lattice holds
        one more boundary candidate whenever extent/step is an integer)."""
        cfg = self.config
        res = cfg.resolution
        cx, cy, ct = (float(v) for v in center_xyt[:3])
        s = 0.5 * cfg.search_size
        so = 0.5 * coarse_offset
        dt = self.np_dtype

        def _tol(v, step):
            return min(0.25 * step,
                       max(1e-6, 256.0 * float(np.spacing(dt(abs(v) + 1.0)))))

        stat_x = cx + float(np.arange(-s, s, res * 2).mean())
        stat_y = cy + float(np.arange(-s, s, res * 2).mean())
        stat_t = ct + float(
            np.arange(-so, so, cfg.coarse_angle_resolution).mean()
        )
        if not (
            abs(float(coarse[1]) - stat_x) < _tol(stat_x, res * 2)
            and abs(float(coarse[2]) - stat_y) < _tol(stat_y, res * 2)
            and abs(float(coarse[3]) - stat_t)
            < _tol(stat_t, cfg.coarse_angle_resolution)
        ):
            return coarse, fine
        bx = self._arange_mean(cx - s, cx + s, res * 2)
        by = self._arange_mean(cy - s, cy + s, res * 2)
        bt = self._arange_mean(ct - so, ct + so, cfg.coarse_angle_resolution)
        coarse = np.array(coarse, dtype=np.float64)
        coarse[1:4] = (bx, by, bt)
        if do_fine:
            fr = cfg.fine_search_angle_resolution
            fine = np.array(fine, dtype=np.float64)
            fine[1:4] = (
                self._arange_mean(bx - res * 2, bx + res * 2, res),
                self._arange_mean(by - res * 2, by + res * 2, res),
                self._arange_mean(bt - _FINE_ANGLE_SIZE,
                                  bt + _FINE_ANGLE_SIZE, fr),
            )
        else:
            fine = coarse
        return coarse, fine

    def _assemble(self, coarse, fine, do_fine, center=None, coarse_offset=None,
                  grid=None):
        cfg = self.config
        final_resp = float(fine[0] if do_fine else coarse[0])
        if center is not None and final_resp <= 0.0:
            if coarse_offset is None:
                coarse_offset = cfg.coarse_search_angle_offset
            coarse, fine = self._degenerate_fixup(
                coarse, fine, do_fine, center, coarse_offset
            )
        if do_fine:
            response, x, y, t = (float(v) for v in fine[:4])
            th = float(fine[7])
        else:
            response, x, y, t = (float(v) for v in coarse[:4])
            th = 4.0 * cfg.coarse_angle_resolution
        # xy covariance from the coarse pass, theta from the fine pass, as
        # the reference does
        xx, yy, xy = float(coarse[4]), float(coarse[5]), float(coarse[6])
        covar = np.array([[xx, xy, 0.0], [xy, yy, 0.0], [0.0, 0.0, th]])
        if self.sanitize_covariance:
            covar = sanitize_covariance(covar, cfg)
        meta = None
        if grid is not None:
            meta = {"grid": grid.to(self.dtype).cpu().numpy(),
                    "kernel": C.gaussian_kernel_2d(cfg.resolution, cfg.smear_deviation)}
        return ScanMatcherResult(
            response, covar, Transform.from_position_euler(x, y, 0, 0, 0, t), meta
        )

    # -- scan-set (submap) matching ------------------------------------------
    @staticmethod
    def _scan_set_points(query_scans):
        """Mean position of the query scans' poses, and all their world
        beam endpoints relative to it."""
        ox_real = float(np.mean([q.corrected_pose.x for q in query_scans]))
        oy_real = float(np.mean([q.corrected_pose.y for q in query_scans]))
        pts = [q.points() for q in query_scans]
        qx = np.concatenate([px - ox_real for px, _ in pts])
        qy = np.concatenate([py - oy_real for _, py in pts])
        return ox_real, oy_real, qx, qy

    def _match_explicit_query(self, base_scans, q_lx, q_ly, n_q, center_xyt,
                              viewpoint_xy, penalty, do_fine, P):
        """One match with explicit query points (not library-resident):
        the scan-set paths.  base_scans[0] stands in as the library query
        of the job assembly; its center and subgrid are replaced."""
        B = self._base_bucket(len(base_scans))
        (idx, mask, pose, q_idx, _, _, _), _ = self._assemble_jobs(
            [(base_scans[0], base_scans)], P, B
        )
        dt = self.np_dtype
        center = np.asarray(center_xyt, dtype=dt)[None]
        sox, soy, S = self._subgrid_for(
            base_scans, float(center_xyt[0]), float(center_xyt[1]), P
        )
        sub = np.array([[sox, soy]], dtype=np.int32)
        vp = np.asarray(viewpoint_xy, dtype=dt)[None]
        queries = (q_lx[None].astype(dt), q_ly[None].astype(dt),
                   np.asarray([n_q], dtype=np.int32))
        packed, grid0 = self._run(
            (idx, mask, pose, q_idx, center, vp, sub), P, bool(penalty),
            bool(do_fine), self.config.coarse_search_angle_offset, S,
            queries=queries,
        )
        packed = packed.cpu().numpy()
        return self._assemble(packed[0, 0], packed[0, 1], do_fine,
                              center=center[0], grid=grid0)

    def match_scan_sets(self, query_scans, base_scans, penalty=True,
                        do_fine=True):
        """Rigidly match a set of query scans against base scans (submap
        alignment).  The grid is centered on the query set's mean position;
        base points are validated against the LAST query scan's pose, as
        the reference does.  The result carries one corrected pose per
        query scan."""
        if not query_scans or not base_scans:
            raise ValueError("match_scan_sets needs query and base scans")
        ox_real, oy_real, qx, qy = self._scan_set_points(query_scans)
        oxy = Transform.from_position_euler(ox_real, oy_real, 0, 0, 0, 0)
        viewpoint = query_scans[-1].corrected_pose

        # the widened cap is kept, so the library re-queues at it
        P = max(self._ensure_point_cap(base_scans), _next_bucket(len(qx)))
        self._point_cap = P
        q_lx = np.full(P, _FAR)
        q_ly = np.full(P, _FAR)
        q_lx[: len(qx)] = qx
        q_ly[: len(qy)] = qy

        result = self._match_explicit_query(
            base_scans, q_lx, q_ly, len(qx),
            (ox_real, oy_real, 0.0), (viewpoint.x, viewpoint.y),
            penalty, do_fine, P,
        )
        diff = result.best_pose - oxy
        return ScanMatcherResult(
            result.response, result.covariance,
            [diff + q.corrected_pose for q in query_scans], result.meta,
        )

    @torch.no_grad()
    def match_scan_sets_with_map(self, cgrid, ox, oy, query_scans,
                                 penalty=True, do_fine=True):
        """Localize a set of query scans against a precomputed correlation
        grid (e.g. a saved map through
        mapping.occupancy_grid_map_to_correlation_grid; `cgrid` is an
        (H, W) array or tensor, (ox, oy) its world origin).  The coarse
        pass is the reference's literal search (+-0.25 m at 0.01 m,
        +-0.1 rad at 0.01 rad, grid res 0.05, unpenalized); the fine pass
        uses the matcher's resolution.  Both score on the element path,
        since 0.01 m is no multiple of the 0.05 m cell."""
        if not query_scans:
            raise ValueError("match_scan_sets_with_map needs query scans")
        cfg = self.config
        res = cfg.resolution
        dev = self.device
        dt = self.np_dtype
        ox_real, oy_real, qx, qy = self._scan_set_points(query_scans)
        oxy = Transform.from_position_euler(ox_real, oy_real, 0, 0, 0, 0)
        P = _next_bucket(len(qx))
        q_lx = np.full(P, _FAR, dtype=dt)
        q_ly = np.full(P, _FAR, dtype=dt)
        q_lx[: len(qx)] = qx
        q_ly[: len(qy)] = qy

        # pad to a square grid and quantize in the matcher dtype, as the
        # JAX package does
        grid = torch.as_tensor(cgrid).to(device=dev, dtype=self.dtype)
        H, W = grid.shape
        G = max(H, W)
        padded = torch.zeros((G, G), dtype=self.dtype, device=dev)
        padded[:H, :W] = grid
        qgrid = C.quantize_grid(padded)

        cx, cy, ct, gox, goy = torch.as_tensor(
            np.array([ox_real, oy_real, 0.0, ox, oy], dtype=dt), device=dev)
        px = torch.as_tensor(q_lx, device=dev)
        py = torch.as_tensor(q_ly, device=dev)
        n_pts = torch.tensor(len(qx), dtype=self.dtype, device=dev)
        coarse = C.find_best_pose(
            qgrid, px, py, n_pts, cx, cy, ct, gox, goy,
            spec=C.LatticeSpec.from_search(
                0.0, 0.0, 0.0, _MAP_COARSE["xy_size"], _MAP_COARSE["xy_res"],
                _MAP_COARSE["ang_size"], _MAP_COARSE["ang_res"]),
            grid_size=G, penalize=False, symmetric=False, **_MAP_COARSE,
        )
        if do_fine:
            fine = C.find_best_pose(
                qgrid, px, py, n_pts, coarse[1], coarse[2], coarse[3],
                gox, goy,
                spec=C.LatticeSpec.from_search(
                    0.0, 0.0, 0.0, res * 2, res, _FINE_ANGLE_SIZE,
                    cfg.fine_search_angle_resolution),
                xy_size=res * 2, xy_res=res, ang_size=_FINE_ANGLE_SIZE,
                ang_res=cfg.fine_search_angle_resolution, grid_size=G,
                grid_res=res, penalize=bool(penalty), symmetric=False,
            )
        else:
            fine = coarse
        packed = torch.stack([coarse, fine]).cpu().numpy()
        # no search center: the zero-response fixup does not apply here
        result = self._assemble(packed[0], packed[1], do_fine)
        diff = result.best_pose - oxy
        return ScanMatcherResult(
            result.response, result.covariance,
            [q.corrected_pose + diff for q in query_scans], result.meta,
        )


# API-parity alias (the reference's Scan2DMatcher)
Scan2DMatcher = CorrelativeScanMatcher
