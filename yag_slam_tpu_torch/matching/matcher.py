"""Correlative scan matcher, in PyTorch.

Counterpart of ``yag_slam_tpu/matching/matcher.py``: same config keys,
same ``ScanMatcherResult``, same ``match_scan`` / ``match_many`` contract.

- a **device-resident scan library** holds every scan's matcher view
  (compacted beam endpoints + validation-run structure) in (K, P) tensors,
  uploaded in batches; a match carries only slot indices, poses and the
  search center;
- the host picks a tight, bucketed **subgrid** around the occupied bounding
  box of each match; cells outside it are provably zero, so building and
  scoring against it is exact;
- each dispatch builds the quantized grids (kernels ``scatter_cells`` and
  ``smear_quantize``), scores the coarse and fine lattices
  (kernel ``window_sum``) and reduces them on the device, then copies one
  (N, 2, 8) tensor to the host.
"""
from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from yag_slam_tpu.core.config import make_config
from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu_torch.matching import correlation as C

ScanMatcherResult = namedtuple(
    "ScanMatcherResult", ["response", "covariance", "best_pose", "meta"]
)

# Far-away sentinel for padded point lanes: maps out of any grid, so the
# lane contributes exactly 0 to every score.
_FAR = 1.0e9

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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scan_matcher_view(scan, cap: int):
    """Cached, pose-independent host view of a scan: compacted local beam
    endpoints + validation-run structure.  Shares the cache key of the JAX
    package, so both matchers reuse one view of a scan."""
    key = ("matcher_view", cap)
    if key not in scan._points_cache:
        lx, ly, n = scan.local_points_padded(cap)
        a, t, h = C.segment_validation_runs(lx, ly, n)
        anchor = np.zeros(cap, dtype=np.int32)
        term = np.zeros(cap, dtype=np.int32)
        has = np.zeros(cap, dtype=bool)
        anchor[:n], term[:n], has[:n] = a, t, h
        scan._points_cache[key] = dict(
            lx=lx, ly=ly, anchor=anchor, term=term, has_run=has, n=n
        )
    return scan._points_cache[key]


class DeviceScanLibrary:
    """Device-resident store of scan matcher views: (K, P) tensors per
    field, addressed by slot.

    Uploads are deferred: ``ensure`` assigns slots (host bookkeeping only)
    and queues the scans; the next read of ``.fields`` copies every queued
    scan in one host-to-device transfer per field.  Slots are keyed by the
    identity of the scan's shared points cache, so ``LocalizedRangeScan.copy``
    (the loop-closure temp scans) aliases the original's slot."""

    def __init__(self, dtype, device):
        self.dtype = dtype
        self.device = device
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
        views = [scan_matcher_view(s, self.P) for _, s in pending]
        rows = dict(
            lx=np.stack([v["lx"] for v in views]).astype(np_dtype),
            ly=np.stack([v["ly"] for v in views]).astype(np_dtype),
            anchor=np.stack([v["anchor"] for v in views]),
            term=np.stack([v["term"] for v in views]),
            has_run=np.stack([v["has_run"] for v in views]),
            n=np.asarray([v["n"] for v in views], dtype=np.int32),
        )
        slots = torch.as_tensor([sl for sl, _ in pending], dtype=torch.long,
                                device=self.device)
        for k, v in rows.items():
            self._fields[k].index_copy_(
                0, slots, torch.from_numpy(v).to(self.device))

    def ensure(self, scans, P):
        """Give every scan a slot at point capacity P (uploads are queued);
        returns the slots aligned with `scans`."""
        if self._fields is None:
            self.P = P
            self.K_cap = _LIBRARY_INITIAL_CAP
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
        return np.asarray(out, dtype=np.int64)


class CorrelativeScanMatcher:
    """Correlative scan matcher (coarse-to-fine, with response expansion)
    running on one torch device.

    ``device`` is required: CUDA tensors go through the hand-written
    kernels, CPU tensors through their plain PyTorch versions.  ``meta`` is
    always None (the grid stays on the device)."""

    def __init__(self, config_dict=None, loop: bool = False, *, device,
                 dtype=torch.float32):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if dtype not in _NP_DTYPES:
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.config = make_config(config_dict, loop)
        cfg = self.config
        self.grid_size = int(
            cfg.search_size / cfg.resolution
            + 1
            + 2 * cfg.range_threshold / cfg.resolution
        )
        self.dtype = dtype
        self.np_dtype = _NP_DTYPES[dtype]
        self._point_cap = None
        self._k1 = C.gaussian_kernel_1d(cfg.resolution, cfg.smear_deviation)
        self._half = (len(self._k1) - 1) // 2
        # float32 taps, as the TPU kernels use them
        self._taps = torch.as_tensor(self._k1.astype(np.float32), device=self.device)
        self.library = DeviceScanLibrary(dtype, self.device)

    # -- capacity management ------------------------------------------------
    def _ensure_point_cap(self, scans) -> int:
        need = max(s.num_valid_beams for s in scans)
        if self._point_cap is None or self._point_cap < need:
            self._point_cap = _next_bucket(need)
        return self._point_cap

    @staticmethod
    def _base_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    # -- subgrid selection ----------------------------------------------------
    def _max_sub(self):
        return _round_up(self.grid_size, 128)

    @staticmethod
    def _scan_world_bbox(s, P):
        """World-frame bbox of a scan's padded view at its corrected pose,
        cached per (pose, P) on the scan's shared points cache."""
        p = s.corrected_pose
        t = p.euler[-1]
        key = ("wbbox", P, p.x, p.y, t)
        cache = s._points_cache
        hit = cache.get(key)
        if hit is None:
            v = scan_matcher_view(s, P)
            c, sn = np.cos(t), np.sin(t)
            wx = p.x + c * v["lx"] - sn * v["ly"]
            wy = p.y + sn * v["lx"] + c * v["ly"]
            hit = (wx.min(), wx.max(), wy.min(), wy.max())
            for k in [k for k in cache if k[0] == "wbbox" and k != key]:
                del cache[k]
            cache[key] = hit
        return hit

    def _subgrid_for(self, base_scans, center_x, center_y, P):
        """Host-side tight occupied-bbox subgrid: (sox, soy, S).  Exact:
        every base point inside the full grid lands inside the subgrid
        (+ smear halo), so all other cells are zero."""
        cfg = self.config
        res = cfg.resolution
        G = self.grid_size
        h = self._half
        ox = center_x - 0.5 * (G - 1) * res
        oy = center_y - 0.5 * (G - 1) * res

        minx = miny = np.inf
        maxx = maxy = -np.inf
        for s in base_scans:
            x0, x1, y0, y1 = self._scan_world_bbox(s, P)
            minx = min(minx, x0)
            maxx = max(maxx, x1)
            miny = min(miny, y0)
            maxy = max(maxy, y1)

        gminx = int(np.clip(np.floor((minx - ox) / res) - 1, 0, G - 1))
        gmaxx = int(np.clip(np.ceil((maxx - ox) / res) + 1, 0, G - 1))
        gminy = int(np.clip(np.floor((miny - oy) / res) - 1, 0, G - 1))
        gmaxy = int(np.clip(np.ceil((maxy - oy) / res) + 1, 0, G - 1))
        span = max(gmaxx - gminx, gmaxy - gminy) + 1 + 2 * h + 4

        s_max = self._max_sub()
        S = s_max
        for b in _SUB_BUCKETS:
            if b >= span and b < s_max:
                S = b
                break
        if S >= G:
            return 0, 0, S
        sox = int(np.clip(gminx - h - 2, 0, G - S))
        soy = int(np.clip(gminy - h - 2, 0, G - S))
        return sox, soy, S

    # -- the match program ------------------------------------------------------
    def _specs(self, coarse_offset):
        cfg = self.config
        res = cfg.resolution
        coarse = C.LatticeSpec.from_search(
            0.0, 0.0, 0.0, cfg.search_size * 0.5, res * 2,
            coarse_offset * 0.5, cfg.coarse_angle_resolution,
        )
        fine = C.LatticeSpec.from_search(
            0.0, 0.0, 0.0, res * 2, res,
            _FINE_ANGLE_SIZE, cfg.fine_search_angle_resolution,
        )
        return coarse, fine

    @torch.no_grad()
    def _run(self, args, P, penalty, do_fine, coarse_offset, S):
        """Grid build + coarse (+ fine) pass for a batch of jobs on the
        device; returns the packed (N, 2, 8) host array
        [coarse, fine] x (response, x, y, theta, XX, YY, XY, TH)."""
        cfg = self.config
        G = self.grid_size
        res = cfg.resolution
        h = self._half
        dev = self.device
        idx, mask, pose, q_idx, center, sub = args
        lib = self.library.fields
        idx_t = torch.as_tensor(idx, device=dev)
        q_t = torch.as_tensor(q_idx, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        pose_t = torch.as_tensor(pose, device=dev)
        center_t = torch.as_tensor(center, device=dev)
        sub_t = torch.as_tensor(sub, device=dev)

        base_lx = lib["lx"][idx_t]          # (N, B, P)
        base_ly = lib["ly"][idx_t]
        qlx = lib["lx"][q_t]                # (N, P)
        qly = lib["ly"][q_t]
        n_q = lib["n"][q_t]

        cx, cy, ct = center_t[:, 0], center_t[:, 1], center_t[:, 2]
        ox = cx - 0.5 * (G - 1) * res
        oy = cy - 0.5 * (G - 1) * res

        pc = torch.cos(pose_t[..., 2:3])
        ps = torch.sin(pose_t[..., 2:3])
        wx = pose_t[..., 0:1] + pc * base_lx - ps * base_ly
        wy = pose_t[..., 1:2] + ps * base_lx + pc * base_ly
        keep = C.keep_mask_for_viewpoint(
            wx, wy, lib["anchor"][idx_t], lib["term"][idx_t],
            lib["has_run"][idx_t], mask_t[..., None],
            cx[:, None, None], cy[:, None, None],
        )
        sox, soy = sub_t[:, 0], sub_t[:, 1]
        q2d = C.build_quantized_grid(wx, wy, keep, ox, oy, sox, soy,
                                     G=G, S=S, h=h, res=res, taps=self._taps)

        lane = torch.arange(P, device=dev)
        valid = lane[None, :] < n_q[:, None]
        qx = torch.where(valid, qlx, _FAR)
        qy = torch.where(valid, qly, _FAR)
        n_pts = n_q.to(self.dtype)

        coarse_spec, fine_spec = self._specs(coarse_offset)
        common = dict(grid_size=G, grid_res=res, penalize=penalty,
                      karto_penalties=cfg.karto_penalty_tuple())
        out, xv, yv, tv = C.score_lattice(
            q2d, qx, qy, n_pts, cx, cy, ct, ox, oy, sox, soy,
            spec=coarse_spec, xy_size=cfg.search_size * 0.5, xy_res=res * 2,
            ang_size=coarse_offset * 0.5, ang_res=cfg.coarse_angle_resolution,
            **common,
        )
        coarse = C.reduce_best_pose(out, xv, yv, tv)
        if do_fine:
            out, xv, yv, tv = C.score_lattice(
                q2d, qx, qy, n_pts, coarse[:, 1], coarse[:, 2], coarse[:, 3],
                ox, oy, sox, soy,
                spec=fine_spec, xy_size=res * 2, xy_res=res,
                ang_size=_FINE_ANGLE_SIZE,
                ang_res=cfg.fine_search_angle_resolution, **common,
            )
            fine = C.reduce_best_pose(out, xv, yv, tv)
        else:
            fine = coarse
        return torch.stack([coarse, fine], dim=1).cpu().numpy()

    # -- job assembly -----------------------------------------------------------
    def _assemble_jobs(self, jobs, P, B):
        """Host-side per-job metadata: library slots, poses, subgrids."""
        N = len(jobs)
        idx = np.zeros((N, B), dtype=np.int64)
        mask = np.zeros((N, B), dtype=bool)
        pose = np.zeros((N, B, 3), dtype=self.np_dtype)
        q_idx = np.zeros(N, dtype=np.int64)
        center = np.zeros((N, 3), dtype=self.np_dtype)
        sub = np.zeros((N, 2), dtype=np.int32)
        S = 0
        for j, (query, base_scans) in enumerate(jobs):
            slots = self.library.ensure(list(base_scans) + [query], P)
            idx[j, : len(base_scans)] = slots[:-1]
            q_idx[j] = slots[-1]
            mask[j, : len(base_scans)] = True
            for i, s in enumerate(base_scans):
                p = s.corrected_pose
                pose[j, i] = (p.x, p.y, p.euler[-1])
            p = query.corrected_pose
            center[j] = (p.x, p.y, p.euler[-1])
            sox, soy, S_j = self._subgrid_for(base_scans, p.x, p.y, P)
            sub[j] = (sox, soy)
            S = max(S, S_j)
        return (idx, mask, pose, q_idx, center, sub), S

    # -- public API -----------------------------------------------------------
    def match_scan(self, query, base_scans, penalty=True, do_fine=True):
        """Match `query` against `base_scans`; returns ScanMatcherResult
        with the covariance assembled from the coarse xy moments and the
        fine theta moment."""
        if not base_scans:
            raise ValueError("match_scan needs at least one base scan")
        return self.match_many([(query, base_scans)], penalty, do_fine)[0]

    def match_many(self, jobs, penalty=True, do_fine=True):
        """Score independent (query, base_scans) jobs in one batch.  Jobs
        whose coarse response is empty are retried together, one widened
        batch per expansion attempt."""
        if not jobs:
            return []
        if any(not bs for _, bs in jobs):
            raise ValueError("every job needs at least one base scan")
        all_scans = [q for q, _ in jobs] + [s for _, bs in jobs for s in bs]
        P = self._ensure_point_cap(all_scans)
        B = self._base_bucket(max(len(bs) for _, bs in jobs))
        args, S = self._assemble_jobs(jobs, P, B)
        offset = self.config.coarse_search_angle_offset
        packed = self._run(args, P, bool(penalty), bool(do_fine), offset, S)
        need = [
            j for j in range(len(jobs))
            if float(packed[j, 0, 0]) <= 0.0 and self.config.use_response_expansion
        ]
        retried = (
            self._expansion_retries(args, need, P, penalty, do_fine, S)
            if need else {}
        )
        center = args[4]
        results = []
        for j in range(len(jobs)):
            c, f, off = retried.get(j, (packed[j, 0], packed[j, 1], offset))
            results.append(self._assemble(c, f, do_fine, center=center[j],
                                          coarse_offset=off))
        return results

    def _expansion_retries(self, args, rows, P, penalty, do_fine, S):
        """Response expansion: one widened batch over all empty-response
        rows per attempt; a row adopts the first attempt with a positive
        coarse response, or the last attempt.  Returns
        {row: (coarse, fine, coarse_offset)}."""
        cfg = self.config
        rows_a = np.asarray(rows, dtype=np.int64)
        sub_args = tuple(a[rows_a] for a in args)
        out = {}
        remaining = set(range(len(rows_a)))
        for attempt in range(_EXPANSION_TRIES):
            coarse_offset = (
                cfg.coarse_search_angle_offset + (attempt + 1) * _EXPANSION_STEP
            )
            packed = self._run(sub_args, P, bool(penalty), bool(do_fine),
                               coarse_offset, S)
            last = attempt == _EXPANSION_TRIES - 1
            for k in sorted(remaining):
                coarse, fine = packed[k, 0], packed[k, 1]
                if float(coarse[0]) > 0.0 or last:
                    out[int(rows_a[k])] = (coarse, fine, coarse_offset)
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

    def _assemble(self, coarse, fine, do_fine, center=None, coarse_offset=None):
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
        covar = sanitize_covariance(
            np.array([[xx, xy, 0.0], [xy, yy, 0.0], [0.0, 0.0, th]]), cfg)
        return ScanMatcherResult(
            response, covar, Transform.from_position_euler(x, y, 0, 0, 0, t), None
        )

