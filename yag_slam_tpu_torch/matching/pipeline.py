"""Device-chained online sequential matching, in PyTorch.

Counterpart of ``yag_slam_tpu/matching/pipeline.py``.  The online loop is
sequential: scan k's corrected pose is scan k+1's search center, so the
blocking loop waits for every match.  Here the pose feedback stays on the
device.  A ``(K_cap, 3)`` pose tensor is aligned with the matcher's scan
library slots; each chained step

1. composes the previous query's device pose with the host's odometry
   prior to get the search center (:func:`se2_compose`, on the device),
2. gathers the base window's poses from the pose tensor,
3. runs the matcher's one match program (``CorrelativeScanMatcher._run``:
   grid build + coarse + fine), and
4. writes the fine best pose into the pose tensor at the query's slot
   (``index_copy_``; stream order makes the next step read it),

so consecutive matches follow one another on the device with no host wait.
The host launches, and copies packed results back once per group: one
step in streaming mode, ``sync_every`` steps in block mode.

The pose chain is float64 whatever the matcher's dtype.  The center is
rounded to the matcher dtype once, as the blocking loop's host-composed
center is, so the chained matches equal the blocking loop's in float32 too.

The subgrid is placed on the host from an odometry-composed estimate that
can lag the device's poses by the corrections since the last sync, so it is
widened by one step's worst-case correction.  At sync time, with the exact
poses in hand, each match's base occupancy (plus smear halo) is checked to
fit the subgrid it was scored against; a match that fails, or whose coarse
response is empty (response expansion cannot branch on the device), is
redone with everything chained after it as one synchronous forward sweep
through ``match_scan``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from yag_slam_tpu_torch.core import transform as T
from yag_slam_tpu_torch.core.transform import Transform
from yag_slam_tpu_torch.matching.matcher import _host_copy_async, _to_device


def se2_wrap(theta):
    """Wrap angle tensors to (-pi, pi] (``core.transform.se2_wrap``)."""
    return theta - 2.0 * math.pi * torch.floor((theta + math.pi) / (2.0 * math.pi))


def se2_compose(a, b):
    """a ∘ b for (..., 3) [x, y, theta] pose tensors."""
    ax, ay, at = a.unbind(-1)
    bx, by, bt = b.unbind(-1)
    c, s = torch.cos(at), torch.sin(at)
    return torch.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, se2_wrap(at + bt)], dim=-1
    )


class OnlineMatchPipeline:
    """Chained sequential matching against a sliding window of the last
    ``window`` scans.

    Usage::

        pipe = OnlineMatchPipeline(matcher, window=10, sync_every=8)
        pipe.seed(corrected_scans)          # pre-corrected history
        for scan in stream:
            pipe.push(scan)                 # launches, does not wait
        results = pipe.flush()              # copy back + apply poses

    ``push`` puts the host's odometry estimate on ``scan.corrected_pose``
    at once (later pushes place their subgrids with it); the device's pose
    replaces it at the next sync.  ``flush`` / ``drain`` return
    ScanMatcherResults in push order, equal to calling
    ``matcher.match_scan(scan, window)`` step by step.

    ``block_dispatch`` buffers ``sync_every`` steps and launches them back
    to back with one readback; streaming mode launches each step at its
    push.  ``lag_blocks`` > 0 leaves the newest groups unread at a sync, so
    their device-to-host copies (started at launch) overlap the next
    group's work.
    """

    def __init__(self, matcher, window: int = 10, sync_every: int = 8,
                 penalty: bool = True, do_fine: bool = True,
                 block_dispatch: bool = False, lag_blocks: int = 0):
        self.m = matcher
        self.window = int(window)
        self.sync_every = int(sync_every)
        self.penalty = bool(penalty)
        self.do_fine = bool(do_fine)
        self.lag_blocks = int(lag_blocks)
        self.block_dispatch = bool(block_dispatch)
        self._base = []          # current sliding window (host scans)
        # launched, unread groups: (steps, wait) where steps lists each
        # step's (scan, base_list, sub_used, prior) and wait() gives the
        # group's (K, 2, 8) packed results on the host
        self._inflight = []
        self._n_inflight = 0     # total steps across groups
        self._pending = []       # block mode: steps awaiting launch
        self._results = []       # completed ScanMatcherResults, push order
        self._poses = None       # device (K_cap, 3) float64 poses
        self._est = None         # host (3,) estimate of the last pushed pose
        self._last_odom = None   # host (3,) odometry of the last pushed scan
        self._S = 0              # sticky subgrid bucket
        # how often the sync-time check fell back to the blocking sweep,
        # and for how many matches
        self.stats = {"synced": 0, "redo_sweeps": 0, "redo_matches": 0}
        # subgrid slack for the host estimate's lag: one step's worst-case
        # correction (coarse half-search + fine extent); a larger lag is
        # caught by the sync-time check and the match redone
        cfg = matcher.config
        per_step = 0.5 * cfg.search_size + 2.0 * cfg.resolution
        self._margin_cells = int(np.ceil(per_step / cfg.resolution)) + 4

    # -- device pose tensor --------------------------------------------------
    def _ensure_poses(self):
        """Grow the pose tensor with the library's slot capacity."""
        K_cap = self.m.library.K_cap
        if self._poses is None:
            self._poses = torch.zeros((K_cap, 3), dtype=torch.float64,
                                      device=self.m.device)
        elif self._poses.shape[0] < K_cap:
            grown = torch.zeros((K_cap, 3), dtype=torch.float64,
                                device=self.m.device)
            grown[: self._poses.shape[0]] = self._poses
            self._poses = grown

    def _set_poses(self, slots, vals):
        self._ensure_poses()
        dev = self.m.device
        self._poses.index_copy_(
            0, _to_device(np.asarray(slots, dtype=np.int64), dev),
            _to_device(np.asarray(vals, dtype=np.float64).reshape(-1, 3), dev))

    @staticmethod
    def _xyt(pose: Transform):
        return np.array([pose.x, pose.y, pose.euler[-1]])

    # -- public API -----------------------------------------------------------
    def seed(self, scans):
        """Install pre-corrected scans as the window (their corrected_pose is
        trusted as it is).  Resets the stream: unflushed pushes, buffered
        or launched, are dropped; flush() first if their results matter."""
        self._pending = []
        self._inflight = []
        self._n_inflight = 0
        m = self.m
        P = m._ensure_point_cap(scans)
        slots = m.library.ensure(scans, P)
        self._set_poses(slots, [self._xyt(s.corrected_pose) for s in scans])
        self._base = list(scans)[-self.window:]
        last = self._base[-1]
        self._est = self._xyt(last.corrected_pose)
        self._last_odom = self._xyt(last.odom_pose)

    def _clip_sub(self, sox, soy, S):
        G = self.m.grid_size
        if S >= G:
            return 0, 0
        return (int(np.clip(sox, 0, G - S)), int(np.clip(soy, 0, G - S)))

    def push(self, scan):
        """Queue the chained match of `scan` against the current window.
        Does not wait for the device; syncs every `sync_every` pushes."""
        if not self._base:
            raise RuntimeError("seed() the pipeline before push()")
        m = self.m
        base = list(self._base)
        odom = self._xyt(scan.odom_pose)
        prior = T.se2_relative(odom, self._last_odom)
        self._last_odom = odom
        est = T.se2_compose(self._est, prior)
        self._est = est
        # the host estimate places later pushes' subgrids; the device's
        # pose replaces it at sync
        scan.corrected_pose = Transform.from_xyt(*est)

        P = m._ensure_point_cap(base + [scan])
        B = m._base_bucket(len(base))
        slots = m.library.ensure(base + [scan], P)
        idx = np.zeros(B, dtype=np.int64)
        mask = np.zeros(B, dtype=bool)
        idx[: len(base)] = slots[:-1]
        mask[: len(base)] = True
        sox, soy, S_j = m._subgrid_for(
            base, float(est[0]), float(est[1]), P,
            margin_cells=self._margin_cells,
        )
        # sticky subgrid bucket: grows, never shrinks mid-stream
        self._S = min(max(self._S, S_j), m._max_sub())
        self._pending.append(dict(
            scan=scan, base=base, idx=idx, mask=mask, q_idx=slots[-1],
            prev_idx=slots[len(base) - 1], prior=prior, sox=sox, soy=soy))
        self._base = (self._base + [scan])[-self.window:]

        if self.block_dispatch:
            if len(self._pending) >= self.sync_every:
                self._dispatch()
                self._sync(keep=self.lag_blocks)
            return
        self._dispatch()
        if self._n_inflight >= self.sync_every + self.lag_blocks:
            self._sync(keep=self.lag_blocks)

    def _dispatch(self):
        """Launch the buffered steps, chained on the device, as one group
        with one device-to-host copy."""
        steps, self._pending = self._pending, []
        if not steps:
            return
        m = self.m
        dev = m.device
        P = m._point_cap
        S = self._S
        # the base bucket can differ across steps while the window fills;
        # pad to the largest (slot 0 with mask False adds nothing)
        B = max(len(st["idx"]) for st in steps)
        subs = [self._clip_sub(st["sox"], st["soy"], S) for st in steps]
        up = lambda a: _to_device(np.asarray(a), dev)  # noqa: E731
        idx = up([np.pad(st["idx"], (0, B - len(st["idx"]))) for st in steps])
        mask = up([np.pad(st["mask"], (0, B - len(st["mask"]))) for st in steps])
        q_idx = up(np.array([st["q_idx"] for st in steps], dtype=np.int64))
        prev_idx = up(np.array([st["prev_idx"] for st in steps], dtype=np.int64))
        prior = up(np.array([st["prior"] for st in steps], dtype=np.float64))
        sub = up(np.array(subs, dtype=np.int32))
        self._ensure_poses()
        offset = m.config.coarse_search_angle_offset
        packs = []
        for k in range(len(steps)):
            row = slice(k, k + 1)
            center = se2_compose(self._poses[prev_idx[row]], prior[row]).to(m.dtype)
            pose_b = self._poses[idx[row]].to(m.dtype)
            packed, _ = m._run(
                (idx[row], mask[row], pose_b, q_idx[row], center, center[:, :2],
                 sub[row]),
                P, self.penalty, self.do_fine, offset, S,
            )
            self._poses.index_copy_(0, q_idx[row],
                                    packed[:, 1, 1:4].to(torch.float64))
            packs.append(packed)
        packed = packs[0] if len(packs) == 1 else torch.cat(packs)
        entry = [
            (st["scan"], st["base"], (sx, sy, S), st["prior"])
            for st, (sx, sy) in zip(steps, subs)
        ]
        self._inflight.append((entry, _host_copy_async(packed)))
        self._n_inflight += len(steps)

    def drain(self):
        """Return (and clear) the results completed so far, without forcing
        a sync of launched work."""
        out = self._results
        self._results = []
        return out

    def flush(self):
        """Sync all launched matches, apply their poses, and return every
        pending result in push order."""
        self._sync()
        return self.drain()

    # -- sync -----------------------------------------------------------------
    def _subgrid_valid(self, base, center_xyt, sub_used):
        """With the device's poses applied to `base`, was the subgrid this
        match was scored against enough?  Enough = every base point inside
        the full grid, plus its smear halo, lands inside the subgrid; then
        every subgrid cell is exact and every read outside it is truly
        zero, so the score equals the blocking loop's."""
        m = self.m
        sox, soy, S = sub_used
        G = m.grid_size
        if S >= G:
            return True
        res = m.config.resolution
        h = m._half
        ox = float(center_xyt[0]) - 0.5 * (G - 1) * res
        oy = float(center_xyt[1]) - 0.5 * (G - 1) * res
        boxes = m._world_bboxes(base, m._point_cap)
        minx, maxx = boxes[:, 0].min(), boxes[:, 1].max()
        miny, maxy = boxes[:, 2].min(), boxes[:, 3].max()
        # conservative cell bounds (half-even rounding is within the +-1)
        gminx = int(np.floor((minx - ox) / res)) - 1
        gmaxx = int(np.ceil((maxx - ox) / res)) + 1
        gminy = int(np.floor((miny - oy) / res)) - 1
        gmaxy = int(np.ceil((maxy - oy) / res)) + 1
        # points outside the full grid are dropped on the device; only
        # cells in [0, G) must be covered (+ smear halo h)
        return (
            max(gminx - h, 0) >= sox
            and min(gmaxx + h, G - 1) <= sox + S - 1
            and max(gminy - h, 0) >= soy
            and min(gmaxy + h, G - 1) <= soy + S - 1
        )

    def _sync(self, keep=0):
        # a flush (keep=0) launches a partial block first; lagged syncs
        # never force it out
        if self._pending and keep == 0:
            self._dispatch()
        if len(self._inflight) <= keep:
            return
        cut = len(self._inflight) - keep
        groups = self._inflight[:cut]
        kept = self._inflight[cut:]
        self._inflight = kept
        self._n_inflight = sum(len(steps) for steps, _ in kept)
        host = np.concatenate([wait().reshape(-1, 2, 8) for _, wait in groups])
        inflight = [st for (steps, _) in groups for st in steps]
        m = self.m
        redo_from = None
        for k, ((scan, base, sub_used, prior), row) in enumerate(
                zip(inflight, host)):
            coarse, fine = row[0], row[1]
            # the chain's exact center for this step: the previous scan's
            # exact pose (applied in the previous iteration or sync)
            # composed with the odometry prior
            center = T.se2_compose(self._xyt(base[-1].corrected_pose), prior)
            needs_expansion = (
                float(coarse[0]) <= 0.0 and m.config.use_response_expansion
            )
            if needs_expansion or not self._subgrid_valid(
                    base, center, sub_used):
                redo_from = k
                break
            res = m._assemble(coarse, fine, self.do_fine, center=center)
            scan.corrected_pose = res.best_pose
            self._results.append(res)
        self.stats["synced"] += len(inflight)
        if redo_from is not None and kept:
            # the still-lagged groups chained off the bad pose on the
            # device: fold their steps into the sweep, drop their results
            inflight = inflight + [st for (steps, _) in kept for st in steps]
            self._inflight = []
            self._n_inflight = 0
            kept = []
        if redo_from is not None:
            self.stats["redo_sweeps"] += 1
            self.stats["redo_matches"] += len(inflight) - redo_from
            # one blocking match_scan per remaining step, each centered on
            # the previous scan's exact pose composed with the odometry
            # delta; match_scan applies response expansion itself
            slots, vals = [], []
            for scan, base, _, _ in inflight[redo_from:]:
                prev = base[-1]
                scan.corrected_pose = prev.corrected_pose + (
                    scan.odom_pose - prev.odom_pose
                )
                res = m.match_scan(scan, base, self.penalty, self.do_fine)
                scan.corrected_pose = res.best_pose
                self._results.append(res)
                slots.append(m.library.ensure([scan], m._point_cap)[0])
                vals.append(self._xyt(res.best_pose))
            self._set_poses(slots, vals)
        # reset the host estimate: the last synced scan's exact pose,
        # advanced by odometry to the last pushed scan (identity when
        # nothing is still in flight)
        last_scan = inflight[-1][0]
        exact = self._xyt(last_scan.corrected_pose)
        self._est = T.se2_compose(
            exact, T.se2_relative(self._last_odom,
                                  self._xyt(last_scan.odom_pose))
        )
