"""Offline mapping CLI on the port.

Counterpart of ``yag_slam_tpu/apps/offline_mapper.py``: build a map and
pose graph from a CARMEN log or a synthetic world on one torch device,
save the checkpoint and the rendered map, and report throughput and ATE.
``--device`` defaults to ``cuda`` and raises when no card is there; there
is no CPU fallback (``--device cpu`` runs the plain path on purpose).

Usage:
  yag-slam-tpu-torch-mapper --carmen intel.clf --out runs/intel
  yag-slam-tpu-torch-mapper --synthetic-laps 2 --out runs/sim --stream
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_carmen(args):
    from yag_slam_tpu_torch.io.carmen import load_carmen_log
    from yag_slam_tpu_torch.apps.online import OnlineMapper

    scans = load_carmen_log(args.carmen, max_scans=args.max_scans)
    print(f"loaded {len(scans)} scans from {args.carmen}")
    seq_cfg = {"range_threshold": args.range_threshold,
               "use_karto_penalties": args.karto_penalties}
    loop_cfg = {"range_threshold": args.range_threshold,
                "use_karto_penalties": args.karto_penalties}
    if args.resolution is not None:
        seq_cfg["resolution"] = args.resolution
    if args.search_size is not None:
        seq_cfg["search_size"] = args.search_size
    if args.smear_deviation is not None:
        seq_cfg["smear_deviation"] = args.smear_deviation
    if args.loop_resolution is not None:
        loop_cfg["resolution"] = args.loop_resolution
    if args.loop_search_size is not None:
        loop_cfg["search_size"] = args.loop_search_size
    mapper = OnlineMapper(
        seq_config=seq_cfg,
        loop_config=loop_cfg,
        device=args.device,
        min_distance=args.min_distance,
        min_rotation=args.min_rotation,
        range_threshold=args.range_threshold,
        map_resolution=args.map_resolution,
        loop_search_distance=args.loop_search_distance,
        loop_search_min_chain_size=args.loop_min_chain,
        min_response_coarse=args.min_response_coarse,
        min_response_fine=args.min_response_fine,
    )
    t0 = time.perf_counter()
    integrated_idx = []
    if args.stream:
        # streamed ingestion: chained match blocks on the device, loop
        # closure at block ends (the same results as the per-scan loop)
        prepared = []
        for i, cs in enumerate(scans):
            s = mapper._prepare_scan(
                cs.ranges, cs.min_angle, cs.max_angle, cs.angle_increment,
                0.0, cs.max_range, (cs.odom_x, cs.odom_y, cs.odom_theta),
            )
            if s is not None:
                prepared.append(s)
                integrated_idx.append(i)
        mapper.add_scans_batch_stream(prepared, sync_every=args.sync_every)
    else:
        for i, cs in enumerate(scans):
            ok, _, _ = mapper.add_scan(
                cs.ranges, cs.min_angle, cs.max_angle, cs.angle_increment,
                0.0, cs.max_range, (cs.odom_x, cs.odom_y, cs.odom_theta),
            )
            if ok:
                integrated_idx.append(i)
    elapsed = time.perf_counter() - t0
    integrated = len(integrated_idx)
    print(
        f"integrated {integrated}/{len(scans)} scans in {elapsed:.3f} s "
        f"({integrated / max(elapsed, 1e-9):.3f} scans/s), "
        f"{mapper.slam.stats['loop_closures']} loop closures"
    )
    gt = odom = None
    if args.gt:
        # ground-truth sidecar, one xyt row per log scan; subset to the
        # integrated scans
        rows = np.asarray(integrated_idx, dtype=int)
        gt = np.loadtxt(args.gt)[rows]
        odom = np.array([[scans[i].odom_x, scans[i].odom_y] for i in rows])
    return mapper, gt, odom, integrated, elapsed


def run_synthetic(args):
    from yag_slam_tpu_torch.io.simulator import (
        SimWorld, drifted_odometry, simulate_scan, square_loop_trajectory,
    )
    from yag_slam_tpu_torch.apps.online import OnlineMapper

    world = SimWorld.office()
    gt = square_loop_trajectory(side=5.0, step=0.5, laps=args.synthetic_laps,
                                start=(-2.5, -2.5))
    odom = drifted_odometry(gt, yaw_bias=0.003, seed=7)
    rng = np.random.default_rng(3)
    mapper = OnlineMapper(
        seq_config={"range_threshold": 5.0, "search_size": 0.5,
                    "resolution": 0.02, "smear_deviation": 0.05,
                    "use_karto_penalties": args.karto_penalties},
        loop_config={"range_threshold": 5.0, "search_size": 2.0,
                     "resolution": 0.05, "smear_deviation": 0.05,
                     "use_karto_penalties": args.karto_penalties},
        device=args.device,
        min_distance=0.0,  # the trajectory is gated already
        min_rotation=0.0,
        range_threshold=5.0,
        loop_search_distance=2.0,
        loop_search_min_chain_size=5,
        min_response_coarse=0.35,
        min_response_fine=0.45,
        map_resolution=args.map_resolution,
    )
    mapper.min_distance = -1.0  # integrate every pose
    t0 = time.perf_counter()
    scans = [
        simulate_scan(world, gt[i], n_beams=250, range_threshold=5.0,
                      noise=0.004, rng=rng, odom_pose_xyt=odom[i])
        for i in range(len(gt))
    ]
    if args.stream:
        mapper.slam.process_scan_stream(scans, sync_every=args.sync_every)
    else:
        for scan in scans:
            mapper.slam.process_scan(scan)
    elapsed = time.perf_counter() - t0
    print(
        f"processed {len(gt)} scans in {elapsed:.3f} s "
        f"({len(gt) / elapsed:.3f} scans/s), "
        f"{mapper.slam.stats['loop_closures']} loop closures"
    )
    return mapper, gt, odom[:, :2], len(gt), elapsed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--carmen", help="CARMEN log file (FLASER/ROBOTLASER1)")
    ap.add_argument("--gt", help="ground-truth sidecar (xyt row per scan)")
    ap.add_argument("--synthetic-laps", type=int, default=0)
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--out", default="yag_slam_tpu_torch_map",
                    help="path prefix of the .graph and .png outputs")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the matchers (cuda raises without "
                         "a card; cpu runs the plain path)")
    ap.add_argument("--range-threshold", type=float, default=20.0)
    ap.add_argument("--min-distance", type=float, default=0.5)
    ap.add_argument("--min-rotation", type=float, default=0.5)
    ap.add_argument("--map-resolution", type=float, default=0.05)
    # matcher grid overrides (None: the node defaults of
    # apps/online.DEFAULT_SEQ_CONFIG / DEFAULT_LOOP_CONFIG)
    ap.add_argument("--resolution", type=float, default=None)
    ap.add_argument("--smear-deviation", type=float, default=None)
    ap.add_argument("--search-size", type=float, default=None)
    ap.add_argument("--loop-resolution", type=float, default=None)
    ap.add_argument("--loop-search-size", type=float, default=None)
    ap.add_argument("--loop-search-distance", type=float, default=4.0)
    ap.add_argument("--loop-min-chain", type=int, default=10)
    ap.add_argument("--min-response-coarse", type=float, default=0.6)
    ap.add_argument("--min-response-fine", type=float, default=0.7)
    ap.add_argument("--karto-penalties", action="store_true",
                    help="score with OpenKarto's C++ penalty semantics "
                         "(clamped minimums, search-center offsets) "
                         "instead of the reference Python spec's")
    ap.add_argument("--stream", action="store_true",
                    help="streamed ingestion: chained match blocks on the "
                         "device with loop closure at block ends (the same "
                         "results as the per-scan loop)")
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--no-map-image", action="store_true",
                    help="skip the PNG render (benchmark runs)")
    args = ap.parse_args(argv)

    if args.carmen:
        mapper, gt, odom, integrated, elapsed = run_carmen(args)
    elif args.synthetic_laps:
        mapper, gt, odom, integrated, elapsed = run_synthetic(args)
    else:
        ap.error("need --carmen or --synthetic-laps")

    graph_path = mapper.save_graph(args.out + ".graph")
    print("saved graph:", graph_path)

    summary = {
        "vertices": len(mapper.slam.graph.vertices),
        "edges": len(mapper.slam.graph.edges),
        "loop_closures": mapper.slam.stats["loop_closures"],
        "integrated": integrated,
        "seconds": elapsed,
        "scans_per_s": integrated / max(elapsed, 1e-9),
    }
    if args.stream:
        summary["pipeline"] = {k: mapper.slam.stats["stream_" + k]
                               for k in ("synced", "redo_sweeps", "redo_matches")}
    if not args.no_map_image:
        _, grid = mapper.render_map()
        png_path = args.out + ".png"
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.imsave(png_path, grid.image[::-1], cmap="gray", vmin=0,
                       vmax=255)
            print("saved map image:", png_path)
        except Exception as e:  # pragma: no cover
            print("map image not saved:", e)
        summary["map_size"] = [grid.width, grid.height]
    if gt is not None:
        from yag_slam_tpu_torch.utils.metrics import ate_rmse, trajectory_from_slam

        est = trajectory_from_slam(mapper.slam)
        summary["ate_rmse"] = ate_rmse(est, gt[:, :2], align=False)
        summary["ate_rmse_odom"] = ate_rmse(odom, gt[:, :2], align=False)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
