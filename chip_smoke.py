#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE] [--kernels-only]

Phases, one line each; any failure raises (non-zero exit):
  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from yag_slam_tpu_torch/csrc;
  3. compare each kernel with its plain PyTorch version on the card, at the
     SLAM main path's shapes (bit equality; the bare scatter_cells writes a
     grid of garbage); time the wrapper and the plain version, the bare
     kernel on preallocated outputs and the one-call PyTorch form where
     there is one (index_put_ for scatter_cells, a grouped F.conv2d for
     window_sum) by device time, beside the bound (HBM bytes or float32
     operations at the published peak); both smears also on a grid of tour
     scans; then both smears on {0,1} grids at three densities and
     window_sum at other point counts, bit-equal;
 3b. the matcher's program kernels (matching/program_kernels.py:
     world_scatter, the scatter_cells kernel fed by the base points in
     csrc/grid_build.cu; lattice_window_sum, the window_sum kernel fed by
     the query points in csrc/window_sum.cu; score_reduce in
     csrc/match_program.cu) against their plain twins on the card at the
     main path's batches, run by real matchers on the building tour's
     scans at odometry poses: the sequential coarse and fine passes (1
     job, 10 base scans), the loop matcher's coarse batch (4 jobs, 40^2
     lattice), the benchmark's office batch (61 jobs padded to 64),
     float64, OpenKarto's penalty, padded rows and an all-zero lattice;
     world_scatter's grid and limits and lattice_window_sum's sums
     bit-equal (the bare world_scatter writing over a grid of garbage);
     score_reduce's response, argmax and tie count bit-equal,
     its pose and moments within one ulp in float32 (rows apart counted)
     and 1e-12 relative in float64; the whole _compute equal to the
     kernels run in turn; each timed as wrapper, bare kernel and twin
     beside its bound, score_reduce's launch shape printed beside it;
     the fused kernels also on their edge cases (fused_cases: no base
     slot in use, more base scans than a block stages, points outside the
     grid, no query point, a count past the lanes); score_reduce also
     on lattices the main path does not give it (reduce_cases: a wide one
     on a cluster of blocks, one past eight blocks' shared memory, ties
     at +0 / -0, NaN and inf responses), each held to its twin the same
     way, its largest difference from the twin measured; the kernels'
     cos / sin bit-equal to torch.cos / torch.sin on the card over every
     angle met and a sweep of 2^20 (--kernels-only stops here);
 4a. the host ops (native/hostops.cpp, built into one library with the
     host SPA solve native/spa_lm.cpp) built on this machine's CPU (timed):
     the tour log parsed natively and by the Python parser, the same scans
     bit for bit; every scan's matcher view (beam compaction, validation
     runs) at the matchers' point capacity natively and by the numpy /
     Python twins, counts and runs bit-equal, points within 1e-14 m (the
     entries not bit-equal counted); both timed on the host CPU; then every
     view again in one call of the matchers' batched op (native.scan_views),
     bit-equal to the per-scan native views, timed a scan; phases 4 and 10
     then require the ops of the main path called (native.CALLS: the log
     parse and the batched views);
  4. run the building-tour CARMEN log through the port's GraphSlam at the
     default matcher configs in float32 on the card: require a loop
     closure, ATE below odometry's and every kernel launched (counted at
     each replay of the matcher's CUDA graphs); every SPA solve through the
     native host solve (native.CALLS["spa_lm"] equal to the solves), each
     solve's ms printed; report the graphs' keys,
     eager runs, captures and replays, and record each key's first
     arguments for phase 15; on every path but the map conversion's each
     scatter_cells launch is a world_scatter and each window_sum launch a
     lattice_window_sum, each followed by a score_reduce (counted from 0
     before each path), and the map conversion keeps its table-fed
     scatter; then hold
     the tour's first 300 scans against the plain path on the host CPU in
     float32, and its first 50 in float64, pose by pose;
  5. render the occupancy grid: make_occupancy_grid and the tour's
     prefixes k = 5, half and all through create_occupancy_grid, the
     render kernels' launches (csrc/render.cu, mapping.render_kernel)
     counted from 0 around them, one render_endpoints and one
     render_counts (the trace with the image in its merge) a render; a
     render waits for the card twice (set_sync_debug_mode "warn": the box
     and the image); at each
     prefix each stage's kernel bit-equal to its plain version on the card
     (seg, flag and the bounding box; the image, also the whole render's;
     the trace's counts mode, passes and hits), timed as wrapper, bare
     kernel, plain version and the whole render (host wall to the image on
     the host) beside each stage's bound and the event floor; the same
     over the map cell's two-lap tour at its odometry poses (k = 5, 416,
     833); the trace on its own cases (TRACE_CASES: beams from one cell,
     of 0 and 1 steps, clipped at max_steps, long and short within a
     warp) and the endpoints on theirs (ENDPOINT_CASES: scans of 0 to
     1,081 beams in one table, one all invalid, past one round of the
     grid) bit-equal to their plain versions; then round-trip a checkpoint
     file and continue 5 scans on the restored instance;
  6. trace a window of scans with torch.profiler and report the device's
     busy time and idle share (kernel, memcpy and memset events only),
     and each kernel's device us a launch;
  7. the matcher API at the default sequential config on the tour's SLAM
     poses: return_meta=True match_scan (results equal to the matcher
     without meta, meta grid bit-equal to the host's), match_scan_sets
     (3 query scans against the previous 10) and match_many_mega against
     match_many, each held to the plain path on the host in float32; mega
     again with each of its 4 chunk replays (one key) held bit for bit to a
     direct _compute on the same staged inputs;
  8. localize against the tour's map: convert the 0.05 m occupancy image
     on the card, offset 3 consecutive scans by (+0.08, -0.06) m and run
     match_scan_sets_with_map; poses back within 0.1 m of the SLAM poses
     and within 1e-6 of the host's float32 plain path; smear_grid at the
     map's shape bit-equal and timed bare beside its bound;
  9. stream: the tour through GraphSlam.process_scan_stream (blocks of 8,
     block dispatch) at the default configs in float32; after 300 scans
     the same counts as phase 4's blocking run and poses within 1e-4, over
     the whole tour closures within +-1 and ATE below odometry's; then the
     first 100 scans through OnlineMatchPipeline in block mode, in
     streaming mode with one lagged group and through the blocking
     match_scan loop, all equal; scans/s of each and the pipeline stats
     (the two pipeline modes' launches counted as path "pipeline");
     block mode again with every step's replay held bit for bit to
     _compute;
 10. entry points: the offline CLI in-process on the tour log (node
     defaults, --device cuda) per scan and with --stream, the same vertex
     and closure counts and ATE below odometry's; ThreadedOnlineMapper
     with 60 tour scans enqueued at once, drained, equal to the per-scan
     OnlineMapper on the card;
 11. lifelong: an OnlineMapper spliced into phase 4's map image
     (segmentation and raytracing on the card, held to the host's plain
     run), fed the tour's first 20 scans from their pose in the map, the
     sweep kernel's launches (csrc/sweep.cu, mapping.raytrace) counted
     from 0 around it: one a splice; the splice bootstrap links the first,
     the graph grows by 20, and the poses come back within 0.3 m of phase
     4's; the sweep kernel over every centroid of the card's labels, at
     one start (trace_rays' route), on a seeded 2048 x 2048 long-ray map
     and on the edge inputs (pixels at and beside 180 and 210, NaN, +-inf,
     negative; starts on the border, outside, on .5 pixels; max_steps 1, 2
     and the image's own; 650 rays) bit-equal to its plain version on the
     card (lengths and ends), the sweep waiting for the card twice (the
     copy up, the lengths back), the first three timed as wrapper, bare
     kernel and plain version beside their bounds;
     map_to_graph on the card (host wall, split into segment_map,
     determine_centroids, create_edges, the sweep and the scans'
     construction) beside the per-centroid routes: trace_rays (the
     kernel at one start) and the plain version with a copy up and back
     a centroid;
 12. SPA on the card (TF32 off), through profile_spa_torch.crossover: the
     noisy square-loop graph at 100-4000 nodes through SPA2d with the host,
     dense and cg solvers in mixed and float64 precision, cg at 100, 1000
     and 4000 nodes only (compute(100, 1e-4, True, 1e-9, 200), one warm
     call, best of 3, or the warm call alone where it takes over 5 s), each
     device solver held to host (cost within 1e-3 relative, poses within
     2e-3) at the sizes where the JAX package's same solver meets those bars
     on the CPU, elsewhere ending finite below its initial cost; ms, LM
     iterations and host reads per cell; the host cell (the native solve)
     also timed bare beside its numpy + SuperLU version
     graphopt.spa._host_lm on the same arrays, held to it at the tests'
     bars (the same stop reason and iterations, poses within 1e-8, cost
     within 1e-10 relative); then the tour again with
     SPA2d(solver="dense") on the card, held
     to phase 4's host-SPA run (the same counts and poses within 1e-4 after
     300 scans, closures within +-1, ATE below odometry's), SPA ms per
     solve beside phase 4's.
 13. the last modules, on a one-rank NCCL mesh (default_mesh): the tour
     with ShardedLoopMatcher as the loop matcher, then its loop-closure
     batches again through a fresh ShardedLoopMatcher, bit-equal to the
     plain match_many on every job with a positive response;
     DistributedSPA (cg mixed and float64 at 105 and 505 nodes, dense at
     105, 505 and 1005) beside host SPA, its cg equal to
     SPA2d(solver="cg") at one rank, and the 4,096-node serpentine graph
     held to host (cost 1e-5 relative, poses 1e-5); GraphSlam with both
     sharded over the 2-lap square loop (closures, ATE < 0.15 m);
     RefBaselineScanMatcher on the host CPU over the first 100 tour
     matches beside the card's; ab_compare --synthetic --device cuda
     (vertices equal, closures within 1, both ATEs below odometry's); and
     save_slam_figure of phase 4's map where matplotlib is installed.
 14. the benchmark's workload (bench_torch.py: 360-beam office scans at
     the reference's default config, G = 4051): bench_torch.bench_device's
     rows (the four OnlineMatchPipeline modes, the lockstep loop,
     match_many_mega and one-deep match_many_async x16 and x64, each the
     median of 3 repeats on fresh streams; the mega results equal to
     match_many's on every job), the first 4 batched jobs held to the
     host's plain path (float64 within 1e-9; float32 poses and covariances
     as in phases 7-8, responses within one point's cell flip), then
     profile_match_torch's stages of the match core at 16 jobs (one
     composed pass counted, each stage timed beside its bound).
 15. the matcher's CUDA graphs: every key phase 4's tour met (the
     sequential S buckets, the loop coarse and fine batches, the
     expansion offsets) run to a replay and held bit for bit to a direct
     _compute on the same staged inputs; the office batch of 64 through
     match_many_async with one batch in flight, every replay held and
     every result equal to _compute's after the next batch ran; then the
     office cell's traffic (8 fresh streams, 17 batches of 64): host ms of
     _prepare a batch (the batched views of its new scans timed apart) and
     of the library's flush, a view's us by the per-scan ops and by the
     batched op, and the wall ms a dispatch with one batch in
     flight, once every key is captured, every result finite and positive;
     match_scan_async (with and without meta), match_many_async, explicit
     queries, the pipeline's block dispatch and match_many_mega, three
     times each, under torch.cuda.set_sync_debug_mode("error") (nothing
     waits for the card before the result); captures, ms per capture,
     host us of a replayed dispatch against host ms of an eager _run;
     the device nodes (kernels, copies, fills) and busy ms of one replay
     of a captured sequential and a loop coarse _run of the tour, and of
     a whole dispatch, from torch.profiler.
Each path's kernel launches are counted from 0 just before it runs.  The
last lines are a JSON line of phase 14's results ({"bench": ...}), a JSON
line of the host ops' results ({"hostops": ...}), the "program:" line
(the device nodes of one captured sequential _run of the tour, the card's
busy ms a tour scan from phase 6, the card), a JSON line of per-kernel
results (ms is the bare kernel's device time at its main-path case;
launches_per_scan is phase 4's count over its scans), the nvidia-smi line
and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import os
import statistics
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

import bench_torch
import profile_match_torch
import profile_spa_torch
from bench_torch import same_result
from profile_spa_torch import pose_gap
from yag_slam_tpu_torch.utils.profiling import (
    bound, cpu_model, cuda_ms, device_ms, gpu_line, smear_bytes, smear_ops, window_bytes)

# (G, S, h) of the default sequential and loop matchers at the building
# tour, and the points per scan (P lanes, 180 beams used)
SEQ_G, SEQ_S, SEQ_H = 4051, 3072, 10
# the sequential subgrid most tour matches take (109 of 412; 768 to 3072
# in all), and the meta grid of phase 7
SEQ_MODE_S = 1792
LOOP_G, LOOP_S, LOOP_H = 881, 768, 2
P, N_BEAMS = 256, 180
NO_LIBRARY_SMEAR = ("none: a weighted max-dilation is no single PyTorch op "
                    "(max_pool2d is unweighted)")
SMEAR_DENSITIES = (0.001, 0.05, 0.5)
TOUR_GRID_SCANS = (60, 10)     # phase 3's tour grid: scans 60-69
WINDOW_POINTS = (1, 31, 180, 257, 2100)   # 2100: more than one staged chunk
HOLD_BACK = 5   # scans processed after the checkpoint round trip
# phase 5's renders: make_occupancy_grid's defaults, the prefixes' first
# (the online mapper's first render), whole renders timed a prefix
RENDER_RES, RENDER_RANGE, RENDER_FIRST, RENDER_TIMED = 0.05, 12.0, 5, 10
# the waits of a render: the box, which sizes the grid, and the image
RENDER_WAITS = 2
# float32 operations of the trace: a step (k * inv; x0 + dx * t and its y
# twin; for each axis a subtraction, a division, a rounding and two
# clamps) and a beam (dx, dy, two abs and divisions, max, ceil, two
# clamps, max, the reciprocal, and the endpoint's two cells); its atomics
# have no published peak rate to count them against
RENDER_STEP_OPS, RENDER_BEAM_OPS = 15, 22
RENDER_NO_LIBRARY = "none: no single PyTorch call traces rays into a grid"
# phase 5 also renders the map cell's tour (two laps) at its odometry poses
MAP_TOUR_SCANS = 833
# the trace's own cases (trace_case): every beam from one cell; beams of 0
# and 1 steps among longer ones; beams clipped at max_steps; long and
# short beams and invalid ones alternating within each warp's beams
TRACE_CASES = ("one_origin", "zero_steps", "clipped", "mixed_warp")
# the endpoints' own cases (endpoint_case): the beams a scan, in one table;
# each holds scans of 0, 1, 180, 360 and 1,081 beams, so the first beams
# step unevenly (0 where a scan is empty), and "mixed" a 180-beam scan
# whose ranges are all invalid; "past_one_round" has more beams than the
# kernel takes in one round (render_kernel.END_MAX_BLOCKS x 256)
ENDPOINT_CASES = {
    "mixed": (180, 0, 1, 1081, 360, 0, 0, 180, 1),
    "empty_ends": (0, 0, 1, 360, 1081, 180, 1, 0, 0),
    "past_one_round": None,
}
ENDPOINT_BEAM_COUNTS = (0, 1, 180, 360, 1081)
# The tour's first scans rerun on the host by the plain path, each as
# (dtype, scans, tolerance m, tolerance rad) for the card run's poses.
# float32: the first 300 scans (7 closures), same counts and poses within
# 1e-6; later closures meet near-ties that the card's and the CPU's
# rounding resolve apart.  float64: the first 50 (no closure yet), same
# vertex and closure counts; float32 may resolve a near-tie one lattice
# step away from float64, so poses within two sequential cells (2 x 0.01 m)
# and two fine angle steps (2 x 0.00349 rad).
HOST_RUNS = ((torch.float32, 300, 1e-6, 1e-6), (torch.float64, 50, 0.02, 0.00698))
PROFILE_SCANS = (150, 210)   # the traced window of phase 6
STREAM_PREFIX = 300          # phase 9 is held to phase 4 after these scans
SNAPSHOTS = {n for _, n, _, _ in HOST_RUNS} | {STREAM_PREFIX}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels of GraphSlam.process_scan (phase 4), besides the program
# kernels below (scatter_cells and window_sum count world_scatter's and
# lattice_window_sum's launches, which do their work from the points, too);
# smear_grid runs on the meta, scan-set and localize paths (phases 7 and 8)
SLAM_KERNELS = ("scatter_cells", "smear_quantize", "window_sum")
# the program kernels, and the kernel each pairs with on every matcher
# path: each scatter fed by the base points, each window sum fed by the
# query points and followed by its reduction
PROGRAM_AFTER = {"world_scatter": "scatter_cells", "lattice_window_sum": "window_sum",
                 "score_reduce": "lattice_window_sum"}
PROGRAM_KERNELS = tuple(PROGRAM_AFTER)
# paths whose scatter_cells builds a saved map's grid from its cells, not a
# matcher's from its points
MAP_GRID_PATHS = ("localize",)
# phase 3b: the tour's sequential match (this scan against the 10 before
# it), the loop matcher's batch (these scans against chains of 10 further
# back), the benchmark's first batched jobs padded to 64 rows
PROGRAM_SEQ_QUERY = 120
PROGRAM_LOOP_QUERIES = (150, 200, 250, 300)
PROGRAM_X64_JOBS = 61
# fused_cases: base scans of a job, past the 128 whose poses a block of the
# fused scatter stages in shared memory
FUSED_MANY_BASES = 200
PROGRAM_NO_LIBRARY = {
    "world_scatter": "none: no single PyTorch call takes points to world, tests runs, "
                     "rounds cells and scatters them",
    "lattice_window_sum": "none: no single PyTorch call turns and rounds the lattice's "
                          "points and sums the grid's windows at them",
    "score_reduce": "none: no single PyTorch call scores, penalizes and reduces a lattice",
}
H0_S, H0_G = 1024, 1100     # the one-tap (h = 0) smear case of phase 3
# the node-default sequential config (res 0.01 m, smear 0.07 m, range
# 20 m) of the CLI and the online mapper: its smear has h = 14
NODE_G, NODE_S, NODE_H = 4031, 3072, 14
META_QUERIES = (60, 150, 240)   # tour scans matched with return_meta
SET_QUERY = 300                 # scans 300-302 against 290-299
MEGA_QUERIES = range(100, 116)  # one batch of 16 sequential jobs
MEGA_CHUNK = 4
# match_scan_sets_with_map composes each query pose with the correction as
# q + diff (the JAX package's order), which turns the correction by the
# query's heading: at heading t the pose comes back off by 2|offset|
# sin(t/2).  So the localized scans are three that face along +x (checked).
LOCALIZE_SCANS = (139, 142)
LOCALIZE_MAX_HEADING = 0.05
LOCALIZE_OFFSET = (0.08, -0.06)
# phases 7-8 against the host's float32 plain path: response and pose
# within 1e-6 (the lattice values are the same; sums differ in order),
# covariance within 1e-4 relative (window moments of float32 sums)
API_TOL, COV_RTOL = 1e-6, 1e-4
# phase 9: blocks of 8; the streamed run is held to phase 4's blocking run
# at its 300-scan snapshot, poses within 1e-4 m / 1e-4 rad
STREAM_SYNC, STREAM_TOL = 8, 1e-4
PIPELINE_SCANS = 100      # the pipeline modes against each other
THREADED_SCANS = 60       # phase 10's enqueued burst
LIFELONG_SCANS, LIFELONG_TOL = 20, 0.3
# phase 11, card against host: segment labels may differ on this share of
# the free pixels (the matmul of the k-means distance may round a near-tie
# apart); ray lengths within 1e-3 px, except this share of rays, which may
# end one step apart (float32 cos/sin last bits at .5 sample positions)
LABEL_FLIPS, RAY_TOL, RAY_STEP_SHARE = 1e-3, 1e-3, 1e-3
LIFELONG_RAY_CENTROIDS = 8
# the splice's sweep: float32 operations of a step (the next position's two
# products and two sums, two roundings, the border's four comparisons, the
# read's four clamps and the value's comparison) and of a ray (the end's
# two products and two sums, two differences, two squares, a sum, the
# square root, the poison's two comparisons and its sum); whole splices
# timed; the sweep's waits (the copy up, the lengths back)
SWEEP_STEP_OPS, SWEEP_RAY_OPS, SPLICE_TIMED, SWEEP_WAITS = 15, 13, 3, 2
SWEEP_NO_LIBRARY = "none: no single PyTorch call marches rays to their first stop"
# the splice's angle table: 1,439 rays a start, from 179.75 down to -180
SPLICE_ANGLES = np.arange(-180, 180, 0.25)[:-1][::-1]
# the sweep's long-ray map (long_ray_map): a side of free pixels walled
# in, with square obstacles (occupied, or unknown space that poisons) and
# starts in its middle, so rays run hundreds of steps
SWEEP_LONG_SIZE, SWEEP_LONG_OBSTACLES, SWEEP_LONG_STARTS = 2048, 400, 16
# the sweep's edge inputs (sweep_edge_inputs): the values at and beside
# the thresholds, NaN (passes), +-inf, negative and zero pixels; the steps
# of max_steps 1 and 2 and the image's own (None)
SWEEP_EDGE_VALUES = (180.0, 210.0, float(np.nextafter(np.float32(210), np.float32(0))),
                     float(np.nextafter(np.float32(180), np.float32(255))), np.nan, np.inf,
                     -np.inf, -7.5, 0.0)
SWEEP_EDGE_STEPS = (1, 2, None)
# phase 11 times the first cases of sweep_cases (every centroid, one
# start, the long-ray map); the edge inputs are held only
SWEEP_TIMED_CASES = 3
# phase 12: the SPA crossover (profile_spa_torch.crossover at
# profile_spa.py's sizes); the cg columns run to the LM cap from 500 nodes
# (15-75 s a cell): timed at these sizes only, to keep the script within
# half its time limit
SPA_CG_SIZES = (100, 1000, 4000)
# phase 13: DistributedSPA at these noisy_loop_pose_graph sizes with
# GraphSlam's solve arguments (50 CG iterations per LM step), each cell
# once; the serpentine graph of tests/test_parallel.py with its arguments
DSPA_SIZES = (100, 500, 1000)
DSPA_COLUMNS = (("cg", True), ("cg", False), ("dense", False))
# the cg columns run to the LM cap from 500 nodes (9-33 s a cell): timed at
# these sizes only, to keep the script within half its time limit
DSPA_CG_SIZES = (100, 500)
DSPA_ARGS = (100, 1e-4, True, 1e-9, 50)
SERPENTINE, SERPENTINE_ARGS, SERPENTINE_TOL = (64, 64), (60, 1e-4, True, 1e-8, 600), 1e-5
# one rank's all-reduce is a copy: DistributedSPA cg equals SPA2d's cg
DSPA_EQUAL_TOL = 1e-9
# the 2-lap square loop of tests/test_parallel.py's fully sharded stack
SQUARE_SEQ = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
              "smear_deviation": 0.05}
SQUARE_LOOP = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
               "smear_deviation": 0.05}
SQUARE_ATE = 0.15
REF_MATCHES = 100      # the tour's first sequential matches, on the host CPU
# phase 4a: native beam endpoints against numpy's, in metres (glibc's and
# numpy's cos / sin may round apart in the last bit), and the timed passes
HOSTOPS_TOL = 1e-14
HOSTOPS_PASSES = 5
# the host ops the main path runs: the matchers make the views of a batch's
# new scans in one call (the per-scan ops serve the other callers)
HOSTOPS_ON_PATH = ("parse_carmen", "scan_views")
# phase 15: the office cell's traffic, fresh streams of 150 scans at 64
# jobs a dispatch
X64_STREAMS, X64_BATCH = 8, 64
# phase 14: bench_torch's first batched jobs, card against the host's
# plain path.  In float64 within BENCH_F64_TOL (response, pose and
# covariance, relative for the covariance).  In float32 the poses within
# API_TOL and the covariances within COV_RTOL, as in phases 7-8, and the
# responses within one point's cell flip (flip_counts): CUDA's and the
# CPU's float32 cos / sin differ in the last bit, so at 360 points x 10
# angles a point's cell can round apart at a half-cell (on an H100: 2
# counts at the best candidate of one of the 4 jobs, 5.5e-5 of its
# response; in float64 the gaps are ~1e-16).
BENCH_HELD_JOBS = 4
BENCH_F64_TOL = 1e-9


def log(msg):
    print(msg, flush=True)


def max_abs_err(x, y):
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
    if x.dtype.is_floating_point:
        return float((x.double() - y.double()).abs().max())
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


# -- phase 3 -------------------------------------------------------------------

def grid_case(rng, dev, *, N, S, h, G, so, B=16):
    """Scatter cells and full-grid bounds of N jobs with B*P lanes each."""
    R = S + 2 * h
    M = B * P
    sy = rng.integers(0, R, (N, M)).astype(np.int32)
    sx = rng.integers(0, R, (N, M)).astype(np.int32)
    sy[rng.uniform(size=(N, M)) < 0.3] = -1        # empty lanes
    lim = np.tile(np.array([G - so, G - so], dtype=np.int32), (N, 1))
    return (torch.as_tensor(sy, device=dev), torch.as_tensor(sx, device=dev),
            torch.as_tensor(lim, device=dev))


def timings(row, wrapper, plain, bare, library=None):
    """Wrapper and plain ms by events (as in earlier runs), kernel-only and
    library ms by device_ms, and the share of the bound."""
    row.update(ms=cuda_ms(wrapper), plain_ms=cuda_ms(plain), kernel_ms=device_ms(bare),
               library_ms=None if library is None else device_ms(library, reps=5, warmup=1))
    row["share"] = row["bound_ms"] / row["kernel_ms"]
    return row


def check_kernels(K, taps_seq, taps_loop, taps_node, dev):
    """Kernel vs plain version at the main path's shapes (bit equality),
    timed as wrapper, bare kernel, plain version and the one-call PyTorch
    form where there is one, beside the bound; then the redesigned
    kernels on more inputs (correctness only).  Returns {kernel: [case
    dicts]}; the first case of each kernel is its main-path case."""
    from yag_slam_tpu_torch import _build

    lib = _build.library()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {k: [] for k in K.KERNELS}
    grids = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def ok(err, name):
        if err != 0:
            raise AssertionError(f"{name}: bare launch failed, cudaError {err}")

    # what device_ms reads for the smallest launch: a one-element add_
    one = torch.zeros(1, device=dev)
    log(f"phase 3: event floor (device_ms of a one-element add_) "
        f"{device_ms(lambda: one.add_(1)):.4f} ms")

    cases = [
        ("seq", dict(N=1, S=SEQ_S, h=SEQ_H, G=SEQ_G, so=500), taps_seq),
        ("seq_1792", dict(N=1, S=SEQ_MODE_S, h=SEQ_H, G=SEQ_G, so=500), taps_seq),
        ("seq_masked", dict(N=1, S=SEQ_S, h=SEQ_H, G=SEQ_G,
                            so=SEQ_G - SEQ_S + 100), taps_seq),
        ("loop", dict(N=4, S=LOOP_S, h=LOOP_H, G=LOOP_G, so=0), taps_loop),
        ("h0", dict(N=2, S=H0_S, h=0, G=H0_G, so=H0_G - H0_S + 24),
         torch.ones(1, dtype=torch.float32, device=dev)),
        ("node_seq", dict(N=1, S=NODE_S, h=NODE_H, G=NODE_G, so=500), taps_node),
    ]
    # seq_1792 draws from a generator of its own, so the other cases keep
    # the cells of earlier runs and their times stay comparable
    own_rng = {"seq_1792": np.random.default_rng(SEQ_MODE_S)}
    for name, c, taps in cases:
        sy, sx, lim = grid_case(own_rng.get(name, rng), dev, **c)
        N, S, h = c["N"], c["S"], c["h"]
        M, R = sy.shape[1], S + 2 * h
        occ = K.scatter_cells(sy, sx, R)
        occ_ref = K.scatter_cells_ref(sy, sx, R)
        err = max_abs_err(occ, occ_ref)
        # the function is the whole grid, zeros and ones: the bare kernel
        # writes a preallocated grid of garbage (0xFF, filled once), and
        # index_put_ runs after a zero fill of its own
        pre = torch.full_like(occ, 0xFF)
        put_pre = torch.empty_like(occ)
        ok_lane = (sy >= 0) & (sy < R) & (sx >= 0) & (sx < R)
        flat = (torch.arange(N, device=dev)[:, None] * R * R + sy.long() * R
                + sx.long())[ok_lane]
        one = torch.ones((), dtype=torch.uint8, device=dev)

        def bare_scatter():
            ok(lib.yag_scatter_cells(sy.data_ptr(), sx.data_ptr(), pre.data_ptr(),
                                     N, M, R, stream()), "scatter_cells")

        def put():
            put_pre.zero_()
            put_pre.view(-1).index_put_((flat,), one)

        bare_scatter()
        err = max(err, max_abs_err(pre, occ_ref))     # the first launch on garbage
        row = timings(
            dict(case=name, shape=[N, M, R],
                 library="index_put_ of 1 at the flat cells, after a zero fill",
                 **bound(8 * N * M + N * R * R)),
            lambda: K.scatter_cells(sy, sx, R), lambda: K.scatter_cells_ref(sy, sx, R),
            bare_scatter, put)
        row["max_abs_err"] = max(err, max_abs_err(pre, occ_ref))   # and the last
        results["scatter_cells"].append(row)
        if not torch.equal(put_pre, occ_ref):
            raise AssertionError(f"{name}: index_put_ grid differs from the plain scatter")

        q = K.smear_quantize(occ, lim, taps, S, h)
        q_ref = K.smear_quantize_ref(occ, lim, taps, S, h)
        err_q = max_abs_err(q, q_ref)
        if name in ("seq_masked", "h0") and int(q[:, :, int(lim[0, 1]):].max()) != 0:
            raise AssertionError("full-grid mask did not zero the overhang")
        q_pre = torch.empty_like(q)
        results["smear_quantize"].append(timings(
            dict(case=name, shape=[N, S, S], h=h, max_abs_err=err_q,
                 library=NO_LIBRARY_SMEAR, **bound(smear_bytes(N, S, h, 1) + 8 * N)),
            lambda: K.smear_quantize(occ, lim, taps, S, h),
            lambda: K.smear_quantize_ref(occ, lim, taps, S, h),
            lambda: ok(lib.yag_smear_quantize(occ.data_ptr(), lim.data_ptr(),
                                              taps.data_ptr(), q_pre.data_ptr(),
                                              N, S, h, stream()), "smear_quantize")))
        grids[name] = q

        g = K.smear_grid(occ, taps, S, h)
        g_ref = K.smear_grid_ref(occ, taps, S, h)
        err_g = max_abs_err(g, g_ref)
        # quantized and masked, the float grid is smear_quantize's output
        err_gq = max_abs_err(K.quantize_mask(g, lim), q)
        g_pre = torch.empty_like(g)
        results["smear_grid"].append(timings(
            dict(case=name, shape=[N, S, S], h=h, max_abs_err=max(err_g, err_gq),
                 quantized_vs_smear_quantize=err_gq, library=NO_LIBRARY_SMEAR,
                 **bound(smear_bytes(N, S, h, 4), smear_ops(N, S, h))),
            lambda: K.smear_grid(occ, taps, S, h), lambda: K.smear_grid_ref(occ, taps, S, h),
            lambda: ok(lib.yag_smear_grid(occ.data_ptr(), taps.data_ptr(), g_pre.data_ptr(),
                                          N, S, h, stream()), "smear_grid")))
        log(f"phase 3: {name} grid build S={S} h={h} N={N}: "
            f"scatter err {err}, smear err {err_q}, smear_grid err {err_g}, "
            f"quantized smear_grid vs smear_quantize err {err_gq}")

    # the sequential grid of ten building-tour scans: walls, not uniform
    # points, set the identity kernels' work (a wall along a column marks
    # every row of its tile)
    for name, h, taps in (("seq_tour", SEQ_H, taps_seq), ("node_tour", NODE_H, taps_node)):
        S = SEQ_S
        occ = tour_occupancy(dev, SEQ_S, h)
        lim = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
        q = K.smear_quantize(occ, lim, taps, S, h)
        err = max_abs_err(q, K.smear_quantize_ref(occ, lim, taps, S, h))
        q_pre = torch.empty((1, S, S), dtype=torch.uint8, device=dev)
        results["smear_quantize"].append(timings(
            dict(case=name, shape=[1, S, S], h=h, max_abs_err=err,
                 occupied=int(occ.sum()), library=NO_LIBRARY_SMEAR,
                 **bound(smear_bytes(1, S, h, 1) + 8)),
            lambda: K.smear_quantize(occ, lim, taps, S, h),
            lambda: K.smear_quantize_ref(occ, lim, taps, S, h),
            lambda: ok(lib.yag_smear_quantize(occ.data_ptr(), lim.data_ptr(),
                                              taps.data_ptr(), q_pre.data_ptr(),
                                              1, S, h, stream()), "smear_quantize")))
        g = K.smear_grid(occ, taps, S, h)
        err_g = max_abs_err(g, K.smear_grid_ref(occ, taps, S, h))
        err_gq = max_abs_err(K.quantize_mask(g, lim), q)
        g_pre = torch.empty((1, S, S), dtype=torch.float32, device=dev)
        results["smear_grid"].append(timings(
            dict(case=name, shape=[1, S, S], h=h, max_abs_err=max(err_g, err_gq),
                 quantized_vs_smear_quantize=err_gq, occupied=int(occ.sum()),
                 library=NO_LIBRARY_SMEAR,
                 **bound(smear_bytes(1, S, h, 4), smear_ops(1, S, h))),
            lambda: K.smear_grid(occ, taps, S, h), lambda: K.smear_grid_ref(occ, taps, S, h),
            lambda: ok(lib.yag_smear_grid(occ.data_ptr(), taps.data_ptr(), g_pre.data_ptr(),
                                          1, S, h, stream()), "smear_grid")))
        log(f"phase 3: {name} S={S} h={h}, {int(occ.sum())} occupied cells: "
            f"smear_quantize err {err}, smear_grid err {err_g}, quantized smear_grid "
            f"vs smear_quantize err {err_gq}")

    # both identity kernels on denser {0,1} grids, at the main-path shapes
    # and h = 0, 2, 10, 14 (correctness only)
    for (name, N, S, h, taps), density in itertools.product(
            (("seq", 1, SEQ_S, SEQ_H, taps_seq), ("loop", 4, LOOP_S, LOOP_H, taps_loop),
             ("node_seq", 1, NODE_S, NODE_H, taps_node),
             ("h0", 2, H0_S, 0, torch.ones(1, dtype=torch.float32, device=dev))),
            SMEAR_DENSITIES):
        R = S + 2 * h
        occ = (torch.rand((N, R, R), generator=gen, device=dev) < density).to(torch.uint8)
        lo = torch.randint(S // 2, S + 1, (N, 2), generator=gen, device=dev, dtype=torch.int32)
        err = max_abs_err(K.smear_quantize(occ, lo, taps, S, h),
                          K.smear_quantize_ref(occ, lo, taps, S, h))
        err_g = max_abs_err(K.smear_grid(occ, taps, S, h), K.smear_grid_ref(occ, taps, S, h))
        for k, e in (("smear_quantize", err), ("smear_grid", err_g)):
            results[k].append(dict(case=f"{name}_density_{density}", shape=[N, S, S],
                                   h=h, max_abs_err=e))
        log(f"phase 3: {name} N={N} S={S} h={h} density {density}: smear_quantize err "
            f"{err}, smear_grid err {err_g}")

    lattices = [
        ("seq_coarse", "seq", (25, 25, 10), 2),
        ("seq_fine", "seq", (4, 4, 10), 1),
        ("loop_coarse", "loop", (40, 40, 10), 2),
    ]
    for name, grid, (nx, ny, nt), stride in lattices:
        q = grids[grid]
        N, S, _ = q.shape
        gy0 = torch.as_tensor(rng.integers(-60, S + 10, (N, nt, P)).astype(np.int32), device=dev)
        gx0 = torch.as_tensor(rng.integers(-60, S + 10, (N, nt, P)).astype(np.int32), device=dev)
        n_pts = torch.full((N,), N_BEAMS, dtype=torch.int32, device=dev)
        raw = K.window_sum(q, gy0, gx0, n_pts, ny, nx, stride)
        raw_ref = K.window_sum_ref(q, gy0, gx0, n_pts, ny, nx, stride)
        err = max_abs_err(raw, raw_ref)
        if int(raw.max()) <= 0:
            raise AssertionError(f"{name}: window sums are all zero")
        pre = torch.empty_like(raw)
        row = dict(case=name, shape=[N, nt, ny, nx], stride=stride, points=N_BEAMS,
                   max_abs_err=err, **bound(window_bytes(q, gy0, gx0, N_BEAMS, ny, nx, stride)))
        library, row["library"] = window_conv(q, gy0, gx0, N_BEAMS, ny, nx, stride, raw)
        results["window_sum"].append(timings(
            row, lambda: K.window_sum(q, gy0, gx0, n_pts, ny, nx, stride),
            lambda: K.window_sum_ref(q, gy0, gx0, n_pts, ny, nx, stride),
            lambda: ok(lib.yag_window_sum(q.data_ptr(), gy0.data_ptr(), gx0.data_ptr(),
                                          n_pts.data_ptr(), pre.data_ptr(), N, S, nt, P,
                                          ny, nx, stride, stream()), "window_sum"),
            library))
        log(f"phase 3: window sum {name} N={N} {nx}x{ny}x{nt} s={stride}: err {err}")

        # point counts around the warp width and the staging chunk, fewer
        # live points than lanes per job, points off the grid
        for n_lanes in WINDOW_POINTS:
            gy = torch.as_tensor(rng.integers(-80, S + 80, (N, nt, n_lanes)).astype(np.int32),
                                 device=dev)
            gx = torch.as_tensor(rng.integers(-80, S + 80, (N, nt, n_lanes)).astype(np.int32),
                                 device=dev)
            live = torch.as_tensor(rng.integers(max(n_lanes - 40, 0), n_lanes + 1, N)
                                   .astype(np.int32), device=dev)
            err = max_abs_err(K.window_sum(q, gy, gx, live, ny, nx, stride),
                              K.window_sum_ref(q, gy, gx, live, ny, nx, stride))
            results["window_sum"].append(dict(case=f"{name}_P{n_lanes}", shape=[N, nt, ny, nx],
                                              stride=stride, points=live.tolist(),
                                              max_abs_err=err))
            log(f"phase 3: window sum {name} P={n_lanes} live {live.tolist()}: err {err}")
    for k, rows in results.items():
        for r in rows:
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{k} {r['case']}: kernel != plain ({r})")
            if "kernel_ms" in r:
                lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
                log(f"phase 3: {k} {r['case']}: wrapper {r['ms']:.4f} ms, kernel "
                    f"{r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                    f"{lib_ms}; bound {1e3 * r['bound_ms']:.3f} us by {r['bound_by']} "
                    f"({r['bytes']} B, {r['ops']} ops), share {r['share']:.3f}")
    return results


def tour_occupancy(dev, S, h, first=TOUR_GRID_SCANS[0], n=TOUR_GRID_SCANS[1]):
    """(1, S+2h, S+2h) uint8 occupancy of the building tour's scans
    first .. first+n-1 at their odometry poses, at 0.01 m, centred on their
    points (as a sequential match's base window)."""
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)

    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(
            os.path.join(tmp, "tour.clf"), step=0.4, laps=1, n_beams=N_BEAMS, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path)[first:first + n])
    pts = [s.points(odom=True) for s in scans]
    x = np.concatenate([p[0] for p in pts])
    y = np.concatenate([p[1] for p in pts])
    R = S + 2 * h
    gx = np.round((x - x.mean()) / 0.01).astype(np.int64) + S // 2 + h
    gy = np.round((y - y.mean()) / 0.01).astype(np.int64) + S // 2 + h
    inside = (gx >= 0) & (gx < R) & (gy >= 0) & (gy < R)
    occ = torch.zeros((1, R, R), dtype=torch.uint8, device=dev)
    occ[0, torch.as_tensor(gy[inside], device=dev), torch.as_tensor(gx[inside], device=dev)] = 1
    return occ


def window_conv(q, gy0, gx0, n_pts, ny, nx, stride, raw):
    """One grouped F.conv2d with the same result as window_sum: the jobs
    are the groups, each job's angles' point-count stencils (built here,
    outside the timing, padded to the largest job's size) run over the
    float crop of its grid that its lattice reads.  Returns (the timed
    call, what it is); raises if its result differs from the kernel's."""
    import torch.nn.functional as F

    N, S, _ = q.shape
    K_ = gy0.shape[1]
    dev = q.device
    y, x = gy0[:, :, :n_pts].long(), gx0[:, :, :n_pts].long()     # (N, K, n)
    y0, x0 = y.amin(dim=(1, 2)), x.amin(dim=(1, 2))
    kh = int((y.amax(dim=(1, 2)) - y0).max()) + 1
    kw = int((x.amax(dim=(1, 2)) - x0).max()) + 1
    stencil = torch.zeros((N, K_, kh * kw), dtype=torch.float32, device=dev)
    stencil.index_put_((torch.arange(N, device=dev)[:, None, None].expand_as(y),
                        torch.arange(K_, device=dev)[None, :, None].expand_as(y),
                        (y - y0[:, None, None]) * kw + (x - x0[:, None, None])),
                       torch.ones((), device=dev), accumulate=True)
    stencil = stencil.view(N * K_, 1, kh, kw)
    hh, ww = kh + stride * (ny - 1), kw + stride * (nx - 1)
    crop = torch.zeros((1, N, hh, ww), dtype=torch.float32, device=dev)
    for n, (a, b) in enumerate(zip(y0.tolist(), x0.tolist())):
        ys, xs = max(a, 0), max(b, 0)
        ye, xe = min(a + hh, S), min(b + ww, S)
        crop[0, n, ys - a:ye - a, xs - b:xe - b] = q[n, ys:ye, xs:xe].float()

    def call():
        return F.conv2d(crop, stencil, stride=stride, groups=N)

    got = call()[0].view(N, K_, ny, nx).round().to(torch.int32)
    if not torch.equal(got, raw):
        raise AssertionError("the conv2d yardstick differs from window_sum")
    what = (f"F.conv2d, float32 without TF32, {N} group(s) of one job each: the "
            f"{hh}x{ww} grid crop with the {K_} angles' {kh}x{kw} point-count "
            f"stencils at stride {stride}")
    return call, what


# -- phase 3b ------------------------------------------------------------------

def tour_scans():
    """The building tour's scans at their odometry poses (corrected = odometry)."""
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)

    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(
            os.path.join(tmp, "tour.clf"), step=0.4, laps=1, n_beams=N_BEAMS, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path))
    for s in scans:
        s.corrected_pose = s.odom_pose
    return scans


def float_ulps(a, b):
    """Per element, how many float32 (or float64) values lie between a and
    b (0 where both are NaN)."""
    ia, ib = bits(a).to(torch.int64), bits(b).to(torch.int64)
    top = -(2 ** 31) if a.element_size() == 4 else -(2 ** 63)
    # order the bit patterns as the values are ordered (-0 and +0 on 0)
    ka = torch.where(ia < 0, top - ia, ia)
    kb = torch.where(ib < 0, top - ib, ib)
    d = (ka - kb).abs()
    return torch.where(a.isnan() & b.isnan(), 0, d)


def hold_equal(what, got, want):
    """Raise unless each tensor of `got` has the shape, dtype and bits of
    the tensor at its place in `want`."""
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            *((bits(a), bits(b)) if a.is_floating_point() else (a, b)))
        if not same:
            raise AssertionError(f"{what}: output {i} differs from its twin's "
                                 f"(max abs err {max_abs_err(a, b)})")


def program_case(name, m, jobs, n_pad, penalty, do_fine, dev, timing=True):
    """One batch of the matcher's main path through the three program kernels
    and, beside them, a chain of plain twins only (world_scatter_ref, the
    plain smear, lattice_window_sum_ref, score_reduce_ref; the fine pass of
    both centered on the kernels' coarse result).  world_scatter's grid and
    limits, the smeared grid and lattice_window_sum's sums bit-equal to the
    plain chain's; score_reduce's response, argmax and tie count
    bit-equal, its pose and moments within one ulp in float32 (rows apart
    counted) or 1e-12 relative in float64; the bare launches' outputs equal
    to the wrappers' (the bare world_scatter writes over a grid of
    garbage); the whole packed result equal to _compute's.  Raises at the
    first difference.  Returns ({kernel: [case dicts]}, the angles the
    kernels took cos and sin of); timed where `timing` (on the card)."""
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.utils.profiling import F32_OPS_PER_S, F64_OPS_PER_S, window_cells

    offset = m.config.coarse_search_angle_offset
    args, _, S = m._prepare(jobs, n_pad=n_pad)
    st = m._stage(args)
    G, h, res = m.grid_size, m._half, m.config.resolution
    R = S + 2 * h
    karto = m.config.karto_penalty_tuple()
    N, B, P = st["lx"].shape
    dt = st["lx"].dtype
    es, is_double = dt.itemsize, int(dt == torch.float64)
    rate = F64_OPS_PER_S if is_double else F32_OPS_PER_S
    jc, n_q, sub = st["center"], st["n_q"], st["sub"]
    if timing:
        lib = _build.library()
        stream = torch.cuda.current_stream().cuda_stream

    def ok(err, what):
        if err != 0:
            raise AssertionError(f"{what}: bare launch failed, cudaError {err}")

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    shape = dict(N=N, B=B, P=P, S=S, dtype=str(dt), penalty=penalty, do_fine=do_fine,
                 karto=karto is not None, padded=0 if n_pad is None else n_pad - len(jobs))
    out = {}

    # world_scatter
    w_in = [st[k] for k in ("lx", "ly", "anchor", "term", "has_run", "mask", "pose",
                            "center", "vp", "sub")]
    kw = dict(G=G, S=S, h=h, res=res)
    got = PK.world_scatter(*w_in, **kw)
    want = PK.world_scatter_ref(*w_in, **kw)
    hold_equal(f"world_scatter {name}", got, want)
    tested = int((st["has_run"] & st["mask"][..., None]).sum())
    # read: per lane its point (2 T), anchor, term (8), has_run (1); per
    # base slot mask (1) and pose (3 T); per job center, viewpoint (5 T) and
    # subgrid origin (8); written: the grid and the limits.  Per lane its
    # world point (8 ops), its two cells (2 x sub, div, round, 3 more); per
    # lane tested for its run the anchor's and terminal's world points (16)
    # and the cross product (7); per base slot cos and sin
    row = dict(case=name, **shape, max_abs_err=0, library=PROGRAM_NO_LIBRARY["world_scatter"],
               **bound(N * B * P * (2 * es + 9) + N * B * (1 + 3 * es) + N * (5 * es + 8)
                       + N * R * R + 8 * N,
                       14 * N * B * P + 23 * tested + 2 * N * B, rate))
    if timing:
        pre = [torch.full_like(got[0], 0xAB), torch.full_like(got[1], -7)]
        wparams = PK._doubles(res, PK._origin_offset(G, res))
        wshape = PK.scatter_shape(N, R, PK._sm_count(torch.device(dev).index))
        row["scatter_shape"] = wshape._asdict()
        timings(row, lambda: PK.world_scatter(*w_in, **kw),
                lambda: PK.world_scatter_ref(*w_in, **kw),
                lambda: ok(lib.yag_world_scatter(*ptrs(w_in), *ptrs(pre), N, B, P, G, S, h,
                                                 *wshape, wparams, is_double, stream),
                           "world_scatter"))
        hold_equal(f"world_scatter {name}, bare launch", pre, want)
    out["world_scatter"] = [row]
    (occ, lim), (occ_plain, lim_plain) = got, want
    q2d = K.smear_quantize(occ, lim, st["taps"], S, h)
    q2d_plain = K.smear_quantize_ref(occ_plain, lim_plain, st["taps"], S, h)
    hold_equal(f"{name}: the grid of world_scatter's occupancy", [q2d], [q2d_plain])

    packed = torch.full((N, 2, 8), float("nan"), dtype=dt, device=dev)
    plain = torch.full((N, 2, 8), float("nan"), dtype=dt, device=dev)
    center = jc
    out["lattice_window_sum"], out["score_reduce"] = [], []
    for r, lat in enumerate(m._lattices(offset)[:1 + bool(do_fine)]):
        pname = f"{name}_{'fine' if r else 'coarse'}"
        lshape = dict(shape, lattice=[lat.nx, lat.ny, lat.nt], stride=lat.stride)
        largs = (st["qlx"], st["qly"], n_q, center, jc, sub, lat)
        raw = PK.lattice_window_sum(q2d, *largs, G=G, res=res)
        raw_plain = PK.lattice_window_sum_ref(q2d_plain, *largs, G=G, res=res)
        hold_equal(f"lattice_window_sum {pname}", [raw], [raw_plain])
        gy0, gx0, _ = PK.lattice_cells_ref(*largs, G=G, res=res)
        live = [max(0, min(int(c), P)) for c in n_q.tolist()]
        distinct = sum(window_cells(q2d[j:j + 1], gy0[j:j + 1], gx0[j:j + 1], live[j],
                                    lat.ny, lat.nx, lat.stride) for j in range(N))
        # read: the distinct grid cells the windows touch, the live query
        # points (2 T), the counts, the pass's and the jobs' centers, the
        # subgrid origins; written: the sums.  Per (angle, live point) its
        # turn (6 ops) and its two cells (8); per (job, angle) the angle and
        # its cos and sin
        row = dict(case=pname, **lshape, max_abs_err=0,
                   library=PROGRAM_NO_LIBRARY["lattice_window_sum"],
                   **bound(distinct + 2 * es * sum(live) + 4 * N + 2 * 3 * es * N + 8 * N
                           + 4 * raw.numel(),
                           14 * lat.nt * sum(live) + 4 * N * lat.nt, rate))
        if timing:
            lpre = torch.full_like(raw, -7)
            lparams = PK._doubles(lat.xy_size, lat.xy_res, lat.ang_size, lat.ang_res, res,
                                  PK._origin_offset(G, res))
            timings(row, lambda: PK.lattice_window_sum(q2d, *largs, G=G, res=res),
                    lambda: PK.lattice_window_sum_ref(q2d, *largs, G=G, res=res),
                    lambda: ok(lib.yag_lattice_window_sum(
                        q2d.data_ptr(), st["qlx"].data_ptr(), st["qly"].data_ptr(),
                        n_q.data_ptr(), center.data_ptr(), center.stride(0), jc.data_ptr(),
                        sub.data_ptr(), lpre.data_ptr(), N, S, lat.nt, P, lat.ny, lat.nx,
                        lat.stride, lparams, is_double, stream), "lattice_window_sum"))
            hold_equal(f"lattice_window_sum {pname}, bare launch", [lpre], [raw_plain])
        out["lattice_window_sum"].append(row)

        stats = torch.empty((N, 4), dtype=torch.int64, device=dev)
        stats_ref = torch.empty_like(stats)
        rkw = dict(G=G, res=res, penalize=penalty, karto=karto, copy_fine=not do_fine)
        PK.score_reduce(raw, n_q, center, jc, packed, r, lat, stats=stats, **rkw)
        PK.score_reduce_ref(raw_plain, n_q, center, jc, plain, r, lat, stats=stats_ref, **rkw)
        a, b = packed[:, r], plain[:, r]
        ulps, rel, err = hold_reduce(f"score_reduce {pname}", a, b, stats, stats_ref)
        cells_n = N * lat.nt * lat.ny * lat.nx
        ties = int(stats[:, 3].sum())
        win = sum(max(0, min(n - 1, int(c) + 6) - max(0, int(c) - 5))
                  for i in range(N) for n, c in zip((lat.nx, lat.ny, lat.nt), stats[i, :3]))
        # per candidate: the division, the / 100 and, penalized, the
        # penalty's 24 operations and its product; per tie four float64 sums;
        # per window cell its moments (about 12)
        rs = reduce_shape(PK, lat, dt, N, dev)
        row = dict(case=pname, **lshape, reduce_shape=rs and rs._asdict(),
                   max_abs_err=err, max_ulps=int(ulps.max()),
                   rows_apart=int((ulps > 0).any(dim=1).sum()), rows=N,
                   max_rel=float(rel.max()), ties=stats[:, 3].tolist(),
                   argmax=stats[:, :3].tolist(), library=PROGRAM_NO_LIBRARY["score_reduce"],
                   **bound(4 * cells_n + 4 * N + 6 * es * N + 8 * es * N * (1 + (not do_fine)),
                           cells_n * (2 + 26 * penalty) + 4 * ties + 12 * 11 * win, rate))
        if timing:
            sparams = PK.reduce_params(lat, G, res, karto)
            spre = torch.empty_like(packed)
            mode = 0 if not penalty else (1 if karto is None else 2)
            if not rs.in_shared:
                raise AssertionError(f"score_reduce {pname}: a main-path lattice in scratch")
            timings(row, lambda: PK.score_reduce(raw, n_q, center, jc, spre, r, lat, **rkw),
                    lambda: PK.score_reduce_ref(raw, n_q, center, jc, spre, r, lat, **rkw),
                    lambda: ok(lib.yag_score_reduce(
                        raw.data_ptr(), n_q.data_ptr(), center.data_ptr(), center.stride(0),
                        jc.data_ptr(), spre.data_ptr(), None, None, r, int(not do_fine), N,
                        lat.nx, lat.ny, lat.nt, rs.threads, rs.cluster, rs.cols, mode,
                        sparams, is_double, stream), "score_reduce"))
            hold_equal(f"score_reduce {pname}, bare launch", [spre[:, r]], [packed[:, r]])
        out["score_reduce"].append(row)
        center = packed[:, 0, 1:4]
    if not do_fine and not torch.equal(bits(packed[:, 1]), bits(packed[:, 0])):
        raise AssertionError(f"{name}: the coarse row was not copied into the fine slot")
    whole, _ = m._compute(st, S, penalty, do_fine, offset)
    if not torch.equal(bits(whole), bits(packed)):
        raise AssertionError(f"{name}: _compute differs from the kernels run in turn")
    trig = torch.cat([st["pose"][..., 2].reshape(-1), jc[:, 2], packed[:, 0, 3]])
    return out, trig


def fused_cases(dev):
    """world_scatter and lattice_window_sum on inputs the main path's
    batches do not give them, each bit-equal to its twin in float32 and
    float64: no base slot in use; more base scans than a block stages
    (FUSED_MANY_BASES); points far outside the full grid with subgrids
    past its edges; query counts of 0, of every lane and past the lanes,
    the centers a strided view; and no job for each.  Returns case rows."""
    from yag_slam_tpu_torch.matching import program_kernels as PK

    rng = np.random.default_rng(5)
    G, S, h, res = 881, 512, 6, 0.05
    lat = PK.PassLattice(40, 40, 10, 2.0, 0.1, 0.1745, 0.0349, 2)
    rows = []

    def world(N, B, P, dt, reach, unused=False):
        ang = rng.uniform(-np.pi, np.pi, (N, B, P))
        r = rng.uniform(0.3, reach, (N, B, P))
        mask = rng.uniform(size=(N, B)) > (1.1 if unused else 0.2)
        sub = rng.integers(0, G - S, (N, 2))
        sub[::2, 0] = G - S + 20          # subgrids past the grid's high edge
        sub[1::3, 1] = G - S + 7
        f = dict(dtype=dt, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        return [torch.as_tensor(r * np.cos(ang), **f), torch.as_tensor(r * np.sin(ang), **f),
                torch.as_tensor(rng.integers(0, P, (N, B, P)), **i32),
                torch.as_tensor(rng.integers(0, P, (N, B, P)), **i32),
                torch.as_tensor(rng.uniform(size=(N, B, P)) > 0.2, device=dev),
                torch.as_tensor(mask, device=dev),
                torch.as_tensor(np.concatenate([rng.uniform(-3, 3, (N, B, 2)),
                                                rng.uniform(-4, 4, (N, B, 1))], -1), **f),
                torch.as_tensor(np.concatenate([rng.uniform(-1, 1, (N, 2)),
                                                rng.uniform(-4, 4, (N, 1))], -1), **f),
                torch.as_tensor(rng.uniform(-1, 1, (N, 2)), **f), torch.as_tensor(sub, **i32)]

    for dt in (torch.float32, torch.float64):
        for case, (N, B, P, reach, unused) in {
                "unused_base": (3, 16, 256, 20.0, True),
                "many_bases": (2, FUSED_MANY_BASES, 128, 20.0, False),
                "outside": (4, 8, 256, 60.0, False),
                "no_job": (0, 8, 128, 20.0, False)}.items():
            w = world(N, B, P, dt, reach, unused)
            got = PK.world_scatter(*w, G=G, S=S, h=h, res=res)
            want = PK.world_scatter_ref(*w, G=G, S=S, h=h, res=res)
            hold_equal(f"world_scatter {case} {dt}", got, want)
            ones = int(got[0].sum())
            if (ones == 0) != (unused or N == 0):
                raise AssertionError(f"world_scatter {case} {dt}: {ones} cells")
            rows.append(dict(kernel="world_scatter", case=f"{case}_{str(dt)[6:]}",
                             shape=[N, B, P, S], cells=ones, max_abs_err=0))
        for case, counts in {"counts": [0, 181, 256, 300], "no_job": []}.items():
            N, P = len(counts), 256
            f = dict(dtype=dt, device=dev)
            q = torch.as_tensor(rng.integers(0, 101, (N, S, S)), dtype=torch.uint8,
                                device=dev)
            packed = torch.zeros((N, 2, 8), **f)
            packed[:, 0, 1:4] = torch.as_tensor(np.concatenate(
                [rng.uniform(-1, 1, (N, 2)), rng.uniform(-4, 4, (N, 1))], -1), **f)
            largs = (torch.as_tensor(rng.uniform(-15, 15, (N, P)), **f),
                     torch.as_tensor(rng.uniform(-15, 15, (N, P)), **f),
                     torch.as_tensor(counts, dtype=torch.int32, device=dev),
                     packed[:, 0, 1:4], packed[:, 0, 1:4].contiguous(),
                     torch.as_tensor(rng.integers(0, G - S, (N, 2)), dtype=torch.int32,
                                     device=dev), lat)
            raw = PK.lattice_window_sum(q, *largs, G=G, res=res)
            hold_equal(f"lattice_window_sum {case} {dt}", [raw],
                       [PK.lattice_window_sum_ref(q, *largs, G=G, res=res)])
            if N and (int(raw[0].abs().sum()) != 0 or int(raw[1:].sum()) == 0):
                raise AssertionError(f"lattice_window_sum {case} {dt}: sums {raw.sum()}")
            rows.append(dict(kernel="lattice_window_sum", case=f"{case}_{str(dt)[6:]}",
                             shape=[N, P, S], points=counts, max_abs_err=0))
    return rows


def reduce_shape(PK, lat, dt, N, dev):
    """score_reduce's launch shape for N jobs on the card `dev`; None on
    the CPU, where the twin runs."""
    dev = torch.device(dev)
    return PK.reduce_shape(lat, dt, N, PK._sm_count(dev.index)) if dev.type == "cuda" else None


def hold_reduce(what, a, b, stats, stats_ref):
    """score_reduce's rows `a` against its twin's `b`: argmax, tie count
    and response bit-equal, NaN in the same places, the rest within one
    ulp in float32 or 1e-12 relative in float64.  Raises at the first
    difference; returns (ulps, relative gaps, the largest absolute
    difference: 0 where the bits agree or both are NaN)."""
    if not torch.equal(stats, stats_ref):
        raise AssertionError(f"{what}: argmax / ties {stats.tolist()} vs {stats_ref.tolist()}")
    if not torch.equal(bits(a[:, 0]), bits(b[:, 0])):
        raise AssertionError(f"{what}: responses {a[:, 0].tolist()} vs {b[:, 0].tolist()}")
    if not torch.equal(a.isnan(), b.isnan()):
        raise AssertionError(f"{what}: NaN apart {a.tolist()} {b.tolist()}")
    ulps = float_ulps(a, b)
    fin = ~a.isnan()
    rel = torch.where(fin, (a - b).abs() / b.abs().clamp_min(1e-300), 0.0)
    if a.dtype == torch.float64:
        if float(rel.max()) > 1e-12:
            raise AssertionError(f"{what}: float64 rel {float(rel.max())}")
    elif int(ulps.max()) > 1:
        raise AssertionError(f"{what}: {int(ulps.max())} ulps apart")
    same = (bits(a) == bits(b)) | (a.isnan() & b.isnan())
    return ulps, rel, float(torch.where(same, 0.0, (a - b).abs()).max())


def reduce_cases(dev):
    """score_reduce on lattices the main path does not give it, against
    its twin (hold_reduce): a wide lattice (a cluster of blocks), one whose
    responses pass eight blocks' shared memory (scratch rows); ties at +0
    and -0 (all-zero sums under the reference penalty on the loop
    lattice); NaN and inf responses (no query point).  Returns case rows."""
    from yag_slam_tpu_torch.matching import program_kernels as PK

    rng = np.random.default_rng(3)
    G, res = 881, 0.05
    lattices = {
        "wide": PK.PassLattice(32, 32, 40, 0.5, 0.02, 0.1, 0.005, 1),
        "scratch": PK.PassLattice(64, 64, 400, 0.5, 0.02, 0.1, 0.005, 1),
        "signed_zero": PK.PassLattice(40, 40, 10, 2.0, 0.1, 0.1745, 0.0349, 2),
        "nan": PK.PassLattice(4, 4, 10, 0.02, 0.01, 0.0175, 0.0035, 1),
    }
    rows = []
    for name, lat in lattices.items():
        N = 2
        shape = (N, lat.nt, lat.ny, lat.nx)
        raw = (np.zeros(shape) if name == "signed_zero"
               else rng.integers(0, 6000, shape)).astype(np.int32)
        n_q = np.array([0, 0] if name == "nan" else [60, 41], np.int32)
        if name == "nan":
            raw[1] = 0                     # every response NaN
        for dt in (torch.float32, torch.float64):
            center = torch.as_tensor(np.concatenate(
                [rng.uniform(-0.3, 0.3, (N, 2)), rng.uniform(-3, 3, (N, 1))], axis=1),
                dtype=dt, device=dev)
            raw_t, nq_t = torch.as_tensor(raw, device=dev), torch.as_tensor(n_q, device=dev)
            out = []
            for fn in (PK.score_reduce, PK.score_reduce_ref):
                packed = torch.zeros((N, 2, 8), dtype=dt, device=dev)
                stats = torch.zeros((N, 4), dtype=torch.int64, device=dev)
                fn(raw_t, nq_t, center, center, packed, 0, lat, G=G, res=res, penalize=True,
                   copy_fine=True, stats=stats)
                out.append((packed[:, 0], stats))
            (a, sa), (b, sb) = out
            ulps, rel, err = hold_reduce(f"score_reduce {name} {dt}", a, b, sa, sb)
            rs = reduce_shape(PK, lat, dt, N, dev)
            rows.append(dict(case=f"{name}_{str(dt)[6:]}", lattice=[lat.nx, lat.ny, lat.nt],
                             reduce_shape=rs and rs._asdict(), max_abs_err=err,
                             max_ulps=int(ulps.max()), max_rel=float(rel.max()),
                             response=a[:, 0].tolist(), ties=sa[:, 3].tolist()))
    return rows


def zero_lattice(m, dev, penalty, karto):
    """score_reduce on an all-zero lattice (every candidate ties, the
    moments 0 / 0), against its twin: response, argmax, ties bit-equal,
    the pose within one ulp, NaN moments in both."""
    from yag_slam_tpu_torch.matching import program_kernels as PK

    lat = m._lattices(m.config.coarse_search_angle_offset)[0]
    N = 2
    raw = torch.zeros((N, lat.nt, lat.ny, lat.nx), dtype=torch.int32, device=dev)
    n_q = torch.tensor([180, 1], dtype=torch.int32, device=dev)
    jc = torch.tensor([[1.5, -2.0, 0.3], [0.0, 0.0, -1.2]], dtype=m.dtype, device=dev)
    outs = []
    for fn in (PK.score_reduce, PK.score_reduce_ref):
        packed = torch.zeros((N, 2, 8), dtype=m.dtype, device=dev)
        stats = torch.zeros((N, 4), dtype=torch.int64, device=dev)
        fn(raw, n_q, jc, jc, packed, 0, lat, G=m.grid_size, res=m.config.resolution,
           penalize=penalty, karto=karto, copy_fine=True, stats=stats)
        outs.append((packed, stats))
    (a, sa), (b, sb) = outs
    what = f"zero lattice (penalty {penalty}, karto {karto})"
    # both rows of each job (the coarse one copied into the fine slot)
    ulps, rel, err = hold_reduce(what, a.reshape(-1, 8), b.reshape(-1, 8), sa, sb)
    if int(sa[:, 3].min()) != lat.nx * lat.ny * lat.nt:
        raise AssertionError(f"{what}: ties {sa[:, 3].tolist()}, not every candidate")
    return dict(case=f"zero_{'karto' if karto else ('ref' if penalty else 'none')}",
                dtype=str(m.dtype), max_abs_err=err, max_ulps=int(ulps.max()),
                max_rel=float(rel.max()), response=a[:, 0, 0].tolist(),
                nan_moments=int(a[:, 0, 4:].isnan().sum()))


def program_cases(dev):
    """Phase 3b's batches, as (name, matcher, jobs, n_pad, penalty,
    do_fine): the tour's sequential match, the loop matcher's coarse batch,
    the office batch (61 jobs padded to 64), and the sequential match in
    float64, with OpenKarto's penalty, padded, and the loop batch with a
    fine pass."""
    from yag_slam_tpu_torch.core.config import default_config, default_config_loop
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    tour = tour_scans()
    office = bench_torch.build_stream()
    seq = [(tour[PROGRAM_SEQ_QUERY], tour[PROGRAM_SEQ_QUERY - 10:PROGRAM_SEQ_QUERY])]
    loop = [(tour[q], tour[q - 25:q - 15]) for q in PROGRAM_LOOP_QUERIES]
    x64 = bench_torch.batch_jobs(office)[:PROGRAM_X64_JOBS]
    karto_cfg = dict(default_config, use_karto_penalties=True)
    return [
        ("seq", M(default_config, device=dev), seq, None, True, True),
        ("loop", M(default_config_loop, loop=True, device=dev), loop, None, False, False),
        ("x64", M(bench_torch.CFG, device=dev), x64, 64, True, True),
        ("seq_f64", M(default_config, device=dev, dtype=torch.float64), seq, None, True, True),
        ("seq_karto", M(karto_cfg, device=dev), seq, None, True, True),
        ("seq_padded", M(default_config, device=dev), seq, 3, True, True),
        ("loop_fine", M(default_config, device=dev), loop, None, False, True),
    ]


def check_program(dev):
    """Phase 3b: the matcher's program kernels (program_kernels.py; the
    fused scatter and window sum, csrc/grid_build.cu and csrc/window_sum.cu,
    and score_reduce, csrc/match_program.cu) against their twins on the
    card at the main path's batches, timed beside their bounds, then on
    their edge cases; and the kernels' cos / sin bit-equal to torch's.
    Returns {kernel: [case dicts]} (the first of each kernel is its
    main-path case)."""
    from yag_slam_tpu_torch import _build

    t0 = time.perf_counter()
    cases = program_cases(dev)
    results = {"world_scatter": [], "lattice_window_sum": [], "score_reduce": []}
    angles = []
    for name, m, jobs, n_pad, penalty, do_fine in cases:
        rows, trig = program_case(name, m, jobs, n_pad, penalty, do_fine, dev)
        angles.append(trig.double())
        for k, v in rows.items():
            results[k] += v
            for r in v:
                extra = (f", rows apart by an ulp {r['rows_apart']} of {r['rows']}"
                         if "rows_apart" in r else "")
                if r.get("reduce_shape"):
                    extra += f"; shape {tuple(r['reduce_shape'].values())}"
                log(f"phase 3b: {k} {r['case']}: err {r['max_abs_err']}{extra}; wrapper "
                    f"{r['ms']:.4f} ms, kernel {r['kernel_ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms; bound {1e3 * r['bound_ms']:.3f} us by "
                    f"{r['bound_by']}, share {r['share']:.3f}")
    for z in fused_cases(dev):
        results[z["kernel"]].append(z)
        log(f"phase 3b: {z['kernel']} {z['case']}: bit-equal to its twin {z}")
    for m, penalty, karto in ((cases[0][1], True, None), (cases[0][1], False, None),
                              (cases[4][1], True, cases[4][1].config.karto_penalty_tuple()),
                              (cases[3][1], True, None)):
        z = zero_lattice(m, dev, penalty, karto)
        results["score_reduce"].append(z)
        log(f"phase 3b: score_reduce on an all-zero lattice {z}")
    for z in reduce_cases(dev):
        results["score_reduce"].append(z)
        log(f"phase 3b: score_reduce {z['case']} lattice {z['lattice']}, shape "
            f"{tuple(z['reduce_shape'].values())}: held to its twin, {z['max_ulps']} ulps, "
            f"rel {z['max_rel']:.3g}, ties {z['ties']}")

    # the kernels' cos and sin against torch's on the card: every angle
    # above and a sweep of 2^20 over [-4 pi, 4 pi], float32 and float64
    lib = _build.library()
    sweep = torch.linspace(-4 * np.pi, 4 * np.pi, 1 << 20, dtype=torch.float64, device=dev)
    apart = {}
    for dt in (torch.float32, torch.float64):
        x = torch.cat([*angles, sweep]).to(dt)
        c, s = torch.empty_like(x), torch.empty_like(x)
        err = lib.yag_program_trig(x.data_ptr(), c.data_ptr(), s.data_ptr(), x.numel(),
                                   int(dt == torch.float64),
                                   torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise AssertionError(f"program trig probe failed, cudaError {err}")
        apart[str(dt)] = int((bits(c) != bits(torch.cos(x))).sum()
                             + (bits(s) != bits(torch.sin(x))).sum())
    if any(apart.values()):
        raise AssertionError(f"the kernels' cos / sin differ from torch's on the card: {apart}")
    log(f"phase 3b: cos / sin of {x.numel()} angles bit-equal to torch.cos / torch.sin "
        f"in float32 and float64; {time.perf_counter() - t0:.1f} s")
    return results


# -- phase 4 / 5 / 6 -----------------------------------------------------------

def ate(est_xy, gt_xy):
    err = np.asarray(est_xy) - np.asarray(gt_xy)
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def graph_state(slam):
    """Corrected poses and (vertex, edge, closure) counts, copied out."""
    poses = slam.graph.as_arrays()[0]
    return poses, (len(slam.graph.vertices), len(slam.graph.edges),
                   slam.stats["loop_closures"])


def device_timeline(events, symbols):
    """Device time in the events of a Chrome trace: the union of kernel,
    memcpy and memset intervals (host-side events are ignored), plus the
    time and count of the kernels of `symbols` ({name: pieces of its CUDA
    kernels' names}), of all other kernels, and of copies and sets.  Times
    in ms."""
    names = tuple(symbols)
    spans, parts = [], {n: [0.0, 0] for n in (*names, "other_kernels", "memcpy_memset")}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        spans.append((a, a + d))
        if e["cat"] != "kernel":
            key = "memcpy_memset"
        else:
            key = next((n for n in names if any(p in e["name"] for p in symbols[n])),
                       "other_kernels")
        parts[key][0] += d / 1e3
        parts[key][1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(busy_ms=busy / 1e3, events=len(spans),
                parts={k: dict(ms=v[0], count=v[1]) for k, v in parts.items()})


def host_ops(log_path):
    """Phase 4a: the host-ops library built here, then the tour log's parse
    and every scan's matcher view, native against the numpy / Python twins
    (bit-equal; points within HOSTOPS_TOL), each timed on the host CPU
    (median over HOSTOPS_PASSES passes; views per scan)."""
    from yag_slam_tpu_torch import _build, native
    from yag_slam_tpu_torch.core import scan as S
    from yag_slam_tpu_torch.io import carmen as CL
    from yag_slam_tpu_torch.matching import correlation as C
    from yag_slam_tpu_torch.matching.matcher import _next_bucket

    t0 = time.perf_counter()
    _build.hostops_library()
    load_s = time.perf_counter() - t0

    def median_ms(fn):
        times = []
        for _ in range(HOSTOPS_PASSES):
            t = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t))
        return out, statistics.median(times)

    recs, parse_ms = median_ms(lambda: CL.load_carmen_log(log_path))
    refs, parse_ref_ms = median_ms(lambda: CL.load_carmen_log_ref(log_path))
    if len(recs) != len(refs) or any(
            not np.array_equal(a.ranges, np.asarray(b.ranges, dtype=np.float64))
            or dataclasses.astuple(a)[1:] != dataclasses.astuple(b)[1:]
            for a, b in zip(recs, refs)):
        raise AssertionError("the native CARMEN parse differs from the Python parser's")

    # both matchers take the point capacity that holds the tour's widest scan
    scans = CL.carmen_to_localized_scans(recs, range_threshold=20.0)
    cap = _next_bucket(max(s.num_valid_beams for s in scans))
    ways = ((S.beam_points_padded, C.segment_validation_runs),
            (S.beam_points_padded_ref, C.segment_validation_runs_ref))
    us = ([], [])
    views = ([], [])
    for _ in range(HOSTOPS_PASSES):
        for w, (compact, segment) in enumerate(ways):
            views[w].clear()
            for s in scans:
                t = time.perf_counter()
                lx, ly, n = compact(s.ranges, s.min_angle, s.angle_increment,
                                    s.range_threshold, cap)
                runs = segment(lx, ly, n)
                us[w].append(1e6 * (time.perf_counter() - t))
                views[w].append((lx, ly, n, runs))
    # the matchers' op: every scan's view in one call, each row bit-equal
    # to the per-scan native view, zero past its count
    batch_us = []
    for _ in range(HOSTOPS_PASSES):
        t = time.perf_counter()
        rows = native.scan_views(scans, cap)
        batch_us.append(1e6 * (time.perf_counter() - t) / len(scans))
    for i, (lx, ly, n, runs) in enumerate(views[0]):
        got = [rows[f][i] for f in ("lx", "ly", "anchor", "term", "has_run")]
        want = [lx, ly, *(np.pad(r, (0, cap - n)) for r in runs)]
        if rows["n"][i] != n or not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("a batched view differs from the per-scan native view")
    err, not_bit_equal = 0.0, 0
    for (lx, ly, n, runs), (rx, ry, rn, rruns) in zip(*views):
        if n != rn or not all(np.array_equal(a, b) for a, b in zip(runs, rruns)):
            raise AssertionError("a native view's count or runs differ from the twins'")
        err = max(err, float(np.abs(lx - rx).max()), float(np.abs(ly - ry).max()))
        not_bit_equal += int(np.count_nonzero(lx != rx) + np.count_nonzero(ly != ry))
    out = dict(build_s=_build.hostops_build_seconds, load_s=load_s, cpu=cpu_model(),
               scans=len(scans), cap=cap, parse_ms=parse_ms, parse_ref_ms=parse_ref_ms,
               view_us=statistics.median(us[0]), view_ref_us=statistics.median(us[1]),
               view_batched_us=statistics.median(batch_us),
               max_abs_err_m=err, not_bit_equal=not_bit_equal,
               points=2 * sum(v[2] for v in views[0]))
    log(f"phase 4a: host ops built in {out['build_s']} s (loaded in {load_s:.3f} s) on "
        f"{out['cpu']}; parse of {len(recs)} scans {parse_ms:.3f} ms native vs "
        f"{parse_ref_ms:.3f} ms Python, the same scans; view per scan at cap {cap} "
        f"{out['view_us']:.2f} us native vs {out['view_ref_us']:.2f} us numpy/Python, "
        f"{out['view_batched_us']:.2f} us a scan in one batched call (bit-equal to "
        f"native); counts and runs bit-equal, points max |err| {err:.3e} m, "
        f"{not_bit_equal} of {out['points']} not bit-equal")
    if not err <= HOSTOPS_TOL:
        raise AssertionError(f"native beam endpoints {err} m from numpy's")
    return out


def run_slam(tmp, gpu, dev):
    from yag_slam_tpu_torch import native
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    def scans_of(records):   # fresh scan objects: a run mutates its scans
        return carmen_to_localized_scans(records, range_threshold=20.0)

    log_path, gt_path, n = generate_benchmark_log(
        os.path.join(tmp, "building.clf"), step=0.4, laps=1, n_beams=N_BEAMS,
        seed=0)
    hostops = host_ops(log_path)
    native.reset_calls()
    carmen = load_carmen_log(log_path)
    scans = scans_of(carmen)
    gt = np.loadtxt(gt_path)
    odom = np.array([[c.odom_x, c.odom_y] for c in carmen])
    if len(scans) != n or len(gt) != n:
        raise AssertionError(f"log has {len(scans)} scans, expected {n}")
    log(f"phase 4: building tour, {n} scans of {N_BEAMS} beams")

    # one match on a small input: the card (float32, kernels) against the
    # plain path on the CPU (float64)
    pair = scans_of(carmen[:2])
    results = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        m = CorrelativeScanMatcher(device=device, dtype=dtype)
        results.append(m.match_scan(pair[1], [pair[0]]))
    a, b = results
    dxy = np.hypot(a.best_pose.x - b.best_pose.x, a.best_pose.y - b.best_pose.y)
    dth = abs(a.best_pose.euler[-1] - b.best_pose.euler[-1])
    if not (dxy <= 0.01 and dth <= 0.0035 and abs(a.response - b.response) < 1e-3):
        raise AssertionError(f"card vs CPU match differs: {a} vs {b}")
    log(f"phase 4: one match card f32 vs cpu f64: |dxy| {dxy:.2e} m, "
        f"|dth| {dth:.2e} rad, response {a.response:.6f} vs {b.response:.6f}")

    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    spa_ms = solve_times(slam)
    main, rest = scans[:-HOLD_BACK], scans[-HOLD_BACK:]
    torch.cuda.synchronize()
    K.reset_launches()
    PK.reset_launches()
    graphs_before = graph_stats()
    match_ms, scan_ms, card_at = [], [], {}
    t_all = time.perf_counter()
    with recorded_keys() as tour_keys:
        for i, s in enumerate(main):
            t0 = time.perf_counter()
            m0 = slam.stats["match_time_total"]
            slam.process_scan(s)
            scan_ms.append(1e3 * (time.perf_counter() - t0))
            match_ms.append(1e3 * (slam.stats["match_time_total"] - m0))
            if i + 1 in SNAPSHOTS:
                card_at[i + 1] = graph_state(slam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = dict(K.LAUNCHES, **PK.LAUNCHES)
    graphs = dict(stats_delta(graphs_before, graph_stats()), keys=len(tour_keys))
    hostops["calls"] = dict(slam=dict(native.CALLS))
    caps = (slam.seq_matcher._point_cap, slam.loop_matcher._point_cap)
    if caps != (hostops["cap"],) * 2:
        raise AssertionError(f"the matchers took point capacities {caps}, phase 4a "
                             f"checked {hostops['cap']}")

    est = np.array([[v.obj.corrected_pose.x, v.obj.corrected_pose.y]
                    for v in slam.graph.vertices])
    nm = len(main)
    ate_slam = ate(est, gt[:nm, :2])
    ate_odom = ate(odom[:nm], gt[:nm, :2])
    st = slam.stats
    summary = dict(
        scans=nm, seconds=wall, scans_per_s=nm / wall,
        median_match_ms=statistics.median(match_ms[1:]),
        median_scan_ms=statistics.median(scan_ms[1:]),
        loop_closures=st["loop_closures"], loop_chains_tried=st["loop_chains_tried"],
        spa_runs=st["opt_runs"],
        spa_ms_mean=1e3 * st["opt_time_total"] / max(st["opt_runs"], 1),
        spa_ms_median=statistics.median(spa_ms) if spa_ms else None, spa_ms=spa_ms,
        seq_match_s=st["match_time_total"], spa_s=st["opt_time_total"],
        ate_slam_m=ate_slam, ate_odom_m=ate_odom, launches=launches,
        graphs=graphs, gpu=gpu,
    )
    log(f"phase 4: {nm} scans in {wall:.3f} s = {summary['scans_per_s']:.3f} scans/s; "
        f"median seq match {summary['median_match_ms']:.3f} ms; "
        f"SPA {summary['spa_ms_mean']:.3f} ms x {st['opt_runs']}; "
        f"{st['loop_closures']} closures ({gpu})")
    if spa_ms:
        log(f"phase 4: host SPA solves (native, {hostops['calls']['slam']['spa_lm']} "
            f"spa_lm calls): median {summary['spa_ms_median']:.3f} ms, first "
            f"{spa_ms[0]:.3f}, max {max(spa_ms):.3f}; each ms: "
            + " ".join(f"{t:.3f}" for t in spa_ms))
    if hostops["calls"]["slam"]["spa_lm"] != st["opt_runs"]:
        raise AssertionError(f"{st['opt_runs']} SPA solves but "
                             f"{hostops['calls']['slam']['spa_lm']} native spa_lm calls")
    log(f"phase 4: ATE slam {ate_slam:.4f} m vs odometry {ate_odom:.4f} m; "
        f"launches {launches}")
    log(f"phase 4: CUDA graphs: {graphs['keys']} keys met, {graphs['eager']} eager "
        f"_runs, {graphs['captures']} captures ({graphs['ms_per_capture']:.3f} ms each), "
        f"{graphs['replays']} replays")
    if st["loop_closures"] < 1:
        raise AssertionError("no loop closure on the building tour")
    if not ate_slam < ate_odom:
        raise AssertionError(f"ATE {ate_slam} not below odometry {ate_odom}")
    for k in SLAM_KERNELS + PROGRAM_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    for op in HOSTOPS_ON_PATH:
        if hostops["calls"]["slam"][op] <= 0:
            raise AssertionError(f"host op {op} never called on the main path")
    log(f"phase 4: host op calls {hostops['calls']['slam']}")

    # the tour's first scans again, on the host CPU (plain path): drift
    # that builds up across scans shows here
    summary["host_runs"] = []
    for dtype, n_scans, tol_m, tol_rad in HOST_RUNS:
        host = GraphSlam.default(device="cpu", dtype=dtype)
        t0 = time.perf_counter()
        for s in scans_of(carmen[:n_scans]):
            host.process_scan(s)
        host_s = time.perf_counter() - t0
        host_poses, host_counts = graph_state(host)
        card_poses, card_counts = card_at[n_scans]
        pdxy, pdth = pose_gap(card_poses, host_poses)
        summary["host_runs"].append(dict(
            dtype=str(dtype), scans=n_scans, card_counts=card_counts,
            host_counts=host_counts, max_dxy_m=pdxy, max_dth_rad=pdth,
            host_s=host_s))
        log(f"phase 4: first {n_scans} scans card f32 vs cpu {dtype}: (vertices, "
            f"edges, closures) {card_counts} vs {host_counts}; max |dxy| {pdxy:.3e} m "
            f"(tol {tol_m}), max |dth| {pdth:.3e} rad (tol {tol_rad})")
        same = (card_counts == host_counts if dtype == torch.float32 else
                (card_counts[0], card_counts[2]) == (host_counts[0], host_counts[2]))
        if not (same and pdxy <= tol_m and pdth <= tol_rad):
            raise AssertionError(f"card run drifted from the host {dtype} run")

    summary["render"] = render_phase(slam, dev, gpu)
    summary["render_tour"] = render_phase(map_cell_tour(dev)[1], dev, gpu)
    summary["render_trace_cases"] = trace_cases(dev)
    summary["render_endpoint_cases"] = endpoint_cases(dev)

    path = os.path.join(tmp, "map.graph")
    slam.to_file(path)
    restored = GraphSlam.from_file(path, device=dev, dtype=torch.float32)
    if restored.binarize() != slam.binarize():
        raise AssertionError("checkpoint round trip changed the state")
    responses = []
    for s in rest:
        res, _ = restored.process_scan(s)
        responses.append(res.response)
    if len(restored.graph.vertices) != n or min(responses) < 0.3:
        raise AssertionError(f"restored run: {len(restored.graph.vertices)} "
                             f"vertices, responses {responses}")
    log(f"phase 5: checkpoint round trip ok; {HOLD_BACK} more scans, "
        f"responses {[round(r, 4) for r in responses]}")
    summary["restored_responses"] = responses

    summary["profile"] = profile_window(scans_of(carmen[:PROFILE_SCANS[1]]), dev, tmp, gpu)
    scans = [v.obj for v in slam.graph.vertices]
    summary["matcher_api"] = matcher_api(scans, dev, gpu)
    summary["localize"] = localize(slam, scans, dev, gpu)
    tour = dict(carmen=carmen, scans_of=scans_of, gt=gt, odom=odom, log=log_path,
                gt_path=gt_path, n_main=nm)
    summary["stream"] = stream(tour, card_at[STREAM_PREFIX], summary, dev, gpu)
    summary["entry_points"] = entry_points(tour, tmp, dev, gpu)
    hostops["calls"]["cli"] = summary["entry_points"].pop("hostops_calls")
    summary["hostops"] = hostops
    summary["lifelong"] = lifelong(tour, slam, dev, gpu)
    summary["spa"] = dict(crossover=spa_crossover(dev, gpu),
                          tour=spa_tour(tour, card_at[STREAM_PREFIX], summary, dev, gpu))
    summary["last_modules"] = last_modules(tour, slam, summary, tmp, dev, gpu)
    summary["bench"] = bench_rows(dev, gpu)
    summary["graphs"]["phase15"] = graphs_phase(slam, tour_keys, tour, dev, gpu)
    return summary


def render_steps(seg, flag, res, max_steps):
    """The DDA steps the trace takes for these beams: n = min(ceil(max(|dx|,
    |dy|) / res), max_steps) summed over the valid beams."""
    x0, y0, x1, y1 = seg.unbind(1)
    r = torch.tensor(res, dtype=torch.float32, device=seg.device)
    n = torch.ceil(torch.maximum((x1 - x0).abs() / r, (y1 - y0).abs() / r)).clamp(0, max_steps)
    return int(torch.where((flag & 1) > 0, n, 0.0).sum())


def render_waits(fn):
    """What fn() did that made the host wait for the card: the warnings of
    torch.cuda.set_sync_debug_mode("warn"), one a wait (the mode's notice
    that it is a prototype is not one)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if str(w.message).startswith("called a synchronizing CUDA operation")]


def map_cell_tour(dev, n=MAP_TOUR_SCANS):
    """The map cell's building tour (two laps of 180-beam scans, seed 0, its
    first n scans), each scan at its odometry pose, and a stand-in for a
    SLAM pass over it as render_phase takes one: the vertices' scans and
    make_occupancy_grid."""
    from yag_slam_tpu_torch.io import (
        carmen_to_localized_scans, generate_benchmark_log, load_carmen_log)
    from yag_slam_tpu_torch.mapping import occupancy as O

    with tempfile.TemporaryDirectory() as tmp:
        log_path, _, _ = generate_benchmark_log(os.path.join(tmp, "tour.clf"), step=0.4,
                                                laps=2, n_beams=N_BEAMS, seed=0)
        scans = carmen_to_localized_scans(load_carmen_log(log_path), range_threshold=20.0)[:n]
    slam = types.SimpleNamespace(
        graph=types.SimpleNamespace(vertices=[types.SimpleNamespace(obj=s) for s in scans]),
        make_occupancy_grid=lambda res, rt: O.create_occupancy_grid(scans, res, rt, device=dev))
    return scans, slam


def trace_case(name, seed=0):
    """Beams of one of TRACE_CASES, in scans of 180 around origins within
    3 m of the frame's center (one origin for all in "one_origin"), up to
    11.9 m long (some end outside the frame): seg (B, 4) float32, flag (B,)
    uint8 (1 valid, 2 hit), and the frame (ox, oy, res, width, height,
    max_steps) at 0.05 m; "clipped" takes max_steps 20."""
    rng = np.random.default_rng(seed)
    B, res = 4096, 0.05
    scan = np.arange(B) // 180
    origin = rng.uniform(-3.0, 3.0, (scan[-1] + 1, 2))[scan]
    if name == "one_origin":
        origin[:] = (0.013, -0.021)
    length = rng.uniform(0.0, 6.0, B)
    flag = np.where(rng.uniform(size=B) < 0.7, 3, 1)
    max_steps = int(np.ceil(12.0 / res)) + 2
    if name == "zero_steps":
        length[::3] = 0.0                                # no step: the endpoint alone
        length[1::3] = rng.uniform(0.0, 0.5 * res, len(length[1::3]))   # one step
    elif name == "clipped":
        length = rng.uniform(3.0, 11.9, B)
        max_steps = 20
    elif name == "mixed_warp":
        length = np.where(np.arange(B) % 2 == 1, 11.9, rng.uniform(0.0, 0.1, B))
        flag[::7] = 0
    elif name != "one_origin":
        raise ValueError(f"no trace case {name!r}")
    ang = rng.uniform(-np.pi, np.pi, B)
    end = origin + length[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    seg = np.concatenate([origin, end], axis=1).astype(np.float32)
    frame = (-12.05, -12.05, res, 483, 483, max_steps)
    return seg, flag.astype(np.uint8), frame


def trace_cases(dev):
    """Phase 5 (b): the trace kernel on each of TRACE_CASES, bit-equal to
    its plain version on the card, and the image of no beam."""
    from yag_slam_tpu_torch.mapping import render_kernel as R

    rows = []
    for name in TRACE_CASES:
        seg, flag, frame = trace_case(name)
        seg, flag = torch.as_tensor(seg, device=dev), torch.as_tensor(flag, device=dev)
        counts = R.beam_counts(seg, flag, *frame)
        want = R.beam_counts_ref(seg, flag, *frame)
        if not torch.equal(counts, want):
            raise AssertionError(f"trace case {name}: counts differ from the plain version's "
                                 f"(max abs err {max_abs_err(counts, want)})")
        rows.append(dict(case=name, beams=int(seg.shape[0]), passes=int(counts[0].sum()),
                         hits=int(counts[1].sum()), max_abs_err=0))
    # no beam: the image mode still writes every cell (unknown)
    seg, flag = torch.zeros((0, 4), device=dev), torch.zeros(0, dtype=torch.uint8, device=dev)
    frame = trace_case(TRACE_CASES[0])[2]
    image = R.beam_image(seg, flag, *frame, 2)
    if not (torch.equal(image, R.beam_image_ref(seg, flag, *frame, 2))
            and bool((image == 200).all())):
        raise AssertionError("trace with no beam: the image is not every cell unknown")
    rows.append(dict(case="no_beams", beams=0, passes=0, hits=0, max_abs_err=0))
    log(f"phase 5: trace cases bit-equal to the plain version: {rows}")
    return rows


def endpoint_case(name, seed=0):
    """The scans of one of ENDPOINT_CASES (LocalizedRangeScans at poses
    within 3 m of the origin, ranges up to 25 m: some past the 12 m
    threshold, some inf, nan or outside [min_range, max_range]; 180 beams
    a degree apart over 180 degrees, 360 over 360, 1,081 a quarter degree
    apart over 270, 1 and 0 beams), and the range threshold 12 m.
    "past_one_round" draws 4,100 scans' beam counts from
    ENDPOINT_BEAM_COUNTS."""
    from yag_slam_tpu_torch import LocalizedRangeScan

    rng = np.random.default_rng(seed)
    counts = ENDPOINT_CASES[name]
    if counts is None:
        counts = rng.choice(ENDPOINT_BEAM_COUNTS, 4100, p=(0.05, 0.05, 0.3, 0.3, 0.3))
    fov = {180: np.pi, 360: 2 * np.pi, 1081: 1.5 * np.pi}
    scans = []
    for i, n in enumerate(int(c) for c in counts):
        inc = fov.get(n, np.pi) / max(n - 1, 1)
        a0 = -0.5 * fov.get(n, np.pi) + rng.uniform(-0.1, 0.1)
        r = rng.uniform(0.05, 25.0, n)
        bad = rng.uniform(size=n) < 0.1
        r[bad] = rng.choice([np.inf, -np.inf, np.nan, 0.05, 20.5], bad.sum())
        if name == "mixed" and i == 7:
            r[:] = rng.choice([np.inf, np.nan, 0.05, 0.1, 20.5], n)   # none valid
        x, y = rng.uniform(-3.0, 3.0, 2)
        scans.append(LocalizedRangeScan(r, a0, a0 + inc * max(n - 1, 0), inc, 0.1, 20.0,
                                        12.0, x, y, rng.uniform(-np.pi, np.pi)))
    return scans, 12.0


def endpoint_cases(dev):
    """Phase 5 (c): the endpoints kernel on each of ENDPOINT_CASES, seg,
    flag and box bit-equal to its plain version on the card, and the image
    of its beams too."""
    from yag_slam_tpu_torch.mapping import occupancy as O
    from yag_slam_tpu_torch.mapping import render_kernel as R

    rows = []
    for name in ENDPOINT_CASES:
        scans, rt = endpoint_case(name)
        table, ranges = O._gather(scans, dev)
        seg, flag, box = R.beam_endpoints(table, ranges, rt)
        want = R.beam_endpoints_ref(table, ranges, rt)
        same = all(torch.equal(a, b) for a, b in zip((seg, flag, box), want))
        frame = O._frame(box.tolist(), RENDER_RES, rt)
        args = (*O._f32(*frame[:2], RENDER_RES), *frame[2:], O.MIN_PASS_THROUGH)
        image = R.beam_image(seg, flag, *args)
        if not (same and torch.equal(image, R.beam_image_ref(seg, flag, *args))):
            raise AssertionError(f"endpoint case {name}: differs from the plain version "
                                 f"(endpoints equal: {same})")
        first = table[:, 7].to(torch.int64)
        rows.append(dict(case=name, scans=len(scans), beams=int(ranges.shape[0]),
                         valid=int((flag & 1).sum()),
                         empty_scans=int((first[1:] == first[:-1]).sum()
                                         + (first[-1] == ranges.shape[0])),
                         blocks=min(-(-int(ranges.shape[0]) // 256), R.END_MAX_BLOCKS),
                         grid=list(frame[2:4]),
                         max_abs_err=0))
    log(f"phase 5: endpoint cases bit-equal to the plain version: {rows}")
    return rows


def render_phase(slam, dev, gpu):
    """Phase 5 (a): the map render.  The main path (make_occupancy_grid and
    the prefixes k = 5, half and all of the tour's vertices through
    create_occupancy_grid) with the render kernels' launches counted from
    0: one render_endpoints and one render_counts a render; then, at each
    prefix, every stage's kernel held bit for bit to its plain version on
    the same inputs on the card (seg, flag and the box; the image, to
    classify_cells_ref of beam_counts_ref and to the whole render's; the
    trace's counts mode, passes and hits); wrapper, bare kernel (device_ms
    on preallocated outputs), plain version and the whole render (host
    wall to the image on the host) timed beside each stage's bound and the
    event floor (device_ms of a one-element add_)."""
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.mapping import occupancy as O
    from yag_slam_tpu_torch.mapping import render_kernel as R

    lib = _build.library()
    scans = [v.obj for v in slam.graph.vertices]
    n = len(scans)
    res, rt, mpt = RENDER_RES, RENDER_RANGE, O.MIN_PASS_THROUGH
    prefixes = (RENDER_FIRST, n // 2, n)
    torch.cuda.synchronize()
    R.reset_launches()
    grid = slam.make_occupancy_grid(res, rt)
    renders = {k: O.create_occupancy_grid(scans[:k], res, rt, device=dev) for k in prefixes}
    torch.cuda.synchronize()
    launches = dict(R.LAUNCHES)
    if launches != dict(render_endpoints=1 + len(prefixes), render_counts=1 + len(prefixes)):
        raise AssertionError(f"{1 + len(prefixes)} renders launched {launches}, not one "
                             f"render_endpoints and one render_counts each")
    vals = set(np.unique(grid.image).tolist())
    if grid.image.shape != (grid.height, grid.width) or not vals <= {0, 200, 255} \
            or 0 not in vals or 255 not in vals:
        raise AssertionError(f"bad occupancy grid {grid.image.shape} {vals}")
    if not np.array_equal(grid.image, renders[n].image):
        raise AssertionError("make_occupancy_grid and create_occupancy_grid disagree")
    log(f"phase 5: occupancy grid {grid.width}x{grid.height}, "
        f"{int((grid.image == 0).sum())} occupied cells; render launches {launches}")
    waits = render_waits(lambda: O.create_occupancy_grid(scans, res, rt, device=dev))
    if len(waits) != RENDER_WAITS:
        raise AssertionError(f"a render waited for the card {len(waits)} times, not "
                             f"{RENDER_WAITS} (the box and the image): {waits}")
    log(f"phase 5: a render waits for the card {len(waits)} times (the box, the image)")
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def ok(err, name):
        if err != 0:
            raise AssertionError(f"{name}: bare launch failed, cudaError {err}")

    cases = {name: [] for name in R.KERNELS}
    counts_mode = []
    wall = {}
    for k in prefixes:
        table, ranges = O._gather(scans[:k], dev)
        B = ranges.shape[0]
        seg, flag, box = R.beam_endpoints(table, ranges, rt)
        seg_r, flag_r, box_r = R.beam_endpoints_ref(table, ranges, rt)
        ox, oy, W, H, max_steps = O._frame(box.tolist(), res, rt)
        frame = (*O._f32(ox, oy, res), W, H, max_steps)
        image = R.beam_image(seg, flag, *frame, mpt)
        image_r = R.beam_image_ref(seg, flag, *frame, mpt)
        counts = R.beam_counts(seg, flag, *frame)
        counts_r = R.beam_counts_ref(seg, flag, *frame)
        errs = dict(
            render_endpoints=max(max_abs_err(seg, seg_r), max_abs_err(flag, flag_r),
                                 max_abs_err(box, box_r)),
            render_counts=max(max_abs_err(image, image_r), max_abs_err(counts, counts_r)))
        same = (torch.equal(seg, seg_r) and torch.equal(flag, flag_r)
                and torch.equal(box, box_r) and torch.equal(counts, counts_r)
                and torch.equal(image, image_r)
                and torch.equal(image, R.classify_cells_ref(counts_r, mpt))
                and np.array_equal(image.cpu().numpy(), renders[k].image)
                and (renders[k].width, renders[k].height) == (W, H)
                and (renders[k].offset.x, renders[k].offset.y) == (ox, oy))
        if not same:
            raise AssertionError(f"render at k = {k}: a kernel differs from its plain "
                                 f"version (max abs errors {errs})")
        valid = int((flag & 1).sum())
        steps = render_steps(seg, flag, res, max_steps)

        scratch = R._end_scratch(table)
        seg_p, flag_p, box_p = torch.empty_like(seg), torch.empty_like(flag), torch.empty_like(box)
        counts_p, image_p = torch.empty_like(counts), torch.empty_like(image)
        cols_p = torch.empty((W, H), dtype=torch.int32, device=dev)
        trace_ops = RENDER_STEP_OPS * steps + RENDER_BEAM_OPS * valid

        def bare_trace(image_ptr):
            return lambda: ok(lib.yag_render_trace(
                seg.data_ptr(), flag.data_ptr(), B, *frame, counts_p.data_ptr(),
                cols_p.data_ptr(), mpt, image_ptr, stream()), "render_counts")

        stages = dict(
            render_endpoints=(
                dict(**bound(64 * k + 8 * B + 17 * B + 32)),
                lambda: R.beam_endpoints(table, ranges, rt),
                lambda: R.beam_endpoints_ref(table, ranges, rt),
                lambda: ok(lib.yag_render_endpoints(
                    table.data_ptr(), ranges.data_ptr(), k, B, rt, seg_p.data_ptr(),
                    flag_p.data_ptr(), scratch.data_ptr(), R.END_MAX_BLOCKS,
                    box_p.data_ptr(), stream()), "render_endpoints")),
            # the render's: the trace with the image in its merge
            render_counts=(
                dict(**bound(17 * B + W * H, trace_ops), steps=steps),
                lambda: R.beam_image(seg, flag, *frame, mpt),
                lambda: R.beam_image_ref(seg, flag, *frame, mpt),
                bare_trace(image_p.data_ptr())),
        )
        for name, (row, wrapper, plain, bare) in stages.items():
            row.update(case=f"k={k}", shape=[k, B, valid, H, W], max_abs_err=errs[name],
                       library=RENDER_NO_LIBRARY, floor_ms=floor)
            cases[name].append(timings(row, wrapper, plain, bare))
        if not (torch.equal(seg_p, seg) and torch.equal(flag_p, flag)
                and torch.equal(box_p, box) and torch.equal(image_p, image)):
            raise AssertionError(f"render at k = {k}: a bare launch's output differs")
        # the trace's counts mode, timed the same way (not on the render's path)
        row = dict(**bound(17 * B + 8 * W * H, trace_ops), steps=steps, case=f"k={k}",
                   shape=[k, B, valid, H, W], max_abs_err=max_abs_err(counts, counts_r))
        counts_mode.append(timings(
            row, lambda: R.beam_counts(seg, flag, *frame),
            lambda: R.beam_counts_ref(seg, flag, *frame), bare_trace(None)))
        if not torch.equal(counts_p, counts):
            raise AssertionError(f"render at k = {k}: the bare counts mode's output differs")

        def whole():
            t0 = time.perf_counter()
            O.create_occupancy_grid(scans[:k], res, rt, device=dev)
            return 1e3 * (time.perf_counter() - t0)

        whole()
        wall[k] = statistics.median(whole() for _ in range(RENDER_TIMED))
        log(f"phase 5: render k = {k} ({B} beams, {valid} valid, {steps} steps, grid "
            f"{W}x{H}): each stage bit-equal to its plain version; "
            + "ms kernel / wrapper / plain / bound: " + "; ".join(
                f"{name} {c[-1]['kernel_ms']:.4f} / {c[-1]['ms']:.4f} / "
                f"{c[-1]['plain_ms']:.4f} / {c[-1]['bound_ms']:.5f}"
                for name, c in (*cases.items(), ("counts mode", counts_mode)))
            + f"; event floor {floor:.4f}; whole render {wall[k]:.3f} ms (host wall, "
            f"median of {RENDER_TIMED}) ({gpu})")
    # the main case, first in each list: the whole map
    for c in (*cases.values(), counts_mode):
        c.insert(0, c.pop())
    return dict(launches=launches, renders=1 + len(prefixes), cases=cases,
                counts_mode=counts_mode, floor_ms=floor, whole_render_ms=wall,
                grid=[grid.width, grid.height])


def profile_window(scans, dev, tmp, gpu):
    """Phase 6: a fresh run up to PROFILE_SCANS[0], then the window traced
    on the card; device time from the trace against host wall time."""
    from torch.profiler import ProfilerActivity, profile

    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    lo, hi = PROFILE_SCANS
    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    for s in scans[:lo]:
        slam.process_scan(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in scans[lo:hi]:
            slam.process_scan(s)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        tl = device_timeline(json.load(f)["traceEvents"],
                             {k: v["symbols"] for k, v in (*PK.KERNELS.items(),
                                                           *K.KERNELS.items())})
    if tl["parts"]["other_kernels"]["count"] + sum(
            tl["parts"][k]["count"] for k in (*K.KERNELS, *PK.KERNELS)) == 0:
        raise AssertionError("the trace holds no kernel on the card")
    tl.update(scans=[lo, hi], window_ms=window_ms,
              idle_share=1.0 - tl["busy_ms"] / window_ms,
              busy_ms_per_scan=tl["busy_ms"] / (hi - lo))
    # each kernel's device us a launch: score_reduce's is the redesign's
    # measure on the main path
    parts = ", ".join(f"{k} {v['ms']:.3f} ms x {v['count']}"
                      + (f" ({1e3 * v['ms'] / v['count']:.2f} us a launch)" if v["count"] else "")
                      for k, v in tl["parts"].items())
    log(f"phase 6: scans {lo}-{hi - 1} traced: device busy {tl['busy_ms']:.3f} ms "
        f"of {window_ms:.3f} ms, idle share {tl['idle_share']:.4f}; {parts} ({gpu})")
    return tl


# -- phase 7 / 8 -----------------------------------------------------------------

def timed(fn):
    """(fn(), host milliseconds to the card's idle)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def result_gap(a, b):
    """Response and pose gaps and the covariance's relative gap of two
    ScanMatcherResults (best_pose a Transform or a list of them)."""
    pa = a.best_pose if isinstance(a.best_pose, list) else [a.best_pose]
    pb = b.best_pose if isinstance(b.best_pose, list) else [b.best_pose]
    xyt = lambda ps: np.array([[p.x, p.y, p.euler[-1]] for p in ps])  # noqa: E731
    dxy, dth = pose_gap(xyt(pa), xyt(pb))
    cov = float(np.max(np.abs(a.covariance - b.covariance)
                       / (np.abs(b.covariance) + 1e-12)))
    return dict(response=abs(a.response - b.response), dxy_m=dxy, dth_rad=dth,
                cov_rel=cov)


def hold(gap, what):
    if not (gap["response"] <= API_TOL and gap["dxy_m"] <= API_TOL
            and gap["dth_rad"] <= API_TOL and gap["cov_rel"] <= COV_RTOL):
        raise AssertionError(f"{what}: card vs host f32 {gap}")


def counted(K, fn, *more):
    """fn() with the launch counts of K (and of each module in `more`) set
    to 0 just before; (out, launches of all of them in one dict).  The
    matcher's paths pass program_kernels in `more`."""
    torch.cuda.synchronize()
    for m in (K, *more):
        m.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for m in more:
        launches.update(m.LAUNCHES)
    return out, launches


def matcher_api(scans, dev, gpu):
    """Phase 7 on the tour's scans at their SLAM poses."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    out = dict(launches={})
    card, card_meta = M(device=dev), M(device=dev, return_meta=True)
    host_meta = M(device="cpu", return_meta=True)
    jobs = [(scans[i], scans[i - 10:i]) for i in META_QUERIES]

    metas, out["launches"]["meta"] = counted(
        K, lambda: [card_meta.match_scan(q, b) for q, b in jobs], PK)
    gaps, meta_ms, plain_ms = [], [], []
    for (q, b), rm in zip(jobs, metas):
        r, ms = timed(lambda: card.match_scan(q, b))
        rm2, mms = timed(lambda: card_meta.match_scan(q, b))
        plain_ms.append(ms)
        meta_ms.append(mms)
        rh = host_meta.match_scan(q, b)
        if not (same_result(r, rm) and same_result(r, rm2)):
            raise AssertionError(f"return_meta changed the result: {r} vs {rm}")
        if rm.meta["grid"].dtype != np.float32 or not np.array_equal(
                rm.meta["grid"], rh.meta["grid"]):
            raise AssertionError("meta grid differs from the host's plain grid")
        gaps.append(result_gap(rm, rh))
        hold(gaps[-1], "return_meta match_scan")
    out["meta"] = dict(queries=list(META_QUERIES), gaps=gaps,
                       grid_shape=list(metas[0].meta["grid"].shape),
                       match_ms=meta_ms, plain_match_ms=plain_ms)
    log(f"phase 7: return_meta match_scan x {len(jobs)}: results equal the "
        f"plain matcher's, meta grids {out['meta']['grid_shape']} bit-equal "
        f"to the host's; {statistics.median(meta_ms):.3f} ms vs "
        f"{statistics.median(plain_ms):.3f} ms without meta; launches "
        f"{out['launches']['meta']} ({gpu})")

    i = SET_QUERY
    queries, base = scans[i:i + 3], scans[i - 10:i]
    (r, ms), out["launches"]["scan_sets"] = counted(
        K, lambda: timed(lambda: card_meta.match_scan_sets(queries, base)), PK)
    rh = host_meta.match_scan_sets(queries, base)
    gap = result_gap(r, rh)
    hold(gap, "match_scan_sets")
    if not np.array_equal(r.meta["grid"], rh.meta["grid"]):
        raise AssertionError("scan-set meta grid differs from the host's")
    out["scan_sets"] = dict(queries=[i, i + 3], base=[i - 10, i], gap=gap,
                            response=r.response, ms=ms)
    log(f"phase 7: match_scan_sets 3 vs 10: response {r.response:.6f}, "
        f"card vs host {gap}; {ms:.3f} ms; launches "
        f"{out['launches']['scan_sets']}")

    jobs = [(scans[i], scans[i - 10:i]) for i in MEGA_QUERIES]
    card.match_many_mega(jobs[:MEGA_CHUNK], chunk=MEGA_CHUNK)      # warm-up
    many, many_ms = timed(lambda: card.match_many(jobs))
    (mega, mega_ms), out["launches"]["mega"] = counted(
        K, lambda: timed(lambda: card.match_many_mega(jobs, chunk=MEGA_CHUNK)), PK)
    if not all(same_result(a, b) for a, b in zip(many, mega)):
        raise AssertionError("match_many_mega differs from match_many")
    with held_replays() as tally:
        held = card.match_many_mega(jobs, chunk=MEGA_CHUNK)
    if max(tally["keys"].values(), default=0) < 3 or not all(
            same_result(a, b) for a, b in zip(held, mega)):
        raise AssertionError(f"match_many_mega: {tally['replays']} replays held")
    host = M(device="cpu").match_many(jobs)
    gaps = [result_gap(a, b) for a, b in zip(mega, host)]
    for g in gaps:
        hold(g, "match_many_mega")
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    out["mega"] = dict(jobs=len(jobs), chunk=MEGA_CHUNK, mega_ms=mega_ms,
                       match_many_ms=many_ms, worst_gap=worst,
                       replays_held=tally["replays"])
    log(f"phase 7: match_many_mega {len(jobs)} jobs (chunk {MEGA_CHUNK}) == "
        f"match_many; {mega_ms:.3f} ms vs {many_ms:.3f} ms; card vs host "
        f"worst {worst}; launches {out['launches']['mega']}; again with its "
        f"{tally['replays']} chunk replays held to _compute bit for bit")
    return out


def localize(slam, scans, dev, gpu):
    """Phase 8: localize offset tour scans against the tour's map."""
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.core.transform import Transform
    from yag_slam_tpu_torch.mapping import occupancy_grid_map_to_correlation_grid
    from yag_slam_tpu_torch.matching import correlation as C
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    res, smear = 0.05, 0.05
    grid = slam.make_occupancy_grid(resolution=res)
    im = grid.image
    lo, hi = LOCALIZE_SCANS
    truth = np.array([[s.corrected_pose.x, s.corrected_pose.y, s.corrected_pose.euler[-1]]
                      for s in scans[lo:hi]])
    if np.abs(np.angle(np.exp(1j * truth[:, 2]))).max() > LOCALIZE_MAX_HEADING:
        raise AssertionError(f"scans {lo}-{hi - 1} do not face along +x: {truth[:, 2]}")
    queries = []
    for s in scans[lo:hi]:
        q = s.copy()
        p = s.corrected_pose
        q.corrected_pose = Transform.from_xyt(p.x + LOCALIZE_OFFSET[0],
                                              p.y + LOCALIZE_OFFSET[1], p.euler[-1])
        queries.append(q)
    card, host = M(loop=True, device=dev), M(loop=True, device="cpu")

    def run():
        cg, conv_ms = timed(lambda: occupancy_grid_map_to_correlation_grid(
            im, res, smear, device=dev))
        r, ms = timed(lambda: card.match_scan_sets_with_map(
            cg, grid.offset.x, grid.offset.y, queries, penalty=False))
        return cg, conv_ms, r, ms

    (cgrid, conv_ms, r, match_ms), launches = counted(K, run, PK)
    host_cgrid = occupancy_grid_map_to_correlation_grid(im, res, smear, device="cpu")
    if not np.array_equal(cgrid, host_cgrid):
        raise AssertionError("map conversion on the card differs from the host's")
    rh = host.match_scan_sets_with_map(host_cgrid, grid.offset.x, grid.offset.y,
                                       queries, penalty=False)
    gap = result_gap(r, rh)
    hold(gap, "match_scan_sets_with_map")
    got = np.array([[p.x, p.y, p.euler[-1]] for p in r.best_pose])
    back_m, back_rad = pose_gap(got, truth)
    if back_m > 0.1:
        raise AssertionError(f"localization off by {back_m} m: {got} vs {truth}")

    # the smear of the conversion at the full map's shape, kernel vs plain
    h = C.kernel_half_size(res, smear)
    G = max(im.shape)
    taps = torch.as_tensor(C.gaussian_kernel_1d(res, smear).astype(np.float32), device=dev)
    oy, ox = np.where(im == 0)
    sy = torch.as_tensor((oy + h).astype(np.int32)[None], device=dev)
    sx = torch.as_tensor((ox + h).astype(np.int32)[None], device=dev)
    occ = K.scatter_cells(sy, sx, G + 2 * h)
    err = max_abs_err(K.smear_grid(occ, taps, G, h), K.smear_grid_ref(occ, taps, G, h))
    lib = _build.library()
    g_pre = torch.empty((1, G, G), dtype=torch.float32, device=dev)

    def bare():
        rc = lib.yag_smear_grid(occ.data_ptr(), taps.data_ptr(), g_pre.data_ptr(), 1, G, h,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"smear_grid: bare launch failed, cudaError {rc}")

    case = timings(dict(case="tour_map", shape=[1, G, G], h=h, max_abs_err=err,
                        library=NO_LIBRARY_SMEAR,
                        **bound(smear_bytes(1, G, h, 4), smear_ops(1, G, h))),
                   lambda: K.smear_grid(occ, taps, G, h),
                   lambda: K.smear_grid_ref(occ, taps, G, h), bare)
    if err != 0:
        raise AssertionError(f"smear_grid != plain on the tour map: {case}")
    out = dict(map_shape=list(im.shape), occupied=int((im == 0).sum()),
               convert_ms=conv_ms, match_ms=match_ms, response=r.response,
               back_m=back_m, back_rad=back_rad, gap=gap, launches=launches,
               smear_case=case)
    log(f"phase 8: map {im.shape[1]}x{im.shape[0]} at {res} m converted on the card in "
        f"{conv_ms:.3f} ms (bit-equal to the host); scans {lo}-{hi - 1} offset by "
        f"{LOCALIZE_OFFSET} m localized in {match_ms:.3f} ms, response "
        f"{r.response:.6f}, back within {back_m:.4f} m / {back_rad:.4f} rad of the "
        f"SLAM poses; card vs host {gap}; smear_grid on the map: kernel "
        f"{case['kernel_ms']:.4f} ms, wrapper {case['ms']:.4f} ms, plain "
        f"{case['plain_ms']:.4f} ms; bound {1e3 * case['bound_ms']:.3f} us by "
        f"{case['bound_by']}, share {case['share']:.3f}; launches {launches} ({gpu})")
    return out


# -- phase 9 / 10 / 11 -----------------------------------------------------------

def xyt(p):
    return [p.x, p.y, p.euler[-1]]


def poses_of(scans):
    return np.array([xyt(s.corrected_pose) for s in scans])


def stream(tour, card_prefix, phase4, dev, gpu):
    """Phase 9: the tour through process_scan_stream, held to phase 4's
    blocking run; then the pipeline's modes on the first scans."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    nm, gt = tour["n_main"], tour["gt"]
    scans = tour["scans_of"](tour["carmen"][:nm])
    slam = GraphSlam.default(device=dev, dtype=torch.float32)

    def run():
        t0 = time.perf_counter()
        slam.process_scan_stream(scans[:STREAM_PREFIX], sync_every=STREAM_SYNC)
        at = graph_state(slam)
        slam.process_scan_stream(scans[STREAM_PREFIX:], sync_every=STREAM_SYNC)
        torch.cuda.synchronize()
        return at, time.perf_counter() - t0

    ((poses, counts), wall), launches = counted(K, run, PK)
    dxy, dth = pose_gap(poses, card_prefix[0])
    est = np.array([xyt(v.obj.corrected_pose)[:2] for v in slam.graph.vertices])
    st = slam.stats
    out = dict(
        scans=nm, seconds=wall, scans_per_s=nm / wall,
        blocking_scans_per_s=phase4["scans_per_s"],
        prefix=STREAM_PREFIX, prefix_counts=counts, blocking_counts=card_prefix[1],
        prefix_dxy_m=dxy, prefix_dth_rad=dth, loop_closures=st["loop_closures"],
        blocking_loop_closures=phase4["loop_closures"],
        ate_slam_m=ate(est, gt[:nm, :2]), ate_odom_m=phase4["ate_odom_m"],
        pipeline_stats={k: st["stream_" + k] for k in ("synced", "redo_sweeps",
                                                       "redo_matches")},
        launches=launches,
    )
    log(f"phase 9: process_scan_stream (blocks of {STREAM_SYNC}) {nm} scans in "
        f"{wall:.3f} s = {out['scans_per_s']:.3f} scans/s against the blocking "
        f"loop's {phase4['scans_per_s']:.3f}; first {STREAM_PREFIX}: (vertices, "
        f"edges, closures) {counts} vs {card_prefix[1]}, max |dxy| {dxy:.3e} m, "
        f"|dth| {dth:.3e} rad; tour: {st['loop_closures']} closures vs "
        f"{phase4['loop_closures']}, ATE {out['ate_slam_m']:.4f} m vs odometry "
        f"{out['ate_odom_m']:.4f} m; pipeline {out['pipeline_stats']}; "
        f"launches {launches} ({gpu})")
    if counts != card_prefix[1] or dxy > STREAM_TOL or dth > STREAM_TOL:
        raise AssertionError("the streamed run parted from the blocking run")
    if abs(st["loop_closures"] - phase4["loop_closures"]) > 1:
        raise AssertionError("streamed closures differ from the blocking run's by > 1")
    if not out["ate_slam_m"] < out["ate_odom_m"]:
        raise AssertionError("streamed ATE not below odometry's")
    out["modes"] = pipeline_modes(tour, dev, gpu)
    return out


def pipeline_modes(tour, dev, gpu):
    """The first PIPELINE_SCANS scans matched against their last 10: the
    blocking match_scan loop, the pipeline in block mode, and in streaming
    mode with one lagged group; the pipeline modes' launches counted
    together (path "pipeline")."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.matching.pipeline import OnlineMatchPipeline

    window = 10

    def blocking(scans, m):
        res = []
        for k in range(1, len(scans)):
            scan, last = scans[k], scans[k - 1]
            scan.corrected_pose = last.corrected_pose + (scan.odom_pose - last.odom_pose)
            r = m.match_scan(scan, scans[max(0, k - window):k])
            scan.corrected_pose = r.best_pose
            res.append(r)
        return res, None

    def piped(scans, m, **kw):
        pipe = OnlineMatchPipeline(m, window=window, sync_every=STREAM_SYNC, **kw)
        pipe.seed(scans[:1])
        res = []
        for s in scans[1:]:
            pipe.push(s)
            res += pipe.drain()
        return res + pipe.flush(), dict(pipe.stats)

    runs, launches = {}, {}
    for name, fn in (("blocking", blocking),
                     ("block", lambda sc, m: piped(sc, m, block_dispatch=True)),
                     ("streaming_lag1", lambda sc, m: piped(sc, m, lag_blocks=1))):
        scans = tour["scans_of"](tour["carmen"][:PIPELINE_SCANS])
        m = CorrelativeScanMatcher(device=dev)
        ((res, stats), ms), n = counted(K, lambda: timed(lambda: fn(scans, m)), PK)
        runs[name] = dict(res=res, poses=poses_of(scans[1:]), ms=ms, stats=stats)
        if name != "blocking":
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
    out = {}
    for name, r in runs.items():
        dxy, dth = pose_gap(r["poses"], runs["block"]["poses"])
        dresp = max(abs(a.response - b.response)
                    for a, b in zip(r["res"], runs["block"]["res"]))
        out[name] = dict(scans_per_s=(PIPELINE_SCANS - 1) / (r["ms"] / 1e3),
                         ms=r["ms"], stats=r["stats"], dxy_vs_block_m=dxy,
                         dth_vs_block_rad=dth, dresponse_vs_block=dresp)
        log(f"phase 9: {PIPELINE_SCANS - 1} matches {name}: "
            f"{out[name]['scans_per_s']:.3f} scans/s; vs block mode max |dxy| "
            f"{dxy:.3e} m, |dth| {dth:.3e} rad, |dresponse| {dresp:.3e}; "
            f"stats {r['stats']} ({gpu})")
        if len(r["res"]) != PIPELINE_SCANS - 1 or max(dxy, dth) > STREAM_TOL \
                or dresp > STREAM_TOL:
            raise AssertionError(f"pipeline {name} differs from block mode")
    # block mode again, each step's replay held to _compute bit for bit
    scans = tour["scans_of"](tour["carmen"][:PIPELINE_SCANS])
    with held_replays() as tally:
        res, _ = piped(scans, CorrelativeScanMatcher(device=dev), block_dispatch=True)
    if tally["replays"] < PIPELINE_SCANS - 1 or not np.array_equal(
            poses_of(scans[1:]), runs["block"]["poses"]):
        raise AssertionError(f"block mode held: {tally['replays']} replays")
    out["block"]["replays_held"] = tally["replays"]
    out["launches"] = launches
    log(f"phase 9: block mode again: its {tally['replays']} replays held to _compute "
        f"bit for bit, the same poses; the pipeline modes' launches {launches}")
    return out


def quiet(fn):
    """fn() with its standard output captured; (out, captured lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def tour_args(records):
    return [(c.ranges, c.min_angle, c.max_angle, c.angle_increment, 0.0,
             c.max_range, (c.odom_x, c.odom_y, c.odom_theta)) for c in records]


def entry_points(tour, tmp, dev, gpu):
    """Phase 10: the offline CLI in-process and the threaded mapper."""
    from yag_slam_tpu_torch import native
    from yag_slam_tpu_torch.apps import offline_mapper
    from yag_slam_tpu_torch.apps.online import OnlineMapper, ThreadedOnlineMapper
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK

    out = dict(launches={})
    base = ["--carmen", tour["log"], "--gt", tour["gt_path"], "--device", dev.type,
            "--no-map-image"]

    def cli():
        a = offline_mapper.main(base + ["--out", os.path.join(tmp, "cli")])
        b = offline_mapper.main(base + ["--out", os.path.join(tmp, "cli_s"), "--stream"])
        return a, b

    native.reset_calls()
    ((a, b), lines), out["launches"]["cli"] = counted(K, lambda: quiet(cli), PK)
    out["hostops_calls"] = dict(native.CALLS)
    if min(out["hostops_calls"][op] for op in HOSTOPS_ON_PATH) <= 0:
        raise AssertionError(f"the CLI skipped a host op: {out['hostops_calls']}")
    keys = ("vertices", "edges", "loop_closures", "integrated", "scans_per_s",
            "ate_rmse", "ate_rmse_odom")
    out["cli"] = {k: a[k] for k in keys}
    out["cli_stream"] = dict({k: b[k] for k in keys}, pipeline=b["pipeline"])
    for line in lines:
        log(f"phase 10: cli: {line}")
    log(f"phase 10: CLI per scan {a['integrated']} scans at {a['scans_per_s']:.3f} "
        f"scans/s, --stream at {b['scans_per_s']:.3f}; (vertices, closures) "
        f"{(a['vertices'], a['loop_closures'])} vs {(b['vertices'], b['loop_closures'])}; "
        f"ATE {a['ate_rmse']:.4f} / {b['ate_rmse']:.4f} m vs odometry "
        f"{a['ate_rmse_odom']:.4f} m; --stream pipeline {b['pipeline']}; launches "
        f"{out['launches']['cli']}, host op calls {out['hostops_calls']} ({gpu})")
    if (a["vertices"], a["loop_closures"]) != (b["vertices"], b["loop_closures"]):
        raise AssertionError("the CLI's --stream run differs from its per-scan run")
    for r in (a, b):
        if not r["ate_rmse"] < r["ate_rmse_odom"]:
            raise AssertionError(f"CLI ATE {r['ate_rmse']} not below odometry's")

    args = tour_args(tour["carmen"][:THREADED_SCANS])
    kw = dict(device=dev, min_distance=0.0, min_rotation=0.0)
    renders = []

    def threaded():
        mapper = ThreadedOnlineMapper(map_callback=lambda im, g: renders.append(im.shape),
                                      **kw)
        try:
            t0 = time.perf_counter()
            for x in args:
                mapper.enqueue_scan(*x)
            ok = mapper.drain(timeout=600)
            return mapper, ok, time.perf_counter() - t0
        finally:
            mapper.close()

    (mapper, ok, secs), out["launches"]["threaded"] = counted(K, threaded, PK)
    ref = OnlineMapper(**kw)
    for x in args:
        ref.add_scan(*x)
    got_poses, got_counts = graph_state(mapper.slam)
    ref_poses, ref_counts = graph_state(ref.slam)
    dxy, dth = pose_gap(got_poses, ref_poses)
    out["threaded"] = dict(scans=THREADED_SCANS, drained=ok, seconds=secs,
                           counts=got_counts, per_scan_counts=ref_counts,
                           dxy_m=dxy, dth_rad=dth, renders=len(renders))
    log(f"phase 10: ThreadedOnlineMapper {THREADED_SCANS} scans enqueued at once: "
        f"drained {ok} in {secs:.3f} s, (vertices, edges, closures) {got_counts} vs "
        f"the per-scan mapper's {ref_counts}, max |dxy| {dxy:.3e} m, |dth| "
        f"{dth:.3e} rad, {len(renders)} map renders; launches "
        f"{out['launches']['threaded']} ({gpu})")
    if not ok or got_counts[0] != THREADED_SCANS or got_counts != ref_counts \
            or max(dxy, dth) > STREAM_TOL:
        raise AssertionError("the threaded mapper differs from the per-scan mapper")
    return out


def lifelong(tour, slam, dev, gpu):
    """Phase 11: splice phase 4's map into an OnlineMapper on the card and
    localize the tour's first scans in it."""
    from yag_slam_tpu_torch.core.transform import Transform
    from yag_slam_tpu_torch.apps.online import OnlineMapper
    from yag_slam_tpu_torch.mapping import raytrace as RT
    from yag_slam_tpu_torch.mapping.raytrace import trace_rays
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.splicing import splice

    grid = slam.make_occupancy_grid()
    im = np.ascontiguousarray(grid.image[::-1])   # a saved map: top row first
    origin = [grid.offset.x, grid.offset.y]
    seg, seg_ms = timed(lambda: splice.segment_map(im, density=5, device=dev))
    t0 = time.perf_counter()
    host_seg = splice.segment_map(im, density=5, device="cpu")
    host_seg_ms = 1e3 * (time.perf_counter() - t0)
    flips = float((seg != host_seg).sum() / max((host_seg > 0).sum(), 1))
    cents = splice.determine_centroids(host_seg)
    angles = SPLICE_ANGLES
    picks = sorted(cents)[:: max(1, len(cents) // LIFELONG_RAY_CENTROIDS)]
    d = np.concatenate([
        np.abs(trace_rays(im, angles, *cents[k], device=dev)[2]
               - trace_rays(im, angles, *cents[k], device="cpu")[2])
        for k in picks[:LIFELONG_RAY_CENTROIDS]])
    far = d > RAY_TOL
    out = dict(map_shape=list(im.shape), segments=int(host_seg.max()),
               label_flip_share=flips, segment_ms=seg_ms, host_segment_ms=host_seg_ms,
               rays=int(d.size), rays_one_step=int(far.sum()),
               max_ray_gap_px=float(d.max()))
    log(f"phase 11: map {im.shape[1]}x{im.shape[0]}, {out['segments']} segments "
        f"in {seg_ms:.3f} ms on the card ({host_seg_ms:.3f} ms host), label flips "
        f"{flips:.2e}; {d.size} rays card vs host: {int(far.sum())} one step "
        f"apart, max gap {d.max():.3e} px")
    if flips > LABEL_FLIPS or far.mean() > RAY_STEP_SHARE or (d[far] > 1 + RAY_TOL).any():
        raise AssertionError("segmentation or raytracing on the card differs from the host's")

    vs = slam.graph.vertices
    recs = tour["carmen"][:LIFELONG_SCANS]
    truth = np.array([xyt(vs[i].obj.corrected_pose) for i in range(LIFELONG_SCANS)])
    # carry the odometry into the map frame: T = P0 o O0^-1
    odom = [Transform.from_xyt(c.odom_x, c.odom_y, c.odom_theta) for c in recs]
    T = vs[0].obj.corrected_pose + odom[0].inverse()
    in_map = [xyt(T + o) for o in odom]

    def run():
        t0 = time.perf_counter()
        mapper = OnlineMapper(device=dev, base_map=(im, grid.resolution, origin),
                              initial_pose=tuple(in_map[0]), min_distance=0.0,
                              min_rotation=0.0)
        t1 = time.perf_counter()
        n_base = len(mapper.slam.graph.vertices)
        for c, pose in zip(recs, in_map):
            mapper.add_scan(c.ranges, c.min_angle, c.max_angle, c.angle_increment,
                            0.0, c.max_range, pose)
        torch.cuda.synchronize()
        return mapper, n_base, t1 - t0, time.perf_counter() - t1

    (mapper, n_base, build_s, feed_s), launches = counted(K, run, RT, PK)
    if launches["splice_sweep"] != 1:
        raise AssertionError(f"the splice launched the sweep kernel "
                             f"{launches['splice_sweep']} times, not once")
    live = mapper.slam.graph.vertices[n_base:]
    got = poses_of([v.obj for v in live])
    back_m, back_rad = pose_gap(got, truth) if len(got) == len(truth) else (np.inf, np.inf)
    linked = any(e.target.obj.num < n_base for e in live[0].edges) if live else False
    out.update(base_vertices=n_base, live_vertices=len(live), bootstrap_linked=linked,
               build_s=build_s, feed_s=feed_s, back_m=back_m, back_rad=back_rad,
               loop_closures=mapper.slam.stats["loop_closures"], launches=launches)
    log(f"phase 11: spliced {n_base} base vertices in {build_s:.3f} s; {len(live)} "
        f"tour scans localized in {feed_s:.3f} s, bootstrap linked {linked}, "
        f"{out['loop_closures']} closures, back within {back_m:.4f} m / "
        f"{back_rad:.4f} rad of phase 4's poses; launches {launches} ({gpu})")
    if not linked or len(live) != LIFELONG_SCANS or back_m > LIFELONG_TOL:
        raise AssertionError("the lifelong splice did not localize the tour's scans")
    out["splices"] = 1
    out["sweep"] = splice_sweep(im, seg, grid.resolution, origin, dev, gpu)
    return out


def splice_parts(im, res, origin, dev):
    """One map_to_graph on the card, host wall ms of its parts: the calls
    it makes through splice's module globals (each returns host arrays, so
    each waits for the card), and the rest, the scans' construction."""
    from yag_slam_tpu_torch.splicing import splice

    names = ("segment_map", "determine_centroids", "create_edges", "trace_sweeps")
    parts = dict.fromkeys(names, 0.0)
    saved = {n: getattr(splice, n) for n in names}

    def timer(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            r = fn(*args, **kwargs)
            parts[name] += 1e3 * (time.perf_counter() - t0)
            return r
        return call

    try:
        for n in names:
            setattr(splice, n, timer(n, saved[n]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        splice.map_to_graph(im, res, origin, density=5, device=dev)
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        for n, fn in saved.items():
            setattr(splice, n, fn)
    parts["scans"] = total - sum(parts.values())
    parts["map_to_graph"] = total
    return parts


def long_ray_map(seed=0):
    """The sweep's long-ray map, SWEEP_LONG_SIZE px a side, and
    SWEEP_LONG_STARTS starts in its middle four fifths: free (255) pixels
    walled in (0), with SWEEP_LONG_OBSTACLES squares of 3-12 px, each
    occupied (0 or 100) or unknown space (200)."""
    rng = np.random.default_rng(seed)
    n = SWEEP_LONG_SIZE
    im = np.full((n, n), 255.0, np.float32)
    im[[0, -1], :] = 0.0
    im[:, [0, -1]] = 0.0
    for _ in range(SWEEP_LONG_OBSTACLES):
        y, x = rng.integers(1, n - 13, 2)
        d = rng.integers(3, 13)
        im[y:y + d, x:x + d] = rng.choice([0.0, 100.0, 200.0])
    return im, rng.uniform(0.1 * n, 0.9 * n, (SWEEP_LONG_STARTS, 2))


def sweep_edge_inputs(seed=0):
    """The sweep's edge inputs: a 47 x 61 image, seven tenths of it free
    (255), the rest drawn from SWEEP_EDGE_VALUES; 50 angles 7.3 degrees
    apart (not a multiple of 32); 13 starts (650 rays: a multiple of no
    block size) on the 1-px border, outside the image, on .5 pixels and
    inside."""
    rng = np.random.default_rng(seed)
    h, w = 47, 61
    im = np.full((h, w), 255.0, np.float32)
    drawn = rng.uniform(size=(h, w)) < 0.3
    im[drawn] = rng.choice(np.array(SWEEP_EDGE_VALUES, np.float32), int(drawn.sum()))
    starts = [(1.0, 1.0), (w - 2.0, h - 2.0), (1.0, 20.0), (30.0, h - 2.0), (0.0, 0.0),
              (-4.0, 10.0), (w + 3.0, h + 7.0), (20.0, -2.5), (10.5, 20.5), (30.5, 7.0),
              (25.0, 17.5), *rng.uniform([2.0, 2.0], [w - 3.0, h - 3.0], (2, 2))]
    return im, np.arange(-180, 180, 7.3), np.array(starts)


def sweep_cases(im, starts, dev):
    """Phase 11's sweep cases as (name, the kernel's inputs on the card):
    every centroid, one start (trace_rays' route, the first centroid), the
    long-ray map, and the edge inputs at each of SWEEP_EDGE_STEPS."""
    from yag_slam_tpu_torch.mapping import raytrace as RT

    long_im, long_starts = long_ray_map()
    edge_im, edge_angles, edge_starts = sweep_edge_inputs()
    cases = [(f"{len(starts)} centroids", RT._upload(im, SPLICE_ANGLES, starts, dev)),
             ("one start", RT._upload(im, SPLICE_ANGLES, starts[:1], dev)),
             ("long-ray map", RT._upload(long_im, SPLICE_ANGLES, long_starts, dev))]
    *edge, own = RT._upload(edge_im, edge_angles, edge_starts, dev)
    cases += [(f"edge inputs, max_steps {m or own}", (*edge, m or own))
              for m in SWEEP_EDGE_STEPS]
    return cases


def sweep_case(case, args, timed=True):
    """One sweep case on the card: the kernel's lengths and ends bit-equal
    to its plain version's; with `timed`, the row of wrapper, bare kernel
    and plain version beside the bound."""
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.mapping import raytrace as RT

    img, c, s, st, max_steps = args
    (H, W), S, A = img.shape, st.shape[0], c.shape[0]
    got = RT.sweep(*args, ends=True)
    ref = RT.trace_sweeps_ref(*args, ends=True)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"sweep case {case}: the kernel differs from its plain version "
                             f"(max abs error {err} px)")
    first, poison = RT.first_events(*args)
    steps = int((first + 1).sum())
    row = dict(**bound(4 * H * W + 8 * A + 8 * S + 4 * S * A,
                       SWEEP_STEP_OPS * steps + SWEEP_RAY_OPS * S * A),
               case=case, shape=[S, A, H, W, max_steps], steps=steps,
               longest=int(first.max()) + 1, poisoned=int(poison.sum()), max_abs_err=err,
               library=SWEEP_NO_LIBRARY)
    if not timed:
        return row

    def ok(e):
        if e != 0:
            raise AssertionError(f"splice_sweep: bare launch failed, cudaError {e}")

    lib = _build.library()
    length = torch.empty((S, A), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream().cuda_stream
    timings(row, lambda: RT.sweep(*args), lambda: RT.trace_sweeps_ref(*args),
            lambda: ok(lib.yag_sweep(img.data_ptr(), H, W, c.data_ptr(), s.data_ptr(), A,
                                     st.data_ptr(), S, max_steps, length.data_ptr(), None,
                                     None, stream)))
    if not torch.equal(length, got[0]):
        raise AssertionError(f"splice_sweep: a bare launch's lengths differ ({case})")
    return row


def splice_sweep(im, labels, res, origin, dev, gpu):
    """Phase 11 (b): the sweep kernel over every centroid of the card's
    labels, at one start, on the long-ray map and on the edge inputs, each
    held bit for bit to its plain version on the card (lengths and ends);
    the first three timed as wrapper, bare kernel and plain version beside
    the bound; a sweep's waits counted; then whole splices, split into
    their parts, beside the per-centroid routes."""
    from yag_slam_tpu_torch.mapping import raytrace as RT
    from yag_slam_tpu_torch.splicing import splice

    cents = splice.determine_centroids(labels)
    starts = np.array([cents[k] for k in range(len(cents))])
    angles = SPLICE_ANGLES
    rows = [sweep_case(name, args, timed=i < SWEEP_TIMED_CASES)
            for i, (name, args) in enumerate(sweep_cases(im, starts, dev))]
    S, A, H, W, max_steps = rows[0]["shape"]
    waits = render_waits(lambda: RT.trace_sweeps(im, angles, starts, device=dev))
    if len(waits) != SWEEP_WAITS:
        raise AssertionError(f"a sweep waited for the card {len(waits)} times, not "
                             f"{SWEEP_WAITS} (the copy up, the lengths back): {waits}")
    for r in rows:
        timing = (f"ms kernel / wrapper / plain / bound ({r['bound_by']}): "
                  f"{r['kernel_ms']:.4f} / {r['ms']:.4f} / {r['plain_ms']:.4f} / "
                  f"{r['bound_ms']:.5f}" if "kernel_ms" in r else "not timed")
        log(f"phase 11: sweep case {r['case']} ({r['shape'][0]} x {r['shape'][1]} rays, "
            f"map {r['shape'][3]}x{r['shape'][2]}, max_steps {r['shape'][4]}, {r['steps']} "
            f"steps, longest {r['longest']}, {r['poisoned']} poisoned) bit-equal to its plain "
            f"version (lengths and ends); {timing} ({gpu})")

    splice_parts(im, res, origin, dev)             # warm
    runs = [splice_parts(im, res, origin, dev) for _ in range(SPLICE_TIMED)]
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    def per_centroid(one):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y in starts:
            one(x, y)
        return 1e3 * (time.perf_counter() - t0)

    def plain_one(x, y):
        args = RT._upload(im, angles, [(x, y)], dev)
        return RT.trace_sweeps_ref(*args).cpu()

    kernel_loop_ms = per_centroid(lambda x, y: RT.trace_rays(im, angles, x, y, device=dev))
    plain_loop_ms = per_centroid(plain_one)
    sweep_ms = min(timed(lambda: RT.trace_sweeps(im, angles, starts, device=dev))[1]
                   for _ in range(SPLICE_TIMED))
    log(f"phase 11: sweep over {S} centroids x {A} angles (map {W}x{H}, max_steps "
        f"{max_steps}): waits {len(waits)}; trace_sweeps (copy up, launch, copy back) "
        f"{sweep_ms:.3f} ms host wall ({gpu})")
    log(f"phase 11: map_to_graph on the card {split['map_to_graph']:.3f} ms (median of "
        f"{SPLICE_TIMED}): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                                         if k != "map_to_graph")
        + f"; per-centroid routes: trace_rays (the kernel at one start) x {S} "
        f"{kernel_loop_ms:.3f} ms, the plain version with a copy up and back a centroid "
        f"{plain_loop_ms:.3f} ms ({gpu})")
    return dict(cases=rows, waits=len(waits), trace_sweeps_ms=sweep_ms, split=split,
                splits=runs, per_centroid_kernel_ms=kernel_loop_ms,
                per_centroid_plain_ms=plain_loop_ms)


# -- phase 12 ----------------------------------------------------------------------

def solve_times(slam):
    """Host milliseconds of each of slam's SPA solves from here on (each
    ends with the poses copied back to the host)."""
    times, compute = [], slam.opt.compute

    def timed_compute(*args, **kwargs):
        t0 = time.perf_counter()
        out = compute(*args, **kwargs)
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    slam.opt.compute = timed_compute
    return times


def spa_crossover(dev, gpu, sizes=profile_spa_torch.SIZES, cg_sizes=SPA_CG_SIZES):
    """Phase 12 (a): host, dense and cg SPA at profile_spa.py's sizes,
    through profile_spa_torch.crossover."""
    return profile_spa_torch.crossover(dev, sizes, cg_sizes,
                                       log=lambda line: log(f"phase 12: {line}"), label=gpu)


def spa_tour(tour, card_prefix, phase4, dev, gpu):
    """Phase 12 (b): the tour with SPA2d(solver="dense") on the card, held
    to phase 4's run (host SPA)."""
    from yag_slam_tpu_torch.graphopt import spa as S
    from yag_slam_tpu_torch.graphopt.spa import SPA2d
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    nm, gt = tour["n_main"], tour["gt"]
    scans = tour["scans_of"](tour["carmen"][:nm])
    slam = GraphSlam.default(device=dev, dtype=torch.float32,
                             opt=SPA2d(solver="dense", device=dev))
    spa_ms = solve_times(slam)

    def run():
        S.reset_host_reads()
        t0 = time.perf_counter()
        for s in scans[:STREAM_PREFIX]:
            slam.process_scan(s)
        at = graph_state(slam)
        for s in scans[STREAM_PREFIX:]:
            slam.process_scan(s)
        torch.cuda.synchronize()
        return at, time.perf_counter() - t0, dict(S.HOST_READS)

    ((poses, counts), wall, reads), launches = counted(K, run, PK)
    if not spa_ms or reads["lm"] <= 0:
        raise AssertionError("the dense-SPA tour never solved on the card")
    dxy, dth = pose_gap(poses, card_prefix[0])
    est = np.array([xyt(v.obj.corrected_pose)[:2] for v in slam.graph.vertices])
    st = slam.stats
    out = dict(scans=nm, seconds=wall, scans_per_s=nm / wall, prefix=STREAM_PREFIX,
               prefix_counts=counts, host_spa_counts=card_prefix[1], prefix_dxy_m=dxy,
               prefix_dth_rad=dth, loop_closures=st["loop_closures"],
               host_spa_loop_closures=phase4["loop_closures"],
               ate_slam_m=ate(est, gt[:nm, :2]), ate_odom_m=phase4["ate_odom_m"],
               spa_runs=len(spa_ms), spa_ms=spa_ms, spa_ms_mean=statistics.mean(spa_ms),
               spa_ms_median=statistics.median(spa_ms), host_reads=reads,
               host_spa_ms_mean=phase4["spa_ms_mean"],
               host_spa_ms_median=phase4["spa_ms_median"], launches=launches)
    log(f"phase 12: tour with SPA2d(solver='dense') on the card: {nm} scans at "
        f"{out['scans_per_s']:.3f} scans/s; SPA {out['spa_ms_mean']:.3f} ms mean, "
        f"{out['spa_ms_median']:.3f} ms median x {len(spa_ms)} (phase 4's host SPA "
        f"{phase4['spa_ms_mean']:.3f} mean, {phase4['spa_ms_median']:.3f} median x "
        f"{phase4['spa_runs']}), host reads {reads}; first {STREAM_PREFIX}: (vertices, "
        f"edges, closures) {counts} vs {card_prefix[1]}, max |dxy| {dxy:.3e} m, |dth| "
        f"{dth:.3e} rad; tour: {st['loop_closures']} closures vs "
        f"{phase4['loop_closures']}, ATE {out['ate_slam_m']:.4f} m vs odometry "
        f"{out['ate_odom_m']:.4f} m; launches {launches} ({gpu})")
    if counts != card_prefix[1] or dxy > STREAM_TOL or dth > STREAM_TOL:
        raise AssertionError("the dense-SPA tour parted from the host-SPA tour")
    if abs(st["loop_closures"] - phase4["loop_closures"]) > 1:
        raise AssertionError("dense-SPA closures differ from the host-SPA run's by > 1")
    if not out["ate_slam_m"] < out["ate_odom_m"]:
        raise AssertionError("dense-SPA ATE not below odometry's")
    return out


# -- phase 13 ----------------------------------------------------------------------

def serpentine_graph(spa, rows, cols, seed=5):
    """tests/test_parallel.py's rows x cols serpentine lattice (odometry
    chain plus vertical revisit closures, all noisy) on the port's SE(2)
    helpers; returns the node count."""
    from yag_slam_tpu_torch.core.transform import se2_compose, se2_relative

    rng = np.random.default_rng(seed)
    true = []
    for r in range(rows):
        for c in (range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)):
            true.append(np.array([float(c), float(r), 0.0]))
    n = len(true)
    info = np.diag([50.0, 50.0, 100.0])
    info_lc = np.diag([200.0, 200.0, 400.0])
    guesses = [true[0]]
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.01, 3)
        guesses.append(se2_compose(guesses[-1], mean))
    for i, g in enumerate(guesses):
        spa.add_node(g[0], g[1], g[2], i)
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.01, 3)
        spa.add_constraint(i, i + 1, *mean, info.tolist())

    def node_id(r, c):
        return r * cols + (c if r % 2 == 0 else cols - 1 - c)

    for r in range(rows - 1):
        for c in range(0, cols, 4):
            a, b = node_id(r, c), node_id(r + 1, c)
            mean = se2_relative(true[b], true[a]) + rng.normal(0, 0.005, 3)
            spa.add_constraint(a, b, *mean, info_lc.tolist())
    return n


def square_loop_scans():
    """tests/test_parallel.py's 2-lap square loop in the office world:
    (ground truth, scans)."""
    from yag_slam_tpu_torch.io.simulator import (
        SimWorld, drifted_odometry, simulate_scan, square_loop_trajectory)

    gt = square_loop_trajectory(side=5.0, step=0.5, laps=2, start=(-2.5, -2.5))
    odom = drifted_odometry(gt, yaw_bias=0.0025, seed=1)
    rng = np.random.default_rng(101)
    return gt, [simulate_scan(SimWorld.office(), gt[i], n_beams=250, range_threshold=5.0,
                              noise=0.004, rng=rng, odom_pose_xyt=odom[i])
                for i in range(len(gt))]


def solve_row(spa, *args, **kwargs):
    """One timed compute of an SPA2d-shaped solver: cost, ms, LM
    iterations (its verbose line), host reads (LM, and CG chunks of 10
    iterations) and poses."""
    import re

    from yag_slam_tpu_torch.graphopt import spa as S

    torch.cuda.synchronize()
    S.reset_host_reads()
    t0 = time.perf_counter()
    cost, lines = quiet(lambda: spa.compute(*args, verbose=True, **kwargs))
    ms = 1e3 * (time.perf_counter() - t0)
    return dict(cost=cost, ms=ms, lm_iters=int(re.search(r"(\d+) iters", lines[-1]).group(1)),
                host_reads=dict(S.HOST_READS), poses=np.asarray([[v.x, v.y, v.yaw]
                                                                  for v in spa.nodes]))


def sharded_matching(tour, phase4, mesh, dev, gpu):
    """Phase 13 (a): the tour with ShardedLoopMatcher as the loop matcher,
    recording each loop-closure batch; then every batch again through a
    fresh ShardedLoopMatcher (the launches counted) and the plain
    matcher's match_many."""
    from yag_slam_tpu_torch.core.config import default_config_loop
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M
    from yag_slam_tpu_torch.parallel import ShardedLoopMatcher
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    def loop_matcher():
        return M(default_config_loop, loop=True, device=dev, dtype=torch.float32)

    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    slam.loop_matcher = ShardedLoopMatcher(slam.loop_matcher, mesh)
    match_many, batches = slam.loop_matcher.match_many, []

    def recording(jobs, penalty=False, do_fine=False):
        res = match_many(jobs, penalty, do_fine)
        if jobs:
            batches.append(([(q.copy(), [b.copy() for b in bs]) for q, bs in jobs], res))
        return res

    slam.loop_matcher.match_many = recording
    scans = tour["scans_of"](tour["carmen"][:tour["n_main"]])
    _, tour_ms = timed(lambda: [slam.process_scan(s) for s in scans])
    st = slam.stats

    sharded, plain = ShardedLoopMatcher(loop_matcher(), mesh), loop_matcher()
    (again, sharded_ms), launches = counted(K, lambda: timed(
        lambda: [sharded.match_many(jobs, False, False) for jobs, _ in batches]), PK)
    want, plain_ms = timed(lambda: [plain.match_many(jobs, False, False) for jobs, _ in batches])
    jobs = positive = 0
    for (_, first), second, ref in zip(batches, again, want):
        for a, b, c in zip(first, second, ref):
            jobs += 1
            if not same_result(a, b):
                raise AssertionError(f"a sharded batch changed on its replay: {a} vs {b}")
            if c.response > 0.0:
                positive += 1
                if not same_result(b, c):
                    raise AssertionError(f"sharded match differs from the plain one: {b} vs {c}")
    out = dict(batches=len(batches), jobs=jobs, positive=positive, tour_ms=tour_ms,
               tour_loop_closures=st["loop_closures"],
               tour_loop_chains_tried=st["loop_chains_tried"],
               phase4_loop_closures=phase4["loop_closures"],
               phase4_loop_chains_tried=phase4["loop_chains_tried"],
               sharded_ms=sharded_ms, plain_ms=plain_ms, launches=launches)
    log(f"phase 13: tour with ShardedLoopMatcher on the one-rank mesh: {len(scans)} scans in "
        f"{tour_ms:.3f} ms, {st['loop_closures']} closures, {st['loop_chains_tried']} chains "
        f"tried (phase 4: {phase4['loop_closures']}, {phase4['loop_chains_tried']}); its "
        f"{len(batches)} loop-closure batches ({jobs} jobs, {positive} with a positive "
        f"response) again: {sharded_ms:.3f} ms sharded vs {plain_ms:.3f} ms plain, every "
        f"positive job bit-equal; launches {launches} ({gpu})")
    if positive == 0:
        raise AssertionError("no loop-closure job with a positive response")
    return out


def distributed_spa(mesh, dev, gpu):
    """Phase 13 (b): DistributedSPA beside host SPA and SPA2d's cg."""
    from yag_slam_tpu_torch.graphopt.spa import SPA2d
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa
    from yag_slam_tpu_torch.parallel import DistributedSPA

    rows = []
    for n in DSPA_SIZES:
        graph = noisy_loop_pose_graph(n)
        host = solve_row(populate_spa(SPA2d(solver="host", device=dev), *graph), *DSPA_ARGS)
        for solver, mixed in DSPA_COLUMNS:
            if solver == "cg" and n not in DSPA_CG_SIZES:
                continue
            r = solve_row(populate_spa(DistributedSPA(mesh, solver=solver, mixed=mixed),
                                       *graph), *DSPA_ARGS)
            dxy, dth = pose_gap(r.pop("poses"), host["poses"])
            row = dict(nodes=len(graph[0]), solver=f"{solver}:{'mixed' if mixed else 'f64'}",
                       host_ms=host["ms"], host_cost=host["cost"],
                       cost_rel_vs_host=abs(r["cost"] - host["cost"]) / host["cost"],
                       dxy_vs_host_m=dxy, dth_vs_host_rad=dth, **r)
            rows.append(row)
            log(f"phase 13: DistributedSPA {row['nodes']} nodes {row['solver']}: "
                f"{row['ms']:.3f} ms, {row['lm_iters']} LM iterations, host reads "
                f"{row['host_reads']}, chi2 {row['cost']:.6g}; host {host['ms']:.3f} ms, chi2 "
                f"{host['cost']:.6g}: cost {row['cost_rel_vs_host']:.2e} rel, |dxy| "
                f"{dxy:.2e} m, |dth| {dth:.2e} rad ({gpu})")
            if not np.isfinite(row["cost"]):
                raise AssertionError(f"DistributedSPA {row['solver']} at {n} ended non-finite")

    equal = []
    graph = noisy_loop_pose_graph(DSPA_SIZES[0])
    for mixed in (True, False):
        a = solve_row(populate_spa(DistributedSPA(mesh, solver="cg", mixed=mixed), *graph),
                      *DSPA_ARGS)
        b = solve_row(populate_spa(SPA2d(solver="cg", precision="mixed" if mixed else "f64",
                                         device=dev), *graph), *DSPA_ARGS)
        gap = dict(precision="mixed" if mixed else "f64",
                   cost_rel=abs(a["cost"] - b["cost"]) / b["cost"],
                   pose_max=float(np.abs(a["poses"] - b["poses"]).max()))
        equal.append(gap)
        log(f"phase 13: DistributedSPA cg vs SPA2d(solver='cg') {gap['precision']} at "
            f"{len(graph[0])} nodes, one rank: cost {gap['cost_rel']:.3e} rel, poses "
            f"{gap['pose_max']:.3e}")
        if gap["cost_rel"] > DSPA_EQUAL_TOL or gap["pose_max"] > DSPA_EQUAL_TOL:
            raise AssertionError("one-rank DistributedSPA cg differs from SPA2d's cg")

    host = SPA2d(solver="host", device=dev)
    n = serpentine_graph(host, *SERPENTINE)
    h = solve_row(host, 100, 1e-4, True, 1e-9, 50, conv_tol=1e-12)
    d = solve_row(_serp(DistributedSPA(mesh, solver="cg")), *SERPENTINE_ARGS, conv_tol=1e-12)
    serp = dict(nodes=n, ms=d["ms"], lm_iters=d["lm_iters"], host_reads=d["host_reads"],
                cost=d["cost"], host_cost=h["cost"], host_ms=h["ms"],
                cost_rel_vs_host=abs(d["cost"] - h["cost"]) / h["cost"],
                pose_max_vs_host=float(np.abs(d["poses"] - h["poses"]).max()))
    log(f"phase 13: serpentine {n} nodes, DistributedSPA cg (mixed, {SERPENTINE_ARGS}): "
        f"{serp['ms']:.3f} ms, {serp['lm_iters']} LM iterations, host reads "
        f"{serp['host_reads']}; host {serp['host_ms']:.3f} ms; cost "
        f"{serp['cost_rel_vs_host']:.2e} rel, poses {serp['pose_max_vs_host']:.2e} ({gpu})")
    if serp["cost_rel_vs_host"] > SERPENTINE_TOL or serp["pose_max_vs_host"] > SERPENTINE_TOL:
        raise AssertionError("the distributed cg parted from host on the serpentine graph")
    return dict(cells=rows, equal_to_spa2d=equal, serpentine=serp)


def _serp(spa):
    serpentine_graph(spa, *SERPENTINE)
    return spa


def sharded_slam(mesh, dev, gpu):
    """Phase 13 (c): GraphSlam with ShardedLoopMatcher and DistributedSPA
    over the 2-lap square loop."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M
    from yag_slam_tpu_torch.parallel import DistributedSPA, ShardedLoopMatcher
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
    from yag_slam_tpu_torch.utils.metrics import ate_rmse, trajectory_from_slam

    gt, scans = square_loop_scans()
    slam = GraphSlam(M(SQUARE_SEQ, device=dev, dtype=torch.float32),
                     ShardedLoopMatcher(M(SQUARE_LOOP, loop=True, device=dev,
                                          dtype=torch.float32), mesh),
                     loop_search_dist=2.0, loop_search_min_chain_size=5,
                     opt=DistributedSPA(mesh))
    (_, secs), launches = counted(K, lambda: timed(lambda: [slam.process_scan(s)
                                                           for s in scans]), PK)
    secs /= 1e3
    err = ate_rmse(trajectory_from_slam(slam), gt[:, :2], align=False)
    st = slam.stats
    out = dict(scans=len(scans), seconds=secs, scans_per_s=len(scans) / secs,
               loop_closures=st["loop_closures"], spa_runs=st["opt_runs"],
               spa_s=st["opt_time_total"], ate_m=err, launches=launches)
    log(f"phase 13: fully sharded GraphSlam, 2-lap square loop: {len(scans)} scans in "
        f"{secs:.3f} s = {out['scans_per_s']:.3f} scans/s, {st['loop_closures']} closures, "
        f"{st['opt_runs']} DistributedSPA solves in {st['opt_time_total']:.3f} s, ATE "
        f"{err:.4f} m; launches {launches} ({gpu})")
    if st["loop_closures"] < 1 or not err < SQUARE_ATE:
        raise AssertionError(f"fully sharded stack: {st['loop_closures']} closures, ATE {err}")
    return out


def ref_baseline(tour, dev, gpu):
    """Phase 13 (d): the reference matcher on the host CPU over the tour's
    first sequential matches (recorded from a card run), beside the card
    matcher's results on the same matches."""
    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.core.config import default_config
    from yag_slam_tpu_torch.matching.refmatcher import RefBaselineScanMatcher
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    slam = GraphSlam.default(device=dev, dtype=torch.float32)
    match, jobs = slam.seq_matcher.match_scan, []

    def recording(query, base, penalty=True, do_fine=True):
        res = match(query, base, penalty, do_fine)
        jobs.append(((query.copy(), [b.copy() for b in base]), res))
        return res

    slam.seq_matcher.match_scan = recording
    for s in tour["scans_of"](tour["carmen"][:REF_MATCHES + 1]):
        slam.process_scan(s)
    t0 = time.perf_counter()
    ref = RefBaselineScanMatcher(default_config)
    build_s = _build.native_build_seconds
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = [ref.match_scan(q, b) for (q, b), _ in jobs]
    secs = time.perf_counter() - t0
    gaps = np.array([np.hypot(r.best_pose.x - c.best_pose.x, r.best_pose.y - c.best_pose.y)
                     for r, (_, c) in zip(results, jobs)])
    card_s = slam.stats["match_time_total"]
    out = dict(matches=len(jobs), seconds=secs, matches_per_s=len(jobs) / secs,
               n_threads=os.cpu_count(), cpu=cpu_model(), build_s=build_s, init_s=init_s,
               dxy_median_m=float(np.median(gaps)), dxy_max_m=float(gaps.max()),
               card_match_s=card_s, card_matches_per_s=len(jobs) / card_s)
    log(f"phase 13: RefBaselineScanMatcher, {len(jobs)} tour matches on the host CPU "
        f"({out['cpu']}, n_threads {out['n_threads']}): {out['matches_per_s']:.3f} "
        f"matches/s; the card matcher {out['card_matches_per_s']:.3f} matches/s on the same "
        f"matches ({gpu}); |dxy| to the card's median {out['dxy_median_m']:.3e} m, max "
        f"{out['dxy_max_m']:.3e} m; built by the host compiler in "
        f"{build_s if build_s is not None else 'cached'} s")
    if len(jobs) != REF_MATCHES:
        raise AssertionError(f"recorded {len(jobs)} matches, expected {REF_MATCHES}")
    return out


def ab_harness(dev, gpu):
    """Phase 13 (e): ab_compare on the generated tour, port side on the
    card."""
    from yag_slam_tpu_torch.apps import ab_compare
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK

    (res, lines), launches = counted(
        K, lambda: quiet(lambda: ab_compare.main(["--synthetic", "--device", dev.type])), PK)
    for line in lines:
        log(f"phase 13: ab_compare: {line}")
    ref, port = res["ref"], res["port"]
    log(f"phase 13: ab_compare --synthetic --device {dev.type}: vertices {port['vertices']} vs "
        f"{ref['vertices']}, closures {port['loop_closures']} vs {ref['loop_closures']}, "
        f"ATE {port['ate_rmse']:.4f} vs {ref['ate_rmse']:.4f} m (odometry "
        f"{ref['ate_odom']:.4f}), ate_ratio_port_over_ref {res['ate_ratio_port_over_ref']}; "
        f"launches {launches} ({gpu})")
    if port["vertices"] != ref["vertices"] or abs(port["loop_closures"]
                                                  - ref["loop_closures"]) > 1:
        raise AssertionError("ab_compare: the port and the reference parted")
    for side in (ref, port):
        if not side["ate_rmse"] < side["ate_odom"]:
            raise AssertionError(f"ab_compare: {side['matcher']} ATE not below odometry's")
    return dict(result=res, launches=launches)


def figure(slam, tmp):
    """Phase 13 (f): save_slam_figure of phase 4's map (Agg), where
    matplotlib is installed."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        log("phase 13: figure: matplotlib is not installed here, save_slam_figure not run "
            "(tests/test_torch_viz_ros1.py runs it on the CPU)")
        return dict(written=False, reason="matplotlib not installed")
    from yag_slam_tpu_torch.utils import save_slam_figure

    path = save_slam_figure(slam, os.path.join(tmp, "map.png"))
    size = os.path.getsize(path)
    log(f"phase 13: save_slam_figure wrote {size} bytes")
    if size == 0:
        raise AssertionError("save_slam_figure wrote an empty file")
    return dict(written=True, bytes=size)


def last_modules(tour, slam, phase4, tmp, dev, gpu):
    """Phase 13: the parallel paths on a one-rank NCCL mesh, the reference
    baseline, the A/B harness and the figure, each timed."""
    import torch.distributed as dist

    from yag_slam_tpu_torch.parallel import default_mesh

    out, secs = {}, {}
    mesh = default_mesh(device=dev)
    try:
        for name, fn in (("sharded", lambda: sharded_matching(tour, phase4, mesh, dev, gpu)),
                         ("dist_spa", lambda: distributed_spa(mesh, dev, gpu)),
                         ("sharded_slam", lambda: sharded_slam(mesh, dev, gpu))):
            t0 = time.perf_counter()
            out[name] = fn()
            secs[name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    for name, fn in (("refbaseline", lambda: ref_baseline(tour, dev, gpu)),
                     ("ab_compare", lambda: ab_harness(dev, gpu)),
                     ("figure", lambda: figure(slam, tmp))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
    out["seconds"] = secs
    log(f"phase 13: seconds {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}")
    return out


# -- phase 15 ----------------------------------------------------------------------

def bits(t):
    """`t`'s bits as integers, so NaN payloads compare too."""
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


@contextlib.contextmanager
def recorded_keys():
    """Within, the first arguments of each key the process's CUDA graphs
    meet, by key: {key: (matcher, args, P, penalty, do_fine, offset, S,
    queries)}."""
    from yag_slam_tpu_torch.matching.graphs import GRAPHS as G

    first = {}
    run = G.run

    def rec(m, args, P, penalty, do_fine, offset, S, queries=None):
        key = G.key(m, args, P, penalty, do_fine, offset, S, queries)
        if key not in first:
            cp = lambda a: a.clone() if isinstance(a, torch.Tensor) else np.array(a)  # noqa: E731
            first[key] = (m, tuple(map(cp, args)), P, penalty, do_fine, offset, S,
                          None if queries is None else tuple(map(cp, queries)))
        return run(m, args, P, penalty, do_fine, offset, S, queries)

    G.run = rec
    try:
        yield first
    finally:
        G.run = run


@contextlib.contextmanager
def held_replays():
    """Within, every replay of the process's CUDA graphs is held bit for
    bit (packed result and meta grid) against a direct call of _compute on
    the same staged inputs, launched right after it (those launches are not
    counted) and compared when the block ends, so that nothing waits for
    the card meanwhile.  Yields the tally {"replays": n, "keys": {key:
    replays}}."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching.graphs import GRAPHS as G

    tally = dict(replays=0, keys={})
    pairs = []
    run = G.run

    def held(m, args, P, penalty, do_fine, offset, S, queries=None):
        out = run(m, args, P, penalty, do_fine, offset, S, queries)
        key = G.key(m, args, P, penalty, do_fine, offset, S, queries)
        e = G.entry(key)
        if e.graph is not None:
            with K.captured_launches():
                pairs.append((key, out, m._compute(e.inputs, S, penalty, do_fine, offset)))
            tally["replays"] += 1
            tally["keys"][key] = tally["keys"].get(key, 0) + 1
        return out

    G.run = held
    try:
        yield tally
    finally:
        G.run = run
    for key, out, want in pairs:
        for a, b in zip(out, want):
            if (a is None) != (b is None) or a is not None and not torch.equal(
                    bits(a), bits(b)):
                raise AssertionError(f"a replay differs from _compute at {key}")


def key_kind(key, loop_matcher):
    """The tour's kinds of _run: the loop matcher's coarse batches, the
    sequential matcher's unpenalized fine batches, its scan matches."""
    if key.config == loop_matcher.config:
        return "loop_coarse"
    return "sequential" if key.penalty else "loop_fine"


@contextlib.contextmanager
def sync_errors():
    """Within, an operation that makes the host wait for the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def graph_stats():
    from yag_slam_tpu_torch.matching.graphs import GRAPHS

    return dict(GRAPHS.stats)


def stats_delta(before, after):
    d = {k: after[k] - before[k] for k in before}
    d["ms_per_capture"] = 1e3 * d["capture_s"] / d["captures"] if d["captures"] else None
    return d


def host_times(m, rec, n=20):
    """Host milliseconds of one dispatch of a captured key (staging,
    replay, clone: no wait) and of one eager _run (staging and _compute)
    at the same inputs, medians over n and n // 2, the card idle before
    each."""
    _, args, P, penalty, do_fine, offset, S, queries = rec

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        return ms

    replay = [host_ms(lambda: m._run(args, P, penalty, do_fine, offset, S, queries))
              for _ in range(n)]
    eager = [host_ms(lambda: m._compute(m._stage(args, queries), S, penalty, do_fine,
                                        offset)) for _ in range(n // 2)]
    return statistics.median(replay), statistics.median(eager)


def x64_batches(seed):
    """The office cell's traffic: bench_torch's batched jobs of X64_STREAMS
    fresh 150-scan streams from `seed` on, in full batches of X64_BATCH."""
    jobs = [j for k in range(X64_STREAMS)
            for j in bench_torch.batch_jobs(bench_torch.build_stream(seed=seed + k))]
    return [jobs[i:i + X64_BATCH] for i in range(0, len(jobs) - X64_BATCH + 1, X64_BATCH)]


def x64_costs(dev):
    """Phase 15's host costs at 64 jobs a dispatch, on fresh scans as the
    office cell meets them: _prepare and the library's flush, host ms a
    batch (medians; the batched views of the batch's new scans timed
    apart), then the wall ms a dispatch with one batch in flight (the
    caller's submit and result apart) once a pass over the same batches
    on fresh scans has captured every key."""
    from yag_slam_tpu_torch import native
    from yag_slam_tpu_torch.matching.graphs import CAPTURE_AT_USE
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    made = []
    batched = native.scan_views

    def timed_views(scans, cap):
        t = time.perf_counter()
        try:
            return batched(scans, cap)
        finally:
            made.append((len(scans), time.perf_counter() - t))

    m = M(bench_torch.CFG, device=dev)
    prep, flush, views, new, calls = [], [], [], [], []
    native.scan_views = timed_views
    try:
        for b in x64_batches(200):
            made.clear()
            t0 = time.perf_counter()
            m._prepare(b, n_pad=X64_BATCH)
            t1 = time.perf_counter()
            m.library.flush()
            flush.append(1e3 * (time.perf_counter() - t1))
            prep.append(1e3 * (t1 - t0))
            views.append(1e3 * sum(t for _, t in made))
            new.append(sum(n for n, _ in made))
            calls.append(len(made))
    finally:
        native.scan_views = batched
    # a new scan's view by the per-scan ops against the batched op, on one
    # fresh stream at the batches' point capacity
    scans, cap = bench_torch.build_stream(seed=400), m.library.P
    v0 = time.perf_counter()
    for s in scans:
        lx, ly, n = native.compact_beams(s.ranges, s.min_angle, s.angle_increment,
                                         s.range_threshold, cap)
        native.segment_runs(lx, ly, n)
    v1 = time.perf_counter()
    batched(scans, cap)
    v2 = time.perf_counter()

    def one_deep(m, batches, times=None):
        out, h = [], None
        for b in batches:
            t = time.perf_counter()
            nxt = m.match_many_async(b)
            t1 = time.perf_counter()
            if h is not None:
                out += h.result()
            if times is not None:
                times.append((t1 - t, time.perf_counter() - t1))
            h = nxt
        return out + h.result()

    for _ in range(CAPTURE_AT_USE):
        one_deep(M(bench_torch.CFG, device=dev), x64_batches(300))
    batches = x64_batches(300)
    m = M(bench_torch.CFG, device=dev)
    times = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = one_deep(m, batches, times)
    wall = time.perf_counter() - t0
    if len(res) != X64_BATCH * len(batches) or not all(
            np.isfinite(r.response) and r.response > 0 for r in res):
        raise AssertionError("an x64 result is not finite and positive")
    med = statistics.median
    return dict(batches=len(batches), prepare_ms=med(prep), flush_ms=med(flush),
                views_ms=med(views), new_scans=statistics.mean(new),
                view_us_per_scan_ops=1e6 * (v1 - v0) / len(scans),
                view_us_batched=1e6 * (v2 - v1) / len(scans),
                view_calls=statistics.mean(calls), dispatch_ms=1e3 * wall / len(batches),
                submit_ms=1e3 * med(s for s, _ in times),
                result_ms=1e3 * med(r for _, r in times[1:]),
                matches_per_s=len(res) / wall)


def replay_nodes(key, rec, runs=5):
    """What the card runs for one _run of `key` (captured): the device
    activities of a trace (kernels, copies, fills), their busy ms and the
    kernels by name, for the graph's replay alone and for a whole
    dispatch of the key's first arguments (staging, replay, clone); means
    over `runs`."""
    from torch.profiler import ProfilerActivity, profile

    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.graphs import GRAPHS

    # the program kernels first: the fused window sum's names are window_sum's
    symbols = {k: v["symbols"] for k, v in (*PK.KERNELS.items(), *K.KERNELS.items())}

    def traced(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        count = dict.fromkeys(DEVICE_CATS, 0)
        for e in events:
            if e.get("cat") in count and "dur" in e:
                count[e["cat"]] += 1
        tl = device_timeline(events, symbols)
        return dict(nodes=sum(count.values()) / runs, kernels=count["kernel"] / runs,
                    copies=count["gpu_memcpy"] / runs, fills=count["gpu_memset"] / runs,
                    busy_ms=tl["busy_ms"] / runs,
                    parts={k: v["count"] / runs for k, v in tl["parts"].items() if v["count"]})

    def whole(fn):
        # a trace that lost device events (no kernel at all, or a part not
        # launched the same number of times each run) is taken again
        for _ in range(3):
            t = traced(fn)
            if t["kernels"] > 0 and all(float(v).is_integer() for v in t["parts"].values()):
                return t
        raise AssertionError(f"the traces of {key} lose device events: {t}")

    m = rec[0]
    if GRAPHS.entry(key).graph is None:
        raise AssertionError(f"key {key} was never captured")
    return dict(replay=whole(GRAPHS.entry(key).graph.replay),
                dispatch=whole(lambda: m._run(*rec[1:])))


def graphs_phase(slam, tour_keys, tour, dev, gpu):
    """Phase 15: every key the tour met held bit for bit, replay against
    _compute; the office batch of 64 with one batch in flight; one
    dispatch of each kind under the sync debug mode's errors; capture and
    dispatch costs."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching.graphs import CAPTURE_AT_USE, GRAPHS
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M
    from yag_slam_tpu_torch.matching.pipeline import OnlineMatchPipeline

    t0 = time.perf_counter()
    out = dict(capture_at_use=CAPTURE_AT_USE)
    before = graph_stats()
    kinds = {}
    with held_replays() as tally:
        for key, rec in tour_keys.items():
            m = rec[0]
            while GRAPHS.entry(key).graph is None or key not in tally["keys"]:
                m._run(*rec[1:])
            kinds.setdefault(key_kind(key, slam.loop_matcher), []).append(
                [key.N, key.B, key.S, key.coarse_offset])
    if len(tally["keys"]) != len(tour_keys):
        raise AssertionError("a key of the tour was not held")
    out["tour_keys"] = {k: dict(keys=len(v), shapes=sorted(v)) for k, v in kinds.items()}
    out["tour_keys_held"] = len(tally["keys"])
    seq_S = sorted({s for _, _, s, _ in kinds.get("sequential", [])})
    log(f"phase 15: the tour's {len(tour_keys)} keys held, replay == _compute bit for bit: "
        + ", ".join(f"{k} {v['keys']}" for k, v in out["tour_keys"].items())
        + f"; sequential S {seq_S}")
    for k in ("sequential", "loop_coarse", "loop_fine"):
        if k not in kinds:
            raise AssertionError(f"the tour met no {k} key")
    out["tour_run_nodes"] = {}
    for kind in ("sequential", "loop_coarse"):
        key, rec = next((k, r) for k, r in tour_keys.items()
                        if key_kind(k, slam.loop_matcher) == kind)
        out["tour_run_nodes"][kind] = n = replay_nodes(key, rec)
        log(f"phase 15: one {kind} _run of the tour (N={key.N} B={key.B} S={key.S}): its "
            f"graph's replay runs {n['replay']['nodes']:g} device nodes "
            f"({n['replay']['kernels']:g} kernels, {n['replay']['copies']:g} copies, "
            f"{n['replay']['fills']:g} fills), busy {n['replay']['busy_ms']:.4f} ms "
            f"({n['replay']['parts']}); the whole dispatch (staging, replay, clone) "
            f"{n['dispatch']['nodes']:g} nodes, busy {n['dispatch']['busy_ms']:.4f} ms ({gpu})")

    # the office cell's pattern: batches of 64, one in flight
    scans = bench_torch.build_stream()
    jobs = bench_torch.batch_jobs(scans)
    batches = [jobs[:64], jobs[64:128], jobs[1:65]]
    m = M(bench_torch.CFG, device=dev)
    for _ in range(CAPTURE_AT_USE):
        m.match_many_async(batches[0]).result()
    off = m.config.coarse_search_angle_offset
    want = []
    for b in batches:
        args, P, S = m._prepare(b)
        with K.captured_launches():
            want.append(m._compute(m._stage(args), S, True, True, off)[0].cpu())
    with held_replays() as tally:
        with sync_errors():
            h = m.match_many_async(batches[0])
        for k in (1, 2):
            with sync_errors():
                nxt = m.match_many_async(batches[k])
            packed = torch.from_numpy(h._pending[0]())
            if not torch.equal(bits(packed), bits(want[k - 1])):
                raise AssertionError("a batch in flight changed an earlier result")
            h.result()
            h = nxt
        if not torch.equal(bits(torch.from_numpy(h._pending[0]())), bits(want[2])):
            raise AssertionError("the last batch differs from _compute")
        h.result()
    out["async64"] = dict(batches=len(batches), replays_held=tally["replays"])
    log(f"phase 15: match_many_async x64, one batch in flight: {tally['replays']} "
        f"replays held, every result equal to _compute's after the next batch ran")
    out["x64_costs"] = c = x64_costs(dev)
    log(f"phase 15: x64, the office cell's traffic ({c['batches']} batches of {X64_BATCH}): "
        f"_prepare {c['prepare_ms']:.3f} ms a batch (median), of which the views of "
        f"{c['new_scans']:.1f} new scans {c['views_ms']:.3f} ms in {c['view_calls']:.1f} "
        f"native call(s) (a view {c['view_us_batched']:.2f} us batched, "
        f"{c['view_us_per_scan_ops']:.2f} us by the per-scan ops); flush "
        f"{c['flush_ms']:.3f} ms; one batch in flight: "
        f"{c['dispatch_ms']:.3f} ms a dispatch wall (submit {c['submit_ms']:.3f}, result "
        f"{c['result_ms']:.3f}), {c['matches_per_s']:.1f} matches/s ({gpu})")

    # one dispatch of each kind, three times (eager, capture, replay where
    # the key is new), with any wait for the card raising
    seq, meta = slam.seq_matcher, M(device=dev, return_meta=True)
    scans = [v.obj for v in slam.graph.vertices]
    q, base = scans[200], scans[190:200]
    P = seq._point_cap
    before_kinds = graph_stats()
    for _ in range(3):
        with sync_errors():
            handles = [seq.match_scan_async(q, base), meta.match_scan_async(q, base),
                       seq.match_many_async([(scans[i], scans[i - 10:i])
                                             for i in range(150, 155)])]
        for hd in handles:
            hd.result()
        lx, ly, n = q.local_points_padded(P)
        far = np.arange(P) >= n
        queries = (np.where(far, 1.0e9, lx)[None].astype(np.float32),
                   np.where(far, 1.0e9, ly)[None].astype(np.float32),
                   np.array([n], dtype=np.int32))
        B = seq._base_bucket(len(base))
        (idx, mask, pose, q_idx, center, vp, sub), S = seq._assemble_jobs([(q, base)], P, B)
        with sync_errors():
            seq._run((idx, mask, pose, q_idx, center, vp, sub), P, True, True,
                     seq.config.coarse_search_angle_offset, S, queries)
        # fresh scans: the pipeline puts its estimates on the scans it takes
        fresh = tour["scans_of"](tour["carmen"][:STREAM_SYNC])
        pipe = OnlineMatchPipeline(M(device=dev), window=10, sync_every=STREAM_SYNC,
                                   block_dispatch=True)
        pipe.seed(fresh[:1])
        for s in fresh[1:]:
            pipe.push(s)
        with sync_errors():
            pipe._dispatch()
        pipe.flush()
        with sync_errors():
            seq.match_many_mega([(scans[i], scans[i - 10:i]) for i in range(120, 128)],
                                chunk=4)
    out["sync_free"] = stats_delta(before_kinds, graph_stats())
    log(f"phase 15: match_scan_async, with meta, match_many_async, explicit queries, "
        f"the pipeline's block dispatch and match_many_mega, 3 times each, with syncs "
        f"raising: no wait for the card before the result ({out['sync_free']})")

    # costs: capture, and the host time of a dispatch against an eager _run
    key = next(k for k in tour_keys if key_kind(k, slam.loop_matcher) == "sequential"
               and k.S == max(seq_S))
    replay_ms, eager_ms = host_times(tour_keys[key][0], tour_keys[key])
    out["costs"] = dict(stats_delta(before, graph_stats()), key=[key.N, key.B, key.S],
                        host_us_per_replay=1e3 * replay_ms, host_ms_per_eager_run=eager_ms,
                        peak_mb=torch.cuda.max_memory_allocated() / 1e6,
                        peak_reserved_mb=torch.cuda.max_memory_reserved() / 1e6)
    out["process"] = graph_stats()
    out["seconds"] = time.perf_counter() - t0
    c = out["costs"]
    log(f"phase 15: sequential key N 1 S {key.S}: host {c['host_us_per_replay']:.1f} us a "
        f"replayed dispatch vs {eager_ms:.3f} ms an eager _run; this phase "
        f"{c['captures']} captures, {c['ms_per_capture']:.3f} ms each; the process so far "
        f"{out['process']}; the process's peak {c['peak_mb']:.1f} MB allocated, "
        f"{c['peak_reserved_mb']:.1f} MB reserved; {out['seconds']:.1f} s ({gpu})")
    return out


# -- phase 14 ----------------------------------------------------------------------

def flip_counts(cfg):
    """The most one query point's window sum can move when its cell
    rounds one cell apart: the largest step between neighbouring cells of
    the quantized smeared grid (100 x the largest step of the 1-D taps),
    plus one for the floor."""
    from yag_slam_tpu_torch.matching.correlation import gaussian_kernel_1d

    taps = gaussian_kernel_1d(cfg["resolution"], cfg["smear_deviation"])
    return int(np.ceil(100 * np.abs(np.diff(taps)).max())) + 1


def bench_rows(dev, gpu):
    """Phase 14: bench_torch's device rows at the benchmark's full
    configuration (its mega results held to match_many on every job), its
    first batched jobs held to the host's float32 plain path, and
    profile_match_torch's stages, one composed pass counted."""
    from yag_slam_tpu_torch.matching import kernels as K
    from yag_slam_tpu_torch.matching import program_kernels as PK
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M

    t0 = time.perf_counter()
    scans = bench_torch.build_stream()
    rows, launches = counted(K, lambda: bench_torch.bench_device(scans, device=dev,
                                                                 repeats=bench_torch.REPEATS), PK)
    jobs = bench_torch.batch_jobs(scans)[:BENCH_HELD_JOBS]
    worst = {}
    for dtype in (torch.float64, torch.float32):
        card = M(bench_torch.CFG, device=dev, dtype=dtype).match_many(jobs)
        host = M(bench_torch.CFG, device="cpu", dtype=dtype).match_many(jobs)
        gaps = [result_gap(a, b) for a, b in zip(card, host)]
        for g, (q, _) in zip(gaps, jobs):
            # the response gap in window-sum counts (penalty <= 1)
            g["counts"] = g["response"] * 100 * q.num_valid_beams
            if dtype == torch.float64:
                ok = max(g["response"], g["dxy_m"], g["dth_rad"], g["cov_rel"]) <= BENCH_F64_TOL
            else:
                ok = (g["counts"] <= flip_counts(bench_torch.CFG) and g["dxy_m"] <= API_TOL
                      and g["dth_rad"] <= API_TOL and g["cov_rel"] <= COV_RTOL)
            if not ok:
                raise AssertionError(f"bench_torch's batched jobs: card vs host {dtype} {g}")
        worst[str(dtype)] = {k: max(g[k] for g in gaps) for k in gaps[0]}
    bench_s = time.perf_counter() - t0
    for name, r in rows.items():
        if name != "match_response":
            log(f"phase 14: bench {name}: {r['median']:.3f} matches/s (median of "
                f"{bench_torch.REPEATS}, {r['spread'][0]:.3f}-{r['spread'][1]:.3f}); launches "
                f"per match {r['launches_per_match']} ({gpu})")
    log(f"phase 14: mega == match_many on every job; first {len(jobs)} batched jobs card "
        f"vs host worst {worst} (flip bar {flip_counts(bench_torch.CFG)} counts in float32); "
        f"launches {launches}; {bench_s:.1f} s")

    t0 = time.perf_counter()
    ctx = profile_match_torch.setup(device=dev)
    _, prof_launches = counted(K, lambda: profile_match_torch.compose(ctx), PK)
    prof = profile_match_torch.profile(ctx)
    for line in quiet(lambda: profile_match_torch.report(prof, torch.cuda.get_device_name(0),
                                                         gpu))[1]:
        log(f"phase 14: {line}")
    log(f"phase 14: one composed pass of the stages launches {prof_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, launches=launches, held_jobs=len(jobs), worst_gap=worst,
                bench_s=bench_s, profile=dict(prof, launches=prof_launches))


def kernel_lines(K, checks, slam):
    """Per-kernel results of the run: the phase-3 cases (plus the tour-map
    smear of phase 8) and the launches of every driven path; the program
    kernels' phase-3b cases (in `checks` too) and launches; then the
    render's kernels, their cases and launches from phase 5, and the
    splice's sweep, its case and launches from phase 11."""
    from yag_slam_tpu_torch.mapping import raytrace as RT
    from yag_slam_tpu_torch.mapping import render_kernel as R
    from yag_slam_tpu_torch.matching import program_kernels as PK

    checks["smear_grid"].append(slam["localize"]["smear_case"])
    paths = dict(slam=slam["launches"], **slam["matcher_api"]["launches"],
                 localize=slam["localize"]["launches"],
                 stream=slam["stream"]["launches"],
                 pipeline=slam["stream"]["modes"]["launches"],
                 **slam["entry_points"]["launches"],
                 lifelong=slam["lifelong"]["launches"],
                 spa_tour=slam["spa"]["tour"]["launches"],
                 sharded=slam["last_modules"]["sharded"]["launches"],
                 sharded_slam=slam["last_modules"]["sharded_slam"]["launches"],
                 ab_compare=slam["last_modules"]["ab_compare"]["launches"],
                 bench=slam["bench"]["launches"],
                 profile_match=slam["bench"]["profile"]["launches"])
    for path in ("meta", "scan_sets", "localize", "profile_match"):
        if paths[path]["smear_grid"] <= 0:
            raise AssertionError(f"smear_grid never launched on the {path} path")
    for path in ("stream", "pipeline", "cli", "threaded", "lifelong", "spa_tour", "sharded",
                 "sharded_slam", "ab_compare", "bench", "profile_match"):
        for k in SLAM_KERNELS + PROGRAM_KERNELS:
            if paths[path][k] <= 0:
                raise AssertionError(f"{k} never launched on the {path} path")
    # every matcher grid build is one scatter fed by the base points, every
    # pass one window sum fed by the query points and one reduction: as
    # many launches as the kernel each pairs with, on every path but the
    # map conversion's, which scatters the map's own cells through the
    # table-fed scatter (phase 8; it matches by the element path)
    for path, n in paths.items():
        if path in MAP_GRID_PATHS:
            if n["scatter_cells"] <= n["world_scatter"]:
                raise AssertionError(f"no table-fed scatter_cells on the {path} path: {n}")
            continue
        for k, after in PROGRAM_AFTER.items():
            if n[k] != n[after]:
                raise AssertionError(f"{n[after]} {after} but {n[k]} {k} launches on the "
                                     f"{path} path")
    kernels = []
    for k, info in K.KERNELS.items():
        main_case = checks[k][0]
        by_path = {p: n[k] for p, n in paths.items() if n[k] > 0}
        if not by_path:
            raise AssertionError(f"kernel {k} launched on no driven path")
        kernels.append(dict(
            name=k, route="cuda" if info["source"].endswith(".cu") else "triton",
            source=info["source"], replaces=info["replaces"][0],
            also_replaces=info["replaces"][1:],
            launches=sum(by_path.values()), launches_by_path=by_path,
            launches_per_scan=slam["launches"][k] / slam["scans"],
            max_abs_err=max(r["max_abs_err"] for r in checks[k]),
            ms=main_case["kernel_ms"], wrapper_ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
            library=main_case["library"], share=main_case["share"],
            case=main_case["case"], cases=checks[k],
        ))
    # the kernels with no Pallas counterpart: the matcher's program
    # kernels, on every matcher path; the render's, on phase 5's path; the
    # splice's sweep, on phase 11's
    x64_row = slam["bench"]["rows"]["64"]["launches_per_match"]
    for k, info in PK.KERNELS.items():
        cases = checks[k]
        main_case = cases[0]
        by_path = {p: n[k] for p, n in paths.items() if n[k] > 0}
        kernels.append(dict(
            name=k, route="cuda", source=info["source"], replaces=info["replaces"][0],
            also_replaces=info["replaces"][1:], launches=sum(by_path.values()),
            launches_by_path=by_path,
            launches_per_scan=slam["launches"][k] / slam["scans"],
            launches_per_batch_match=x64_row[k],
            max_abs_err=max(r["max_abs_err"] for r in cases),
            ms=main_case["kernel_ms"], wrapper_ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
            library=main_case["library"], share=main_case["share"],
            case=main_case["case"], cases=cases,
        ))
    render, life = slam["render"], slam["lifelong"]
    added = [(k, info, "render", render["launches"].get(k, 0), render["cases"][k],
              dict(launches_per_render=render["launches"].get(k, 0) / render["renders"]))
             for k, info in R.KERNELS.items()]
    added += [(k, info, "lifelong", life["launches"].get(k, 0), life["sweep"]["cases"],
               dict(launches_per_splice=life["launches"].get(k, 0) / life["splices"]))
              for k, info in RT.KERNELS.items()]
    for k, info, path, n, cases, per in added:
        if n <= 0:
            raise AssertionError(f"{k} never launched on the {path} path")
        main_case = cases[0]
        kernels.append(dict(
            name=k, route="cuda", source=info["source"], replaces=info["replaces"],
            also_replaces=[], launches=n, launches_by_path={path: n}, **per,
            max_abs_err=max(r["max_abs_err"] for r in cases),
            ms=main_case["kernel_ms"], wrapper_ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
            library=main_case["library"], share=main_case["share"],
            case=main_case["case"], cases=cases,
        ))
    return kernels


def package_modules():
    """JAX and JAX-package modules loaded in this process (the port and
    this script import neither)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "yag_slam_tpu"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3b only: build, hold each kernel to its plain "
                         "version and time it; prints no result line")
    ap.add_argument("--csrc", help="with --kernels-only: build the kernels from this "
                                   "directory of CUDA sources (an earlier tree's "
                                   "csrc, to time its kernels the same way)")
    args = ap.parse_args()
    if args.csrc and not args.kernels_only:
        ap.error("--csrc needs --kernels-only")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    log(f"phase 1: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; {gpu}")

    from yag_slam_tpu_torch import _build
    from yag_slam_tpu_torch.matching import correlation as C
    from yag_slam_tpu_torch.matching import kernels as K

    if args.csrc:
        _build.CSRC_DIR = Path(args.csrc).resolve()
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels from {_build.CSRC_DIR} built in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    taps = {cfg: torch.as_tensor(
                C.check_smear_taps(C.gaussian_kernel_1d(*cfg).astype(np.float32)),
                device=dev)
            for cfg in ((0.01, 0.05), (0.05, 0.05), (0.01, 0.07))}
    if len(taps[(0.01, 0.07)]) != 2 * NODE_H + 1:
        raise AssertionError("the node-default smear is not h = 14")
    checks = check_kernels(K, taps[(0.01, 0.05)], taps[(0.05, 0.05)],
                           taps[(0.01, 0.07)], dev)
    program = check_program(dev)
    if args.kernels_only:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(gpu=gpu, device=name, kernels=checks, program=program), f,
                          indent=1)
        log(f"phase 3: done ({gpu}); --kernels-only, no result line")
        return
    with tempfile.TemporaryDirectory() as tmp:
        slam = run_slam(tmp, gpu, dev)
    out = dict(gpu=gpu, device=name, kernels=checks, slam=slam)

    # the port runs without JAX and without any module of the JAX package
    loaded = package_modules()
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded[:5]}")

    checks.update(program)
    kernels = kernel_lines(K, checks, slam)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    nodes = slam["graphs"]["phase15"]["tour_run_nodes"]["sequential"]
    print(json.dumps({"bench": slam["bench"]}))
    print(json.dumps({"hostops": slam["hostops"]}))
    print(f"program: one captured sequential _run of the tour replays "
          f"{nodes['replay']['nodes']:g} device nodes ({nodes['replay']['kernels']:g} kernels, "
          f"{nodes['replay']['copies']:g} copies, {nodes['replay']['fills']:g} fills), busy "
          f"{nodes['replay']['busy_ms']:.4f} ms; the card is busy "
          f"{slam['profile']['busy_ms_per_scan']:.4f} ms a tour scan (scans "
          f"{PROFILE_SCANS[0]}-{PROFILE_SCANS[1] - 1} traced); {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
