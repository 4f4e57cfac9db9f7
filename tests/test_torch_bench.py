"""The port's measurement harnesses (bench_torch.py, profile_match_torch.py,
profile_spa_torch.py, scaling_bench_torch.py) against the JAX side's
scripts and matcher, on the CPU in float64.

The JAX-side scripts are read by AST or imported for their host-side
helpers only (bench.build_stream); none of them is run.  Matches at
bench.py's configuration are held to the JAX CorrelativeScanMatcher built
as tests/test_torch_matcher.py builds it (use_patch=True,
use_pallas=False, float64), within its tolerance TOL = 1e-9.
"""
import ast
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402  (the JAX side's script: build_stream only)
import bench_torch  # noqa: E402
import profile_match_torch  # noqa: E402
import profile_spa_torch  # noqa: E402
import scaling_bench_torch  # noqa: E402
from yag_slam_tpu.core.scan import LocalizedRangeScan as JaxScan  # noqa: E402
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher  # noqa: E402
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher  # noqa: E402

TOL = 1e-9          # tests/test_torch_matcher.py's
N_SCANS = 15        # enough for the lockstep jobs, a 4-job batch and 2 profile jobs
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_matcher():
    return JaxMatcher(bench.CFG, dtype=np.float64, use_patch=True, use_pallas=False)


def _scan_fields(s):
    p, o = s.corrected_pose, s.odom_pose
    return (np.asarray(s.ranges), s.min_angle, s.max_angle, s.angle_increment, s.min_range,
            s.max_range, s.range_threshold, (p.x, p.y, p.euler[-1]), (o.x, o.y, o.euler[-1]))


@pytest.mark.parametrize("script", [bench_torch, profile_match_torch])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_stream_is_bench_py_s(script, seed):
    """Each script's copy of build_stream gives bench.py's scans bit for bit."""
    assert script.CFG == bench.CFG and script.N_BASE == bench.N_BASE
    got = script.build_stream(n_scans=14, seed=seed)
    want = bench.build_stream(n_scans=14, seed=seed)
    assert len(got) == len(want) == 14
    for a, b in zip(got, want):
        fa, fb = _scan_fields(a), _scan_fields(b)
        np.testing.assert_array_equal(fa[0], fb[0])
        assert fa[1:] == fb[1:]


def test_bench_constants_are_bench_py_s():
    assert bench_torch.BATCH == bench.BATCH
    assert bench_torch.MODES == {"stream": (8, False, 0), "block": (8, True, 0),
                                 "lowlat_s2_l1": (2, True, 1), "lowlat_s4_l1": (4, True, 1)}
    # every timed stream its own seed, none the warm stream's
    seeds = [bench_torch.pipeline_seed(i, r) for i in range(len(bench_torch.MODES))
             for r in range(bench_torch.REPEATS)]
    seeds += [bench_torch.batch_seed(r) for r in range(1, bench_torch.REPEATS)]
    assert len(set(seeds)) == len(seeds) and bench_torch.WARM_SEED not in seeds
    assert bench_torch.pipeline_seed(0, 0) == bench_torch.batch_seed(0) == 0


def _bench_py_keys():
    """The keys of bench.py's output line: its `out = {...}` literal in
    main() and its `out["..."] = ...` assignments."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "out" and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == "out"):
                    keys.add(t.slice.value)
    return keys


def _fake_line():
    row = dict(median=2.0, spread=[1.0, 3.0],
               launches_per_match={"scatter_cells": 1.0, "window_sum": 2.0})
    rows = {k: dict(row) for k in list(bench_torch.MODES) + ["lockstep", "mega", "16", "64"]}
    rows["block"] = dict(row, median=5.0)
    rows["64"] = dict(row, median=7.0)
    rows["match_response"] = 0.9
    spa = {k: (10.0, [9.0, 11.0], 503) for k in ("host", "cg", "dense")}
    return bench_torch.result_line(rows, spa, 4.0, 8.0, "NVIDIA H100 80GB HBM3",
                                   "NVIDIA H100 80GB HBM3, 700.00 W", "host, 8 CPUs")


def test_result_line_holds_every_key_of_bench_py():
    keys = _bench_py_keys()
    assert {"metric", "value", "vs_baseline", "batched_by_size", "spa_solve_ms_host",
            "spa_solve_ms_device_dense_mixed"} <= keys and len(keys) == 20
    line = json.loads(json.dumps(_fake_line()))
    assert keys <= set(line)
    assert line["backend"] == "cuda" and line["metric"] == "scan_matches_per_sec"
    assert line["device"] == "NVIDIA H100 80GB HBM3" and line["power_limit"] == "700.00 W"
    # bench.py's maxima over the medians, and a spread beside every median
    assert line["single_stream"] == 5.0 and line["batched"] == 7.0 and line["value"] == 7.0
    assert line["vs_baseline"] == 7.0 / 4.0 and line["single_vs_baseline"] == 5.0 / 4.0
    assert set(line["batched_by_size"]) == {"mega", "16", "64"}
    sp = line["spread"]
    assert set(sp["single_stream_by_mode"]) == set(line["single_stream_by_mode"])
    assert set(sp["batched_by_size"]) == set(line["batched_by_size"])
    assert sp["single_stream_lockstep"] == [1.0, 3.0]
    assert {k for k in line if k.startswith("spa_solve_ms")} <= set(sp)
    assert set(line["launches_per_match"]) == set(bench_torch.MODES) | {
        "lockstep", "mega", "16", "64"}


def _jax_scan(s):
    out = JaxScan(s.ranges, s.min_angle, s.max_angle, s.angle_increment, s.min_range,
                  s.max_range, s.range_threshold, s.odom_pose.x, s.odom_pose.y,
                  s.odom_pose.euler[-1])
    p = s.corrected_pose
    out.corrected_pose = type(out.corrected_pose).from_xyt(p.x, p.y, p.euler[-1])
    return out


def _assert_same(a, b):
    assert b.response == pytest.approx(a.response, abs=TOL)
    pa, pb = a.best_pose, b.best_pose
    np.testing.assert_allclose([pb.x, pb.y, pb.euler[-1]], [pa.x, pa.y, pa.euler[-1]],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(b.covariance, a.covariance, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def streams():
    """(port scans, JAX scans) of bench.py's stream, seed 0."""
    scans = bench_torch.build_stream(n_scans=N_SCANS)
    return scans, [_jax_scan(s) for s in scans]


def test_lockstep_and_batch_match_jax(streams):
    """bench_torch's lockstep loop and a 4-job batch at bench.py's config on
    the CPU equal the JAX matcher's match_scan and match_many."""
    scans, jscans = streams
    m = CorrelativeScanMatcher(bench_torch.CFG, device="cpu", dtype=torch.float64)
    jm = _jax_matcher()
    jobs = bench_torch.lockstep_jobs(scans)
    jjobs = bench_torch.lockstep_jobs(jscans)
    assert len(jobs) == N_SCANS - bench_torch.N_BASE - 2
    for a, b in zip([jm.match_scan(q, bs) for q, bs in jjobs],
                    bench_torch.run_lockstep(m, jobs)):
        assert a.response > 0.5
        _assert_same(a, b)
    jobs = bench_torch.batch_jobs(scans)[:4]
    want = jm.match_many(bench_torch.batch_jobs(jscans)[:4])
    got = bench_torch.run_batched(m, jobs, 4)
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        _assert_same(a, b)


def test_mega_equals_match_many(streams):
    """match_many_mega in chunks of 2 (and a short last chunk) gives
    match_many's results job by job, and check_mega accepts them."""
    scans, _ = streams
    m = CorrelativeScanMatcher(bench_torch.CFG, device="cpu")
    jobs = bench_torch.batch_jobs(scans)[:3]
    bench_torch.check_mega(m.match_many_mega(jobs, chunk=2), m.match_many(jobs))


def test_check_mega_refuses_a_differing_or_non_finite_job(streams):
    scans, _ = streams
    m = CorrelativeScanMatcher(bench_torch.CFG, device="cpu")
    many = m.match_many(bench_torch.batch_jobs(scans)[:2])
    moved = many[:1] + [many[1]._replace(response=many[1].response + 1e-7)]
    with pytest.raises(AssertionError, match="job 1 differs"):
        bench_torch.check_mega(moved, many)
    bad = [many[0]._replace(response=float("nan"))] + many[1:]
    with pytest.raises(AssertionError, match="job 0: non-finite"):
        bench_torch.check_mega(bad, many)


@pytest.mark.parametrize("script", [bench_torch, profile_match_torch, profile_spa_torch,
                                    scaling_bench_torch])
def test_main_raises_without_a_card(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        if script in (profile_match_torch, profile_spa_torch):
            script.main([])
        else:
            script.main()


def test_profile_stages_compose_to_batched_core(streams):
    """profile_match_torch's stages, run in order on the CPU, give
    batched_core's packed output bit for bit for 2 jobs, at the shapes the
    JAX matcher's _ensure_point_cap, _base_bucket and _assemble_jobs give."""
    scans, jscans = streams
    ctx = profile_match_torch.setup(batch=2, device="cpu", dtype=torch.float64, scans=scans)
    packed, out, fns = profile_match_torch.compose(ctx)
    want = ctx["m"].batched_core(ctx["P"], ctx["B"], True, True, ctx["S"])(*ctx["args"])
    assert torch.equal(packed, want) and packed.shape == (2, 2, 8)
    assert set(out) == set(fns) == set(profile_match_torch.STAGES)
    assert torch.equal(out["staged"], out["smear_quantize"])

    jm = _jax_matcher()
    N, B = 2, bench.N_BASE
    jobs = [(jscans[B + i + 1], jscans[i + 1:B + i + 1]) for i in range(N)]
    P = jm._ensure_point_cap([q for q, _ in jobs] + [s for _, bs in jobs for s in bs])
    Bb = jm._base_bucket(B)
    S = jm._assemble_jobs(jobs, P, Bb)[-1]
    assert {k: ctx[k] for k in ("N", "B", "P", "S", "G", "h")} == dict(
        N=N, B=Bb, P=P, S=S, G=jm.grid_size, h=jm._half)
    assert (ctx["P"], ctx["B"], ctx["S"], ctx["G"]) == (512, 16, 1536, 4051)

    work = profile_match_torch.stage_work(ctx, out, fns)
    assert set(work) == set(profile_match_torch.STAGES)
    assert all(b > 0 for b, _ in work.values())
    # the smears count as phase 3 counts them; the float grid only on the staged route
    R = ctx["S"] + 2 * ctx["h"]
    assert work["smear_quantize"][0] == 2 * R * R + 2 * ctx["S"] ** 2 + 4 * 21 + 16
    assert work["staged"][0] == work["smear_quantize"][0] + 4 * 2 * ctx["S"] ** 2
    assert work["staged"][1] > 0 and work["smear_quantize"][1] == 0


def test_profile_spa_dense_f64_meets_host_at_100_nodes():
    """profile_spa_torch's crossover on the CPU at 100 nodes (cg left
    out): dense:f64 meets host's cost within phase 12's bar, and the table
    has profile_spa.py's columns."""
    lines = []
    rows = profile_spa_torch.crossover("cpu", sizes=(100,), cg_sizes=(), log=lines.append,
                                       label="cpu")
    by = {r["solver"]: r for r in rows}
    assert set(by) == {"host", "dense:mixed", "dense:f64"}
    d = by["dense:f64"]
    assert d["held_to_host"] and d["cost_rel_vs_host"] <= profile_spa_torch.COST_RTOL
    assert max(d["dxy_vs_host_m"], d["dth_vs_host_rad"]) <= profile_spa_torch.POSE_TOL
    n = by["host"]["nodes"]
    assert len(lines) == 3 and lines[0].startswith(f"SPA {n} nodes host: ")
    table = profile_spa_torch.table(rows)
    assert [c.strip() for c in table[0].split("|")[1:]][:-1] == [
        "host", "dense:mixed", "dense:f64", "cg:mixed"]
    cells = [c.split()[0] for c in table[1].split("|")]
    assert cells[0] == str(n) and cells[4:] == ["-", "-"]
    assert float(cells[3]) == pytest.approx(d["ms"], abs=0.05)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _scaling_bench_py_keys():
    """The key sets of the dicts scaling_bench.py prints with json.dumps."""
    tree = ast.parse(open(os.path.join(REPO, "scaling_bench.py")).read())
    return {frozenset(k.value for k in node.args[0].keys) for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)}


def test_scaling_bench_at_world_size_2():
    """scaling_bench_torch.run on two gloo ranks (as
    tests/test_torch_parallel.py starts them): the sharded jobs bit-equal
    at world sizes 1 and 2 on both ranks, and scaling_bench.py's JSON
    lines, key for key."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(r), "2", port,
         "scaling"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in range(2)]
    try:
        outs = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank failed:\n{stderr[-4000:]}"
            outs.append(json.loads(stdout.strip().splitlines()[-1])["scaling"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lead, other = outs
    assert set(lead["match"]) == {"1", "2"} and set(other["match"]) == {"2"}
    assert len(lead["match"]["1"]) == scaling_bench_torch.N_JOBS
    assert lead["match"]["1"] == lead["match"]["2"] == other["match"]["2"]
    assert lead["spa"]["2"] == other["spa"]["2"] and other["lines"] == []
    assert {frozenset(line) for line in lead["lines"]} == _scaling_bench_py_keys()
    assert [line.get("devices", line.get("dist_spa_devices")) for line in lead["lines"]] == [
        1, 2, None, 1, 2, None]
    assert all(line["responses_ok"] for line in lead["lines"] if "devices" in line)
