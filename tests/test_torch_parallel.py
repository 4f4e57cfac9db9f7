"""The port's multi-device paths on torch.distributed (gloo, CPU, float64)
against the JAX package's on the conftest's 8-device CPU mesh.

World sizes 2 and 4 run in worker processes (tests/torch_dist_worker.py)
that join through ``initialize_multihost`` on a free port; world size 1
runs in this process on a one-rank group that the `mesh` fixture opens
and destroys.  Tolerances: the loop matcher as tests/test_parallel.py
(response rtol 1e-9, pose atol 1e-9); float64 SPA against the JAX
package's same solver at cost rtol 1e-9 and poses 1e-8 (only the edge
shards' summation order differs); the mixed-precision cg at the JAX
package's own bounds against SPA2d (rtol 1e-6, poses 1e-5).
"""
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as W
from yag_slam_tpu.core.scan import LocalizedRangeScan as JaxScan
from yag_slam_tpu.core.transform import Transform as JaxTransform
from yag_slam_tpu.core.transform import se2_compose as jax_se2_compose
from yag_slam_tpu.core.transform import se2_relative as jax_se2_relative
from yag_slam_tpu.graphopt.spa import SPA2d as JaxSPA2d
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher as JaxMatcher
from yag_slam_tpu.parallel.dist_spa import DistributedSPA as JaxDistributedSPA
from yag_slam_tpu.parallel.loop_search import ShardedLoopMatcher as JaxShardedLoopMatcher
from yag_slam_tpu.parallel.sharding import default_mesh as jax_default_mesh
from yag_slam_tpu_torch.graphopt.spa import SPA2d, _cap
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.parallel import DistributedSPA, ShardedLoopMatcher, default_mesh
from yag_slam_tpu_torch.parallel.dist_spa import make_distributed_lm_run_cg
from yag_slam_tpu_torch.parallel.sharding import initialize_multihost

from test_parallel import _serpentine_grid_graph, make_jobs

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = {2: "match,spa,mp", 4: "match"}
EMPTY_JOB = 5          # loop_jobs()'s job with an empty coarse response
SCANS = 50             # the fully sharded stack's scans (JAX compiles take most of it)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def launched():
    """Every world's ranks, started at once: {world size: [Popen]}."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = {}
    for world, tasks in WORLDS.items():
        port = str(_free_port())
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(r),
             str(world), port, tasks],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
            for r in range(world)]
    try:
        yield procs
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(launched, jax_loop, jax_spa):
    """{world size: [each rank's JSON output]}; the JAX references are
    computed here while the ranks run."""
    out = {}
    for world, ps in launched.items():
        out[world] = []
        for p in ps:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank failed:\n{stderr[-4000:]}"
            out[world].append(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo mesh in this process, destroyed at the end."""
    m = default_mesh(device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _jax_scan(s):
    out = JaxScan(s.ranges, s.min_angle, s.max_angle, s.angle_increment, s.min_range,
                  s.max_range, s.range_threshold, s.odom_pose.x, s.odom_pose.y,
                  s.odom_pose.euler[-1])
    p = s.corrected_pose
    out.corrected_pose = JaxTransform.from_xyt(p.x, p.y, p.euler[-1])
    return out


@pytest.fixture(scope="module")
def jax_loop():
    """The JAX package's loop matcher (the index math of the port's
    kernels: use_patch, no Pallas) on loop_jobs(): its sharded match_many
    over the 8-device mesh and its plain match_many."""
    jobs = [(_jax_scan(q), [_jax_scan(s) for s in bs]) for q, bs in W.loop_jobs()]

    def matcher():
        return JaxMatcher(W.LOOP_CFG, loop=True, dtype=np.float64, use_patch=True,
                          use_pallas=False)

    sharded = JaxShardedLoopMatcher(matcher(), jax_default_mesh())
    return (W.result_rows(sharded.match_many(jobs, penalty=False, do_fine=False)),
            W.result_rows(matcher().match_many(jobs, penalty=False, do_fine=False)))


def _assert_rows(got, want, positive_only=False):
    assert len(got) == len(want)
    for j, (a, b) in enumerate(zip(got, want)):
        if positive_only and j == EMPTY_JOB:
            continue
        assert a[0] == pytest.approx(b[0], rel=1e-9, abs=1e-12), j
        np.testing.assert_allclose(a[1:4], b[1:4], rtol=0, atol=1e-9, err_msg=str(j))
        np.testing.assert_allclose(a[4], b[4], rtol=1e-9, atol=1e-12, err_msg=str(j))


def test_cases_are_the_jax_tests_inputs():
    """loop_jobs()'s first 5 jobs are test_parallel.make_jobs' scans, and
    build_loop_graph stores the same graph through either package's SE(2)
    helpers."""
    for (pq, pb), (jq, jb) in zip(W.loop_jobs(), make_jobs(5)):
        for a, b in zip([pq, *pb], [jq, *jb]):
            np.testing.assert_array_equal(a.ranges, b.ranges)
    a, b = SPA2d(device="cpu"), SPA2d(device="cpu")
    W.build_loop_graph(a)
    W.build_loop_graph(b, (jax_se2_compose, jax_se2_relative))
    assert a._solver.poses == b._solver.poses
    assert a._solver.edge_means == b._solver.edge_means


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_loop_matcher_matches_jax(ranks, jax_loop, world):
    """Jobs pad to 6 (world 2) and 8 (world 4); every rank holds JAX's
    sharded results, the empty-response job included (no expansion on the
    sharded path), and JAX's plain match_many on the other jobs."""
    jax_sharded, jax_plain = jax_loop
    assert jax_sharded[EMPTY_JOB][0] == 0.0
    for out in ranks[world]:
        assert out["world"] == world and out["mesh"] == [world]
        _assert_rows(out["match"], jax_sharded)
        _assert_rows(out["match"], jax_plain, positive_only=True)
    first = ranks[world][0]["match"]
    assert all(o["match"] == first for o in ranks[world][1:])
    assert min(r[0] for j, r in enumerate(first) if j != EMPTY_JOB) > 0.5


def test_sharded_equals_plain_at_world_size_1(mesh):
    """One rank: the sharded path is the plain match_many bit for bit on
    every job with a positive coarse response (the plain path retries the
    empty one with a wider angle)."""
    def matcher():
        return CorrelativeScanMatcher(W.LOOP_CFG, loop=True, device="cpu",
                                      dtype=torch.float64)

    jobs = W.loop_jobs()
    sharded = W.result_rows(ShardedLoopMatcher(matcher(), mesh).match_many(jobs))
    plain = W.result_rows(matcher().match_many(jobs, penalty=False, do_fine=False))
    for j, (a, b) in enumerate(zip(sharded, plain)):
        if j != EMPTY_JOB:
            assert a == b
    assert ShardedLoopMatcher(matcher(), mesh).match_many([]) == []
    sm = ShardedLoopMatcher(matcher(), mesh)
    q, bs = jobs[0]
    assert sm.config is sm.matcher.config
    assert W.result_rows([sm.match_scan(q, bs)]) == W.result_rows([matcher().match_scan(q, bs)])


@pytest.fixture(scope="module")
def jax_spa():
    out = {}
    for solver, mixed in W.SPA_CASES:
        spa = JaxDistributedSPA(jax_default_mesh(), solver=solver, mixed=mixed)
        W.build_loop_graph(spa)
        cost = spa.compute(100, 1.0e-4, True, 1.0e-12, 50)
        out[f"{solver}:{mixed}"] = dict(cost=cost, poses=W.poses_of(spa))
    ref = JaxSPA2d()
    W.build_loop_graph(ref)
    out["spa2d"] = dict(cost=ref.compute(100, 1.0e-4, True, 1.0e-12, 50),
                        poses=W.poses_of(ref))
    return out


@pytest.mark.parametrize("case", [f"{s}:{m}" for s, m in W.SPA_CASES])
def test_distributed_spa_matches_jax(ranks, jax_spa, case):
    """World size 2 (edges sharded 2 ways here, 8 ways in JAX)."""
    ref = jax_spa["spa2d"]
    for out in ranks[2]:
        got = out["spa"][case]
        if case == "cg:True":
            assert got["cost"] == pytest.approx(ref["cost"], rel=1e-6)
            np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=1e-5)
        else:
            want = jax_spa[case]
            assert got["cost"] == pytest.approx(want["cost"], rel=1e-9)
            np.testing.assert_allclose(got["poses"], want["poses"], rtol=0, atol=1e-8)
    assert ranks[2][0]["spa"][case] == ranks[2][1]["spa"][case]


def test_multiprocess_solve_agrees(ranks, mesh):
    """Two processes through initialize_multihost agree with each other and
    with the same solve in one process (tests/test_multiprocess.py)."""
    a, b = (o["mp"] for o in ranks[2])
    assert a["cost"] == pytest.approx(b["cost"], rel=1e-12)
    np.testing.assert_allclose(a["poses"], b["poses"], rtol=1e-12, atol=0)
    one = DistributedSPA(mesh, solver="cg")
    W.build_mp_graph(one)
    cost = one.compute(50, 1.0e-4, True, 1.0e-10, 100, conv_tol=1e-10)
    assert a["cost"] == pytest.approx(cost, rel=1e-6)
    assert np.abs(a["poses"]).sum() == pytest.approx(np.abs(W.poses_of(one)).sum(), rel=1e-6)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_world_size_1_equals_spa2d_cg(mesh, precision):
    """On one rank the all-reduce is a sum over one partial: DistributedSPA
    cg is the port's SPA2d(solver="cg") in the same precision."""
    dspa = DistributedSPA(mesh, solver="cg", mixed=precision == "mixed")
    spa = SPA2d(solver="cg", precision=precision, device="cpu")
    for s in (dspa, spa):
        W.build_loop_graph(s)
    assert dspa.compute(100, 1.0e-4, True, 1.0e-12, 50) == \
        spa.compute(100, 1.0e-4, True, 1.0e-12, 50)
    assert W.poses_of(dspa) == W.poses_of(spa)


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_cg_at_graphslam_arguments_matches_jax(mesh, mixed):
    """GraphSlam's solve arguments (50 CG iterations per LM step) on the
    105-node noisy loop that chip_smoke.py phase 13 solves on the card:
    the port's DistributedSPA cg is JAX's, and both stop short of host's
    optimum (5.1e-4 above its cost in float64, 1.2e-4 mixed)."""
    from yag_slam_tpu.io.benchmark import noisy_loop_pose_graph as jax_graph
    from yag_slam_tpu.io.benchmark import populate_spa as jax_populate
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa

    args = (100, 1.0e-4, True, 1.0e-9, 50)
    graph = jax_graph(100)
    host = jax_populate(JaxSPA2d(solver="host"), *graph)
    host_cost = host.compute(*args)
    jax = jax_populate(JaxDistributedSPA(jax_default_mesh(), solver="cg", mixed=mixed), *graph)
    want = jax.compute(*args)
    port = populate_spa(DistributedSPA(mesh, solver="cg", mixed=mixed),
                        *noisy_loop_pose_graph(100))
    got = port.compute(*args)
    rtol, atol = (1e-6, 1e-5) if mixed else (1e-9, 1e-8)
    assert got == pytest.approx(want, rel=rtol)
    np.testing.assert_allclose(W.poses_of(port), W.poses_of(jax), rtol=0, atol=atol)
    assert min(got, want) > host_cost * (1 + 1e-5)


def test_serpentine_graph_matches_host(mesh):
    """tests/test_parallel.py's serpentine lattice at 16 x 16 = 256 nodes
    and its solve parameters: cg reaches the exact host solve.  Float64 CG
    here (4 s; the mixed steps take 16 s on this CPU); the 4,096-node case
    with the default mixed steps runs on the card (chip_smoke.py phase
    13)."""
    host = SPA2d(solver="host", device="cpu")
    assert _serpentine_grid_graph(host, 16, 16) == 256
    host_cost = host.compute(100, 1.0e-4, True, 1.0e-9, 50, conv_tol=1e-12)
    dspa = DistributedSPA(mesh, solver="cg", mixed=False)
    _serpentine_grid_graph(dspa, 16, 16)
    cost = dspa.compute(60, 1.0e-4, True, 1.0e-8, 600, conv_tol=1e-12)
    assert cost == pytest.approx(host_cost, rel=1e-5)
    assert np.max(np.abs(np.subtract(W.poses_of(host), W.poses_of(dspa)))) < 1e-5


def test_dist_spa_no_dense_hessian(mesh):
    """No (3N, 3N), nor any O(N^2), tensor is created anywhere in the
    sharded cg program: the largest tensor any aten op creates during 2 LM
    iterations of 5 CG steps at n_cap 4096 is edge-shard or pose scale."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa

    spa = populate_spa(SPA2d(device="cpu"), *noisy_loop_pose_graph(4000))
    s = spa._solver
    n, e = len(s.poses), len(s.edge_idx)
    n_cap, e_cap = _cap(n), 8192
    assert n_cap == 4096 and e <= e_cap
    poses = np.zeros((n_cap, 3))
    poses[:n] = s.poses
    eidx = np.zeros((e_cap, 2), dtype=np.int64)
    eidx[:e] = s.edge_idx
    means = np.zeros((e_cap, 3))
    means[:e] = s.edge_means
    infos = np.zeros((e_cap, 3, 3))
    infos[:e] = np.stack(s.edge_infos)
    emask = np.arange(e_cap) < e
    free = (np.arange(n_cap) >= 1) & (np.arange(n_cap) < n)

    class Biggest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Biggest.numel = max(Biggest.numel, t.numel())
            return out

    prog = make_distributed_lm_run_cg(mesh, n_cap, 2, 5)
    with Biggest():
        _, cost, iters = prog(torch.as_tensor(poses), eidx, means, infos, emask, free,
                              1e-4, 1e-12, 1e-9)
    assert iters == 2 and np.isfinite(float(cost))
    assert Biggest.numel < 9 * n_cap * n_cap
    assert Biggest.numel <= 16 * max(9 * e_cap, 3 * n_cap)


def test_fully_sharded_graphslam_matches_jax(mesh):
    """ShardedLoopMatcher and DistributedSPA in one GraphSlam
    (tests/test_parallel.py's fully sharded stack), one rank here and 8 JAX
    devices there, over the first SCANS of its 2-lap square loop (the
    first two closures, at scans 44 and 48; the whole loop on the card in
    chip_smoke.py phase 13): the same vertex, edge and closure counts, ATE
    < 0.15 m, and positions within 1e-3 m of JAX's."""
    from yag_slam_tpu.io import simulator as jsim
    from yag_slam_tpu.slam.graph_slam import GraphSlam as JaxGraphSlam
    from yag_slam_tpu_torch.io import simulator as tsim
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
    from yag_slam_tpu_torch.utils.metrics import ate_rmse, trajectory_from_slam

    seq_cfg = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
               "smear_deviation": 0.05}

    def scans(sim):
        gt = sim.square_loop_trajectory(side=5.0, step=0.5, laps=2, start=(-2.5, -2.5))
        odom = sim.drifted_odometry(gt, yaw_bias=0.0025, seed=1)
        rng = np.random.default_rng(101)
        return gt[:SCANS], [sim.simulate_scan(sim.SimWorld.office(), gt[i], n_beams=250,
                                              range_threshold=5.0, noise=0.004, rng=rng,
                                              odom_pose_xyt=odom[i]) for i in range(SCANS)]

    gt, port_scans = scans(tsim)
    _, jax_scans = scans(jsim)
    kw = dict(loop_search_dist=2.0, loop_search_min_chain_size=5)
    port = GraphSlam(
        CorrelativeScanMatcher(seq_cfg, device="cpu", dtype=torch.float64),
        ShardedLoopMatcher(CorrelativeScanMatcher(W.LOOP_CFG, loop=True, device="cpu",
                                                  dtype=torch.float64), mesh),
        opt=DistributedSPA(mesh), **kw)
    jmesh = jax_default_mesh()
    jax = JaxGraphSlam(
        JaxMatcher(seq_cfg, dtype=np.float64, use_patch=True, use_pallas=False),
        JaxShardedLoopMatcher(JaxMatcher(W.LOOP_CFG, loop=True, dtype=np.float64,
                                         use_patch=True, use_pallas=False), jmesh),
        opt=JaxDistributedSPA(jmesh), **kw)
    for a, b in zip(port_scans, jax_scans):
        np.testing.assert_array_equal(a.ranges, b.ranges)
        port.process_scan(a)
        jax.process_scan(b)
    counts = lambda s: (len(s.graph.vertices), len(s.graph.edges),  # noqa: E731
                        s.stats["loop_closures"])
    assert counts(port) == counts(jax) and port.stats["loop_closures"] >= 2
    est = trajectory_from_slam(port)
    assert ate_rmse(est, gt[:, :2], align=False) < 0.15
    gap = np.max(np.hypot(*(est - np.asarray(trajectory_from_slam(jax))).T))
    assert gap < 1e-3, gap


def test_no_fallback_and_mesh_checks(mesh):
    """A cuda mesh without a card raises; a CPU matcher cannot be sharded
    over a cuda mesh; a mesh spans every rank; one process needs no
    group."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            default_mesh(device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistributedSPA(types.SimpleNamespace(device_type="cuda"))
    cuda_mesh = types.SimpleNamespace(device_type="cuda")
    with pytest.raises(ValueError, match="cannot shard a matcher on cpu"):
        ShardedLoopMatcher(CorrelativeScanMatcher(W.LOOP_CFG, device="cpu"), cuda_mesh)
    with pytest.raises(ValueError, match="spans every rank"):
        default_mesh(2, device="cpu")
    assert default_mesh(1, "loop", device="cpu").mesh_dim_names == ("loop",)
    assert initialize_multihost() is None and initialize_multihost("x:1", 1, 0) is None
    with pytest.raises(ValueError, match="solver"):
        DistributedSPA(mesh, solver="host")
