"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

    python torch_dist_worker.py RANK WORLD PORT TASK[,TASK...]

Joins a WORLD-rank gloo process group through the port's
``initialize_multihost`` at 127.0.0.1:PORT, builds ``default_mesh`` on the
CPU and runs the tasks in float64, on one CPU thread:
  match: ShardedLoopMatcher.match_many over ``loop_jobs()`` (5 jobs and
         one whose coarse response is empty), penalty and fine pass off;
  spa:   DistributedSPA on ``build_loop_graph`` with cg (mixed and
         float64) and dense;
  mp:    DistributedSPA cg on ``build_mp_graph`` (tests/mp_worker.py's);
  scaling: scaling_bench_torch.run on the CPU (its 32 jobs, one timed
         repeat), its JSON lines and each world size's results.
Prints one JSON line.  The case helpers below are shared with the test
module; they use the port's types only, on the seeds of
tests/test_parallel.py and tests/test_multiprocess.py.
"""
import json
import sys

import numpy as np

LOOP_CFG = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
            "smear_deviation": 0.05}
SPA_CASES = (("cg", True), ("cg", False), ("dense", False))


def loop_jobs(n_jobs=5):
    """tests/test_parallel.py's make_jobs on the port's simulator, plus one
    job whose query sits 30 m from its chain (an empty grid: coarse
    response 0)."""
    from yag_slam_tpu_torch.core.transform import Transform
    from yag_slam_tpu_torch.io.simulator import SimWorld, simulate_scan

    world = SimWorld.office()
    rng = np.random.default_rng(0)
    jobs = []
    for j in range(n_jobs):
        base_pose = np.array([0.3 * j - 1.0, 0.2 * j - 1.0, 0.1 * j])
        chain = [
            simulate_scan(world, base_pose + [0.3 * i, 0.05, 0.0], n_beams=180,
                          range_threshold=5.0, noise=0.004, rng=rng)
            for i in range(3)
        ]
        query = simulate_scan(world, base_pose + [0.1, 0.05, 0.02],
                              n_beams=180, range_threshold=5.0, noise=0.004,
                              rng=rng)
        jobs.append((query, chain))
    far = jobs[0][0].copy()
    p = far.corrected_pose
    far.corrected_pose = Transform.from_xyt(p.x + 30.0, p.y, p.euler[-1])
    jobs.append((far, jobs[0][1]))
    return jobs


def _loop_truth(se2_compose):
    """The true poses of both graphs below: a 4 m square, 1 m steps."""
    true = [np.array([0.0, 0.0, 0.0])]
    for _ in range(4):
        for _ in range(4):
            true.append(se2_compose(true[-1], np.array([1.0, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    return true


def build_loop_graph(spa, se2=None):
    """tests/test_parallel.py's build_loop_graph (a noisy 21-node square
    loop with one closure), on the port's SE(2) helpers unless `se2` =
    (se2_compose, se2_relative) is given."""
    if se2 is None:
        from yag_slam_tpu_torch.core.transform import se2_compose, se2_relative
    else:
        se2_compose, se2_relative = se2
    rng = np.random.default_rng(3)
    true = _loop_truth(se2_compose)
    n = len(true)
    info = np.diag([50.0, 50.0, 100.0])
    guesses = [true[0]]
    edges = []
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.02, 3)
        edges.append(((i, i + 1), mean, info))
        guesses.append(se2_compose(guesses[-1], mean))
    edges.append(((n - 1, 0), se2_relative(true[0], true[-1]),
                  np.diag([500.0, 500.0, 1000.0])))
    for i, g in enumerate(guesses):
        spa.add_node(g[0], g[1], g[2], i)
    for (i, j), mean, info_e in edges:
        spa.add_constraint(i, j, *mean, info_e.tolist())
    return n


def build_mp_graph(spa):
    """tests/mp_worker.py's graph: the same loop, nodes and odometry edges
    interleaved."""
    from yag_slam_tpu_torch.core.transform import se2_compose, se2_relative

    rng = np.random.default_rng(3)
    true = _loop_truth(se2_compose)
    n = len(true)
    info = np.diag([50.0, 50.0, 100.0])
    guess = true[0]
    spa.add_node(guess[0], guess[1], guess[2], 0)
    means = []
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.02, 3)
        means.append(mean)
        guess = se2_compose(guess, mean)
        spa.add_node(guess[0], guess[1], guess[2], i + 1)
    for i, mean in enumerate(means):
        spa.add_constraint(i, i + 1, *mean, info.tolist())
    spa.add_constraint(n - 1, 0, *se2_relative(true[0], true[-1]),
                       np.diag([500.0, 500.0, 1000.0]).tolist())
    return n


def result_rows(results):
    """(response, x, y, theta, covariance) per ScanMatcherResult."""
    return [[r.response, r.best_pose.x, r.best_pose.y, r.best_pose.euler[-1],
             np.asarray(r.covariance).tolist()] for r in results]


def poses_of(spa):
    return [[v.x, v.y, v.yaw] for v in spa.nodes]


def run(rank, world, port, tasks):
    import torch
    import torch.distributed as dist

    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.parallel import DistributedSPA, ShardedLoopMatcher
    from yag_slam_tpu_torch.parallel.sharding import default_mesh, initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = default_mesh(device="cpu")
        out = {"rank": rank, "world": dist.get_world_size(), "mesh": list(mesh.shape)}
        if "match" in tasks:
            m = CorrelativeScanMatcher(LOOP_CFG, loop=True, device="cpu",
                                       dtype=torch.float64)
            sharded = ShardedLoopMatcher(m, mesh)
            out["match"] = result_rows(sharded.match_many(loop_jobs(), penalty=False,
                                                          do_fine=False))
        if "spa" in tasks:
            out["spa"] = {}
            for solver, mixed in SPA_CASES:
                spa = DistributedSPA(mesh, solver=solver, mixed=mixed)
                build_loop_graph(spa)
                cost = spa.compute(100, 1.0e-4, True, 1.0e-12, 50)
                out["spa"][f"{solver}:{mixed}"] = dict(cost=cost, poses=poses_of(spa))
        if "mp" in tasks:
            spa = DistributedSPA(mesh, solver="cg")
            build_mp_graph(spa)
            cost = spa.compute(50, 1.0e-4, True, 1.0e-10, 100, conv_tol=1e-10)
            out["mp"] = dict(cost=cost, poses=poses_of(spa))
        if "scaling" in tasks:
            import scaling_bench_torch

            lines = []
            res = scaling_bench_torch.run("cpu", repeats=1, emit=lines.append)
            out["scaling"] = dict(lines=lines,
                                  match={n: result_rows(r) for n, r in res["match"].items()},
                                  spa=res["spa"])
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4].split(","))
