"""The port's SPA (graphopt/spa.py) against the JAX package's on the CPU.

The same seeded numpy inputs go through each JAX function and its port in
float64 (tests/conftest.py enables x64; on the CPU JAX takes its
scatter-add branch, as the port does everywhere).  Building blocks agree
to 1e-10; the LM loops take the same number of iterations, with poses
within 1e-8 (dense float64) or 1e-6 (mixed precision and PCG) and costs
within 1e-8 relative.  Also: the SPA2d / PoseGraphSolver facades on every
solver, the "auto" routing, a non-positive-definite step, empty and
disconnected graphs, a JAX solver's lists carried over, and the
public-signature repairs that ride along (occupancy min_pass_through,
matcher config=, gaussian_kernel_2d, the SPA benchmark graph).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yag_slam_tpu.graphopt import spa as J
from yag_slam_tpu.io import benchmark as JB
from yag_slam_tpu_torch.graphopt import spa as T
from yag_slam_tpu_torch.io import benchmark as TB

from test_spa import _noisy_loop_graph

torch.set_num_threads(1)

BLOCK_TOL = 1e-10
DENSE_TOL, MIXED_TOL, COST_RTOL = 1e-8, 1e-6, 1e-8
LAM0, CTOL, CG_RTOL, CG_ITERS, MAX_ITERS = 1.0e-4, 1.0e-4, 1.0e-9, 100, 100


def _random_inputs(seed=3, n_cap=16, e=22):
    """Random poses and edges over 13 live nodes (node 0 the gauge, 13-15
    padding), some edges masked, as tests/test_spa.py builds them; a
    chain of live edges through nodes 0-12 keeps every damped system
    positive definite."""
    rng = np.random.default_rng(seed)
    poses = rng.normal(0, 1.0, (n_cap, 3))
    eidx = rng.integers(0, 12, (e, 2))
    eidx[:12] = np.stack([np.arange(12), np.arange(1, 13)], axis=1)
    means = rng.normal(0, 0.5, (e, 3))
    A = rng.normal(0, 1, (e, 3, 3))
    infos = np.einsum("eij,ekj->eik", A, A) + np.eye(3)
    emask = rng.random(e) > 0.2
    emask[:12] = True
    free = np.ones(n_cap, bool)
    free[0] = False
    free[13:] = False
    return dict(poses=poses, eidx=eidx, means=means, infos=infos, emask=emask,
                free=free, v=rng.normal(0, 1, (n_cap, 3)), n_cap=n_cap)


def _padded(guesses, edges, info, n_cap=64, e_cap=64):
    """A graph packed as PoseGraphSolver packs it (padded, node 0 fixed)."""
    n, e = len(guesses), len(edges)
    poses = np.zeros((n_cap, 3))
    poses[:n] = np.asarray(guesses)
    eidx = np.zeros((e_cap, 2), dtype=np.int64)
    means = np.zeros((e_cap, 3))
    infos = np.zeros((e_cap, 3, 3))
    emask = np.zeros(e_cap, bool)
    for k, ((i, j), mean) in enumerate(edges):
        eidx[k], means[k], emask[k] = (i, j), mean, True
        infos[k] = info if np.ndim(info) == 2 else info[k]
    free = np.zeros(n_cap, bool)
    free[1:n] = True
    return dict(poses=poses, eidx=eidx, means=means, infos=infos, emask=emask,
                free=free, n_cap=n_cap, n=n, e=e)


def _jax(d):
    return (jnp.asarray(d["poses"]), jnp.asarray(d["eidx"], dtype=jnp.int32),
            jnp.asarray(d["means"]), jnp.asarray(d["infos"]), jnp.asarray(d["emask"]),
            jnp.asarray(d["free"]))


def _port(d):
    return (torch.as_tensor(d["poses"]), torch.as_tensor(d["eidx"], dtype=torch.int64),
            torch.as_tensor(d["means"]), torch.as_tensor(d["infos"]),
            torch.as_tensor(d["emask"]), torch.as_tensor(d["free"]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _blocks(S, args, n_cap, v, lam):
    """Every building block of S (the JAX module or the port) on args."""
    poses, eidx, means, infos, emask, free = args
    dt = poses.dtype
    r, Ji, Jj, W = S._edge_blocks(poses, eidx, means, infos, emask)
    H, b = S.build_normal_equations(poses, eidx, means, infos, emask, free, n_cap=n_cap)
    D = S._hessian_diag_blocks(Ji, Jj, W, eidx, free, n_cap, dt)
    b_neg, avp, diag, D2 = S._damped_system_f64(poses, eidx, means, infos, emask, free, lam)
    return {
        "edge_residuals": S.edge_residuals(poses, eidx, means),
        "edge_jacobians": S.edge_jacobians(poses, eidx),
        "graph_cost": S.graph_cost(poses, eidx, means, infos, emask, n_cap=n_cap),
        "build_normal_equations": (H, b),
        "hessian_diag_blocks": D,
        "make_hvp": S._make_hvp(Ji, Jj, W, eidx, free, n_cap, dt)(v),
        "inv3x3": S._inv3x3(D + 0.5 * (jnp.eye(3) if S is J else torch.eye(3, dtype=dt))),
        "damped_solve": S._damped_solve(H, b, poses, free, lam),
        "damped_system_f64": (b_neg, avp(v), diag, D2),
        "lm_candidate": S.lm_candidate(poses, eidx, means, infos, emask, free, lam,
                                       n_cap=n_cap),
    }


BLOCKS = ("edge_residuals", "edge_jacobians", "graph_cost", "build_normal_equations",
          "hessian_diag_blocks", "make_hvp", "inv3x3", "damped_solve",
          "damped_system_f64", "lm_candidate")


@pytest.fixture(scope="module")
def blocks():
    d = _random_inputs()
    return (_blocks(J, _jax(d), d["n_cap"], jnp.asarray(d["v"]), jnp.asarray(0.3)),
            _blocks(T, _port(d), d["n_cap"], torch.as_tensor(d["v"]),
                    torch.tensor(0.3, dtype=torch.float64)))


@pytest.mark.parametrize("name", BLOCKS)
def test_building_block_matches_jax(blocks, name):
    a, b = blocks[0][name], blocks[1][name]
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(y), _np(x), rtol=0, atol=BLOCK_TOL)
        assert np.isfinite(_np(y)).all()


def test_matmul_assembly_equals_scatter_assembly():
    """The one-hot matmul form (the JAX package's TPU assembly) equals the
    scatter form in the port, gauge and padding rows included."""
    d = _random_inputs(seed=7)
    poses, eidx, means, infos, emask, free = _port(d)
    n_cap = d["n_cap"]
    H1, b1 = T.build_normal_equations(poses, eidx, means, infos, emask, free, n_cap=n_cap)
    for oh in (None, T._edge_onehots(eidx, n_cap, poses.dtype)):
        H2, b2 = T.build_normal_equations_matmul(poses, eidx, means, infos, emask, free,
                                                 n_cap=n_cap, onehots=oh)
        np.testing.assert_allclose(H2.numpy(), H1.numpy(), rtol=0, atol=BLOCK_TOL)
        np.testing.assert_allclose(b2.numpy(), b1.numpy(), rtol=0, atol=BLOCK_TOL)
    fixed = np.flatnonzero(~d["free"])
    rows = (3 * fixed[:, None] + np.arange(3)).ravel()
    np.testing.assert_array_equal(H1.numpy()[rows][:, rows], np.eye(len(rows)))
    assert (H1.numpy()[rows].sum() == len(rows)) and (b1.numpy()[rows] == 0).all()


def _run(S, name, args, n_cap):
    """One LM loop of module S: (poses, cost, iterations) as numpy."""
    dt = args[0].dtype
    scalar = (lambda v: jnp.asarray(v)) if S is J else (
        lambda v: torch.tensor(v, dtype=dt))
    lam0, ctol = scalar(LAM0), scalar(CTOL)
    if name == "lm_run":
        out = S.lm_run(*args, lam0, ctol, n_cap=n_cap, max_iters=MAX_ITERS)
    elif name == "lm_run_mixed":
        out = S.lm_run_mixed(*args, lam0, ctol, n_cap=n_cap, max_iters=MAX_ITERS)
    else:
        out = S.lm_run_cg(*args, lam0, ctol, scalar(CG_RTOL), n_cap=n_cap,
                          max_iters=MAX_ITERS, cg_iters=CG_ITERS,
                          mixed=name == "lm_run_cg_mixed")
    p, cost, it = out
    return _np(p), float(cost), int(it)


SOLVERS = {"lm_run": DENSE_TOL, "lm_run_mixed": MIXED_TOL, "lm_run_cg": MIXED_TOL,
           "lm_run_cg_mixed": MIXED_TOL}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_lm_loop_matches_jax(name):
    d = _padded(*_noisy_loop_graph())
    pa, ca, ia = _run(J, name, _jax(d), d["n_cap"])
    pb, cb, ib = _run(T, name, _port(d), d["n_cap"])
    assert ib == ia and ia > 1
    np.testing.assert_allclose(pb, pa, rtol=0, atol=SOLVERS[name])
    assert cb == pytest.approx(ca, rel=COST_RTOL)
    n, e = d["n"], d["e"]
    assert cb < 0.5 * T._np_cost(d["poses"][:n], d["eidx"][:e], d["means"][:e],
                                 d["infos"][:e])


def test_cg_short_of_the_optimum_as_in_jax():
    """On the 305-node benchmark loop, 200 CG iterations per LM step do not
    solve the chain's damped system: the JAX package's cg stops 2.1e-3 above
    host's cost, its positions up to 0.13 m from host's; the port's cg stops
    at the same place (4e-13 apart)."""
    graph = TB.noisy_loop_pose_graph(300)
    ca, pa = _solve(J.SPA2d(solver="cg", precision="f64"), graph, max_cg=200)
    cb, pb = _solve(T.SPA2d(solver="cg", precision="f64", device="cpu"), graph, max_cg=200)
    ch, ph = _solve(T.SPA2d(solver="host", device="cpu"), graph)
    assert cb == pytest.approx(ca, rel=COST_RTOL)
    np.testing.assert_allclose(pb, pa, rtol=0, atol=MIXED_TOL)
    assert cb > (1 + 1e-3) * ch and np.abs(pb[:, :2] - ph[:, :2]).max() > 0.1


@pytest.mark.parametrize("chunk", [1, 7])
def test_cg_chunks_freeze_the_stopped_carry(monkeypatch, chunk):
    """The chunked CG loop gives the same poses, bit for bit, whatever the
    chunk: iterations after the stop change nothing.  Fewer reads with a
    longer chunk."""
    d = _padded(*_noisy_loop_graph(n_side=4, seed=9), n_cap=32, e_cap=32)
    outs, reads = [], []
    for c in (chunk, T.CG_CHUNK):
        monkeypatch.setattr(T, "CG_CHUNK", c)
        T.reset_host_reads()
        outs.append(_run(T, "lm_run_cg_mixed", _port(d), d["n_cap"]))
        reads.append(dict(T.HOST_READS))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
    assert reads[0]["lm"] == reads[1]["lm"] == outs[0][2]
    assert reads[0]["cg"] > reads[1]["cg"] > 0


def _solve(spa, graph, niter=100, max_cg=100):
    TB.populate_spa(spa, *graph)
    cost = spa.compute(niter, 1.0e-4, True, 1.0e-12, max_cg)
    return cost, np.array([[n.x, n.y, n.yaw] for n in spa.nodes])


FACADES = [("host", "mixed", DENSE_TOL), ("dense", "f64", DENSE_TOL),
           ("dense", "mixed", MIXED_TOL), ("cg", "f64", MIXED_TOL),
           ("cg", "mixed", MIXED_TOL)]


@pytest.mark.parametrize("solver,precision,tol", FACADES)
def test_spa2d_matches_jax(solver, precision, tol):
    graph = _noisy_loop_graph()
    ca, pa = _solve(J.SPA2d(solver=solver, precision=precision), graph)
    cb, pb = _solve(T.SPA2d(solver=solver, precision=precision, device="cpu"), graph)
    assert cb == pytest.approx(ca, rel=COST_RTOL)
    np.testing.assert_allclose(pb, pa, rtol=0, atol=tol)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_mixed_matches_f64_and_host(solver):
    """The port's mixed-precision steps reach the all-float64 optimum and
    the host sparse solver's, as tests/test_spa.py holds the JAX package."""
    graph = _noisy_loop_graph()
    c_m, p_m = _solve(T.SPA2d(solver=solver, precision="mixed", device="cpu"), graph)
    c_f, p_f = _solve(T.SPA2d(solver=solver, precision="f64", device="cpu"), graph)
    c_h, p_h = _solve(T.SPA2d(solver="host", device="cpu"), graph)
    assert np.isclose(c_m, c_h, rtol=1e-3) and np.isclose(c_m, c_f, rtol=1e-3)
    assert np.abs(p_m - p_h).max() < 2e-3 and np.abs(p_f - p_h).max() < 2e-3


@pytest.mark.parametrize("limits,reads", [
    ((53, None), {"lm": 0, "cg": 0}),          # at the host limit: host
    ((52, None), {"lm": 1, "cg": 0}),          # above it: dense on the device
    ((52, 52), {"lm": 1, "cg": 1}),            # above the dense limit: cg
])
def test_auto_routes_by_node_count(limits, reads):
    """Solver "auto" runs on the host up to auto_host_limit nodes and on
    the device above it (dense up to dense_node_limit, then PCG): only the
    device loops read stop flags back.  Each route reaches host's result."""
    host_limit, dense_limit = limits
    graph = _noisy_loop_graph()
    assert len(graph[0]) == 53
    T.reset_host_reads()
    spa = T.SPA2d(device="cpu")
    spa._solver.auto_host_limit = host_limit
    spa._solver.dense_node_limit = dense_limit or spa._solver.DENSE_NODE_LIMIT
    cost, poses = _solve(spa, graph)
    assert {k: min(v, 1) for k, v in T.HOST_READS.items()} == reads
    c_h, p_h = _solve(T.SPA2d(solver="host", device="cpu"), graph)
    assert np.isclose(cost, c_h, rtol=1e-3) and np.abs(poses - p_h).max() < 2e-3


def test_auto_limit_defaults():
    s = T.PoseGraphSolver(device="cpu")
    assert (s.solver, s.precision, s.DENSE_NODE_LIMIT, s.AUTO_HOST_NODE_LIMIT) == \
        ("auto", "mixed", 1024, 65536)
    assert (s.dense_node_limit, s.auto_host_limit) == (1024, 65536)
    assert T.PoseGraphSolver(dense_node_limit=8, auto_host_limit=9).auto_host_limit == 9
    # the host path needs no card, whatever the device
    for spa in (T.SPA2d(), T.SPA2d(solver="host")):
        assert np.isfinite(TB.populate_spa(spa, *TB.noisy_loop_pose_graph(8)).compute())


@pytest.mark.parametrize("name", ["lm_run", "lm_run_mixed"])
def test_non_pd_step_matches_jax(name, monkeypatch):
    """A negative-definite edge makes many damped systems indefinite: the
    JAX factor is NaN, the port's cholesky_ex reports it and the candidate
    becomes NaN, so both reject those steps and raise lambda, with the
    same poses, cost and iteration count."""
    guesses, edges, info = _noisy_loop_graph(n_side=3, seed=2)
    infos = np.stack([np.asarray(info, float)] * len(edges))
    infos[4] = -50.0 * np.eye(3)
    d = _padded(guesses, edges, infos, n_cap=32, e_cap=32)
    factored = []

    def spy(A, cholesky=T._cholesky):
        L, pd = cholesky(A)
        factored.append(bool(pd))
        return L, pd

    monkeypatch.setattr(T, "_cholesky", spy)
    pa, ca, ia = _run(J, name, _jax(d), d["n_cap"])
    pb, cb, ib = _run(T, name, _port(d), d["n_cap"])
    assert ib == ia and np.isfinite(cb)
    assert factored.count(False) >= 10 and factored.count(True) >= 10
    np.testing.assert_allclose(pb, pa, rtol=0, atol=DENSE_TOL)
    assert cb == pytest.approx(ca, rel=COST_RTOL)


ALL_SOLVERS = [("host", "mixed"), ("dense", "f64"), ("dense", "mixed"), ("cg", "f64"),
               ("cg", "mixed")]


def _tiny_graph(spa):
    spa.add_node(0.0, 0.0, 0.0, 0)
    spa.add_node(1.0, 0.1, 0.0, 1)
    spa.add_node(5.0, 5.0, 1.0, 2)   # disconnected
    spa.add_constraint(0, 1, 1.05, 0.0, 0.0, np.diag([100.0, 100.0, 100.0]).tolist())
    cost = spa.compute(50, 1.0e-4, True, 1.0e-9, 50)
    return cost, np.array([[n.x, n.y, n.yaw] for n in spa.nodes])


@pytest.mark.parametrize("solver,precision", ALL_SOLVERS)
def test_empty_tiny_and_disconnected_graphs(solver, precision):
    """Empty and one-node graphs cost 0.0; a free node with no edge keeps
    its pose, on every solver, with the JAX package's result.  (Its zero
    row leaves the dense system singular, so the dense LM rejects every
    step there, in both packages; host pins the node and PCG's block
    inverse stays finite, so both solve the rest.)"""
    spa = T.SPA2d(solver=solver, precision=precision, device="cpu")
    assert spa.compute() == 0.0
    spa.add_node(0.0, 0.0, 0.0, 0)
    assert spa.compute() == 0.0
    cost, poses = _tiny_graph(T.SPA2d(solver=solver, precision=precision, device="cpu"))
    cost_j, poses_j = _tiny_graph(J.SPA2d(solver=solver, precision=precision))
    assert cost == pytest.approx(cost_j, rel=COST_RTOL, abs=1e-12)
    np.testing.assert_allclose(poses, poses_j, rtol=0, atol=MIXED_TOL)
    np.testing.assert_array_equal(poses[[0, 2]], [[0.0, 0.0, 0.0], [5.0, 5.0, 1.0]])
    if solver != "dense":
        assert cost < 1e-6 and abs(poses[1, 0] - 1.05) < 1e-6 and abs(poses[1, 1]) < 1e-6


@pytest.mark.parametrize("solver", ["host", "dense"])
def test_jax_solver_lists_carry_over(solver):
    """A JAX PoseGraphSolver's lists, loaded into the port's through
    add_node / add_constraint after a first solve, give JAX's second solve."""
    guesses, edges, info = _noisy_loop_graph(n_side=6, seed=4)
    a = J.PoseGraphSolver(solver=solver, precision="f64")
    JB.populate_spa(a, guesses, edges[:-1], info)
    a.optimize()
    for k, g in enumerate(guesses[:3]):    # a late closure and new guesses
        a.set_pose(k + 1, *(np.asarray(a.poses[k + 1]) + 0.01 * g))
    a.add_constraint(*edges[-1][0], *edges[-1][1], info)
    b = T.PoseGraphSolver(solver=solver, precision="f64", device="cpu")
    for k, p in enumerate(a.poses):
        b.add_node(*p, k)
    for (i, j), m, inf in zip(a.edge_idx, a.edge_means, a.edge_infos):
        b.add_constraint(i, j, *m, inf)
    ca, cb = a.optimize(), b.optimize()
    assert cb == pytest.approx(ca, rel=COST_RTOL)
    np.testing.assert_allclose(np.asarray(b.poses), np.asarray(a.poses), rtol=0,
                               atol=DENSE_TOL)


def test_set_pose_and_duplicate_ids():
    s = T.PoseGraphSolver(device="cpu")
    s.add_node(0, 0, 0, "a")
    s.add_node(1, 2, 3, "b")
    s.set_pose("b", 4, 5, 6)
    assert s.poses == [[0.0, 0.0, 0.0], [4.0, 5.0, 6.0]]
    with pytest.raises(ValueError, match="duplicate"):
        s.add_node(0, 0, 0, "a")


def test_benchmark_graph_matches_jax():
    for n in (8, 101):
        ga, ea, ia = JB.noisy_loop_pose_graph(n, seed=3)
        gb, eb, ib = TB.noisy_loop_pose_graph(n, seed=3)
        assert ib == ia and len(gb) == len(ga) and len(eb) == len(ea)
        np.testing.assert_allclose(np.asarray(gb), np.asarray(ga), rtol=0, atol=1e-12)
        assert [e[0] for e in eb] == [e[0] for e in ea]
        np.testing.assert_allclose(np.asarray([e[1] for e in eb]),
                                   np.asarray([e[1] for e in ea]), rtol=0, atol=1e-12)
    spa = TB.populate_spa(T.SPA2d(device="cpu"), gb, eb, ib)
    assert len(spa.nodes) == len(gb) and len(spa._solver.edge_infos) == len(eb)


# -- the public-signature repairs (C6) -------------------------------------------

def _scans(n=15):
    from test_slam_e2e import build_sequence

    return build_sequence(laps=1)[2][:n]


@pytest.mark.parametrize("k", [0, 2, 5])
def test_occupancy_min_pass_through_matches_jax(k):
    from yag_slam_tpu.mapping.occupancy import create_occupancy_grid as jax_grid
    from yag_slam_tpu_torch.mapping.occupancy import create_occupancy_grid

    scans = _scans()
    a = jax_grid(scans, 0.05, 5.0, min_pass_through=k)
    b = create_occupancy_grid(scans, 0.05, 5.0, min_pass_through=k, device="cpu")
    assert (b.width, b.height) == (a.width, a.height)
    np.testing.assert_array_equal(b.image, a.image)
    assert {0, 255} <= set(np.unique(b.image).tolist())
    if k == 2:    # the default
        np.testing.assert_array_equal(
            create_occupancy_grid(scans, 0.05, 5.0, device="cpu").image, b.image)


def test_matcher_takes_a_config_object():
    """config= wins over the dict, as in the JAX package; the scan library
    takes the JAX package's initial_cap."""
    from test_slam_e2e import SEQ_CFG
    from yag_slam_tpu_torch.core.config import make_config
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher as M
    from yag_slam_tpu_torch.matching.matcher import DeviceScanLibrary

    cfg = make_config(SEQ_CFG)
    m = M({"resolution": 0.05}, config=cfg, device="cpu", dtype=torch.float64)
    assert m.config is cfg and m.grid_size == M(SEQ_CFG, device="cpu").grid_size
    m.library = DeviceScanLibrary(m.dtype, 8, device="cpu")
    scans = _scans(3)
    r = m.match_scan(scans[2], scans[:2])
    ref = M(SEQ_CFG, device="cpu", dtype=torch.float64).match_scan(scans[2], scans[:2])
    assert m.library.K_cap == 8 and r.response == ref.response


def test_gaussian_kernel_2d_matches_jax():
    from yag_slam_tpu.matching import correlation as JC
    from yag_slam_tpu_torch.matching import correlation as TC

    for res, smear in ((0.02, 0.05), (0.01, 0.07), (0.05, 0.05)):
        np.testing.assert_array_equal(TC.gaussian_kernel_2d(res, smear),
                                      JC.gaussian_kernel_2d(res, smear))


def test_link_to_near_chains_is_not_implemented():
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    with pytest.raises(NotImplementedError):
        GraphSlam.default(device="cpu").link_to_near_chains()


def test_graph_slam_solver_follows_its_matchers_device():
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    slam = GraphSlam.default(device="cpu")
    assert isinstance(slam.opt, T.SPA2d) and slam.opt._solver.device == slam.device
    assert slam.opt._solver.solver == "auto"
