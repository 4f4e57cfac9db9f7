"""The native host SPA solve (native/spa_lm.cpp, ``native.spa_lm``) against
the port's plain numpy + SuperLU version (``graphopt.spa._host_lm``) and
the JAX package's host solver, on the same numpy inputs in float64.

Each graph ends with the same stop reason and iteration count in all
three, poses within 1e-8 and costs within 1e-10 relative.  Also: the host
and "auto" solvers run the native solve and never ``_host_lm``, the
minimum-degree order keeps a loop's fill linear, a bad node index and a
failed build raise.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

from yag_slam_tpu.graphopt import spa as J
from yag_slam_tpu_torch import _build, native
from yag_slam_tpu_torch.graphopt import spa as T
from yag_slam_tpu_torch.io import benchmark as TB

from test_spa import _noisy_loop_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:      # chip_smoke imports the root-level *_torch.py harnesses
    sys.path.insert(0, REPO)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

DENSE_TOL, COST_RTOL = 1e-8, 1e-10
LAM0, CTOL, MAX_ITERS = 1.0e-4, 1.0e-4, 100


class _Recorder:
    """An SPA2d-contract sink that keeps what a graph builder hands it."""

    def __init__(self):
        self.poses, self.eidx, self.means, self.infos = [], [], [], []

    def add_node(self, x, y, yaw, node_id):
        assert node_id == len(self.poses)
        self.poses.append([x, y, yaw])

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        self.eidx.append([from_id, to_id])
        self.means.append([dx, dy, dyaw])
        self.infos.append(np.asarray(info, dtype=np.float64))

    def arrays(self):
        return (np.asarray(self.poses, dtype=np.float64),
                np.asarray(self.eidx, dtype=np.int64).reshape(-1, 2),
                np.asarray(self.means, dtype=np.float64).reshape(-1, 3),
                np.asarray(self.infos, dtype=np.float64).reshape(-1, 3, 3))


def _arrays(guesses, edges, info):
    return TB.populate_spa(_Recorder(), guesses, edges, info).arrays()


def _loop():
    return _arrays(*_noisy_loop_graph()), MAX_ITERS


def _serpentine():
    rec = _Recorder()
    smoke.serpentine_graph(rec, 12, 16)
    return rec.arrays(), MAX_ITERS


def _dangling():
    """The loop with two free nodes that no edge reaches, one amid the
    others and one last: each keeps its pose."""
    p, e, m, w = _arrays(*_noisy_loop_graph(n_side=6, seed=4))
    p = np.insert(p, 10, [3.0, -2.0, 0.7], axis=0)
    p = np.vstack([p, [5.0, 5.0, 1.0]])
    e = np.where(e >= 10, e + 1, e)
    return (p, e, m, w), MAX_ITERS


def _blowup():
    """Negative-definite information everywhere: every step raises the
    cost (SuperLU) or meets a non-positive pivot (Cholesky), so lambda
    climbs past 1e8 with the poses unchanged."""
    p, e, m, w = _arrays(*_noisy_loop_graph(n_side=3, seed=2))
    return (p, e, m, -w), MAX_ITERS


def _capped():
    """The serpentine stopped after 3 LM iterations, short of converging."""
    (p, e, m, w), _ = _serpentine()
    return (p, e, m, w), 3


def _gauge_and_self_edges():
    """Edges to and from the gauge, a repeated edge and a self-edge (its four
    blocks all on one diagonal block), with full information matrices; the
    gauge's heading past pi (an accepted step wraps every heading, the
    gauge's too)."""
    rng = np.random.default_rng(7)
    p, e, m, w = _arrays(*_noisy_loop_graph(n_side=4, seed=1))
    p[0, 2] = 7.0
    extra = np.array([[0, 5], [9, 0], [3, 4], [6, 6]])
    a = rng.normal(0, 1, (len(extra), 3, 3))
    infos = np.einsum("eij,ekj->eik", a, a) + 5 * np.eye(3)
    return (p, np.vstack([e, extra]), np.vstack([m, rng.normal(0, 0.3, (len(extra), 3))]),
            np.concatenate([w, infos])), MAX_ITERS


GRAPHS = {"noisy_loop": _loop, "serpentine": _serpentine, "dangling": _dangling,
          "lambda_blowup": _blowup, "max_iters": _capped,
          "gauge_and_self_edges": _gauge_and_self_edges}
REASONS = {"noisy_loop": "converged", "serpentine": "converged", "dangling": "converged",
           "lambda_blowup": "lambda_blowup", "max_iters": "max_iters",
           "gauge_and_self_edges": "converged"}
PLAIN = {"port": T._host_lm, "jax": J._host_lm}


@pytest.mark.parametrize("plain", sorted(PLAIN))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_native_lm_matches_the_plain_host_lm(name, plain):
    (poses, eidx, means, infos), max_iters = GRAPHS[name]()
    args = (poses, eidx, means, infos, max_iters, LAM0, CTOL)
    pa, ca, ia, ra = PLAIN[plain](*(a.copy() if isinstance(a, np.ndarray) else a
                                    for a in args))
    pb, cb, ib, rb = native.spa_lm(*args)
    assert (rb, ib) == (ra, ia) and ra == REASONS[name]
    np.testing.assert_allclose(pb, np.asarray(pa), rtol=0, atol=DENSE_TOL)
    assert cb == pytest.approx(float(ca), rel=COST_RTOL)
    if name == "dangling":
        np.testing.assert_array_equal(pb[[10, -1]], poses[[10, -1]])
    if name == "lambda_blowup":
        np.testing.assert_array_equal(pb, poses)
    if name == "gauge_and_self_edges":
        assert pb[0, 2] == pytest.approx(7.0 - 2 * np.pi, abs=1e-15)


def test_empty_and_edgeless_graphs():
    one = np.zeros((1, 3))
    none_e, none_m, none_w = np.zeros((0, 2), np.int64), np.zeros((0, 3)), np.zeros((0, 3, 3))
    for f in (T._host_lm, native.spa_lm):
        p, c, i, r = f(one, none_e, none_m, none_w, MAX_ITERS, LAM0, CTOL)
        assert (c, i, r) == (0.0, 0, "empty")
        np.testing.assert_array_equal(p, one)
    two = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 4.0]])
    a = T._host_lm(two, none_e, none_m, none_w, MAX_ITERS, LAM0, CTOL)
    b = native.spa_lm(two, none_e, none_m, none_w, MAX_ITERS, LAM0, CTOL)
    assert b[1:] == a[1:] == (0.0, 1, "converged")
    np.testing.assert_array_equal(b[0], a[0])   # the heading wrapped, as numpy wraps it


def test_minimum_degree_order_keeps_a_loop_sparse():
    """A single loop eliminated in a minimum-degree order fills one block a
    column (a chain end meets the loop's far end), not a dense corner."""
    (poses, eidx, means, infos), _ = _loop()
    native.spa_lm(poses, eidx, means, infos, MAX_ITERS, LAM0, CTOL)
    assert native.SPA_FILL["blocks"] <= len(poses)


@pytest.mark.parametrize("solver", ["host", "auto"])
def test_spa2d_host_path_runs_the_native_solve(solver, monkeypatch):
    """SPA2d(solver="host"), and "auto" below its host limit, solve with
    native.spa_lm, one call a compute, and never reach _host_lm; the
    result equals the JAX package's host solve."""
    def forbidden(*args, **kwargs):
        raise AssertionError("_host_lm on the solver's path")

    guesses, edges, info = _noisy_loop_graph()
    ref = TB.populate_spa(J.SPA2d(solver="host"), guesses, edges, info)
    costs_ref = [ref.compute(100, 1.0e-4, True, 1.0e-9, 50) for _ in range(2)]
    monkeypatch.setattr(T, "_host_lm", forbidden)
    native.reset_calls()
    spa = TB.populate_spa(T.SPA2d(solver=solver, device="cpu"), guesses, edges, info)
    assert spa._solver._use_host(len(guesses))
    costs = [spa.compute(100, 1.0e-4, True, 1.0e-9, 50) for _ in range(2)]
    assert native.CALLS["spa_lm"] == 2
    assert costs == pytest.approx(costs_ref, rel=COST_RTOL)
    np.testing.assert_allclose([[n.x, n.y, n.yaw] for n in spa.nodes],
                               [[n.x, n.y, n.yaw] for n in ref.nodes], rtol=0, atol=DENSE_TOL)


def test_bad_node_index_raises():
    (poses, eidx, means, infos), _ = _loop()
    eidx = eidx.copy()
    eidx[3, 1] = len(poses)
    with pytest.raises(RuntimeError, match="node index out of range"):
        native.spa_lm(poses, eidx, means, infos, MAX_ITERS, LAM0, CTOL)


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    """A native solve that does not build raises from compute(); the plain
    version is not called in its place."""
    src = tmp_path / "spa_lm.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "SPA_LM_SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_hostops", None)
    monkeypatch.setattr(T, "_host_lm", lambda *a, **k: pytest.fail("fell back to _host_lm"))
    spa = TB.populate_spa(T.SPA2d(solver="host", device="cpu"), *_noisy_loop_graph(n_side=2))
    with pytest.raises(RuntimeError, match="failed"):
        spa.compute()
    assert not native.available()


def test_profile_spa_host_row_holds_native_to_numpy():
    """profile_spa_torch's (and chip_smoke phase 12's) host row times the
    native solve bare beside _host_lm on the same arrays and holds the two
    to each other at this file's bars."""
    import profile_spa_torch

    assert (profile_spa_torch.HOST_COST_RTOL, profile_spa_torch.HOST_POSE_TOL) == \
        (COST_RTOL, DENSE_TOL)
    pair = profile_spa_torch.host_pair(TB.noisy_loop_pose_graph(100))
    assert pair["reason"] == pair["numpy_reason"] == "converged"
    assert pair["native_iters"] == pair["numpy_iters"] > 0
    assert pair["numpy_cost_rel"] <= COST_RTOL and pair["numpy_pose_gap"] <= DENSE_TOL
    assert 0 < pair["fill_blocks"] <= 105 and len(pair["numpy_ms_runs"]) == 3
    lines = []
    rows = profile_spa_torch.crossover("cpu", sizes=(100,), cg_sizes=(), log=lines.append)
    assert rows[0]["solver"] == "host" and rows[0]["native_iters"] == rows[0]["iters"]
    assert "bare: native " in lines[0] and "vs numpy _host_lm " in lines[0]
    assert profile_spa_torch.table(rows)[-1].startswith("host bare, best-of-3 ms: 105 nodes")
