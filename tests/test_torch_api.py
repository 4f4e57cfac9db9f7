"""The port's package-level public names against the JAX package's.

Each ``__all__`` of ``yag_slam_tpu/**/__init__.py`` is read from the source
by AST, so this file never imports the JAX package (and the import-boundary
tests stay sound whatever file a worker ran before them).  The port's
counterpart of each package must export every one of those names, except
the names that wait for a module still to port; those must not appear in
the port yet, so the list can only shrink.
"""
import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "yag_slam_tpu"

# name -> the module of the JAX package it waits for
WAITING = {
    "PoseGraphSolver": "graphopt/spa.py (device SPA)",
    "RefBaselineScanMatcher": "matching/refmatcher.py",
    "plot_slam": "utils/viz.py",
    "save_slam_figure": "utils/viz.py",
    "default_mesh": "parallel/sharding.py",
    "ShardedLoopMatcher": "parallel/loop_search.py",
    "DistributedSPA": "parallel/dist_spa.py",
}


def _jax_exports():
    """{dotted package: __all__} of every package of the JAX package that
    declares one, read without importing it."""
    out = {}
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        tree = ast.parse(init.read_text(), str(init))
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                rel = init.parent.relative_to(REPO)
                out[".".join(rel.parts)] = ast.literal_eval(node.value)
    return out


JAX_EXPORTS = _jax_exports()


def _port_module(package):
    name = package.replace("yag_slam_tpu", "yag_slam_tpu_torch", 1)
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def test_the_ast_reader_finds_the_packages():
    assert {"yag_slam_tpu", "yag_slam_tpu.core", "yag_slam_tpu.io",
            "yag_slam_tpu.matching", "yag_slam_tpu.utils"} <= set(JAX_EXPORTS)
    assert "Transform" in JAX_EXPORTS["yag_slam_tpu"]
    assert "Scan2DMatcherCpp" in JAX_EXPORTS["yag_slam_tpu.matching"]


@pytest.mark.parametrize("package", sorted(JAX_EXPORTS))
def test_port_exports_the_jax_packages_names(package):
    names = JAX_EXPORTS[package]
    mod = _port_module(package)
    have = set() if mod is None else {n for n in names if hasattr(mod, n)}
    missing = [n for n in names if n not in have and n not in WAITING]
    assert not missing, f"{package}: the port lacks {missing}"
    early = [n for n in names if n in have and n in WAITING]
    assert not early, f"{package}: {early} are ported; take them off WAITING"
    if mod is not None:
        listed = set(getattr(mod, "__all__", ()))
        assert have <= listed, f"{package}: {sorted(have - listed)} not in __all__"


def test_every_waiting_name_is_a_jax_export():
    exported = {n for names in JAX_EXPORTS.values() for n in names}
    assert set(WAITING) <= exported


def test_top_level_names_are_the_core_objects():
    import yag_slam_tpu_torch as T
    from yag_slam_tpu_torch import core

    for name in JAX_EXPORTS["yag_slam_tpu.core"]:
        assert getattr(T, name) is getattr(core, name), name
    from yag_slam_tpu_torch.io import SimWorld, simulate_scan
    from yag_slam_tpu_torch.matching import (
        CorrelativeScanMatcher, Scan2DMatcherCpp, Scan2DMatcherPy)

    assert Scan2DMatcherCpp is CorrelativeScanMatcher is Scan2DMatcherPy
    assert T.Transform is T.core.Transform
    scan = simulate_scan(SimWorld.office(), [0.0, 0.0, 0.0], n_beams=30)
    assert len(scan.ranges) == 30
