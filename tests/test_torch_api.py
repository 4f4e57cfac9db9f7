"""The port's package-level public names against the JAX package's.

Each ``__all__`` of ``yag_slam_tpu/**/__init__.py`` is read from the source
by AST, so this file never imports the JAX package (and the import-boundary
tests stay sound whatever file a worker ran before them).  The port's
counterpart of each package must export every one of those names, except
the names that wait for a module still to port; those must not appear in
the port yet, so the list can only shrink.  The same holds for the
parameter names of every public function and method of each ported module.
"""
import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "yag_slam_tpu"

# name -> the module of the JAX package it waits for: none is left, every
# name the JAX package exports is ported
WAITING = {}


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


# -- parameter names of the ported modules' public functions and methods --------

# parameters only the port has: every entry point takes a torch device, and
# some take a torch dtype where the JAX package fixes it
PORT_ONLY = {"device", "dtype"}
# the JAX package's TPU route switches: the port dispatches by device
TPU_SWITCHES = {"use_pallas", "use_patch", "use_vmem_score"}
# module -> {JAX name: the port's}: the SPA loops take a reduction callable
# (an all-reduce for an edge-sharded graph) where JAX takes a mesh axis name
RENAMED = {"graphopt/spa.py": {"axis_name": "reduce"}}
# public internals whose parameters differ by design
INTERNALS = {
    "matching/correlation.py:build_correlation_grid":
        "takes float32 smear `taps` (checked once by check_smear_taps) where "
        "JAX takes the float64 `k1` and a dtype",
    "matching/correlation.py:score_lattice":
        "takes the (N, S, S) uint8 grid that window_sum reads where JAX takes a "
        "flat grid, and has no TPU layout arguments (sub_size, symmetric)",
    "matching/correlation.py:find_best_pose":
        "passes score_lattice's keywords through",
}
# TPU layouts and Pallas routes of the JAX matcher; the port's
# build_quantized_grid and score_lattice, with the CUDA kernels of
# matching/kernels.py, stand in their place
TPU_ONLY = {f"matching/correlation.py:{n}" for n in (
    "build_occupancy_padded", "dedup_scatter_cells", "build_occupancy_pallas",
    "build_quantized_grid_fused", "build_quantized_grid_strip", "score_lattice_batched",
    "score_lattice_patch_batched", "vmem_score_layout", "score_lattice_vmem_batched",
    "mxu_score_layout", "score_lattice_mxu_batched")}
# callables of ported modules that wait for a module still to port, with
# the reason: none is left, every callable of the JAX package is ported
SIGNATURE_WAITING = {}


def _public_signatures(path):
    """{name: (positional names, keyword-only names, *args, **kwargs)} of
    the public functions, public methods and constructors in `path`; a
    public name bound to jax.jit(f, ...) of a def f takes f's parameters."""
    tree = ast.parse(path.read_text(), str(path))

    def sig(fn):
        a = fn.args
        return ([x.arg for x in a.posonlyargs + a.args], {x.arg for x in a.kwonlyargs},
                a.vararg is not None, a.kwarg is not None)

    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = sig(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (
                        not m.name.startswith("_") or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = sig(m)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)
              and not node.targets[0].id.startswith("_")
              and isinstance(node.value, ast.Call) and node.value.args
              and isinstance(node.value.args[0], ast.Name)
              and node.value.args[0].id in defs):
            out[node.targets[0].id] = sig(defs[node.value.args[0].id])
    return out


def _normalized(jax_sig, port_sig, renamed=None):
    jpos, jkw, jva, jvk = jax_sig
    ppos, pkw, pva, pvk = port_sig
    renamed = renamed or {}
    keep = lambda names: [renamed.get(n, n) for n in names if n not in TPU_SWITCHES]  # noqa: E731
    extra = PORT_ONLY - set(jpos) - jkw
    return ((keep(jpos), set(keep(jkw)), jva, jvk),
            ([n for n in ppos if n not in extra], pkw - extra, pva, pvk))


def _ported_modules():
    for jax_path in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_path.relative_to(JAX_PKG)
        port_path = REPO / "yag_slam_tpu_torch" / rel
        if port_path.exists():
            yield rel.as_posix(), jax_path, port_path


def test_signature_walk_sees_the_ported_modules():
    mods = {rel for rel, _, _ in _ported_modules()}
    assert {"graphopt/spa.py", "matching/matcher.py", "slam/graph_slam.py",
            "mapping/occupancy.py", "utils/profiling.py", "io/benchmark.py",
            "native/__init__.py", "matching/refmatcher.py", "apps/ab_compare.py",
            "parallel/sharding.py", "parallel/loop_search.py", "parallel/dist_spa.py",
            "utils/viz.py", "apps/ros1_node.py"} <= mods
    spa = _public_signatures(JAX_PKG / "graphopt" / "spa.py")
    assert {"lm_run_cg", "lm_candidate", "PoseGraphSolver.__init__", "SPA2d.compute"} <= set(spa)
    assert "axis_name" in spa["lm_run_cg"][1]


@pytest.mark.parametrize("rel", sorted(rel for rel, _, _ in _ported_modules()))
def test_public_signatures_match_the_jax_package(rel):
    """Every public function and method of a ported module takes the JAX
    package's parameter names (positional ones in order), apart from the
    port's device and dtype, the TPU route switches, the renames above and
    the reasoned lists; each list entry must still be needed."""
    jax_sigs = _public_signatures(JAX_PKG / rel)
    port_sigs = _public_signatures(REPO / "yag_slam_tpu_torch" / rel)
    bad = []
    for name, jsig in jax_sigs.items():
        key = f"{rel}:{name}"
        if key in TPU_ONLY or key in SIGNATURE_WAITING:
            assert name not in port_sigs, f"{key} is ported; take it off its list"
            continue
        if name not in port_sigs:
            bad.append(f"{name}: missing")
            continue
        want, got = _normalized(jsig, port_sigs[name], RENAMED.get(rel))
        if key in INTERNALS:
            assert got != want, f"{key} now matches; take it off INTERNALS"
        elif got != want:
            bad.append(f"{name}: JAX {want}, port {got}")
    assert not bad, f"{rel}: " + "; ".join(bad)


def test_every_listed_signature_is_a_jax_callable():
    for key in (*INTERNALS, *TPU_ONLY, *SIGNATURE_WAITING):
        rel, name = key.split(":")
        assert name in _public_signatures(JAX_PKG / rel), key
