"""The port's boundaries: no JAX, no JAX-package module, no silent
fallback, honest counters."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from yag_slam_tpu_torch import _build
from yag_slam_tpu_torch.matching import kernels as K
from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

PORT_MODULES = [
    "yag_slam_tpu_torch",
    "yag_slam_tpu_torch._build",
    "yag_slam_tpu_torch.interop",
    "yag_slam_tpu_torch.io",
    "yag_slam_tpu_torch.graphopt",
    "yag_slam_tpu_torch.graphopt.graph",
    "yag_slam_tpu_torch.graphopt.spa",
    "yag_slam_tpu_torch.mapping",
    "yag_slam_tpu_torch.mapping.occupancy",
    "yag_slam_tpu_torch.mapping.render_kernel",
    "yag_slam_tpu_torch.matching",
    "yag_slam_tpu_torch.matching.correlation",
    "yag_slam_tpu_torch.matching.graphs",
    "yag_slam_tpu_torch.matching.kernels",
    "yag_slam_tpu_torch.matching.program_kernels",
    "yag_slam_tpu_torch.matching.matcher",
    "yag_slam_tpu_torch.slam",
    "yag_slam_tpu_torch.slam.graph_slam",
    "yag_slam_tpu_torch.slam.serde",
    "yag_slam_tpu_torch.matching.pipeline",
    "yag_slam_tpu_torch.mapping.raytrace",
    "yag_slam_tpu_torch.splicing",
    "yag_slam_tpu_torch.splicing.segmentation",
    "yag_slam_tpu_torch.splicing.splice",
    "yag_slam_tpu_torch.apps",
    "yag_slam_tpu_torch.apps.online",
    "yag_slam_tpu_torch.apps.offline_mapper",
    "yag_slam_tpu_torch.utils",
    "yag_slam_tpu_torch.utils.profiling",
    "yag_slam_tpu_torch.utils.metrics",
    "yag_slam_tpu_torch._device",
    "yag_slam_tpu_torch.core",
    "yag_slam_tpu_torch.core.config",
    "yag_slam_tpu_torch.core.scan",
    "yag_slam_tpu_torch.core.transform",
    "yag_slam_tpu_torch.io.benchmark",
    "yag_slam_tpu_torch.io.carmen",
    "yag_slam_tpu_torch.io.simulator",
    "yag_slam_tpu_torch.native",
    "yag_slam_tpu_torch.matching.refmatcher",
    "yag_slam_tpu_torch.apps.ab_compare",
    "yag_slam_tpu_torch.apps.ros1_node",
    "yag_slam_tpu_torch.parallel",
    "yag_slam_tpu_torch.parallel.sharding",
    "yag_slam_tpu_torch.parallel.loop_search",
    "yag_slam_tpu_torch.parallel.dist_spa",
    "yag_slam_tpu_torch.utils.viz",
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the root-level scripts of the port: its harnesses and chip_smoke.py
PORT_SCRIPTS = ("bench_torch.py", "profile_match_torch.py", "profile_spa_torch.py",
                "scaling_bench_torch.py", "chip_smoke.py")
# the JAX side's root-level scripts, which no port source may import
JAX_SCRIPTS = ("bench", "profile_match", "profile_spa", "scaling_bench")


def _modules_loaded_by_the_port(prefix):
    """Names under `prefix` in sys.modules of a fresh interpreter that
    imported every port module and every port script as a module."""
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"for f in {PORT_SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(f[:-3], f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"print(sorted(k for k in sys.modules if k == {prefix!r} "
        f"or k.startswith({prefix + '.'!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_port_never_imports_jax():
    assert _modules_loaded_by_the_port("jax") == "[]"


def test_port_never_imports_the_jax_package():
    """Not even its JAX-free host modules: the port has its own copies."""
    assert _modules_loaded_by_the_port("yag_slam_tpu") == "[]"


@pytest.mark.parametrize("script", JAX_SCRIPTS)
def test_port_never_imports_the_jax_side_scripts(script):
    assert _modules_loaded_by_the_port(script) == "[]"


def _port_sources():
    root = pathlib.Path(REPO)
    return sorted((root / "yag_slam_tpu_torch").rglob("*.py")) + [root / f for f in PORT_SCRIPTS]


def test_every_port_module_is_imported_and_scanned():
    """PORT_MODULES (imported by the sys.modules checks) and the AST scan
    both cover every module of the port."""
    root = pathlib.Path(REPO)
    files = [p for p in _port_sources() if p.name not in PORT_SCRIPTS]
    names = {".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
             for p in files}
    assert names == set(PORT_MODULES)
    assert {"refmatcher.py", "ab_compare.py", "ros1_node.py", "sharding.py",
            "loop_search.py", "dist_spa.py", "viz.py"} <= {p.name for p in files}


def test_no_port_source_names_the_jax_package_in_an_import():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n == "yag_slam_tpu" or n.startswith("yag_slam_tpu.")
                    or n.split(".")[0] in ("jax", *JAX_SCRIPTS)]
    assert len(_port_sources()) > 30 and not bad, bad
    assert {p.name for p in _port_sources()} >= set(PORT_SCRIPTS)


def _checkpoint(tmp_path):
    slam = GraphSlam.default(device="cpu")
    path = tmp_path / "empty.graph"
    slam.to_file(str(path))
    return slam.serialize(), slam.binarize(), str(path)


def _entry_point_calls(tmp_path):
    """Every public entry point of the port, called without `device`."""
    from yag_slam_tpu_torch.apps.online import OnlineMapper, ThreadedOnlineMapper
    from yag_slam_tpu_torch.graphopt.spa import SPA2d
    from yag_slam_tpu_torch.interop import graph_slam_from_state
    from yag_slam_tpu_torch.io.benchmark import noisy_loop_pose_graph, populate_spa
    from yag_slam_tpu_torch.io.simulator import SimWorld, simulate_scan
    from yag_slam_tpu_torch.mapping import (
        create_occupancy_grid, occupancy_grid_map_to_correlation_grid,
        run_raytracing_sweep, trace_rays)
    from yag_slam_tpu_torch.parallel import DistributedSPA, default_mesh
    from yag_slam_tpu_torch.splicing import map_to_graph, segment_map, spatial_segments

    im = np.full((40, 40), 255, dtype=np.uint8)
    im[5, :] = 0
    scan = simulate_scan(SimWorld.office(), np.zeros(3), n_beams=90)
    return {
        "CorrelativeScanMatcher": lambda: CorrelativeScanMatcher(),
        "GraphSlam.default": lambda: GraphSlam.default(),
        "GraphSlam.deserialize": lambda: GraphSlam.deserialize(_checkpoint(tmp_path)[0]),
        "GraphSlam.unbinarize": lambda: GraphSlam.unbinarize(_checkpoint(tmp_path)[1]),
        "GraphSlam.from_file": lambda: GraphSlam.from_file(_checkpoint(tmp_path)[2]),
        "graph_slam_from_state": lambda: graph_slam_from_state(_checkpoint(tmp_path)[0]),
        "OnlineMapper": lambda: OnlineMapper(),
        "ThreadedOnlineMapper": lambda: ThreadedOnlineMapper(),
        "create_occupancy_grid": lambda: create_occupancy_grid([scan]),
        "occupancy_grid_map_to_correlation_grid":
            lambda: occupancy_grid_map_to_correlation_grid(im, 0.05),
        "trace_rays": lambda: trace_rays(im, [0.0, 90.0], 20, 20),
        "run_raytracing_sweep": lambda: run_raytracing_sweep(im, [0.0, 90.0], 20, 20),
        "spatial_segments": lambda: spatial_segments(im == 255, 2),
        "segment_map": lambda: segment_map(im),
        "map_to_graph": lambda: map_to_graph(im, 0.05, (0.0, 0.0)),
        "SPA2d.dense": lambda: populate_spa(
            SPA2d(solver="dense"), *noisy_loop_pose_graph(8)).compute(),
        "SPA2d.cg": lambda: populate_spa(
            SPA2d(solver="cg"), *noisy_loop_pose_graph(8)).compute(),
        "default_mesh": lambda: default_mesh(),
        "DistributedSPA": lambda: DistributedSPA(default_mesh()),
    }


# RefBaselineScanMatcher is not an entry point here: it is host code by its
# nature (the reference the card is measured against) and takes no device.
ENTRY_POINTS = (
    "CorrelativeScanMatcher", "GraphSlam.default", "GraphSlam.deserialize",
    "GraphSlam.unbinarize", "GraphSlam.from_file", "graph_slam_from_state",
    "OnlineMapper", "ThreadedOnlineMapper", "create_occupancy_grid",
    "occupancy_grid_map_to_correlation_grid", "trace_rays",
    "run_raytracing_sweep", "spatial_segments", "segment_map", "map_to_graph",
    "SPA2d.dense", "SPA2d.cg", "default_mesh", "DistributedSPA",
)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_cuda_request_never_runs_on_cpu(entry, tmp_path):
    """Every entry point runs on cuda unless the caller asks for the CPU:
    called without `device` it gets the card or raises; it never quietly
    becomes a CPU run."""
    calls = _entry_point_calls(tmp_path)
    assert set(calls) == set(ENTRY_POINTS)
    if torch.cuda.is_available():
        if entry != "CorrelativeScanMatcher":
            pytest.skip("checks the card-less case")
        m = calls[entry]()
        assert m.device.type == "cuda" and m._taps.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CorrelativeScanMatcher(device="cuda")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the card-less case")
def test_mapper_and_cli_refuse_cuda_without_a_card(tmp_path):
    """The online mapper and the CLI (whose --device defaults to cuda)
    raise without a card; neither falls back to the CPU."""
    from yag_slam_tpu_torch.apps import offline_mapper
    from yag_slam_tpu_torch.apps.online import OnlineMapper, ThreadedOnlineMapper

    for cls in (OnlineMapper, ThreadedOnlineMapper):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(device="cuda")
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        offline_mapper.main(["--synthetic-laps", "1", "--out", out])
    assert not (tmp_path / "run.graph").exists()


def test_stage_timer_and_block_and_time():
    from yag_slam_tpu_torch.utils.profiling import StageTimer, block_and_time

    timer = StageTimer()
    for _ in range(3):
        with timer("match"):
            pass
    row = timer.summary()["match"]
    assert row["count"] == 3 and row["total_s"] >= 0.0
    calls = []
    mean_s, out = block_and_time(lambda x: calls.append(x) or x + 1, 4, repeats=5)
    assert out == 5 and len(calls) == 6 and mean_s >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from yag_slam_tpu_torch.utils.profiling import device_trace

    log_dir = tmp_path / "trace"
    with device_trace(log_dir=str(log_dir)) as got:
        torch.ones(64).cumsum(0)
    assert got == str(log_dir)
    import json

    from yag_slam_tpu_torch.utils.profiling import TRACE_FILE

    events = json.loads((log_dir / TRACE_FILE).read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_wrappers_reject_other_devices():
    """Dispatch knows only CPU (plain version) and CUDA (kernel)."""
    q = torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta")
    idx = torch.zeros((1, 1, 4), dtype=torch.int32, device="meta")
    n = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.window_sum(q, idx, idx, n, 2, 2, 1)
    with pytest.raises(ValueError, match="different devices"):
        K.window_sum(torch.zeros((1, 8, 8), dtype=torch.uint8), idx, idx, n, 2, 2, 1)


def test_cpu_wrappers_leave_launch_counts_at_zero():
    K.reset_launches()
    sy = torch.tensor([[1, -1, 3]], dtype=torch.int32)
    sx = torch.tensor([[2, 0, 4]], dtype=torch.int32)
    occ = K.scatter_cells(sy, sx, 7)
    assert occ.sum() == 2 and occ[0, 1, 2] == 1 and occ[0, 3, 4] == 1
    taps = torch.tensor([0.5, 1.0, 0.5], dtype=torch.float32)
    lim = torch.tensor([[5, 4]], dtype=torch.int32)
    q = K.smear_quantize(occ, lim, taps, 5, 1)
    assert q.dtype == torch.uint8 and q[0, 2, 3] == 100 and q[0, 2, 2] == 50
    assert q[0, :, 4:].sum() == 0    # masked past col_hi = 4
    g = K.smear_grid(occ, taps, 5, 1)
    assert g.dtype == torch.float32 and g[0, 2, 3] == 1.0 and g[0, 2, 2] == 0.5
    assert g[0, :, 4].sum() > 0      # unmasked
    g0 = K.smear_grid(occ, taps[1:2], 7, 0)     # one tap: h = 0
    assert torch.equal(g0, occ.to(torch.float32))
    K.window_sum(q, sy[:, None, :], sx[:, None, :],
                 torch.tensor([3], dtype=torch.int32), 2, 2, 1)
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_sources():
    """The built library is keyed by a hash of every CUDA source."""
    srcs, headers = _build._sources()
    assert {p.name for p in srcs} == {"grid_build.cu", "match_program.cu", "render.cu",
                                      "sweep.cu", "window_sum.cu"}
    path = _build._library_path(srcs, headers)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libyag_kernels_") and path.suffix == ".so"
    assert _build._library_path(srcs, headers) == path
    assert _build._library_path(srcs[:1], headers) != path


def test_smear_taps_are_float32_and_symmetric():
    m = CorrelativeScanMatcher(device="cpu")
    taps = m._taps.numpy()
    assert m._taps.dtype == torch.float32
    np.testing.assert_array_equal(taps, taps[::-1])
    assert len(taps) == 2 * m._half + 1 and taps[m._half] == 1.0


def _pallas_defs(path):
    """Line numbers of the defs in `path` whose body reaches pl.pallas_call."""
    with open(os.path.join(REPO, path)) as f:
        lines = f.read().splitlines()
    defs = []
    for i, text in enumerate(lines):
        if not text.startswith("def "):
            continue
        body = []
        for later in lines[i + 1:]:
            if later.startswith("def "):
                break
            body.append(later)
        if any("pl.pallas_call(" in b for b in body):
            defs.append(i + 1)
    return defs


def test_kernel_table_names_the_pallas_kernels():
    """Each wrapper's source exists, each "file:line" it replaces is the
    def of a function that reaches pl.pallas_call, and together they
    cover every such def of the JAX package."""
    assert set(K.KERNELS) == set(K.LAUNCHES)
    covered = set()
    for name, info in K.KERNELS.items():
        assert os.path.isfile(os.path.join(REPO, info["source"])), name
        for ref in info["replaces"]:
            path, line = ref.rsplit(":", 1)
            assert int(line) in _pallas_defs(path), (name, ref)
            covered.add((path, int(line)))
    path = "yag_slam_tpu/matching/pallas_kernels.py"
    defs = _pallas_defs(path)
    assert len(defs) == 7
    assert {(path, line) for line in defs} <= covered
