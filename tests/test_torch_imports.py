"""The port's boundaries: no JAX, no silent fallback, honest counters."""
import os
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
    "yag_slam_tpu_torch.matching",
    "yag_slam_tpu_torch.matching.correlation",
    "yag_slam_tpu_torch.matching.kernels",
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
    # the JAX package's host metrics, which the port's CLI reports with
    "yag_slam_tpu.utils.metrics",
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_request_never_runs_on_cpu():
    """device="cuda" either gets a CUDA matcher or raises; it never quietly
    becomes a CPU run."""
    if torch.cuda.is_available():
        m = CorrelativeScanMatcher(device="cuda")
        assert m.device.type == "cuda" and m._taps.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CorrelativeScanMatcher(device="cuda")
        with pytest.raises(RuntimeError):
            GraphSlam.default(device="cuda")


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

    path = tmp_path / "trace" / "t.json"
    with device_trace(str(path)):
        torch.ones(64).cumsum(0)
    import json

    events = json.loads(path.read_text())["traceEvents"]
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
    assert {p.name for p in srcs} == {"grid_build.cu", "window_sum.cu"}
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
