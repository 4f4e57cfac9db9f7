"""Whole-pipeline A/B on the port: the reference-matcher-driven GraphSlam
(native/refbaseline.cpp on the host CPU) against the port's pipeline on
the same generated building tour, float64 on the CPU, with the
assertions of tests/test_ab_reference.py (which skips where the JAX
package's extension is not built; the port builds its library with the
host compiler, so this runs).  The whole tour takes ~13 s here, so it is
not cut."""
import numpy as np
import pytest
import torch

from yag_slam_tpu_torch.apps import ab_compare as AB


@pytest.fixture(scope="module")
def ab_run(tmp_path_factory):
    from yag_slam_tpu_torch.io.benchmark import generate_benchmark_log

    tmp = tmp_path_factory.mktemp("ab_ref")
    log, gtp, _ = generate_benchmark_log(
        str(tmp / "sim_intel.clf"), step=0.5, laps=1, n_beams=180, seed=0,
        yaw_bias=0.0020, xy_noise=0.003, yaw_noise=0.0015,
    )
    args = AB.build_parser().parse_args(["--device", "cpu"])
    args.dtype = torch.float64
    # the port side's ops are small: one intra-op thread runs them as fast
    # alone and keeps pytest-xdist's workers from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return AB.ab_compare(log, gtp, args)
    finally:
        torch.set_num_threads(threads)


def test_reference_pipeline_runs(ab_run):
    ref = ab_run["ref"]
    assert ref["matcher"] == "refbaseline_cpp"
    assert ref["vertices"] > 100
    assert ref["loop_closures"] >= 1
    assert np.isfinite(ref["ate_rmse"])
    # the reference pipeline itself beats raw odometry on its own run
    assert ref["ate_rmse"] < ref["ate_odom"]


def test_ate_parity_vs_reference_pipeline(ab_run):
    """The port's trajectory matches or beats the reference-driven run on
    the same log: same integrated subset, closures within one, ATE within
    10 % + 2 cm (both pipelines make float-boundary accept/reject
    decisions), both below odometry."""
    ref, port = ab_run["ref"], ab_run["port"]
    assert port["vertices"] == ref["vertices"]
    assert abs(port["loop_closures"] - ref["loop_closures"]) <= 1
    assert port["loop_closures"] >= 1
    assert port["ate_rmse"] <= ref["ate_rmse"] * 1.10 + 0.02, ab_run
    assert port["ate_rmse"] < port["ate_odom"]


def test_output_schema_names_the_port(ab_run):
    """The JAX package's schema with the TPU names renamed."""
    assert set(ab_run) == {"ref", "port", "ate_ratio_port_over_ref"}
    assert ab_run["port"]["matcher"] == "torch_cpu"
    assert ab_run["ate_ratio_port_over_ref"] == pytest.approx(
        ab_run["port"]["ate_rmse"] / ab_run["ref"]["ate_rmse"], abs=1e-4)
    keys = {"matcher", "vertices", "edges", "loop_closures", "loop_chains_tried",
            "elapsed_s", "scans_per_s", "ate_rmse", "ate_odom"}
    assert set(ab_run["ref"]) == set(ab_run["port"]) == keys


def test_port_side_defaults_to_cuda():
    """--device defaults to cuda; without a card the port side raises (the
    reference side alone is host code)."""
    args = AB.build_parser().parse_args([])
    assert args.device == "cuda" and args.dtype is None
    cfg = {"range_threshold": 8.0}
    ref = AB._build_mapper(cfg, cfg, args, use_ref=True)
    assert ref.device.type == "cpu" and ref.slam.opt._solver.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("checks the card-less case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AB._build_mapper(cfg, cfg, args, use_ref=False)
