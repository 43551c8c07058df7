"""Port parity for the scoring slice as a whole: the 22-column export, the
metric block, run_scoring_pipeline and the ``score`` command line.

The same JAX params, scalers and MC seed integer go through the JAX exporter
with ``sampler='pallas'`` (interpret mode on the CPU) and through the port's
exporter on ``device="cpu"``.  Tolerances: the deterministic columns are
float32 arithmetic on both sides, rtol 2e-5 (atol 1e-5 for the cancellation
in f_v and the prediction residual, stated on column 12 in volts); the two
uncertainty columns differ only in the matmul summation order of the MC
passes, rtol 1e-4 atol 1e-6."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.data.combine import combine_and_normalize as jax_combine
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu.pipeline import export as jax_export
from pinnfc_tpu.pipeline.train_pipeline import evaluate_voltage_metrics as jax_metrics
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.config import TrainConfig, train_config_to_dict
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.contract import load_comprehensive_results
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results, default_mc_seed
from pinnfc_tpu_torch.pipeline.score import run_scoring_pipeline
from pinnfc_tpu_torch.pipeline.train_pipeline import evaluate_voltage_metrics
from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
from pinnfc_tpu_torch.utils.jax_params import params_from_jax

MC_TIMES = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    """(JAX params, JAX dataset, JAX export, seed int, port params, port dataset)."""
    normal, faults = synthesize_stack_data(n_normal=300, n_fault=40, seed=42)
    jds = jax_combine(normal, faults)
    jparams = jax_init_pinn(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    # the JAX exporter's own integer derivation (pipeline/export.py:111)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    jres = jax_export.build_comprehensive_results(
        jparams, jds, rng=key, mc_times=MC_TIMES, sampler="pallas", smooth_window=50)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ds = combine_and_normalize(normal, faults, device="cpu")
    return jparams, jds, jres, seed, params, ds


def test_export_matches_jax_pallas_exporter(both):
    _, _, jres, seed, params, ds = both
    res, _ = build_comprehensive_results(params, ds, mc_seed=seed, mc_times=MC_TIMES,
                                         smooth_window=50)
    got, want = res.array, jres.array
    assert got.shape == want.shape == (780, 22)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for c in range(22):
        if c in (10, 11):
            rtol, atol = 1e-4, 1e-6
        else:
            rtol, atol = 2e-5, 1e-5
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=f"column {c}")
    np.testing.assert_array_equal(got[:, 17], want[:, 17])


def test_metrics_match_jax(both):
    jparams, jds, jres, seed, params, ds = both
    res, _ = build_comprehensive_results(params, ds, mc_seed=seed, mc_times=MC_TIMES,
                                         smooth_window=50)
    got = evaluate_voltage_metrics(params, ds, results=res)
    want = jax_metrics(jparams, jds, results=jres)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]) == np.isfinite(want[k]), k
        if np.isfinite(want[k]):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def _assert_metrics_close(got, want, rtol):
    """Each metric at ``rtol`` (atol 1e-7); an R² as 1 − R² = SS_res/SS_tot,
    the ratio computed, whose relative error a near-zero R² would magnify."""
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]) == np.isfinite(want[k]), k
        if np.isfinite(want[k]):
            g, w = (1.0 - got[k], 1.0 - want[k]) if "_r2" in k else (got[k], want[k])
            assert g == pytest.approx(w, rel=rtol, abs=1e-7), k


def test_metrics_without_results_match_jax(both):
    """``results=None``: one eval forward and the residual bundle in each
    package (the JAX ``_metrics_device``); float32 on both sides, rtol 1e-5."""
    jparams, jds, _, _, params, ds = both
    before = dict(build.LAUNCHES)
    got = evaluate_voltage_metrics(params, ds)
    assert build.LAUNCHES == before
    _assert_metrics_close(got, jax_metrics(jparams, jds), rtol=1e-5)


def test_metrics_without_results_match_the_export_path(both):
    """The port's two paths describe the same eval forward: the export's base
    column is the plain float32 forward on the CPU (rtol 1e-5)."""
    _, _, _, seed, params, ds = both
    res, _ = build_comprehensive_results(params, ds, mc_seed=seed, mc_times=MC_TIMES,
                                         smooth_window=50)
    _assert_metrics_close(evaluate_voltage_metrics(params, ds),
                          evaluate_voltage_metrics(params, ds, results=res), rtol=1e-5)


def _port_checkpoint(tmp_path, params, ds, mc_times):
    cfg = dataclasses.replace(TrainConfig(), mc_times=mc_times, smooth_window=50)
    path = str(tmp_path / "ck")
    save_checkpoint(path, params, ds.scaler_x, ds.scaler_y,
                    meta={"config": train_config_to_dict(cfg)})
    return path


def test_run_scoring_pipeline_on_cpu_matches_exporter(both, tmp_path):
    _, _, jres, seed, params, ds = both
    path = _port_checkpoint(tmp_path, params, ds, MC_TIMES)
    mat = str(tmp_path / "out" / "scored.mat")
    res = run_scoring_pipeline(path, mat_path=mat, n_normal=300, n_fault=40,
                               device="cpu", mc_seed=seed)
    np.testing.assert_allclose(res.results.array, jres.array, rtol=1e-4, atol=1e-5,
                               equal_nan=True)
    np.testing.assert_array_equal(load_comprehensive_results(mat).array, res.results.array)
    assert res.metrics["normal_oob_frac"] == 0.0
    assert set(res.timings) == {"ckpt_s", "data_s", "export_s"}


def test_default_mc_seed():
    assert default_mc_seed(42) == int(np.random.RandomState(43).randint(0, 2**31 - 1))
    assert default_mc_seed(42) != default_mc_seed(41)


def test_default_device_raises_without_cuda(both, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    _, _, _, _, params, ds = both
    path = _port_checkpoint(tmp_path, params, ds, MC_TIMES)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scoring_pipeline(path, n_normal=300, n_fault=40)
    assert cli.main(["score", "--ckpt", path, "--mat-out", str(tmp_path / "x.mat")]) != 0
    assert not os.path.exists(tmp_path / "x.mat")


def test_building_blocks_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from pinnfc_tpu_torch.data.scaling import AffineScaler
    from pinnfc_tpu_torch.models.mlp import MLP

    data = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    for build in (MLP, lambda: AffineScaler.fit(data),
                  lambda: AffineScaler.from_numpy(AffineScaler.fit(data, device="cpu").to_numpy())):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_cli_score_on_cpu(both, tmp_path, capsys):
    _, _, _, _, params, ds = both
    path = _port_checkpoint(tmp_path, params, ds, 2)
    mat = str(tmp_path / "cli.mat")
    rc = cli.main(["score", "--ckpt", path, "--mat-out", mat, "--mc-times", "3",
                   "--seed", "42", "--device", "cpu"])
    assert rc == 0
    assert load_comprehensive_results(mat).array.shape == (15600, 22)
    assert "voltage_mae" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Import every port module and run score on the CPU in a fresh process:
    neither ``jax`` nor ``pinnfc_tpu`` may be imported."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys, dataclasses
        import torch
        import pinnfc_tpu_torch
        for m in pkgutil.walk_packages(pinnfc_tpu_torch.__path__, "pinnfc_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from pinnfc_tpu_torch.config import TrainConfig, train_config_to_dict
        from pinnfc_tpu_torch.data.combine import combine_and_normalize
        from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
        from pinnfc_tpu_torch.models.pinn import init_pinn
        from pinnfc_tpu_torch.pipeline.score import run_scoring_pipeline
        from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
        params = init_pinn(generator=torch.Generator().manual_seed(0), device="cpu")
        normal, faults = synthesize_stack_data(n_normal=120, n_fault=10, seed=42)
        ds = combine_and_normalize(normal, faults, device="cpu")
        cfg = dataclasses.replace(TrainConfig(), mc_times=2)
        path = {str(tmp_path / "ck")!r}
        save_checkpoint(path, params, ds.scaler_x, ds.scaler_y,
                        meta={{"config": train_config_to_dict(cfg)}})
        res = run_scoring_pipeline(path, n_normal=120, n_fault=10, device="cpu")
        assert res.results.array.shape == (240, 22)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.") or k == "pinnfc_tpu"
                     or k.startswith("pinnfc_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout
