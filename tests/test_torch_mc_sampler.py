"""Port parity: the MC sampler for any topology
(pinnfc_tpu_torch.uq.mc_dropout.mc_dropout_samples, masks from a
torch.Generator) against the JAX vmapped sampler
pinnfc_tpu.uq.mc_dropout.mc_dropout_samples, and the exporter's choice of
sampler by topology.

The two samplers draw their masks from different random streams, so with
dropout their statistics agree in distribution only: the banded check of
tests/test_pallas_mc.py (mean relative difference of the epistemic std below
0.15, of the aleatoric std below 0.1, at 800 passes).  With dropout 0 every
pass is the eval pass: all three outputs against JAX at rtol 1e-5 (atol 1e-7
for predictions near zero; float32 matmuls in XLA and in torch), epistemic
exactly 0."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.models.mlp import init_mlp
from pinnfc_tpu.uq import mc_dropout as jax_mc
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.pipeline import export
from pinnfc_tpu_torch.uq.mc_dropout import (
    mc_chunking, mc_dropout_samples, mc_dropout_samples_loop)
from pinnfc_tpu_torch.utils.jax_params import mlp_from_jax
from pinnfc_tpu_torch.utils.threads import one_thread

LAYERS = (8, 64, 64, 1)


@pytest.fixture(scope="module")
def setup():
    jm = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(0), LAYERS))
    x = np.random.RandomState(1).uniform(-1, 1, (300, 8)).astype(np.float32)
    return jm, x, mlp_from_jax(jm, device="cpu"), torch.as_tensor(x)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("mc_times,n,chunk", [
    (2000, 15600, 100),  # the default campaign: the budget clamps the chunk to 96
    (2000, 780, 100),
    (250, 20000, 100),  # budget 75: 4 chunks, 300 passes
    (7, 300, 100),  # fewer passes than a chunk
    (7, 300, 3),  # rounded up to 9 passes
    (1, 1, 100),
])
def test_chunking_is_the_jax_arithmetic(monkeypatch, mc_times, n, chunk):
    """The chunk the JAX sampler hands its jitted body, and that body's
    ``n_chunks = ceil(mc_times / chunk)``."""
    seen = {}
    monkeypatch.setattr(jax_mc, "_mc_dropout_jit", lambda *a, **kw: seen.update(kw))
    jax_mc.mc_dropout_samples({}, np.zeros((n, 8), np.float32), None, mc_times=mc_times,
                              chunk=chunk)
    want = (seen["chunk"], -(-mc_times // seen["chunk"]))
    assert mc_chunking(mc_times, n, chunk) == want
    if (mc_times, n) == (2000, 15600):
        assert want == (96, 21)


def test_statistics_divide_by_the_passes_run(setup):
    """7 passes in chunks of 3 run 9: the same draws, the same statistics as
    asking for 9."""
    _, _, mlp, x = setup
    with one_thread():
        a, a_passes = mc_dropout_samples(mlp, x, _gen(5), mc_times=7, dropout=0.4, chunk=3)
        b, b_passes = mc_dropout_samples(mlp, x, _gen(5), mc_times=9, dropout=0.4, chunk=3)
    assert a_passes == b_passes == 9
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_no_dropout_matches_jax(setup):
    jm, x, mlp, xt = setup
    want = jax_mc.mc_dropout_samples(jm, x, jax.random.PRNGKey(7), mc_times=20, dropout=0.0)
    got, passes = mc_dropout_samples(mlp, xt, _gen(3), mc_times=20, dropout=0.0, chunk=8)
    assert passes == 24
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name)
    assert not got.epistemic_std.any()


@pytest.fixture(scope="module")
def dropout_runs(setup):
    jm, x, mlp, xt = setup
    jax_run = jax_mc.mc_dropout_samples(jm, x, jax.random.PRNGKey(7), mc_times=800,
                                        dropout=0.4, chunk=100)
    port, _ = mc_dropout_samples(mlp, xt, _gen(7), mc_times=800, dropout=0.4, chunk=100)
    loop = mc_dropout_samples_loop(mlp, xt, _gen(8), mc_times=800, dropout=0.4)
    return jax_run, port, loop


def _mean_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean(np.abs(a - b) / (0.5 * (a + b) + 1e-9)))


@pytest.mark.parametrize("against", ["jax", "loop"])
def test_statistical_parity(dropout_runs, against):
    jax_run, port, loop = dropout_runs
    other = jax_run if against == "jax" else loop
    np.testing.assert_allclose(port.pred_mean.numpy(), np.asarray(other.pred_mean),
                               rtol=1e-5, atol=1e-7)
    assert _mean_rel(port.epistemic_std, other.epistemic_std) < 0.15
    assert _mean_rel(port.aleatoric_std, other.aleatoric_std) < 0.1


def test_deterministic_given_generator_seed(setup):
    _, _, mlp, x = setup
    with one_thread():
        a, _ = mc_dropout_samples(mlp, x, _gen(11), mc_times=32, dropout=0.4, chunk=8)
        b, _ = mc_dropout_samples(mlp, x, _gen(11), mc_times=32, dropout=0.4, chunk=8)
        c, _ = mc_dropout_samples(mlp, x, _gen(12), mc_times=32, dropout=0.4, chunk=8)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a.epistemic_std, c.epistemic_std)


def test_sampler_rejects_bad_arguments(setup):
    _, _, mlp, x = setup
    with pytest.raises(ValueError, match="mc_times"):
        mc_dropout_samples(mlp, x, _gen(0), mc_times=0)
    with pytest.raises(ValueError, match="dropout"):
        mc_dropout_samples(mlp, x, _gen(0), mc_times=2, dropout=1.0)


@pytest.fixture(scope="module")
def small_campaign():
    normal, faults = synthesize_stack_data(n_normal=100, n_fault=10, seed=42)
    return combine_and_normalize(normal, faults, device="cpu")


@pytest.mark.parametrize("layers,want", [((8, 256, 256, 256, 1), "kernel"),
                                         ((8, 32, 32, 1), "vmap"),
                                         ((8, 256, 256, 256, 256, 1), "vmap")])
def test_auto_picks_by_topology(small_campaign, layers, want):
    """The exporter takes the kernel for the flagship and the sampler for any
    other topology, and reports the passes it ran: 101 asked, 101 for the
    kernel, two whole chunks of 100 for the sampler."""
    params = init_pinn(layers, generator=torch.Generator().manual_seed(0), device="cpu")
    with one_thread():
        _, info = export.build_comprehensive_results(params, small_campaign, mc_seed=5,
                                                     mc_times=101, smooth_window=10)
    assert info == {"sampler": want, "mc_passes": 200 if want == "vmap" else 101}


@pytest.mark.parametrize("layers", [(8, 256, 256, 256, 1), (8, 32, 32, 1)])
def test_export_auto_takes_the_sampler_of_its_topology_on_the_cpu(monkeypatch, small_campaign,
                                                                  layers):
    """The exporter calls the kernel wrapper for the flagship and the
    ``torch.Generator`` sampler for any other, never both, and counts no
    kernel launch on the CPU; the same seed gives the same artifact."""
    params = init_pinn(layers, generator=torch.Generator().manual_seed(0), device="cpu")
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(export, "mc_dropout", spy("kernel", export.mc_dropout))
    monkeypatch.setattr(export, "mc_dropout_samples", spy("vmap", export.mc_dropout_samples))
    kw = dict(mc_seed=5, mc_times=3, smooth_window=10)
    before = dict(build.LAUNCHES)
    with one_thread():
        a, info = export.build_comprehensive_results(params, small_campaign, **kw)
        b, _ = export.build_comprehensive_results(params, small_campaign, **kw)
    assert build.LAUNCHES == before
    assert calls == [info["sampler"]] * 2
    assert info["sampler"] == ("kernel" if params["mlp"].is_flagship() else "vmap")
    assert np.array_equal(a.array, b.array, equal_nan=True)
    assert np.isfinite(a.array[:, 10:12]).all()


def test_pipelines_report_the_sampler(small_campaign, tmp_path):
    from pinnfc_tpu_torch.config import ModelConfig, StageConfig, TrainConfig
    from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline

    cfg = dataclasses.replace(
        TrainConfig(), model=ModelConfig(layers=(8, 16, 16, 16, 1)), mc_times=5,
        smooth_window=10, schedule=(StageConfig("dnn", 3, lr=0.01),))
    with one_thread():
        res = run_training_pipeline(cfg, dataset=small_campaign, device="cpu")
    # 5 passes fit one chunk: none added
    assert res.export == {"sampler": "vmap", "mc_passes": 5}
