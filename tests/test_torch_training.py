"""Port parity for the training slice: the λ stages and run_schedule
(pinnfc_tpu_torch.training.stages) against the JAX package's, the training
pipeline, the checkpoints it writes, and the ``train``/``score`` command line.

The same synthetic campaign (numpy, seed 42, 300 normal rows) and the same
JAX-initialised params go through both packages on the CPU.  Tolerances:
- λ stages, 30 steps: losses rtol 2e-4, atol 1e-7 (float32 log/exp/pow in
  XLA and in torch differ in the last ulps, and the dnn_para=False loss is a
  squared difference of nearly equal numbers: observed 1e-4); λ rtol 2e-5,
  atol 1e-7 (observed 2.3e-6).
- run_schedule, 7 stages of 8 steps, dropout 0, DNN stages at lr 1e-3: loss
  traces rtol 2e-5 (observed 5e-6), λ rtol 2e-5; MLP weights rtol 1e-3,
  atol 1e-4 (Adam's normalized update magnifies rounding-level differences in
  near-zero gradient elements: observed 4.5e-5 on a few of 175k elements)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import pinnfc_tpu.config as jax_config
from pinnfc_tpu.data.combine import combine_and_normalize as jax_combine
from pinnfc_tpu.data.contract import load_comprehensive_results as jax_load_results
from pinnfc_tpu.diagnosis import run_gmm_pipeline
from pinnfc_tpu.models.mlp import mlp_forward
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu.risk import run_risk_pipeline
from pinnfc_tpu.training import stages as jax_stages
from pinnfc_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.cli._common import _small_schedule
from pinnfc_tpu_torch.config import TrainConfig, default_schedule, train_config_to_dict
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.contract import load_comprehensive_results
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, init_pinn
from pinnfc_tpu_torch.pipeline.export import default_mc_seed
from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
from pinnfc_tpu_torch.training import stages
from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy
from pinnfc_tpu_torch.utils.threads import one_thread


@pytest.fixture(scope="module")
def campaign():
    normal, faults = synthesize_stack_data(n_normal=300, n_fault=40, seed=42)
    jds = jax_combine(normal, faults)
    ds = combine_and_normalize(normal, faults, device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_pinn(jax.random.PRNGKey(0)))
    return jds, ds, jparams


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.mark.parametrize("dnn_para", [False, True])
def test_lambda_v_stage_matches_jax(campaign, dnn_para):
    jds, ds, jp = campaign
    u = np.asarray(mlp_forward(jp["mlp"], jds.x_train, train=False)[0])
    want = jax_stages.train_lambda_v_stage(
        jp["lam_v"], jds.x_train, jds.y_train, u, jds.scaler_x, jds.scaler_y, n_iter=30,
        lr=1e-3, lr_step=10, lr_gamma=0.8, dnn_para=dnn_para)
    got = stages.train_lambda_v_stage(_t(jp["lam_v"]), ds.x_train, ds.y_train, _t(u),
                                      ds.scaler_x, ds.scaler_y, 30, lr=1e-3, lr_step=10,
                                      lr_gamma=0.8, dnn_para=dnn_para)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=2e-5,
                               atol=1e-7)


@pytest.mark.parametrize("group,lr,clamped", [
    ("lam_t", 1.0, False), ("lam_h", 0.1, False), ("lam_o", 0.01, False),
    ("lam_h", 30.0, True), ("lam_o", 5.0, True),
])
def test_residual_stage_matches_jax(campaign, group, lr, clamped):
    jds, ds, jp = campaign
    want = jax_stages.train_residual_stage(jp[group], jds.x_train, jds.scaler_x, group,
                                           n_iter=30, lr=lr, lr_step=10, lr_gamma=0.8)
    got = stages.train_residual_stage(_t(jp[group]), ds.x_train, ds.scaler_x, group, 30, lr,
                                      lr_step=10, lr_gamma=0.8)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=2e-5,
                               atol=1e-7)
    lo, hi = LAMBDA_BOUNDS[group]
    lam = got.params.numpy()
    assert ((lam >= lo) & (lam <= hi)).all()
    assert bool(((lam == lo) | (lam == hi)).any()) == clamped


def _tiny_schedule(dnn_lr=None, n_iter=8):
    return tuple(dataclasses.replace(s, n_iter=n_iter, lr_step=3,
                                     lr=dnn_lr if dnn_lr and s.name == "dnn" else s.lr)
                 for s in default_schedule())


def test_run_schedule_matches_jax(campaign):
    jds, ds, jp = campaign
    sched = _tiny_schedule(dnn_lr=1e-3)
    jsched = tuple(jax_config.StageConfig(**dataclasses.asdict(s)) for s in sched)
    jparams, jlog = jax_stages.run_schedule(jp, jds.x_train, jds.y_train, jds.scaler_x,
                                            jds.scaler_y, schedule=jsched, dropout_p=0.0)
    params, log = stages.run_schedule(params_from_jax(jp, device="cpu"), ds.x_train,
                                      ds.y_train, ds.scaler_x, ds.scaler_y, schedule=sched,
                                      seed=3, dropout_p=0.0)
    assert [n for n, _ in log.stages] == [n for n, _ in jlog.stages]
    for (name, a), (_, b) in zip(jlog.stages, log.stages):
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-5, err_msg=name)
    got = params_to_numpy(params)
    for g in ("lam_v", "lam_t", "lam_h", "lam_o"):
        np.testing.assert_allclose(got[g], np.asarray(jparams[g]), rtol=2e-5, err_msg=g)
    want_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams["mlp"]))
    for a, b in zip(jax.tree_util.tree_leaves(got["mlp"]), want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    assert set(log.final_losses()) == {n for n, _ in log.stages}
    assert len(log.seconds) == 7


def test_dnn_stage_seed():
    seeds = [stages.dnn_stage_seed(42, k) for k in range(7)]
    assert len(set(seeds)) == 7
    assert all(0 <= s < 2**31 for s in seeds)
    assert stages.dnn_stage_seed(42, 0) == int(np.random.RandomState([42, 0]).randint(0, 2**31 - 1))
    assert default_mc_seed(42) not in seeds


def test_resume_reproduces_the_uninterrupted_run(campaign, tmp_path):
    """Run stages 0-2, 'crash', rerun the whole schedule on the same snapshot
    dir: it resumes at stage 3 (a DNN stage, with dropout on, so its seed must
    depend on the stage index alone) and ends where an uninterrupted run
    ends."""
    _, ds, _ = campaign
    sched = _tiny_schedule(n_iter=4)
    args = (ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y)

    def fresh():
        return init_pinn(generator=torch.Generator().manual_seed(1), device="cpu")

    ck = str(tmp_path / "resume")
    with one_thread():
        full, _ = stages.run_schedule(fresh(), *args, schedule=sched, seed=5)
        stages.run_schedule(fresh(), *args, schedule=sched[:3], seed=5, checkpoint_dir=ck)
        resumed, log = stages.run_schedule(fresh(), *args, schedule=sched, seed=5,
                                           checkpoint_dir=ck)
    assert [n for n, _ in log.stages] == ["3:dnn", "4:thermal", "5:hydrogen", "6:oxygen"]
    a, b = params_to_numpy(full), params_to_numpy(resumed)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="only 3 stages"):
        stages.run_schedule(fresh(), *args, schedule=sched[:3], seed=5, checkpoint_dir=ck)


def test_training_pipeline_on_cpu_feeds_the_jax_consumers(tmp_path):
    cfg = dataclasses.replace(TrainConfig(), schedule=_tiny_schedule(n_iter=10), mc_times=8,
                              smooth_window=50)
    mat = str(tmp_path / "F01_output.mat")
    res = run_training_pipeline(cfg, mat_path=mat, n_normal=300, n_fault=40, device="cpu")
    arr = res.results.array
    assert arr.shape == (780, 22)
    assert set(res.timings) == {"data_s", "train_s", "export_s"}
    assert {f"final_loss/{k}:{s.name}" for k, s in enumerate(cfg.schedule)} <= set(res.metrics)
    loaded = jax_load_results(mat)
    np.testing.assert_array_equal(loaded.array, arr)
    gmm = run_gmm_pipeline(loaded)
    assert gmm.y_prob.shape[1] == 4
    np.testing.assert_allclose(gmm.y_prob.sum(axis=1), 1.0, atol=1e-6)
    risk = run_risk_pipeline(loaded)
    assert len(risk) == 12
    # the checkpoint of this run loads in both packages
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, res.params, res.dataset.scaler_x, res.dataset.scaler_y,
                    meta={"config": train_config_to_dict(cfg)})
    jck = jax_load_checkpoint(ck)
    back = load_checkpoint(ck, device="cpu")
    mine = params_to_numpy(res.params)
    for tree in (jck["params"], params_to_numpy(back["params"])):
        for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_cli_train_then_score_reproduces_the_artifact(tmp_path, capsys):
    ck, mat, scored = (str(tmp_path / n) for n in ("ck", "train.mat", "scored.mat"))
    with one_thread():
        assert cli.main(["train", "--device", "cpu", "--small", "--n-normal", "300",
                         "--n-fault", "40", "--ckpt", ck, "--mat-out", mat]) == 0
    out = capsys.readouterr().out
    assert "identified physics parameters" in out and "train_s" in out
    with open(ck + ".meta.json") as f:
        meta = json.load(f)
    assert {"config", "n_normal", "n_fault", "created", "metrics"} <= set(meta)
    assert (meta["n_normal"], meta["n_fault"]) == (300, 40)
    assert [s["n_iter"] for s in meta["config"]["schedule"]] == \
        [s.n_iter for s in _small_schedule()]
    with one_thread():
        assert cli.main(["score", "--ckpt", ck, "--device", "cpu", "--mat-out", scored]) == 0
    a = load_comprehensive_results(mat).array
    b = load_comprehensive_results(scored).array
    assert a.shape == (780, 22)
    assert np.array_equal(a, b, equal_nan=True)


def test_cli_score_takes_the_campaign_size_from_the_sidecar(campaign, tmp_path):
    """A checkpoint trained on 300 normal + 12 x 40 fault rows is scored on
    that campaign (780 rows), not on the default 15,600."""
    _, ds, jp = campaign
    ck = str(tmp_path / "ck")
    cfg = dataclasses.replace(TrainConfig(), mc_times=4, smooth_window=50)
    save_checkpoint(ck, params_from_jax(jp, device="cpu"), ds.scaler_x, ds.scaler_y,
                    meta={"config": train_config_to_dict(cfg), "n_normal": 300,
                          "n_fault": 40})
    mat = str(tmp_path / "s.mat")
    assert cli.main(["score", "--ckpt", ck, "--device", "cpu", "--mc-times", "2",
                     "--mat-out", mat]) == 0
    assert load_comprehensive_results(mat).array.shape == (780, 22)
    assert cli.main(["score", "--ckpt", ck, "--device", "cpu", "--mc-times", "2",
                     "--n-fault", "10", "--mat-out", mat]) == 0
    assert load_comprehensive_results(mat).array.shape == (420, 22)


def test_cli_train_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    mat = str(tmp_path / "x.mat")
    assert cli.main(["train", "--small", "--n-normal", "100", "--n-fault", "10",
                     "--mat-out", mat]) != 0
    assert not os.path.exists(mat)
