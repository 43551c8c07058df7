"""Port parity for chunked stages and mid-stage resume: the chunk drivers of
``pinnfc_tpu_torch.training.stages`` against the JAX package's, the training
kernel's plain version run in chunks (start step ``t0`` and carried Adam
state), and ``run_schedule(ckpt_every=)`` killed at a chunk boundary and
resumed.

Tolerances: the chunked λ stages against the JAX chunk drivers as
``tests/test_torch_training.py`` holds the λ stages (losses rtol 2e-4, atol
1e-7; λ rtol 2e-5, atol 1e-7).  Everything inside the port is compared
bitwise: a chunked stage takes the same float32 operations as the whole
stage, and a resumed run the same as the uninterrupted one (under one pinned
CPU thread, ``utils/threads.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_campaign import campaign  # noqa: F401  (fixture)
from pinnfc_tpu.data import campaign as jax_campaign
from pinnfc_tpu.training import stages as jax_stages
from pinnfc_tpu.utils.checkpoint import save_params_npz as jax_save_params_npz
from pinnfc_tpu_torch.config import default_schedule
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.training import stages
from pinnfc_tpu_torch.training.adam import (
    AdamState, adam_state_from_numpy, adam_tree_from_optax)
from pinnfc_tpu_torch.utils import checkpoint as ckpt_mod
from pinnfc_tpu_torch.utils.jax_params import params_to_numpy
from pinnfc_tpu_torch.utils.threads import one_thread

# the λ stages as the default schedule has them: (group, lr, lr_gamma, dnn_para)
LAMBDA_STAGES = {
    "lambda_v": ("lam_v", 1e-3, 0.8, False),
    "lambda_v_dnn_para": ("lam_v", 1e-3, 0.8, True),
    "thermal": ("lam_t", 1.0, 0.8, None),
    "hydrogen": ("lam_h", 0.1, 0.9, None),
    "oxygen": ("lam_o", 0.01, 0.9, None),
}
CHUNKS = (7, 7, 7, 9)  # 30 steps; the staircase (lr_step 10) turns inside chunks


def _sched(names=("dnn", "lambda_v"), n_iter=8):
    """Stages of the default schedule in order, each cut to ``n_iter`` steps,
    with the staircase turning every 3 steps."""
    picked, want = [], list(names)
    for s in default_schedule():
        if want and s.name == want[0]:
            picked.append(dataclasses.replace(s, n_iter=n_iter, lr_step=3))
            want.pop(0)
    return tuple(picked)


def _leaves(params):
    return jax.tree_util.tree_leaves(params_to_numpy(params))


def _assert_params_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(LAMBDA_STAGES))
def test_lambda_chunks_match_jax(campaign, name):  # noqa: F811
    group, lr, gamma, dnn_para = LAMBDA_STAGES[name]
    ds = campaign.ds
    jds = jax_campaign.load_campaign_dataset(jax_campaign.CampaignConfig.from_dir(
        campaign.config.normal_path, campaign.ascii_dir))
    params = campaign.params()
    lam0 = params[group]
    hp = dict(lr=lr, lr_step=10, lr_gamma=gamma)
    with torch.no_grad():
        u = params["mlp"](ds.x_train)[0]
    jlam, jstate, jlosses = np.asarray(lam0.numpy()), None, []
    lam, state, losses = lam0, None, []
    for m in CHUNKS:
        if jstate is None:
            jstate = jax_stages._opt_init(jlam, **hp)
        if dnn_para is None:
            jlam, jstate, jl = jax_stages.train_residual_chunk(
                jlam, jstate, jds.x_train, jds.scaler_x, group, length=m, **hp)
            lam, state, pl = stages.train_residual_chunk(lam, state, ds.x_train, ds.scaler_x,
                                                         group, m, **hp)
        else:
            jlam, jstate, jl = jax_stages.train_lambda_v_chunk(
                jlam, jstate, jds.x_train, jds.y_train, u.numpy(), jds.scaler_x, jds.scaler_y,
                length=m, dnn_para=dnn_para, **hp)
            lam, state, pl = stages.train_lambda_v_chunk(
                lam, state, ds.x_train, ds.y_train, u, ds.scaler_x, ds.scaler_y, m,
                dnn_para=dnn_para, **hp)
        jlosses.append(np.asarray(jl))
        losses.append(pl.numpy())
    assert int(state.count) == sum(CHUNKS) == int(jstate[0].count)
    np.testing.assert_allclose(np.concatenate(losses), np.concatenate(jlosses), rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=2e-5, atol=1e-7)
    with one_thread():  # the chunks take the whole stage's steps, bit for bit
        if dnn_para is None:
            whole = stages.train_residual_stage(lam0, ds.x_train, ds.scaler_x, group,
                                                sum(CHUNKS), **hp)
        else:
            whole = stages.train_lambda_v_stage(lam0, ds.x_train, ds.y_train, u, ds.scaler_x,
                                                ds.scaler_y, sum(CHUNKS), dnn_para=dnn_para,
                                                **hp)
    np.testing.assert_array_equal(np.concatenate(losses), whole.losses.numpy())
    np.testing.assert_array_equal(lam.numpy(), whole.params.numpy())


@pytest.mark.parametrize("split", [(5, 7), (4, 4, 4), (1, 11)])
def test_dnn_chunks_equal_the_whole_stage(campaign, split):  # noqa: F811
    """The training kernel's plain version from step t0 with the carried Adam
    state: its chunks equal the whole stage bitwise, and each chunk equals the
    tail of the whole stage from its start step (masks, staircase, bias
    correction)."""
    ds, mlp = campaign.ds, campaign.params()["mlp"]
    hp = dict(lr=0.01, lr_step=3, lr_gamma=0.5, dropout_p=0.2)
    with one_thread():
        whole = td.train_dnn_stage_plain(mlp, ds.x_train, ds.y_train, 11, sum(split), **hp)
        piece, state, losses, t0 = mlp, None, [], 0
        for m in split:
            piece, got, state = td.train_dnn_stage_plain(piece, ds.x_train, ds.y_train, 11, m,
                                                         t0=t0, state=state, **hp)
            np.testing.assert_array_equal(got.numpy(), whole.losses[t0:t0 + m].numpy())
            losses.append(got)
            t0 += m
    assert int(state.count) == sum(split) == int(whole.state.count)
    assert torch.equal(torch.cat(losses), whole.losses)
    for a, b in zip(td.mlp_weights(piece), td.mlp_weights(whole.mlp)):
        assert torch.equal(a, b)
    assert torch.equal(state.m, whole.state.m) and torch.equal(state.v, whole.state.v)
    assert torch.equal(td.flat_weights(whole.mlp), td.flat_weights(piece))


def test_dnn_chunk_checks_the_carried_state(campaign):  # noqa: F811
    ds, mlp = campaign.ds, campaign.params()["mlp"]
    x, y = ds.x_train[:20], ds.y_train[:20]
    size = td.flat_weights(mlp).numel()
    good = AdamState(torch.zeros(size), torch.zeros(size), torch.zeros((), dtype=torch.int64))
    for bad in (good._replace(m=torch.zeros(size - 1)), good._replace(v=torch.zeros(size).double()),
                good._replace(count=torch.zeros(2, dtype=torch.int64))):
        with pytest.raises(ValueError, match="state"):
            td.train_dnn(mlp, x, y, 0, 2, state=bad)
    with pytest.raises(ValueError, match="t0"):
        td.train_dnn(mlp, x, y, 0, 2, t0=-1)


def test_run_schedule_chunked_equals_monolithic(campaign):  # noqa: F811
    ds = campaign.ds
    sched = _sched(("dnn", "lambda_v", "lambda_v", "dnn", "thermal", "hydrogen", "oxygen"))
    args = (ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y)
    with one_thread():
        mono, mlog = stages.run_schedule(campaign.params(), *args, schedule=sched, seed=5)
        chunked, clog = stages.run_schedule(campaign.params(), *args, schedule=sched, seed=5,
                                            ckpt_every=3)
    _assert_params_equal(mono, chunked)
    assert [n for n, _ in clog.stages] == [n for n, _ in mlog.stages]
    for (_, a), (_, b) in zip(mlog.stages, clog.stages):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ckpt_every must be >= 1"):
        stages.run_schedule(campaign.params(), *args, schedule=sched, ckpt_every=0)


@pytest.mark.parametrize("kill_after,resume_every,where", [
    (2, 3, (0, 6)),  # inside the DNN stage, at step 6 of 8
    (5, 3, (1, 6)),  # inside the λ stage
    (2, None, (0, 6)),  # the restart omits ckpt_every: the stage still resumes mid-stage
    (5, None, (1, 6)),
])
def test_kill_and_resume_equals_the_uninterrupted_run(campaign, tmp_path, monkeypatch,  # noqa: F811
                                                      kill_after, resume_every, where):
    """Kill the run after its Nth chunk snapshot (chunks of 3 steps; each
    stage 3 + 3 + 2) and restart it on the same snapshot directory: the final
    params and the stitched loss traces equal the uninterrupted chunked run's,
    bit for bit."""
    ds = campaign.ds
    sched = _sched()
    args = (ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y)
    real_save = ckpt_mod.save_params_npz
    calls = {"n": 0}

    def killing_save(payload, path):
        real_save(payload, path)  # the snapshot lands, then the process dies
        calls["n"] += 1
        if calls["n"] == kill_after:
            raise KeyboardInterrupt("simulated preemption")

    ck = str(tmp_path / "killed")
    with one_thread():
        full, full_log = stages.run_schedule(campaign.params(), *args, schedule=sched, seed=5,
                                             checkpoint_dir=str(tmp_path / "full"),
                                             ckpt_every=3)
        monkeypatch.setattr(ckpt_mod, "save_params_npz", killing_save)
        with pytest.raises(KeyboardInterrupt):
            stages.run_schedule(campaign.params(), *args, schedule=sched, seed=5,
                                checkpoint_dir=ck, ckpt_every=3)
        monkeypatch.setattr(ckpt_mod, "save_params_npz", real_save)
        snap = ckpt_mod.load_params_npz(f"{ck}/schedule_ckpt.npz")
        resumed, log = stages.run_schedule(campaign.params(), *args, schedule=sched, seed=5,
                                           checkpoint_dir=ck, ckpt_every=resume_every)
    # without ckpt_every a finished stage's snapshot holds its params and index only
    final = ckpt_mod.load_params_npz(f"{ck}/schedule_ckpt.npz")
    assert ("step" in final) == (resume_every is not None)
    stage, step = where
    assert (int(snap["stage"]), int(snap["step"])) == (stage, step)
    opt = snap["opt"]
    assert str(opt["writer"]) == "pinnfc_tpu_torch" and int(opt["count"]) == step
    assert snap["losses"].shape == (step,)
    if stage == 0:  # the DNN stage's moments, in the MLP's JAX layout
        want = params_to_numpy(full)["mlp"]
        got = jax.tree_util.tree_map(np.shape, opt["m"])
        assert got == jax.tree_util.tree_map(np.shape, want)
    else:
        assert opt["m"].shape == opt["v"].shape == (4,)
    _assert_params_equal(full, resumed)
    assert [n for n, _ in log.stages] == [n for n, _ in full_log.stages][stage:]
    traces = dict(full_log.stages)
    for name, losses in log.stages:
        np.testing.assert_array_equal(losses, traces[name])


def _jax_snapshot(path, params, stage, step, n_iter_losses, opt_init=None):
    """A snapshot as the JAX package's run_schedule writes it: its optax state
    (an Adam state and a schedule count) under ``opt``, or ``opt_init(piece)``."""
    jparams = jax.tree_util.tree_map(np.asarray, params_to_numpy(params))
    piece = jparams["mlp"] if stage == 0 else jparams["lam_v"]
    payload = {"params": jparams, "stage": np.asarray(stage)}
    if step is not None:
        opt = (jax_stages._opt_init(piece, lr=0.01, lr_step=3, lr_gamma=0.8)
               if opt_init is None else opt_init(piece))
        payload.update(step=np.asarray(step), opt=opt,
                       losses=np.zeros(n_iter_losses, np.float32))
    jax_save_params_npz(payload, path)


@pytest.mark.parametrize("stage", [0, 1])
def test_a_jax_mid_stage_snapshot_is_refused(campaign, tmp_path, stage):  # noqa: F811
    """A mid-stage snapshot whose optimizer tree is neither the port's nor the
    JAX package's optax Adam state (here optax SGD with momentum) raises,
    naming the file."""
    import optax

    ds = campaign.ds
    path = tmp_path / "schedule_ckpt.npz"
    _jax_snapshot(str(path), campaign.params(), stage, 4, 4,
                  opt_init=optax.sgd(0.1, momentum=0.9).init)
    with pytest.raises(ValueError, match="optax") as e:
        stages.run_schedule(campaign.params(), ds.x_train, ds.y_train, ds.scaler_x,
                            ds.scaler_y, schedule=_sched(), checkpoint_dir=str(tmp_path))
    assert str(path) in str(e.value)


def test_adam_tree_from_optax_maps_the_jax_state():
    """The optax tree of ``_opt_init`` maps onto the port's payload; trees of
    another shape, or with the two counts apart, map to None."""
    lam = np.arange(4, dtype=np.float32)
    opt = jax_stages._opt_init(lam, lr=0.01, lr_step=3, lr_gamma=0.8)
    tree = [[np.asarray(opt[0].count) + 5, np.asarray(opt[0].mu) + 1, np.asarray(opt[0].nu) + 2],
            [np.asarray(opt[1].count) + 5]]
    got = adam_tree_from_optax(tree)
    state = adam_state_from_numpy(got, "cpu")
    assert int(state.count) == 5 and state.count.dtype == torch.int64
    np.testing.assert_array_equal(state.m.numpy(), np.ones(4, np.float32))
    np.testing.assert_array_equal(state.v.numpy(), np.full(4, 2, np.float32))
    assert adam_tree_from_optax([tree[0], [np.asarray(6)]]) is None
    assert adam_tree_from_optax([tree[0]]) is None
    assert adam_tree_from_optax({"m": 0}) is None


def _jax_resume_sched(names):
    """``_sched`` with the DNN stages at lr 1e-3, as
    ``tests/test_torch_training.py`` compares whole schedules at dropout 0."""
    return tuple(dataclasses.replace(s, lr=1e-3) if s.name == "dnn" else s
                 for s in _sched(names))


@pytest.mark.parametrize("names,kill_after,where", [
    (("dnn", "lambda_v"), 2, (0, 6)),  # inside the DNN stage, dropout 0
    (("dnn", "lambda_v"), 5, (1, 6)),  # inside the voltage-λ stage
    (("dnn", "lambda_v", "thermal"), 7, (2, 3)),  # inside the thermal stage
])
def test_a_jax_mid_stage_snapshot_resumes(campaign, tmp_path, monkeypatch,  # noqa: F811
                                          names, kill_after, where):
    """The JAX package's run_schedule (chunks of 3, dropout 0) is killed after
    its Nth chunk snapshot; the port and the JAX package each resume a copy
    of that snapshot and end at the same place: loss traces rtol 2e-5, λ rtol
    2e-5 (atol 1e-7), MLP weights rtol 1e-3 atol 1e-4, the tolerances of
    ``tests/test_torch_training.py::test_run_schedule_matches_jax``."""
    import shutil

    from pinnfc_tpu import config as jax_config
    from pinnfc_tpu.utils import checkpoint as jax_ckpt_mod

    ds = campaign.ds
    jds = jax_campaign.load_campaign_dataset(jax_campaign.CampaignConfig.from_dir(
        campaign.config.normal_path, campaign.ascii_dir))
    sched = _jax_resume_sched(names)
    jsched = tuple(jax_config.StageConfig(**dataclasses.asdict(s)) for s in sched)
    jparams0 = jax.tree_util.tree_map(np.asarray, params_to_numpy(campaign.params()))
    jargs = (jds.x_train, jds.y_train, jds.scaler_x, jds.scaler_y)
    real_save = jax_ckpt_mod.save_params_npz
    calls = {"n": 0}

    def killing_save(payload, path):
        real_save(payload, path)
        calls["n"] += 1
        if calls["n"] == kill_after:
            raise KeyboardInterrupt("simulated preemption")

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(jax_ckpt_mod, "save_params_npz", killing_save)
    with pytest.raises(KeyboardInterrupt):
        jax_stages.run_schedule(jparams0, *jargs, schedule=jsched, dropout_p=0.0,
                                checkpoint_dir=jax_dir, ckpt_every=3)
    monkeypatch.setattr(jax_ckpt_mod, "save_params_npz", real_save)
    shutil.copytree(jax_dir, port_dir)
    snap = ckpt_mod.load_params_npz(f"{port_dir}/schedule_ckpt.npz")
    assert (int(snap["stage"]), int(snap["step"])) == where
    assert not stages.is_port_adam_state(snap["opt"])

    jparams, jlog = jax_stages.run_schedule(jparams0, *jargs, schedule=jsched, dropout_p=0.0,
                                            checkpoint_dir=jax_dir)
    params, log = stages.run_schedule(campaign.params(), ds.x_train, ds.y_train, ds.scaler_x,
                                      ds.scaler_y, schedule=sched, seed=5, dropout_p=0.0,
                                      checkpoint_dir=port_dir)
    assert [n for n, _ in log.stages] == [n for n, _ in jlog.stages]
    assert [n for n, _ in log.stages][0] == f"{where[0]}:{sched[where[0]].name}"
    for (name, a), (_, b) in zip(jlog.stages, log.stages):
        assert b.shape == (sched[int(name.split(":")[0])].n_iter,)
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-5, err_msg=name)
    got = params_to_numpy(params)
    for g in ("lam_v", "lam_t", "lam_h", "lam_o"):
        np.testing.assert_allclose(got[g], np.asarray(jparams[g]), rtol=2e-5, atol=1e-7,
                                   err_msg=g)
    want_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams["mlp"]))
    for a, b in zip(jax.tree_util.tree_leaves(got["mlp"]), want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("step", [None, 8])
def test_a_jax_per_stage_snapshot_resumes(campaign, tmp_path, step):  # noqa: F811
    """A JAX snapshot written after stage 0 (per stage, or the last chunk of
    a chunked stage: step = n_iter) resumes at stage 1 from its params."""
    ds = campaign.ds
    params = campaign.params()
    params["lam_v"] = params["lam_v"] * 1.01
    _jax_snapshot(str(tmp_path / "schedule_ckpt.npz"), params, 0, step, 8)
    args = (ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y)
    with one_thread():
        got, log = stages.run_schedule(campaign.params(), *args, schedule=_sched(),
                                       checkpoint_dir=str(tmp_path))
        want, _ = stages.run_schedule(params, *args, schedule=_sched()[1:])
    assert [n for n, _ in log.stages] == ["1:lambda_v"]
    _assert_params_equal(got, want)
