"""Port parity: the DNN stage for any topology
(pinnfc_tpu_torch.training.stages.train_dnn_autograd: the dropout forward of
``MLP``, autograd, Adam + StepLR) against the JAX XLA scan
``pinnfc_tpu.training.stages.train_dnn_stage`` and against the training
kernel's plain version, and the choice of stage by topology.

Tolerances:
- against JAX with dropout 0 on (8, 32, 32, 32, 1), 20 steps: losses rtol
  2e-5, weights rtol 1e-3 and atol 1e-4, as test_run_schedule_matches_jax
  holds them (float32 matmuls in XLA and in torch; Adam's normalised update
  magnifies rounding in near-zero gradient elements);
- against ``train_dnn_stage_plain`` at dropout 0.2 under the same hash masks,
  20 steps: losses rtol 1e-5 (atol 1e-7), weights rtol 1e-4 and atol 1e-6
  (``h / (1 − p)`` against ``h · float32(1 / (1 − p))`` in the last ulp, and
  autograd's summation order against the hand-derived backward's);
- everything inside the autograd stage bitwise: chunks against the whole
  stage, a killed and resumed schedule against the uninterrupted one (under
  one pinned CPU thread, ``utils/threads.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_campaign import campaign  # noqa: F401  (fixture)
from pinnfc_tpu.models.mlp import init_mlp
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu.training.stages import train_dnn_stage as jax_train_dnn_stage
from pinnfc_tpu_torch.config import default_schedule
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.training import stages
from pinnfc_tpu_torch.utils import checkpoint as ckpt_mod
from pinnfc_tpu_torch.utils.jax_params import (
    mlp_from_jax, mlp_to_numpy, params_from_jax, params_to_numpy)
from pinnfc_tpu_torch.utils.threads import one_thread

DEEP = (8, 32, 32, 32, 1)
HP = dict(lr=1e-2, lr_step=5, lr_gamma=0.5)


@pytest.fixture(scope="module")
def setup():
    jm = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(2), DEEP))
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (300, 8)).astype(np.float32)
    y = rs.uniform(-1, 1, (300, 1)).astype(np.float32)
    return jm, x, y


def _port(jm):
    return mlp_from_jax(jm, device="cpu")


def _weights_equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(td.mlp_weights(a), td.mlp_weights(b)))


def test_matches_jax_without_dropout(setup):
    jm, x, y = setup
    want = jax_train_dnn_stage(jm, x, y, jax.random.PRNGKey(0), n_iter=20, dropout_p=0.0, **HP)
    got = stages.train_dnn_stage(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 0, 20,
                                 dropout_p=0.0, **HP)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=2e-5)
    want_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want.params))
    for a, b in zip(jax.tree_util.tree_leaves(mlp_to_numpy(got.params)), want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_matches_the_plain_kernel_version_under_the_hash_masks(setup):
    jm, x, y = setup
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    with one_thread():
        a = stages.train_dnn_autograd(_port(jm), xt, yt, 7, 20, dropout_p=0.2, **HP)
        b = td.train_dnn_stage_plain(_port(jm), xt, yt, 7, 20, dropout_p=0.2, **HP)
    torch.testing.assert_close(a.losses, b.losses, rtol=1e-5, atol=1e-7)
    for u, v in zip(td.mlp_weights(a.mlp), td.mlp_weights(b.mlp)):
        torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-6)
    assert int(a.state.count) == int(b.state.count) == 20
    torch.testing.assert_close(a.state.m, b.state.m, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("layers,flagship", [((8, 256, 256, 256, 1), True),
                                              (DEEP, False), ((8, 16, 16, 1), False)])
def test_the_stage_is_chosen_by_topology(setup, layers, flagship):
    """``train_dnn_stage`` and ``train_dnn_chunk``: the training kernel's
    wrapper (its plain version on the CPU) for the flagship, the autograd
    stage for any other — bitwise the function they name."""
    _, x, y = setup
    xt, yt = torch.as_tensor(x[:64]), torch.as_tensor(y[:64])
    mlp = init_pinn(layers, generator=torch.Generator().manual_seed(0), device="cpu")["mlp"]
    direct = td.train_dnn if flagship else stages.train_dnn_autograd
    with one_thread():
        want = direct(mlp, xt, yt, 3, 4, dropout_p=0.2, **HP)
        got = stages.train_dnn_stage(mlp, xt, yt, 3, 4, dropout_p=0.2, **HP)
        piece, state, losses = stages.train_dnn_chunk(mlp, None, xt, yt, 3, 0, 4,
                                                      dropout_p=0.2, **HP)
    assert torch.equal(got.losses, want.losses) and torch.equal(losses, want.losses)
    assert _weights_equal(got.params, want.mlp) and _weights_equal(piece, want.mlp)
    assert torch.equal(state.m, want.state.m)


@pytest.mark.parametrize("split", [(7, 6, 7), (1, 19), (20,)])
def test_chunks_equal_the_whole_stage(setup, split):
    jm, x, y = setup
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    with one_thread():
        whole = stages.train_dnn_stage(_port(jm), xt, yt, 11, sum(split), dropout_p=0.2, **HP)
        piece, state, got, start = _port(jm), None, [], 0
        for m in split:
            piece, state, losses = stages.train_dnn_chunk(piece, state, xt, yt, 11, start, m,
                                                          dropout_p=0.2, **HP)
            got.append(losses)
            start += m
    assert torch.equal(torch.cat(got), whole.losses)
    assert _weights_equal(piece, whole.params)
    assert int(state.count) == sum(split)


def test_skip_nonfinite_keeps_weights_and_adam_count(setup):
    jm, x, y = setup
    x_nan = x.copy()
    x_nan[17, 3] = np.nan
    xt, yt = torch.as_tensor(x_nan), torch.as_tensor(y)
    out = stages.train_dnn_autograd(_port(jm), xt, yt, 0, 5, dropout_p=0.2,
                                    skip_nonfinite=True, **HP)
    assert bool(torch.isnan(out.losses).all())
    assert _weights_equal(out.mlp, _port(jm))
    assert int(out.state.count) == 0 and not out.state.m.any()
    poisoned = stages.train_dnn_autograd(_port(jm), xt, yt, 0, 2, dropout_p=0.2, **HP)
    assert not all(bool(torch.isfinite(w).all()) for w in td.mlp_weights(poisoned.mlp))


def test_rejects_bad_inputs(setup):
    jm, x, y = setup
    mlp = _port(jm)
    xt, yt = torch.as_tensor(x[:10]), torch.as_tensor(y[:10])
    with pytest.raises(ValueError):
        stages.train_dnn_autograd(mlp, torch.zeros(10, 7), yt, 0, 2)
    with pytest.raises(ValueError):
        stages.train_dnn_autograd(mlp, xt, yt, 0, 0)
    with pytest.raises(ValueError, match="t0"):
        stages.train_dnn_autograd(mlp, xt, yt, 0, 2, t0=-1)
    with pytest.raises(ValueError):
        stages.train_dnn_autograd(mlp, xt, yt, 0, 2, dropout_p=1.0)


def test_a_four_hidden_layer_jax_tree_crosses_both_ways():
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init_pinn(jax.random.PRNGKey(5), (8, 256, 256, 256, 256, 1)))
    params = params_from_jax(tree, device="cpu")
    assert params["mlp"].layers == (8, 256, 256, 256, 256, 1)
    assert not params["mlp"].is_flagship()
    back = params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _deep_sched():
    """The default dnn and lambda_v stages, 8 steps each, the staircase
    turning every 3 steps."""
    return tuple(dataclasses.replace(s, n_iter=8, lr_step=3) for s in default_schedule()[:2])


@pytest.mark.parametrize("kill_after,resume_every", [(2, 3), (5, None)])
def test_kill_and_resume_of_a_non_flagship_schedule(campaign, tmp_path, monkeypatch,  # noqa: F811
                                                    kill_after, resume_every):
    """A (8, 32, 32, 32, 1) schedule in chunks of 3, killed after its 2nd
    snapshot (inside the DNN stage) or its 5th (inside the λ stage) and
    restarted: params and stitched losses equal the uninterrupted run's."""
    ds = campaign.ds
    args = (ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y)

    def fresh():
        return init_pinn(DEEP, generator=torch.Generator().manual_seed(1), device="cpu")

    real_save = ckpt_mod.save_params_npz
    calls = {"n": 0}

    def killing_save(payload, path):
        real_save(payload, path)
        calls["n"] += 1
        if calls["n"] == kill_after:
            raise KeyboardInterrupt("simulated preemption")

    ck = str(tmp_path / "killed")
    with one_thread():
        full, full_log = stages.run_schedule(fresh(), *args, schedule=_deep_sched(), seed=5,
                                             ckpt_every=3)
        monkeypatch.setattr(ckpt_mod, "save_params_npz", killing_save)
        with pytest.raises(KeyboardInterrupt):
            stages.run_schedule(fresh(), *args, schedule=_deep_sched(), seed=5,
                                checkpoint_dir=ck, ckpt_every=3)
        monkeypatch.setattr(ckpt_mod, "save_params_npz", real_save)
        resumed, log = stages.run_schedule(fresh(), *args, schedule=_deep_sched(), seed=5,
                                           checkpoint_dir=ck, ckpt_every=resume_every)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(full)),
                    jax.tree_util.tree_leaves(params_to_numpy(resumed))):
        np.testing.assert_array_equal(a, b)
    traces = dict(full_log.stages)
    for name, losses in log.stages:
        np.testing.assert_array_equal(losses, traces[name])
