"""Port parity: the DNN training stage (pinnfc_tpu_torch.ops.train_dnn, the
plain version of csrc/train_dnn.cu) against the TPU kernel
pinnfc_tpu.ops.pallas_train.train_dnn_pallas in interpret mode and against
the JAX scan trainer, at the flagship width.

Tolerances: the mask bits are integer arithmetic and match exactly.  Losses
against the TPU kernel: rtol 5e-4, atol 1e-5 (float32 sums in another order,
over 512-row blocks there); weights: rtol 1e-3, atol 1e-5 at lr 1e-3.  At the
schedule's lr 1e-2 the loss jumps to ~20 on step 2, and Adam's normalized
update turns a rounding-level difference in a near-zero gradient element into
a step of O(lr): there one element of 175k moves by 1.2e-4, and the JAX
package's own two trainers disagree by 5e-5 in the same setting, so the
weights are held at atol 3e-4.  The hand-derived gradients against autograd:
rtol 1e-4, atol 1e-8 (the loss is summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinnfc_tpu.models.mlp import init_mlp
from pinnfc_tpu.ops.pallas_mc_dropout import _random_bits
from pinnfc_tpu.ops.pallas_train import _flatten_weights, train_dnn_pallas
from pinnfc_tpu.training.stages import train_dnn_stage as jax_train_dnn_stage
from pinnfc_tpu_torch.models.mlp import aleatoric_loss, logvar_from_raw
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants, random_bits
from pinnfc_tpu_torch.training.adam import adam_init, adam_step
from pinnfc_tpu_torch.training.stages import train_dnn_stage
from pinnfc_tpu_torch.utils.jax_params import mlp_from_jax
from pinnfc_tpu_torch.utils.threads import one_thread

FLAGSHIP = (8, 256, 256, 256, 1)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (1024, 8)).astype(np.float32)
    y = rs.uniform(-1, 1, (1024, 1)).astype(np.float32)
    jm = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(0), FLAGSHIP))
    return jm, x, y


def _port(jm):
    return mlp_from_jax(jm, device="cpu")


def _assert_weights(mlp, jax_tree, rtol, atol):
    want = [np.asarray(w) for w in _flatten_weights(jax_tree)]
    for i, (got, w) in enumerate(zip(td.mlp_weights(mlp), want)):
        np.testing.assert_allclose(got.numpy(), w.reshape(got.shape), rtol=rtol, atol=atol,
                                   err_msg=f"weight tensor {i}")


@pytest.mark.parametrize("seed,t,blk", [(0, 0, 0), (5, 3, 1), (2**31 - 1, 7, 2),
                                        (2**31 - 2, 4001, 11)])
@pytest.mark.parametrize("layer,width", [(0, 256), (1, 256), (2, 256), (3, 128)])
def test_mask_bits_match_the_tpu_kernel(seed, t, blk, layer, width):
    u32 = jnp.uint32
    salt = u32(seed) * u32(2654435761) + u32(t) * u32(40503) + u32(blk) * u32(7919) + u32(layer)
    want = np.asarray(_random_bits((512, width), salt))
    rows = torch.arange(blk * 512, (blk + 1) * 512, dtype=torch.int64)
    row_salt = td.step_salts((blk + 1) * 512, seed, t, "cpu")[rows]
    got = random_bits(rows % 512, width, (row_salt + layer) & 0xFFFFFFFF).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    keep = td.keep_masks((blk + 1) * 512, [256, 256, 256, 128], seed, t,
                         dropout_constants(0.2)[0], "cpu")[layer][rows]
    np.testing.assert_array_equal(keep.numpy(), want >= np.uint32(int(0.2 * 2**32)))


@pytest.mark.parametrize("lr,w_atol", [(1e-3, 1e-5), (1e-2, 3e-4)])
def test_plain_matches_pallas_interpret(setup, lr, w_atol):
    jm, x, y = setup
    want = train_dnn_pallas(jm, x, y, seed=5, n_iter=6, lr=lr, lr_step=3, lr_gamma=0.5,
                            dropout_p=0.2, interpret=True)
    mlp, losses, _ = td.train_dnn_stage_plain(_port(jm), torch.as_tensor(x), torch.as_tensor(y),
                                           5, 6, lr=lr, lr_step=3, lr_gamma=0.5, dropout_p=0.2)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want.losses), rtol=5e-4, atol=1e-5)
    _assert_weights(mlp, want.params, rtol=1e-3, atol=w_atol)


def test_plain_matches_jax_scan_trainer_without_dropout_ragged(setup):
    """N = 1,000 is ragged against the 512-row mask blocks; with dropout off
    the JAX trainer's full-batch mean is the same objective."""
    jm, x, y = setup
    x, y = x[:1000], y[:1000]
    want = jax_train_dnn_stage(jm, x, y, jax.random.PRNGKey(1), n_iter=6, lr=1e-3, lr_step=3,
                               lr_gamma=0.5, dropout_p=0.0)
    mlp, losses, _ = td.train_dnn_stage_plain(_port(jm), torch.as_tensor(x), torch.as_tensor(y),
                                           9, 6, lr=1e-3, lr_step=3, lr_gamma=0.5, dropout_p=0.0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want.losses), rtol=5e-4, atol=1e-5)
    _assert_weights(mlp, want.params, rtol=1e-3, atol=1e-5)


def test_hand_derived_gradients_match_autograd(setup):
    jm, x, y = setup
    x, y = torch.as_tensor(x[:700]), torch.as_tensor(y[:700])
    mlp = _port(jm)
    thresh, inv_keep = dropout_constants(0.2)
    keep = td.keep_masks(700, [256, 256, 256, 128], 11, 2, thresh, "cpu")
    ws = [w.requires_grad_(True) for w in td.mlp_weights(mlp)]

    def drop(h, m):
        return torch.where(m, h * inv_keep, 0.0)

    h = x
    for i in range(3):
        h = drop(torch.tanh(h @ ws[2 * i] + ws[2 * i + 1]), keep[i])
    pred = h @ ws[6] + ws[7]
    v = drop(torch.tanh(h @ ws[8] + ws[9]), keep[3])
    v = torch.tanh(v @ ws[10] + ws[11])
    lv = logvar_from_raw(v @ ws[12] + ws[13])
    want_loss = aleatoric_loss(y, pred, lv)
    want = torch.autograd.grad(want_loss, ws)
    with torch.no_grad():
        loss, got = td.loss_and_grads([w.detach() for w in ws], x, y, keep, inv_keep,
                                      td._inv_n(700))
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-5, atol=1e-7)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-8, msg=f"gradient {i}")


def test_deterministic_given_seed(setup):
    jm, x, y = setup
    with one_thread():
        runs = [td.train_dnn_stage_plain(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 7,
                                         3, dropout_p=0.3) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b in zip(td.mlp_weights(runs[0][0]), td.mlp_weights(runs[1][0])):
        assert torch.equal(a, b)
    other = td.train_dnn_stage_plain(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 8, 3,
                                     dropout_p=0.3)
    assert not torch.equal(runs[0][1], other[1])


def test_skip_nonfinite_keeps_initial_weights_on_a_nan_row(setup):
    jm, x, y = setup
    x = x[:300].copy()
    x[17, 3] = np.nan
    mlp0 = _port(jm)
    mlp, losses, _ = td.train_dnn_stage_plain(mlp0, torch.as_tensor(x), torch.as_tensor(y[:300]),
                                           3, 4, dropout_p=0.2, skip_nonfinite=True)
    assert torch.isnan(losses).all()
    for a, b in zip(td.mlp_weights(mlp), td.mlp_weights(mlp0)):
        assert torch.equal(a, b)
    poisoned, _, _ = td.train_dnn_stage_plain(mlp0, torch.as_tensor(x), torch.as_tensor(y[:300]),
                                           3, 1, dropout_p=0.2)
    assert torch.isnan(td.mlp_weights(poisoned)[0]).any()


def test_skipped_step_does_not_advance_the_adam_count(setup, monkeypatch):
    """Step 1's gradient is poisoned.  The stage must then apply steps 0, 2, 3
    with Adam counts 0, 1, 2 (StepLR lr·0.5^count, lr_step 1), and masks
    of steps 0, 2, 3."""
    jm, x, y = setup
    xt, yt = torch.as_tensor(x[:300]), torch.as_tensor(y[:300])
    real = td.loss_and_grads
    calls = []

    def poisoned(*args):
        loss, grads = real(*args)
        calls.append(len(calls))
        if len(calls) == 2:
            grads[4] = grads[4].clone()
            grads[4][0, 0] = float("inf")
        return loss, grads

    monkeypatch.setattr(td, "loss_and_grads", poisoned)
    with one_thread():
        mlp, _, _ = td.train_dnn_stage_plain(_port(jm), xt, yt, 21, 4, lr=0.01, lr_step=1,
                                          lr_gamma=0.5, dropout_p=0.2, skip_nonfinite=True)
    monkeypatch.setattr(td, "loss_and_grads", real)

    thresh, inv_keep = dropout_constants(0.2)
    ws = td.mlp_weights(_port(jm))
    sizes = [w.numel() for w in ws]
    flat = torch.cat([w.reshape(-1) for w in ws])
    state = adam_init(flat)
    for t in (0, 2, 3):
        views = [v.view(w.shape) for v, w in zip(torch.split(flat, sizes), ws)]
        keep = td.keep_masks(300, [256, 256, 256, 128], 21, t, thresh, "cpu")
        with one_thread():
            _, grads = real(views, xt, yt, keep, inv_keep, td._inv_n(300))
        flat, state = adam_step(flat, torch.cat([g.reshape(-1) for g in grads]), state,
                                0.01, 1, 0.5)
    assert int(state.count) == 3
    want = [v.view(w.shape) for v, w in zip(torch.split(flat, sizes), ws)]
    for a, b in zip(td.mlp_weights(mlp), want):
        assert torch.equal(a, b)


def test_cpu_wrapper_is_the_plain_version_and_does_not_count(setup):
    jm, x, y = setup
    xt, yt = torch.as_tensor(x[:200]), torch.as_tensor(y[:200])
    before = dict(build.LAUNCHES)
    with one_thread():
        a = td.train_dnn(_port(jm), xt, yt, 4, 2)
        b = td.train_dnn_stage_plain(_port(jm), xt, yt, 4, 2)
        res = train_dnn_stage(_port(jm), xt, yt, 4, 2, precision="default")
    assert build.LAUNCHES == before
    assert torch.equal(a[1], b[1]) and torch.equal(res.losses, b[1])
    for u, v in zip(td.mlp_weights(a[0]), td.mlp_weights(b[0])):
        assert torch.equal(u, v)


def test_any_depth_on_the_cpu():
    """The plain version covers other topologies (the kernel only the flagship)."""
    jm = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(2), (8, 32, 32, 1)))
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (128, 8)).astype(np.float32)
    y = rs.uniform(-1, 1, (128, 1)).astype(np.float32)
    want = jax_train_dnn_stage(jm, x, y, jax.random.PRNGKey(0), n_iter=5, lr=1e-3,
                               dropout_p=0.0)
    mlp, losses, _ = td.train_dnn(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 0, 5,
                               lr=1e-3, dropout_p=0.0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want.losses), rtol=5e-4, atol=1e-5)


def test_rejects_bad_inputs(setup):
    jm, x, y = setup
    mlp = _port(jm)
    xt, yt = torch.as_tensor(x[:10]), torch.as_tensor(y[:10])
    with pytest.raises(ValueError):
        td.train_dnn(mlp, torch.zeros(10, 7), yt, 0, 2)
    with pytest.raises(ValueError):
        td.train_dnn(mlp, xt.double(), yt, 0, 2)
    with pytest.raises(ValueError):
        td.train_dnn(mlp, xt, yt[:9], 0, 2)
    with pytest.raises(ValueError):
        td.train_dnn(mlp, xt, yt, 0, 0)
    with pytest.raises(ValueError):
        td.train_dnn(mlp, xt, yt, 0, 2, dropout_p=1.0)
    with pytest.raises(ValueError):
        train_dnn_stage(mlp, xt, yt, 0, 2, precision="bf16")
