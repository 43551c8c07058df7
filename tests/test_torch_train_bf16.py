"""The DNN stage at precision "default" (the TPU kernel's mxu_prec = None) on the CPU.

On a CUDA tensor "default" runs the training kernel's bf16 form
(csrc/train_dnn.cu) for the flagship and bf16-operand products
(``models/mlp.py::RoundedMatmul``) for any other topology; on a CPU tensor it
is float32, as JAX computes ``precision=None`` on a CPU.  The bf16 rounding
contract's plain version is ``loss_and_grads(..., product_dtype=bf16)``; the
card holds the kernel to it (chip_smoke.py phase 21), and this file holds it
on the CPU.  Miniature sizes: N <= 512 rows, <= 6 steps.

Tolerances:
- ``rounded_matmul`` against a float64 product of the same bf16 operands:
  2^-20 of the magnitude sum |a| |b| per element (float32 accumulation).
- One-step gradients as the worst tensor's max|Δg| / max|g| (``rel_gap``):
  the bf16 plain version in float32 against float64 accumulation of the same
  rounded operands within ``ORDER_BAND`` = 1e-3 (measured 5.5e-5 at N = 512
  by tests/_torch_precision_probe.py: the spread of a summation order,
  activations that round across a bf16 boundary included); the float32
  plain version must be outside that band (measured 1.4e-2: the planted
  fault the card's check relies on).  The same band holds shards against the
  whole and the autograd bf16 gradient against the hand-derived one.
- Trajectories, not gradients, are held by losses: Adam moves a weight by
  about lr sign(g) in its first steps, so a near-zero gradient whose sign
  flips under rounding moves that weight by 2 lr.  The bf16 plain losses
  against JAX's float32 kernel at lr 1e-3: within 1e-2 of the trace's
  largest |loss| (measured 1.7e-3 of it); the port's CPU
  "default" against JAX's at the existing tolerances of
  tests/test_torch_train_dnn.py (losses rtol 5e-4 atol 1e-5, weights rtol
  1e-3 atol 1e-5); chunks bitwise; sharded stages at the tolerances of
  tests/test_torch_parallel.py.
"""

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.models.mlp import init_mlp
from pinnfc_tpu.ops.pallas_train import _flatten_weights, train_dnn_pallas
from pinnfc_tpu.training.stages import train_dnn_stage as jax_train_dnn_stage
from pinnfc_tpu_torch.cli import main as port_main
from pinnfc_tpu_torch.models.mlp import MLP, RoundedMatmul, aleatoric_loss, rounded_matmul
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants
from pinnfc_tpu_torch.parallel import mesh as pm
from pinnfc_tpu_torch.training import stages
from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint_meta, load_params_npz
from pinnfc_tpu_torch.utils.jax_params import mlp_from_jax
from pinnfc_tpu_torch.utils.threads import one_thread

FLAGSHIP = (8, 256, 256, 256, 1)
SMALL = (8, 32, 32, 1)
BF = torch.bfloat16
ORDER_BAND = 1e-3
HP = dict(lr=1e-3, lr_step=3, lr_gamma=0.5, dropout_p=0.2)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (512, 8)).astype(np.float32)
    y = rs.uniform(-1, 1, (512, 1)).astype(np.float32)
    jm = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(4), FLAGSHIP))
    return jm, x, y


@pytest.fixture(scope="module")
def pallas_runs(setup):
    """JAX's kernel in interpret mode at both precisions, 6 steps."""
    jm, x, y = setup
    return {p: train_dnn_pallas(jm, x, y, seed=5, n_iter=6, interpret=True, precision=p,
                                **{k: v for k, v in HP.items()})
            for p in ("highest", "default")}


def _port(jm):
    return mlp_from_jax(jm, device="cpu")


def rel_gap(got, want) -> float:
    """The worst tensor's max|Δg| / max|g| of ``want``."""
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for a, b in zip(got, want))


def _grads(mlp, x, y, dtype=torch.float32, product_dtype=None, t=0, row0=0, n=None):
    thresh, inv_keep = dropout_constants(0.2)
    keep = td.keep_masks(x.shape[0], mlp.dropout_widths(), 9, t, thresh, "cpu", row0=row0)
    ws = [w.to(dtype) for w in td.mlp_weights(mlp)]
    return td.loss_and_grads(ws, x.to(dtype), y.to(dtype), keep, inv_keep,
                             td._inv_n(n or x.shape[0]), product_dtype)


def test_bf16_rounds_to_nearest_even():
    one = 1.0
    ties = torch.tensor([one + 2**-8, one + 3 * 2**-8, -(one + 2**-8), one + 2**-8 + 2**-20])
    want = torch.tensor([one, one + 2**-6, -one, one + 2**-7])
    assert torch.equal(ties.to(BF).float(), want)
    assert torch.isnan(torch.tensor([float("nan")]).to(BF).float()).all()


@pytest.mark.parametrize("m,k,n", [(48, 8, 256), (48, 256, 256), (64, 32, 64)])
def test_rounded_matmul_is_a_float64_product_of_bf16_operands(m, k, n):
    """The kernel's shapes: layer 0, a trunk product, a weight-gradient tile."""
    rs = np.random.RandomState(m + k + n)
    a = torch.as_tensor(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.as_tensor(rs.standard_normal((k, n)).astype(np.float32))
    got = rounded_matmul(a, b, BF)
    ar, br = a.to(BF).double(), b.to(BF).double()
    mag = ar.abs() @ br.abs()
    assert ((got.double() - ar @ br).abs() <= 2**-20 * mag).all()
    # the operands are rounded: the unrounded product is far off somewhere
    assert ((got.double() - a.double() @ b.double()).abs() > 2**-12 * mag).any()
    assert torch.equal(rounded_matmul(a, b), a @ b)


def test_rounded_matmul_backward_rounds_both_products():
    rs = np.random.RandomState(8)
    a = torch.as_tensor(rs.standard_normal((37, 24)).astype(np.float32)).requires_grad_(True)
    w = torch.as_tensor(rs.standard_normal((24, 16)).astype(np.float32)).requires_grad_(True)
    g0 = torch.as_tensor(rs.standard_normal((37, 16)).astype(np.float32))
    out = RoundedMatmul.apply(a, w, BF)
    assert torch.equal(out, rounded_matmul(a.detach(), w.detach(), BF))
    ga, gw = torch.autograd.grad(out, (a, w), g0)
    assert torch.equal(ga, rounded_matmul(g0, w.detach().t(), BF))
    assert torch.equal(gw, rounded_matmul(a.detach().t(), g0, BF))


def test_bf16_step_against_float64_accumulation(setup):
    jm, x, y = setup
    mlp = _port(jm)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    loss32, g32 = _grads(mlp, x, y, product_dtype=BF)
    loss64, g64 = _grads(mlp, x, y, torch.float64, product_dtype=BF)
    assert rel_gap(g32, g64) <= ORDER_BAND
    torch.testing.assert_close(loss32.double(), loss64, rtol=1e-5, atol=0)


def test_the_float32_step_is_outside_the_bf16_band(setup):
    """The planted fault of the card's check: the float32 form's gradient
    where the bf16 form's is wanted."""
    jm, x, y = setup
    mlp = _port(jm)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    _, gb = _grads(mlp, x, y, product_dtype=BF)
    _, gb64 = _grads(mlp, x, y, torch.float64, product_dtype=BF)
    _, g32 = _grads(mlp, x, y)
    fault = rel_gap(g32, gb)
    assert fault > ORDER_BAND
    assert fault > 20 * rel_gap(gb, gb64)


def test_pallas_default_is_highest_on_the_cpu(pallas_runs):
    hi, de = pallas_runs["highest"], pallas_runs["default"]
    np.testing.assert_array_equal(np.asarray(de.losses), np.asarray(hi.losses))
    for a, b in zip(_flatten_weights(de.params), _flatten_weights(hi.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_default_on_the_cpu_matches_jax_default(setup, pallas_runs):
    jm, x, y = setup
    want = pallas_runs["default"]
    res = stages.train_dnn_stage(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 5, 6,
                                 precision="default", **HP)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(want.losses), rtol=5e-4,
                               atol=1e-5)
    wanted = [np.asarray(w) for w in _flatten_weights(want.params)]
    for i, (got, w) in enumerate(zip(td.mlp_weights(res.params), wanted)):
        np.testing.assert_allclose(got.numpy(), w.reshape(got.shape), rtol=1e-3, atol=1e-5,
                                   err_msg=f"weight tensor {i}")


def test_bf16_plain_losses_against_jax(setup, pallas_runs):
    """The same hash masks (bit-exact, tests/test_torch_train_dnn.py) with bf16
    operands: within 1 % of the largest |loss| of JAX's float32 trace (which
    crosses zero), and not equal to it."""
    jm, x, y = setup
    want = np.asarray(pallas_runs["default"].losses)
    out = td.train_dnn_stage_plain(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 5, 6,
                                   product_dtype=BF, **HP)
    got = out.losses.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)
    assert np.abs(got - want).max() > 1e-6 * scale


@pytest.mark.parametrize("form", ["cpu default", "bf16 plain"])
def test_chunks_equal_the_whole_stage(setup, form):
    jm, x, y = setup
    x, y = torch.as_tensor(x[:256]), torch.as_tensor(y[:256])

    def run(mlp, steps, t0=0, state=None):
        if form == "bf16 plain":
            return td.train_dnn_stage_plain(mlp, x, y, 5, steps, t0=t0, state=state,
                                            product_dtype=BF, **HP)
        m, s, losses = stages.train_dnn_chunk(mlp, state, x, y, 5, t0, steps,
                                              precision="default", **HP)
        return td.DnnStageOut(m, losses, s)

    with one_thread():
        whole = run(_port(jm), 5)
        first = run(_port(jm), 2)
        rest = run(first.mlp, 3, t0=2, state=first.state)
    assert torch.equal(torch.cat([first.losses, rest.losses]), whole.losses)
    assert all(torch.equal(a, b) for a, b in zip(td.mlp_weights(rest.mlp),
                                                 td.mlp_weights(whole.mlp)))


@pytest.mark.parametrize("layers,w_tol", [(SMALL, (1e-3, 1e-5)), (FLAGSHIP, (5e-3, 5e-3))])
def test_sharded_equals_unsharded_at_default(setup, layers, w_tol):
    _, x, y = setup
    x, y = torch.as_tensor(x[:384]), torch.as_tensor(y[:384])
    mlp = MLP(layers, generator=torch.Generator().manual_seed(6), device="cpu")
    shards = pm.shard_batch(pm.make_mesh(devices=["cpu"] * 3), x, y)
    a_mlp, _, a_loss = stages.train_dnn_chunk(mlp, None, x, y, 5, 0, 4, precision="default",
                                              **HP)
    b_mlp, _, b_loss = stages.train_dnn_chunk_sharded(mlp, None, shards, 5, 0, 4,
                                                      precision="default", **HP)
    np.testing.assert_allclose(b_loss.numpy(), a_loss.numpy(), rtol=1e-4, atol=1e-6)
    for u, v in zip(td.mlp_weights(a_mlp), td.mlp_weights(b_mlp)):
        torch.testing.assert_close(v, u, rtol=w_tol[0], atol=w_tol[1])


def test_bf16_shard_terms_sum_to_the_whole_gradient(setup):
    """Row shards of the bf16 plain step (masks by global row) against the
    whole-N step: another summation order, within the band."""
    jm, x, y = setup
    mlp = _port(jm)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    loss, whole = _grads(mlp, x, y, product_dtype=BF)
    terms, parts = [], []
    for lo, hi in ((0, 100), (100, 357), (357, 512)):
        loss_k, g_k = _grads(mlp, x[lo:hi], y[lo:hi], product_dtype=BF, row0=lo, n=512)
        terms.append(loss_k)
        parts.append(g_k)
    torch.testing.assert_close(pm.all_sum(terms), loss, rtol=1e-6, atol=0)
    summed = [pm.all_sum([p[i] for p in parts]) for i in range(len(whole))]
    assert rel_gap(summed, whole) <= ORDER_BAND


@pytest.mark.parametrize("layers", [FLAGSHIP, (8, 64, 64, 64, 64, 1)])
def test_rounded_autograd_is_the_hand_derived_bf16_gradient(setup, layers):
    """The non-flagship path's bf16 products (``MLP.forward(product_dtype=)``
    under autograd) give the gradient of the kernel's contract."""
    _, x, y = setup
    x, y = torch.as_tensor(x[:300]), torch.as_tensor(y[:300])
    mlp = MLP(layers, generator=torch.Generator().manual_seed(2), device="cpu")
    thresh, _ = dropout_constants(0.2)
    keep = td.keep_masks(300, mlp.dropout_widths(), 9, 0, thresh, "cpu")
    ws = [w.detach().requires_grad_(True) for w in td.mlp_weights(mlp)]
    params = stages._named_params(ws, mlp)
    pred, lv = torch.func.functional_call(mlp, params, (x,),
                                          {"keep": keep, "dropout_p": 0.2, "product_dtype": BF})
    auto = torch.autograd.grad(aleatoric_loss(y, pred, lv), ws)
    _, hand = _grads(mlp, x, y, product_dtype=BF)
    _, hand32 = _grads(mlp, x, y)
    assert rel_gap(auto, hand) <= ORDER_BAND
    assert rel_gap(hand32, hand) > ORDER_BAND


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_step_grads_on_the_cpu_is_the_float32_plain_step(setup, precision):
    """The kernel's one-step gradient entry runs ``loss_and_grads`` in float32
    for a CPU tensor, at either precision, and counts no launch."""
    jm, x, y = setup
    mlp = _port(jm)
    x, y = torch.as_tensor(x[:200]), torch.as_tensor(y[:200])
    before = dict(build.LAUNCHES)
    with one_thread():
        loss, got = td.step_grads(mlp, x, y, 9, 2, precision=precision)
        want_loss, want = _grads(mlp, x, y, t=2)
    assert build.LAUNCHES == before
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_non_flagship_default_matches_jax_default():
    """Dropout off (JAX's masks come from its keys), 5 steps."""
    jm = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(2), SMALL))
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (128, 8)).astype(np.float32)
    y = rs.uniform(-1, 1, (128, 1)).astype(np.float32)
    want = jax_train_dnn_stage(jm, x, y, jax.random.PRNGKey(0), n_iter=5, lr=1e-3,
                               dropout_p=0.0, precision="default")
    res = stages.train_dnn_stage(_port(jm), torch.as_tensor(x), torch.as_tensor(y), 0, 5,
                                 lr=1e-3, dropout_p=0.0, precision="default")
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(want.losses), rtol=5e-4,
                               atol=1e-5)
    wanted = [np.asarray(w) for w in _flatten_tree(want.params)]
    for got, w in zip(td.mlp_weights(res.params), wanted):
        np.testing.assert_allclose(got.numpy(), w.reshape(got.shape), rtol=1e-3, atol=1e-5)


def _flatten_tree(tree):
    lins = [*tree["hidden"], tree["mean"], *tree["var"]]
    return [a for lin in lins for a in (lin["w"], lin["b"])]


@pytest.mark.parametrize("layers", [FLAGSHIP, SMALL])
def test_default_is_float32_on_the_cpu(setup, layers):
    _, x, y = setup
    x, y = torch.as_tensor(x[:128]), torch.as_tensor(y[:128])
    mlp = MLP(layers, generator=torch.Generator().manual_seed(1), device="cpu")
    before = dict(build.LAUNCHES)
    with one_thread():
        a = stages.train_dnn_stage(mlp, x, y, 2, 3, precision="default")
        b = stages.train_dnn_stage(mlp, x, y, 2, 3, precision="highest")
    assert build.LAUNCHES == before
    assert torch.equal(a.losses, b.losses)
    assert all(torch.equal(u, v) for u, v in zip(td.mlp_weights(a.params),
                                                 td.mlp_weights(b.params)))
    assert td.precision_dtype("default", "cpu") is None
    assert td.precision_dtype("highest", "cuda") is None
    assert td.precision_dtype("default", "cuda") is BF


def test_cli_train_precision_default_on_the_cpu(tmp_path, capsys):
    """``cli train --precision default --device cpu``: the sidecar records the
    precision and ``cli score`` reads the checkpoint back (on the CPU the
    stages are the float32 ones: ``test_default_is_float32_on_the_cpu``)."""
    ck = str(tmp_path / "ck")
    with one_thread():
        assert port_main(["train", "--device", "cpu", "--small", "--steps-scale", "0.01",
                          "--n-normal", "120", "--n-fault", "12", "--precision", "default",
                          "--ckpt", ck, "--mat-out", str(tmp_path / "t.mat")]) == 0
        assert port_main(["score", "--ckpt", ck, "--device", "cpu", "--mc-times", "8",
                          "--mat-out", str(tmp_path / "s.mat")]) == 0
    assert load_checkpoint_meta(ck)["config"]["model"]["precision"] == "default"
    assert load_params_npz(ck + ".npz")["params"]["mlp"]["hidden"]
    assert "config from checkpoint meta" in capsys.readouterr().out
    assert (tmp_path / "s.mat").exists()


@pytest.mark.parametrize("entry", ["train_dnn", "step_grads", "train_dnn_sharded",
                                   "train_dnn_stage", "train_dnn_chunk", "train_dnn_chunk_sharded",
                                   "train_dnn_autograd", "precision_dtype", "cli"])
def test_an_unknown_precision_raises(setup, entry):
    _, x, y = setup
    x, y = torch.as_tensor(x[:32]), torch.as_tensor(y[:32])
    mlp = MLP(SMALL if entry == "train_dnn_autograd" else FLAGSHIP, device="cpu")
    shards = pm.RowShards(((x, y),), (0,), 32)
    calls = {
        "train_dnn": lambda: td.train_dnn(mlp, x, y, 0, 2, precision="bf16"),
        "step_grads": lambda: td.step_grads(mlp, x, y, 0, 0, precision="bf16"),
        "train_dnn_sharded": lambda: td.train_dnn_sharded(mlp, shards, 0, 2, precision="bf16"),
        "train_dnn_stage": lambda: stages.train_dnn_stage(mlp, x, y, 0, 2, precision="bf16"),
        "train_dnn_chunk": lambda: stages.train_dnn_chunk(mlp, None, x, y, 0, 0, 2,
                                                          precision="fast"),
        "train_dnn_chunk_sharded": lambda: stages.train_dnn_chunk_sharded(
            mlp, None, shards, 0, 0, 2, precision="HIGHEST"),
        "train_dnn_autograd": lambda: stages.train_dnn_autograd(mlp, x, y, 0, 2,
                                                                precision="tf32"),
        "precision_dtype": lambda: td.precision_dtype("bf16", "cuda"),
    }
    if entry == "cli":
        with pytest.raises(SystemExit) as exc:
            port_main(["train", "--device", "cpu", "--precision", "bf16"])
        assert exc.value.code == 2
        return
    with pytest.raises(ValueError, match="precision must be one of"):
        calls[entry]()
