"""The bf16 rounding contract of the MC-dropout sample passes
(pinnfc_tpu_torch.ops.mc_dropout, ``sample_dtype=torch.bfloat16``), which the
CUDA kernel csrc/mc_dropout.cu follows on the card.

Tolerances: the base pass is float32 in both precisions and must be bitwise
equal; the masks are integer arithmetic and must match exactly.  The
statistics with bf16 sample passes stay within rtol 1e-2, atol 1e-4 of the
float32 ones and of the JAX kernel run in interpret mode: bf16 keeps 8
significant bits, and a standard deviation over these few samples moves by
well under a percent.  A wide product is a float32 product of bf16-rounded
operands: against a float64 product of the same operands, rtol 1e-5 (float32
accumulation over K <= 256)."""

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.models.mlp import init_mlp
from pinnfc_tpu.ops.pallas_mc_dropout import mc_dropout_pallas
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops.mc_ablation import VARIANTS, variant_source
from pinnfc_tpu_torch.ops.mc_dropout import (
    MASK_BLOCK,
    _U32,
    dropout_constants,
    mc_dropout_sums,
    mc_dropout_sums_plain,
    random_bits,
    round_bf16,
    sample_pass,
    sample_product,
    wang_hash,
    wide_linears,
)
from pinnfc_tpu_torch.uq.mc_dropout import finish_mc_stats
from pinnfc_tpu_torch.utils.jax_params import params_from_jax
from pinnfc_tpu_torch.utils.threads import one_thread

FLAGSHIP = (8, 256, 256, 256, 1)
NARROW = (8, 64, 64, 1)


def _jax_mlp(layers, seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.PRNGKey(seed), layers))


def _port_mlp(jax_mlp):
    zeros = {g: np.zeros(4, np.float32) for g in ("lam_v", "lam_h", "lam_o")}
    return params_from_jax({"mlp": jax_mlp, "lam_t": np.zeros(5, np.float32), **zeros},
                           device="cpu")["mlp"]


def _x(n, seed=1):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def flagship():
    jax_mlp = _jax_mlp(FLAGSHIP)
    return jax_mlp, _port_mlp(jax_mlp)


@pytest.mark.parametrize("layers,n", [(FLAGSHIP, 300), (NARROW, 70)])
def test_base_column_is_float32_bitwise(layers, n):
    mlp = _port_mlp(_jax_mlp(layers))
    x = torch.as_tensor(_x(n))
    with one_thread():
        f = mc_dropout_sums_plain(mlp, x, 9, mc_times=2)
        b = mc_dropout_sums_plain(mlp, x, 9, mc_times=2, sample_dtype=torch.bfloat16)
    assert torch.equal(b[:, 0], f[:, 0])
    assert not torch.equal(b[:, 1:], f[:, 1:])


@pytest.mark.parametrize("layer", [0, 1, 2, 3])
def test_bf16_pass_zeroes_the_mask_elements(flagship, layer):
    """Layer ``layer`` of one bf16 sample pass over rows that straddle two
    mask blocks: zero exactly where the hash drops, and elsewhere the float32
    pass's value rounded to bf16 where the layer's input is the same."""
    _, mlp = flagship
    n, seed, s, p = 300, 77, 3, 0.4
    thresh, inv_keep = dropout_constants(p)
    rows = torch.arange(n, dtype=torch.int64)
    local = rows % MASK_BLOCK
    salt = (seed * 7919 + (rows // MASK_BLOCK) * 104729 + s * 15485863) & _U32
    x = torch.as_tensor(_x(n))
    with torch.no_grad():
        _, _, masked = sample_pass(mlp, x, local, salt, thresh, inv_keep, torch.bfloat16)
        _, _, masked_f = sample_pass(mlp, x, local, salt, thresh, inv_keep)
    act = masked[layer]
    bits = random_bits(local, act.shape[1], (salt + layer) & _U32)
    dropped = bits < thresh
    assert 0.3 < float(dropped.float().mean()) < 0.5
    assert torch.equal(act == 0, dropped)
    assert torch.equal(masked_f[layer] == 0, dropped)
    assert torch.equal(act, round_bf16(act))
    if layer == 0:  # same float32 input: the stored values are the float32 ones, rounded
        assert torch.equal(act, round_bf16(masked_f[0]))


def test_round_bf16_is_nearest_even():
    one = 1.0
    ties = torch.tensor([one + 2**-8, one + 3 * 2**-8, -(one + 2**-8), 2**-8 * (1 + 2**-8)])
    want = torch.tensor([one, one + 2**-6, -one, 2**-8])
    assert torch.equal(round_bf16(ties), want)
    assert torch.equal(round_bf16(torch.tensor([one + 2**-7])), torch.tensor([one + 2**-7]))
    assert torch.isnan(round_bf16(torch.tensor([float("nan")]))).all()


def test_wide_product_is_float32_product_of_bf16_operands(flagship):
    _, mlp = flagship
    h = torch.as_tensor(np.tanh(np.random.RandomState(4).normal(size=(64, 256))).astype(np.float32))
    lin = mlp.hidden[1]
    with torch.no_grad():
        got = sample_product(h, lin.weight, lin.bias)
        a, w = round_bf16(h).double(), round_bf16(lin.weight).double()
        want = a @ w.T + lin.bias.double()
        exact = h.double() @ lin.weight.double().T + lin.bias.double()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    assert float((got.double() - exact).abs().max()) > 1e-4  # the operands were rounded


def test_wide_linears_are_the_four_wide_products(flagship):
    _, mlp = flagship
    shapes = [tuple(lin.weight.shape) for lin in wide_linears(mlp)]
    assert shapes == [(256, 256), (256, 256), (128, 256), (64, 128)]
    macs = sum(o * i for o, i in shapes)
    assert macs == 172_032


@pytest.mark.parametrize(
    "layers,n,mc_times,seed",
    [(FLAGSHIP, 300, 8, 11), (NARROW, 300, 16, 3), (NARROW, 37, 4, 2**31 - 2)],
)
def test_bf16_statistics_near_float32_and_pallas(layers, n, mc_times, seed):
    jax_mlp = _jax_mlp(layers)
    mlp = _port_mlp(jax_mlp)
    x = _x(n)
    bf = finish_mc_stats(mc_dropout_sums_plain(mlp, torch.as_tensor(x), seed, mc_times, 0.4,
                                               sample_dtype=torch.bfloat16), mc_times)
    fp = finish_mc_stats(mc_dropout_sums_plain(mlp, torch.as_tensor(x), seed, mc_times, 0.4),
                         mc_times)
    pallas = mc_dropout_pallas(jax_mlp, x, seed, mc_times=mc_times, dropout=0.4, interpret=True)
    for name in ("aleatoric_std", "epistemic_std"):
        got = getattr(bf, name).numpy()
        np.testing.assert_allclose(got, getattr(fp, name).numpy(), rtol=1e-2, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(got, np.asarray(getattr(pallas, name)), rtol=1e-2,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(bf.pred_mean.numpy(), np.asarray(pallas.pred_mean),
                               rtol=2e-5, atol=1e-6)


def test_wrapper_on_cpu_keeps_float32_samples(flagship):
    _, mlp = flagship
    x = torch.as_tensor(_x(90, seed=5))
    before = dict(build.LAUNCHES)
    with one_thread():
        got = mc_dropout_sums(mlp, x, 21, mc_times=3)
        plain = mc_dropout_sums_plain(mlp, x, 21, mc_times=3)
    assert build.LAUNCHES == before
    assert torch.equal(got, plain)
    bf = mc_dropout_sums_plain(mlp, x, 21, mc_times=3, sample_dtype=torch.bfloat16)
    assert not torch.equal(got[:, 1:], bf[:, 1:])


def test_sample_dtype_other_than_float32_or_bf16_raises(flagship):
    _, mlp = flagship
    with pytest.raises(ValueError, match="sample_dtype"):
        mc_dropout_sums_plain(mlp, torch.as_tensor(_x(4)), 0, mc_times=1,
                              sample_dtype=torch.float16)


@pytest.mark.parametrize("salt", [0, 12345, 2**31 + 7, 2**32 - 1])
def test_hash_first_step_folds_into_a_layer_key(salt):
    """csrc/mc_dropout.cu computes wang(ctr ^ hs) as the hash's remaining
    steps of ctr ^ (hs ^ 61 ^ (hs >> 16)): the first step (x ^ 61) ^ (x >> 16)
    of x = ctr ^ hs equals that for every counter below 2^16 (lr * W + c with
    lr < 256, W <= 256)."""
    hs = int(wang_hash(torch.tensor([(salt + 0x9E3779B9) & _U32]))[0])
    key = hs ^ 61 ^ (hs >> 16)
    ctr = torch.arange(0, 1 << 16, dtype=torch.int64)
    x = ctr ^ hs
    first = (x ^ 61) ^ (x >> 16)
    assert torch.equal(first, ctr ^ key)


@pytest.mark.parametrize("width", [256, 128, 64])
def test_fragment_counter_bits_are_disjoint(width):
    """The kernel's counter of fragment element (row, wn, q, j, e) is
    ((lr0 + row) * W) ^ col0 ^ (8 j) ^ e with col0 = wn W/4 + 2 q: equal to
    the contract's (lr0 + row) W + col0 + 8 j + e for every row of a CTA and
    every position a thread holds."""
    lr = torch.arange(MASK_BLOCK, dtype=torch.int64)[:, None]
    wn, q, j, e = np.meshgrid(np.arange(4), np.arange(4), np.arange(width // 32), np.arange(2),
                              indexing="ij")
    col0 = torch.as_tensor((wn * (width // 4) + 2 * q).ravel())[None, :]
    off = torch.as_tensor((8 * j + e).ravel())[None, :]
    folded = ((lr * width) ^ col0) ^ off
    assert torch.equal(folded, lr * width + col0 + off)
    assert int(folded.max()) < 1 << 16


def _tanh_sample(x, e_err, r_err):
    """csrc/mc_dropout.cu's tanh_sample in float32, with ex2.approx and
    rcp.approx modelled as the rounded exact result times (1 + err)."""
    def f32(v):
        return np.asarray(v, np.float32)

    def f64(v):
        return np.asarray(v, np.float64)

    e = f32(np.exp2(f64(f32(x * f32(2.8853900817779268)))) * (1 + e_err))
    r = f32(f64(f32(1.0 / f64(f32(1 + e)))) * (1 + r_err))
    big = f32(1.0 - 2.0 * f64(r))
    x2 = f32(x * x)
    p = f32(f64(x2) * f64(f32(62.0 / 2835.0)) + f32(-17.0 / 315.0))
    p = f32(f64(x2) * f64(p) + f32(2.0 / 15.0))
    p = f32(f64(x2) * f64(p) + f32(-1.0 / 3.0))
    small = f32(f64(f32(x * x2)) * f64(p) + f64(x))
    return np.where(np.abs(x) < f32(0.25), small, big)


@pytest.mark.parametrize("e_err", [0.0, 2.0**-22, -(2.0**-22)])
@pytest.mark.parametrize("r_err", [0.0, 2.0**-23, -(2.0**-23)])
def test_sample_pass_tanh_within_2e6_of_tanh(e_err, r_err):
    """The sample passes' tanh at the worst documented errors of ex2.approx
    (2^-22 relative) and rcp.approx (one ulp) stays within 2e-6 relative of
    tanh: about 400 times below tanh.approx.f32's 2^-11, and below the bf16
    rounding that follows (2^-9 relative) by a factor of 1,000."""
    x = np.concatenate([np.linspace(-12, 12, 400_001), np.linspace(-0.3, 0.3, 200_001),
                        2.0 ** -np.arange(1, 140)]).astype(np.float32)
    x = np.concatenate([x, -x, np.float32([0.0, np.inf, -np.inf])])
    got = _tanh_sample(x, e_err, r_err)
    want = np.tanh(x.astype(np.float64))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert float(rel.max()) < 2e-6
    assert np.isnan(_tanh_sample(np.float32([np.nan]), e_err, r_err)).all()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_ablation_edits_apply_to_the_kernel_source(name):
    """pinnfc_tpu_torch.ops.mc_ablation edits csrc/mc_dropout.cu by text (the
    four removals and the stamps): each edit must still
    find its text, and change the source."""
    src = variant_source(VARIANTS[name])
    assert src != variant_source([])
    for old, new in VARIANTS[name]:
        assert new in src
