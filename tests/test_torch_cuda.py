"""The port's kernels on the card against their plain versions.

Every test here needs a CUDA card and is marked ``cuda``; without one it
skips.  The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: loss[0] of the training kernel at rtol 2e-5 (one float32 forward
under the same masks: it checks the masks); its loss trace at rtol 5e-3,
atol 1e-5 and the weights at rtol 5e-3, atol 5e-3 (summation order differs,
and Adam amplifies it over the steps; the hardware row of
tests/test_pallas_train.py:47-49).  The MC-dropout kernel against its plain
version with bf16 sample passes: base at rtol 2e-5, atol 1e-6 (float32 in
both), statistics at rtol 1e-3, atol 1e-5 (summation order, and the bf16
roundings that it flips); against the float32 plain version at rtol 1e-2,
atol 1e-4.  The residual kernel against its plain version: rtol = atol = 2e-5
(float32 in both, each op in the same order; the accurate powf/expf/logf of
the card and of torch differ in the last ulps), NaN sets identical."""

import numpy as np
import pytest
import torch

from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.mlp import MLP
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.ops.mc_dropout import mc_dropout_sums, mc_dropout_sums_plain
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.physics.residuals import all_residuals
from pinnfc_tpu_torch.training.stages import train_dnn_stage
from pinnfc_tpu_torch.uq.mc_dropout import finish_mc_stats


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 37])
@pytest.mark.parametrize("dropout_p", [0.2, 0.0])
def test_train_kernel_matches_plain(cuda_device, dropout_p, n):
    """N = 1,000 is ragged against the 48-row CTAs and the 512-row mask blocks
    (CTA 10 straddles the first block boundary); N = 37 against the 16-row
    mma tiles and a single CTA."""
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.uniform(-1, 1, (n, 8)).astype(np.float32), device=cuda_device)
    y = torch.as_tensor(rs.uniform(-1, 1, (n, 1)).astype(np.float32), device=cuda_device)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=cuda_device)
    before = build.LAUNCHES["train_dnn"]
    km, kl, _ = td.train_dnn(mlp, x, y, 3, 10, lr_step=4, lr_gamma=0.5, dropout_p=dropout_p)
    assert build.LAUNCHES["train_dnn"] == before + 1
    pm, pl, _ = td.train_dnn_stage_plain(mlp, x, y, 3, 10, lr_step=4, lr_gamma=0.5,
                                      dropout_p=dropout_p)
    torch.testing.assert_close(kl[0], pl[0], rtol=2e-5, atol=0)
    torch.testing.assert_close(kl, pl, rtol=5e-3, atol=1e-5)
    for a, b in zip(td.mlp_weights(km), td.mlp_weights(pm)):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-3)
    again = td.train_dnn(mlp, x, y, 3, 10, lr_step=4, lr_gamma=0.5, dropout_p=dropout_p)
    assert torch.equal(again[1], kl)


def _train_inputs(n, device):
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.uniform(-1, 1, (n, 8)).astype(np.float32), device=device)
    y = torch.as_tensor(rs.uniform(-1, 1, (n, 1)).astype(np.float32), device=device)
    return MLP(generator=torch.Generator().manual_seed(0), device=device), x, y


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(5, 7), (4, 4, 4)])
def test_train_kernel_chunks_equal_the_whole_stage(cuda_device, split):
    """A stage run as chunks (start step t0, carried Adam moments and count)
    equals the whole stage bitwise: the same four launches per step, no float
    atomics; the staircase (lr_step 3) turns inside the chunks."""
    mlp, x, y = _train_inputs(1000, cuda_device)
    hp = dict(lr_step=3, lr_gamma=0.5, dropout_p=0.2)
    whole = td.train_dnn(mlp, x, y, 3, sum(split), **hp)
    piece, state, losses, t0 = mlp, None, [], 0
    for m in split:
        piece, got, state = td.train_dnn(piece, x, y, 3, m, t0=t0, state=state, **hp)
        losses.append(got)
        t0 += m
    assert int(state.count) == sum(split) == int(whole.state.count)
    assert torch.equal(torch.cat(losses), whole.losses)
    assert torch.equal(td.flat_weights(piece), td.flat_weights(whole.mlp))
    assert torch.equal(state.m, whole.state.m) and torch.equal(state.v, whole.state.v)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 37])
def test_train_kernel_from_t0_with_carried_state_matches_plain(cuda_device, n):
    """From step 4 with the Adam state after 4 steps, the kernel against its
    plain version at the tolerances of test_train_kernel_matches_plain."""
    mlp, x, y = _train_inputs(n, cuda_device)
    hp = dict(lr_step=3, lr_gamma=0.5, dropout_p=0.2)
    start, _, state = td.train_dnn_stage_plain(mlp, x, y, 3, 4, **hp)
    km, kl, ks = td.train_dnn(start, x, y, 3, 6, t0=4, state=state, **hp)
    pm, pl, ps = td.train_dnn_stage_plain(start, x, y, 3, 6, t0=4, state=state, **hp)
    torch.testing.assert_close(kl[0], pl[0], rtol=2e-5, atol=0)
    torch.testing.assert_close(kl, pl, rtol=5e-3, atol=1e-5)
    for a, b in zip(td.mlp_weights(km), td.mlp_weights(pm)):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-3)
    assert int(ks.count) == int(ps.count) == 10
    torch.testing.assert_close(ks.m, ps.m, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(ks.v, ps.v, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_train_kernel_refuses_what_it_does_not_cover(cuda_device):
    x = torch.zeros(64, 8, device=cuda_device)
    y = torch.zeros(64, 1, device=cuda_device)
    with pytest.raises(ValueError, match="flagship"):
        td.train_dnn(MLP((8, 32, 32, 1), device=cuda_device), x, y, 0, 2)
    with pytest.raises(ValueError, match="TF32"):
        train_dnn_stage(MLP(device=cuda_device), x, y, 0, 2, precision="default")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 37])
def test_mc_kernel_matches_bf16_plain(cuda_device, n):
    """N = 1,000 is ragged against the 128-row CTAs and the 256-row mask
    blocks; N = 37 fills part of one CTA."""
    x = torch.as_tensor(np.random.RandomState(1).uniform(-1.2, 1.2, (n, 8)).astype(np.float32),
                        device=cuda_device)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=cuda_device)
    seed, m = 123456789, 64
    before = build.LAUNCHES["mc_dropout"]
    k_sums = mc_dropout_sums(mlp, x, seed, mc_times=m)
    assert build.LAUNCHES["mc_dropout"] == before + 1
    assert torch.equal(mc_dropout_sums(mlp, x, seed, mc_times=m), k_sums)
    k = finish_mc_stats(k_sums, m)
    b = finish_mc_stats(mc_dropout_sums_plain(mlp, x, seed, mc_times=m,
                                              sample_dtype=torch.bfloat16), m)
    f = finish_mc_stats(mc_dropout_sums_plain(mlp, x, seed, mc_times=m), m)
    torch.testing.assert_close(k.pred_mean, b.pred_mean, rtol=2e-5, atol=1e-6)
    for name in ("aleatoric_std", "epistemic_std"):
        torch.testing.assert_close(getattr(k, name), getattr(b, name), rtol=1e-3, atol=1e-5)
        torch.testing.assert_close(getattr(k, name), getattr(f, name), rtol=1e-2, atol=1e-4)


@pytest.mark.cuda
def test_mc_kernel_refuses_a_non_flagship_mlp(cuda_device):
    with pytest.raises(ValueError, match="flagship"):
        mc_dropout_sums(MLP((8, 64, 64, 1), device=cuda_device),
                        torch.zeros(16, 8, device=cuda_device), 0, mc_times=2)


@pytest.fixture(scope="module")
def campaign_rows():
    """The default synthetic campaign's 15,600 normalized rows, on the CPU."""
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    return combine_and_normalize(normal, faults, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15600, 37])
@pytest.mark.parametrize("i_l", [None, 1.2])
def test_residual_kernel_matches_plain(cuda_device, campaign_rows, n, i_l):
    """The campaign's rows, and their first 37 (ragged against the 32-row
    CTAs); i_l = 1.2 puts rows past the limiting current, whose f_v and
    v_phys_stack are NaN in both."""
    ds = campaign_rows
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)
    if i_l is not None:
        params["lam_v"][2] = i_l
    sx, sy = ds.scaler_x.to(cuda_device), ds.scaler_y.to(cuda_device)
    x = ds.x_test[:n].to(cuda_device)
    with torch.no_grad():
        u = params["mlp"](x)[0]
    before = build.LAUNCHES["residuals"]
    got = all_residuals_kernel(params, x, u, sx, sy)
    assert build.LAUNCHES["residuals"] == before + 1
    want = all_residuals(params, x, u, sx, sy)
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape == (n, 1), name
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f"{name}: NaN sets differ"
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, equal_nan=True, msg=name)
    if i_l is not None and n == 15600:
        assert bool(torch.isnan(got.f_v).any())
