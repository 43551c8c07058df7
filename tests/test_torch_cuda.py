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
the card and of torch differ in the last ulps), NaN sets identical.

The paths without a kernel, on the card: the autograd DNN stage against the
training kernel's plain version under the same hash masks (losses rtol 1e-5,
atol 1e-7; weights rtol 1e-4, atol 1e-6, as tests/test_torch_dnn_any_depth.py
holds them on the CPU), its chunks bitwise equal to the whole stage; the
'vmap' MC sampler's eval pass bitwise the eval forward's, its statistics
against the same sampler on the CPU (another random stream) in the band of
tests/test_pallas_mc.py; the torch risk backend on the card against the
float64 numpy backend: the same alarm table, the series at the tolerances of
tests/test_risk.py:88-91.

The residual kernel on rows with NaN, +inf and -inf in each input channel and
a NaN u: NaN sets identical to the plain version's.  Serving and the
counterfactual on the card against the CPU: the monitor's series at rtol
1e-5 (atol 1e-5; layer_c 1e-4, the posteriors 1e-4), its flags and p-value
ranks equal, one residual-kernel launch per ``observe``/``observe_many``;
a 40-step recovery solve with δ within 2e-5 of the range and v_after within
2e-6 V.  The registered operator ``pinnfc_torch::residuals`` on the card
against the plain version at the residual kernel's tolerances, and the
eager wrapper's direct launch bitwise the operator's rows; a monitor
step exported on the CPU and moved to the card bitwise the eager monitor on
the card, one kernel launch per call.

Diagnosis on the card against the port on the CPU with the same CPU-generator
draws: the forest's feature, size and threshold tables identical (the
threshold is one float64 rounding on both) and its scores within rtol 1e-6;
k-means with the same assignments and inertia within rtol 1e-5; logistic
regression with the same ``n_iter`` and probabilities within atol 1e-5; the
EM in float32 from the same k-means draws with the same ``n_iter`` and argmax
on ≥ 99.9 % of rows, in float64 from one ``init_resp`` within 1e-9; and
``init='sklearn'`` / ``iso_backend='sklearn'`` raising ImportError when
scikit-learn cannot be imported.  Script 05 and t-SNE on the card against the
port on the CPU: the SVM's coefficients within 1e-3 of max |coef| and its
predictions on ≥ 99.5 % of rows, the L-BFGS logistic regression's
probabilities within atol 2e-4 of the CPU's and of Newton's on the card (on
overlapping classes both L-BFGS runs stop at float32's gradient floor, 1,000
steps; the card and the CPU differed by 7e-5); Ward labels identical (global at N = 600,
NN-chain at N = 2,400); the kNN index sets identical and the bottom-16
projectors of eigh and of the subspace iteration within 1e-3; t-SNE's final
KL within 10 %; the comparison pipeline on the miniature artifact with LR,
SVM and Agglomerative predictions agreeing on ≥ 99.5 % of rows and every
macro F1 within 0.05.  Explainability on the card against the CPU: the input
saliency at rtol 1e-4, atol 1e-6 with each class's driver equal; λ
identifiability with the same flags and dropped rows and stderr within rtol
1e-3 (tests/test_torch_explain.py's tolerances against JAX); ``tsne_embed``'s
KL within 10 %.

The training kernel's bf16 form (precision 'default'): its one-step
gradient within 1e-3 of max|g| of the plain version with bf16 products (the
worst tensor; the float32 plain gradient must be outside), loss[0] of a stage
at rtol 1e-3, two runs bitwise equal; another topology at 'default' runs the
bf16-operand autograd stage and launches no kernel.  The 3xTF32 form's
one-step gradient within max(4 × the float32 plain version's gap, 1e-6) of
max|g| of a float64 gradient (float32 accuracy).

The operational commands on the card: the doctor's probe reports the
kernels' compute capability (9, 0); its smoke run (101 flagship steps on 256
rows, two training-kernel launches) ends finite; every production step's
peak at the default campaign fits the card; a warmup of the ``--small``
steps leaves every warmed program present in the coverage check; the bench
line has both forms above 0 steps/s.

Data-parallel and ensembles on one card: the MC kernel on row shards with
their first mask block (``block0``) and ``mc_dropout_sharded`` on a mesh that
lists ``cuda:0`` three times, bitwise the whole run; the sharded DNN stage
(the training kernel's per-step entries) against the whole-stage kernel and
its per-shard plain version at the training kernel's tolerances; a 2-member
ensemble bitwise two lone stages; the monitor's sharded fleet step on
``[cuda:0] * 3`` against the unsharded step at the monitor's card-against-CPU
tolerances, one residual-kernel launch per shard.  On a mesh of distinct cards
(these skip with fewer than two): the sharded MC run bitwise one launch, the
sharded DNN stage bitwise the same shards on one card, an ensemble split over
the cards bitwise the ensemble without a mesh, the residual kernel on the last
card at its tolerances, and the sharded fleet step against the unsharded one."""

import numpy as np
import pytest
import torch

from pinnfc_tpu_torch.config import AucConfig, GmmConfig
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.diagnosis import (
    gmm_fit, gmm_predict_proba, isoforest_fit, isoforest_score, kmeans_fit, logreg_fit,
    logreg_predict_proba, run_auc_pipeline, run_compare_pipeline, run_gmm_pipeline, svm_fit,
    svm_predict, tsne_fit, ward_fit)
from pinnfc_tpu_torch.diagnosis.spectral import _bottom_k_subspace, knn_laplacian
from pinnfc_tpu_torch.diagnosis.tsne import _pairwise_sq_dists, conditional_p, joint_p, kl_and_grad
from pinnfc_tpu_torch.models.mlp import MLP
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.ops.mc_dropout import (
    dropout_constants, mc_dropout, mc_dropout_sums, mc_dropout_sums_plain)
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.physics.residuals import all_residuals
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results
from pinnfc_tpu_torch.risk import (
    compute_rf_time_series, estimate_mu_sigma_normal, run_risk_pipeline)
from pinnfc_tpu_torch.training.stages import train_dnn_chunk, train_dnn_stage
from pinnfc_tpu_torch.uq.mc_dropout import finish_mc_stats, mc_dropout_samples

from _torch_artifact import miniature_artifact


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
    with pytest.raises(ValueError, match="flagship"):
        td.train_dnn(MLP((8, 32, 32, 1), device=cuda_device), x, y, 0, 2, precision="default")
    with pytest.raises(ValueError, match="precision must be one of"):
        train_dnn_stage(MLP(device=cuda_device), x, y, 0, 2, precision="bf16")


def _rel_gap(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 37, 511, 513])
def test_train_kernel_bf16_form_matches_its_bf16_plain_version(cuda_device, n):
    """precision='default' runs: the bf16 form's one-step gradient within 1e-3
    of max|g| of the plain version with bf16 products (the worst tensor), the
    float32 plain gradient outside that band, on row counts ragged against its
    64-row CTAs and the 512-row mask blocks, and on a row shard at a global
    row offset that is not a multiple of 64 (its rows' masks and its terms of
    the whole mean); a 10-step stage launches the kernel once, repeats
    bitwise, and keeps loss[0] within rtol 1e-3."""
    mlp, x, y = _train_inputs(n, cuda_device)
    before = dict(build.LAUNCHES)
    _, k_g = td.step_grads(mlp, x, y, 3, 0, precision="default")
    assert build.LAUNCHES["train_dnn_grad"] == before["train_dnn_grad"] + 1
    thresh, inv_keep = dropout_constants(0.2)
    keep = td.keep_masks(n, mlp.dropout_widths(), 3, 0, thresh, cuda_device)
    ws = td.mlp_weights(mlp)
    _, p_g = td.loss_and_grads(ws, x, y, keep, inv_keep, td._inv_n(n), torch.bfloat16)
    _, f_g = td.loss_and_grads(ws, x, y, keep, inv_keep, td._inv_n(n))
    assert _rel_gap(k_g, p_g) <= 1e-3 < _rel_gap(f_g, p_g)
    lo = n // 3  # the shard's first global row
    lib = build.load()
    ks = td._to_kernel(lib, mlp, None)
    work, grad, loss, flag = td._grad_buffers(lib, x[lo:], ks.params.numel())
    td._launch_grad(lib, x[lo:].contiguous(), y[lo:].contiguous(), lo, ks.params, work, grad,
                    loss, flag, 3, 5, thresh, inv_keep, td._inv_n(n), "default")
    s_g = td.unflat_weights(td._flat_layout(grad, ks.ws, ks.offsets), mlp)
    s_keep = td.keep_masks(n - lo, mlp.dropout_widths(), 3, 5, thresh, cuda_device, lo)
    s_loss, sp_g = td.loss_and_grads(ws, x[lo:], y[lo:], s_keep, inv_keep, td._inv_n(n),
                                     torch.bfloat16)
    assert _rel_gap(s_g, sp_g) <= 1e-3 and int(flag[0]) == 0
    torch.testing.assert_close(loss[0], s_loss, rtol=1e-3, atol=0)
    res = train_dnn_stage(mlp, x, y, 3, 10, precision="default")
    assert build.LAUNCHES["train_dnn"] == before["train_dnn"] + 1
    again = td.train_dnn(mlp, x, y, 3, 10, precision="default")
    assert torch.equal(again.losses, res.losses)
    plain = td.train_dnn_stage_plain(mlp, x, y, 3, 10, product_dtype=torch.bfloat16)
    torch.testing.assert_close(res.losses[0], plain.losses[0], rtol=1e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 37])
def test_train_kernel_bf16_form_is_bitwise_repeatable_and_chunked(cuda_device, n):
    """The bf16 form has no float atomics: two 20-step stages are bitwise
    equal, and a stage run as 200 steps, then a chunk from step 200 with the
    carried Adam state, is bitwise the whole 210-step stage."""
    mlp, x, y = _train_inputs(n, cuda_device)
    hp = dict(lr_step=50, lr_gamma=0.5, precision="default")
    a = td.train_dnn(mlp, x, y, 3, 20, **hp)
    b = td.train_dnn(mlp, x, y, 3, 20, **hp)
    assert torch.equal(a.losses, b.losses)
    assert torch.equal(td.flat_weights(a.mlp), td.flat_weights(b.mlp))
    whole = td.train_dnn(mlp, x, y, 3, 210, **hp)
    first = td.train_dnn(mlp, x, y, 3, 200, **hp)
    rest = td.train_dnn(first.mlp, x, y, 3, 10, t0=200, state=first.state, **hp)
    assert torch.equal(rest.losses, whole.losses[200:])
    assert torch.equal(td.flat_weights(rest.mlp), td.flat_weights(whole.mlp))
    assert int(rest.state.count) == int(whole.state.count) == 210


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 37])
def test_train_kernel_3xtf32_gradient_is_float32_accurate(cuda_device, n):
    """The 3xTF32 form's one-step gradient is as close to a float64 gradient
    as the float32 plain version's (the worst tensor's max|Δg|/max|g| within
    4x of the float32 plain version's, or 1e-6).  With the three TF32
    products of all k steps in one mma.sync accumulator it read 1.1e-5 to
    1.5e-5 on an H100 against the float32 plain version's 3.3e-7 to 6.1e-7;
    each k8 step's products now meet in a fresh accumulator that is added to
    the sum in float32."""
    mlp, x, y = _train_inputs(n, cuda_device)
    thresh, inv_keep = dropout_constants(0.2)
    keep = td.keep_masks(n, mlp.dropout_widths(), 3, 0, thresh, cuda_device)
    ws = td.mlp_weights(mlp)
    _, k_g = td.step_grads(mlp, x, y, 3, 0)
    _, f_g = td.loss_and_grads(ws, x, y, keep, inv_keep, td._inv_n(n))
    _, d_g = td.loss_and_grads([w.double() for w in ws], x.double(), y.double(), keep,
                               inv_keep, td._inv_n(n))
    assert _rel_gap(k_g, d_g) <= max(4 * _rel_gap(f_g, d_g), 1e-6)


@pytest.mark.cuda
def test_non_flagship_default_runs_bf16_operand_autograd(cuda_device):
    """precision='default' on another topology: no kernel launch, the stage
    runs, and it differs from the float32 stage (its products are bf16)."""
    x = torch.rand(256, 8, device=cuda_device) * 2 - 1
    y = torch.rand(256, 1, device=cuda_device)
    mlp = MLP((8, 64, 64, 1), generator=torch.Generator().manual_seed(1), device=cuda_device)
    before = dict(build.LAUNCHES)
    a = train_dnn_stage(mlp, x, y, 2, 5, precision="default")
    b = train_dnn_stage(mlp, x, y, 2, 5, precision="highest")
    assert build.LAUNCHES == before
    assert bool(torch.isfinite(a.losses).all()) and not torch.equal(a.losses, b.losses)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 3])
@pytest.mark.parametrize("n", [1000, 37, 64, 65, 129, 191])
def test_mc_kernel_matches_bf16_plain(cuda_device, n, m):
    """N = 1,000 is ragged against the 128-row CTAs and the 256-row mask
    blocks (its last CTA's second 64-row warp group is partial); N = 37 fills
    part of one CTA; N = 64, 129 and 191 leave a CTA's second group empty, N =
    65 gives it one row.  m = 3 passes, odd, beside 64.  At 3 passes the
    kernel is held to the plain versions in pred_mean and aleatoric_std only:
    epistemic_std, the spread of three values, turns one flipped bf16
    rounding (the tensor cores accumulate in another order than the plain
    version) into a gap of 4.4e-3 relative at one row of 1,000, and the bf16
    plain version's own epistemic_std lies 3.4 times the float32 tolerance
    from the float32 one's (CPU, N = 191)."""
    x = torch.as_tensor(np.random.RandomState(1).uniform(-1.2, 1.2, (n, 8)).astype(np.float32),
                        device=cuda_device)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=cuda_device)
    seed = 123456789
    before = build.LAUNCHES["mc_dropout"]
    k_sums = mc_dropout_sums(mlp, x, seed, mc_times=m)
    assert build.LAUNCHES["mc_dropout"] == before + 1
    assert torch.equal(mc_dropout_sums(mlp, x, seed, mc_times=m), k_sums)
    k = finish_mc_stats(k_sums, m)
    b = finish_mc_stats(mc_dropout_sums_plain(mlp, x, seed, mc_times=m,
                                              sample_dtype=torch.bfloat16), m)
    f = finish_mc_stats(mc_dropout_sums_plain(mlp, x, seed, mc_times=m), m)
    torch.testing.assert_close(k.pred_mean, b.pred_mean, rtol=2e-5, atol=1e-6)
    for name in ("aleatoric_std", "epistemic_std") if m == 64 else ("aleatoric_std",):
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


@pytest.mark.cuda
def test_autograd_stage_on_the_card(cuda_device):
    """A (8, 64, 64, 64, 1) stage runs on the card without the training
    kernel, near its plain version under the same masks, and in chunks equal
    to the whole stage."""
    rs = np.random.RandomState(2)
    x = torch.as_tensor(rs.uniform(-1, 1, (1000, 8)).astype(np.float32), device=cuda_device)
    y = torch.as_tensor(rs.uniform(-1, 1, (1000, 1)).astype(np.float32), device=cuda_device)
    mlp = MLP((8, 64, 64, 64, 1), generator=torch.Generator().manual_seed(0), device=cuda_device)
    hp = dict(lr=1e-2, lr_step=5, lr_gamma=0.5, dropout_p=0.2)
    before = build.LAUNCHES["train_dnn"]
    whole = train_dnn_stage(mlp, x, y, 7, 20, **hp)
    assert build.LAUNCHES["train_dnn"] == before
    plain = td.train_dnn_stage_plain(mlp, x, y, 7, 20, **hp)
    torch.testing.assert_close(whole.losses, plain.losses, rtol=1e-5, atol=1e-7)
    for a, b in zip(td.mlp_weights(whole.params), td.mlp_weights(plain.mlp)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    piece, state, parts, start = mlp, None, [], 0
    for m in (7, 6, 7):
        piece, state, losses = train_dnn_chunk(piece, state, x, y, 7, start, m, **hp)
        parts.append(losses)
        start += m
    assert torch.equal(torch.cat(parts), whole.losses)
    for a, b in zip(td.mlp_weights(piece), td.mlp_weights(whole.params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_vmap_sampler_on_the_card(cuda_device, campaign_rows):
    mlp_cpu = MLP((8, 64, 64, 1), generator=torch.Generator().manual_seed(0), device="cpu")
    mlp = MLP((8, 64, 64, 1), generator=torch.Generator().manual_seed(0), device=cuda_device)
    x_cpu = campaign_rows.x_test[:300]
    x = x_cpu.to(cuda_device)

    def run(seed):
        return mc_dropout_samples(mlp, x, torch.Generator(cuda_device).manual_seed(seed),
                                  mc_times=800, dropout=0.4)[0]

    a, b = run(7), run(7)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with torch.no_grad():
        assert torch.equal(a.pred_mean, mlp(x)[0][:, 0])
    host, _ = mc_dropout_samples(mlp_cpu, x_cpu, torch.Generator().manual_seed(7),
                                 mc_times=800, dropout=0.4)
    for name, band in (("epistemic_std", 0.15), ("aleatoric_std", 0.1)):
        u, v = getattr(a, name).cpu(), getattr(host, name)
        assert float(torch.mean((u - v).abs() / (0.5 * (u + v) + 1e-9))) < band, name
    # the exporter takes 'vmap' for this topology; the MC kernel refuses it
    params = init_pinn((8, 64, 64, 1), generator=torch.Generator().manual_seed(0),
                       device=cuda_device)
    ds = combine_and_normalize(*synthesize_stack_data(n_normal=300, n_fault=40, seed=42),
                               device=cuda_device)
    before = dict(build.LAUNCHES)
    res, info = build_comprehensive_results(params, ds, mc_seed=5, mc_times=16)
    assert build.LAUNCHES["mc_dropout"] == before["mc_dropout"]
    assert info == {"sampler": "vmap", "mc_passes": 16}
    assert np.isfinite(res.array[:, 10:12]).all()
    with pytest.raises(ValueError, match="flagship"):
        mc_dropout(params["mlp"], ds.x_test, 5, mc_times=16)


def _ramped_results():
    """tests/test_risk.py's campaign-scale artifact: 12 slow-onset fault
    segments of 1,050 rows (columns: 0 current, 8 voltage, 12-16 residuals,
    17 label)."""
    rng = np.random.RandomState(7)
    n_normal, n_fault = 2000, 1050
    arr = np.zeros((n_normal + 12 * n_fault, 22))
    arr[:, 8] = 4.0 + 0.01 * rng.randn(arr.shape[0])
    arr[:, 12:17] = 0.1 * rng.randn(arr.shape[0], 5)
    arr[:n_normal, 0] = rng.uniform(100, 400, n_normal)
    ramp = np.clip((np.linspace(0.0, 1.0, n_fault) - 0.25) / 0.75, 0.0, 1.0)
    for seg in range(12):
        rows = slice(n_normal + seg * n_fault, n_normal + (seg + 1) * n_fault)
        arr[rows, 17] = seg + 1
        arr[rows, 0] = (108.0, 270.0, 405.0)[seg % 3]
        arr[rows, 12] += ramp * 0.35
        arr[rows, 13] += ramp * 0.3
        arr[rows, 14] += ramp * 0.25
        arr[rows, 8] = 4.0 - ramp * 0.15
    return arr


@pytest.mark.cuda
def test_risk_torch_backend_on_the_card(cuda_device):
    arr = _ramped_results()
    on_card = run_risk_pipeline(arr, backend="torch", device=cuda_device)
    on_host = run_risk_pipeline(arr, backend="numpy")
    assert len(on_card) == len(on_host) == 12
    for a, b in zip(on_card, on_host):
        assert (a.fault_name, a.current_target, a.n_samples, a.idx_v_alarm, a.idx_rf_alarm,
                a.advance) == (b.fault_name, b.current_target, b.n_samples, b.idx_v_alarm,
                               b.idx_rf_alarm, b.advance)
    mu, sigma = estimate_mu_sigma_normal(arr)
    r = arr[2000:3050, 12:17]
    got = compute_rf_time_series(r, mu, sigma, backend="torch", device=cuda_device)
    want = compute_rf_time_series(r, mu, sigma, backend="numpy")
    tol = {"s_tot": (1e-4, 1e-5), "c": (1e-3, 1e-3), "rf_inst": (1e-3, 1e-4),
           "rf_smooth": (1e-3, 1e-4)}
    for key, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=key)


def _blobs(seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[0, 0, 0, 0], [6, 0, 0, 0], [0, 6, 0, 0], [0, 0, 6, 6]], dtype=float)
    x = np.vstack([c + rng.randn(500, 4) for c in centers])
    y = np.repeat(np.arange(4), 500)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


@pytest.mark.cuda
def test_forest_on_the_card_is_the_cpu_forest(cuda_device):
    rng = np.random.RandomState(7)
    x_fit, x_te = rng.randn(600, 2) * [0.4, 0.6], rng.randn(14040, 2)
    on_card = isoforest_fit(x_fit, torch.Generator().manual_seed(49), device=cuda_device)
    on_host = isoforest_fit(x_fit, torch.Generator().manual_seed(49), device="cpu")
    for name in ("feature", "threshold", "size"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_host, name)), name
    np.testing.assert_allclose(isoforest_score(on_card, x_te).cpu().numpy(),
                               isoforest_score(on_host, x_te).numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        isoforest_fit(x_fit, torch.Generator(device=cuda_device), device=cuda_device)


@pytest.mark.cuda
def test_kmeans_and_logreg_on_the_card_match_the_cpu(cuda_device):
    x, y = _blobs()
    on_card = kmeans_fit(x, torch.Generator().manual_seed(0), 20, max_iter=50,
                         device=cuda_device)
    on_host = kmeans_fit(x, torch.Generator().manual_seed(0), 20, max_iter=50, device="cpu")
    assert torch.equal(on_card.assignments.cpu(), on_host.assignments)
    assert float(on_card.inertia) == pytest.approx(float(on_host.inertia), rel=1e-5)
    for k, xs in ((4, x), (2, x[:, :2])):
        yk = y if k == 4 else (y > 0).astype(int)
        m_card = logreg_fit(xs, yk, n_classes=k, device=cuda_device)
        m_host = logreg_fit(xs, yk, n_classes=k, device="cpu")
        assert m_card.n_iter == m_host.n_iter
        np.testing.assert_allclose(logreg_predict_proba(m_card, xs).cpu().numpy(),
                                   logreg_predict_proba(m_host, xs).numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_em_on_the_card_matches_the_cpu(cuda_device):
    x, _ = _blobs(1)
    on_card = gmm_fit(x, torch.Generator().manual_seed(42), 20, device=cuda_device)
    on_host = gmm_fit(x, torch.Generator().manual_seed(42), 20, device="cpu")
    assert (on_card.n_iter, on_card.converged) == (on_host.n_iter, on_host.converged)
    agree = (gmm_predict_proba(on_card, x).argmax(1).cpu() ==
             gmm_predict_proba(on_host, x).argmax(1)).double().mean()
    assert float(agree) >= 0.999
    assert on_card.lower_bound == pytest.approx(on_host.lower_bound, rel=1e-4)
    resp = np.eye(20)[np.arange(len(x)) % 20]
    f64 = [gmm_fit(x, None, 20, init_resp=resp, dtype="float64", device=d)
           for d in (cuda_device, "cpu")]
    assert f64[0].n_iter == f64[1].n_iter
    for name in ("weights", "means", "covariances"):
        np.testing.assert_allclose(getattr(f64[0], name).cpu().numpy(),
                                   getattr(f64[1], name).numpy(), rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_sklearn_paths_raise_without_sklearn(cuda_device, monkeypatch):
    import sys

    rng = np.random.RandomState(0)
    arr = np.zeros((400, 22))
    arr[:, 11:17] = rng.randn(400, 6)
    arr[:, 17] = np.arange(400) % 13
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        run_gmm_pipeline(arr, GmmConfig(init="sklearn"), device=cuda_device)
    with pytest.raises(ImportError, match="scikit-learn"):
        run_auc_pipeline(arr, AucConfig(iso_backend="sklearn", feature_groups=("epi,res",)),
                         device=cuda_device)


@pytest.mark.cuda
def test_svm_and_lbfgs_logreg_on_the_card_match_the_cpu(cuda_device):
    x, y = _blobs()
    x = x + 2.0 * np.random.RandomState(1).randn(*x.shape)  # overlapping classes
    on_card = svm_fit(x, y, n_classes=4, device=cuda_device)
    on_host = svm_fit(x, y, n_classes=4, device="cpu")
    scale = float(on_host.coef.abs().max())
    np.testing.assert_allclose(on_card.coef.cpu().numpy(), on_host.coef.numpy(), rtol=0,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(on_card.intercept.cpu().numpy(), on_host.intercept.numpy(),
                               rtol=0, atol=1e-3 * scale)
    agree = (svm_predict(on_card, x).cpu() == svm_predict(on_host, x)).double().mean()
    assert float(agree) >= 0.995
    m_card = logreg_fit(x, y, n_classes=4, solver="lbfgs", device=cuda_device)
    m_host = logreg_fit(x, y, n_classes=4, solver="lbfgs", device="cpu")
    newton = logreg_fit(x, y, n_classes=4, solver="newton", device=cuda_device)
    p_card = logreg_predict_proba(m_card, x).cpu().numpy()
    np.testing.assert_allclose(p_card, logreg_predict_proba(m_host, x).numpy(), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(p_card, logreg_predict_proba(newton, x).cpu().numpy(), rtol=0,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,algorithm", [(600, "global"), (2400, "auto")])
def test_ward_on_the_card_is_the_cpu_ward(cuda_device, n, algorithm):
    """N = 2,400 takes the NN-chain ("auto" above 2,048)."""
    x = np.random.RandomState(n).randn(n, 4)
    on_card = ward_fit(x, 16, algorithm=algorithm, device=cuda_device)
    on_host = ward_fit(x, 16, algorithm=algorithm, device="cpu")
    assert torch.equal(on_card.assignments.cpu(), on_host.assignments)
    np.testing.assert_allclose(on_card.centers.cpu().numpy(), on_host.centers.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_spectral_on_the_card(cuda_device):
    x = torch.as_tensor(_blobs()[0][:600], dtype=torch.float32)
    idx_card, lap_card, _ = knn_laplacian(x.to(cuda_device), 10)
    idx_host, lap_host, _ = knn_laplacian(x, 10)
    for a, b in zip(idx_card.cpu().numpy(), idx_host.numpy()):
        assert set(a) == set(b)
    torch.testing.assert_close(lap_card.cpu(), lap_host, rtol=0, atol=1e-6)

    def projector(v):
        v = v.double()
        return v @ v.T

    p_eigh = projector(torch.linalg.eigh(lap_card)[1][:, :16])
    sub, steps = _bottom_k_subspace(lap_card, 16, torch.Generator().manual_seed(0))
    assert 0 < steps < 3000
    assert float((projector(sub) - p_eigh).abs().max()) <= 1e-3
    assert float((projector(torch.linalg.eigh(lap_host)[1][:, :16]) - p_eigh.cpu())
                 .abs().max()) <= 1e-3


@pytest.mark.cuda
def test_tsne_on_the_card_matches_the_cpu(cuda_device):
    x = _blobs()[0][:300]
    on_card = tsne_fit(x, perplexity=20.0, device=cuda_device)
    on_host = tsne_fit(x, perplexity=20.0, device="cpu")
    assert on_card.embedding.is_cuda and torch.isfinite(on_card.embedding).all()
    assert float(on_card.kl_divergence) == pytest.approx(float(on_host.kl_divergence), rel=0.1)


@pytest.mark.cuda
def test_compare_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    import sys

    arr = miniature_artifact()
    on_card = run_compare_pipeline(arr, device=cuda_device)
    on_host = run_compare_pipeline(arr, device="cpu")
    np.testing.assert_array_equal(on_card.y_true, on_host.y_true)
    for a, b in zip(on_card.methods, on_host.methods):
        assert a.name == b.name
        if a.name in ("Supervised_LR", "Supervised_SVM", "Agglomerative"):
            assert (a.y_pred == b.y_pred).mean() >= 0.995, a.name
        assert abs(a.metrics["f1_macro"] - b.metrics["f1_macro"]) <= 0.05, a.name
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        run_compare_pipeline(arr, methods=["agglomerative"], device_ward=False,
                             device=cuda_device)


@pytest.mark.cuda
def test_saliency_and_identifiability_on_the_card_match_the_cpu(cuda_device):
    from pinnfc_tpu_torch.uq import coarse_class_saliency, input_saliency, lambda_identifiability

    normal, faults = synthesize_stack_data(n_normal=600, n_fault=60, seed=42)
    sal, ident = {}, {}
    for dev in (cuda_device, "cpu"):
        ds = combine_and_normalize(normal, faults, device=dev)
        params = init_pinn(generator=torch.Generator().manual_seed(0), device=dev)
        params["lam_v"] = torch.tensor([0.2, 2.0e-6, 1.2, 1.0], device=dev)  # rows past i_l
        x_norm = ds.x_test.cpu().numpy()
        bounds = list(ds.info.boundary_lines)
        labels = np.zeros(len(x_norm), int)
        for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]), start=1):
            labels[lo:hi] = k
        x_phys = ds.scaler_x.inverse(x_norm)
        sal[str(dev)] = input_saliency(params, x_phys, ds.scaler_x, ds.scaler_y, labels=labels,
                                       device=dev)
        ident[str(dev)] = lambda_identifiability(params, x_norm, ds.scaler_x, ds.scaler_y)
    card, host = sal["cuda"], sal["cpu"]
    for field in ("jac_norm", "jac_range"):
        np.testing.assert_allclose(getattr(card, field), getattr(host, field), rtol=1e-4,
                                   atol=1e-6)
    for name, row in coarse_class_saliency(card).items():
        assert np.argmax(row) == np.argmax(coarse_class_saliency(host)[name])
    assert ident["cuda"]["lam_v"].n_dropped > 0
    for group, c in ident["cuda"].items():
        h = ident["cpu"][group]
        np.testing.assert_array_equal(c.identifiable, h.identifiable)
        np.testing.assert_array_equal(c.at_bound, h.at_bound)
        assert c.n_dropped == h.n_dropped
        fin = np.isfinite(h.stderr)
        np.testing.assert_array_equal(np.isfinite(c.stderr), fin)
        np.testing.assert_allclose(c.stderr[fin], h.stderr[fin], rtol=1e-3)


@pytest.mark.cuda
def test_tsne_embed_on_the_card_matches_the_cpu(cuda_device):
    from pinnfc_tpu_torch.viz import tsne_embed

    x = _blobs()[0][:300]
    on_card = tsne_embed(x, perplexity=20.0, device=cuda_device)
    on_host = tsne_embed(x, perplexity=20.0, device="cpu")
    assert on_card.dtype == np.float64 and np.isfinite(on_card).all()
    p = joint_p(conditional_p(_pairwise_sq_dists(torch.as_tensor(x, dtype=torch.float32)), 20.0))
    kls = [float(kl_and_grad(torch.as_tensor(e, dtype=torch.float32), p)[0])
           for e in (on_card, on_host)]
    assert kls[0] == pytest.approx(kls[1], rel=0.1)


def _nonfinite_rows(x, u):
    """Copies of x (N, 8) and u (N, 1) with NaN, +inf and -inf in each input
    channel in turn and a NaN u, at ragged rows (as chip_smoke.py phase 3)."""
    x, u = x.clone(), u.clone()
    n = x.shape[0]
    rows = [(3 * k + 7) % n if n < 100 else (613 * k + 7) % n for k in range(25)]
    for k, r in enumerate(rows[:24]):
        x[r, k % 8] = (float("nan"), float("inf"), float("-inf"))[k // 8]
    u[rows[24]] = float("nan")
    return x, u


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15600, 37])
def test_residual_kernel_on_nonfinite_rows(cuda_device, campaign_rows, n):
    """NaN, ±inf in each input channel and a NaN u: the kernel's NaN sets are
    the plain version's (whose NaN sets are JAX's, tests/test_torch_monitor.py);
    a NaN stack current leaves the gas ratios NaN."""
    ds = campaign_rows
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)
    sx, sy = ds.scaler_x.to(cuda_device), ds.scaler_y.to(cuda_device)
    x = ds.x_test[:n].to(cuda_device)
    with torch.no_grad():
        u = params["mlp"](x)[0]
    x, u = _nonfinite_rows(x, u)
    got = all_residuals_kernel(params, x, u, sx, sy)
    want = all_residuals(params, x, u, sx, sy)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f"{name}: NaN sets differ"
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, equal_nan=True, msg=name)
    nan_current = torch.isnan(x[:, 0])
    assert bool(torch.isnan(got.ratio_h[nan_current]).all())
    assert bool(torch.isnan(got.ratio_o[nan_current]).all())


def _monitor_inputs():
    """(x_raw (N, 8), v (N,)) of a small campaign with glitches, and a
    factory of monitors (head, conformal ACI) on a device."""
    from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor

    normal, faults = synthesize_stack_data(n_normal=600, n_fault=60, seed=42)
    ds = combine_and_normalize(normal, faults, device="cpu")
    x = ds.scaler_x.inverse(ds.x_test.numpy()).astype(np.float32)
    v = ds.scaler_y.inverse(ds.y_test.numpy())[:, 0].astype(np.float32)
    x[100:103] = np.nan
    x[400, 0] = np.nan
    x[401, 3] = np.inf
    v[500:530] = np.nan
    mu = np.zeros(5)
    sigma = np.array([0.05, 0.05, 2.0, 0.1, 0.2])
    calib = np.abs(0.05 * np.random.RandomState(0).randn(200)).astype(np.float32)

    def make(dev):
        params = init_pinn(generator=torch.Generator().manual_seed(0), device=dev)
        head = DiagnosisHead(
            gmm=gmm_fit(np.random.RandomState(1).randn(400, 4).astype(np.float32),
                        torch.Generator().manual_seed(0), 3, device=dev),
            comp_fault_prob=torch.tensor([[0.7, 0.3], [0.2, 0.8], [0.5, 0.5]], device=dev),
            class_names=("a", "b"), feature_indices=(1, 2, 3, 4))
        return OnlineMonitor(params, ds.scaler_x.to(dev), ds.scaler_y.to(dev), mu, sigma,
                             diagnosis=head, glitch_alarm_n=5, conformal_calib=calib,
                             conformal_gamma=0.01, device=dev)
    return x, v, make


@pytest.mark.cuda
def test_monitor_on_the_card_matches_the_cpu(cuda_device):
    """``observe`` in blocks of 64 and ``observe_many`` of 3 streams on the
    card against the same monitor on the CPU: the series at rtol 1e-5 (atol
    1e-5; 1e-4 for layer_c), the flags equal, the p-value ranks equal; one
    residual-kernel launch per call."""
    x, v, make = _monitor_inputs()
    card, host = make(cuda_device), make("cpu")
    before = build.LAUNCHES["residuals"]
    calls = 0
    for lo in range(0, 640, 64):
        a = card.observe(x[lo:lo + 64], v[lo:lo + 64])
        b = host.observe(x[lo:lo + 64], v[lo:lo + 64])
        calls += 1
        _same_monitor_out(a, b)
    xb = np.stack([x[0:64], x[200:264], x[500:564]])
    vb = np.stack([v[0:64], v[200:264], v[500:564]])
    got = card.observe_many(xb, vb, ["a", "b", "c"])
    want = host.observe_many(xb, vb, ["a", "b", "c"])
    calls += 1
    assert build.LAUNCHES["residuals"] == before + calls
    for k in got:
        _same_monitor_out(got[k], want[k])
    assert card.stream_low_p() == host.stream_low_p()
    np.testing.assert_array_equal(card.stream_oob_counts(), host.stream_oob_counts())


def _same_monitor_out(a, b):
    for f, atol in (("rf_inst", 1e-5), ("rf_smooth", 1e-5), ("residuals", 1e-5),
                    ("v_pred", 1e-5), ("layer_scores", 1e-5), ("layer_c", 1e-4),
                    ("fault_probs", 1e-4), ("aci_alpha", 1e-6)):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f)
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=atol, equal_nan=True, err_msg=f)
    for f in ("warn", "danger", "v_alarm", "glitch", "sensor_alarm", "oob", "aci_anomaly"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(np.rint(a.conformal_p * 201), np.rint(b.conformal_p * 201))


@pytest.mark.cuda
def test_counterfactual_on_the_card_matches_the_cpu(cuda_device):
    """A 40-step gain-mode solve of 200 rows on the card against the CPU:
    δ (fraction of range) within 2e-5, v_after within 2e-6 V, recovered
    equal (tests/test_torch_counterfactual.py's tolerances against JAX)."""
    from pinnfc_tpu_torch.uq import CounterfactualConfig, counterfactual_recovery

    normal, faults = synthesize_stack_data(n_normal=600, n_fault=60, seed=42)
    reps = {}
    for dev in (cuda_device, "cpu"):
        ds = combine_and_normalize(normal, faults, device=dev)
        params = init_pinn(generator=torch.Generator().manual_seed(0), device=dev)
        x = ds.scaler_x.inverse(ds.x_test.cpu().numpy())[-200:]
        v = ds.scaler_y.inverse(ds.y_test.cpu().numpy())[-200:, 0]
        reps[str(dev)] = counterfactual_recovery(params, x, v + 0.005, ds.scaler_x, ds.scaler_y,
                                                 config=CounterfactualConfig(steps=40),
                                                 v_meas=v, device=dev)
    card, host = reps["cuda"], reps["cpu"]
    np.testing.assert_allclose(card.v_before, host.v_before, atol=1e-6)
    np.testing.assert_allclose(card.v_after, host.v_after, atol=2e-6)
    np.testing.assert_allclose(card.delta_range, host.delta_range, atol=2e-5)
    np.testing.assert_array_equal(card.recovered, host.recovered)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15600, 37])
def test_registered_residual_operator_on_the_card(cuda_device, campaign_rows, n):
    """``pinnfc_torch::residuals`` on CUDA tensors launches the kernel once
    and agrees with the plain version (rtol = atol = 2e-5, NaN sets equal);
    its fake form gives the (8, N) float32 shape."""
    from pinnfc_tpu_torch.ops.residuals import kernel_scalars, residuals_op

    ds = campaign_rows
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)
    params["lam_v"][2] = 1.2
    sx, sy = ds.scaler_x.to(cuda_device), ds.scaler_y.to(cuda_device)
    x = ds.x_test[:n].to(cuda_device)
    with torch.no_grad():
        u = params["mlp"](x)[0][:, 0].contiguous()
    scalars = kernel_scalars(params, sx, sy)
    before = build.LAUNCHES["residuals"]
    got = residuals_op(x, u, *(scalars[k] for k in build.RESIDUAL_SCALAR_SIZES))
    assert build.LAUNCHES["residuals"] == before + 1
    assert got.shape == (8, n) and got.dtype == torch.float32 and got.device == x.device
    want = all_residuals(params, x, u[:, None], sx, sy)
    for row, w in zip(got, want):
        assert torch.equal(torch.isnan(row), torch.isnan(w[:, 0]))
        torch.testing.assert_close(row, w[:, 0], rtol=2e-5, atol=2e-5, equal_nan=True)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = residuals_op(torch.empty(5, 8, device=cuda_device),
                            torch.empty(5, device=cuda_device),
                            *(scalars[k] for k in build.RESIDUAL_SCALAR_SIZES))
    assert fake.shape == (8, 5) and fake.dtype == torch.float32


@pytest.mark.cuda
def test_exported_monitor_step_moved_to_the_card(cuda_device):
    """A monitor step exported on the CPU and moved to CUDA: bitwise the eager
    monitor on the card (the same traced function, the same kernel), one
    residual-kernel launch per ``observe``; the fleet artifact one launch per
    ``observe_many``."""
    from pinnfc_tpu_torch.serving import (
        export_monitor_fleet_step, export_monitor_step, monitor_from_artifact)

    x, v, make = _monitor_inputs()
    src, eager = make("cpu"), make(cuda_device)
    kw = dict(class_names=("a", "b"), glitch_alarm_n=5, conformal_gamma=0.01,
              device=cuda_device)
    art = monitor_from_artifact(export_monitor_step(src), src.mu.numpy(), src.sigma.numpy(),
                                **kw)
    for lo in range(0, 640, 64):
        before = build.LAUNCHES["residuals"]
        a = art.observe(x[lo:lo + 64], v[lo:lo + 64])
        assert build.LAUNCHES["residuals"] == before + 1
        b = eager.observe(x[lo:lo + 64], v[lo:lo + 64])
        for f in ("rf_smooth", "rf_inst", "residuals", "v_pred", "layer_c", "fault_probs",
                  "conformal_p", "aci_alpha", "warn", "glitch", "oob", "aci_anomaly"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    fleet = monitor_from_artifact(export_monitor_fleet_step(src), src.mu.numpy(),
                                  src.sigma.numpy(), **kw)
    xb = np.stack([x[0:64], x[200:264], x[500:564]])
    vb = np.stack([v[0:64], v[200:264], v[500:564]])
    before = build.LAUNCHES["residuals"]
    got = fleet.observe_many(xb, vb, ["a", "b", "c"])
    assert build.LAUNCHES["residuals"] == before + 1
    want = make(cuda_device).observe_many(xb, vb, ["a", "b", "c"])
    for k in got:
        np.testing.assert_array_equal(got[k].rf_smooth, want[k].rf_smooth)
        np.testing.assert_array_equal(got[k].residuals, want[k].residuals)


@pytest.mark.cuda
def test_mc_kernel_block0_shards_equal_the_whole_run(cuda_device):
    """The MC kernel on two row shards split at a multiple of 256 rows (each
    with its first mask block, ``block0``) equals one launch over all 1,000
    rows bit for bit; ``mc_dropout_sharded`` on ``[cuda:0] * 3`` likewise."""
    from pinnfc_tpu_torch.parallel.ensemble import mc_dropout_sharded
    from pinnfc_tpu_torch.parallel.mesh import make_mesh

    x = torch.as_tensor(np.random.RandomState(1).uniform(-1.2, 1.2, (1000, 8)).astype(np.float32),
                        device=cuda_device)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=cuda_device)
    whole = mc_dropout_sums(mlp, x, 5, mc_times=32)
    before = build.LAUNCHES["mc_dropout"]
    parts = [mc_dropout_sums(mlp, x[:512], 5, mc_times=32, block0=0),
             mc_dropout_sums(mlp, x[512:], 5, mc_times=32, block0=2)]
    assert build.LAUNCHES["mc_dropout"] == before + 2
    assert torch.equal(torch.cat(parts), whole)
    got, passes = mc_dropout_sharded(mlp, x, 5, make_mesh(devices=["cuda:0"] * 3), mc_times=32)
    assert passes == 32
    assert all(torch.equal(a, b) for a, b in zip(got, finish_mc_stats(whole, 32)))


@pytest.mark.cuda
def test_sharded_dnn_stage_matches_the_whole_stage_kernel(cuda_device):
    """The data-parallel DNN stage on ``[cuda:0] * 3`` (1,000 rows in pieces
    of 334, 334 and 332, straddling the 512-row mask blocks; one grad launch
    per piece and one Adam launch per step) against the whole-stage kernel at
    test_train_kernel_matches_plain's tolerances; its per-shard plain version
    likewise."""
    from pinnfc_tpu_torch.parallel.mesh import block_sizes, make_mesh, split_rows

    mlp, x, y = _train_inputs(1000, cuda_device)
    hp = dict(lr_step=4, lr_gamma=0.5, dropout_p=0.2)
    devices = make_mesh(devices=["cuda:0"] * 3).axis_devices("data")
    shards = split_rows([x, y], block_sizes(1000, 3, 1), devices)
    whole = td.train_dnn(mlp, x, y, 3, 10, **hp)
    before = dict(build.LAUNCHES)
    got = td.train_dnn_sharded(mlp, shards, 3, 10, **hp)
    assert build.LAUNCHES["train_dnn_grad"] == before["train_dnn_grad"] + 30
    assert build.LAUNCHES["train_dnn_adam"] == before["train_dnn_adam"] + 10
    plain = td.train_dnn_sharded_plain(mlp, shards, 3, 10, **hp)
    for other in (whole, plain):
        torch.testing.assert_close(got.losses[0], other.losses[0], rtol=2e-5, atol=0)
        torch.testing.assert_close(got.losses, other.losses, rtol=5e-3, atol=1e-5)
        for a, b in zip(td.mlp_weights(got.mlp), td.mlp_weights(other.mlp)):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-3)
    assert int(got.state.count) == 10
    again = td.train_dnn_sharded(mlp, shards, 3, 10, **hp)
    assert torch.equal(again.losses, got.losses)


@pytest.mark.cuda
def test_ensemble_members_are_lone_stages_on_the_card(cuda_device):
    """A 2-member flagship ensemble (one training-kernel launch per member)
    equals two lone ``train_dnn_stage`` calls with the members' seeds, bit
    for bit."""
    from pinnfc_tpu_torch.parallel.ensemble import init_ensemble, member_seed, train_dnn_ensemble

    _, x, y = _train_inputs(1000, cuda_device)
    ens = init_ensemble(3, 2, device=cuda_device)
    before = build.LAUNCHES["train_dnn"]
    trained, losses = train_dnn_ensemble(ens, x, y, 11, 20)
    assert build.LAUNCHES["train_dnn"] == before + 2
    for e in range(2):
        lone = train_dnn_stage(ens["mlp"][e], x, y, member_seed(11, e), 20)
        assert torch.equal(lone.losses, losses[e])
        assert torch.equal(td.flat_weights(lone.params), td.flat_weights(trained["mlp"][e]))


@pytest.fixture
def card_mesh(cuda_device):
    """A ``"data"`` mesh over every visible card, each listed once."""
    from pinnfc_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards: a mesh of distinct cards")
    return make_mesh()


@pytest.mark.cuda
def test_mc_dropout_sharded_over_distinct_cards(card_mesh):
    """``mc_dropout_sharded`` with its row shards on distinct cards (each
    launch on a card that is not the current one) equals one launch over all
    rows on the first card, bit for bit."""
    from pinnfc_tpu_torch.parallel.ensemble import mc_dropout_sharded

    dev0 = card_mesh.axis_devices("data")[0]
    x = torch.as_tensor(np.random.RandomState(1).uniform(-1.2, 1.2, (1000, 8)).astype(np.float32),
                        device=dev0)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=dev0)
    whole = mc_dropout_sums(mlp, x, 5, mc_times=32)
    got, passes = mc_dropout_sharded(mlp, x, 5, card_mesh, mc_times=32)
    assert passes == 32 and got[0].device == dev0
    assert all(torch.equal(a, b) for a, b in zip(got, finish_mc_stats(whole, 32)))


@pytest.mark.cuda
def test_sharded_dnn_stage_over_distinct_cards(card_mesh):
    """The data-parallel DNN stage with its row shards on distinct cards
    equals the same shards all on the first card bit for bit (the same
    kernels on the same rows, summed in the same order)."""
    from pinnfc_tpu_torch.parallel.mesh import shard_batch

    devices = card_mesh.axis_devices("data")
    mlp, x, y = _train_inputs(250 * len(devices), devices[0])
    hp = dict(lr_step=4, lr_gamma=0.5, dropout_p=0.2)
    spread = shard_batch(card_mesh, x, y)
    assert spread.devices == devices
    one = spread._replace(parts=tuple((a.to(devices[0]), b.to(devices[0]))
                                      for a, b in spread.parts))
    got = td.train_dnn_sharded(mlp, spread, 3, 10, **hp)
    want = td.train_dnn_sharded(mlp, one, 3, 10, **hp)
    assert torch.equal(got.losses, want.losses)
    assert torch.equal(td.flat_weights(got.mlp), td.flat_weights(want.mlp))


@pytest.mark.cuda
def test_ensemble_over_distinct_cards(card_mesh):
    """``train_dnn_ensemble`` with its members split over distinct cards
    equals the ensemble without a mesh bit for bit, the trained MLPs back on
    x's card; the residual kernel on the last card against its plain
    version."""
    from pinnfc_tpu_torch.parallel.ensemble import init_ensemble, train_dnn_ensemble

    devices = card_mesh.axis_devices("data")
    _, x, y = _train_inputs(1000, devices[0])
    ens = init_ensemble(3, len(devices), device=devices[0])
    got, got_l = train_dnn_ensemble(ens, x, y, 11, 20, mesh=card_mesh)
    want, want_l = train_dnn_ensemble(ens, x, y, 11, 20)
    assert torch.equal(got_l, want_l)
    for a, b in zip(got["mlp"], want["mlp"]):
        assert next(a.parameters()).device == devices[0]
        assert torch.equal(td.flat_weights(a), td.flat_weights(b))
    last = devices[-1]
    ds = combine_and_normalize(*synthesize_stack_data(n_normal=300, n_fault=40, seed=0),
                               device=last)
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=last)
    with torch.no_grad():
        u = params["mlp"](ds.x_test)[0]
    kb = all_residuals_kernel(params, ds.x_test, u, ds.scaler_x, ds.scaler_y)
    pb = all_residuals(params, ds.x_test, u, ds.scaler_x, ds.scaler_y)
    for a, b in zip(kb, pb):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, equal_nan=True)


def _sharded_fleet_against_one_card(mesh, cuda_device):
    """Five streams of 64 rows through ``observe_many`` of a monitor sharded
    over ``mesh`` and of the same monitor unsharded, two rounds: one
    residual-kernel launch per shard and call, the outputs at
    ``_same_monitor_out``'s tolerances, the carried states' flags equal."""
    x, v, make = _monitor_inputs()
    sharded, plain = make(cuda_device), make(cuda_device)
    sharded.mesh = mesh
    xb = np.stack([x[64 * i:64 * (i + 1)] for i in range(5)])
    vb = np.stack([v[64 * i:64 * (i + 1)] for i in range(5)])
    keys = [f"s{i}" for i in range(5)]
    for rnd in range(2):
        before = build.LAUNCHES["residuals"]
        got = sharded.observe_many(xb + np.float32(0.01 * rnd), vb, keys)
        assert build.LAUNCHES["residuals"] == before + mesh.shape["data"]
        want = plain.observe_many(xb + np.float32(0.01 * rnd), vb, keys)
        for k in keys:
            _same_monitor_out(got[k], want[k])
            assert sharded._streams[k].v_first_set == plain._streams[k].v_first_set
    assert set(sharded.streams) == {"default", *keys}


@pytest.mark.cuda
def test_sharded_fleet_step_on_one_card(cuda_device):
    """The sharded fleet step on a mesh that lists the card three times (one
    dummy stream) against the unsharded step."""
    from pinnfc_tpu_torch.parallel.mesh import make_mesh

    _sharded_fleet_against_one_card(make_mesh(devices=["cuda:0"] * 3), cuda_device)


@pytest.mark.cuda
def test_sharded_fleet_step_over_distinct_cards(card_mesh, cuda_device):
    """The sharded fleet step with its stream shards on distinct cards (the
    monitor's copy on each, made once) against the unsharded step on the
    first card."""
    _sharded_fleet_against_one_card(card_mesh, cuda_device)


@pytest.mark.cuda
def test_doctor_probe_reports_the_kernels_capability(cuda_device):
    from pinnfc_tpu_torch.utils import doctor

    res = doctor.probe_backend(300, "cuda")
    assert res["ok"] and res["platform"] == "cuda", res
    assert tuple(res["capability"]) == doctor.KERNEL_CAPABILITY == (9, 0)


@pytest.mark.cuda
def test_doctor_smoke_train_through_the_kernel(cuda_device):
    from pinnfc_tpu_torch.utils import doctor

    res = doctor.smoke_train(900, "cuda")
    assert res["ok"] and np.isfinite(res["final_loss"]), res
    assert res["train_dnn_launches"] == 2 and res["steps_per_sec"] > 0


@pytest.mark.cuda
def test_production_memory_report_fits_the_card(cuda_device):
    from pinnfc_tpu_torch.config import TrainConfig
    from pinnfc_tpu_torch.utils.memory import production_memory_report

    recs = production_memory_report(TrainConfig(), device="cuda")
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    assert [r["program"] for r in recs][-1] == "monitor_fleet[S64,b64]"
    assert "mc_kernel[2000]" in [r["program"] for r in recs]
    assert all(r["total_bytes"] == total and 0 <= r["peak_bytes"] <= r["resident_bytes"] < total
               for r in recs), recs


@pytest.mark.cuda
def test_warmup_then_coverage_is_complete(cuda_device):
    import argparse

    from pinnfc_tpu_torch.cli._common import _train_config
    from pinnfc_tpu_torch.utils import warmup

    cfg = _train_config(argparse.Namespace(small=True, seed=42, steps_scale=None,
                                           precision=None, skip_nonfinite=False))
    dataset = warmup._dataset_for(cfg, 300, 40, device=cuda_device)
    records = warmup.warm_cache(warmup.production_lowerings(cfg, dataset), cuda_device,
                                verbose=False)
    assert f"mc_kernel[{cfg.mc_times}]" in [r["program"] for r in records]
    # what was warmed just now loads the built library; entries a manifest
    # kept from before an edit of the sources may stay stale beside them
    cov = warmup.warmup_coverage()
    assert cov["ok"], cov
    assert {f"cuda:{r['program']}" for r in records} <= set(cov["present"]), cov


@pytest.mark.cuda
def test_bench_line_has_both_forms(cuda_device):
    from pinnfc_tpu_torch import bench

    doc = bench.run("cuda")
    assert doc["value"] > 0 and doc["throughput_steady_steps_per_sec"] > 0, doc
    assert doc["vs_baseline"] > 0


def _profiled(fn):
    """``fn()`` under a CPU and CUDA profiler: (its result, device events,
    the program's ``pinnfc.`` host events), each (name, start, end) in ns of
    the profiler's clock, by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        item = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if str(ev.device_type()).endswith("CUDA"):
            device.append(item)
        elif item[0].startswith("pinnfc."):
            spans.append(item)
    return out, sorted(device, key=lambda d: d[1]), sorted(spans, key=lambda s: s[1])


def _inside(outer, events):
    return all(outer[1] <= s and e <= outer[2] for _, s, e in events)


@pytest.mark.cuda
def test_export_spans_share_the_device_clock(cuda_device):
    """The program's spans put nothing on the device timeline, and every
    device operation of one export lies inside its ``pinnfc.export`` span:
    host spans and device events are on one clock."""
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)
    ds = combine_and_normalize(*synthesize_stack_data(n_normal=600, n_fault=50, seed=42),
                               device=cuda_device)

    def export():
        return build_comprehensive_results(params, ds, mc_seed=5, mc_times=64)[0].array

    want = export()  # the first launches outside the trace
    got, device, spans = _profiled(export)
    np.testing.assert_array_equal(got, want)
    assert device and not [d for d in device if d[0].startswith("pinnfc.")]
    assert [s[0] for s in spans] == [
        "pinnfc.export", "pinnfc.export.mc", "pinnfc.export.residuals",
        "pinnfc.export.to_host", "pinnfc.export.smooth", "pinnfc.export.assemble"]
    assert _inside(spans[0], device) and _inside(spans[0], spans[1:])
    assert any("mc_sample_kernel" in d[0] for d in device)


@pytest.mark.cuda
def test_stage_spans_hold_the_training_kernel(cuda_device):
    """A DNN stage's span holds the wrapper's three spans in order and every
    operation of its training kernel; none of them reaches the device."""
    from pinnfc_tpu_torch.config import StageConfig
    from pinnfc_tpu_torch.training.stages import run_schedule

    normal, _ = synthesize_stack_data(n_normal=1000, n_fault=10, seed=42)
    ds = combine_and_normalize(normal, [], device=cuda_device)
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)

    def stage():
        return run_schedule(params, ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y,
                            schedule=(StageConfig("dnn", 20, lr=0.01),), seed=3)

    stage()
    _, device, spans = _profiled(stage)
    assert [s[0] for s in spans] == ["pinnfc.stage.dnn", "pinnfc.train_dnn.prep",
                                     "pinnfc.train_dnn.launch", "pinnfc.train_dnn.finish"]
    assert _inside(spans[0], spans[1:]) and spans[1][2] <= spans[2][1] <= spans[2][2] <= \
        spans[3][1]
    kernels = [d for d in device if "_kernel" in d[0]]
    assert sum("fwd_bwd_kernel" in d[0] for d in kernels) == 20
    assert _inside(spans[0], kernels)
    assert not [d for d in device if d[0].startswith("pinnfc.")]


@pytest.mark.cuda
def test_once_counts_the_first_launches_and_dispatch(cuda_device, monkeypatch):
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)
    ds = combine_and_normalize(*synthesize_stack_data(n_normal=300, n_fault=20, seed=42),
                               device=cuda_device)
    build.load()
    monkeypatch.setattr(build, "ONCE_S", {})
    build_comprehensive_results(params, ds, mc_seed=5, mc_times=16)
    first = dict(build.ONCE_S)
    # an eager export launches the residual kernel directly: no operator dispatch
    assert set(first) == {"launch.mc_dropout", "launch.residuals"}
    assert all(v >= 0 for v in first.values())
    build_comprehensive_results(params, ds, mc_seed=5, mc_times=16)
    assert build.ONCE_S == first


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15600, 37])
def test_eager_residuals_launch_the_kernel_directly(cuda_device, campaign_rows, n):
    """``all_residuals_kernel`` on CUDA tensors launches the kernel once
    without the registered operator, and its rows are ``residuals_op``'s
    bitwise, NaN sets included."""
    from pinnfc_tpu_torch.ops.residuals import (
        all_residuals_kernel, kernel_scalars, residuals_op)

    ds = campaign_rows
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=cuda_device)
    params["lam_v"][2] = 1.2
    sx, sy = ds.scaler_x.to(cuda_device), ds.scaler_y.to(cuda_device)
    x = ds.x_test[:n].to(cuda_device)
    with torch.no_grad():
        u = params["mlp"](x)[0]
    before = build.LAUNCHES["residuals"]
    bundle = all_residuals_kernel(params, x, u, sx, sy)
    assert build.LAUNCHES["residuals"] == before + 1
    scalars = kernel_scalars(params, sx, sy)
    want = residuals_op(x, u[:, 0], *(scalars[k] for k in build.RESIDUAL_SCALAR_SIZES))
    got = torch.stack([t[:, 0] for t in bundle])
    assert got.device == x.device
    # 5,626 of the campaign's rows lie past the limiting current; none of the first 37
    assert torch.isnan(want).any() == (n == 15600)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
