"""Port parity: exact t-SNE (pinnfc_tpu_torch.diagnosis.tsne) against the JAX
package's ``pinnfc_tpu/diagnosis/tsne.py``, on the CPU, at N = 160.

Every test runs under one pinned torch thread.  Tolerances:
- ``joint_p`` within 1e-6 abs of JAX's; ``conditional_p`` within 1e-6 abs on
  ≥ 95 % of rows.  The bisection stops a row once |H − ln perplexity| ≤ 1e-5,
  a band some 40 float32 ulps wide: where a row's entropy lands within
  rounding of its edge, one side stops a step before the other (XLA's and
  torch's float32 exp and sums round differently).  Such a row is within
  1e-5 abs, and its entropy within the tolerance on both sides;
- ``kl_and_grad`` on the same (y, P): KL and gradient within rtol 1e-4;
- ``pca_init`` within rtol 1e-5 with the same signs;
- ``descent_phase`` from one y₀ and one P: 50 steps of the second phase
  (momentum 0.8) within rtol 1e-3.  The exaggerated first phase is chaotic:
  a gain flips on the sign of update·gradient, and rounding differences grow
  about tenfold every three steps there, so it is held for 5 steps (rtol
  1e-3);
- ``tsne_fit`` end to end (1,000 steps): final KL within 10 % of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinnfc_tpu.diagnosis import tsne as jax_tsne
from pinnfc_tpu_torch.diagnosis import tsne
from pinnfc_tpu_torch.utils.threads import one_thread

PERPLEXITY = 20.0  # what cli gmm --tsne passes


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.RandomState(0)
    centers = np.array([[0, 0, 0, 0], [6, 0, 0, 0], [0, 6, 0, 0], [0, 0, 6, 6]], dtype=float)
    return np.vstack([c + rng.randn(40, 4) for c in centers]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_p(blobs):
    d2 = jax_tsne._pairwise_sq_dists(jnp.asarray(blobs))
    cond = jax_tsne.conditional_p(d2, jnp.float32(PERPLEXITY))
    return np.array(d2), np.array(cond), np.array(jax_tsne.joint_p(cond))


def _row_entropy(p):
    p = np.asarray(p, np.float64)
    return -np.sum(np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0), axis=1)


def test_probabilities_match_jax(blobs, jax_p):
    d2_j, cond_j, joint_j = jax_p
    d2 = tsne._pairwise_sq_dists(torch.as_tensor(blobs))
    np.testing.assert_allclose(d2.numpy(), d2_j, rtol=1e-5, atol=1e-4)
    cond = tsne.conditional_p(d2, PERPLEXITY).numpy()
    row_err = np.abs(cond - cond_j).max(axis=1)
    assert (row_err <= 1e-6).mean() >= 0.95
    assert row_err.max() <= 1e-5
    target = np.log(PERPLEXITY)
    for c in (cond, cond_j):
        np.testing.assert_allclose(c.sum(axis=1), 1.0, atol=1e-5)
        assert np.abs(_row_entropy(c) - target).max() <= 1e-5 + 2e-6  # + float32 rounding
    joint = tsne.joint_p(torch.as_tensor(cond)).numpy()
    np.testing.assert_allclose(joint, joint_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsne.joint_p(torch.as_tensor(cond_j)).numpy(),
                               np.asarray(jax_tsne.joint_p(jnp.asarray(cond_j))),
                               rtol=1e-6, atol=0)


def test_kl_and_grad_and_pca_init_match_jax(blobs, jax_p):
    _, _, joint_j = jax_p
    y0 = tsne.pca_init(torch.as_tensor(blobs), 2)
    y0_j = np.array(jax_tsne.pca_init(jnp.asarray(blobs), 2))
    np.testing.assert_allclose(y0.numpy(), y0_j, rtol=1e-5, atol=1e-5 * np.abs(y0_j).max())
    np.testing.assert_array_equal(np.sign(y0.numpy()), np.sign(y0_j))
    assert float(y0[:, 0].std(correction=0)) == pytest.approx(1e-4, rel=1e-5)
    for y in (y0_j, np.random.RandomState(3).randn(160, 2).astype(np.float32)):
        kl, grad = tsne.kl_and_grad(torch.as_tensor(y), torch.as_tensor(joint_j))
        kl_j, grad_j = jax_tsne.kl_and_grad(jnp.asarray(y), jnp.asarray(joint_j))
        assert float(kl) == pytest.approx(float(kl_j), rel=1e-4)
        np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(grad_j)).max())


@pytest.mark.parametrize("exaggeration,momentum,steps", [(1.0, 0.8, 50), (12.0, 0.5, 5)])
def test_descent_phase_matches_jax(blobs, jax_p, exaggeration, momentum, steps):
    _, _, joint_j = jax_p
    y0 = np.array(jax_tsne.pca_init(jnp.asarray(blobs), 2))
    zeros, ones = np.zeros_like(y0), np.ones_like(y0)
    p = joint_j * np.float32(exaggeration)
    y, update, gains, kls = tsne.descent_phase(
        torch.as_tensor(y0), torch.as_tensor(zeros), torch.as_tensor(ones), torch.as_tensor(p),
        momentum, 50.0, steps)
    y_j, update_j, gains_j, kls_j = jax_tsne.descent_phase(
        jnp.asarray(y0), jnp.asarray(zeros), jnp.asarray(ones), jnp.asarray(p), momentum,
        50.0, steps)
    y_j = np.asarray(y_j)
    np.testing.assert_allclose(y.numpy(), y_j, rtol=1e-3, atol=1e-3 * np.abs(y_j).max())
    np.testing.assert_allclose(kls.numpy(), np.asarray(kls_j), rtol=1e-3)
    assert kls.shape == (steps,) and float(gains.min()) >= 0.01


def test_tsne_fit_kl_close_to_jax(blobs):
    got = tsne.tsne_fit(blobs, perplexity=PERPLEXITY, device="cpu")
    want = jax_tsne.tsne_fit(blobs, perplexity=PERPLEXITY)
    assert got.embedding.shape == (160, 2) and torch.isfinite(got.embedding).all()
    assert float(got.kl_divergence) == pytest.approx(float(want.kl_divergence), rel=0.1)
    # the blobs stay apart: each point's nearest embedded neighbor is of its blob
    e = got.embedding.numpy().astype(np.float64)
    d = ((e[:, None] - e[None]) ** 2).sum(-1) + np.diag(np.full(160, np.inf))
    assert (np.argmin(d, axis=1) // 40 == np.arange(160) // 40).mean() >= 0.95


def test_perplexity_clamp_and_random_init(blobs):
    x = blobs[:30]
    clamped = tsne.tsne_fit(x, perplexity=50.0, max_iter=60, device="cpu")
    explicit = tsne.tsne_fit(x, perplexity=29 / 3.0, max_iter=60, device="cpu")
    assert torch.equal(clamped.embedding, explicit.embedding)  # max((n − 1)/3, 2)
    want = jax_tsne.tsne_fit(x, perplexity=50.0, max_iter=60)
    assert float(clamped.kl_divergence) == pytest.approx(float(want.kl_divergence), rel=0.1)

    # max_iter=0 returns the init: 1e-4 · N(0, 1) from the CPU generator
    y0 = tsne.tsne_fit(x, torch.Generator().manual_seed(5), init="random", max_iter=0,
                       device="cpu").embedding
    torch.testing.assert_close(y0, 1e-4 * torch.randn((30, 2),
                                                      generator=torch.Generator().manual_seed(5)),
                               rtol=0, atol=0)
    default = tsne.tsne_fit(x, init="random", max_iter=0, device="cpu").embedding
    assert torch.equal(default, tsne.tsne_fit(x, torch.Generator().manual_seed(0),
                                              init="random", max_iter=0,
                                              device="cpu").embedding)
    a = tsne.tsne_fit(x, torch.Generator().manual_seed(1), init="random", max_iter=60,
                      device="cpu")
    b = tsne.tsne_fit(x, torch.Generator().manual_seed(1), init="random", max_iter=60,
                      device="cpu")
    assert torch.equal(a.embedding, b.embedding) and torch.isfinite(a.kl_divergence)
    with pytest.raises(ValueError, match="init must be"):
        tsne.tsne_fit(x, init="spectral", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsne.tsne_fit(x)
