"""Exact t-SNE on a device (counterpart of ``pinnfc_tpu/diagnosis/tsne.py``;
reference usage: 02:319 with TSNE_PARAMS at 02:63, 03:451-460, the scatter
views of 05).

Semantics follow ``sklearn.manifold.TSNE(method="exact")``, as the JAX
package runs them:

1. conditional P per row by the bisection on the Gaussian precision beta of
   sklearn's ``_binary_search_perplexity`` (100 steps, entropy tolerance
   1e-5, a row frozen once converged), all rows at once;
2. joint ``P = max((P_c + P_cᵀ)/sum, eps)`` (sklearn ``_joint_probabilities``),
   ×12 early exaggeration for the first phase;
3. PCA init scaled to std 1e-4 on the first component, with svd_flip's sign
   rule (sklearn ``_fit``), or ``1e-4·N(0, 1)`` draws from a CPU
   ``torch.Generator`` (the JAX package draws from ``jax.random``);
4. two phases of batch gradient descent with individual gains (sklearn
   ``_gradient_descent``: gains +0.2/×0.8 clipped at 0.01; momentum 0.5 for
   250 steps on the exaggerated P, then 0.8), learning rate "auto" =
   max(N/early_exaggeration/4, 50), the full budget with no early stop;
5. the exact KL gradient ``4·(diag(W·1) − W)·Y`` with ``W = (P − Q)·num``,
   ``num = (1+‖yi−yj‖²)⁻¹``.

Float32 with the eps floors of float64 (sklearn's MACHINE_EPSILON).  Every
loop (the bisection, the descent) is a fixed trip count with no host read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device

# sklearn floors P and Q at np.finfo(np.double).eps (MACHINE_EPSILON)
_EPS = float(np.finfo(np.float64).eps)
_PERPLEXITY_TOL = 1e-5  # sklearn _utils PERPLEXITY_TOLERANCE
_N_BISECT = 100  # sklearn binary-search step budget
_EXPLORATION_ITER = 250  # sklearn TSNE._EXPLORATION_MAX_ITER
_MIN_GAIN = 0.01


class TsneResult(NamedTuple):
    embedding: torch.Tensor  # (N, n_components) float32
    kl_divergence: torch.Tensor  # () float32, final (unexaggerated) KL


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(N, N) squared euclidean distances, clamped at 0 (full float32)."""
    sq = (x * x).sum(dim=1)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)


def _off_diagonal(n: int, like: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.eye(n, dtype=like.dtype, device=like.device)


def conditional_p(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Per-row Gaussian conditional probabilities at the desired perplexity:
    bisection on beta, doubling/halving while a bound is open, entropy
    H = log(ΣP) + β·Σ(dP)/ΣP against ln(perplexity), tolerance 1e-5; a row
    freezes once converged, so later steps do not move it."""
    d2 = d2.to(torch.float32)
    n = d2.shape[0]
    desired_entropy = float(np.log(np.float32(perplexity)))
    mask = _off_diagonal(n, d2)  # exclude self (j != i)
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    bmin = torch.full_like(beta, float("-inf"))
    bmax = torch.full_like(beta, float("inf"))
    done = torch.zeros(n, dtype=torch.bool, device=d2.device)
    for _ in range(_N_BISECT):
        p = torch.exp(-d2 * beta[:, None]) * mask
        sum_p = torch.clamp(p.sum(dim=1), min=_EPS)
        h = torch.log(sum_p) + beta * (d2 * p).sum(dim=1) / sum_p
        diff = h - desired_entropy
        keep = done | (diff.abs() <= _PERPLEXITY_TOL)
        too_high = diff > 0.0  # entropy too high → raise beta
        nbeta = torch.where(
            too_high,
            torch.where(torch.isinf(bmax), beta * 2.0, 0.5 * (beta + bmax)),
            torch.where(torch.isinf(bmin), beta * 0.5, 0.5 * (beta + bmin)),
        )
        nbmin = torch.where(too_high, beta, bmin)
        nbmax = torch.where(too_high, bmax, beta)
        beta = torch.where(keep, beta, nbeta)
        bmin = torch.where(keep, bmin, nbmin)
        bmax = torch.where(keep, bmax, nbmax)
        done = keep
    p = torch.exp(-d2 * beta[:, None]) * mask
    return p / torch.clamp(p.sum(dim=1, keepdim=True), min=_EPS)


def joint_p(cond_p: torch.Tensor) -> torch.Tensor:
    """Symmetrized joint probabilities (sklearn ``_joint_probabilities``,
    square form: the zero diagonal carries eps after the floor, which cancels
    in the KL sum and the gradient)."""
    p = cond_p + cond_p.T
    return torch.clamp(p / torch.clamp(p.sum(), min=_EPS), min=_EPS)


def kl_and_grad(y: torch.Tensor, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KL divergence and gradient (sklearn ``_kl_divergence``,
    degrees_of_freedom = 1): Q ∝ (1+d²)⁻¹, grad = 4·(diag(W·1) − W)·Y."""
    n = y.shape[0]
    num = 1.0 / (1.0 + _pairwise_sq_dists(y))
    num = num * _off_diagonal(n, num)
    q = torch.clamp(num / torch.clamp(num.sum(), min=_EPS), min=_EPS)
    # full-matrix sum == 2 × condensed sum (sklearn's factor 2.0)
    kl = (p * torch.log(torch.clamp(p, min=_EPS) / q)).sum()
    w = (p - q) * num
    grad = 4.0 * (y * w.sum(dim=1, keepdim=True) - w @ y)
    return kl, grad


def descent_phase(y, update, gains, p, momentum: float, learning_rate: float, n_iter: int):
    """``n_iter`` gradient-descent steps (sklearn ``_gradient_descent``'s
    update rule: individual gains +0.2/×0.8 clipped at 0.01, momentum step,
    no early abort); returns (y, update, gains, the KL before each step)."""
    kls = []
    for _ in range(n_iter):
        kl, grad = kl_and_grad(y, p)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8), min=_MIN_GAIN)
        update = momentum * update - learning_rate * (grad * gains)
        y = y + update
        kls.append(kl)
    return y, update, gains, torch.stack(kls) if kls else torch.zeros(0, device=y.device)


def pca_init(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """PCA init scaled so std(component 0) = 1e-4 (sklearn ``TSNE._fit``;
    the deterministic svd_flip sign rule: each column's largest |entry|
    positive)."""
    xc = x - x.mean(dim=0)
    u, s, _ = torch.linalg.svd(xc, full_matrices=False)
    u = u[:, :n_components] * s[:n_components]
    cols = torch.arange(u.shape[1], device=u.device)
    signs = torch.sign(u[torch.argmax(u.abs(), dim=0), cols])
    u = u * signs[None, :]
    return u / u[:, 0].std(correction=0) * 1e-4


def tsne_fit(
    x,
    generator: Optional[torch.Generator] = None,
    *,
    perplexity: float = 30.0,
    n_components: int = 2,
    max_iter: int = 1000,
    early_exaggeration: float = 12.0,
    learning_rate: float | str = "auto",
    init: str = "pca",
    device="cuda",
) -> TsneResult:
    """Fit exact t-SNE on ``device`` (float32).  Defaults mirror the
    reference's ``TSNE_PARAMS`` (02:63: perplexity 30, lr "auto", init
    "pca") and script 03's n_iter=1000 (03:451-460).  ``generator`` (a CPU
    ``torch.Generator``, default seed 0) draws ``init="random"``."""
    if init not in ("pca", "random"):
        raise ValueError(f"init must be 'pca' or 'random', got {init!r}")
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    if perplexity >= n:
        # exactly sklearn's validity domain (it raises for perplexity >=
        # n_samples); clamp instead of failing a one-off figure
        perplexity = max((n - 1) / 3.0, 2.0)
    if learning_rate == "auto":  # sklearn TSNE._fit
        learning_rate = max(n / early_exaggeration / 4.0, 50.0)
    # the JAX package passes both as float32 scalars
    learning_rate = float(np.float32(learning_rate))
    early_exaggeration = float(np.float32(early_exaggeration))
    p = joint_p(conditional_p(_pairwise_sq_dists(x), perplexity))

    if init == "pca":
        y0 = pca_init(x, n_components)
    else:  # sklearn draws standard_normal × 1e-4
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        y0 = 1e-4 * torch.randn((n, n_components), generator=generator).to(dev)

    update = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    # phase 1: early exaggeration, momentum 0.5 (sklearn TSNE._tsne)
    n1 = min(_EXPLORATION_ITER, max_iter)
    y, update, gains, _ = descent_phase(
        y0, update, gains, p * early_exaggeration, 0.5, learning_rate, n1)
    # phase 2: plain P, momentum 0.8
    n2 = max(max_iter - n1, 0)
    if n2:
        y, update, gains, _ = descent_phase(y, update, gains, p, 0.8, learning_rate, n2)
    kl, _ = kl_and_grad(y, p)
    return TsneResult(y, kl)
