"""Gaussian-mixture EM on a device (counterpart of
``pinnfc_tpu/diagnosis/gmm.py``; sklearn ``GaussianMixture`` with
``covariance_type='full'``).

The reference fits ``GaussianMixture(n_components=20, covariance_type=
'full')`` on the four physics residuals (03:384-389).  Here EM runs in torch
on the device: sklearn's precision-Cholesky log-densities, sklearn's update
equations term for term (``reg_covar`` on the covariance diagonal, ``10·eps``
on ``nk``, initial weights ``nk/n``, later ones ``nk/Σnk``), and sklearn's
convergence rule (the mean per-sample log-likelihood moves by < tol; the
converging iteration still applies its update).  The EM loop runs on the
host with one read of the lower bound per iteration, so ``n_iter`` and
``converged`` are the JAX ``while_loop``'s.

Shapes: X (N, D), means (C, D), covariances (C, D, D).  The E-step is a
batched triangular solve on the (C, D, D) factors and batched matmuls over
the N axis.  ``dtype`` float32 (default) or float64; every product in full
precision (``resolve_device`` turns TF32 off).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.kmeans import kmeans_fit


class GMMParams(NamedTuple):
    weights: torch.Tensor  # (C,)
    means: torch.Tensor  # (C, D)
    covariances: torch.Tensor  # (C, D, D)
    converged: bool
    n_iter: int
    lower_bound: float  # mean per-sample log-likelihood of the last E-step


def _torch_dtype(dtype) -> torch.dtype:
    """'float32' / 'float64' / a numpy or torch float dtype → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"GMM dtype must be float32 or float64, got {dtype!r}")
    return getattr(torch, name)


def _log_gaussian_prob(x: torch.Tensor, means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """log N(x | μ_c, Σ_c) for all samples × components (N, C), in sklearn's
    formulation: the precision Cholesky ``B = L⁻ᵀ`` per component and the
    Mahalanobis term ``‖x·B − μ·B‖²``.

    A covariance that is not positive definite has no factor: its
    component's log-densities are NaN, as ``jnp.linalg.cholesky``'s NaN factor
    makes them in the JAX package (``cholesky_ex`` reports the failure
    without a host sync, and the factor is replaced by NaN)."""
    d = x.shape[1]
    chol, info = torch.linalg.cholesky_ex(covs)  # (C, D, D)
    chol = chol.masked_fill((info != 0)[:, None, None], float("nan"))
    eye = torch.eye(d, dtype=x.dtype, device=x.device).expand_as(chol)
    l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)  # L⁻¹
    prec_chol = l_inv.transpose(1, 2)  # B = L⁻ᵀ
    xb = x[None] @ prec_chol  # (C, N, D)
    mub = (means[:, None, :] @ prec_chol)[:, 0]  # (C, D)
    maha = ((xb - mub[:, None, :]) ** 2).sum(dim=2)  # (C, N)
    # log|Σ_c|⁻¹ᐟ² = Σ log diag(B_c)
    log_det = torch.log(torch.diagonal(prec_chol, dim1=1, dim2=2)).sum(dim=1)  # (C,)
    return (-0.5 * (d * math.log(2.0 * math.pi) + maha) + log_det[:, None]).T


def _e_step(x, weights, means, covs):
    """(mean log-likelihood (0-dim tensor), log responsibilities (N, C)).
    The covariances carry reg_covar from the M-step, as in sklearn."""
    log_prob = _log_gaussian_prob(x, means, covs) + torch.log(weights)[None, :]
    log_norm = torch.logsumexp(log_prob, dim=1, keepdim=True)
    return log_norm.mean(), log_prob - log_norm


def _gaussian_parameters(x, resp, reg):
    """sklearn ``_estimate_gaussian_parameters`` for 'full' covariances:
    (nk, means, covariances with reg on the diagonal)."""
    nk = resp.sum(dim=0) + 10.0 * torch.finfo(resp.dtype).eps  # (C,)
    means = (resp.T @ x) / nk[:, None]  # (C, D)
    diff = x[None, :, :] - means[:, None, :]  # (C, N, D)
    wdiff = diff * resp.T[:, :, None]
    covs = (wdiff.transpose(1, 2) @ diff) / nk[:, None, None]
    covs = covs + reg * torch.eye(x.shape[1], dtype=x.dtype, device=x.device)[None]
    return nk, means, covs


def gmm_fit(
    x,
    generator: Optional[torch.Generator],
    n_components: int,
    max_iter: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    kmeans_iters: int = 50,
    init_resp=None,
    dtype="float32",
    device="cuda",
) -> GMMParams:
    """Fit by EM on ``device``.  ``init_resp`` (N, C) replaces the k-means
    one-hot initialization when given (``sklearn_kmeans_init_resp`` gives
    sklearn's own; from it, float64 EM follows ``GaussianMixture.fit``);
    otherwise ``kmeans_fit`` (float32, draws from ``generator``, a CPU
    ``torch.Generator``) with ``kmeans_iters`` Lloyd iterations seeds it."""
    dev = resolve_device(device)
    dt = _torch_dtype(dtype)
    x = torch.as_tensor(x, dtype=dt, device=dev)
    n = x.shape[0]
    if init_resp is None:
        if generator is None:
            raise ValueError("gmm_fit needs a generator for its k-means init (or init_resp)")
        km = kmeans_fit(x, generator, n_components, max_iter=kmeans_iters, device=dev)
        resp0 = torch.nn.functional.one_hot(km.assignments, n_components).to(dt)
    else:
        resp0 = torch.as_tensor(init_resp, dtype=dt, device=dev)
    nk0, means, covs = _gaussian_parameters(x, resp0, reg_covar)
    weights = nk0 / n  # sklearn _initialize: nk / n_samples (not nk / Σnk)

    prev_lb = torch.tensor(float("-inf"), dtype=dt, device=dev)
    converged, n_iter = False, 0
    while not converged and n_iter < max_iter:
        lb, log_resp = _e_step(x, weights, means, covs)
        nk, means, covs = _gaussian_parameters(x, torch.exp(log_resp), reg_covar)
        weights = nk / nk.sum()  # sklearn _m_step: nk / Σnk
        converged = bool((lb - prev_lb).abs() < tol)
        prev_lb = lb
        n_iter += 1
    return GMMParams(weights, means, covs, converged, n_iter, float(prev_lb))


def sklearn_kmeans_init_resp(
    x: np.ndarray, n_components: int, random_state: int = 42
) -> np.ndarray:
    """sklearn ``GaussianMixture``'s own initialization, computed with
    sklearn itself (one CPU k-means): the one-hot responsibilities of
    ``KMeans(n_clusters, n_init=1, random_state=check_random_state(seed))``
    labels, byte for byte the ``_initialize_parameters(init_params='kmeans')``
    resp (sklearn mixture/_base.py).  Needs scikit-learn; without it, raises
    ``ImportError`` (there is no substitute init)."""
    try:
        from sklearn import cluster
        from sklearn.utils import check_random_state
    except ImportError as e:
        raise ImportError(
            "init='sklearn' (sklearn_kmeans_init_resp) needs scikit-learn, which cannot be "
            "imported here; use init='kmeans'") from e

    x = np.asarray(x)
    labels = (
        cluster.KMeans(
            n_clusters=n_components, n_init=1,
            random_state=check_random_state(random_state),
        )
        .fit(x)
        .labels_
    )
    resp = np.zeros((x.shape[0], n_components), dtype=np.float64)
    resp[np.arange(x.shape[0]), labels] = 1.0
    return resp


def gmm_predict_proba(model: GMMParams, x) -> torch.Tensor:
    """Responsibilities P(component | x) (sklearn predict_proba), on the
    model's device in its dtype."""
    x = torch.as_tensor(x, dtype=model.means.dtype, device=model.means.device)
    _, log_resp = _e_step(x, model.weights, model.means, model.covariances)
    return torch.exp(log_resp)


def gmm_score_samples(model: GMMParams, x) -> torch.Tensor:
    """Per-sample log-likelihood under the mixture."""
    x = torch.as_tensor(x, dtype=model.means.dtype, device=model.means.device)
    log_prob = _log_gaussian_prob(x, model.means, model.covariances)
    return torch.logsumexp(log_prob + torch.log(model.weights)[None, :], dim=1)
