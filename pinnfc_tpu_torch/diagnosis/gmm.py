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

``mask`` (N,) of 1/0 excludes padded rows exactly (their responsibility mass
and log-likelihood are zeroed), which is how rows of any count shard over a
device mesh (``parallel/diagnosis.py::gmm_fit_dp``); a mask needs
``init_resp``, as the k-means init is unmasked.  EM runs on row shards
(``gmm_fit_shards``): per shard, on its device, the E-step and the sums
``nk``, ``respᵀX`` and the lower bound's; their sums on the first device in
order (``parallel/mesh.py::all_sum``) give the means, which go back to the
shards for the centred scatter ``Σ resp·(x−μ)(x−μ)ᵀ``; the covariances and
their precision Cholesky factors are formed on the first device and sent to
the shards.  One shard is ``gmm_fit``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.kmeans import kmeans_fit
from pinnfc_tpu_torch.parallel.mesh import all_sum


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


def _precision_cholesky(covs: torch.Tensor) -> torch.Tensor:
    """The precision Cholesky factors ``B = L⁻ᵀ`` (C, D, D) of the
    covariances.  A covariance that is not positive definite has no factor:
    its ``B`` is NaN, as ``jnp.linalg.cholesky``'s NaN factor makes it in the
    JAX package (``cholesky_ex`` reports the failure without a host sync)."""
    chol, info = torch.linalg.cholesky_ex(covs)  # (C, D, D)
    chol = chol.masked_fill((info != 0)[:, None, None], float("nan"))
    eye = torch.eye(covs.shape[1], dtype=covs.dtype, device=covs.device).expand_as(chol)
    l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)  # L⁻¹
    return l_inv.transpose(1, 2)


def _log_prob_chol(x: torch.Tensor, means: torch.Tensor, prec_chol: torch.Tensor) -> torch.Tensor:
    """log N(x | μ_c, Σ_c) (N, C) from the precision Cholesky factors: the
    Mahalanobis term ``‖x·B − μ·B‖²`` and ``log|Σ_c|⁻¹ᐟ² = Σ log diag(B_c)``."""
    d = x.shape[1]
    xb = x[None] @ prec_chol  # (C, N, D)
    mub = (means[:, None, :] @ prec_chol)[:, 0]  # (C, D)
    maha = ((xb - mub[:, None, :]) ** 2).sum(dim=2)  # (C, N)
    log_det = torch.log(torch.diagonal(prec_chol, dim1=1, dim2=2)).sum(dim=1)  # (C,)
    return (-0.5 * (d * math.log(2.0 * math.pi) + maha) + log_det[:, None]).T


def _log_gaussian_prob(x: torch.Tensor, means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """log N(x | μ_c, Σ_c) for all samples × components (N, C), in sklearn's
    formulation (``_precision_cholesky``, ``_log_prob_chol``); a component
    whose covariance has no Cholesky factor gets NaN log-densities."""
    return _log_prob_chol(x, means, _precision_cholesky(covs))


def _e_step(x, weights, means, covs):
    """(mean log-likelihood (0-dim tensor), log responsibilities (N, C)).
    The covariances carry reg_covar from the M-step, as in sklearn."""
    log_prob = _log_gaussian_prob(x, means, covs) + torch.log(weights)[None, :]
    log_norm = torch.logsumexp(log_prob, dim=1, keepdim=True)
    return log_norm.mean(), log_prob - log_norm


def _gaussian_parameters(xs, resps, reg):
    """sklearn ``_estimate_gaussian_parameters`` for 'full' covariances over
    row shards (lists, one tensor per shard): (nk, means, covariances with reg
    on the diagonal) on the first shard's device."""
    nk = all_sum([r.sum(dim=0) for r in resps])
    nk = nk + 10.0 * torch.finfo(nk.dtype).eps  # (C,)
    means = all_sum([r.T @ x for r, x in zip(resps, xs)]) / nk[:, None]  # (C, D)
    scatter = []
    for x, r in zip(xs, resps):
        diff = x[None, :, :] - means.to(x.device)[:, None, :]  # (C, N, D)
        wdiff = diff * r.T[:, :, None]
        scatter.append(wdiff.transpose(1, 2) @ diff)
    covs = all_sum(scatter) / nk[:, None, None]
    covs = covs + reg * torch.eye(means.shape[1], dtype=means.dtype, device=means.device)[None]
    return nk, means, covs


def gmm_fit(
    x,
    generator: Optional[torch.Generator],
    n_components: int,
    max_iter: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    kmeans_iters: int = 50,
    mask=None,
    init_resp=None,
    dtype="float32",
    device="cuda",
) -> GMMParams:
    """Fit by EM on ``device``.  ``init_resp`` (N, C) replaces the k-means
    one-hot initialization when given (``sklearn_kmeans_init_resp`` gives
    sklearn's own; from it, float64 EM follows ``GaussianMixture.fit``);
    otherwise ``kmeans_fit`` (float32, draws from ``generator``, a CPU
    ``torch.Generator``) with ``kmeans_iters`` Lloyd iterations seeds it.
    ``mask`` (N,) of 1/0 gives rows zero weight and needs ``init_resp``."""
    if mask is not None and init_resp is None:
        raise ValueError("mask requires init_resp (k-means init is unmasked)")
    dev = resolve_device(device)
    dt = _torch_dtype(dtype)
    x = torch.as_tensor(x, dtype=dt, device=dev)
    if init_resp is None:
        if generator is None:
            raise ValueError("gmm_fit needs a generator for its k-means init (or init_resp)")
        km = kmeans_fit(x, generator, n_components, max_iter=kmeans_iters, device=dev)
        resp0 = torch.nn.functional.one_hot(km.assignments, n_components).to(dt)
    else:
        resp0 = torch.as_tensor(init_resp, dtype=dt, device=dev)
    masks = None if mask is None else [torch.as_tensor(mask, dtype=dt, device=dev)]
    return gmm_fit_shards([x], [resp0], max_iter=max_iter, tol=tol, reg_covar=reg_covar,
                          masks=masks)


def gmm_fit_shards(xs, resp0s, max_iter: int = 100, tol: float = 1e-3,
                   reg_covar: float = 1e-6, masks=None) -> GMMParams:
    """EM from the initial responsibilities over row shards: ``xs`` (N_s, D),
    ``resp0s`` (N_s, C) and ``masks`` (N_s,) of one dtype (None: every row
    counts; more than one shard needs masks), shard s on its own device.  The
    mixture's tensors live on the first shard's device; one read of the
    lower bound per iteration."""
    if masks is None and len(xs) != 1:
        raise ValueError("row shards need their masks")
    if masks is not None:
        resp0s = [r * m[:, None] for r, m in zip(resp0s, masks)]
    nk0, means, covs = _gaussian_parameters(xs, resp0s, reg_covar)
    # sklearn _initialize: nk / n_samples (not nk / Σnk)
    n_eff = xs[0].shape[0] if masks is None else all_sum([m.sum() for m in masks])
    weights = nk0 / n_eff

    prev_lb = torch.tensor(float("-inf"), dtype=means.dtype, device=means.device)
    converged, n_iter = False, 0
    while not converged and n_iter < max_iter:
        # E-step per shard with the first device's factors
        prec_chol, log_w = _precision_cholesky(covs), torch.log(weights)
        resps, lb_parts = [], []
        for k, x in enumerate(xs):
            d = x.device
            log_prob = (_log_prob_chol(x, means.to(d), prec_chol.to(d))
                        + log_w.to(d)[None, :])
            log_norm = torch.logsumexp(log_prob, dim=1, keepdim=True)
            resp = torch.exp(log_prob - log_norm)
            if masks is None:
                lb = log_norm.mean()
            else:
                lb_parts.append((log_norm[:, 0] * masks[k]).sum())
                resp = resp * masks[k][:, None]
            resps.append(resp)
        if masks is not None:
            lb = all_sum(lb_parts) / n_eff
        nk, means, covs = _gaussian_parameters(xs, resps, reg_covar)
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
