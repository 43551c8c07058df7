"""Spectral clustering on a device (counterpart of
``pinnfc_tpu/diagnosis/spectral.py``): kNN affinity, normalized-Laplacian
eigenvectors, k-means on the embedding.

The steps of sklearn ``SpectralClustering(affinity='nearest_neighbors',
assign_labels='kmeans')`` (05:455-512), as the JAX package runs them:

1. kNN connectivity A from the pairwise squared distances (the
   ‖a‖²+‖b‖²−2ab expansion, full float32), self included, symmetrized
   0.5·(A + Aᵀ).  The neighbors are the first ``n_neighbors`` of each row
   sorted stably by distance, so a tied distance goes to the lower index,
   as ``jax.lax.top_k`` orders it;
2. normalized Laplacian L = I − D^{-1/2} A D^{-1/2};
3. its bottom ``n_clusters`` eigenvectors, by the JAX package's size rule
   (``solver="auto"``): ``torch.linalg.eigh`` up to N = 4096, above it block
   orthogonal iteration on 2I − L (eigenvalues of L lie in [0, 2]) until the
   Rayleigh-Ritz residual ‖(2I−L)q − q·qᵀ(2I−L)q‖∞ ≤ 1e-5 or 3,000 steps,
   one host read of the residual per step, columns sorted by Rayleigh
   quotient.  Any basis of the invariant subspace differs from eigh's by a
   k×k rotation, which k-means on the rows does not see;
4. rows rescaled by D^{-1/2} (sklearn's ``spectral_embedding`` recovers
   u = D^{-1/2}·v) and each column's sign fixed deterministically;
5. the port's ``kmeans_fit`` on the embedding.

Draws: the subspace start Q₀ and the k-means seeding come, in that order,
from ``generator``, a CPU ``torch.Generator``, so the card and the CPU take the
same draws (the JAX package splits a ``jax.random`` key, which torch cannot
reproduce).  ``eigh``, ``qr`` and the products are library calls, as in the
JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.kmeans import kmeans_fit

# above this N the dense-eigh temps no longer fit a TPU's HBM; the JAX
# package's rule, kept so that the port takes the path JAX takes at each N
_EIGH_MAX_N = 4096


class SpectralResult(NamedTuple):
    assignments: torch.Tensor  # (N,) int64 cluster labels
    embedding: torch.Tensor  # (N, n_clusters) spectral embedding


def knn_laplacian(x: torch.Tensor, n_neighbors: int):
    """(kNN index (N, n_neighbors), normalized Laplacian (N, N), D^{-1/2} (N,))."""
    n = x.shape[0]
    sq = (x**2).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :n_neighbors]
    a = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    a.scatter_(1, idx, 1.0)
    a = 0.5 * (a + a.T)
    d_isqrt = 1.0 / torch.sqrt(torch.clamp(a.sum(dim=1), min=1e-12))
    lap = torch.eye(n, dtype=x.dtype, device=x.device) - (d_isqrt[:, None] * a) * d_isqrt[None, :]
    return idx, lap, d_isqrt


def _bottom_k_subspace(lap, k, generator, tol=1e-5, max_iter=3000):
    """Orthonormal basis of the bottom-k eigenspace of ``lap`` by block
    orthogonal iteration on 2I − lap, columns sorted by Rayleigh quotient
    (ascending in lap's spectrum, eigh's order); returns (basis, steps)."""
    n = lap.shape[0]
    a = 2.0 * torch.eye(n, dtype=lap.dtype, device=lap.device) - lap
    q0 = torch.randn((n, k), generator=generator, dtype=lap.dtype)
    q = torch.linalg.qr(q0.to(lap.device))[0]
    steps = 0
    res = float("inf")
    while steps < max_iter and res > tol:
        z = a @ q
        # Rayleigh-Ritz residual of the current q, from the same product
        res = float(torch.abs(z - q @ (q.T @ z)).max())
        q = torch.linalg.qr(z)[0]
        steps += 1
    theta = (q * (lap @ q)).sum(dim=0)
    return q[:, torch.argsort(theta)], steps


def spectral_fit(
    x,
    generator: torch.Generator,
    n_clusters: int,
    n_neighbors: int = 10,
    solver: str = "auto",
    device="cuda",
) -> SpectralResult:
    """Spectral clustering of ``x`` (N, D) on ``device`` (float32)."""
    if solver not in ("auto", "eigh", "subspace"):
        raise ValueError(f"unknown solver {solver!r}")
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    _, lap, d_isqrt = knn_laplacian(x, n_neighbors)
    if solver == "eigh" or (solver == "auto" and n <= _EIGH_MAX_N):
        vecs = torch.linalg.eigh(lap)[1][:, :n_clusters]  # ascending eigenvalues
    else:
        vecs, _ = _bottom_k_subspace(lap, n_clusters, generator)
    emb = vecs * d_isqrt[:, None]  # u = D^{-1/2} v

    # deterministic sign flip (sklearn _deterministic_vector_sign_flip)
    cols = torch.arange(n_clusters, device=dev)
    flip = torch.sign(emb[torch.argmax(emb.abs(), dim=0), cols])
    emb = emb * flip[None, :]

    km = kmeans_fit(emb, generator, n_clusters, device=dev)
    return SpectralResult(km.assignments, emb)
