"""KMeans on a device (counterpart of ``pinnfc_tpu/diagnosis/kmeans.py``):
k-means++ seeding, then Lloyd iterations, the ``n_init`` restarts batched
along a leading dimension.

The replacement for sklearn KMeans in script 05's "KMeans posterior" method
(05:346-393) and the GMM initializer (sklearn ``init_params='kmeans'``).
Distances are one batched matmul (‖x‖² − 2x·μᵀ + ‖μ‖², clamped at 0) in
full float32.

Draws: the JAX package seeds from ``jax.random`` streams, which torch cannot
reproduce.  Here each restart takes one uniform row index for its first
centre and one uniform per further centre from a CPU ``torch.Generator``;
a centre is then the inverse CDF of that uniform over the cumulative
``min_d2`` (``searchsorted``), which is ``jax.random.choice(p=min_d2/Σ)``'s
distribution.  The seeding runs in float64, so the CPU and the card pick the
same rows from the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pinnfc_tpu_torch.device import resolve_device


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (C, D)
    assignments: torch.Tensor  # (N,)
    inertia: torch.Tensor  # () sum of squared distances
    n_iter: torch.Tensor  # ()


def _pairwise_sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(..., N, C) squared distances of x (N, D) to centers (..., C, D)."""
    x2 = (x**2).sum(dim=1, keepdim=True)  # (N, 1)
    c2 = (centers**2).sum(dim=-1).unsqueeze(-2)  # (..., 1, C)
    return torch.clamp(x2 - 2.0 * (x @ centers.transpose(-1, -2)) + c2, min=0.0)


def _draw(generator: torch.Generator, n: int, n_clusters: int, n_init: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first centre's row (R,), uniforms (R, C − 1) in float64) on the CPU."""
    if generator.device.type != "cpu":
        raise ValueError("k-means++ draws come from a CPU torch.Generator, so that the CPU "
                         f"and the card seed alike; got one on {generator.device}")
    first = torch.randint(0, n, (n_init,), generator=generator)
    u = torch.rand((n_init, n_clusters - 1), generator=generator, dtype=torch.float64)
    return first, u


def _kmeans_plus_plus(x: torch.Tensor, first: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding of R restarts from their draws → centres (R, C, D),
    rows of ``x``."""
    n = x.shape[0]
    x64 = x.to(torch.float64)
    picks = [first]
    min_d2 = ((x64[None] - x64[first][:, None]) ** 2).sum(dim=2)  # (R, N)
    for i in range(u.shape[1]):
        cdf = torch.cumsum(min_d2, dim=1)
        target = (u[:, i] * cdf[:, -1])[:, None]
        idx = torch.searchsorted(cdf, target, right=True)[:, 0].clamp(max=n - 1)
        picks.append(idx)
        min_d2 = torch.minimum(min_d2, ((x64[None] - x64[idx][:, None]) ** 2).sum(dim=2))
    return x[torch.stack(picks, dim=1)]


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int, tol: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations of R restarts at once from centres (R, C, D): a
    restart freezes once its centres move by ≤ tol (squared, summed); an
    empty cluster keeps its centre.  Stops when every restart has frozen
    (one host read per iteration) or after ``max_iter``; returns (centres,
    n_iter (R,))."""
    r, c, _ = centers.shape
    done = torch.zeros(r, dtype=torch.bool, device=x.device)
    n_iter = torch.zeros(r, dtype=torch.int64, device=x.device)
    for _ in range(max_iter):
        assign = torch.argmin(_pairwise_sq_dists(x, centers), dim=2)  # (R, N)
        onehot = torch.nn.functional.one_hot(assign, c).to(x.dtype)  # (R, N, C)
        counts = onehot.sum(dim=1)[:, :, None]  # (R, C, 1)
        sums = onehot.transpose(1, 2) @ x  # (R, C, D)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
        shift = ((new - centers) ** 2).sum(dim=(1, 2))
        centers = torch.where(done[:, None, None], centers, new)
        n_iter = torch.where(done, n_iter, n_iter + 1)
        done = done | (shift <= tol)
        if bool(done.all()):
            break
    return centers, n_iter


def kmeans_fit(
    x,
    generator: torch.Generator,
    n_clusters: int,
    max_iter: int = 300,
    tol: float = 1e-4,
    n_init: int = 4,
    device="cuda",
) -> KMeansResult:
    """Best of ``n_init`` restarts by inertia (ties to the first), all
    restarts in one batch on ``device`` (float32)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    first, u = (a.to(dev) for a in _draw(generator, x.shape[0], n_clusters, n_init))
    centers, n_iter = _lloyd(x, _kmeans_plus_plus(x, first, u), max_iter, tol)
    d2 = _pairwise_sq_dists(x, centers)  # (R, N, C)
    assignments = torch.argmin(d2, dim=2)
    inertia = d2.amin(dim=2).sum(dim=1)
    best = int(torch.argmin(inertia))
    return KMeansResult(centers[best], assignments[best], inertia[best], n_iter[best])


def kmeans_predict(centers: torch.Tensor, x) -> torch.Tensor:
    """Nearest-center assignment (test-set path of 05:385-392)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=centers.device)
    return torch.argmin(_pairwise_sq_dists(x, centers), dim=1)
