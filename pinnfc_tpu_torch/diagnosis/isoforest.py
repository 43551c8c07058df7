"""Isolation Forest on a device (counterpart of
``pinnfc_tpu/diagnosis/isoforest.py``).

The reference's unsupervised detector is ``sklearn.IsolationForest(
n_estimators=200, contamination='auto')`` fit on normal-only rows
(02:583-596), scored as ``-score_samples`` (02:592).  Every tree is a
*complete* fixed-depth array-encoded binary tree (feature / threshold /
node-size tables), built from an ψ-row subsample level by level and batched
over the trees:

- draws (``_draw``, from a CPU ``torch.Generator``, so the CPU and the card
  build the same forest): per tree the subsample without replacement, one
  feature per node and one uniform per node, level by level;
- build (``_build_trees_from_draws``): per level, boolean membership masks
  (T, 2^l, ψ), per-node masked min/max of the drawn feature, threshold
  ``lo + u·(hi − lo)`` (the extremely-randomized split rule sklearn uses),
  ``vals < thr`` going left; empty nodes split at 0;
- score: a gather walk — each of the H levels gathers, for every (tree, row)
  pair, the current node's size, feature and threshold and the row's value of
  that feature, and steps to child ``2i + (v ≥ thr)``.  A row that reaches a
  node of size ≤ 1 freezes at ``lvl + c(size)``; one that reaches depth H
  takes ``H + c(size)`` of its external node.

The JAX package avoids gathers (a TPU runs them slowly) with an (N, M)
one-hot decision table per tree; at the campaign's 14,040 test rows × 255
nodes × 200 trees that table alone is 2.9 GB of float32.  The gather walk
holds (T, N) tensors only and computes the same path lengths.

Anomaly score s(x) = 2^{−E[h(x)]/c(ψ)} (Liu et al.; sklearn's
``-score_samples``), with sklearn's average-path-length correction c(n).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pinnfc_tpu_torch.device import resolve_device

_EULER = 0.5772156649015329


class IsoForest(NamedTuple):
    feature: torch.Tensor  # (T, M) int64 — split feature per internal node
    threshold: torch.Tensor  # (T, M) float32
    size: torch.Tensor  # (T, 2M+1) float32 — training-subsample rows per node
    depth: int  # tree depth H (M = 2^H − 1 internal nodes)
    psi: int  # subsample size


def _avg_path_length(n: torch.Tensor) -> torch.Tensor:
    """c(n): expected unsuccessful-search path length of a BST with n
    external nodes (sklearn's ``_average_path_length``), in float32."""
    n = n.to(torch.float32)
    c = 2.0 * (torch.log(torch.clamp(n - 1.0, min=1.0)) + _EULER) - 2.0 * (
        torch.clamp(n - 1.0, min=0.0) / torch.clamp(n, min=1.0)
    )
    return torch.where(n <= 1.0, torch.zeros_like(c), torch.where(n == 2.0, torch.ones_like(c), c))


def _draw(generator: torch.Generator, n: int, d: int, n_estimators: int, psi: int,
          depth: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(subsample (T, ψ), feature (T, M), uniform (T, M)) on the CPU, nodes
    in level order (node m of level l at column 2^l − 1 + m)."""
    if generator.device.type != "cpu":
        raise ValueError("the forest's draws come from a CPU torch.Generator, so that the "
                         f"CPU and the card build the same trees; got one on {generator.device}")
    n_internal = 2**depth - 1
    sub = torch.rand((n_estimators, n), generator=generator).argsort(dim=1)[:, :psi]
    feat = torch.randint(0, d, (n_estimators, n_internal), generator=generator)
    u = torch.rand((n_estimators, n_internal), generator=generator)
    return sub, feat, u


def _build_trees_from_draws(x: torch.Tensor, sub: torch.Tensor, feat: torch.Tensor,
                            u: torch.Tensor, depth: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Node tables (feature, threshold, size) of T trees from their draws,
    batched over the trees; ``x`` (n, d) float32, the draws on x's device."""
    t, psi = sub.shape
    xs = x[sub]  # (T, ψ, d)
    xs_t = xs.transpose(1, 2)  # (T, d, ψ)
    thresholds = torch.zeros(feat.shape, dtype=torch.float32, device=x.device)
    sizes = torch.zeros((t, 2 ** (depth + 1) - 1), dtype=torch.float32, device=x.device)
    masks = torch.ones((t, 1, psi), dtype=torch.bool, device=x.device)  # level-0 membership
    for lvl in range(depth):
        lo, cnt = 2**lvl - 1, 2**lvl
        sz = masks.sum(dim=2).to(torch.float32)  # (T, 2^l)
        sizes[:, lo:lo + cnt] = sz
        f = feat[:, lo:lo + cnt]  # (T, 2^l)
        # the drawn feature's values of every subsample row, per node
        vals = torch.gather(xs_t, 1, f[:, :, None].expand(t, cnt, psi))  # (T, 2^l, ψ)
        empty = sz < 1.0
        hi = vals.masked_fill(~masks, float("-inf")).amax(dim=2).masked_fill(empty, 0.0)
        lo_v = vals.masked_fill(~masks, float("inf")).amin(dim=2).masked_fill(empty, 0.0)
        # one rounding of the exact lo + u·(hi − lo), as a fused multiply-add
        # gives (XLA contracts the JAX form into one): the product of two
        # float32 values is exact in float64, so the CPU and the card agree
        thr = (lo_v.double() + u[:, lo:lo + cnt].double() * (hi - lo_v).double()).float()
        thresholds[:, lo:lo + cnt] = thr
        go_left = vals < thr[:, :, None]
        masks = torch.stack([masks & go_left, masks & ~go_left], dim=2).reshape(t, 2 * cnt, psi)
    # depth-H external nodes
    sizes[:, 2**depth - 1:] = masks.sum(dim=2).to(torch.float32)
    return feat, thresholds, sizes


def isoforest_fit(
    x,
    generator: torch.Generator,
    n_estimators: int = 200,
    max_samples: int = 256,
    depth: Optional[int] = None,
    device="cuda",
) -> IsoForest:
    """Fit the forest on ``device`` (sklearn defaults: 200 trees,
    ψ = min(256, n), tree height cap ⌈log2 ψ⌉ — 02:583-587).  The draws come
    from ``generator``, a CPU ``torch.Generator``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n, d = x.shape
    psi = int(min(max_samples, n))
    if depth is None:
        depth = max(1, math.ceil(math.log2(psi)))
    sub, feat, u = (a.to(dev) for a in _draw(generator, n, d, n_estimators, psi, depth))
    feature, threshold, size = _build_trees_from_draws(x, sub, feat, u, depth)
    return IsoForest(feature, threshold, size, depth, psi)


def isoforest_score(model: IsoForest, x) -> torch.Tensor:
    """Anomaly score s(x) = 2^{−E[h]/c(ψ)} ∈ (0, 1] — higher = more
    anomalous; sklearn's ``-score_samples`` up to the ensemble's randomness
    (the pipeline's ROC input, 02:592).  On the model's device."""
    dev = model.feature.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    t = model.feature.shape[0]
    x_t = x.T.contiguous()  # (d, N): x_t.gather(0, f)[t, i] = x[i, f[t, i]]
    node = torch.zeros((t, n), dtype=torch.int64, device=dev)  # level-local index
    h = torch.zeros((t, n), dtype=torch.float32, device=dev)
    done = torch.zeros((t, n), dtype=torch.bool, device=dev)
    for lvl in range(model.depth):
        idx = node + (2**lvl - 1)
        sz = torch.gather(model.size, 1, idx)
        leaf = sz <= 1.0
        h = torch.where(~done & leaf, lvl + _avg_path_length(sz), h)
        done = done | leaf
        v = torch.gather(x_t, 0, torch.gather(model.feature, 1, idx))
        go_right = v >= torch.gather(model.threshold, 1, idx)
        node = 2 * node + go_right.to(torch.int64)
    sz_ext = torch.gather(model.size, 1, node + (2**model.depth - 1))
    h = torch.where(done, h, model.depth + _avg_path_length(sz_ext))
    mean_h = h.mean(dim=0)
    c_psi = _avg_path_length(torch.tensor(float(model.psi), device=dev))
    return 2.0 ** (-mean_h / c_psi)
