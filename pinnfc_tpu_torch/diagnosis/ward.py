"""Ward agglomerative clustering on a device (counterpart of
``pinnfc_tpu/diagnosis/ward.py``).

Reference: sklearn ``AgglomerativeClustering(linkage='ward')`` (05:416-425).
Ward greedily merges the pair of clusters minimizing the variance increase
Δ(i,j) = (nᵢnⱼ/(nᵢ+nⱼ))·‖cᵢ−cⱼ‖².  The two exact algorithms of the JAX
package, chosen by the same size rule (``algorithm="auto"``: global up to
N = 2048, NN-chain above):

- ``"global"``: N−k merges, each over the full masked (N, N) merge-cost
  matrix (the ‖a‖²+‖b‖²−2ab expansion, full float32), its first minimum in
  row-major order, the merged cluster kept in the lower slot.  Each merge is
  a fixed chain of launches with no host read.
- ``"nn-chain"``: the nearest-neighbor chain (what sklearn and scipy run).
  Each chain step is one O(N·D) row of centroid costs and an argmin; on a
  cost tie the previous chain element wins (scipy's rule, which makes the
  chain's costs strictly decrease).  The JAX ``while_loop`` with its
  ``lax.cond`` becomes a branch-free step on the device (merge and push
  both computed, one of them kept; a no-op once all N−1 merges are
  recorded), run in blocks of ``_CHAIN_BLOCK`` steps with one host read of
  the merge count per block; on CUDA a block is one CUDA graph, replayed.
  The k-cluster partition is recovered as scipy's ``label`` does: the N−1
  recorded merges sorted stably by height, the cheapest N−k replayed
  through a union-find on the host, whose roots are the label the JAX
  package's label propagation gives each cluster; then the surviving labels
  are ranked (``unique``/``searchsorted``).

Cluster IDs are arbitrary (as in sklearn); the comparison pipeline's
posterior calibration absorbs permutations.  Exact cost ties (duplicate
rows) resolve by the rules above; with distinct costs both algorithms give
sklearn's partition.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device

# above this N the global algorithm's per-merge (N, N) streams dominate;
# flip to the NN-chain (the JAX package's rule)
_GLOBAL_MAX_N = 2048
# NN-chain steps launched between two host reads of the merge count
_CHAIN_BLOCK = 256


class WardResult(NamedTuple):
    assignments: torch.Tensor  # (N,) int64 in [0, n_clusters)
    centers: torch.Tensor  # (n_clusters, D) cluster means


def _ward_global(x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Greedy global-minimum merges; per-point labels in [0, n_clusters)."""
    n = x.shape[0]
    dev = x.device
    centroids = x.clone()
    sizes = torch.ones(n, dtype=x.dtype, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    assign = torch.arange(n, device=dev)
    off_diag = ~torch.eye(n, dtype=torch.bool, device=dev)
    for _ in range(n - n_clusters):
        sq = (centroids**2).sum(dim=1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (centroids @ centroids.T), min=0.0)
        w = (sizes[:, None] * sizes[None, :]) / (sizes[:, None] + sizes[None, :])
        pair_ok = active[:, None] & active[None, :] & off_diag
        cost = torch.where(pair_ok, w * d2, float("inf"))
        flat = torch.argmin(cost.reshape(-1)).reshape(1)  # the first minimum
        i, j = flat // n, flat % n
        i, j = torch.minimum(i, j), torch.maximum(i, j)  # keep the lower slot
        n_i, n_j = sizes[i], sizes[j]
        c_new = (n_i[:, None] * centroids[i] + n_j[:, None] * centroids[j]) / (n_i + n_j)[:, None]
        centroids.index_copy_(0, i, c_new)
        sizes.index_copy_(0, i, n_i + n_j)
        active.index_fill_(0, j, False)
        assign = torch.where(assign == j, i, assign)
    # relabel surviving slots to dense 0..k-1 (active slots, ascending)
    slot_rank = torch.cumsum(active, dim=0) - 1
    return slot_rank[assign]


def _chain_step(n, ar, centroids, sizes, active, chain, clen, m_a, m_b, m_h, mcount, steps):
    """One NN-chain step, in place on the state tensors, branch-free: a merge
    of the chain's top with its nearest neighbor when they are reciprocal,
    else a push of that neighbor; nothing once all N−1 merges are recorded
    (``steps`` counts the steps that did something).  Indices are
    (1,)-shaped tensors, so no step reads the device."""
    running = mcount < n - 1
    steps.add_(running.to(steps.dtype))
    empty = clen == 0
    # (re)start the chain from the first active cluster when empty
    first = torch.argmax(active.to(torch.uint8)).reshape(1)
    top = torch.where(empty, first, chain[torch.clamp(clen - 1, min=0)])
    chain[:1] = torch.where(empty, top, chain[:1])
    clen.copy_(torch.where(empty, 1, clen))

    size_top = sizes[top]
    diff = centroids - centroids[top]
    w = sizes * size_top / (sizes + size_top)
    row = torch.where(active & (ar != top), w * (diff * diff).sum(dim=1), float("inf"))
    y0 = torch.argmin(row).reshape(1)
    # prefer the previous chain element on cost ties (scipy's rule)
    prev = chain[torch.clamp(clen - 2, min=0)]
    reciprocal = (clen >= 2) & (row[prev] <= row[y0])
    y = torch.where(reciprocal, prev, y0)
    merge = reciprocal & running
    push = ~reciprocal & running

    a, b = torch.minimum(top, y), torch.maximum(top, y)
    n_a, n_b = sizes[a], sizes[b]
    c_a = centroids[a]
    c_new = (n_a[:, None] * c_a + n_b[:, None] * centroids[b]) / (n_a + n_b)[:, None]
    centroids.index_copy_(0, a, torch.where(merge[:, None], c_new, c_a))
    sizes.index_copy_(0, a, torch.where(merge, n_a + n_b, n_a))
    active.index_copy_(0, b, active[b] & ~merge)
    slot = torch.clamp(mcount, max=n - 2)
    m_a.index_copy_(0, slot, torch.where(merge, a, m_a[slot]))
    m_b.index_copy_(0, slot, torch.where(merge, b, m_b[slot]))
    m_h.index_copy_(0, slot, torch.where(merge, row[y], m_h[slot]))
    mcount.add_(merge.to(mcount.dtype))
    at = torch.clamp(clen, max=n + 1)
    chain.index_copy_(0, at, torch.where(push, y, chain[at]))
    clen.copy_(torch.where(merge, clen - 2, torch.where(push, clen + 1, clen)))


def _replay_labels(m_a: np.ndarray, m_b: np.ndarray, m_h: np.ndarray, n: int,
                   n_clusters: int) -> np.ndarray:
    """The N−k cheapest merges (stable sort by height) through a union-find;
    a cluster's root is the label the JAX package's label propagation
    (``lbl = where(lbl == lbl[b], lbl[a], lbl)``) gives it.  Returns labels
    ranked to [0, n_clusters)."""
    parent = np.arange(n)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    for m in np.argsort(m_h, kind="stable")[: n - n_clusters]:
        parent[find(m_b[m])] = find(m_a[m])
    roots = np.array([find(i) for i in range(n)])
    return np.searchsorted(np.unique(roots), roots)


def _nn_chain_merges(x: torch.Tensor):
    """The N−1 merges of the NN-chain as host arrays (a, b, height) and the
    number of chain steps taken.  On CUDA the steps after the first block run
    as replays of one CUDA graph of ``_CHAIN_BLOCK`` steps (the block's
    launches cost the host once, at capture), on the CPU as a Python loop;
    both run the same kernels in the same order."""
    n = x.shape[0]
    dev = x.device
    state = dict(
        centroids=x.clone(),
        sizes=torch.ones(n, dtype=x.dtype, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        chain=torch.zeros(n + 2, dtype=torch.int64, device=dev),
        clen=torch.zeros(1, dtype=torch.int64, device=dev),
        m_a=torch.zeros(n - 1, dtype=torch.int64, device=dev),
        m_b=torch.zeros(n - 1, dtype=torch.int64, device=dev),
        m_h=torch.zeros(n - 1, dtype=x.dtype, device=dev),
        mcount=torch.zeros(1, dtype=torch.int64, device=dev),
        steps=torch.zeros(1, dtype=torch.int64, device=dev),
    )
    ar = torch.arange(n, device=dev)

    def block():
        for _ in range(_CHAIN_BLOCK):
            _chain_step(n, ar, **state)

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            block()  # the first block runs eagerly: the warm-up before capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            block()  # recorded, not run
        block = graph.replay
    # every merge pops two chain elements that were pushed once each, and a
    # restart pushes two: at most 3(N − 1) steps
    for _ in range(0, 3 * n, _CHAIN_BLOCK):
        if int(state["mcount"]) == n - 1:
            break
        block()
    if int(state["mcount"]) != n - 1:
        raise RuntimeError(f"NN-chain Ward did not finish its {n - 1} merges in {3 * n} steps")
    return (*(state[k].cpu().numpy() for k in ("m_a", "m_b", "m_h")), int(state["steps"]))


def _ward_nn_chain(x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """NN-chain Ward; per-point labels in [0, n_clusters)."""
    m_a, m_b, m_h, _ = _nn_chain_merges(x)
    return torch.as_tensor(_replay_labels(m_a, m_b, m_h, x.shape[0], n_clusters),
                           device=x.device)


def ward_fit(x, n_clusters: int, algorithm: str = "auto", device="cuda") -> WardResult:
    """Ward clustering of ``x`` (N, D) on ``device`` (float32)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    if n_clusters >= n:
        raise ValueError(f"n_clusters={n_clusters} must be < n={n}")
    if algorithm not in ("auto", "global", "nn-chain"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    use_global = algorithm == "global" or (algorithm == "auto" and n <= _GLOBAL_MAX_N)
    labels = (_ward_global if use_global else _ward_nn_chain)(x, n_clusters)

    # cluster means
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
    counts = torch.clamp(onehot.sum(dim=0), min=1.0)
    return WardResult(labels, (onehot.T @ x) / counts[:, None])
