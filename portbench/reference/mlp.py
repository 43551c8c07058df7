"""The PINN's dropout MLP in plain torch (reference script 01, ``DNN``,
01:389-438): hidden trunk Linear → Tanh → Dropout, the mean head Linear(h, 1),
the variance head Linear(h, h/2) → Tanh → Dropout → Linear(h/2, h/4) → Tanh →
Linear(h/4, 1), and ``logvar = log(softplus(v) + 1e-6)``.

Weights are a list of (W (out, in), b) pairs in the order hidden trunk, mean
head, variance head, float32.  Products run in float32 with TF32 off unless a
rounding is given: then both operands of each rounded product are rounded
to it and the product accumulates in float32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from portbench.reference import masks
from portbench.reference.rounding import Rounding

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def strict_float32() -> None:
    """Float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _split(weights: Weights):
    n_hidden = len(weights) - 4
    return list(weights[:n_hidden]), weights[n_hidden], list(weights[n_hidden + 1:])


def softplus(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-torch.abs(v)))


def logvar(v: torch.Tensor) -> torch.Tensor:
    return torch.log(softplus(v) + 1e-6)


def linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, rnd: Rounding = None,
           w_rounded: torch.Tensor = None) -> torch.Tensor:
    """h @ Wᵀ + b, the operands rounded by ``rnd`` when given (``w_rounded``:
    W already rounded)."""
    if rnd is None:
        return torch.matmul(h, w.t()) + b
    return torch.matmul(rnd(h), (rnd(w) if w_rounded is None else w_rounded).t()) + b


@torch.no_grad()
def eval_forward(weights: Weights, x: torch.Tensor, rnd: Rounding = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean (N,), logvar (N,)) of the eval pass (no dropout), float32, every
    product's operands rounded by ``rnd`` when given."""
    hidden, (wm, bm), var = _split(weights)
    h = x
    for w, b in hidden:
        h = torch.tanh(linear(h, w, b, rnd))
    v = torch.tanh(linear(h, *var[0], rnd))
    v = torch.tanh(linear(v, *var[1], rnd))
    return linear(h, wm, bm, rnd)[..., 0], logvar(linear(v, *var[2], rnd))[..., 0]


@torch.no_grad()
def mc_sums(weights: Weights, x: torch.Tensor, seed: int, passes: int, p: float,
            rnd: Rounding = None, base_rnd: Rounding = None, chunk: int = 16) -> torch.Tensor:
    """(N, 4) float64 [base, Σd, Σd², Σlogvar] of MC dropout over ``passes``
    dropout passes with the hash masks of ``masks``, d = pred − base.  The
    base is the eval pass, its products rounded by ``base_rnd`` when given.
    With ``rnd``, a dropout pass rounds what
    the sample-pass contract rounds: the operands of every trunk product but
    the first and of the first two variance products (their weights once),
    and every activation stored between layers (after the dropout's select
    and scale); layer 0 reads x with float32 weights, and both width-1 heads
    read the stored activations with float32 weights."""
    strict_float32()
    hidden, (wm, bm), var = _split(weights)
    n_hidden = len(hidden)
    thresh, inv_keep = masks.dropout_constants(p)
    store = rnd if rnd is not None else (lambda t: t)
    wide = {} if rnd is None else {id(w): rnd(w) for w, _ in [*hidden[1:], var[0], var[1]]}

    def product(h, w, b):
        if id(w) in wide:
            return linear(h, w, b, rnd, wide[id(w)])
        return linear(h, w, b)

    n = x.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=x.device)
    local = rows % masks.MC_BLOCK
    base = eval_forward(weights, x, base_rnd)[0]
    sums = torch.zeros((n, 4), dtype=torch.float64, device=x.device)
    sums[:, 0] = base.double()
    for s0 in range(0, passes, chunk):
        ss = torch.arange(s0, min(s0 + chunk, passes), dtype=torch.int64, device=x.device)
        salt = masks.mc_salts(rows, seed, ss)  # (passes, N)

        def drop(h, layer):
            kept = masks.keep(local, h.shape[-1], (salt + layer) & masks.U32, thresh)
            return store(torch.where(kept, h * inv_keep, 0.0))

        h = x.expand(len(ss), *x.shape)
        for layer, (w, b) in enumerate(hidden):
            h = drop(torch.tanh(product(h, w, b)), layer)
        pred = linear(h, wm, bm)[..., 0]
        v = drop(torch.tanh(product(h, *var[0])), n_hidden)
        v = store(torch.tanh(product(v, *var[1])))
        lv = logvar(linear(v, *var[2]))[..., 0]
        d = (pred - base).double()
        sums[:, 1] += d.sum(0)
        sums[:, 2] += (d * d).sum(0)
        sums[:, 3] += lv.double().sum(0)
    return sums


def mc_stats(sums: torch.Tensor, passes: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pred_mean, aleatoric std, epistemic std) from the sums: the eval pass,
    sqrt(exp(mean logvar)) and the population std of the dropout passes
    (reference ``get_MC_samples``, 01:1413-1491)."""
    mean_d = sums[:, 1] / passes
    var = torch.clamp_min(sums[:, 2] / passes - mean_d**2, 0.0)
    return sums[:, 0], torch.sqrt(torch.exp(sums[:, 3] / passes)), torch.sqrt(var)


class _RoundedMatmul(torch.autograd.Function):
    """a @ w with both operands rounded, in the forward and in both products
    of the backward (g wᵀ and aᵀ g), each accumulating in float32."""

    @staticmethod
    def forward(ctx, a, w, rnd):
        ctx.save_for_backward(a, w)
        ctx.rnd = rnd
        return torch.matmul(rnd(a), rnd(w))

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        rnd = ctx.rnd
        return torch.matmul(rnd(g), rnd(w).t()), torch.matmul(rnd(a).t(), rnd(g)), None


def _train_linear(h, w, b, rnd: Rounding):
    if rnd is None:
        return torch.matmul(h, w.t()) + b
    return _RoundedMatmul.apply(h, w.t(), rnd) + b


def train_loss_terms(weights: Weights, x: torch.Tensor, y: torch.Tensor,
                     keeps: List[torch.Tensor], inv_keep: float, rnd: Rounding = None
                     ) -> torch.Tensor:
    """Each row's term of the heteroscedastic loss of one training step
    (01:916-927): 0.5·exp(−lv)·(y − pred)² + 0.5·lv + 0.01·|lv|, under inverted
    dropout ``where(keep, h·inv_keep, 0)`` after every hidden tanh and after
    the first tanh of the variance head (``keeps`` in that order); the loss is
    their mean."""
    hidden, (wm, bm), var = _split(weights)

    def drop(h, keep):
        return torch.where(keep, h * inv_keep, 0.0)

    h = x
    for (w, b), keep in zip(hidden, keeps):
        h = drop(torch.tanh(_train_linear(h, w, b, rnd)), keep)
    pred = _train_linear(h, wm, bm, rnd)
    v = drop(torch.tanh(_train_linear(h, *var[0], rnd)), keeps[len(hidden)])
    v = torch.tanh(_train_linear(v, *var[1], rnd))
    lv = logvar(_train_linear(v, *var[2], rnd))
    return 0.5 * torch.exp(-lv) * (y - pred) ** 2 + 0.5 * lv + 0.01 * torch.abs(lv)


def train_steps(weights: Weights, x: torch.Tensor, y: torch.Tensor, seed: int, steps: int,
                lr: float, lr_step: int, lr_gamma: float, p: float, rnd: Rounding = None
                ) -> Tuple[List[float], List[float]]:
    """The first ``steps`` full-batch steps of a DNN stage with dropout seed
    ``seed`` from a fresh Adam (``optax.adam`` over a staircase decay, as
    reference 01:948-955 steps ``torch.optim.Adam`` with StepLR): each step's
    loss and the mean |row term| of it (the loss itself can sit near 0, its
    rows' terms cancelling)."""
    strict_float32()
    thresh, inv_keep = masks.dropout_constants(p)
    leaves = [t.detach().clone() for pair in weights for t in pair]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    n = x.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=x.device)
    local = rows % masks.TRAIN_BLOCK
    widths = [w.shape[0] for w, _ in weights[:len(weights) - 4]] + [weights[-3][0].shape[0]]
    losses, scales = [], []
    for t in range(steps):
        salt = masks.train_salts(rows, seed, t)
        keeps = [masks.keep(local, w, (salt + layer) & masks.U32, thresh)
                 for layer, w in enumerate(widths)]
        params = [leaf.requires_grad_(True) for leaf in leaves]
        pairs = list(zip(params[0::2], params[1::2]))
        terms = train_loss_terms(pairs, x, y, keeps, inv_keep, rnd)
        loss = torch.mean(terms)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        scales.append(float(torch.mean(torch.abs(terms.detach()))))
        lr_t = lr * lr_gamma ** (t // lr_step)
        c = t + 1
        with torch.no_grad():
            new = []
            for i, (leaf, g) in enumerate(zip(leaves, grads)):
                m[i] = 0.9 * m[i] + 0.1 * g
                v[i] = 0.999 * v[i] + 0.001 * g * g
                m_hat = m[i] / (1.0 - 0.9**c)
                v_hat = v[i] / (1.0 - 0.999**c)
                new.append(leaf.detach() - lr_t * m_hat / (torch.sqrt(v_hat) + 1e-8))
        leaves = new
    return losses, scales
