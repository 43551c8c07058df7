"""Dropout MLP with heteroscedastic variance head
(counterpart of ``pinnfc_tpu/models/mlp.py``; reference ``DNN``, 01:389-438).

- hidden trunk: Linear → Tanh (→ Dropout in training) per hidden layer;
- mean head: one Linear (01:410);
- variance head: Linear(h→h/2) → Tanh (→ Dropout in training) →
  Linear(h/2→h/4) → Tanh → Linear(h/4→1), then
  ``logvar = log(softplus(v) + 1e-6)`` (01:412-434).

``MLP.forward(x)`` is the eval pass; ``MLP.forward(x, keep, dropout_p)`` the
train pass with the given keep masks, so each caller chooses the random
stream: the ``torch.Generator`` stream of ``draw_keep_masks`` (the MC sampler
``uq/mc_dropout.py``) or the counter hash of the training kernel (the autograd
DNN stage).  The flagship's MC passes and DNN stages run in the kernels
(``ops/mc_dropout.py``, ``ops/train_dnn.py``).

``product_dtype=torch.bfloat16`` is the JAX package's ``precision='default'``
on a TPU (``jnp.matmul(a, w, precision=None)``, one bf16 MXU pass): every
product of the forward, and both products of its backward, takes operands
rounded to bf16 and gives a float32 result (``RoundedMatmul``).  bf16 GEMM
with a bf16 output would round the result as well, which is another
contract.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pinnfc_tpu_torch.device import resolve_device


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``max(v, 0) + log1p(exp(-|v|))`` — the form of ``jax.nn.softplus``.
    torch's ``F.softplus`` switches to the identity above ``threshold=20``,
    which differs."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-torch.abs(v)))


def rounded_matmul(a: torch.Tensor, b: torch.Tensor,
                   product_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``product_dtype`` (None: as
    they are) and the product computed in their own dtype: bf16 operands
    with float32 (or, for float64 inputs, float64) accumulation."""
    if product_dtype is None:
        return a @ b
    return a.to(product_dtype).to(a.dtype) @ b.to(product_dtype).to(b.dtype)


class RoundedMatmul(torch.autograd.Function):
    """``a @ w`` (a (..., K), w (K, J)) with operands rounded to ``dtype``,
    in the forward and in both products of the backward, each with a result
    in a's dtype: the transposed products keep the forward's precision, as
    JAX's transposed ``dot_general`` does on a TPU."""

    @staticmethod
    def forward(ctx, a, w, dtype):
        ctx.save_for_backward(a, w)
        ctx.dtype = dtype
        return rounded_matmul(a, w, dtype)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = rounded_matmul(g, w.t(), ctx.dtype)
        gw = rounded_matmul(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]),
                            ctx.dtype)
        return ga, gw, None


def linear(lin: nn.Linear, h: torch.Tensor,
           product_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin(h)``, or with ``product_dtype`` the product of ``RoundedMatmul``
    plus the float32 bias."""
    if product_dtype is None:
        return lin(h)
    return RoundedMatmul.apply(h, lin.weight.t(), product_dtype) + lin.bias


def logvar_from_raw(v: torch.Tensor) -> torch.Tensor:
    """``log(softplus(v) + 1e-6)`` (01:434)."""
    return torch.log(softplus(v) + 1e-6)


class MLP(nn.Module):
    """Layer sizes ``layers`` = (in, hidden..., out); flagship (8, 256, 256, 256, 1)."""

    def __init__(
        self,
        layers: Sequence[int] = (8, 256, 256, 256, 1),
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        layers = tuple(int(n) for n in layers)
        self.layers = layers
        h = layers[-2]
        self.hidden = nn.ModuleList(
            nn.Linear(layers[i], layers[i + 1], device=device)
            for i in range(len(layers) - 2)
        )
        self.mean = nn.Linear(h, layers[-1], device=device)
        self.var = nn.ModuleList([
            nn.Linear(h, h // 2, device=device),
            nn.Linear(h // 2, h // 4, device=device),
            nn.Linear(h // 4, layers[-1], device=device),
        ])
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """U(±1/√fan_in) for weight and bias, like ``torch.nn.Linear``, drawn
        from ``generator`` (on the CPU, so a seed gives the same weights on
        every device)."""
        for lin in self.linears():
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                draw = torch.empty(p.shape, dtype=torch.float32)
                draw.uniform_(-bound, bound, generator=generator)
                p.copy_(draw)

    def linears(self):
        """The Linear layers in the JAX package's weight order: hidden trunk,
        mean head, variance head."""
        return [*self.hidden, self.mean, *self.var]

    def is_flagship(self) -> bool:
        return self.layers == (8, 256, 256, 256, 1)

    def dropout_widths(self) -> List[int]:
        """Widths of the dropout layers, in the order of the keep masks: every
        hidden layer, then the first variance layer."""
        return [lin.out_features for lin in self.hidden] + [self.var[0].out_features]

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None,
                dropout_p: float = 0.2, product_dtype: Optional[torch.dtype] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar), both (..., 1).  ``keep=None`` is the eval pass;
        otherwise the train pass: inverted dropout ``where(keep, h / (1 − p),
        0)`` after every hidden tanh and after the first tanh of the variance
        head, with the bool masks ``keep`` (``dropout_widths`` order), each
        broadcast against its activation (..., width).  ``product_dtype``
        rounds every product's operands (``linear``)."""
        h = x
        for i, lin in enumerate(self.hidden):
            h = torch.tanh(linear(lin, h, product_dtype))
            if keep is not None:
                h = dropout(h, keep[i], dropout_p)
        mean = linear(self.mean, h, product_dtype)
        v = torch.tanh(linear(self.var[0], h, product_dtype))
        if keep is not None:
            v = dropout(v, keep[len(self.hidden)], dropout_p)
        v = torch.tanh(linear(self.var[1], v, product_dtype))
        v = linear(self.var[2], v, product_dtype)
        return mean, logvar_from_raw(v)


def dropout(h: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """``where(keep, h / (1 − p), 0)``, the JAX package's ``_dropout``."""
    return torch.where(keep, h / (1.0 - p), 0.0)


def draw_keep_masks(mlp: MLP, shape: Sequence[int], p: float,
                    generator: torch.Generator) -> List[torch.Tensor]:
    """Bool keep masks (*shape, width) for every dropout layer of ``mlp``
    (``MLP.dropout_widths`` order), each element kept with probability 1 − p:
    ``torch.rand(..., generator=generator) >= p`` on the generator's device."""
    dev = generator.device
    return [torch.rand((*shape, w), generator=generator, device=dev) >= p
            for w in mlp.dropout_widths()]


def aleatoric_loss(y_true, y_pred, log_var, reg_weight: float = 0.01,
                   n_total: Optional[int] = None):
    """Heteroscedastic Gaussian NLL + L1 logvar regularizer (01:916-927).
    With ``n_total``, a row shard's term of that loss over ``n_total`` rows:
    its rows' sums of both parts divided by ``n_total``."""
    precision = torch.exp(-log_var)
    if n_total is None:
        nll = torch.mean(0.5 * precision * (y_true - y_pred) ** 2 + 0.5 * log_var)
        return nll + reg_weight * torch.mean(torch.abs(log_var))
    nll = torch.sum(0.5 * precision * (y_true - y_pred) ** 2 + 0.5 * log_var)
    return (nll + reg_weight * torch.sum(torch.abs(log_var))) / n_total
