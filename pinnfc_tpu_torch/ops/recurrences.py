"""First-order linear recurrences on tensors (counterpart of
``pinnfc_tpu/ops/recurrences.py``).

The reference's only sequential computations are first-order linear
recurrences evaluated in Python loops:

- the RF(t) leaky risk integral ``C[t] = λ·C[t-1] + S[t]`` (04:262-264);
- the EMA smoother ``y[t] = α·x[t] + (1-α)·y[t-1]`` (04:276-279).

Both have the form ``y[t] = a[t]·y[t-1] + b[t]`` along the leading axis.
``linear_recurrence_assoc`` runs it as a log-depth doubling scan over the
pairs ``(a, b)`` with the combine ``(a, b) ∘ (a', b') = (a·a', a'·b + b')``,
every round one elementwise pass on the tensor's device.  It agrees with the
sequential loop in exact arithmetic and to float tolerance in float32.  No
closed form through cumulative products and a division by ``λ^t`` is used:
``(1-α)^-t = 0.8^-t`` overflows float32 past t ≈ 400, and a condition runs
to 1,050 rows.
"""

from __future__ import annotations

import torch


def linear_recurrence_assoc(a: torch.Tensor, b: torch.Tensor, y0=0.0,
                            max_len: int | None = None) -> torch.Tensor:
    """``y[t] = a[t]·y[t-1] + b[t]`` with ``y[-1] = y0``, as an inclusive
    doubling scan: in the round of offset d, element i is composed with its
    left neighbour at offset d, or below d with the identity (1, 0), which
    leaves it as it is; after it, element i holds the composition of elements
    (i − 2d, i] (of [0, i] near the start), so ⌈log2 N⌉ rounds leave y[i] in
    b[i].

    ``max_len`` runs the rounds of every length up to it (default N), so the
    ops do not depend on N: ``torch.export`` traces the scan with a symbolic
    N.  A round at d ≥ N changes nothing but the sign of a zero (``b·1`` and
    ``a·0 + b``).  Nothing is sliced at a size that depends on N."""
    n = b.shape[0]
    if isinstance(y0, torch.Tensor):
        y0 = y0.to(b.dtype)
    # the identity's rows, made once: each round pads with views of them
    one, zero = torch.ones_like(a[:1]), torch.zeros_like(b[:1])
    # b[0] + a[0]·y0, and b + 0 below it
    b = b + torch.cat([a[:1] * y0, zero.expand_as(b)])[:n]
    d = 1
    while d < (n if max_len is None else max_len):
        # left (a[i−d], b[i−d]), the identity below d, composed with (a[i], b[i])
        a_left = torch.cat([one.expand((d,) + a.shape[1:]), a])[:n]
        b_left = torch.cat([zero.expand((d,) + b.shape[1:]), b])[:n]
        a, b = a_left * a, a * b_left + b
        d *= 2
    return b


def leaky_integral(s: torch.Tensor, decay: float) -> torch.Tensor:
    """RF(t) accumulator ``C[t] = decay·C[t-1] + S[t]`` from ``C[-1] = 0``
    (04:262-264)."""
    return linear_recurrence_assoc(torch.full_like(s, decay), s)


def ema(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Exponential moving average seeded with x[0] (04:276-279):
    ``y[0] = x[0]; y[t] = α·x[t] + (1-α)·y[t-1]``, as the recurrence with
    ``y[-1] = x[0]`` (a[0]·x0 + b[0] = (1-α)·x0 + α·x0 = x0)."""
    return linear_recurrence_assoc(torch.full_like(x, 1.0 - alpha), alpha * x, x[0])
