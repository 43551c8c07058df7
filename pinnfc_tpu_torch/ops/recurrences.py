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


def linear_recurrence_assoc(a: torch.Tensor, b: torch.Tensor, y0=0.0) -> torch.Tensor:
    """``y[t] = a[t]·y[t-1] + b[t]`` with ``y[-1] = y0``, as an inclusive
    doubling scan: after the round of offset d, element i holds the
    composition of elements (i − 2d, i] (of [0, i] near the start), so
    ⌈log2 N⌉ rounds leave y[i] in b[i]."""
    y0 = torch.as_tensor(y0, dtype=b.dtype, device=b.device)
    b = torch.cat([b[:1] + a[:1] * y0, b[1:]])
    d = 1
    while d < b.shape[0]:
        # left (a[i−d], b[i−d]) composed with right (a[i], b[i])
        a, b = (torch.cat([a[:d], a[:-d] * a[d:]]),
                torch.cat([b[:d], a[d:] * b[:-d] + b[d:]]))
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
