"""MC-dropout uncertainty statistics (counterpart of ``pinnfc_tpu/uq/mc_dropout.py``).

The reference's ``get_MC_samples`` (01:1413-1491) has two phases: an eval
pass gives pred_mean, and ``mc_times`` dropout passes give
aleatoric = sqrt(exp(mean(logvar))) and epistemic = sqrt(population var(pred)).
Every sampler accumulates the base-centred sufficient statistics
[base, Σ(pred−base), Σ(pred−base)², Σlogvar] per row; ``finish_mc_stats``
turns them into ``MCSamples`` exactly as the TPU kernel's wrapper does
(``pallas_mc_dropout.py:184-194``).

Two samplers: the flagship's fused kernel with counter-hash masks
(``ops/mc_dropout.py``), and ``mc_dropout_samples`` here, for any topology,
whose masks come from a ``torch.Generator`` (the JAX package's ``vmap``
sampler, which draws them from ``jax.random``; the two streams agree in
distribution only).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pinnfc_tpu_torch.models.mlp import MLP, draw_keep_masks

# rows × samples per chunk, kept as the JAX package has it: the widest
# activation is (chunk, N, 256) float32, 1.5e6 row-samples ≈ 1.5 GB
_CHUNK_ROW_BUDGET = 1_500_000


class MCSamples(NamedTuple):
    """(pred_mean, aleatoric_std, epistemic_std), normalized domain, (N,)."""

    pred_mean: torch.Tensor
    aleatoric_std: torch.Tensor
    epistemic_std: torch.Tensor


def finish_mc_stats(sums: torch.Tensor, mc_times: int) -> MCSamples:
    """(N, 4) sums [base, Σd, Σd², Σlogvar] over ``mc_times`` passes → MCSamples."""
    m = float(mc_times)
    mean_d = sums[:, 1] / m
    var = torch.clamp_min(sums[:, 2] / m - mean_d**2, 0.0)  # population variance
    mean_lv = sums[:, 3] / m
    return MCSamples(
        pred_mean=sums[:, 0],
        aleatoric_std=torch.sqrt(torch.exp(mean_lv)),
        epistemic_std=torch.sqrt(var),
    )


def mc_chunking(mc_times: int, n: int, chunk: int = 100) -> Tuple[int, int]:
    """(chunk, n_chunks) of ``mc_dropout_samples``: the chunk clamped so that
    chunk·N stays inside the row budget and never exceeds ``mc_times``, and
    ``mc_times`` rounded up to whole chunks; n_chunks·chunk passes run."""
    chunk = max(1, min(chunk, mc_times, _CHUNK_ROW_BUDGET // max(n, 1)))
    return chunk, -(-mc_times // chunk)


@torch.no_grad()
def mc_dropout_samples(
    mlp: MLP,
    x: torch.Tensor,
    generator: torch.Generator,
    mc_times: int = 2000,
    dropout: float = 0.4,
    chunk: int = 100,
) -> Tuple[MCSamples, int]:
    """Chunked two-phase MC-dropout sampler, any topology: (statistics,
    passes run).

    One eval pass gives the base prediction; then ``n_chunks`` batched passes,
    each x broadcast to (chunk, N, in) under one set of masks per sample drawn
    from ``generator`` (on x's device), accumulate the base-centred sums.  When
    ``mc_times`` is not a multiple of the clamped chunk it is rounded UP
    (``mc_chunking``): the extra passes are further unbiased samples, and the
    statistics divide by the passes actually run, which it returns beside
    them."""
    if mc_times < 1:
        raise ValueError(f"mc_times must be >= 1, got {mc_times}")
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {dropout}")
    gen_dev = generator.device
    if (gen_dev.type, gen_dev.index or 0) != (x.device.type, x.device.index or 0):
        raise ValueError(f"the generator lies on {gen_dev}, x on {x.device}")
    n = x.shape[0]
    chunk, n_chunks = mc_chunking(mc_times, n, chunk)
    base = mlp(x)[0][:, 0]
    s_d = torch.zeros_like(base)
    s_d2 = torch.zeros_like(base)
    s_lv = torch.zeros_like(base)
    xb = x.expand(chunk, *x.shape)
    for _ in range(n_chunks):
        keep = draw_keep_masks(mlp, (chunk, n), dropout, generator)
        pred, log_var = mlp(xb, keep, dropout)
        d = pred[..., 0] - base
        s_d = s_d + d.sum(0)
        s_d2 = s_d2 + (d * d).sum(0)
        s_lv = s_lv + log_var[..., 0].sum(0)
    sums = torch.stack([base, s_d, s_d2, s_lv], dim=1)
    return finish_mc_stats(sums, n_chunks * chunk), n_chunks * chunk


@torch.no_grad()
def mc_dropout_samples_loop(
    mlp: MLP,
    x: torch.Tensor,
    generator: torch.Generator,
    mc_times: int = 64,
    dropout: float = 0.4,
) -> MCSamples:
    """Literal per-sample loop: one pass, one set of (N, width) masks from
    ``generator`` at a time, then the reference's mean and population
    variance — the statistical-parity oracle of the tests."""
    base = mlp(x)[0][:, 0]
    preds, log_vars = [], []
    for _ in range(mc_times):
        keep = draw_keep_masks(mlp, (x.shape[0],), dropout, generator)
        p, lv = mlp(x, keep, dropout)
        preds.append(p[:, 0])
        log_vars.append(lv[:, 0])
    preds = torch.stack(preds)
    log_vars = torch.stack(log_vars)
    return MCSamples(
        pred_mean=base,
        aleatoric_std=torch.sqrt(torch.exp(torch.mean(log_vars, dim=0))),
        epistemic_std=torch.sqrt(torch.var(preds, dim=0, unbiased=False)),
    )
