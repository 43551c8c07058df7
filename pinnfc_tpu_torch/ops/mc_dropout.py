"""Fused MC-dropout sampler: the CUDA kernel ``csrc/mc_dropout.cu`` and its
plain PyTorch version (counterpart of ``pinnfc_tpu/ops/pallas_mc_dropout.py``).

Both produce, per row, [base, Σ(pred−base), Σ(pred−base)², Σlogvar] over
``mc_times`` dropout passes, with masks drawn from the TPU kernel's
counter-based Wang hash, bit for bit: global row r lies in mask block
``r // 256`` at local row ``r % 256``, and element (lr, c) of layer l (width W)
is kept iff ``wang(lr·W + c ^ wang(salt + 0x9E3779B9)) >= thresh`` with
``salt = seed·7919 + blk·104729 + s·15485863 + l`` in wrapping uint32.  A
call on a row shard whose first row is global row ``256·block0`` passes
``block0``: its row r draws the masks of global block ``block0 + r // 256``, so
the shards of a split at multiples of 256 rows give the sums of one call over
all rows (rows do not interact).

Precision.  The TPU kernel runs its base pass at ``Precision.HIGHEST`` and its
sample passes at the default matmul precision, which is one bf16 pass on a
TPU and float32 on a CPU.  The port does the same: the base pass is float32
everywhere; the sample passes are bf16 on the card (``sample_dtype``
``torch.bfloat16``) and float32 on the CPU, so that the port on the CPU
equals the JAX kernel on the CPU.  The bf16 rounding contract of a sample
pass, which the CUDA kernel and ``mc_dropout_sums_plain(...,
sample_dtype=torch.bfloat16)`` share:

- every activation stored between layers is bf16, rounded to nearest even
  after tanh and after the dropout select and scale (``h·(1/(1−p))`` in
  float32, then rounded);
- the four wide products (trunk 256×256 twice, variance 256×128 and
  128×64) take bf16 operands and accumulate in float32; their weights are
  rounded to bf16 once per call;
- layer 0 (8→256) reads ``x`` and its weights in float32; the two width-1
  heads read the stored bf16 activations with float32 weights; bias adds,
  ``log_softplus`` and the per-row sums are float32, the sums in sample order.

The kernel computes a sample pass's tanh from ``ex2.approx`` and
``rcp.approx`` (an odd polynomial below |x| = 0.25), within 1.5e-6 relative
of tanh, far below the bf16 rounding that follows; the plain version keeps
``torch.tanh``, and the tolerance of the comparison covers the difference.

The plain version emulates uint32 in int64 with ``& 0xFFFFFFFF``; products
are split into 16-bit halves of the constant so no int64 product overflows.
``mc_dropout_sums`` launches the kernel for a CUDA tensor (flagship topology
only) and runs the float32 plain version only for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pinnfc_tpu_torch.models.mlp import MLP, logvar_from_raw
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.uq.mc_dropout import MCSamples, finish_mc_stats

MASK_BLOCK = 256  # rows per mask block: part of the random stream's contract
_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 ``x`` in [0, 2³²) and a constant ``c`` < 2³²:
    both partial products stay below 2⁴⁸."""
    hi, lo = c >> 16, c & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ``_wang_hash`` on uint32 values held in int64."""
    x = (x ^ 61) ^ (x >> 16)
    x = _mul32(x, 9)
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27D4EB2D)
    x = x ^ (x >> 15)
    x = _mul32(x, 2654435761)
    x = x ^ (x >> 13)
    return x


def random_bits(local_rows: torch.Tensor, width: int, salt: torch.Tensor) -> torch.Tensor:
    """(N, width) uint32 mask bits in int64: row i of the result is local mask
    row ``local_rows[i]`` of the stream keyed by ``salt[i]`` — the TPU kernel's
    ``_random_bits((256, width), salt)`` row by row."""
    cols = torch.arange(width, dtype=torch.int64, device=local_rows.device)
    ctr = local_rows[:, None] * width + cols[None, :]
    return wang_hash(ctr ^ wang_hash((salt + _GOLDEN) & _U32)[:, None])


def dropout_constants(dropout: float):
    """(thresh, inv_keep) exactly as the TPU kernel derives them."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {dropout}")
    thresh = min(int(dropout * (1 << 32)), (1 << 32) - 1)
    inv_keep = float(np.float32(1.0 / (1.0 - dropout)))
    return thresh, inv_keep


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def wide_linears(mlp: MLP):
    """The layers whose products a bf16 sample pass runs in bf16: every trunk
    layer but the first, and the first two variance layers."""
    return [*mlp.hidden[1:], mlp.var[0], mlp.var[1]]


def sample_product(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One wide product of a bf16 sample pass: ``h`` and ``weight`` (out, in)
    rounded to bf16, multiplied and accumulated in float32, plus the float32
    bias."""
    return F.linear(round_bf16(h), round_bf16(weight), bias)


def sample_pass(mlp: MLP, x: torch.Tensor, local_rows: torch.Tensor, salt: torch.Tensor,
                thresh: int, inv_keep: float, sample_dtype: torch.dtype = torch.float32):
    """One dropout pass of the plain version: (pred (N,), logvar (N,), the
    stored activations of each masked layer).  Row i uses mask row
    ``local_rows[i]`` of the streams keyed by ``salt[i] + layer``.  With
    ``sample_dtype`` bf16 it rounds what the module's contract rounds."""
    if sample_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sample_dtype must be float32 or bfloat16, got {sample_dtype}")
    bf16 = sample_dtype == torch.bfloat16
    store = round_bf16 if bf16 else (lambda t: t)
    wide = wide_linears(mlp) if bf16 else []

    def linear(h, lin):
        return sample_product(h, lin.weight, lin.bias) if lin in wide else lin(h)

    def drop(h, layer):
        bits = random_bits(local_rows, h.shape[1], (salt + layer) & _U32)
        return store(torch.where(bits >= thresh, h * inv_keep, 0.0))

    masked = []
    h = x
    for layer, lin in enumerate(mlp.hidden):
        h = drop(torch.tanh(linear(h, lin)), layer)
        masked.append(h)
    pred = mlp.mean(h)[:, 0]
    v = drop(torch.tanh(linear(h, mlp.var[0])), len(mlp.hidden))
    masked.append(v)
    v = store(torch.tanh(linear(v, mlp.var[1])))
    return pred, logvar_from_raw(mlp.var[2](v))[:, 0], masked


@torch.no_grad()
def mc_dropout_sums_plain(
    mlp: MLP, x: torch.Tensor, seed: int, mc_times: int = 2000, dropout: float = 0.4,
    sample_dtype: torch.dtype = torch.float32, block0: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version: (N, 4) [base, Σd, Σd², Σlogvar], any topology.
    The base pass is float32; the sample passes run in ``sample_dtype``
    (bf16: the kernel's rounding contract, see the module docstring).  Row r
    draws the masks of global mask block ``block0 + r // 256``."""
    thresh, inv_keep = dropout_constants(dropout)
    n = x.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=x.device)
    local = rows % MASK_BLOCK
    block_salt = (int(seed) * 7919 + (int(block0) + rows // MASK_BLOCK) * 104729) & _U32

    base = mlp(x)[0][:, 0]
    s_d = torch.zeros_like(base)
    s_d2 = torch.zeros_like(base)
    s_lv = torch.zeros_like(base)
    for s in range(mc_times):
        salt = (block_salt + (s * 15485863 & _U32)) & _U32
        pred, log_var, _ = sample_pass(mlp, x, local, salt, thresh, inv_keep, sample_dtype)
        d = pred - base
        s_d = s_d + d
        s_d2 = s_d2 + d * d
        s_lv = s_lv + log_var
    return torch.stack([base, s_d, s_d2, s_lv], dim=1)


def _check_inputs(mlp: MLP, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != mlp.layers[0]:
        raise ValueError(
            f"x must be float32 (N, {mlp.layers[0]}), got {x.dtype} {tuple(x.shape)}"
        )
    for p in mlp.parameters():
        if p.device != x.device or p.dtype != torch.float32:
            raise ValueError("MLP weights must be float32 on x's device")


def mc_dropout_sums(
    mlp: MLP, x: torch.Tensor, seed: int, mc_times: int = 2000, dropout: float = 0.4,
    block0: int = 0,
) -> torch.Tensor:
    """(N, 4) [base, Σd, Σd², Σlogvar]: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  ``block0``: the global mask block of x's
    first row (a row shard's; 0 for all rows)."""
    _check_inputs(mlp, x)
    if mc_times < 1:
        raise ValueError(f"mc_times must be >= 1, got {mc_times}")
    if not 0 <= block0 <= _U32:
        raise ValueError(f"block0 must be a uint32, got {block0}")
    if x.device.type == "cpu":
        return mc_dropout_sums_plain(mlp, x, seed, mc_times, dropout, block0=block0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not mlp.is_flagship():
        raise ValueError(
            f"the MC-dropout kernel covers the flagship topology (8, 256, 256, 256, 1) "
            f"only; this MLP is {mlp.layers}"
        )
    out = launch_kernel(build.load(), mlp, x, seed, mc_times, dropout, block0)
    build.LAUNCHES["mc_dropout"] += 1
    return out


def launch_kernel(lib, mlp: MLP, x: torch.Tensor, seed: int, mc_times: int,
                  dropout: float, block0: int = 0) -> torch.Tensor:
    """Launch ``pinnfc_mc_dropout`` of the loaded library ``lib`` on CUDA
    tensors (flagship MLP, inputs checked by the caller); returns the (N, 4)
    sums."""
    thresh, inv_keep = dropout_constants(dropout)
    x = x.contiguous()
    n = x.shape[0]
    # float32 (in, out) copies for the base pass, layer 0 and the heads; bf16
    # (in, out) copies of the four wide products for the sample passes
    weights = []
    for lin in mlp.linears():
        weights += [lin.weight.detach().t().contiguous(), lin.bias.detach().contiguous()]
    wide = [lin.weight.detach().t().to(torch.bfloat16).contiguous() for lin in wide_linears(mlp)]
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    build.launch(
        lib.pinnfc_mc_dropout, "mc_dropout", x.device,
        x.data_ptr(), n, *[w.data_ptr() for w in weights], *[w.data_ptr() for w in wide],
        out.data_ptr(), int(seed) & _U32, int(block0), int(mc_times), thresh, inv_keep,
    )
    return out


def mc_dropout(
    mlp: MLP, x: torch.Tensor, seed: int, mc_times: int = 2000, dropout: float = 0.4
) -> MCSamples:
    """Fused sampler → ``MCSamples`` (the contract of ``mc_dropout_pallas``)."""
    return finish_mc_stats(mc_dropout_sums(mlp, x, seed, mc_times, dropout), mc_times)
