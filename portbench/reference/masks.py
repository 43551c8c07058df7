"""The counter-based random stream of the port's dropout masks, in plain torch.

uint32 arithmetic is held in int64 and wrapped with ``& 0xFFFFFFFF``; each
product by a constant is split into its 16-bit halves so that no int64
product overflows.

Element (r, c) of dropout layer l (width W) is kept iff
``wang(local·W + c ^ wang(salt + l + 0x9E3779B9)) >= thresh``, where
``local = r % B`` and the salt depends on the row's block ``r // B``:

- MC dropout (B = 256): ``salt = seed·7919 + block·104729 + s·15485863`` for
  sample pass s;
- training (B = 512): ``salt = seed·2654435761 + t·40503 + block·7919`` for
  step t inside the stage.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
MC_BLOCK = 256
TRAIN_BLOCK = 512


def dropout_constants(p: float) -> Tuple[int, float]:
    """(thresh, inv_keep): a uint32 draw at or above ``thresh`` keeps its
    element, which is then scaled by ``inv_keep`` = float32(1 / (1 − p))."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {p}")
    return min(int(p * (1 << 32)), U32), float(np.float32(1.0 / (1.0 - p)))


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    hi, lo = c >> 16, c & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & U32


def wang(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's 32-bit integer hash."""
    x = (x ^ 61) ^ (x >> 16)
    x = _mul(x, 9)
    x = x ^ (x >> 4)
    x = _mul(x, 0x27D4EB2D)
    x = x ^ (x >> 15)
    x = _mul(x, 2654435761)
    return x ^ (x >> 13)


def keep(local: torch.Tensor, width: int, salt: torch.Tensor, thresh: int) -> torch.Tensor:
    """Bool keep mask (..., rows, width): ``local`` (rows,) the rows' places in
    their mask blocks, ``salt`` (..., rows) each row's salt of this layer."""
    cols = torch.arange(width, dtype=torch.int64, device=local.device)
    ctr = local[:, None] * width + cols[None, :]
    key = wang((salt + GOLDEN) & U32)
    return wang(ctr ^ key[..., None]) >= thresh


def mc_salts(rows: torch.Tensor, seed: int, passes: torch.Tensor) -> torch.Tensor:
    """(passes, rows) layer-0 salts of MC sample passes ``passes`` for global
    rows ``rows``."""
    block = (int(seed) * 7919 + (rows // MC_BLOCK) * 104729) & U32
    return (block[None, :] + ((passes * 15485863) & U32)[:, None]) & U32


def train_salts(rows: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    """(rows,) layer-0 salts of training step ``t`` for global rows ``rows``."""
    base = (int(seed) * 2654435761 + int(t) * 40503) & U32
    return (base + (rows // TRAIN_BLOCK) * 7919) & U32


def stage_seed(seed: int, k: int) -> int:
    """The dropout seed of the DNN stage at schedule index ``k`` of a training
    run with seed ``seed``: the first ``randint(0, 2**31 - 1)`` of
    ``RandomState([seed, k])``."""
    return int(np.random.RandomState([int(seed), int(k)]).randint(0, 2**31 - 1))
