"""Operands rounded to a precision below float32, held in float32.

``PRECISIONS`` maps a precision's name to its rounding (None: float32 as it
is).  A product in precision q takes both operands rounded to q and
accumulates in float32.  The names are those of the configurations' files.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """bf16, nearest even."""
    return t.to(torch.bfloat16).to(torch.float32)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """TF32 (10 explicit mantissa bits), nearest even, by integer arithmetic on
    the float32 bits (finite values)."""
    bits = t.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn with one scale per tensor, its largest magnitude mapped to
    448, as an fp8 product scales its operands."""
    amax = t.abs().amax()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


PRECISIONS = {"float32": None, "tf32": round_tf32, "bfloat16": round_bf16,
              "fp8": round_fp8}

# the step below each stated precision: the control of a configuration
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}


def rounding(name: str) -> Rounding:
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; known: {sorted(PRECISIONS)}")
    return PRECISIONS[name]
