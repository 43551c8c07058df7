"""One-off CPU measurement of the training step's precision forms (not a
tier-1 test: pytest does not collect this file).

    python tests/_torch_precision_probe.py [--rows 6000] [--steps 20]

On the default synthetic campaign's training rows (6,000 normal and 12 x 800
fault rows, seed 42; the first ``--rows`` of them) and the flagship MLP from
``torch.Generator().manual_seed(0)``, dropout 0.2, it prints:

1. the one-step gradient (step 0, seed 20240601) of the plain version in
   several product forms, each against another, as the worst tensor's
   max|Δg| / max|g|: float32 against float64 products; bf16 operands with
   float32 against float64 accumulation (the spread a kernel's summation
   order gives, activations that round across a bf16 boundary included);
   bf16 against float32 products (the gap between the two forms);
2. ``--steps`` steps at lr 0.01 (StepLR every 5 steps, gamma 0.5, the
   settings of chip_smoke.py phase 6) of the float32 plain version against
   the same stage with 3xTF32-emulated products (each operand split into
   TF32 hi and lo with ``tf32_rna`` of tests/test_torch_tf32_split.py, a b as
   a_lo b_hi + a_hi b_lo + a_hi b_hi), with one TF32 product (a_hi b_hi:
   what a kernel that lost its lo terms would give), and against float64
   products; bf16 against float32, and bf16 operands with float32 against
   float64 accumulation: the largest |Δweight| and the share of weights that
   differ by more than 1e-3.

Everything runs on the CPU in float32 unless named otherwise.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_tf32_split import tf32_rna  # noqa: E402

from pinnfc_tpu_torch.data.combine import combine_and_normalize  # noqa: E402
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data  # noqa: E402
from pinnfc_tpu_torch.models.mlp import MLP  # noqa: E402
from pinnfc_tpu_torch.ops import train_dnn as td  # noqa: E402
from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants  # noqa: E402

SEED = 20240601


def tf32x3(a: torch.Tensor, b: torch.Tensor, _dtype=None) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32 form computes it, in float32."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tf32x1(a: torch.Tensor, b: torch.Tensor, _dtype=None) -> torch.Tensor:
    """a @ b as one TF32 product (both operands cvt.rna to TF32)."""
    return tf32_rna(a) @ tf32_rna(b)


def rel_gap(g1, g2) -> float:
    """Worst tensor's max|Δg| / max|g2|."""
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for a, b in zip(g1, g2))


def one_step(mlp, x, y, dtype, product_dtype):
    thresh, inv_keep = dropout_constants(0.2)
    keep = td.keep_masks(x.shape[0], mlp.dropout_widths(), SEED, 0, thresh, "cpu")
    ws = [w.to(dtype) for w in td.mlp_weights(mlp)]
    _, g = td.loss_and_grads(ws, x.to(dtype), y.to(dtype), keep, inv_keep,
                             td._inv_n(x.shape[0]), product_dtype)
    return g


def stage(mlp, x, y, steps, dtype=torch.float32, product_dtype=None):
    """(the flat weights after ``steps`` steps, as float64; the losses)."""
    m = copy.deepcopy(mlp).to(dtype)
    if dtype == torch.float32:
        out = td.train_dnn_stage_plain(m, x, y, SEED, steps, lr=0.01, lr_step=5, lr_gamma=0.5,
                                       dropout_p=0.2, product_dtype=product_dtype)
    else:
        out = _stage64(m, x.to(dtype), y.to(dtype), steps, product_dtype)
    return torch.cat([w.reshape(-1).double() for w in td.mlp_weights(out.mlp)]), out.losses


def _stage64(m, x, y, steps, product_dtype=None):
    """The float64 stage: check_stage_inputs wants float32, so the step loop
    runs on adam_steps directly."""
    thresh, inv_keep = dropout_constants(0.2)
    widths, n = m.dropout_widths(), x.shape[0]

    def step_grad(ws, t):
        keep = td.keep_masks(n, widths, SEED, t, thresh, "cpu")
        loss, g = td.loss_and_grads(ws, x, y, keep, inv_keep, 1.0 / n, product_dtype)
        return loss, td.flat_grad(g)

    return td.adam_steps(m, steps, step_grad, lr=0.01, lr_step=5, lr_gamma=0.5)


def weight_gap(a, b) -> str:
    d = (a - b).abs()
    share = float((d > 1e-3).double().mean())
    return f"max |Δweight| {float(d.max()):.3e}, share > 1e-3 {share:.4%}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=6000)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    ds = combine_and_normalize(normal, faults, device="cpu")
    x, y = ds.x_train[:args.rows], ds.y_train[:args.rows]
    mlp = MLP(generator=torch.Generator().manual_seed(0), device="cpu")
    bf = torch.bfloat16
    g32 = one_step(mlp, x, y, torch.float32, None)
    g64 = one_step(mlp, x, y, torch.float64, None)
    gb32 = one_step(mlp, x, y, torch.float32, bf)
    gb64 = one_step(mlp, x, y, torch.float64, bf)
    print(f"N={x.shape[0]} one-step gradient, worst tensor's max|Δg|/max|g|:")
    print(f"  float32 vs float64 products:                  {rel_gap(g32, g64):.3e}")
    print(f"  bf16 operands, float32 vs float64 accumulation: {rel_gap(gb32, gb64):.3e}")
    print(f"  bf16 vs float32 products:                     {rel_gap(gb32, g32):.3e}")
    if args.steps > 0:
        w32, l32 = stage(mlp, x, y, args.steps)
        w64, _ = stage(mlp, x, y, args.steps, torch.float64)
        with mock.patch.object(td, "rounded_matmul", tf32x3):
            w3x, l3x = stage(mlp, x, y, args.steps)
        with mock.patch.object(td, "rounded_matmul", tf32x1):
            w1x, l1x = stage(mlp, x, y, args.steps)
        wbf, lbf = stage(mlp, x, y, args.steps, product_dtype=bf)
        wbf64, _ = stage(mlp, x, y, args.steps, torch.float64, product_dtype=bf)
        print(f"N={x.shape[0]}, {args.steps} steps at lr 0.01:")
        print(f"  3xTF32-emulated vs float32: {weight_gap(w3x, w32)}, "
              f"max |Δloss| {float((l3x - l32).abs().max()):.3e}")
        print(f"  1xTF32-emulated vs float32: {weight_gap(w1x, w32)}, "
              f"max |Δloss| {float((l1x - l32).abs().max()):.3e}")
        print(f"  float32 vs float64:         {weight_gap(w32, w64)}")
        print(f"  bf16, float32 vs float64 accumulation: {weight_gap(wbf, wbf64)}")
        print(f"  bf16 vs float32:            {weight_gap(wbf, w32)}, "
              f"loss traces {[round(float(v), 4) for v in lbf]} against "
              f"{[round(float(v), 4) for v in l32]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
