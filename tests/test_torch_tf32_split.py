"""The precision contract of the training kernel (csrc/train_dnn.cu), on the CPU.

The kernel runs every product of a training step on the tensor cores in
3xTF32: each float32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi) with ``cvt.rna.tf32.f32`` (round to nearest, ties away from
zero, to TF32's 10 mantissa bits), and a b is accumulated in float32 as
a_lo b_hi + a_hi b_lo + a_hi b_hi.  This file holds a plain-PyTorch emulation
of that rounding on the float32 bit pattern, checks it on hand-made patterns,
and shows at the kernel's shapes why "highest" needs the three products: the
3xTF32 product stays within float32-product error of a float64 reference,
where the single TF32 product does not.

Tolerances, as a share of the magnitude sum |A| |B| of each output element:
3xTF32 and the float32 product within 2^-20 (the float32 unit roundoff 2^-24
grown over the sum; the split itself leaves 2^-22 of each operand); a single
TF32 product is about 2^-11 off, and is held above 2^-14 to show it fails."""

import numpy as np
import pytest
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 ``x``: keep 10 mantissa bits, rounding the
    13 dropped bits half away from zero on the magnitude; inf and NaN pass
    through; a value that rounds past the largest finite TF32 becomes inf."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    special = (bits & 0x7F800000) == 0x7F800000
    rounded = (bits + 0x1000) & 0xFFFFE000
    out = torch.where(special, bits, rounded)
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32).view(torch.float32)


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([bits - 2**32 if bits >= 2**31 else bits],
                        dtype=torch.int32).view(torch.float32)


def _bits(x: torch.Tensor) -> int:
    return int(x.view(torch.int32).item()) & 0xFFFFFFFF


@pytest.mark.parametrize("given,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is TF32 already
    (0x3F800FFF, 0x3F800000),  # just below half a TF32 ulp: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero
    (0x3F801001, 0x3F802000),  # just above the tie: up
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero, so more negative
    (0xBF800FFF, 0xBF800000),  # a negative value just below the tie
    (0x3FFFF000, 0x40000000),  # the carry runs into the exponent: 2.0
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x00000FFF, 0x00000000),  # the smallest subnormals round to +0
    (0x80001000, 0x80002000),  # a negative subnormal tie
    (0x7F7FF000, 0x7F800000),  # past the largest finite TF32: +inf
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
])
def test_tf32_rounding_on_hand_made_bit_patterns(given, want):
    assert _bits(tf32_rna(_f32(given))) == want


@pytest.mark.parametrize("nan", [0x7FC00000, 0x7FFFFFFF, 0xFFC00001, 0x7F800001])
def test_tf32_rounding_keeps_a_nan_a_nan(nan):
    """The canonical NaN 0x7FFFFFFF would carry into the sign bit and become
    -0.0 under a bare add-and-mask: the rounding must leave NaN alone, and so
    must the split, or a NaN row would no longer reach the kernel's flag."""
    x = _f32(nan)
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    assert torch.isnan(hi).all() and torch.isnan(lo).all()


def test_tf32_split_is_exact_to_22_bits():
    """hi + lo recovers x to within 2^-22 of |x| (lo is itself rounded), and
    both parts are TF32 values (their 13 low mantissa bits are zero)."""
    x = torch.as_tensor(np.random.RandomState(3).standard_normal(4096).astype(np.float32))
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    for part in (hi, lo):
        assert int(((part.view(torch.int32) & 0x1FFF) != 0).sum()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0**-22).all())


def _products(a: np.ndarray, b: np.ndarray):
    """(float64 reference, |a| |b|, float32, 3xTF32, 1xTF32) products."""
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    a_hi, b_hi = tf32_rna(at), tf32_rna(bt)
    a_lo, b_lo = tf32_rna(at - a_hi), tf32_rna(bt - b_hi)
    three = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi  # the small terms first
    ref = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    return ref, mag, (at @ bt).numpy(), three.numpy(), (a_hi @ b_hi).numpy()


@pytest.mark.parametrize("shape", ["forward", "weight_gradient"])
def test_three_tf32_products_keep_float32_accuracy(shape):
    """Forward: activations (32 x 256) times a weight (256 x 256).  Weight
    gradient: an activation block transposed (256 x R) times the deltas
    (R x 256) over R = 64 rows."""
    rs = np.random.RandomState(11 if shape == "forward" else 12)
    if shape == "forward":
        a = np.tanh(rs.standard_normal((32, 256))).astype(np.float32)
        b = (rs.standard_normal((256, 256)) * 0.06).astype(np.float32)
    else:
        a = np.tanh(rs.standard_normal((64, 256))).T.astype(np.float32)
        b = (rs.standard_normal((64, 256)) * 1e-3).astype(np.float32)
    ref, mag, f32, three, one = _products(a, b)
    rel = {name: float(np.max(np.abs(v.astype(np.float64) - ref) / mag))
           for name, v in (("float32", f32), ("3xTF32", three), ("1xTF32", one))}
    assert rel["float32"] <= 2.0**-20, rel
    assert rel["3xTF32"] <= 2.0**-20, rel
    assert rel["1xTF32"] > 2.0**-14, rel
