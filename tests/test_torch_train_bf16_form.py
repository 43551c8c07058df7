"""CPU checks of the training kernel's bf16 form (``csrc/train_dnn.cu``:
``fwd_bwd_bf16_kernel``, ``wgrad_bf16_kernel``) that need no card.

There is no CUDA compiler here, so these hold the index and hash arithmetic
that the kernel's source writes down, emulated in numpy, against the port's
plain functions: the folded mask hash of a 64-row CTA (one key per row from
the CTA's two hashed salts) against ``keep_masks`` (the TPU kernel's masks,
bit for bit) at row offsets that put a CTA across a 512-row mask block; the
fragment order in which the forward stores the backward's factors and the
backward reads them, which must cover a layer's 64 x N tile once; and the
text edits of ``pinnfc_tpu_torch/ops/train_ablation.py``, which must still
find their text in the source.  tests/test_torch_cuda.py holds the kernel
itself against its plain version on the card.
"""

import numpy as np
import pytest

from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants
from pinnfc_tpu_torch.ops.train_ablation import ABLATIONS, STAMPS, variant_source

U32 = np.uint64(0xFFFFFFFF)
BROWS, BTHREADS, MASK_BLOCK = 64, 512, 512  # csrc/train_dnn.cu
WIDTHS = (256, 256, 256, 128)  # the flagship's masked layers


def _u32(v):
    return np.asarray(v, np.uint64) & U32


def _wang(x):
    x = _u32(x)
    x = (x ^ np.uint64(61)) ^ (x >> np.uint64(16))
    return _wang_rest(x)


def _wang_rest(x):
    x = _u32(x * np.uint64(9))
    x = x ^ (x >> np.uint64(4))
    x = _u32(x * np.uint64(0x27D4EB2D))
    x = x ^ (x >> np.uint64(15))
    x = _u32(x * np.uint64(2654435761))
    return x ^ (x >> np.uint64(13))


def _kernel_masks(n, seed, t, thresh, row_off):
    """The masks as fwd_bwd_bf16_kernel draws them: per CTA of BROWS rows the
    hashed salts of its first and second mask block, per row one key
    (mask_row_key), per element wang_rest(key ^ column)."""
    out = [np.zeros((n, w), bool) for w in WIDTHS]
    base = _u32(np.uint64(seed) * np.uint64(2654435761) + np.uint64(t) * np.uint64(40503))
    for row0 in range(0, n, BROWS):
        blk = (row0 + row_off) // MASK_BLOCK
        split = (blk + 1) * MASK_BLOCK
        for layer, width in enumerate(WIDTHS):
            hs = [_wang(_u32(base + np.uint64((blk + k) * 7919 + layer) + np.uint64(0x9E3779B9)))
                  for k in (0, 1)]
            for r in range(row0, min(row0 + BROWS, n)):
                grow = r + row_off
                h = hs[0] if grow < split else hs[1]
                lrw = np.uint64((grow % MASK_BLOCK) * width)
                key = lrw ^ (lrw >> np.uint64(16)) ^ h ^ np.uint64(61) ^ (h >> np.uint64(16))
                cols = np.arange(width, dtype=np.uint64)
                out[layer][r] = _wang_rest(key ^ cols) >= np.uint64(thresh)
    return out


@pytest.mark.parametrize("n, row_off", [(130, 0), (37, 12), (200, 480), (150, 1500)])
def test_folded_mask_hash_is_the_tpu_kernels(n, row_off):
    """Rows 480.. and 1500.. put a 64-row CTA across a mask block's end."""
    thresh, _ = dropout_constants(0.2)
    want = td.keep_masks(n, WIDTHS, 20240601, 7, thresh, "cpu", row_off)
    got = _kernel_masks(n, 20240601, 7, thresh, row_off)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert 0.7 < float(np.mean(got[0])) < 0.9


@pytest.mark.parametrize("width", [256, 128])
def test_factor_fragment_order_covers_the_tile_once(width):
    """fwd_layer16 stores thread t's factor (i, j, e) at float ((i NT + j)
    BTHREADS + t) 4 + e and bwd_layer16 reads it there; with warp (wm, wn) =
    (w / 8, w % 8), lane (g, q) = (lane / 4, lane % 4), the element is row
    32 wm + 16 i + g + 8 (e / 2), column wn N/8 + 8 j + 2 q + e % 2."""
    nt = width // 64
    index, cell = [], []
    for t in range(BTHREADS):
        warp, lane = t // 32, t % 32
        wm, wn, g, q = warp // 8, warp % 8, lane // 4, lane % 4
        for i in range(2):
            for j in range(nt):
                for e in range(4):
                    index.append(((i * nt + j) * BTHREADS + t) * 4 + e)
                    cell.append((32 * wm + 16 * i + g + 8 * (e // 2)) * width
                                + wn * width // 8 + 8 * j + 2 * q + e % 2)
    assert sorted(index) == list(range(BROWS * width))
    assert sorted(cell) == list(range(BROWS * width))


def test_ablation_edits_apply_to_the_kernel_source():
    """pinnfc_tpu_torch.ops.train_ablation edits csrc/train_dnn.cu by text:
    every variant's edits must still find their text, and change the source."""
    base = variant_source([])
    for edits in [STAMPS, *ABLATIONS.values()]:
        src = variant_source(edits)
        assert src != base
        for _, new in edits:
            assert new in src
