"""Whole DNN training stage: the CUDA kernel ``csrc/train_dnn.cu`` and its plain
PyTorch version (counterpart of ``pinnfc_tpu/ops/pallas_train.py``).

Both run ``n_iter`` full-batch steps of the TPU kernel's stage: hash-masked
dropout forward, the heteroscedastic loss ``0.5·e·r² + 0.5·lv + 0.01·|lv|``
(``lv = log(softplus(q3) + 1e-6)``, ``e = exp(−lv)``), the hand-derived
backward of ``pallas_train.py:141-172``, and Adam with the StepLR staircase
(``training/adam.py``).  The per-step loss is taken before that step's update.

Dropout masks are the TPU kernel's, bit for bit: global row r lies in mask
block ``r // 512`` at local row ``r % 512``, and element (lr, c) of layer l
(width W; l = 0..L−1 the hidden layers, L the first variance layer) is kept
iff ``wang(lr·W + c ^ wang(salt + 0x9E3779B9)) >= thresh`` with
``salt = seed·2654435761 + t·40503 + blk·7919 + l`` in wrapping uint32, t the
step index inside the stage.  Rows past N take no part: the mean divides by
the true N.  (``train_dnn_pallas`` refuses a ragged N; when N % 512 == 0 the
objective is exactly its own.)

With ``skip_nonfinite`` a step whose loss or any gradient element is not
finite leaves the weights, both Adam moments and the Adam count as they were;
its loss is still recorded and the masks still advance with t.

A stage can run in chunks: a call with start step ``t0`` and the carried Adam
state (moments and count) draws the masks of steps t0, t0 + 1, … and continues
the StepLR staircase and the bias correction from the carried count, so the
chunks of a stage walk the trajectory of the whole stage.

``train_dnn`` launches the kernel for CUDA tensors (flagship topology only)
and runs the plain version only for CPU tensors.
"""

from __future__ import annotations

import copy
import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.models.mlp import MLP, softplus
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops.mc_dropout import _GOLDEN, _U32, dropout_constants, wang_hash
from pinnfc_tpu_torch.training.adam import (
    AdamState, adam_init, adam_step, all_finite, keep_if_nonfinite)

MASK_BLOCK = 512  # rows per mask block: part of the random stream's contract
REG_WEIGHT = 0.01  # |logvar| regularizer of the loss (01:916-927)


def step_salts(n: int, seed: int, t: int, device) -> torch.Tensor:
    """(n,) int64: the salt of layer 0 for every row at step ``t`` (add l for
    layer l)."""
    rows = torch.arange(n, dtype=torch.int64, device=device)
    base = (int(seed) * 2654435761 + int(t) * 40503) & _U32
    return (base + (rows // MASK_BLOCK) * 7919) & _U32


@functools.lru_cache(maxsize=16)
def _mask_columns(widths: Tuple[int, ...], device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(layer, layer width, column inside the layer) of every column of the
    dropout layers' masks laid side by side, int64 on ``device``: made once per
    topology and device, so a step copies nothing from the host."""
    cols = [np.repeat(np.arange(len(widths)), widths), np.repeat(widths, widths),
            np.concatenate([np.arange(w) for w in widths])]
    return tuple(torch.as_tensor(c.astype(np.int64), device=device) for c in cols)


def keep_masks(n: int, widths: Sequence[int], seed: int, t: int, thresh: int,
               device) -> List[torch.Tensor]:
    """Bool keep masks, (n, width) per dropout layer, for step ``t``: layer l's
    mask is ``random_bits(local, width_l, salt + l) >= thresh``, computed for
    all layers in one pass over their columns side by side (one row key per
    row and layer, then one hash per element)."""
    widths = tuple(int(w) for w in widths)
    device = torch.device(device)
    layer, width, col = _mask_columns(widths, device)
    local = torch.arange(n, dtype=torch.int64, device=device) % MASK_BLOCK
    salt = step_salts(n, seed, t, device)
    layers = torch.arange(len(widths), dtype=torch.int64, device=device)
    row_keys = wang_hash((salt[:, None] + layers[None, :] + _GOLDEN) & _U32)
    ctr = local[:, None] * width[None, :] + col[None, :]
    keep = wang_hash(ctr ^ row_keys[:, layer]) >= thresh
    return list(torch.split(keep, widths, dim=1))


def mlp_weights(mlp: MLP) -> List[torch.Tensor]:
    """The 2·(L+4) tensors in the JAX package's order and layout: per Linear
    ``w`` (in, out), then ``b`` (out,); hidden trunk, mean head, variance head."""
    out = []
    for lin in mlp.linears():
        out += [lin.weight.detach().t().contiguous(), lin.bias.detach().clone()]
    return out


def mlp_with_weights(mlp: MLP, ws: Sequence[torch.Tensor]) -> MLP:
    """A copy of ``mlp`` carrying the (JAX-layout) weights ``ws``."""
    new = copy.deepcopy(mlp)
    with torch.no_grad():
        for lin, w, b in zip(new.linears(), ws[0::2], ws[1::2]):
            lin.weight.copy_(w.t())
            lin.bias.copy_(b)
    return new


def loss_and_grads(ws: Sequence[torch.Tensor], x: torch.Tensor, y: torch.Tensor,
                   keep: Optional[Sequence[torch.Tensor]], inv_keep: float,
                   inv_n: float) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One step's mean loss and the gradient of every tensor of ``ws``, with the
    hand-derived backward of the TPU kernel (``pallas_train.py:111-172``), for
    any number of hidden layers.  ``keep`` is the list of keep masks (hidden
    layers, then the first variance layer); None means no dropout."""
    n_hidden = len(ws) // 2 - 4
    hidden = [(ws[2 * i], ws[2 * i + 1]) for i in range(n_hidden)]
    h0 = 2 * n_hidden
    wm, bm, v1, c1, v2, c2, v3, c3 = ws[h0:h0 + 8]

    def drop(h, layer):
        return h if keep is None else torch.where(keep[layer], h * inv_keep, 0.0)

    hs, hds, inp = [], [], x
    for i, (w, b) in enumerate(hidden):
        h = torch.tanh(inp @ w + b)
        hs.append(h)
        inp = drop(h, i)
        hds.append(inp)
    pred = inp @ wm + bm
    q1 = inp @ v1 + c1
    t1 = torch.tanh(q1)
    t1d = drop(t1, n_hidden)
    t2 = torch.tanh(t1d @ v2 + c2)
    q3 = t2 @ v3 + c3
    sp = softplus(q3)
    lv = torch.log(sp + 1e-6)
    r = y - pred
    e = torch.exp(-lv)
    loss = torch.sum(0.5 * e * r * r + 0.5 * lv + REG_WEIGHT * torch.abs(lv)) * inv_n

    g: List[torch.Tensor] = [None] * len(ws)  # type: ignore[list-item]
    dpred = (-e * r) * inv_n
    dlv = (0.5 * (1.0 - e * r * r) + REG_WEIGHT * torch.sign(lv)) * inv_n
    dq3 = dlv * torch.sigmoid(q3) / (sp + 1e-6)
    g[h0 + 6], g[h0 + 7] = t2.T @ dq3, dq3.sum(0)
    dq2 = (dq3 @ v3.T) * (1.0 - t2 * t2)
    g[h0 + 4], g[h0 + 5] = t1d.T @ dq2, dq2.sum(0)
    dq1 = drop(dq2 @ v2.T, n_hidden) * (1.0 - t1 * t1)
    g[h0 + 2], g[h0 + 3] = inp.T @ dq1, dq1.sum(0)
    g[h0], g[h0 + 1] = inp.T @ dpred, dpred.sum(0)
    dh = dpred @ wm.T + dq1 @ v1.T
    for i in reversed(range(n_hidden)):
        da = drop(dh, i) * (1.0 - hs[i] * hs[i])
        a_in = hds[i - 1] if i > 0 else x
        g[2 * i], g[2 * i + 1] = a_in.T @ da, da.sum(0)
        if i > 0:
            dh = da @ hidden[i][0].T
    return loss, g


class DnnStageOut(NamedTuple):
    mlp: MLP  # trained copy of the input MLP
    losses: torch.Tensor  # per-step losses (n_iter,)
    state: AdamState  # Adam state after the last step, over flat_weights' layout


def flat_weights(mlp: MLP) -> torch.Tensor:
    """The flat float32 vector the Adam state runs over: ``mlp_weights(mlp)``
    flattened and concatenated (w (in, out) row-major, then b, per Linear)."""
    return torch.cat([w.reshape(-1) for w in mlp_weights(mlp)])


def unflat_weights(flat: torch.Tensor, mlp: MLP) -> List[torch.Tensor]:
    """Inverse of ``flat_weights``: the tensors of ``mlp_weights`` as views of
    ``flat``."""
    shapes = [s for lin in mlp.linears()
              for s in ((lin.in_features, lin.out_features), (lin.out_features,))]
    sizes = [int(np.prod(s)) for s in shapes]
    return [v.view(s) for v, s in zip(torch.split(flat, sizes), shapes)]


def check_stage_inputs(mlp: MLP, x: torch.Tensor, y: torch.Tensor, n_iter: int, t0: int,
                       state: Optional[AdamState]) -> None:
    """Validate a stage call: x, y and the weights float32 on one device, the
    step counts, and a carried Adam state over ``flat_weights``' layout."""
    n = x.shape[0] if x.dim() == 2 else -1
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != mlp.layers[0] or n < 1:
        raise ValueError(f"x must be float32 (N, {mlp.layers[0]}) with N >= 1, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if y.dtype != torch.float32 or tuple(y.shape) != (n, 1) or y.device != x.device:
        raise ValueError(f"y must be float32 ({n}, 1) on x's device, got {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}")
    for p in mlp.parameters():
        if p.device != x.device or p.dtype != torch.float32:
            raise ValueError("MLP weights must be float32 on x's device")
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if t0 < 0:
        raise ValueError(f"t0 must be >= 0, got {t0}")
    if state is not None:
        size = sum(p.numel() for p in mlp.parameters())
        for name in ("m", "v"):
            t = getattr(state, name)
            if t.dtype != torch.float32 or tuple(t.shape) != (size,) or t.device != x.device:
                raise ValueError(f"state.{name} must be float32 ({size},) on x's device, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if state.count.numel() != 1 or state.count.device != x.device:
            raise ValueError("state.count must be one integer on x's device")


def _inv_n(n: int) -> float:
    return float(np.float32(1.0 / n))


# (weights of ``unflat_weights``, keep masks or None) -> (loss, gradients)
GradFn = Callable[[List[torch.Tensor], Optional[List[torch.Tensor]]],
                  Tuple[torch.Tensor, Sequence[torch.Tensor]]]


@torch.no_grad()
def stage_steps(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, grad_fn: GradFn,
    lr: float = 0.01, lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage, step by step, any
    topology, on x's device: per step the hash masks of step t
    (``keep_masks``), the loss and gradients from ``grad_fn``, and Adam +
    StepLR over the flat layout of ``flat_weights`` from the carried ``state``
    (fresh when None); with ``skip_nonfinite`` a step with a non-finite loss
    or gradient keeps the weights and the state.  The loss is taken before its
    step's update.  The one step loop of the plain version and of the
    autograd stage, so a stage run in chunks takes the steps of the whole
    stage, bit for bit, on either."""
    check_stage_inputs(mlp, x, y, n_iter, t0, state)
    thresh, _ = dropout_constants(dropout_p)
    n, widths = x.shape[0], mlp.dropout_widths()
    flat = flat_weights(mlp)
    state = adam_init(flat) if state is None else state._replace(
        count=state.count.reshape(()).to(torch.int64))
    losses = []
    for t in range(t0, t0 + n_iter):
        keep = keep_masks(n, widths, seed, t, thresh, x.device) if thresh > 0 else None
        loss, grads = grad_fn(unflat_weights(flat, mlp), keep)
        g = torch.cat([gi.reshape(-1) for gi in grads])
        new = adam_step(flat, g, state, lr, lr_step, lr_gamma)
        if skip_nonfinite:
            new = keep_if_nonfinite(all_finite(loss, g), new, (flat, state))
        flat, state = new
        losses.append(loss)
    return DnnStageOut(mlp_with_weights(mlp, unflat_weights(flat, mlp)), torch.stack(losses), state)


def train_dnn_stage_plain(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
) -> DnnStageOut:
    """Plain PyTorch version, step by step, any topology: steps t0 .. t0 +
    n_iter − 1 of a stage (the masks of step t0 + t), from the carried Adam
    ``state`` (fresh when None), with the kernel's hand-derived gradients
    (``loss_and_grads``)."""
    _, inv_keep = dropout_constants(dropout_p)
    inv_n = _inv_n(x.shape[0])

    def grad_fn(ws, keep):
        return loss_and_grads(ws, x, y, keep, inv_keep, inv_n)

    return stage_steps(mlp, x, y, seed, n_iter, grad_fn, lr, lr_step, lr_gamma, dropout_p,
                       skip_nonfinite, t0, state)


def _kernel_layout(flat: torch.Tensor, ws: Sequence[torch.Tensor], offsets: Sequence[int],
                   total: int) -> torch.Tensor:
    """``flat`` (flat_weights' layout) → the kernel's buffer: tensor block i at
    ``offsets[i]``, its w then its b; the gaps between blocks stay zero."""
    out = torch.zeros(total, dtype=torch.float32, device=flat.device)
    src = 0
    for off, w, b in zip(offsets, ws[0::2], ws[1::2]):
        size = w.numel() + b.numel()
        out[off:off + size] = flat[src:src + size]
        src += size
    return out


def _flat_layout(buf: torch.Tensor, ws: Sequence[torch.Tensor],
                 offsets: Sequence[int]) -> torch.Tensor:
    """Inverse of ``_kernel_layout``."""
    return torch.cat([buf[off:off + w.numel() + b.numel()]
                      for off, w, b in zip(offsets, ws[0::2], ws[1::2])])


def train_dnn(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage from the carried Adam
    ``state`` (fresh when None): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  ``seed`` is a uint32.  Returns the trained copy
    of ``mlp``, the per-step losses and the Adam state after the last step."""
    check_stage_inputs(mlp, x, y, n_iter, t0, state)
    if x.device.type == "cpu":
        return train_dnn_stage_plain(mlp, x, y, seed, n_iter, lr, lr_step, lr_gamma,
                                     dropout_p, skip_nonfinite, t0, state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not mlp.is_flagship():
        raise ValueError(
            f"the training kernel covers the flagship topology (8, 256, 256, 256, 1) "
            f"only; this MLP is {mlp.layers}"
        )
    thresh, inv_keep = dropout_constants(dropout_p)
    x, y = x.contiguous(), y.contiguous()
    n, dev = x.shape[0], x.device
    lib = build.load()
    layout = (ctypes.c_int * 8)()
    lib.pinnfc_train_dnn_layout(layout)
    offsets, total = list(layout)[:7], layout[7]
    ws = mlp_weights(mlp)
    params = _kernel_layout(flat_weights(mlp), ws, offsets, total)
    if state is None:
        m = torch.zeros_like(params)
        v = torch.zeros_like(params)
    else:
        m = _kernel_layout(state.m, ws, offsets, total)
        v = _kernel_layout(state.v, ws, offsets, total)
    work = torch.empty(int(lib.pinnfc_train_dnn_workspace_floats(n)), dtype=torch.float32,
                       device=dev)
    # the step flags, then the Adam count before each step: counts[0] =
    # ints[n_iter] is the carried count, counts[n_iter] = ints[2 n_iter] the last
    ints = torch.zeros(2 * n_iter + 1, dtype=torch.int32, device=dev)
    if state is not None:
        ints[n_iter:n_iter + 1].copy_(state.count.reshape(1))
    losses = torch.empty(n_iter, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.pinnfc_train_dnn(
        x.data_ptr(), y.data_ptr(), n, params.data_ptr(), m.data_ptr(), v.data_ptr(),
        work.data_ptr(), ints.data_ptr(), losses.data_ptr(), int(seed) & _U32, int(t0),
        int(n_iter), float(lr), int(lr_step), float(lr_gamma), thresh, inv_keep, _inv_n(n),
        int(bool(skip_nonfinite)), stream,
    )
    build.check(status, "train_dnn")
    build.LAUNCHES["train_dnn"] += 1
    new_state = AdamState(_flat_layout(m, ws, offsets), _flat_layout(v, ws, offsets),
                          ints[2 * n_iter].to(torch.int64))
    trained = unflat_weights(_flat_layout(params, ws, offsets), mlp)
    return DnnStageOut(mlp_with_weights(mlp, trained), losses, new_state)
