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

A stage can also run data-parallel over row shards (``train_dnn_sharded``):
per step, each shard's gradient and loss terms of the whole mean (its rows'
masks by global row, divided by the rows of all shards), their sum in shard
order (``parallel/mesh.py::all_sum``), then one Adam step.  On CUDA tensors
that is one ``pinnfc_train_dnn_grad`` launch per shard and one
``pinnfc_train_dnn_adam``; on CPU tensors ``loss_and_grads`` per shard.

Precision.  ``precision='highest'`` is the TPU kernel's ``Precision.HIGHEST``
(the kernel's 3xTF32 form, float32-accurate products); ``'default'`` its
``mxu_prec = None``, one bf16 MXU pass per product on a TPU and float32 on a
CPU.  The port does the same: on a CUDA tensor ``'default'`` launches the
kernel's bf16 form, and on a CPU tensor either precision runs the plain
version in float32, so that the port on the CPU equals the JAX kernel on the
CPU.  The bf16 rounding contract, which the kernel's bf16 form and the plain
version with ``product_dtype=torch.bfloat16`` share: every product of a step
(the forward's, the width-1 heads' included; the data gradients ``d Wᵀ``;
the weight gradients ``Aᵀ D``) takes operands rounded to bf16 (nearest even)
and accumulates in float32; a masked activation is rounded as the value
``h·(1/(1−p))`` that the next product reads; bias adds, bias-gradient sums,
tanh, softplus, the loss, the masks, Adam and the weights stay float32.

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

from pinnfc_tpu_torch.models.mlp import MLP, rounded_matmul, softplus
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops.mc_dropout import _GOLDEN, _U32, dropout_constants, wang_hash
from pinnfc_tpu_torch.training.adam import (
    AdamState, adam_init, adam_step, all_finite, keep_if_nonfinite)
from pinnfc_tpu_torch.utils.observability import span

MASK_BLOCK = 512  # rows per mask block: part of the random stream's contract
REG_WEIGHT = 0.01  # |logvar| regularizer of the loss (01:916-927)
PRECISIONS = ("highest", "default")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def precision_dtype(precision: str, device) -> Optional[torch.dtype]:
    """The dtype a DNN stage rounds its products' operands to: bf16 for
    ``'default'`` on a CUDA device (a TPU's one bf16 MXU pass), None (float32)
    for ``'highest'`` and for any precision on the CPU (as JAX computes
    ``precision=None`` there)."""
    check_precision(precision)
    return torch.bfloat16 if precision == "default" and torch.device(device).type == "cuda" \
        else None


def step_salts(n: int, seed: int, t: int, device, row0: int = 0) -> torch.Tensor:
    """(n,) int64: the salt of layer 0 for global rows row0 .. row0 + n − 1 at
    step ``t`` (add l for layer l)."""
    rows = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)
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
               device, row0: int = 0) -> List[torch.Tensor]:
    """Bool keep masks, (n, width) per dropout layer, for step ``t`` and global
    rows row0 .. row0 + n − 1: layer l's mask is ``random_bits(local, width_l,
    salt + l) >= thresh``, computed for all layers in one pass over their
    columns side by side (one row key per row and layer, then one hash per
    element)."""
    widths = tuple(int(w) for w in widths)
    device = torch.device(device)
    layer, width, col = _mask_columns(widths, device)
    local = torch.arange(row0, row0 + n, dtype=torch.int64, device=device) % MASK_BLOCK
    salt = step_salts(n, seed, t, device, row0)
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
                   inv_n: float, product_dtype: Optional[torch.dtype] = None,
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One step's mean loss and the gradient of every tensor of ``ws``, with the
    hand-derived backward of the TPU kernel (``pallas_train.py:111-172``), for
    any number of hidden layers.  ``keep`` is the list of keep masks (hidden
    layers, then the first variance layer); None means no dropout.  With
    ``product_dtype`` every product rounds its operands to it (the module's
    bf16 contract) and accumulates in the inputs' dtype."""

    def mm(a, b):
        return rounded_matmul(a, b, product_dtype)

    n_hidden = len(ws) // 2 - 4
    hidden = [(ws[2 * i], ws[2 * i + 1]) for i in range(n_hidden)]
    h0 = 2 * n_hidden
    wm, bm, v1, c1, v2, c2, v3, c3 = ws[h0:h0 + 8]

    def drop(h, layer):
        return h if keep is None else torch.where(keep[layer], h * inv_keep, 0.0)

    hs, hds, inp = [], [], x
    for i, (w, b) in enumerate(hidden):
        h = torch.tanh(mm(inp, w) + b)
        hs.append(h)
        inp = drop(h, i)
        hds.append(inp)
    pred = mm(inp, wm) + bm
    q1 = mm(inp, v1) + c1
    t1 = torch.tanh(q1)
    t1d = drop(t1, n_hidden)
    t2 = torch.tanh(mm(t1d, v2) + c2)
    q3 = mm(t2, v3) + c3
    sp = softplus(q3)
    lv = torch.log(sp + 1e-6)
    r = y - pred
    e = torch.exp(-lv)
    loss = torch.sum(0.5 * e * r * r + 0.5 * lv + REG_WEIGHT * torch.abs(lv)) * inv_n

    g: List[torch.Tensor] = [None] * len(ws)  # type: ignore[list-item]
    dpred = (-e * r) * inv_n
    dlv = (0.5 * (1.0 - e * r * r) + REG_WEIGHT * torch.sign(lv)) * inv_n
    dq3 = dlv * torch.sigmoid(q3) / (sp + 1e-6)
    g[h0 + 6], g[h0 + 7] = mm(t2.T, dq3), dq3.sum(0)
    dq2 = mm(dq3, v3.T) * (1.0 - t2 * t2)
    g[h0 + 4], g[h0 + 5] = mm(t1d.T, dq2), dq2.sum(0)
    dq1 = drop(mm(dq2, v2.T), n_hidden) * (1.0 - t1 * t1)
    g[h0 + 2], g[h0 + 3] = mm(inp.T, dq1), dq1.sum(0)
    g[h0], g[h0 + 1] = mm(inp.T, dpred), dpred.sum(0)
    dh = mm(dpred, wm.T) + mm(dq1, v1.T)
    for i in reversed(range(n_hidden)):
        da = drop(dh, i) * (1.0 - hs[i] * hs[i])
        a_in = hds[i - 1] if i > 0 else x
        g[2 * i], g[2 * i + 1] = mm(a_in.T, da), da.sum(0)
        if i > 0:
            dh = mm(da, hidden[i][0].T)
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


def _check_rows(mlp: MLP, x: torch.Tensor, y: torch.Tensor) -> None:
    n = x.shape[0] if x.dim() == 2 else -1
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != mlp.layers[0] or n < 1:
        raise ValueError(f"x must be float32 (N, {mlp.layers[0]}) with N >= 1, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if y.dtype != torch.float32 or tuple(y.shape) != (n, 1) or y.device != x.device:
        raise ValueError(f"y must be float32 ({n}, 1) on x's device, got {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}")


def check_stage_inputs(mlp: MLP, x: torch.Tensor, y: torch.Tensor, n_iter: int, t0: int,
                       state: Optional[AdamState]) -> None:
    """Validate a stage call: x, y and the weights float32 on one device, the
    step counts, and a carried Adam state over ``flat_weights``' layout."""
    _check_rows(mlp, x, y)
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
# (weights of ``unflat_weights``, step index t) -> (loss, flat gradient)
StepGradFn = Callable[[List[torch.Tensor], int], Tuple[torch.Tensor, torch.Tensor]]


def flat_grad(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([gi.reshape(-1) for gi in grads])


@torch.no_grad()
def adam_steps(
    mlp: MLP, n_iter: int, step_grad: StepGradFn, lr: float = 0.01, lr_step: int = 1000,
    lr_gamma: float = 0.8, skip_nonfinite: bool = False, t0: int = 0,
    state: Optional[AdamState] = None,
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage on the MLP's device: per
    step the loss and flat gradient of ``step_grad``, and Adam + StepLR over
    the flat layout of ``flat_weights`` from the carried ``state`` (fresh when
    None); with ``skip_nonfinite`` a step with a non-finite loss or gradient
    keeps the weights and the state.  The loss is taken before its step's
    update."""
    flat = flat_weights(mlp)
    state = adam_init(flat) if state is None else state._replace(
        count=state.count.reshape(()).to(torch.int64))
    losses = []
    for t in range(t0, t0 + n_iter):
        loss, g = step_grad(unflat_weights(flat, mlp), t)
        new = adam_step(flat, g, state, lr, lr_step, lr_gamma)
        if skip_nonfinite:
            new = keep_if_nonfinite(all_finite(loss, g), new, (flat, state))
        flat, state = new
        losses.append(loss)
    return DnnStageOut(mlp_with_weights(mlp, unflat_weights(flat, mlp)), torch.stack(losses), state)


def stage_steps(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, grad_fn: GradFn,
    lr: float = 0.01, lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage, step by step, any
    topology, on x's device: per step the hash masks of step t
    (``keep_masks``), the loss and gradients from ``grad_fn``, and the Adam
    loop of ``adam_steps``.  The one step loop of the plain version and of the
    autograd stage, so a stage run in chunks takes the steps of the whole
    stage, bit for bit, on either."""
    check_stage_inputs(mlp, x, y, n_iter, t0, state)
    thresh, _ = dropout_constants(dropout_p)
    n, widths = x.shape[0], mlp.dropout_widths()

    def step_grad(ws, t):
        keep = keep_masks(n, widths, seed, t, thresh, x.device) if thresh > 0 else None
        loss, grads = grad_fn(ws, keep)
        return loss, flat_grad(grads)

    return adam_steps(mlp, n_iter, step_grad, lr, lr_step, lr_gamma, skip_nonfinite, t0, state)


def train_dnn_stage_plain(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
    product_dtype: Optional[torch.dtype] = None,
) -> DnnStageOut:
    """Plain PyTorch version, step by step, any topology: steps t0 .. t0 +
    n_iter − 1 of a stage (the masks of step t0 + t), from the carried Adam
    ``state`` (fresh when None), with the kernel's hand-derived gradients
    (``loss_and_grads``); ``product_dtype=torch.bfloat16`` is the kernel's
    bf16 form, None its float32-accurate one."""
    _, inv_keep = dropout_constants(dropout_p)
    inv_n = _inv_n(x.shape[0])

    def grad_fn(ws, keep):
        return loss_and_grads(ws, x, y, keep, inv_keep, inv_n, product_dtype)

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


def _layout(lib) -> Tuple[List[int], int]:
    """The kernel buffer's block offsets (one per weight/bias pair) and size."""
    layout = (ctypes.c_int * 8)()
    lib.pinnfc_train_dnn_layout(layout)
    return list(layout)[:7], layout[7]


class _KernelState(NamedTuple):
    """A stage's parameters and Adam moments in the kernel's buffer layout."""

    ws: List[torch.Tensor]  # mlp_weights of the MLP the stage starts from
    offsets: List[int]
    params: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


def _to_kernel(lib, mlp: MLP, state: Optional[AdamState]) -> _KernelState:
    """``mlp``'s weights and the carried Adam ``state``'s moments (zeros when
    None) in the kernel's buffer layout, on the MLP's device."""
    offsets, total = _layout(lib)
    ws = mlp_weights(mlp)
    params = _kernel_layout(flat_weights(mlp), ws, offsets, total)
    if state is None:
        return _KernelState(ws, offsets, params, torch.zeros_like(params),
                            torch.zeros_like(params))
    return _KernelState(ws, offsets, params, _kernel_layout(state.m, ws, offsets, total),
                        _kernel_layout(state.v, ws, offsets, total))


def _stage_out(mlp: MLP, ks: _KernelState, count: torch.Tensor,
               losses: torch.Tensor) -> DnnStageOut:
    """Inverse of ``_to_kernel`` after the steps: the trained copy of ``mlp``,
    the losses and the Adam state (``flat_weights``' layout, the count as
    int64)."""
    new_state = AdamState(_flat_layout(ks.m, ks.ws, ks.offsets),
                          _flat_layout(ks.v, ks.ws, ks.offsets), count.to(torch.int64))
    trained = unflat_weights(_flat_layout(ks.params, ks.ws, ks.offsets), mlp)
    return DnnStageOut(mlp_with_weights(mlp, trained), losses, new_state)


def train_dnn(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
    precision: str = "highest",
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage from the carried Adam
    ``state`` (fresh when None): the CUDA kernel for a CUDA tensor (its 3xTF32
    form for ``precision='highest'``, its bf16 form for ``'default'``), the
    float32 plain version for a CPU tensor at either precision.  ``seed`` is a
    uint32.  Returns the trained copy of ``mlp``, the per-step losses and the
    Adam state after the last step."""
    check_precision(precision)
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
    # spans (utils/observability.py) at the stage's host edges and around the
    # C entry, which enqueues every step
    with span("train_dnn.prep"):
        lib = build.load()
        ks = _to_kernel(lib, mlp, state)
        work = torch.empty(int(lib.pinnfc_train_dnn_workspace_floats(n)), dtype=torch.float32,
                           device=dev)
        # the step flags, then the Adam count before each step: counts[0] =
        # ints[n_iter] is the carried count, counts[n_iter] = ints[2 n_iter] the last
        ints = torch.zeros(2 * n_iter + 1, dtype=torch.int32, device=dev)
        if state is not None:
            ints[n_iter:n_iter + 1].copy_(state.count.reshape(1))
        losses = torch.empty(n_iter, dtype=torch.float32, device=dev)
    with span("train_dnn.launch"):
        build.launch(
            lib.pinnfc_train_dnn, "train_dnn", dev,
            x.data_ptr(), y.data_ptr(), n, ks.params.data_ptr(), ks.m.data_ptr(),
            ks.v.data_ptr(), work.data_ptr(), ints.data_ptr(), losses.data_ptr(),
            int(seed) & _U32, int(t0), int(n_iter), float(lr), int(lr_step), float(lr_gamma),
            thresh, inv_keep, _inv_n(n), int(bool(skip_nonfinite)), int(precision == "default"),
        )
        build.LAUNCHES["train_dnn"] += 1
    with span("train_dnn.finish"):
        return _stage_out(mlp, ks, ints[2 * n_iter], losses)


def step_grads(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, t: int, dropout_p: float = 0.2,
    precision: str = "highest",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss and the gradients (``mlp_weights``' order and layout) of step
    ``t`` of a stage from ``mlp``'s weights, with no Adam step: one
    ``pinnfc_train_dnn_grad`` launch in the form ``precision`` picks for a
    CUDA tensor (flagship only), ``loss_and_grads`` in float32 for a CPU
    tensor.  The kernel's one-step gradient, to hold against the plain
    version."""
    check_precision(precision)
    check_stage_inputs(mlp, x, y, 1, t, None)
    thresh, inv_keep = dropout_constants(dropout_p)
    n, dev = x.shape[0], x.device
    if dev.type == "cpu":
        keep = keep_masks(n, mlp.dropout_widths(), seed, t, thresh, dev) if thresh > 0 else None
        return loss_and_grads(mlp_weights(mlp), x, y, keep, inv_keep, _inv_n(n))
    if not mlp.is_flagship():
        raise ValueError(f"the training kernel covers the flagship topology only; this MLP "
                         f"is {mlp.layers}")
    lib = build.load()
    ks = _to_kernel(lib, mlp, None)
    work, grad, loss, flag = _grad_buffers(lib, x, ks.params.numel())
    _launch_grad(lib, x.contiguous(), y.contiguous(), 0, ks.params, work, grad, loss, flag,
                 seed, t, thresh, inv_keep, _inv_n(n), precision)
    return loss[0], unflat_weights(_flat_layout(grad, ks.ws, ks.offsets), mlp)


def _grad_buffers(lib, x: torch.Tensor, total: int):
    """The workspace, gradient, loss and flag of a ``pinnfc_train_dnn_grad``
    launch over the rows of x, on x's device."""
    d = x.device
    return (torch.empty(int(lib.pinnfc_train_dnn_workspace_floats(x.shape[0])),
                        dtype=torch.float32, device=d),
            torch.empty(total, dtype=torch.float32, device=d),
            torch.empty(1, dtype=torch.float32, device=d),
            torch.empty(1, dtype=torch.int32, device=d))


def _launch_grad(lib, x, y, row_off, params, work, grad, loss, flag, seed, t, thresh,
                 inv_keep, inv_n, precision) -> None:
    """One ``pinnfc_train_dnn_grad`` launch (kernels 1-3 of step t over the
    row shard x, y at global row ``row_off``) on x's device, counted."""
    build.launch(
        lib.pinnfc_train_dnn_grad, "train_dnn_grad", x.device, x.data_ptr(), y.data_ptr(),
        x.shape[0], int(row_off), params.to(x.device).data_ptr(), work.data_ptr(),
        grad.data_ptr(), loss.data_ptr(), flag.data_ptr(), int(seed) & _U32, int(t), thresh,
        inv_keep, inv_n, int(precision == "default"))
    build.LAUNCHES["train_dnn_grad"] += 1


# (weights on the shard's device, x, y, keep masks or None) -> (the shard's
# loss and gradient terms of the whole mean)
ShardGradFn = Callable[[List[torch.Tensor], torch.Tensor, torch.Tensor,
                        Optional[List[torch.Tensor]]], Tuple[torch.Tensor, Sequence[torch.Tensor]]]


def check_shards(mlp: MLP, shards, n_iter: int, t0: int, state: Optional[AdamState]) -> None:
    """Validate a sharded stage call: every shard (x, y) as ``check_stage_inputs``
    wants them on its own device, the MLP (and a carried state) on the first
    shard's device, and one device type for all."""
    if len(shards.parts) < 1:
        raise ValueError("no row shards")
    if len({x.device.type for x, _ in shards.parts}) != 1:
        raise ValueError(f"shards on mixed device types: {shards.devices}")
    for x_k, y_k in shards.parts:
        _check_rows(mlp, x_k, y_k)
    check_stage_inputs(mlp, *shards.parts[0], n_iter, t0, state)


def sharded_steps(
    mlp: MLP, shards, seed: int, n_iter: int, shard_grad: ShardGradFn, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
) -> DnnStageOut:
    """The step loop of ``adam_steps`` over row shards (``parallel/mesh.py::
    RowShards`` of (x, y)): per step, on every shard in order, the masks of its
    global rows and ``shard_grad``'s loss and gradient terms; their sums
    (``all_sum``, on the first shard's device, in shard order); then Adam on
    the first shard's device, where the MLP lies."""
    from pinnfc_tpu_torch.parallel.mesh import all_sum

    check_shards(mlp, shards, n_iter, t0, state)
    thresh, _ = dropout_constants(dropout_p)
    widths = mlp.dropout_widths()

    def step_grad(ws, t):
        losses, grads = [], []
        for (x_k, y_k), off in zip(shards.parts, shards.offsets):
            ws_k = [w.to(x_k.device) for w in ws]
            keep = (keep_masks(x_k.shape[0], widths, seed, t, thresh, x_k.device, off)
                    if thresh > 0 else None)
            loss_k, g_k = shard_grad(ws_k, x_k, y_k, keep)
            losses.append(loss_k)
            grads.append(flat_grad(g_k))
        return all_sum(losses), all_sum(grads)

    return adam_steps(mlp, n_iter, step_grad, lr, lr_step, lr_gamma, skip_nonfinite, t0, state)


def train_dnn_sharded_plain(
    mlp: MLP, shards, seed: int, n_iter: int, lr: float = 0.01, lr_step: int = 1000,
    lr_gamma: float = 0.8, dropout_p: float = 0.2, skip_nonfinite: bool = False, t0: int = 0,
    state: Optional[AdamState] = None, product_dtype: Optional[torch.dtype] = None,
) -> DnnStageOut:
    """Plain version of ``train_dnn_sharded``, any topology: ``loss_and_grads``
    on every shard with its global rows' masks and 1 / (the rows of all
    shards) as the mean's factor, the terms summed in shard order;
    ``product_dtype`` as in ``train_dnn_stage_plain``."""
    _, inv_keep = dropout_constants(dropout_p)
    inv_n = _inv_n(shards.n)

    def shard_grad(ws, x_k, y_k, keep):
        return loss_and_grads(ws, x_k, y_k, keep, inv_keep, inv_n, product_dtype)

    return sharded_steps(mlp, shards, seed, n_iter, shard_grad, lr, lr_step, lr_gamma,
                         dropout_p, skip_nonfinite, t0, state)


def train_dnn_sharded(
    mlp: MLP, shards, seed: int, n_iter: int, lr: float = 0.01, lr_step: int = 1000,
    lr_gamma: float = 0.8, dropout_p: float = 0.2, skip_nonfinite: bool = False, t0: int = 0,
    state: Optional[AdamState] = None, precision: str = "highest",
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage over row shards (``RowShards``
    of (x, y), the MLP on the first shard's device): per step one
    ``pinnfc_train_dnn_grad`` launch per shard (on its device), the shards'
    gradients, losses and flags summed in shard order on the first device, and
    one ``pinnfc_train_dnn_adam`` launch there; the plain version for CPU
    shards.  The objective is the mean over all rows, each row under the
    masks of its global row: one shard gives the whole-stage kernel's
    trajectory up to summation order.  ``precision`` picks the kernel's form
    as in ``train_dnn``.  Returns the trained copy of ``mlp``, the per-step
    losses and the Adam state (``flat_weights``' layout)."""
    from pinnfc_tpu_torch.parallel.mesh import all_sum

    check_precision(precision)
    check_shards(mlp, shards, n_iter, t0, state)
    dev_type = shards.devices[0].type
    if dev_type == "cpu":
        return train_dnn_sharded_plain(mlp, shards, seed, n_iter, lr, lr_step, lr_gamma,
                                       dropout_p, skip_nonfinite, t0, state)
    if dev_type != "cuda":
        raise ValueError(f"unsupported device {shards.devices[0]}")
    if not mlp.is_flagship():
        raise ValueError(
            f"the training kernel covers the flagship topology (8, 256, 256, 256, 1) "
            f"only; this MLP is {mlp.layers}"
        )
    thresh, inv_keep = dropout_constants(dropout_p)
    inv_n = _inv_n(shards.n)
    dev0 = shards.devices[0]
    lib = build.load()
    ks = _to_kernel(lib, mlp, state)
    total = ks.params.numel()
    # per step t: [the shards' flags summed, the Adam count before, after]
    ints = torch.zeros((n_iter, 3), dtype=torch.int32, device=dev0)
    if state is not None:
        ints[0, 1:2].copy_(state.count.reshape(1))
    losses = torch.empty(n_iter, dtype=torch.float32, device=dev0)
    # per shard: x, y, workspace, gradient, loss, flag
    bufs = [(x_k.contiguous(), y_k.contiguous(), *_grad_buffers(lib, x_k, total))
            for x_k, y_k in shards.parts]
    for t in range(n_iter):
        for buf, off in zip(bufs, shards.offsets):
            _launch_grad(lib, *buf[:2], off, ks.params, *buf[2:], seed, t0 + t, thresh,
                         inv_keep, inv_n, precision)
        losses[t:t + 1].copy_(all_sum([b[4] for b in bufs]))
        ints[t, 0:1].copy_(all_sum([b[5] for b in bufs]))
        if t > 0:
            ints[t, 1:2].copy_(ints[t - 1, 2:3])
        g = all_sum([b[3] for b in bufs])
        build.launch(
            lib.pinnfc_train_dnn_adam, "train_dnn_adam", dev0,
            ks.params.data_ptr(), ks.m.data_ptr(), ks.v.data_ptr(), g.data_ptr(),
            bufs[0][2].data_ptr(), ints[t].data_ptr(), float(lr), int(lr_step),
            float(lr_gamma), int(bool(skip_nonfinite)))
        build.LAUNCHES["train_dnn_adam"] += 1
    return _stage_out(mlp, ks, ints[n_iter - 1, 2], losses)
