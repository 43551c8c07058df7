"""Staged freeze/unfreeze PINN training (counterpart of
``pinnfc_tpu/training/stages.py``; reference schedule 01:2143-2153).

    dnn(4001) → lambda_v(4001, dnn_para=False) → lambda_v(4001, dnn_para=True)
    → dnn(8001) → thermal(10001) → hydrogen(8001) → oxygen(8001)

- The DNN stages of the flagship MLP run through the training kernel
  (``ops/train_dnn.py``): on a CUDA tensor the whole stage is one call of
  ``csrc/train_dnn.cu``, on a CPU tensor its plain version.  Any other
  topology runs the autograd stage ``train_dnn_autograd`` on either device
  (the JAX package's XLA scan ``train_dnn_stage``): the dropout forward of
  ``MLP``, ``torch.autograd.grad`` of ``aleatoric_loss``, Adam + StepLR.  The
  choice is made by topology alone, as the JAX exporter picks its sampler.
  Both draw the kernel's hash masks (``ops/train_dnn.py::keep_masks``).
  λ stay frozen; dropout is active.
- ``precision``: 'highest' (float32 accuracy: the kernel's 3xTF32 form, float32
  autograd) or 'default' (the TPU's bf16 throughput mode: on a CUDA tensor the
  kernel's bf16 form for the flagship and bf16-operand products
  (``models/mlp.py::RoundedMatmul``) for any other topology; on a CPU tensor
  float32, as JAX computes ``precision=None`` on a CPU).
- The λ stages are plain PyTorch on the data's device (the JAX package runs
  them as XLA scans, with no Pallas kernel): per step the loss, its gradient
  by ``torch.autograd.grad`` through ``physics/``, Adam + StepLR
  (``training/adam.py``) and the box clamp of ``LAMBDA_BOUNDS``.  In
  ``lambda_v`` the eval-mode DNN prediction is a stage constant (01:967,
  01:1009), and the other groups' losses never touch the DNN.

Every stage starts a fresh Adam.  With ``skip_nonfinite`` a step whose loss or
any gradient element is non-finite leaves the parameters AND the optimizer
state (moments and count) as they were — the reference's
try/except-and-continue loops (01:1204-1286, 01:1354-1396).

Each stage can also run in chunks (``train_dnn_chunk``,
``train_lambda_v_chunk``, ``train_residual_chunk``) that carry the Adam state
(``training/adam.py::AdamState``) from one chunk to the next: a stage run in
chunks takes the same steps as the whole stage.  ``run_schedule`` with
``ckpt_every`` snapshots after every chunk, so a run killed mid-stage resumes
at its last chunk boundary.

Data-parallel (``run_schedule(mesh=)``, the ``*_chunk_sharded`` functions):
the rows are split over the devices of the mesh's ``"data"`` axis
(``parallel/mesh.py::RowShards``), each step computes every shard's terms of
the whole mean loss and its gradient on the shard's device, sums them in
shard order on the first device (``all_sum``) and steps Adam there.  The
flagship's DNN stages run the training kernel's per-step entries
(``ops/train_dnn.py::train_dnn_sharded``); any other topology, and the λ
stages, autograd per shard.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.config import default_schedule
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.models.mlp import MLP, aleatoric_loss
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, PinnParams
from pinnfc_tpu_torch.ops.train_dnn import (
    DnnStageOut, check_precision, precision_dtype, sharded_steps, stage_steps, train_dnn,
    train_dnn_sharded)
from pinnfc_tpu_torch.parallel.mesh import (
    Mesh, RowShards, all_sum, data_size, pad_to_multiple, replicate, shard_batch)
from pinnfc_tpu_torch.physics.hydrogen import hydrogen_residual
from pinnfc_tpu_torch.physics.oxygen import oxygen_residual
from pinnfc_tpu_torch.physics.thermal import thermal_residual_simple
from pinnfc_tpu_torch.physics.voltage import voltage_residual
from pinnfc_tpu_torch.training.adam import (
    AdamState, adam_init, adam_state_from_numpy, adam_state_to_numpy, adam_step,
    adam_tree_from_optax, all_finite, is_port_adam_state, keep_if_nonfinite)
from pinnfc_tpu_torch.utils import checkpoint
from pinnfc_tpu_torch.utils.jax_params import (
    mlp_tree_from_flat, mlp_tree_to_flat, params_from_jax, params_to_numpy)
from pinnfc_tpu_torch.utils.observability import span

_GROUP_OF = {"thermal": "lam_t", "hydrogen": "lam_h", "oxygen": "lam_o"}
_RESIDUAL = {"lam_t": thermal_residual_simple, "lam_h": hydrogen_residual,
             "lam_o": oxygen_residual}


class StageResult(NamedTuple):
    params: object  # MLP for a DNN stage, the λ vector for a λ stage
    losses: torch.Tensor  # per-step loss trace (n_iter,)


def dnn_stage_seed(seed: int, k: int) -> int:
    """The uint32 dropout seed of the DNN stage at schedule index ``k``:
    ``RandomState([seed, k]).randint(0, 2**31 - 1)``.  A function of the stage
    index, so a run resumed at stage k draws the uninterrupted run's masks (the
    role of ``fold_in(rng, k)`` in the JAX package), and another stream than
    the MC export's ``default_mc_seed``."""
    return int(np.random.RandomState([int(seed), int(k)]).randint(0, 2**31 - 1))


def _named_params(ws, mlp: MLP) -> Dict[str, torch.Tensor]:
    """``mlp``'s parameters by name, taken from the tensors ``ws`` of
    ``mlp_weights``' order and (in, out) layout."""
    names = [name for name, _ in mlp.named_parameters()]
    return {name: (w.t() if name.endswith("weight") else w) for name, w in zip(names, ws)}


def train_dnn_autograd(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
    precision: str = "highest",
) -> DnnStageOut:
    """Steps t0 .. t0 + n_iter − 1 of a DNN stage for any topology, on x's
    device: the step loop of ``ops/train_dnn.py::stage_steps`` (the hash masks
    of step t, as the training kernel draws them; Adam + StepLR from the
    carried ``state``) with the gradient of ``aleatoric_loss`` of the dropout
    forward of ``mlp`` by ``torch.autograd.grad``, its products' operands
    rounded to ``precision_dtype(precision, x.device)``.  The counterpart of the
    JAX ``_dnn_step`` scan."""
    dtype = precision_dtype(precision, x.device)

    def grad_fn(ws, keep):
        ws = [w.detach().requires_grad_(True) for w in ws]
        with torch.enable_grad():
            pred, log_var = torch.func.functional_call(
                mlp, _named_params(ws, mlp), (x,),
                {"keep": keep, "dropout_p": dropout_p, "product_dtype": dtype})
            loss = aleatoric_loss(y, pred, log_var)
            grads = torch.autograd.grad(loss, ws)
        return loss.detach(), grads

    return stage_steps(mlp, x, y, seed, n_iter, grad_fn, lr, lr_step, lr_gamma, dropout_p,
                       skip_nonfinite, t0, state)


def train_dnn_autograd_sharded(
    mlp: MLP, shards: RowShards, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    skip_nonfinite: bool = False, t0: int = 0, state: Optional[AdamState] = None,
    precision: str = "highest",
) -> DnnStageOut:
    """``train_dnn_autograd`` over row shards, any topology: per step, on every
    shard, ``torch.autograd.grad`` of its term of the whole mean loss (its
    global rows' hash masks), the terms summed in shard order, then Adam."""
    dtype = precision_dtype(precision, shards.devices[0])

    def shard_grad(ws, x_k, y_k, keep):
        ws = [w.detach().requires_grad_(True) for w in ws]
        with torch.enable_grad():
            pred, log_var = torch.func.functional_call(
                mlp, _named_params(ws, mlp), (x_k,),
                {"keep": keep, "dropout_p": dropout_p, "product_dtype": dtype})
            loss = aleatoric_loss(y_k, pred, log_var, n_total=shards.n)
            grads = torch.autograd.grad(loss, ws)
        return loss.detach(), grads

    return sharded_steps(mlp, shards, seed, n_iter, shard_grad, lr, lr_step, lr_gamma,
                         dropout_p, skip_nonfinite, t0, state)


def train_dnn_chunk_sharded(
    mlp: MLP, opt_state: Optional[AdamState], shards: RowShards, seed: int, start: int,
    length: int, lr: float = 0.01, lr_step: int = 1000, lr_gamma: float = 0.8,
    dropout_p: float = 0.2, precision: str = "highest", skip_nonfinite: bool = False,
) -> Tuple[MLP, AdamState, torch.Tensor]:
    """``train_dnn_chunk`` over row shards: the training kernel's per-step
    entries for the flagship (their plain version on CPU shards), the
    autograd stage for any other topology, at ``precision``."""
    check_precision(precision)
    steps = train_dnn_sharded if mlp.is_flagship() else train_dnn_autograd_sharded
    out = steps(mlp, shards, seed, length, lr, lr_step, lr_gamma, dropout_p, skip_nonfinite,
                t0=start, state=opt_state, precision=precision)
    return out.mlp, out.state, out.losses


def _dnn_steps(mlp: MLP):
    """The DNN stage's implementation, by topology alone: the training kernel
    (its plain version on a CPU tensor) for the flagship, the autograd stage
    for any other."""
    return train_dnn if mlp.is_flagship() else train_dnn_autograd


def train_dnn_stage(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    precision: str = "highest", skip_nonfinite: bool = False,
) -> StageResult:
    """Full-batch Adam on the MLP with dropout active and λ frozen.

    The JAX function takes a ``jax.random`` key, which torch cannot reproduce;
    this one takes a uint32 ``seed`` and draws its dropout masks from the hash
    stream of ``train_dnn_pallas`` (see ``ops/train_dnn.py``).  The flagship
    runs the training kernel on a CUDA tensor and its plain version on a CPU
    tensor; any other topology runs ``train_dnn_autograd``.  On a CUDA tensor
    ``precision='highest'`` is float32 accuracy (the kernel's 3xTF32 form) and
    ``'default'`` the TPU's bf16 throughput mode (the kernel's bf16 form, or
    bf16-operand products for another topology); on a CPU tensor every path
    runs in float32 for either precision, as JAX does on a CPU."""
    check_precision(precision)
    out = _dnn_steps(mlp)(mlp, x, y, seed, n_iter, lr, lr_step, lr_gamma, dropout_p,
                          skip_nonfinite, precision=precision)
    return StageResult(out.mlp, out.losses)


def train_dnn_chunk(
    mlp: MLP, opt_state: Optional[AdamState], x: torch.Tensor, y: torch.Tensor, seed: int,
    start: int, length: int, lr: float = 0.01, lr_step: int = 1000, lr_gamma: float = 0.8,
    dropout_p: float = 0.2, precision: str = "highest", skip_nonfinite: bool = False,
) -> Tuple[MLP, AdamState, torch.Tensor]:
    """``length`` steps of the DNN stage from step ``start``, carrying the Adam
    state (None: fresh) across chunks: (mlp, state, losses).  Step s draws the
    masks of step s of the whole stage (the salt takes the step index inside
    the stage), so the chunks of a stage take its steps; for the flagship on a
    CUDA tensor one training-kernel launch per chunk, in the form
    ``precision`` picks."""
    check_precision(precision)
    out = _dnn_steps(mlp)(mlp, x, y, seed, length, lr, lr_step, lr_gamma, dropout_p,
                          skip_nonfinite, t0=start, state=opt_state, precision=precision)
    return out.mlp, out.state, out.losses


LossFn = Callable[[torch.Tensor], torch.Tensor]


def _value_and_grad(loss_fns: Sequence[Tuple[torch.device, LossFn]],
                    lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ_k loss_k(λ) and its gradient: each term and its gradient by autograd
    on its own device, the sums in order on λ's device (one term: that term)."""
    losses, grads = [], []
    for dev, loss_fn in loss_fns:
        var = lam.to(dev).detach().requires_grad_(True)
        loss = loss_fn(var)
        (g,) = torch.autograd.grad(loss, var)
        losses.append(loss.detach())
        grads.append(g.detach())
    return all_sum(losses), all_sum(grads)


def _lambda_steps(loss_fns: Sequence[Tuple[torch.device, LossFn]], lam: torch.Tensor,
                  state: Optional[AdamState], group: str, length: int, lr: float,
                  lr_step: int, lr_gamma: float, skip_nonfinite: bool,
                  ) -> Tuple[torch.Tensor, AdamState, torch.Tensor]:
    """``length`` Adam + post-step box-clamp steps over one λ vector (or a
    stack of them, (E, k), elementwise) from the carried state (None: fresh):
    (λ, state, losses).  The loss is the sum of the ``(device, loss_fn)``
    terms (one per row shard; one for unsharded rows)."""
    lo, hi = (torch.as_tensor(b, device=lam.device) for b in LAMBDA_BOUNDS[group])
    lam = lam.detach().clone()
    state = adam_init(lam) if state is None else state
    losses = []
    for _ in range(length):
        loss, g = _value_and_grad(loss_fns, lam)
        lam2, state2 = adam_step(lam, g, state, lr, lr_step, lr_gamma)
        new = (torch.clamp(lam2, lo, hi), state2)
        if skip_nonfinite:
            new = keep_if_nonfinite(all_finite(loss, g), new, (lam, state))
        lam, state = new
        losses.append(loss)
    return lam, state, torch.stack(losses)


def _mean_or_part(sq: torch.Tensor, n_total: Optional[int]) -> torch.Tensor:
    """mean(sq), or with ``n_total`` a shard's term of the mean over all rows."""
    return torch.mean(sq) if n_total is None else torch.sum(sq) / n_total


def _lambda_v_loss_fn(x_norm, y_norm, u_pred_norm, scaler_x, scaler_y, dnn_para,
                      n_total: Optional[int] = None):
    """Voltage-λ stage loss (01:1025-1032), shared by the stage and its chunks;
    with ``n_total``, the term of a row shard."""
    scale_y, min_y = scaler_y.loss_affine()
    u_pred_norm = u_pred_norm.detach()

    def loss_fn(lam):
        v = voltage_residual(lam, x_norm, u_pred_norm, scaler_x, scaler_y)
        if dnn_para:
            return _mean_or_part(v.f**2, n_total)
        return _mean_or_part((y_norm - (v.v_out_est_stack * scale_y + min_y)) ** 2, n_total)

    return loss_fn


def _residual_loss_fn(x_norm, scaler_x, group, n_total: Optional[int] = None):
    residual = _RESIDUAL[group]

    def loss_fn(lam):
        return _mean_or_part(residual(lam, x_norm, scaler_x).f ** 2, n_total)

    return loss_fn


def train_lambda_v_stage(
    lam_v: torch.Tensor, x_norm: torch.Tensor, y_norm: torch.Tensor, u_pred_norm: torch.Tensor,
    scaler_x: AffineScaler, scaler_y: AffineScaler, n_iter: int, lr: float = 1e-3,
    lr_step: int = 1000, lr_gamma: float = 0.8, dnn_para: bool = False,
    skip_nonfinite: bool = False,
) -> StageResult:
    """Voltage-λ stage (reference train_lambda, 01:966-1058).

    ``dnn_para=False`` → normalized-domain physics loss
    MSE(y_norm, V_out_est·scale_y + min_y) (01:1025-1032); ``dnn_para=True`` →
    residual loss mean(f²) (01:1029).  ``u_pred_norm`` is the eval-mode DNN
    prediction, a stage constant."""
    lam, _, losses = train_lambda_v_chunk(
        lam_v, None, x_norm, y_norm, u_pred_norm, scaler_x, scaler_y, n_iter, lr, lr_step,
        lr_gamma, dnn_para, skip_nonfinite)
    return StageResult(lam, losses)


def train_lambda_v_chunk(
    lam_v: torch.Tensor, opt_state: Optional[AdamState], x_norm: torch.Tensor,
    y_norm: torch.Tensor, u_pred_norm: torch.Tensor, scaler_x: AffineScaler,
    scaler_y: AffineScaler, length: int, lr: float = 1e-3, lr_step: int = 1000,
    lr_gamma: float = 0.8, dnn_para: bool = False, skip_nonfinite: bool = False,
) -> Tuple[torch.Tensor, AdamState, torch.Tensor]:
    """``length`` steps of the voltage-λ stage from the carried Adam state
    (None: fresh): (λ, state, losses).  The count in the state carries the
    StepLR staircase across chunk boundaries."""
    loss_fn = _lambda_v_loss_fn(x_norm, y_norm, u_pred_norm, scaler_x, scaler_y, dnn_para)
    return _lambda_steps([(lam_v.device, loss_fn)], lam_v, opt_state, "lam_v", length, lr,
                         lr_step, lr_gamma, skip_nonfinite)


def train_lambda_v_chunk_sharded(
    lam_v: torch.Tensor, opt_state: Optional[AdamState], shards: RowShards,
    u_preds: Sequence[torch.Tensor], scaler_x: AffineScaler, scaler_y: AffineScaler,
    length: int, lr: float = 1e-3, lr_step: int = 1000, lr_gamma: float = 0.8,
    dnn_para: bool = False, skip_nonfinite: bool = False,
) -> Tuple[torch.Tensor, AdamState, torch.Tensor]:
    """``train_lambda_v_chunk`` over row shards of (x, y), with each shard's
    eval-mode DNN prediction ``u_preds[k]``: the loss is the sum of the
    shards' terms of the mean over all rows, by autograd per shard."""
    fns = [(x_k.device, _lambda_v_loss_fn(x_k, y_k, u_k, scaler_x, scaler_y, dnn_para,
                                          shards.n))
           for (x_k, y_k), u_k in zip(shards.parts, u_preds)]
    return _lambda_steps(fns, lam_v, opt_state, "lam_v", length, lr, lr_step, lr_gamma,
                         skip_nonfinite)


def train_residual_stage(
    lam: torch.Tensor, x_norm: torch.Tensor, scaler_x: AffineScaler, group: str, n_iter: int,
    lr: float, lr_step: int = 1000, lr_gamma: float = 0.8, skip_nonfinite: bool = False,
) -> StageResult:
    """Thermal / hydrogen / oxygen stage: loss = mean(f²) over one λ group
    (reference 01:1060-1399)."""
    lam, _, losses = train_residual_chunk(lam, None, x_norm, scaler_x, group, n_iter, lr,
                                          lr_step, lr_gamma, skip_nonfinite)
    return StageResult(lam, losses)


def train_residual_chunk(
    lam: torch.Tensor, opt_state: Optional[AdamState], x_norm: torch.Tensor,
    scaler_x: AffineScaler, group: str, length: int, lr: float, lr_step: int = 1000,
    lr_gamma: float = 0.8, skip_nonfinite: bool = False,
) -> Tuple[torch.Tensor, AdamState, torch.Tensor]:
    """``length`` steps of a thermal/hydrogen/oxygen stage from the carried
    Adam state (None: fresh): (λ, state, losses)."""
    return _lambda_steps([(lam.device, _residual_loss_fn(x_norm, scaler_x, group))], lam,
                         opt_state, group, length, lr, lr_step, lr_gamma, skip_nonfinite)


def train_residual_chunk_sharded(
    lam: torch.Tensor, opt_state: Optional[AdamState], shards: RowShards,
    scaler_x: AffineScaler, group: str, length: int, lr: float, lr_step: int = 1000,
    lr_gamma: float = 0.8, skip_nonfinite: bool = False,
) -> Tuple[torch.Tensor, AdamState, torch.Tensor]:
    """``train_residual_chunk`` over row shards (arrays: x first): the sum of
    the shards' terms of the mean over all rows, by autograd per shard."""
    fns = [(p[0].device, _residual_loss_fn(p[0], scaler_x, group, shards.n))
           for p in shards.parts]
    return _lambda_steps(fns, lam, opt_state, group, length, lr, lr_step, lr_gamma,
                         skip_nonfinite)


def _sharded_chunk(key, stage, piece, opt_state, shards, u_preds, scaler_x, scaler_y, seed,
                   start, length, dropout_p, precision, common):
    """One chunk of run_schedule's stage over row shards: (piece, state, losses)."""
    if key == "mlp":
        return train_dnn_chunk_sharded(piece, opt_state, shards, seed, start, length,
                                       dropout_p=dropout_p, precision=precision, **common)
    if key == "lam_v":
        return train_lambda_v_chunk_sharded(piece, opt_state, shards, u_preds, scaler_x,
                                            scaler_y, length, dnn_para=stage.dnn_para, **common)
    return train_residual_chunk_sharded(piece, opt_state, shards, scaler_x, key, length,
                                        **common)


@dataclasses.dataclass
class TrainLog:
    """Loss traces per executed stage, in order, with each stage's wall
    seconds (host clock; a stage ends when its losses reach the host)."""

    stages: list = dataclasses.field(default_factory=list)  # (name, losses)
    seconds: list = dataclasses.field(default_factory=list)  # (name, s)

    def add(self, name: str, losses, seconds: float) -> None:
        self.stages.append((name, losses))
        self.seconds.append((name, seconds))

    def final_losses(self) -> Dict[str, float]:
        return {name: float(losses[-1]) for name, losses in self.stages}


def _piece_key(name: str) -> str:
    if name == "dnn":
        return "mlp"
    if name == "lambda_v":
        return "lam_v"
    if name in _GROUP_OF:
        return _GROUP_OF[name]
    raise ValueError(f"unknown stage '{name}'")


def run_schedule(
    params: PinnParams,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
    schedule=None,
    seed: int = 0,
    dropout_p: float = 0.2,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    ckpt_every: Optional[int] = None,
    precision: str = "highest",
    skip_nonfinite: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[PinnParams, TrainLog]:
    """Run the staged schedule on the device of ``x_train``, replacing the
    params set's pieces stage by stage; the DNN stage at index k draws its masks
    from ``dnn_stage_seed(seed, k)``.  Loss traces come back as numpy arrays.

    With ``checkpoint_dir``, the params are saved after every stage
    (``schedule_ckpt.npz``: params and stage index) and a restarted run
    resumes at the first stage not yet done, reproducing the uninterrupted
    run.  A snapshot written at a stage index past this schedule's end raises.

    With ``ckpt_every=m``, every stage runs in chunks of m steps and the
    snapshot after each chunk also holds the step reached inside the stage,
    the Adam state (marked as this package's) and the stage's losses so far: a
    run killed mid-stage resumes at its last chunk boundary and ends where the
    uninterrupted chunked run ends, bit for bit.  Without ``ckpt_every`` a
    stage is one chunk of its ``n_iter`` steps, and a stage resumed from a
    mid-stage snapshot runs the rest of it as one chunk.  A mid-stage snapshot of the JAX package
    resumes too: its optax Adam state maps onto ``AdamState``
    (``adam_tree_from_optax``); any other optimizer tree raises ``ValueError``.

    With ``mesh`` (``parallel/mesh.py``), the rows are edge-padded to a
    multiple of the mesh's size, as the JAX package pads them (padded rows
    count in the mean losses, so pass a divisible N for the unsharded run's
    objective), and split evenly over the devices of its ``"data"`` axis; every
    step sums the shards' terms in shard order and updates the parameters on
    the axis' first device, where they come back.  The DNN stages' masks go by
    global row, so a sharded stage draws the unsharded stage's masks.  Chunks,
    snapshots and resume work as without a mesh.  A data axis of size 1 runs
    the unsharded path."""
    schedule = default_schedule() if schedule is None else schedule
    if ckpt_every is not None and ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    log = TrainLog()
    shards = None
    if data_size(mesh) > 1:
        x_pad, n0 = pad_to_multiple(x_train, mesh.size)
        y_pad, _ = pad_to_multiple(y_train, mesh.size)
        if x_pad.shape[0] != n0 and verbose:
            print(f"padded {n0} → {x_pad.shape[0]} rows for {mesh.size}-way sharding")
        shards = shard_batch(mesh, x_pad, y_pad)
        params = replicate(mesh, params)[0]
    dev = x_train.device if shards is None else shards.devices[0]
    start_stage = 0
    mid_resume = None  # (step, opt tree, losses so far) of stage start_stage
    ckpt_path = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "schedule_ckpt.npz")
        if os.path.exists(ckpt_path):
            payload = checkpoint.load_params_npz(ckpt_path)
            k0 = int(payload["stage"])
            if k0 >= len(schedule):
                raise ValueError(
                    f"checkpoint at {ckpt_path} was written at stage {k0} but "
                    f"the current schedule has only {len(schedule)} stages — "
                    "the checkpoint does not match this schedule"
                )
            step_done = int(payload["step"]) if "step" in payload else None
            if step_done is None or step_done >= schedule[k0].n_iter:
                start_stage = k0 + 1
            else:
                opt = payload.get("opt")
                if not is_port_adam_state(opt):  # the JAX package's optax state
                    opt = adam_tree_from_optax(opt)
                if opt is None:
                    raise ValueError(
                        f"checkpoint at {ckpt_path} is a mid-stage snapshot (stage {k0}, "
                        f"step {step_done}) whose optimizer state is neither this "
                        "package's nor the JAX package's optax Adam state; remove the "
                        "snapshot to start the schedule anew")
                start_stage = k0
                mid_resume = (step_done, opt, np.asarray(payload["losses"]))
            params = params_from_jax(payload["params"], device=dev)
            if verbose:
                where = (f"stage {start_stage}" if mid_resume is None
                         else f"stage {k0} step {step_done}")
                print(f"resuming schedule at {where}")

    def run_stage(k, stage, params, resume):
        """Run stage k from the resumed step and Adam state in chunks of
        ckpt_every steps (one chunk without it).  After a chunk that ends
        inside the stage, or any chunk under ckpt_every, the snapshot holds
        (params, stage, step, opt, losses); otherwise (params, stage)."""
        key = _piece_key(stage.name)
        piece = params[key]
        if key == "mlp":  # the moments lie in the MLP's JAX layout in the file
            tree_of = lambda a: mlp_tree_from_flat(a, piece)  # noqa: E731
            flat_of = mlp_tree_to_flat
        else:
            tree_of = flat_of = None
        if key == "lam_v":
            with torch.no_grad():
                if shards is None:
                    u_pred, _ = params["mlp"](x_train)
                else:  # the eval forward per shard, on the shard's device
                    mlps = replicate(mesh, params["mlp"])
                    u_pred = [m(x_k)[0] for m, (x_k, _) in zip(mlps, shards.parts)]
        start, opt_state, acc = 0, None, []
        if resume is not None:
            start, opt_tree, losses_prev = resume
            opt_state = adam_state_from_numpy(opt_tree, dev, flat_of)
            acc.append(losses_prev)
        every = ckpt_every if ckpt_every is not None else stage.n_iter - start
        common = dict(lr=stage.lr, lr_step=stage.lr_step, lr_gamma=stage.lr_gamma,
                      skip_nonfinite=skip_nonfinite)
        s = start
        while s < stage.n_iter:
            m = min(every, stage.n_iter - s)
            if shards is not None:
                piece, opt_state, losses = _sharded_chunk(
                    key, stage, piece, opt_state, shards, u_pred if key == "lam_v" else None,
                    scaler_x, scaler_y, dnn_stage_seed(seed, k), s, m, dropout_p, precision,
                    common)
            elif key == "mlp":
                piece, opt_state, losses = train_dnn_chunk(
                    piece, opt_state, x_train, y_train, dnn_stage_seed(seed, k), s, m,
                    dropout_p=dropout_p, precision=precision, **common)
            elif key == "lam_v":
                piece, opt_state, losses = train_lambda_v_chunk(
                    piece, opt_state, x_train, y_train, u_pred, scaler_x, scaler_y, m,
                    dnn_para=stage.dnn_para, **common)
            else:
                piece, opt_state, losses = train_residual_chunk(
                    piece, opt_state, x_train, scaler_x, key, m, **common)
            s += m
            acc.append(losses.cpu().numpy())
            params = {**params, key: piece}
            if ckpt_path is not None:
                payload = {"params": params_to_numpy(params), "stage": np.asarray(k)}
                if ckpt_every is not None or s < stage.n_iter:
                    payload.update(step=np.asarray(s),
                                   opt=adam_state_to_numpy(opt_state, tree_of),
                                   losses=np.concatenate(acc))
                # looked up at call time, so a test can stand in for the writer
                checkpoint.save_params_npz(payload, ckpt_path)
        return params, np.concatenate(acc)

    for k, stage in enumerate(schedule):
        if k < start_stage:
            continue
        t0 = time.perf_counter()
        with span(f"stage.{stage.name}"):  # the losses' readback and any snapshot included
            params, losses = run_stage(k, stage, params, mid_resume if k == start_stage else None)
        seconds = time.perf_counter() - t0
        log.add(f"{k}:{stage.name}", losses, seconds)
        if verbose:
            print(f"stage {k} [{stage.name:9s}] {stage.n_iter:6d} steps  "
                  f"loss {losses[0]:.3e} → {losses[-1]:.3e}  ({seconds:.3f} s)")
    return params, log
