"""Staged freeze/unfreeze PINN training (counterpart of
``pinnfc_tpu/training/stages.py``; reference schedule 01:2143-2153).

    dnn(4001) → lambda_v(4001, dnn_para=False) → lambda_v(4001, dnn_para=True)
    → dnn(8001) → thermal(10001) → hydrogen(8001) → oxygen(8001)

- The DNN stages run through the training kernel (``ops/train_dnn.py``): on a
  CUDA tensor the whole stage is one call of ``csrc/train_dnn.cu``, on a CPU
  tensor its plain version.  λ stay frozen; dropout is active.
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
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.config import default_schedule
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.models.mlp import MLP
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, PinnParams
from pinnfc_tpu_torch.ops.train_dnn import train_dnn
from pinnfc_tpu_torch.physics.hydrogen import hydrogen_residual
from pinnfc_tpu_torch.physics.oxygen import oxygen_residual
from pinnfc_tpu_torch.physics.thermal import thermal_residual_simple
from pinnfc_tpu_torch.physics.voltage import voltage_residual
from pinnfc_tpu_torch.training.adam import adam_init, adam_step, all_finite, keep_if_nonfinite
from pinnfc_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz
from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy

PRECISIONS = ("highest", "default")
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


def train_dnn_stage(
    mlp: MLP, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, lr: float = 0.01,
    lr_step: int = 1000, lr_gamma: float = 0.8, dropout_p: float = 0.2,
    precision: str = "highest", skip_nonfinite: bool = False,
) -> StageResult:
    """Full-batch Adam on the MLP with dropout active and λ frozen.

    The JAX function takes a ``jax.random`` key, which torch cannot reproduce;
    this one takes a uint32 ``seed`` and draws its dropout masks from the hash
    stream of ``train_dnn_pallas`` (see ``ops/train_dnn.py``).  On a CUDA
    tensor it launches the training kernel at float32 accuracy ('highest',
    3xTF32 on the tensor cores); ``precision='default'`` (the TPU's bf16
    throughput mode) needs a single-TF32 or bf16 form of the kernel, which does
    not exist yet, and raises there.  On a CPU tensor it runs the plain
    version, in float32 for either precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "default" and x.device.type == "cuda":
        raise ValueError("precision='default' needs a single-TF32 or bf16 form of the "
                         "training kernel, which is not ported yet; use 'highest'")
    mlp, losses = train_dnn(mlp, x, y, seed, n_iter, lr, lr_step, lr_gamma, dropout_p,
                            skip_nonfinite)
    return StageResult(mlp, losses)


def _fit_lambda(loss_fn: Callable[[torch.Tensor], torch.Tensor], lam0: torch.Tensor,
                group: str, n_iter: int, lr: float, lr_step: int, lr_gamma: float,
                skip_nonfinite: bool) -> StageResult:
    """Adam + post-step box clamp over one λ vector."""
    lo, hi = (torch.as_tensor(b, device=lam0.device) for b in LAMBDA_BOUNDS[group])
    lam = lam0.detach().clone()
    state = adam_init(lam)
    losses = []
    for _ in range(n_iter):
        var = lam.detach().requires_grad_(True)
        loss = loss_fn(var)
        (g,) = torch.autograd.grad(loss, var)
        loss, g = loss.detach(), g.detach()
        lam2, state2 = adam_step(lam, g, state, lr, lr_step, lr_gamma)
        new = (torch.clamp(lam2, lo, hi), state2)
        if skip_nonfinite:
            new = keep_if_nonfinite(all_finite(loss, g), new, (lam, state))
        lam, state = new
        losses.append(loss)
    return StageResult(lam, torch.stack(losses))


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
    scale_y, min_y = scaler_y.loss_affine()
    u_pred_norm = u_pred_norm.detach()

    def loss_fn(lam):
        v = voltage_residual(lam, x_norm, u_pred_norm, scaler_x, scaler_y)
        if dnn_para:
            return torch.mean(v.f**2)
        return torch.mean((y_norm - (v.v_out_est_stack * scale_y + min_y)) ** 2)

    return _fit_lambda(loss_fn, lam_v, "lam_v", n_iter, lr, lr_step, lr_gamma, skip_nonfinite)


def train_residual_stage(
    lam: torch.Tensor, x_norm: torch.Tensor, scaler_x: AffineScaler, group: str, n_iter: int,
    lr: float, lr_step: int = 1000, lr_gamma: float = 0.8, skip_nonfinite: bool = False,
) -> StageResult:
    """Thermal / hydrogen / oxygen stage: loss = mean(f²) over one λ group
    (reference 01:1060-1399)."""
    residual = _RESIDUAL[group]

    def loss_fn(l):
        return torch.mean(residual(l, x_norm, scaler_x).f ** 2)

    return _fit_lambda(loss_fn, lam, group, n_iter, lr, lr_step, lr_gamma, skip_nonfinite)


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
    precision: str = "highest",
    skip_nonfinite: bool = False,
) -> Tuple[PinnParams, TrainLog]:
    """Run the staged schedule on the device of ``x_train``, replacing the
    params set's pieces stage by stage; the DNN stage at index k draws its masks
    from ``dnn_stage_seed(seed, k)``.  Loss traces come back as numpy arrays.

    With ``checkpoint_dir``, the params are saved after every stage
    (``schedule_ckpt.npz``: params and stage index) and a restarted run
    resumes at the first stage not yet done, reproducing the uninterrupted
    run.  A snapshot written at a stage index past this schedule's end
    raises, as does a mid-stage snapshot (``ckpt_every`` is not ported)."""
    schedule = default_schedule() if schedule is None else schedule
    log = TrainLog()
    dev = x_train.device
    start_stage = 0
    ckpt_path = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "schedule_ckpt.npz")
        if os.path.exists(ckpt_path):
            payload = load_params_npz(ckpt_path)
            k0 = int(payload["stage"])
            if k0 >= len(schedule):
                raise ValueError(
                    f"checkpoint at {ckpt_path} was written at stage {k0} but "
                    f"the current schedule has only {len(schedule)} stages — "
                    "the checkpoint does not match this schedule"
                )
            if "step" in payload and int(payload["step"]) < schedule[k0].n_iter:
                raise ValueError(
                    f"checkpoint at {ckpt_path} is a mid-stage snapshot (stage {k0}, "
                    f"step {int(payload['step'])}); mid-stage resume is not ported"
                )
            params = params_from_jax(payload["params"], device=dev)
            start_stage = k0 + 1
            if verbose:
                print(f"resuming schedule at stage {start_stage}")

    for k, stage in enumerate(schedule):
        if k < start_stage:
            continue
        t0 = time.perf_counter()
        if stage.name == "dnn":
            res = train_dnn_stage(
                params["mlp"], x_train, y_train, dnn_stage_seed(seed, k), n_iter=stage.n_iter,
                lr=stage.lr, lr_step=stage.lr_step, lr_gamma=stage.lr_gamma,
                dropout_p=dropout_p, precision=precision, skip_nonfinite=skip_nonfinite,
            )
            params = {**params, "mlp": res.params}
        elif stage.name == "lambda_v":
            with torch.no_grad():
                u_pred, _ = params["mlp"](x_train)
            res = train_lambda_v_stage(
                params["lam_v"], x_train, y_train, u_pred, scaler_x, scaler_y,
                n_iter=stage.n_iter, lr=stage.lr, lr_step=stage.lr_step,
                lr_gamma=stage.lr_gamma, dnn_para=stage.dnn_para,
                skip_nonfinite=skip_nonfinite,
            )
            params = {**params, "lam_v": res.params}
        elif stage.name in _GROUP_OF:
            group = _GROUP_OF[stage.name]
            res = train_residual_stage(
                params[group], x_train, scaler_x, group, n_iter=stage.n_iter, lr=stage.lr,
                lr_step=stage.lr_step, lr_gamma=stage.lr_gamma, skip_nonfinite=skip_nonfinite,
            )
            params = {**params, group: res.params}
        else:
            raise ValueError(f"unknown stage '{stage.name}'")
        losses = res.losses.cpu().numpy()
        seconds = time.perf_counter() - t0
        log.add(f"{k}:{stage.name}", losses, seconds)
        if ckpt_path is not None:
            save_params_npz({"params": params_to_numpy(params), "stage": np.asarray(k)},
                            ckpt_path)
        if verbose:
            print(f"stage {k} [{stage.name:9s}] {stage.n_iter:6d} steps  "
                  f"loss {losses[0]:.3e} → {losses[-1]:.3e}  ({seconds:.3f} s)")
    return params, log
