"""One combined data-parallel PINN step (counterpart of
``pinnfc_tpu/parallel/data_parallel.py``).

``full_train_step`` evaluates every loss of the staged schedule on one batch
whose rows are split over a mesh's ``"data"`` axis — the aleatoric DNN loss,
the voltage-λ residual loss and the thermal / hydrogen / oxygen residual
losses — and applies five per-group Adam updates (``training/adam.py``, a
constant learning rate each) and the λ box clamps.  Each loss and its gradient
is the sum of the shards' terms of the whole mean, added in shard order on the
first device (``parallel/mesh.py::all_sum``); the parameters live there.

The JAX step takes a ``jax.random`` key for its dropout masks, which torch
cannot reproduce.  This one takes a uint32 ``seed`` and a step index ``t`` and
draws the training kernel's hash masks of step t by global row
(``ops/train_dnn.py::keep_masks``), so a sharded step equals an unsharded one
up to summation order.  The DNN gradient is the training kernel's plain
version (``loss_and_grads``) on each shard, for any topology.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, PinnParams
from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants
from pinnfc_tpu_torch.ops.train_dnn import (
    _inv_n, flat_grad, flat_weights, keep_masks, loss_and_grads, mlp_with_weights,
    unflat_weights)
from pinnfc_tpu_torch.parallel.mesh import (
    Mesh, RowShards, all_sum, data_size, shard_batch, to_device)
from pinnfc_tpu_torch.physics.hydrogen import hydrogen_residual
from pinnfc_tpu_torch.physics.oxygen import oxygen_residual
from pinnfc_tpu_torch.physics.thermal import thermal_residual_simple
from pinnfc_tpu_torch.physics.voltage import voltage_residual
from pinnfc_tpu_torch.training.adam import AdamState, adam_init, adam_step

GROUPS = ("mlp", "lam_v", "lam_t", "lam_h", "lam_o")
_RESIDUAL = {"lam_t": thermal_residual_simple, "lam_h": hydrogen_residual,
             "lam_o": oxygen_residual}
# Adam with a constant learning rate: a StepLR staircase that never turns
_NO_DECAY = dict(lr_step=2**31 - 1, lr_gamma=1.0)


class DPTrainState(NamedTuple):
    params: PinnParams
    opt_states: Tuple[AdamState, ...]  # one per group, in GROUPS order; the MLP's over
    #                                    ops/train_dnn.py::flat_weights


def make_dp_optimizers(lr_mlp: float = 0.01, lr_v: float = 1e-3, lr_t: float = 1.0,
                       lr_h: float = 1e-1, lr_o: float = 1e-2) -> Dict[str, float]:
    """The learning rate of each group's Adam (the JAX package's
    ``optax.adam(lr)`` per group)."""
    return {"mlp": lr_mlp, "lam_v": lr_v, "lam_t": lr_t, "lam_h": lr_h, "lam_o": lr_o}


def init_dp_state(params: PinnParams, opts: Dict[str, float]) -> DPTrainState:
    del opts  # a fresh Adam state does not depend on the learning rate
    return DPTrainState(params, tuple(
        adam_init(flat_weights(params[g]) if g == "mlp" else params[g]) for g in GROUPS))


def _shards(mesh: Optional[Mesh], x: torch.Tensor, y: torch.Tensor) -> RowShards:
    if data_size(mesh) > 1:
        return shard_batch(mesh, x, y)
    return RowShards(((x, y),), (0,), int(x.shape[0]))


def full_train_step(
    state: DPTrainState, x: torch.Tensor, y: torch.Tensor, seed: int, t: int,
    scaler_x: AffineScaler, scaler_y: AffineScaler, opts: Dict[str, float],
    dropout_p: float = 0.2, mesh: Optional[Mesh] = None,
) -> Tuple[DPTrainState, Dict[str, torch.Tensor]]:
    """One combined step updating all five parameter groups from the same
    parameters; the voltage loss takes the eval-mode DNN prediction of those
    parameters.  With ``mesh``, x's and y's rows (N divisible by the data axis)
    split over its ``"data"`` axis.  Returns (the new state, {group: loss})."""
    params = state.params
    shards = _shards(mesh, x, y)
    n = shards.n
    dev = shards.devices[0]
    mlp = params["mlp"]
    thresh, inv_keep = dropout_constants(dropout_p)
    widths = mlp.dropout_widths()

    flat = flat_weights(mlp)
    ws = unflat_weights(flat, mlp)
    dnn_terms, dnn_grads, u_evals = [], [], []
    with torch.no_grad():
        for (x_k, y_k), off in zip(shards.parts, shards.offsets):
            ws_k = [w.to(x_k.device) for w in ws]
            keep = (keep_masks(x_k.shape[0], widths, seed, t, thresh, x_k.device, off)
                    if thresh > 0 else None)
            loss_k, g_k = loss_and_grads(ws_k, x_k, y_k, keep, inv_keep, _inv_n(n))
            dnn_terms.append(loss_k)
            dnn_grads.append(flat_grad(g_k))
            u_evals.append(to_device(mlp, x_k.device)(x_k)[0])

    def lam_terms(group, lam):
        terms, grads = [], []
        for (x_k, _), u_k in zip(shards.parts, u_evals):
            var = lam.to(x_k.device).detach().requires_grad_(True)
            with torch.enable_grad():
                if group == "lam_v":
                    f = voltage_residual(var, x_k, u_k, scaler_x, scaler_y).f
                else:
                    f = _RESIDUAL[group](var, x_k, scaler_x).f
                loss = torch.sum(f**2) / n
                (g,) = torch.autograd.grad(loss, var)
            terms.append(loss.detach())
            grads.append(g)
        return all_sum(terms), all_sum(grads)

    new_params, new_states, losses = dict(params), [], {}
    for g, opt_state in zip(GROUPS, state.opt_states):
        if g == "mlp":
            loss, grad = all_sum(dnn_terms), all_sum(dnn_grads)
            new_flat, opt_state = adam_step(flat, grad, opt_state, opts[g], **_NO_DECAY)
            new_params[g] = mlp_with_weights(mlp, unflat_weights(new_flat, mlp))
        else:
            loss, grad = lam_terms(g, params[g])
            p, opt_state = adam_step(params[g].detach(), grad, opt_state, opts[g], **_NO_DECAY)
            lo, hi = (torch.as_tensor(b, device=dev) for b in LAMBDA_BOUNDS[g])
            new_params[g] = torch.clamp(p, lo, hi)
        new_states.append(opt_state)
        losses[g] = loss
    return DPTrainState(new_params, tuple(new_states)), losses
