"""Many-seed PINN ensembles and row-sharded MC dropout (counterpart of
``pinnfc_tpu/parallel/ensemble.py``).

An ensemble is ``{"mlp": [MLP] * E, "lam_v": (E, 4), "lam_t": (E, 5), "lam_h":
(E, 4), "lam_o": (E, 4)}``: the λ's stacked with a leading member axis as in
the JAX package, the MLPs a list (the flagship's stages run one training-kernel
launch per member, which a stacked weight tensor would not give).  Member e
draws its weights from ``torch.Generator().manual_seed(member_seed(seed, e))``,
and ``train_dnn_ensemble(..., seed=s)`` draws its dropout masks from the hash
stream keyed by ``member_seed(s, e)`` (``cli ensemble`` passes s = seed + 1, as
the JAX command keys its dropout with ``seed + 1``).  So member e of an
ensemble is the lone model of those seeds, bit for bit.

- ``train_dnn_ensemble``: one DNN stage per member; with a mesh, the members
  are split in contiguous groups over the ``"data"`` axis, group g on its g-th
  device (no communication between members).
- ``train_dnn_ensemble_2d``: members over the ``"model"`` axis, each member's
  rows over the ``"data"`` axis through the sharded DNN stage
  (``training/stages.py::train_dnn_chunk_sharded``).
- ``train_pinn_ensemble``: the whole staged schedule for every member; each λ
  stage is ONE step loop over the stacked (E, k) λ's (the loss is the sum of
  the members' means, so each member's λ's get its own gradient, and Adam and
  the clamp are elementwise), the counterpart of the JAX package's ``vmap``
  over the stage scan.
- ``mc_dropout_sharded``: MC dropout with the rows split over the ``"data"``
  axis at multiples of 256 rows (the MC kernel's mask blocks): for the
  flagship one MC-kernel launch per shard with the shard's first mask block
  (``block0``), which gives the unsharded kernel's statistics bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.models.mlp import MLP
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, LAMBDA_GROUPS, init_pinn
from pinnfc_tpu_torch.ops.mc_dropout import MASK_BLOCK, mc_dropout_sums
from pinnfc_tpu_torch.parallel.mesh import (
    Mesh, block_sizes, gather_rows, pad_to_multiple, replicate, shard_batch, split_rows,
    to_device)
from pinnfc_tpu_torch.physics.hydrogen import hydrogen_residual
from pinnfc_tpu_torch.physics.oxygen import oxygen_residual
from pinnfc_tpu_torch.physics.thermal import thermal_residual_simple
from pinnfc_tpu_torch.physics.voltage import voltage_residual
from pinnfc_tpu_torch.training.adam import adam_init, adam_step
from pinnfc_tpu_torch.training.stages import (
    dnn_stage_seed, train_dnn_chunk_sharded, train_dnn_stage)
from pinnfc_tpu_torch.uq.mc_dropout import (
    MCSamples, finish_mc_stats, mc_chunking, mc_dropout_samples)

Ensemble = Dict[str, object]
FLAGSHIP = (8, 256, 256, 256, 1)
_RESIDUAL = {"lam_t": thermal_residual_simple, "lam_h": hydrogen_residual,
             "lam_o": oxygen_residual}
_GROUP_OF = {"thermal": "lam_t", "hydrogen": "lam_h", "oxygen": "lam_o"}


def member_seed(seed: int, e: int) -> int:
    """Member e's seed: ``RandomState([seed, e]).randint(0, 2**31 - 1)``."""
    return int(np.random.RandomState([int(seed), int(e)]).randint(0, 2**31 - 1))


def init_ensemble(seed: int, n_models: int, layers: Sequence[int] = FLAGSHIP,
                  device="cuda") -> Ensemble:
    """E fresh members: member e is ``init_pinn(layers)`` from
    ``torch.Generator().manual_seed(member_seed(seed, e))``; the λ's start at
    their initial values, stacked (E, k)."""
    dev = resolve_device(device)
    members = [init_pinn(layers, generator=torch.Generator().manual_seed(member_seed(seed, e)),
                         device=dev) for e in range(n_models)]
    ens: Ensemble = {"mlp": [p["mlp"] for p in members]}
    for g in LAMBDA_GROUPS:
        ens[g] = torch.stack([p[g] for p in members])
    return ens


def _member_devices(n: int, mesh: Optional[Mesh], axis: str) -> List[Optional[torch.device]]:
    """Member e's device: contiguous groups over the mesh axis (None: no mesh)."""
    if mesh is None or mesh.shape[axis] == 1:
        return [None] * n
    devices = mesh.axis_devices(axis)
    return [d for d, size in zip(devices, block_sizes(n, len(devices), 1)) for _ in range(size)]


def train_dnn_ensemble(
    ens: Ensemble, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int,
    mesh: Optional[Mesh] = None, lr: float = 0.01, dropout_p: float = 0.2,
) -> Tuple[Ensemble, torch.Tensor]:
    """Train every member's MLP through one DNN stage (``train_dnn_stage``:
    one training-kernel launch per flagship member on the card) with dropout
    seed ``member_seed(seed, e)``; with a mesh, member group g on the g-th
    device of its ``"data"`` axis.  Returns the ensemble with the trained MLPs
    (on x's device) and the losses (E, n_iter)."""
    dev = x.device
    mlps, losses = [], []
    for e, (mlp, d) in enumerate(zip(ens["mlp"], _member_devices(len(ens["mlp"]), mesh, "data"))):
        xe, ye, me = (x, y, mlp) if d is None else (x.to(d), y.to(d), to_device(mlp, d))
        res = train_dnn_stage(me, xe, ye, member_seed(seed, e), n_iter, lr=lr,
                              dropout_p=dropout_p)
        mlps.append(to_device(res.params, dev))
        losses.append(res.losses.to(dev))
    return {**ens, "mlp": mlps}, torch.stack(losses)


def train_dnn_ensemble_2d(
    ens: Ensemble, x: torch.Tensor, y: torch.Tensor, seed: int, n_iter: int, mesh: Mesh,
    lr: float = 0.01, dropout_p: float = 0.2,
) -> Tuple[Ensemble, torch.Tensor]:
    """Members over the mesh's ``"model"`` axis in contiguous groups, each
    member's rows over the ``"data"`` axis of its group, edge-padded to a
    multiple of its size as ``run_schedule(mesh=)`` pads them (padded rows
    count in the mean; the JAX package needs N to divide).  Member e's stage is the sharded DNN stage with the seed of
    ``train_dnn_ensemble``, so the result is that of the unsharded ensemble up
    to summation order; a data axis of size 1 runs ``train_dnn_stage``."""
    dev = x.device
    n_model = mesh.shape["model"]
    groups = [g for g, size in enumerate(block_sizes(len(ens["mlp"]), n_model, 1))
              for _ in range(size)]
    mlps, losses = [], []
    for e, (mlp, g) in enumerate(zip(ens["mlp"], groups)):
        devices = mesh.axis_devices("data", index=g)
        if len(devices) == 1:
            res = train_dnn_stage(to_device(mlp, devices[0]), x.to(devices[0]),
                                  y.to(devices[0]), member_seed(seed, e), n_iter, lr=lr,
                                  dropout_p=dropout_p)
            trained, trace = res.params, res.losses
        else:
            shards = shard_batch(mesh, pad_to_multiple(x, len(devices))[0],
                                 pad_to_multiple(y, len(devices))[0], index=g)
            trained, _, trace = train_dnn_chunk_sharded(
                to_device(mlp, devices[0]), None, shards, member_seed(seed, e), 0, n_iter,
                lr=lr, dropout_p=dropout_p)
        mlps.append(to_device(trained, dev))
        losses.append(trace.to(dev))
    return {**ens, "mlp": mlps}, torch.stack(losses)


def _stacked(lam: torch.Tensor) -> torch.Tensor:
    """(E, k) λ's → (k, 1, E): ``lam[i]`` is then a (1, E) row that broadcasts
    against an (N, 1) column, so a physics residual evaluates every member at
    once as (N, E)."""
    return lam.t().unsqueeze(1)


def _stacked_lambda_stage(per_member_loss, lam: torch.Tensor, group: str, n_iter: int,
                          lr: float, lr_step: int, lr_gamma: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step loop over stacked (E, k) λ's: per step each member's loss
    ``per_member_loss(λ)`` (E,), the gradient of their sum (member e's λ's get
    member e's gradient), Adam + StepLR and the box clamp, both elementwise.
    Returns (λ, losses (E, n_iter))."""
    lo, hi = (torch.as_tensor(b, device=lam.device) for b in LAMBDA_BOUNDS[group])
    lam = lam.detach().clone()
    state = adam_init(lam)
    losses = []
    for _ in range(n_iter):
        var = lam.detach().requires_grad_(True)
        per = per_member_loss(var)
        (g,) = torch.autograd.grad(per.sum(), var)
        lam2, state = adam_step(lam, g.detach(), state, lr, lr_step, lr_gamma)
        lam = torch.clamp(lam2, lo, hi)
        losses.append(per.detach())
    return lam, torch.stack(losses, dim=1)


def train_pinn_ensemble(
    ens: Ensemble, x: torch.Tensor, y: torch.Tensor, seed: int, scaler_x: AffineScaler,
    scaler_y: AffineScaler, schedule=None, dropout_p: float = 0.2,
) -> Tuple[Ensemble, Dict[str, torch.Tensor]]:
    """The whole staged schedule for every member: each DNN stage per member
    (seed ``member_seed(dnn_stage_seed(seed, k), e)``), each λ stage once for all
    members over the stacked λ's (``_stacked_lambda_stage``; the voltage stage
    with every member's eval-mode prediction, (N, E)).  Returns (the trained
    ensemble, {"k:stage": losses (E, n_iter)})."""
    from pinnfc_tpu_torch.config import default_schedule

    schedule = default_schedule() if schedule is None else schedule
    ens = dict(ens)
    losses: Dict[str, torch.Tensor] = {}
    scale_y, min_y = scaler_y.loss_affine()
    for k, stage in enumerate(schedule):
        hp = dict(lr=stage.lr, lr_step=stage.lr_step, lr_gamma=stage.lr_gamma)
        if stage.name == "dnn":
            results = [train_dnn_stage(mlp, x, y, member_seed(dnn_stage_seed(seed, k), e),
                                       stage.n_iter, dropout_p=dropout_p, **hp)
                       for e, mlp in enumerate(ens["mlp"])]
            ens["mlp"] = [r.params for r in results]
            losses[f"{k}:dnn"] = torch.stack([r.losses for r in results])
            continue
        if stage.name == "lambda_v":
            with torch.no_grad():
                u = torch.cat([mlp(x)[0] for mlp in ens["mlp"]], dim=1)  # (N, E)

            def per_member(lam, u=u, dnn_para=stage.dnn_para):
                v = voltage_residual(_stacked(lam), x, u, scaler_x, scaler_y)
                if dnn_para:
                    return torch.mean(v.f**2, dim=0)
                return torch.mean((y - (v.v_out_est_stack * scale_y + min_y)) ** 2, dim=0)

            group = "lam_v"
        elif stage.name in _GROUP_OF:
            group = _GROUP_OF[stage.name]

            def per_member(lam, residual=_RESIDUAL[group]):
                return torch.mean(residual(_stacked(lam), x, scaler_x).f ** 2, dim=0)
        else:
            raise ValueError(f"unknown stage '{stage.name}'")
        ens[group], losses[f"{k}:{stage.name}"] = _stacked_lambda_stage(
            per_member, ens[group], group, stage.n_iter, **hp)
    return ens, losses


@torch.no_grad()
def ensemble_predict(ens: Ensemble, x: torch.Tensor) -> torch.Tensor:
    """(E, N, 1) eval-mode predictions, member by member."""
    return torch.stack([mlp(x)[0] for mlp in ens["mlp"]])


@torch.no_grad()
def mc_dropout_sharded(
    mlp: MLP, x: torch.Tensor, seed: int, mesh: Mesh, mc_times: int = 2000,
    dropout: float = 0.4, chunk: int = 100,
) -> Tuple[MCSamples, int]:
    """MC dropout with x's rows split over the mesh's ``"data"`` axis at
    multiples of 256 rows (empty pieces dropped), each piece on its device,
    the statistics gathered on x's device: (statistics, passes run).

    The flagship runs the MC kernel once per piece (``mc_dropout_sums`` with
    the piece's first mask block), so the statistics equal the unsharded
    kernel's bit for bit.  (The JAX package refuses its single-core Pallas
    kernel on a mesh and samples with ``vmap``; the port's kernel has no such
    limit.)  Any other topology runs ``mc_dropout_samples`` per piece with
    ``torch.Generator(device).manual_seed(member_seed(seed, k))`` and one
    chunk size for all pieces (that of the largest), so every piece runs the
    same passes; its statistics agree with an unsharded run's in distribution
    only, as ``mc_dropout_samples`` already does with the JAX sampler's."""
    devices = mesh.axis_devices("data")
    sizes = block_sizes(x.shape[0], len(devices), MASK_BLOCK)
    shards = split_rows([x], sizes, devices)
    mlps = replicate(mesh, mlp)
    if mlp.is_flagship():
        sums = [mc_dropout_sums(m, x_k, seed, mc_times, dropout, block0=off // MASK_BLOCK)
                for m, (x_k,), off in zip(mlps, shards.parts, shards.offsets)]
        return finish_mc_stats(gather_rows(sums).to(x.device), mc_times), int(mc_times)
    chunk, n_chunks = mc_chunking(mc_times, max(sizes), chunk)
    outs = []
    for k, (m, (x_k,)) in enumerate(zip(mlps, shards.parts)):
        gen = torch.Generator(x_k.device).manual_seed(member_seed(seed, k))
        outs.append(mc_dropout_samples(m, x_k, gen, mc_times, dropout, chunk=chunk)[0])
    stats = MCSamples(*(gather_rows([o[i] for o in outs]).to(x.device) for i in range(3)))
    return stats, n_chunks * chunk

