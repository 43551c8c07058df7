"""Deep-ensemble epistemic uncertainty (counterpart of
``pinnfc_tpu/uq/deep_ensemble.py``).

The E member heads of an ensemble (``parallel/ensemble.py``) are taken as an
equal-weight Gaussian mixture, whose moments decompose as

    pred_mean      = mean_e  mu_e
    aleatoric_std  = sqrt( mean_e  exp(log_var_e) )      (within-member)
    epistemic_std  = sqrt( pop-var_e  mu_e )             (between-member)

(Lakshminarayanan et al., NeurIPS 2017), with the epistemic variance in the
centred form (E[mu²] − mean² cancels in float32 when members agree) and the
population variance of the MC sampler.  The result is the same ``MCSamples``
bundle as MC dropout's, normalized domain, (N,).

One eval pass per member, no sampling: the members' weights are stacked
(``torch.func.stack_module_state``) and one ``torch.vmap`` of the eval forward
runs them as batched products, the counterpart of the JAX package's ``vmap``
(which runs outside any Pallas kernel).
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch

from pinnfc_tpu_torch.parallel.mesh import (
    Mesh, gather_rows, pad_to_multiple, replicate, shard_batch)
from pinnfc_tpu_torch.uq.mc_dropout import MCSamples


def _member_heads(mlps, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, N) eval-mode (mean, log_var) of every member, one vmapped forward."""
    params, buffers = torch.func.stack_module_state(list(mlps))
    skeleton = copy.deepcopy(mlps[0]).to("meta")

    def one(p, b):
        return torch.func.functional_call(skeleton, (p, b), (x,))

    mu, log_var = torch.vmap(one)(params, buffers)
    return mu[..., 0], log_var[..., 0]


@torch.no_grad()
def ensemble_moments(ens, x: torch.Tensor) -> MCSamples:
    """Mixture-moment UQ of an ensemble (``{"mlp": [MLP] * E, ...}``) on x's
    rows, normalized domain, each (N,)."""
    mu, log_var = _member_heads(ens["mlp"], x)
    mean = torch.mean(mu, dim=0)
    ale_var = torch.mean(torch.exp(log_var), dim=0)
    epi_var = torch.mean((mu - mean[None, :]) ** 2, dim=0)
    return MCSamples(pred_mean=mean, aleatoric_std=torch.sqrt(ale_var),
                     epistemic_std=torch.sqrt(epi_var))


@torch.no_grad()
def ensemble_moments_sharded(ens, x: torch.Tensor, mesh: Mesh) -> MCSamples:
    """``ensemble_moments`` with x's rows edge-padded to a multiple of the
    mesh's ``"data"`` axis and split evenly over its devices, every device
    holding all members; the statistics are gathered on x's device and the
    padding trimmed (every statistic is per row)."""
    x_pad, n0 = pad_to_multiple(x, mesh.shape["data"])
    shards = shard_batch(mesh, x_pad)
    members = replicate(mesh, list(ens["mlp"]))
    parts = [ensemble_moments({"mlp": m}, x_k) for m, (x_k,) in zip(members, shards.parts)]
    return MCSamples(*(gather_rows([p[i] for p in parts], n0).to(x.device) for i in range(3)))
