"""Input-channel saliency of the trained PINN (counterpart of
``pinnfc_tpu/uq/saliency.py``): per sample, how sensitive the voltage
prediction and its aleatoric σ are to each of the 8 measured inputs
(``data/contract.py::INPUT_CHANNELS``, 01:2162-2169).

Every sample's output depends only on its own input row (the trunk is
row-wise), so the gradient of each head's batch SUM with respect to the
normalized inputs is the per-sample Jacobian stack (N, 8): one forward pass
and two backward passes for the whole batch, on the device, in float32 with
TF32 off.

The model works in the MinMax-normalized domain (01:271-274).  The report
carries three calibrations, computed in float64 on the host:

* ``jac_norm``  — ∂v_norm/∂x_norm, the model's own view;
* ``jac_phys``  — ∂v_phys/∂x_phys by the affine chain rule;
* ``jac_range`` — ∂v_phys/∂x_phys × the channel's training range: volts of
  predicted swing per full-range swing of the channel, comparable across
  channels.

With a mesh, the rows split over its ``"data"`` axis (edge rows appended to a
multiple of its size, trimmed on the host after one read per device) and
each shard's Jacobians are taken on its device with a copy of the MLP there:
a Jacobian row depends on its own input row only, so the shards never meet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.data.contract import INPUT_CHANNELS
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.parallel.mesh import Mesh, data_size, pad_to_multiple, replicate, shard_batch


class SaliencyReport(NamedTuple):
    """Per-sample input-saliency stacks (all (N, 8) float32 numpy)."""

    channel_names: Tuple[str, ...]
    jac_norm: np.ndarray  # ∂v̂_norm/∂x_norm — dimensionless
    jac_phys: np.ndarray  # ∂v̂_phys/∂x_phys — volts per channel unit
    jac_range: np.ndarray  # volts per full training-range swing
    sigma_jac_range: np.ndarray  # same calibration for aleatoric σ
    labels: Optional[np.ndarray] = None  # (N,) int, when known


def _head_jacobians(mlp, x_norm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 8) normalized-domain Jacobians of the mean head and of the
    aleatoric σ = exp(0.5·logvar) (the exporter's convention), from one eval
    forward."""
    x = x_norm.detach().requires_grad_(True)
    with torch.enable_grad():
        mean, log_var = mlp(x)
        jac_v, = torch.autograd.grad(mean.sum(), x, retain_graph=True)
        jac_s, = torch.autograd.grad(torch.exp(0.5 * log_var).sum(), x)
    return jac_v, jac_s


def _sharded_jacobians(mlp, x_norm: np.ndarray, mesh: Mesh):
    """``_head_jacobians`` of the rows of ``x_norm`` (N, 8) split over the
    mesh's ``"data"`` axis: every shard launched before the first read, one
    read per shard, the pad rows trimmed on the host."""
    for d in mesh.axis_devices("data"):
        resolve_device(d)
    x_pad, n = pad_to_multiple(np.asarray(x_norm, np.float32), mesh.shape["data"])
    shards = shard_batch(mesh, torch.from_numpy(x_pad))
    jacs = [torch.stack(_head_jacobians(m, x)) for m, x in zip(replicate(mesh, mlp),
                                                                 shards.array(0))]
    jac = np.concatenate([j.cpu().numpy() for j in jacs], axis=1)[:, :n]
    return jac[0], jac[1]


def input_saliency(
    params,
    x_phys: np.ndarray,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
    labels: Optional[np.ndarray] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> SaliencyReport:
    """Saliency report over physical-domain rows ``x_phys`` (N, 8), on
    ``device`` (where ``params`` must live).

    Chain rule through the frozen affine scalers: ``x_norm = x·s_x + m_x``
    and ``v_phys = (v_norm − m_y)/s_y`` give ``∂v_phys/∂x_phys =
    (s_x/s_y)·∂v_norm/∂x_norm``; the range calibration multiplies by the
    training span ``data_max − data_min`` (0 for a channel that was constant
    in training).  With ``mesh``, the rows split over its ``"data"`` axis; a
    data axis of size 1 takes the unsharded path."""
    x_phys = np.asarray(x_phys, np.float32)
    if x_phys.ndim != 2 or x_phys.shape[1] != len(INPUT_CHANNELS):
        raise ValueError(f"x_phys must be (N, {len(INPUT_CHANNELS)}); got {x_phys.shape}")
    mlp = params["mlp"] if isinstance(params, dict) and "mlp" in params else params
    if data_size(mesh) > 1:
        jac_v, jac_s = _sharded_jacobians(mlp, scaler_x.transform(x_phys), mesh)
    else:
        x_norm = torch.as_tensor(scaler_x.transform(x_phys), device=resolve_device(device))
        jac_v, jac_s = _head_jacobians(mlp, x_norm)
        jac_v, jac_s = torch.stack([jac_v, jac_s]).cpu().numpy()  # one read

    s_x = scaler_x.scale.cpu().numpy().astype(np.float64)
    s_y = float(scaler_y.scale.cpu().numpy().astype(np.float64).ravel()[0])
    span = (scaler_x.data_max.cpu().numpy().astype(np.float64)
            - scaler_x.data_min.cpu().numpy().astype(np.float64))

    jac_phys = jac_v * (s_x / s_y)[None, :]
    jac_range = jac_phys * span[None, :]
    sigma_jac_range = jac_s * (s_x / s_y)[None, :] * span[None, :]
    return SaliencyReport(
        channel_names=INPUT_CHANNELS,
        jac_norm=jac_v,
        jac_phys=np.asarray(jac_phys, np.float32),
        jac_range=np.asarray(jac_range, np.float32),
        sigma_jac_range=np.asarray(sigma_jac_range, np.float32),
        labels=None if labels is None else np.asarray(labels, int),
    )


def class_mean_saliency(report: SaliencyReport,
                        field: str = "jac_range") -> Dict[int, np.ndarray]:
    """Mean |saliency| per label → {label: (8,)}.  Requires labels."""
    if report.labels is None:
        raise ValueError("report carries no labels — pass labels to input_saliency")
    jac = np.abs(getattr(report, field))
    return {int(lbl): jac[report.labels == lbl].mean(axis=0) for lbl in np.unique(report.labels)}


def coarse_class_saliency(report: SaliencyReport,
                          field: str = "jac_range") -> Dict[str, np.ndarray]:
    """Mean |saliency| per coarse class → {name: (8,)}: 'normal' (label 0)
    plus the four fault families of ``FAULT_RANGE_MAP`` (04:75-80) under
    their English names.  Classes absent from the rows are omitted."""
    from pinnfc_tpu_torch.config import FAULT_NAMES_EN, FAULT_RANGE_MAP

    if report.labels is None:
        raise ValueError("report carries no labels — pass labels to input_saliency")
    jac = np.abs(getattr(report, field))
    out: Dict[str, np.ndarray] = {}
    mask = report.labels == 0
    if mask.any():
        out["normal"] = jac[mask].mean(axis=0)
    for zh, rng in FAULT_RANGE_MAP.items():
        mask = np.isin(report.labels, list(rng))
        if mask.any():
            out[FAULT_NAMES_EN.get(zh, zh)] = jac[mask].mean(axis=0)
    return out
