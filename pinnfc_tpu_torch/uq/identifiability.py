"""Identifiability of the 17 physics parameters (λ's) (counterpart of
``pinnfc_tpu/uq/identifiability.py``).

The reference identifies its λ's by gradient descent (01:966-1399) and never
asks how well.  At the trained optimum, the curvature of each stage's own
loss gives:

* a Gauss-Newton 95 % confidence interval per parameter
  (``Cov(λ) ≈ σ̂²(JᵀJ)⁻¹``, ``J = ∂r/∂λ``, ``σ̂² = Σr²/(N−k)``);
* a sensitivity per parameter (RMS of its Jacobian column);
* an unidentifiable flag for a zero Jacobian column: the reference's dead
  parameters, λ4 of the voltage group (the upstream ``lambda_3`` name
  shadowing, 01:468) and the reserved λ4 of the gas groups, come out as
  exactly zero columns;
* an at-bound flag where the box clamp (01:1040-1047 etc.) is active.

The residual vector per group is the one its training stage minimizes:
``voltage_residual(...).f`` for λV (the ``dnn_para=True`` stage, 01:1029) and
``thermal_residual_simple``/``hydrogen_residual``/``oxygen_residual(...).f``.
Residual and Jacobian run on the device in float32: forward mode over the
group's 4-5 λ's (``torch.func.jacfwd``), one read per group; the k×k algebra
runs in float64 on the host.  With a mesh, the rows split over its ``"data"``
axis (edge rows appended to a multiple of its size) and each shard's
residuals and Jacobian are taken on its device with a copy of the params and
scalers there, one read per shard and group; the pad rows are trimmed before
the interval math, so σ̂² and the degrees of freedom never see them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, LAMBDA_NAMES
from pinnfc_tpu_torch.parallel.mesh import Mesh, data_size, pad_to_multiple, replicate, shard_batch
from pinnfc_tpu_torch.physics.hydrogen import hydrogen_residual
from pinnfc_tpu_torch.physics.oxygen import oxygen_residual
from pinnfc_tpu_torch.physics.thermal import thermal_residual_simple
from pinnfc_tpu_torch.physics.voltage import voltage_residual


class GroupIdentifiability(NamedTuple):
    """Per-λ-group identifiability report (arrays of length k)."""

    group: str
    names: Tuple[str, ...]
    values: np.ndarray
    stderr: np.ndarray  # inf where unidentifiable
    ci_lo: np.ndarray
    ci_hi: np.ndarray
    sensitivity: np.ndarray  # RMS ∂r/∂λ_j over the N residuals
    identifiable: np.ndarray  # bool — non-zero Jacobian column
    at_bound: np.ndarray  # bool — box clamp active at the optimum
    n_residuals: int  # finite rows that informed the interval
    n_dropped: int  # rows dropped as non-finite at this λ
    dof: int
    sigma2: float  # σ̂² residual variance estimate
    # (k, k) estimate correlation matrix: |corr| → 1 means the two parameters
    # are only jointly identified; NaN rows/cols for unidentifiable params
    corr: np.ndarray


def gauss_newton_ci(
    r: np.ndarray,
    jac: np.ndarray,
    z: float = 1.959964,
    sens_rtol: float = 1e-9,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, float, int, np.ndarray]:
    """Gauss-Newton interval math in float64: residuals (N,) + Jacobian
    (N, k) → (stderr, sensitivity, identifiable, dof, σ̂², n_used, corr).

    Rows whose residual or Jacobian is non-finite (the physics is undefined
    there at this λ) are dropped first.  Columns whose RMS sensitivity is at
    most ``sens_rtol`` × the largest are excluded from the normal matrix
    (stderr +inf); the reduced JᵀJ is inverted by pseudo-inverse."""
    r = np.asarray(r, np.float64).ravel()
    jac = np.asarray(jac, np.float64).reshape(r.shape[0], -1)
    finite = np.isfinite(r) & np.isfinite(jac).all(axis=1)
    r, jac = r[finite], jac[finite]
    if r.shape[0] == 0:
        raise ValueError(
            "every residual row is non-finite at this λ — nothing to "
            "analyze (is the model trained?)"
        )
    n, k = jac.shape
    sens = np.sqrt(np.mean(jac**2, axis=0))
    identifiable = sens > max(sens.max(), 0.0) * sens_rtol
    k_id = int(identifiable.sum())
    dof = max(n - k_id, 1)
    sigma2 = float(np.sum(r**2) / dof)
    stderr = np.full(k, np.inf)
    corr = np.full((k, k), np.nan)
    if k_id:
        j_id = jac[:, identifiable]
        cov = sigma2 * np.linalg.pinv(j_id.T @ j_id)
        se_id = np.sqrt(np.maximum(np.diag(cov), 0.0))
        stderr[identifiable] = se_id
        denom = np.outer(se_id, se_id)
        with np.errstate(invalid="ignore", divide="ignore"):
            c_id = np.where(denom > 0, cov / denom, np.nan)
        idx = np.flatnonzero(identifiable)
        corr[np.ix_(idx, idx)] = np.clip(c_id, -1.0, 1.0)
    return stderr, sens, identifiable, dof, sigma2, n, corr


def _residual_fn(group: str, params, x_norm: torch.Tensor, scaler_x, scaler_y):
    """The residual vector each training stage minimizes, as a function of
    that stage's λ alone (everything else frozen, as in the staged
    optimization)."""
    if group == "lam_v":
        with torch.no_grad():
            u_pred, _ = params["mlp"](x_norm)

        def r_fn(lam):
            return voltage_residual(lam, x_norm, u_pred, scaler_x, scaler_y).f.reshape(-1)

        return r_fn
    residual = {
        "lam_t": thermal_residual_simple,
        "lam_h": hydrogen_residual,
        "lam_o": oxygen_residual,
    }[group]

    def r_fn(lam):
        return residual(lam, x_norm, scaler_x).f.reshape(-1)

    return r_fn


def residual_and_jacobian(group: str, params, x_norm: torch.Tensor, scaler_x, scaler_y):
    """(r (N,), J (N, k)) of ``group`` at its trained λ, on the λ's device:
    forward mode, one tangent per λ."""
    fn = _residual_fn(group, params, x_norm, scaler_x, scaler_y)
    lam = params[group].detach()
    return fn(lam), torch.func.jacfwd(fn)(lam)


def lambda_identifiability(
    params,
    x_norm,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
    groups: Sequence[str] = ("lam_v", "lam_t", "lam_h", "lam_o"),
    z: float = 1.959964,
    bound_rtol: float = 1e-4,
    mesh: Optional[Mesh] = None,
) -> Dict[str, GroupIdentifiability]:
    """Identifiability report for every λ group at the trained optimum.

    ``x_norm`` are normalized input rows (the domain the stages trained on),
    numpy or a tensor; they go to the device of ``params``.  One residual and
    Jacobian evaluation per group on that device; interval math on the
    host.  With ``mesh``, the rows split over its ``"data"`` axis; a data
    axis of size 1 takes the unsharded path."""
    dev = params[groups[0]].device
    if isinstance(x_norm, np.ndarray):
        x_norm = torch.from_numpy(np.array(x_norm, np.float32))
    n = int(x_norm.shape[0])
    if data_size(mesh) > 1:
        for d in mesh.axis_devices("data"):
            resolve_device(d)
        x_pad, _ = pad_to_multiple(x_norm.to(dtype=torch.float32), mesh.shape["data"])
        pieces = [((p, scaler_x.to(x.device), scaler_y.to(x.device)), x)
                  for p, x in zip(replicate(mesh, params), shard_batch(mesh, x_pad).array(0))]
    else:
        pieces = [((params, scaler_x, scaler_y), x_norm.to(device=dev, dtype=torch.float32))]
    out: Dict[str, GroupIdentifiability] = {}
    for group in groups:
        rjs = []
        for (p, sx, sy), x in pieces:  # every shard launched before the first read
            r, jac = residual_and_jacobian(group, p, x, sx, sy)
            rjs.append(torch.cat([r[:, None], jac], dim=1))
        rj = np.concatenate([a.cpu().numpy() for a in rjs])[:n]  # one read per shard
        r, jac = rj[:, 0], rj[:, 1:]
        stderr, sens, identifiable, dof, sigma2, n_used, corr = gauss_newton_ci(r, jac, z)
        lam = params[group].detach().cpu().numpy().astype(np.float64).ravel()
        lo, hi = LAMBDA_BOUNDS[group]
        span = np.maximum(np.abs(np.asarray(hi) - np.asarray(lo)), 1e-30)
        at_bound = ((np.abs(lam - np.asarray(lo)) <= bound_rtol * span)
                    | (np.abs(lam - np.asarray(hi)) <= bound_rtol * span))
        out[group] = GroupIdentifiability(
            group=group,
            names=LAMBDA_NAMES[group],
            values=lam,
            stderr=stderr,
            ci_lo=lam - z * stderr,
            ci_hi=lam + z * stderr,
            sensitivity=sens,
            identifiable=identifiable,
            at_bound=np.asarray(at_bound, bool),
            n_residuals=n_used,
            n_dropped=int(r.shape[0]) - n_used,
            dof=dof,
            sigma2=sigma2,
            corr=corr,
        )
    return out
