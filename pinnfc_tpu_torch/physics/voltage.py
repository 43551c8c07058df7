"""Electrochemical voltage residual (counterpart of ``pinnfc_tpu/physics/voltage.py``;
reference net_f_V, 01:724-765).

Polarization model: Nernst potential + activation + ohmic + concentration
losses, with λ_V = (r, i0, i_l, reserved).  The DNN output is detached, so a
physics loss reaches only the λ's.  Rows where i > i_l give NaN (log of a
negative number), as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.physics import constants as C


class VoltageOutputs(NamedTuple):
    """Return bundle of net_f_V (01:765)."""

    f: torch.Tensor  # residual V_est - V_out (per cell)
    v_act: torch.Tensor
    v_ohmic: torch.Tensor
    v_conc: torch.Tensor
    e_nernst: torch.Tensor
    v_out_est_stack: torch.Tensor  # physics stack voltage estimate (×5)
    i: torch.Tensor  # current density [A/cm²]
    il: torch.Tensor
    v_out_stack: torch.Tensor  # measured/DNN stack voltage (×5)


def voltage_residual(
    lam_v: torch.Tensor,
    x_norm: torch.Tensor,
    u_norm: torch.Tensor,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
    stop_grad_u: bool = True,
) -> VoltageOutputs:
    """x_norm (N, 8) and u_norm (N, 1) normalized; lam_v (4,)."""
    real = scaler_x.inverse(x_norm)
    if stop_grad_u:
        u_norm = u_norm.detach()
    v_out = scaler_y.inverse(u_norm) / C.N_CELLS  # per-cell voltage

    i = real[:, 0:1] / C.A_CELL + 1e-5
    t_out = real[:, 5:6]
    # gauge pressures divided by 101 (01:746-747)
    p_h2 = real[:, 3:4] / 101.0 + 1.0
    p_air = real[:, 4:5] / 101.0 + 1.0

    r, i0, il = lam_v[0], lam_v[1], lam_v[2]

    tk = t_out + C.KELVIN
    p_h2o = C.saturation_pressure()
    pp_h2 = 0.5 * (p_h2 / torch.exp(1.653 * i / tk**1.334) - p_h2o)
    pp_o2 = p_air / torch.exp(4.192 * i / tk**1.334) - p_h2o
    b = C.R_GAS * tk / (2.0 * C.ALPHA * C.F_CONST)

    v_act = -b * torch.log(i / i0)
    v_ohmic = -(i * r)
    v_conc = C.ALPHA * b * torch.log(1.0 - (i / il))
    # torch computes x**0.5 as sqrt(x), NaN at -inf, where the JAX function's
    # pow gives +inf (a -inf air pressure reading): lift -inf to +inf first
    pp_o2 = torch.where(torch.isneginf(pp_o2), float("inf"), pp_o2)
    e_nernst = -C.GF_LIQ / (2.0 * C.F_CONST) - (
        (C.R_GAS * tk) * torch.log(p_h2o / (pp_h2 * pp_o2**0.5))
    ) / (2.0 * C.F_CONST)

    v_out_est = e_nernst + v_act + v_ohmic + v_conc
    return VoltageOutputs(
        f=v_out_est - v_out,
        v_act=v_act,
        v_ohmic=v_ohmic,
        v_conc=v_conc,
        e_nernst=e_nernst,
        v_out_est_stack=v_out_est * C.N_CELLS,
        i=i,
        il=il * torch.ones_like(i[:1]),
        v_out_stack=v_out * C.N_CELLS,
    )
