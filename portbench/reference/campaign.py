"""A scored campaign's 22-column artifact, worked out from the raw campaign
(reference script 01: ``create_comprehensive_results_array_v2``, 01:1877-2010;
the loader's normalisation, 01:190-386; the physics models ``net_f_V``,
``net_f_T_simple``, ``net_f_H``, ``net_f_O``, 01:535-914).

The scalers are sklearn's ``MinMaxScaler(feature_range=(-1, 1))`` fitted in
float32 on the normal rows; the network's inputs are the float32 scaled rows.
MC dropout runs in ``mlp.mc_sums``; everything after it is float64.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import mlp
from portbench.reference.rounding import Rounding

# physical constants (net_f_V 01:729-750, net_f_H 01:633-664, net_f_O 01:546-550)
A_CELL, N_CELLS, F_CONST, R_GAS = 270.0, 5.0, 96485.0, 8.314
V_MOLAR, O2_FRACTION, ALPHA, GF_LIQ, TC_REF, KELVIN = 22.4, 0.21, 0.5, -220170.0, 55.0, 273.15
I_NORM = 100.0


def fit_minmax(data: np.ndarray) -> Dict[str, np.ndarray]:
    """float32 MinMax(-1, 1) statistics of ``data`` (rows, features): scale,
    min, data_min, data_max (a zero range divides by 1)."""
    data = np.asarray(data, np.float32)
    lo = data.min(axis=0)
    hi = data.max(axis=0)
    rng = hi - lo
    scale = np.float32(2.0) / np.where(rng == 0, np.float32(1.0), rng)
    return {"scale": scale, "min": np.float32(-1.0) - lo * scale, "data_min": lo,
            "data_max": hi}


def scaled(data: np.ndarray, s: Dict[str, np.ndarray]) -> np.ndarray:
    """float32 rows of ``data`` (float64) through the scaler."""
    return np.asarray(np.asarray(data, np.float64) * s["scale"] + s["min"], np.float32)


def campaign_arrays(normal, faults) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(x (N, 8), y (N,), cumulative segment ends) of a campaign: the normal
    rows, then each fault segment in load order."""
    xs = [np.asarray(normal[0], np.float64)] + [np.asarray(f[0], np.float64) for f in faults]
    ys = [np.asarray(normal[1], np.float64).reshape(-1)]
    ys += [np.asarray(f[1], np.float64).reshape(-1) for f in faults]
    ends = list(np.cumsum([len(a) for a in xs]))
    return np.vstack(xs), np.concatenate(ys), [int(e) for e in ends]


def saturation_pressure() -> float:
    x = -2.1794 + 0.02953 * TC_REF - 9.1837e-5 * TC_REF**2 + 1.4454e-7 * TC_REF**3
    return 10.0**x


def residuals(real: torch.Tensor, v_stack: torch.Tensor, lam: Dict[str, Sequence[float]]
              ) -> Dict[str, torch.Tensor]:
    """The four physics models on real-unit rows ``real`` (N, 8) and the
    network's stack voltage ``v_stack`` (N,), float64: each residual and the
    physics outputs the artifact keeps.  The λ's are numbers or tensors (a
    λ stage takes the gradient through them)."""
    lv, lt, lh, lo = (lam[k] for k in ("lam_v", "lam_t", "lam_h", "lam_o"))
    cur, cool, t_in, p_h2g, p_airg, t_out, h2, air = real.unbind(1)

    # voltage (net_f_V, 01:724-765)
    i = cur / A_CELL + 1e-5
    tk = t_out + KELVIN
    p_h2o = saturation_pressure()
    pp_h2 = 0.5 * ((p_h2g / 101.0 + 1.0) / torch.exp(1.653 * i / tk**1.334) - p_h2o)
    pp_o2 = (p_airg / 101.0 + 1.0) / torch.exp(4.192 * i / tk**1.334) - p_h2o
    b = R_GAS * tk / (2.0 * ALPHA * F_CONST)
    v_act = -b * torch.log(i / lv[1])
    v_ohm = -i * lv[0]
    v_conc = ALPHA * b * torch.log(1.0 - i / lv[2])
    e_nernst = -GF_LIQ / (2 * F_CONST) - R_GAS * tk * torch.log(
        p_h2o / (pp_h2 * torch.sqrt(pp_o2))) / (2 * F_CONST)
    v_est = e_nernst + v_act + v_ohm + v_conc

    # thermal, simple model (net_f_T_simple, 01:869-914)
    t_pred = lt[0] * ((cur / A_CELL + 1e-6) * A_CELL) + lt[2] * (cool + 1e-6) + 0.5 * t_in + lt[4]

    # hydrogen (net_f_H, 01:621-722)
    i_tot = (cur / A_CELL + 1e-5) * A_CELL
    q_h = torch.clamp_min(i_tot / (2 * F_CONST) * N_CELLS * V_MOLAR * 60.0, 1e-8)
    target_h = torch.where(i_tot <= lh[2], lh[0] + lh[1] * i_tot / I_NORM,
                           lh[0] + lh[1] * lh[2] / I_NORM)
    ratio_h = (h2 + 1e-6) / q_h

    # oxygen (net_f_O, 01:535-619)
    q_o = torch.clamp_min(i_tot * N_CELLS / (4 * F_CONST) * V_MOLAR * 60.0, 1e-8)
    knee = abs(lo[2])
    target_o = torch.where(i_tot <= knee, lo[0] + lo[1] * i_tot / I_NORM,
                           lo[0] + lo[1] * knee / I_NORM)
    target_o = torch.clamp(target_o, 1.05, 15.0)
    ratio_o = (air + 1e-6) * O2_FRACTION / q_o
    return {"f_v": v_est - v_stack / N_CELLS, "f_t": t_out - t_pred,
            "f_h": ratio_h - target_h,
            "f_o": ratio_o - target_o + torch.clamp_min(1.0 - ratio_o, 0.0) * 10.0,
            "v_phys": v_est * N_CELLS, "t_phys": t_pred, "ratio_h": ratio_h,
            "ratio_o": ratio_o}


def centred_mean(values: np.ndarray, window: int) -> np.ndarray:
    """pandas ``rolling(window, center=True, min_periods=1).mean()``: the mean
    over rows i − w//2 .. i + (w − 1)//2 that exist."""
    n = len(values)
    out = np.empty(n)
    for i in range(n):
        lo, hi = max(0, i - window // 2), min(n, i + (window - 1) // 2 + 1)
        out[i] = values[lo:hi].mean()
    return out


def smooth(values: np.ndarray, ends: Sequence[int], window: int) -> np.ndarray:
    """``centred_mean`` within each segment (01:1848-1872)."""
    out, start = np.empty(len(values)), 0
    for end in ends:
        out[start:end] = centred_mean(values[start:end], window)
        start = end
    return out


def artifact(weights, lam: Dict[str, Sequence[float]], normal, faults, mc_seed: int,
             passes: int, p: float, window: int, device,
             rounding: Dict[str, Rounding]) -> np.ndarray:
    """The (N, 22) float64 artifact of scoring the raw campaign (normal,
    faults) with ``passes`` MC-dropout passes at rate p, masks keyed by
    ``mc_seed``.  ``rounding`` by part: ``mc_base_products`` the eval pass's
    products, ``mc_sample_products`` the dropout passes' (see
    ``mlp.mc_sums``), ``post_precision`` every column after MC dropout, its
    float64 value rounded once (None: each as it is)."""
    x, y, ends = campaign_arrays(normal, faults)
    sx, sy = fit_minmax(normal[0]), fit_minmax(np.asarray(normal[1]).reshape(-1, 1))
    xs = scaled(x, sx)
    ys = scaled(y.reshape(-1, 1), sy)[:, 0]
    x_dev = torch.as_tensor(xs, device=device)
    sums = mlp.mc_sums(weights, x_dev, mc_seed, passes, p, rounding["mc_sample_products"],
                       rounding["mc_base_products"])
    base, ale, epi = (t.cpu().numpy() for t in mlp.mc_stats(sums, passes))

    f64 = np.float64
    # the de-normalisation of the exporter (01:1920-1932)
    scale_y = 2.0 / (f64(sy["data_max"][0]) - f64(sy["data_min"][0]) + 1e-12)
    min_y = -1.0 - f64(sy["data_min"][0]) * scale_y
    real = (xs.astype(f64) - sx["min"].astype(f64)) / sx["scale"].astype(f64)
    y_real = (ys.astype(f64) - f64(sy["min"][0])) / f64(sy["scale"][0])
    pred_real = (base - min_y) / (scale_y + 1e-12)
    v_net = (base - f64(sy["min"][0])) / f64(sy["scale"][0])
    res = residuals(torch.as_tensor(real), torch.as_tensor(v_net), lam)

    n = len(x)
    labels = np.zeros(n)
    for k in range(len(ends) - 1):
        labels[ends[k]:ends[k + 1]] = k + 1
    out = np.zeros((n, 22))
    out[:, 0:8] = real
    out[:, 8] = y_real
    out[:, 9] = pred_real
    out[:, 10] = smooth(ale / (scale_y + 1e-12), ends, window)
    out[:, 11] = smooth(epi / (scale_y + 1e-12), ends, window)
    out[:, 12] = y_real - pred_real
    for c, key in zip(range(13, 17), ("f_v", "f_t", "f_h", "f_o")):
        out[:, c] = res[key].numpy()
    out[:, 17] = labels
    for c, key in zip(range(18, 22), ("v_phys", "t_phys", "ratio_h", "ratio_o")):
        out[:, c] = res[key].numpy()
    post = rounding["post_precision"]
    if post is not None:
        cols = [c for c in range(22) if c != 17]
        out[:, cols] = post(torch.as_tensor(out[:, cols], dtype=torch.float32)).double().numpy()
    return out
