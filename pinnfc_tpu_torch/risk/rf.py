"""RF(t) risk function and early-warning index (counterpart of
``pinnfc_tpu/risk/rf.py``; reference script 04).

Pipeline (04:201-285): z-score the 5 residual channels against
normal-operation statistics → |z| → truncate below the safe band →
per-layer weighted p-norms → weighted layer sum S_tot → leaky integral
``C[t] = λ·C[t-1] + S[t]`` (with C[0] = 0, the loop starts at t=1) →
rescaled logistic map → EMA smoothing.

Two backends: 'torch' (float32, the chain on a device, the card by default;
the two recurrences as doubling scans, ``ops/recurrences.py``) and 'numpy'
(float64, the recurrences through ``scipy.signal.lfilter``, exact w.r.t. the
reference's sequential loops and bitwise equal to the JAX package's numpy
backend).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.config import DEFAULT_RF_CONDITIONS, FAULT_RANGE_MAP, RiskConfig
from pinnfc_tpu_torch.data.contract import INDEX, ComprehensiveResults
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.ops.recurrences import ema, leaky_integral

BACKENDS = ("torch", "numpy")


def estimate_mu_sigma_normal(
    results: np.ndarray,
    res_keys: Sequence[str] = RiskConfig.res_keys,
    normal_labels: Sequence[int] = (0,),
) -> Tuple[np.ndarray, np.ndarray]:
    """μ/σ (ddof=1, zero→1e-6 floor) of the residual channels over
    normal-labelled rows (04:181-197)."""
    results = np.asarray(results)
    labels = results[:, INDEX["label"]].astype(int)
    mask = np.isin(labels, list(normal_labels))
    if not mask.any():
        raise ValueError(f"no rows with normal labels {tuple(normal_labels)}")
    r = np.stack([results[mask, INDEX[k]].astype(float) for k in res_keys], axis=1)
    mu = np.nanmean(r, axis=0)
    sigma = np.nanstd(r, axis=0, ddof=1)
    sigma[sigma == 0] = 1e-6
    return mu, sigma


def _logistic_constants(config: RiskConfig) -> Tuple[float, float]:
    """(l_0, denom) of the rescaled logistic map (04:267-273)."""
    k, c0 = config.k_logistic, config.c0_logistic
    l_0 = 1.0 / (1.0 + math.exp(-k * (0.0 - c0)))
    l_max = 1.0 / (1.0 + math.exp(-k * (config.c_max - c0)))
    denom = (l_max - l_0) if (l_max - l_0) != 0 else 1e-6
    return l_0, denom


def compute_rf_time_series(
    residuals,
    mu: np.ndarray,
    sigma: np.ndarray,
    config: RiskConfig = RiskConfig(),
    backend: str = "torch",
    device="cuda",
) -> Dict:
    """RF over a residual matrix (N, D) with channel order = config.res_keys.

    Returns {'rf_inst', 'rf_smooth', 'c', 's_tot', 's_layers'} (04:281-285)
    as host numpy arrays.

    ``backend``: 'torch' (float32 on ``device``, one fetch to the host at the
    end) or 'numpy' (float64, ``scipy.signal.lfilter`` recurrences, exact
    w.r.t. the reference's sequential loops; ``device`` is not used).  The
    JAX package pads the rows to a power of two for XLA's compile cache; the
    torch chain compiles nothing, so it runs on the N rows as they are.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "numpy":
        return _compute_rf_numpy(residuals, mu, sigma, config)
    dev = resolve_device(device)
    r = torch.as_tensor(np.asarray(residuals, np.float32), device=dev)
    mu_t = torch.as_tensor(np.asarray(mu, np.float32), device=dev)
    sigma_t = torch.as_tensor(np.asarray(sigma, np.float32), device=dev)
    series = _rf_series_torch(r, mu_t, sigma_t, config)
    host = torch.stack(list(series.values())).cpu().numpy()  # the one fetch
    out = dict(zip(series, host))
    names = [name for name, _ in config.layer_config]
    return {
        "rf_inst": out["rf_inst"],
        "rf_smooth": out["rf_smooth"],
        "c": out["c"],
        "s_tot": out["s_tot"],
        "s_layers": {name: out[f"layer:{name}"] for name in names},
    }


def _rf_series_torch(r: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                     config: RiskConfig) -> Dict[str, torch.Tensor]:
    """The whole RF chain (04:234-279) in float32 on r's device: every series
    (N,), the layers' S under ``layer:<name>``."""
    n = r.shape[0]
    w_feat = torch.as_tensor(config.feature_weights, dtype=torch.float32, device=r.device)
    key_to_idx = {k: i for i, k in enumerate(config.res_keys)}
    layer_w = dict(config.layer_weights)

    # 1-2) |z|-score, safe-band truncation (04:234-238)
    a = torch.abs((r - mu[None, :]) / sigma[None, :])
    a_trunc = torch.clamp_min(a - config.z_safe, 0.0)

    # 3-4) per-layer weighted p-norm, weighted layer sum (04:244-259)
    s_layers: Dict[str, torch.Tensor] = {}
    s_tot = torch.zeros(n, dtype=torch.float32, device=r.device)
    for layer_name, keys in config.layer_config:
        idxs = [key_to_idx[k] for k in keys if k in key_to_idx]
        if not idxs:
            s_layers[layer_name] = torch.zeros_like(s_tot)
            continue
        a_l = a_trunc[:, idxs]
        w_l = w_feat[idxs][None, :]
        s_l = torch.pow(torch.sum(w_l * torch.pow(a_l, config.p_layer), dim=1),
                        1.0 / config.p_layer)
        s_layers[layer_name] = s_l
        s_tot = s_tot + layer_w.get(layer_name, 1.0) * s_l

    # 5) leaky integral with C[0] = 0 (loop starts at t=1, 04:262-264)
    s_shift = torch.cat([torch.zeros_like(s_tot[:1]), s_tot[1:]])
    c = leaky_integral(s_shift, config.lambda_decay)

    # 6) rescaled logistic map (04:267-273)
    c_clip = torch.clamp(c, 0.0, config.c_max)
    l_0, denom = _logistic_constants(config)
    k, c0 = config.k_logistic, config.c0_logistic
    rf_inst = (1.0 / (1.0 + torch.exp(-k * (c_clip - c0))) - l_0) / denom
    rf_inst = torch.clamp(rf_inst, 0.0, 1.0)

    # 7) EMA smoothing seeded with rf_inst[0] (04:276-279)
    rf_smooth = ema(rf_inst, config.alpha_smooth)

    series = {"rf_inst": rf_inst, "rf_smooth": rf_smooth, "c": c, "s_tot": s_tot}
    series.update({f"layer:{name}": s for name, s in s_layers.items()})
    return series


def _leaky_integral_f64(s: np.ndarray, lam: float) -> np.ndarray:
    """C[t] = λ·C[t-1] + S[t] with C[0] = 0 (the loop starts at t=1,
    04:262-264) ≡ IIR filter b=[1], a=[1, -λ] on S with S[0] zeroed —
    exact f64, shared by the numpy backend and the per-layer attribution."""
    from scipy.signal import lfilter

    s_shift = np.asarray(s, np.float64).copy()
    s_shift[0] = 0.0
    return lfilter([1.0], [1.0, -lam], s_shift)


def _compute_rf_numpy(residuals, mu, sigma, config: RiskConfig) -> Dict:
    """f64 CPU path, exact w.r.t. the reference's sequential loops: the two
    first-order recurrences run through ``scipy.signal.lfilter`` (IIR filters
    evaluate the identical recurrence in f64)."""
    from scipy.signal import lfilter

    r = np.asarray(residuals, np.float64)
    mu = np.asarray(mu, np.float64)
    sigma = np.asarray(sigma, np.float64)
    n = r.shape[0]

    w_feat = np.asarray(config.feature_weights, np.float64)
    key_to_idx = {k: i for i, k in enumerate(config.res_keys)}
    layer_w = dict(config.layer_weights)

    a_trunc = np.maximum(0.0, np.abs((r - mu[None, :]) / sigma[None, :]) - config.z_safe)
    s_layers: Dict[str, np.ndarray] = {}
    s_tot = np.zeros(n)
    for layer_name, keys in config.layer_config:
        idxs = [key_to_idx[k] for k in keys if k in key_to_idx]
        if not idxs:
            s_layers[layer_name] = np.zeros(n)
            continue
        a_l = a_trunc[:, idxs]
        w_l = w_feat[idxs][None, :]
        s_l = np.power((w_l * np.power(a_l, config.p_layer)).sum(axis=1),
                       1.0 / config.p_layer)
        s_layers[layer_name] = s_l
        s_tot += layer_w.get(layer_name, 1.0) * s_l

    c = _leaky_integral_f64(s_tot, config.lambda_decay)

    c_clip = np.clip(c, 0.0, config.c_max)
    l_0, denom = _logistic_constants(config)
    k, c0 = config.k_logistic, config.c0_logistic
    rf_inst = np.clip(
        (1.0 / (1.0 + np.exp(-k * (c_clip - c0))) - l_0) / denom, 0.0, 1.0
    )

    # EMA with y[0]=x[0]: filter y[t] = α·x[t] + (1-α)·y[t-1] with initial
    # condition matching y[-1] = x[0]
    alpha = config.alpha_smooth
    zi = np.array([(1.0 - alpha) * rf_inst[0]])
    rf_smooth, _ = lfilter([alpha], [1.0, -(1.0 - alpha)], rf_inst, zi=zi)

    return {
        "rf_inst": rf_inst,
        "rf_smooth": rf_smooth,
        "c": c,
        "s_tot": s_tot,
        "s_layers": s_layers,
    }


def find_first_alarm_index(
    series: np.ndarray, threshold: float, mode: str = "above"
) -> Optional[int]:
    """First index where series ≥ (or ≤) threshold, else None (04:289-300)."""
    series = np.asarray(series)
    if mode == "above":
        idxs = np.where(series >= threshold)[0]
    elif mode == "below":
        idxs = np.where(series <= threshold)[0]
    else:
        raise ValueError("mode must be 'above' or 'below'")
    return int(idxs[0]) if len(idxs) else None


@dataclasses.dataclass
class ConditionAdvance:
    """Per-(current, fault) early-warning summary (04:395-408)."""

    fault_name: str
    current_target: float
    n_samples: int
    v_threshold: float
    idx_v_alarm: Optional[int]
    idx_rf_alarm: Optional[int]
    advance: Optional[int]  # idx_v - idx_rf; positive → RF warned earlier
    rf_inst: np.ndarray
    rf_smooth: np.ndarray
    voltage: np.ndarray
    row_indices: np.ndarray
    # each physics layer's share of the accumulated (layer-weighted) S at the
    # RF alarm — which of voltage/gas/temp drove the warning (04:244-259
    # decomposition); {} when no layer accumulated anything in the window
    layer_shares: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-layer decayed risk-integral series: C_l[t] = λ·C_l[t−1] +
    # w_l·S_l[t] (C_l[0] = 0), so Σ_l C_l[t] = C[t] exactly
    layer_c: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def dominant_layer(self) -> Optional[str]:
        if not self.layer_shares:
            return None
        return max(self.layer_shares, key=self.layer_shares.get)


def condition_row_indices(
    arr: np.ndarray,
    fault_name: str,
    current_target: float,
    config: RiskConfig = RiskConfig(),
    index_range: Optional[Tuple[int, Optional[int]]] = None,
) -> Optional[np.ndarray]:
    """Row indices of one (fault, current) evaluation condition: fault
    class ∧ |I − target| ≤ tol, then the optional relative slice
    (04:304-340 selection semantics).  None when the condition is absent
    from the artifact."""
    labels = arr[:, INDEX["label"]].astype(int)
    current = arr[:, INDEX["x0"]].astype(float)

    if fault_name not in FAULT_RANGE_MAP:
        raise ValueError(f"unknown fault '{fault_name}'")
    fault_range = FAULT_RANGE_MAP[fault_name]
    mask = np.isin(labels, list(fault_range)) & (
        np.abs(current - current_target) <= config.current_tol
    )
    if not mask.any():
        return None

    idx_all = np.sort(np.where(mask)[0])
    total = len(idx_all)
    if index_range is not None:
        start, end = index_range
        start = max(start, 0)
        end = total if end is None or end > total else end
        if start >= end:
            return None
        idx_all = idx_all[start:end]
    return idx_all


def compute_rf_advance_for_condition(
    results,
    mu: np.ndarray,
    sigma: np.ndarray,
    fault_name: str,
    current_target: float,
    config: RiskConfig = RiskConfig(),
    index_range: Optional[Tuple[int, Optional[int]]] = None,
    backend: str = "torch",
    device="cuda",
) -> Optional[ConditionAdvance]:
    """Mask rows by fault class ∧ |I − target| ≤ tol, evaluate RF on the
    sub-sequence, compare against the dynamic voltage threshold
    V(0) − voltage_drop (04:304-408)."""
    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    voltage = arr[:, INDEX["y_true"]].astype(float)

    idx_all = condition_row_indices(arr, fault_name, current_target, config, index_range)
    if idx_all is None:
        return None

    sub = arr[idx_all]
    v_sub = voltage[idx_all]
    res_matrix = ComprehensiveResults(sub).residual_matrix(config.res_keys)
    rf = compute_rf_time_series(res_matrix, mu, sigma, config, backend=backend, device=device)
    rf_smooth = np.asarray(rf["rf_smooth"])

    v_threshold = float(v_sub[0]) - config.voltage_drop
    idx_v = find_first_alarm_index(v_sub, v_threshold, mode="below")
    idx_rf = find_first_alarm_index(rf_smooth, config.warn_threshold, mode="above")
    advance = idx_v - idx_rf if (idx_v is not None and idx_rf is not None) else None

    # attribute the alarm: C[t] is linear in the layer terms, so each layer's
    # weighted S through the same leaky integral decomposes the risk exactly
    # (Σ_l C_l[t] = C[t]); the shares of C_l at the alarm instant (the last
    # sample when the RF never fired) name the layer that drove the warning
    layer_w = dict(config.layer_weights)
    t_anchor = idx_rf if idx_rf is not None else len(idx_all) - 1
    layer_c = {
        name: _leaky_integral_f64(layer_w.get(name, 1.0) * np.asarray(s, float),
                                  config.lambda_decay)
        for name, s in rf["s_layers"].items()
    }
    sums = {name: float(c[t_anchor]) for name, c in layer_c.items()}
    total_s = sum(sums.values())
    layer_shares = {k: v / total_s for k, v in sums.items()} if total_s > 0 else {}

    return ConditionAdvance(
        fault_name=fault_name,
        current_target=current_target,
        n_samples=len(idx_all),
        v_threshold=v_threshold,
        idx_v_alarm=idx_v,
        idx_rf_alarm=idx_rf,
        advance=advance,
        rf_inst=np.asarray(rf["rf_inst"]),
        rf_smooth=rf_smooth,
        voltage=v_sub,
        row_indices=idx_all,
        layer_shares=layer_shares,
        layer_c=layer_c,
    )


def run_risk_pipeline(
    results,
    config: RiskConfig = RiskConfig(),
    conditions=DEFAULT_RF_CONDITIONS,
    backend: str = "torch",
    device="cuda",
) -> List[ConditionAdvance]:
    """Script-04 main: normal stats → all conditions → advance table
    (04:479-528).  ``device`` (the card by default) is the torch backend's."""
    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    mu, sigma = estimate_mu_sigma_normal(arr, config.res_keys, config.normal_labels)
    out: List[ConditionAdvance] = []
    for current_target, fault_name, index_range in conditions:
        adv = compute_rf_advance_for_condition(
            arr, mu, sigma, fault_name, current_target, config, index_range,
            backend=backend, device=device,
        )
        if adv is not None:
            out.append(adv)
    return out
