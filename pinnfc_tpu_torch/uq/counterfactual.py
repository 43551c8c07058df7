"""Counterfactual recovery (counterpart of ``pinnfc_tpu/uq/counterfactual.py``):
the minimal actuation change that clears a voltage alarm, according to the
trained PINN.

Per sample, a box-constrained inverse problem in the normalized input domain

    min_δ  α·mean(δ²)  +  mean relu(v* − v̂(clip(x₀+δ)))²

where

* ``v*`` is the recovery target in volts.  In **gain mode** (the default of
  the risk conditions) the solve targets ``v̂(x₀+δ) − v̂(x₀) ≥ relu(v_thr +
  margin − v_meas)``: the PINN detects a fault as the residual between
  measured and predicted voltage, so the actionable question is which
  actuation gains back the measured shortfall, with the model as a local
  sensitivity surrogate.  In **absolute mode** the model's own prediction
  must clear ``v* + margin``.  By default the alarm line is script 04's
  dynamic threshold V(0) − voltage_drop (04:389);
* the box is the MinMax training range (01:271-274), widened per row so
  δ = 0 stays feasible for inputs already outside it; channels that were
  constant in training are frozen;
* an **actuatable mask** freezes channels the operator cannot command: by
  default the stack current (a load demand) and the coolant outlet
  temperature (an outcome of the stack).

The solve is one batched Adam loop over δ (N, 8) on the device: each step one
eval forward of the mean head and one ``torch.autograd.grad``, in float32
with TF32 off, and no host read until the end.  Rows are independent (the
model is row-wise), so the gradient of the batch mean, times N, is each row's
own gradient.  δ enters the forward only as ``δ·mask``, so masked channels
never move, and rows that already meet their target keep δ = 0 exactly (zero
hinge gradient, zero penalty gradient at 0).

With a mesh, the rows split over its ``"data"`` axis (edge rows appended to a
multiple of its size, trimmed on the host after one read per device) and each
shard runs the Adam loop on its device with a copy of the MLP there, the
shards stepped in lockstep.  As in the JAX function, the loss's means divide
by the padded row count and the gradient is multiplied by it back, so each
row's step is its own whatever shard it lies in; no sum crosses shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.data.contract import INPUT_CHANNELS
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.parallel.mesh import Mesh, data_size, pad_to_multiple, replicate, shard_batch

# Channels an operator can command on the test bench; stack current is the
# imposed load and coolant_t_out a measured consequence of the thermal state
# (01:2162-2169 channel semantics).
DEFAULT_ACTUATABLE: Tuple[str, ...] = (
    "coolant_flow",
    "coolant_t_in",
    "p_h2_in",
    "p_air_in",
    "h2_flow",
    "air_flow",
)


@dataclasses.dataclass(frozen=True)
class CounterfactualConfig:
    """Optimizer knobs for the recovery inverse problem."""

    steps: int = 400  # Adam iterations
    lr: float = 0.05  # in normalized-input units
    alpha: float = 0.05  # pull toward the smallest actuation (L2 on δ)
    margin: float = 0.01  # volts above the target before "recovered"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8


class CounterfactualReport(NamedTuple):
    """Batched recovery result (numpy, one device read)."""

    channel_names: Tuple[str, ...]
    actuatable: np.ndarray  # (8,) bool — which channels were free
    x_phys: np.ndarray  # (N, 8) original inputs
    x_cf_phys: np.ndarray  # (N, 8) counterfactual inputs
    delta_phys: np.ndarray  # (N, 8) x_cf − x, physical units
    delta_range: np.ndarray  # (N, 8) delta as a fraction of training range
    v_before: np.ndarray  # (N,) model voltage at x
    v_after: np.ndarray  # (N,) model voltage at x_cf
    v_target: np.ndarray  # (N,) recovery target (volts, absolute)
    recovered: np.ndarray  # (N,) bool — the mode's recovery criterion
    v_meas: Optional[np.ndarray] = None  # (N,) measured volts (gain mode)
    v_expected: Optional[np.ndarray] = None  # (N,) v_meas + (v_after − v_before)


def actuatable_mask(channels: Sequence[str]) -> np.ndarray:
    """(8,) float32 mask from channel names; unknown names raise."""
    unknown = set(channels) - set(INPUT_CHANNELS)
    if unknown:
        raise ValueError(f"unknown channels {sorted(unknown)}; valid: {INPUT_CHANNELS}")
    return np.asarray([1.0 if c in set(channels) else 0.0 for c in INPUT_CHANNELS], np.float32)


def _mean_head(mlp, x: torch.Tensor) -> torch.Tensor:
    """Eval forward of the trunk and the mean head only (the JAX
    ``mlp_forward(..., train=False, logvar=False)``) → (N,)."""
    h = x
    for lin in mlp.hidden:
        h = torch.tanh(lin(h))
    return mlp.mean(h)[:, 0]


def _f32(v) -> float:
    """A Python float holding ``v`` rounded to float32, so a scalar operand
    of a float32 op carries the JAX function's float32 constant."""
    return float(np.float32(v))


class _Solve:
    """One shard's box-constrained Adam solve over δ (N, 8), on the device of
    its tensors: ``x0_norm`` (N, 8), ``v_target`` (N,), and the constants
    ``y_scale``, ``y_min``, ``mask`` (8,), ``box_lo``, ``box_hi`` (8,)."""

    def __init__(self, mlp, x0_norm, v_target, y_scale, y_min, mask, box_lo, box_hi,
                 gain_mode: bool):
        self.mlp, self.x0_norm, self.mask = mlp, x0_norm, mask
        self.y_scale, self.y_min = y_scale, y_min
        # widen the box per row so δ = 0 is always feasible
        self.lo_eff = torch.minimum(box_lo, x0_norm)
        self.hi_eff = torch.maximum(box_hi, x0_norm)
        zeros = torch.zeros_like(x0_norm)
        with torch.no_grad():
            self.v0 = self.v_hat(zeros)
        self.tgt = self.v0 + v_target if gain_mode else v_target.expand_as(self.v0)
        self.delta = self.m = self.v = zeros

    def x(self, delta):
        # jnp.clip's maximum-then-minimum: at a tie each splits its gradient
        # in half, as torch.maximum/minimum do
        return torch.minimum(torch.maximum(self.x0_norm + delta * self.mask, self.lo_eff),
                             self.hi_eff)

    def v_hat(self, delta):
        return (_mean_head(self.mlp, self.x(delta)) - self.y_min) / self.y_scale

    def gradient(self, alpha: float, n_rows=None):
        """Each row's own gradient of the objective: the batch means over
        ``n_rows`` rows (default: this shard's), times ``n_rows``."""
        d = self.delta.detach().requires_grad_(True)
        short = torch.relu(self.tgt - self.v_hat(d))
        if n_rows is None:
            loss = torch.mean(short ** 2) + alpha * torch.mean((d * self.mask) ** 2)
            n_rows = d.shape[0]
        else:  # the means of the whole padded batch
            loss = (torch.sum(short ** 2) / n_rows
                    + alpha * (torch.sum((d * self.mask) ** 2) / (n_rows * d.shape[1])))
        g, = torch.autograd.grad(loss, d)
        return g * n_rows


def _recover(solves, config: CounterfactualConfig, n_rows=None):
    """Adam on every shard's δ, the shards stepped in lockstep (each step
    issued on every device before the next); returns per shard ``(x_cf_norm,
    v_after, v_before)`` with voltages in volts, on the shard's device.

    The objective is a batch mean over ``n_rows`` rows (default: each shard's
    own), so the gradient is multiplied by ``n_rows`` (each row's own
    gradient).  The hinge lives in physical volts, the α-penalty in
    normalized-δ units.  Scalars are float32 as in the JAX function:
    ``1 − b1``, the bias corrections ``1 − b1**t`` and the update
    ``lr·m̂/(√v̂ + eps)``."""
    b1, b2 = np.float32(config.adam_b1), np.float32(config.adam_b2)
    one = np.float32(1.0)
    omb1, omb2 = _f32(one - b1), _f32(one - b2)
    lr, alpha, eps = _f32(config.lr), _f32(config.alpha), _f32(config.adam_eps)
    with torch.enable_grad():
        for t in range(1, config.steps + 1):
            for sv in solves:
                g = sv.gradient(alpha, n_rows)
                sv.m = float(b1) * sv.m + omb1 * g
                sv.v = float(b2) * sv.v + omb2 * g ** 2
                mh = sv.m / _f32(one - b1 ** np.float32(t))
                vh = sv.v / _f32(one - b2 ** np.float32(t))
                sv.delta = sv.delta - lr * mh / (torch.sqrt(vh) + eps)
    with torch.no_grad():
        return [(sv.x(sv.delta), sv.v_hat(sv.delta), sv.v0) for sv in solves]


def counterfactual_recovery(
    params,
    x_phys: np.ndarray,
    v_target: np.ndarray,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
    actuatable: Optional[Sequence[str]] = None,
    config: CounterfactualConfig = CounterfactualConfig(),
    v_meas: Optional[np.ndarray] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> CounterfactualReport:
    """Solve the recovery problem for every row of ``x_phys`` (N, 8), on
    ``device`` (where ``params`` and the scalers live).

    ``v_target`` is in physical volts — scalar or (N,).  With ``v_meas`` (the
    measured voltage per row) the solve runs in gain mode: the required
    model-voltage gain is ``relu(v_target + margin − v_meas)`` and
    ``recovered`` means the expected measured voltage ``v_meas + (v̂_after −
    v̂_before)`` clears ``v_target``.  Without it the target is absolute:
    ``v̂_after ≥ v_target + margin``, recovered when ``v̂_after ≥ v_target``.
    With ``mesh``, the rows split over its ``"data"`` axis; a data axis of
    size 1 takes the unsharded path.
    """
    x_phys = np.asarray(x_phys, np.float32)
    if x_phys.ndim != 2 or x_phys.shape[1] != len(INPUT_CHANNELS):
        raise ValueError(f"x_phys must be (N, {len(INPUT_CHANNELS)}); got {x_phys.shape}")
    n = x_phys.shape[0]
    v_target = np.broadcast_to(np.asarray(v_target, np.float32).reshape(-1), (n,)).copy()
    gain_mode = v_meas is not None
    if gain_mode:
        v_meas = np.broadcast_to(np.asarray(v_meas, np.float32).reshape(-1), (n,)).copy()

    mlp = params["mlp"] if isinstance(params, dict) and "mlp" in params else params
    span = (scaler_x.data_max.cpu().numpy().astype(np.float64)
            - scaler_x.data_min.cpu().numpy().astype(np.float64))
    # zero-span channels were constant in training: actuation on them would
    # be pure extrapolation, so they are frozen whatever the caller asks
    mask = actuatable_mask(DEFAULT_ACTUATABLE if actuatable is None else actuatable) * (span > 0)
    mask = mask.astype(np.float32)

    # normalized-domain constants; the box is the transform of the training
    # extrema (a collapsed point for zero-span channels)
    x0_norm = scaler_x.transform(x_phys)  # numpy in → numpy out
    box_lo = scaler_x.transform(scaler_x.data_min.cpu().numpy()[None, :]).reshape(-1)
    box_hi = scaler_x.transform(scaler_x.data_max.cpu().numpy()[None, :]).reshape(-1)
    y_scale = np.float32(scaler_y.scale.cpu().numpy().ravel()[0])
    y_min = np.float32(scaler_y.min.cpu().numpy().ravel()[0])
    if gain_mode:
        # required model-voltage gain; rows at/above the line need none
        solve_target = np.maximum(0.0, v_target + config.margin - v_meas)
    else:
        solve_target = v_target + config.margin

    def solve(mlp_, x0, tgt):  # one shard's solve on the device of x0
        consts = [torch.as_tensor(np.asarray(a, np.float32), device=x0.device)
                  for a in (y_scale, y_min, mask, box_lo, box_hi)]
        return _Solve(mlp_, x0, tgt, *consts, gain_mode)

    if data_size(mesh) > 1:
        x_pad, _ = pad_to_multiple(np.asarray(x0_norm, np.float32), mesh.shape["data"])
        t_pad, _ = pad_to_multiple(np.asarray(solve_target, np.float32), mesh.shape["data"])
        rows = shard_batch(mesh, torch.from_numpy(x_pad), torch.from_numpy(t_pad))
        for d in rows.devices:
            resolve_device(d)
        solved = _recover([solve(m, x, t) for m, (x, t) in zip(replicate(mesh, mlp), rows.parts)],
                          config, n_rows=x_pad.shape[0])
    else:
        dev = resolve_device(device)
        solved = _recover([solve(mlp, torch.as_tensor(np.asarray(x0_norm, np.float32), device=dev),
                                 torch.as_tensor(np.asarray(solve_target, np.float32), device=dev))],
                          config)
    # one device→host read per shard, the pad rows trimmed on the host
    packed = [torch.cat([x_cf, v_after[:, None], v_before[:, None]], dim=1)
              for x_cf, v_after, v_before in solved]
    packed = np.concatenate([p.cpu().numpy() for p in packed])[:n]
    x_cf_norm, v_after, v_before = packed[:, :8], packed[:, 8].copy(), packed[:, 9].copy()

    x_cf_phys = np.asarray(scaler_x.inverse(x_cf_norm), np.float32)
    # entries the solver did not move (frozen channels, rows already above
    # target, zero-span channels) return the original values exactly: the
    # round trip through the affine pair is identity only up to rounding
    unchanged = x_cf_norm == np.asarray(x0_norm, np.float32)
    x_cf_phys[unchanged] = x_phys[unchanged]
    delta_phys = x_cf_phys - x_phys
    safe_span = np.where(span == 0, 1.0, span)
    delta_range = (delta_phys / safe_span[None, :]).astype(np.float32)
    if gain_mode:
        v_expected = (v_meas + (v_after - v_before)).astype(np.float32)
        recovered = v_expected >= v_target
    else:
        v_expected = None
        recovered = v_after >= v_target
    return CounterfactualReport(
        channel_names=INPUT_CHANNELS,
        actuatable=mask.astype(bool),
        x_phys=x_phys,
        x_cf_phys=x_cf_phys,
        delta_phys=delta_phys.astype(np.float32),
        delta_range=delta_range,
        v_before=v_before,
        v_after=v_after,
        v_target=v_target,
        recovered=recovered,
        v_meas=v_meas,
        v_expected=v_expected,
    )


class ConditionRecovery(NamedTuple):
    """Recovery analysis for one (current, fault) risk condition."""

    fault_name: str  # English name (config.FAULT_NAMES_EN)
    current_target: float
    v_threshold: float  # the 04:389 dynamic alarm line V(0) − drop
    idx_v_alarm: Optional[int]  # within the condition sub-sequence
    n_rows: int  # alarmed rows actually solved
    report: Optional[CounterfactualReport]  # None when never alarmed


def condition_recovery(
    results,
    params,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
    conditions=None,
    risk_config=None,
    config: CounterfactualConfig = CounterfactualConfig(),
    actuatable: Optional[Sequence[str]] = None,
    max_rows: int = 64,
    target: str = "gain",
    device="cuda",
    mesh: Optional[Mesh] = None,
):
    """Per-risk-condition counterfactual recovery over an exported artifact.

    Mirrors the 12-condition table of ``cli risk`` (04:145-161 conditions,
    04:389 dynamic threshold): for each condition the alarmed tail — rows
    at/after the first measured-voltage crossing of V(0) − voltage_drop — is
    solved for the minimal actuation that recovers the alarm line
    (``target='gain'``, the default) or that lifts the model's own prediction
    over it (``target='absolute'``).  All conditions share one batched solve
    (its rows split over ``mesh``'s ``"data"`` axis when given); tails longer
    than ``max_rows`` are subsampled evenly."""
    from pinnfc_tpu_torch.config import DEFAULT_RF_CONDITIONS, FAULT_NAMES_EN, RiskConfig
    from pinnfc_tpu_torch.data.contract import INDEX, ComprehensiveResults
    from pinnfc_tpu_torch.risk.rf import condition_row_indices, find_first_alarm_index

    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    if target not in ("gain", "absolute"):
        raise ValueError(f"target must be 'gain' or 'absolute'; got {target!r}")
    if conditions is None:
        conditions = DEFAULT_RF_CONDITIONS
    if risk_config is None:
        risk_config = RiskConfig()

    entries = []
    for current, fault, index_range in conditions:
        idx = condition_row_indices(arr, fault, current, risk_config, index_range)
        if idx is None:
            continue
        v_sub = arr[idx, INDEX["y_true"]].astype(float)
        v_thr = float(v_sub[0]) - risk_config.voltage_drop
        i_alarm = find_first_alarm_index(v_sub, v_thr, mode="below")
        rows = np.empty(0, int)
        if i_alarm is not None:
            rows = idx[i_alarm:]
            if len(rows) > max_rows:
                sel = np.unique(np.linspace(0, len(rows) - 1, max_rows).round().astype(int))
                rows = rows[sel]
        entries.append(dict(fault=FAULT_NAMES_EN.get(fault, fault), current=float(current),
                            v_threshold=v_thr, idx_v_alarm=i_alarm, rows=rows))

    full = None
    if sum(len(e["rows"]) for e in entries) > 0:
        solved = [e for e in entries if len(e["rows"])]
        all_rows = np.concatenate([e["rows"] for e in solved])
        x = arr[all_rows, : len(INPUT_CHANNELS)].astype(np.float32)
        v_t = np.concatenate([np.full(len(e["rows"]), e["v_threshold"], np.float32)
                              for e in solved])
        v_m = arr[all_rows, INDEX["y_true"]].astype(np.float32) if target == "gain" else None
        full = counterfactual_recovery(params, x, v_t, scaler_x, scaler_y,
                                       actuatable=actuatable, config=config, v_meas=v_m,
                                       device=device, mesh=mesh)

    out = []
    off = 0
    for e in entries:
        n = len(e["rows"])
        rep = None
        if n and full is not None:
            sl = slice(off, off + n)
            rep = full._replace(**{
                f: (None if getattr(full, f) is None else getattr(full, f)[sl])
                for f in CounterfactualReport._fields
                if f not in ("channel_names", "actuatable")})
            off += n
        out.append(ConditionRecovery(fault_name=e["fault"], current_target=e["current"],
                                     v_threshold=e["v_threshold"],
                                     idx_v_alarm=e["idx_v_alarm"], n_rows=n, report=rep))
    return out


def summarize_recovery(report: CounterfactualReport) -> Dict[str, np.ndarray]:
    """Aggregate a report into the operator-facing row: mean signed delta per
    channel (fraction of training range and physical units, moved rows only),
    the dominant actuator (name and index) and the recovered fraction — the
    one definition of "moved"/"mean move" every printout, JSON field and
    figure reads."""
    moved = ~np.isclose(report.delta_range, 0.0).all(axis=1)
    sel = moved if moved.any() else slice(None)
    rows = report.delta_range[sel]
    rows_phys = report.delta_phys[sel]
    n_ch = len(report.channel_names)
    mean_delta = rows.mean(axis=0) if rows.size else np.zeros(n_ch, np.float32)
    mean_phys = rows_phys.mean(axis=0) if rows_phys.size else np.zeros(n_ch, np.float32)
    k = int(np.argmax(np.abs(mean_delta))) if np.abs(mean_delta).max() > 0 else -1
    return {
        "mean_delta_range": mean_delta,
        "mean_delta_phys": mean_phys,
        "dominant": report.channel_names[k] if k >= 0 else None,
        "dominant_index": k,
        "recovered_frac": (float(report.recovered.mean()) if len(report.recovered)
                           else float("nan")),
        "n_moved": int(moved.sum()),
    }
