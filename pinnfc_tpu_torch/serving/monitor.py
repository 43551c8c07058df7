"""Online streaming fault monitor (counterpart of ``pinnfc_tpu/serving/monitor.py``).

``OnlineMonitor`` scores measurement blocks as they arrive, with O(1) state
per stream:

1. one pass on the device evaluates the DNN voltage prediction and all four
   physics residuals of the block — the residual kernel ``csrc/residuals.cu``
   through ``ops/residuals.py::all_residuals_kernel`` on the card (one launch
   per ``observe`` and per ``observe_many``), its plain version on the CPU;
2. the RF(t) recurrences carry across calls — the leaky risk integral
   ``C[t] = λ·C[t-1] + S[t]`` (04:262-264) and the EMA smoother (04:276-279)
   continue where the previous block ended, as doubling scans with the
   carried value as start (``ops/recurrences.py``), so one row at a time or
   a thousand at a time give the same series up to float32 rounding;
3. alarms follow script 04: the RF warn/danger thresholds and the dynamic
   voltage threshold V(0) − 0.1 V from the first finite sample;
4. optionally a ``DiagnosisHead`` (script 03's calibrated GMM posterior,
   03:360-426) classifies every sample's fault type from the same residuals;
5. optionally a conformal calibration vector (``uq/conformal``, |res| on
   normal rows) gives every sample a calibrated anomaly p-value, and the
   adaptive conformal level α_t (Gibbs & Candès ACI) runs on the host after
   the block's one read: it is a non-linear scalar recurrence, B steps that
   would each be a launch on the device.

Each ``observe``/``observe_many`` call copies its inputs and the carried
state to the device in one transfer and reads the whole result back in one.
Between calls the state bank is host numpy with the JAX package's dtypes, so
``save_state_bank`` files cross between the two packages.

With a mesh (``mesh=``, a ``"data"`` axis), ``observe_many`` splits the stream
axis over its devices (``_shard_fleet``): the streams never interact, so each
shard's step runs on its own device with a copy of the monitor's params,
scalers and constants there (made once per monitor), one copy in, one
residual-kernel launch and one read per shard.  ``observe`` (one stream) stays
unsharded.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from pinnfc_tpu_torch.config import RiskConfig
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.gmm import GMMParams, gmm_predict_proba
from pinnfc_tpu_torch.ops.recurrences import linear_recurrence_assoc
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.parallel.mesh import Mesh, data_size, to_device
from pinnfc_tpu_torch.risk.rf import _logistic_constants
from pinnfc_tpu_torch.utils.io import atomic_savez

# monitor residual-stack columns (RiskConfig.res_keys order, 04:88)
_R_COLUMN = {"res": 0, "pV": 1, "pT": 2, "pH": 3, "pO": 4}

# the consecutive-glitch sensor alarm default (the CLI flags and
# from_checkpoint reference it)
DEFAULT_GLITCH_ALARM_N = 25


class DiagnosisHead(NamedTuple):
    """Calibrated-GMM fault-type classifier applied to the monitor's residual
    stack (script 03 semantics, streaming)."""

    gmm: GMMParams  # fitted mixture, tensors on the monitor's device
    comp_fault_prob: torch.Tensor  # (C, K) float32 P(fault | component)
    class_names: tuple  # K class names (calibration order)
    feature_indices: tuple  # columns of the residual stack r fed to the GMM

    @classmethod
    def from_gmm_result(cls, result, features: str | None = None):
        """Build from a ``run_gmm_pipeline`` result.  The feature spec is the
        one the mixture was fitted on; ``features`` overrides it only if equal.
        Only channels the monitor computes live are streamable
        (res/pV/pT/pH/pO)."""
        fitted = getattr(result, "features", None)
        if features is None:
            features = fitted or "pV,pT,pH,pO"
        elif fitted is not None and [f.strip() for f in features.split(",")] != [
                f.strip() for f in fitted.split(",")]:
            raise ValueError(f"features {features!r} do not match the spec the mixture "
                             f"was fitted on ({fitted!r})")
        names = [f.strip() for f in features.split(",") if f.strip()]
        unknown = [f for f in names if f not in _R_COLUMN]
        if unknown:
            raise ValueError(f"features {unknown} are not streamable monitor channels "
                             f"(available: {sorted(_R_COLUMN)})")
        model = result.model
        return cls(
            gmm=model,
            comp_fault_prob=torch.as_tensor(np.asarray(result.comp_fault_prob, np.float32),
                                            device=model.means.device),
            class_names=tuple(result.class_names),
            feature_indices=tuple(_R_COLUMN[f] for f in names),
        )

    def save(self, path: str) -> str:
        """Write the head as npz, in the JAX package's keys and dtypes, so a
        restarted scorer diagnoses without refitting; returns the path
        written."""
        g = self.gmm
        path = path if path.endswith(".npz") else path + ".npz"
        atomic_savez(
            path,
            gmm_weights=g.weights.detach().cpu().numpy(),
            gmm_means=g.means.detach().cpu().numpy(),
            gmm_covariances=g.covariances.detach().cpu().numpy(),
            gmm_converged=np.asarray(bool(g.converged)),
            gmm_n_iter=np.asarray(int(g.n_iter), np.int32),
            gmm_lower_bound=np.asarray(float(g.lower_bound), np.float32),
            comp_fault_prob=self.comp_fault_prob.detach().cpu().numpy().astype(np.float32),
            class_names=np.asarray(self.class_names),
            feature_indices=np.asarray(self.feature_indices, np.int32),
        )
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "DiagnosisHead":
        """Read a head written by ``save`` (of either package) onto ``device``."""
        dev = resolve_device(device)
        d = np.load(path if path.endswith(".npz") else path + ".npz")
        feature_indices = tuple(int(i) for i in d["feature_indices"])
        bad = [i for i in feature_indices if not 0 <= i < len(_R_COLUMN)]
        if bad:
            raise ValueError(f"head file has feature indices {bad} outside the monitor's "
                             f"residual channels 0..{len(_R_COLUMN) - 1}")
        comp = d["comp_fault_prob"]
        if comp.shape[1] != len(d["class_names"]):
            raise ValueError(f"comp_fault_prob has {comp.shape[1]} classes but "
                             f"{len(d['class_names'])} class names")
        if d["gmm_means"].shape != (comp.shape[0], len(feature_indices)):
            raise ValueError("gmm means shape does not match components/features: "
                             f"{d['gmm_means'].shape} vs ({comp.shape[0]}, "
                             f"{len(feature_indices)})")
        gmm = GMMParams(
            weights=torch.as_tensor(d["gmm_weights"], device=dev),
            means=torch.as_tensor(d["gmm_means"], device=dev),
            covariances=torch.as_tensor(d["gmm_covariances"], device=dev),
            converged=bool(d["gmm_converged"]),
            n_iter=int(d["gmm_n_iter"]),
            lower_bound=float(d["gmm_lower_bound"]),
        )
        return cls(gmm=gmm,
                   comp_fault_prob=torch.as_tensor(comp.astype(np.float32), device=dev),
                   class_names=tuple(str(c) for c in d["class_names"]),
                   feature_indices=feature_indices)


# Field order of a step's outputs, as in the JAX package (whose exported
# step artifacts bake a prefix of it); ``_pack`` reads them by name.
STEP_OUT_FIELDS = (
    "rf_inst", "rf_smooth", "residuals", "v_pred", "v_alarm", "glitch",
    "sensor_alarm", "fault", "layer_scores", "layer_c", "oob",
    "conformal_p", "aci_alpha", "aci_anomaly",
)


def contributing_layer_names(config) -> tuple:
    """Layers that contribute (non-empty key intersection with ``res_keys``),
    in config order — the column order of layer_scores/layer_c and the width
    of the per-stream layer_c state."""
    k2i = {k: i for i, k in enumerate(config.res_keys)}
    return tuple(lname for lname, keys in config.layer_config if any(k in k2i for k in keys))


def check_fleet_bank(x_bank, v_bank, streams):
    """Validate and coerce ``observe_many`` arguments: returns (streams list,
    x_bank f32 (S, B, 8), v_bank f32 (S, B)) or raises before any stream
    state is touched."""
    streams = list(streams)
    x_bank = np.asarray(x_bank, np.float32)
    v_bank = np.asarray(v_bank, np.float32)
    if x_bank.ndim != 3 or x_bank.shape[0] != len(streams):
        raise ValueError(f"x_bank must be (S={len(streams)}, B, 8), got {x_bank.shape}")
    if v_bank.shape != x_bank.shape[:2]:
        raise ValueError(f"v_bank must be {x_bank.shape[:2]}, got {v_bank.shape}")
    if len(set(streams)) != len(streams):
        raise ValueError("stream keys must be unique per observe_many call")
    return streams, x_bank, v_bank


class MonitorState(NamedTuple):
    """Carry between blocks, as host numpy values (the JAX package's dtypes)."""

    c: np.ndarray  # () float32 leaky integral C[t]
    rf_smooth: np.ndarray  # () float32 EMA value
    v_first: np.ndarray  # () float32 V(0) for the dynamic threshold
    n_seen: np.ndarray  # () int32 samples consumed
    v_first_set: np.ndarray  # () bool — baseline captured from a finite sample
    glitch_run: np.ndarray  # () float32 consecutive non-finite samples ending the stream
    # (L,) float32 per-layer decomposition of the same integral,
    # C_l[t] = λ·C_l[t−1] + w_l·S_l[t] with identical gating, so Σ_l C_l ≡ C
    layer_c: np.ndarray
    # (F,) int32 cumulative count of samples whose raw input left the
    # scaler's training range, per channel (streaming drift; non-finite
    # readings are glitches, not drift)
    oob_count: np.ndarray
    # () float32 adaptive conformal level α_t: α_{t+1} = α_t + γ·(α* − err_t),
    # err_t = [p_t ≤ α_t], deliberately unclipped (a level driven below 0
    # stores the debt that pins the long-run alarm rate to α*); stays at α*
    # with γ = 0
    aci_alpha: np.ndarray


@dataclasses.dataclass
class MonitorOutput:
    rf_smooth: np.ndarray  # (B,)
    rf_inst: np.ndarray  # (B,)
    residuals: np.ndarray  # (B, 5) [res, pV, pT, pH, pO]
    v_pred: np.ndarray  # (B,) predicted stack voltage [V]
    warn: np.ndarray  # (B,) bool — RF ≥ warn threshold
    danger: np.ndarray  # (B,) bool — RF ≥ danger threshold
    v_alarm: np.ndarray  # (B,) bool — measured V ≤ V(0) − drop
    glitch: np.ndarray | None = None  # (B,) bool — sample excluded from risk
    sensor_alarm: np.ndarray | None = None  # (B,) bool — glitch run ≥ limit
    fault_probs: np.ndarray | None = None  # (B, K) — with a DiagnosisHead
    fault_pred: np.ndarray | None = None  # (B,) argmax class index, -1 on glitches
    # (B, L) per-layer risk attribution (weighted p-norm terms of the RF
    # aggregation, 04:244-259), before the first-sample/glitch gating
    layer_scores: np.ndarray | None = None
    # (B, L) per-layer risk integral C_l(t), gated like C and carried across
    # blocks: row sums reconstruct the unclipped C
    layer_c: np.ndarray | None = None
    oob: np.ndarray | None = None  # (B,) bool — the raw row left the training range
    # (B,) conformal anomaly p-value of |res| against the calibration scores,
    # NaN on glitches; None without a ``conformal_calib``
    conformal_p: np.ndarray | None = None
    aci_alpha: np.ndarray | None = None  # (B,) the level α_t each sample was tested at
    aci_anomaly: np.ndarray | None = None  # (B,) bool — p_t ≤ α_t


def _layer_columns(cfg: RiskConfig, device) -> list:
    """(layer weight, column index tensor on ``device``) per contributing layer
    of ``cfg``, in config order: the columns of the residual stack it sums."""
    key_to_idx = {k: i for i, k in enumerate(cfg.res_keys)}
    layer_w = dict(cfg.layer_weights)
    out = []
    for lname, keys in cfg.layer_config:
        idxs = [key_to_idx[k] for k in keys if k in key_to_idx]
        if idxs:
            out.append((layer_w.get(lname, 1.0),
                        torch.as_tensor(idxs, dtype=torch.int64, device=device)))
    return out


def _excitation_block(r, mu, sigma, cfg: RiskConfig, w_feat, layer_columns):
    """Per-layer weighted p-norm excitations of the standardized truncated
    residuals r (..., 5) (04:244-259) → (s_tot (...), layer_scores (..., L)),
    before the gating; NaN feature rows give NaN columns.  ``layer_columns``
    is ``_layer_columns(cfg)``."""
    a_trunc = torch.clamp_min(torch.abs((r - mu) / sigma) - cfg.z_safe, 0.0)
    s_tot = torch.zeros_like(r[..., 0])
    layer_contribs = []
    for weight, idxs in layer_columns:
        contrib = weight * torch.pow(
            torch.sum(w_feat[idxs] * torch.pow(a_trunc[..., idxs], cfg.p_layer), dim=-1),
            1.0 / cfg.p_layer)
        s_tot = s_tot + contrib
        layer_contribs.append(contrib)
    layer_scores = (torch.stack(layer_contribs, dim=-1) if layer_contribs
                    else s_tot[..., None][..., :0])
    return s_tot, layer_scores


def _gate_block(s_tot, v_meas, first):
    """Sensor-glitch and first-sample gating of (B, S) scores → (glitch,
    gate, gated s_tot).  A non-finite sample (score or voltage) would poison
    the carried state forever, so it contributes zero risk and surfaces as
    ``glitch``; each stream's first-ever sample (``first``, (S,)) contributes
    zero too (C[0] = 0, 04:262)."""
    glitch = ~(torch.isfinite(s_tot) & torch.isfinite(v_meas))
    gate = glitch.clone()
    gate[0] |= first
    return glitch, gate, torch.where(gate, 0.0, s_tot)


def _layer_c_block(layer_scores, gate, c0, cfg: RiskConfig, max_len=None):
    """Per-layer risk integral (B, S, L) from the carried (S, L) ``c0``: the
    same leaky recurrence on each layer's gated term, so Σ_l C_l ≡ C."""
    layer_gated = torch.where(gate[..., None], 0.0, layer_scores)
    if layer_gated.shape[-1]:
        return linear_recurrence_assoc(torch.full_like(layer_gated, cfg.lambda_decay),
                                       layer_gated, c0, max_len)
    return layer_gated


def _glitch_run_block(glitch, run0, glitch_alarm_n: int, max_len=None):
    """Consecutive-glitch run length run[i] = glitch[i]·(run[i-1]+1), the
    same first-order recurrence as C[t] → (series, sensor alarm)."""
    gf = glitch.to(torch.float32)
    series = linear_recurrence_assoc(gf, gf, run0, max_len)
    return series, series >= glitch_alarm_n


def _voltage_alarm_block(v_meas, v_first0, v_first_set0, cfg: RiskConfig):
    """Dynamic-threshold baseline and alarm over (B, S) voltages → (v_first
    (S,), v_first_set (S,), v_alarm (B, S)).  The baseline is the first
    finite voltage ever seen (a glitched first sample defers capture); NaN
    comparisons are False, so non-finite samples never alarm."""
    finite_v = torch.isfinite(v_meas)
    has_finite = finite_v.any(dim=0)
    # the first True: argmax over an integer copy picks the first maximum
    first_i = torch.argmax(finite_v.to(torch.int32), dim=0)
    cand = v_meas.gather(0, first_i[None])[0]
    v_first = torch.where(v_first_set0, v_first0, torch.where(has_finite, cand, 0.0))
    v_first_set = v_first_set0 | has_finite
    v_alarm = v_first_set & (v_meas <= (v_first - cfg.voltage_drop))
    return v_first, v_first_set, v_alarm


def _drift_block(x_raw, box_lo, box_hi):
    """Which channels left the training box, per sample: (oob per channel,
    oob per row).  ±inf would satisfy the box comparison, so non-finite
    readings (glitches) are excluded explicitly."""
    oob_ch = torch.isfinite(x_raw) & ((x_raw < box_lo) | (x_raw > box_hi))
    return oob_ch, oob_ch.any(dim=-1)


def _conformal_block(res, calib):
    """Conformal anomaly p-values p = (1 + #{calib ≥ |res|}) / (n + 1), by one
    searchsorted against the sorted calibration vector (exact integer rank
    counts, ties conservative) and one IEEE float32 division, so every
    device gives the host's p for the same |res|; NaN on non-finite
    residuals."""
    s_conf = torch.abs(res)
    ge = calib.shape[0] - torch.searchsorted(calib, s_conf.contiguous(), side="left")
    # a tensor divisor: CUDA divides by a Python scalar through its reciprocal
    n_plus_1 = torch.full_like(s_conf[..., :1], calib.shape[0] + 1.0)
    p_conf = (1.0 + ge.to(torch.float32)) / n_plus_1
    return torch.where(torch.isfinite(s_conf), p_conf, float("nan"))


def _aci_block(conformal_p: np.ndarray, alpha0, gamma: float, alpha_star: float):
    """The adaptive conformal level over one stream's block, on the host in
    float32: α_{t+1} = α_t + γ·(α* − err_t), err_t = [p_t ≤ α_t]; glitched
    samples (NaN p) neither flag nor move the level.  Returns (α_t per
    sample, err per sample, α after the block)."""
    a = np.float32(alpha0)
    g32, a_star = np.float32(gamma), np.float32(alpha_star)
    alphas = np.empty(len(conformal_p), np.float32)
    errs = np.zeros(len(conformal_p), bool)
    for i, p in enumerate(conformal_p):
        alphas[i] = a
        if np.isfinite(p):
            errs[i] = p <= a
            a = np.float32(a + g32 * np.float32(a_star - np.float32(errs[i])))
    return alphas, errs, a


def _diagnosis_block(head: DiagnosisHead, r, glitch, feature_columns):
    """Script-03 posterior mapping (03:417-425) of rows r (N, 5) → (probs
    (N, K), pred (N,)); glitched rows (NaN posterior, whose argmax would be a
    confident-looking class) get pred = -1.  ``feature_columns``: the head's
    feature indices as a tensor on r's device."""
    feats = r[:, feature_columns]
    resp = gmm_predict_proba(head.gmm, feats)
    probs = torch.clamp(resp @ head.comp_fault_prob.to(resp.dtype), 1e-12, 1.0)
    probs = probs / torch.sum(probs, dim=1, keepdim=True)
    pred = torch.where(glitch, -1, torch.argmax(probs, dim=1))
    return probs.to(torch.float32), pred


def _split_columns(cols, per_stream, n_layers: int, n_classes: int, conformal: bool) -> dict:
    """The fields of ``OnlineMonitor._device_step``'s outputs, the one place
    that knows their column order: per-sample columns (..., n) and per-stream
    columns (..., 4 + F), as numpy arrays or tensors alike (slices and
    comparisons only); absent fields are None."""
    i = 11 + 2 * n_layers
    out = {"rf_inst": cols[..., 0], "rf_smooth": cols[..., 1], "residuals": cols[..., 2:7],
           "v_pred": cols[..., 7], "v_alarm": cols[..., 8] > 0, "glitch": cols[..., 9] > 0,
           "sensor_alarm": cols[..., 10] > 0, "layer_scores": cols[..., 11:11 + n_layers],
           "layer_c": cols[..., 11 + n_layers:i], "oob": cols[..., i] > 0,
           "conformal_p": None, "fault_probs": None, "fault_pred": None,
           "c": per_stream[..., 0], "glitch_run": per_stream[..., 1],
           "v_first": per_stream[..., 2], "v_first_set": per_stream[..., 3] > 0,
           "oob_count": per_stream[..., 4:]}
    i += 1
    if conformal:
        out["conformal_p"], i = cols[..., i], i + 1
    if n_classes:
        out["fault_probs"], out["fault_pred"] = cols[..., i:i + n_classes], cols[..., i + n_classes]
    return out


def _rf_block(s_tot, c0, rf0, first, cfg: RiskConfig, max_len=None):
    """Continue the RF recurrences over a (B, S) block from the carried C and
    EMA values; on a stream's first-ever sample the EMA is seeded with
    rf_inst[0] (04:277).  Returns (rf_inst, rf_smooth, C series)."""
    c_series = linear_recurrence_assoc(torch.full_like(s_tot, cfg.lambda_decay), s_tot, c0,
                                       max_len)
    c_clip = torch.clamp(c_series, 0.0, cfg.c_max)
    k, c0_log = cfg.k_logistic, cfg.c0_logistic
    l_0, denom = _logistic_constants(cfg)
    rf_inst = torch.clamp((1.0 / (1.0 + torch.exp(-k * (c_clip - c0_log))) - l_0) / denom,
                          0.0, 1.0)
    alpha = cfg.alpha_smooth
    seed = torch.where(first, rf_inst[0], rf0)
    rf_smooth = linear_recurrence_assoc(torch.full_like(rf_inst, 1.0 - alpha),
                                        alpha * rf_inst, seed, max_len)
    # first-ever sample: rf_smooth[0] equals rf_inst[0] exactly
    rf_smooth[0] = torch.where(first, rf_inst[0], rf_smooth[0])
    return rf_inst, rf_smooth, c_series


def _pad_streams(x_bank: np.ndarray, v_bank: np.ndarray, states, pad: int, fresh):
    """The fleet (S, B, F) / (S, B) and its S states with ``pad`` zero-input,
    fresh-state dummy streams after the real ones (whose results the caller
    drops by keeping the first S)."""
    if not pad:
        return x_bank, v_bank, list(states)
    s_n, b_n, f_n = x_bank.shape
    return (np.concatenate([x_bank, np.zeros((pad, b_n, f_n), x_bank.dtype)]),
            np.concatenate([v_bank, np.zeros((pad, b_n), v_bank.dtype)]),
            list(states) + [fresh] * pad)


class OnlineMonitor:
    """Streaming scorer over (B, 8) raw measurement blocks + (B,) voltage, on
    ``device`` (where ``params`` and the scalers live; the card by default);
    with ``mesh``, ``observe_many`` splits its streams over the mesh's
    ``"data"`` axis."""

    def __init__(
        self,
        params,
        scaler_x: AffineScaler,
        scaler_y: AffineScaler,
        mu: np.ndarray,
        sigma: np.ndarray,
        config: RiskConfig = RiskConfig(),
        diagnosis: DiagnosisHead | None = None,
        glitch_alarm_n: int = DEFAULT_GLITCH_ALARM_N,
        conformal_calib=None,
        conformal_alpha: float = 0.1,
        conformal_gamma: float = 0.0,
        device="cuda",
        mesh: Mesh | None = None,
    ):
        calib = None
        if conformal_calib is not None:
            calib = np.asarray(conformal_calib, np.float32).ravel()
            if calib.size == 0:
                raise ValueError("conformal_calib must be non-empty")
            if not np.isfinite(calib).all():
                raise ValueError("conformal_calib must be finite (uq.normal_calibration_"
                                 "scores already drops non-finite rows)")
            calib = np.sort(calib)
        self._init_options(mu, sigma, config, diagnosis, glitch_alarm_n, calib is not None,
                           conformal_alpha, conformal_gamma, int(scaler_x.scale.shape[0]),
                           device, mesh)
        self.params = params
        self.scaler_x = scaler_x
        self.scaler_y = scaler_y
        self.conformal_calib = calib
        # the step's constants on the device
        self._w_feat = torch.as_tensor(np.asarray(config.feature_weights, np.float32),
                                       device=self.device)
        self._layer_columns = _layer_columns(config, self.device)
        self._head_columns = (None if diagnosis is None else torch.as_tensor(
            diagnosis.feature_indices, dtype=torch.int64, device=self.device))
        self._box_lo = scaler_x.data_min.to(self.device)
        self._box_hi = scaler_x.data_max.to(self.device)
        self._calib = (None if self.conformal_calib is None
                       else torch.as_tensor(self.conformal_calib, device=self.device))

    def _init_options(self, mu, sigma, config: RiskConfig, diagnosis, glitch_alarm_n: int,
                      conformal: bool, conformal_alpha: float, conformal_gamma: float,
                      n_features: int, device, mesh: Mesh | None = None) -> None:
        """The checks and attributes that do not depend on how the step is
        computed, shared with ``serving/exported.py``'s artifact monitor:
        ``conformal`` says whether the step computes p-values."""
        if glitch_alarm_n < 1:
            raise ValueError(f"glitch_alarm_n must be >= 1 (a run of 0 would alarm on "
                             f"every healthy sample), got {glitch_alarm_n}")
        if mesh is not None and "data" not in mesh.axis_names:
            raise ValueError(f"monitor mesh needs a 'data' axis to shard streams over, "
                             f"got axes {mesh.axis_names}")
        if conformal and not 0.0 < conformal_alpha < 1.0:
            raise ValueError(f"conformal_alpha must be in (0, 1), got {conformal_alpha}")
        if not 0.0 <= conformal_gamma < 1.0:
            raise ValueError(f"conformal_gamma must be in [0, 1), got {conformal_gamma}")
        if conformal_gamma > 0.0 and not conformal:
            raise ValueError("conformal_gamma needs a conformal_calib vector (there is "
                             "no p-value to adapt the level against)")
        self.device = resolve_device(device)
        self.mu = torch.as_tensor(np.asarray(mu, np.float32), device=self.device)
        self.sigma = torch.as_tensor(np.asarray(sigma, np.float32), device=self.device)
        self.config = config
        self.diagnosis = diagnosis
        self.glitch_alarm_n = int(glitch_alarm_n)
        self.conformal_alpha = float(conformal_alpha)
        self.conformal_gamma = float(conformal_gamma)
        self._conformal = conformal  # whether the step computes p-values
        self.layer_names = contributing_layer_names(config)
        self._n_features = n_features
        # the multi-stream state bank: each stream key carries its own RF(t)
        # state; "default" is the single-stream API's
        self._streams: dict[str, MonitorState] = {"default": self._fresh_state()}
        self._n_seen: dict[str, int] = {"default": 0}
        # per-stream count of samples with conformal p ≤ α (host statistic)
        self._low_p: dict[str, int] = {"default": 0}
        # observe_many's stream shards and the monitor's copy on each device
        self.mesh = mesh
        self._replicas = None

    def _fresh_state(self) -> MonitorState:
        return MonitorState(
            c=np.float32(0.0),
            rf_smooth=np.float32(0.0),
            v_first=np.float32(0.0),
            n_seen=np.int32(0),
            v_first_set=np.bool_(False),
            glitch_run=np.float32(0.0),
            layer_c=np.zeros(len(self.layer_names), np.float32),
            oob_count=np.zeros(self._n_features, np.int32),
            aci_alpha=np.float32(self.conformal_alpha),
        )

    # carried state on the device, per stream: c, rf_smooth, v_first,
    # v_first_set, first (n_seen == 0), glitch_run, then layer_c
    _CARRY = 6

    def _device_step(self, x_raw, v_meas, carry, mu, sigma, max_len=None):
        """The device program of one step over S streams of B rows, a function
        of tensors only (``_step`` runs it eagerly, ``serving/exported.py``
        traces it): x_raw (S, B, F), v_meas (B, S), carry
        (S, _CARRY + L) float32, mu and sigma (5,) → (per_sample (B, S, n)
        float32, per_stream (S, 4 + F) float32) in the column order of
        ``_split_columns``.  One residual-kernel launch on the card.
        ``max_len``: run the recurrences' scans at the fixed depth of blocks
        up to that size (``ops/recurrences.py``)."""
        cfg = self.config
        s_n, b_n, f_n = x_raw.shape
        first = carry[:, 4] > 0
        with torch.no_grad():
            # forward and residual stack (col 12 semantics for ``res``)
            mlp = self.params["mlp"]
            x_norm = self.scaler_x.transform(x_raw.reshape(s_n * b_n, f_n))
            h = x_norm
            for lin in mlp.hidden:
                h = torch.tanh(lin(h))
            u_norm = mlp.mean(h)
            v_pred = self.scaler_y.inverse(u_norm)[:, 0]
            bundle = all_residuals_kernel(self.params, x_norm, u_norm, self.scaler_x,
                                          self.scaler_y)

            def bs(t):  # (S·B,) or (S·B, 1) → (B, S)
                return t.reshape(s_n, b_n).T

            v_pred = bs(v_pred)
            res = v_meas - v_pred
            r = torch.stack([res, bs(bundle.f_v), bs(bundle.f_t), bs(bundle.f_h),
                             bs(bundle.f_o)], dim=-1)  # (B, S, 5)

            s_tot, layer_scores = _excitation_block(r, mu, sigma, cfg, self._w_feat,
                                                    self._layer_columns)
            glitch, gate, s_tot = _gate_block(s_tot, v_meas, first)
            rf_inst, rf_smooth, c_series = _rf_block(s_tot, carry[:, 0], carry[:, 1], first,
                                                     cfg, max_len)
            lc_series = _layer_c_block(layer_scores, gate, carry[:, self._CARRY:], cfg, max_len)
            glitch_series, sensor_alarm = _glitch_run_block(glitch, carry[:, 5],
                                                            self.glitch_alarm_n, max_len)
            v_first, v_first_set, v_alarm = _voltage_alarm_block(v_meas, carry[:, 2],
                                                                 carry[:, 3] > 0, cfg)
            oob_ch, oob = _drift_block(x_raw, self._box_lo, self._box_hi)

            f32 = torch.float32
            per_sample = [rf_inst, rf_smooth, *r.unbind(-1), v_pred, v_alarm.to(f32),
                          glitch.to(f32), sensor_alarm.to(f32), *layer_scores.unbind(-1),
                          *lc_series.unbind(-1), oob.T.to(f32)]
            if self._calib is not None:
                per_sample.append(_conformal_block(res, self._calib))
            head = self.diagnosis
            if head is not None:
                probs, pred = _diagnosis_block(head, r.reshape(b_n * s_n, 5),
                                               glitch.reshape(-1), self._head_columns)
                per_sample += [*probs.view(b_n, s_n, -1).unbind(-1),
                               pred.view(b_n, s_n).to(f32)]
            per_stream = [c_series[-1], glitch_series[-1], v_first, v_first_set.to(f32),
                          *oob_ch.sum(dim=1).to(f32).unbind(-1)]
            return torch.stack(per_sample, dim=-1), torch.stack(per_stream, dim=-1)

    def _carry(self, states) -> np.ndarray:
        """The (S, _CARRY + L) float32 carry of S host states."""
        n_l = len(self.layer_names)
        return np.array([[st.c, st.rf_smooth, st.v_first, st.v_first_set, st.n_seen == 0,
                          st.glitch_run, *np.asarray(st.layer_c)] for st in states],
                        np.float32).reshape(len(states), self._CARRY + n_l)

    def _launch(self, x_bank: np.ndarray, v_bank: np.ndarray, carry: np.ndarray):
        """The device step of S streams on this monitor's device, not read
        back: one host→device copy of x_bank (S, B, F), v_bank (S, B) and the
        carry, one residual-kernel launch on the card → (the per-sample and
        per-stream columns packed flat, the per-sample width)."""
        s_n, b_n, f_n = x_bank.shape
        buf = torch.from_numpy(np.concatenate([x_bank.ravel(), v_bank.ravel(), carry.ravel()]))
        buf = buf.to(self.device)
        n_x = s_n * b_n * f_n
        x_raw = buf[:n_x].view(s_n, b_n, f_n)
        v_meas = buf[n_x:n_x + s_n * b_n].view(s_n, b_n).T  # (B, S)
        carry = buf[n_x + s_n * b_n:].view(s_n, -1)
        per_sample, per_stream = self._device_step(x_raw, v_meas, carry, self.mu, self.sigma)
        return torch.cat([per_sample.reshape(-1), per_stream.reshape(-1)]), per_sample.shape[-1]

    @staticmethod
    def _columns(host: np.ndarray, s_n: int, b_n: int, n_sample: int):
        """``_launch``'s packed result read to the host → (cols (B, S, n),
        last (S, 4 + F))."""
        return (host[:b_n * s_n * n_sample].reshape(b_n, s_n, n_sample),
                host[b_n * s_n * n_sample:].reshape(s_n, -1))

    def _step(self, x_bank: np.ndarray, v_bank: np.ndarray, states) -> list:
        """Advance S streams by one (B,) block each: x_bank (S, B, F), v_bank
        (S, B), ``states`` S host states → S (state, step outputs) pairs.
        One host→device copy, one residual-kernel launch on the card, one
        device→host read."""
        s_n, b_n, _ = x_bank.shape
        packed, n_sample = self._launch(x_bank, v_bank, self._carry(states))
        cols, last = self._columns(packed.cpu().numpy(), s_n, b_n, n_sample)
        return self._unpack(cols, last, states)

    def _unpack(self, cols: np.ndarray, last: np.ndarray, states) -> list:
        """S (state, step outputs) pairs from ``_device_step``'s columns read
        to the host: cols (B, S, n), last (S, 4 + F); the ACI level runs
        here, after the read."""
        b_n = cols.shape[0]
        head = self.diagnosis
        results = []
        for i, st in enumerate(states):
            f = _split_columns(cols[:, i, :], last[i], len(self.layer_names),
                               0 if head is None else len(head.class_names),
                               self._conformal)
            aci_a = aci_e = None
            aci_last = st.aci_alpha
            if f["conformal_p"] is not None:
                aci_a, aci_e, aci_last = _aci_block(f["conformal_p"], st.aci_alpha,
                                                    self.conformal_gamma, self.conformal_alpha)
            fault = (None, None)
            if head is not None:
                fault = (f["fault_probs"], f["fault_pred"].astype(np.int32))
            new_state = MonitorState(
                c=np.float32(f["c"]),
                rf_smooth=np.float32(f["rf_smooth"][-1]),
                v_first=np.float32(f["v_first"]),
                n_seen=np.int32(st.n_seen + b_n),
                v_first_set=np.bool_(f["v_first_set"]),
                glitch_run=np.float32(f["glitch_run"]),
                layer_c=f["layer_c"][-1].astype(np.float32),
                oob_count=(np.asarray(st.oob_count)
                           + f["oob_count"].astype(np.int32)).astype(np.int32),
                aci_alpha=np.float32(aci_last),
            )
            results.append((new_state, (f["rf_inst"], f["rf_smooth"], f["residuals"],
                                        f["v_pred"], f["v_alarm"], f["glitch"],
                                        f["sensor_alarm"], fault, f["layer_scores"],
                                        f["layer_c"], f["oob"], f["conformal_p"], aci_a,
                                        aci_e)))
        return results

    def _replica(self, device: torch.device) -> "OnlineMonitor":
        """A shallow copy of this monitor with everything ``_device_step``
        reads on ``device`` (the same tensors where they lie there already):
        the same step, the same code."""
        rep = copy.copy(self)
        rep.device = device
        rep.params = to_device(self.params, device)
        rep.scaler_x, rep.scaler_y = self.scaler_x.to(device), self.scaler_y.to(device)
        for name in ("mu", "sigma", "_w_feat", "_box_lo", "_box_hi", "_calib", "_head_columns"):
            setattr(rep, name, to_device(getattr(self, name), device))
        rep._layer_columns = [(w, idx.to(device)) for w, idx in self._layer_columns]
        if self.diagnosis is not None:
            rep.diagnosis = self.diagnosis._replace(
                gmm=self.diagnosis.gmm._replace(**{
                    f: getattr(self.diagnosis.gmm, f).to(device)
                    for f in ("weights", "means", "covariances")}),
                comp_fault_prob=self.diagnosis.comp_fault_prob.to(device))
        return rep

    def _shard_fleet(self, x_bank: np.ndarray, v_bank: np.ndarray, states) -> list:
        """``_step`` with the S streams split over the mesh's ``"data"`` axis.

        The stream axis is padded to a multiple of the data size with
        fresh-state, zero-input dummy streams, whose results are dropped; shard
        k's streams go to the k-th device in one copy and through the step of
        the monitor's copy there (``_replica``, made once per monitor: params,
        scalers, μ and σ replicated), every shard launched before the first
        read; the per-shard outputs are read to the host one device at a
        time and put back in stream order."""
        devices = self.mesh.axis_devices("data")
        if self._replicas is None:
            self._replicas = {}
            for d in devices:
                if d not in self._replicas:
                    self._replicas[d] = self._replica(resolve_device(d))
        s_n, b_n, _ = x_bank.shape
        pad = (-s_n) % len(devices)
        x_bank, v_bank, padded = _pad_streams(x_bank, v_bank, states, pad, self._fresh_state())
        carry = self._carry(padded)
        per = (s_n + pad) // len(devices)
        launched = [self._replicas[d]._launch(x_bank[k * per:(k + 1) * per],
                                              v_bank[k * per:(k + 1) * per],
                                              carry[k * per:(k + 1) * per])
                    for k, d in enumerate(devices)]
        parts = [self._columns(packed.cpu().numpy(), per, b_n, n_sample)  # one read per shard
                 for packed, n_sample in launched]
        cols = np.concatenate([c for c, _ in parts], axis=1)[:, :s_n]
        last = np.concatenate([p for _, p in parts])[:s_n]
        return self._unpack(cols, last, states)

    # ---- single-stream surface ----------------------------------------
    @property
    def state(self) -> MonitorState:
        return self._streams["default"]

    @state.setter
    def state(self, value: MonitorState) -> None:
        self._streams["default"] = value

    @property
    def n_seen(self) -> int:
        """Total samples seen across all streams."""
        return sum(self._n_seen.values())

    @property
    def streams(self) -> tuple:
        return tuple(self._streams)

    def stream_n_seen(self, stream: str = "default") -> int:
        return self._n_seen.get(stream, 0)

    def stream_low_p(self, stream: str = "default") -> int:
        """Cumulative count of samples with conformal p ≤ α on this stream
        (0 for unknown streams or without a calibration vector)."""
        return self._low_p.get(stream, 0)

    def stream_aci_alpha(self, stream: str = "default") -> float:
        """Current adaptive conformal level α_t of one stream (α* for an
        unknown stream)."""
        state = self._streams.get(stream)
        if state is None:
            return self.conformal_alpha
        return float(state.aci_alpha)

    def stream_oob_counts(self, stream: str = "default") -> np.ndarray:
        """(F,) cumulative out-of-training-range sample count per input
        channel of one stream (zeros for an unknown stream)."""
        state = self._streams.get(stream)
        if state is None:
            return np.zeros(self._n_features, np.int64)
        return np.asarray(state.oob_count).astype(np.int64)

    def _pack(self, out_host) -> MonitorOutput:
        d = dict(zip(STEP_OUT_FIELDS, out_host))
        probs, pred = d["fault"]
        rf_smooth = d["rf_smooth"]
        return MonitorOutput(
            rf_smooth=rf_smooth,
            rf_inst=d["rf_inst"],
            residuals=d["residuals"],
            v_pred=d["v_pred"],
            warn=rf_smooth >= self.config.warn_threshold,
            danger=rf_smooth >= self.config.danger_threshold,
            v_alarm=d["v_alarm"],
            glitch=d["glitch"],
            sensor_alarm=d["sensor_alarm"],
            fault_probs=probs,
            fault_pred=pred,
            layer_scores=d["layer_scores"],
            layer_c=d["layer_c"],
            oob=d["oob"],
            conformal_p=d["conformal_p"],
            aci_alpha=d["aci_alpha"],
            aci_anomaly=d["aci_anomaly"],
        )

    def _count_low_p(self, out: MonitorOutput, stream: str) -> None:
        """Advance the host-side calibrated-anomaly counter (tie-inclusive
        p ≤ α: covered ⟺ p > α; NaN never counts)."""
        if out.conformal_p is not None:
            self._low_p[stream] = self._low_p.get(stream, 0) + int(
                np.sum(out.conformal_p <= self.conformal_alpha))

    def _advance(self, streams, x_bank, v_bank, step=None) -> dict:
        states = [self._streams.get(s) or self._fresh_state() for s in streams]
        results = {}
        for s, (new_state, out) in zip(streams, (step or self._step)(x_bank, v_bank, states)):
            self._streams[s] = new_state
            self._n_seen[s] = self._n_seen.get(s, 0) + int(x_bank.shape[1])
            results[s] = self._pack(out)
            self._count_low_p(results[s], s)
        return results

    def observe(self, x_raw, v_measured, stream: str = "default") -> MonitorOutput:
        """Score a block of raw measurements (B, 8) and measured voltages (B,)
        on ``stream`` (created fresh on first use)."""
        x_raw = np.atleast_2d(np.asarray(x_raw, np.float32))
        v_meas = np.atleast_1d(np.asarray(v_measured, np.float32))
        return self._advance([stream], x_raw[None], v_meas[None])[stream]

    def observe_many(self, x_bank, v_bank, streams) -> dict:
        """Advance many streams in one step: x_bank (S, B, 8), v_bank (S, B),
        S stream keys (created fresh on first use) → {stream: MonitorOutput}.
        Equal to S ``observe`` calls; the streams' rows go through the
        forward and the residual kernel as one (S·B, 8) batch and the
        recurrences run on (B, S) with the per-stream carry as start.  With a
        mesh whose data axis spans more than one device, the streams split
        over it (``_shard_fleet``: one batch and one kernel launch per
        shard)."""
        streams, x_bank, v_bank = check_fleet_bank(x_bank, v_bank, streams)
        sharded = data_size(self.mesh) > 1
        return self._advance(streams, x_bank, v_bank, self._shard_fleet if sharded else None)

    def reset(self, stream: str | None = None) -> None:
        """Reset one stream's state, or (default) the whole bank."""
        if stream is None:
            self._streams = {"default": self._fresh_state()}
            self._n_seen = {"default": 0}
            self._low_p = {"default": 0}
        else:
            self._streams[stream] = self._fresh_state()
            self._n_seen[stream] = 0
            self._low_p[stream] = 0

    def save_state_bank(self, path: str) -> str:
        """Snapshot every stream's carry state and counters (npz, the JAX
        package's keys and dtypes), written atomically; ``load_state_bank``
        continues every stream bit for bit.  Returns the path written."""
        path = path if path.endswith(".npz") else path + ".npz"
        streams = sorted(self._streams)
        states = [self._streams[s] for s in streams]
        payload = {
            "streams": np.asarray(streams),
            "n_seen": np.asarray([self._n_seen.get(s, 0) for s in streams], np.int64),
            "low_p": np.asarray([self._low_p.get(s, 0) for s in streams], np.int64),
        }
        for field in MonitorState._fields:
            payload[f"state_{field}"] = np.stack([np.asarray(getattr(st, field))
                                                  for st in states])
        atomic_savez(path, **payload)
        return path

    def load_state_bank(self, path: str) -> None:
        """Replace the whole stream bank with a ``save_state_bank`` snapshot
        (of either package), cast to the fresh-state dtypes.  layer_c,
        oob_count and aci_alpha may be absent (an older snapshot) or of
        another width (another layer config or feature width): they restart
        fresh, with a note on stderr; the RF recurrence resumes exactly."""
        d = np.load(path if path.endswith(".npz") else path + ".npz")
        fresh = self._fresh_state()
        optional = {
            f for f in ("layer_c", "oob_count", "aci_alpha")
            if f"state_{f}" not in d
            or d[f"state_{f}"].shape[1:] != np.asarray(getattr(fresh, f)).shape
        }
        missing = [k for k in ["streams", "n_seen"]
                   + [f"state_{f}" for f in MonitorState._fields if f not in optional]
                   if k not in d]
        if missing:
            raise ValueError(f"state-bank file {path!r} is missing {missing}")
        streams = [str(s) for s in d["streams"]]
        n = len(streams)
        if len(set(streams)) != n:
            raise ValueError(f"state-bank file {path!r} has duplicate streams")
        for f in MonitorState._fields:
            if f in optional:
                continue
            want = (n,) + np.asarray(getattr(fresh, f)).shape
            if d[f"state_{f}"].shape != want:
                raise ValueError(f"state-bank field state_{f} has shape "
                                 f"{d[f'state_{f}'].shape}, want {want} for {n} streams")
        if d["n_seen"].shape != (n,):
            raise ValueError(f"state-bank n_seen has shape {d['n_seen'].shape} for "
                             f"{n} streams")
        if optional:
            print(f"note: state-bank {path!r} lacks {sorted(optional)} (older snapshot or "
                  "different layer config); those fields restart fresh — the RF "
                  "recurrence itself resumes exactly", file=sys.stderr)
        self._streams = {
            s: MonitorState(*(
                np.asarray(getattr(fresh, f)).copy() if f in optional
                else np.asarray(d[f"state_{f}"][i]).astype(
                    np.asarray(getattr(fresh, f)).dtype)[()]
                for f in MonitorState._fields
            ))
            for i, s in enumerate(streams)
        }
        self._n_seen = {s: int(d["n_seen"][i]) for i, s in enumerate(streams)}
        # the anomaly counter gates nothing: an older snapshot restarts it
        low_p = d["low_p"] if "low_p" in d and d["low_p"].shape == (n,) else None
        self._low_p = {s: int(low_p[i]) if low_p is not None else 0
                       for i, s in enumerate(streams)}
        self._streams.setdefault("default", self._fresh_state())
        self._n_seen.setdefault("default", 0)
        self._low_p.setdefault("default", 0)

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        mu,
        sigma,
        config: RiskConfig = RiskConfig(),
        diagnosis: DiagnosisHead | None = None,
        glitch_alarm_n: int = DEFAULT_GLITCH_ALARM_N,
        conformal_calib=None,
        conformal_alpha: float = 0.1,
        conformal_gamma: float = 0.0,
        device="cuda",
        mesh: Mesh | None = None,
    ) -> "OnlineMonitor":
        """Restore params and scalers of a checkpoint (either package's) onto
        ``device``; ``mesh`` shards ``observe_many``'s streams."""
        from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint

        ckpt = load_checkpoint(path, device=device)
        return cls(ckpt["params"], ckpt["scaler_x"], ckpt["scaler_y"], mu, sigma, config,
                   diagnosis, glitch_alarm_n=glitch_alarm_n, conformal_calib=conformal_calib,
                   conformal_alpha=conformal_alpha, conformal_gamma=conformal_gamma,
                   device=device, mesh=mesh)
