"""Save-to-file matplotlib figures (counterpart of ``pinnfc_tpu/viz/plots.py``),
the reference's visualizations written to disk:

- uncertainty views (aleatoric scatter / smoothed epistemic, 01:1494-1624)
- detailed voltage fit with residual axis (01:1626-1828)
- train/test split overview (01:330-360)
- ROC curves incl. unsupervised overlay (02:546-611)
- 2-D feature / t-SNE scatters (02:287-433, 03:429-508)
- per-fault GMM probability scatter (03:209-356)
- RF(t) early-warning dual-axis condition plot (04:411-474)
- confusion matrix with count + row-% annotations (05:104-174)
- six-method macro-metric grouped bar chart (05:517-609)
- the explainability figures of ``cli identify/explain/whatif/conformal``.

matplotlib is imported on a figure's first call, not with this module:
``tsne_embed`` (the device work of the t-SNE views) and the rest of the
package run where matplotlib is not installed, and a figure there raises
``ImportError``.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from pinnfc_tpu_torch.config import FAULT_NAMES_EN
from pinnfc_tpu_torch.data.contract import INDEX, ComprehensiveResults

_CJK_CANDIDATES = ("Noto Sans CJK SC", "SimHei", "Microsoft YaHei", "WenQuanYi Zen Hei")


def pyplot():
    """``matplotlib.pyplot``.  On its first import, the Agg backend is chosen
    when the process is headless and the user has chosen no backend, so a
    host application keeps its interactive one."""
    if "matplotlib.pyplot" not in sys.modules:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("figures need matplotlib, which is not installed") from e
        if os.environ.get("MPLBACKEND") is None and os.environ.get("DISPLAY") is None:
            matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def setup_cjk_font() -> bool:
    """Configure a CJK-capable font if one exists (reference
    setup_chinese_font, 01:33-55).  Returns whether one was found; when not,
    ``display_name`` translates the fault names to English instead."""
    plt = pyplot()
    import matplotlib.font_manager as fm

    available = {f.name for f in fm.fontManager.ttflist}
    for cand in _CJK_CANDIDATES:
        if cand in available:
            plt.rcParams["font.sans-serif"] = [cand] + plt.rcParams["font.sans-serif"]
            plt.rcParams["axes.unicode_minus"] = False
            return True
    return False


_HAS_CJK: bool | None = None  # resolved on first use: the font scan is slow


def _cjk_available() -> bool:
    """The first call runs the font scan and, when no CJK font exists,
    silences matplotlib's per-glyph warnings."""
    global _HAS_CJK
    if _HAS_CJK is None:
        _HAS_CJK = setup_cjk_font()
        if not _HAS_CJK:
            warnings.filterwarnings("ignore", message=r"Glyph \d+ .* missing from font")
    return _HAS_CJK


def display_name(name: str) -> str:
    """Fault name for figure text: Chinese when a CJK font is available, the
    English translation otherwise (also inside the data layer's composite
    segment labels: ``水淹故障(108A)`` → ``Flooding fault(108A)``)."""
    if _cjk_available():
        return name
    for zh, en in FAULT_NAMES_EN.items():
        name = name.replace(zh, en)
    return name.replace("故障", " fault")


def _arr(results):
    return results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)


def _finish(fig, save_path: str):
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    pyplot().close(fig)
    return save_path


def _rolling_mean_centered(data: np.ndarray, window: int) -> np.ndarray:
    """pandas ``rolling(window, center=True, min_periods=1).mean()``
    (reference moving_average_improved, 01:1511-1515) in numpy: row i
    averages the non-NaN values of rows i − ⌊w/2⌋ … i + w − 1 − ⌊w/2⌋ that
    exist; a series shorter than the window is returned as it is."""
    data = np.asarray(data, float)
    if len(data) < window:
        return data
    left = window // 2
    padded = np.pad(data, (left, window - 1 - left), constant_values=np.nan)
    windows = np.lib.stride_tricks.sliding_window_view(padded, window)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # an all-NaN window gives NaN
        return np.nanmean(windows, axis=1)


def plot_uncertainty(results, boundary_lines: Sequence[int], save_path: str,
                     window_size: int = 50):
    """Reference view_uncertainty_only (01:1494-1624): TWO figures — A, the
    aleatoric scatter with Normal/Fault-i region labels, and B, the
    window-50 centered rolling epistemic line with the normal-region mean as
    a purple dashed baseline.  ``save_path`` is the stem: writes
    ``<stem>_aleatoric.<ext>`` and ``<stem>_epistemic.<ext>``; returns both
    paths."""
    plt = pyplot()
    arr = _arr(results)
    n = len(arr)
    idx = np.arange(n)
    ale = arr[:, INDEX["ale"]]
    epi = arr[:, INDEX["epi"]]
    base, ext = os.path.splitext(save_path)
    # an ndarray's truthiness raises; the reference guards with len() (01:1536)
    boundary_lines = list(boundary_lines) if boundary_lines is not None else []
    # clamped as in the reference (01:1538-1543); without boundaries the
    # baseline is the whole series' mean
    normal_end = min(int(boundary_lines[0]), n) if len(boundary_lines) > 0 else 0
    normal_mean = float(np.mean(epi[:normal_end])) if normal_end > 0 else float(np.mean(epi))

    # figure A — aleatoric scatter (01:1547-1580)
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.scatter(idx, ale, c="blue", s=7, alpha=0.7, label="Aleatoric uncertainty")
    ax.set_ylabel("Uncertainty magnitude")
    ax.set_title("Aleatoric uncertainty distribution")
    ax.legend(fontsize=9)
    ax.grid(True, alpha=0.3)
    for b in boundary_lines[:-1]:
        ax.axvline(b, color="gray", ls="--", alpha=0.5, lw=1)
    if normal_end > 0:
        ax.text(
            normal_end / 2, ax.get_ylim()[1] * 0.95, "Normal", ha="center", fontsize=9,
            bbox=dict(boxstyle="round,pad=0.2", facecolor="lightblue", alpha=0.7),
        )
    y_pos = ax.get_ylim()[1] * 0.85
    for i in range(len(boundary_lines) - 1):
        mid = (boundary_lines[i] + boundary_lines[i + 1]) / 2
        ax.text(
            mid, y_pos, f"Fault-{i + 1}", ha="center", fontsize=8,
            bbox=dict(boxstyle="round,pad=0.2", facecolor="lightcoral", alpha=0.7),
        )
    path_a = _finish(fig, f"{base}_aleatoric{ext}")

    # figure B — smoothed epistemic line + normal-mean baseline (01:1585-1624)
    epi_filtered = _rolling_mean_centered(epi, window_size)
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(idx, epi_filtered, c="red", lw=4, alpha=0.8,
            label=f"Epistemic uncertainty (filtered, window={window_size})")
    for side in ("left", "right", "top", "bottom"):
        ax.spines[side].set_linewidth(2.5)
    if np.isfinite(normal_mean):
        ax.axhline(normal_mean, color="purple", ls="--", lw=1.5,
                   label=f"Normal mean = {normal_mean:.4f}")
    ax.set_xlabel("Sample index")
    ax.set_ylabel("Epistemic uncertainty")
    for b in boundary_lines[:-1]:
        ax.axvline(b, color="gray", ls="--", alpha=0.5, lw=2)
    path_b = _finish(fig, f"{base}_epistemic{ext}")
    return path_a, path_b


def plot_detailed_results(results, save_path: str, boundary_lines=()):
    """Dual-axis detailed figure, reference plot_model_results_detailed_split
    (01:1626-1828): measured voltage (blue) vs model output (red dashed) on
    an upper-shifted left axis, the model residual in green on a
    lower-shifted right axis with a green zero line and spine, thick frame,
    fault-boundary lines, merged legend."""
    plt = pyplot()
    arr = _arr(results)
    idx = np.arange(len(arr))
    y = arr[:, INDEX["y_true"]]
    p = arr[:, INDEX["y_pred"]]
    err = y - p  # model residual (01:1665)

    fig, ax_l = plt.subplots(figsize=(14, 6))
    ln1 = ax_l.plot(idx, y, "b-", lw=3.5, alpha=0.9, label="Measured voltage")
    ln2 = ax_l.plot(idx, p, "r--", lw=3.5, alpha=0.9, label="Model output")
    ax_l.set_xlabel("Sample index")
    ax_l.set_ylabel("Voltage (V)")
    # voltage band shifted to the upper half (01:1705-1708)
    v_min, v_max = min(y.min(), p.min()), max(y.max(), p.max())
    v_margin = 0.05 * (v_max - v_min + 1e-6)
    ax_l.set_ylim(v_min - v_margin - (v_max - v_min), v_max + v_margin)

    ax_r = ax_l.twinx()
    ln3 = ax_r.plot(idx, err, color="green", lw=3.5, alpha=0.9, label="Model residual")
    ax_r.set_ylabel("Model residual (V)", color="green")
    ax_r.tick_params(axis="y", colors="green")
    ax_r.spines["right"].set_color("green")
    err_abs_max = float(np.max(np.abs(err))) + 1e-6
    ax_r.set_ylim(-1.2 * err_abs_max, 3.2 * err_abs_max)  # 01:1726-1728
    ax_r.axhline(0.0, color="green", ls="--", lw=2.0, alpha=0.7)

    for side in ("left", "right", "top", "bottom"):
        ax_l.spines[side].set_linewidth(2.5)
        ax_r.spines[side].set_linewidth(2.5)
    for b in list(boundary_lines)[:-1]:
        ax_l.axvline(b, color="gray", ls="--", alpha=0.5, lw=2)

    lines = ln1 + ln2 + ln3
    ax_l.legend(lines, [ln.get_label() for ln in lines], loc="center left", fontsize=10)
    return _finish(fig, save_path)


def plot_temp_comparison(results, save_path: str, boundary_lines=()):
    """Measured coolant-outlet temperature (col 5) vs the physics-model
    temperature (col 19), the reference main's inline figure (01:2208-2228)."""
    plt = pyplot()
    arr = _arr(results)
    idx = np.arange(len(arr))
    fig, ax = plt.subplots(figsize=(14, 5))
    ax.plot(idx, arr[:, INDEX["x5"]], "b-", lw=2, label="Measured temperature")
    ax.plot(idx, arr[:, INDEX["t_phys"]], "r--", lw=2, label="Physics-model temperature")
    ax.set_xlabel("Sample index")
    ax.set_ylabel("Temperature (°C)")
    ax.set_title(display_name("真实温度 vs 物理模型输出温度"))
    ax.grid(True, alpha=0.3)
    for b in list(boundary_lines)[:-1]:
        ax.axvline(b, color="gray", ls="--", alpha=0.5, lw=1.5)
    ax.legend(fontsize=10)
    return _finish(fig, save_path)


def scatter_features(results, feature_spec: str, group_spec: str):
    """(x, y, class_names) of the feature scatter: the artifact rows whose
    label the group spec maps, on ``feature_spec``'s columns."""
    from pinnfc_tpu_torch.diagnosis.features import (
        build_label_mapper, extract_X_y, parse_features, parse_group_spec)

    feat_idx = parse_features(feature_spec)
    if len(feat_idx) < 2:
        raise ValueError(f"feature scatter needs at least 2 features, got {feature_spec!r}")
    label_map, class_names = build_label_mapper(parse_group_spec(group_spec))
    x, y = extract_X_y(_arr(results), feat_idx, label_map)
    return x, y, class_names


def plot_scatter_by_features(
    results,
    feature_spec: str,
    group_spec: str,
    save_path: str,
    backend: str = "device",
    random_state: int = 42,
    device="cuda",
):
    """Scatter of the configured PLOT_FEATURES, reference
    ``plot_scatter_by_features`` (02:287-433, called at 02:470-476): two
    features plot directly; more embed to 2-D with t-SNE first (TSNE_PARAMS
    02:63 — perplexity 30, PCA init, fixed seed) on ``device``.  Points are
    colored by coarse class (normal blue / fault red in the binary case)."""
    plt = pyplot()
    x, y, class_names = scatter_features(results, feature_spec, group_spec)
    if len(x) == 0:
        return None
    if x.shape[1] > 2:
        x2d = tsne_embed(x, random_state=random_state, backend=backend, device=device)
        xlabel, ylabel = "t-SNE dim1", "t-SNE dim2"
    else:
        from pinnfc_tpu_torch.diagnosis.features import parse_features

        feat_idx = parse_features(feature_spec)
        x2d = x
        inv = {v: k for k, v in INDEX.items()}
        xlabel = inv.get(feat_idx[0], f"col{feat_idx[0]}")
        ylabel = inv.get(feat_idx[1], f"col{feat_idx[1]}")

    fig, ax = plt.subplots(figsize=(5.5, 4.5))
    # binary normal/fault keeps the reference's blue/red style (02:341-344)
    colors = {0: "tab:blue", 1: "tab:red"} if len(class_names) == 2 else {}
    _class_scatter(ax, x2d, y, class_names, colors)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, ls=":", alpha=0.4)
    ax.legend(fontsize=8, markerscale=2, frameon=True)
    return _finish(fig, save_path)


def plot_split_overview(results, boundary_lines: Sequence[int], save_path: str):
    """Voltage trace with segment boundaries (loader overview, 01:330-360)."""
    plt = pyplot()
    arr = _arr(results)
    fig, ax = plt.subplots(figsize=(11, 3))
    ax.plot(arr[:, INDEX["y_true"]], lw=0.5, c="k")
    for b in boundary_lines:
        ax.axvline(b, color="tab:red", lw=0.6, alpha=0.6)
    ax.set_ylabel("stack voltage [V]")
    ax.set_xlabel("sample")
    return _finish(fig, save_path)


def plot_roc_curves(auc_result, save_path: str):
    """All feature-group ROC curves + unsupervised overlay (02:546-611)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    for g in auc_result.groups:
        ax.plot(g.fpr, g.tpr, lw=1.2, label=f"group {g.group_id} [{g.features}] AUC={g.auc:.3f}")
    if auc_result.iso_fpr is not None:
        ax.plot(auc_result.iso_fpr, auc_result.iso_tpr, "--", lw=1.2,
                label=f"IsolationForest AUC={auc_result.iso_auc:.3f}")
    ax.plot([0, 1], [0, 1], ":", c="gray", lw=0.8)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend(fontsize=7, loc="lower right")
    return _finish(fig, save_path)


def _class_scatter(ax, x2d, labels, class_names=None, colors=None):
    """The class-colored 2-D scatter of plot_feature_scatter and
    plot_scatter_by_features."""
    colors = colors or {}
    for c in np.unique(labels):
        m = labels == c
        name = display_name(class_names[int(c)]) if class_names else str(int(c))
        ax.scatter(x2d[m, 0], x2d[m, 1], s=4, alpha=0.5, c=colors.get(int(c)), label=name)


def plot_feature_scatter(x2d: np.ndarray, labels: np.ndarray, save_path: str,
                         class_names: Optional[List[str]] = None, title: str = ""):
    """2-D scatter colored by class (02:233-285 / t-SNE output views)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5.5, 4.5))
    _class_scatter(ax, x2d, labels, class_names)
    ax.legend(fontsize=7, markerscale=2)
    if title:
        ax.set_title(title, fontsize=9)
    return _finish(fig, save_path)


def _normal_fault_scatter(results, save_path: str, x_key: str, y_key: str,
                          xlabel: str, ylabel: str):
    plt = pyplot()
    arr = _arr(results)
    m = arr[:, INDEX["label"]].astype(int) == 0
    fig, ax = plt.subplots(figsize=(5.5, 4))
    ax.scatter(arr[m, INDEX[x_key]], arr[m, INDEX[y_key]], s=4, alpha=0.4, label="normal",
               c="tab:blue")
    ax.scatter(arr[~m, INDEX[x_key]], arr[~m, INDEX[y_key]], s=4, alpha=0.4, label="fault",
               c="tab:red")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8, markerscale=2)
    return _finish(fig, save_path)


def plot_temp_vs_voltage(results, save_path: str):
    """Coolant-outlet temperature (x5) vs measured voltage, normal/fault
    colored (reference scatter view, 02:233-258)."""
    return _normal_fault_scatter(results, save_path, "x5", "y_true",
                                 "coolant outlet temperature [°C]", "stack voltage [V]")


def plot_res_vs_epi(results, save_path: str):
    """Prediction residual vs epistemic uncertainty, normal/fault colored
    (reference scatter view, 02:260-285)."""
    return _normal_fault_scatter(results, save_path, "res", "epi",
                                 "prediction residual [V]", "epistemic std [V]")


def tsne_embed(
    x: np.ndarray,
    perplexity: float = 30.0,
    random_state: int = 42,
    backend: str = "device",
    device="cuda",
):
    """t-SNE to 2-D (02:316-321, TSNE_PARAMS 02:63; 03:451-460), float64.

    backend="device" (default) runs the port's exact t-SNE
    (``diagnosis.tsne.tsne_fit``) on ``device``, its random draws from
    ``torch.Generator().manual_seed(random_state)``; backend="sklearn" runs
    the reference's CPU estimator and raises ``ImportError`` where
    scikit-learn is absent."""
    if backend not in ("device", "sklearn"):
        raise ValueError(f"backend must be 'device' or 'sklearn', got {backend!r}")
    if backend == "sklearn":
        try:
            from sklearn.manifold import TSNE
        except ImportError as e:
            raise ImportError("tsne_embed(backend='sklearn') needs scikit-learn, which is "
                              "not installed") from e
        return TSNE(n_components=2, perplexity=perplexity, init="pca",
                    random_state=random_state).fit_transform(np.asarray(x, np.float64))
    import torch

    from pinnfc_tpu_torch.diagnosis.tsne import tsne_fit

    out = tsne_fit(np.asarray(x, np.float32), torch.Generator().manual_seed(random_state),
                   perplexity=perplexity, device=device)
    return out.embedding.cpu().numpy().astype(np.float64)


# script-03 probability-figure style constants (03:36-48)
PROB_FIG_SIZE = (12, 4)
PROB_MARKERSIZE = 20
PROB_ALPHA = 0.75
DIAG_COLORS = {"水淹": "#e377c2", "氧饥饿": "#ff7f0e", "膜干": "#17becf", "氢饥饿": "#9464b8"}
FAULT_EN_TITLE = {
    "水淹": "Flooding",
    "氧饥饿": "Oxygen starvation",
    "膜干": "Membrane drying",
    "氢饥饿": "Hydrogen starvation",
}
FAULT_EN_SHORT = {
    "水淹": "flooding",
    "氧饥饿": "oxygen_starvation",
    "膜干": "membrane_drying",
    "氢饥饿": "hydrogen_starvation",
}


def fault_prob_filename(class_name: str) -> str:
    """Reference figure file name ``prob_<english short name>.png``
    (03:323-325)."""
    return f"prob_{FAULT_EN_SHORT.get(class_name, class_name)}.png"


def plot_fault_probabilities(gmm_result, fault_idx: int, save_path: str):
    """Class-probability scatter over the test samples whose TRUE condition
    is one fault type, reference plot_fault_probabilities_for_single_fault
    (03:209-327): fixed class colors, English title, (12, 4) canvas, dotted
    grid."""
    plt = pyplot()
    probs = gmm_result.y_prob[gmm_result.y_true == fault_idx]
    fig, ax = plt.subplots(figsize=PROB_FIG_SIZE)
    x = np.arange(len(probs))
    for j, name in enumerate(gmm_result.class_names):
        color = DIAG_COLORS.get(name, plt.cm.Dark2(j % 8))
        ax.scatter(x, probs[:, j], s=PROB_MARKERSIZE, c=[color], alpha=PROB_ALPHA, marker="o",
                   edgecolors="none", label=display_name(name))
    ax.set_xlabel("Sample Index")
    ax.set_ylabel("Probability")
    ax.set_ylim(-0.02, 1.02)
    ax.grid(True, ls=":", alpha=0.5)
    name = gmm_result.class_names[fault_idx]
    ax.set_title(FAULT_EN_TITLE.get(name, display_name(name)))
    return _finish(fig, save_path)


def plot_rf_condition(advance, warn_threshold: float, danger_threshold: float, save_path: str):
    """Dual-axis RF(t) vs voltage with risk bands and alarm markers
    (04:411-474)."""
    plt = pyplot()
    fig, ax1 = plt.subplots(figsize=(6, 3))
    t = np.arange(len(advance.voltage))
    ax1.plot(t, advance.voltage, c="k", lw=0.8, label="stack voltage")
    ax1.axhline(advance.v_threshold, ls="--", c="gray", lw=0.8, label="V threshold")
    ax1.set_ylabel("voltage [V]")
    ax1.set_xlabel("sample (condition-relative)")
    ax2 = ax1.twinx()
    ax2.plot(t, advance.rf_smooth, c="tab:red", lw=1.0, label="RF(t)")
    ax2.axhspan(warn_threshold, danger_threshold, color="orange", alpha=0.15)
    ax2.axhspan(danger_threshold, 1.0, color="red", alpha=0.12)
    ax2.set_ylim(0, 1.05)
    ax2.set_ylabel("RF(t)")
    if advance.idx_rf_alarm is not None:
        ax2.axvline(advance.idx_rf_alarm, c="tab:red", lw=0.8, ls=":")
    if advance.idx_v_alarm is not None:
        ax1.axvline(advance.idx_v_alarm, c="k", lw=0.8, ls=":")
    driver = getattr(advance, "dominant_layer", None)
    driver_txt = f"  driver={driver} {advance.layer_shares[driver]:.0%}" if driver else ""
    ax1.set_title(f"{advance.current_target:.0f}A {display_name(advance.fault_name)}  "
                  f"advance={advance.advance}{driver_txt}", fontsize=9)
    return _finish(fig, save_path)


def plot_rf_attribution(advance, save_path: str):
    """Stacked per-layer C_l(t) (Σ_l C_l = C exactly, ``risk/rf.py``) with
    the RF and voltage alarm markers: which physics layer built up the risk
    that crossed the threshold (decomposes 04:244-264)."""
    if not advance.layer_c:
        return None
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 3))
    names = list(advance.layer_c)
    series = [np.asarray(advance.layer_c[n], float) for n in names]
    t = np.arange(len(series[0]))
    colors = ["tab:red", "tab:blue", "tab:orange", "tab:green", "tab:purple"]
    shares = advance.layer_shares
    ax.stackplot(t, series,
                 labels=[f"{n} ({shares[n]:.0%} at alarm)" if n in shares else n for n in names],
                 colors=colors[: len(names)], alpha=0.75)
    if advance.idx_rf_alarm is not None:
        ax.axvline(advance.idx_rf_alarm, c="tab:red", lw=0.8, ls=":", label="RF alarm")
    if advance.idx_v_alarm is not None:
        ax.axvline(advance.idx_v_alarm, c="k", lw=0.8, ls=":", label="V alarm")
    ax.set_xlabel("sample (condition-relative)")
    ax.set_ylabel("risk integral C(t) composition")
    ax.legend(fontsize=7, loc="upper left")
    ax.set_title(f"{advance.current_target:.0f}A {display_name(advance.fault_name)} "
                 f"— risk attribution", fontsize=9)
    return _finish(fig, save_path)


def plot_confusion_matrix(cm: np.ndarray, class_names: List[str], save_path: str,
                          title: str = ""):
    """Counts + row-percentage annotations (05:104-174)."""
    plt = pyplot()
    cm = np.asarray(cm)
    row_sum = np.maximum(cm.sum(axis=1, keepdims=True), 1)
    pct = cm / row_sum * 100.0
    fig, ax = plt.subplots(figsize=(4.8, 4.2))
    im = ax.imshow(cm, cmap="Blues")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            color = "white" if cm[i, j] > cm.max() / 2 else "black"
            ax.text(j, i, f"{cm[i, j]}\n{pct[i, j]:.1f}%", ha="center", va="center",
                    fontsize=7, color=color)
    names = [display_name(c) for c in class_names]
    ax.set_xticks(range(len(names)), names, fontsize=7, rotation=30)
    ax.set_yticks(range(len(names)), names, fontsize=7)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    if title:
        ax.set_title(title, fontsize=9)
    fig.colorbar(im, shrink=0.8)
    return _finish(fig, save_path)


def plot_metrics_bars(summary: Dict[str, Dict[str, float]], save_path: str):
    """Grouped accuracy / macro-P/R/F1 bars per method with value labels
    (05:517-609)."""
    plt = pyplot()
    methods = list(summary.keys())
    metric_keys = ["accuracy", "precision_macro", "recall_macro", "f1_macro"]
    x = np.arange(len(metric_keys))
    width = 0.8 / max(len(methods), 1)
    fig, ax = plt.subplots(figsize=(8, 3.6))
    for i, m in enumerate(methods):
        vals = [summary[m][k] for k in metric_keys]
        bars = ax.bar(x + i * width, vals, width, label=m)
        for b, v in zip(bars, vals):
            ax.text(b.get_x() + b.get_width() / 2, v + 0.01, f"{v:.2f}", ha="center", fontsize=6)
    ax.set_xticks(x + 0.4 - width / 2, ["accuracy", "precision", "recall", "F1"])
    ax.set_ylim(0, 1.12)
    ax.legend(fontsize=7, ncol=3)
    return _finish(fig, save_path)


def plot_identifiability(report: Dict, save_path: str):
    """Horizontal bars of each λ's RELATIVE 95 % CI half-width, grouped by
    physics family, log scale, with unidentifiable / at-bound parameters
    named in text instead of drawn with an interval (``cli identify
    --plot-dir``; report from ``uq.lambda_identifiability``)."""
    plt = pyplot()
    import matplotlib.transforms as mtransforms

    rows = []  # (label, rel_halfwidth or None, flag)
    for g, gi in report.items():
        for i in range(len(gi.values)):
            # tick-sized name: the symbol before the " — " gloss, else a
            # truncated gloss
            label = f"{g}[{i}]"
            if i < len(gi.names):
                short = gi.names[i].split(" — ")[0]
                if len(short) > 26:
                    short = short[:25] + "…"
                label = f"{label} {short}"
            if not gi.identifiable[i]:
                rows.append((label, None, "unidentifiable"))
            elif gi.at_bound[i]:
                rows.append((label, None, "at bound"))
            else:
                denom = max(abs(float(gi.values[i])), 1e-30)
                rel = 1.959964 * float(gi.stderr[i]) / denom
                rows.append((label, max(rel, 1e-6), ""))
        rows.append((None, None, ""))  # group separator
    if rows and rows[-1][0] is None:
        rows.pop()

    fig, ax = plt.subplots(figsize=(7, 0.34 * len(rows) + 1.2))
    y = np.arange(len(rows))[::-1]
    finite = [r[1] for r in rows if r[1] is not None]
    lo = min(finite) if finite else 1e-2
    hi = max(finite) if finite else 1.0
    ax.set_xscale("log")
    # bars start at a common floor and the value labels get headroom; flag
    # text sits in axes coordinates so it never stretches the data range
    ax.set_xlim(lo / 3, hi * 30)
    flag_tf = mtransforms.blended_transform_factory(ax.transAxes, ax.transData)
    for yi, (label, rel, flag) in zip(y, rows):
        if label is None:
            continue
        if rel is not None:
            ax.barh(yi, rel, height=0.62, color="#4878cf")
            ax.text(rel * 1.3, yi, f"±{100 * rel:.3g}%", va="center", fontsize=7,
                    color="dimgray")
        else:
            ax.text(0.02, yi, flag, va="center", fontsize=7, color="dimgray", style="italic",
                    transform=flag_tf)
    ax.set_yticks(y, [r[0] or "" for r in rows], fontsize=7)
    ax.set_xlabel("relative 95% CI half-width (fraction of |λ|, log)", fontsize=8)
    ax.set_title("physics-parameter identifiability (Gauss-Newton)", fontsize=9)
    ax.grid(axis="x", alpha=0.25, lw=0.5)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    return _finish(fig, save_path)


def _annotated_heatmap(rows: Dict[str, np.ndarray], channel_names: Sequence[str],
                       cmap: str, signed: bool, title: str, cbar_label: str, save_path: str):
    """Class (or condition) × channel heatmap with value annotations, text
    color flipped on dark cells: sequential from 0 (``signed`` False) or
    zero-centred."""
    plt = pyplot()
    names = list(rows.keys())
    mat = np.stack([np.asarray(rows[n], float) for n in names])
    fig, ax = plt.subplots(figsize=(1.05 * mat.shape[1] + 2.2, 0.55 * mat.shape[0] + 1.6))
    if signed:
        vmax = float(np.abs(mat).max()) if mat.size and np.abs(mat).max() > 0 else 1.0
        im = ax.imshow(mat, cmap=cmap, vmin=-vmax, vmax=vmax, aspect="auto")
    else:
        vmax = float(mat.max()) if mat.size and mat.max() > 0 else 1.0
        im = ax.imshow(mat, cmap=cmap, vmin=0.0, vmax=vmax, aspect="auto")
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            v = mat[i, j]
            if signed:
                text, dark = (f"{v:+.2f}" if v else "0"), abs(v) > 0.6 * vmax
            else:
                text, dark = f"{v:.3g}", v > 0.6 * vmax
            ax.text(j, i, text, ha="center", va="center", fontsize=7,
                    color="white" if dark else "#1a1a2e")
    ax.set_xticks(range(mat.shape[1]), channel_names, fontsize=7, rotation=30, ha="right")
    ax.set_yticks(range(mat.shape[0]), names, fontsize=8)
    ax.set_title(title, fontsize=9)
    cbar = fig.colorbar(im, ax=ax, shrink=0.85)
    cbar.set_label(cbar_label, fontsize=7)
    cbar.ax.tick_params(labelsize=7)
    return _finish(fig, save_path)


def plot_saliency(class_table: Dict[str, np.ndarray], channel_names: Sequence[str],
                  save_path: str, unit: str = "V / full-range swing"):
    """Heatmap of mean |input saliency| per class × input channel (``cli
    explain --plot-dir``; table from ``uq.coarse_class_saliency``)."""
    return _annotated_heatmap(class_table, channel_names, "Blues", False,
                              "input-channel saliency of the voltage prediction",
                              f"mean |∂v̂/∂x| [{unit}]", save_path)


def plot_whatif(rows: Dict[str, np.ndarray], channel_names: Sequence[str], save_path: str,
                unit: str = "fraction of training range"):
    """Diverging heatmap of the mean SIGNED counterfactual actuation per
    risk condition × input channel (``cli whatif --plot-dir``): zero-centred
    RdBu_r, so the direction of the suggested move reads first."""
    return _annotated_heatmap(rows, channel_names, "RdBu_r", True,
                              "counterfactual recovery actuation (signed)",
                              f"mean Δ [{unit}]", save_path)


def plot_conformal(report, save_path: str):
    """Two-panel conformal summary (``cli conformal --plot-dir``; report from
    ``uq.conformal_report``).  Left: per-class coverage of v̂ ± q̂·σ̂
    against the 1−α guarantee line.  Right: per-class median conformal
    p-value (0.5 on exchangeable data, toward 1/(n+1) under shift), log
    scale."""
    plt = pyplot()
    classes = report.classes
    names = ["normal" if c.label == 0 else f"f{c.label:02d}" for c in classes]
    cov = np.asarray([c.coverage for c in classes], float)
    med_p = np.asarray([c.median_p for c in classes], float)
    is_normal = np.asarray([c.label == 0 for c in classes])

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(max(7.5, 0.62 * len(classes) + 3.5), 3.4))
    x = np.arange(len(classes))
    colors = np.where(is_normal, "#2a6fba", "#c44e52")
    ax1.bar(x, cov, color=colors)
    ax1.axhline(1.0 - report.alpha, color="#1a1a2e", lw=1.0, ls="--",
                label=f"guarantee ≥ {1 - report.alpha:g}")
    ax1.set_xticks(x, names, fontsize=7, rotation=45, ha="right")
    ax1.set_ylim(0.0, 1.05)
    ax1.set_ylabel("interval coverage", fontsize=8)
    ax1.set_title(f"conformal coverage (α={report.alpha:g}, {report.score} score)", fontsize=9)
    ax1.legend(fontsize=7)

    floor = 1.0 / (report.n_calib + 1.0)
    ax2.bar(x, np.maximum(med_p, floor), color=colors)
    ax2.axhline(0.5, color="#1a1a2e", lw=1.0, ls="--", label="exchangeable (0.5)")
    ax2.axhline(floor, color="#888888", lw=0.8, ls=":", label=f"floor 1/(n+1)={floor:.2g}")
    ax2.set_yscale("log")
    ax2.set_xticks(x, names, fontsize=7, rotation=45, ha="right")
    ax2.set_ylabel("median conformal p", fontsize=8)
    ax2.set_title(f"detection AUC {report.detection_auc:.3f}", fontsize=9)
    ax2.legend(fontsize=7)
    for ax in (ax1, ax2):
        ax.tick_params(labelsize=7)
    return _finish(fig, save_path)
