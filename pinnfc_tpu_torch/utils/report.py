"""One-file markdown run report over an exported artifact (counterpart of
``pinnfc_tpu/utils/report.py``; the document's text is the JAX package's).

``build_report`` renders what the downstream stages compute — checkpoint
provenance, artifact overview, the script-02 AUC table (02:444-611),
script-03 GMM accuracy (03:513-591), the script-04 risk/advance table with
per-layer attribution (04:479-528), the script-05 method comparison
(05:614-707), the split-conformal audit, and (when the checkpoint is given)
the model-level explainability tables — λ identifiability CIs and per-class
input-channel saliency — into ONE ``report.md`` next to the artifact, with
the figure gallery linked.  The pipelines run on ``device`` (the card by
default); the conformal audit on the host.

Each section is independently fault-tolerant: a stage that cannot run on a
given artifact (too few rows, no faults, missing checkpoint) degrades to a
note in the report instead of failing the run.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Dict, Optional, Sequence

import numpy as np

from pinnfc_tpu_torch.data.contract import INDEX

ALL_SECTIONS = (
    "provenance",
    "overview",
    "auc",
    "gmm",
    "risk",
    "compare",
    "conformal",
    "identifiability",
    "saliency",
    "baseline",
    "figures",
)

_NO_CKPT_NOTE = "_no checkpoint given (`--ckpt`) — model-level section omitted_"


def _ckpt_with_scalers(ckpt_path, device):
    """Load a checkpoint onto ``device`` for the model-level sections;
    returns ``(ckpt, None)`` on success or ``(None, degrade-note)``."""
    if not ckpt_path:
        return None, _NO_CKPT_NOTE
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(ckpt_path, device=device)
    if "scaler_x" not in ckpt or "scaler_y" not in ckpt:
        return None, (f"_`{ckpt_path}` has no stored scalers — cannot "
                      "normalize the artifact rows_")
    return ckpt, None


def artifact_metrics(results, device="cuda") -> Dict[str, float]:
    """Compact scalar summary of one artifact — the regression-tracking
    vector the baseline section diffs.  Keys are stable across versions and
    the JAX package's; the pipelines run on ``device``."""
    arr = results.array if hasattr(results, "array") else np.asarray(results)
    out: Dict[str, float] = {"rows": float(len(arr))}
    res = arr[:, INDEX["res"]]
    finite = np.isfinite(res)
    out["voltage_mae"] = float(np.abs(res[finite]).mean()) if finite.any() else float("nan")
    out["voltage_rmse"] = (
        float(np.sqrt((res[finite] ** 2).mean())) if finite.any() else float("nan")
    )
    out["mean_aleatoric"] = float(np.nanmean(arr[:, INDEX["ale"]]))
    out["mean_epistemic"] = float(np.nanmean(arr[:, INDEX["epi"]]))

    from pinnfc_tpu_torch.diagnosis.auc import run_auc_pipeline

    auc_out = run_auc_pipeline(arr, device=device)
    for g in auc_out.groups:
        out[f"auc_group{g.group_id}"] = float(g.auc)
        out[f"accuracy_group{g.group_id}"] = float(g.accuracy)
    if auc_out.iso_auc is not None:
        out["isoforest_auc"] = float(auc_out.iso_auc)

    from pinnfc_tpu_torch.diagnosis.gmm_pipeline import run_gmm_pipeline

    out["gmm_accuracy"] = float(run_gmm_pipeline(arr, device=device).accuracy)

    from pinnfc_tpu_torch.risk import run_risk_pipeline

    advances = run_risk_pipeline(arr, device=device)
    leads = [a.advance for a in advances if a.advance is not None]
    out["risk_conditions"] = float(len(advances))
    out["risk_conditions_with_lead"] = float(len(leads))
    out["mean_rf_advance"] = float(np.mean(leads)) if leads else float("nan")

    from pinnfc_tpu_torch.uq.conformal import conformal_report

    rep = conformal_report(arr)
    out["conformal_normal_coverage"] = float(rep.normal_eval.coverage)
    out["conformal_detection_auc"] = float(rep.detection_auc)
    return out


def _md_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    out = ["| " + " | ".join(str(h) for h in headers) + " |",
           "|" + "---|" * len(headers)]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def _fmt(v, nd: int = 4) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}f}" if np.isfinite(v) else "—"
    return str(v)


def _section_provenance(arr, ckpt_path, device) -> str:
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint_meta

    if not ckpt_path:
        return "_no checkpoint given (`--ckpt`) — provenance omitted_"
    meta = load_checkpoint_meta(ckpt_path)
    if not meta:
        return f"`{ckpt_path}` has no provenance sidecar (pre-metadata checkpoint)"
    rows = [(k, _fmt(meta[k]) if isinstance(meta[k], float) else meta[k])
            for k in sorted(meta) if not isinstance(meta[k], (dict, list))]
    body = _md_table(["field", "value"], rows)
    cfg = meta.get("config")
    if isinstance(cfg, dict):
        body += "\n\nTraining config: `" + ", ".join(
            f"{k}={v}" for k, v in sorted(cfg.items())) + "`"
    return body


def _section_overview(arr, ckpt_path, device) -> str:
    labels = arr[:, INDEX["label"]].astype(int)
    res = arr[:, INDEX["res"]]
    finite = np.isfinite(res)
    mae = float(np.abs(res[finite]).mean()) if finite.any() else float("nan")
    rmse = float(np.sqrt((res[finite] ** 2).mean())) if finite.any() else float("nan")
    lines = [
        f"- rows: **{len(arr)}** "
        f"(normal {int((labels == 0).sum())}, "
        f"fault {int((labels != 0).sum())} over "
        f"{len([l for l in np.unique(labels) if l != 0])} segments)",
        f"- voltage MAE **{_fmt(mae)} V**, RMSE **{_fmt(rmse)} V** "
        f"(columns {INDEX['y_true']}/{INDEX['y_pred']})",
        f"- mean aleatoric σ {_fmt(float(np.nanmean(arr[:, INDEX['ale']])))} V, "
        f"mean epistemic σ {_fmt(float(np.nanmean(arr[:, INDEX['epi']])))} V "
        "(smoothed, de-normalized)",
    ]
    seg_rows = [(int(l), int((labels == l).sum())) for l in np.unique(labels)]
    lines.append("")
    lines.append(_md_table(["label", "rows"], seg_rows))
    return "\n".join(lines)


def _section_auc(arr, ckpt_path, device) -> str:
    from pinnfc_tpu_torch.diagnosis.auc import run_auc_pipeline

    out = run_auc_pipeline(arr, device=device)
    rows = [
        (g.group_id, f"`{g.features}`", _fmt(g.auc), _fmt(g.accuracy))
        for g in out.groups
    ]
    body = _md_table(["group", "features", "AUC", "accuracy"], rows)
    if out.iso_auc is not None:
        body += f"\n\nIsolationForest (unsupervised, group 1): AUC **{_fmt(out.iso_auc)}**"
    return body


def _section_gmm(arr, ckpt_path, device) -> str:
    from pinnfc_tpu_torch.diagnosis.gmm_pipeline import run_gmm_pipeline

    out = run_gmm_pipeline(arr, device=device)
    body = (
        f"GMM ({out.model.means.shape[0]} components on `{out.features}`): "
        f"test accuracy **{_fmt(out.accuracy)}**\n\n"
    )
    k = len(out.class_names)
    body += _md_table(
        ["true \\ pred"] + list(out.class_names),
        [[out.class_names[i]] + [int(v) for v in out.confusion[i]] for i in range(k)],
    )
    return body


def _section_risk(arr, ckpt_path, device) -> str:
    from pinnfc_tpu_torch.risk import run_risk_pipeline

    advances = run_risk_pipeline(arr, device=device)
    if not advances:
        return "_no risk conditions present in this artifact_"
    rows = []
    for a in advances:
        driver = (
            f"{a.dominant_layer} {a.layer_shares[a.dominant_layer]:.0%}"
            if a.layer_shares else "—"
        )
        rows.append((
            f"{a.current_target:g} A", a.fault_name, a.n_samples,
            _fmt(a.idx_rf_alarm), _fmt(a.idx_v_alarm), _fmt(a.advance), driver,
        ))
    body = _md_table(
        ["current", "fault", "n", "RF alarm", "V alarm", "advance", "driver"], rows
    )
    both = [a.advance for a in advances if a.advance is not None]
    if both:
        body += (f"\n\nMean RF(t) lead over the voltage alarm: "
                 f"**{np.mean(both):.0f} samples** "
                 f"({len(both)}/{len(advances)} conditions with both alarms)")
    return body


def _section_compare(arr, ckpt_path, device) -> str:
    from pinnfc_tpu_torch.diagnosis.compare import run_compare_pipeline

    out = run_compare_pipeline(arr, device=device)
    metric_names = list(out.methods[0].metrics) if out.methods else []
    rows = [
        [m.name] + [_fmt(m.metrics.get(k)) for k in metric_names]
        for m in out.methods
    ]
    return _md_table(["method"] + metric_names, rows)


def _section_conformal(arr, ckpt_path, device) -> str:
    from pinnfc_tpu_torch.uq.conformal import conformal_report

    rep = conformal_report(arr)
    rows = [
        ("normal" if c.label == 0 else f"fault {c.label}",
         c.n, _fmt(c.coverage, 3), _fmt(c.mean_width, 3),
         _fmt(c.median_p, 3), _fmt(c.frac_low_p, 3))
        for c in rep.classes
    ]
    body = (
        f"Split conformal at α={rep.alpha:g} "
        f"(q̂={rep.q_hat:.4g} from {rep.n_calib} calibration normals):\n\n"
        + _md_table(["class", "n", "coverage", "width [V]", "median p", "p≤α"], rows)
    )
    ne = rep.normal_eval
    body += (f"\n\nHeld-out normal coverage **{_fmt(ne.coverage, 3)}** vs "
             f"guaranteed ≥ {1 - rep.alpha:g}; detection AUC "
             f"**{_fmt(rep.detection_auc)}**")
    return body


def _section_identifiability(arr, ckpt_path, device) -> str:
    """Gauss-Newton 95% CIs of the 17 physics λ's (uq/identifiability) —
    the 'how well are the physics parameters pinned down' audit that
    `cli identify` prints, rendered per stage group."""
    ckpt, note = _ckpt_with_scalers(ckpt_path, device)
    if note:
        return note
    from pinnfc_tpu_torch.uq.identifiability import lambda_identifiability

    x_raw = arr[:, [INDEX[f"x{i}"] for i in range(8)]]
    x_norm = np.asarray(
        ckpt["scaler_x"].transform(x_raw.astype(np.float32)), np.float32
    )
    report = lambda_identifiability(
        ckpt["params"], x_norm, ckpt["scaler_x"], ckpt["scaler_y"]
    )
    blocks = []
    for g, gi in report.items():
        rows = []
        for i, name in enumerate(gi.names):
            if not gi.identifiable[i]:
                ci, flag = "—", "UNIDENTIFIABLE"
            else:
                ci = f"± {1.959964 * gi.stderr[i]:.4g}"
                flag = "at-bound" if gi.at_bound[i] else ""
            rows.append((f"{g}[{i}]", name, f"{gi.values[i]:.6g}", ci,
                         f"{gi.sensitivity[i]:.3g}", flag))
        block = (
            f"**{g}** (N={gi.n_residuals}, σ̂²={gi.sigma2:.4g})\n\n"
            + _md_table(
                ["param", "physical meaning", "value", "95% CI",
                 "sensitivity", ""], rows)
        )
        coupled = [
            f"`{g}[{i}]` ↔ `{g}[{j}]` (corr {gi.corr[i, j]:+.3f})"
            for i in range(len(gi.names))
            for j in range(i + 1, len(gi.names))
            if np.isfinite(gi.corr[i, j]) and abs(gi.corr[i, j]) > 0.95
        ]
        if coupled:
            block += ("\n\nOnly jointly identified (sloppy directions): "
                      + "; ".join(coupled))
        blocks.append(block)
    return "\n\n".join(blocks)


def _section_saliency(arr, ckpt_path, device) -> str:
    """Per-class input-channel saliency (uq/saliency): which of the 8
    measured inputs each class's voltage prediction leans on, in volts
    per full training-range swing — `cli explain`'s table."""
    ckpt, note = _ckpt_with_scalers(ckpt_path, device)
    if note:
        return note
    from pinnfc_tpu_torch.data.contract import INPUT_CHANNELS
    from pinnfc_tpu_torch.uq.saliency import coarse_class_saliency, input_saliency

    labels = arr[:, INDEX["label"]].astype(int)
    x_raw = arr[:, [INDEX[f"x{i}"] for i in range(8)]]
    rep = input_saliency(
        ckpt["params"], x_raw, ckpt["scaler_x"], ckpt["scaler_y"],
        labels=labels, device=device,
    )
    body = ["Mean |∂v̂/∂x| per class, volts per full training-range swing "
            "(driver = the channel the prediction leans on most):", ""]
    for field, label in (("jac_range", "voltage head"),
                         ("sigma_jac_range", "aleatoric-σ head")):
        table = coarse_class_saliency(rep, field)
        rows = [
            [name] + [f"{v:.3g}" for v in vals]
            + [INPUT_CHANNELS[int(np.argmax(vals))]]
            for name, vals in table.items()
        ]
        body.append(f"**{label}**")
        body.append("")
        body.append(_md_table(
            ["class"] + list(INPUT_CHANNELS) + ["driver"], rows))
        body.append("")
    return "\n".join(body).rstrip()


_SECTION_TITLES = {
    "provenance": "Checkpoint provenance",
    "overview": "Artifact overview",
    "auc": "Supervised detection (script 02)",
    "gmm": "Unsupervised GMM diagnosis (script 03)",
    "risk": "RF(t) early warning (script 04)",
    "compare": "Method comparison (script 05)",
    "conformal": "Conformal calibration audit",
    "identifiability": "Physics-parameter identifiability",
    "saliency": "Input-channel saliency",
    "baseline": "Regression vs baseline",
    "figures": "Figures",
}

# direction of improvement for the baseline diff; metrics not listed are
# informational (no regression flag)
_HIGHER_IS_BETTER = {
    "auc_group1", "auc_group2", "auc_group3", "auc_group4",
    "accuracy_group1", "accuracy_group2", "accuracy_group3", "accuracy_group4",
    "isoforest_auc", "gmm_accuracy", "mean_rf_advance",
    "risk_conditions_with_lead", "conformal_normal_coverage",
    "conformal_detection_auc",
}
_LOWER_IS_BETTER = {"voltage_mae", "voltage_rmse"}


def _section_baseline(arr, baseline, baseline_path, device) -> str:
    if baseline is None:
        return "_no baseline artifact given (`--baseline`) — comparison omitted_"
    cur = artifact_metrics(arr, device)
    base = artifact_metrics(baseline, device)
    rows = []
    regressions = 0
    for k in cur:
        if k not in base:
            continue
        c, b = cur[k], base[k]
        delta = c - b if np.isfinite(c) and np.isfinite(b) else float("nan")
        flag = ""
        if np.isfinite(delta):
            worse = (k in _HIGHER_IS_BETTER and delta < 0) or (
                k in _LOWER_IS_BETTER and delta > 0
            )
            # flag only material moves: >1% relative (or absolute for
            # near-zero baselines)
            if worse and abs(delta) > max(0.01 * abs(b), 1e-6):
                flag = "⚠ regressed"
                regressions += 1
        rows.append((k, _fmt(c), _fmt(b), _fmt(delta), flag))
    head = f"Baseline: `{baseline_path or '(in-memory)'}`\n\n"
    body = head + _md_table(["metric", "this run", "baseline", "Δ", ""], rows)
    body += (
        f"\n\n**{regressions} material regression(s)** vs baseline"
        if regressions else "\n\nNo material regressions vs baseline."
    )
    return body

_SECTION_FNS = {
    "provenance": _section_provenance,
    "overview": _section_overview,
    "auc": _section_auc,
    "gmm": _section_gmm,
    "risk": _section_risk,
    "compare": _section_compare,
    "conformal": _section_conformal,
    "identifiability": _section_identifiability,
    "saliency": _section_saliency,
}


def build_report(
    results,
    ckpt_path: Optional[str] = None,
    figures_dir: Optional[str] = None,
    report_dir: Optional[str] = None,
    sections: Optional[Sequence[str]] = None,
    mat_path: Optional[str] = None,
    baseline=None,
    baseline_path: Optional[str] = None,
    device="cuda",
) -> str:
    """Render the consolidated markdown report; returns the document.

    ``figures_dir`` is linked relative to ``report_dir`` (the directory the
    report will be written to) so the gallery works wherever the report
    lands.  ``sections`` subsets/reorders ``ALL_SECTIONS``.  ``baseline``
    (another artifact) adds a direction-aware metric diff — the regression
    check for retrain/rescore workflows.  The pipelines run on ``device``.
    """
    arr = results.array if hasattr(results, "array") else np.asarray(results)
    if baseline is not None:
        baseline = (
            baseline.array if hasattr(baseline, "array") else np.asarray(baseline)
        )
    picked = list(sections) if sections is not None else list(ALL_SECTIONS)
    if sections is None and baseline is None:
        picked.remove("baseline")  # default report: no empty placeholder
    unknown = [s for s in picked if s not in ALL_SECTIONS]
    if unknown:
        raise ValueError(f"unknown report sections {unknown}; "
                         f"valid: {', '.join(ALL_SECTIONS)}")

    doc = ["# pinnfc_tpu run report", ""]
    doc.append(f"- generated: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    if mat_path:
        doc.append(f"- artifact: `{mat_path}`")
    if ckpt_path:
        doc.append(f"- checkpoint: `{ckpt_path}`")
    doc.append("")

    for name in picked:
        doc.append(f"## {_SECTION_TITLES[name]}")
        doc.append("")
        try:
            if name == "figures":
                doc.append(_figures_gallery(figures_dir, report_dir))
            elif name == "baseline":
                doc.append(_section_baseline(arr, baseline, baseline_path, device))
            else:
                doc.append(_SECTION_FNS[name](arr, ckpt_path, device))
        except Exception as e:  # degrade, never fail the run
            doc.append(f"_section unavailable: {type(e).__name__}: {e}_")
            doc.append("")
            doc.append("```\n" + traceback.format_exc(limit=2).strip() + "\n```")
        doc.append("")
    return "\n".join(doc).rstrip() + "\n"


def _figures_gallery(figures_dir: Optional[str], report_dir: Optional[str]) -> str:
    if not figures_dir or not os.path.isdir(figures_dir):
        return "_no figures directory_"
    pngs = sorted(
        f for f in os.listdir(figures_dir) if f.lower().endswith((".png", ".svg"))
    )
    if not pngs:
        return "_figures directory is empty_"
    base = os.path.relpath(figures_dir, report_dir) if report_dir else figures_dir
    return "\n".join(
        f"- [{os.path.splitext(f)[0]}]({os.path.join(base, f)})" for f in pngs
    )


def write_report(
    path: str,
    results,
    ckpt_path: Optional[str] = None,
    figures_dir: Optional[str] = None,
    sections: Optional[Sequence[str]] = None,
    mat_path: Optional[str] = None,
    baseline=None,
    baseline_path: Optional[str] = None,
    device="cuda",
) -> str:
    """Build and atomically write the report; returns ``path``."""
    doc = build_report(
        results,
        ckpt_path=ckpt_path,
        figures_dir=figures_dir,
        report_dir=os.path.dirname(os.path.abspath(path)),
        sections=sections,
        mat_path=mat_path,
        baseline=baseline,
        baseline_path=baseline_path,
        device=device,
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(doc)
    os.replace(tmp, path)
    return path
