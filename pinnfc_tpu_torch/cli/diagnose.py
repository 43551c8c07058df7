"""``auc``, ``gmm``, ``compare``, ``conformal`` and ``report`` subcommands
(counterpart of ``pinnfc_tpu/cli/diagnose.py::cmd_auc``/``cmd_gmm``/
``cmd_compare``/``cmd_conformal``/``cmd_report``): the AUC table of script 02,
the 4-class GMM diagnosis of script 03, the six-method comparison of script
05, the split-conformal coverage table and the consolidated run report over
a ``comprehensive_results`` artifact, with the JAX commands' printed lines
and ``--plot-dir`` figures.  ``gmm --data-parallel`` splits the EM fit's rows
over every visible device of ``--device``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

from pinnfc_tpu_torch.cli._common import (
    _USER_ERRORS, _data_parallel_mesh, _draw_figures, _finite_or_none)


def _print_coefficients(results, cfg, topn: int, device) -> None:
    """Top-N LR coefficients per class for each feature group (02:209-229)."""
    from pinnfc_tpu_torch.data.contract import INDEX
    from pinnfc_tpu_torch.diagnosis import (
        build_label_mapper, explain_coefficients, extract_X_y, logreg_fit, parse_features,
        parse_group_spec)
    from pinnfc_tpu_torch.diagnosis.splits import stratified_split

    label_map, class_names = build_label_mapper(parse_group_spec(cfg.group_spec))
    inv = {v: k for k, v in INDEX.items()}
    for spec in cfg.feature_groups:
        feat_idx = parse_features(spec)
        x, y = extract_X_y(results.array, feat_idx, label_map)
        x_tr, _, y_tr, _ = stratified_split(
            x, y, y=y, test_size=cfg.test_size, random_state=cfg.random_state)
        model = logreg_fit(x_tr, y_tr, n_classes=len(class_names), balanced=cfg.balanced,
                           device=device)
        names = [inv.get(i, f"col{i}") for i in feat_idx]
        info = explain_coefficients(model, names, class_names, topn=topn)
        print(f"\nLR coefficients, features [{spec}]:")
        for cname, d in info.items():
            pos = ", ".join(f"{n}({w:+.3f})" for n, w in d["positive"])
            neg = ", ".join(f"{n}({w:+.3f})" for n, w in d["negative"])
            print(f"  {cname}: top+ {pos} | top- {neg}")


def cmd_auc(args) -> int:
    """Per feature group: its logistic regression's detection AUC and
    accuracy; then the Isolation Forest's AUC; with ``--show-coef N`` the
    top-N coefficients per class."""
    from pinnfc_tpu_torch.config import AucConfig
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.diagnosis import list_available_features, run_auc_pipeline

    if args.list_features:  # 02:455-458
        print("available features:", ", ".join(list_available_features()))
        return 0
    overrides = {k: v for k, v in (("group_spec", args.group_spec),
                                   ("test_size", args.test_size),
                                   ("balanced", args.balanced)) if v is not None}
    cfg = dataclasses.replace(AucConfig(), **overrides)
    try:
        results = load_comprehensive_results(args.mat)
        out = run_auc_pipeline(results, cfg, device=args.device)
    except _USER_ERRORS as e:
        print(f"auc: {e}", file=sys.stderr)
        return 1
    for g in out.groups:
        print(f"group {g.group_id} [{g.features}]  AUC={g.auc:.4f}  acc={g.accuracy:.4f}")
    print(f"unsupervised IsolationForest AUC={out.iso_auc:.4f}")
    if args.show_coef:
        _print_coefficients(results, cfg, args.show_coef, args.device)
    if args.plot_dir:
        return _draw_figures("auc", args.plot_dir, lambda: _auc_figures(args, cfg, results, out))
    return 0


def _auc_figures(args, cfg, results, out) -> None:
    from pinnfc_tpu_torch.viz import (
        plot_res_vs_epi, plot_roc_curves, plot_scatter_by_features, plot_temp_vs_voltage)

    # the PLOT_FEATURES scatter first, as the reference main does (02:470-476)
    plot_scatter_by_features(results, cfg.plot_features, cfg.group_spec,
                             os.path.join(args.plot_dir, "feature_scatter.png"),
                             random_state=cfg.random_state, device=args.device)
    plot_roc_curves(out, os.path.join(args.plot_dir, "roc.png"))
    plot_temp_vs_voltage(results, os.path.join(args.plot_dir, "temp_vs_v.png"))
    plot_res_vs_epi(results, os.path.join(args.plot_dir, "res_vs_epi.png"))


def cmd_gmm(args) -> int:
    """The 4-class GMM diagnosis: its accuracy and confusion matrix; with
    ``--plot-dir`` the confusion matrix and one class-probability figure per
    fault class, and with ``--tsne`` as well a t-SNE view of the test rows
    (03:429-508).  The fit stays on ``args.gmm_result``."""
    from pinnfc_tpu_torch.config import GmmConfig
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.diagnosis import run_gmm_pipeline

    cfg = GmmConfig()
    if args.init:
        cfg = dataclasses.replace(cfg, init=args.init)
    try:
        results = load_comprehensive_results(args.mat)
        mesh = _data_parallel_mesh(args)
        if mesh is not None:
            print(f"GMM EM data-parallel over {mesh.size} devices")
        out = run_gmm_pipeline(results, cfg, device=args.device, mesh=mesh)
    except _USER_ERRORS as e:
        print(f"gmm: {e}", file=sys.stderr)
        return 1
    args.gmm_result = out
    print(f"GMM 4-class accuracy: {out.accuracy:.4f}")
    print("confusion:\n", out.confusion)
    if args.plot_dir:
        return _draw_figures("gmm", args.plot_dir, lambda: _gmm_figures(args, results, out))
    return 0


def _gmm_figures(args, results, out) -> None:
    from pinnfc_tpu_torch.viz import (
        fault_prob_filename, plot_confusion_matrix, plot_fault_probabilities)

    plot_confusion_matrix(out.confusion, out.class_names,
                          os.path.join(args.plot_dir, "gmm_confusion.png"), title="GMM")
    for k, cname in enumerate(out.class_names):
        plot_fault_probabilities(out, k, os.path.join(args.plot_dir, fault_prob_filename(cname)))
    if args.tsne:  # 03:429-508
        from pinnfc_tpu_torch.diagnosis import parse_features
        from pinnfc_tpu_torch.viz import plot_feature_scatter, tsne_embed

        x_te = results.array[out.test_full_indices][:, parse_features(out.features)]
        emb = tsne_embed(x_te, perplexity=20.0, device=args.device)
        plot_feature_scatter(emb, out.y_pred, os.path.join(args.plot_dir, "gmm_tsne.png"),
                             out.class_names, title="t-SNE of test samples (predicted class)")


def cmd_compare(args) -> int:
    """The six methods of script 05 (or ``--methods``): one line of macro
    metrics each."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.diagnosis import run_compare_pipeline

    methods = args.methods.split(",") if args.methods else None
    try:
        results = load_comprehensive_results(args.mat)
        out = run_compare_pipeline(results, methods=methods, device=args.device)
    except _USER_ERRORS as e:
        print(f"compare: {e}", file=sys.stderr)
        return 1
    for m in out.methods:
        print(f"{m.name:>15}: " + "  ".join(f"{k}={v:.4f}" for k, v in m.metrics.items()))
    if args.plot_dir:
        return _draw_figures("compare", args.plot_dir, lambda: _compare_figures(args, out))
    return 0


def _compare_figures(args, out) -> None:
    from pinnfc_tpu_torch.viz import plot_confusion_matrix, plot_metrics_bars

    for m in out.methods:
        plot_confusion_matrix(m.confusion, out.class_names,
                              os.path.join(args.plot_dir, f"confusion_{m.name}.png"),
                              title=m.name)
    plot_metrics_bars(out.summary_table(), os.path.join(args.plot_dir, "method_metrics.png"))


def cmd_conformal(args) -> int:
    """Split-conformal analysis of an artifact (``uq/conformal``), on the
    host: the 1−α coverage of v̂ ± q̂·σ̂ calibrated on held-out normal rows,
    the per-fault miscoverage, and the detection AUC of the anomaly score
    1−p."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.uq import conformal_report

    try:
        results = load_comprehensive_results(args.mat)
        rep = conformal_report(results.array, alpha=args.alpha, score=args.score,
                               calib_frac=args.calib_frac, seed=args.seed)
        if args.plot_dir:
            from pinnfc_tpu_torch.viz import plot_conformal

            os.makedirs(args.plot_dir, exist_ok=True)
            path = os.path.join(args.plot_dir, "conformal_coverage.png")
            plot_conformal(rep, path)
            print(f"figure → {path}")
    except _USER_ERRORS as e:
        print(f"conformal: {e}", file=sys.stderr)
        return 1

    if args.json:
        print(json.dumps(_finite_or_none(rep.to_dict()), indent=2, allow_nan=False))
        return 0

    kind = "|res|/σ̂ (adaptive width)" if rep.score == "adaptive" else "|res| (constant width)"
    print(f"split conformal at α={rep.alpha:g}, score {kind}: "
          f"q̂={rep.q_hat:.4g} from {rep.n_calib} calibration normals"
          + (f" ({rep.n_dropped} non-finite dropped)" if rep.n_dropped else ""))
    print(f"{'class':>6} {'n':>6} {'coverage':>9} {'width[V]':>9} "
          f"{'median p':>9} {'p≤α':>7}")
    for c in rep.classes:
        tag = "normal" if c.label == 0 else f"f{c.label:02d}"
        print(f"{tag:>6} {c.n:>6} {c.coverage:>9.3f} {c.mean_width:>9.3g} "
              f"{c.median_p:>9.3f} {c.frac_low_p:>7.3f}")
    ne = rep.normal_eval
    print(f"held-out normal coverage {ne.coverage:.3f} vs guaranteed "
          f"≥ {1 - rep.alpha:g}; conformal detection AUC {rep.detection_auc:.4f}")
    return 0


def cmd_report(args) -> int:
    """Consolidated markdown run report (``utils/report``): every downstream
    stage's findings — AUC, GMM, RF(t) advance table with layer drivers,
    method comparison, conformal audit, identifiability and saliency — plus
    checkpoint provenance and the figure gallery, in ONE report.md next to
    the artifact; the pipelines on ``--device``.  ``--json``/``--json-out``
    give the artifact's metric vector."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.utils.report import artifact_metrics, write_report

    try:
        results = load_comprehensive_results(args.mat)
        json_out = getattr(args, "json_out", None)
        if getattr(args, "json", False) or json_out:
            # the machine-readable regression vector (the numbers the
            # baseline section diffs), strict JSON: NaN → null
            metrics = _finite_or_none(artifact_metrics(results, device=args.device))
            doc = json.dumps(metrics, indent=2, allow_nan=False)
            if json_out:
                with open(json_out, "w") as f:
                    f.write(doc + "\n")
                print(f"metrics → {json_out}")
            if getattr(args, "json", False):
                print(doc)
                return 0
        baseline_path = getattr(args, "baseline", None)
        baseline = load_comprehensive_results(baseline_path) if baseline_path else None
        out = args.out or os.path.join(os.path.dirname(os.path.abspath(args.mat)), "report.md")
        sections = args.sections.split(",") if args.sections else None
        path = write_report(out, results, ckpt_path=getattr(args, "ckpt", None),
                            figures_dir=getattr(args, "plot_dir", None), sections=sections,
                            mat_path=args.mat, baseline=baseline, baseline_path=baseline_path,
                            device=args.device)
    except _USER_ERRORS as e:
        print(f"report: {e}", file=sys.stderr)
        return 1
    print(f"report → {path}")
    return 0
