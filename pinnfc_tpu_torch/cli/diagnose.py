"""``auc``, ``gmm`` and ``compare`` subcommands (counterpart of
``pinnfc_tpu/cli/diagnose.py::cmd_auc``/``cmd_gmm``/``cmd_compare``): the AUC
table of script 02, the 4-class GMM diagnosis of script 03 and the
six-method comparison of script 05 over a ``comprehensive_results``
artifact, with the JAX commands' printed lines.

Flags of the JAX commands left out: ``--plot-dir`` (all three) and ``gmm
--tsne`` wait for ``viz/``; ``gmm --data-parallel`` waits for ``parallel/``
(ROADMAP.md Queue 1 items 6 and 7).
"""

from __future__ import annotations

import dataclasses
import sys

# what a run can fail with that the user can act on: no card, an unreadable
# artifact, a bad spec, scikit-learn missing for --init sklearn
_USER_ERRORS = (RuntimeError, ValueError, KeyError, OSError, ImportError)


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
    return 0


def cmd_gmm(args) -> int:
    """The 4-class GMM diagnosis: its accuracy and confusion matrix."""
    from pinnfc_tpu_torch.config import GmmConfig
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.diagnosis import run_gmm_pipeline

    cfg = GmmConfig()
    if args.init:
        cfg = dataclasses.replace(cfg, init=args.init)
    try:
        results = load_comprehensive_results(args.mat)
        out = run_gmm_pipeline(results, cfg, device=args.device)
    except _USER_ERRORS as e:
        print(f"gmm: {e}", file=sys.stderr)
        return 1
    print(f"GMM 4-class accuracy: {out.accuracy:.4f}")
    print("confusion:\n", out.confusion)
    return 0


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
    return 0
