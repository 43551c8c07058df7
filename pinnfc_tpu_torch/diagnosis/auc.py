"""Supervised & unsupervised fault-detection AUC (counterpart of
``pinnfc_tpu/diagnosis/auc.py``; reference script 02).

Four feature groups (02:41-47) each get a balanced multinomial logistic
regression (Newton on the device, ``diagnosis/logreg.py``) and a binary ROC
built from ``1 − P(normal)`` (02:546-569); group 1 additionally gets an
unsupervised Isolation Forest trained on normal-only rows (02:571-611) —
the batched torch forest by default (``diagnosis/isoforest.py``, draws from
a CPU ``torch.Generator`` seeded by ``random_state``), or sklearn's
estimator with ``AucConfig.iso_backend='sklearn'`` where scikit-learn is
installed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from pinnfc_tpu_torch.config import AucConfig
from pinnfc_tpu_torch.data.contract import ComprehensiveResults
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.features import (
    build_label_mapper,
    extract_X_y,
    parse_features,
    parse_group_spec,
)
from pinnfc_tpu_torch.diagnosis.isoforest import isoforest_fit, isoforest_score
from pinnfc_tpu_torch.diagnosis.logreg import logreg_fit, logreg_predict_proba
from pinnfc_tpu_torch.diagnosis.metrics import (
    accuracy_score,
    auc,
    classification_report_dict,
    confusion_matrix,
    roc_curve,
)
from pinnfc_tpu_torch.diagnosis.splits import stratified_split


@dataclasses.dataclass
class GroupAucResult:
    group_id: int
    features: str
    auc: float
    accuracy: float
    fpr: np.ndarray
    tpr: np.ndarray
    confusion: np.ndarray
    report: Dict


@dataclasses.dataclass
class AucPipelineResult:
    groups: List[GroupAucResult]
    iso_auc: Optional[float]
    iso_fpr: Optional[np.ndarray]
    iso_tpr: Optional[np.ndarray]
    class_names: List[str]


def _sklearn_iso_scores(x_iso: np.ndarray, x_te: np.ndarray, config: AucConfig) -> np.ndarray:
    """``-score_samples`` of sklearn's IsolationForest (02:583-596)."""
    try:
        from sklearn.ensemble import IsolationForest
    except ImportError as e:
        raise ImportError("AucConfig.iso_backend='sklearn' needs scikit-learn, which cannot "
                          "be imported here; use iso_backend='device'") from e
    iso = IsolationForest(n_estimators=config.iso_n_estimators, contamination="auto",
                          random_state=config.random_state)
    iso.fit(x_iso)
    return -iso.score_samples(x_te)


def run_auc_pipeline(results, config: AucConfig = AucConfig(),
                     device="cuda") -> AucPipelineResult:
    """Script-02 main loop (02:444-611); the fits run on ``device``."""
    if config.iso_backend not in ("device", "sklearn"):
        raise ValueError(f"AucConfig.iso_backend must be 'device' or 'sklearn', "
                         f"got {config.iso_backend!r}")
    dev = resolve_device(device)
    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    groups = parse_group_spec(config.group_spec)
    label_map, class_names = build_label_mapper(groups)
    n_classes = len(class_names)

    out_groups: List[GroupAucResult] = []
    iso_auc = iso_fpr = iso_tpr = None

    for gid, feat_spec in enumerate(config.feature_groups, start=1):
        feat_idx = parse_features(feat_spec)
        x, y = extract_X_y(arr, feat_idx, label_map)
        x_tr, x_te, y_tr, y_te = stratified_split(
            x, y, y=y, test_size=config.test_size, random_state=config.random_state
        )

        model = logreg_fit(x_tr, y_tr, n_classes=n_classes, balanced=config.balanced,
                           device=dev)
        proba = logreg_predict_proba(model, x_te).cpu().numpy()
        y_pred = proba.argmax(axis=1)

        # binary ROC: positive = "not normal", score = 1 − P(normal); the
        # normal class is resolved BY NAME with fallback 0, as the reference
        # does (02:546-552)
        normal_idx = class_names.index("正常") if "正常" in class_names else 0
        y_bin = (y_te != normal_idx).astype(int)
        score = 1.0 - proba[:, normal_idx]
        fpr, tpr, _ = roc_curve(y_bin, score)

        out_groups.append(
            GroupAucResult(
                group_id=gid,
                features=feat_spec,
                auc=auc(fpr, tpr),
                accuracy=accuracy_score(y_te, y_pred),
                fpr=fpr,
                tpr=tpr,
                confusion=confusion_matrix(y_te, y_pred, n_classes),
                report=classification_report_dict(y_te, y_pred, class_names),
            )
        )

        # unsupervised Isolation Forest on group 1 (02:571-611), fit on
        # normal-only training rows — falling back to ALL training rows when
        # too few normal ones exist, as the reference does (02:577-583)
        if gid == 1:
            x_iso = x_tr[y_tr == normal_idx]
            if len(x_iso) <= 10:
                x_iso = x_tr
            if config.iso_backend == "device":
                iso = isoforest_fit(
                    x_iso,
                    torch.Generator().manual_seed(config.random_state),
                    n_estimators=config.iso_n_estimators,
                    max_samples=config.iso_max_samples,
                    device=dev,
                )
                iso_score = isoforest_score(iso, x_te).cpu().numpy()
            else:
                iso_score = _sklearn_iso_scores(x_iso, x_te, config)
            iso_fpr, iso_tpr, _ = roc_curve(y_bin, iso_score)
            iso_auc = auc(iso_fpr, iso_tpr)

    return AucPipelineResult(
        groups=out_groups,
        iso_auc=iso_auc,
        iso_fpr=iso_fpr,
        iso_tpr=iso_tpr,
        class_names=class_names,
    )
