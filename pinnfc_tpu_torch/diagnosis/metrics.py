"""Classification metrics in plain numpy, sklearn-parity semantics
(counterpart of ``pinnfc_tpu/diagnosis/metrics.py``).

Covers every metric the downstream scripts print: ROC curve + AUC (02:552-569),
accuracy / confusion matrix (02:536-541, 03:553-558), and macro
precision/recall/F1 (05:177-191, ``zero_division=0`` semantics).  Implemented
from their definitions; verified against sklearn in tests.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def roc_curve(y_true: np.ndarray, y_score: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary ROC curve: (fpr, tpr, thresholds), sklearn drop_intermediate=False
    except collinear-point dropping — thresholds are the distinct scores in
    decreasing order with the leading +inf sentinel."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[order]
    y_score = y_score[order]

    # cumulative TP/FP at each distinct threshold
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx].astype(np.float64)
    fps = (idx + 1) - tps

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    p = max(tps[-1], 1e-300)
    n = max(fps[-1], 1e-300)
    thresholds = np.r_[np.inf, y_score[idx]]
    return fps / n, tps / p, thresholds


def auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    """Trapezoidal area under the curve: ``np.trapezoid``'s own sum, written
    out because numpy before 2.0 has only ``np.trapz``."""
    fpr = np.asarray(fpr, dtype=np.float64)
    tpr = np.asarray(tpr, dtype=np.float64)
    return float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def roc_auc_score(y_true, y_score) -> float:
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def confusion_matrix(y_true, y_pred, n_classes: int | None = None) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    if n_classes is None:
        n_classes = int(max(y_true.max(), y_pred.max())) + 1
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred))


def precision_recall_f1(
    y_true, y_pred, n_classes: int | None = None, average: str = "macro"
) -> Dict[str, np.ndarray | float]:
    """Per-class and averaged P/R/F1, ``zero_division=0`` (05:184-188)."""
    cm = confusion_matrix(y_true, y_pred, n_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(true_pos > 0, tp / true_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    out: Dict[str, np.ndarray | float] = {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": true_pos,
    }
    if average == "macro":
        out["precision_macro"] = float(precision.mean())
        out["recall_macro"] = float(recall.mean())
        out["f1_macro"] = float(f1.mean())
    elif average == "weighted":
        w = true_pos / max(true_pos.sum(), 1.0)
        out["precision_weighted"] = float((precision * w).sum())
        out["recall_weighted"] = float((recall * w).sum())
        out["f1_weighted"] = float((f1 * w).sum())
    return out


def compute_macro_metrics(y_true, y_pred, n_classes: int | None = None) -> Dict[str, float]:
    """The summary dict script 05 builds per method (05:177-191)."""
    prf = precision_recall_f1(y_true, y_pred, n_classes, average="macro")
    return {
        "accuracy": accuracy_score(y_true, y_pred),
        "precision_macro": prf["precision_macro"],
        "recall_macro": prf["recall_macro"],
        "f1_macro": prf["f1_macro"],
    }


def classification_report_dict(y_true, y_pred, class_names=None) -> Dict:
    """Structured equivalent of sklearn classification_report printing."""
    y_true = np.asarray(y_true, dtype=np.int64)
    # class_names fixes the label set (sklearn lists ALL labels even when a
    # class is absent from the data, and the macro average must span the
    # same k classes as compute_macro_metrics on the same split)
    if class_names is not None:
        n_classes = len(class_names)
    else:
        n_classes = int(max(y_true.max(), np.asarray(y_pred).max())) + 1
    prf = precision_recall_f1(y_true, y_pred, n_classes, average="macro")
    names = class_names or [str(i) for i in range(n_classes)]
    per_class = {
        names[i]: {
            "precision": float(prf["precision"][i]),
            "recall": float(prf["recall"][i]),
            "f1-score": float(prf["f1"][i]),
            "support": int(prf["support"][i]),
        }
        for i in range(n_classes)
    }
    per_class["accuracy"] = accuracy_score(y_true, y_pred)
    per_class["macro avg"] = {
        "precision": prf["precision_macro"],
        "recall": prf["recall_macro"],
        "f1-score": prf["f1_macro"],
        "support": int(prf["support"].sum()),
    }
    return per_class
