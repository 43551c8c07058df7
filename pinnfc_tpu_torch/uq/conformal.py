"""Split-conformal prediction intervals and calibrated anomaly p-values
(counterpart of ``pinnfc_tpu/uq/conformal.py``).

The artifact's MC-dropout bands (01:1413-1491) carry no coverage guarantee.
Split conformal prediction (Vovk et al. 2005; Lei et al. 2018) wraps the same
artifact columns with a distribution-free, finite-sample one:

* calibrate the score quantile ``q̂`` on held-out NORMAL rows;
* for a fresh sample exchangeable with the calibration set, the interval
  ``v̂ ± q̂·σ̂`` covers the measured voltage with probability ≥ 1 − α.

On FAULT rows exchangeability breaks: their miscoverage and the per-sample
p-value ``p_i = (1 + #{calib scores ≥ s_i}) / (n_calib + 1)`` (uniform on
normal data, toward 1/(n+1) under shift) are a calibrated anomaly signal.

Scores: ``'adaptive'`` — ``s = |res| / σ̂`` with ``σ̂ = sqrt(ale² + epi²)``
(01:1516-1529); ``'absolute'`` — ``s = |res|``.

Everything here is float64 host numpy, as in the JAX package: quantiles and
p-values are rank statistics, where a one-ulp difference at a tie flips an
integer rank, and at artifact scale (~15k rows) the work is microseconds.
So the results equal the JAX package's exactly.

The artifact's normal rows include the reference's training rows (its
test ⊇ train quirk, 01:300-316), so the guarantee is within-artifact
exchangeability; the calibration/evaluation split inside the normal class
keeps the reported normal coverage honest.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from pinnfc_tpu_torch.data.contract import INDEX


def conformal_quantile(scores: np.ndarray, alpha: float) -> float:
    """Finite-sample conformal quantile of ``scores``: the
    ``k = ⌈(n+1)(1−α)⌉``-th smallest score; ``inf`` when k > n (too few
    calibration points for the level — the interval becomes the whole line
    instead of undercovering)."""
    s = np.asarray(scores, np.float64).ravel()
    n = s.size
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    if n == 0:
        return float("inf")
    k = math.ceil((n + 1) * (1.0 - alpha))
    if k > n:
        return float("inf")
    return float(np.sort(s)[k - 1])


def conformal_pvalues(calib_scores: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-sample conformal p-values against a calibration score set:
    ``p_i = (1 + #{calib ≥ s_i}) / (n_calib + 1)`` (ties count as ≥).
    Non-finite scores map to NaN."""
    calib = np.sort(np.asarray(calib_scores, np.float64).ravel())
    s = np.asarray(scores, np.float64)
    n = calib.size
    # #{calib >= s} = n − (first index where calib >= s) with 'left'
    ge = n - np.searchsorted(calib, s, side="left")
    p = (1.0 + ge) / (n + 1.0)
    return np.where(np.isfinite(s), p, np.nan)


@dataclasses.dataclass
class ClassCoverage:
    """Coverage of the conformal interval over one label's rows."""

    label: int  # 0 = normal (evaluation half), 1..12 = fault segment
    n: int  # rows in the class (including non-finite-score rows)
    # fraction of FINITE-score rows with |res| ≤ q̂·σ̂ (NaN when none is finite)
    coverage: float
    mean_width: float  # mean 2·q̂·σ̂ [V] over finite rows
    median_p: float  # median conformal p-value (non-finite excluded)
    # fraction of finite rows with p ≤ α — exactly 1 − coverage, by the
    # duality covered ⟺ p > α
    frac_low_p: float


@dataclasses.dataclass
class ConformalReport:
    alpha: float
    score: str  # 'adaptive' | 'absolute'
    q_hat: float
    n_calib: int
    n_dropped: int  # non-finite-score rows excluded from calibration
    classes: List[ClassCoverage]
    detection_auc: float  # 1−p as normal-vs-fault score (eval normals vs faults)
    pvalues: np.ndarray  # (N,) over ALL artifact rows (NaN where non-finite)
    covered: np.ndarray  # (N,) bool, the interval covers y_true
    calib_mask: np.ndarray  # (N,) bool, rows consumed for calibration
    calib_scores: np.ndarray  # the calibration score vector

    @property
    def normal_eval(self) -> ClassCoverage:
        return next(c for c in self.classes if c.label == 0)

    def to_dict(self) -> Dict:
        return {
            "alpha": self.alpha,
            "score": self.score,
            "q_hat": self.q_hat,
            "n_calib": self.n_calib,
            "n_dropped": self.n_dropped,
            "detection_auc": self.detection_auc,
            "classes": [dataclasses.asdict(c) for c in self.classes],
        }


def artifact_scores(results: np.ndarray, score: str = "adaptive") -> tuple:
    """(scores, sigma) over every artifact row for ``score`` kind."""
    arr = np.asarray(results, np.float64)
    res = np.abs(arr[:, INDEX["res"]])
    if score == "adaptive":
        sigma = np.sqrt(arr[:, INDEX["ale"]] ** 2 + arr[:, INDEX["epi"]] ** 2)
        # a zero σ̂ would make its score infinite and its interval empty:
        # floor at the smallest positive σ̂ seen
        pos = sigma[sigma > 0]
        floor = float(pos.min()) if pos.size else 1.0
        sigma = np.maximum(sigma, floor)
    elif score == "absolute":
        sigma = np.ones_like(res)
    else:
        raise ValueError(f"score must be 'adaptive' or 'absolute', got {score!r}")
    return res / sigma, sigma


def normal_calibration_scores(
    results: np.ndarray,
    score: str = "absolute",
    calib_frac: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Finite scores of a seeded random ``calib_frac`` of the NORMAL rows."""
    arr = np.asarray(results, np.float64)
    scores, _ = artifact_scores(arr, score)
    normal = np.flatnonzero(arr[:, INDEX["label"]] == 0)
    if normal.size == 0:
        raise ValueError("artifact has no normal (label==0) rows to calibrate on")
    if not 0.0 < calib_frac <= 1.0:
        raise ValueError(f"calib_frac must be in (0, 1], got {calib_frac}")
    n_cal = max(1, int(round(normal.size * calib_frac)))
    picked = np.random.RandomState(seed).permutation(normal.size)[:n_cal]
    s = scores[normal[picked]]
    return s[np.isfinite(s)]


def conformal_report(
    results: np.ndarray,
    alpha: float = 0.1,
    score: str = "adaptive",
    calib_frac: float = 0.5,
    seed: int = 0,
) -> ConformalReport:
    """Split-conformal analysis of one exported artifact: calibrates on a
    seeded random ``calib_frac`` of the normal rows, reports the coverage on
    the held-out normal rows and on each fault segment, and the normal-vs-
    fault detection AUC of the anomaly score ``1 − p``."""
    from pinnfc_tpu_torch.diagnosis.metrics import roc_auc_score

    arr = np.asarray(results, np.float64)
    labels = arr[:, INDEX["label"]].astype(np.int64)
    scores, sigma = artifact_scores(arr, score)

    normal = np.flatnonzero(labels == 0)
    if normal.size < 2:
        raise ValueError("need ≥2 normal rows to split calibration/evaluation")
    if not 0.0 < calib_frac < 1.0:
        raise ValueError(f"calib_frac must be in (0, 1), got {calib_frac}")
    perm = np.random.RandomState(seed).permutation(normal.size)
    n_cal = min(max(1, int(round(normal.size * calib_frac))), normal.size - 1)
    calib_mask = np.zeros(arr.shape[0], bool)
    calib_mask[normal[perm[:n_cal]]] = True

    calib_all = scores[calib_mask]
    finite = np.isfinite(calib_all)
    calib = calib_all[finite]
    n_dropped = int((~finite).sum())

    q_hat = conformal_quantile(calib, alpha)
    p = conformal_pvalues(calib, scores)
    covered = np.isfinite(scores) & (scores <= q_hat)

    classes: List[ClassCoverage] = []
    for lbl in np.unique(labels):
        rows = (labels == lbl) & ~calib_mask
        n = int(rows.sum())
        if n == 0:
            continue
        fin = rows & np.isfinite(scores)
        classes.append(ClassCoverage(
            label=int(lbl),
            n=n,
            coverage=float(covered[fin].mean()) if fin.any() else float("nan"),
            mean_width=float(2.0 * q_hat * sigma[fin].mean()) if fin.any() else float("nan"),
            median_p=float(np.nanmedian(p[rows])) if fin.any() else float("nan"),
            frac_low_p=float((p[fin] <= alpha).mean()) if fin.any() else float("nan"),
        ))

    eval_rows = ~calib_mask & np.isfinite(scores)
    is_fault = labels > 0
    det_auc = float("nan")
    if (eval_rows & is_fault).any() and (eval_rows & ~is_fault).any():
        det_auc = roc_auc_score(is_fault[eval_rows].astype(np.int64), 1.0 - p[eval_rows])

    return ConformalReport(
        alpha=alpha, score=score, q_hat=q_hat, n_calib=int(calib.size),
        n_dropped=n_dropped, classes=classes, detection_auc=det_auc,
        pvalues=p, covered=covered, calib_mask=calib_mask, calib_scores=calib,
    )
