"""The gaps between what the program produced and what the reference works
out, each a float: 0 for equal answers, inf where one side is not finite and
the other is.
"""

from __future__ import annotations

import math

import numpy as np

# the artifact's columns by the part of the pipeline that produces them
ARTIFACT_GROUPS = {
    "mean_gap": (9, 12),  # the eval-pass prediction and y − prediction
    "spread_gap": (10, 11),  # aleatoric and epistemic std, smoothed
    "residual_gap": (13, 14, 15, 16, 18, 19, 20, 21),  # the physics
    "data_gap": (0, 1, 2, 3, 4, 5, 6, 7, 8, 17),  # inputs, target, labels
}


def column_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """max over rows of |prog − ref| over the column's largest |ref|; rows
    where both are NaN agree."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    pf, ok = np.isfinite(prog), np.isfinite(ref)
    if np.any(pf != ok):
        return math.inf
    both_nan = np.isnan(prog) & np.isnan(ref)
    if np.any(~ok & ~both_nan & (prog != ref)):  # +inf against -inf
        return math.inf
    if not ok.any():
        return 0.0
    scale = np.max(np.abs(ref[ok]))
    diff = np.max(np.abs(prog[ok] - ref[ok]))
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return float(diff / scale)


def artifact_gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The widest ``column_gap`` of each group of ``ARTIFACT_GROUPS``."""
    if prog.shape != ref.shape:
        return {name: math.inf for name in ARTIFACT_GROUPS}
    return {name: max(column_gap(prog[:, c], ref[:, c]) for c in cols)
            for name, cols in ARTIFACT_GROUPS.items()}

