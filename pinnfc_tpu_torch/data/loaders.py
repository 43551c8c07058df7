"""Raw .mat ingestion with the reference's channel selection and filters
(counterpart of ``pinnfc_tpu/data/loaders.py``; numpy and scipy only).

Normal data (reference 01:115-154): variables ``I, m_W, T_W_in, P_H_in,
P_O_in, T_W_out, m_H2, m_O2`` form the 8 input channels, ``U`` is the target,
and rows are kept only when 50 < I < 800 (01:143).

Fault data (reference 01:157-187): a single ``segment_double`` matrix,
columns selected by ``corr_index = [20,25,65,68,69,66,14,16] - 3`` (01:172),
target column ``19 - 3`` (01:176), rows kept when the second selected channel
is non-zero (01:180-181).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.io

NORMAL_X_KEYS = ("I", "m_W", "T_W_in", "P_H_in", "P_O_in", "T_W_out", "m_H2", "m_O2")
NORMAL_Y_KEY = "U"
FAULT_CORR_INDEX = np.array([20, 25, 65, 68, 69, 66, 14, 16]) - 3
FAULT_Y_INDEX = 19 - 3


def _as_col(a: np.ndarray) -> np.ndarray:
    """Channel vector → (N, 1) column.  MATLAB stores vectors as (N, 1) or
    (1, N) depending on origin; both flatten to the same channel."""
    return np.asarray(a).reshape(-1, 1)


def loadmat_checked(path: str) -> dict:
    """``scipy.io.loadmat`` with the file path attached to the failure: a
    truncated or non-MAT file otherwise surfaces as a bare byte-level parse
    error that names no campaign file.

    scipy raises MatReadError on empty or header-truncated files, IndexError
    on short mid-header truncations, ValueError/TypeError/NotImplementedError
    on byte-level garbage and unsupported (v7.3/HDF5) formats, OSError on
    filesystem failures; each comes back as a ``ValueError`` naming ``path``."""
    from scipy.io.matlab import MatReadError

    try:
        return scipy.io.loadmat(path)
    except (OSError, ValueError, TypeError, NotImplementedError,
            MatReadError, IndexError) as e:
        raise ValueError(f"{path}: not a readable MATLAB .mat file ({e})") from e


def load_normal_mat(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a normal-operation .mat file → (X (N, 8), Y (N, 1))."""
    data = loadmat_checked(path)
    missing = [k for k in (*NORMAL_X_KEYS, NORMAL_Y_KEY) if k not in data]
    if missing:
        raise ValueError(
            f"{path}: missing channel variable(s) {missing} — a normal-"
            f"operation campaign file must carry {NORMAL_X_KEYS} and "
            f"'{NORMAL_Y_KEY}' (reference 01:126-140)"
        )
    cols = [_as_col(data[k]) for k in NORMAL_X_KEYS]
    lengths = {k: c.shape[0] for k, c in zip(NORMAL_X_KEYS, cols)}
    lengths[NORMAL_Y_KEY] = _as_col(data[NORMAL_Y_KEY]).shape[0]
    if len(set(lengths.values())) != 1:
        raise ValueError(
            f"{path}: channel lengths disagree {lengths} — every channel "
            "must have one sample per row (reference 01:204-221 dimension "
            "consistency check)"
        )
    x = np.column_stack(cols)
    y = _as_col(data[NORMAL_Y_KEY])
    current = x[:, 0]
    valid = np.where((current > 50) & (current < 800))[0]
    if valid.size == 0:
        # NaN fails both comparisons: an all-NaN current column would
        # otherwise give an empty campaign
        raise ValueError(
            f"{path}: no rows with 50 < I < 800 out of {x.shape[0]} "
            "(current channel all out-of-range or non-finite)"
        )
    return x[valid], y[valid]


def load_fault_mat(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a fault-segment .mat file → (X (N, 8), Y (N, 1))."""
    payload = loadmat_checked(path)
    if "segment_double" not in payload:
        have = [k for k in payload if not k.startswith("__")]
        raise ValueError(
            f"{path}: no 'segment_double' variable (found {have}) — fault "
            "segments must use the reference layout (01:168-176)"
        )
    data = np.asarray(payload["segment_double"])
    n_required = int(max(FAULT_CORR_INDEX.max(), FAULT_Y_INDEX)) + 1
    if data.ndim != 2 or data.shape[1] < n_required:
        raise ValueError(
            f"{path}: segment_double must be (N, >={n_required}) for the "
            f"corr_index column selection (01:172); got {data.shape}"
        )
    x = data[:, FAULT_CORR_INDEX]
    y = data[:, [FAULT_Y_INDEX]]
    # The reference filters on selected column 1 (01:180), which is the
    # coolant flow, not the current (x[:, 0]) its comment names (01:179):
    # kept as it is, so zero-current fault rows survive.
    valid = np.where(x[:, 1] != 0)[0]
    if valid.size == 0:
        raise ValueError(
            f"{path}: every row has zero coolant flow (selected column 1) "
            f"— nothing survives the reference's row filter (01:180)"
        )
    return x[valid], y[valid]
