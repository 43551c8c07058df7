"""Posterior label calibration for unsupervised clustering methods
(counterpart of ``pinnfc_tpu/diagnosis/posterior.py``; host work in float64).

Every clustering method in the reference (GMM 03:360-426, KMeans 05:346-393,
Agglomerative 05:398-450, Spectral 05:455-512) is wrapped with the same
recipe: cluster unsupervised, estimate ``P(fault k | cluster c)`` from the
training labels, then map test-set cluster responsibilities through that
matrix.  This module is the single vectorized implementation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def calibrate_components(
    resp_tr: np.ndarray, y_tr: np.ndarray, n_classes: int
) -> np.ndarray:
    """``comp_fault_prob[c, k] = P(fault=k | component=c)`` from soft (or
    one-hot) train responsibilities, uniform fallback for empty components
    (reference 03:395-414, vectorized as in 05:250-266)."""
    resp_tr = np.asarray(resp_tr, dtype=np.float64)
    y_tr = np.asarray(y_tr, dtype=np.int64)
    n_components = resp_tr.shape[1]

    onehot = np.zeros((len(y_tr), n_classes), dtype=np.float64)
    onehot[np.arange(len(y_tr)), y_tr] = 1.0
    weights = resp_tr.T @ onehot  # [C, K] weighted label counts

    row_sum = weights.sum(axis=1, keepdims=True)
    uniform = np.full((1, n_classes), 1.0 / n_classes)
    return np.where(row_sum > 0, weights / np.where(row_sum > 0, row_sum, 1.0), uniform)


def posterior_probabilities(
    resp_te: np.ndarray, comp_fault_prob: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Map test responsibilities → class probabilities, clip + renormalize +
    argmax (reference 03:417-425)."""
    y_prob = np.asarray(resp_te, dtype=np.float64) @ comp_fault_prob
    y_prob = np.clip(y_prob, 1e-12, 1.0)
    y_prob /= y_prob.sum(axis=1, keepdims=True)
    return y_prob, y_prob.argmax(axis=1)


def hard_responsibilities(assignments: np.ndarray, n_components: int) -> np.ndarray:
    """One-hot responsibilities for hard cluster assignments (KMeans/Ward/
    Spectral wrappers, 05:385-392)."""
    assignments = np.asarray(assignments, dtype=np.int64)
    resp = np.zeros((len(assignments), n_components), dtype=np.float64)
    resp[np.arange(len(assignments)), assignments] = 1.0
    return resp
