"""Stratified train/test splitting (counterpart of
``pinnfc_tpu/diagnosis/splits.py``), without scikit-learn.

Scripts 02/03/05 all split with ``train_test_split(..., stratify=y,
random_state)`` (02:522, 03:533-535, 05:627-633).  The JAX package calls
sklearn; the port computes the same split in numpy, draw for draw, so the
rows (and their order) are sklearn's: ``n_test = ceil(test_size · n)``
(``_validate_shuffle_split``), the per-class counts of
``StratifiedShuffleSplit._iter_indices`` with the ties of
``utils.extmath._approximate_mode`` broken by the same ``RandomState``,
one permutation per class, then one of the train and one of the test rows.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Rows drawn per class: the floor of each class's share, the rest added
    by largest remainder, ties broken by ``rng.choice`` (sklearn's
    ``_approximate_mode``, including the draws it makes)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(
    *arrays,
    y: np.ndarray,
    test_size: float,
    random_state: int,
) -> Tuple:
    """(a_train, a_test, b_train, b_test, ...) for each of ``arrays``, the
    rows sklearn's ``train_test_split(*arrays, test_size=test_size,
    random_state=random_state, stratify=y)`` returns, in the same order;
    ``test_size`` is a fraction in (0, 1), as every caller passes it."""
    arrays = [np.asarray(a) for a in arrays]
    y = np.asarray(y)
    lengths = [a.shape[0] for a in arrays] + [y.shape[0]]
    if not arrays or len(set(lengths)) > 1:
        raise ValueError(f"need arrays with as many rows as y, got lengths {lengths}")
    if y.ndim != 1:
        raise ValueError(f"stratify labels must be one-dimensional, got shape {y.shape}")
    n_samples = y.shape[0]
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be either positive and smaller than "
                         f"the number of samples {n_samples} or a float in the (0, 1) range")
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few. The "
            "minimum number of groups for any class cannot be less than 2. Classes with "
            f"too few members are: {classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[np.ndarray] = []
    test: List[np.ndarray] = []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.append(perm[: n_i[i]])
        test.append(perm[n_i[i]: n_i[i] + t_i[i]])
    train, test = rng.permutation(np.concatenate(train)), rng.permutation(np.concatenate(test))
    return [part for a in arrays for part in (a[train], a[test])]
