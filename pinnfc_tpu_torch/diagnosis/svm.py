"""Linear SVM, one-vs-one, on a device (counterpart of
``pinnfc_tpu/diagnosis/svm.py``).

The reference's "SVM (RBF)" method is ``SVC(kernel='linear', C=0.05,
class_weight='balanced')`` (05:329-331; the docstring/kernel mismatch is an
upstream quirk, preserved: this IS a linear SVM).  As in the JAX package, each
of the K·(K−1)/2 pairwise problems is solved in the primal with a squared
hinge (LinearSVC-style),

    min_{w,b}  0.5·‖w‖² + Σ_i C·w_{y_i}·max(0, 1 − s_i·(x_i·w + b))²

over the rows of the pair's two classes (s = +1 for the larger class index),
on population-std standardized inputs, with 'balanced' class weights.  The
pairs are one batch of ``diagnosis/lbfgs.py`` (the JAX package vmaps
``optax.lbfgs`` over them), stopping at gradient norm ≤ 1e-6 or ``max_iter``.

Prediction: OvO votes; ties broken by the summed |margin| toward each class
(sklearn's ``decision_function_shape='ovr'`` aggregation idea).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.lbfgs import lbfgs_minimize
from pinnfc_tpu_torch.diagnosis.logreg import balanced_class_weights

# the OvO vote table of svm_predict has this many classes
_MAX_CLASSES = 16


class SVMModel(NamedTuple):
    coef: torch.Tensor  # (P, D) one row per class pair
    intercept: torch.Tensor  # (P,)
    pairs: torch.Tensor  # (P, 2) class indices (i, j); +1 margin = j
    x_mean: torch.Tensor
    x_scale: torch.Tensor


def _pair_list(n_classes: int) -> np.ndarray:
    return np.array(
        [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)],
        dtype=np.int64,
    ).reshape(-1, 2)


def svm_fit(
    x,
    y,
    n_classes: int,
    c_svm: float = 0.05,
    balanced: bool = True,
    max_iter: int = 500,
    device="cuda",
) -> SVMModel:
    """Fit every class pair on ``device`` (float32).  ``x`` (N, D) and ``y``
    (N,) are numpy arrays or tensors."""
    if n_classes > _MAX_CLASSES:
        raise ValueError(
            f"svm_fit supports at most 16 classes (the OvO vote table in "
            f"svm_predict is fixed at length 16), got {n_classes}"
        )
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int64, device=dev)
    d = x.shape[1]

    x_mean = x.mean(dim=0)
    x_std = x.std(dim=0, correction=0)
    x_scale = torch.where(x_std == 0.0, torch.ones_like(x_std), x_std)
    xs = (x - x_mean) / x_scale

    if balanced:
        w_class = balanced_class_weights(y, n_classes)
    else:
        w_class = torch.ones((n_classes,), dtype=torch.float32, device=dev)

    pairs = torch.as_tensor(_pair_list(n_classes), device=dev)  # (P, 2)
    in_pair = (y[:, None] == pairs[None, :, 0]) | (y[:, None] == pairs[None, :, 1])  # (N, P)
    sign = torch.where(y[:, None] == pairs[None, :, 1], 1.0, -1.0)  # +1 for the larger index
    w_row = torch.where(in_pair, (w_class[y] * c_svm)[:, None], 0.0)  # (N, P)

    def loss_and_grad(theta):  # theta (P, D + 1): w, then b
        w, b = theta[:, :d], theta[:, d]
        margin = xs @ w.T + b  # (N, P)
        hinge = torch.clamp(1.0 - sign * margin, min=0.0)
        loss = 0.5 * (w * w).sum(dim=1) + (w_row * hinge * hinge).sum(dim=0)
        coeff = -2.0 * w_row * hinge * sign  # ∂loss/∂margin
        return loss, torch.cat([w + coeff.T @ xs, coeff.sum(dim=0)[:, None]], dim=1)

    theta0 = torch.zeros((pairs.shape[0], d + 1), dtype=torch.float32, device=dev)
    sol = lbfgs_minimize(loss_and_grad, theta0, max_iter=max_iter, tol=1e-6)
    return SVMModel(sol.x[:, :d], sol.x[:, d], pairs, x_mean, x_scale)


def svm_predict(model: SVMModel, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=model.coef.device)
    xs = (x - model.x_mean) / model.x_scale
    margins = xs @ model.coef.T + model.intercept[None, :]  # (N, P)
    # votes: margin > 0 → class j, else class i (vote length 16 caps n_classes)
    winner = torch.where(margins > 0, model.pairs[None, :, 1], model.pairs[None, :, 0])
    onehot = torch.nn.functional.one_hot(winner, _MAX_CLASSES)  # (N, P, 16)
    votes = onehot.sum(dim=1).to(torch.float32)
    # confidence tiebreak: accumulate |margin| toward the winning class
    conf = (onehot.to(torch.float32) * margins.abs()[:, :, None]).sum(dim=1)
    score = votes + conf / (1.0 + conf.sum(dim=1, keepdim=True))
    return torch.argmax(score, dim=1)
