"""Multinomial logistic regression on a device (counterpart of
``pinnfc_tpu/diagnosis/logreg.py``; sklearn-parity objective).

Replaces the reference's ``Pipeline(StandardScaler → LogisticRegression(
multi_class='multinomial', solver='lbfgs', max_iter=1000, class_weight))``
(02:195-207, 05:284-309).  The optimization problem is sklearn's exactly:

    min_{W,b}  0.5·‖W‖²_F + C · Σ_i w_i · CE(softmax(x_i W + b), y_i)

with ``C=1.0`` and optional 'balanced' class weights
``n_samples / (n_classes · count_k)``, on standardized inputs.

Solvers, chosen as in the JAX package (``solver="auto"``: Newton up to 256
packed parameters (D+1)·K, L-BFGS above):

- exact Newton/IRLS on the packed parameters, the JAX package's rules term
  for term — a ridge ``1e-6·tr(H)/(D+1)K + 1e-8``, the intercept step
  projected onto the zero-mean subspace (the softmax shift direction), stop
  when ``max|Δ| ≤ max(tol, 5e-6)`` or after ``min(max_iter, 100)`` steps.
  The loop runs on the host with one read of the step size per iteration,
  so ``n_iter`` is the JAX ``while_loop``'s;
- L-BFGS (``diagnosis/lbfgs.py``; the JAX package runs ``optax.lbfgs``) on
  the same objective from zero, stopping at gradient norm ≤ ``tol`` or after
  ``max_iter`` steps.  Its iterates are not optax's: parity is on the
  optimum.

Float32, every product in full float32 (``resolve_device`` turns TF32 off).

Not ported: ``mask=`` (row padding for a device mesh); scripts 02, 03 and 05
do not use it, and it raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.lbfgs import lbfgs_minimize


class LogRegModel(NamedTuple):
    coef: torch.Tensor  # (D, K)
    intercept: torch.Tensor  # (K,)
    x_mean: torch.Tensor  # (D,) standardization constants
    x_scale: torch.Tensor  # (D,)
    n_iter: int


def balanced_class_weights(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """sklearn 'balanced': n_samples / (n_classes * bincount)."""
    counts = torch.bincount(y, minlength=n_classes)[:n_classes].to(torch.float32)
    # a true division (``number / tensor`` multiplies by a rounded reciprocal)
    n = torch.tensor(float(y.shape[0]), dtype=torch.float32, device=y.device)
    return n / (n_classes * torch.clamp(counts, min=1.0))


# dense-Hessian Newton pays while the packed parameter block stays small
_NEWTON_MAX_PARAMS = 256


def _newton_solve(xs, onehot, w, c_reg, tol, max_iter):
    """Exact Newton on the sklearn objective; returns (coef, intercept, it)."""
    n, d = xs.shape
    k = onehot.shape[1]
    dev, dt = xs.device, xs.dtype
    xt = torch.cat([xs, torch.ones((n, 1), dtype=dt, device=dev)], dim=1)  # (N, D+1)
    dk = (d + 1) * k
    # L2 penalty on the coef rows only (sklearn never penalizes b)
    pen = torch.cat([torch.ones(d, dtype=dt, device=dev), torch.zeros(1, dtype=dt, device=dev)])
    pen_diag = pen.repeat_interleave(k)  # packed (a, l) order of theta.reshape(-1)
    eye_k = torch.eye(k, dtype=dt, device=dev)
    eye_dk = torch.eye(dk, dtype=dt, device=dev)
    wxt = w[:, None] * xt
    # the JAX cond compares a float32 step with a float32 threshold
    threshold = float(np.float32(max(tol, 5e-6)))

    theta = torch.zeros((d + 1, k), dtype=dt, device=dev)
    it = 0
    step_norm = float("inf")
    while it < max_iter and step_norm > threshold:
        p = torch.softmax(xt @ theta, dim=1)
        g = c_reg * (xt.T @ (w[:, None] * (p - onehot))) + pen[:, None] * theta
        s = p[:, :, None] * eye_k[None] - p[:, :, None] * p[:, None, :]  # (N, K, K)
        h = c_reg * torch.einsum("na,nkl,nb->akbl", wxt, s, xt)
        h = h.reshape(dk, dk) + torch.diag(pen_diag)
        # the softmax shift direction has zero curvature; a ridge scaled to
        # the Hessian's own magnitude keeps the float32 solve well-posed
        ridge = 1e-6 * torch.trace(h) / dk + 1e-8
        h = h + ridge * eye_dk
        delta = torch.linalg.solve(h, g.reshape(-1)).reshape(d + 1, k)
        # project out the flat softmax-shift direction of the intercepts
        delta[d] -= delta[d].mean()
        theta = theta - delta
        step_norm = float(delta.abs().max())
        it += 1
    return theta[:d], theta[d], it


def _lbfgs_solve(xs, onehot, w, c_reg, tol, max_iter):
    """L-BFGS on the sklearn objective (``loss_fn`` of
    pinnfc_tpu/diagnosis/logreg.py:163-167) from zero; returns (coef,
    intercept, n_iter)."""
    d, k = xs.shape[1], onehot.shape[1]

    def loss_and_grad(theta):  # theta (1, D·K + K): coef row-major, then intercept
        coef, intercept = theta[0, :d * k].reshape(d, k), theta[0, d * k:]
        logp = torch.log_softmax(xs @ coef + intercept, dim=1)
        loss = 0.5 * (coef * coef).sum() + c_reg * (w * -(onehot * logp).sum(dim=1)).sum()
        resid = c_reg * w[:, None] * (torch.exp(logp) - onehot)  # ∂loss/∂logits
        grad = torch.cat([(xs.T @ resid + coef).reshape(-1), resid.sum(dim=0)])
        return loss[None], grad[None]

    theta0 = torch.zeros((1, (d + 1) * k), dtype=xs.dtype, device=xs.device)
    sol = lbfgs_minimize(loss_and_grad, theta0, max_iter=max_iter, tol=tol)
    theta = sol.x[0]
    return theta[:d * k].reshape(d, k), theta[d * k:], int(sol.n_iter[0])


def logreg_fit(
    x,
    y,
    n_classes: int,
    max_iter: int = 1000,
    balanced: bool = True,
    c_reg: float = 1.0,
    tol: float = 1e-6,
    solver: str = "auto",
    mask=None,
    device="cuda",
) -> LogRegModel:
    """Fit on ``device`` (float32).  ``x`` (N, D) and ``y`` (N,) are numpy
    arrays or tensors; the model's tensors live on ``device``."""
    if solver not in ("auto", "newton", "lbfgs"):
        raise ValueError(f"unknown solver {solver!r}")
    if mask is not None:
        raise NotImplementedError(
            "logreg_fit(mask=...) (row padding for a device mesh) is not ported; it comes "
            "with parallel/ (ROADMAP.md Queue 1 item 8)")
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int64, device=dev)
    n, d = x.shape

    # StandardScaler (population std, sklearn semantics)
    x_mean = x.mean(dim=0)
    x_std = x.std(dim=0, correction=0)
    x_scale = torch.where(x_std == 0.0, torch.ones_like(x_std), x_std)
    xs = (x - x_mean) / x_scale

    if balanced:
        w = balanced_class_weights(y, n_classes)[y]
    else:
        w = torch.ones((n,), dtype=torch.float32, device=dev)
    onehot = torch.nn.functional.one_hot(y, n_classes).to(torch.float32)
    use_newton = solver == "newton" or (
        solver == "auto" and (d + 1) * n_classes <= _NEWTON_MAX_PARAMS)
    if use_newton:
        coef, intercept, n_iter = _newton_solve(xs, onehot, w, c_reg, tol, min(max_iter, 100))
    else:
        coef, intercept, n_iter = _lbfgs_solve(xs, onehot, w, c_reg, tol, max_iter)
    return LogRegModel(coef, intercept, x_mean, x_scale, n_iter)


def logreg_predict_proba(model: LogRegModel, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=model.coef.device)
    xs = (x - model.x_mean) / model.x_scale
    return torch.softmax(xs @ model.coef + model.intercept, dim=1)


def logreg_predict(model: LogRegModel, x) -> torch.Tensor:
    return torch.argmax(logreg_predict_proba(model, x), dim=1)


def explain_coefficients(
    model: LogRegModel,
    feature_names,
    class_names,
    topn: int = 5,
):
    """Top-N positive / negative LR coefficients per class in standardized
    space (reference explain_coefficients, 02:209-229), as structured data."""
    coefs = model.coef.detach().cpu().numpy().T  # (K, D)
    out = {}
    for c_idx, cname in enumerate(class_names):
        w = coefs[c_idx]
        pos = np.argsort(-w)[:topn]
        neg = np.argsort(w)[:topn]
        out[cname] = {
            "positive": [(feature_names[i], float(w[i])) for i in pos],
            "negative": [(feature_names[i], float(w[i])) for i in neg],
        }
    return out
