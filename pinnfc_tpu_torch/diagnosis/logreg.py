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

``mask`` (N,) of 1/0 gives padded rows zero weight everywhere (the
standardization statistics, the balanced class counts, the loss, gradient
and Hessian), so the objective is exactly the unpadded one: that is how rows
of any count shard over a device mesh (``parallel/diagnosis.py``).  The fit
runs on row shards (``logreg_fit_shards``): every sum over rows is taken per
shard on its device and the shards' sums are added on the first device in
order (``parallel/mesh.py::all_sum``); one shard is ``logreg_fit``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.lbfgs import lbfgs_minimize
from pinnfc_tpu_torch.parallel.mesh import all_sum


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
    """Exact Newton on the sklearn objective over row shards (lists of one
    tensor per shard, the first shard's device holding the parameters);
    returns (coef, intercept, it)."""
    d = xs[0].shape[1]
    k = onehot[0].shape[1]
    dev, dt = xs[0].device, xs[0].dtype
    xt = [torch.cat([x, torch.ones((x.shape[0], 1), dtype=dt, device=x.device)], dim=1)
          for x in xs]  # (N_s, D+1)
    dk = (d + 1) * k
    # L2 penalty on the coef rows only (sklearn never penalizes b)
    pen = torch.cat([torch.ones(d, dtype=dt, device=dev), torch.zeros(1, dtype=dt, device=dev)])
    pen_diag = pen.repeat_interleave(k)  # packed (a, l) order of theta.reshape(-1)
    eye_k = [torch.eye(k, dtype=dt, device=x.device) for x in xs]
    eye_dk = torch.eye(dk, dtype=dt, device=dev)
    wxt = [ws[:, None] * x for ws, x in zip(w, xt)]
    # the JAX cond compares a float32 step with a float32 threshold
    threshold = float(np.float32(max(tol, 5e-6)))

    theta = torch.zeros((d + 1, k), dtype=dt, device=dev)
    it = 0
    step_norm = float("inf")
    while it < max_iter and step_norm > threshold:
        g_parts, h_parts = [], []
        for x, wx, ws, oh, ek in zip(xt, wxt, w, onehot, eye_k):
            th = theta.to(x.device)
            p = torch.softmax(x @ th, dim=1)
            g_parts.append(x.T @ (ws[:, None] * (p - oh)))
            s = p[:, :, None] * ek[None] - p[:, :, None] * p[:, None, :]  # (N, K, K)
            h_parts.append(torch.einsum("na,nkl,nb->akbl", wx, s, x))
        g = c_reg * all_sum(g_parts) + pen[:, None] * theta
        h = c_reg * all_sum(h_parts)
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
    pinnfc_tpu/diagnosis/logreg.py:163-167) from zero over row shards (as
    ``_newton_solve``); returns (coef, intercept, n_iter)."""
    d, k = xs[0].shape[1], onehot[0].shape[1]

    def loss_and_grad(theta):  # theta (1, D·K + K): coef row-major, then intercept
        coef, intercept = theta[0, :d * k].reshape(d, k), theta[0, d * k:]
        ce_parts, xg_parts, rs_parts = [], [], []
        for x, oh, ws in zip(xs, onehot, w):
            c, b = coef.to(x.device), intercept.to(x.device)
            logp = torch.log_softmax(x @ c + b, dim=1)
            ce_parts.append((ws * -(oh * logp).sum(dim=1)).sum())
            resid = c_reg * ws[:, None] * (torch.exp(logp) - oh)  # ∂loss/∂logits
            xg_parts.append(x.T @ resid)
            rs_parts.append(resid.sum(dim=0))
        loss = 0.5 * (coef * coef).sum() + c_reg * all_sum(ce_parts)
        grad = torch.cat([(all_sum(xg_parts) + coef).reshape(-1), all_sum(rs_parts)])
        return loss[None], grad[None]

    theta0 = torch.zeros((1, (d + 1) * k), dtype=xs[0].dtype, device=xs[0].device)
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
    """Fit on ``device`` (float32).  ``x`` (N, D), ``y`` (N,) and ``mask``
    (N,) are numpy arrays or tensors; the model's tensors live on
    ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int64, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    return logreg_fit_shards([x], [y], n_classes, max_iter=max_iter, balanced=balanced,
                             c_reg=c_reg, tol=tol, solver=solver,
                             masks=None if mask is None else [mask])


def logreg_fit_shards(
    xs,
    ys,
    n_classes: int,
    max_iter: int = 1000,
    balanced: bool = True,
    c_reg: float = 1.0,
    tol: float = 1e-6,
    solver: str = "auto",
    masks=None,
) -> LogRegModel:
    """``logreg_fit`` over row shards: ``xs`` (N_s, D) float32, ``ys`` (N_s,)
    int64 and ``masks`` (N_s,) float32 (None: every row counts; more than one
    shard needs masks), shard s on its own device.  The model's tensors live
    on the first shard's device."""
    if solver not in ("auto", "newton", "lbfgs"):
        raise ValueError(f"unknown solver {solver!r}")
    if masks is None and len(xs) != 1:
        raise ValueError("row shards need their masks")
    d = xs[0].shape[1]
    dev = xs[0].device

    # StandardScaler (population std, sklearn semantics)
    if masks is None:
        x_mean = xs[0].mean(dim=0)
        x_std = xs[0].std(dim=0, correction=0)
    else:
        n_eff = all_sum([m.sum() for m in masks])
        x_mean = all_sum([(x * m[:, None]).sum(dim=0) for x, m in zip(xs, masks)]) / n_eff
        x_std = torch.sqrt(all_sum([(m[:, None] * (x - x_mean.to(x.device)) ** 2).sum(dim=0)
                                    for x, m in zip(xs, masks)]) / n_eff)
    x_scale = torch.where(x_std == 0.0, torch.ones_like(x_std), x_std)
    xs = [(x - x_mean.to(x.device)) / x_scale.to(x.device) for x in xs]
    onehot = [torch.nn.functional.one_hot(y, n_classes).to(torch.float32) for y in ys]

    if masks is None:
        y = ys[0]
        w = [balanced_class_weights(y, n_classes)[y] if balanced
             else torch.ones((y.shape[0],), dtype=torch.float32, device=dev)]
    else:
        if balanced:
            counts = all_sum([(oh * m[:, None]).sum(dim=0) for oh, m in zip(onehot, masks)])
            w_class = n_eff / (n_classes * torch.clamp(counts, min=1.0))
            w = [w_class.to(y.device)[y] * m for y, m in zip(ys, masks)]
        else:
            w = list(masks)
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
