"""A limited-memory BFGS batched over a leading problem dimension, in float32.

The JAX package solves two smooth convex problems with ``optax.lbfgs`` inside
a ``while_loop``: the one-vs-one linear SVM (``pinnfc_tpu/diagnosis/svm.py``,
the class pairs under ``vmap``) and the L-BFGS branch of the logistic
regression (``pinnfc_tpu/diagnosis/logreg.py``).  This is the port's solver
for both: B independent problems of P parameters each, ``x`` of shape (B, P),
``fun(x) → (f (B,), ∇f (B, P))``.

- Direction: the two-loop recursion over the newest 10 pairs
  (s, y), the initial inverse Hessian scaled by sᵀy/yᵀy of the newest pair
  (optax's defaults); a pair with sᵀy ≤ ε·yᵀy is not stored.  With no pair yet
  the first trial step has unit length.
- Step: a bisection line search for the weak Wolfe conditions (Armijo with
  c1 = 1e-4, curvature with c2 = 0.9).  Where f changes by less than its
  float32 resolution (1e-6·|f|), Armijo is judged from the slope instead, as
  in Hager and Zhang's approximate Wolfe conditions (slope at the step ≤
  (2·c1 − 1)·slope at 0), so that the iteration goes on converging on the
  gradient, which float32 still resolves.  A trial step that fails Armijo halves
  toward the last one that passed it; one that fails the curvature condition
  doubles while no failing step bounds it, else bisects.  After 30 trials
  the last step that passed Armijo is taken.
- Stop, per problem: global gradient norm ≤ ``tol``, ``max_iter`` steps, or
  a line search with no trial that passed Armijo (float32 resolution of f
  reached).  A stopped problem's x no longer moves.

It does not reproduce optax's iterates (optax runs a zoom line search); both
problems are convex, so parity with the JAX package is on the optimum.  The
loop runs on the host with one read per iteration and per line-search trial.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

_C1, _C2 = 1e-4, 0.9
_MEMORY = 10  # stored (s, y) pairs, optax's default
_MAX_LINESEARCH = 30  # trial steps per iteration
# a change of f within this relative band is float32 rounding (8 ulp)
_F_RESOLUTION = 1e-6


class LbfgsResult(NamedTuple):
    x: torch.Tensor  # (B, P) the last accepted iterate of each problem
    grad_norm: torch.Tensor  # (B,) ‖∇f‖₂ there
    n_iter: torch.Tensor  # (B,) int64 steps taken


def _two_loop(g, s_hist, y_hist, rho, gamma, slots):
    """H·g for the L-BFGS inverse Hessian H of each problem; ``slots`` lists
    the stored pairs newest first (an unstored pair of a problem is zero
    there, with rho 0, and leaves its q and r unchanged)."""
    q = g
    alphas = []
    for i in slots:
        a = rho[i] * (s_hist[i] * q).sum(-1)
        q = q - a[:, None] * y_hist[i]
        alphas.append(a)
    r = gamma[:, None] * q
    for i, a in zip(reversed(slots), reversed(alphas)):
        b = rho[i] * (y_hist[i] * r).sum(-1)
        r = r + (a - b)[:, None] * s_hist[i]
    return r


def lbfgs_minimize(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    max_iter: int,
    tol: float,
) -> LbfgsResult:
    """Minimize each of the B problems of ``fun`` from ``x0`` (B, P)."""
    x = x0.clone()
    b, p = x.shape
    f, g = fun(x)
    gnorm = torch.linalg.vector_norm(g, dim=1)
    s_hist = torch.zeros((_MEMORY, b, p), dtype=x.dtype, device=x.device)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((_MEMORY, b), dtype=x.dtype, device=x.device)
    # no pair yet: scale the gradient to a unit first step
    gamma = 1.0 / torch.clamp(gnorm, min=torch.finfo(x.dtype).tiny)
    n_iter = torch.zeros(b, dtype=torch.int64, device=x.device)
    active = gnorm > tol
    head, n_stored = 0, 0
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        slots = [(head - 1 - i) % _MEMORY for i in range(n_stored)]
        d = -_two_loop(g, s_hist, y_hist, rho, gamma, slots)
        gd0 = (g * d).sum(-1)
        # not a descent direction (rounding): fall back to the scaled gradient
        uphill = ~(gd0 < 0)
        d = torch.where(uphill[:, None], -g / torch.clamp(gnorm, min=1e-30)[:, None], d)
        gd0 = torch.where(uphill, -gnorm, gd0)

        t = torch.ones_like(f)
        lo = torch.zeros_like(f)
        hi = torch.full_like(f, float("inf"))
        searching = active.clone()
        x_new, f_new, g_new = x, f, g  # the accepted point (or the last Armijo one)
        for _ in range(_MAX_LINESEARCH):
            xt = x + t[:, None] * d
            ft, gt = fun(xt)
            slope = (gt * d).sum(-1)
            # Armijo, or its approximate form from the slope where float32
            # cannot resolve the decrease of f
            armijo = searching & ((ft <= f + _C1 * t * gd0)
                                  | ((ft <= f + _F_RESOLUTION * f.abs())
                                     & (slope <= (2.0 * _C1 - 1.0) * gd0)))
            curved = slope >= _C2 * gd0
            take = armijo  # Wolfe, or Armijo alone: the best step so far
            x_new = torch.where(take[:, None], xt, x_new)
            f_new = torch.where(take, ft, f_new)
            g_new = torch.where(take[:, None], gt, g_new)
            lo = torch.where(armijo, t, lo)
            hi = torch.where(searching & ~armijo, t, hi)
            searching = searching & ~(armijo & curved)
            if not bool(searching.any()):
                break
            t = torch.where(torch.isinf(hi), 2.0 * t, 0.5 * (lo + hi))
        moved = active & (lo > 0)

        s = x_new - x
        y = g_new - g
        sy = (s * y).sum(-1)
        yy = (y * y).sum(-1)
        store = moved & (sy > torch.finfo(x.dtype).eps * yy)
        s_hist[head] = torch.where(store[:, None], s, 0.0)
        y_hist[head] = torch.where(store[:, None], y, 0.0)
        rho[head] = torch.where(store, 1.0 / torch.where(store, sy, 1.0), 0.0)
        gamma = torch.where(store, sy / torch.where(store, yy, 1.0), gamma)
        head = (head + 1) % _MEMORY
        n_stored = min(n_stored + 1, _MEMORY)

        x, f, g = x_new, f_new, g_new
        gnorm = torch.linalg.vector_norm(g, dim=1)
        n_iter = n_iter + moved.to(torch.int64)
        active = moved & (gnorm > tol)
    return LbfgsResult(x, gnorm, n_iter)
