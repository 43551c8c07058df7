"""The λ stages of the staged schedule in plain torch (reference script 01:
``train_lambda``, 01:966-1058; the thermal, hydrogen and oxygen stages,
01:1060-1399): each stage's loss from the physics models of
``campaign.residuals``, its gradient by autograd, Adam over the StepLR
staircase, and the box clamp after every step.

Float64 throughout.  The rows are the float32 scaled training rows,
de-normalised in float64 as the exporter does; the network's voltage is its
eval pass (``mlp.eval_forward``: float32, TF32 off), a stage constant
(01:967, 01:1009).  A stage's loss:

- ``lambda_v``, ``dnn_para`` false: mean (y_norm − (V_est·5·scale_y +
  min_y))², the fit in the normalised domain (01:1025-1032), with
  scale_y = 2 / (max − min + 1e-12) and min_y = −1 − min·scale_y (01:1021-1022);
- ``lambda_v``, ``dnn_para`` true: mean f_V² (01:1029);
- ``thermal``, ``hydrogen``, ``oxygen``: mean f² of the group's residual
  (01:1109, 01:1245, 01:1375).

``point`` works out a stage's loss and gradient at given λ's, ``adam_steps``
the λ's that given gradients step to, and ``steps`` a stage's first steps
as the program runs them; there ``rnd`` rounds every input of the loss (the
rows, the network's voltage and the λ's before each step) to a lower
precision: the control of ``correct``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import campaign
from portbench.reference.rounding import Rounding

# the box each group is clamped to after every step (01:992-997, 01:1089-1095,
# 01:1336-1341, 01:1183-1188)
BOUNDS = {
    "lam_v": ((0.167 * 0.5, 2.36e-6 * 0.1, 2.0, 0.1),
              (0.167 * 5.0, 2.36e-6 * 2.1, 2.0 * 5.2, 10.0)),
    "lam_t": ((-10000.0,) * 5, (10000.0,) * 5),
    "lam_h": ((0.5, -20.0, 50.0, 0.0), (50.0, 20.0, 1000.0, 20.0)),
    "lam_o": ((1.5, -20.0, 50.0, 0.0), (8.0, 20.0, 1000.0, 20.0)),
}
GROUP_OF = {"lambda_v": "lam_v", "thermal": "lam_t", "hydrogen": "lam_h", "oxygen": "lam_o"}
RESIDUAL_OF = {"lam_v": "f_v", "lam_t": "f_t", "lam_h": "f_h", "lam_o": "f_o"}


@dataclasses.dataclass
class Rows:
    """What a λ stage's loss reads, float64 on one device."""

    real: torch.Tensor  # (N, 8) the rows in real units
    y_norm: torch.Tensor  # (N,) the measured voltage, scaled
    v_stack: torch.Tensor  # (N,) the network's stack voltage, in volts
    scale_y: float
    min_y: float

    def rounded(self, rnd: Rounding) -> "Rows":
        if rnd is None:
            return self
        r = lambda t: rnd(t.float()).double()  # noqa: E731
        return dataclasses.replace(self, real=r(self.real), y_norm=r(self.y_norm),
                                   v_stack=r(self.v_stack))


def rows(xs: np.ndarray, ys: np.ndarray, sx: Dict[str, np.ndarray], sy: Dict[str, np.ndarray],
         u_norm: torch.Tensor) -> Rows:
    """``Rows`` of the float32 scaled rows ``xs`` (N, 8) and ``ys`` (N,),
    their scalers (``campaign.fit_minmax``) and the network's scaled
    prediction ``u_norm`` (N,), on ``u_norm``'s device."""
    f64 = np.float64
    dev = u_norm.device
    real = (xs.astype(f64) - sx["min"].astype(f64)) / sx["scale"].astype(f64)
    scale_y = 2.0 / (f64(sy["data_max"][0]) - f64(sy["data_min"][0]) + 1e-12)
    v_stack = (u_norm.double() - f64(sy["min"][0])) / f64(sy["scale"][0])
    return Rows(torch.as_tensor(real, device=dev),
                torch.as_tensor(np.asarray(ys, f64).reshape(-1), device=dev), v_stack,
                float(scale_y), float(-1.0 - f64(sy["data_min"][0]) * scale_y))


def terms(stage: str, dnn_para: bool, lam: Dict[str, torch.Tensor], data: Rows) -> torch.Tensor:
    """Each row's term of the stage's loss at the λ's ``lam`` (all four
    groups); the loss is their mean."""
    res = campaign.residuals(data.real, data.v_stack, lam)
    group = GROUP_OF[stage]
    if group == "lam_v" and not dnn_para:
        return (data.y_norm - (res["v_phys"] * data.scale_y + data.min_y)) ** 2
    return res[RESIDUAL_OF[group]] ** 2


def _fixed(group: str, others: Dict[str, Sequence[float]], dev) -> Dict[str, torch.Tensor]:
    return {g: torch.as_tensor(np.asarray(v, np.float64), device=dev)
            for g, v in others.items() if g != group}


@dataclasses.dataclass
class Point:
    loss: float
    grad: torch.Tensor  # of the loss by the stage's group
    # ‖mean over rows of |∂ term / ∂λ|‖: the gradient's size were no rows to
    # cancel (at the data's optimum the gradient itself is all but nought)
    grad_scale: float


def point(stage: str, dnn_para: bool, lam: Sequence[float], others: Dict[str, Sequence[float]],
          data: Rows) -> Point:
    """The stage's loss and gradient at the group's λ's ``lam``, the other
    groups at ``others``."""
    group = GROUP_OF[stage]
    dev = data.real.device
    fixed = _fixed(group, others, dev)
    var = torch.as_tensor(np.asarray(lam, np.float64), device=dev)

    def row_terms(x):
        return terms(stage, dnn_para, dict(fixed, **{group: x}), data)

    jac = torch.func.jacfwd(row_terms)(var)  # (N, k)
    grad = jac.mean(0)
    scale = torch.linalg.vector_norm(jac.abs().mean(0))
    return Point(float(row_terms(var).mean()), grad, float(scale))


def adam_steps(stage: str, start: Sequence[float], grads: Sequence[torch.Tensor], lr: float,
               lr_step: int, lr_gamma: float) -> torch.Tensor:
    """The group's λ's after one step for each of ``grads`` from ``start``,
    from a fresh Adam (``optax.adam`` over a staircase decay, ε outside the
    root, as reference 01:948-955 steps ``torch.optim.Adam`` with StepLR),
    each step clamped to ``BOUNDS``."""
    dev = grads[0].device
    lo, hi = (torch.as_tensor(b, dtype=torch.float64, device=dev)
              for b in BOUNDS[GROUP_OF[stage]])
    lam = torch.as_tensor(np.asarray(start, np.float64), device=dev)
    m, v = torch.zeros_like(lam), torch.zeros_like(lam)
    for t, g in enumerate(grads):
        g = g.double()
        c = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        lr_t = lr * lr_gamma ** (t // lr_step)
        step = (m / (1.0 - 0.9**c)) / (torch.sqrt(v / (1.0 - 0.999**c)) + 1e-8)
        lam = torch.clamp(lam - lr_t * step, lo, hi)
    return lam


@dataclasses.dataclass
class Steps:
    """The first steps of a λ stage: the loss and gradient of each, and the
    λ's each starts from and the last one leaves."""

    losses: List[float]
    grads: List[torch.Tensor]
    lams: List[torch.Tensor]


def steps(stage: str, dnn_para: bool, start: Sequence[float], others: Dict[str, Sequence[float]],
          data: Rows, k: int, lr: float, lr_step: int, lr_gamma: float,
          rnd: Rounding = None) -> Steps:
    """The first ``k`` steps of a λ stage from ``start``, as the program runs
    them, every input of the loss rounded by ``rnd`` (the λ's before each
    step included)."""
    group = GROUP_OF[stage]
    dev = data.real.device
    data = data.rounded(rnd)
    fixed = _fixed(group, others, dev)
    lam = torch.as_tensor(np.asarray(start, np.float64), device=dev)
    out = Steps([], [], [lam])
    for _ in range(k):
        var = (lam if rnd is None else rnd(lam.float()).double()).detach().requires_grad_(True)
        value = terms(stage, dnn_para, dict(fixed, **{group: var}), data).mean()
        (g,) = torch.autograd.grad(value, var)
        out.losses.append(float(value.detach()))
        out.grads.append(g)
        lam = adam_steps(stage, start, out.grads, lr, lr_step, lr_gamma)
        out.lams.append(lam)
    return out
