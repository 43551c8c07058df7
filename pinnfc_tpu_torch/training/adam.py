"""Hand-written Adam with the StepLR staircase, on float32 tensors.

This is ``optax.adam(optax.exponential_decay(lr, lr_step, gamma,
staircase=True))`` as the JAX package builds it (``training/stages.py:64-71``):

    m ← 0.9·m + 0.1·g,  v ← 0.999·v + 0.001·g²,  c ← count + 1
    w ← w − lr·γ^⌊count/lr_step⌋ · (m / (1 − 0.9^c)) / (√(v / (1 − 0.999^c)) + 1e-8)

with ε outside the root.  The count lives on the parameters' device as an
int64 scalar, so a stage never syncs with the host, and ``keep_if_nonfinite``
can hold it back together with the moments.  An ``AdamState`` carries a stage
across chunks (the role of the optax state that the JAX package's ``_opt_init``
builds), and a mid-stage snapshot stores it through ``adam_state_to_numpy``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor  # int64 scalar: updates applied so far


def adam_init(w: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(w), torch.zeros_like(w),
                     torch.zeros((), dtype=torch.int64, device=w.device))


# marks a snapshot's optimizer state as this package's (the JAX package stores
# an optax state tree there; ``adam_tree_from_optax`` reads it)
SNAPSHOT_WRITER = "pinnfc_tpu_torch"


def adam_state_to_numpy(state: AdamState,
                        tree_of: Optional[Callable[[np.ndarray], Any]] = None) -> Dict[str, Any]:
    """The snapshot payload of ``state``: the writer mark, the count, and both
    moments, each as ``tree_of(moment)`` when given (a layout for the file)."""
    tree_of = tree_of or (lambda a: a)
    return {"writer": np.asarray(SNAPSHOT_WRITER),
            "count": np.asarray(int(state.count), np.int64),
            "m": tree_of(state.m.detach().cpu().numpy()),
            "v": tree_of(state.v.detach().cpu().numpy())}


def is_port_adam_state(tree) -> bool:
    """Whether a snapshot's ``opt`` entry was written by ``adam_state_to_numpy``."""
    return isinstance(tree, dict) and str(tree.get("writer", "")) == SNAPSHOT_WRITER


def adam_tree_from_optax(tree) -> Optional[Dict[str, Any]]:
    """The ``adam_state_to_numpy`` payload of an optax state of the JAX
    package's ``_opt_init`` (``optax.adam`` over a StepLR schedule), as a
    snapshot file holds it: ``[[count, mu, nu], [schedule count]]`` (the
    ``ScaleByAdamState`` and the ``ScaleByScheduleState``).  The two counts
    advance together (the JAX package's non-finite skip holds both back), and
    the port's one count drives both roles.  None for any other tree, or when
    the counts differ."""
    if not (isinstance(tree, (list, tuple)) and len(tree) == 2
            and isinstance(tree[0], (list, tuple)) and len(tree[0]) == 3
            and isinstance(tree[1], (list, tuple)) and len(tree[1]) == 1):
        return None
    (count, mu, nu), (sched_count,) = tree
    count, sched_count = np.asarray(count), np.asarray(sched_count)
    if (count.shape != () or sched_count.shape != () or count.dtype.kind not in "iu"
            or sched_count.dtype.kind not in "iu" or int(count) != int(sched_count)):
        return None
    return {"writer": np.asarray(SNAPSHOT_WRITER), "count": count.astype(np.int64), "m": mu,
            "v": nu}


def adam_state_from_numpy(tree: Dict[str, Any], device,
                          flat_of: Optional[Callable[[Any], np.ndarray]] = None) -> AdamState:
    """Inverse of ``adam_state_to_numpy`` on ``device``; ``flat_of`` undoes its
    ``tree_of``."""
    flat_of = flat_of or (lambda a: a)

    def moment(key):
        return torch.as_tensor(np.array(flat_of(tree[key]), np.float32), device=device)

    count = torch.as_tensor(np.asarray(tree["count"], np.int64).reshape(()), device=device)
    return AdamState(moment("m"), moment("v"), count)


def step_lr(count: torch.Tensor, lr: float, lr_step: int, lr_gamma: float) -> torch.Tensor:
    """``lr·γ^⌊count/lr_step⌋`` in float32, as ``optax.exponential_decay``."""
    p = torch.floor(count.to(torch.float32) / lr_step)
    # torch.full fills on the device; torch.tensor would copy the value from
    # the host, and that copy waits for the device
    return lr * torch.pow(torch.full((), lr_gamma, dtype=torch.float32, device=count.device), p)


def adam_step(
    w: torch.Tensor, g: torch.Tensor, state: AdamState, lr: float, lr_step: int, lr_gamma: float
) -> Tuple[torch.Tensor, AdamState]:
    """One update of ``w`` by gradient ``g``; returns new tensors."""
    m = (1 - B1) * g + B1 * state.m
    v = (1 - B2) * (g * g) + B2 * state.v
    c = (state.count + 1).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    m_hat = m / (one - torch.pow(one * B1, c))
    v_hat = v / (one - torch.pow(one * B2, c))
    lr_t = step_lr(state.count, lr, lr_step, lr_gamma)
    return w - lr_t * (m_hat / (torch.sqrt(v_hat) + EPS)), AdamState(m, v, state.count + 1)


def all_finite(loss: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Device bool: the loss and every gradient element are finite."""
    return torch.isfinite(loss) & torch.isfinite(g).all()


def keep_if_nonfinite(ok: torch.Tensor, new: Tuple[torch.Tensor, AdamState],
                      old: Tuple[torch.Tensor, AdamState]) -> Tuple[torch.Tensor, AdamState]:
    """``new`` where ``ok``, else ``old`` — parameters, both moments AND the
    count (which drives StepLR and the bias correction), as the JAX package's
    ``_keep_if_nonfinite`` (``training/stages.py:78-94``)."""
    (w1, s1), (w0, s0) = new, old
    pick = lambda a, b: torch.where(ok, a, b)  # noqa: E731
    return pick(w1, w0), AdamState(pick(s1.m, s0.m), pick(s1.v, s0.v), pick(s1.count, s0.count))
