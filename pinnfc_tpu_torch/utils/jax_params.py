"""Carry weights between the JAX package's params tree and the port's params
(a lone model, or an ensemble whose JAX tree stacks its members on a leading
axis), and a fitted Gaussian mixture or linear SVM from the JAX package's
``GMMParams``/``SVMModel`` to the port's.

The JAX tree is ``{"mlp": {"hidden": [{"w","b"}...], "mean": {"w","b"},
"var": [{"w","b"} x3]}, "lam_v", "lam_t", "lam_h", "lam_o"}`` of arrays; a
JAX ``w`` is (in, out), an ``nn.Linear.weight`` is (out, in).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.gmm import GMMParams, _torch_dtype
from pinnfc_tpu_torch.diagnosis.svm import SVMModel
from pinnfc_tpu_torch.models.mlp import MLP
from pinnfc_tpu_torch.models.pinn import LAMBDA_GROUPS, PinnParams


def _jax_linears(mlp_tree) -> list:
    return [*mlp_tree["hidden"], mlp_tree["mean"], *mlp_tree["var"]]


def mlp_from_jax(tree: Dict[str, Any], device="cuda") -> MLP:
    """A bare JAX MLP tree (``{"hidden", "mean", "var"}``) of numpy arrays →
    an ``MLP`` on ``device``."""
    layers = [np.asarray(layer["w"]).shape[0] for layer in tree["hidden"]]
    layers += [np.asarray(tree["hidden"][-1]["w"]).shape[1],
               np.asarray(tree["mean"]["w"]).shape[1]]
    mlp = MLP(layers, device=device)
    with torch.no_grad():
        for lin, src in zip(mlp.linears(), _jax_linears(tree)):
            w = np.array(src["w"], np.float32)
            b = np.array(src["b"], np.float32).reshape(-1)
            if w.shape != (lin.in_features, lin.out_features):
                raise ValueError(
                    f"weight of shape {w.shape} does not fit a "
                    f"Linear({lin.in_features}, {lin.out_features})"
                )
            lin.weight.copy_(torch.as_tensor(w.T.copy()))
            lin.bias.copy_(torch.as_tensor(b))
    return mlp


def mlp_to_numpy(mlp: MLP) -> Dict[str, Any]:
    """``MLP`` → bare JAX MLP tree of numpy arrays (inverse of ``mlp_from_jax``)."""

    def lin(l):
        return {"w": l.weight.detach().cpu().numpy().T.copy(),
                "b": l.bias.detach().cpu().numpy().copy()}

    return {"hidden": [lin(l) for l in mlp.hidden], "mean": lin(mlp.mean),
            "var": [lin(l) for l in mlp.var]}


def mlp_tree_from_flat(flat: np.ndarray, mlp: MLP) -> Dict[str, Any]:
    """A flat vector over ``mlp``'s tensors, in the order and layout of the
    training kernel's plain version (per Linear ``w`` (in, out) row-major, then
    ``b``; hidden trunk, mean head, variance head) → bare JAX MLP tree."""
    flat = np.asarray(flat)
    layers, off = [], 0
    for lin in mlp.linears():
        k, j = lin.in_features, lin.out_features
        layers.append({"w": flat[off:off + k * j].reshape(k, j),
                       "b": flat[off + k * j:off + k * j + j]})
        off += k * j + j
    if off != flat.size:
        raise ValueError(f"a flat vector of {flat.size} values does not fit MLP {mlp.layers}")
    n = len(mlp.hidden)
    return {"hidden": layers[:n], "mean": layers[n], "var": layers[n + 1:]}


def mlp_tree_to_flat(tree: Dict[str, Any]) -> np.ndarray:
    """Inverse of ``mlp_tree_from_flat``."""
    return np.concatenate([np.asarray(layer[key], np.float32).reshape(-1)
                           for layer in _jax_linears(tree) for key in ("w", "b")])


def params_from_jax(tree: Dict[str, Any], device="cuda") -> PinnParams:
    """JAX-layout params tree of numpy arrays → port params on ``device``."""
    params: PinnParams = {"mlp": mlp_from_jax(tree["mlp"], device=device)}
    for g in LAMBDA_GROUPS:
        params[g] = torch.as_tensor(np.array(tree[g], np.float32), device=device)
    return params


def params_to_numpy(params: PinnParams) -> Dict[str, Any]:
    """Port params → JAX-layout tree of numpy arrays (inverse of ``params_from_jax``)."""
    tree: Dict[str, Any] = {"mlp": mlp_to_numpy(params["mlp"])}
    for g in LAMBDA_GROUPS:
        tree[g] = params[g].detach().cpu().numpy().copy()
    return tree


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def ensemble_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A stacked JAX ensemble tree of numpy arrays (``parallel.init_ensemble``:
    a leading member axis on every leaf) → the port's ensemble on ``device``:
    ``{"mlp": [MLP] * E, "lam_v": (E, 4), ...}``."""
    n = np.asarray(tree["mlp"]["mean"]["w"]).shape[0]
    ens: Dict[str, Any] = {"mlp": [
        mlp_from_jax(_map_leaves(lambda a, e=e: np.asarray(a)[e], tree["mlp"]), device=device)
        for e in range(n)]}
    for g in LAMBDA_GROUPS:
        ens[g] = torch.as_tensor(np.array(tree[g], np.float32), device=device)
    return ens


def ensemble_to_numpy(ens: Dict[str, Any]) -> Dict[str, Any]:
    """The port's ensemble → the stacked JAX tree of numpy arrays (inverse of
    ``ensemble_from_jax``)."""
    members = [mlp_to_numpy(m) for m in ens["mlp"]]

    def zip_trees(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_trees([t[k] for t in trees]) for k in first}
        if isinstance(first, list):
            return [zip_trees([t[i] for t in trees]) for i in range(len(first))]
        return np.stack(trees)

    tree: Dict[str, Any] = {"mlp": zip_trees(members)}
    for g in LAMBDA_GROUPS:
        tree[g] = ens[g].detach().cpu().numpy().copy()
    return tree


def gmm_params_from_numpy(weights, means, covariances, converged: bool = True,
                          n_iter: int = 0, lower_bound: float = float("nan"),
                          dtype=None, device="cuda"):
    """A fitted mixture's arrays (a JAX ``GMMParams``'s weights (C,), means
    (C, D) and covariances (C, D, D), as numpy) → the port's ``GMMParams`` on
    ``device``, in ``dtype`` (default: the means' float dtype)."""
    dev = resolve_device(device)
    means = np.asarray(means)
    dt = _torch_dtype(means.dtype if dtype is None else dtype)
    weights, means, covariances = (torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
                                   for a in (weights, means, covariances))
    c, d = means.shape
    if weights.shape != (c,) or covariances.shape != (c, d, d):
        raise ValueError(f"mixture shapes do not fit: weights {tuple(weights.shape)}, means "
                         f"{(c, d)}, covariances {tuple(covariances.shape)}")
    return GMMParams(weights, means, covariances, bool(converged), int(n_iter),
                     float(lower_bound))


def svm_params_from_numpy(coef, intercept, pairs, x_mean, x_scale, device="cuda") -> SVMModel:
    """A fitted one-vs-one SVM's arrays (a JAX ``SVMModel``'s coef (P, D),
    intercept (P,), pairs (P, 2), x_mean (D,) and x_scale (D,), as numpy) →
    the port's ``SVMModel`` on ``device`` (float32, pairs int64)."""
    dev = resolve_device(device)
    coef, intercept, x_mean, x_scale = (
        torch.as_tensor(np.array(a, np.float32), device=dev)
        for a in (coef, intercept, x_mean, x_scale))
    pairs = torch.as_tensor(np.array(pairs, np.int64), device=dev)
    p, d = coef.shape
    if (intercept.shape != (p,) or pairs.shape != (p, 2) or x_mean.shape != (d,)
            or x_scale.shape != (d,)):
        raise ValueError(f"SVM shapes do not fit: coef {(p, d)}, intercept "
                         f"{tuple(intercept.shape)}, pairs {tuple(pairs.shape)}, x_mean "
                         f"{tuple(x_mean.shape)}, x_scale {tuple(x_scale.shape)}")
    return SVMModel(coef, intercept, pairs, x_mean, x_scale)
