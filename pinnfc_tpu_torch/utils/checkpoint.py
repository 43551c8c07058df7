"""Parameter checkpoints in the JAX package's npz layout
(counterpart of the npz path of ``pinnfc_tpu/utils/checkpoint.py``).

A checkpoint at ``path`` is the archive ``<path>.npz`` holding the flat keys
``params/mlp/hidden/0/w``, …, ``params/lam_v``, ``step``,
``scaler_x/scale``, …, plus an optional ``<path>.meta.json`` provenance
sidecar.  The port reads JAX checkpoints saved through the npz fallback and
writes its own in the same layout, so either package loads the other's.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

import numpy as np

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.models.pinn import PinnParams
from pinnfc_tpu_torch.utils.io import atomic_savez, atomic_write_text
from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild the nested dict/list tree; only a contiguous 0..n-1 digit key
    set is a flattened list."""
    nested: Dict[str, Any] = {}
    for key, value in flat.items():
        node = nested
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and set(keys) == {str(i) for i in range(len(keys))}:
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(nested)


def save_params_npz(tree: Dict[str, Any], path: str) -> None:
    """Write a nested dict/list tree of arrays (e.g. the schedule snapshot
    ``{"params": params_to_numpy(params), "stage": k}``) to the archive
    ``path``, atomically, in the flat-key layout of the checkpoints."""
    atomic_savez(path, **_flatten(tree))


def load_params_npz(path: str) -> Dict[str, Any]:
    """Read an archive written by ``save_params_npz`` back into its tree of
    numpy arrays."""
    with np.load(path) as archive:
        return _unflatten(dict(archive))


def _meta_path(path: str) -> str:
    return os.path.abspath(path) + ".meta.json"


def save_checkpoint(
    path: str,
    params: PinnParams,
    scaler_x: Optional[AffineScaler] = None,
    scaler_y: Optional[AffineScaler] = None,
    step: int = 0,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``<path>.npz`` (and ``<path>.meta.json`` when ``meta`` is given;
    a save without meta removes a stale sidecar, which must never describe a
    different model).  The sidecar is written after the arrays."""
    payload: Dict[str, Any] = {"params": params_to_numpy(params), "step": np.asarray(step)}
    if scaler_x is not None:
        payload["scaler_x"] = scaler_x.to_numpy()
    if scaler_y is not None:
        payload["scaler_y"] = scaler_y.to_numpy()
    atomic_savez(path + ".npz", **_flatten(payload))
    if meta is not None:
        atomic_write_text(
            _meta_path(path),
            json.dumps(
                meta, indent=2, ensure_ascii=False,
                default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o),
            ),
        )
    else:
        try:
            os.remove(_meta_path(path))
        except FileNotFoundError:
            pass


def load_checkpoint(path: str, device="cuda") -> Dict[str, Any]:
    """Load ``<path>.npz``: ``params`` as port params on ``device``, scalers as
    ``AffineScaler`` on ``device``, provenance (if any) under ``'meta'``."""
    tree = load_params_npz(path + ".npz")
    out: Dict[str, Any] = dict(tree)
    out["params"] = params_from_jax(tree["params"], device=device)
    for name in ("scaler_x", "scaler_y"):
        if name in tree:
            out[name] = AffineScaler.from_numpy(tree[name], device=device)
    meta = load_checkpoint_meta(path)
    if meta is not None:
        out["meta"] = meta
    return out


def load_checkpoint_meta(path: str) -> Optional[Dict[str, Any]]:
    """Read the ``<path>.meta.json`` sidecar; None if absent.  A corrupt
    sidecar degrades to None with a warning instead of blocking the arrays."""
    try:
        with open(_meta_path(path)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        warnings.warn(
            f"ignoring unreadable checkpoint metadata sidecar "
            f"{_meta_path(path)!r}: {e}", stacklevel=2,
        )
        return None
