"""Parameter checkpoints in the JAX package's layouts
(counterpart of ``pinnfc_tpu/utils/checkpoint.py``).

The port writes a checkpoint at ``path`` as the archive ``<path>.npz``
holding the flat keys ``params/mlp/hidden/0/w``, …, ``params/lam_v``,
``step``, ``scaler_x/scale``, …, plus an optional ``<path>.meta.json``
provenance sidecar: the JAX package's npz fallback, which it reads too.  The
port reads both of the JAX package's formats: that npz archive, and the Orbax
PyTree directory ``<path>/`` that the JAX ``save_checkpoint`` writes whenever
``orbax.checkpoint`` imports (read with ``tensorstore``, without JAX).
"""

from __future__ import annotations

import json
import os
import shutil
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
    different model).  The sidecar is written after the arrays.  An Orbax
    checkpoint directory ``<path>/`` is removed first: both packages' loaders
    read it before the npz, so it would hide the model written here."""
    if os.path.isfile(os.path.join(path, "_METADATA")):
        shutil.rmtree(path)
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


def _orbax_tree(directory: str) -> Dict[str, Any]:
    """Read the Orbax PyTree checkpoint in ``directory`` into its tree of
    numpy arrays, without JAX or Orbax.

    ``_METADATA`` (JSON) lists every leaf under ``tree_metadata`` with its
    key path (``key_type`` 1 a list index, 2 a dict key); each leaf is a
    zarr array named by the dotted key path inside one OCDBT key-value store,
    which ``tensorstore`` opens.  Other layouts raise ``ValueError``."""
    with open(os.path.join(directory, "_METADATA")) as f:
        metadata = json.load(f)
    what = f"the Orbax checkpoint {directory!r}"
    npz = (f"; or write its tree as {directory + '.npz'!r} with the JAX package's "
           "save_params_npz, which the port reads")
    if not metadata.get("use_ocdbt", False):
        raise ValueError(f"{what} is not OCDBT-backed (use_ocdbt false): the port reads only "
                         f"Orbax's default OCDBT layout{npz}")
    if metadata.get("use_zarr3", False):
        raise ValueError(f"{what} stores zarr3 arrays (use_zarr3 true): the port reads only "
                         f"zarr v2 arrays, Orbax's default{npz}")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ValueError(f"{what} needs the tensorstore package to be read{npz}") from e
    base = {"driver": "file", "path": os.path.abspath(directory) + "/"}
    store = {"driver": "ocdbt", "base": base}
    root: Dict[str, Any] = {}
    lists = set()  # ids of the nodes whose keys are list indices
    for entry in metadata["tree_metadata"].values():
        keys = [(str(k["key"]), k["key_type"]) for k in entry["key_metadata"]]
        node = root
        for (key, _), (_, child_type) in zip(keys, keys[1:]):
            node = node.setdefault(key, {})
            if child_type == 1:
                lists.add(id(node))
        spec = {"driver": "zarr", "kvstore": store, "path": ".".join(k for k, _ in keys)}
        node[keys[-1][0]] = ts.open(spec, open=True, read=True).result().read().result()

    def listify(node):
        if not isinstance(node, dict):
            return node
        if id(node) in lists:
            if set(node) != {str(i) for i in range(len(node))}:
                raise ValueError(f"{what} has a list with indices {sorted(node)}")
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    """The checkpoint's tree as numpy arrays, with no device work: the JAX
    package's Orbax directory ``<path>/`` where it holds ``_METADATA``, else
    ``<path>.npz`` (the JAX ``load_checkpoint``'s order), the scalers as their
    ``AffineScaler.to_numpy`` dicts, provenance (if any) under ``'meta'``."""
    if os.path.isfile(os.path.join(path, "_METADATA")):
        out = _orbax_tree(path)
    else:
        out = load_params_npz(path + ".npz")
    meta = load_checkpoint_meta(path)
    if meta is not None:
        out["meta"] = meta
    return out


def load_checkpoint(path: str, device="cuda") -> Dict[str, Any]:
    """``load_checkpoint_raw`` with ``params`` as port params on ``device``
    and the scalers as ``AffineScaler`` on ``device``; ``step`` stays a numpy
    scalar array."""
    out = load_checkpoint_raw(path)
    out["params"] = params_from_jax(out["params"], device=device)
    for name in ("scaler_x", "scaler_y"):
        if name in out:
            out[name] = AffineScaler.from_numpy(out[name], device=device)
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
