"""Feature / group spec parsing and (X, y) extraction (counterpart of
``pinnfc_tpu/diagnosis/features.py``).

Rebuilds the tolerant string parsers the reference duplicates in scripts
02/03 (02:119-193, 03:101-185): a feature spec like ``"epi,res"`` or
``"x0 x3;x4|x5"`` → column indices; a group spec like
``"水淹:1,2,3|氧饥饿:4,5,6"`` → detail-label→coarse-class map.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from pinnfc_tpu_torch.data.contract import INDEX


def list_available_features() -> List[str]:
    return sorted(INDEX.keys(), key=lambda k: INDEX[k])


def normalize_feature_spec(spec: str) -> str:
    """Collapse mixed CJK/ASCII separators to commas (02:119-125)."""
    s = spec.strip()
    s = re.sub(r"[，、；;|]+", ",", s)
    s = re.sub(r"(\d+)\.(\d+)", r"\1,\2", s)
    s = re.sub(r"\s+", ",", s)
    s = re.sub(r",+", ",", s)
    return s.strip(", ")


def parse_features(spec: str) -> List[int]:
    """Feature spec → ordered unique column indices; rejects 'label',
    warns on 'y_true' leakage (02:127-150)."""
    cleaned = normalize_feature_spec(spec)
    tokens = [t for t in cleaned.split(",") if t != ""]
    indices: List[int] = []
    for t in tokens:
        if re.match(r"^-?\d+$", t):
            idx = int(t)
            if idx < 0:
                # a negative index would alias a real column (e.g. -5 is the
                # fault label) and slip past the leakage guards below
                raise ValueError(
                    f"negative feature index {idx} is not allowed; use the "
                    f"column name or its non-negative index"
                )
        else:
            if t not in INDEX:
                raise KeyError(
                    f"unknown feature '{t}'; available: {list_available_features()}"
                )
            idx = INDEX[t]
        if idx == INDEX["label"]:
            raise ValueError("'label' cannot be used as an input feature")
        indices.append(idx)
    seen = set()
    ordered = []
    for idx in indices:
        if idx not in seen:
            ordered.append(idx)
            seen.add(idx)
    if INDEX["y_true"] in ordered:
        warnings.warn(
            "features include y_true (the measured target) — possible leakage"
        )
    return ordered


def parse_group_spec(spec: str) -> Dict[str, List[int]]:
    """``"name:ids | name:ids"`` → {name: [detail ids]} (02:152-174)."""
    parts = re.split(r"[|；;]\s*|\n+", spec.strip())
    groups: Dict[str, List[int]] = {}
    for p in parts:
        if not p.strip():
            continue
        if ":" not in p:
            raise ValueError(f"group fragment missing ':': '{p}'")
        name, ids_str = p.split(":", 1)
        name = name.strip()
        ids_str = normalize_feature_spec(ids_str)
        det_ids = []
        for tok in [t for t in ids_str.split(",") if t != ""]:
            if not re.match(r"^-?\d+$", tok):
                raise ValueError(f"invalid label id: '{tok}'")
            det_ids.append(int(tok))
        if name in groups:
            raise ValueError(f"duplicate group name: '{name}'")
        groups[name] = det_ids
    if not groups:
        raise ValueError("no groups parsed from spec")
    return groups


def build_label_mapper(groups: Dict[str, List[int]]) -> Tuple[Dict[int, int], List[str]]:
    """Detail-label → coarse-class-index map + class names (02:176-185)."""
    class_names = list(groups.keys())
    detail_to_coarse: Dict[int, int] = {}
    for coarse_idx, name in enumerate(class_names):
        for det in groups[name]:
            if det in detail_to_coarse:
                prev = class_names[detail_to_coarse[det]]
                raise ValueError(
                    f"detail label {det} claimed by both '{prev}' and '{name}'"
                )
            detail_to_coarse[det] = coarse_idx
    return detail_to_coarse, class_names


def extract_X_y(
    results: np.ndarray,
    feature_indices: Sequence[int],
    label_map: Dict[int, int],
    return_indices: bool = False,
):
    """Select mapped rows / feature columns, drop non-finite rows (02:187-193).
    ``return_indices=True`` additionally returns the kept rows' positions in
    the full array (needed by script 03's plotting, 03:533-535)."""
    results = np.asarray(results)
    detailed = results[:, INDEX["label"]].astype(np.int32)
    keep = np.array([d in label_map for d in detailed], dtype=bool)
    X = results[keep][:, list(feature_indices)].astype(np.float64)
    y = np.array([label_map[int(d)] for d in detailed[keep]], dtype=np.int32)
    finite = np.isfinite(X).all(axis=1) & np.isfinite(y)
    if return_indices:
        full_idx = np.where(keep)[0][finite]
        return X[finite], y[finite], full_idx
    return X[finite], y[finite]
