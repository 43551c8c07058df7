"""Real-campaign ingestion: one normal .mat + 12 fault .mat files
(counterpart of ``pinnfc_tpu/data/campaign.py``).

Reproduces the reference main driver's data assembly (01:2055-2135): the
normal polarization file (``Polar-1.mat``) plus 4 fault types × 3 current
levels loaded in the reference order (water flooding, oxygen starvation,
membrane drying, hydrogen starvation; 108/270/405 A, 01:2098-2110), with
missing or broken files skipped with a warning like the reference's
print-and-continue loop (01:2114-2127).

File names: the reference uses Chinese stems (``水淹_108A.mat``,
01:2066-2084); ASCII aliases (``water_flooding_108A.mat``) are accepted as a
fallback, for filesystems without CJK support.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.io

from pinnfc_tpu_torch.data.combine import FuelCellDataset, combine_and_normalize
from pinnfc_tpu_torch.data.loaders import (
    FAULT_CORR_INDEX,
    FAULT_Y_INDEX,
    NORMAL_X_KEYS,
    NORMAL_Y_KEY,
    load_fault_mat,
    load_normal_mat,
)

# (ascii key, Chinese stem), reference order 01:2098-2110
FAULT_TYPES: Tuple[Tuple[str, str], ...] = (
    ("water_flooding", "水淹"),
    ("oxygen_starvation", "氧饥饿"),
    ("membrane_drying", "膜干"),
    ("hydrogen_starvation", "氢饥饿"),
)
CURRENT_LEVELS: Tuple[int, ...] = (108, 270, 405)  # 0.4/1.0/1.5 A/cm² × 270 cm²


def default_fault_paths(fault_dir: str) -> Tuple[Tuple[str, str], ...]:
    """The 12 (path, label) pairs in reference order (01:2098-2110).

    For each condition the Chinese file name is preferred; if it is absent
    and the ASCII alias exists, the alias is used.  Labels are the
    reference's ``'<type>故障(<I>A)'`` strings (01:2099)."""
    out: List[Tuple[str, str]] = []
    for ascii_stem, zh in FAULT_TYPES:
        for cur in CURRENT_LEVELS:
            zh_path = os.path.join(fault_dir, f"{zh}_{cur}A.mat")
            ascii_path = os.path.join(fault_dir, f"{ascii_stem}_{cur}A.mat")
            use_zh = os.path.exists(zh_path) or not os.path.exists(ascii_path)
            out.append((zh_path if use_zh else ascii_path, f"{zh}故障({cur}A)"))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """A real measurement campaign: normal file + ordered fault files."""

    normal_path: str
    fault_paths: Tuple[Tuple[str, str], ...]  # (path, label), load order
    training_rate: float = 1.0  # the reference trains on all normal rows (01:2132)
    seed: int = 42
    noise_config: Optional[Dict] = None
    skip_missing: bool = True  # print-and-continue like 01:2114-2127

    @classmethod
    def from_dir(cls, normal_path: str, fault_dir: str, **kwargs) -> "CampaignConfig":
        return cls(normal_path=normal_path, fault_paths=default_fault_paths(fault_dir),
                   **kwargs)


def load_campaign(
    config: CampaignConfig,
) -> Tuple[Tuple[np.ndarray, np.ndarray], List[Tuple[np.ndarray, np.ndarray, str]]]:
    """Load the raw campaign → (normal (X, Y), [(X, Y, label), ...]).

    A missing or unreadable fault file is skipped with a warning when
    ``skip_missing``; otherwise a missing one raises ``FileNotFoundError`` and
    an unreadable one re-raises the loader's error."""
    normal = load_normal_mat(config.normal_path)
    fault_list: List[Tuple[np.ndarray, np.ndarray, str]] = []
    for path, label in config.fault_paths:
        if not os.path.exists(path):
            msg = f"fault file missing, skipped: {label} ({path})"
            if not config.skip_missing:
                raise FileNotFoundError(msg)
            warnings.warn(msg)
            continue
        try:
            x_f, y_f = load_fault_mat(path)
        except Exception as e:  # the reference continues past broken files
            if not config.skip_missing:
                raise
            warnings.warn(f"fault file unreadable, skipped: {label}: {e}")
            continue
        fault_list.append((x_f, y_f, label))
    return normal, fault_list


def load_campaign_dataset(config: CampaignConfig, scalers=None,
                          device="cuda") -> FuelCellDataset:
    """Campaign files → combined, normalized, labelled dataset on ``device``:
    the object ``run_training_pipeline(dataset=...)`` takes.

    ``scalers=(scaler_x, scaler_y)`` normalizes through a trained
    checkpoint's affine constants instead of fitting on this campaign (the
    scoring path, see ``combine_and_normalize``)."""
    normal, fault_list = load_campaign(config)
    if not fault_list:
        warnings.warn("campaign contains no loadable fault segments")
    return combine_and_normalize(
        normal, fault_list, training_rate=config.training_rate,
        noise_config=config.noise_config, seed=config.seed, scalers=scalers, device=device,
    )


def write_campaign_mats(
    out_dir: str,
    normal: Tuple[np.ndarray, np.ndarray],
    faults: Sequence[Tuple[np.ndarray, np.ndarray, str]],
    ascii_names: bool = True,
) -> CampaignConfig:
    """Write (synthetic or real) arrays to disk in the campaign layout the
    loaders read: the normal channel variables (01:126-140) and the fault
    ``segment_double`` matrices (01:168-176).  Returns the matching config;
    the inverse of ``load_campaign``."""
    n_faults = len(FAULT_TYPES) * len(CURRENT_LEVELS)
    if len(faults) != n_faults:
        raise ValueError(f"expected {n_faults} fault segments in reference order, "
                         f"got {len(faults)}")
    os.makedirs(out_dir, exist_ok=True)
    x_n, y_n = normal
    payload = {k: np.asarray(x_n[:, i]).reshape(-1, 1) for i, k in enumerate(NORMAL_X_KEYS)}
    payload[NORMAL_Y_KEY] = np.asarray(y_n).reshape(-1, 1)
    normal_path = os.path.join(out_dir, "Polar-1.mat")
    scipy.io.savemat(normal_path, payload)

    width = int(max(FAULT_CORR_INDEX.max(), FAULT_Y_INDEX)) + 1
    stems = [(a, zh, cur) for a, zh in FAULT_TYPES for cur in CURRENT_LEVELS]
    for (ascii_stem, zh, cur), (x_f, y_f, _label) in zip(stems, faults):
        seg = np.zeros((len(x_f), width))
        seg[:, FAULT_CORR_INDEX] = np.asarray(x_f)
        seg[:, FAULT_Y_INDEX] = np.asarray(y_f).reshape(-1)
        stem = ascii_stem if ascii_names else zh
        scipy.io.savemat(os.path.join(out_dir, f"{stem}_{cur}A.mat"), {"segment_double": seg})
    return CampaignConfig.from_dir(normal_path, out_dir)
