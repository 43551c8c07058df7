"""The 22-column ``comprehensive_results`` pipeline contract
(counterpart of ``pinnfc_tpu/data/contract.py``).

Script 01 exports an N×22 matrix to ``F01_output.mat`` (01:1877-2010,
01:2185-2187); the downstream stages read it by the column map below.  A
``.mat`` written here loads through the JAX package's contract unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import scipy.io

from pinnfc_tpu_torch.utils.io import ensure_parent

# Column map (reference 01:2162-2183; downstream INDEX at 02:88-101).
INDEX: Dict[str, int] = {
    **{f"x{i}": i for i in range(8)},  # de-normalized inputs
    "y_true": 8,  # measured stack voltage (de-normalized)
    "y_pred": 9,  # MC-mean predicted voltage (de-normalized)
    "ale": 10,  # aleatoric std (smoothed, de-normalized)
    "epi": 11,  # epistemic std (smoothed, de-normalized)
    "res": 12,  # prediction residual y_true - y_pred
    "pV": 13,  # voltage physics residual
    "pT": 14,  # temperature physics residual
    "pH": 15,  # hydrogen physics residual
    "pO": 16,  # oxygen physics residual
    "label": 17,  # 0 = normal, 1..12 = fault segment index
    "v_phys": 18,  # physics-model stack voltage estimate (01:2004)
    "t_phys": 19,  # physics-model temperature prediction (01:2005)
    "ratio_H": 20,  # actual hydrogen excess ratio (01:2006)
    "ratio_O": 21,  # actual oxygen excess ratio (01:2007)
}

N_COLUMNS = 22
REQUIRED_MAX_INDEX = INDEX["label"]  # downstream schema check (02:101)

# Names of the 8 inputs (01:2162-2169).
INPUT_CHANNELS = (
    "current",  # x0  stack current I [A]
    "coolant_flow",  # x1  cooling-water flow m_W
    "coolant_t_in",  # x2  coolant inlet temperature T_W_in [°C]
    "p_h2_in",  # x3  hydrogen inlet pressure P_H_in
    "p_air_in",  # x4  air inlet pressure P_O_in
    "coolant_t_out",  # x5  coolant outlet temperature T_W_out [°C]
    "h2_flow",  # x6  hydrogen flow m_H2 [slpm]
    "air_flow",  # x7  air flow m_O2 [slpm]
)


def channel_names(n: int) -> tuple:
    """Input-channel labels for an ``n``-wide vector: ``INPUT_CHANNELS`` when
    the width is 8, positional ``chN`` otherwise."""
    if n == len(INPUT_CHANNELS):
        return tuple(INPUT_CHANNELS)
    return tuple(f"ch{i}" for i in range(n))


@dataclasses.dataclass
class ComprehensiveResults:
    """Typed wrapper over the N×22 results matrix."""

    array: np.ndarray  # (N, 22) float64

    def __post_init__(self):
        arr = np.asarray(self.array, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] <= REQUIRED_MAX_INDEX:
            raise ValueError(
                f"comprehensive_results must be (N, >={REQUIRED_MAX_INDEX + 1}); "
                f"got {arr.shape}"
            )
        self.array = arr

    def __len__(self):
        return self.array.shape[0]

    def col(self, name: str) -> np.ndarray:
        return self.array[:, INDEX[name]]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.col(name)

    @property
    def labels(self) -> np.ndarray:
        return self.array[:, INDEX["label"]].astype(np.int32)

    def residual_matrix(self, keys=("res", "pV", "pT", "pH", "pO")) -> np.ndarray:
        """Stack residual channels column-wise (RF input, 04:220-223)."""
        return np.stack([self.col(k) for k in keys], axis=1)


def save_comprehensive_results(results, path: str) -> None:
    """Persist under the MAT variable name the downstream stages expect
    (01:2185-2187), creating parent directories."""
    arr = results.array if isinstance(results, ComprehensiveResults) else results
    ensure_parent(path)
    scipy.io.savemat(path, {"comprehensive_results": np.asarray(arr, np.float64)})


def load_comprehensive_results(path: str) -> ComprehensiveResults:
    """Load + schema-check (mirrors 02:105-114 / 03:90-99 / 04:168-177)."""
    from scipy.io.matlab import MatReadError

    try:
        data = scipy.io.loadmat(path)
    except (OSError, ValueError, TypeError, NotImplementedError,
            MatReadError, IndexError) as e:
        raise ValueError(f"{path}: not a readable MATLAB .mat file ({e})") from e
    if "comprehensive_results" not in data:
        raise KeyError(f"{path}: MAT file has no variable 'comprehensive_results'")
    return ComprehensiveResults(np.array(data["comprehensive_results"]))
