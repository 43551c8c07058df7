"""The miniature 22-column artifact that the port's diagnosis tests share
(``tests/test_torch_diagnosis_pipelines.py``, ``tests/test_torch_compare.py``,
``tests/test_torch_cuda.py``), in the ``fake_results`` pattern of
tests/test_diagnosis.py.  It imports numpy and the port only, so the card-only
tests can use it where JAX is absent."""

import numpy as np

from pinnfc_tpu_torch.data.contract import INDEX


def miniature_artifact() -> np.ndarray:
    """400 normal rows and 12 fault segments of 50, each fault class (水淹,
    氧饥饿, 膜干, 氢饥饿: labels 1-3, 4-6, 7-9, 10-12) shifting one physics
    residual, the faults raising res and epi."""
    rng = np.random.RandomState(0)
    n_normal, n_fault = 400, 50
    n = n_normal + 12 * n_fault
    arr = np.zeros((n, 22))
    arr[:, INDEX["x0"]] = rng.uniform(100, 400, n)
    for k in ("x3", "x4", "x5"):
        arr[:, INDEX[k]] = rng.randn(n)
    arr[:, INDEX["y_true"]] = 4.0 + 0.05 * rng.randn(n)
    arr[:, INDEX["epi"]] = 0.01 + 0.002 * rng.rand(n)
    arr[:, INDEX["res"]] = 0.02 * rng.randn(n)
    for k in ("pV", "pT", "pH", "pO"):
        arr[:, INDEX[k]] = 0.3 * rng.randn(n)
    for label in range(1, 13):
        seg = slice(n_normal + (label - 1) * n_fault, n_normal + label * n_fault)
        arr[seg, INDEX["label"]] = label
        arr[seg, INDEX["res"]] += np.linspace(0.02, 0.3, n_fault)
        arr[seg, INDEX["epi"]] += 0.004
        arr[seg, INDEX["x5"]] += 0.3
        arr[seg, INDEX["y_true"]] -= 0.03
        channel = ("pV", "pT", "pH", "pO")[(label - 1) // 3]
        arr[seg, INDEX[channel]] += rng.uniform(0.3, 0.9, n_fault)
    return arr
