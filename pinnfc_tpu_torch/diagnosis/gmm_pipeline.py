"""Unsupervised 4-class GMM fault diagnosis (counterpart of
``pinnfc_tpu/diagnosis/gmm_pipeline.py``; reference script 03).

Fit a 20-component full-covariance GMM (EM on the device) on the four
physics residuals, calibrate ``P(fault | component)`` from train labels, map
test responsibilities to class probabilities (03:360-426), report metrics
and the per-fault probability series (03:209-356).  The fitted mixture stays
on the device (``GmmDiagnosisResult.model``); everything else is numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from pinnfc_tpu_torch.config import GmmConfig
from pinnfc_tpu_torch.data.contract import ComprehensiveResults
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.features import (
    build_label_mapper,
    extract_X_y,
    parse_features,
    parse_group_spec,
)
from pinnfc_tpu_torch.diagnosis.gmm import (
    GMMParams,
    gmm_fit,
    gmm_predict_proba,
    sklearn_kmeans_init_resp,
)
from pinnfc_tpu_torch.diagnosis.metrics import (
    accuracy_score,
    classification_report_dict,
    confusion_matrix,
)
from pinnfc_tpu_torch.diagnosis.posterior import calibrate_components, posterior_probabilities
from pinnfc_tpu_torch.diagnosis.splits import stratified_split
from pinnfc_tpu_torch.parallel.mesh import Mesh, data_size


@dataclasses.dataclass
class GmmDiagnosisResult:
    accuracy: float
    confusion: np.ndarray
    report: Dict
    y_prob: np.ndarray  # (n_te, K)
    y_pred: np.ndarray
    y_true: np.ndarray
    test_full_indices: np.ndarray  # test rows → full-array positions (03:562-569)
    comp_fault_prob: np.ndarray
    class_names: List[str]
    model: GMMParams  # the fitted mixture, tensors on the device
    features: str  # the feature spec the mixture was fitted on


def run_gmm_pipeline(
    results,
    config: GmmConfig = GmmConfig(),
    seed: Optional[int] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> GmmDiagnosisResult:
    """Script-03 main (03:513-591) on ``device``.  ``seed`` (default
    ``config.random_state``) seeds the CPU ``torch.Generator`` of the k-means
    init, or sklearn's init with ``config.init='sklearn'``.  With ``mesh``,
    the EM fit splits the training rows over the mesh's ``"data"`` axis
    (padded rows at exactly zero weight, ``parallel/diagnosis.py::
    gmm_fit_dp``) and the mixture lives on its first device; a data axis of
    size 1 takes the unsharded path."""
    dev = resolve_device(device)
    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    groups = parse_group_spec(config.group_spec)
    label_map, class_names = build_label_mapper(groups)
    n_classes = len(class_names)

    feat_idx = parse_features(config.features)
    x, y, full_idx = extract_X_y(arr, feat_idx, label_map, return_indices=True)

    idx = np.arange(len(x))
    x_tr, x_te, y_tr, y_te, _, idx_te = stratified_split(
        x, y, idx, y=y, test_size=config.test_size, random_state=config.random_state
    )

    n_components = config.n_components_factor * n_classes  # 5×4 = 20 (03:548)
    seed = config.random_state if seed is None else seed
    init_resp = None
    if config.init == "sklearn":
        init_resp = sklearn_kmeans_init_resp(x_tr, n_components, seed)
    elif config.init != "kmeans":
        raise ValueError(f"GmmConfig.init must be 'kmeans' or 'sklearn', got {config.init!r}")
    fit_kw = dict(n_components=n_components, max_iter=config.max_iter, tol=config.tol,
                  reg_covar=config.reg_covar,
                  init_resp=None if init_resp is None else np.asarray(init_resp, config.dtype),
                  dtype=config.dtype)
    if data_size(mesh) > 1:
        from pinnfc_tpu_torch.parallel.diagnosis import gmm_fit_dp

        model = gmm_fit_dp(x_tr, torch.Generator().manual_seed(seed), mesh=mesh, **fit_kw)
    else:
        model = gmm_fit(x_tr, torch.Generator().manual_seed(seed), device=dev, **fit_kw)
    resp_tr = gmm_predict_proba(model, x_tr).cpu().numpy()
    comp_fault_prob = calibrate_components(resp_tr, y_tr, n_classes)
    resp_te = gmm_predict_proba(model, x_te).cpu().numpy()
    y_prob, y_pred = posterior_probabilities(resp_te, comp_fault_prob)

    return GmmDiagnosisResult(
        accuracy=accuracy_score(y_te, y_pred),
        confusion=confusion_matrix(y_te, y_pred, n_classes),
        report=classification_report_dict(y_te, y_pred, class_names),
        y_prob=y_prob,
        y_pred=np.asarray(y_pred),
        y_true=np.asarray(y_te),
        test_full_indices=full_idx[idx_te],
        comp_fault_prob=comp_fault_prob,
        class_names=class_names,
        model=model,
        features=config.features,
    )
