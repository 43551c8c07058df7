"""Six-method 4-class fault-diagnosis comparison (counterpart of
``pinnfc_tpu/diagnosis/compare.py``; reference script 05).

Methods, each wrapped with the shared posterior label calibration
(``diagnosis/posterior.py``), the fits on the device:

1. GMM posterior        — EM (05:229-279, components = 5×4)
2. Supervised LR        — Newton (05:284-309)
3. Linear SVM           — OvO squared hinge, batched L-BFGS (05:314-341; the
                          reference's "RBF" docstring is wrong, the kernel IS
                          linear — quirk preserved)
4. KMeans posterior     — Lloyd, hard calibration (05:346-393)
5. Agglomerative (Ward) — ``diagnosis/ward.py`` (NN-chain above N = 2048);
                          sklearn via ``device_ward=False`` (05:398-450)
6. Spectral             — ``diagnosis/spectral.py`` (subspace iteration
                          above N = 4096); sklearn via
                          ``device_spectral=False`` (05:455-512)

Draws: GMM, KMeans and Spectral each take a fresh CPU
``torch.Generator().manual_seed(seed)`` (the JAX package reuses one
``jax.random`` key for the three).  The sklearn options import scikit-learn
inside the call and raise ImportError without it; there is no fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from pinnfc_tpu_torch.config import CompareConfig, GmmConfig
from pinnfc_tpu_torch.data.contract import ComprehensiveResults
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.features import (
    build_label_mapper,
    extract_X_y,
    parse_features,
    parse_group_spec,
)
from pinnfc_tpu_torch.diagnosis.gmm import gmm_fit, gmm_predict_proba
from pinnfc_tpu_torch.diagnosis.kmeans import kmeans_fit, kmeans_predict
from pinnfc_tpu_torch.diagnosis.logreg import logreg_fit, logreg_predict
from pinnfc_tpu_torch.diagnosis.metrics import (
    classification_report_dict,
    compute_macro_metrics,
    confusion_matrix,
)
from pinnfc_tpu_torch.diagnosis.posterior import (
    calibrate_components,
    hard_responsibilities,
    posterior_probabilities,
)
from pinnfc_tpu_torch.diagnosis.spectral import spectral_fit
from pinnfc_tpu_torch.diagnosis.splits import stratified_split
from pinnfc_tpu_torch.diagnosis.svm import svm_fit, svm_predict
from pinnfc_tpu_torch.diagnosis.ward import ward_fit

METHODS = ("gmm", "logreg", "svm", "kmeans", "agglomerative", "spectral")


@dataclasses.dataclass
class MethodResult:
    name: str
    y_pred: np.ndarray
    metrics: Dict[str, float]
    confusion: np.ndarray
    report: Dict


@dataclasses.dataclass
class CompareResult:
    methods: List[MethodResult]
    y_true: np.ndarray
    class_names: List[str]

    def summary_table(self) -> Dict[str, Dict[str, float]]:
        return {m.name: m.metrics for m in self.methods}


def _centers_from_assignments(x, assign, n_clusters):
    """Synthetic cluster centers = per-cluster means (05:419-425)."""
    centers = np.zeros((n_clusters, x.shape[1]))
    for c in range(n_clusters):
        m = assign == c
        if m.any():
            centers[c] = x[m].mean(axis=0)
    return centers


def _nearest_center(x, centers, dev) -> np.ndarray:
    return kmeans_predict(torch.as_tensor(centers, dtype=torch.float32, device=dev),
                          x).cpu().numpy()


def _import_sklearn_cluster():
    try:
        import sklearn.cluster as cluster
    except ImportError as e:
        raise ImportError("device_ward=False / device_spectral=False run scikit-learn's "
                          "estimator, and scikit-learn is not installed") from e
    return cluster


def run_compare_pipeline(
    results,
    config: CompareConfig = CompareConfig(),
    gmm_config: GmmConfig = GmmConfig(),
    methods: Optional[List[str]] = None,
    device_spectral: bool = True,
    device_ward: bool = True,
    device="cuda",
    seed: Optional[int] = None,
) -> CompareResult:
    """Script-05 main (05:614-707) on ``device``.  ``seed`` (default
    ``config.random_state``) seeds the CPU generators of GMM, KMeans and
    Spectral."""
    dev = resolve_device(device)
    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    groups = parse_group_spec(gmm_config.group_spec)
    label_map, class_names = build_label_mapper(groups)
    k = len(class_names)

    feat_idx = parse_features(gmm_config.features)
    x, y = extract_X_y(arr, feat_idx, label_map)
    x_tr, x_te, y_tr, y_te = stratified_split(
        x, y, y=y, test_size=config.test_size, random_state=config.random_state
    )

    todo = methods or list(METHODS)
    unknown = sorted(set(todo) - set(METHODS))
    if unknown:
        raise ValueError(f"unknown methods {unknown}; choose from {', '.join(METHODS)}")
    seed = config.random_state if seed is None else seed
    out: List[MethodResult] = []

    def add(name, y_pred):
        out.append(
            MethodResult(
                name=name,
                y_pred=y_pred,
                metrics=compute_macro_metrics(y_te, y_pred, k),
                confusion=confusion_matrix(y_te, y_pred, k),
                report=classification_report_dict(y_te, y_pred, class_names),
            )
        )

    def add_clustering(name, assign_tr, n_clusters):
        centers = _centers_from_assignments(x_tr, assign_tr, n_clusters)
        cal = calibrate_components(hard_responsibilities(assign_tr, n_clusters), y_tr, k)
        _, y_pred = posterior_probabilities(
            hard_responsibilities(_nearest_center(x_te, centers, dev), n_clusters), cal
        )
        add(name, y_pred)

    if "gmm" in todo:
        n_comp = config.gmm_components_factor * k
        model = gmm_fit(x_tr, torch.Generator().manual_seed(seed), n_components=n_comp,
                        device=dev)
        resp_tr = gmm_predict_proba(model, x_tr).cpu().numpy()
        cal = calibrate_components(resp_tr, y_tr, k)
        _, y_pred = posterior_probabilities(gmm_predict_proba(model, x_te).cpu().numpy(), cal)
        add("GMM", y_pred)

    if "logreg" in todo:
        lr = logreg_fit(x_tr, y_tr, n_classes=k, balanced=True, device=dev)
        add("Supervised_LR", logreg_predict(lr, x_te).cpu().numpy())

    if "svm" in todo:
        svm = svm_fit(x_tr, y_tr, n_classes=k, c_svm=config.svm_c, balanced=True, device=dev)
        add("Supervised_SVM", svm_predict(svm, x_te).cpu().numpy())

    if "kmeans" in todo:
        n_clusters = config.kmeans_clusters_factor * k
        km = kmeans_fit(x_tr, torch.Generator().manual_seed(seed), n_clusters=n_clusters,
                        device=dev)
        cal = calibrate_components(
            hard_responsibilities(km.assignments.cpu().numpy(), n_clusters), y_tr, k
        )
        assign_te = kmeans_predict(km.centers, x_te).cpu().numpy()
        _, y_pred = posterior_probabilities(hard_responsibilities(assign_te, n_clusters), cal)
        add("KMeans", y_pred)

    if "agglomerative" in todo:
        n_clusters = config.agglo_clusters_factor * k
        if device_ward:
            assign_tr = ward_fit(x_tr, n_clusters, device=dev).assignments.cpu().numpy()
        else:
            cluster = _import_sklearn_cluster()
            agg = cluster.AgglomerativeClustering(n_clusters=n_clusters, linkage="ward")
            assign_tr = agg.fit_predict(x_tr)
        add_clustering("Agglomerative", assign_tr, n_clusters)

    if "spectral" in todo:
        n_clusters = config.spectral_clusters_factor * k
        if device_spectral:
            assign_tr = spectral_fit(
                x_tr, torch.Generator().manual_seed(seed), n_clusters,
                n_neighbors=config.spectral_n_neighbors, device=dev,
            ).assignments.cpu().numpy()
        else:
            cluster = _import_sklearn_cluster()
            spec = cluster.SpectralClustering(
                n_clusters=n_clusters,
                affinity="nearest_neighbors",
                n_neighbors=config.spectral_n_neighbors,
                assign_labels="kmeans",
                random_state=config.random_state,
            )
            assign_tr = spec.fit_predict(x_tr)
        add_clustering("Spectral", assign_tr, n_clusters)

    return CompareResult(methods=out, y_true=np.asarray(y_te), class_names=class_names)
