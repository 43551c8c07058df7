"""Fault diagnosis over the artifact: the AUC stage of script 02, the GMM
stage of script 03 and the six-method comparison of script 05, and t-SNE
(counterpart of ``pinnfc_tpu/diagnosis``).

The fits (logistic regression, Isolation Forest, k-means, GMM EM, the
one-vs-one SVM, Ward, spectral clustering, t-SNE) run in torch on a device,
the card by default; splits, metrics and the posterior calibration are host
numpy, as in the JAX package.  Nothing here imports scikit-learn except
``sklearn_kmeans_init_resp``, ``AucConfig.iso_backend='sklearn'`` and
``run_compare_pipeline(device_ward=False | device_spectral=False)``, inside
the call.
"""

from pinnfc_tpu_torch.diagnosis.features import (
    build_label_mapper,
    extract_X_y,
    list_available_features,
    normalize_feature_spec,
    parse_features,
    parse_group_spec,
)
from pinnfc_tpu_torch.diagnosis.metrics import (
    accuracy_score,
    auc,
    classification_report_dict,
    compute_macro_metrics,
    confusion_matrix,
    precision_recall_f1,
    roc_auc_score,
    roc_curve,
)
from pinnfc_tpu_torch.diagnosis.posterior import (
    calibrate_components,
    hard_responsibilities,
    posterior_probabilities,
)
from pinnfc_tpu_torch.diagnosis.gmm import (
    GMMParams,
    gmm_fit,
    gmm_predict_proba,
    gmm_score_samples,
    sklearn_kmeans_init_resp,
)
from pinnfc_tpu_torch.diagnosis.kmeans import KMeansResult, kmeans_fit, kmeans_predict
from pinnfc_tpu_torch.diagnosis.logreg import (
    LogRegModel,
    explain_coefficients,
    logreg_fit,
    logreg_predict,
    logreg_predict_proba,
)
from pinnfc_tpu_torch.diagnosis.isoforest import IsoForest, isoforest_fit, isoforest_score
from pinnfc_tpu_torch.diagnosis.spectral import SpectralResult, spectral_fit
from pinnfc_tpu_torch.diagnosis.ward import WardResult, ward_fit
from pinnfc_tpu_torch.diagnosis.svm import SVMModel, svm_fit, svm_predict
from pinnfc_tpu_torch.diagnosis.tsne import TsneResult, tsne_fit
from pinnfc_tpu_torch.diagnosis.auc import AucPipelineResult, GroupAucResult, run_auc_pipeline
from pinnfc_tpu_torch.diagnosis.gmm_pipeline import GmmDiagnosisResult, run_gmm_pipeline
from pinnfc_tpu_torch.diagnosis.compare import CompareResult, MethodResult, run_compare_pipeline

__all__ = [
    "build_label_mapper",
    "extract_X_y",
    "list_available_features",
    "normalize_feature_spec",
    "parse_features",
    "parse_group_spec",
    "accuracy_score",
    "auc",
    "classification_report_dict",
    "compute_macro_metrics",
    "confusion_matrix",
    "precision_recall_f1",
    "roc_auc_score",
    "roc_curve",
    "calibrate_components",
    "hard_responsibilities",
    "posterior_probabilities",
    "GMMParams",
    "gmm_fit",
    "sklearn_kmeans_init_resp",
    "gmm_predict_proba",
    "gmm_score_samples",
    "KMeansResult",
    "kmeans_fit",
    "kmeans_predict",
    "LogRegModel",
    "explain_coefficients",
    "logreg_fit",
    "logreg_predict",
    "logreg_predict_proba",
    "IsoForest",
    "isoforest_fit",
    "isoforest_score",
    "SpectralResult",
    "spectral_fit",
    "WardResult",
    "ward_fit",
    "SVMModel",
    "svm_fit",
    "svm_predict",
    "TsneResult",
    "tsne_fit",
    "AucPipelineResult",
    "GroupAucResult",
    "run_auc_pipeline",
    "GmmDiagnosisResult",
    "run_gmm_pipeline",
    "CompareResult",
    "MethodResult",
    "run_compare_pipeline",
]
