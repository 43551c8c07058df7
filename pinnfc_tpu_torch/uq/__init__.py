"""Uncertainty and explainability: MC-dropout statistics, deep-ensemble
moments, split-conformal coverage, input saliency, λ identifiability and
counterfactual recovery."""

from pinnfc_tpu_torch.uq.conformal import (
    ClassCoverage,
    ConformalReport,
    artifact_scores,
    conformal_pvalues,
    conformal_quantile,
    conformal_report,
    normal_calibration_scores,
)
from pinnfc_tpu_torch.uq.deep_ensemble import ensemble_moments, ensemble_moments_sharded
from pinnfc_tpu_torch.uq.counterfactual import (
    ConditionRecovery,
    CounterfactualConfig,
    CounterfactualReport,
    actuatable_mask,
    condition_recovery,
    counterfactual_recovery,
    summarize_recovery,
)
from pinnfc_tpu_torch.uq.identifiability import (
    GroupIdentifiability,
    gauss_newton_ci,
    lambda_identifiability,
)
from pinnfc_tpu_torch.uq.mc_dropout import MCSamples, mc_dropout_samples
from pinnfc_tpu_torch.uq.saliency import (
    SaliencyReport,
    class_mean_saliency,
    coarse_class_saliency,
    input_saliency,
)

__all__ = [
    "ClassCoverage",
    "ConditionRecovery",
    "ConformalReport",
    "CounterfactualConfig",
    "CounterfactualReport",
    "GroupIdentifiability",
    "MCSamples",
    "SaliencyReport",
    "actuatable_mask",
    "artifact_scores",
    "class_mean_saliency",
    "coarse_class_saliency",
    "condition_recovery",
    "conformal_pvalues",
    "conformal_quantile",
    "conformal_report",
    "counterfactual_recovery",
    "ensemble_moments",
    "ensemble_moments_sharded",
    "gauss_newton_ci",
    "input_saliency",
    "lambda_identifiability",
    "mc_dropout_samples",
    "normal_calibration_scores",
    "summarize_recovery",
]
