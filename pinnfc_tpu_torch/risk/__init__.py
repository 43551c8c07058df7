"""RF(t) risk function and early-warning index (script 04)."""

from pinnfc_tpu_torch.risk.rf import (
    ConditionAdvance,
    compute_rf_advance_for_condition,
    compute_rf_time_series,
    condition_row_indices,
    estimate_mu_sigma_normal,
    find_first_alarm_index,
    run_risk_pipeline,
)

__all__ = [
    "ConditionAdvance",
    "compute_rf_advance_for_condition",
    "compute_rf_time_series",
    "condition_row_indices",
    "estimate_mu_sigma_normal",
    "find_first_alarm_index",
    "run_risk_pipeline",
]
