"""Figures of every command's ``--plot-dir`` (counterpart of ``pinnfc_tpu/viz``).
matplotlib is imported on a figure's first call, so this package imports
without it."""

from pinnfc_tpu_torch.viz.plots import (
    plot_conformal,
    plot_confusion_matrix,
    plot_detailed_results,
    fault_prob_filename,
    plot_fault_probabilities,
    plot_feature_scatter,
    plot_identifiability,
    plot_metrics_bars,
    plot_res_vs_epi,
    plot_scatter_by_features,
    plot_rf_attribution,
    plot_rf_condition,
    plot_roc_curves,
    plot_saliency,
    plot_split_overview,
    plot_temp_comparison,
    plot_temp_vs_voltage,
    plot_uncertainty,
    plot_whatif,
    tsne_embed,
)

__all__ = [
    "plot_conformal",
    "plot_confusion_matrix",
    "plot_detailed_results",
    "fault_prob_filename",
    "plot_fault_probabilities",
    "plot_feature_scatter",
    "plot_identifiability",
    "plot_metrics_bars",
    "plot_res_vs_epi",
    "plot_scatter_by_features",
    "plot_rf_attribution",
    "plot_rf_condition",
    "plot_roc_curves",
    "plot_saliency",
    "plot_split_overview",
    "plot_temp_comparison",
    "plot_temp_vs_voltage",
    "plot_uncertainty",
    "plot_whatif",
    "tsne_embed",
]
