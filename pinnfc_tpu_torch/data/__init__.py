"""Data layer: synthetic and real campaigns, combination, scaling and the 22-column contract."""

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.data.contract import (
    INDEX,
    N_COLUMNS,
    ComprehensiveResults,
    load_comprehensive_results,
    save_comprehensive_results,
)
from pinnfc_tpu_torch.data.combine import DataInfo, FuelCellDataset, combine_and_normalize
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.data.loaders import load_fault_mat, load_normal_mat
from pinnfc_tpu_torch.data.campaign import (
    CampaignConfig,
    default_fault_paths,
    load_campaign,
    load_campaign_dataset,
    write_campaign_mats,
)
from pinnfc_tpu_torch.data.noise import add_noise

__all__ = [
    "AffineScaler",
    "INDEX",
    "N_COLUMNS",
    "ComprehensiveResults",
    "load_comprehensive_results",
    "save_comprehensive_results",
    "DataInfo",
    "FuelCellDataset",
    "combine_and_normalize",
    "synthesize_stack_data",
    "load_normal_mat",
    "load_fault_mat",
    "CampaignConfig",
    "default_fault_paths",
    "load_campaign",
    "load_campaign_dataset",
    "write_campaign_mats",
    "add_noise",
]
