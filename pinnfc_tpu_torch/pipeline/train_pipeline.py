"""End-to-end stage-01 pipeline: data → staged training → MC export → metrics
(counterpart of ``pinnfc_tpu/pipeline/train_pipeline.py``; the reference's
``__main__``, 01:2055-2228).

``run_training_pipeline`` synthesizes, loads from .mat files, or takes the campaign, initialises the
PINN from a ``torch.Generator`` seeded with ``config.seed``, runs the staged
schedule (``training/stages.py``: the DNN stages through the training kernel),
exports the 22-column artifact with ``default_mc_seed(config.seed)`` (the
MC-dropout kernel for the flagship topology, the ``torch.Generator`` sampler
for any other; the residual kernel for every one), and prints the metric block
(``evaluate_voltage_metrics``, reference 01:1765-1818).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from pinnfc_tpu_torch.config import TrainConfig
from pinnfc_tpu_torch.data.campaign import CampaignConfig, load_campaign_dataset
from pinnfc_tpu_torch.data.combine import FuelCellDataset, combine_and_normalize
from pinnfc_tpu_torch.data.contract import ComprehensiveResults, save_comprehensive_results
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.models.pinn import PinnParams, init_pinn
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.parallel.mesh import Mesh
from pinnfc_tpu_torch.physics.hydrogen import hydrogen_residual
from pinnfc_tpu_torch.physics.oxygen import oxygen_residual
from pinnfc_tpu_torch.physics.thermal import thermal_residual_euler
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results, default_mc_seed
from pinnfc_tpu_torch.training.stages import TrainLog, run_schedule


@dataclasses.dataclass
class PipelineResult:
    params: PinnParams
    dataset: FuelCellDataset
    results: ComprehensiveResults
    log: TrainLog
    metrics: Dict[str, float]
    timings: Dict[str, float]
    export: Dict[str, object]  # the MC sampler that ran and its passes


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _printed_extras(params: PinnParams, x_test, pred_norm, sx, sy):
    """What the printed block uses but the export array does not carry: the
    FULL Euler thermal residual (01:1670) and the target ratios (01:1810-1816)."""
    t = thermal_residual_euler(params["lam_t"], x_test, pred_norm, sx, sy)
    h = hydrogen_residual(params["lam_h"], x_test, sx)
    o = oxygen_residual(params["lam_o"], x_test, sx)
    return _np(t.f[:, 0]), _np(h.target_ratio[:, 0]), _np(o.target_ratio[:, 0])


@torch.no_grad()
def evaluate_voltage_metrics(
    params: PinnParams,
    dataset: FuelCellDataset,
    results: Optional[ComprehensiveResults] = None,
) -> Dict[str, float]:
    """MAE / RMSE / R² / max-abs-err of the de-normalized voltage prediction
    plus physics-residual statistics (reference metric block, 01:1765-1818).

    ``temp_*`` come from the FULL Euler residual as the reference prints them
    (01:1670); ``temp_mae_simple`` is export column 14's simple model.  With
    ``results`` (the export of the same params and dataset) the export
    columns are read from its array.  Without it, one eval forward serves
    everything, as the JAX ``_metrics_device`` does: ``scaler_y.inverse`` of
    the targets and of the prediction, and the residual bundle through the
    fused residual kernel (its plain version on CPU tensors).  Either way the
    extras take the eval forward, a plain float32 matmul chain outside any
    kernel."""
    sx, sy = dataset.scaler_x, dataset.scaler_y
    x_test = dataset.x_test
    pred_norm, _ = params["mlp"](x_test)
    f_t_euler, target_h, target_o = _printed_extras(params, x_test, pred_norm, sx, sy)
    if results is not None:
        arr = results.array
        y_real, p_real = arr[:, 8], arr[:, 9]
        f_v, f_t_col, f_h, f_o = arr[:, 13], arr[:, 14], arr[:, 15], arr[:, 16]
        ratio_h, ratio_o = arr[:, 20], arr[:, 21]
    else:
        y_real = _np(sy.inverse(dataset.y_test)[:, 0])
        p_real = _np(sy.inverse(pred_norm)[:, 0])
        bundle = all_residuals_kernel(params, x_test, pred_norm, sx, sy)
        f_v, f_t_col, f_h, f_o, _, _, ratio_h, ratio_o = (_np(t[:, 0]) for t in bundle)
    err = y_real - p_real
    ss_res = float(np.sum(err**2))
    ss_tot = float(np.sum((y_real - y_real.mean()) ** 2))

    # normal-segment-only fit: the model trains on normal operation only
    n_norm = dataset.info.normal_samples
    e_n = err[:n_norm]
    y_n = y_real[:n_norm]
    ss_tot_n = float(np.sum((y_n - y_n.mean()) ** 2))

    # smoothed Euler temperature residual: np.convolve 'same', window 100
    # (01:1776-1782); shorter series pass through unsmoothed (01:1777)
    w = 100
    f_t_smooth = (
        np.convolve(f_t_euler, np.ones(w) / w, mode="same")
        if len(f_t_euler) >= w
        else f_t_euler
    )

    return {
        "voltage_mae": float(np.mean(np.abs(err))),
        "voltage_rmse": float(np.sqrt(np.mean(err**2))),
        "voltage_r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan"),
        "voltage_max_abs_err": float(np.max(np.abs(err))),
        "voltage_mae_normal": float(np.mean(np.abs(e_n))),
        "voltage_r2_normal": (
            1.0 - float(np.sum(e_n**2)) / ss_tot_n if ss_tot_n > 0 else float("nan")
        ),
        "physics_v_mae": float(np.mean(np.abs(f_v))),
        "physics_v_rmse": float(np.sqrt(np.mean(f_v**2))),
        "temp_mae": float(np.mean(np.abs(f_t_euler))),
        "temp_rmse": float(np.sqrt(np.mean(f_t_euler**2))),
        "temp_mae_smooth": float(np.mean(np.abs(f_t_smooth))),
        "temp_rmse_smooth": float(np.sqrt(np.mean(f_t_smooth**2))),
        "temp_mae_simple": float(np.mean(np.abs(f_t_col))),
        "hydrogen_mae": float(np.mean(np.abs(f_h))),
        "hydrogen_rmse": float(np.sqrt(np.mean(f_h**2))),
        "oxygen_mae": float(np.mean(np.abs(f_o))),
        "oxygen_rmse": float(np.sqrt(np.mean(f_o**2))),
        "ratio_h_min": float(np.min(ratio_h)),
        "ratio_h_max": float(np.max(ratio_h)),
        "ratio_h_target_min": float(np.min(target_h)),
        "ratio_h_target_max": float(np.max(target_h)),
        "ratio_o_min": float(np.min(ratio_o)),
        "ratio_o_max": float(np.max(ratio_o)),
        "ratio_o_target_min": float(np.min(target_o)),
        "ratio_o_target_max": float(np.max(target_o)),
    }


def run_training_pipeline(
    config: TrainConfig = TrainConfig(),
    dataset: Optional[FuelCellDataset] = None,
    campaign: Optional[CampaignConfig] = None,
    mat_path: Optional[str] = None,
    n_normal: int = 6000,
    n_fault: int = 800,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    ckpt_every: Optional[int] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> PipelineResult:
    """Execute the stage-01 pipeline on ``device`` (the card by default; it
    raises when CUDA is absent).  Data source precedence: ``dataset``
    (pre-built, on ``device``) > ``campaign`` (a ``CampaignConfig`` pointing
    at real .mat files, reference 01:2055-2135) > the synthetic generator.
    ``checkpoint_dir`` saves the params after every stage, or with
    ``ckpt_every`` after every ``ckpt_every`` steps inside each stage, and
    resumes a restarted run (see ``run_schedule``).  ``timings`` holds
    ``data_s``, ``train_s`` and ``export_s``; the metric block gains
    ``final_loss/<k:stage>``; ``export`` names the MC sampler that ran
    ('kernel' for the flagship topology, else 'vmap') and its passes.  With
    ``mesh``, the schedule runs data-parallel over its ``"data"`` axis
    (``run_schedule(mesh=)``: rows edge-padded to a multiple of the mesh's
    size, as the JAX pipeline pads them) and the MC export shards its rows
    (``build_comprehensive_results(mesh=)``); the data lie on ``device``."""
    dev = resolve_device(device)
    timings: Dict[str, float] = {}

    t0 = time.perf_counter()
    if dataset is None and campaign is not None:
        dataset = load_campaign_dataset(campaign, device=dev)
        if verbose:
            print(f"campaign: {dataset.info.normal_samples} normal rows + "
                  f"{len(dataset.info.segment_labels)} fault segments "
                  f"({dataset.info.fault_samples} rows)")
    if dataset is None:
        normal, faults = synthesize_stack_data(n_normal=n_normal, n_fault=n_fault,
                                               seed=config.seed)
        dataset = combine_and_normalize(normal, faults, training_rate=config.training_rate,
                                        seed=config.seed, device=dev)
    timings["data_s"] = time.perf_counter() - t0

    params = init_pinn(config.model.layers,
                       generator=torch.Generator().manual_seed(config.seed), device=dev)
    t0 = time.perf_counter()
    params, log = run_schedule(
        params, dataset.x_train, dataset.y_train, dataset.scaler_x, dataset.scaler_y,
        schedule=config.schedule, seed=config.seed, dropout_p=config.model.dropout_p,
        verbose=verbose, checkpoint_dir=checkpoint_dir, ckpt_every=ckpt_every,
        precision=config.model.precision,
        skip_nonfinite=config.skip_nonfinite, mesh=mesh,
    )  # each stage ends by copying its losses to the host, which syncs the device
    timings["train_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    results, export = build_comprehensive_results(
        params, dataset, mc_seed=default_mc_seed(config.seed), mc_times=config.mc_times,
        dropout=config.mc_dropout, smooth_window=config.smooth_window, mesh=mesh,
    )
    timings["export_s"] = time.perf_counter() - t0

    metrics = evaluate_voltage_metrics(params, dataset, results=results)
    metrics.update({f"final_loss/{k}": v for k, v in log.final_losses().items()})
    if mat_path is not None:
        save_comprehensive_results(results, mat_path)
    return PipelineResult(params=params, dataset=dataset, results=results, log=log,
                          metrics=metrics, timings=timings, export=export)
