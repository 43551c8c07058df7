"""Offline scoring: a NEW campaign through an EXISTING checkpoint
(counterpart of ``pinnfc_tpu/pipeline/score.py``).

``run_scoring_pipeline`` loads a checkpoint (params + the TRAINING campaign's
MinMax scalers), normalizes the new measurements through those frozen
scalers, and runs the MC-dropout exporter to produce a 22-column
``comprehensive_results`` artifact without retraining.  On CUDA it runs
through the fused residual kernel, and through the MC-dropout kernel for a
flagship checkpoint or the ``torch.Generator`` sampler for any other.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional

import numpy as np

from pinnfc_tpu_torch.config import TrainConfig, train_config_from_dict
from pinnfc_tpu_torch.data.campaign import CampaignConfig, load_campaign_dataset
from pinnfc_tpu_torch.data.combine import FuelCellDataset, combine_and_normalize
from pinnfc_tpu_torch.data.contract import ComprehensiveResults, save_comprehensive_results
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.models.pinn import PinnParams
from pinnfc_tpu_torch.parallel.mesh import Mesh
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results, default_mc_seed
from pinnfc_tpu_torch.pipeline.train_pipeline import evaluate_voltage_metrics
from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_meta

# Distribution-shift alarm: on the model's own training campaign every normal
# row lies inside [-1, 1] by construction (01:266-274).
OOB_WARN_FRACTION = 0.05


def _normal_out_of_range_fraction(dataset: FuelCellDataset) -> float:
    """Fraction of NORMAL-labelled rows with any feature outside [-1, 1]
    after normalization through the checkpoint's scalers."""
    labels = dataset.info.fault_labels(int(dataset.x_test.shape[0]))
    x_normal = dataset.x_test.cpu().numpy()[labels == 0]
    if x_normal.size == 0:
        return 0.0
    tol = 1e-5  # f32 round-off on the affine transform
    out = np.any((x_normal < -1.0 - tol) | (x_normal > 1.0 + tol), axis=1)
    return float(np.mean(out))


@dataclasses.dataclass
class ScoreResult:
    params: PinnParams
    dataset: FuelCellDataset
    results: ComprehensiveResults
    metrics: Dict[str, float]
    timings: Dict[str, float]
    export: Dict[str, object]  # the MC sampler that ran and its passes


def run_scoring_pipeline(
    ckpt_path: str,
    config: Optional[TrainConfig] = None,
    dataset: Optional[FuelCellDataset] = None,
    campaign: Optional[CampaignConfig] = None,
    mat_path: Optional[str] = None,
    n_normal: int = 6000,
    n_fault: int = 800,
    verbose: bool = False,
    device="cuda",
    mc_seed: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> ScoreResult:
    """Checkpoint + new measurements → ``comprehensive_results`` artifact.

    Data source precedence: ``dataset`` (pre-built, already in the
    checkpoint's normalized space and on ``device``) > ``campaign`` (a
    ``CampaignConfig`` pointing at real .mat files) > the synthetic generator;
    a campaign and the generator's output are normalized through the
    CHECKPOINT's scalers, never re-fit.  ``config``
    supplies the MC export settings and the seed; None adopts the
    checkpoint's ``.meta.json`` training config, else ``TrainConfig()``.
    ``mc_seed`` defaults to ``default_mc_seed(config.seed)``.  ``device``
    defaults to the card and raises when CUDA is absent.  ``export`` names
    the MC sampler that ran (chosen by topology) and its passes.  With
    ``mesh``, the MC phase shards its rows over the mesh's ``"data"`` axis
    (see ``build_comprehensive_results``); the data lie on ``device``.
    """
    dev = resolve_device(device)
    if config is None:
        meta = load_checkpoint_meta(ckpt_path)
        if meta is not None and "config" in meta:
            config = train_config_from_dict(meta["config"])
        else:
            config = TrainConfig()

    timings: Dict[str, float] = {}

    t0 = time.perf_counter()
    ckpt = load_checkpoint(ckpt_path, device=dev)
    if "scaler_x" not in ckpt or "scaler_y" not in ckpt:
        raise ValueError(
            f"checkpoint '{ckpt_path}' carries no scalers — the normalized "
            "space the model expects is unknown; re-save with the scalers"
        )
    params = ckpt["params"]
    scalers = (ckpt["scaler_x"], ckpt["scaler_y"])
    timings["ckpt_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if dataset is None and campaign is not None:
        dataset = load_campaign_dataset(campaign, scalers=scalers, device=dev)
        if verbose:
            print(f"campaign: {dataset.info.normal_samples} normal rows + "
                  f"{len(dataset.info.segment_labels)} fault segments "
                  f"({dataset.info.fault_samples} rows), normalized through "
                  "the checkpoint's scalers")
    if dataset is None:
        normal, faults = synthesize_stack_data(
            n_normal=n_normal, n_fault=n_fault, seed=config.seed
        )
        dataset = combine_and_normalize(
            normal, faults, training_rate=config.training_rate,
            seed=config.seed, scalers=scalers, device=dev,
        )
    timings["data_s"] = time.perf_counter() - t0

    oob = _normal_out_of_range_fraction(dataset)
    if oob > OOB_WARN_FRACTION:
        warnings.warn(
            f"{oob:.1%} of the campaign's NORMAL rows fall outside the "
            "checkpoint scalers' [-1, 1] training range — the new campaign "
            "has drifted from the conditions this model was trained on; "
            "scores may be unreliable (consider retraining)",
            stacklevel=2,
        )
    if verbose:
        print(f"drift check: {oob:.2%} of normal rows outside the "
              "checkpoint's training range")

    mc_seed = default_mc_seed(config.seed) if mc_seed is None else int(mc_seed)
    t0 = time.perf_counter()
    results, export = build_comprehensive_results(
        params,
        dataset,
        mc_seed=mc_seed,
        mc_times=config.mc_times,
        dropout=config.mc_dropout,
        smooth_window=config.smooth_window,
        mesh=mesh,
    )
    timings["export_s"] = time.perf_counter() - t0

    metrics = evaluate_voltage_metrics(params, dataset, results=results)
    metrics["normal_oob_frac"] = oob

    if mat_path is not None:
        save_comprehensive_results(results, mat_path)

    return ScoreResult(
        params=params, dataset=dataset, results=results, metrics=metrics, timings=timings,
        export=export,
    )
