"""Shared CLI helpers (counterpart of ``pinnfc_tpu/cli/_common.py``): the
reduced schedule, the training config from flags, the campaign from flags,
the checkpoint's provenance line, the λ table, the monitor's glitch-alarm
default and streaming conformal calibration, and the errors a command
reports as its exit code."""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np

from pinnfc_tpu_torch.config import StageConfig, TrainConfig
from pinnfc_tpu_torch.models.pinn import LAMBDA_INIT, LAMBDA_NAMES

# what a run can fail with that the user can act on: no card, an unreadable
# file, a bad spec, a missing optional package (scikit-learn for an sklearn
# option, matplotlib for --plot-dir)
_USER_ERRORS = (RuntimeError, ValueError, KeyError, OSError, ImportError)


def _small_schedule():
    """Reduced schedule for quick verification runs (same stage order)."""
    return (
        StageConfig("dnn", 300, lr=0.01),
        StageConfig("lambda_v", 150, lr=1e-3, dnn_para=False),
        StageConfig("lambda_v", 150, lr=1e-3, dnn_para=True),
        StageConfig("dnn", 300, lr=0.01),
        StageConfig("thermal", 500, lr=1.0),
        StageConfig("hydrogen", 300, lr=0.1, lr_gamma=0.9),
        StageConfig("oxygen", 300, lr=0.01, lr_gamma=0.9),
    )


def _train_config(args) -> TrainConfig:
    """``--small`` (reduced schedule, 200 MC passes), ``--seed``,
    ``--steps-scale`` (every stage's n_iter times the factor, at least 1),
    ``--precision`` and ``--skip-nonfinite`` → ``TrainConfig``."""
    if getattr(args, "small", False):
        cfg = TrainConfig(schedule=_small_schedule(), mc_times=200, seed=args.seed)
    else:
        cfg = TrainConfig(seed=args.seed)
    scale = getattr(args, "steps_scale", None)
    if scale:
        cfg = dataclasses.replace(cfg, schedule=tuple(
            dataclasses.replace(s, n_iter=max(1, int(s.n_iter * scale))) for s in cfg.schedule))
    precision = getattr(args, "precision", None)
    if precision:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, precision=precision))
    if getattr(args, "skip_nonfinite", False):
        cfg = dataclasses.replace(cfg, skip_nonfinite=True)
    return cfg


def _data_parallel_mesh(args):
    """The mesh of ``--data-parallel``: one ``"data"`` axis over every visible
    device (``parallel/mesh.py::visible_devices``); None without the flag.  Raises
    RuntimeError when CUDA is asked for and absent."""
    if not getattr(args, "data_parallel", False):
        return None
    from pinnfc_tpu_torch.device import resolve_device
    from pinnfc_tpu_torch.parallel.mesh import make_mesh, visible_devices

    resolve_device(args.device)
    return make_mesh(devices=visible_devices(args.device))


def _print_ckpt_provenance(ckpt_path: str):
    """One line saying which model is about to score, from the checkpoint's
    ``.meta.json`` sidecar if it has one; returns that summary dict (None
    without one), which ``cli serve`` shows on GET /health."""
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint_meta

    meta = load_checkpoint_meta(ckpt_path)
    if meta is None:
        return None
    summary = {key: meta[key] for key in ("created", "framework_version") if key in meta}
    if isinstance(meta.get("config"), dict) and "seed" in meta["config"]:
        summary["seed"] = meta["config"]["seed"]
    if isinstance(meta.get("metrics"), dict) and isinstance(
            meta["metrics"].get("voltage_mae"), float):
        summary["voltage_mae"] = meta["metrics"]["voltage_mae"]
    if summary:
        print("checkpoint provenance: " + " ".join(f"{k}={v}" for k, v in summary.items()))
    return summary or None


def _campaign_from_args(args):
    """--normal-mat/--fault-dir → ``CampaignConfig`` (None when neither is
    given; ValueError when only one is)."""
    normal_mat, fault_dir = getattr(args, "normal_mat", None), getattr(args, "fault_dir", None)
    if not (normal_mat or fault_dir):
        return None
    from pinnfc_tpu_torch.data.campaign import CampaignConfig

    if not (normal_mat and fault_dir):
        raise ValueError("real campaigns need BOTH --normal-mat and --fault-dir")
    campaign = CampaignConfig.from_dir(normal_mat, fault_dir, seed=args.seed)
    print(f"campaign: {normal_mat} + faults from {fault_dir}")
    return campaign


def _print_lambda_table(params) -> None:
    """The identified physics parameters with their physical names; the
    λ's are tensors on any device or numpy arrays."""
    print("identified physics parameters (λ):")
    for group, names in LAMBDA_NAMES.items():
        vals = params.get(group)
        if vals is None:
            continue
        if hasattr(vals, "detach"):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals).ravel()
        inits = np.asarray(LAMBDA_INIT[group]).ravel()
        for i, name in enumerate(names):
            moved = "" if np.isclose(vals[i], inits[i]) else f"  (init {inits[i]:.6g})"
            print(f"  {group}[{i}] = {vals[i]:<12.6g} {name}{moved}")


def _finite_or_none(o):
    """``o`` for strict JSON (``allow_nan=False``): every non-finite float,
    in nested dicts and lists too, becomes None (null)."""
    if isinstance(o, float) and not math.isfinite(o):
        return None
    if isinstance(o, dict):
        return {k: _finite_or_none(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_finite_or_none(v) for v in o]
    return o


def _draw_figures(command: str, plot_dir: str, draw, done: str = None) -> int:
    """``draw()`` the command's ``--plot-dir`` figures into ``plot_dir``
    (created), then print ``done`` (default ``figures → <plot_dir>``); the
    command's exit code: 1 when drawing fails (matplotlib missing, an
    unwritable directory)."""
    try:
        os.makedirs(plot_dir, exist_ok=True)
        draw()
    except _USER_ERRORS as e:
        print(f"{command}: {e}", file=sys.stderr)
        return 1
    print(done or f"figures → {plot_dir}")
    return 0


def _glitch_default() -> int:
    from pinnfc_tpu_torch.serving.monitor import DEFAULT_GLITCH_ALARM_N

    return DEFAULT_GLITCH_ALARM_N


def _streaming_conformal_calib(arr, alpha, announce=True):
    """Normal-row |res| calibration vector for the streaming monitor (the
    ``uq/conformal`` 'absolute' score, the one computable online without MC
    sampling)."""
    from pinnfc_tpu_torch.uq import normal_calibration_scores

    calib = normal_calibration_scores(arr, score="absolute", calib_frac=1.0)
    if announce:
        print(f"conformal calibration: {calib.size} normal scores, α={alpha:g}")
    return calib
