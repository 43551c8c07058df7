"""``train`` and ``score`` subcommands (counterpart of ``pinnfc_tpu/cli/train.py``)."""

from __future__ import annotations

import dataclasses
import datetime
import json
import sys

from pinnfc_tpu_torch.cli._common import _print_lambda_table, _train_config


def _sizes(args):
    n_normal = args.n_normal or (1500 if args.small else 6000)
    n_fault = args.n_fault or (200 if args.small else 800)
    return n_normal, n_fault


def cmd_train(args) -> int:
    from pinnfc_tpu_torch.config import train_config_to_dict
    from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _train_config(args)
    n_normal, n_fault = _sizes(args)
    try:
        res = run_training_pipeline(
            cfg, mat_path=args.mat_out, n_normal=n_normal, n_fault=n_fault, verbose=True,
            checkpoint_dir=args.resume_dir, device=args.device,
        )
    except (RuntimeError, ValueError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"metrics": res.metrics, "timings": res.timings}, indent=2))
    _print_lambda_table(res.params)
    if args.ckpt:
        save_checkpoint(
            args.ckpt, res.params, res.dataset.scaler_x, res.dataset.scaler_y,
            meta={
                "created": datetime.datetime.now(datetime.timezone.utc).isoformat(
                    timespec="seconds"),
                "config": train_config_to_dict(cfg),
                "n_normal": n_normal,
                "n_fault": n_fault,
                "metrics": res.metrics,
            },
        )
        print(f"checkpoint → {args.ckpt}")
    if args.mat_out:
        print(f"comprehensive_results → {args.mat_out}")
    return 0


def cmd_score(args) -> int:
    """Score a campaign with an existing checkpoint, no retraining.  The MC
    settings, the seed and the synthetic campaign's sizes default to the ones
    the checkpoint's sidecar records (``pinnfc_tpu/cli/train.py:188-218``), so
    scoring the training campaign reproduces the train-time artifact."""
    from pinnfc_tpu_torch.config import train_config_from_dict
    from pinnfc_tpu_torch.pipeline.score import run_scoring_pipeline
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint_meta

    meta = load_checkpoint_meta(args.ckpt)
    if meta is not None and "config" in meta:
        cfg = train_config_from_dict(meta["config"])
        if args.small:
            cfg = dataclasses.replace(cfg, mc_times=200)
        if args.seed is not None:
            cfg = dataclasses.replace(cfg, seed=args.seed)
        if not args.small:
            if args.n_normal is None:
                args.n_normal = meta.get("n_normal")
            if args.n_fault is None:
                args.n_fault = meta.get("n_fault")
    else:
        args.seed = 42 if args.seed is None else args.seed
        cfg = _train_config(args)
    if args.mc_times is not None:
        cfg = dataclasses.replace(cfg, mc_times=args.mc_times)
    n_normal, n_fault = _sizes(args)
    try:
        res = run_scoring_pipeline(
            args.ckpt, config=cfg, mat_path=args.mat_out, n_normal=n_normal, n_fault=n_fault,
            verbose=True, device=args.device,
        )
    except (RuntimeError, ValueError) as e:
        print(f"score: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"metrics": res.metrics, "timings": res.timings}, indent=1))
    print("artifact →", args.mat_out)
    return 0
