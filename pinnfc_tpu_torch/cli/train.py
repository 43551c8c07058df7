"""``train``, ``score``, ``synth`` and ``ensemble`` subcommands (counterpart of
``pinnfc_tpu/cli/train.py``)."""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import sys

from pinnfc_tpu_torch.cli._common import (
    _campaign_from_args,
    _data_parallel_mesh,
    _draw_figures,
    _print_ckpt_provenance,
    _print_lambda_table,
    _train_config,
)


def _sizes(args):
    n_normal = args.n_normal or (1500 if args.small else 6000)
    n_fault = args.n_fault or (200 if args.small else 800)
    return n_normal, n_fault


def cmd_train(args) -> int:
    import pinnfc_tpu_torch
    from pinnfc_tpu_torch.config import train_config_to_dict
    from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _train_config(args)
    n_normal, n_fault = _sizes(args)
    if args.ckpt_every is not None and not args.resume_dir:
        # chunks without a snapshot directory buy no preemption safety
        print("--ckpt-every requires --resume-dir (nowhere to snapshot)", file=sys.stderr)
        return 2
    try:
        campaign = _campaign_from_args(args)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    try:
        mesh = _data_parallel_mesh(args)
    except (RuntimeError, ValueError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 1
    if mesh is not None:
        print(f"data-parallel over {mesh.size} devices")

    if args.profile_dir:
        from pinnfc_tpu_torch.utils.observability import trace_profiler

        prof_cm = trace_profiler()
        print(f"capturing a torch.profiler trace → {args.profile_dir}")
    else:
        prof_cm = contextlib.nullcontext()
    try:
        with prof_cm as prof:
            res = run_training_pipeline(
                cfg, campaign=campaign, mat_path=args.mat_out, n_normal=n_normal,
                n_fault=n_fault, verbose=True, checkpoint_dir=args.resume_dir,
                ckpt_every=args.ckpt_every, device=args.device, mesh=mesh,
            )
    except (RuntimeError, ValueError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"metrics": res.metrics, "timings": res.timings, "export": res.export},
                     indent=2))
    _print_lambda_table(res.params)
    if args.ckpt:
        save_checkpoint(
            args.ckpt, res.params, res.dataset.scaler_x, res.dataset.scaler_y,
            meta={
                "framework_version": pinnfc_tpu_torch.__version__,
                "created": datetime.datetime.now(datetime.timezone.utc).isoformat(
                    timespec="seconds"),
                "config": train_config_to_dict(cfg),
                "n_normal": n_normal,
                "n_fault": n_fault,
                "campaign": ({"normal_mat": args.normal_mat, "fault_dir": args.fault_dir}
                             if campaign is not None else None),
                "metrics": res.metrics,
            },
        )
        print(f"checkpoint → {args.ckpt}")
    # the reports come after the checkpoint: a bad report path must not cost
    # the trained model
    if args.metrics_jsonl:
        _write_metrics_jsonl(args.metrics_jsonl, res)
    if args.tensorboard_dir:
        _write_tensorboard(args.tensorboard_dir, res)
    if prof is not None:
        from pinnfc_tpu_torch.utils.observability import write_chrome_trace

        print(f"profiler trace → {write_chrome_trace(prof, args.profile_dir)}")
    if args.mat_out:
        print(f"comprehensive_results → {args.mat_out}")
    if args.plot_dir:
        return _draw_figures("train", args.plot_dir,
                             lambda: _emit_train_figures(res, args.plot_dir))
    return 0


def _write_metrics_jsonl(path: str, res) -> None:
    """One row per stage (final loss and at most ~100 points of its loss
    trace), then a final row with the metric and timing tables."""
    import numpy as np

    from pinnfc_tpu_torch.utils.observability import MetricsLogger

    ml = MetricsLogger()
    for i, (name, losses) in enumerate(res.log.stages):
        losses = np.asarray(losses)
        stride = max(1, losses.shape[0] // 100)
        ml.log(step=i, event="stage", stage=name, n_iter=int(losses.shape[0]),
               final_loss=float(losses[-1]), loss_trace=[float(v) for v in losses[::stride]])
    ml.log(step=len(res.log.stages), event="final", **res.metrics, **res.timings)
    ml.to_jsonl(path)
    print(f"metrics JSONL → {path}")


def _write_tensorboard(logdir: str, res) -> None:
    """Scalar event files for the run: every stage's loss at every step on one
    global step axis (``loss/<k:stage>``), then the final metric and timing
    tables (``final/<metric>``, ``time/<timing>``) at the last step."""
    import numpy as np

    from pinnfc_tpu_torch.utils.tbevents import EventFileWriter

    with EventFileWriter(logdir) as w:
        step = 0
        for name, losses in res.log.stages:
            for v in np.asarray(losses):
                w.add_scalar(f"loss/{name}", float(v), step=step)
                step += 1
        finals = {f"final/{k}": float(v) for k, v in res.metrics.items()}
        finals.update({f"time/{k}": float(v) for k, v in res.timings.items()})
        w.add_scalars(finals, step=max(step - 1, 0))
    print(f"tensorboard events → {logdir}")


def _emit_train_figures(res, plot_dir: str) -> None:
    """The script-01 figure set of a trained or scored artifact."""
    from pinnfc_tpu_torch.viz import (
        plot_detailed_results, plot_split_overview, plot_temp_comparison, plot_uncertainty)

    bl = res.dataset.info.boundary_lines
    plot_uncertainty(res.results, bl, os.path.join(plot_dir, "uncertainty.png"))
    plot_detailed_results(res.results, os.path.join(plot_dir, "detailed.png"), bl)
    plot_split_overview(res.results, bl, os.path.join(plot_dir, "split.png"))
    # true vs physics-model temperature, the reference main's inline figure
    # (01:2208-2228)
    plot_temp_comparison(res.results, os.path.join(plot_dir, "temp_comparison.png"), bl)


def cmd_score(args) -> int:
    """Score a campaign with an existing checkpoint, no retraining.  Unless
    ``--ignore-ckpt-config``, the MC settings, the seed and the synthetic
    campaign's sizes default to the ones the checkpoint's sidecar records
    (``pinnfc_tpu/cli/train.py:188-218``), so scoring the training campaign
    reproduces the train-time artifact."""
    from pinnfc_tpu_torch.config import train_config_from_dict
    from pinnfc_tpu_torch.pipeline.score import run_scoring_pipeline
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint_meta

    meta = load_checkpoint_meta(args.ckpt)
    if meta is not None and "config" in meta and not args.ignore_ckpt_config:
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
        print(f"config from checkpoint meta: mc_times={cfg.mc_times} "
              f"dropout={cfg.mc_dropout} seed={cfg.seed} "
              f"(--ignore-ckpt-config for CLI flags only)")
        # the campaign is built from args.seed: keep it the resolved seed
        args.seed = cfg.seed
    else:
        args.seed = 42 if args.seed is None else args.seed
        cfg = _train_config(args)
    if args.mc_times is not None:
        cfg = dataclasses.replace(cfg, mc_times=args.mc_times)
    n_normal, n_fault = _sizes(args)
    try:
        campaign = _campaign_from_args(args)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    try:
        mesh = _data_parallel_mesh(args)
    except (RuntimeError, ValueError) as e:
        print(f"score: {e}", file=sys.stderr)
        return 1
    if mesh is not None:
        print(f"MC export sharded over {mesh.size} devices")
    _print_ckpt_provenance(args.ckpt)
    try:
        res = run_scoring_pipeline(
            args.ckpt, config=cfg, campaign=campaign, mat_path=args.mat_out,
            n_normal=n_normal, n_fault=n_fault, verbose=True, device=args.device, mesh=mesh,
        )
    except (RuntimeError, ValueError) as e:
        print(f"score: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"metrics": res.metrics, "timings": res.timings, "export": res.export},
                     indent=1))
    print("artifact →", args.mat_out)
    if args.plot_dir:
        return _draw_figures("score", args.plot_dir,
                             lambda: _emit_train_figures(res, args.plot_dir))
    return 0


def cmd_synth(args) -> int:
    """Write a synthetic measurement campaign to disk in the reference's
    13-file .mat layout: ``Polar-1.mat`` with the normal channel variables
    (01:126-140) and the 12 fault ``segment_double`` files (01:168-176) in the
    load order 水淹/氧饥饿/膜干/氢饥饿 × 108/270/405 A (01:2097-2110).  A
    stand-in for the measurement data, which is not redistributed, to drive
    ``train --normal-mat/--fault-dir``."""
    from pinnfc_tpu_torch.data.campaign import write_campaign_mats
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data

    normal, faults = synthesize_stack_data(n_normal=args.n_normal, n_fault=args.n_fault,
                                           seed=args.seed)
    cfg = write_campaign_mats(args.out_dir, normal, faults, ascii_names=not args.zh_names)
    print(f"campaign → {args.out_dir} ({os.path.basename(cfg.normal_path)} with "
          f"{len(normal[0])} rows + {len(faults)} fault segments × {args.n_fault} rows)")
    print("train on it: python -m pinnfc_tpu_torch.cli train "
          f"--normal-mat {cfg.normal_path} --fault-dir {args.out_dir}")
    return 0


def cmd_ensemble(args) -> int:
    """Many-seed PINN ensemble on the synthetic campaign (all normal rows for
    training, every row for the test): E members through one DNN stage each
    (one training-kernel launch per flagship member on the card), over a mesh
    when more than one device is visible and divides the members, or over
    ``--mesh-shape MxD`` (members over M devices, each member's rows over
    D).  Prints the JAX command's tables; ``--uq`` adds the deep-ensemble
    moments against member 0's MC dropout (``mc_dropout_samples``)."""
    import numpy as np
    import torch

    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.device import resolve_device
    from pinnfc_tpu_torch.parallel.ensemble import (
        ensemble_predict, init_ensemble, train_dnn_ensemble, train_dnn_ensemble_2d)
    from pinnfc_tpu_torch.parallel.mesh import make_mesh, visible_devices

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ensemble: {e}", file=sys.stderr)
        return 1
    normal, faults = synthesize_stack_data(
        n_normal=1500 if args.small else 6000, n_fault=200 if args.small else 800,
        seed=args.seed)
    ds = combine_and_normalize(normal, faults, training_rate=1.0, seed=args.seed, device=dev)

    ens = init_ensemble(args.seed, args.members, device=dev)
    visible = visible_devices(args.device)
    n_dev = len(visible)
    # the dropout seed is seed + 1, as the JAX command keys its dropout
    if args.mesh_shape:
        m, d = (int(v) for v in args.mesh_shape.lower().split("x"))
        mesh = make_mesh(m * d, axis_names=("model", "data"), shape=(m, d), devices=visible)
        print(f"2-D mesh: {args.members} members over {m} × rows over {d}")
        ens, losses = train_dnn_ensemble_2d(ens, ds.x_train, ds.y_train, args.seed + 1,
                                            args.steps, mesh)
    else:
        mesh = None
        if n_dev > 1 and args.members % n_dev == 0:
            mesh = make_mesh(n_dev, devices=visible)
            print(f"sharding {args.members} members over {n_dev} devices")
        ens, losses = train_dnn_ensemble(ens, ds.x_train, ds.y_train, args.seed + 1,
                                         args.steps, mesh=mesh)
    preds = ensemble_predict(ens, ds.x_test).cpu().numpy()  # (E, N, 1)
    losses = losses.cpu().numpy()
    y = ds.scaler_y.inverse(ds.y_test)[:, 0].cpu().numpy()
    scale_y = ds.scaler_y.scale.cpu().numpy()
    min_y = ds.scaler_y.min.cpu().numpy()
    preds_real = (preds[:, :, 0] - min_y) / scale_y
    mae = np.abs(preds_real - y[None, :]).mean(axis=1)
    print(f"{'member':>7} {'final loss':>12} {'test MAE [V]':>13}")
    for e in range(args.members):
        print(f"{e:7d} {float(losses[e, -1]):12.4e} {mae[e]:13.4f}")
    spread = preds_real.std(axis=0).mean()
    print(f"ensemble spread (mean member std): {spread:.4f} V")

    if args.uq:
        from pinnfc_tpu_torch.uq.deep_ensemble import ensemble_moments
        from pinnfc_tpu_torch.uq.mc_dropout import mc_dropout_samples

        de = ensemble_moments(ens, ds.x_test)
        gen = torch.Generator(dev).manual_seed(args.seed + 2)
        mc, _ = mc_dropout_samples(ens["mlp"][0], ds.x_test, gen, mc_times=args.uq_mc_times)
        # de-normalize the stds through the exporter's affine constants
        # (pipeline/export.py, reference 01:1924-1932)
        sc = float(scale_y.reshape(-1)[0]) + 1e-12
        print(f"\ndeep-ensemble UQ (E={args.members}) vs MC dropout "
              f"(member 0, {args.uq_mc_times} samples):")
        print(f"{'estimator':>14} {'mean ale [V]':>13} {'mean epi [V]':>13} "
              f"{'max epi [V]':>12}")
        for name, s in (("ensemble", de), ("mc-dropout", mc)):
            ale, epi = s.aleatoric_std.cpu().numpy(), s.epistemic_std.cpu().numpy()
            print(f"{name:>14} {np.mean(ale) / sc:13.4f} {np.mean(epi) / sc:13.4f} "
                  f"{np.max(epi) / sc:12.4f}")
        a, b = de.epistemic_std.cpu().numpy(), mc.epistemic_std.cpu().numpy()
        if np.std(a) > 0 and np.std(b) > 0:
            corr = float(np.corrcoef(a, b)[0, 1])
            print(f"epistemic profile correlation (ensemble vs MC): {corr:.3f}")
    return 0
