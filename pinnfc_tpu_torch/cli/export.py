"""``export-model`` subcommand (counterpart of ``pinnfc_tpu/cli/export.py``):
a checkpoint's scorer, monitor step or fleet step as a ``torch.export``
artifact (``serving/exported.py``) with its ``.meta.json`` provenance
sidecar.  The whole command runs on the CPU, so it needs no card; the
artifact is moved to its device when it is loaded.  The JAX command's lines
and argument errors (exit 2); ``--platforms`` names ``cpu`` and ``cuda``
(default both), and another target exits 2."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

from pinnfc_tpu_torch.cli._common import _USER_ERRORS, _glitch_default, _streaming_conformal_calib


def cmd_export_model(args) -> int:
    """Serialize the checkpoint's eval-mode scorer, or with
    ``--monitor-step`` the streaming monitor's block step (``--fleet-step``:
    its fleet program), into a self-contained artifact: the weights and both
    MinMax scalers baked in, a symbolic batch dimension."""
    from pinnfc_tpu_torch.serving.exported import check_platforms

    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    if not platforms:
        print("--platforms must name at least one target", file=sys.stderr)
        return 2
    try:
        check_platforms(platforms)
    except ValueError as e:
        print(f"--platforms: {e}", file=sys.stderr)
        return 2
    if args.head and not args.monitor_step:
        # the plain scorer has no diagnosis output; silently dropping the
        # head would only be discovered at serve time
        print("--head requires --monitor-step (the scorer artifact has no "
              "fault-typing output)", file=sys.stderr)
        return 2
    if args.conformal_mat and not args.monitor_step:
        print("--conformal-mat requires --monitor-step (the scorer artifact "
              "has no p-value output)", file=sys.stderr)
        return 2
    if args.conformal_gamma and not args.conformal_mat:
        print("--conformal-gamma requires --conformal-mat (there is no "
              "p-value to adapt the level against)", file=sys.stderr)
        return 2
    if args.fleet_step and not args.monitor_step:
        print("--fleet-step requires --monitor-step (the scorer artifact "
              "has no stream state to vmap over)", file=sys.stderr)
        return 2
    try:
        return _export_model(args, platforms)
    except _USER_ERRORS as e:
        print(f"export-model: {e}", file=sys.stderr)
        return 1


def _export_model(args, platforms) -> int:
    import numpy as np

    import pinnfc_tpu_torch
    from pinnfc_tpu_torch.serving import exported
    from pinnfc_tpu_torch.serving.monitor import MonitorState
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_meta

    ckpt = load_checkpoint(args.ckpt, device="cpu")
    if "scaler_x" not in ckpt or "scaler_y" not in ckpt:
        print(f"{args.ckpt} has no stored scalers — cannot build the "
              "raw-units scorer", file=sys.stderr)
        return 2
    if args.monitor_step:
        # the full streaming RF(t) block step; μ/σ are runtime inputs of the
        # exported signature, so placeholder statistics suffice here
        from pinnfc_tpu_torch.data.contract import load_comprehensive_results
        from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor

        head = DiagnosisHead.load(args.head, device="cpu") if args.head else None
        conformal_alpha = 0.1 if args.conformal_alpha is None else args.conformal_alpha
        conformal_calib = None
        if args.conformal_mat:
            # the sorted normal-row |res| scores become step constants
            conformal_calib = _streaming_conformal_calib(
                load_comprehensive_results(args.conformal_mat).array, conformal_alpha)
        monitor = OnlineMonitor(
            ckpt["params"], ckpt["scaler_x"], ckpt["scaler_y"],
            mu=np.zeros(5, np.float32), sigma=np.ones(5, np.float32), diagnosis=head,
            glitch_alarm_n=(args.glitch_alarm_n if args.glitch_alarm_n is not None
                            else _glitch_default()),
            conformal_calib=conformal_calib, conformal_alpha=conformal_alpha,
            conformal_gamma=args.conformal_gamma or 0.0, device="cpu",
        )
        fields = "/".join(MonitorState._fields)
        if args.fleet_step:
            # observe_many's program, symbolic on both axes
            blob = exported.export_monitor_fleet_step(monitor, platforms)
            signature = (f"(state bank tuple {fields} each leading s, f32[s,b,8] raw sensors, "
                         "f32[s,b] v_meas, f32[5] mu, f32[5] sigma) -> (state bank, outputs)")
        else:
            blob = exported.export_monitor_step(monitor, platforms)
            signature = (f"(state tuple {fields}, f32[b,8] raw sensors, f32[b] v_meas, "
                         "f32[5] mu, f32[5] sigma) -> (state, outputs)")
    else:
        blob = exported.export_scorer(ckpt["params"], ckpt["scaler_x"], ckpt["scaler_y"],
                                      platforms)
        signature = "f32[b,8] raw sensors -> (f32[b] v_pred, f32[b] log_var)"
    with open(args.out, "wb") as f:
        f.write(blob)
    # provenance sidecar, the checkpoints' convention (.meta.json)
    sidecar = {
        "kind": "pinnfc_torch_monitor_step" if args.monitor_step else "pinnfc_torch_scorer",
        "platforms": list(platforms),
        "framework_version": pinnfc_tpu_torch.__version__,
        "signature": signature,
        "checkpoint": os.path.abspath(args.ckpt),
        "checkpoint_meta": load_checkpoint_meta(args.ckpt),
    }
    if args.monitor_step:
        # the values baked into the step, so a deployment can tell which
        # sensor-alarm and risk behaviour the artifact carries
        sidecar["glitch_alarm_n"] = monitor.glitch_alarm_n
        sidecar["fleet_step"] = bool(args.fleet_step)
        sidecar["block_max"] = exported.BLOCK_MAX
        sidecar["risk_config"] = dataclasses.asdict(monitor.config)
        sidecar["diagnosis_head"] = os.path.abspath(args.head) if args.head else None
        sidecar["class_names"] = list(head.class_names) if head is not None else None
        if monitor.conformal_calib is not None:
            # α* and γ drive the adaptive level, which runs on the host after
            # each step's read: the serving side takes them from here
            sidecar["conformal_alpha"] = monitor.conformal_alpha
            sidecar["conformal_gamma"] = monitor.conformal_gamma
            sidecar["conformal_n_calib"] = int(monitor.conformal_calib.size)
            sidecar["conformal_source"] = os.path.abspath(args.conformal_mat)
    with open(args.out + ".meta.json", "w") as f:
        json.dump(sidecar, f, indent=2)
    what = "monitor step" if args.monitor_step else "scorer"
    print(f"{what} ({','.join(platforms)}; any batch size) → {args.out} "
          f"({len(blob):,} bytes)")
    return 0
