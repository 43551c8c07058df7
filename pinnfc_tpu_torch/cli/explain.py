"""``identify``, ``explain``, ``whatif`` and ``inspect`` subcommands
(counterpart of ``pinnfc_tpu/cli/explain.py``): λ identifiability, input
saliency and counterfactual recovery of a checkpoint over an artifact's rows,
on ``--device``, and a description of a checkpoint that does no device work.
The JAX commands' tables and ``--json`` documents; ``--data-parallel`` splits
the rows of identify, explain and whatif over every visible device of
``--device``."""

from __future__ import annotations

import json
import os
import sys

from pinnfc_tpu_torch.cli._common import (
    _USER_ERRORS, _data_parallel_mesh, _draw_figures, _finite_or_none, _print_lambda_table)


def _load_with_scalers(args, command: str):
    """(checkpoint on ``args.device``, artifact) for ``identify``/``explain``/``whatif``,
    or the exit code when the run cannot go on: 1 for an error the user can
    act on (no card, an unreadable file), 2 for a checkpoint without scalers,
    as in JAX."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint

    try:
        ckpt = load_checkpoint(args.ckpt, device=args.device)
        if "scaler_x" not in ckpt or "scaler_y" not in ckpt:
            print(f"{args.ckpt} has no stored scalers — cannot normalize the "
                  "artifact rows", file=sys.stderr)
            return 2
        return ckpt, load_comprehensive_results(args.mat)
    except _USER_ERRORS as e:
        print(f"{command}: {e}", file=sys.stderr)
        return 1


def cmd_identify(args) -> int:
    """Identifiability of the 17 physics λ's (``uq/identifiability``):
    Gauss-Newton 95 % CIs from each training stage's own residual Jacobian at
    the trained optimum, the sensitivity, at-bound and unidentifiable flags;
    the reference's dead parameters come out as zero-sensitivity columns."""
    import numpy as np

    from pinnfc_tpu_torch.data.contract import INDEX
    from pinnfc_tpu_torch.uq import lambda_identifiability

    loaded = _load_with_scalers(args, "identify")
    if isinstance(loaded, int):
        return loaded
    ckpt, results = loaded
    x_raw = results.array[:, [INDEX[f"x{i}"] for i in range(8)]]
    x_norm = np.asarray(ckpt["scaler_x"].transform(x_raw.astype(np.float32)), np.float32)
    try:
        mesh = _data_parallel_mesh(args)
        if mesh is not None:
            print(f"residual Jacobians data-parallel over {mesh.size} devices")
        report = lambda_identifiability(ckpt["params"], x_norm, ckpt["scaler_x"],
                                        ckpt["scaler_y"], mesh=mesh)
        if args.plot_dir:
            from pinnfc_tpu_torch.viz import plot_identifiability

            os.makedirs(args.plot_dir, exist_ok=True)
            plot_identifiability(report, os.path.join(args.plot_dir, "identifiability.png"))
            print(f"figure → {args.plot_dir}/identifiability.png")
    except _USER_ERRORS as e:
        print(f"identify: {e}", file=sys.stderr)
        return 1

    if args.json:
        out = {
            g: {
                "names": list(gi.names),
                "values": gi.values.tolist(),
                "stderr": _finite_or_none(gi.stderr.tolist()),
                "ci95": [_finite_or_none(gi.ci_lo.tolist()), _finite_or_none(gi.ci_hi.tolist())],
                "sensitivity": gi.sensitivity.tolist(),
                "identifiable": gi.identifiable.tolist(),
                "at_bound": gi.at_bound.tolist(),
                "corr": [_finite_or_none(row) for row in gi.corr.tolist()],
                "n_residuals": gi.n_residuals,
                "n_dropped": gi.n_dropped,
                "dof": gi.dof,
                "sigma2": gi.sigma2,
            }
            for g, gi in report.items()
        }
        print(json.dumps(out, indent=2, ensure_ascii=False, allow_nan=False))
        return 0

    print(f"identifiability over {results.array.shape[0]} artifact rows "
          "(Gauss-Newton 95% CIs at the trained optimum):")
    for g, gi in report.items():
        dropped = f", {gi.n_dropped} non-finite rows dropped" if gi.n_dropped else ""
        print(f"{g}  (N={gi.n_residuals}, σ̂²={gi.sigma2:.4g}{dropped})")
        for i, name in enumerate(gi.names):
            if not gi.identifiable[i]:
                tail = "UNIDENTIFIABLE (zero sensitivity — loss never sees it)"
            else:
                tail = f"± {1.959964 * gi.stderr[i]:<12.4g} sens {gi.sensitivity[i]:.3g}"
                if gi.at_bound[i]:
                    tail += "  AT-BOUND (clamp active; CI not meaningful)"
            print(f"  {g}[{i}] = {gi.values[i]:<12.6g} {tail}")
            print(f"           {name}")
        # sloppy directions: pairs the loss constrains only jointly
        k = len(gi.names)
        for i in range(k):
            for j in range(i + 1, k):
                c = gi.corr[i, j]
                if np.isfinite(c) and abs(c) > 0.95:
                    print(f"  coupled: {g}[{i}] ↔ {g}[{j}] "
                          f"(corr {c:+.3f} — only jointly identified)")
    return 0


def cmd_explain(args) -> int:
    """Input-channel saliency of the trained model (``uq/saliency``): per
    fault class, which of the 8 measured inputs the voltage prediction and
    its aleatoric σ lean on, in volts per full training-range swing."""
    import numpy as np

    from pinnfc_tpu_torch.data.contract import INDEX, INPUT_CHANNELS
    from pinnfc_tpu_torch.uq import coarse_class_saliency, input_saliency

    loaded = _load_with_scalers(args, "explain")
    if isinstance(loaded, int):
        return loaded
    ckpt, results = loaded
    x_raw = results.array[:, [INDEX[f"x{i}"] for i in range(8)]]
    try:
        mesh = _data_parallel_mesh(args)
        if mesh is not None:
            print(f"saliency data-parallel over {mesh.size} devices")
        report = input_saliency(ckpt["params"], x_raw, ckpt["scaler_x"], ckpt["scaler_y"],
                                labels=results.labels, device=args.device, mesh=mesh)
        table = coarse_class_saliency(report, "jac_range")
        sigma_table = coarse_class_saliency(report, "sigma_jac_range")
        if args.plot_dir:
            from pinnfc_tpu_torch.viz import plot_saliency

            os.makedirs(args.plot_dir, exist_ok=True)
            plot_saliency(table, INPUT_CHANNELS,
                          os.path.join(args.plot_dir, "saliency_voltage.png"))
            plot_saliency(sigma_table, INPUT_CHANNELS,
                          os.path.join(args.plot_dir, "saliency_sigma.png"),
                          unit="σ_a volts / full-range swing")
            print(f"figures → {args.plot_dir}/saliency_voltage.png, "
                  f"{args.plot_dir}/saliency_sigma.png")
    except _USER_ERRORS as e:
        print(f"explain: {e}", file=sys.stderr)
        return 1

    if args.json:
        out = {
            "unit": "V per full training-range swing",
            "channels": list(INPUT_CHANNELS),
            "n_rows": int(results.array.shape[0]),
            "classes": {
                name: {
                    "voltage": table[name].tolist(),
                    "sigma": sigma_table[name].tolist(),
                    "driver": INPUT_CHANNELS[int(np.argmax(table[name]))],
                }
                for name in table
            },
        }
        print(json.dumps(out, indent=2, ensure_ascii=False, allow_nan=False))
        return 0

    print(f"input-channel saliency over {results.array.shape[0]} artifact "
          "rows (mean |∂v̂/∂x| in volts per full training-range swing):")
    width = max(len(c) for c in INPUT_CHANNELS)
    header = "  ".join(f"{c:>{width}}" for c in INPUT_CHANNELS)
    print(f"{'class':<20} {header}  driver")
    for name, row in table.items():
        cells = "  ".join(f"{v:>{width}.3g}" for v in row)
        print(f"{name:<20} {cells}  {INPUT_CHANNELS[int(np.argmax(row))]}")
    print("aleatoric-σ saliency (same units):")
    for name, row in sigma_table.items():
        cells = "  ".join(f"{v:>{width}.3g}" for v in row)
        print(f"{name:<20} {cells}  {INPUT_CHANNELS[int(np.argmax(row))]}")
    return 0


def cmd_whatif(args) -> int:
    """Counterfactual recovery (``uq/counterfactual``): for every alarmed risk
    condition of the ``cli risk`` table (04:145-161, dynamic threshold
    04:389), the minimal actuation — within the training range, frozen
    channels excluded — whose model-predicted voltage gain covers the
    measured shortfall below the alarm line (``--absolute-target``: the
    model's own prediction must clear it)."""
    import numpy as np

    from pinnfc_tpu_torch.data.contract import INPUT_CHANNELS
    from pinnfc_tpu_torch.uq import CounterfactualConfig, condition_recovery, summarize_recovery

    loaded = _load_with_scalers(args, "whatif")
    if isinstance(loaded, int):
        return loaded
    ckpt, results = loaded
    cfg = CounterfactualConfig(steps=args.steps, lr=args.lr, alpha=args.alpha,
                               margin=args.margin)
    actuate = args.actuate.split(",") if args.actuate else None
    target = "absolute" if args.absolute_target else "gain"
    try:
        mesh = _data_parallel_mesh(args)
        if mesh is not None:
            print(f"recovery solve data-parallel over {mesh.size} devices")
        recs = condition_recovery(results, ckpt["params"], ckpt["scaler_x"], ckpt["scaler_y"],
                                  config=cfg, actuatable=actuate, max_rows=args.max_rows,
                                  target=target, device=args.device, mesh=mesh)
    except _USER_ERRORS as e:
        print(f"whatif: {e}", file=sys.stderr)
        return 1

    summaries = {f"{r.current_target:.0f}A {r.fault_name}": summarize_recovery(r.report)
                 for r in recs if r.report is not None}

    def _mean_short(r):
        """Mean measured shortfall below the alarm line over solved rows."""
        if r.report is None or r.report.v_meas is None:
            return None
        return float(np.maximum(0.0, r.report.v_target - r.report.v_meas).mean())

    if args.json:
        out = {
            "unit": "delta as fraction of the channel's training range",
            "target_mode": target,
            "channels": list(INPUT_CHANNELS),
            "conditions": [
                {
                    "fault": r.fault_name,
                    "current": r.current_target,
                    "v_threshold": r.v_threshold,
                    "alarmed": r.idx_v_alarm is not None,
                    "n_rows": r.n_rows,
                    **({"mean_short_v": s} if (s := _mean_short(r)) is not None else {}),
                    **({
                        "recovered_frac": summaries[key]["recovered_frac"],
                        "dominant": summaries[key]["dominant"],
                        "mean_delta_range": summaries[key]["mean_delta_range"].tolist(),
                    } if (key := f"{r.current_target:.0f}A {r.fault_name}") in summaries
                        else {}),
                }
                for r in recs
            ],
        }
        print(json.dumps(out, indent=2, ensure_ascii=False, allow_nan=False))
        return 0

    mode_note = ("gain target: Δv̂ must cover the measured shortfall" if target == "gain"
                 else "absolute target: v̂ itself must clear the line")
    print("counterfactual recovery per risk condition (mean signed Δ, "
          f"fraction of training range; alarmed rows only; {mode_note}):")
    print(f"{'current':>8} {'fault':>20} {'rows':>5} {'short(V)':>8} "
          f"{'recovered':>9}  knob (Δ physical)")
    for r in recs:
        if r.report is None:
            print(f"{r.current_target:8.0f} {r.fault_name:>20} {0:>5} "
                  f"{'-':>8} {'-':>9}  never alarmed")
            continue
        s = summaries[f"{r.current_target:.0f}A {r.fault_name}"]
        short = _mean_short(r)
        short_s = f"{short:8.3f}" if short is not None else f"{'-':>8}"
        knob = s["dominant"]
        if knob is None:
            detail = "no actuation needed"
        else:
            detail = f"{knob} ({float(s['mean_delta_phys'][s['dominant_index']]):+.3g})"
        print(f"{r.current_target:8.0f} {r.fault_name:>20} {r.n_rows:>5} "
              f"{short_s} {s['recovered_frac']:>9.0%}  {detail}")

    if args.plot_dir and summaries:
        from pinnfc_tpu_torch.viz import plot_whatif

        path = os.path.join(args.plot_dir, "whatif_actuation.png")
        table = {k: v["mean_delta_range"] for k, v in summaries.items()}
        return _draw_figures("whatif", args.plot_dir,
                             lambda: plot_whatif(table, INPUT_CHANNELS, path),
                             done=f"figures → {args.plot_dir}/whatif_actuation.png")
    return 0


def cmd_inspect(args) -> int:
    """Describe a checkpoint without running anything: provenance metadata
    from the ``.meta.json`` sidecar, the parameter tree with shapes and
    counts, the λ's and the stored normalization ranges.  Reads the arrays
    as numpy and never touches a device."""
    import numpy as np

    from pinnfc_tpu_torch.models.pinn import LAMBDA_NAMES
    from pinnfc_tpu_torch.utils.checkpoint import _flatten, load_checkpoint_raw

    try:
        ckpt = load_checkpoint_raw(args.ckpt)
    except _USER_ERRORS as e:
        print(f"inspect: {e}", file=sys.stderr)
        return 1
    meta = ckpt.get("meta")
    flat = _flatten(ckpt["params"])
    total = int(sum(a.size for a in flat.values()))

    if args.json:
        out = {
            "meta": meta,
            "params": {p: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for p, a in flat.items()},
            "total_parameters": total,
            "lambdas": {
                g: {"values": np.asarray(ckpt["params"][g]).ravel().tolist(),
                    "names": list(names)}
                for g, names in LAMBDA_NAMES.items()
                if g in ckpt["params"]
            },
            "scalers": {
                name: {
                    "data_min": np.asarray(s["data_min"]).ravel().tolist(),
                    "data_max": np.asarray(s["data_max"]).ravel().tolist(),
                }
                for name in ("scaler_x", "scaler_y")
                if (s := ckpt.get(name)) is not None
            },
            "step": int(np.asarray(ckpt["step"])) if "step" in ckpt else None,
        }
        print(json.dumps(out, indent=2, ensure_ascii=False))
        return 0

    if meta is not None:
        print(json.dumps({"meta": meta}, indent=2, ensure_ascii=False))
    else:
        print("meta: none (checkpoint saved without a .meta.json sidecar)")
    # _flatten is the checkpoint's own flattener: the printed paths are the
    # archive's keys
    print("params:")
    for path, arr in flat.items():
        print(f"  {path:40s} {str(arr.shape):14s} {arr.dtype}")
    print(f"  total: {total:,} parameters")

    _print_lambda_table(ckpt["params"])

    for name in ("scaler_x", "scaler_y"):
        s = ckpt.get(name)
        if s is None:
            print(f"{name}: absent")
            continue
        lo = np.asarray(s["data_min"]).ravel()
        hi = np.asarray(s["data_max"]).ravel()
        rng = ", ".join(f"[{a:.4g}, {b:.4g}]" for a, b in zip(lo, hi))
        print(f"{name}: {lo.size} features, training ranges {rng}")
    if "step" in ckpt:
        print(f"step: {int(np.asarray(ckpt['step']))}")
    return 0
