"""``risk`` subcommand (counterpart of ``pinnfc_tpu/cli/diagnose.py::cmd_risk``):
the RF(t) early-warning table of script 04 over a ``comprehensive_results``
artifact, and with ``--plot-dir`` each condition's RF(t) and attribution
figures."""

from __future__ import annotations

import os
import sys

from pinnfc_tpu_torch.cli._common import _USER_ERRORS, _draw_figures


def cmd_risk(args) -> int:
    """Print, per evaluation condition present in the artifact: current,
    fault, the voltage alarm and RF alarm indices, the advance, and the
    physics layer that contributed most to the risk at the alarm instant with
    its share — the JAX command's table, character for character.
    ``--backend jax``, the JAX command's name for its device backend, runs the
    torch backend."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.risk import run_risk_pipeline

    backend = "torch" if args.backend == "jax" else args.backend
    try:
        results = load_comprehensive_results(args.mat)
        advances = run_risk_pipeline(results, backend=backend, device=args.device)
    except _USER_ERRORS as e:
        print(f"risk: {e}", file=sys.stderr)
        return 1
    print(f"{'current':>8} {'fault':>8} {'V alarm':>8} {'RF alarm':>9} "
          f"{'advance':>8}  driver")
    for a in advances:
        driver = (
            f"{a.dominant_layer} {a.layer_shares[a.dominant_layer]:.0%}"
            if a.layer_shares else "-"
        )
        print(
            f"{a.current_target:8.0f} {a.fault_name:>8} "
            f"{str(a.idx_v_alarm):>8} {str(a.idx_rf_alarm):>9} "
            f"{str(a.advance):>8}  {driver}"
        )
    if args.plot_dir:
        return _draw_figures("risk", args.plot_dir, lambda: _risk_figures(advances, args.plot_dir))
    return 0


def _risk_figures(advances, plot_dir: str) -> None:
    from pinnfc_tpu_torch.config import RiskConfig
    from pinnfc_tpu_torch.viz import plot_rf_attribution, plot_rf_condition

    cfg = RiskConfig()
    for a in advances:
        stem = f"{a.current_target:.0f}A_{a.fault_name}.png"
        plot_rf_condition(a, cfg.warn_threshold, cfg.danger_threshold,
                          os.path.join(plot_dir, f"rf_{stem}"))
        plot_rf_attribution(a, os.path.join(plot_dir, f"rf_attr_{stem}"))
