"""``risk`` subcommand (counterpart of ``pinnfc_tpu/cli/diagnose.py::cmd_risk``):
the RF(t) early-warning table of script 04 over a ``comprehensive_results``
artifact."""

from __future__ import annotations

import sys


def cmd_risk(args) -> int:
    """Print, per evaluation condition present in the artifact: current,
    fault, the voltage alarm and RF alarm indices, the advance, and the
    physics layer that contributed most to the risk at the alarm instant with
    its share — the JAX command's table, character for character."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.risk import run_risk_pipeline

    try:
        results = load_comprehensive_results(args.mat)
        advances = run_risk_pipeline(results, backend=args.backend, device=args.device)
    except (RuntimeError, ValueError, KeyError, OSError) as e:
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
    return 0
