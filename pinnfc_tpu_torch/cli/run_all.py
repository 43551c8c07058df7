"""``run-all`` (counterpart of ``pinnfc_tpu/cli/run_all.py``): the whole
01 → 02/03/04/05 pipeline, then the serving demo, the explainability trio,
the conformal audit and the consolidated report, on ``--device``.

Each stage is the port's own command, called with the arguments the JAX
``cmd_run_all`` passes (built through the port's parser, so every other flag
takes its default)."""

from __future__ import annotations

import os


def _stage_args(*argv: str, plot_dir=None, device="cuda"):
    """The Namespace of ``python -m pinnfc_tpu_torch.cli <argv>`` with
    ``--plot-dir`` and ``--device`` where given."""
    from pinnfc_tpu_torch.cli import build_parser

    extra = ["--plot-dir", plot_dir] if plot_dir else []
    extra += ["--device", device] if device else []
    return build_parser().parse_args([*argv, *extra])


def run_all(args, plot_dir) -> int:
    """The chain of ``cmd_run_all`` with its figures in ``plot_dir`` (None:
    no figures); the first stage that fails ends it with its exit code."""
    from pinnfc_tpu_torch.cli.diagnose import (
        cmd_auc, cmd_compare, cmd_conformal, cmd_gmm, cmd_report)
    from pinnfc_tpu_torch.cli.explain import cmd_explain, cmd_identify, cmd_whatif
    from pinnfc_tpu_torch.cli.risk import cmd_risk
    from pinnfc_tpu_torch.cli.serve import cmd_monitor
    from pinnfc_tpu_torch.cli.train import cmd_score, cmd_train

    dev = args.device
    os.makedirs(args.out_dir, exist_ok=True)
    mat_path = os.path.join(args.out_dir, "F01_output.mat")
    campaign = []
    if args.normal_mat:
        campaign += ["--normal-mat", args.normal_mat]
    if args.fault_dir:
        campaign += ["--fault-dir", args.fault_dir]
    small = ["--small"] if args.small else []
    if args.from_ckpt:
        # reuse a trained model: the score stage replaces the train stage;
        # without --seed the checkpoint's training seed wins, so run-all on
        # the training campaign reproduces the train-time artifact
        ckpt = args.from_ckpt
        seed = [] if args.seed is None else ["--seed", str(args.seed)]
        rc = cmd_score(_stage_args("score", "--mat-out", mat_path, "--ckpt", ckpt, *small,
                                   *seed, *campaign, plot_dir=plot_dir, device=dev))
    else:
        ckpt = os.path.join(args.out_dir, "pinn_ckpt")
        scale = [] if args.steps_scale is None else ["--steps-scale", str(args.steps_scale)]
        rc = cmd_train(_stage_args(
            "train", "--mat-out", mat_path, "--ckpt", ckpt,
            "--seed", str(args.seed if args.seed is not None else 42), *small, *scale,
            *campaign, plot_dir=plot_dir, device=dev))
    if rc:
        return rc
    gmm_result = None
    for name, fn in (("auc", cmd_auc), ("gmm", cmd_gmm), ("risk", cmd_risk),
                     ("compare", cmd_compare)):
        # --tsne: the reference always draws the script-03 t-SNE (03:587)
        stage_ns = _stage_args(name, "--mat", mat_path, *(["--tsne"] if name == "gmm" else []),
                               plot_dir=plot_dir, device=dev)
        rc = fn(stage_ns)
        if rc:
            return rc
        if name == "gmm":
            gmm_result = stage_ns.gmm_result
    # serving demo: fault segment 1 through the OnlineMonitor from the
    # checkpoint, with the gmm stage's fit as the online-diagnosis head and
    # the calibrated anomaly p-values
    monitor_ns = _stage_args("monitor", "--mat", mat_path, "--ckpt", ckpt, "--block", "256",
                             "--fault-label", "1", "--lead", "200", "--diagnose",
                             "--conformal", "--conformal-alpha", "0.1", device=dev)
    monitor_ns.gmm_result = gmm_result
    rc = cmd_monitor(monitor_ns)
    if rc:
        return rc
    # how well the 17 physics parameters are pinned down, the per-class
    # input-channel saliency, and per alarmed risk condition the minimal
    # actuation that clears the alarm line
    for argv, fn in ((("identify", "--ckpt", ckpt, "--mat", mat_path), cmd_identify),
                     (("explain", "--ckpt", ckpt, "--mat", mat_path), cmd_explain),
                     (("whatif", "--ckpt", ckpt, "--mat", mat_path, "--steps", "400"),
                      cmd_whatif)):
        rc = fn(_stage_args(*argv, plot_dir=plot_dir, device=dev))
        if rc:
            return rc
    # split-conformal coverage of the voltage interval (uq/conformal; host)
    conformal_ns = _stage_args("conformal", "--mat", mat_path, "--alpha", "0.1",
                               plot_dir=plot_dir, device=None)
    rc = cmd_conformal(conformal_ns)
    if rc:
        return rc
    # the one-file deliverable over everything the stages just printed
    report_ns = _stage_args("report", "--mat", mat_path, "--ckpt", ckpt,
                            "--out", os.path.join(args.out_dir, "report.md"),
                            "--json-out", os.path.join(args.out_dir, "metrics.json"),
                            plot_dir=plot_dir, device=dev)
    rc = cmd_report(report_ns)
    if rc:
        return rc
    print(f"run-all complete → {args.out_dir}")
    return 0


def cmd_run_all(args) -> int:
    """The whole pipeline into ``--out-dir``: F01_output.mat, the checkpoint
    (or ``--from-ckpt``'s), report.md, metrics.json and the figures in
    ``<out-dir>/figures``."""
    return run_all(args, os.path.join(args.out_dir, "figures"))
