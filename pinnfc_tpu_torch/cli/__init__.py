"""Command line of the port: ``python -m pinnfc_tpu_torch.cli {train,score} ...``.

Both run on the card by default (``--device cuda``) and exit with an error
when CUDA is absent; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from pinnfc_tpu_torch.cli.train import cmd_score, cmd_train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m pinnfc_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="staged PINN training + MC export (stage 01)")
    t.add_argument("--mat-out", default="F01_output.mat")
    t.add_argument("--ckpt", default=None,
                   help="write the trained checkpoint (<ckpt>.npz and <ckpt>.meta.json; "
                        "replaces an Orbax directory <ckpt>/)")
    t.add_argument("--small", action="store_true", help="reduced schedule/data")
    t.add_argument("--steps-scale", type=float, default=None,
                   help="multiply every stage's step count (quick experiments)")
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--n-normal", type=int, default=None,
                   help="synthetic normal rows (default 6000; 1500 with --small)")
    t.add_argument("--n-fault", type=int, default=None,
                   help="rows per fault segment (default 800; 200 with --small)")
    t.add_argument("--skip-nonfinite", action="store_true",
                   help="skip (don't apply) training steps with a non-finite loss or "
                        "gradient instead of letting NaN poison the run")
    t.add_argument("--precision", choices=("highest", "default"), default=None,
                   help="'highest' = full float32 (the default and the only one the "
                        "CUDA training kernel has); 'default' runs only with --device cpu")
    t.add_argument("--resume-dir", default=None,
                   help="schedule snapshot dir: a killed run restarted with the same flags "
                        "resumes at the first unfinished stage")
    t.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    t.set_defaults(fn=cmd_train)

    sc = sub.add_parser(
        "score",
        help="score a campaign with an existing checkpoint: normalize through "
             "the checkpoint's scalers, MC-dropout export, no retraining",
    )
    sc.add_argument("--ckpt", required=True,
                    help="checkpoint path (reads the JAX package's Orbax directory <ckpt>/ "
                         "where it exists, else <ckpt>.npz, and <ckpt>.meta.json)")
    sc.add_argument("--mat-out", default="F01_scored.mat")
    sc.add_argument("--small", action="store_true",
                    help="reduced MC sample count / synthetic data size")
    sc.add_argument("--mc-times", type=int, default=None,
                    help="MC-dropout passes (default: the checkpoint's config, 2000)")
    sc.add_argument("--seed", type=int, default=None,
                    help="data and MC seed (default: the checkpoint's training seed, 42)")
    sc.add_argument("--n-normal", type=int, default=None,
                    help="synthetic normal rows (default: the checkpoint's training "
                         "campaign, else 6000; 1500 with --small)")
    sc.add_argument("--n-fault", type=int, default=None,
                    help="rows per fault segment (default: the checkpoint's training "
                         "campaign, else 800; 200 with --small)")
    sc.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sc.set_defaults(fn=cmd_score)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
