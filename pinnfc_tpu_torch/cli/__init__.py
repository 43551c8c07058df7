"""Command line of the port: ``python -m pinnfc_tpu_torch.cli
{train,score,synth,ensemble,auc,gmm,compare,risk,inspect,identify,explain,whatif,
conformal,monitor,export-model,report,run-all,serve,doctor,warmup,bench} ...``.

``train``, ``score``, ``ensemble``, ``auc``, ``gmm``, ``compare``, ``risk``,
``identify``, ``explain``, ``whatif``, ``monitor``, ``report``, ``run-all``,
``serve``, ``warmup`` and ``bench``
run on the card by default (``--device cuda``) and exit with an error when
CUDA is absent; ``--device cpu`` runs the plain PyTorch path.  ``doctor``
probes the card (``--platform cuda``, the default) or the CPU
(``--platform cpu``) in a bounded subprocess.
``synth`` writes a synthetic campaign as .mat files; ``risk --backend numpy``
runs the float64 host path; ``inspect``, ``conformal`` and ``export-model``
do no device work (an exported artifact is moved to its device when it is
loaded).  ``--plot-dir`` writes the JAX commands' figures (matplotlib).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from pinnfc_tpu_torch.cli.admin import cmd_bench, cmd_doctor, cmd_warmup
from pinnfc_tpu_torch.cli.diagnose import (
    cmd_auc, cmd_compare, cmd_conformal, cmd_gmm, cmd_report)
from pinnfc_tpu_torch.cli.explain import cmd_explain, cmd_identify, cmd_inspect, cmd_whatif
from pinnfc_tpu_torch.cli.export import cmd_export_model
from pinnfc_tpu_torch.cli.risk import cmd_risk
from pinnfc_tpu_torch.cli.run_all import cmd_run_all
from pinnfc_tpu_torch.cli.serve import cmd_monitor, cmd_serve
from pinnfc_tpu_torch.cli.train import cmd_ensemble, cmd_score, cmd_synth, cmd_train

_PLOT_DIR_HELP = "write the command's figures (PNG) into this directory"


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
                   help="'highest' = float32 accuracy (the default; the training "
                        "kernel's 3xTF32 form on the card); 'default' = the throughput "
                        "mode: bf16 product operands with float32 accumulation on the "
                        "card, float32 on the CPU")
    t.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the pipeline (a Chrome trace "
                        "in this directory)")
    t.add_argument("--metrics-jsonl", default=None,
                   help="write structured run metrics: one JSONL row per stage (final loss "
                        "+ subsampled loss trace) plus a final row with the metric/timing "
                        "tables")
    t.add_argument("--tensorboard-dir", default=None,
                   help="write TensorBoard scalar event files (per-stage loss curves + final "
                        "metrics; no TensorFlow needed)")
    t.add_argument("--resume-dir", default=None,
                   help="schedule snapshot dir: a killed run restarted with the same flags "
                        "resumes and reproduces the trajectory")
    t.add_argument("--ckpt-every", type=int, default=None,
                   help="with --resume-dir: snapshot every N steps WITHIN each stage "
                        "(mid-stage preemption safety)")
    t.add_argument("--normal-mat", default=None,
                   help="real campaign: normal-operation .mat (e.g. Polar-1.mat)")
    t.add_argument("--fault-dir", default=None,
                   help="real campaign: directory with the 12 fault .mat files "
                        "(<type>_<108|270|405>A.mat, Chinese or ASCII stems)")
    t.add_argument("--plot-dir", default=None, help=_PLOT_DIR_HELP)
    t.add_argument("--data-parallel", action="store_true",
                   help="shard batch rows over all visible devices (the CPU once with "
                        "--device cpu; one device runs the unsharded path)")
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
    sc.add_argument("--ignore-ckpt-config", action="store_true",
                    help="ignore the checkpoint's stored training config and build the "
                         "MC-export settings from CLI flags alone")
    sc.add_argument("--normal-mat", default=None,
                    help="new campaign: normal-operation .mat")
    sc.add_argument("--fault-dir", default=None,
                    help="new campaign: directory with the 12 fault .mat files")
    sc.add_argument("--plot-dir", default=None,
                    help="emit the script-01 figure set for the scored artifact "
                         "(uncertainty/detailed/split/temp)")
    sc.add_argument("--data-parallel", action="store_true",
                    help="shard the MC export's rows over all visible devices (the CPU once "
                         "with --device cpu; one device runs the unsharded path)")
    sc.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sc.set_defaults(fn=cmd_score)

    sy = sub.add_parser(
        "synth",
        help="write a synthetic campaign in the reference's 13-file .mat layout — a "
             "runnable stand-in for the measurement data, which is not redistributed",
    )
    sy.add_argument("--out-dir", required=True)
    sy.add_argument("--n-normal", type=int, default=6000,
                    help="normal-operation rows (before the loader's 50<I<800 filter)")
    sy.add_argument("--n-fault", type=int, default=800, help="rows per fault segment")
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--zh-names", action="store_true",
                    help="use the Chinese fault-file stems the reference ships (default: "
                         "ASCII aliases)")
    sy.set_defaults(fn=cmd_synth)

    e = sub.add_parser("ensemble", help="many-seed parallel PINN ensemble")
    e.add_argument("--members", type=int, default=8)
    e.add_argument("--steps", type=int, default=2000)
    e.add_argument("--mesh-shape", default=None, metavar="MxD",
                   help="hybrid 2-D mesh, e.g. 4x2: members over M devices, each member's "
                        "batch rows over D devices")
    e.add_argument("--small", action="store_true")
    e.add_argument("--seed", type=int, default=42)
    e.add_argument("--uq", action="store_true",
                   help="deep-ensemble mixture-moment UQ on the test split, compared against "
                        "member-0 MC dropout")
    e.add_argument("--uq-mc-times", type=int, default=256,
                   help="MC-dropout samples for the --uq comparison")
    e.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    e.set_defaults(fn=cmd_ensemble)

    a = sub.add_parser("auc", help="stage auc over F01_output.mat: the detection AUCs of "
                                   "script 02 (logistic regression per feature group, "
                                   "Isolation Forest)")
    a.add_argument("--mat", default="F01_output.mat")
    a.add_argument("--group-spec", default=None)
    a.add_argument("--test-size", type=float, default=None)
    a.add_argument("--balanced", action="store_true", default=None)
    a.add_argument("--no-balanced", dest="balanced", action="store_false")
    a.add_argument("--show-coef", type=int, default=0,
                   help="print top-N LR coefficients per class")
    a.add_argument("--list-features", action="store_true")
    a.add_argument("--plot-dir", default=None, help=_PLOT_DIR_HELP)
    a.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a.set_defaults(fn=cmd_auc)

    g = sub.add_parser("gmm", help="stage gmm over F01_output.mat: the 4-class GMM "
                                   "diagnosis of script 03")
    g.add_argument("--mat", default="F01_output.mat")
    g.add_argument("--init", choices=("kmeans", "sklearn"), default=None,
                   help="EM init: the port's k-means++ (default) or sklearn "
                        "GaussianMixture's own kmeans init (needs scikit-learn)")
    g.add_argument("--plot-dir", default=None, help=_PLOT_DIR_HELP)
    g.add_argument("--tsne", action="store_true",
                   help="with --plot-dir, also write a t-SNE figure of the test rows "
                        "(on --device)")
    g.add_argument("--data-parallel", action="store_true",
                   help="row-shard the GMM EM fit over all visible devices (of --device)")
    g.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    g.set_defaults(fn=cmd_gmm)

    c = sub.add_parser("compare", help="stage compare over F01_output.mat: the six-method "
                                       "4-class comparison of script 05")
    c.add_argument("--mat", default="F01_output.mat")
    c.add_argument("--methods", default=None,
                   help="comma list: gmm,logreg,svm,kmeans,agglomerative,spectral")
    c.add_argument("--plot-dir", default=None, help=_PLOT_DIR_HELP)
    c.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    c.set_defaults(fn=cmd_compare)

    r = sub.add_parser("risk", help="stage risk over F01_output.mat: the RF(t) early-warning "
                                    "table of script 04")
    r.add_argument("--mat", default="F01_output.mat")
    r.add_argument("--backend", choices=("torch", "jax", "numpy"), default="torch",
                   help="RF recurrences: 'torch' (float32 doubling scans on --device; "
                        "'jax' is the JAX command's name for it) or 'numpy' (float64 "
                        "lfilter, bit-parity with the reference)")
    r.add_argument("--plot-dir", default=None, help=_PLOT_DIR_HELP)
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the torch backend's device")
    r.set_defaults(fn=cmd_risk)

    ins = sub.add_parser("inspect", help="describe a checkpoint: provenance metadata, "
                                         "parameter tree, stored normalization ranges (no "
                                         "device work)")
    ins.add_argument("--ckpt", required=True)
    ins.add_argument("--json", action="store_true",
                     help="machine-readable output (meta, param shapes, named λ values, "
                          "scaler ranges, step)")
    ins.set_defaults(fn=cmd_inspect)

    idf = sub.add_parser("identify", help="identifiability of the 17 physics λ's: Gauss-Newton "
                                          "95%% CIs + sensitivity + at-bound/unidentifiable "
                                          "flags at the trained optimum")
    idf.add_argument("--ckpt", required=True)
    idf.add_argument("--mat", required=True,
                     help="exported F01_output.mat supplying the input rows")
    idf.add_argument("--json", action="store_true")
    idf.add_argument("--plot-dir", default=None,
                     help="save the relative-CI identifiability figure here")
    idf.add_argument("--data-parallel", action="store_true",
                     help="shard the residual Jacobian rows over all visible devices")
    idf.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    idf.set_defaults(fn=cmd_identify)

    xp = sub.add_parser("explain", help="input-channel saliency: which measured input the "
                                        "voltage prediction (and its aleatoric σ) leans on, "
                                        "per fault class")
    xp.add_argument("--ckpt", required=True)
    xp.add_argument("--mat", required=True,
                    help="exported F01_output.mat supplying rows + labels")
    xp.add_argument("--json", action="store_true")
    xp.add_argument("--plot-dir", default=None,
                    help="save the class × channel saliency heatmaps here")
    xp.add_argument("--data-parallel", action="store_true",
                    help="shard the Jacobian rows over all visible devices")
    xp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    xp.set_defaults(fn=cmd_explain)

    wi = sub.add_parser("whatif", help="counterfactual recovery: per alarmed risk condition, "
                                       "the minimal in-distribution actuation whose predicted "
                                       "voltage gain covers the measured shortfall below the "
                                       "alarm line")
    wi.add_argument("--ckpt", required=True)
    wi.add_argument("--mat", required=True,
                    help="exported F01_output.mat supplying rows + labels")
    wi.add_argument("--steps", type=int, default=400,
                    help="Adam iterations of the inverse solve (default 400)")
    wi.add_argument("--lr", type=float, default=0.05,
                    help="step size in normalized-input units (default 0.05)")
    wi.add_argument("--alpha", type=float, default=0.05,
                    help="minimal-actuation penalty weight (default 0.05)")
    wi.add_argument("--margin", type=float, default=0.01,
                    help="volts above the alarm line to target (default 0.01)")
    wi.add_argument("--actuate", default=None,
                    help="comma-separated channels the solver may move "
                         "(default: all but current and coolant_t_out)")
    wi.add_argument("--max-rows", type=int, default=64,
                    help="cap alarmed rows per condition, subsampled evenly")
    wi.add_argument("--absolute-target", action="store_true",
                    help="target the model's own prediction clearing the alarm line instead "
                         "of the default gain target (Δv̂ covering the measured shortfall)")
    wi.add_argument("--json", action="store_true")
    wi.add_argument("--plot-dir", default=None,
                    help="save the condition × channel actuation heatmap here")
    wi.add_argument("--data-parallel", action="store_true",
                    help="shard the solve rows over all visible devices")
    wi.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    wi.set_defaults(fn=cmd_whatif)

    m = sub.add_parser("monitor", help="streaming replay through OnlineMonitor")
    m.add_argument("--mat", default="F01_output.mat")
    m.add_argument("--ckpt", required=True, help="checkpoint from `train --ckpt`")
    m.add_argument("--block", type=int, default=64, help="samples per block")
    m.add_argument("--fault-label", type=int, default=None,
                   help="replay only this fault segment (1..12) after a lead-in")
    m.add_argument("--lead", type=int, default=200,
                   help="normal lead-in rows before the fault segment")
    m.add_argument("--diagnose", action="store_true",
                   help="attach the script-03 GMM head: classify the fault type online "
                        "while the RF warns")
    m.add_argument("--head", default=None,
                   help="load a saved diagnosis head (.npz) instead of fitting one from "
                        "the artifact")
    m.add_argument("--save-head", default=None, help="persist the fitted diagnosis head (.npz)")
    m.add_argument("--glitch-alarm-n", type=int, default=None,
                   help="sensor_alarm after N consecutive non-finite samples")
    m.add_argument("--fleet", action="store_true",
                   help="replay ALL 12 (current, fault) risk conditions (04:145-161) as "
                        "concurrent streams — one observe_many step per lockstep block")
    m.add_argument("--whatif", action="store_true",
                   help="after the replay, solve the gain-mode counterfactual over the "
                        "alarmed tail: the minimal in-training-range actuation whose "
                        "predicted voltage gain covers the measured shortfall below the "
                        "stream's dynamic alarm line")
    m.add_argument("--conformal", action="store_true",
                   help="calibrated anomaly p-values per sample, calibrated on the "
                        "artifact's normal rows (uq/conformal |res| score); prints the "
                        "normal-vs-fault anomaly rate")
    m.add_argument("--conformal-alpha", type=float, default=0.1,
                   help="p<α counts as a calibrated anomaly (default 0.1)")
    m.add_argument("--conformal-gamma", type=float, default=0.0,
                   help="with --conformal: adaptive conformal step size γ (Gibbs & Candès "
                        "ACI) — the alarm level α_t tracks drift so the long-run alarm rate "
                        "stays at α*; the replayed stream's final α_t is a calibrated drift "
                        "gauge (0 = static level, default)")
    m.add_argument("--data-parallel", action="store_true",
                   help="with --fleet: shard the stream axis over all visible devices "
                        "(collective-free)")
    m.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    m.set_defaults(fn=cmd_monitor)

    cf = sub.add_parser("conformal", help="split-conformal coverage analysis of an exported "
                                          "artifact: distribution-free voltage intervals "
                                          "calibrated on normal rows, per-fault miscoverage, "
                                          "calibrated anomaly p-values (host)")
    cf.add_argument("--mat", required=True)
    cf.add_argument("--alpha", type=float, default=0.1,
                    help="miscoverage level (default 0.1 → 90%% intervals)")
    cf.add_argument("--score", choices=("adaptive", "absolute"), default="adaptive",
                    help="adaptive = |res|/sqrt(ale²+epi²) (width tracks the model's σ̂); "
                         "absolute = |res|")
    cf.add_argument("--calib-frac", type=float, default=0.5,
                    help="fraction of normal rows consumed for calibration (the rest gives "
                         "the held-out coverage; default 0.5)")
    cf.add_argument("--seed", type=int, default=0,
                    help="calibration/evaluation split seed (default 0)")
    cf.add_argument("--json", action="store_true")
    cf.add_argument("--plot-dir", default=None,
                    help="save the per-class coverage/p-value figure here")
    cf.set_defaults(fn=cmd_conformal)

    ex = sub.add_parser("export-model", help="serialize the checkpoint's eval-mode scorer to a "
                                             "self-contained torch.export artifact: weights + "
                                             "scalers baked in, any batch size (traced on the "
                                             "CPU, moved to its device at load time)")
    ex.add_argument("--ckpt", required=True)
    ex.add_argument("--out", required=True,
                    help="output artifact path (a .meta.json provenance sidecar is written "
                         "alongside)")
    ex.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated devices the artifact targets: cpu, cuda (default "
                         "cpu,cuda)")
    ex.add_argument("--monitor-step", action="store_true",
                    help="export the full streaming RF(t) block step (state in/out as a "
                         "plain tuple; μ/σ runtime inputs) instead of the plain scorer")
    ex.add_argument("--fleet-step", action="store_true",
                    help="with --monitor-step: export observe_many's fleet program instead "
                         "(symbolic stream axis AND block size): one call advances a whole "
                         "fleet")
    ex.add_argument("--head", default=None,
                    help="with --monitor-step: bake this DiagnosisHead (.npz) in for online "
                         "fault typing")
    ex.add_argument("--glitch-alarm-n", type=int, default=None,
                    help="with --monitor-step: bake this consecutive-glitch sensor-alarm "
                         "threshold in (default: the monitor's)")
    ex.add_argument("--conformal-mat", default=None,
                    help="with --monitor-step: bake calibrated anomaly p-values in, "
                         "calibrated on this artifact's normal rows (|res| scores)")
    ex.add_argument("--conformal-alpha", type=float, default=None,
                    help="α recorded in the sidecar for the low-p counter (default 0.1)")
    ex.add_argument("--conformal-gamma", type=float, default=None,
                    help="with --conformal-mat: the adaptive conformal step size γ, recorded "
                         "in the sidecar (the level α_t runs on the host after each step; "
                         "default 0: static level)")
    ex.set_defaults(fn=cmd_export_model)

    rp = sub.add_parser("report", help="one-file markdown report: every downstream stage's "
                                       "findings over an artifact, plus provenance and the "
                                       "figure gallery")
    rp.add_argument("--mat", default="F01_output.mat")
    rp.add_argument("--ckpt", default=None, help="checkpoint for the provenance section")
    rp.add_argument("--plot-dir", default=None,
                    help="existing figures directory to link as the gallery")
    rp.add_argument("--out", default=None, help="output path (default: report.md next to --mat)")
    rp.add_argument("--baseline", default=None,
                    help="baseline artifact (.mat) for a direction-aware metric diff — the "
                         "retrain/rescore regression check")
    rp.add_argument("--sections", default=None,
                    help="comma subset of: provenance,overview,auc,gmm,risk,compare,"
                         "conformal,identifiability,saliency,figures")
    rp.add_argument("--json", action="store_true",
                    help="print the artifact metric vector as JSON instead of writing markdown "
                         "(CI regression tracking)")
    rp.add_argument("--json-out", default=None,
                    help="also write the metric vector to this path (run-all drops "
                         "metrics.json next to report.md)")
    rp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    rp.set_defaults(fn=cmd_report)

    ra = sub.add_parser("run-all", help="full pipeline 01→02/03/04/05")
    # (--seed default None: the train stage falls back to 42; the --from-ckpt
    # score stage to the checkpoint's training seed)
    ra.add_argument("--out-dir", required=True)
    ra.add_argument("--from-ckpt", default=None,
                    help="skip training: score the campaign with this existing checkpoint "
                         "(see `score`), then run every downstream stage on the scored "
                         "artifact")
    ra.add_argument("--small", action="store_true")
    ra.add_argument("--steps-scale", type=float, default=None,
                    help="multiply every stage's step count")
    ra.add_argument("--seed", type=int, default=None)
    ra.add_argument("--normal-mat", default=None, help="real campaign: normal-operation .mat")
    ra.add_argument("--fault-dir", default=None,
                    help="real campaign: directory with the 12 fault .mat files")
    ra.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ra.set_defaults(fn=cmd_run_all)

    sv = sub.add_parser("serve", help="HTTP scoring endpoint (POST /observe, /observe_many, "
                                      "/reset; GET /health, /metrics)")
    sv.add_argument("--mat", default="F01_output.mat",
                    help="artifact for the normal-operation μ/σ statistics")
    sv.add_argument("--ckpt", default=None, help="checkpoint from `train --ckpt`")
    sv.add_argument("--artifact", default=None,
                    help="serve from an `export-model --monitor-step` torch.export artifact "
                         "instead of a checkpoint (risk config/glitch threshold/class names "
                         "adopted from its .meta.json sidecar)")
    sv.add_argument("--head", default=None,
                    help="saved diagnosis head (.npz) for online fault typing")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8787)
    sv.add_argument("--max-requests", type=int, default=None,
                    help="stop after N requests (bounded demos/tests)")
    sv.add_argument("--glitch-alarm-n", type=int, default=None,
                    help="sensor_alarm after N consecutive non-finite samples")
    sv.add_argument("--state-path", default=None,
                    help="preemption-safe serving: snapshot the per-stream RF(t) state bank "
                         "here after every request and restore it on restart (atomic npz)")
    sv.add_argument("--conformal", action="store_true",
                    help="with --ckpt: serve calibrated anomaly p-values, calibrated on "
                         "--mat's normal rows (/observe gains conformal_p; /metrics a low-p "
                         "counter)")
    sv.add_argument("--conformal-alpha", type=float, default=None,
                    help="p<α counts as a calibrated anomaly (default 0.1, or the artifact "
                         "sidecar's recorded value)")
    sv.add_argument("--conformal-gamma", type=float, default=None,
                    help="with --ckpt --conformal: adaptive conformal step size γ — each "
                         "stream's alarm level α_t tracks drift (/observe gains aci_alpha/"
                         "aci_anomaly; /metrics a per-stream α_t gauge). Recorded in the "
                         "sidecar for artifacts (`export-model --conformal-gamma`)")
    sv.add_argument("--data-parallel", action="store_true",
                    help="shard /observe_many's stream axis over all visible devices (fleet "
                         "scoring is collective-free; capacity scales with cards)")
    sv.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sv.set_defaults(fn=cmd_serve)

    dr = sub.add_parser("doctor", help="deployment self-check: versions, environment, the kernel "
                                       "library, warmup coverage, checkpoint/artifact "
                                       "pre-flight, a bounded card probe")
    dr.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                    help="the device the probe and --smoke bring up (default cuda; cpu runs "
                         "the plain PyTorch path)")
    dr.add_argument("--probe-timeout", type=float, default=600.0,
                    help="seconds before the probe subprocess is declared stalled "
                         "(default 600)")
    dr.add_argument("--skip-probe", action="store_true",
                    help="skip the probe (filesystem and environment checks only; CUDA is "
                         "never initialised)")
    dr.add_argument("--smoke", action="store_true",
                    help="also run 101 Adam steps through the training kernel in a bounded "
                         "subprocess (build or load, launch, readback)")
    dr.add_argument("--ckpt", default=None,
                    help="pre-flight a checkpoint: its arrays read on the host + sidecar")
    dr.add_argument("--artifact", default=None,
                    help="pre-flight an export-model artifact: deserialize it and report its "
                         "platforms (nothing runs)")
    dr.add_argument("--json", action="store_true",
                    help="emit the check list as one JSON array")
    dr.set_defaults(fn=cmd_doctor)

    wu = sub.add_parser("warmup", help="build the kernel library and run each production step "
                                       "once at the configured row counts, so the first real "
                                       "run pays neither")
    wu.add_argument("--small", action="store_true",
                    help="warm the --small schedule/data-size steps")
    wu.add_argument("--seed", type=int, default=42,
                    help="data seed (row counts follow the data; match the training run)")
    wu.add_argument("--steps-scale", type=float, default=None,
                    help="multiply every stage's step count (match the training flags)")
    wu.add_argument("--n-normal", type=int, default=None)
    wu.add_argument("--n-fault", type=int, default=None)
    wu.add_argument("--normal-mat", default=None, help="real campaign: warm for ITS row counts")
    wu.add_argument("--fault-dir", default=None)
    wu.add_argument("--precision", choices=("highest", "default"), default=None,
                    help="the training kernel's form to warm (match the training flags)")
    wu.add_argument("--skip-nonfinite", action="store_true")
    wu.add_argument("--ckpt", default=None,
                    help="also warm the monitor step for this checkpoint")
    wu.add_argument("--mat", default=None,
                    help="also run the downstream pipelines (AUC/GMM/risk/compare) once on "
                         "this artifact")
    wu.add_argument("--block", type=int, default=64,
                    help="monitor block size to warm (with --ckpt)")
    wu.add_argument("--json", action="store_true")
    wu.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    wu.set_defaults(fn=cmd_warmup)

    b = sub.add_parser("bench", help="training throughput of the flagship DNN stage in both "
                                     "forms of the training kernel (one JSON line)")
    b.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
