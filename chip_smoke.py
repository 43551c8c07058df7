"""Smoke run of the PyTorch/CUDA port on one GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, any failure exits non-zero before the result line:
1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile every kernel in pinnfc_tpu_torch/csrc with nvcc (sm_90a);
   count the tensor-core instructions (HMMA, and wgmma's HGMMA) of each
   training-kernel function and of the MC-dropout sample kernel in the
   library's SASS (cuobjdump): fwd_bwd_kernel and wgrad_kernel (the 3xTF32
   form) must have HMMA, fwd_bwd_bf16_kernel and wgrad_bf16_kernel (the bf16
   form) bf16 HMMA or HGMMA, mc_sample_kernel bf16 ones;
3. kernel vs plain on the card: the MC-dropout kernel at flagship width on
   1,000 rows (ragged against its 128-row CTAs and 256-row mask blocks),
   64 samples, against its plain version with bf16 sample passes and against
   the float32 plain version; the residual kernel on the 15,600-row campaign
   and on its first 37 rows (ragged against the 32-row CTAs), each with and
   without rows past the limiting current, and with 25 rows at ragged
   positions holding NaN, +inf and -inf in each input channel in turn and a
   NaN u (NaN sets must be identical);
4. the scoring slice at full width: flagship params from a torch.Generator
   seed, scalers fitted on the default synthetic campaign (N = 15,600), a
   port checkpoint, then ``run_scoring_pipeline(device="cuda")`` with
   mc_times = 2000, the launch counters reset just before and read just
   after; the artifact is checked against the plain functions; then
   ``evaluate_voltage_metrics(params, dataset)`` (one eval forward and the
   residual kernel, the counters reset just before and read just after)
   against ``evaluate_voltage_metrics(..., results=)`` of the scored artifact,
   every metric within rtol 1e-5 (atol 1e-7; an R² as 1 − R²);
5. the main path's shapes: the MC-dropout kernel against its plain versions
   (bf16 and float32 sample passes) on the campaign's 15,600 rows with 2,000
   samples and the main path's MC seed, two kernel runs bitwise equal, the
   artifact's columns 10 and 11 against the bf16 plain statistics; timing
   (CUDA events, median of repeats; the residual kernel alone, and an empty
   kernel on its grid as its launch floor, each as 50 launches replayed from
   one CUDA graph, and the kernel on 37 rows; its wrapper and its plain
   version as 50 calls);
6. the training kernel against its plain version at the training path's
   shape: the campaign's 6,000 training rows (ragged against its 512-row
   mask blocks), and their first 37 (ragged against the 16-row mma tiles and
   the 48-row CTAs), flagship params from ``torch.Generator().manual_seed(0)``,
   20 steps at lr 0.01 with the staircase turning three times, dropout 0.2
   and 0, the weights within ``TRAIN_WEIGHT_ATOL`` (1e-3) of the plain
   version's; two kernel runs bitwise equal at each N; a NaN row with
   skip_nonfinite leaves the weights as they were;
7. the training slice: ``run_training_pipeline(device="cuda")`` on the
   default campaign at flagship width, mc_times 2000, the default schedule
   with every stage's n_iter scaled by 0.1, the launch counters reset just
   before and read just after; finite losses, the first DNN stage's loss
   falling and the later one staying below its untrained level (``falls``,
   phase 21's reading); each DNN stage walked (``walk_dnn_stage``): the
   kernel in four chunks takes the pipeline's steps bitwise, 20 steps from
   its own weights and Adam state at the start of each chunk stay within
   max(1e-3, 4 × a one-ulp nudged start's drift) of the float32 plain
   version's weights, and over the whole stage the plain version's nudged
   twin parts from it at least a quarter as far as the kernel does; λ
   bounds and the artifact checked; the
   checkpoint saved as ``cli train`` saves it and scored again with
   ``run_scoring_pipeline``, whose artifact must equal the train-time one;
8. timing at the training path's shapes (the training kernel per step of a
   200-step stage, its plain version, each λ-stage kind per step, the slice's
   per-stage seconds; the device launches and per-kernel device time of a
   50-step stage, counted from a torch.profiler trace; the kernel's share of
   its 3xTF32 and float32 bounds; the kernel as a chunk from step 200 with a
   carried Adam state);
9. the campaign slice through the command line, each step a subprocess on
   the card that prints its launch counts: ``cli synth`` writes the default
   campaign (6,000 normal rows, 12 x 800 fault rows, seed 0) as .mat files;
   ``cli train --normal-mat --fault-dir`` trains on them (schedule x 0.1,
   ``--ckpt-every 100`` so the DNN stages run as 12 chunk launches of the
   training kernel, ``--metrics-jsonl``, ``--tensorboard-dir`` and
   ``--profile-dir``), and ``cli score`` on the same files must reproduce the
   train-time artifact column for column; the JSONL rows, the event file (read
   back by the port's ``read_events``) and the profiler trace are checked;
10. kill and resume on the card: the default dnn and lambda_v stages at 0.05
   of their steps, chunks of 70, a preemption simulated by raising from the
   snapshot writer after chunk 2 (inside the DNN stage) or 5 (inside the λ
   stage): the resumed run, restarted with ``ckpt_every`` or without, equals
   the uninterrupted chunked run bitwise, which equals the unchunked one;
11. a non-flagship model at flagship width: ``run_training_pipeline(device=
   "cuda")`` with four hidden layers (8, 256, 256, 256, 256, 1), the default
   campaign, the schedule x 0.1 and mc_times 2000, the launch counters reset
   just before and read just after: the DNN stages take the autograd stage and
   the export the torch.Generator ('vmap') sampler, so neither the training
   kernel nor the MC kernel launches, and the residual kernel does; the
   artifact checked as in phase 7; ``cli score`` on the written checkpoint, a
   subprocess, reproduces the train-time artifact; the autograd stage in
   chunks of 70 equals the whole 200-step stage bitwise;
12. risk on the card: phase 7's artifact through ``run_risk_pipeline`` with
   the torch backend on the card and with the float64 numpy backend: the same
   alarm table for every condition, the RF series within the tolerances of
   tests/test_risk.py; ``cli risk`` on the card and with ``--backend numpy``,
   two subprocesses, print identical tables;
13. diagnosis on the card: phase 7's artifact through ``run_auc_pipeline``
   (4 feature groups, 1,560 training and 14,040 test rows, a forest of 200
   trees) and ``run_gmm_pipeline`` (20 components on ``pV,pT,pH,pO``), each on
   the card and on the CPU with the same CPU-generator draws: the same split,
   group AUCs within 1e-4, GMM accuracy within 0.005, ``y_prob`` rows summing
   to 1, the EM converged within ``max_iter``; their seconds, the Newton and
   EM iterations and the peak memory printed; then ``cli auc`` and ``cli gmm``
   on the card over phase 9's ``cli score`` file, two subprocesses, whose
   tables are printed;
14. the comparison of script 05 on the card: phase 7's artifact through
   ``run_compare_pipeline`` at the published ``CompareConfig``/``GmmConfig``
   (7,200 training and 2,400 test fault rows; Ward takes the NN-chain and
   spectral the subspace iteration at that size), all six methods at once
   and each on its own (synchronized host clock), with the SVM's L-BFGS
   steps, Ward's chain steps and host replay, and the subspace steps
   recorded on the way; the same seed on the CPU for GMM, LR, SVM, KMeans
   and Agglomerative: the same ``y_true``, LR/SVM/Agglomerative predictions
   agreeing on ≥ 99.5 % of rows, every macro F1 within 0.01 of the card's;
   on the card, the subspace path's bottom-16 projector within 1e-2 (max
   abs) of ``eigh``'s on the same Laplacian; ``tsne_fit`` on the 2,400 test
   rows at perplexity 20 (its seconds and KL), and on a 600-row subset on the
   card and on the CPU, KLs within 10 %; ``cli compare`` on the card over
   phase 9's ``cli score`` file, a subprocess, whose table is printed; the
   peak memory of the phase;
15. explainability and figures on the card: ``input_saliency`` over phase
   7's 15,600 artifact rows on the card and on the CPU (``jac_norm`` and
   ``jac_range`` of each within rtol 1e-4 plus 1e-5 of the field's largest
   entry of a float64 Jacobian, the card's largest error at most twice the
   CPU's; the class tables within 1e-4, their drivers equal); ``lambda_identifiability`` on the card, group by
   group, and on the CPU (flags and ``n_dropped`` equal, stderr within rtol
   1e-3); ``conformal_report`` (host); the t-SNE view of ``auc --plot-dir``
   (``tsne_embed`` of all 15,600 rows on x0,x3,x4,x5) with its seconds and
   peak memory, and a 600-row subset on the card and on the CPU, KLs within
   10 %; the view of ``gmm --plot-dir --tsne`` (the GMM test rows); then ``cli
   identify``, ``explain``, ``inspect`` and ``conformal`` over phase 9's
   checkpoint and ``cli score`` file, text and ``--json``, in one subprocess,
   whose tables are printed; then ``--plot-dir`` on auc, gmm --tsne, risk,
   compare, identify, explain and conformal in one subprocess: where
   matplotlib is installed each writes the JAX command's file names; where it
   is not, each exits 1 naming matplotlib and one line says that no figure
   was drawn;
16. serving and the counterfactual on the card (see ``run_serving_slice``);
17. run-all and the report on the card: ``run_all(args, plot_dir=None)``, the
   chain of ``cli run-all`` without figures, at flagship width on the
   default campaign (15,600 rows, mc_times 2000, the schedule x 0.1), the
   launch counts reset just before and read just after (the training kernel
   twice, the MC kernel once, the residual kernel phase 7's count plus one
   per monitor block), each stage's seconds; report.md with every default
   section and none degraded; metrics.json against ``artifact_metrics`` of
   the same .mat on the CPU at phases 12-13's tolerances; then ``cli run-all
   --from-ckpt`` over phase 9's checkpoint in a subprocess: exit 0 where
   matplotlib is installed, else exit 1 naming it after writing
   F01_output.mat;
18. export and serve on the card: ``cli export-model`` over phase 9's
   checkpoint three ways (the scorer; the monitor step with phase 13's GMM
   head, conformal p-values and γ = 0.005; the fleet step), one subprocess
   that launches no kernel; the scorer artifact moved to the card against
   the eval forward at 1, 37 and 15,600 rows; phase 16's stream through
   ``monitor_from_artifact(device="cuda")`` in blocks of 64 and 256 against
   the checkpoint monitor on the card, one residual-kernel launch per
   block; ``observe_many`` of 12 x 64 through the fleet artifact in one
   launch; ``cli serve --ckpt`` and ``--artifact`` as subprocesses driven
   over loopback (/health, /observe, /observe_many, /reset, /metrics), each
   payload equal to the in-process monitor's; a ``--state-path`` restart
   continuing the bank bitwise; the ms per exported ``observe`` at B = 1,
   64 and 256, at B = 1 and 64 split into the artifact's device step and
   the rest, and the eager device step with the scans at three depths (the
   cost of the fixed rounds), and per /observe round trip at B = 64;
19. ensembles and data-parallel training on the card: ``cli ensemble
   --members 8 --steps 2000 --uq`` in a subprocess (6,000 training rows,
   flagship; one training-kernel launch per member); ``train_dnn_ensemble``
   on 2 members bitwise two lone ``train_dnn_stage`` calls with the members'
   seeds; ``run_training_pipeline(mesh=make_mesh(devices=["cuda:0"] * 4))``
   at flagship width on the default campaign, the schedule x 0.05 and
   mc_times 2000, the launch counters reset just before and read just after
   (the DNN stages through the training kernel's per-step entries, the MC
   export one launch per row shard): its MC columns bitwise those of the
   unsharded export of its params, its λ_t, λ_h and λ_o against an
   unsharded run's, its λ_v at ``LAM_V_WHOLE_RTOL`` of the unsharded run's,
   its two λ_v stages at 25 steps sharded against unsharded from its MLP
   (and their reading at 200 steps printed); the sharded DNN stage against
   the whole-stage kernel at phase 6's tolerances, and from the trained MLP
   at ``TRAINED_WEIGHT_ATOL`` beside the whole-stage kernel against its
   plain version; a planted fault (every shard's masks at row offset 0)
   must fail both bounds; phase 9's ``cli train`` (without its report flags) and ``cli
   score`` again with ``--data-parallel``, whose artifacts must equal phase
   9's bitwise and the checkpoint byte for byte; the sharded DNN stage's
   ms/step against the whole-stage kernel's, the MC kernel over four shards
   against one launch, per-member training seconds and ``ensemble_moments``
   at E = 8 and N = 15,600;
20. the downstream half of ``parallel/`` on the card, on
   ``make_mesh(devices=["cuda:0"] * 4)`` with phase 7's model and artifact,
   each sharded result against the unsharded run on the card:
   ``run_gmm_pipeline(mesh=)`` (k-means init) and the sharded EM fit on 9,597
   fault rows (three pad rows) at ``GMM_SHARDED_RTOL``, which a planted fault
   (pad rows at weight 1) must fail; ``input_saliency`` and
   ``lambda_identifiability`` of the 15,600 rows; ``condition_recovery`` at
   400 steps, held by its recovered fractions; 30 streams × 64 rows through
   the sharded ``observe_many`` (two dummy streams; four residual-kernel
   launches per call, the kernel held against its plain version on each
   shard's rows) at ``FLEET_SHARDED_ATOL``, which a planted fault (a dummy
   stream's result written back) must fail, and ``fleet_replay``; the
   sharded and unsharded ``observe_many`` times; then ``gmm``, ``identify``,
   ``explain``, ``whatif --json`` and ``monitor --fleet`` with and without
   ``--data-parallel`` in one subprocess over phase 9's files (the same
   output, the mesh line aside) and ``serve --ckpt --data-parallel`` for one
   /observe_many against the in-process monitor;
21. the training kernel's bf16 form (precision "default") on the card: the
   one-step gradient of ``pinnfc_train_dnn_grad`` in both forms on 6,000 and
   37 rows, and in the bf16 form on 511, 513 and 1,000 (ragged against its
   64-row CTAs and the 512-row mask blocks), against the plain version with
   bf16 products within ``BF16_GRAD_BAND`` of max|g| (the float32 plain
   gradient, a planted fault, must fail it; the 3xTF32 form's gaps to the
   float32 and float64 plain gradients printed); a 20-step stage against its bf16 plain version (loss[0],
   the losses within ``BF16_LOSS_BAND`` of the largest |loss|, at most
   ``BF16_WEIGHT_SHARE`` of the weights further than 1e-3), two runs bitwise
   equal, a chunk from step 200 bitwise the whole stage, a NaN row with
   skip_nonfinite; the sharded stage on ``[cuda:0] * 4`` (4 grad launches a
   step) against the whole-stage bf16 kernel; ``cli train --precision
   default --steps-scale 0.1`` plain, with ``--ckpt-every 100`` and with
   ``--data-parallel``, three subprocesses at once, the first DNN stage's
   loss falling (the median after its first tenth below that of its first
   tenth) and the later one staying below that first tenth's median, their
   launches counted, their artifacts equal on one card; the
   non-flagship model's bf16-operand autograd gradient against the
   hand-derived bf16 one (the float32 autograd must fail the band) and its
   200-step stage at "default"; both forms' ms/step of a 200-step stage in
   turns, the bf16 plain version's, a profiler split of the bf16 form and
   its scratch bytes per step;
   the 3xTF32 form's one-step gradient within max(4 × the float32 plain
   version's gap, 1e-6) of max|g| of a float64 gradient;
22. the operational commands on the card: ``cli doctor --smoke --json``
   (every check ok, the probe's capability (9, 0), the smoke run's two
   training-kernel launches), ``cli warmup --json`` and ``cli warmup
   --precision default --json`` at the default campaign, ``cli bench``, all
   four in one subprocess whose launches are counted; then every warmed
   program present in ``warmup_coverage``, bench's ``value`` within 10 % of
   1 / (phase 8's ms/step), and ``production_memory_report`` at the default
   campaign (with a monitor step of phase 7's model) with each step's peak
   printed and below the card's memory;
then one JSON line ``{"kernels": [...]}``, the card line, and
``{"ok": true, "device": {...}}`` as the last line.

``python3 chip_smoke.py --kernel-times`` runs none of it and prints the two
kernels' times at the main path's shapes (``kernel_times``).

Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
TF32_PEAK = 495e12  # H100 SXM TF32 tensor cores, dense, FLOP/s
BF16_PEAK = 989e12  # H100 SXM bf16 tensor cores, dense, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
MC_FLOP_PER_ROW_SAMPLE = 2 * (8 * 256 + 2 * 256 * 256 + 256 + 256 * 128 + 128 * 64 + 64)
# ... of it in the four wide products, which a sample pass runs in bf16 (the
# rest, layer 0 and the two heads, stays float32)
MC_WIDE_FLOP_PER_ROW_SAMPLE = 2 * (2 * 256 * 256 + 256 * 128 + 128 * 64)
# float32 operations per row of csrc/residuals.cu, counting each powf/expf/logf/sqrtf as one
RESIDUAL_FLOP_PER_ROW = 110
# MACs per row of one training step: forward 174,400, weight gradients 174,400,
# input gradients 172,352
TRAIN_FLOP_PER_ROW_STEP = 2 * (174_400 + 174_400 + 172_352)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, inner: int = 1, warmup: bool = True) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls, per call."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def timed(fn):
    """(fn's result, the CUDA-event ms of that one call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    stop.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(stop)


def graph_ms(fn, inner: int, repeats: int) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured in one CUDA
    graph, replayed ``repeats`` times (median), so host launch costs drop out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, repeats) / inner


def check_mc(k_sums: torch.Tensor, b_sums: torch.Tensor, f_sums: torch.Tensor, m: int,
             label: str):
    """Hold the kernel's statistics against the plain version with bf16 sample
    passes (its rounding contract; b_sums): base at rtol 2e-5, the statistics
    at rtol 1e-3 and atol 1e-5 (summation order, and the bf16 roundings that
    it flips); and against the float32 plain version (f_sums) at rtol 1e-2,
    atol 1e-4 (the bf16 sample passes).  Returns (the finished bf16 plain
    statistics, max |Δ| against them, max |Δ| against the float32 ones)."""
    from pinnfc_tpu_torch.uq.mc_dropout import finish_mc_stats

    k_mc, b_mc, f_mc = (finish_mc_stats(t, m) for t in (k_sums, b_sums, f_sums))
    torch.testing.assert_close(k_mc.pred_mean, b_mc.pred_mean, rtol=2e-5, atol=1e-6)
    for name in ("aleatoric_std", "epistemic_std"):
        torch.testing.assert_close(getattr(k_mc, name), getattr(b_mc, name), rtol=1e-3,
                                   atol=1e-5, msg=f"{name} against the bf16 plain version")
        torch.testing.assert_close(getattr(k_mc, name), getattr(f_mc, name), rtol=1e-2,
                                   atol=1e-4, msg=f"{name} against the float32 plain version")
    err = max(max_abs_err(a, b) for a, b in zip(k_mc, b_mc))
    err_fp32 = max(max_abs_err(a, b) for a, b in zip(k_mc, f_mc))
    print(f"[check] mc_dropout kernel vs plain, {label}: max |statistics diff| {err:.3e} "
          f"against bf16 sample passes (base rtol 2e-5 atol 1e-6, statistics rtol 1e-3 "
          f"atol 1e-5), {err_fp32:.3e} against float32 ones (rtol 1e-2 atol 1e-4); "
          f"max |sums diff| {max_abs_err(k_sums, b_sums):.3e}: ok")
    return b_mc, err, err_fp32


def check_artifact(arr: np.ndarray, params, ds, metrics, n: int) -> None:
    """The artifact against the plain functions on the same inputs: shape,
    finite columns, positive uncertainties, the prediction column and the
    residual columns, and which metrics may be non-finite."""
    from pinnfc_tpu_torch.physics.residuals import all_residuals

    check(arr.shape == (n, 22), f"artifact shape {arr.shape}")
    finite_cols = [*range(0, 13), *range(14, 18), *range(19, 22)]
    bad = [c for c in finite_cols if not np.isfinite(arr[:, c]).all()]
    check(not bad, f"non-finite values in columns {bad}")
    check((arr[:, 10] > 0).all() and (arr[:, 11] > 0).all(), "uncertainty columns not positive")
    with torch.no_grad():
        base = params["mlp"](ds.x_test)[0]
        bundle = all_residuals(params, ds.x_test, base, ds.scaler_x, ds.scaler_y)
        scale_y, min_y = ds.scaler_y.loss_affine()
        pred_real = ((base[:, 0] - min_y) / (scale_y + 1e-12)).cpu().numpy()
    np.testing.assert_allclose(arr[:, 9], pred_real, rtol=2e-5, atol=1e-4)
    for col, t in zip((13, 14, 15, 16, 18, 19, 20, 21), bundle):
        np.testing.assert_allclose(arr[:, col], t[:, 0].cpu().numpy(), rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=f"column {col}")
    nan_metrics = sorted(k for k, v in metrics.items() if not np.isfinite(v))
    check(set(nan_metrics) <= {"physics_v_mae", "physics_v_rmse"},
          f"non-finite metrics {nan_metrics}")
    check(bool(np.isnan(arr[:, 13]).any()) or not nan_metrics,
          "physics_v metrics non-finite although column 13 is finite")


def with_nonfinite_rows(x: torch.Tensor, u: torch.Tensor):
    """Copies of the residual kernel's inputs x (N, 8) and u (N, 1) with 25
    rows replaced, at ragged positions (stride 613 for the campaign, 3 for
    N = 37, so some land in the last partial CTA): NaN in each of the 8
    channels in turn, +inf in each, -inf in each, and a NaN u."""
    x, u = x.clone(), u.clone()
    n = x.shape[0]
    stride = 613 if n > 1000 else 3
    rows = [(stride * k + 7) % n for k in range(25)]
    check(len(set(rows)) == 25, f"non-finite rows collide: {rows}")
    for k, r in enumerate(rows[:24]):
        x[r, k % 8] = (float("nan"), float("inf"), float("-inf"))[k // 8]
    u[rows[24]] = float("nan")
    return x, u


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    finite = torch.isfinite(a) & torch.isfinite(b)
    return float((a[finite] - b[finite]).abs().max()) if bool(finite.any()) else 0.0


# phase 6's bound on the weights after 20 steps, kernel against its float32
# plain version: the 3xTF32 form with a fresh accumulator per k8 step drifted
# 1.56e-5 (N = 6,000) and 2.21e-4 (N = 37) on an H100; with the products of
# all k steps in one mma.sync accumulator it drifted up to 2.9e-3
TRAIN_WEIGHT_ATOL = 1e-3


def check_train_kernel(mlp, x: torch.Tensor, y: torch.Tensor) -> float:
    """Phase 6: the training kernel against its plain version on the training
    path's rows and on their first 37; returns max |Δ| over the losses and
    weights."""
    from pinnfc_tpu_torch.ops.train_dnn import mlp_weights, train_dnn, train_dnn_stage_plain

    steps, hp = 20, dict(lr=0.01, lr_step=5, lr_gamma=0.5)
    seed = 20240601
    err = 0.0
    for xn, yn in ((x, y), (x[:37], y[:37])):
        for p in (0.2, 0.0):
            k_mlp, k_loss, _ = train_dnn(mlp, xn, yn, seed, steps, dropout_p=p, **hp)
            p_mlp, p_loss, _ = train_dnn_stage_plain(mlp, xn, yn, seed, steps, dropout_p=p, **hp)
            torch.cuda.synchronize()
            torch.testing.assert_close(k_loss[0], p_loss[0], rtol=2e-5, atol=0)
            torch.testing.assert_close(k_loss, p_loss, rtol=5e-3, atol=1e-5)
            w_err = 0.0
            for i, (a, b) in enumerate(zip(mlp_weights(k_mlp), mlp_weights(p_mlp))):
                check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
                      f"weight tensor {i}: non-finite entries differ")
                w_err = max(w_err, max_abs_err(a, b))
            check(w_err <= TRAIN_WEIGHT_ATOL,
                  f"train_dnn kernel vs plain, N={xn.shape[0]}, dropout {p}: max |Δweight| "
                  f"{w_err:.3e} after {steps} steps, bound {TRAIN_WEIGHT_ATOL:g}")
            l0 = float((k_loss[0] - p_loss[0]).abs())
            l_err = max_abs_err(k_loss, p_loss)
            err = max(err, w_err, l_err)
            print(f"[check] train_dnn kernel vs plain, N={xn.shape[0]} (ragged), {steps} steps, "
                  f"dropout {p}: |Δloss[0]| {l0:.3e} (rtol 2e-5), max |Δloss| {l_err:.3e} "
                  f"(rtol 5e-3 atol 1e-5), max |Δweight| {w_err:.3e} "
                  f"(≤ {TRAIN_WEIGHT_ATOL:g}): ok")
        a_mlp, a_loss, _ = train_dnn(mlp, xn, yn, seed, steps, dropout_p=0.2, **hp)
        b_mlp, b_loss, _ = train_dnn(mlp, xn, yn, seed, steps, dropout_p=0.2, **hp)
        same = torch.equal(a_loss, b_loss) and all(
            torch.equal(u, v) for u, v in zip(mlp_weights(a_mlp), mlp_weights(b_mlp)))
        check(same, f"two training-kernel runs with one seed differ at N={xn.shape[0]}")
    x_nan = x.clone()
    x_nan[17, 3] = float("nan")
    s_mlp, s_loss, _ = train_dnn(mlp, x_nan, y, seed, 5, dropout_p=0.2, skip_nonfinite=True,
                                 **hp)
    kept = all(torch.equal(u, v) for u, v in zip(mlp_weights(s_mlp), mlp_weights(mlp)))
    check(kept and bool(torch.isnan(s_loss).all()),
          "skip_nonfinite with a NaN row changed the weights")
    print("[check] train_dnn kernel: two runs bitwise equal; a NaN row with skip_nonfinite "
          "leaves the weights as they were: ok")
    return err


# phase 7's walk along a DNN stage of the pipeline: the kernel's own weights
# and Adam state are taken at WALK_POINTS evenly spaced steps, and WALK_STEPS
# steps of the kernel and of its float32 plain version are run from each
WALK_POINTS, WALK_STEPS = 4, 20


def nudged(mlp):
    """A copy of ``mlp`` with every weight one float32 ulp up."""
    from pinnfc_tpu_torch.ops.train_dnn import mlp_weights, mlp_with_weights

    return mlp_with_weights(mlp, [torch.nextafter(w, torch.full_like(w, float("inf")))
                                  for w in mlp_weights(mlp)])


def weight_gap(a_mlp, b_mlp) -> float:
    from pinnfc_tpu_torch.ops.train_dnn import mlp_weights

    return max(max_abs_err(a, b) for a, b in zip(mlp_weights(a_mlp), mlp_weights(b_mlp)))


def tenths(losses) -> list:
    """The medians of a loss trace's ten tenths, to four places."""
    return [round(float(np.median(c)), 4) for c in np.array_split(np.asarray(losses), 10)]


def parted(a, b, scale: float) -> int:
    """The first step at which two loss traces differ by more than 1e-2 of
    ``scale``; their length where they never do."""
    far = np.flatnonzero(np.abs(np.asarray(a) - np.asarray(b)) > 1e-2 * scale)
    return int(far[0]) if far.size else len(a)


def walk_dnn_stage(name: str, mlp, ds, stage, seed: int, dropout_p: float, losses):
    """Phase 7's check of one DNN stage of the pipeline, from its start
    weights ``mlp``: the training kernel in WALK_POINTS chunks takes the
    pipeline's steps bitwise, and from its own weights and Adam state at the
    start of each chunk, WALK_STEPS steps of the kernel end with weights
    within max(TRAIN_WEIGHT_ATOL, 4 × the float32 plain version's drift from
    a one-ulp nudged start over the same steps) of the plain version's, and
    losses within 5e-3 of its largest |loss| + 1e-5.  Over the whole stage
    the plain version and its nudged twin are run beside the kernel: rounding
    alone parts two float32-accurate runs, so the twin's largest tenth-median
    gap from the plain version must reach a quarter of the kernel's.
    Returns (the kernel's trained MLP, the readings)."""
    from pinnfc_tpu_torch.ops.train_dnn import train_dnn, train_dnn_stage_plain

    x, y, n = ds.x_train, ds.y_train, stage.n_iter
    hp = dict(lr=stage.lr, lr_step=stage.lr_step, lr_gamma=stage.lr_gamma, dropout_p=dropout_p)
    chunk = -(-n // WALK_POINTS)
    cur, state, parts, points = mlp, None, [], []
    for t in range(0, n, chunk):
        k_mlp, k_loss, _ = train_dnn(cur, x, y, seed, WALK_STEPS, t0=t, state=state, **hp)
        p_mlp, p_loss, _ = train_dnn_stage_plain(cur, x, y, seed, WALK_STEPS, t0=t,
                                                 state=state, **hp)
        u_mlp = train_dnn_stage_plain(nudged(cur), x, y, seed, WALK_STEPS, t0=t, state=state,
                                      **hp).mlp
        w_err, w_ulp = weight_gap(k_mlp, p_mlp), weight_gap(u_mlp, p_mlp)
        l_err = max_abs_err(k_loss, p_loss)
        w_bound = max(TRAIN_WEIGHT_ATOL, 4 * w_ulp)
        l_bound = 5e-3 * float(p_loss.abs().max()) + 1e-5
        check(bool(torch.isfinite(k_loss).all()) and w_err <= w_bound and l_err <= l_bound,
              f"stage {name}, {WALK_STEPS} steps from the kernel's step {t}: kernel vs plain "
              f"max |Δweight| {w_err:.3e} (bound {w_bound:.3e}; the nudged start's "
              f"{w_ulp:.3e}), max |Δloss| {l_err:.3e} (bound {l_bound:.3e})")
        points.append({"step": t, "weight": w_err, "weight_nudged": w_ulp, "loss": l_err})
        cur, part, state = train_dnn(cur, x, y, seed, min(chunk, n - t), t0=t, state=state,
                                     **hp)
        parts.append(part)
    check(np.array_equal(torch.cat(parts).cpu().numpy(), losses),
          f"stage {name}: the kernel in {WALK_POINTS} chunks does not take the pipeline's steps")
    plain = train_dnn_stage_plain(mlp, x, y, seed, n, **hp).losses.cpu().numpy()
    twin = train_dnn_stage_plain(nudged(mlp), x, y, seed, n, **hp).losses.cpu().numpy()
    scale = float(np.median(np.abs(plain[:max(1, n // 10)])))
    tk, tp, tu = tenths(losses), tenths(plain), tenths(twin)
    gap_k = max(abs(a - b) for a, b in zip(tk, tp))
    gap_u = max(abs(a - b) for a, b in zip(tu, tp))
    out = {"points": points, "parted_kernel": parted(losses, plain, scale),
           "parted_nudged": parted(twin, plain, scale), "tenth_gap_kernel": gap_k,
           "tenth_gap_nudged": gap_u, "plain_tenths": tp, "nudged_tenths": tu}
    check(gap_u >= gap_k / 4,
          f"stage {name}: the kernel's tenth medians part from the plain version's by "
          f"{gap_k:.4f}, its nudged twin's by only {gap_u:.4f}: more than rounding parts them")
    w_errs = ", ".join(f"{p['weight']:.3e} (nudged {p['weight_nudged']:.3e})" for p in points)
    l_errs = ", ".join(f"{p['loss']:.3e}" for p in points)
    print(f"[check] train stage {name}: the kernel in {WALK_POINTS} chunks takes the "
          f"pipeline's steps bitwise; {WALK_STEPS} steps from its weights and Adam state at "
          f"steps {[p['step'] for p in points]} against the float32 plain version: max "
          f"|Δweight| {w_errs}, max |Δloss| {l_errs}: ok")
    print(f"[check] train stage {name}, whole: the kernel and the plain version part (|Δloss| "
          f"> 1e-2 of {scale:.4f}) at step {out['parted_kernel']}, the plain version and its "
          f"nudged twin at step {out['parted_nudged']}; largest tenth-median gap from the "
          f"plain version {gap_k:.4f} (kernel), {gap_u:.4f} (nudged twin, at least a quarter "
          f"of it): ok; plain tenths {tp}, nudged {tu}")
    return cur, out

def run_training_slice():
    """Phase 7: the training path at flagship width on the default campaign,
    the schedule scaled by 0.1; returns (result, launches)."""
    from pinnfc_tpu_torch.cli._common import _train_config
    from pinnfc_tpu_torch.config import train_config_to_dict
    from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.pipeline.score import run_scoring_pipeline
    from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _train_config(argparse.Namespace(small=False, seed=42, steps_scale=0.1,
                                           precision=None, skip_nonfinite=False))
    steps = [s.n_iter for s in cfg.schedule]
    check(steps == [400, 400, 400, 800, 1000, 800, 800], f"scaled schedule {steps}")
    torch.cuda.synchronize()
    build.reset_launches()
    res = run_training_pipeline(cfg, n_normal=6000, n_fault=800, verbose=True, device="cuda")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check(launches["train_dnn"] == 2 and launches["mc_dropout"] == 1
          and launches["residuals"] >= 1, f"training path launches {launches}")
    # the DNN stages as phase 21 reads them (``falls``): after about a hundred
    # steps at lr 0.01 the loss wanders between about -1.7 and +0.8, so the
    # first stage must fall by the median of the rest, the later one stay
    # below the untrained level (the first stage's first-tenth median); the
    # walk below holds each stage's steps against the plain version
    untrained = None
    for name, losses in res.log.stages:
        check(np.isfinite(losses).all(), f"non-finite losses in stage {name}")
        if name.endswith(":dnn"):
            first, rest, fell = falls(losses)
            print(f"[slice] train stage {name}: loss median {first:.4f} over its first "
                  f"tenth, {rest:.4f} over the rest; by tenths {tenths(losses)}")
            if untrained is None:
                untrained = first
                check(fell, f"stage {name} loss did not fall: median {first} over its first "
                            f"tenth, {rest} over the rest")
            else:
                check(rest < untrained, f"stage {name} loss median {rest} after its first "
                                        f"tenth is not below the untrained {untrained}")
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.training.stages import dnn_stage_seed

    mlp = init_pinn(cfg.model.layers, generator=torch.Generator().manual_seed(cfg.seed),
                    device="cuda")["mlp"]
    stage_losses = dict(res.log.stages)
    t0 = time.perf_counter()
    for k, stage in enumerate(cfg.schedule):
        if stage.name == "dnn":
            mlp, _ = walk_dnn_stage(f"{k}:dnn", mlp, res.dataset, stage,
                                    dnn_stage_seed(cfg.seed, k), cfg.model.dropout_p,
                                    stage_losses[f"{k}:dnn"])
    print(f"[slice] train: the DNN stages walked in {time.perf_counter() - t0:.1f} s")
    for g, (lo, hi) in LAMBDA_BOUNDS.items():
        lam = res.params[g].cpu().numpy()
        check(((lam >= lo) & (lam <= hi)).all(), f"{g} = {lam} outside its bounds")
    arr = res.results.array
    check_artifact(arr, res.params, res.dataset, res.metrics, 15600)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "trained")
        save_checkpoint(ckpt, res.params, res.dataset.scaler_x, res.dataset.scaler_y,
                        meta={"config": train_config_to_dict(cfg), "n_normal": 6000,
                              "n_fault": 800, "metrics": res.metrics})
        build.reset_launches()
        scored = run_scoring_pipeline(ckpt, device="cuda").results.array
    check(np.array_equal(scored, arr, equal_nan=True),
          "scoring the written checkpoint does not reproduce the train-time artifact")
    print(f"[slice] train: launches {launches}, timings {json.dumps(res.timings)}")
    print(f"[slice] train per stage (s): "
          f"{json.dumps({n: round(t, 4) for n, t in res.log.seconds})}")
    print(f"[slice] train final losses {json.dumps(res.log.final_losses())}; the artifact "
          "passes the plain-function checks and equals the one scored from the checkpoint")
    return res, launches


def time_training(mlp, params, ds):
    """Phase 8: per-step times and device launches at the training path's shapes."""
    from pinnfc_tpu_torch.ops.train_dnn import train_dnn, train_dnn_stage_plain
    from pinnfc_tpu_torch.training.stages import train_lambda_v_stage, train_residual_stage

    x, y = ds.x_train, ds.y_train
    steps = 200
    kernel_ms = cuda_ms(lambda: train_dnn(mlp, x, y, 7, steps), repeats=3) / steps
    # a chunk of a stage: from step 200 with the Adam state carried in
    _, _, carried = train_dnn(mlp, x, y, 7, 10)
    chunk_ms = cuda_ms(lambda: train_dnn(mlp, x, y, 7, steps, t0=200, state=carried),
                       repeats=3) / steps
    plain_ms = cuda_ms(lambda: train_dnn_stage_plain(mlp, x, y, 7, 20), repeats=2) / 20
    breakdown, traced, per_step = kernel_breakdown(lambda: train_dnn(mlp, x, y, 7, 50), 50)
    with torch.no_grad():
        u_pred = mlp(x)[0]
    lam_kinds = {
        "lambda_v(dnn_para=False)": lambda: train_lambda_v_stage(
            params["lam_v"], x, y, u_pred, ds.scaler_x, ds.scaler_y, steps, dnn_para=False),
        "lambda_v(dnn_para=True)": lambda: train_lambda_v_stage(
            params["lam_v"], x, y, u_pred, ds.scaler_x, ds.scaler_y, steps, dnn_para=True),
        "thermal": lambda: train_residual_stage(params["lam_t"], x, ds.scaler_x, "lam_t",
                                                steps, 1.0),
        "hydrogen": lambda: train_residual_stage(params["lam_h"], x, ds.scaler_x, "lam_h",
                                                 steps, 0.1, lr_gamma=0.9),
        "oxygen": lambda: train_residual_stage(params["lam_o"], x, ds.scaler_x, "lam_o",
                                               steps, 0.01, lr_gamma=0.9),
    }
    lam_ms = {}
    for name, fn in lam_kinds.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn().losses.cpu()
        lam_ms[name] = (time.perf_counter() - t0) / steps * 1e3
    print(f"[time] train_dnn kernel {kernel_ms:.4f} ms/step (median of 3 {steps}-step stages, "
          f"N={x.shape[0]}); as a chunk from step 200 with carried Adam state {chunk_ms:.4f} "
          f"ms/step; plain {plain_ms:.4f} ms/step; profiler trace of a 50-step stage: "
          f"{per_step} device launches per step, launches {json.dumps(traced)}, "
          f"per-kernel device ms/step {json.dumps(breakdown)}")
    print(f"[time] λ stages, plain PyTorch on the card, host clock, ms/step: "
          f"{json.dumps({k: round(v, 4) for k, v in lam_ms.items()})}")
    return kernel_ms, chunk_ms, plain_ms, per_step, traced, breakdown, lam_ms


# the kernels of csrc/train_dnn.cu: launched every step (the 3xTF32 form's,
# the bf16 form's), and once per stage
STEP_KERNELS = ("fwd_bwd_kernel", "wgrad_kernel", "finalize_kernel", "adam_kernel")
BF16_STEP_KERNELS = ("bf16_weights_kernel", "fwd_bwd_bf16_kernel", "wgrad_bf16_kernel",
                     "finalize_kernel", "adam_kernel")
STAGE_KERNELS = ("transpose_kernel",)
TRAIN_KERNELS = tuple(dict.fromkeys(STEP_KERNELS + BF16_STEP_KERNELS + STAGE_KERNELS))


# the kernels of csrc/mc_dropout.cu
MC_KERNELS = ("mc_sample_kernel", "mc_base_kernel")


def sass_hmma(lib) -> dict:
    """Tensor-core instructions in the SASS of each function of
    csrc/train_dnn.cu and csrc/mc_dropout.cu in the built library, counted
    from ``cuobjdump -sass``: HMMA (mma.sync) under ``<name>``, the bf16 ones
    also under ``<name>.bf16``, HGMMA (wgmma) under ``<name>.hgmma``."""
    from pinnfc_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stdout[-2000:]}")
    counts, current = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = next((k for k in TRAIN_KERNELS + MC_KERNELS if k in line), None)
            if current:
                for key in (current, current + ".bf16", current + ".hgmma"):
                    counts.setdefault(key, 0)
        elif current and "HGMMA" in line:
            counts[current + ".hgmma"] += 1
        elif current and "HMMA" in line:
            counts[current] += 1
            counts[current + ".bf16"] += "BF16" in line
    return counts


def kernel_breakdown(fn, steps: int, required=STEP_KERNELS + STAGE_KERNELS,
                     step_kernels=STEP_KERNELS):
    """From a torch.profiler trace of ``fn``, one ``steps``-step stage: device
    ms per step of each kernel of csrc/train_dnn.cu, the launches of each (and
    the trace's device memsets, the wrapper's and torch's), and the device
    launches per step of ``step_kernels`` (a form's kernels of a step).
    Fails if a kernel of ``required`` shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, launches = {}, {"memset": 0}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.key.startswith("Memset"):
            launches["memset"] += ev.count
        name = next((k for k in TRAIN_KERNELS if k in ev.key), None)
        if name and dev_us:
            ms[name] = ms.get(name, 0.0) + dev_us / steps / 1e3
            launches[name] = launches.get(name, 0) + ev.count
    missing = [k for k in required if k not in ms]
    check(not missing, f"the profiler trace shows no device time for {missing}")
    per_step = sum(launches[k] for k in step_kernels) / steps
    return ms, launches, per_step


REPO = os.path.dirname(os.path.abspath(__file__))
# runs the port's command line in a fresh process and prints its launch counts
CLI_RUNNER = (
    "import json, sys\n"
    "from pinnfc_tpu_torch.cli import main\n"
    "from pinnfc_tpu_torch.ops import build\n"
    "build.reset_launches()\n"
    "rc = main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps(build.LAUNCHES))\n"
    "sys.exit(rc)\n"
)


def run_cli(*argv: str, timeout: int = 600):
    """``python -m pinnfc_tpu_torch.cli <argv>`` in a subprocess: (its standard
    output, the launch counts of its run, its wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, *argv], cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli {argv[0]} exited {proc.returncode}:\n{proc.stdout[-4000:]}")
    counts = [ln for ln in proc.stdout.splitlines() if ln.startswith("LAUNCHES ")]
    check(len(counts) == 1, f"cli {argv[0]} printed no launch counts")
    return proc.stdout, json.loads(counts[0][len("LAUNCHES "):]), wall


# runs several of the port's commands in one fresh process: each command's
# output followed by "RC <exit code>", then the launch counts of the process
CLI_MANY_RUNNER = (
    "import json, sys\n"
    "from pinnfc_tpu_torch.cli import main\n"
    "from pinnfc_tpu_torch.ops import build\n"
    "build.reset_launches()\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    rc = main(argv)\n"
    "    sys.stdout.flush()\n"
    "    print(f'RC {rc}', flush=True)\n"
    "print('LAUNCHES ' + json.dumps(build.LAUNCHES))\n"
)


def run_cli_many(*argvs, timeout: int = 600):
    """Each argv through the port's ``main`` in one subprocess: ([(output,
    exit code)] per command, the launch counts of the process, its standard
    error, its wall seconds)."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_MANY_RUNNER, json.dumps(list(argvs))],
                          cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the cli process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    body, _, counts = proc.stdout.rpartition("LAUNCHES ")
    parts = re.split(r"^RC (-?\d+)\n", body, flags=re.M)
    runs = list(zip(parts[0:-1:2], (int(rc) for rc in parts[1::2])))
    check(len(runs) == len(argvs), f"{len(runs)} exit codes for {len(argvs)} commands")
    return runs, json.loads(counts), proc.stderr, wall


def run_campaign_slice(dev, keep_dir):
    """Phase 9: ``cli synth`` writes the default campaign as .mat files;
    ``cli train`` trains on them (schedule × 0.1, mid-stage snapshots every 100
    steps, all three reports); ``cli score`` scores them from the checkpoint,
    whose .mat file and checkpoint are copied into ``keep_dir`` for phases
    13-15.  Returns the
    launch counts of the train and score runs."""
    import re

    from pinnfc_tpu_torch.data.campaign import CampaignConfig, load_campaign_dataset
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint, load_params_npz
    from pinnfc_tpu_torch.utils.tbevents import read_events

    with tempfile.TemporaryDirectory() as tmp:
        camp, ck = os.path.join(tmp, "campaign"), os.path.join(tmp, "ck")
        mats = {k: os.path.join(tmp, f"{k}.mat") for k in ("train", "score")}
        jsonl, tb, prof = (os.path.join(tmp, n) for n in ("m.jsonl", "tb", "prof"))
        _, _, synth_s = run_cli("synth", "--out-dir", camp)
        files = sorted(os.listdir(camp))
        check(len(files) == 13 and "Polar-1.mat" in files, f"synth wrote {files}")
        flags = ["--normal-mat", os.path.join(camp, "Polar-1.mat"), "--fault-dir", camp]
        out, train_l, train_wall = run_cli(
            "train", *flags, "--steps-scale", "0.1", "--resume-dir", os.path.join(tmp, "rd"),
            "--ckpt-every", "100", "--ckpt", ck, "--mat-out", mats["train"],
            "--metrics-jsonl", jsonl, "--tensorboard-dir", tb, "--profile-dir", prof)
        rows = re.search(r"campaign: (\d+) normal rows \+ (\d+) fault segments \((\d+) rows\)",
                         out)
        check(rows is not None and tuple(map(int, rows.groups())) == (6000, 12, 9600),
              f"campaign rows {rows and rows.groups()}")
        stage_s = {f"{k}:{n}": float(t) for k, n, t in re.findall(
            r"stage (\d+) \[(\w+)\s*\].*\(([\d.]+) s\)", out)}
        check(len(stage_s) == 7, f"per-stage seconds {stage_s}")
        # the DNN stages run in chunks of 100 steps: 4 + 8 kernel launches
        check(train_l["train_dnn"] == 12 and train_l["mc_dropout"] == 1
              and train_l["residuals"] >= 1, f"cli train launches {train_l}")
        report = [json.loads(ln) for ln in open(jsonl)]
        check([r["event"] for r in report] == ["stage"] * 7 + ["final"],
              f"metrics JSONL events {[r['event'] for r in report]}")
        timings = {k: report[-1][k] for k in ("data_s", "train_s", "export_s")}
        events = [e for f in os.listdir(tb) for e in read_events(os.path.join(tb, f))]
        n_steps = sum(r["n_iter"] for r in report[:-1])
        check(n_steps == 4600 and sum(e.tag.startswith("loss/") for e in events) == n_steps,
              f"event file: {len(events)} events for {n_steps} steps")
        traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json.gz")]
        check(len(traces) == 1, f"profile directory holds {os.listdir(prof)}")
        trace_mb = os.path.getsize(os.path.join(prof, traces[0])) / 2**20
        snap = load_params_npz(os.path.join(tmp, "rd", "schedule_ckpt.npz"))
        check((int(snap["stage"]), int(snap["step"])) == (6, 800), "last snapshot")
        with open(ck + ".meta.json") as f:
            meta = json.load(f)
        check(meta["campaign"] == {"normal_mat": flags[1], "fault_dir": camp}
              and "framework_version" in meta, f"sidecar {sorted(meta)}")

        _, score_l, score_wall = run_cli("score", "--ckpt", ck, *flags, "--mat-out",
                                         mats["score"])
        check(score_l["mc_dropout"] == 1 and score_l["residuals"] >= 1 and
              score_l["train_dnn"] == 0, f"cli score launches {score_l}")
        arr, scored = (load_comprehensive_results(mats[k]).array for k in ("train", "score"))
        check(np.array_equal(scored, arr, equal_nan=True),
              "cli score on the campaign does not reproduce the train-time artifact")
        shutil.copy(mats["score"], os.path.join(keep_dir, "F01_scored.mat"))
        # for phase 19: the campaign and the train-time artifact
        shutil.copy(mats["train"], os.path.join(keep_dir, "F01_train.mat"))
        shutil.copytree(camp, os.path.join(keep_dir, "campaign"))
        for ext in (".npz", ".meta.json"):
            shutil.copy(ck + ext, os.path.join(keep_dir, "ck" + ext))
        trained = load_checkpoint(ck, device=dev)
        ds = load_campaign_dataset(CampaignConfig.from_dir(flags[1], camp),
                                   scalers=(trained["scaler_x"], trained["scaler_y"]),
                                   device=dev)
        metrics = {k: v for k, v in report[-1].items() if k not in
                   ("step", "time", "event", *timings) and isinstance(v, float)}
        check_artifact(arr, trained["params"], ds, metrics, 15600)
    print(f"[slice] campaign: synth {synth_s:.1f} s; cli train on 6000 normal + 12 x 800 fault "
          f"rows (wall {train_wall:.1f} s, torch.profiler on): launches {json.dumps(train_l)}, "
          f"timings {json.dumps(timings)}; per stage (s) {json.dumps(stage_s)}; "
          f"{len(report)} JSONL rows, {len(events)} events, gzipped trace {trace_mb:.1f} MiB")
    print(f"[slice] campaign: cli score (wall {score_wall:.1f} s): launches {json.dumps(score_l)}; "
          "its artifact equals the train-time one column for column and passes the "
          "plain-function checks")
    return {"train": train_l, "score": score_l}


def check_kill_and_resume(train_ds) -> None:
    """Phase 10: the default dnn and lambda_v stages at 0.05 of their steps
    (200 each) on the training path's rows, in chunks of 70 (dividing
    neither): the chunked run equals the unchunked one, and a run killed after
    its 2nd snapshot (DNN stage, step 140) or its 5th (λ stage, step 140) and
    restarted, with ckpt_every or without, equals the uninterrupted chunked
    run, bit for bit."""
    import dataclasses

    from pinnfc_tpu_torch.config import default_schedule
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.training.stages import run_schedule
    from pinnfc_tpu_torch.utils import checkpoint
    from pinnfc_tpu_torch.utils.jax_params import params_to_numpy

    sched = tuple(dataclasses.replace(s, n_iter=int(s.n_iter * 0.05))
                  for s in default_schedule()[:2])
    check([s.n_iter for s in sched] == [200, 200], f"two-stage schedule {sched}")
    args = (train_ds.x_train, train_ds.y_train, train_ds.scaler_x, train_ds.scaler_y)

    def fresh():
        return init_pinn(generator=torch.Generator().manual_seed(42),
                         device=train_ds.x_train.device)

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in leaves(tree[k])]
        if isinstance(tree, list):
            return [v for t in tree for v in leaves(t)]
        return [tree]

    def same(a, b):
        """(params, log) pairs: every weight and λ, and every loss trace, bitwise."""
        pa, pb = leaves(params_to_numpy(a[0])), leaves(params_to_numpy(b[0]))
        return (all(np.array_equal(u, v) for u, v in zip(pa, pb))
                and [n for n, _ in a[1].stages] == [n for n, _ in b[1].stages]
                and all(np.array_equal(u, v) for (_, u), (_, v) in zip(a[1].stages, b[1].stages)))

    with tempfile.TemporaryDirectory() as tmp:
        full = run_schedule(fresh(), *args, schedule=sched, seed=9,
                            checkpoint_dir=os.path.join(tmp, "full"), ckpt_every=70)
        whole = run_schedule(fresh(), *args, schedule=sched, seed=9)
        check(same(full, whole), "the chunked run differs from the unchunked one")
        real = checkpoint.save_params_npz
        for kill_after, every in ((2, 70), (5, 70), (2, None)):
            ck = os.path.join(tmp, f"killed_{kill_after}_{every}")
            calls = [0]

            def killing_save(payload, path):
                real(payload, path)
                calls[0] += 1
                if calls[0] == kill_after:
                    raise KeyboardInterrupt("simulated preemption")

            checkpoint.save_params_npz = killing_save
            try:
                run_schedule(fresh(), *args, schedule=sched, seed=9, checkpoint_dir=ck,
                             ckpt_every=70)
                fail("the simulated preemption did not happen")
            except KeyboardInterrupt:
                pass
            finally:
                checkpoint.save_params_npz = real
            snap = checkpoint.load_params_npz(os.path.join(ck, "schedule_ckpt.npz"))
            where = (int(snap["stage"]), int(snap["step"]))
            check(where == ((0, 140) if kill_after == 2 else (1, 140)), f"killed at {where}")
            resumed = run_schedule(fresh(), *args, schedule=sched, seed=9, checkpoint_dir=ck,
                                   ckpt_every=every)
            stitched = (full[0], type(full[1])(stages=full[1].stages[where[0]:]))
            check(same(resumed, stitched),
                  f"resumed at stage {where[0]} step {where[1]} (ckpt_every {every}): differs "
                  "from the uninterrupted chunked run")
    print("[check] kill and resume on the card (dnn and lambda_v, 200 steps each, chunks of "
          "70): chunked = unchunked, and killed after chunk 2 (DNN stage, step 140) or 5 (λ "
          "stage, step 140) then resumed, with ckpt_every or without, = the uninterrupted "
          "chunked run, params and stitched losses bitwise: ok")


# Phase 11's topology.  No config, checkpoint or command-line flag of either
# package builds it: it stands for a caller of ``ModelConfig.layers``, which
# the JAX package trains and scores for any topology, taken as the flagship
# with one more hidden layer at its width.
NON_FLAGSHIP = (8, 256, 256, 256, 256, 1)


def run_non_flagship_slice(dev, train_ds):
    """Phase 11: train, export and re-score a four-hidden-layer model at
    flagship width on the card; returns what it prints as one dict."""
    import dataclasses

    from pinnfc_tpu_torch.cli._common import _train_config
    from pinnfc_tpu_torch.config import train_config_to_dict
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.ops.train_dnn import mlp_weights
    from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
    from pinnfc_tpu_torch.training.stages import train_dnn_chunk, train_dnn_stage
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _train_config(argparse.Namespace(small=False, seed=42, steps_scale=0.1,
                                           precision=None, skip_nonfinite=False))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, layers=NON_FLAGSHIP))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    res = run_training_pipeline(cfg, n_normal=6000, n_fault=800, device="cuda")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches["train_dnn"] == 0 and launches["mc_dropout"] == 0
          and launches["residuals"] >= 1, f"non-flagship training path launches {launches}")
    check(res.export == {"sampler": "vmap", "mc_passes": 2016},
          f"non-flagship export {res.export}")
    check(res.params["mlp"].layers == NON_FLAGSHIP, f"layers {res.params['mlp'].layers}")
    for name, losses in res.log.stages:
        check(np.isfinite(losses).all(), f"non-finite losses in stage {name}")
    arr = res.results.array
    check_artifact(arr, res.params, res.dataset, res.metrics, 15600)

    with tempfile.TemporaryDirectory() as tmp:
        ck, mat = os.path.join(tmp, "deep"), os.path.join(tmp, "scored.mat")
        save_checkpoint(ck, res.params, res.dataset.scaler_x, res.dataset.scaler_y,
                        meta={"config": train_config_to_dict(cfg), "n_normal": 6000,
                              "n_fault": 800, "metrics": res.metrics})
        out, score_l, score_wall = run_cli("score", "--ckpt", ck, "--mat-out", mat)
        check(score_l["mc_dropout"] == 0 and score_l["train_dnn"] == 0
              and score_l["residuals"] >= 1, f"cli score launches {score_l}")
        check('"sampler": "vmap"' in out and '"mc_passes": 2016' in out,
              "cli score did not report the vmap sampler's 2016 passes")
        scored = load_comprehensive_results(mat).array
    rescore_diff = 0.0
    if not np.array_equal(scored, arr, equal_nan=True):
        finite = np.isfinite(arr) & np.isfinite(scored)
        rescore_diff = float(np.max(np.abs(scored - arr)[finite]))
        print(f"[slice] non-flagship: cli score differs from the train-time artifact by at "
              f"most {rescore_diff:.3e}; held to rtol 1e-6")
        np.testing.assert_allclose(scored, arr, rtol=1e-6, atol=0, equal_nan=True)

    x, y = train_ds.x_train, train_ds.y_train
    mlp = init_pinn(NON_FLAGSHIP, generator=torch.Generator().manual_seed(3), device=dev)["mlp"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = train_dnn_stage(mlp, x, y, 17, 200)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) / 200 * 1e3
    piece, state, parts, start = mlp, None, [], 0
    for m in (70, 70, 60):
        piece, state, losses = train_dnn_chunk(piece, state, x, y, 17, start, m)
        parts.append(losses)
        start += m
    same = torch.equal(torch.cat(parts), whole.losses) and all(
        torch.equal(u, v) for u, v in zip(mlp_weights(piece), mlp_weights(whole.params)))
    check(same, "the autograd stage in chunks of 70 differs from the whole 200-step stage")
    check(build.LAUNCHES["train_dnn"] == 0, "the autograd stage launched the training kernel")
    info = {"layers": list(NON_FLAGSHIP), "sampler": res.export["sampler"],
            "mc_passes": res.export["mc_passes"], "launches": launches,
            "cli_score_launches": score_l, "timings": res.timings,
            "peak_allocated_gib": peak_gib, "cli_score_wall_s": score_wall,
            "rescore_max_abs_diff": rescore_diff, "autograd_stage_ms_per_step": stage_ms}
    print(f"[slice] non-flagship {NON_FLAGSHIP}: sampler {info['sampler']}, "
          f"{info['mc_passes']} passes, launches {json.dumps(launches)}, timings "
          f"{json.dumps(res.timings)}, peak torch.cuda.max_memory_allocated {peak_gib:.3f} GiB")
    print(f"[slice] non-flagship per stage (s): "
          f"{json.dumps({n: round(t, 4) for n, t in res.log.seconds})}")
    print(f"[slice] non-flagship: cli score (wall {score_wall:.1f} s, launches "
          f"{json.dumps(score_l)}) {'equals' if not rescore_diff else 'matches'} the "
          f"train-time artifact; the autograd stage at N={x.shape[0]}: {stage_ms:.4f} ms/step "
          "(host clock, 200 steps), in chunks of 70 bitwise equal to the whole stage: ok")
    return info


def run_risk_slice(results):
    """Phase 12: the risk function of script 04 on phase 7's artifact, the
    torch backend on the card against the float64 numpy backend, and ``cli
    risk`` with each; returns what it prints as one dict."""
    from pinnfc_tpu_torch.config import DEFAULT_RF_CONDITIONS, RiskConfig
    from pinnfc_tpu_torch.data.contract import ComprehensiveResults, save_comprehensive_results
    from pinnfc_tpu_torch.risk import (
        compute_rf_time_series, condition_row_indices, estimate_mu_sigma_normal,
        run_risk_pipeline)

    arr = results.array
    run_risk_pipeline(results, backend="torch", device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = run_risk_pipeline(results, backend="torch", device="cuda")
    torch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_host = run_risk_pipeline(results, backend="numpy")
    numpy_s = time.perf_counter() - t0
    check(len(on_card) == len(on_host) == 12, f"conditions {len(on_card)}, {len(on_host)}")
    for a, b in zip(on_card, on_host):
        keys = ("fault_name", "current_target", "n_samples", "idx_v_alarm", "idx_rf_alarm",
                "advance")
        ta, tb = (tuple(getattr(c, k) for k in keys) for c in (a, b))
        check(ta == tb, f"risk tables differ: torch on the card {ta}, numpy {tb}")
    cfg = RiskConfig()
    mu, sigma = estimate_mu_sigma_normal(arr)
    tol = {"s_tot": (1e-4, 1e-5), "c": (1e-3, 1e-3), "rf_inst": (1e-3, 1e-4),
           "rf_smooth": (1e-3, 1e-4)}
    worst = {k: 0.0 for k in tol}
    for current, fault, index_range in DEFAULT_RF_CONDITIONS:
        rows = condition_row_indices(arr, fault, current, cfg, index_range)
        r = ComprehensiveResults(arr[rows]).residual_matrix(cfg.res_keys)
        got = compute_rf_time_series(r, mu, sigma, cfg, backend="torch", device="cuda")
        want = compute_rf_time_series(r, mu, sigma, cfg, backend="numpy")
        for key, (rtol, atol) in tol.items():
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f"{current} {fault} {key}")
            finite = np.isfinite(want[key])
            worst[key] = max(worst[key], float(np.max(np.abs(got[key] - want[key])[finite]))
                             if finite.any() else 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        mat = os.path.join(tmp, "F01_output.mat")
        save_comprehensive_results(results, mat)
        card_out, card_l, card_wall = run_cli("risk", "--mat", mat, "--device", "cuda")
        host_out, _, host_wall = run_cli("risk", "--mat", mat, "--backend", "numpy")
    check(card_out == host_out, f"cli risk tables differ:\n{card_out}\n{host_out}")
    check(sum(card_l.values()) == 0, f"cli risk launched a kernel: {card_l}")
    table = [ln for ln in card_out.splitlines() if not ln.startswith("LAUNCHES ")]
    check(len(table) == 13, f"cli risk printed {len(table)} lines")
    fired = sum(a.idx_rf_alarm is not None for a in on_card)
    print("[slice] risk table of phase 7's artifact (cli risk on the card = --backend numpy):")
    print("\n".join(table))
    print(f"[slice] risk: run_risk_pipeline torch on the card {torch_s:.4f} s, numpy float64 "
          f"{numpy_s:.4f} s (host clock, 12 conditions, {fired} RF alarms); alarm tables "
          f"identical; max |Δ| torch vs numpy {json.dumps(worst)}; cli risk walls "
          f"{card_wall:.1f} s (cuda), {host_wall:.1f} s (numpy): ok")
    return {"torch_s": torch_s, "numpy_s": numpy_s, "rf_alarms": fired, "max_abs_diff": worst,
            "cli_wall_s": {"cuda": card_wall, "numpy": host_wall}}


def _synced(fn):
    """(fn's result, its host seconds between two synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def _auc_newton_iters(arr, cfg, dev):
    """The Newton iterations of each feature group's fit in
    ``run_auc_pipeline`` (the same split and fit, which it does not return)."""
    from pinnfc_tpu_torch.diagnosis import (
        build_label_mapper, extract_X_y, logreg_fit, parse_features, parse_group_spec)
    from pinnfc_tpu_torch.diagnosis.splits import stratified_split

    label_map, names = build_label_mapper(parse_group_spec(cfg.group_spec))
    iters = {}
    for spec in cfg.feature_groups:
        x, y = extract_X_y(arr, parse_features(spec), label_map)
        x_tr, _, y_tr, _ = stratified_split(x, y, y=y, test_size=cfg.test_size,
                                            random_state=cfg.random_state)
        iters[spec] = logreg_fit(x_tr, y_tr, n_classes=len(names), balanced=cfg.balanced,
                                 device=dev).n_iter
    return iters


def _diagnosis_stage_seconds(arr, auc_cfg, gmm_cfg):
    """Host-clock seconds (synchronized) of each device stage of the two
    pipelines on the card, at the pipelines' shapes: the four Newton fits,
    the forest's build and its scoring, the k-means init and the EM from it."""
    from pinnfc_tpu_torch.diagnosis import (
        build_label_mapper, extract_X_y, gmm_fit, isoforest_fit, isoforest_score, kmeans_fit,
        parse_features, parse_group_spec)
    from pinnfc_tpu_torch.diagnosis.splits import stratified_split

    secs = {}
    _, secs["newton_fits"] = _synced(lambda: _auc_newton_iters(arr, auc_cfg, "cuda"))
    label_map, _ = build_label_mapper(parse_group_spec(auc_cfg.group_spec))
    x, y = extract_X_y(arr, parse_features(auc_cfg.feature_groups[0]), label_map)
    x_tr, x_te, y_tr, _ = stratified_split(x, y, y=y, test_size=auc_cfg.test_size,
                                           random_state=auc_cfg.random_state)
    forest, secs["forest_build"] = _synced(lambda: isoforest_fit(
        x_tr[y_tr == 0], torch.Generator().manual_seed(auc_cfg.random_state), device="cuda"))
    _, secs["forest_score"] = _synced(lambda: isoforest_score(forest, x_te))
    label_map, names = build_label_mapper(parse_group_spec(gmm_cfg.group_spec))
    x, y = extract_X_y(arr, parse_features(gmm_cfg.features), label_map)
    x_tr, _, _, _ = stratified_split(x, y, y=y, test_size=gmm_cfg.test_size,
                                     random_state=gmm_cfg.random_state)
    c = gmm_cfg.n_components_factor * len(names)
    km, secs["kmeans_init"] = _synced(lambda: kmeans_fit(
        x_tr, torch.Generator().manual_seed(gmm_cfg.random_state), c, max_iter=50,
        device="cuda"))
    resp = torch.nn.functional.one_hot(km.assignments, c)
    _, secs["em"] = _synced(lambda: gmm_fit(x_tr, None, c, init_resp=resp, device="cuda"))
    secs["gmm_train_rows"] = len(x_tr)
    return secs


def run_diagnosis_slice(results, score_mat):
    """Phase 13: the AUC stage of script 02 and the GMM stage of script 03 on
    phase 7's artifact, on the card and on the CPU with the same draws, then
    ``cli auc`` and ``cli gmm`` on the card over phase 9's ``cli score`` file;
    returns what it prints as one dict, and the GMM fit on the card."""
    import warnings

    from pinnfc_tpu_torch.config import AucConfig, GmmConfig
    from pinnfc_tpu_torch.diagnosis import run_auc_pipeline, run_gmm_pipeline

    arr = results.array
    auc_cfg, gmm_cfg = AucConfig(), GmmConfig()
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # group 4 is y_true, as script 02's
        run_auc_pipeline(arr, auc_cfg, device="cuda")  # warm-up: cuBLAS/cuSOLVER handles
        run_gmm_pipeline(arr, gmm_cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        t0 = time.perf_counter()
        auc_card = run_auc_pipeline(arr, auc_cfg, device="cuda")
        out["auc_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gmm_card = run_gmm_pipeline(arr, gmm_cfg, device="cuda")
        out["gmm_s"] = time.perf_counter() - t0
        out["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        t0 = time.perf_counter()
        auc_host = run_auc_pipeline(arr, auc_cfg, device="cpu")
        out["auc_cpu_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gmm_host = run_gmm_pipeline(arr, gmm_cfg, device="cpu")
        out["gmm_cpu_s"] = time.perf_counter() - t0
        out["newton_iters"] = _auc_newton_iters(arr, auc_cfg, "cuda")
        # float32 rounding differs between the devices, and the last Newton
        # steps are at its level: the counts are reported, not compared
        out["newton_iters_cpu"] = _auc_newton_iters(arr, auc_cfg, "cpu")
        out["stage_s"] = _diagnosis_stage_seconds(arr, auc_cfg, gmm_cfg)
    for a, b in zip(auc_card.groups, auc_host.groups):
        check(np.array_equal(a.confusion.sum(axis=1), b.confusion.sum(axis=1)),
              f"group {a.group_id}: the test rows differ between the card and the CPU")
        check(abs(a.auc - b.auc) <= 1e-4, f"group {a.group_id} AUC {a.auc} on the card, "
                                          f"{b.auc} on the CPU")
    check(abs(auc_card.iso_auc - auc_host.iso_auc) <= 1e-4,
          f"forest AUC {auc_card.iso_auc} on the card, {auc_host.iso_auc} on the CPU")
    n_te = int(auc_card.groups[0].confusion.sum())
    check(n_te == 14040, f"the AUC stage tests {n_te} rows, expected 14,040")
    check(np.array_equal(gmm_card.test_full_indices, gmm_host.test_full_indices)
          and np.array_equal(gmm_card.y_true, gmm_host.y_true),
          "the GMM split differs between the card and the CPU")
    check(abs(gmm_card.accuracy - gmm_host.accuracy) <= 0.005,
          f"GMM accuracy {gmm_card.accuracy} on the card, {gmm_host.accuracy} on the CPU")
    check(gmm_card.y_prob.shape == (len(gmm_card.y_true), 4)
          and np.allclose(gmm_card.y_prob.sum(axis=1), 1.0, atol=1e-9),
          "GMM y_prob rows do not sum to 1")
    model = gmm_card.model
    check(model.means.is_cuda and model.means.shape == (20, 4), "the mixture is not on the card")
    check(model.converged and model.n_iter <= gmm_cfg.max_iter,
          f"the EM did not converge: {model.n_iter} iterations")
    out.update({
        "auc": {g.features: g.auc for g in auc_card.groups}, "iso_auc": auc_card.iso_auc,
        "auc_cpu": {g.features: g.auc for g in auc_host.groups}, "iso_auc_cpu": auc_host.iso_auc,
        "accuracy": {g.features: g.accuracy for g in auc_card.groups},
        "gmm_accuracy": gmm_card.accuracy, "gmm_accuracy_cpu": gmm_host.accuracy,
        "em_iters": model.n_iter, "em_converged": model.converged,
        "em_iters_cpu": gmm_host.model.n_iter, "lower_bound": model.lower_bound,
        "gmm_test_rows": len(gmm_card.y_true)})
    auc_out, auc_l, out["cli_auc_wall_s"] = run_cli("auc", "--mat", score_mat)
    gmm_out, gmm_l, out["cli_gmm_wall_s"] = run_cli("gmm", "--mat", score_mat)
    check(sum(auc_l.values()) + sum(gmm_l.values()) == 0,
          f"cli auc/gmm launched a kernel: {auc_l}, {gmm_l}")
    tables = {}
    for name, text, head in (("auc", auc_out, "group 1 [epi,res]  AUC="),
                             ("gmm", gmm_out, "GMM 4-class accuracy: ")):
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith("LAUNCHES ") and "Warning" not in ln
                 and "warnings.warn" not in ln]
        check(any(ln.startswith(head) for ln in lines), f"cli {name} printed:\n{text}")
        tables[name] = lines
    print("[slice] cli auc on the card over phase 9's cli score file:")
    print("\n".join(tables["auc"]))
    print("[slice] cli gmm on the card over phase 9's cli score file:")
    print("\n".join(tables["gmm"]))
    print(f"[slice] diagnosis on the card: run_auc_pipeline {out['auc_s']:.3f} s, "
          f"run_gmm_pipeline {out['gmm_s']:.3f} s (host clock, warm), peak "
          f"{out['peak_gib']:.4f} GiB above what earlier phases hold; Newton iterations per group "
          f"{json.dumps(out['newton_iters'])} (on the CPU {json.dumps(out['newton_iters_cpu'])}); "
          f"EM {model.n_iter} iterations, converged "
          f"{model.converged}; by stage (s) {json.dumps(out['stage_s'])}; on the CPU {out['auc_cpu_s']:.3f} s and {out['gmm_cpu_s']:.3f} s; "
          f"group AUCs within 1e-4 of the CPU's, GMM accuracy {gmm_card.accuracy:.4f} against "
          f"{gmm_host.accuracy:.4f}: ok")
    return out, gmm_card


class _Recorder:
    """Wraps a module's function for one phase: counts its calls, sums its
    host seconds (synchronized) and keeps its first result; ``restore()``
    puts the function back.  The modules look these functions up at call
    time, so the main path runs through the wrapper unchanged."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.seconds, self.first = 0, 0.0, None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        result, seconds = _synced(lambda: self.orig(*args, **kwargs))
        self.seconds += seconds
        if self.calls == 0:
            self.first = result
        self.calls += 1
        return result

    def restore(self):
        setattr(self.module, self.name, self.orig)


def run_compare_slice(results, score_mat):
    """Phase 14: the six-method comparison of script 05 on phase 7's
    artifact, on the card and on the CPU with the same seed, the spectral
    eigenspace checked against ``eigh``, t-SNE on the test rows, then ``cli
    compare`` on the card over phase 9's ``cli score`` file; returns what it
    prints as one dict."""
    from pinnfc_tpu_torch.config import CompareConfig, GmmConfig
    from pinnfc_tpu_torch.diagnosis import (
        build_label_mapper, extract_X_y, parse_features, parse_group_spec, run_compare_pipeline,
        tsne_fit)
    from pinnfc_tpu_torch.diagnosis import spectral as spectral_mod
    from pinnfc_tpu_torch.diagnosis import svm as svm_mod
    from pinnfc_tpu_torch.diagnosis import ward as ward_mod
    from pinnfc_tpu_torch.diagnosis.compare import METHODS
    from pinnfc_tpu_torch.diagnosis.splits import stratified_split

    arr = results.array
    cfg, gmm_cfg = CompareConfig(), GmmConfig()
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    # warm-up of the cheap methods: cuBLAS/cuSOLVER handles, allocator
    run_compare_pipeline(arr, cfg, gmm_cfg, methods=["gmm", "logreg", "svm", "kmeans"],
                         device="cuda")
    card, out["all_six_s"] = _synced(lambda: run_compare_pipeline(arr, cfg, gmm_cfg,
                                                                  device="cuda"))
    recorders = [_Recorder(svm_mod, "lbfgs_minimize"), _Recorder(ward_mod, "_nn_chain_merges"),
                 _Recorder(ward_mod, "_replay_labels"),
                 _Recorder(spectral_mod, "_bottom_k_subspace")]
    try:
        out["method_s"], out["alone_equal"] = {}, {}
        for m in METHODS:
            one, out["method_s"][m] = _synced(lambda: run_compare_pipeline(
                arr, cfg, gmm_cfg, methods=[m], device="cuda"))
            out["alone_equal"][m] = bool(np.array_equal(
                one.methods[0].y_pred, card.methods[METHODS.index(m)].y_pred))
    finally:
        for r in recorders:
            r.restore()
    lbfgs_rec, chain_rec, replay_rec, sub_rec = recorders
    check(chain_rec.calls == replay_rec.calls == sub_rec.calls == 1,
          f"Ward ran {chain_rec.calls} NN-chains, spectral {sub_rec.calls} subspace "
          "iterations: the size rule did not pick the NN-chain and the subspace path")
    sol = lbfgs_rec.first
    out["svm_lbfgs_iters"] = sol.n_iter.tolist()
    out["svm_lbfgs_s"] = lbfgs_rec.seconds
    out["ward_chain_steps"] = chain_rec.first[3]
    out["ward_chain_s"] = chain_rec.seconds
    out["ward_replay_s"] = replay_rec.seconds
    basis, out["subspace_steps"] = sub_rec.first
    out["subspace_s"] = sub_rec.seconds

    # the same seed on the CPU, for every method but spectral
    host_methods = ["gmm", "logreg", "svm", "kmeans", "agglomerative"]
    host, out["cpu_five_s"] = _synced(lambda: run_compare_pipeline(
        arr, cfg, gmm_cfg, methods=host_methods, device="cpu"))
    check(np.array_equal(card.y_true, host.y_true), "y_true differs between the card and the CPU")
    n_te = len(card.y_true)
    check(n_te == 2400, f"the comparison tests {n_te} rows, expected 2,400")
    by_name = {m.name: m for m in card.methods}
    out["agree"], out["f1"], out["f1_cpu"] = {}, {}, {}
    for h in host.methods:
        c = by_name[h.name]
        out["agree"][h.name] = float((c.y_pred == h.y_pred).mean())
        out["f1"][h.name], out["f1_cpu"][h.name] = c.metrics["f1_macro"], h.metrics["f1_macro"]
        if h.name in ("Supervised_LR", "Supervised_SVM", "Agglomerative"):
            check(out["agree"][h.name] >= 0.995,
                  f"{h.name}: the card and the CPU agree on {out['agree'][h.name]:.4f} of rows")
        check(abs(c.metrics["f1_macro"] - h.metrics["f1_macro"]) <= 0.01,
              f"{h.name}: macro F1 {c.metrics['f1_macro']} on the card, "
              f"{h.metrics['f1_macro']} on the CPU")
    out["f1"]["Spectral"] = by_name["Spectral"].metrics["f1_macro"]
    out["metrics"] = card.summary_table()

    # spectral on the card: the subspace basis of the main path against eigh
    label_map, _ = build_label_mapper(parse_group_spec(gmm_cfg.group_spec))
    x, y = extract_X_y(arr, parse_features(gmm_cfg.features), label_map)
    x_tr, x_te, _, _ = stratified_split(x, y, y=y, test_size=cfg.test_size,
                                        random_state=cfg.random_state)
    check(len(x_tr) == 7200, f"the comparison trains on {len(x_tr)} rows, expected 7,200")
    _, lap, _ = spectral_mod.knn_laplacian(torch.as_tensor(x_tr, dtype=torch.float32,
                                                           device="cuda"), cfg.spectral_n_neighbors)
    (evals, evecs), out["eigh_s"] = _synced(lambda: torch.linalg.eigh(lap))
    k = cfg.spectral_clusters_factor * 4
    p_eigh = evecs[:, :k].double() @ evecs[:, :k].double().T
    p_sub = basis.double() @ basis.double().T
    out["projector_max_abs"] = float((p_sub - p_eigh).abs().max())
    out["eigenvalues_14_to_18"] = evals[k - 3:k + 2].tolist()
    out["zero_eigenvalues"] = int((evals.abs() < 1e-5).sum())
    check(out["projector_max_abs"] <= 1e-2,
          f"subspace and eigh bottom-{k} projectors differ by {out['projector_max_abs']:.3e}")
    del lap, evecs, p_eigh, p_sub

    # t-SNE of the test rows, as cli gmm --tsne runs it
    emb, out["tsne_s"] = _synced(lambda: tsne_fit(x_te, perplexity=20.0, device="cuda"))
    check(emb.embedding.shape == (2400, 2) and bool(torch.isfinite(emb.embedding).all()),
          "t-SNE embedding is not finite")
    out["tsne_kl"] = float(emb.kl_divergence)
    sub = x_te[:600]
    card_sub = float(tsne_fit(sub, perplexity=20.0, device="cuda").kl_divergence)
    host_sub, out["tsne_600_cpu_s"] = _synced(lambda: tsne_fit(sub, perplexity=20.0,
                                                               device="cpu"))
    out["tsne_600_kl"], out["tsne_600_kl_cpu"] = card_sub, float(host_sub.kl_divergence)
    check(abs(card_sub - out["tsne_600_kl_cpu"]) <= 0.1 * card_sub,
          f"t-SNE KL on 600 rows {card_sub} on the card, {out['tsne_600_kl_cpu']} on the CPU")
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30

    text, launches, out["cli_compare_wall_s"] = run_cli("compare", "--mat", score_mat)
    check(sum(launches.values()) == 0, f"cli compare launched a kernel: {launches}")
    lines = [ln for ln in text.splitlines() if ":" in ln and "=" in ln
             and not ln.startswith("LAUNCHES ")]
    check(len(lines) == 6 and lines[0].strip().startswith("GMM: accuracy="),
          f"cli compare printed:\n{text}")
    print("[slice] cli compare on the card over phase 9's cli score file:")
    print("\n".join(lines))
    print("[slice] comparison on the card (host clock, synchronized, warm): all six methods "
          f"{out['all_six_s']:.3f} s; alone (s) {json.dumps(out['method_s'])}; SVM L-BFGS "
          f"steps per pair {out['svm_lbfgs_iters']}; Ward {out['ward_chain_steps']} chain steps in "
          f"{out['ward_chain_s']:.3f} s, host replay {out['ward_replay_s']:.4f} s; spectral "
          f"subspace {out['subspace_steps']} steps in {out['subspace_s']:.3f} s, projector vs "
          f"eigh {out['projector_max_abs']:.3e} (eigh {out['eigh_s']:.3f} s); the CPU's five "
          f"methods {out['cpu_five_s']:.3f} s, "
          f"agreement {json.dumps(out['agree'])}; t-SNE of 2,400 rows {out['tsne_s']:.3f} s, "
          f"KL {out['tsne_kl']:.4f}; peak {out['peak_gib']:.4f} GiB above what earlier phases "
          "hold: ok")
    return out


# the JAX commands' --plot-dir file names (pinnfc_tpu/cli/diagnose.py,
# pinnfc_tpu/cli/explain.py); risk's depend on the conditions present
PLOT_FILES = {
    "auc": ["feature_scatter.png", "res_vs_epi.png", "roc.png", "temp_vs_v.png"],
    "gmm": ["gmm_confusion.png", "gmm_tsne.png", "prob_flooding.png",
            "prob_hydrogen_starvation.png", "prob_membrane_drying.png",
            "prob_oxygen_starvation.png"],
    "compare": ["confusion_Agglomerative.png", "confusion_GMM.png", "confusion_KMeans.png",
                "confusion_Spectral.png", "confusion_Supervised_LR.png",
                "confusion_Supervised_SVM.png", "method_metrics.png"],
    "identify": ["identifiability.png"],
    "explain": ["saliency_sigma.png", "saliency_voltage.png"],
    "conformal": ["conformal_coverage.png"],
}


def run_explain_slice(trained, keep_dir):
    """Phase 15: saliency, identifiability, conformal coverage and the t-SNE
    views on phase 7's artifact, on the card and on the CPU; then ``cli
    identify/explain/inspect/conformal`` and ``--plot-dir`` on phase 9's
    checkpoint and ``cli score`` file; returns what it prints as one dict."""
    import copy
    import importlib.util

    from pinnfc_tpu_torch.config import AucConfig
    from pinnfc_tpu_torch.diagnosis import parse_features, run_gmm_pipeline, tsne_fit
    from pinnfc_tpu_torch.uq import (
        coarse_class_saliency, conformal_report, input_saliency, lambda_identifiability)
    from pinnfc_tpu_torch.uq.saliency import _head_jacobians
    from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy
    from pinnfc_tpu_torch.viz.plots import scatter_features, tsne_embed

    arr, ds, params = trained.results.array, trained.dataset, trained.params
    host_params = params_from_jax(params_to_numpy(params), device="cpu")
    sx, sy = ds.scaler_x, ds.scaler_y
    hsx, hsy = sx.to("cpu"), sy.to("cpu")
    x_raw, labels = arr[:, :8], trained.results.labels
    out = {"rows": len(arr)}

    # input saliency: one forward, two backward passes over every row
    input_saliency(params, x_raw[:64], sx, sy, device="cuda")  # warm-up
    card, out["saliency_s"] = _synced(lambda: input_saliency(params, x_raw, sx, sy,
                                                             labels=labels, device="cuda"))
    t0 = time.perf_counter()
    host = input_saliency(host_params, x_raw, hsx, hsy, labels=labels, device="cpu")
    out["saliency_cpu_s"] = time.perf_counter() - t0
    # both float32 Jacobians against a float64 one (the CPU model in double):
    # near-zero entries are sums of 256 products that cancel, so an
    # elementwise atol of 1e-6 is below float32's rounding at this scale
    mlp64 = copy.deepcopy(host_params["mlp"]).double()
    x64 = torch.as_tensor(hsx.transform(x_raw.astype(np.float32))).double()
    ref_norm = _head_jacobians(mlp64, x64)[0].numpy()
    s_x, s_y = (s.scale.cpu().numpy().astype(np.float64) for s in (hsx, hsy))
    span = (hsx.data_max.cpu().numpy().astype(np.float64)
            - hsx.data_min.cpu().numpy().astype(np.float64))
    refs = {"jac_norm": ref_norm, "jac_range": ref_norm * (s_x / s_y[0] * span)[None, :]}
    out["saliency_err_vs_float64"], out["saliency_outside_1e-4_1e-6"] = {}, {}
    for field, ref in refs.items():
        tol = 1e-4 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        errs = {k: np.abs(getattr(r, field) - ref) for k, r in (("cuda", card), ("cpu", host))}
        check(all((e <= tol).all() for e in errs.values())
              and errs["cuda"].max() <= 2.0 * errs["cpu"].max() + 1e-12,
              f"saliency {field}: max error against float64 {errs['cuda'].max():.3e} on the "
              f"card, {errs['cpu'].max():.3e} on the CPU (max |ref| {np.abs(ref).max():.3e})")
        out["saliency_err_vs_float64"][field] = {k: float(e.max()) for k, e in errs.items()}
        out["saliency_outside_1e-4_1e-6"][field] = int((~np.isclose(
            getattr(card, field), getattr(host, field), rtol=1e-4, atol=1e-6)).sum())
    out["drivers"] = {}
    for field in ("jac_range", "sigma_jac_range"):
        t_card, t_host = coarse_class_saliency(card, field), coarse_class_saliency(host, field)
        check(list(t_card) == list(t_host) and len(t_card) == 5, f"saliency classes {list(t_card)}")
        for name in t_card:
            np.testing.assert_allclose(t_card[name], t_host[name], rtol=1e-4,
                                       err_msg=f"saliency table {field} {name}")
            check(np.argmax(t_card[name]) == np.argmax(t_host[name]), f"driver of {name}")
            out["drivers"][f"{field}:{name}"] = int(np.argmax(t_card[name]))

    # λ identifiability: the residual and its forward-mode Jacobian per group
    x_norm = sx.transform(x_raw.astype(np.float32))
    lambda_identifiability(params, x_norm[:64], sx, sy)  # warm-up
    card_rep, out["identify_s"] = {}, {}
    for group in ("lam_v", "lam_t", "lam_h", "lam_o"):
        rep, out["identify_s"][group] = _synced(lambda: lambda_identifiability(
            params, x_norm, sx, sy, groups=(group,)))
        card_rep.update(rep)
    host_rep = lambda_identifiability(host_params, x_norm, hsx, hsy)
    out["n_dropped"], out["identifiable"], out["stderr_max_rel"] = {}, {}, {}
    for group, c in card_rep.items():
        h = host_rep[group]
        check(np.array_equal(c.identifiable, h.identifiable)
              and np.array_equal(c.at_bound, h.at_bound) and c.n_dropped == h.n_dropped,
              f"identifiability {group}: flags or dropped rows differ between the card and the "
              f"CPU ({c.identifiable}, {c.at_bound}, {c.n_dropped} against {h.identifiable}, "
              f"{h.at_bound}, {h.n_dropped})")
        check(np.array_equal(np.isinf(c.stderr), np.isinf(h.stderr)), f"{group}: inf stderr")
        fin = np.isfinite(h.stderr)
        np.testing.assert_allclose(c.stderr[fin], h.stderr[fin], rtol=1e-3,
                                   err_msg=f"identifiability {group}: stderr")
        out["stderr_max_rel"][group] = float(np.max(
            np.abs(c.stderr[fin] / h.stderr[fin] - 1.0), initial=0.0))
        out["n_dropped"][group] = c.n_dropped
        out["identifiable"][group] = c.identifiable.tolist()

    rep, out["conformal_s"] = _synced(lambda: conformal_report(arr))
    check(np.isfinite(rep.detection_auc) and len(rep.classes) == 13,
          f"conformal: AUC {rep.detection_auc}, {len(rep.classes)} classes")
    out["conformal_auc"], out["conformal_q_hat"] = rep.detection_auc, rep.q_hat

    # the t-SNE view of auc --plot-dir: every mapped row on PLOT_FEATURES
    cfg = AucConfig()
    x, _, _ = scatter_features(arr, cfg.plot_features, cfg.group_spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    emb, out["tsne_auc_s"] = _synced(lambda: tsne_embed(x, random_state=cfg.random_state,
                                                        device="cuda"))
    out["tsne_auc_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["tsne_auc_rows"] = len(x)
    check(emb.shape == (15600, 2) and np.isfinite(emb).all(), f"t-SNE view {emb.shape}")
    sub = x[::len(x) // 600][:600]
    kl = {dev: float(tsne_fit(sub, device=dev).kl_divergence) for dev in ("cuda", "cpu")}
    check(abs(kl["cuda"] - kl["cpu"]) <= 0.1 * kl["cpu"], f"t-SNE KL on 600 rows {kl}")
    out["tsne_600_kl"] = kl
    # the view of gmm --plot-dir --tsne: the GMM's test rows
    gmm = run_gmm_pipeline(arr, device="cuda")
    x_te = arr[gmm.test_full_indices][:, parse_features(gmm.features)]
    emb, out["tsne_gmm_s"] = _synced(lambda: tsne_embed(x_te, perplexity=20.0, device="cuda"))
    check(np.isfinite(emb).all(), "t-SNE view of the GMM test rows")
    out["tsne_gmm_rows"] = len(x_te)

    # the four commands on phase 9's checkpoint and cli score file
    ck, mat = os.path.join(keep_dir, "ck"), os.path.join(keep_dir, "F01_scored.mat")
    argvs = [[cmd, *files, *fmt] for cmd, files in (
        ("identify", ["--ckpt", ck, "--mat", mat]), ("explain", ["--ckpt", ck, "--mat", mat]),
        ("inspect", ["--ckpt", ck]), ("conformal", ["--mat", mat])) for fmt in (["--json"], [])]
    runs, launches, _, out["cli_wall_s"] = run_cli_many(*argvs)
    check(all(rc == 0 for _, rc in runs), f"exit codes {[rc for _, rc in runs]}")
    check(sum(launches.values()) == 0, f"the explainability commands launched a kernel: {launches}")
    docs = {argv[0]: json.loads(text) for argv, (text, _) in zip(argvs[::2], runs[::2])}
    ident = docs["identify"]
    check(list(ident) == ["lam_v", "lam_t", "lam_h", "lam_o"]
          and [ident[g]["identifiable"][k] for g, k in (("lam_v", 3), ("lam_t", 1), ("lam_t", 3),
                                                        ("lam_h", 3), ("lam_o", 3))] == [False] * 5,
          "cli identify: the dead parameters are not flagged unidentifiable")
    check(len(docs["explain"]["classes"]) == 5, f"cli explain classes {docs['explain']['classes']}")
    check(docs["inspect"]["total_parameters"] == sum(p.numel() for p in params["mlp"].parameters())
          + 17, f"cli inspect counts {docs['inspect']['total_parameters']} parameters")
    check(len(docs["conformal"]["classes"]) == 13, "cli conformal classes")
    out["cli_n_dropped"] = {g: ident[g]["n_dropped"] for g in ident}
    for argv, (text, _) in zip(argvs[1::2], runs[1::2]):
        print(f"[slice] cli {argv[0]} on the card over phase 9's files:")
        print(text.rstrip())

    # --plot-dir on the seven commands of the slice
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as figs:
        plot_argvs = [[cmd, *files, "--plot-dir", os.path.join(figs, cmd), *extra]
                      for cmd, files, extra in (
                          ("auc", ["--mat", mat], []), ("gmm", ["--mat", mat], ["--tsne"]),
                          ("risk", ["--mat", mat], []), ("compare", ["--mat", mat], []),
                          ("identify", ["--ckpt", ck, "--mat", mat], []),
                          ("explain", ["--ckpt", ck, "--mat", mat], []),
                          ("conformal", ["--mat", mat], []))]
        runs, _, err, out["plot_dir_wall_s"] = run_cli_many(*plot_argvs)
        rcs = [rc for _, rc in runs]
        if have_mpl:
            check(rcs == [0] * 7, f"--plot-dir exit codes {rcs}:\n{err[-3000:]}")
            for argv in plot_argvs:
                files = sorted(os.listdir(os.path.join(figs, argv[0])))
                if argv[0] == "risk":
                    check(len(files) == 24 and all(f.startswith("rf_") for f in files),
                          f"risk figures {files}")
                else:
                    check(files == PLOT_FILES[argv[0]], f"{argv[0]} figures {files}")
            out["figures"] = "drawn"
            print("[slice] --plot-dir: every command wrote the JAX command's figure files: ok")
        else:
            check(rcs == [1] * 7 and err.count("figures need matplotlib") == 7,
                  f"--plot-dir without matplotlib: exit codes {rcs}:\n{err[-3000:]}")
            out["figures"] = "not drawn: matplotlib is not installed"
            print("[slice] --plot-dir: no figure was drawn: matplotlib is not installed on this "
                  "machine; each of the 7 commands exited 1 naming it, after its tables; the "
                  "t-SNE views' embeddings ran on the card above; the figures are checked "
                  "against the JAX package on the CPU (tests/test_torch_viz.py)")
    print(f"[slice] explainability on the card (host clock, synchronized, warm): saliency of "
          f"{len(arr)} rows {out['saliency_s']:.4f} s (CPU {out['saliency_cpu_s']:.3f} s), "
          f"max error against float64 {json.dumps(out['saliency_err_vs_float64'])}, entries "
          f"outside rtol 1e-4 atol 1e-6 of the CPU's "
          f"{json.dumps(out['saliency_outside_1e-4_1e-6'])}; identifiability per group (s) "
          f"{json.dumps(out['identify_s'])}, rows dropped {json.dumps(out['n_dropped'])}, "
          f"stderr card vs CPU max rel {json.dumps(out['stderr_max_rel'])}; conformal "
          f"{out['conformal_s']:.4f} s (host); t-SNE view of {out['tsne_auc_rows']} rows "
          f"{out['tsne_auc_s']:.3f} s, peak {out['tsne_auc_peak_gib']:.3f} GiB above what earlier "
          f"phases hold; 600 rows KL {json.dumps(kl)}; gmm view of {out['tsne_gmm_rows']} rows "
          f"{out['tsne_gmm_s']:.3f} s; cli process {out['cli_wall_s']:.1f} s: ok")
    return out


# tolerances of phase 16, card against CPU (float32 in both; the card's
# matmuls and the residual kernel round differently from MKL and the plain
# version, and the z-scores divide by the normal rows' σ)
SERVE_TOL = {"residuals": (1e-4, 1e-4), "v_pred": (1e-5, 1e-5), "layer_scores": (1e-3, 1e-3),
             "rf_inst": (0, 1e-4), "rf_smooth": (0, 1e-4), "layer_c": (1e-3, 1e-2)}
SERVE_FLAGS = ("warn", "danger", "v_alarm", "glitch", "sensor_alarm", "oob")


def _serving_stream(arr):
    """Phase 16's stream: the normal rows' last 200 (the lead-in of ``cli
    monitor --fault-label 1``) and fault segment 1, with NaN voltages first
    (the deferred V(0)), a stretch of NaN and ±inf inputs, and a 40-sample
    voltage-only outage (the sensor alarm)."""
    from pinnfc_tpu_torch.data.contract import INDEX

    labels = arr[:, INDEX["label"]]
    rows = np.vstack([arr[labels == 0][-200:], arr[labels == 1]])
    x = rows[:, :8].astype(np.float32)
    v = rows[:, INDEX["y_true"]].astype(np.float32)
    v[:3] = np.nan
    for k in range(24):
        x[300 + 3 * k, k % 8] = (np.nan, np.inf, -np.inf)[k // 8]
    v[600:640] = np.nan
    return x, v, rows[:, INDEX["label"]]


def _serving_same(card_outs, host_outs, n_calib, calib):
    """Card against CPU block by block at SERVE_TOL: NaN sets equal, flags
    equal (warn/danger except within 1e-4 of a threshold), fault_pred equal
    where the top posterior leads by more than 1e-4; each device's p-value
    is (1 + #{calib ≥ |res|})/(n+1) of its own |res|, computed on the host
    (bitwise on the ranks).  Returns (max errors, samples whose p-value rank
    differs between the devices, samples compared)."""
    from pinnfc_tpu_torch.config import RiskConfig

    cfg = RiskConfig()
    errs = {f: 0.0 for f in SERVE_TOL}
    rank_diff = n = 0
    for a, b in zip(card_outs, host_outs):
        for f, (rtol, atol) in SERVE_TOL.items():
            x, y = getattr(a, f), getattr(b, f)
            check(x.shape == y.shape and x.dtype == y.dtype, f"monitor {f}: {x.shape} {y.shape}")
            check(np.array_equal(np.isnan(x), np.isnan(y)), f"monitor {f}: NaN sets differ")
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=f"monitor {f}, card against the CPU")
            fin = np.isfinite(y)
            errs[f] = max(errs[f], float(np.max(np.abs(x[fin] - y[fin]), initial=0.0)))
        near = np.zeros(len(b.rf_smooth), bool)
        for thr in (cfg.warn_threshold, cfg.danger_threshold):
            near |= np.abs(b.rf_smooth - thr) <= 1e-4
        for f in SERVE_FLAGS:
            keep = ~near if f in ("warn", "danger") else slice(None)
            check(np.array_equal(getattr(a, f)[keep], getattr(b, f)[keep]),
                  f"monitor {f}: flags differ between the card and the CPU")
        p = np.sort(np.nan_to_num(b.fault_probs, nan=0.0), axis=1)
        clear = (p[:, -1] - p[:, -2] > 1e-4) | (b.fault_pred < 0)
        check(np.array_equal(a.fault_pred[clear], b.fault_pred[clear]), "monitor fault_pred")
        for out in (a, b):
            s_conf = np.abs(out.residuals[:, 0])
            fin = np.isfinite(s_conf)
            ge = n_calib - np.searchsorted(calib, s_conf[fin], side="left")
            want = ((1.0 + ge.astype(np.float32)) / np.float32(n_calib + 1.0)).astype(np.float32)
            check(np.array_equal(out.conformal_p[fin], want)
                  and np.isnan(out.conformal_p[~fin]).all(), "monitor conformal_p ranks")
        rank_diff += int(np.sum(a.conformal_p[np.isfinite(a.conformal_p)]
                                != b.conformal_p[np.isfinite(b.conformal_p)]))
        n += len(a.rf_smooth)
    return errs, rank_diff, n


def run_serving_slice(trained, gmm_result, keep_dir):
    """Phase 16: ``OnlineMonitor`` on phase 7's model and artifact on the card
    and on the CPU (a fault segment after its lead-in, blocks of 64 and 256,
    phase 13's GMM head, conformal ACI), ``observe_many`` against ``observe``,
    the fleet replay of the 12 conditions, a state-bank round trip, and
    ``condition_recovery`` on the card and the CPU; their times; then ``cli
    monitor`` and ``cli whatif`` over phase 9's files in one subprocess;
    returns what it prints as one dict."""
    import importlib.util

    from pinnfc_tpu_torch.diagnosis.gmm import GMMParams
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.risk import estimate_mu_sigma_normal
    from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor, fleet_replay
    from pinnfc_tpu_torch.uq import (
        CounterfactualConfig, condition_recovery, normal_calibration_scores)
    from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy

    arr, ds, params = trained.results.array, trained.dataset, trained.params
    host_params = params_from_jax(params_to_numpy(params), device="cpu")
    mu, sigma = estimate_mu_sigma_normal(arr)
    calib = np.sort(normal_calibration_scores(arr, score="absolute", calib_frac=1.0)
                    .astype(np.float32))
    head = DiagnosisHead.from_gmm_result(gmm_result)
    host_head = head._replace(
        gmm=GMMParams(*(t.cpu() if torch.is_tensor(t) else t for t in head.gmm)),
        comp_fault_prob=head.comp_fault_prob.cpu())
    out = {"calib_scores": len(calib)}

    def make(dev):
        on_card = dev == "cuda"
        return OnlineMonitor(params if on_card else host_params,
                             ds.scaler_x if on_card else ds.scaler_x.to("cpu"),
                             ds.scaler_y if on_card else ds.scaler_y.to("cpu"), mu, sigma,
                             diagnosis=head if on_card else host_head, conformal_calib=calib,
                             conformal_gamma=0.005, device=dev)

    def replay(mon, x, v, block, stream="default"):
        return [mon.observe(x[lo:lo + block], v[lo:lo + block], stream=stream)
                for lo in range(0, len(x), block)]

    x, v, labels = _serving_stream(arr)
    make("cuda").observe(x[:64], v[:64])  # warm-up
    out["errors"], out["rank_diff"] = {}, {}
    for block in (64, 256):
        card, host = make("cuda"), make("cpu")
        torch.cuda.synchronize()
        build.reset_launches()
        card_outs = replay(card, x, v, block)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        n_blocks = -(-len(x) // block)
        check(launches["residuals"] == n_blocks,
              f"the monitor launched the residual kernel {launches['residuals']} times over "
              f"{n_blocks} blocks")
        if block == 64:
            out["launches_monitor"] = launches["residuals"]
        host_outs = replay(host, x, v, block)
        errs, rank_diff, n = _serving_same(card_outs, host_outs, len(calib), calib)
        out["errors"][block], out["rank_diff"][block] = errs, rank_diff
        cat = {f: np.concatenate([getattr(o, f) for o in card_outs])
               for f in ("glitch", "sensor_alarm", "warn", "v_alarm", "oob")}
        # the sensor alarm is the run of consecutive glitches reaching 25
        run = np.zeros(len(x))
        for i, g in enumerate(cat["glitch"]):
            run[i] = (run[i - 1] + 1 if i else 1) if g else 0
        check(cat["glitch"][[0, 1, 2, 600, 639]].all()
              and cat["glitch"][300:372:3].all() and not cat["oob"][300:372:3].any()
              and np.array_equal(cat["sensor_alarm"], run >= 25)
              and cat["sensor_alarm"][624:640].all(),
              f"the stream's glitches and sensor alarm: "
              f"{ {k: int(c.sum()) for k, c in cat.items()} }")
        check(float(card.state.v_first) == float(v[3]), "V(0) was not deferred to sample 3")
        s_card, s_host = card.state, host.state
        check(all(np.asarray(getattr(s_card, f)).dtype == np.asarray(getattr(s_host, f)).dtype
                  for f in s_card._fields), "state dtypes differ")
        check(np.array_equal(s_card.oob_count, s_host.oob_count)
              and s_card.n_seen == s_host.n_seen, "oob counts or n_seen differ")
    out["stream"] = {"rows": len(x), "fault_rows": int((labels > 0).sum()),
                     "glitches": int(cat["glitch"].sum()),
                     "sensor_alarms": int(cat["sensor_alarm"].sum()),
                     "warn_first": int(np.argmax(cat["warn"])) if cat["warn"].any() else None,
                     "v_alarm_first": (int(np.argmax(cat["v_alarm"])) if cat["v_alarm"].any()
                                       else None)}

    # observe_many: 12 streams × 64 rows, 3 rounds, against single-stream observe
    from pinnfc_tpu_torch.data.contract import INDEX
    segs = [np.flatnonzero(arr[:, INDEX["label"]] == k)[:192] for k in range(1, 13)]
    keys = [f"seg{k}" for k in range(1, 13)]
    many, single = make("cuda"), make("cuda")
    bitwise = True
    for rnd in range(3):
        sl = [s[rnd * 64:(rnd + 1) * 64] for s in segs]
        xb = np.stack([arr[i, :8] for i in sl]).astype(np.float32)
        vb = np.stack([arr[i, INDEX["y_true"]] for i in sl]).astype(np.float32)
        build.reset_launches()
        got = many.observe_many(xb, vb, keys)
        check(build.LAUNCHES["residuals"] == 1, "observe_many launched the kernel "
                                                f"{build.LAUNCHES['residuals']} times")
        want = [single.observe(xb[i], vb[i], stream=k) for i, k in enumerate(keys)]
        errs, _, _ = _serving_same([got[k] for k in keys], want, len(calib), calib)
        bitwise &= all(np.array_equal(got[k].rf_smooth, w.rf_smooth)
                       and np.array_equal(got[k].residuals, w.residuals, equal_nan=True)
                       for k, w in zip(keys, want))
    out["observe_many_bitwise_observe"] = bool(bitwise)

    # the fleet replay of the 12 conditions, card against CPU
    fleet_card, out["fleet_replay_s"] = _synced(lambda: fleet_replay(make("cuda"), arr))
    fleet_host = fleet_replay(make("cpu"), arr)
    check(len(fleet_card) == len(fleet_host) == 12, f"fleet conditions {len(fleet_card)}")
    share_err = 0.0
    for a, b in zip(fleet_card, fleet_host):
        check(a.stream == b.stream and a.n_samples == b.n_samples
              and a.first_v_alarm == b.first_v_alarm, f"fleet {a.stream}: {a} against {b}")
        for f in ("first_warn", "first_danger"):
            ga, gb = getattr(a, f), getattr(b, f)
            check((ga is None) == (gb is None) and (ga is None or abs(ga - gb) <= 1),
                  f"fleet {a.stream} {f}: {ga} on the card, {gb} on the CPU")
        check(list(a.layer_shares) == list(b.layer_shares), f"fleet {a.stream} shares")
        if a.layer_shares:
            share_err = max(share_err, max(abs(a.layer_shares[k] - b.layer_shares[k])
                                           for k in a.layer_shares))
    check(share_err <= 1e-4, f"fleet layer shares differ by {share_err}")
    out["fleet_share_err"] = share_err
    out["fleet_warned"] = sum(r.first_warn is not None for r in fleet_card)

    # a state-bank round trip on the card: save mid-stream, load, continue
    with tempfile.TemporaryDirectory() as tmp:
        whole, half = make("cuda"), make("cuda")
        ref = replay(whole, x, v, 64)
        replay(half, x[:512], v[:512], 64)
        path = half.save_state_bank(os.path.join(tmp, "bank"))
        resumed = make("cuda")
        resumed.load_state_bank(path)
        rest = replay(resumed, x[512:], v[512:], 64)
    for a, b in zip(rest, ref[8:]):
        for f in ("rf_smooth", "rf_inst", "layer_c", "residuals", "conformal_p", "aci_alpha"):
            check(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True),
                  f"state bank round trip: {f} differs from the uninterrupted replay")
    check(resumed.stream_low_p() == whole.stream_low_p(), "state bank: anomaly counter")

    # times (synchronized host clock: each call ends in its one read; warm)
    t_mon = make("cuda")
    out["observe_ms"] = {}
    for b_n in (1, 64, 256):
        ts = []
        for rep in range(21):
            lo = (rep * b_n) % (len(x) - b_n)
            t0 = time.perf_counter()
            t_mon.observe(x[lo:lo + b_n], v[lo:lo + b_n], stream=f"t{b_n}")
            ts.append(time.perf_counter() - t0)
        out["observe_ms"][b_n] = statistics.median(ts[1:]) * 1e3
    xb = np.stack([x[64 * i:64 * (i + 1)] for i in range(12)])
    vb = np.stack([v[64 * i:64 * (i + 1)] for i in range(12)])
    ts = []
    for _ in range(11):
        t0 = time.perf_counter()
        t_mon.observe_many(xb, vb, keys)
        ts.append(time.perf_counter() - t0)
    out["observe_many_12x64_ms"] = statistics.median(ts[1:]) * 1e3

    # condition_recovery on the card against the CPU, gain mode, ≤ 64 rows per
    # alarmed condition.  Adam's step is scale-invariant, so a gradient
    # component at rounding level (through tanh units that the two devices
    # round to 1 or not) becomes a whole step on one device and none on the
    # other, and such a row's trajectory splits: rows are held where they did
    # not split — at 40 steps at least 85 % of rows with δ (fraction of the
    # range) and v_after (V) within 2e-5 — and every condition by its
    # recovered fraction (within one row of 64 at 40 steps, 0.1 at 400)
    def recover(dev, steps):
        on_card = dev == "cuda"
        return condition_recovery(arr, params if on_card else host_params,
                                  ds.scaler_x if on_card else ds.scaler_x.to("cpu"),
                                  ds.scaler_y if on_card else ds.scaler_y.to("cpu"),
                                  config=CounterfactualConfig(steps=steps), device=dev)

    recover("cuda", 5)  # warm-up
    out["recovery"] = {}
    for steps, min_close, tol_frac in ((40, 0.85, 1 / 64), (400, 0.0, 0.1)):
        card_recs, secs = _synced(lambda: recover("cuda", steps))
        t0 = time.perf_counter()
        host_recs = recover("cpu", steps)
        host_s = time.perf_counter() - t0
        per, n_rows, n_outside = {}, 0, 0
        for a, b in zip(card_recs, host_recs):
            check((a.fault_name, a.current_target, a.idx_v_alarm, a.n_rows)
                  == (b.fault_name, b.current_target, b.idx_v_alarm, b.n_rows),
                  f"recovery conditions differ: {a.fault_name} {a.current_target}")
            if a.report is None:
                continue
            check(np.abs(a.report.v_before - b.report.v_before).max() <= 1e-5, "v_before")
            d = np.abs(a.report.delta_range - b.report.delta_range).max(axis=1)
            n_rows += a.n_rows
            n_outside += int(((d > 2e-5)
                              | (np.abs(a.report.v_after - b.report.v_after) > 2e-5)).sum())
            per[f"{a.current_target:g}A {a.fault_name}"] = [
                float(d.max()), float(np.abs(a.report.v_after - b.report.v_after).max()),
                abs(float(a.report.recovered.mean()) - float(b.report.recovered.mean())),
                int((b.report.v_target + 0.01 - b.report.v_meas <= 0).sum())]
        worst = np.max(np.array([e[:3] for e in per.values()]), axis=0)
        check(worst[2] <= tol_frac and n_rows - n_outside >= min_close * n_rows,
              f"recovery {steps} steps, card against CPU per condition [δ error, v_after "
              f"error, recovered-fraction error, rows needing no gain]: {json.dumps(per)}; "
              f"{n_outside} of {n_rows} rows outside 2e-5")
        out["recovery"][steps] = {"s": secs, "cpu_s": host_s, "rows": n_rows,
                                  "delta_err": float(worst[0]), "v_after_err": float(worst[1]),
                                  "recovered_frac_err": float(worst[2]),
                                  "rows_outside_2e-5": n_outside,
                                  "per_condition": per,
                                  "recovered_frac": {f"{r.current_target:g}A {r.fault_name}":
                                                     float(r.report.recovered.mean())
                                                     for r in card_recs if r.report is not None}}

    # the two commands on phase 9's checkpoint and cli score file
    ck, mat = os.path.join(keep_dir, "ck"), os.path.join(keep_dir, "F01_scored.mat")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as figs:
        argvs = [["monitor", "--mat", mat, "--ckpt", ck],
                 ["monitor", "--mat", mat, "--ckpt", ck, "--fault-label", "1", "--diagnose",
                  "--conformal", "--conformal-gamma", "0.005", "--whatif"],
                 ["monitor", "--mat", mat, "--ckpt", ck, "--fleet"],
                 ["whatif", "--ckpt", ck, "--mat", mat, "--json"],
                 ["whatif", "--ckpt", ck, "--mat", mat, "--plot-dir", figs]]
        runs, launches, err, out["cli_wall_s"] = run_cli_many(*argvs)
        rcs = [rc for _, rc in runs]
        check(rcs == [0, 0, 0, 0, 0 if have_mpl else 1],
              f"cli monitor/whatif exit codes {rcs}:\n{err[-3000:]}")
        if have_mpl:
            check(os.listdir(figs) == ["whatif_actuation.png"], f"whatif figures {os.listdir(figs)}")
        else:
            check("figures need matplotlib" in err, f"whatif --plot-dir:\n{err[-2000:]}")
    check(launches["residuals"] > 0, f"cli monitor launched no residual kernel: {launches}")
    doc = json.loads(runs[3][0])
    check(len(doc["conditions"]) == 12 and doc["target_mode"] == "gain", "cli whatif --json")
    check("streamed 15600 samples" in runs[0][0] and "streamed 1000 samples" in runs[1][0]
          and "conformal anomaly rate" in runs[1][0]
          and "fleet replay: 12 conditions" in runs[2][0],
          f"cli monitor printed:\n{runs[0][0]}\n{runs[1][0]}\n{runs[2][0]}")
    out["cli_launches"] = launches
    out["figures"] = "drawn" if have_mpl else "not drawn: matplotlib is not installed"
    for argv, (text, _) in zip(argvs[:3], runs[:3]):
        print(f"[slice] cli {' '.join(a for a in argv[1:] if a not in (mat, ck))} on the card "
              f"over phase 9's files:")
        print(text.rstrip())
    print(f"[slice] cli whatif --json on the card: "
          f"{json.dumps([[c['current'], c['fault'], c.get('dominant'), c.get('recovered_frac')] for c in doc['conditions']], ensure_ascii=False)}")
    print(f"[slice] serving on the card (host clock, synchronized, warm, median): observe ms per "
          f"block {json.dumps(out['observe_ms'])}, observe_many 12 x 64 "
          f"{out['observe_many_12x64_ms']:.3f} ms, fleet_replay {out['fleet_replay_s']:.3f} s; "
          f"condition_recovery {json.dumps({k: [v_['s'], v_['rows']] for k, v_ in out['recovery'].items()})} "
          f"(s, rows); card against CPU max errors {json.dumps(out['errors'])}, p-value ranks "
          f"differing {json.dumps(out['rank_diff'])} (each device's bitwise its own |res|'s); "
          f"observe_many bitwise observe {out['observe_many_bitwise_observe']}; residual-kernel "
          f"launches {out['launches_monitor']} for {-(-len(x) // 64)} blocks: ok")
    return out


# the stages of run_all, each looked up in its module when the chain runs
RUN_ALL_STAGES = (("train", "cmd_train"), ("diagnose", "cmd_auc"), ("diagnose", "cmd_gmm"),
                  ("risk", "cmd_risk"), ("diagnose", "cmd_compare"), ("serve", "cmd_monitor"),
                  ("explain", "cmd_identify"), ("explain", "cmd_explain"),
                  ("explain", "cmd_whatif"), ("diagnose", "cmd_conformal"),
                  ("diagnose", "cmd_report"))


def _metrics_close(got: dict, want: dict, n_te: int) -> dict:
    """Hold a ``metrics.json`` made on the card against ``artifact_metrics`` of
    the same artifact on the CPU at phases 12-13's card-against-CPU
    tolerances: group and forest AUCs within 1e-4, the LR accuracies within
    2/n_te, GMM accuracy within 0.005, the risk counts equal and the mean
    advance within one sample, the host statistics to float64 rounding.
    Returns the largest difference per metric."""
    check(list(got) == list(want), f"metrics.json keys {list(got)} against {list(want)}")
    diffs = {}
    for k, w in want.items():
        g = got[k]
        w = None if not np.isfinite(w) else w
        check((g is None) == (w is None), f"metrics.json {k}: {g} against {w} on the CPU")
        if w is None:
            continue
        if k.startswith(("auc_group", "isoforest")):
            tol = 1e-4
        elif k.startswith("accuracy_group"):
            tol = 2.0 / n_te
        else:
            tol = {"gmm_accuracy": 0.005, "mean_rf_advance": 1.0}.get(k, 1e-12 * max(1, abs(w)))
        diffs[k] = abs(g - w)
        check(diffs[k] <= tol, f"metrics.json {k}: {g} on the card, {w} on the CPU")
    return diffs


def run_all_slice(train_launches: dict, keep_dir: str) -> dict:
    """Phase 17: ``run_all(args, plot_dir=None)``, the chain of ``cli run-all``
    without figures, at flagship width on the default campaign with every
    stage scaled by 0.1, the launch counts reset just before and read just
    after; report.md and metrics.json checked; then ``cli run-all
    --from-ckpt`` over phase 9's checkpoint in a subprocess.  Returns what it
    prints as one dict."""
    import importlib
    import importlib.util

    from pinnfc_tpu_torch.cli import build_parser
    from pinnfc_tpu_torch.cli.run_all import run_all
    from pinnfc_tpu_torch.data.contract import INDEX, load_comprehensive_results
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.utils.report import ALL_SECTIONS, _SECTION_TITLES, artifact_metrics

    out = {"stage_s": {}}
    saved = []
    for mod_name, fn_name in RUN_ALL_STAGES:
        mod = importlib.import_module(f"pinnfc_tpu_torch.cli.{mod_name}")
        fn = getattr(mod, fn_name)

        def timed_stage(args, fn=fn, name=fn_name[4:]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(args)
            finally:
                torch.cuda.synchronize()
                out["stage_s"][name] = time.perf_counter() - t0

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, timed_stage)
    with tempfile.TemporaryDirectory() as tmp:
        args = build_parser().parse_args(["run-all", "--out-dir", tmp, "--steps-scale", "0.1"])
        try:
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            rc = run_all(args, None)
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            out["wall_s"] = time.perf_counter() - t0
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        check(rc == 0, f"run_all exited {rc}")
        with open(os.path.join(tmp, "report.md")) as f:
            text = f.read()
        want_titles = [_SECTION_TITLES[s] for s in ALL_SECTIONS if s != "baseline"]
        titles = [ln[3:] for ln in text.splitlines() if ln.startswith("## ")]
        check(titles == want_titles, f"report.md sections {titles}")
        check("section unavailable" not in text and "_no checkpoint given" not in text,
              "report.md has a degraded section:\n" + "\n".join(
                  ln for ln in text.splitlines() if "unavailable" in ln or "_no " in ln))
        arr = load_comprehensive_results(os.path.join(tmp, "F01_output.mat")).array
        check(arr.shape == (15600, 22) and np.isfinite(arr[:, INDEX["y_pred"]]).all(),
              f"run-all artifact {arr.shape}")
        labels = arr[:, INDEX["label"]]
        n_blocks = -(-(200 + int((labels == 1).sum())) // 256)  # cli monitor's stream
        out["launches"] = launches
        check(launches["train_dnn"] == 2 and launches["mc_dropout"] == 1
              and launches["residuals"] == train_launches["residuals"] + n_blocks,
              f"run_all launches {launches}: want the training kernel twice, the MC kernel "
              f"once, the residual kernel {train_launches['residuals']} + {n_blocks} times")
        with open(os.path.join(tmp, "metrics.json")) as f:
            card = json.load(f)
        t0 = time.perf_counter()
        host = artifact_metrics(arr, device="cpu")
        out["metrics_cpu_s"] = time.perf_counter() - t0
        n_te = int(round(0.9 * len(arr)))
        diffs = _metrics_close(card, host, n_te)
        out["metrics_max_diff"] = max(diffs.values())
        out["metrics"] = card

    # the command in a subprocess over phase 9's checkpoint
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, "run-all", "--from-ckpt",
                               os.path.join(keep_dir, "ck"), "--out-dir", tmp], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              timeout=900)
        out["cli_wall_s"] = time.perf_counter() - t0
        wrote = os.path.exists(os.path.join(tmp, "F01_output.mat"))
        if have_mpl:
            check(proc.returncode == 0 and "run-all complete" in proc.stdout,
                  f"cli run-all exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        else:
            check(proc.returncode == 1 and "matplotlib" in proc.stderr and wrote
                  and not os.path.exists(os.path.join(tmp, "report.md")),
                  f"cli run-all without matplotlib exited {proc.returncode} (want 1 naming "
                  f"matplotlib after F01_output.mat):\n{proc.stderr[-3000:]}")
        out["cli"] = ("exit 0" if have_mpl else
                      "exit 1 naming matplotlib after writing F01_output.mat")
    print(f"[slice] run_all(plot_dir=None) on the card (default campaign, schedule x 0.1, "
          f"mc_times 2000): {out['wall_s']:.1f} s; per stage (s, synchronized) "
          f"{json.dumps({k: round(v, 3) for k, v in out['stage_s'].items()})}; launches "
          f"{json.dumps(launches)}; report.md with its {len(want_titles)} default sections, none "
          f"degraded; metrics.json against artifact_metrics on the CPU, largest difference "
          f"{out['metrics_max_diff']:.3e}: ok; cli run-all --from-ckpt (subprocess, "
          f"{out['cli_wall_s']:.1f} s): {out['cli']}")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, path: str, obj=None):
    """One request to the loopback server: (status, JSON body or text)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if obj is None else json.dumps(obj).encode(),
        method="GET" if obj is None else "POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read().decode()
            return r.status, body if path == "/metrics" else json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_process(argv, requests, timeout: int = 300):
    """``cli serve <argv>`` on the card in a subprocess on a free loopback
    port, with ``--max-requests len(requests)``: wait for its ready line, send
    the requests in order, wait for it to end.  Returns (responses, seconds
    per request, its standard output)."""
    port = _free_port()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pinnfc_tpu_torch.cli", "serve", *argv, "--port", str(port),
             "--max-requests", str(len(requests))], cwd=REPO, stdout=subprocess.PIPE,
            stderr=err, text=True)
        try:
            lines = []
            deadline = time.time() + timeout
            while time.time() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                if line.startswith("serving OnlineMonitor on"):
                    break
            check(lines and lines[-1].startswith("serving OnlineMonitor on"),
                  f"cli serve {argv} did not start:\n{''.join(lines)}")
            responses, seconds = [], []
            for path, obj in requests:
                t0 = time.perf_counter()
                responses.append(_http(port, path, obj))
                seconds.append(time.perf_counter() - t0)
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        check(proc.returncode == 0 and "server closed" in rest,
              f"cli serve {argv} exited {proc.returncode}:\n{err.read()[-3000:]}")
    return responses, seconds, "".join(lines) + rest


def _in_thread(fn, *args):
    """Start ``fn(*args)`` in a thread: (thread, box); the box gets its result
    (or what it raised, ``SystemExit`` from ``fail`` included) and seconds."""
    import threading

    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller's thread
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


def _joined(thread, box):
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["value"]


def _replay_requests(monitor, requests) -> list:
    """The JSON bodies an in-process server would answer ``requests`` with
    (the observing routes; others None), from ``monitor``."""
    from pinnfc_tpu_torch.serving.server import _json_payload

    bodies = []
    for path, obj in requests:
        body = None
        if path == "/observe":
            s = obj.get("stream", "default")
            body = _json_payload(monitor.observe(np.asarray(obj["x"], np.float32),
                                                 np.asarray(obj["v"], np.float32), stream=s),
                                 monitor, s)
        elif path == "/observe_many":
            outs = monitor.observe_many(np.asarray(obj["x"], np.float32),
                                        np.asarray(obj["v"], np.float32), obj["streams"])
            body = {"results": {s: _json_payload(o, monitor, s) for s, o in outs.items()},
                    "n_seen": monitor.n_seen}
        elif path == "/reset":
            monitor.reset(obj.get("stream"))
            body = {"ok": True}
        bodies.append(None if body is None else json.loads(json.dumps(body)))
    return bodies


def run_export_serve_slice(gmm_result, keep_dir: str) -> dict:
    """Phase 18: ``cli export-model`` three ways over phase 9's checkpoint (one
    subprocess, no device work); the scorer artifact on the card against the
    eval forward; phase 16's stream through ``monitor_from_artifact`` on the
    card against the checkpoint monitor on the card, blocks of 64 and 256,
    one residual-kernel launch per block; ``observe_many`` of 12 x 64 through
    the fleet artifact in one call; ``cli serve --ckpt`` and ``--artifact``
    over loopback against the in-process monitors, and a ``--state-path``
    restart; their times.  Returns what it prints as one dict."""
    from pinnfc_tpu_torch.data.contract import INDEX, load_comprehensive_results
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.risk import estimate_mu_sigma_normal
    from pinnfc_tpu_torch.serving import (
        DiagnosisHead, OnlineMonitor, load_scorer, monitor_from_artifact)
    from pinnfc_tpu_torch.uq import normal_calibration_scores
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint

    ck, mat = os.path.join(keep_dir, "ck"), os.path.join(keep_dir, "F01_scored.mat")
    arr = load_comprehensive_results(mat).array
    mu, sigma = estimate_mu_sigma_normal(arr)
    calib = normal_calibration_scores(arr, score="absolute", calib_frac=1.0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        head = DiagnosisHead.from_gmm_result(gmm_result).save(os.path.join(tmp, "head"))
        arts = {k: os.path.join(tmp, f"{k}.pt2") for k in ("scorer", "step", "fleet")}
        argvs = [["export-model", "--ckpt", ck, "--out", arts["scorer"]],
                 ["export-model", "--ckpt", ck, "--out", arts["step"], "--monitor-step",
                  "--head", head, "--conformal-mat", mat, "--conformal-gamma", "0.005"],
                 ["export-model", "--ckpt", ck, "--out", arts["fleet"], "--monitor-step",
                  "--fleet-step", "--head", head]]
        # three processes at once: each traces on the host for about 20 s
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", CLI_RUNNER, *argv], cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for argv in argvs]
        runs = [(p, *p.communicate(timeout=900)) for p in procs]
        out["export_wall_s"] = time.perf_counter() - t0
        for proc, text, err in runs:
            check(proc.returncode == 0, f"export-model exited {proc.returncode}:\n{err[-3000:]}")
            launches = json.loads(text.rpartition("LAUNCHES ")[2])
            check(not any(launches.values()), f"export-model launched kernels: {launches}")
        sides = {k: json.load(open(p + ".meta.json")) for k, p in arts.items()}
        check([sides[k]["kind"] for k in arts] == ["pinnfc_torch_scorer"] + [
            "pinnfc_torch_monitor_step"] * 2 and sides["step"]["conformal_gamma"] == 0.005
              and sides["fleet"]["fleet_step"], f"sidecars {sides}")
        out["artifact_bytes"] = {k: os.path.getsize(p) for k, p in arts.items()}

        # the scorer against the eval forward of the checkpoint on the card
        ckpt = load_checkpoint(ck, device="cuda")
        scorer = load_scorer(open(arts["scorer"], "rb").read(), device="cuda")
        out["scorer_err"] = {}
        for rows in (1, 37, len(arr)):
            x = torch.as_tensor(arr[:rows, :8].astype(np.float32), device="cuda")
            v, lv = scorer(x)
            with torch.no_grad():
                pred, lv_ref = ckpt["params"]["mlp"](ckpt["scaler_x"].transform(x))
            v_ref = ckpt["scaler_y"].inverse(pred)[:, 0]
            check(v.shape == (rows,) and v.is_cuda, f"scorer output {v.shape} {v.device}")
            torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(lv, lv_ref[:, 0], rtol=1e-5, atol=1e-5)
            out["scorer_err"][rows] = max(max_abs_err(v, v_ref), max_abs_err(lv, lv_ref[:, 0]))

        # phase 16's stream through the step artifact against the checkpoint monitor
        x, v, _ = _serving_stream(arr)
        kw = dict(conformal_calib=calib, conformal_gamma=0.005, device="cuda")

        def ckpt_monitor(**extra):
            return OnlineMonitor.from_checkpoint(
                ck, mu, sigma, diagnosis=DiagnosisHead.load(head, device="cuda"), **kw, **extra)

        def art_monitor(name):
            side = sides[name]
            return monitor_from_artifact(
                open(arts[name], "rb").read(), mu, sigma, class_names=side["class_names"],
                conformal_alpha=side.get("conformal_alpha", 0.1),
                conformal_gamma=side.get("conformal_gamma", 0.0), device="cuda")

        out["artifact_bitwise"], per_block = {}, []
        for block in (64, 256):
            art, ref = art_monitor("step"), ckpt_monitor()
            bitwise, worst = True, 0.0
            for lo in range(0, len(x), block):
                torch.cuda.synchronize()
                before = build.LAUNCHES["residuals"]
                a = art.observe(x[lo:lo + block], v[lo:lo + block])
                torch.cuda.synchronize()
                per_block.append(build.LAUNCHES["residuals"] - before)
                check(per_block[-1] == 1,
                      "the exported step did not launch the residual kernel once per block")
                b = ref.observe(x[lo:lo + block], v[lo:lo + block])
                for f in ("rf_smooth", "rf_inst", "residuals", "v_pred", "layer_c",
                          "fault_probs", "conformal_p", "aci_alpha"):
                    ga, gb = getattr(a, f), getattr(b, f)
                    check(np.array_equal(np.isnan(ga), np.isnan(gb)), f"artifact {f} NaN sets")
                    np.testing.assert_allclose(ga, gb, rtol=1e-5, atol=1e-5, equal_nan=True,
                                               err_msg=f"artifact {f} against the checkpoint")
                    bitwise &= np.array_equal(ga, gb, equal_nan=True)
                    fin = np.isfinite(gb)
                    worst = max(worst, float(np.max(np.abs(ga[fin] - gb[fin]), initial=0.0)))
                for f in ("warn", "danger", "v_alarm", "glitch", "sensor_alarm", "oob",
                          "aci_anomaly", "fault_pred"):
                    check(np.array_equal(getattr(a, f), getattr(b, f)), f"artifact {f} flags")
            out["artifact_bitwise"][block] = [bitwise, worst]
        # residual-kernel launches per exported observe: [fewest, most] over the blocks
        out["launches_per_exported_observe"] = [min(per_block), max(per_block)]

        # observe_many of 12 x 64 through the fleet artifact: one call
        fleet = art_monitor("fleet")
        xb = np.stack([x[64 * i:64 * (i + 1)] for i in range(12)])
        vb = np.stack([v[64 * i:64 * (i + 1)] for i in range(12)])
        keys = [f"s{i}" for i in range(12)]
        torch.cuda.synchronize()
        build.reset_launches()
        got = fleet.observe_many(xb, vb, keys)
        torch.cuda.synchronize()
        out["launches_fleet_observe_many"] = build.LAUNCHES["residuals"]
        check(out["launches_fleet_observe_many"] == 1,
              f"the fleet artifact launched the residual kernel {build.LAUNCHES['residuals']} "
              "times for one observe_many")
        want = OnlineMonitor.from_checkpoint(
            ck, mu, sigma, diagnosis=DiagnosisHead.load(head, device="cuda"),
            device="cuda").observe_many(xb, vb, keys)
        out["fleet_bitwise"] = all(np.array_equal(got[k].rf_smooth, want[k].rf_smooth)
                                   and np.array_equal(got[k].residuals, want[k].residuals,
                                                      equal_nan=True) for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k].rf_smooth, want[k].rf_smooth, rtol=1e-5,
                                       atol=1e-5, err_msg="fleet artifact rf_smooth")

        # times: exported observe per block size (host clock, synchronized, warm)
        t_art = art_monitor("step")
        out["artifact_observe_ms"] = {}
        for b_n in (1, 64, 256):
            ts = []
            for rep in range(21):
                lo = (rep * b_n) % (len(x) - b_n)
                t0 = time.perf_counter()
                t_art.observe(x[lo:lo + b_n], v[lo:lo + b_n], stream=f"t{b_n}")
                ts.append(time.perf_counter() - t0)
            out["artifact_observe_ms"][b_n] = statistics.median(ts[1:]) * 1e3

        # where an exported observe's time goes at B = 1 and 64: the artifact's
        # device step alone (its inputs already on the card), against the
        # eager device step with the scans at the block's own depth, at
        # BLOCK_MAX's and at 4,096 rows' (the rounds' cost); the rest of the
        # observe is the copy, the read and the host's packing.  The five
        # take turns within each repeat, so the host's drift falls on all
        from pinnfc_tpu_torch.serving.exported import BLOCK_MAX

        def device_step(mon, b_n, max_len=None):
            carry = torch.as_tensor(mon._carry([mon._fresh_state()]), device="cuda")
            xs = torch.as_tensor(x[None, :b_n], device="cuda")
            vs = torch.as_tensor(v[:b_n, None], device="cuda")

            def run():
                mon._device_step(xs, vs, carry, mon.mu, mon.sigma, max_len)
                torch.cuda.synchronize()
            return run

        eager = ckpt_monitor()
        out["exported_breakdown_ms"] = {}
        for b_n in (1, 64):
            fns = {"observe": lambda: t_art.observe(x[:b_n], v[:b_n], stream="split"),
                   "artifact_device_step": device_step(t_art, b_n),
                   "eager_device_step": device_step(eager, b_n),
                   "eager_device_step_block_max": device_step(eager, b_n, BLOCK_MAX),
                   "eager_device_step_4096": device_step(eager, b_n, 4096)}
            ts = {k: [] for k in fns}
            for _ in range(21):
                for k, fn in fns.items():
                    t0 = time.perf_counter()
                    fn()
                    ts[k].append(time.perf_counter() - t0)
            out["exported_breakdown_ms"][b_n] = {k: statistics.median(t[1:]) * 1e3
                                                 for k, t in ts.items()}
        out["block_max"] = BLOCK_MAX

        # the command line: cli serve over loopback, against the in-process monitors
        def block(lo, stream=None):
            body = {"x": x[lo:lo + 64].tolist(), "v": v[lo:lo + 64].tolist()}
            return body if stream is None else {**body, "stream": stream}

        requests = [("/health", None), ("/observe", block(0)), ("/observe", block(64, "b")),
                    ("/observe_many", {"streams": ["b", "c"],
                                       "x": [x[128:192].tolist(), x[192:256].tolist()],
                                       "v": [v[128:192].tolist(), v[192:256].tolist()]}),
                    ("/reset", {"stream": "c"}), ("/metrics", None)]
        timing = [("/observe", block(256 + 64 * (k % 10), "t")) for k in range(21)]
        serve_flags = ["--mat", mat, "--head", head, "--conformal", "--conformal-gamma", "0.005"]
        state = os.path.join(tmp, "bank")
        servers = {  # name: (argv, requests, the in-process monitor)
            "ckpt": (["--ckpt", ck, *serve_flags], requests + timing, ckpt_monitor),
            "artifact": (["--mat", mat, "--artifact", arts["step"], "--state-path", state],
                         requests, lambda: art_monitor("step"))}
        # the two servers at once, each driven from its own thread
        out["serve_wall_s"] = {}
        running = {name: _in_thread(serve_process, argv, reqs)
                   for name, (argv, reqs, _) in servers.items()}
        for name, (argv, reqs, local) in servers.items():
            resp, secs, text = _joined(*running[name])
            check([c for c, _ in resp] == [200] * len(resp), f"serve {name} statuses "
                                                             f"{[c for c, _ in resp]}")
            for (path, _), (_, body), w in zip(reqs, resp, _replay_requests(local(), reqs)):
                if w is not None:
                    check(body == w, f"serve {name} {path}: the payload differs from the "
                                     "in-process monitor's")
            health, metrics = resp[0][1], resp[5][1]
            check(health["ok"] and health["streams"] == ["default"]
                  and "pinnfc_stream_rf_smooth{stream=\"b\"}" in metrics
                  and "pinnfc_stream_conformal_low_p" in metrics, f"serve {name} health/metrics")
            if name == "ckpt":
                out["observe_round_trip_ms"] = statistics.median(secs[-20:]) * 1e3
            else:
                check("serving from torch.export artifact" in text, f"serve --artifact:\n{text}")
        out["serve_wall_s"] = {name: box["s"] for name, (_, box) in running.items()}

        # the artifact server restarted on its --state-path resumes the bank bitwise
        restart = [("/observe", block(320))]
        resumed, _, text = serve_process(servers["artifact"][0], restart)
        check("restored 3 stream(s)" in text, f"serve --state-path did not restore:\n{text}")
        want = _replay_requests(art_monitor("step"), requests + restart)
        check(resumed[0][1] == want[-1],
              "serve --state-path: the restarted server does not continue the bank bitwise")
    print(f"[slice] export-model x 3 (three processes at once, {out['export_wall_s']:.1f} s, no kernel "
          f"launch; bytes {json.dumps(out['artifact_bytes'])}); scorer artifact on the card "
          f"against the eval forward, max abs err {json.dumps(out['scorer_err'])}; the step "
          f"artifact on the card against the checkpoint monitor [bitwise, max abs err] "
          f"{json.dumps(out['artifact_bitwise'])}, residual-kernel launches per block "
          f"{out['launches_per_exported_observe']}; fleet "
          f"artifact observe_many 12 x 64 in {out['launches_fleet_observe_many']} launch, "
          f"bitwise {out['fleet_bitwise']}; "
          f"exported observe ms per block (host clock, warm, median) "
          f"{json.dumps(out['artifact_observe_ms'])}, where it goes (block_max "
          f"{out['block_max']}) {json.dumps(out['exported_breakdown_ms'])}; cli serve --ckpt "
          f"and --artifact over loopback, at once (wall s {json.dumps(out['serve_wall_s'])}): "
          f"payloads equal to the "
          f"in-process monitors', /observe round trip at B = 64 "
          f"{out['observe_round_trip_ms']:.3f} ms (median of 20); --state-path restart "
          f"bitwise: ok")
    return out


def _same_files(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# phase 19's bounds on a sharded run against an unsharded one, each between
# the sound run's reading and a planted fault's (both printed by the phase):
# λ_v of the whole pipelines (relative), and the weights after 20 DNN steps
# from the trained MLP (absolute)
LAM_V_WHOLE_RTOL = 4e-2
TRAINED_WEIGHT_ATOL = 4e-2


@contextlib.contextmanager
def _row_offsets_lost():
    """A planted fault for phase 19: ``run_schedule``'s row shards all claim
    global row 0, so every shard draws the masks of the first rows."""
    from pinnfc_tpu_torch.training import stages

    real = stages.shard_batch

    def lost(*args, **kw):
        sh = real(*args, **kw)
        return sh._replace(offsets=(0,) * len(sh.offsets))

    stages.shard_batch = lost
    try:
        yield
    finally:
        stages.shard_batch = real


def run_parallel_slice(dev, train_ds, campaign_launches: dict, keep_dir: str) -> dict:
    """Phase 19: ``cli ensemble`` on the card, member independence, the
    data-parallel training pipeline on a mesh that lists the card four times,
    the sharded DNN stage against the whole-stage kernel, ``train`` and
    ``score --data-parallel`` on phase 9's files, and their times.  Returns
    what it measured."""
    import dataclasses

    from pinnfc_tpu_torch.cli._common import _train_config
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.models.mlp import MLP
    from pinnfc_tpu_torch.models.pinn import LAMBDA_GROUPS
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.ops.mc_dropout import mc_dropout
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.ops.train_dnn import (
        mlp_weights, train_dnn, train_dnn_sharded, train_dnn_sharded_plain,
        train_dnn_stage_plain)
    from pinnfc_tpu_torch.parallel.ensemble import (
        init_ensemble, mc_dropout_sharded, member_seed, train_dnn_ensemble)
    from pinnfc_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results, default_mc_seed
    from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
    from pinnfc_tpu_torch.training.stages import run_schedule, train_dnn_stage
    from pinnfc_tpu_torch.uq.deep_ensemble import ensemble_moments

    out = {}
    # the ensemble command at full size
    ens_out, ens_l, ens_wall = run_cli("ensemble", "--members", "8", "--steps", "2000", "--uq")
    check(ens_l["train_dnn"] == 8 and ens_l["mc_dropout"] == 0,
          f"cli ensemble launches {ens_l}")
    rows = [ln for ln in ens_out.splitlines() if ln.strip() and ln.split()[0].isdigit()]
    check(len(rows) == 8 and "ensemble spread" in ens_out and "deep-ensemble UQ" in ens_out,
          f"cli ensemble output:\n{ens_out[-2000:]}")
    print("[slice] cli ensemble --members 8 --steps 2000 --uq on the card (wall "
          f"{ens_wall:.1f} s): launches {json.dumps(ens_l)}")
    print("\n".join(ln for ln in ens_out.splitlines() if not ln.startswith("LAUNCHES")))
    out.update(launches_ensemble=ens_l, ensemble_wall_s=ens_wall)

    # member independence, and per-member seconds
    x, y = train_ds.x_train, train_ds.y_train
    ens = init_ensemble(3, 2, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, losses = train_dnn_ensemble(ens, x, y, 11, 2000)
    torch.cuda.synchronize()
    out["member_train_s"] = (time.perf_counter() - t0) / 2
    for e in range(2):
        lone = train_dnn_stage(ens["mlp"][e], x, y, member_seed(11, e), 2000)
        same = torch.equal(lone.losses, losses[e]) and all(
            torch.equal(u, v) for u, v in zip(mlp_weights(lone.params),
                                               mlp_weights(trained["mlp"][e])))
        check(same, f"ensemble member {e} differs from a lone stage with its seed")
    print(f"[check] train_dnn_ensemble on 2 members (2,000 steps, N={x.shape[0]}) equals two "
          f"lone train_dnn_stage calls with the members' seeds bitwise; "
          f"{out['member_train_s']:.3f} s per member: ok")

    # the data-parallel training pipeline on [cuda:0] * 4
    mesh = make_mesh(devices=["cuda:0"] * 4)
    cfg = _train_config(argparse.Namespace(small=False, seed=42, steps_scale=0.05,
                                           precision=None, skip_nonfinite=False))
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    res = run_training_pipeline(cfg, n_normal=6000, n_fault=800, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    dp_wall = time.perf_counter() - t0
    dp_l = dict(build.LAUNCHES)
    dnn_steps = sum(s.n_iter for s in cfg.schedule if s.name == "dnn")
    check(dp_l["train_dnn"] == 0 and dp_l["train_dnn_grad"] == 4 * dnn_steps
          and dp_l["train_dnn_adam"] == dnn_steps and dp_l["mc_dropout"] == 4
          and dp_l["residuals"] >= 1, f"data-parallel pipeline launches {dp_l}")
    ref = run_training_pipeline(cfg, n_normal=6000, n_fault=800, device="cuda")

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    # λ_t, λ_h, λ_o see x alone: float32 summation order apart.  λ_v reads the
    # MLP's prediction, whose first DNN stage (200 dropout steps) Adam moves
    # apart in the two runs; and a λ_v stage near its optimum turns the
    # shards' summation order into ±lr steps where a gradient element changes
    # sign.  So λ_v of the whole runs is held at LAM_V_WHOLE_RTOL, between
    # the sound run's reading and that of a planted fault (every shard's DNN
    # masks drawn at row offset 0, as if the global row were lost), and its
    # two stages from one MLP at rtol 1e-4 at 25 steps each, the length of
    # JAX's own mesh-parity test (tests/test_parallel.py,
    # TestDataParallelSchedule); their reading at the schedule's 200 steps
    # each is printed.
    lam_err = {g: rel(res.params[g], ref.params[g]) for g in LAMBDA_GROUPS}
    d = res.dataset
    for steps in (25, None):
        lam_v_only = tuple(dataclasses.replace(s, n_iter=steps or s.n_iter)
                           for s in cfg.schedule if s.name == "lambda_v")
        v_dp, _ = run_schedule(res.params, d.x_train, d.y_train, d.scaler_x, d.scaler_y,
                               schedule=lam_v_only, mesh=mesh)
        v_one, _ = run_schedule(res.params, d.x_train, d.y_train, d.scaler_x, d.scaler_y,
                                schedule=lam_v_only)
        n_v = lam_v_only[0].n_iter
        lam_err[f"lam_v, 2 x {n_v} steps from one MLP"] = rel(v_dp["lam_v"], v_one["lam_v"])
        if steps is not None:
            torch.testing.assert_close(v_dp["lam_v"], v_one["lam_v"], rtol=1e-4, atol=1e-6)
    head = cfg.schedule[:3]  # the first DNN stage and both λ_v stages set λ_v
    check([s.name for s in head] == ["dnn", "lambda_v", "lambda_v"]
          and all(s.name != "lambda_v" for s in cfg.schedule[3:]),
          f"the schedule's λ_v no longer ends at stage 2: {cfg.schedule}")
    params0 = init_pinn(cfg.model.layers, generator=torch.Generator().manual_seed(cfg.seed),
                        device=dev)
    with _row_offsets_lost():
        planted, _ = run_schedule(params0, d.x_train, d.y_train, d.scaler_x, d.scaler_y,
                                  schedule=head, seed=cfg.seed, dropout_p=cfg.model.dropout_p,
                                  mesh=mesh)
    lam_err["lam_v, planted fault (row offsets 0)"] = rel(planted["lam_v"], ref.params["lam_v"])
    print(f"[check] λ sharded against unsharded, max relative difference "
          f"{json.dumps(lam_err)}")
    for g in ("lam_t", "lam_h", "lam_o"):
        torch.testing.assert_close(res.params[g], ref.params[g], rtol=1e-4, atol=1e-6)
    check(lam_err["lam_v"] <= LAM_V_WHOLE_RTOL,
          f"λ_v of the sharded and unsharded pipelines {lam_err['lam_v']:.3e} apart "
          f"(relative), over {LAM_V_WHOLE_RTOL:g}")
    check(lam_err["lam_v, planted fault (row offsets 0)"] > LAM_V_WHOLE_RTOL,
          "the planted fault passes λ_v's bound: the bound tells nothing")
    build.reset_launches()
    again, _ = build_comprehensive_results(
        res.params, res.dataset, mc_seed=default_mc_seed(cfg.seed), mc_times=cfg.mc_times,
        dropout=cfg.mc_dropout, smooth_window=cfg.smooth_window)
    check(build.LAUNCHES["mc_dropout"] == 1, "the unsharded export did not run the MC kernel once")
    check(np.array_equal(res.results.array, again.array, equal_nan=True),
          "the sharded export differs from the unsharded export of the same params")
    print(f"[slice] data-parallel training on {mesh} (schedule x 0.05, N={x.shape[0]}; wall "
          f"{dp_wall:.1f} s): launches {json.dumps(dp_l)}; per stage (s) "
          f"{json.dumps({n: round(t, 4) for n, t in res.log.seconds})}; the artifact (MC "
          f"columns included) equals the unsharded export of its params bitwise; λ_t, λ_h, "
          f"λ_o and the λ_v stages from one MLP (25 steps each) against the unsharded runs at "
          f"rtol 1e-4, λ_v of the whole runs at {LAM_V_WHOLE_RTOL:g} (the planted fault "
          f"over it): ok")
    out.update(launches_data_parallel=dp_l, dp_pipeline_wall_s=dp_wall,
               dp_stage_s=dict(res.log.seconds), lam_rel_err=lam_err)

    # the sharded DNN stage against the whole-stage kernel, from phase 6's
    # initial weights as phase 6 holds the kernel, at phase 6's tolerances;
    # the loss trace at rtol 5e-3 of its own scale (its largest |loss|): the
    # heteroscedastic loss crosses zero, where a relative band means nothing
    # (a step at loss 1.6e-3 came 6.6e-5 apart, the whole trace 1.8e-3)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=dev)
    shards = shard_batch(mesh, x, y)
    hp = dict(lr_step=5, lr_gamma=0.5, dropout_p=0.2)
    k_sh = train_dnn_sharded(mlp, shards, 7, 20, **hp)
    k_whole = train_dnn(mlp, x, y, 7, 20, **hp)
    p_sh = train_dnn_sharded_plain(mlp, shards, 7, 20, **hp)
    torch.cuda.synchronize()
    errs = {name: (float((k_sh.losses - o.losses).abs().max()),
                   max(max_abs_err(a, b) for a, b in zip(mlp_weights(k_sh.mlp),
                                                         mlp_weights(o.mlp))))
            for name, o in (("whole-stage kernel", k_whole), ("per-shard plain", p_sh))}
    print(f"[check] sharded DNN stage, max |Δloss| and |Δweight| against {json.dumps(errs)}")
    for other in (k_whole, p_sh):
        torch.testing.assert_close(k_sh.losses[0], other.losses[0], rtol=2e-5, atol=0)
        scale = float(other.losses.abs().max())
        torch.testing.assert_close(k_sh.losses, other.losses, rtol=5e-3,
                                   atol=max(1e-5, 5e-3 * scale))
        for a, b in zip(mlp_weights(k_sh.mlp), mlp_weights(other.mlp)):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-3)
    err = max(e for pair in errs.values() for e in pair)

    # from the trained MLP, where Adam moves runs of another summation order
    # apart: the sharded stage against the whole-stage kernel, beside the
    # whole-stage kernel against its own plain version (the same 20 steps;
    # the second witness of the size of a summation-order gap there) and a
    # planted fault (every shard's masks at row offset 0)
    mlp = res.params["mlp"]
    k_sh = train_dnn_sharded(mlp, shards, 7, 20, **hp)
    k_whole = train_dnn(mlp, x, y, 7, 20, **hp)
    p_whole = train_dnn_stage_plain(mlp, x, y, 7, 20, **hp)
    k_lost = train_dnn_sharded(mlp, shards._replace(offsets=(0,) * len(shards.offsets)), 7,
                               20, **hp)
    torch.cuda.synchronize()

    def weight_gap(a, b):
        return max(max_abs_err(u, v) for u, v in zip(mlp_weights(a.mlp), mlp_weights(b.mlp)))

    trained_gaps = {"sharded vs whole-stage kernel": weight_gap(k_sh, k_whole),
                    "whole-stage kernel vs its plain version": weight_gap(k_whole, p_whole),
                    "planted fault (row offsets 0) vs whole-stage kernel":
                        weight_gap(k_lost, k_whole)}
    print(f"[check] from the trained MLP, 20 steps, max |Δweight| {json.dumps(trained_gaps)}")
    check(trained_gaps["sharded vs whole-stage kernel"] <= TRAINED_WEIGHT_ATOL,
          f"from the trained MLP the sharded stage is over {TRAINED_WEIGHT_ATOL:g} from the "
          f"whole-stage kernel: {trained_gaps}")
    check(trained_gaps["planted fault (row offsets 0) vs whole-stage kernel"]
          > TRAINED_WEIGHT_ATOL, "the planted fault passes the trained-MLP bound")
    out["trained_mlp_weight_gaps"] = trained_gaps
    out["dp_step_ms"] = cuda_ms(lambda: train_dnn_sharded(mlp, shards, 7, 200), repeats=3) / 200
    out["whole_step_ms"] = cuda_ms(lambda: train_dnn(mlp, x, y, 7, 200), repeats=3) / 200
    out["dp_max_abs_err"] = err
    print(f"[check] sharded DNN stage (4 shards on one card, 20 steps) against the whole-stage "
          f"kernel and its per-shard plain version: loss[0] rtol 2e-5, losses rtol 5e-3 (atol "
          f"5e-3 of the trace's largest |loss|), weights rtol=atol=5e-3, max |Δ| {err:.3e}: ok")
    print(f"[time] DNN stage per step: sharded over 4 shards on one card "
          f"{out['dp_step_ms']:.4f} ms, whole-stage kernel {out['whole_step_ms']:.4f} ms "
          f"(CUDA events, 200-step stages, median of 3)")

    # the MC kernel over four shards against one launch; ensemble_moments
    xt, seed = res.dataset.x_test, default_mc_seed(cfg.seed)
    out["mc_sharded_ms"] = cuda_ms(lambda: mc_dropout_sharded(mlp, xt, seed, mesh), repeats=3)
    out["mc_whole_ms"] = cuda_ms(lambda: mc_dropout(mlp, xt, seed), repeats=3)
    ens8 = init_ensemble(0, 8, device=dev)
    out["ensemble_moments_ms"] = cuda_ms(lambda: ensemble_moments(ens8, xt), repeats=5)
    print(f"[time] MC kernel over 4 row shards {out['mc_sharded_ms']:.3f} ms, one launch "
          f"{out['mc_whole_ms']:.3f} ms (N={xt.shape[0]}, mc_times 2000); ensemble_moments at "
          f"E=8, N={xt.shape[0]}: {out['ensemble_moments_ms']:.3f} ms")

    # phase 9's commands again with --data-parallel
    camp = os.path.join(keep_dir, "campaign")
    flags = ["--normal-mat", os.path.join(camp, "Polar-1.mat"), "--fault-dir", camp]
    with tempfile.TemporaryDirectory() as tmp:
        ck, mats = os.path.join(tmp, "ck"), {k: os.path.join(tmp, f"{k}.mat")
                                            for k in ("train", "score")}
        t_out, t_l, t_wall = run_cli(
            "train", *flags, "--steps-scale", "0.1", "--resume-dir", os.path.join(tmp, "rd"),
            "--ckpt-every", "100", "--ckpt", ck, "--mat-out", mats["train"], "--data-parallel")
        check("data-parallel over 1 devices" in t_out and t_l == campaign_launches["train"],
              f"cli train --data-parallel launches {t_l}, phase 9 {campaign_launches['train']}")
        s_out, s_l, s_wall = run_cli("score", "--ckpt", os.path.join(keep_dir, "ck"), *flags,
                                     "--mat-out", mats["score"], "--data-parallel")
        check("MC export sharded over 1 devices" in s_out and s_l == campaign_launches["score"],
              f"cli score --data-parallel launches {s_l}")
        # a .mat header carries its creation time: the arrays are compared
        same = [np.array_equal(load_comprehensive_results(mats[k]).array,
                               load_comprehensive_results(os.path.join(keep_dir, f)).array,
                               equal_nan=True)
                for k, f in (("train", "F01_train.mat"), ("score", "F01_scored.mat"))]
        check(all(same) and _same_files(ck + ".npz", os.path.join(keep_dir, "ck.npz")),
              f"--data-parallel on one card changed the artifacts {same} or the checkpoint")
    print(f"[slice] phase 9's cli train (wall {t_wall:.1f} s) and cli score (wall {s_wall:.1f} "
          "s) with --data-parallel on one card: the same launches; the artifacts equal phase "
          "9's bitwise and the checkpoint byte for byte: ok")
    out.update(dp_cli_train_wall_s=t_wall, dp_cli_score_wall_s=s_wall)
    return out


# phase 20's bounds on a sharded result against the unsharded one on the card,
# each between the sound reading and a planted fault's (both printed by the
# phase): the means of the sharded EM fit (largest |Δ| relative to the
# unsharded fit's largest |mean|; the weights and covariances are printed
# beside them: a covariance of the largest feature's scale drifts by float32
# cancellation), and the fleet's per-sample outputs (largest |Δ| of v_pred in
# V and rf_smooth, a NaN-set difference counting as infinite)
GMM_SHARDED_RTOL = 1e-3
FLEET_SHARDED_ATOL = 1e-3


@contextlib.contextmanager
def _pad_rows_weighted():
    """A planted fault for phase 20: ``parallel/diagnosis.py``'s pad rows get
    weight 1, as if the row mask were lost."""
    from pinnfc_tpu_torch.parallel import diagnosis

    real = diagnosis._pad_rows

    def weighted(arr, multiple):
        padded, mask = real(arr, multiple)
        return padded, torch.ones_like(mask)

    diagnosis._pad_rows = weighted
    try:
        yield
    finally:
        diagnosis._pad_rows = real


@contextlib.contextmanager
def _dummy_streams_first():
    """A planted fault for phase 20: the sharded fleet's dummy streams go
    before the real ones, so the first S results kept (written back to the
    bank) begin with a dummy stream's."""
    from pinnfc_tpu_torch.serving import monitor

    real = monitor._pad_streams

    def first(x_bank, v_bank, states, pad, fresh):
        if not pad:
            return real(x_bank, v_bank, states, pad, fresh)
        s_n, b_n, f_n = x_bank.shape
        return (np.concatenate([np.zeros((pad, b_n, f_n), x_bank.dtype), x_bank]),
                np.concatenate([np.zeros((pad, b_n), v_bank.dtype), v_bank]),
                [fresh] * pad + list(states))

    monitor._pad_streams = first
    try:
        yield
    finally:
        monitor._pad_streams = real


def _mixture_gap(a, b) -> dict:
    """Largest |Δ| of two mixtures' weights, means and covariances, each
    relative to ``b``'s largest magnitude of that field."""
    return {f: float((getattr(a, f) - getattr(b, f)).abs().max() / getattr(b, f).abs().max())
            for f in ("weights", "means", "covariances")}


def _fleet_gap(got: dict, want: dict) -> float:
    """Largest |Δ| of v_pred and rf_smooth over the streams; inf where the NaN
    sets differ."""
    gap = 0.0
    for s, w in want.items():
        for f in ("v_pred", "rf_smooth"):
            a, b = getattr(got[s], f), getattr(w, f)
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                return float("inf")
            fin = np.isfinite(b)
            gap = max(gap, float(np.max(np.abs(a[fin] - b[fin]), initial=0.0)))
    return gap


def run_downstream_parallel_slice(trained, gmm_result, keep_dir: str) -> dict:
    """Phase 20: the downstream half of ``parallel/`` on a mesh that lists the
    card four times, each sharded result against the unsharded run on the
    card: ``run_gmm_pipeline(mesh=)`` (k-means init) and the sharded EM fit
    (with a planted fault: pad rows at weight 1), ``input_saliency``,
    ``lambda_identifiability`` and ``condition_recovery`` (400 steps, held by
    outcome), a fleet of 30 streams × 64 rows through the sharded
    ``observe_many`` (four residual-kernel launches per call, the kernel held
    against its plain version on each shard; a planted fault: a dummy
    stream's result written back) and ``fleet_replay``; then ``gmm``,
    ``identify``, ``explain``, ``whatif`` and ``monitor --fleet`` with and
    without ``--data-parallel`` in one subprocess over phase 9's files, and
    ``serve --ckpt --data-parallel`` for one /observe_many.  Returns what it
    measured."""
    from pinnfc_tpu_torch.config import GmmConfig
    from pinnfc_tpu_torch.data.contract import INDEX, load_comprehensive_results
    from pinnfc_tpu_torch.diagnosis import parse_features, run_gmm_pipeline
    from pinnfc_tpu_torch.diagnosis.gmm import gmm_fit
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
    from pinnfc_tpu_torch.parallel.diagnosis import gmm_fit_dp
    from pinnfc_tpu_torch.parallel.mesh import make_mesh
    from pinnfc_tpu_torch.physics.residuals import all_residuals
    from pinnfc_tpu_torch.risk import estimate_mu_sigma_normal
    from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor, fleet_replay
    from pinnfc_tpu_torch.uq import (
        CounterfactualConfig, condition_recovery, input_saliency, lambda_identifiability,
        normal_calibration_scores)

    arr, ds, params = trained.results.array, trained.dataset, trained.params
    sx, sy = ds.scaler_x, ds.scaler_y
    mesh = make_mesh(devices=["cuda:0"] * 4)
    out = {"mesh": str(mesh)}

    # script 03: the pipeline, then the EM fit on rows that pad (9,597 of the
    # fault rows: three pad rows), with the planted fault
    cfg = GmmConfig()
    sh, out["gmm_pipeline_s"] = _synced(lambda: run_gmm_pipeline(arr, cfg, device="cuda",
                                                                   mesh=mesh))
    one, out["gmm_pipeline_unsharded_s"] = _synced(lambda: run_gmm_pipeline(arr, cfg,
                                                                            device="cuda"))
    out["gmm_accuracy"] = [sh.accuracy, one.accuracy]
    out["gmm_pipeline_gap"] = _mixture_gap(sh.model, one.model)
    check(abs(sh.accuracy - one.accuracy) <= 0.005,
          f"sharded GMM pipeline accuracy {sh.accuracy:.4f}, unsharded {one.accuracy:.4f}")
    feats = arr[arr[:, INDEX["label"]] > 0][:9597][:, parse_features(cfg.features)]
    n_comp = cfg.n_components_factor * 4

    def fit(sharded):
        gen = torch.Generator().manual_seed(cfg.random_state)
        if sharded:
            return gmm_fit_dp(feats, gen, n_comp, mesh, max_iter=cfg.max_iter, tol=cfg.tol,
                              reg_covar=cfg.reg_covar)
        return gmm_fit(feats, gen, n_comp, max_iter=cfg.max_iter, tol=cfg.tol,
                       reg_covar=cfg.reg_covar, device="cuda")

    whole = fit(False)
    gaps = {"sharded": _mixture_gap(fit(True), whole)}
    with _pad_rows_weighted():
        gaps["planted fault (pad rows at weight 1)"] = _mixture_gap(fit(True), whole)
    out["gmm_fit_gaps"] = gaps
    print(f"[check] sharded GMM EM on {len(feats)} rows over 4 shards (3 pad rows) against the "
          f"unsharded fit, largest relative |Δ| per field {json.dumps(gaps)}; the pipeline's "
          f"{json.dumps(out['gmm_pipeline_gap'])}, accuracy {json.dumps(out['gmm_accuracy'])}")
    check(gaps["sharded"]["means"] <= GMM_SHARDED_RTOL,
          f"the sharded EM fit's means are {gaps['sharded']['means']:.3e} from the unsharded "
          f"fit's, over {GMM_SHARDED_RTOL:g}")
    check(gaps["planted fault (pad rows at weight 1)"]["means"] > GMM_SHARDED_RTOL,
          "the planted fault passes the GMM bound: the bound tells nothing")

    # saliency and identifiability of the 15,600 rows
    x_raw = arr[:, :8].astype(np.float32)
    sal, out["saliency_s"] = _synced(lambda: input_saliency(params, x_raw, sx, sy, mesh=mesh))
    sal1, out["saliency_unsharded_s"] = _synced(lambda: input_saliency(params, x_raw, sx, sy,
                                                                        device="cuda"))
    out["saliency_err"] = {}
    for f in ("jac_norm", "jac_range", "sigma_jac_range"):
        a, b = getattr(sal, f), getattr(sal1, f)
        out["saliency_err"][f] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
        check(a.shape == b.shape and out["saliency_err"][f] <= 1e-6,
              f"sharded saliency {f}: {out['saliency_err'][f]:.3e} of max|J| from unsharded")
    x_norm = np.asarray(sx.transform(x_raw), np.float32)
    idf, out["identifiability_s"] = _synced(
        lambda: lambda_identifiability(params, x_norm, sx, sy, mesh=mesh))
    idf1, out["identifiability_unsharded_s"] = _synced(
        lambda: lambda_identifiability(params, x_norm, sx, sy))
    out["identifiability_stderr_rel"] = {}
    for g in idf1:
        a, b = idf[g], idf1[g]
        check((a.n_residuals, a.n_dropped, a.dof) == (b.n_residuals, b.n_dropped, b.dof)
              and np.array_equal(a.identifiable, b.identifiable),
              f"sharded identifiability {g}: rows {a.n_residuals}/{a.n_dropped} against "
              f"{b.n_residuals}/{b.n_dropped}")
        ok = np.isfinite(b.stderr)
        rel = float(np.max(np.abs(a.stderr[ok] - b.stderr[ok]) / b.stderr[ok], initial=0.0))
        out["identifiability_stderr_rel"][g] = rel
        check(rel <= 1e-4 and abs(a.sigma2 - b.sigma2) <= 1e-5 * abs(b.sigma2),
              f"sharded identifiability {g}: stderr {rel:.3e} relative, σ² {a.sigma2} / "
              f"{b.sigma2}")
    print(f"[check] sharded saliency of {len(x_raw)} rows, |Δ|/max|J| "
          f"{json.dumps(out['saliency_err'])} (≤ 1e-6); identifiability stderr relative "
          f"{json.dumps(out['identifiability_stderr_rel'])} (≤ 1e-4), rows and flags equal: ok")

    # the counterfactual at 400 steps, held by outcome (phase 16's reason)
    ccfg = CounterfactualConfig(steps=400)
    recs, out["recovery_s"] = _synced(lambda: condition_recovery(arr, params, sx, sy,
                                                                 config=ccfg, mesh=mesh))
    recs1, out["recovery_unsharded_s"] = _synced(lambda: condition_recovery(
        arr, params, sx, sy, config=ccfg, device="cuda"))
    frac_err, d_err, n_rows = 0.0, 0.0, 0
    for a, b in zip(recs, recs1):
        check((a.fault_name, a.current_target, a.n_rows) == (b.fault_name, b.current_target,
                                                             b.n_rows), "recovery conditions")
        if a.report is None:
            continue
        n_rows += a.n_rows
        check(np.abs(a.report.v_before - b.report.v_before).max() <= 1e-5, "recovery v_before")
        frac_err = max(frac_err, abs(float(a.report.recovered.mean())
                                     - float(b.report.recovered.mean())))
        d_err = max(d_err, float(np.abs(a.report.delta_range - b.report.delta_range).max()))
    out["recovery"] = {"rows": n_rows, "padded_rows": (-n_rows) % 4,
                       "recovered_frac_err": frac_err, "delta_err": d_err}
    check(frac_err <= 0.1, f"sharded recovery's recovered fraction {frac_err} from unsharded")
    print(f"[check] sharded condition_recovery (400 steps, {n_rows} rows): recovered fraction "
          f"within {frac_err:.4f} (≤ 0.1) of the unsharded solve, max |Δδ| {d_err:.3e}: ok")

    # the fleet: 30 streams × 64 rows, two rounds, sharded against unsharded
    mu, sigma = estimate_mu_sigma_normal(arr)
    calib = np.sort(normal_calibration_scores(arr, score="absolute", calib_frac=1.0)
                    .astype(np.float32))
    head = DiagnosisHead.from_gmm_result(gmm_result)

    def make(sharded):
        return OnlineMonitor(params, sx, sy, mu, sigma, diagnosis=head, conformal_calib=calib,
                             device="cuda", mesh=mesh if sharded else None)

    keys = [f"f{i}" for i in range(30)]

    def bank(rnd):
        rows = [np.arange(520 * i + 64 * rnd, 520 * i + 64 * (rnd + 1)) for i in range(30)]
        return (np.stack([arr[r, :8] for r in rows]).astype(np.float32),
                np.stack([arr[r, INDEX["y_true"]] for r in rows]).astype(np.float32))

    sharded, plain = make(True), make(False)
    gap, launches = 0.0, []
    for rnd in range(2):
        xb, vb = bank(rnd)
        torch.cuda.synchronize()
        build.reset_launches()
        got = sharded.observe_many(xb, vb, keys)
        torch.cuda.synchronize()
        launches.append(build.LAUNCHES["residuals"])
        gap = max(gap, _fleet_gap(got, plain.observe_many(xb, vb, keys)))
    with _dummy_streams_first():
        planted = make(True).observe_many(*bank(0), keys)
    fleet_gaps = {"sharded": gap,
                  "planted fault (a dummy stream's result written back)":
                      _fleet_gap(planted, make(False).observe_many(*bank(0), keys))}
    out["fleet_gaps"], out["launches_sharded_fleet"] = fleet_gaps, launches
    print(f"[check] sharded observe_many, 30 streams x 64 rows over 4 shards (2 dummy "
          f"streams), largest |Δ| of v_pred and rf_smooth against the unsharded monitor "
          f"{json.dumps(fleet_gaps)}; residual-kernel launches per call {launches}")
    check(launches == [4, 4], f"the sharded fleet step launched the residual kernel {launches} "
                              "times per call, not once per shard")
    check(gap <= FLEET_SHARDED_ATOL, f"the sharded fleet is {gap:.3e} from the unsharded one, "
                                     f"over {FLEET_SHARDED_ATOL:g}")
    check(fleet_gaps["planted fault (a dummy stream's result written back)"]
          > FLEET_SHARDED_ATOL, "the planted fault passes the fleet bound")
    # the kernel against its plain version on each shard's rows (8 streams;
    # the last shard holds the two dummy streams' zero rows)
    xb, _ = bank(0)
    xb = np.concatenate([xb, np.zeros((2,) + xb.shape[1:], np.float32)])
    res_err = 0.0
    for k in range(4):
        x_norm_k = sx.transform(torch.as_tensor(xb[8 * k:8 * (k + 1)].reshape(-1, 8),
                                                device="cuda"))
        with torch.no_grad():
            u = params["mlp"](x_norm_k)[0]
        kb = all_residuals_kernel(params, x_norm_k, u, sx, sy)
        pb = all_residuals(params, x_norm_k, u, sx, sy)
        for name, a, b in zip(kb._fields, kb, pb):
            check(torch.equal(torch.isnan(a), torch.isnan(b)), f"shard {k} {name}: NaN sets")
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, equal_nan=True)
            res_err = max(res_err, max_abs_err(a, b))
    out["residual_kernel_shard_err"] = res_err
    print(f"[check] residual kernel against its plain version on each of the 4 shards' 512 "
          f"rows: max abs err {res_err:.3e} (rtol=atol=2e-5), NaN sets identical: ok")
    ts = {True: [], False: []}
    for _ in range(11):
        for s_, mon_ in ((True, sharded), (False, plain)):
            t0 = time.perf_counter()
            mon_.observe_many(*bank(0), keys)
            ts[s_].append(time.perf_counter() - t0)
    out["observe_many_30x64_ms"] = {"sharded_4": statistics.median(ts[True][1:]) * 1e3,
                                    "unsharded": statistics.median(ts[False][1:]) * 1e3}
    table, out["fleet_replay_s"] = _synced(lambda: fleet_replay(make(True), arr))
    table1, out["fleet_replay_unsharded_s"] = _synced(lambda: fleet_replay(make(False), arr))
    for a, b in zip(table, table1):
        check(a.stream == b.stream and a.first_v_alarm == b.first_v_alarm, f"fleet {a.stream}")
        for f in ("first_warn", "first_danger"):
            ga, gb = getattr(a, f), getattr(b, f)
            check((ga is None) == (gb is None) and (ga is None or abs(ga - gb) <= 1),
                  f"sharded fleet_replay {a.stream} {f}: {ga}, unsharded {gb}")
    print(f"[time] observe_many 30 x 64 (host clock, synchronized, warm, median of 10) "
          f"{json.dumps(out['observe_many_30x64_ms'])} ms; fleet_replay sharded "
          f"{out['fleet_replay_s']:.3f} s, unsharded {out['fleet_replay_unsharded_s']:.3f} s "
          f"(first alarms within one sample)")

    # the commands with and without --data-parallel over phase 9's files
    ck, mat = os.path.join(keep_dir, "ck"), os.path.join(keep_dir, "F01_scored.mat")
    argvs = [["gmm", "--mat", mat], ["identify", "--ckpt", ck, "--mat", mat],
             ["explain", "--ckpt", ck, "--mat", mat],
             ["whatif", "--ckpt", ck, "--mat", mat, "--json"],
             ["monitor", "--mat", mat, "--ckpt", ck, "--fleet"]]
    runs, cli_l, err, out["cli_wall_s"] = run_cli_many(
        *(a for argv in argvs for a in (argv, argv + ["--data-parallel"])))
    check([rc for _, rc in runs] == [0] * 10, f"cli exit codes {[rc for _, rc in runs]}:\n"
                                              f"{err[-3000:]}")
    banner = {"gmm": "GMM EM data-parallel over 1 devices\n",
              "identify": "residual Jacobians data-parallel over 1 devices\n",
              "explain": "saliency data-parallel over 1 devices\n",
              "whatif": "recovery solve data-parallel over 1 devices\n", "monitor": ""}
    for k, argv in enumerate(argvs):
        plain_out, flagged = runs[2 * k][0], runs[2 * k + 1][0]
        b = banner[argv[0]]
        check(flagged.startswith(b) and flagged[len(b):] == plain_out and plain_out,
              f"cli {argv[0]} --data-parallel printed otherwise than without the flag:\n"
              f"{flagged[:1500]}\n---\n{plain_out[:1500]}")
    check(cli_l["residuals"] > 0, f"cli monitor --fleet launched no residual kernel: {cli_l}")
    out["cli_launches"] = cli_l
    print(f"[slice] cli gmm, identify, explain, whatif --json and monitor --fleet on the card "
          f"over phase 9's files with --data-parallel (one card: a mesh of one device) print "
          f"what they print without it, the mesh line aside (wall {out['cli_wall_s']:.1f} s "
          f"for the ten): ok")

    # serve --data-parallel for one /observe_many, against the in-process monitor
    xb, vb = bank(0)
    req = [("/observe_many", {"streams": keys[:6], "x": xb[:6].tolist(),
                              "v": vb[:6].tolist()})]
    resp, secs, _ = serve_process(["--mat", mat, "--ckpt", ck, "--data-parallel"], req)
    mu9, sigma9 = estimate_mu_sigma_normal(load_comprehensive_results(mat).array)
    want = _replay_requests(OnlineMonitor.from_checkpoint(ck, mu9, sigma9, device="cuda"), req)
    check(resp[0][0] == 200 and resp[0][1] == want[0],
          "serve --data-parallel /observe_many differs from the in-process monitor's")
    out["serve_observe_many_ms"] = secs[0] * 1e3
    print(f"[slice] cli serve --ckpt --data-parallel on 127.0.0.1: one /observe_many of 6 "
          f"streams ({secs[0] * 1e3:.1f} ms) equals the in-process monitor's payload: ok")
    return out


# Phase 21's bands for the training kernel's bf16 form against its bf16 plain
# version.  One-step gradient, as the worst tensor's max|Δg| / max|g|: on the
# CPU (tests/_torch_precision_probe.py) a float32 against a float64
# accumulation of the same bf16 operands reads 9.5e-6 at N = 6,000 (5.5e-5 at
# N = 512), and the float32 form against the bf16 one 4.0e-3 (the planted
# fault, which must fail the band).
BF16_GRAD_BAND = 1e-3
# 20 steps at lr 0.01: the share of weights more than 1e-3 from the bf16
# plain version's (Adam turns a flipped sign of a near-zero gradient element
# into a step of 2 lr, so the largest gap says nothing); the losses within
# BF16_LOSS_BAND of the trace's largest |loss|.  On the CPU, 20 steps of a
# float32 against a float64 accumulation of bf16 operands leave 0.0034 % of
# the weights further than 1e-3 at N = 6,000 (0 % at N = 37); the float32
# form against the bf16 one 42.8 % (3.4 %), its losses 3.2e-2 (7.6e-3) of the
# largest |loss| apart.
BF16_WEIGHT_SHARE = 0.01
BF16_LOSS_BAND = 1e-2


def rel_gap(got, want) -> float:
    """The worst tensor's max|Δ| / max|want| over two lists of tensors."""
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for a, b in zip(got, want))


def weight_share(a_mlp, b_mlp, tol: float = 1e-3) -> float:
    """The share of weights (all tensors) further apart than ``tol``."""
    from pinnfc_tpu_torch.ops.train_dnn import flat_weights

    return float(((flat_weights(a_mlp) - flat_weights(b_mlp)).abs() > tol).double().mean())


def falls(losses) -> tuple:
    """(median of the first tenth, median of the rest, whether it fell).  At
    lr 0.01 a DNN stage's loss wanders between about -1.7 and +0.3 after its
    first hundred steps in every form (3xTF32 and bf16, kernel and plain),
    with spikes of a tenth's median, so the rest of the stage is read as one
    median rather than by its last tenth as phase 7 reads it."""
    losses = np.asarray(losses)
    tenth = max(1, len(losses) // 10)
    first, rest = float(np.median(losses[:tenth])), float(np.median(losses[tenth:]))
    return first, rest, bool(np.isfinite(losses).all()) and rest < first


def run_cli_together(*argvs, timeout: int = 600):
    """Each argv through ``python -m pinnfc_tpu_torch.cli`` in its own
    subprocess, all started together: [(standard output, launch counts)] in
    order, and the wall seconds of all."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", CLI_RUNNER, *argv], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for argv, proc in zip(argvs, procs):
            out, _ = proc.communicate(timeout=timeout)
            check(proc.returncode == 0, f"cli {' '.join(argv)} exited {proc.returncode}:\n"
                                        f"{out[-4000:]}")
            counts = [ln for ln in out.splitlines() if ln.startswith("LAUNCHES ")]
            check(len(counts) == 1, f"cli {argv[0]} printed no launch counts")
            outs.append((out, json.loads(counts[0][len("LAUNCHES "):])))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs, time.perf_counter() - t0


def check_bf16_grads(mlp, x, y, seed: int, tf32: bool = True) -> dict:
    """The kernel's one-step gradient (``step_grads``) in the bf16 form and,
    with ``tf32``, the 3xTF32 form against the plain version on the card;
    returns the gaps."""
    from pinnfc_tpu_torch.ops import train_dnn as td
    from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants

    thresh, inv_keep = dropout_constants(0.2)
    n = x.shape[0]
    keep = td.keep_masks(n, mlp.dropout_widths(), seed, 0, thresh, x.device)
    ws = td.mlp_weights(mlp)
    k_loss, k_g = td.step_grads(mlp, x, y, seed, 0, precision="default")
    p_loss, p_g = td.loss_and_grads(ws, x, y, keep, inv_keep, td._inv_n(n), torch.bfloat16)
    f_loss, f_g = td.loss_and_grads(ws, x, y, keep, inv_keep, td._inv_n(n))
    torch.cuda.synchronize()
    gaps = {"bf16_kernel_vs_bf16_plain": rel_gap(k_g, p_g),
            "fp32_plain_vs_bf16_plain (planted fault)": rel_gap(f_g, p_g),
            "bf16_kernel_vs_fp32_plain": rel_gap(k_g, f_g),
            "loss_rel_bf16": float((k_loss - p_loss).abs() / p_loss.abs())}
    check(gaps["bf16_kernel_vs_bf16_plain"] <= BF16_GRAD_BAND,
          f"N={n}: the bf16 kernel's one-step gradient is outside its band: {gaps}")
    check(gaps["fp32_plain_vs_bf16_plain (planted fault)"] > BF16_GRAD_BAND,
          f"N={n}: the float32 gradient (a planted fault) passes the bf16 band: {gaps}")
    if tf32:
        kh_loss, kh_g = td.step_grads(mlp, x, y, seed, 0, precision="highest")
        _, d_g = td.loss_and_grads([w.double() for w in ws], x.double(), y.double(), keep,
                                   inv_keep, td._inv_n(n))
        torch.cuda.synchronize()
        gaps.update({"3xtf32_kernel_vs_fp32_plain": rel_gap(kh_g, f_g),
                     "3xtf32_kernel_vs_fp64_plain": rel_gap(kh_g, d_g),
                     "fp32_plain_vs_fp64_plain": rel_gap(f_g, d_g),
                     "3xtf32_kernel_vs_fp64_plain_per_tensor": [rel_gap([a], [b]) for a, b in
                                                                 zip(kh_g, d_g)],
                     "loss_rel_3xtf32": float((kh_loss - f_loss).abs() / f_loss.abs())})
        # float32 accuracy: as close to float64 as the float32 plain version is
        tf32_bound = max(4 * gaps["fp32_plain_vs_fp64_plain"], 1e-6)
        check(gaps["3xtf32_kernel_vs_fp64_plain"] <= tf32_bound,
              f"N={n}: the 3xTF32 kernel's one-step gradient is not float32-accurate: "
              f"{gaps['3xtf32_kernel_vs_fp64_plain']:.3e} of max|g| from float64, bound "
              f"{tf32_bound:.3e}")
        print(f"[check] train_dnn 3xTF32 form, N={n}: one-step gradient "
              f"{gaps['3xtf32_kernel_vs_fp64_plain']:.3e} of max|g| from a float64 gradient, "
              f"within max(4 × the float32 plain version's "
              f"{gaps['fp32_plain_vs_fp64_plain']:.3e}, 1e-6): ok")
    print(f"[check] train_dnn bf16 form, N={n}: one-step gradient (pinnfc_train_dnn_grad) "
          f"within {BF16_GRAD_BAND:g} of max|g| of the bf16 plain version, the float32 "
          f"plain gradient (planted fault) outside it; worst tensor's max|Δg|/max|g| "
          f"{json.dumps(gaps)}: ok")
    return gaps


# phase 21's rows of the bf16 form's one-step gradient: the campaign's 6,000
# and 37 rows (both forms), then rows ragged against the bf16 form's 64-row
# CTAs and the 512-row mask blocks
BF16_GRAD_ROWS = (6000, 37, 511, 513, 1000)


def run_bf16_slice(dev, train_ds, mlp) -> dict:
    """Phase 21: the training kernel's bf16 form (precision "default") against
    its bf16 plain version, ``cli train --precision default`` three ways, the
    non-flagship stage at "default", and both forms' times."""
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.models.mlp import MLP, aleatoric_loss
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.ops import train_dnn as td
    from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants
    from pinnfc_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from pinnfc_tpu_torch.training import stages

    x, y = train_ds.x_train, train_ds.y_train
    seed, hp, bf = 20240601, dict(lr=0.01, lr_step=5, lr_gamma=0.5), torch.bfloat16
    out = {"grad_gaps": {n: check_bf16_grads(mlp, x[:n], y[:n], seed, tf32=n in (6000, 37))
                         for n in BF16_GRAD_ROWS}}

    traces = {}
    for n in (6000, 37):
        k = td.train_dnn(mlp, x[:n], y[:n], seed, 20, precision="default", **hp)
        k2 = td.train_dnn(mlp, x[:n], y[:n], seed, 20, precision="default", **hp)
        p = td.train_dnn_stage_plain(mlp, x[:n], y[:n], seed, 20, product_dtype=bf, **hp)
        f = td.train_dnn_stage_plain(mlp, x[:n], y[:n], seed, 20, **hp)
        torch.cuda.synchronize()
        same = torch.equal(k.losses, k2.losses) and torch.equal(
            td.flat_weights(k.mlp), td.flat_weights(k2.mlp))
        check(same, f"two bf16 training-kernel runs with one seed differ at N={n}")
        scale = float(p.losses.abs().max())
        loss_gap = float((k.losses - p.losses).abs().max()) / scale
        t = {"loss0_rel": float((k.losses[0] - p.losses[0]).abs() / p.losses[0].abs()),
             "loss_gap_of_max": loss_gap,
             "fp32_loss_gap_of_max": float((f.losses - p.losses).abs().max()) / scale,
             "weight_share_1e-3": weight_share(k.mlp, p.mlp),
             "fp32_weight_share_1e-3": weight_share(f.mlp, p.mlp),
             "max_abs_dweight": max_abs_err(td.flat_weights(k.mlp), td.flat_weights(p.mlp))}
        check(t["loss0_rel"] <= 1e-3, f"N={n}: bf16 kernel loss[0] against the plain: {t}")
        check(loss_gap <= BF16_LOSS_BAND and t["weight_share_1e-3"] <= BF16_WEIGHT_SHARE,
              f"N={n}: the bf16 kernel's 20-step stage against its plain version: {t}")
        traces[n] = t
        print(f"[check] train_dnn bf16 form vs its bf16 plain version, N={n}, 20 steps at lr "
              f"0.01: two runs bitwise equal; loss[0] within 1e-3, the losses within "
              f"{BF16_LOSS_BAND:g} of the largest |loss|, at most {BF16_WEIGHT_SHARE:.0%} of "
              f"the weights further than 1e-3 (the float32 plain version beside them): "
              f"{json.dumps(t)}: ok")
    out["stage_20"] = traces

    whole = td.train_dnn(mlp, x, y, seed, 210, precision="default", **hp)
    first = td.train_dnn(mlp, x, y, seed, 200, precision="default", **hp)
    rest = td.train_dnn(first.mlp, x, y, seed, 10, t0=200, state=first.state,
                        precision="default", **hp)
    same = torch.equal(rest.losses, whole.losses[200:]) and torch.equal(
        td.flat_weights(rest.mlp), td.flat_weights(whole.mlp)) and int(rest.state.count) == 210
    check(same, "the bf16 kernel as a chunk from step 200 differs from the whole stage")
    x_nan = x.clone()
    x_nan[17, 3] = float("nan")
    s = td.train_dnn(mlp, x_nan, y, seed, 5, skip_nonfinite=True, precision="default", **hp)
    check(torch.equal(td.flat_weights(s.mlp), td.flat_weights(mlp))
          and bool(torch.isnan(s.losses).all()),
          "bf16 form: skip_nonfinite with a NaN row changed the weights")
    print("[check] train_dnn bf16 form: a chunk from step 200 with the carried Adam state "
          "bitwise the whole 210-step stage; a NaN row with skip_nonfinite leaves the "
          "weights as they were: ok")

    # the sharded stage: per-step grad launches on [cuda:0] * 4
    shards = shard_batch(make_mesh(devices=["cuda:0"] * 4), x, y)
    torch.cuda.synchronize()
    build.reset_launches()
    sh_mlp, _, sh_loss = stages.train_dnn_chunk_sharded(mlp, None, shards, seed, 0, 20,
                                                        precision="default", **hp)
    torch.cuda.synchronize()
    sh_launches = dict(build.LAUNCHES)
    check(sh_launches["train_dnn_grad"] == 80 and sh_launches["train_dnn_adam"] == 20
          and sh_launches["train_dnn"] == 0, f"sharded bf16 stage launches {sh_launches}")
    wk = td.train_dnn(mlp, x, y, seed, 20, precision="default", **hp)
    scale = float(wk.losses.abs().max())
    sh = {"loss_gap_of_max": float((sh_loss - wk.losses).abs().max()) / scale,
          "weight_share_1e-3": weight_share(sh_mlp, wk.mlp), "launches": sh_launches}
    check(sh["loss_gap_of_max"] <= BF16_LOSS_BAND
          and sh["weight_share_1e-3"] <= BF16_WEIGHT_SHARE,
          f"the sharded bf16 stage against the whole-stage bf16 kernel: {sh}")
    out["sharded_4"] = sh
    print(f"[check] train_dnn_chunk_sharded(precision='default') on [cuda:0] * 4, 20 steps, "
          f"against the whole-stage bf16 kernel: {json.dumps(sh)}: ok")

    # cli train --precision default three ways, all three processes at once
    with tempfile.TemporaryDirectory() as tmp:
        common = ["train", "--precision", "default", "--steps-scale", "0.1"]
        ways = {"plain": [], "ckpt_every_100": ["--ckpt-every", "100", "--resume-dir",
                                                os.path.join(tmp, "rd")],
                "data_parallel": ["--data-parallel"]}
        argvs = [common + extra + ["--ckpt", os.path.join(tmp, w), "--mat-out",
                                   os.path.join(tmp, f"{w}.mat"), "--metrics-jsonl",
                                   os.path.join(tmp, f"{w}.jsonl")]
                 for w, extra in ways.items()]
        runs, cli_wall = run_cli_together(*argvs)
        cli = {}
        for (w, _), (stdout, counts) in zip(ways.items(), runs):
            rows = [json.loads(ln) for ln in open(os.path.join(tmp, f"{w}.jsonl"))]
            traces = {r["stage"]: r["loss_trace"] for r in rows
                      if r["event"] == "stage" and r["stage"].endswith(":dnn")}
            dnn = {k: falls(v) for k, v in traces.items()}
            # the first DNN stage trains from the initial weights and must fall;
            # a later one starts trained (a fresh Adam at lr 0.01 need not lower
            # it further at 0.1 of its steps, in either precision) and must stay
            # below the untrained level, the first stage's first-tenth median
            first, *later = sorted(dnn, key=lambda k: int(k.split(":")[0]))
            trained = dnn[first][2] and all(
                np.isfinite(traces[k]).all() and dnn[k][1] < dnn[first][0] for k in later)
            check(len(dnn) == 2 and trained,
                  f"cli train --precision default ({w}): the first DNN stage's loss did not "
                  f"fall, or a later one rose to the untrained level: {dnn}")
            with open(os.path.join(tmp, f"{w}.meta.json")) as fh:
                check(json.load(fh)["config"]["model"]["precision"] == "default",
                      f"{w}: the sidecar does not record precision 'default'")
            cli[w] = {"launches": counts, "dnn_loss_medians_first_tenth_rest": dnn,
                      "dnn_loss_medians_by_tenth": {k: tenths(v) for k, v in traces.items()}}
        want = {"plain": 2, "ckpt_every_100": 12}
        for w, k in want.items():
            check(cli[w]["launches"]["train_dnn"] == k and cli[w]["launches"]["mc_dropout"] == 1,
                  f"cli train --precision default ({w}) launches {cli[w]['launches']}")
        dp = cli["data_parallel"]["launches"]
        if torch.cuda.device_count() == 1:  # a data axis of size 1: the unsharded path
            check(dp["train_dnn"] == 2, f"--data-parallel on one card launches {dp}")
        else:
            check(dp["train_dnn_grad"] > 0, f"--data-parallel launches {dp}")
        arrays = {w: load_comprehensive_results(os.path.join(tmp, f"{w}.mat")).array
                  for w in ways}
        if torch.cuda.device_count() == 1:
            check(all(np.array_equal(arrays["plain"], a, equal_nan=True)
                      for a in arrays.values()),
                  "the chunked or --data-parallel cli train's artifact differs from the "
                  "plain run's")
    out["cli"], out["cli_wall_s"] = cli, cli_wall
    print(f"[slice] cli train --precision default --steps-scale 0.1, three processes at once "
          f"(wall {cli_wall:.1f} s): the first DNN stage's loss fell (the median after its "
          f"first tenth below that of its first tenth), the later one stayed below that "
          f"first tenth's; launches and loss medians "
          f"{json.dumps(cli)}; the three artifacts equal on one card: ok")

    # the non-flagship stage at "default": bf16-operand autograd, no kernel
    deep = MLP(NON_FLAGSHIP, generator=torch.Generator().manual_seed(3), device=dev)
    thresh, inv_keep = dropout_constants(0.2)
    keep = td.keep_masks(x.shape[0], deep.dropout_widths(), seed, 0, thresh, dev)
    ws = [w.detach().requires_grad_(True) for w in td.mlp_weights(deep)]
    grads = {}
    for name, dtype in (("bf16", bf), ("fp32", None)):
        with torch.enable_grad():
            pred, lv = torch.func.functional_call(
                deep, stages._named_params(ws, deep), (x,),
                {"keep": keep, "dropout_p": 0.2, "product_dtype": dtype})
            grads[name] = torch.autograd.grad(aleatoric_loss(y, pred, lv), ws)
    _, hand = td.loss_and_grads(td.mlp_weights(deep), x, y, keep, inv_keep,
                                td._inv_n(x.shape[0]), bf)
    ng = {"autograd_bf16_vs_hand_bf16": rel_gap(grads["bf16"], hand),
          "autograd_fp32_vs_hand_bf16 (planted fault)": rel_gap(grads["fp32"], hand)}
    check(ng["autograd_bf16_vs_hand_bf16"] <= BF16_GRAD_BAND
          < ng["autograd_fp32_vs_hand_bf16 (planted fault)"],
          f"the non-flagship bf16 gradient against the hand-derived one: {ng}")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    res = stages.train_dnn_stage(deep, x, y, 17, 200, precision="default")
    torch.cuda.synchronize()
    deep_ms = (time.perf_counter() - t0) / 200 * 1e3
    check(sum(build.LAUNCHES.values()) == 0, f"the autograd stage launched {build.LAUNCHES}")
    hi = stages.train_dnn_stage(deep, x, y, 17, 200, precision="highest")
    d_first, d_rest, d_fell = falls(res.losses.cpu().numpy())
    check(d_fell, f"the non-flagship stage at 'default' did not fall: {d_first} → {d_rest}")
    ng.update(ms_per_step=deep_ms, loss_median_first=d_first, loss_median_rest=d_rest,
              final_loss=float(res.losses[-1]), final_loss_highest=float(hi.losses[-1]),
              weight_share_vs_highest=weight_share(res.params, hi.params))
    out["non_flagship"] = ng
    print(f"[check] non-flagship {NON_FLAGSHIP} at 'default' on the card: one-step gradient "
          f"of the bf16-operand autograd within {BF16_GRAD_BAND:g} of the hand-derived bf16 "
          f"one, the float32 autograd (planted fault) outside; 200 steps, no kernel launch, "
          f"the loss fell: {json.dumps(ng)}: ok")

    # both forms' times in this call: highest, default, default, highest
    steps = 200
    ms = {"highest": [], "default": []}
    for form in ("highest", "default", "default", "highest"):
        ms[form].append(cuda_ms(lambda: td.train_dnn(mlp, x, y, 7, steps, precision=form),
                                repeats=3) / steps)
    plain_ms = cuda_ms(lambda: td.train_dnn_stage_plain(mlp, x, y, 7, 20, product_dtype=bf),
                       repeats=2) / 20
    # the step kernels only: a later profiler session of the process has
    # shown no device time for the once-per-stage transpose (1 µs)
    breakdown, traced, per_step = kernel_breakdown(
        lambda: td.train_dnn(mlp, x, y, 7, 50, precision="default"), 50, BF16_STEP_KERNELS,
        BF16_STEP_KERNELS)
    flop = TRAIN_FLOP_PER_ROW_STEP * x.shape[0]
    n_param = sum(p.numel() for p in mlp.parameters())
    t_bytes = 4 * (x.shape[0] * 9 + 2 * n_param) / steps + 4
    bound = max(flop / BF16_PEAK, t_bytes / HBM_RATE) * 1e3
    out.update(ms_bf16=ms["default"], ms_3xtf32=ms["highest"], plain_bf16_ms=plain_ms,
               bound_bf16_ms=bound, kernel_ms_per_step_bf16=breakdown,
               traced_launches_50_steps_bf16=traced, device_launches_per_step_bf16=per_step,
               scratch_bytes_per_step_bf16=int(
                   build.load().pinnfc_train_dnn_bf16_scratch_bytes(x.shape[0])))
    print(f"[time] train_dnn per step of a {steps}-step stage at N={x.shape[0]} (median of 3, "
          f"in turns): 3xTF32 {ms['highest']} ms, bf16 {ms['default']} ms; bf16 bound "
          f"{bound:.5f} ms (operations, 989 TFLOP/s), bf16 at {bound / min(ms['default']):.1%} "
          f"of it; bf16 plain {plain_ms:.4f} ms/step; profiler, 50-step bf16 stage: "
          f"{per_step} device launches per step, per-kernel device ms/step "
          f"{json.dumps(breakdown)}; fwd_bwd_bf16_kernel writes "
          f"{out['scratch_bytes_per_step_bf16']:,} bytes of scratch per step")
    return out


# phase 22's bound on cli bench's steps/s against 1 / (phase 8's ms/step):
# both time the whole-stage kernel on 6,000 rows; bench's stages end in a read
BENCH_RTOL = 0.10
ADMIN_CHECKS = ["versions", "environment", "compilation_cache", "warmup_coverage",
                "backend_probe", "smoke_train"]


def run_admin_slice(params, ds, t_ms: float) -> dict:
    """Phase 22: ``cli doctor --smoke``, ``cli warmup`` in both forms, ``cli
    bench`` in one subprocess, the warmup coverage after them, and the
    production steps' memory at campaign scale."""
    from pinnfc_tpu_torch.config import TrainConfig
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
    from pinnfc_tpu_torch.utils.memory import production_memory_report
    from pinnfc_tpu_torch.utils.warmup import warmup_coverage

    out = {}
    argvs = [["doctor", "--smoke", "--json"], ["warmup", "--json"],
             ["warmup", "--precision", "default", "--json"], ["bench"]]
    runs, launches, err, out["cli_wall_s"] = run_cli_many(*argvs)
    for argv, (text, rc) in zip(argvs, runs):
        check(rc == 0, f"cli {' '.join(argv)} exited {rc}:\n{text[-3000:]}\n{err[-3000:]}")
    checks = json.loads(runs[0][0].strip().splitlines()[-1])
    check([c["name"] for c in checks] == ADMIN_CHECKS and all(c["ok"] for c in checks),
          f"cli doctor --smoke: {json.dumps(checks)[-3000:]}")
    probe, smoke = checks[-2], checks[-1]
    check(probe["capability"] == [9, 0] and smoke["train_dnn_launches"] == 2,
          f"doctor probe {probe}, smoke {smoke}")
    out["doctor"] = {"probe": probe["detail"], "smoke": smoke["detail"],
                     "smoke_steps_per_sec": smoke["steps_per_sec"],
                     "smoke_first_call_s": smoke["first_call_s"]}
    print(f"[slice] cli doctor --smoke: every check ok; {probe['detail']}; {smoke['detail']}")
    warmed = []
    for argv, (text, _) in zip(argvs[1:3], runs[1:3]):
        doc = json.loads(text.strip().splitlines()[-1])
        warmed += [r["program"] for r in doc["programs"]]
        out[" ".join(argv[:-1])] = {r["program"]: r["compile_s"] for r in doc["programs"]}
        print(f"[slice] cli {' '.join(argv)}: {len(doc['programs'])} programs in "
              f"{doc['total_compile_s']} s ({doc['already_cached']} found the library built)")
    cov = warmup_coverage()
    check(cov["ok"] and {f"cuda:{p}" for p in warmed} <= set(cov["present"]),
          f"warmup coverage after cli warmup: {cov}")
    out["coverage"] = cov["detail"]
    print(f"[check] warmup coverage: {cov['detail']}: ok")
    doc = json.loads(runs[3][0].strip().splitlines()[-1])
    want = 1e3 / t_ms
    check(abs(doc["value"] / want - 1) <= BENCH_RTOL and doc["throughput_steady_steps_per_sec"] > 0
          and doc["mfu_pct"] is not None,
          f"cli bench {doc} against 1/(phase 8's {t_ms:.4f} ms/step) = {want:.1f} steps/s")
    out["bench"] = doc
    print(f"[check] cli bench: {json.dumps(doc)}; value within {BENCH_RTOL:.0%} of 1/(phase 8's "
          f"ms/step) = {want:.1f}: ok")
    # the default schedule has two distinct DNN stages: two launches per warmup,
    # and bench's four stages per form
    check(launches["train_dnn"] == 2 * 2 + 2 * 4 and launches["mc_dropout"] == 2
          and launches["residuals"] >= 2, f"phase 22 launches {launches}")
    out["launches"] = launches

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        save_checkpoint(ck, params, ds.scaler_x, ds.scaler_y)
        recs = production_memory_report(TrainConfig(), ckpt_path=ck, device="cuda")
    out["memory_s"] = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    for r in recs:
        check(r["total_bytes"] == total and 0 <= r["peak_bytes"] <= r["resident_bytes"] < total,
              f"memory of {r['program']}: {r}")
        print(f"[slice] memory {r['program']:<44} peak {r['peak_bytes'] / 2**20:10.2f} MiB, "
              f"resident {r['resident_bytes'] / 2**20:10.2f} MiB of {total / 2**30:.2f} GiB")
    check([r["program"] for r in recs][-2:] == ["monitor_step[b64]", "monitor_fleet[S64,b64]"],
          f"memory report programs {[r['program'] for r in recs]}")
    out["memory"] = {r["program"]: r["peak_bytes"] for r in recs}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from pinnfc_tpu_torch.config import TrainConfig, train_config_to_dict
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.device import resolve_device
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.ops.mc_dropout import mc_dropout_sums, mc_dropout_sums_plain
    from pinnfc_tpu_torch.ops.residuals import (
        all_residuals_kernel, kernel_scalars, launch_floor, launch_residuals)
    from pinnfc_tpu_torch.ops.smoothing import smooth_by_segments
    from pinnfc_tpu_torch.physics.residuals import all_residuals
    from pinnfc_tpu_torch.pipeline.export import default_mc_seed
    from pinnfc_tpu_torch.pipeline.score import run_scoring_pipeline
    from pinnfc_tpu_torch.pipeline.train_pipeline import evaluate_voltage_metrics
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint

    # ---- 1. device ----
    dev = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.load()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    hmma = sass_hmma(lib)
    for fn in ("fwd_bwd_kernel", "wgrad_kernel"):  # the 3xTF32 form: TF32 HMMA
        check(hmma.get(fn, 0) > hmma.get(f"{fn}.bf16", 0),
              f"{fn}: the products of the training kernel's 3xTF32 form are not on the "
              f"tensor cores: HMMA counts {hmma}")
    for fn in ("fwd_bwd_bf16_kernel", "wgrad_bf16_kernel"):  # the bf16 form
        check(hmma.get(f"{fn}.bf16", 0) + hmma.get(f"{fn}.hgmma", 0) > 0,
              f"{fn}: the products of the training kernel's bf16 form are not on the tensor "
              f"cores: HMMA/HGMMA counts {hmma}")
    check(hmma.get("mc_sample_kernel.bf16", 0) > 0,
          f"the MC sample kernel's products are not on the tensor cores in bf16: {hmma}")
    print(f"[build] HMMA instructions in the SASS of csrc/train_dnn.cu and csrc/mc_dropout.cu "
          f"(bf16 ones under .bf16, wgmma's HGMMA under .hgmma): {json.dumps(hmma)}")

    # ---- 3. kernel vs plain on the card ----
    gen = torch.Generator().manual_seed(0)
    params = init_pinn(generator=gen, device=dev)
    mlp = params["mlp"]
    x_small = torch.as_tensor(
        np.random.RandomState(1).uniform(-1.2, 1.2, (1000, 8)).astype(np.float32), device=dev)
    seed, m_small = 123456789, 64
    k_sums = mc_dropout_sums(mlp, x_small, seed, mc_times=m_small, dropout=0.4)
    b_sums = mc_dropout_sums_plain(mlp, x_small, seed, mc_times=m_small, dropout=0.4,
                                   sample_dtype=torch.bfloat16)
    f_sums = mc_dropout_sums_plain(mlp, x_small, seed, mc_times=m_small, dropout=0.4)
    torch.cuda.synchronize()
    check_mc(k_sums, b_sums, f_sums, m_small, f"N=1000 (ragged) mc_times={m_small}")

    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    dataset = combine_and_normalize(normal, faults, device=dev)
    n = dataset.x_test.shape[0]
    check(n == 15600, f"campaign has {n} rows, expected 15600")
    with torch.no_grad():
        u_eval = mlp(dataset.x_test)[0]
    res_err = 0.0
    nan_rows = {}
    for rows in (n, 37):
        for label, lam_il in (("init", None), ("i_l=1.2", 1.2), ("non-finite inputs", None)):
            p = dict(params)
            if lam_il is not None:
                p["lam_v"] = params["lam_v"].clone()
                p["lam_v"][2] = lam_il
            xr, ur = dataset.x_test[:rows], u_eval[:rows]
            if label == "non-finite inputs":
                xr, ur = with_nonfinite_rows(xr, ur)
            kb = all_residuals_kernel(p, xr, ur, dataset.scaler_x, dataset.scaler_y)
            pb = all_residuals(p, xr, ur, dataset.scaler_x, dataset.scaler_y)
            torch.cuda.synchronize()
            differ_msgs = []
            for name, a, b in zip(kb._fields, kb, pb):
                check(a.shape == b.shape == (rows, 1), f"residual {name}: shape {a.shape}")
                differ = torch.isnan(a) != torch.isnan(b)
                if differ.any():
                    differ_msgs.append(
                        f"{name} at rows {torch.nonzero(differ[:, 0]).flatten().tolist()[:12]}"
                        f" (kernel {a[differ].tolist()[:3]}, plain {b[differ].tolist()[:3]})")
            check(not differ_msgs, f"residual kernel: NaN sets differ from the plain version's "
                                   f"(N={rows}, {label}): {'; '.join(differ_msgs)}")
            for name, a, b in zip(kb._fields, kb, pb):
                torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, equal_nan=True)
                res_err = max(res_err, max_abs_err(a, b))
            nan_rows[f"N={rows} {label}"] = int(torch.isnan(kb.f_v).sum())
            if label == "non-finite inputs":
                nan_rows[f"N={rows} {label} (f_h, f_o)"] = [
                    int(torch.isnan(kb.f_h).sum()), int(torch.isnan(kb.f_o).sum())]
    check(nan_rows[f"N={n} i_l=1.2"] > 0, "the i_l=1.2 case produced no NaN rows to compare")
    print(f"[check] residual kernel vs plain, N={n} and N=37 (ragged), with rows past the "
          f"limiting current and with NaN, +inf and -inf in each input channel and a NaN u at "
          f"ragged positions: NaN rows {nan_rows} identical, max abs err {res_err:.3e} "
          f"(rtol=atol=2e-5): ok")

    # ---- 4. the scoring slice at full width ----
    cfg = TrainConfig()  # mc_times 2000, dropout 0.4, smoothing 200, seed 42
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "flagship")
        save_checkpoint(ckpt, params, dataset.scaler_x, dataset.scaler_y,
                        meta={"config": train_config_to_dict(cfg)})
        mat_path = os.path.join(tmp, "F01_scored.mat")
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = run_scoring_pipeline(ckpt, mat_path=mat_path, device="cuda", verbose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        reloaded = load_comprehensive_results(mat_path).array
    check(launches["mc_dropout"] > 0 and launches["residuals"] > 0,
          f"a kernel of the scoring path was not launched: {launches}")
    arr = res.results.array
    check(np.array_equal(reloaded, arr, equal_nan=True), "the .mat artifact does not round-trip")
    ds = res.dataset
    check_artifact(arr, params, ds, res.metrics, 15600)
    with torch.no_grad():
        base = mlp(ds.x_test)[0]
        scale_y, _ = ds.scaler_y.loss_affine()
    print(f"[slice] score N={arr.shape[0]} mc_times={cfg.mc_times}: launches {launches}, "
          f"wall {wall:.3f} s, timings {json.dumps(res.timings)}")
    print(f"[slice] metrics {json.dumps(res.metrics)}")
    torch.cuda.synchronize()
    build.reset_launches()
    own = evaluate_voltage_metrics(params, ds)
    torch.cuda.synchronize()
    metrics_launches = dict(build.LAUNCHES)
    check(metrics_launches["residuals"] == 1,
          f"evaluate_voltage_metrics(results=None) launches {metrics_launches}")
    from_artifact = evaluate_voltage_metrics(params, ds, results=res.results)
    check(own.keys() == from_artifact.keys(), f"metric keys {sorted(own)}")
    metric_rel = 0.0
    for key, want in from_artifact.items():
        got = own[key]
        check(np.isfinite(got) == np.isfinite(want), f"metric {key}: {got} against {want}")
        if np.isfinite(want):
            # an R² as 1 − R² = SS_res/SS_tot, the ratio computed
            g, w = (1.0 - got, 1.0 - want) if "_r2" in key else (got, want)
            check(abs(g - w) <= 1e-5 * abs(w) + 1e-7,
                  f"metric {key}: {got} without results, {want} from the artifact")
            metric_rel = max(metric_rel, abs(g - w) / max(abs(w), 1e-30))
    print(f"[check] evaluate_voltage_metrics(results=None) on the card: launches "
          f"{metrics_launches}; every metric within rtol 1e-5 (atol 1e-7; R² as 1 − R²) of "
          f"the results= path, max relative difference {metric_rel:.3e}: ok")

    # ---- 5. the main path's shapes: MC kernel vs plain, and timing ----
    x = ds.x_test
    mc_seed, m = default_mc_seed(cfg.seed), cfg.mc_times  # the seed the main path used
    k_full = mc_dropout_sums(mlp, x, mc_seed, mc_times=m)
    k_again = mc_dropout_sums(mlp, x, mc_seed, mc_times=m)
    b_full, mc_plain_ms = timed(lambda: mc_dropout_sums_plain(
        mlp, x, mc_seed, mc_times=m, sample_dtype=torch.bfloat16))
    f_full, mc_plain_fp32_ms = timed(lambda: mc_dropout_sums_plain(mlp, x, mc_seed, mc_times=m))
    p_mc, mc_err, mc_err_fp32 = check_mc(k_full, b_full, f_full, m,
                                         f"N={n} mc_times={m} seed {mc_seed}")
    check(torch.equal(k_full, k_again), "two MC-dropout kernel runs with one seed differ")
    print("[check] mc_dropout kernel: two runs bitwise equal: ok")
    boundaries = list(ds.info.boundary_lines)
    if boundaries and boundaries[-1] != n:
        boundaries.append(n)
    for col, std in ((10, p_mc.aleatoric_std), (11, p_mc.epistemic_std)):
        want = smooth_by_segments((std / (scale_y + 1e-12)).cpu().numpy(), boundaries,
                                  cfg.smooth_window)
        np.testing.assert_allclose(arr[:, col], want, rtol=1e-3, atol=1e-5,
                                   err_msg=f"column {col} against the bf16 plain MC statistics")
    print("[check] artifact columns 10, 11 against the bf16 plain MC statistics "
          "(rtol 1e-3 atol 1e-5): ok")
    mc_ms = cuda_ms(lambda: mc_dropout_sums(mlp, x, mc_seed, mc_times=m), repeats=3, warmup=False)
    print(f"[time] mc_dropout kernel {mc_ms:.3f} ms; plain with bf16 sample passes "
          f"{mc_plain_ms:.1f} ms, float32 {mc_plain_fp32_ms:.1f} ms (one run each)")
    mc_flop = MC_FLOP_PER_ROW_SAMPLE * n * (m + 1)
    mc_wide = MC_WIDE_FLOP_PER_ROW_SAMPLE * n * m
    mc_bytes = 4 * (n * 8 + n * 4 + sum(p.numel() for p in mlp.parameters()))
    # bf16 for the sample passes' wide products, float32 for the rest of the
    # sample passes (layer 0, the heads) and for the base pass
    mc_bound = max(mc_wide / BF16_PEAK + (mc_flop - mc_wide) / FP32_PEAK,
                   mc_bytes / HBM_RATE) * 1e3
    mc_bound_fp32 = max(mc_flop / FP32_PEAK, mc_bytes / HBM_RATE) * 1e3
    print(f"[time] mc_dropout kernel at {mc_ms:.3f} ms: {mc_bound / mc_ms:.1%} of its bound "
          f"({mc_bound:.3f} ms: bf16 wide products, float32 rest), {mc_bound_fp32 / mc_ms:.1%} "
          f"of its float32 bound ({mc_bound_fp32:.2f} ms)")
    u = k_full[:, 0]  # the main path's u: the MC base column, a strided view
    scalars = kernel_scalars(params, ds.scaler_x, ds.scaler_y)
    res_ms = graph_ms(lambda: launch_residuals(x, u, scalars), inner=50, repeats=5)
    res_floor_ms = graph_ms(lambda: launch_floor(n, x.device), inner=50, repeats=5)
    # one warp's rows: the latency of one row's chain, loads and stores
    res_37_ms = graph_ms(lambda: launch_residuals(x[:37], u[:37], scalars),
                         inner=50, repeats=5)
    res_wrapper_ms = cuda_ms(lambda: all_residuals_kernel(params, x, u, ds.scaler_x, ds.scaler_y),
                             repeats=5, inner=50)
    res_plain_ms = cuda_ms(lambda: all_residuals(params, x, u[:, None], ds.scaler_x,
                                                 ds.scaler_y), repeats=5, inner=50)
    res_bytes = 4 * (n * 8 + n + sum(build.RESIDUAL_SCALAR_SIZES.values()) + 8 * n)
    res_bound = max(res_bytes / HBM_RATE, RESIDUAL_FLOP_PER_ROW * n / FP32_PEAK) * 1e3
    print(f"[time] residual kernel {res_ms:.5f} ms, launch floor {res_floor_ms:.5f} ms "
          f"(each 50 launches in one CUDA graph, median of 5), bound {res_bound:.6f} ms "
          f"(bytes); on 37 rows (one CTA) {res_37_ms:.5f} ms; wrapper {res_wrapper_ms:.4f} ms; "
          f"plain {res_plain_ms:.4f} ms")

    # ---- 6. the training kernel vs plain at the training path's shape ----
    train_ds = combine_and_normalize(normal, faults, device=dev)
    check(train_ds.x_train.shape[0] == 6000, f"training rows {train_ds.x_train.shape[0]}")
    train_err = check_train_kernel(mlp, train_ds.x_train, train_ds.y_train)

    # ---- 7. the training slice ----
    trained, train_launches = run_training_slice()

    # ---- 8. timing at the training path's shapes ----
    t_ms, t_chunk_ms, t_plain_ms, t_per_step, t_traced, t_breakdown, lam_ms = time_training(
        mlp, trained.params, train_ds)
    n_tr = train_ds.x_train.shape[0]
    t_flop = TRAIN_FLOP_PER_ROW_STEP * n_tr
    n_param = sum(p.numel() for p in mlp.parameters())
    t_bytes = 4 * (n_tr * 9 + 2 * n_param) / 200 + 4  # x, y, weights in/out per 200 steps, loss
    # 3xTF32: three TF32 tensor-core products for every float32 one
    t_bound = max(3 * t_flop / TF32_PEAK, t_bytes / HBM_RATE) * 1e3
    t_bound_fp32 = max(t_flop / FP32_PEAK, t_bytes / HBM_RATE) * 1e3
    print(f"[time] train_dnn kernel at {t_ms:.4f} ms/step: {t_bound / t_ms:.1%} of its 3xTF32 "
          f"bound ({t_bound:.4f} ms), {t_bound_fp32 / t_ms:.1%} of its float32 bound "
          f"({t_bound_fp32:.4f} ms)")

    # ---- 9. the campaign slice through the command line ----
    keep = tempfile.TemporaryDirectory()  # phase 9's files, for phases 13-15
    campaign_launches = run_campaign_slice(dev, keep.name)

    # ---- 10. kill and resume on the card ----
    check_kill_and_resume(train_ds)

    # ---- 11. a non-flagship model at flagship width ----
    t0 = time.perf_counter()
    deep = run_non_flagship_slice(dev, train_ds)
    deep["phase_s"] = time.perf_counter() - t0

    # ---- 12. risk on the card ----
    t0 = time.perf_counter()
    risk = run_risk_slice(trained.results)
    risk["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phases 11-12 (s): {deep['phase_s']:.1f}, {risk['phase_s']:.1f}; "
          f"{json.dumps({'non_flagship': deep, 'risk': risk})}")

    # ---- 13. diagnosis on the card ----
    t0 = time.perf_counter()
    diag, gmm_fit = run_diagnosis_slice(trained.results, os.path.join(keep.name, "F01_scored.mat"))
    diag["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 13 (s): {diag['phase_s']:.1f}; {json.dumps({'diagnosis': diag})}")

    # ---- 14. the comparison of script 05 on the card ----
    t0 = time.perf_counter()
    comp = run_compare_slice(trained.results, os.path.join(keep.name, "F01_scored.mat"))
    comp["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 14 (s): {comp['phase_s']:.1f}; {json.dumps({'compare': comp})}")

    # ---- 15. explainability and figures on the card ----
    t0 = time.perf_counter()
    expl = run_explain_slice(trained, keep.name)
    expl["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 15 (s): {expl['phase_s']:.1f}; {json.dumps({'explain': expl})}")

    # ---- 16. serving and the counterfactual on the card ----
    t0 = time.perf_counter()
    serve = run_serving_slice(trained, gmm_fit, keep.name)
    serve["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 16 (s): {serve['phase_s']:.1f}; {json.dumps({'serving': serve})}")

    # ---- 17. run-all and the report on the card ----
    t0 = time.perf_counter()
    chain = run_all_slice(train_launches, keep.name)
    chain["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 17 (s): {chain['phase_s']:.1f}; {json.dumps({'run_all': chain})}")

    # ---- 18. export and serve on the card ----
    t0 = time.perf_counter()
    served = run_export_serve_slice(gmm_fit, keep.name)
    served["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 18 (s): {served['phase_s']:.1f}; "
          f"{json.dumps({'export_serve': served})}")

    # ---- 19. ensembles and data-parallel training on the card ----
    t0 = time.perf_counter()
    par = run_parallel_slice(dev, train_ds, campaign_launches, keep.name)
    par["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 19 (s): {par['phase_s']:.1f}; {json.dumps({'parallel': par})}")

    # ---- 20. the downstream half of parallel/ on the card ----
    t0 = time.perf_counter()
    down = run_downstream_parallel_slice(trained, gmm_fit, keep.name)
    keep.cleanup()
    down["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 20 (s): {down['phase_s']:.1f}; "
          f"{json.dumps({'downstream_parallel': down})}")

    # ---- 21. the training kernel's bf16 form on the card ----
    t0 = time.perf_counter()
    bf16 = run_bf16_slice(dev, train_ds, mlp)
    bf16["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 21 (s): {bf16['phase_s']:.1f}; {json.dumps({'bf16': bf16})}")

    # ---- 22. the operational commands on the card ----
    t0 = time.perf_counter()
    admin = run_admin_slice(trained.params, trained.dataset, t_ms)
    admin["phase_s"] = time.perf_counter() - t0
    print(f"[slice] phase 22 (s): {admin['phase_s']:.1f}; {json.dumps({'admin': admin})}")

    kernels = [
        {"name": "mc_dropout", "route": "cuda", "source": "pinnfc_tpu_torch/csrc/mc_dropout.cu",
         "replaces": "pinnfc_tpu/ops/pallas_mc_dropout.py:140",
         "shape": f"x ({n}, 8), mc_times {m}, flagship", "launches": launches["mc_dropout"],
         "max_abs_err": mc_err, "max_abs_err_fp32": mc_err_fp32, "ms": mc_ms,
         "plain_ms": mc_plain_ms, "plain_fp32_ms": mc_plain_fp32_ms, "bound_ms": mc_bound,
         "bound_by": "operations",
         "bound_is": "bf16 tensor cores for the sample passes' wide products, float32 for "
                     "their layer 0 and heads and for the base pass",
         "bound_fp32_ms": mc_bound_fp32, "bound_tf32_ms": mc_flop / TF32_PEAK * 1e3,
         "sass_hmma": {k: v for k, v in hmma.items() if k.startswith("mc_")},
         "bitwise_equal_runs": True,
         "launches_campaign_slice": {k: campaign_launches[k]["mc_dropout"]
                                     for k in ("train", "score")},
         "launches_run_all": chain["launches"]["mc_dropout"],
         "launches_sharded_export": par["launches_data_parallel"]["mc_dropout"],
         "ms_sharded_4": par["mc_sharded_ms"], "ms_whole_same_call": par["mc_whole_ms"],
         "library_ms": None},
        {"name": "residuals", "route": "cuda", "source": "pinnfc_tpu_torch/csrc/residuals.cu",
         "replaces": "pinnfc_tpu/ops/pallas_residuals.py:134",
         "shape": f"x ({n}, 8)", "launches": launches["residuals"],
         "max_abs_err": res_err, "ms": res_ms, "launch_floor_ms": res_floor_ms,
         "ms_37_rows": res_37_ms,
         "wrapper_ms": res_wrapper_ms, "plain_ms": res_plain_ms, "bound_ms": res_bound,
         "bound_by": "bytes",
         "launches_evaluate_metrics": metrics_launches["residuals"],
         "launches_monitor": serve["launches_monitor"],
         "launches_run_all": chain["launches"]["residuals"],
         "launches_per_exported_observe": served["launches_per_exported_observe"],
         "launches_per_fleet_observe_many": served["launches_fleet_observe_many"],
         "launches_sharded_fleet": down["launches_sharded_fleet"],
         "launches_campaign_slice": {k: campaign_launches[k]["residuals"]
                                     for k in ("train", "score")},
         "library_ms": None},
        {"name": "train_dnn", "route": "cuda", "source": "pinnfc_tpu_torch/csrc/train_dnn.cu",
         "replaces": "pinnfc_tpu/ops/pallas_train.py:239",
         "shape": f"x ({n_tr}, 8), flagship; times per step of a 200-step stage",
         "launches": train_launches["train_dnn"],
         "launches_campaign_slice": campaign_launches["train"]["train_dnn"],
         "launches_run_all": chain["launches"]["train_dnn"],
         "ms_chunk_from_t0": t_chunk_ms, "device_launches_per_step": t_per_step,
         "traced_launches_50_steps": t_traced, "max_abs_err": train_err, "ms": t_ms,
         "plain_ms": t_plain_ms, "bound_ms": t_bound, "bound_by": "operations",
         "bound_is": "3xTF32 on the tensor cores", "bound_fp32_ms": t_bound_fp32,
         "bound_tf32_ms": t_flop / TF32_PEAK * 1e3, "kernel_ms_per_step": t_breakdown,
         "sass_hmma": {k: v for k, v in hmma.items() if not k.startswith("mc_")},
         "launches_ensemble": par["launches_ensemble"]["train_dnn"],
         "launches_data_parallel_grad": par["launches_data_parallel"]["train_dnn_grad"],
         "launches_data_parallel_adam": par["launches_data_parallel"]["train_dnn_adam"],
         "ms_sharded_4": par["dp_step_ms"], "ms_whole_same_call": par["whole_step_ms"],
         "launches_warmup_bench": admin["launches"]["train_dnn"],
         "bench_steps_per_sec": admin["bench"]["value"],
         "bench_bf16_steps_per_sec": admin["bench"]["throughput_steady_steps_per_sec"],
         "library_ms": None,
         "bf16": {"precision": "default", "ms": min(bf16["ms_bf16"]),
                  "ms_runs": bf16["ms_bf16"], "ms_3xtf32_same_call": bf16["ms_3xtf32"],
                  "plain_ms": bf16["plain_bf16_ms"], "bound_ms": bf16["bound_bf16_ms"],
                  "bound_by": "operations", "bound_is": "bf16 on the tensor cores",
                  "grad_gap": bf16["grad_gaps"][6000]["bf16_kernel_vs_bf16_plain"],
                  "grad_gap_37_rows": bf16["grad_gaps"][37]["bf16_kernel_vs_bf16_plain"],
                  "grad_gap_planted_fault":
                      bf16["grad_gaps"][6000]["fp32_plain_vs_bf16_plain (planted fault)"],
                  "launches": bf16["cli"]["plain"]["launches"]["train_dnn"],
                  "launches_ckpt_every_100":
                      bf16["cli"]["ckpt_every_100"]["launches"]["train_dnn"],
                  "launches_sharded_grad": bf16["sharded_4"]["launches"]["train_dnn_grad"],
                  "kernels": list(BF16_STEP_KERNELS),
                  "kernel_ms_per_step": bf16["kernel_ms_per_step_bf16"],
                  "scratch_bytes_per_step": bf16["scratch_bytes_per_step_bf16"],
                  "grad_gap_by_rows": {n: g["bf16_kernel_vs_bf16_plain"]
                                       for n, g in bf16["grad_gaps"].items()},
                  "sass_hmma_bf16": {k: v for k, v in hmma.items()
                                     if k.endswith((".bf16", ".hgmma"))
                                     and not k.startswith("mc_")},
                  "library_ms": None}},
    ]
    print(f"[time] λ-stage ms/step {json.dumps(lam_ms)}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_times() -> int:
    """``--kernel-times``: the whole-stage training kernel per step of a
    200-step stage on the default campaign's 6,000 training rows (median of 5)
    and the MC kernel's 2,000 passes over its 15,600 rows (median of 3),
    flagship weights from ``torch.Generator().manual_seed(0)``, as one line.
    It calls only what both kernels had when they were ported (and the
    training kernel's bf16 form where ``train_dnn`` takes a precision), so a
    copy of this file beside another checkout of the port times that tree:
    parent, change, change, parent in one call compare two trees on one
    card."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.models.mlp import MLP
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.ops.mc_dropout import mc_dropout_sums
    from pinnfc_tpu_torch.ops.train_dnn import train_dnn

    build.build()
    build.load()
    dev = torch.device("cuda")
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    ds = combine_and_normalize(normal, faults, device=dev)
    mlp = MLP(generator=torch.Generator().manual_seed(0), device=dev)
    t = cuda_ms(lambda: train_dnn(mlp, ds.x_train, ds.y_train, 7, 200), repeats=5) / 200
    m = cuda_ms(lambda: mc_dropout_sums(mlp, ds.x_test, 12345, 2000), repeats=3)
    line = f"TIMES train_dnn {t:.5f} ms/step, mc_dropout {m:.3f} ms"
    if "precision" in inspect.signature(train_dnn).parameters:  # a tree with the bf16 form
        b = cuda_ms(lambda: train_dnn(mlp, ds.x_train, ds.y_train, 7, 200, precision="default"),
                    repeats=5) / 200
        line += f", train_dnn bf16 {b:.5f} ms/step"
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(kernel_times() if sys.argv[1:] == ["--kernel-times"] else main())
