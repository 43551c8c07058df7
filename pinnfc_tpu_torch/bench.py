"""Training throughput of the port, ``cli bench`` (counterpart of the
repository's root ``bench.py``, which measures the JAX package).

    python -m pinnfc_tpu_torch.cli bench [--device cuda|cpu]

The stage-1 hot loop (full-batch dropout-MLP forward, backward and Adam,
reference 01:948-955) at the reference's scale, 6,000 training rows through
the flagship MLP, as one ``train_dnn_stage`` of 1,001 steps: on the card one
launch of ``csrc/train_dnn.cu``.  The first call (the kernel library's build
or load, and one stage) is timed apart; then three stages with other seeds,
each ending in a read of its last loss, and their median.  Both forms are
measured: ``precision="highest"`` (3xTF32, float32 accuracy) gives ``value``
and ``"default"`` (bf16 products, float32 accumulation) the ``throughput_*``
keys.  ``vs_baseline`` divides by the steps/s of the same step in plain
torch on the CPU, written as the reference trains.  Prints one JSON line
with the root ``bench.py``'s keys and writes no file.  ``mfu_pct`` divides
the step's product FLOPs by the card's dense bf16 peak (``PEAK_TFLOPS``, by
``torch.cuda.get_device_name``): None on the CPU or on a card missing from
the table.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

N_TRAIN = 6000
LAYERS = (8, 256, 256, 256, 1)
STEPS = 1001  # per timed stage
TORCH_STEPS = 30

# product FLOPs per training step, as the root bench.py counts them: forward
# 2·N·(in·out) per layer and a backward of twice that, 6·N·Σ(in·out), over the
# trunk, the mean head and the variance head (tanh, dropout and Adam excluded)
_MATMUL_IN_OUT = (
    8 * 256 + 256 * 256 + 256 * 256  # trunk
    + 256 * 1  # mean head
    + 256 * 128 + 128 * 64 + 64 * 1  # variance head
)
FLOPS_PER_STEP = 6 * N_TRAIN * _MATMUL_IN_OUT

# dense bf16 tensor-core peak, TFLOP/s, by torch.cuda.get_device_name
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}


def bench_stage(precision: str = "highest", device="cuda") -> Tuple[float, float]:
    """(steady steps/s, compile_s) of the flagship DNN stage in one form.
    ``compile_s`` is the first call's seconds less one steady stage's: the
    library's build or load."""
    from pinnfc_tpu_torch.device import resolve_device
    from pinnfc_tpu_torch.models.mlp import MLP
    from pinnfc_tpu_torch.training.stages import train_dnn_stage

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (N_TRAIN, 8)).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.uniform(-1, 1, (N_TRAIN, 1)).astype(np.float32), device=dev)
    mlp = MLP(LAYERS, generator=torch.Generator().manual_seed(0), device=dev)

    t0 = time.perf_counter()
    res = train_dnn_stage(mlp, x, y, 0, STEPS, precision=precision)
    if not np.isfinite(float(res.losses[-1])):
        raise RuntimeError(f"bench: non-finite loss in the first {precision} stage")
    first_call_s = time.perf_counter() - t0
    times = []
    for seed in range(1, 4):  # another seed each time, each ending in a read
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = train_dnn_stage(mlp, x, y, seed, STEPS, precision=precision)
        final = float(res.losses[-1])
        times.append(time.perf_counter() - t0)
        if not np.isfinite(final):
            raise RuntimeError(f"bench: non-finite loss in a {precision} stage")
    dt = statistics.median(times)
    return STEPS / dt, max(0.0, first_call_s - dt)


def bench_torch_cpu() -> float:
    """Steps/s of the reference's stage-1 step (01:929-955) in plain torch on
    the CPU: the same architecture, the heteroscedastic loss, full-batch
    Adam."""
    torch.manual_seed(0)
    hidden = []
    for i in range(len(LAYERS) - 2):
        hidden += [torch.nn.Linear(LAYERS[i], LAYERS[i + 1]), torch.nn.Tanh(),
                   torch.nn.Dropout(0.2)]
    trunk = torch.nn.Sequential(*hidden)
    mean_head = torch.nn.Linear(LAYERS[-2], LAYERS[-1])
    var_head = torch.nn.Sequential(
        torch.nn.Linear(LAYERS[-2], LAYERS[-2] // 2), torch.nn.Tanh(), torch.nn.Dropout(0.2),
        torch.nn.Linear(LAYERS[-2] // 2, LAYERS[-2] // 4), torch.nn.Tanh(),
        torch.nn.Linear(LAYERS[-2] // 4, 1),
    )
    params = [*trunk.parameters(), *mean_head.parameters(), *var_head.parameters()]
    opt = torch.optim.Adam(params, lr=0.01)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.uniform(-1, 1, (N_TRAIN, 8)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(-1, 1, (N_TRAIN, 1)), dtype=torch.float32)

    def step():
        h = trunk(x)
        pred = mean_head(h)
        log_var = torch.log(torch.nn.functional.softplus(var_head(h)) + 1e-6)
        loss = torch.mean(0.5 * torch.exp(-log_var) * (y - pred) ** 2 + 0.5 * log_var) \
            + 0.01 * torch.mean(torch.abs(log_var))
        opt.zero_grad()
        loss.backward()
        opt.step()

    for _ in range(3):
        step()
    t0 = time.perf_counter()
    for _ in range(TORCH_STEPS):
        step()
    return TORCH_STEPS / (time.perf_counter() - t0)


def _mfu_pct(steps_per_sec: float, dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    peak = PEAK_TFLOPS.get(torch.cuda.get_device_name(dev))
    return None if peak is None else 100.0 * steps_per_sec * FLOPS_PER_STEP / (peak * 1e12)


def run(device="cuda") -> dict:
    """Both forms and the CPU baseline; the JSON line's dict."""
    from pinnfc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    torch_sps = bench_torch_cpu()
    print(f"[bench] torch-cpu reference step: {torch_sps:.1f} steps/s "
          f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    sps, compile_s = bench_stage("highest", dev)
    print(f"[bench] {dev.type} highest (3xTF32 on the card): {sps:.1f} steps/s steady "
          f"(build or load {compile_s:.1f}s, timed apart)", file=sys.stderr)
    tp_sps, tp_compile_s = bench_stage("default", dev)
    print(f"[bench] {dev.type} default (bf16 on the card): {tp_sps:.1f} steps/s steady "
          f"(first call less a stage {tp_compile_s:.1f}s)", file=sys.stderr)
    mfu, tp_mfu = _mfu_pct(sps, dev), _mfu_pct(tp_sps, dev)
    return {
        "metric": "pinn_train_steps_per_sec",
        "value": round(sps, 2),
        "unit": "steps/s",
        "vs_baseline": round(sps / torch_sps, 2),
        "compile_s": round(compile_s, 2),
        "steady_steps_per_sec": round(sps, 2),
        "throughput_steady_steps_per_sec": round(tp_sps, 2),
        "flops_per_step": FLOPS_PER_STEP,
        "tflops": round(sps * FLOPS_PER_STEP / 1e12, 2),
        "mfu_pct": None if mfu is None else round(mfu, 2),
        "throughput_mfu_pct": None if tp_mfu is None else round(tp_mfu, 2),
    }


def main(device="cuda") -> int:
    print(json.dumps(run(device)))
    return 0
