"""Times of the eager ``OnlineMonitor`` step on the card, as phase 16 of
``chip_smoke.py`` takes them, for comparing two trees in one call.

    python3 -m pinnfc_tpu_torch.serving.observe_timing

The monitor is the flagship MLP with weights from
``torch.Generator().manual_seed(0)``, scalers fitted on the synthetic normal
set (``synthesize_stack_data(seed=0)``), a random 8-component, 5-class GMM
head on pV/pT/pH/pO, a 6,000-score conformal calibration vector and an
adaptive level (γ = 0.005).  The stream is phase 16's: the normal set's last
200 rows and fault segment 1, with NaN voltages first, NaN and ±inf inputs
and a voltage outage.  Times are the synchronized host clock (each call ends
in its one read), the median of 20 warm calls: ``observe`` at B = 1, 64, 256
and ``observe_many`` of 12 × 64.  The module uses only what the monitor has
had since it was ported, so a copy of it runs in an older tree to compare
the two on one card.  Prints the card line, then one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch


def _card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"


def _stream():
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data

    (x_n, y_n), faults = synthesize_stack_data(seed=0)
    x = np.vstack([x_n[-200:], faults[0][0]]).astype(np.float32)
    v = np.concatenate([y_n[-200:], faults[0][1]]).astype(np.float32).ravel()
    v[:3] = np.nan
    for k in range(24):
        x[300 + 3 * k, k % 8] = (np.nan, np.inf, -np.inf)[k // 8]
    v[600:640] = np.nan
    return x_n.astype(np.float32), np.asarray(y_n, np.float32).reshape(-1, 1), x, v


def build_monitor(device="cuda"):
    """The flagship monitor described above, and phase 16's stream."""
    from pinnfc_tpu_torch.data.scaling import AffineScaler
    from pinnfc_tpu_torch.diagnosis.gmm import GMMParams
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor

    x_n, y_n, x, v = _stream()
    params = init_pinn(generator=torch.Generator().manual_seed(0), device=device)
    sx = AffineScaler.fit(torch.from_numpy(x_n), device=device)
    sy = AffineScaler.fit(torch.from_numpy(y_n), device=device)
    rs = np.random.RandomState(0)
    comp = rs.uniform(0.1, 1.0, (8, 5)).astype(np.float32)
    head = DiagnosisHead(
        gmm=GMMParams(weights=torch.full((8,), 0.125, device=device),
                      means=torch.as_tensor(rs.randn(8, 4).astype(np.float32), device=device),
                      covariances=torch.eye(4, device=device).repeat(8, 1, 1),
                      converged=True, n_iter=1, lower_bound=0.0),
        comp_fault_prob=torch.as_tensor(comp / comp.sum(1, keepdims=True), device=device),
        class_names=tuple(f"class_{i}" for i in range(5)), feature_indices=(1, 2, 3, 4))
    calib = np.sort(np.abs(rs.randn(6000)).astype(np.float32))
    mon = OnlineMonitor(params, sx, sy, np.zeros(5, np.float32), np.ones(5, np.float32),
                        diagnosis=head, conformal_calib=calib, conformal_gamma=0.005,
                        device=device)
    return mon, x, v


def time_observe(mon, x, v) -> dict:
    """Phase 16's times of ``mon`` on the stream ``x``, ``v``."""
    mon.observe(x[:64], v[:64], stream="warm")
    out = {"observe_ms": {}}
    for b_n in (1, 64, 256):
        ts = []
        for rep in range(21):
            lo = (rep * b_n) % (len(x) - b_n)
            t0 = time.perf_counter()
            mon.observe(x[lo:lo + b_n], v[lo:lo + b_n], stream=f"t{b_n}")
            ts.append(time.perf_counter() - t0)
        out["observe_ms"][b_n] = statistics.median(ts[1:]) * 1e3
    xb = np.stack([x[64 * i:64 * (i + 1)] for i in range(12)])
    vb = np.stack([v[64 * i:64 * (i + 1)] for i in range(12)])
    keys = [f"s{i}" for i in range(12)]
    ts = []
    for _ in range(11):
        t0 = time.perf_counter()
        mon.observe_many(xb, vb, keys)
        ts.append(time.perf_counter() - t0)
    out["observe_many_12x64_ms"] = statistics.median(ts[1:]) * 1e3
    return out


def main() -> int:
    import pinnfc_tpu_torch
    from pinnfc_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("observe_timing: no CUDA device")
        return 1
    mon, x, v = build_monitor("cuda")
    build.reset_launches()
    out = time_observe(mon, x, v)
    out["residual_launches"] = build.LAUNCHES["residuals"]
    out["tree"] = os.path.dirname(os.path.dirname(os.path.abspath(pinnfc_tpu_torch.__file__)))
    print(_card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
