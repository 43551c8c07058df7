"""The training kernel's 3xTF32 accuracy with another accumulation, on the card.

    python3 -m pinnfc_tpu_torch.ops.train_accum_trial

``csrc/train_dnn.cu``'s 3xTF32 form adds the three TF32 products of every k8
step into one ``mma.sync`` accumulator that runs over all k.  This builds a
copy in which each k8 step's three products go into a fresh accumulator
that is then added to the running sum in float32 ("fresh_accumulator"), and
holds both the unchanged source and the copy on the main path's shapes (the
default campaign's 6,000 training rows and their first 37, flagship weights
from ``init_pinn(generator=torch.Generator().manual_seed(0))``): the
one-step gradient (``step_grads``) against a float64 gradient of the plain
version under the same masks, beside the float32 plain version's, as the
worst tensor's max|Δg| / max|g|; the largest |Δweight| after 20 steps at lr
0.01 (StepLR every 5 steps, gamma 0.5) against the float32 plain version;
and the ms per step of a 200-step stage (median of 5), the unchanged source
first and last.  Copies are built into ``pinnfc_tpu_torch/build/trial/``.
Prints the card line, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from pinnfc_tpu_torch.ops import build

# name -> (text in csrc/train_dnn.cu, its replacement)
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "fresh_accumulator": [(
        "      for (int j = 0; j < TN; ++j) {\n"
        "        mma_tf32(c[i][j], al[i], bh[j]);\n"
        "        mma_tf32(c[i][j], ah[i], bl[j]);\n"
        "        mma_tf32(c[i][j], ah[i], bh[j]);\n"
        "      }",
        "      for (int j = 0; j < TN; ++j) {\n"
        "        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
        "        mma_tf32(p, al[i], bh[j]);\n"
        "        mma_tf32(p, ah[i], bl[j]);\n"
        "        mma_tf32(p, ah[i], bh[j]);\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < 4; ++e) c[i][j][e] += p[e];\n"
        "      }")],
}


def build_variants() -> Dict[str, ctypes.CDLL]:
    """The unchanged source ("source") and every variant, compiled by one
    nvcc process each, all at once, and loaded."""
    out_dir = build.BUILD_DIR / "trial"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in {"source": [], **VARIANTS}.items():
        src_text = (build.CSRC / "train_dnn.cu").read_text()
        for old, new in edits:
            if old not in src_text:
                raise ValueError(f"csrc/train_dnn.cu no longer contains {old[:60]!r}")
            src_text = src_text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(src_text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared", str(src), "-o",
               str(out_dir / f"{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = build.bind(ctypes.CDLL(str(out_dir / f"{name}.so")), build.TRAIN_ENTRIES)
    return libs


def rel_gap(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for a, b in zip(got, want))


def measure(mlp, x, y) -> dict:
    """The readings of the library that ``build.load()`` returns."""
    from pinnfc_tpu_torch.ops import train_dnn as td
    from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants

    seed, hp = 20240601, dict(lr=0.01, lr_step=5, lr_gamma=0.5)
    thresh, inv_keep = dropout_constants(0.2)
    out = {}
    for n in (6000, 37):
        xn, yn = x[:n], y[:n]
        keep = td.keep_masks(n, mlp.dropout_widths(), seed, 0, thresh, x.device)
        ws = td.mlp_weights(mlp)
        _, k_g = td.step_grads(mlp, xn, yn, seed, 0)
        _, f_g = td.loss_and_grads(ws, xn, yn, keep, inv_keep, td._inv_n(n))
        _, d_g = td.loss_and_grads([w.double() for w in ws], xn.double(), yn.double(), keep,
                                   inv_keep, td._inv_n(n))
        k = td.train_dnn(mlp, xn, yn, seed, 20, **hp)
        p = td.train_dnn_stage_plain(mlp, xn, yn, seed, 20, **hp)
        out[f"N={n}"] = {
            "kernel_vs_fp64": rel_gap(k_g, d_g), "fp32_plain_vs_fp64": rel_gap(f_g, d_g),
            "max_abs_dweight_20_steps": float(
                (td.flat_weights(k.mlp) - td.flat_weights(p.mlp)).abs().max())}
    stage = lambda: td.train_dnn(mlp, x, y, 7, 200)  # noqa: E731
    stage()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        stage()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / 200)
    out["ms_per_step"] = statistics.median(times)
    return out


def main() -> int:
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.models.pinn import init_pinn

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    ds = combine_and_normalize(normal, faults, device="cuda")
    mlp = init_pinn(generator=torch.Generator().manual_seed(0), device="cuda")["mlp"]
    readings: Dict[str, List[dict]] = {}
    own = build._Library.handle
    try:
        for name in ["source", *VARIANTS, *VARIANTS, "source"]:
            build._Library.handle = libs[name]
            readings.setdefault(name, []).append(measure(mlp, ds.x_train, ds.y_train))
            print(f"[trial] {name}: {json.dumps(readings[name][-1])}", flush=True)
    finally:
        build._Library.handle = own
    print(card)
    print(json.dumps({"readings": readings, "card": card,
                      "shape": "x (6000, 8) and its first 37 rows, flagship"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
