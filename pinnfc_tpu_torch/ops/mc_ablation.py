"""Where the MC-dropout sample kernel spends its time on the card.

    python3 -m pinnfc_tpu_torch.ops.mc_ablation

No profiler that reads inside a kernel runs on the chip machine, so this
builds copies of ``csrc/mc_dropout.cu`` with one part of the sample passes
removed each, and times every copy against the unchanged source on the main
path's shapes (the default campaign's 15,600 rows, 2,000 samples, the main
path's MC seed, flagship weights from ``torch.Generator().manual_seed(0)``).  A copy computes wrong
statistics: only its time is read.  The time a removal saves bounds what that
part costs where it does not overlap the rest.  Copies are built into
``pinnfc_tpu_torch/build/ablation/``; the timing runs the unchanged source
first and last, the copies in between.  Prints the card line, then one JSON
line ``{"ms": {name: [ms, ...]}, "card": ...}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops.mc_dropout import launch_kernel

# name -> (text in csrc/mc_dropout.cu, its replacement)
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    # the tensor-core products: the mma becomes one integer op on its operands
    "no_mma": [(
        '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
        '      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])\n'
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));',
        "  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3F000000u);")],
    # the mask hash: keep by the counter's low bit
    "no_hash": [("  return wang_rest(mixed) >= thresh ? h * inv_keep : 0.0f;",
                 "  return (mixed & 1u) ? h * inv_keep : 0.0f;")],
    # the sample passes' tanh
    "no_tanh": [("__device__ __forceinline__ float tanh_sample(float x) {\n",
                 "__device__ __forceinline__ float tanh_sample(float x) {\n  return 0.5f * x;\n")],
    # the weight stream from L2: no tile is ever staged
    "no_weight_stream": [
        ("      stage_weights<N>(W, s * KT, ring + s * WTILE);\n", "      cp_async_commit();\n"),
        ("    if (next < K / KT) {\n      stage_weights<N>(W, next * KT",
         "    if (false) {\n      stage_weights<N>(W, next * KT")],
}


def variant_source(edits: List[Tuple[str, str]]) -> str:
    return build.edited_source("mc_dropout.cu", edits)


def build_variants(variants: Dict[str, List[Tuple[str, str]]]) -> Dict[str, ctypes.CDLL]:
    """Compile every variant (all nvcc processes at once) and load each."""
    built = build.compile_variants({name: variant_source(edits) for name, edits in variants.items()},
                                   build.BUILD_DIR / "ablation")
    libs = {}
    for name, (lib, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "mc_sample_kernel" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(regs[-3:])}")
        lib.pinnfc_mc_dropout.argtypes = build.MC_DROPOUT_ARGTYPES
        lib.pinnfc_mc_dropout.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants() -> Dict[str, List[float]]:
    """Median CUDA-event ms of one call (of three) per variant, the unchanged
    source ("source") first and last."""
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.models.mlp import MLP
    from pinnfc_tpu_torch.pipeline.export import default_mc_seed

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    libs = build_variants({"source": [], **ABLATIONS})
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    x = combine_and_normalize(normal, faults, device="cuda").x_test
    mlp = MLP(generator=torch.Generator().manual_seed(0), device="cuda")
    ms: Dict[str, List[float]] = {}
    for name in [*libs, "source"]:
        def call(lib=libs[name]):
            return launch_kernel(lib, mlp, x, default_mc_seed(42), 2000, 0.4)
        call()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        ms.setdefault(name, []).append(sorted(times)[len(times) // 2])
        print(f"[time] {name}: {ms[name][-1]:.3f} ms", flush=True)
    return ms


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    ms = time_variants()
    print(card)
    print(json.dumps({"ms": ms, "card": card, "shape": "x (15600, 8), mc_times 2000"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
