"""Where the training kernel's bf16 form spends its time on the card.

    python3 -m pinnfc_tpu_torch.ops.train_ablation

No profiler that reads inside a kernel runs on the chip machine, so this
builds copies of ``csrc/train_dnn.cu`` with one part of the bf16 form removed
each, and times every copy against the unchanged source as a 200-step bf16
stage (``precision="default"``) on the main path's shapes (the default
campaign's 6,000 training rows, flagship weights from
``torch.Generator().manual_seed(0)``), with each kernel's device time from
the profiler.  A copy computes wrong gradients: only its time is read.  The
time a removal saves bounds what that part costs where it does not overlap
the rest.  A last copy ("stamps") records ``clock64()`` in thread 0 of CTAs 0
and 47 of ``fwd_bwd_bf16_kernel`` at every phase boundary (each layer's
first weight tile in, its product done, its epilogue done), and prints the
cycles of each phase.  Copies are built into ``pinnfc_tpu_torch/build/
train_ablation/``; the timing runs the unchanged source first and last.
Prints the card line, then one JSON line ``{"ms": ..., "stamps": ...,
"card": ...}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from pinnfc_tpu_torch.ops import build

SOURCE = "train_dnn.cu"
Edits = List[Tuple[str, str]]

# name -> (text in csrc/train_dnn.cu, its replacement)
ABLATIONS: Dict[str, Edits] = {
    # the bf16 tensor-core products: the mma becomes one integer op on its operands
    "no_mma": [(
        '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
        '      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])\n'
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));',
        "  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]) & 0x3F000000u);")],
    # the forward's tanh
    "no_tanh": [("  return make_float4(tanhf(z.x), tanhf(z.y), tanhf(z.z), tanhf(z.w));",
                 "  return make_float4(0.5f * z.x, 0.5f * z.y, 0.5f * z.z, 0.5f * z.w);")],
    # the mask hash: keep by the counter's low bit
    "no_hash": [
        ("const bool k0 = wang_rest(rk[i][hh] ^ (uint32_t)c) >= ma.thresh;",
         "const bool k0 = (rk[i][hh] ^ (uint32_t)c) & 1u;"),
        ("const bool k1 = wang_rest(rk[i][hh] ^ (uint32_t)(c + 1)) >= ma.thresh;",
         "const bool k1 = (rk[i][hh] ^ (uint32_t)(c + 1)) & 1u;")],
    # the bf16 weight stream from L2 into fwd_bwd_bf16_kernel's ring
    "no_weight_stream": [(
        "    cp_async16(slot + (e / (N / 8)) * ldh(N) + (e % (N / 8)) * 8, "
        "W + (size_t)k0 * N + 8 * e);\n", "")],
    # the backward's factors: neither stored by the forward nor read back
    "no_fact_io": [
        ("        __stcg(reinterpret_cast<float4*>(fact + ((i * NT + j) * BTHREADS + t) * 4),\n"
         "               make_float4(f[0], f[1], f[2], f[3]));",
         "        if (f[0] == 1234.5f && f[1] == f[2] && f[3] == 7.0f) fact[t] = 1.0f;"),
        ("    fv[q] = __ldcs(reinterpret_cast<const float4*>(fact + (q * BTHREADS + t) * 4));",
         "    fv[q] = make_float4(0.5f, 0.5f, 0.5f, 0.5f);")],
    # the bf16 scratch written for the weight gradients
    "no_scratch_out": [(
        "    *reinterpret_cast<uint4*>(dst + (size_t)r * N + c) =\n"
        "        *reinterpret_cast<const uint4*>(tile + r * ldh(N) + c);", "")],
    # the weight gradients' reads of the bf16 scratch
    "no_wgrad_stage": [
        ("          if (k0 + c < g.lda) cp_async16(as + r * WLDA + c, "
         "g.a + (r0 + r) * g.lda + k0 + c);", ""),
        ("          if (j0 + c < g.j) cp_async16(ds + r * WLDD + c, "
         "g.d + (r0 + r) * g.j + j0 + c);", "")],
    # adam_kernel's float32 transposes, which only the 3xTF32 form reads
    "no_adam_transposes": [("  p[e] = w;\n  put_transposed(tr, e, w);\n}", "  p[e] = w;\n}")],
}

STAMP_CTAS = (0, 47)
# clock64() stamps in thread 0 of the CTAs STAMP_CTAS, at every phase boundary
STAMPS: Edits = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_stamps[2][64];\n__shared__ int g_si;\n"
     "__device__ __forceinline__ void rec() {\n"
     f"  const int slot = blockIdx.x == {STAMP_CTAS[0]} ? 0 : "
     f"(blockIdx.x == {STAMP_CTAS[1]} ? 1 : -1);\n"
     "  if (threadIdx.x == 0 && slot >= 0) g_stamps[slot][g_si++] = clock64();\n}\n"),
    ("    cp_async_wait<BNSTAGE - 2>();  // slot c has landed (this thread's part)\n"
     "    __syncthreads();               // ... everyone's, and slot c - 1 is free\n",
     "    cp_async_wait<BNSTAGE - 2>();  // slot c has landed (this thread's part)\n"
     "    __syncthreads();               // ... everyone's, and slot c - 1 is free\n"
     "    if (c == 0) rec();\n"),
    ("  __syncthreads();\n}\n\n// Copy the CTA's bf16 tile",
     "  __syncthreads();\n  rec();\n}\n\n// Copy the CTA's bf16 tile"),
    ("  __syncthreads();\n  if (gout != nullptr) copy_tile16<N>(out, gout + (size_t)row0 * N);\n",
     "  __syncthreads();\n  rec();\n"
     "  if (gout != nullptr) copy_tile16<N>(out, gout + (size_t)row0 * N);\n"),
    ("  __syncthreads();\n  put_colsum<N>(cred, colsum);\n",
     "  __syncthreads();\n  rec();\n  put_colsum<N>(cred, colsum);\n"),
    ("  float* rowv = cred + WMS * H;  // [0, BROWS): dpred, [BROWS, 2 BROWS): dq3\n",
     "  float* rowv = cred + WMS * H;  // [0, BROWS): dpred, [BROWS, 2 BROWS): dq3\n"
     "  if (threadIdx.x == 0) g_si = 0;\n  rec();\n"),
    ("                          colsum + CS_B1, row0, nullptr);\n}",
     "                          colsum + CS_B1, row0, nullptr);\n  __syncthreads();\n  rec();\n}"),
]
STAMPS_EXPORT = ('\nextern "C" int pinnfc_stamps(long long* out) {\n'
                 "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n")
# the phases between consecutive stamps: each product layer's lead-in
# (previous copy, first tile's wait), product and epilogue
LAYERS = ("W1", "W2", "W3", "V1", "V2", "dq1 (V2^T)", "da3 (V1^T)", "da2 (W3^T)", "da1 (W2^T)")


def variant_source(edits: Edits) -> str:
    return build.edited_source(SOURCE, edits)


def build_variants(variants: Dict[str, Edits]) -> Dict[str, ctypes.CDLL]:
    """Compile every variant (all nvcc processes at once) and load each with
    the training entries' signatures; the "stamps" copy also exports
    ``pinnfc_stamps``."""
    texts = {name: variant_source(edits) + (STAMPS_EXPORT if name == "stamps" else "")
             for name, edits in variants.items()}
    built = build.compile_variants(texts, build.BUILD_DIR / "train_ablation")
    return {name: build.bind(lib, build.TRAIN_ENTRIES) for name, (lib, _) in built.items()}


def phase_cycles(stamps: List[int]) -> Dict[str, int]:
    """Cycles of each phase of one CTA from its stamps (kernel start, then per
    product layer: first tile in, product done, epilogue done; kernel end)."""
    d = [b - a for a, b in zip(stamps, stamps[1:])]
    out = {}
    for k, name in enumerate(LAYERS):
        out[f"{name} lead-in"], out[f"{name} product"], out[f"{name} epilogue"] = d[3 * k:3 * k + 3]
    out["end"] = d[3 * len(LAYERS)]
    out["total"] = stamps[-1] - stamps[0]
    return out


def time_variants():
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.models.mlp import MLP
    from pinnfc_tpu_torch.ops import train_dnn as td
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    libs = build_variants({"source": [], **ABLATIONS, "stamps": STAMPS})
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    ds = combine_and_normalize(normal, faults, device="cuda")
    x, y = ds.x_train, ds.y_train
    mlp = MLP(generator=torch.Generator().manual_seed(0), device="cuda")
    saved = build._Library.handle
    ms: Dict[str, list] = {}
    try:
        for name in [*libs, "source"]:
            build._Library.handle = libs[name]

            def stage(steps):
                return td.train_dnn(mlp, x, y, 7, steps, precision="default")

            stage(10)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            stage(200)
            stop.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                stage(50)
                torch.cuda.synchronize()
            per = {}
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                for k in ("fwd_bwd_bf16_kernel", "wgrad_bf16_kernel", "bf16_weights_kernel",
                          "adam_kernel"):
                    if k in ev.key and dev_us:
                        per[k] = dev_us / 50 / 1e3
            ms.setdefault(name, []).append({"ms_per_step": start.elapsed_time(stop) / 200,
                                            "kernel_ms_per_step": per})
            print(f"[time] {name}: {json.dumps(ms[name][-1])}", flush=True)
        buf = (ctypes.c_longlong * 128)()
        build.check(libs["stamps"].pinnfc_stamps(buf), "stamps")
        stamps = {}
        for i, cta in enumerate(STAMP_CTAS):
            row = list(buf)[64 * i:64 * (i + 1)]
            stamps[f"cta {cta}"] = phase_cycles(row[:3 * len(LAYERS) + 2])
            print(f"[stamps] CTA {cta}: {json.dumps(stamps[f'cta {cta}'])}", flush=True)
    finally:
        build._Library.handle = saved
    return ms, stamps


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    ms, stamps = time_variants()
    print(card)
    print(json.dumps({"ms": ms, "stamps": stamps, "card": card,
                      "shape": "x (6000, 8), 200-step bf16 stage"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
