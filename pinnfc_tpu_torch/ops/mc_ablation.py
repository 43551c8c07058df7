"""Where the MC-dropout sample kernel spends its time on the card.

    python3 -m pinnfc_tpu_torch.ops.mc_ablation

No profiler that reads inside a kernel runs on the chip machine, so this
builds copies of ``csrc/mc_dropout.cu`` with one part of the sample passes
removed each, and times every copy against the unchanged source on the main
path's shapes (the default campaign's 15,600 rows, 2,000 samples, the main
path's MC seed, flagship weights from ``torch.Generator().manual_seed(0)``).  A copy computes wrong
statistics: only its time is read.  The time a removal saves bounds what that
part costs where it does not overlap the rest.  One more copy computes the
right statistics: "stamps" records
``clock64()`` in thread 0 of each warp group of CTAs 0 and 61 at five points
of every product phase of 16 samples from the middle of the passes (before
its turn at the tensor cores, after it, after the products, after the
slice's barrier that follows them, after the epilogue) and sums the cycles
that thread waits on the ring there; it prints each group's cycles per
sample in turn waits, products, ring waits, that barrier, the epilogue and
the rest, and the share of one group's epilogue cycles during which the
other group is in its products.
Copies are built into ``pinnfc_tpu_torch/build/ablation/``; the timing runs
the unchanged source first and last, the copies in between.  Prints each
copy's ``mc_sample_kernel`` registers and spills (``ptxas -v``), the card
line, then one JSON line ``{"ms": {name: [ms, ...]}, "stamps": ..., "card": ...}``.
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

Edits = List[Tuple[str, str]]

# a ring tile's tensor copy and its expected bytes, in stage_tile
STAGE_COPIES = (
    "  mbar_expect_tx(bar, KT * n * 2);\n"
    "  tma_load_3d(ring + (j % NSTAGE) * SLOT_BYTES, &maps->w1 + layer, 0, k0, 0, bar);\n")

# name -> (text in csrc/mc_dropout.cu, its replacement)
ABLATIONS: Dict[str, Edits] = {
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
    # the weight stream from L2: no tile is ever staged, and no warp waits for one
    "no_weight_stream": [
        (STAGE_COPIES, ""),
        ("    if (p.g == 0) mbar_wait(p.full + (p.it % NSTAGE) * 8, (p.it / NSTAGE) & 1u);\n", "")],
}

# the kernel's last addition to the row sums, after which the stamps copy
# stores its ring waits
LAST_SUMS = ("    if (adder) add_sample(r, red_mean, red_var, rows, wt.mb, wt.v2b);"
             "  // the last sample's\n")
STAMP_CTAS = (0, 61)
WINDOW = 64  # product phases stamped: 16 samples of 4
POINTS = 5   # stamps per product phase
# clock64() stamps in thread 0 of each group of the CTAs STAMP_CTAS, per
# product phase of the window: before its turn at the tensor cores, after it,
# after its products, after the slice's barrier that follows them (and, in
# group 1, the count and staging of the freed tiles), after its epilogue (one
# phase past the window closes the last); index 511 holds the cycles that
# thread waited on the ring inside the window
STAMPS: Edits = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_stamps[2][2][512];\n"
     "__shared__ long long g_wait[2];\n__shared__ int g_on[2];\n"
     "__device__ __forceinline__ int stamp_cta() {\n"
     f"  return blockIdx.x == {STAMP_CTAS[0]} ? 0 : (blockIdx.x == {STAMP_CTAS[1]} ? 1 : -1);\n"
     "}\n"
     "__device__ __forceinline__ void rec_wait(long long t0) {\n"
     "  const int g = threadIdx.x >> 8;\n"
     "  if ((threadIdx.x & 255) == 0 && g_on[g]) g_wait[g] += clock64() - t0;\n}\n"),
    ("  uint32_t done;\n  do {\n", "  const long long t0 = clock64();\n  uint32_t done;\n  do {\n"),
    ("  } while (!done);\n}\n", "  } while (!done);\n  rec_wait(t0);\n}\n"),
    ("// Stage tile j of the passes' sequence",
     "// k: the stamp's point in product phase `phase`\n"
     "__device__ __forceinline__ void rec(const Pass& p, uint32_t phase, int k) {\n"
     "  const int slot = stamp_cta();\n"
     "  const uint32_t w0 = 4u * (uint32_t)(p.mc_times / 2);\n"
     "  if ((threadIdx.x & 255) != 0 || slot < 0 || phase < w0 || "
     f"phase > w0 + {WINDOW}) return;\n"
     f"  if (k == 0) g_on[p.g] = phase < w0 + {WINDOW};\n"
     f"  g_stamps[slot][p.g][{POINTS} * (phase - w0) + k] = clock64();\n}}\n\n"
     "// Stage tile j of the passes' sequence"),
    ("  if (p.turns && (p.g == 1 || p.phase > 0)) bar_sync(BAR_TURN + p.g, STHREADS);\n"
     "  warp_mma<K, N>(p, acc);\n",
     "  rec(p, p.phase, 0);\n"
     "  if (p.turns && (p.g == 1 || p.phase > 0)) bar_sync(BAR_TURN + p.g, STHREADS);\n"
     "  rec(p, p.phase, 1);\n  warp_mma<K, N>(p, acc);\n  rec(p, p.phase, 2);\n"),
    ("  epilogue<N, DROP, STORE>(acc, bias, p.act, head, red, key, p.lr0, p.thresh, p.inv_keep);\n",
     "  rec(p, p.phase - 1, 3);\n"
     "  epilogue<N, DROP, STORE>(acc, bias, p.act, head, red, key, p.lr0, p.thresh, p.inv_keep);\n"
     "  rec(p, p.phase - 1, 4);\n"),
    ("  if (t < NSTAGE) {\n", "  if (t < 2) {\n    g_wait[t] = 0;\n    g_on[t] = 0;\n  }\n"
                            "  if (t < NSTAGE) {\n"),
    (LAST_SUMS, LAST_SUMS +
     "    if (t % GTHREADS == 0 && stamp_cta() >= 0) g_stamps[stamp_cta()][g][511] = g_wait[g];\n"),
]
STAMPS_EXPORT = ('\nextern "C" int pinnfc_stamps(long long* out) {\n'
                 "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n")

# every copy the script builds beside the unchanged source
VARIANTS: Dict[str, Edits] = {**ABLATIONS, "stamps": STAMPS}


def variant_source(edits: Edits) -> str:
    return build.edited_source("mc_dropout.cu", edits)


def sample_kernel_resources(log: str) -> str:
    """``ptxas -v``'s registers and spill line for mc_sample_kernel in ``log``."""
    lines = log.splitlines()
    start = next((i for i, ln in enumerate(lines)
                  if "Compiling entry function" in ln and "mc_sample_kernel" in ln), None)
    if start is None:
        return "mc_sample_kernel not in the log"
    found = []
    for ln in lines[start + 1:]:
        if "Compiling entry function" in ln:
            break
        if "spill" in ln or "Used" in ln:
            found.append(ln.strip())
    return " | ".join(found)


def build_variants(texts: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Compile every source text (all nvcc processes at once) and load each;
    the "stamps" copy also exports ``pinnfc_stamps``."""
    built = build.compile_variants(texts, build.BUILD_DIR / "ablation")
    libs = {}
    for name, (lib, log) in built.items():
        print(f"[build] {name}: {sample_kernel_resources(log)}")
        lib.pinnfc_mc_dropout.argtypes = build.MC_DROPOUT_ARGTYPES
        lib.pinnfc_mc_dropout.restype = ctypes.c_int
        libs[name] = lib
    return libs


def overlap(spans: List[Tuple[int, int]], other: List[Tuple[int, int]]) -> float:
    """Share of the cycles of ``spans`` that some span of ``other`` covers
    (the spans of each list are disjoint)."""
    total = sum(b - a for a, b in spans)
    covered = sum(max(0, min(b, d) - max(a, c)) for a, b in spans for c, d in other)
    return covered / total if total else 0.0


def group_cycles(stamps: List[List[int]]) -> Dict[str, object]:
    """Per group (of one CTA's two rows of stamps) the cycles per sample in the
    window: turn waits, products less ring waits, ring waits, the slice's
    barrier after the products (with group 1's count and staging), the
    epilogue, and the rest up to the next turn (the slice's barrier after the
    epilogue; once a pass, layer 0 and the row sums); then the share of each
    group's epilogue cycles during which the other group is in its
    products."""
    samples = WINDOW // 4
    out: Dict[str, object] = {}
    spans = []
    for g, st in enumerate(stamps):
        at = [st[k * POINTS:(k + 1) * POINTS] for k in range(WINDOW + 1)]
        wait = st[511]
        ph = range(WINDOW)
        spans.append(([(at[k][3], at[k][4]) for k in ph], [(at[k][1], at[k][2]) for k in ph]))
        out[f"group {g}"] = {
            "turn_wait": sum(at[k][1] - at[k][0] for k in ph) / samples,
            "products": (sum(at[k][2] - at[k][1] for k in ph) - wait) / samples,
            "ring_wait": wait / samples,
            "barrier": sum(at[k][3] - at[k][2] for k in ph) / samples,
            "epilogue": sum(at[k][4] - at[k][3] for k in ph) / samples,
            "rest": sum(at[k + 1][0] - at[k][4] for k in ph) / samples,
            "total": (at[WINDOW][0] - at[0][0]) / samples,
        }
    out["epilogue 0 under products 1"] = overlap(spans[0][0], spans[1][1])
    out["epilogue 1 under products 0"] = overlap(spans[1][0], spans[0][1])
    return out


def read_stamps(lib) -> Dict[str, object]:
    buf = (ctypes.c_longlong * (2 * 2 * 512))()
    build.check(lib.pinnfc_stamps(buf), "stamps")
    row = list(buf)
    return {f"cta {cta}": group_cycles([row[(2 * i + g) * 512:(2 * i + g + 1) * 512]
                                        for g in range(2)])
            for i, cta in enumerate(STAMP_CTAS)}


def time_variants():
    """Median CUDA-event ms of one call (of five) per copy, the unchanged
    source ("source") first and last, and the stamps."""
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
    from pinnfc_tpu_torch.models.mlp import MLP
    from pinnfc_tpu_torch.pipeline.export import default_mc_seed

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    texts = {"source": variant_source([])}
    texts.update({name: variant_source(edits) + (STAMPS_EXPORT if name == "stamps" else "")
                  for name, edits in VARIANTS.items()})
    libs = build_variants(texts)
    normal, faults = synthesize_stack_data(n_normal=6000, n_fault=800, seed=42)
    x = combine_and_normalize(normal, faults, device="cuda").x_test
    mlp = MLP(generator=torch.Generator().manual_seed(0), device="cuda")
    ms: Dict[str, List[float]] = {}
    for name in [*libs, "source"]:
        def call(lib=libs[name]):
            return launch_kernel(lib, mlp, x, default_mc_seed(42), 2000, 0.4)
        call()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        ms.setdefault(name, []).append(sorted(times)[len(times) // 2])
        print(f"[time] {name}: {ms[name][-1]:.3f} ms", flush=True)
    stamps = read_stamps(libs["stamps"])
    for cta, cycles in stamps.items():
        print(f"[stamps] {cta}: {json.dumps(cycles)}", flush=True)
    return ms, stamps


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    ms, stamps = time_variants()
    print(card)
    print(json.dumps({"ms": ms, "stamps": stamps, "card": card,
                      "shape": "x (15600, 8), mc_times 2000"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
