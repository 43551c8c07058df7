// Fused MC-dropout sampler for the flagship MLP (8 -> 256 -> 256 -> 256, mean
// head 256 -> 1, variance head 256 -> 128 -> 64 -> 1).
//
// Replaces the TPU kernel pinnfc_tpu/ops/pallas_mc_dropout.py::mc_dropout_pallas
// (body _make_kernel, RNG _wang_hash/_random_bits).  Per row it runs one eval
// pass (base) and mc_times dropout passes (trunk layers 0-2 and the first
// variance layer dropped), and writes [base, sum(pred-base), sum((pred-base)^2),
// sum(logvar)].  The plain PyTorch version is
// pinnfc_tpu_torch/ops/mc_dropout.py::mc_dropout_sums_plain.
//
// Precision, as the TPU kernel's: the base pass is float32 (its HIGHEST pass),
// the sample passes run their wide products in bf16 (its default-precision
// passes, one bf16 MXU pass on a TPU).  The rounding contract of a sample pass
// (the plain version with sample_dtype=torch.bfloat16 follows it):
//  - every activation stored between layers is bf16, rounded to nearest even
//    after tanh and after the dropout select and scale (h * (1/(1-p)) in
//    float32, then rounded);
//  - the four wide products (trunk 256x256 twice, variance 256x128 and
//    128x64; 172,032 of the 174,400 MAC of a row-sample) take bf16 operands
//    (the weights converted once per call by the wrapper) and accumulate in
//    float32 on the tensor cores (mma.sync m16n8k16);
//  - layer 0 (K = 8) reads x and its weights in float32; the width-1 heads
//    read the stored bf16 activations with float32 weights; bias adds, the
//    head dot products, log_softplus and the per-row sums are float32, the
//    sums in sample order.
// The base pass uses the accurate tanhf, logf, expf and log1pf (no fast math).
// The sample passes compute tanh as tanh_sample: 1 - 2 / (1 + 2^(2x log2 e))
// with ex2.approx and rcp.approx, and an odd polynomial (Taylor series to x^9)
// for |x| < 0.25; within 1.5e-6 relative of tanh at the two instructions'
// worst documented errors (a CPU emulation in tests/test_torch_mc_bf16.py),
// far below the bf16 rounding that follows, in fewer instructions than
// tanhf.  tanh.approx.f32 (relative error up to 2^-11) was not taken: an
// emulation of that error on the CPU flipped enough bf16 roundings to move
// epistemic_std by 1.6e-3 relative, over the 1e-3 tolerance against the
// plain version, which keeps torch.tanh.
//
// What bounds it on the H100: operations.  A row-sample costs 174,400 MAC; the
// 15,600-row campaign at 2,000 samples is 1.09e13 FLOP of bf16 products
// (11.0 ms at 989 TFLOP/s) plus one float32 base pass (0.08 ms at 67
// TFLOP/s).  The bytes are negligible: x in, 4 floats out per row, 0.35 MB
// of weights (bf16 for the wide products) that stay in L2.  With the products on the tensor cores, what the
// float32 FMAs hid takes most of the time: the epilogue (per row-sample, 896
// elements are tanh'd, hashed and masked and 64 more tanh'd: a few dozen
// instructions each on the integer, FMA and MUFU pipes), which does not
// overlap the tensor cores inside a CTA, and the weight stream from L2, which
// every CTA re-reads for every pass.  pinnfc_tpu_torch/ops/mc_ablation.py
// times copies of this file without each of these parts (PERF.md has the
// numbers): the hash saves the most, then the tanh, the products and the
// weight stream.
//
// Design.
//  - mc_base_kernel: the base pass in float32, as the float32 kernel did it
//    (64 rows per CTA, activations transposed [feature][row] in shared
//    memory, 8x8 register tiles of float32 FMAs); writes out[:, 0].
//  - mc_sample_kernel: a CTA owns SROWS = 128 rows (122 CTAs for the campaign,
//    one wave on 132 SMs at one CTA per SM) and loops over all samples itself,
//    one sample of its 128 rows per pass: the M of every product is 128
//    row-samples, which halves the L2 weight stream per unit of work against
//    64.  (64 rows x 2 samples would fill 244 CTAs in two waves: the same
//    92 % of the SMs, two salts per pass and a wasted sample when mc_times is
//    odd; 128 x 1 was taken.)  The activations stay in shared memory as bf16
//    [row][feature] across all layers and all samples: per-sample activations
//    never touch device memory, which was the point of the TPU kernel.
//    16 warps in a 4 (rows) x 4 (columns) grid; each owns a 32-row slice of a
//    quarter of the output columns, so an epilogue holds at most 64
//    accumulators per thread and its unrolled code stays small (8 warps of
//    64-row slices, with room for 255 registers and no spills, ran slower on
//    the card: fewer warps hide less of the epilogue's latency).  The bf16
//    weights stream from L2 in KT-row tiles through an NSTAGE-tile cp.async
//    ring; the next layer's first tiles are requested before each epilogue
//    (the first trunk layer's, for the next sample, before the last one).
//    Operands reach the tensor cores through ldmatrix (.trans for the
//    weights, stored (in, out)); the leading dimensions are padded by 8 bf16,
//    so the eight 16-byte rows of each 8x8 matrix fall on distinct banks.
//    The epilogue works on the accumulators in registers: bias, tanh_sample,
//    the mask, the bf16 pack (cvt.rn.bf16x2.f32) and a 32-bit shared store.  The
//    mean head is summed in the second trunk layer's epilogue and the
//    variance head in the last variance layer's (whose output is never
//    stored), from the rounded values, then across the quad by shuffles and
//    across the four column warps through shared memory in a fixed order.  No
//    float atomics: two runs are bitwise equal.  Rows past n are computed and
//    never stored.
//
// The dropout masks are part of the random stream's contract and are bit-exact
// with the TPU kernel: global row r belongs to mask block blk = r / 256 at
// local row lr = r % 256, whatever the CTA tiling; element (lr, c) of layer l
// (width W) keeps its value iff
//   wang(lr*W + c ^ wang(salt + 0x9E3779B9)) >= thresh,
//   salt = seed*7919 + blk*104729 + s*15485863 + l   (uint32, wrapping),
// and a kept value is multiplied by the float32 constant 1/(1-p).  A call on a
// row shard whose first row is global row 256*block0 passes block0: its row r
// draws the masks of global block block0 + r / 256, so the shards of a split at
// multiples of 256 rows give the unsplit call's sums, bit for bit (a row's
// place in its 128-row CTA is the same in both).  The counter
// lr*W + c is below 2^16, so the hash's first step (x ^ 61) ^ (x >> 16) of
// x = ctr ^ hs is ctr ^ (hs ^ 61 ^ (hs >> 16)): one XOR with a per-layer key.
// Within a thread's fragment the column offsets use bits disjoint from the
// row's, so the counter XOR the key is a per-row value XOR a constant.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int D_IN = 8;
constexpr int H = 256;           // trunk width
constexpr int V0 = 128;          // first variance layer
constexpr int V1 = 64;           // second variance layer
constexpr uint32_t MASK_BLOCK = 256;

__device__ __forceinline__ float log_softplus(float v) {
  // log(softplus(v) + 1e-6) with softplus in the jax.nn.softplus form
  const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
  return logf(sp + 1e-6f);
}

// ---------------------------------------------------------------------------
// mc_base_kernel: the eval pass in float32

constexpr int BROWS = 64;         // rows per CTA
constexpr int BTHREADS = 256;
constexpr int BKT = 32;           // weight rows staged in shared memory per step

// shared memory, in floats
constexpr int BSMEM_FLOATS = 2 * H * BROWS  // two activation buffers [H][BROWS]
                           + BKT * H        // weight tile
                           + D_IN * BROWS   // x, transposed
                           + 4 * BROWS;     // row-dot partial sums
constexpr size_t BSMEM_BYTES = BSMEM_FLOATS * sizeof(float);

struct BaseWeights {
  const float *w0, *b0, *w1, *b1, *w2, *b2;  // trunk, w as (in, out)
  const float *mw, *mb;                      // mean head
};

template <int NV>
__device__ __forceinline__ void load_vec(float (&dst)[NV], const float* src) {
  static_assert(NV % 4 == 0, "vector width must be a multiple of 4");
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q + 0] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

// out[N][BROWS] = tanh(in[K][BROWS]^T @ W(K, N) + b).  Ends with a barrier.
template <int K, int N, int TM, int TN, int KSTEP>
__device__ __forceinline__ void dense(const float* in, const float* __restrict__ W,
                                      const float* __restrict__ bias, float* out,
                                      float* wtile) {
  constexpr int NCG = N / TN;
  static_assert(NCG * (BROWS / TM) == BTHREADS, "tile does not cover the CTA");
  static_assert(K % KSTEP == 0 && (KSTEP * N) % (4 * BTHREADS) == 0, "bad staging");
  const int t = threadIdx.x;
  const int c0 = (t % NCG) * TN;
  const int r0 = (t / NCG) * TM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KSTEP) {
    const float4* src = reinterpret_cast<const float4*>(W + k0 * N);
    float4* dst = reinterpret_cast<float4*>(wtile);
#pragma unroll
    for (int q = t; q < KSTEP * N / 4; q += BTHREADS) dst[q] = __ldg(src + q);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KSTEP; ++kk) {
      float a[TM], w[TN];
      load_vec<TM>(a, in + (k0 + kk) * BROWS + r0);
      load_vec<TN>(w, wtile + kk * N + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float bj = __ldg(bias + c0 + j);
#pragma unroll
    for (int i = 0; i < TM; ++i) out[(c0 + j) * BROWS + r0 + i] = tanhf(acc[i][j] + bj);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(BTHREADS, 1)
mc_base_kernel(const float* __restrict__ x, int n, BaseWeights wt, float* __restrict__ out) {
  extern __shared__ __align__(16) float bsmem[];
  float* actA = bsmem;
  float* actB = actA + H * BROWS;
  float* wtile = actB + H * BROWS;
  float* xT = wtile + BKT * H;
  float* red = xT + D_IN * BROWS;

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * BROWS;
  // x rows, transposed; rows past n are zeros, computed and never stored
  for (int q = t; q < BROWS * D_IN; q += BTHREADS) {
    const int r = q / D_IN, d = q % D_IN;
    xT[d * BROWS + r] = row0 + r < n ? x[(size_t)(row0 + r) * D_IN + d] : 0.0f;
  }
  __syncthreads();
  dense<D_IN, H, 8, 8, D_IN>(xT, wt.w0, wt.b0, actA, wtile);
  dense<H, H, 8, 8, BKT>(actA, wt.w1, wt.b1, actB, wtile);
  dense<H, H, 8, 8, BKT>(actB, wt.w2, wt.b2, actA, wtile);
  // mean head: four threads per row, each over a quarter of H, summed in a
  // fixed order
  const int r = t % BROWS, part = t / BROWS;
  constexpr int KP = H / (BTHREADS / BROWS);
  float s = 0.0f;
#pragma unroll 8
  for (int k = part * KP; k < (part + 1) * KP; ++k) s = fmaf(actA[k * BROWS + r], __ldg(wt.mw + k), s);
  red[part * BROWS + r] = s;
  __syncthreads();
  if (t < BROWS && row0 + t < n) {
    out[(size_t)(row0 + t) * 4] =
        ((red[t] + red[BROWS + t]) + (red[2 * BROWS + t] + red[3 * BROWS + t])) + __ldg(wt.mb);
  }
}

// ---------------------------------------------------------------------------
// mc_sample_kernel: the dropout passes, wide products in bf16 on the tensor cores

constexpr int SROWS = 128;        // rows (= row-samples) per CTA pass
constexpr int STHREADS = 512;     // 16 warps: 4 row slices x 4 column quarters
constexpr int WROWS = SROWS / 4;  // rows of a warp's slice
constexpr int MT = WROWS / 16;    // ... in 16-row mma tiles
constexpr int KT = 32;            // weight rows per staged tile
constexpr int NSTAGE = 4;         // tiles in the weight ring
constexpr int LDA = H + 8;        // leading dimension (bf16) of an activation buffer
__host__ __device__ constexpr int ldw(int n) { return n + 8; }  // ... of a weight tile
constexpr int WTILE = KT * ldw(H);  // bf16 of one ring slot

// shared memory, in bytes: two activation buffers, the ring, x, and the two
// heads' per-column-quarter partial sums
constexpr size_t ACT_BYTES = (size_t)SROWS * LDA * 2;
constexpr size_t RING_BYTES = (size_t)NSTAGE * WTILE * 2;
constexpr size_t XS_BYTES = (size_t)SROWS * D_IN * 4;
constexpr size_t RED_BYTES = (size_t)2 * 4 * SROWS * 4;
constexpr size_t SSMEM_BYTES = 2 * ACT_BYTES + RING_BYTES + XS_BYTES + RED_BYTES;  // 210,944

static_assert(MASK_BLOCK % SROWS == 0, "a CTA's rows must lie in one mask block");
static_assert(MASK_BLOCK * H <= 65536u, "mask counters must stay below 2^16");
static_assert(SSMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory per block");
static_assert(MT >= 1 && WROWS % 16 == 0, "whole mma tiles");

struct SampleWeights {
  const float *w0, *b0, *b1, *b2, *mw, *mb, *v0b, *v1b, *v2w, *v2b;  // float32
  const uint16_t *w1, *w2, *v0w, *v1w;  // bf16 bit patterns, (in, out) row-major
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b on one m16n8k16 tile: bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t p;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(p) : "f"(hi), "f"(lo));
  return p;
}
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// The per-layer key of the hash's first step (see the note at the top):
// wang(ctr ^ hs) == wang_rest(ctr ^ layer_key(hs)) for ctr < 2^16.
__device__ __forceinline__ uint32_t layer_key(uint32_t hs) { return hs ^ 61u ^ (hs >> 16); }
__device__ __forceinline__ uint32_t wang_rest(uint32_t x) {
  x *= 9u;
  x = x ^ (x >> 4);
  x *= 0x27D4EB2Du;
  x = x ^ (x >> 15);
  x *= 2654435761u;
  x = x ^ (x >> 13);
  return x;
}
// tanh for the sample passes (see the note at the top)
__device__ __forceinline__ float tanh_sample(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * 2.8853900817779268f));  // 2 log2(e)
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
  const float big = fmaf(-2.0f, r, 1.0f);
  const float x2 = x * x;
  float p = fmaf(x2, 62.0f / 2835.0f, -17.0f / 315.0f);
  p = fmaf(x2, p, 2.0f / 15.0f);
  p = fmaf(x2, p, -1.0f / 3.0f);
  const float small = fmaf(x * x2, p, x);
  return fabsf(x) < 0.25f ? small : big;
}

__device__ __forceinline__ float drop(float h, uint32_t mixed, uint32_t thresh, float inv_keep) {
  return wang_rest(mixed) >= thresh ? h * inv_keep : 0.0f;
}

// Stage rows [k0, k0 + KT) of W (bf16, row-major (K, N) in device memory) into
// a ring slot (leading dimension ldw(N)) with cp.async, as one committed group.
template <int N>
__device__ __forceinline__ void stage_weights(const uint16_t* __restrict__ W, int k0,
                                              uint16_t* slot) {
  constexpr int CHUNKS = KT * N / 8;  // 16-byte copies
  for (int e = threadIdx.x; e < CHUNKS; e += STHREADS) {
    cp_async16(slot + (e / (N / 8)) * ldw(N) + (e % (N / 8)) * 8, W + (size_t)k0 * N + 8 * e);
  }
  cp_async_commit();
}

// Put the first NSTAGE - 1 tiles of W (K, N) in flight, one committed group
// each (empty groups past K).  cta_mma<K, N> expects them.
template <int K, int N>
__device__ __forceinline__ void prefetch_weights(const uint16_t* __restrict__ W, uint16_t* ring) {
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < K / KT) {
      stage_weights<N>(W, s * KT, ring + s * WTILE);
    } else {
      cp_async_commit();
    }
  }
}

// The CTA's C(SROWS x N) = in(SROWS x K, bf16, leading dimension LDA) @ W
// (bf16 (K, N) in device memory), streamed KT rows at a time through the
// ring, whose first NSTAGE - 1 tiles prefetch_weights<K, N> has put in flight.
// Warp (wm, wn) owns rows [wm WROWS, (wm + 1) WROWS) and columns
// [wn N/4, (wn + 1) N/4).  With g = lane / 4, q = lane % 4, acc[i][j][0..1] is
// C at row wm WROWS + 16 i + g, columns wn N/4 + 8 j + 2 q + 0..1, and
// acc[i][j][2..3] the same columns eight rows below.  Ends with a barrier.
template <int K, int N>
__device__ __forceinline__ void cta_mma(const uint16_t* in, const uint16_t* __restrict__ W,
                                        uint16_t* ring, float (&acc)[MT][N / 32][4]) {
  constexpr int NT = N / 32;  // 8-column mma tiles per warp
  static_assert(K % KT == 0 && NT % 2 == 0, "bad tiling");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // ldmatrix row addresses: lanes 0-15 give rows 0-15 of the first eight
  // columns (k), lanes 16-31 the same rows eight columns on
  const uint32_t a_addr = smem_u32(in + (wm * WROWS + (lane & 15)) * LDA + (lane >> 4) * 8);
  const uint32_t b_off = ((lane & 15) * ldw(N) + wn * (N / 4) + (lane >> 4) * 8) * 2;
  for (int c = 0; c < K / KT; ++c) {
    cp_async_wait<NSTAGE - 2>();  // tile c has landed (this thread's part)
    __syncthreads();              // ... everyone's, and tile c - 1 is free
    const int next = c + NSTAGE - 1;
    if (next < K / KT) {
      stage_weights<N>(W, next * KT, ring + (next % NSTAGE) * WTILE);
    } else {
      cp_async_commit();
    }
    const uint32_t b_addr = smem_u32(ring + (c % NSTAGE) * WTILE) + b_off;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_addr + (i * 16 * LDA + c * KT + kk) * 2);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        // b[0], b[1]: tile 2 jp (k rows 0-7, 8-15); b[2], b[3]: tile 2 jp + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_addr + (kk * ldw(N) + 16 * jp) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();
}

// Epilogue of a layer of width N on the accumulators of cta_mma: tanh(acc + b),
// with DROP the mask of layer key `key`; the bf16 result goes to out
// (leading dimension LDA) when out is given, and, when head is given, its dot
// product with head (N,) goes to red[wn][row] (the warp's column quarter).
template <int N, bool DROP>
__device__ __forceinline__ void epilogue(const float (&acc)[MT][N / 32][4],
                                         const float* __restrict__ bias, uint16_t* out,
                                         const float* __restrict__ head, float* red,
                                         uint32_t key, uint32_t lr0, uint32_t thresh,
                                         float inv_keep) {
  constexpr int NT = N / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2;
  const int col0 = wn * (N / 4) + 2 * (lane & 3);
  float part[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) part[i][0] = part[i][1] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * j));
    const float2 hw = head ? __ldg(reinterpret_cast<const float2*>(head + col0 + 8 * j))
                           : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int row = wm * WROWS + 16 * i + 8 * f + g;
        float h0 = tanh_sample(acc[i][j][2 * f] + b.x);
        float h1 = tanh_sample(acc[i][j][2 * f + 1] + b.y);
        if (DROP) {
          // counter (lr0 + row) N + col0 + 8 j + e; its column bits are
          // disjoint from the row's, and 8 j + e from col0's
          const uint32_t mixed = (((lr0 + (uint32_t)row) * N) ^ (uint32_t)col0 ^ key) ^ (8u * j);
          h0 = drop(h0, mixed, thresh, inv_keep);
          h1 = drop(h1, mixed ^ 1u, thresh, inv_keep);
        }
        const uint32_t p = pack_bf16x2(h0, h1);
        if (out) *reinterpret_cast<uint32_t*>(out + row * LDA + col0 + 8 * j) = p;
        if (head) part[i][f] = fmaf(bf16_hi(p), hw.y, fmaf(bf16_lo(p), hw.x, part[i][f]));
      }
  }
  if (head) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        float v = part[i][f];
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
        if ((lane & 3) == 0) red[wn * SROWS + wm * WROWS + 16 * i + 8 * f + g] = v;
      }
  }
}

// Layer 0 of a sample pass in float32: h = tanh(x W0 + b0), masked, to bf16
// in out.  Thread t owns columns 2 (t % 128) + 0..1 of every fourth row.
__device__ __forceinline__ void sample_layer0(const float* xs, const float* __restrict__ w0,
                                              const float* __restrict__ b0, uint16_t* out,
                                              uint32_t key, uint32_t lr0, uint32_t thresh,
                                              float inv_keep) {
  constexpr int PAIRS = H / 2;
  const int c = 2 * (threadIdx.x % PAIRS);
  float w[D_IN][2];
#pragma unroll
  for (int k = 0; k < D_IN; ++k) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(w0 + k * H + c));
    w[k][0] = v.x;
    w[k][1] = v.y;
  }
  const float2 b = __ldg(reinterpret_cast<const float2*>(b0 + c));
#pragma unroll 2
  for (int r = threadIdx.x / PAIRS; r < SROWS; r += STHREADS / PAIRS) {
    const float4 xa = *reinterpret_cast<const float4*>(xs + r * D_IN);
    const float4 xb = *reinterpret_cast<const float4*>(xs + r * D_IN + 4);
    const float xv[D_IN] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    float z0 = 0.0f, z1 = 0.0f;
#pragma unroll
    for (int k = 0; k < D_IN; ++k) {
      z0 = fmaf(xv[k], w[k][0], z0);
      z1 = fmaf(xv[k], w[k][1], z1);
    }
    const uint32_t mixed = ((lr0 + (uint32_t)r) * H) ^ (uint32_t)c ^ key;
    const float h0 = drop(tanh_sample(z0 + b.x), mixed, thresh, inv_keep);
    const float h1 = drop(tanh_sample(z1 + b.y), mixed ^ 1u, thresh, inv_keep);
    *reinterpret_cast<uint32_t*>(out + r * LDA + c) = pack_bf16x2(h0, h1);
  }
}

__global__ void __launch_bounds__(STHREADS, 1)
mc_sample_kernel(const float* __restrict__ x, int n, SampleWeights wt, float* __restrict__ out,
                 uint32_t seed, uint32_t block0, int mc_times, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char ssmem[];
  uint16_t* actA = reinterpret_cast<uint16_t*>(ssmem);
  uint16_t* actB = reinterpret_cast<uint16_t*>(ssmem + ACT_BYTES);
  uint16_t* ring = reinterpret_cast<uint16_t*>(ssmem + 2 * ACT_BYTES);
  float* xs = reinterpret_cast<float*>(ssmem + 2 * ACT_BYTES + RING_BYTES);
  float* red_mean = xs + SROWS * D_IN;
  float* red_var = red_mean + 4 * SROWS;

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * SROWS;
  prefetch_weights<H, H>(wt.w1, ring);
  // x rows; rows past n are zeros, computed and never stored
  for (int q = t; q < SROWS * D_IN; q += STHREADS) {
    const int r = q / D_IN;
    xs[q] = row0 + r < n ? x[(size_t)row0 * D_IN + q] : 0.0f;
  }
  const bool owner = t < SROWS && row0 + t < n;  // thread t < SROWS sums row t
  const float base = owner ? out[(size_t)(row0 + t) * 4] : 0.0f;  // from mc_base_kernel
  const float mb = __ldg(wt.mb), v2b = __ldg(wt.v2b);
  __syncthreads();

  const uint32_t lr0 = (uint32_t)row0 % MASK_BLOCK;
  const uint32_t block_salt = seed * 7919u + (block0 + (uint32_t)row0 / MASK_BLOCK) * 104729u;
  float s_d = 0.0f, s_d2 = 0.0f, s_lv = 0.0f;
  for (int s = 0; s < mc_times; ++s) {
    const uint32_t salt = block_salt + (uint32_t)s * 15485863u;
    sample_layer0(xs, wt.w0, wt.b0, actA, layer_key(hashed_salt(salt + 0u)), lr0, thresh,
                  inv_keep);
    // trunk layers 1 and 2 share one copy of their code: actA -> actB, then
    // actB -> actA with the mean head
#pragma unroll 1
    for (int l = 1; l <= 2; ++l) {
      float acc[MT][H / 32][4];
      cta_mma<H, H>(l == 1 ? actA : actB, l == 1 ? wt.w1 : wt.w2, ring, acc);
      if (l == 1) {
        prefetch_weights<H, H>(wt.w2, ring);
      } else {
        prefetch_weights<H, V0>(wt.v0w, ring);
      }
      epilogue<H, true>(acc, l == 1 ? wt.b1 : wt.b2, l == 1 ? actB : actA,
                        l == 1 ? nullptr : wt.mw, red_mean,
                        layer_key(hashed_salt(salt + (uint32_t)l)), lr0, thresh, inv_keep);
    }
    {
      float acc[MT][V0 / 32][4];
      cta_mma<H, V0>(actA, wt.v0w, ring, acc);
      prefetch_weights<V0, V1>(wt.v1w, ring);
      epilogue<V0, true>(acc, wt.v0b, actB, nullptr, nullptr, layer_key(hashed_salt(salt + 3u)),
                         lr0, thresh, inv_keep);
    }
    {
      float acc[MT][V1 / 32][4];
      cta_mma<V0, V1>(actB, wt.v1w, ring, acc);
      prefetch_weights<H, H>(wt.w1, ring);  // the next sample's first trunk layer
      epilogue<V1, false>(acc, wt.v1b, nullptr, wt.v2w, red_var, 0u, lr0, thresh, inv_keep);
    }
    __syncthreads();
    if (t < SROWS) {
      const float pred = ((red_mean[t] + red_mean[SROWS + t]) +
                          (red_mean[2 * SROWS + t] + red_mean[3 * SROWS + t])) + mb;
      const float raw = ((red_var[t] + red_var[SROWS + t]) +
                         (red_var[2 * SROWS + t] + red_var[3 * SROWS + t])) + v2b;
      const float d = __fsub_rn(pred, base);
      s_d = __fadd_rn(s_d, d);
      s_d2 = __fadd_rn(s_d2, __fmul_rn(d, d));
      s_lv = __fadd_rn(s_lv, log_softplus(raw));
    }
  }
  cp_async_wait<0>();

  if (owner) {
    float* o = out + (size_t)(row0 + t) * 4;
    o[1] = s_d;
    o[2] = s_d2;
    o[3] = s_lv;
  }
}

template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success).  All
// pointers are device pointers of contiguous tensors, 16-byte aligned; the 14
// float32 weights and biases are (in, out) row-major, and w1h, w2h, v0wh, v1wh
// are bf16 copies of w1, w2, v0w, v1w in the same layout.  v0w and v1w are not
// read: the base pass has no variance head, and the sample passes read the
// bf16 copies.  out is (n, 4):
// mc_base_kernel writes column 0, mc_sample_kernel reads it and writes 1-3.
// block0: the global mask block of x's first row (0 for a whole call).
extern "C" int pinnfc_mc_dropout(const float* x, int n, const float* w0, const float* b0,
                                 const float* w1, const float* b1, const float* w2,
                                 const float* b2, const float* mw, const float* mb,
                                 const float* v0w, const float* v0b, const float* v1w,
                                 const float* v1b, const float* v2w, const float* v2b,
                                 const uint16_t* w1h, const uint16_t* w2h, const uint16_t* v0wh,
                                 const uint16_t* v1wh, float* out, uint32_t seed,
                                 uint32_t block0, int mc_times, uint32_t thresh, float inv_keep,
                                 void* stream) {
  if (n <= 0) return 0;
  int err = set_smem(mc_base_kernel, BSMEM_BYTES);
  if (err == 0) err = set_smem(mc_sample_kernel, SSMEM_BYTES);
  if (err != 0) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const BaseWeights bw{w0, b0, w1, b1, w2, b2, mw, mb};
  mc_base_kernel<<<(n + BROWS - 1) / BROWS, BTHREADS, BSMEM_BYTES, s>>>(x, n, bw, out);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const SampleWeights sw{w0, b0, b1, b2, mw, mb, v0b, v1b, v2w, v2b, w1h, w2h, v0wh, v1wh};
  mc_sample_kernel<<<(n + SROWS - 1) / SROWS, STHREADS, SSMEM_BYTES, s>>>(
      x, n, sw, out, seed, block0, mc_times, thresh, inv_keep);
  return (int)cudaGetLastError();
}
