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
// What bounds it on the H100: instruction issue and latency, not the tensor
// cores or the bytes.  A row-sample costs 174,400 MAC; the 15,600-row
// campaign at 2,000 samples is 1.09e13 FLOP of bf16 products (11.0 ms at 989
// TFLOP/s) plus one float32 base pass (0.08 ms at 67 TFLOP/s), and the bytes
// are negligible: x in, 4 floats out per row, 0.35 MB of weights (bf16 for
// the wide products) that stay in L2.  The epilogue takes most of the time:
// per row-sample 896 elements are tanh'd, hashed and masked and 64 more
// tanh'd, a few dozen dependent instructions each on the integer, FMA and
// MUFU pipes, and a warp's 64 accumulators leave its registers room for few
// such chains at once.  The products, and the weight stream from L2 that
// every CTA re-reads for every pass, use the tensor cores and the copy engine
// and few issue slots.  So the sample kernel runs the two side by side inside
// a CTA: two warp groups out of phase, one group's epilogue issuing while the
// other group's products run (below).  pinnfc_tpu_torch/ops/mc_ablation.py
// times copies of this file without each part, and a copy with clock64
// stamps per group (PERF.md has the numbers).
//
// Design.
//  - mc_base_kernel: the base pass in float32, as the float32 kernel did it
//    (64 rows per CTA, activations transposed [feature][row] in shared
//    memory, 8x8 register tiles of float32 FMAs); writes out[:, 0].
//  - mc_sample_kernel: a CTA owns SROWS = 128 rows (122 CTAs for the campaign,
//    one wave on 132 SMs at one CTA per SM) and loops over all samples itself,
//    one sample of its 128 rows per pass, so each weight tile it streams from
//    L2 serves 128 row-samples.  (64 rows x 2 samples would fill 244 CTAs in
//    two waves: the same 92 % of the SMs, two salts per pass and a wasted
//    sample when mc_times is odd; 128 x 1 was taken.)  The activations stay in
//    shared memory as bf16 [row][feature] across all layers and all samples,
//    in one buffer that each layer's epilogue overwrites in place: per-sample
//    activations never touch device memory, which was the point of the TPU
//    kernel.
//    16 warps in two groups of 8.  Group g owns rows [64 g, 64 g + 64) as 2
//    row slices x 4 column quarters: warp w owns the 32-row slice w / 4 of the
//    column quarter w % 4, so an epilogue holds at most 64 accumulators per
//    thread.  Warps w and w + 4 share an SM sub-partition, so each
//    sub-partition holds two warps of each group.
//    No CTA-wide barrier inside the passes.  A warp's products read the rows
//    of its slice alone, so a slice's 4 warps wait for each other (a named
//    barrier) once their products have read a layer's input and once their
//    epilogue has written the output over it.  The two groups take turns at
//    the tensor cores: group 1 starts a layer's products once group 0 has
//    finished them, and group 0 starts the next layer's once group 1 has
//    finished this one's (a named barrier each way, the finishing side
//    arriving without waiting).  So group 1 runs one product phase behind
//    group 0 through all the passes, and each group's epilogue issues while
//    the other group's products run.  A group whose rows all lie past n (the
//    last CTA's second group when n % 128 is 1 to 64) does nothing.
//    The bf16 weights stream from L2 through a ring of NSTAGE = 8 slots of
//    KT = 32 weight rows: the TILES = 28 tiles of a pass (W1, W2, V0, V1) in
//    order, each read by every warp of both groups.  A tile lands in its slot
//    by one tensor copy (cp.async.bulk.tensor, through a map per weight that
//    the C entry encodes) counted against the slot's mbarrier, as four column
//    quarters, each swizzled so that ldmatrix reads it without bank
//    conflicts.  Group 0 waits on the mbarrier; group 1, whose turn comes
//    after group 0 has read the same tiles, does not.  The last warp of group
//    1 to finish a product phase (a count in shared memory) has its lanes
//    stage the tiles NSTAGE on into the slots the phase has read, so group
//    0's next tiles land while group 1 runs its epilogue; eight slots hold a
//    whole 256-row layer.  (A lone group 0 waits, counts and stages itself.)
//    Operands reach the tensor cores through ldmatrix (.trans for the
//    weights, stored (in, out)); the activations' leading dimension is padded
//    by 8 bf16, so the eight 16-byte rows of each 8x8 matrix fall on distinct
//    banks.
//    The epilogue works on the accumulators in registers: bias, tanh_sample,
//    the mask, the bf16 pack (cvt.rn.bf16x2.f32) and a 32-bit shared store.  The
//    mean head is summed in the second trunk layer's epilogue and the
//    variance head in the last variance layer's (whose output is never
//    stored), from the rounded values, then across the quad by shuffles and
//    across the four column warps through shared memory in a fixed order.
//    A row's sums live in shared memory and a lane of the first warp of its
//    slice adds each sample to them, in sample order.  No float atomics: two
//    runs are bitwise equal.  Rows past n are computed and never stored.
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

#include <cuda.h>
#include <cudaTypedefs.h>
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

constexpr int SROWS = 128;                  // rows (= row-samples) per CTA pass
constexpr int STHREADS = 512;               // 16 warps in two groups
constexpr int GROWS = SROWS / 2;            // rows of a group
constexpr int GTHREADS = STHREADS / 2;      // threads of a group: 2 row slices x 4 column quarters
constexpr int WROWS = SROWS / 4;            // rows of a warp's slice
constexpr int MT = WROWS / 16;              // ... in 16-row mma tiles
constexpr int KT = 32;                      // weight rows per ring slot
constexpr int NSTAGE = 8;                   // slots in the weight ring
constexpr int LDA = H + 8;                  // leading dimension (bf16) of the activations
// A ring slot holds a KT-row tile of W (K, N) as its four column quarters,
// quarter q at q KT RB(N), each of KT rows of RB(N) bytes (N / 4 bf16: 128,
// 64 or 32 bytes), as one tensor copy lays them out with the swizzle of that
// row length: the 16-byte chunk index XOR address bits 7-9, 7-8 or 7.  So a
// quarter is read by the warps of one column quarter alone, and the eight
// rows of each ldmatrix fall on distinct banks.
__host__ __device__ constexpr int rb(int n) { return n / 4 * 2; }
constexpr int SLOT_BYTES = KT * H * 2;
// the ring tiles of one sample pass, in the order every warp reads them
constexpr int TILE_W2 = H / KT, TILE_V0 = 2 * H / KT, TILE_V1 = 3 * H / KT;
constexpr int TILES = TILE_V1 + V0 / KT;
// named barriers (0 is __syncthreads): BAR_SLICE + w is row slice w's own
// (its 4 warps), BAR_TURN + g group g's turn at the tensor cores
constexpr int BAR_SLICE = 1, BAR_TURN = 5;
constexpr int SLICE_THREADS = 128;

// shared memory, in bytes: the ring (1,024-byte aligned for the swizzle,
// hence the slack), the activations, x, the two heads' per-column-quarter
// partial sums, the per-row sums, the ring's mbarriers and the count of
// product phases read
constexpr size_t RING_BYTES = (size_t)NSTAGE * SLOT_BYTES;
constexpr size_t ACT_BYTES = (size_t)SROWS * LDA * 2;
constexpr size_t XS_BYTES = (size_t)SROWS * D_IN * 4;
constexpr size_t RED_BYTES = (size_t)2 * 4 * SROWS * 4;
constexpr size_t ROW_BYTES = (size_t)4 * SROWS * 4;
constexpr size_t BAR_BYTES = (size_t)NSTAGE * 8 + 8;
constexpr size_t SSMEM_BYTES =
    1024 + RING_BYTES + ACT_BYTES + XS_BYTES + RED_BYTES + ROW_BYTES + BAR_BYTES;  // 209,992

static_assert(MASK_BLOCK % SROWS == 0, "a CTA's rows must lie in one mask block");
static_assert(MASK_BLOCK * H <= 65536u, "mask counters must stay below 2^16");
static_assert(SSMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory per block");
static_assert(MT >= 1 && WROWS % 16 == 0, "whole mma tiles");
static_assert(NSTAGE >= H / KT, "the ring holds a whole layer");

struct SampleWeights {
  const float *w0, *b0, *b1, *b2, *mw, *mb, *v0b, *v1b, *v2w, *v2b;  // float32
};
// tensor maps of the bf16 wide weights, (in, out) row-major, in ring quarters
struct WideMaps {
  CUtensorMap w1, w2, v0, v1;
};
static_assert(sizeof(WideMaps) == 4 * sizeof(CUtensorMap), "the maps of a pass, in layer order");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers, at shared addresses
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// wait until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// one arrival that also expects `bytes` more of transactions in the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes)
               : "memory");
}
// the box of the 3-D `map` at (c0, c1, c2) to shared memory at dst, counted
// against bar's transactions
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(bar) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
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

// What a warp carries through the sample passes.
struct Pass {
  const WideMaps* maps;
  uint32_t ring;     // shared address of NSTAGE slots of SLOT_BYTES
  uint16_t* act;     // the activations, SROWS x LDA bf16
  uint32_t full;     // shared address of NSTAGE mbarriers, one per slot: its tile landed
  uint32_t done;     // shared address of a count of the product phases the last-reading
                     // group's warps have finished
  uint32_t it;       // ring tiles this warp has read
  uint32_t phase;    // product phases this warp's group has run
  int mc_times;
  int g;             // the warp's group
  bool turns;        // both groups run (and take turns at the tensor cores)
  uint32_t lr0, thresh;
  float inv_keep;
};

// Stage tile j of the passes' sequence (TILES per pass: W1, W2, V0, V1 in
// KT-row tiles) into ring slot j % NSTAGE: one tensor copy, issued by the
// calling thread, its bytes expected by the slot's mbarrier.
__device__ __forceinline__ void stage_tile(const WideMaps* maps, uint32_t j, uint32_t ring,
                                           uint32_t full) {
  static_assert(TILE_W2 == 8 && TILE_V0 == 16 && TILE_V1 == 24 && V0 == H / 2 && V1 == H / 4,
                "a tile's layer is its position / 8, the layer's width H >> (layer - 1)");
  const uint32_t p = j % TILES;
  const uint32_t layer = p < TILE_V1 ? p / 8 : 3;  // W1, W2, V0, V1
  const int n = H >> (layer < 2 ? 0 : layer - 1);
  const int k0 = (int)(p - 8 * layer) * KT;
  const uint32_t bar = full + (j % NSTAGE) * 8;
  mbar_expect_tx(bar, KT * n * 2);
  tma_load_3d(ring + (j % NSTAGE) * SLOT_BYTES, &maps->w1 + layer, 0, k0, 0, bar);
}

// The calling warp has read a product phase's `count` ring tiles, the last
// it has read.  The group that reads tiles last (group 1 when both run: its
// turn comes after group 0's) frees their slots: the last of its 8 warps to
// get here (a count in shared memory) has lane l stage the tile NSTAGE after
// the phase's l-th into that tile's slot, if the passes have one.  (No warp
// counts a later phase before all have counted this one: with two groups,
// the later phase's turn comes after all of group 1 has finished this one;
// alone, the later phase's last tile lands only after this count.)
__device__ __forceinline__ void free_tiles(const Pass& p, uint32_t count) {
  if (p.g != (p.turns ? 1 : 0)) return;
  const uint32_t first = p.it - count;
  const uint32_t lane = threadIdx.x & 31;
  __syncwarp();
  uint32_t before = 0;
  if (lane == 0) {
    // release: the warp's reads of the tiles come first; acquire: so do the
    // other warps', for the last
    asm volatile("atom.acq_rel.cta.shared.add.u32 %0, [%1], 1;\n"
                 : "=r"(before) : "r"(p.done) : "memory");
  }
  if (__shfl_sync(0xFFFFFFFFu, before, 0) % 8 == 7 && lane < count &&
      first + lane + NSTAGE < (uint32_t)p.mc_times * TILES) {
    stage_tile(p.maps, first + lane + NSTAGE, p.ring, p.full);
  }
}

// The warp's share of C(SROWS x N) = act(SROWS x K, bf16, leading dimension
// LDA) @ W (bf16 (K, N)), whose KT-row tiles are the next K / KT tiles of the
// ring.  Warp (wm, wn) = (warp / 4, warp % 4) owns rows [wm WROWS, (wm + 1)
// WROWS) and columns [wn N/4, (wn + 1) N/4).  With g = lane / 4, q = lane % 4,
// acc[i][j][0..1] is C at row wm WROWS + 16 i + g, columns wn N/4 + 8 j + 2 q
// + 0..1, and acc[i][j][2..3] the same columns eight rows below.
template <int K, int N>
__device__ __forceinline__ void warp_mma(Pass& p, float (&acc)[MT][N / 32][4]) {
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
  const uint32_t a_addr = smem_u32(p.act + (wm * WROWS + (lane & 15)) * LDA + (lane >> 4) * 8);
  // the lane's row of the warp's ring quarter (k rows 0-15; 16-31 for kk =
  // 16) and the swizzle of its 16-byte chunks, the same for both
  constexpr int RB = rb(N);  // bytes in a row of a quarter
  const uint32_t b_off = wn * KT * RB + (lane & 15) * RB;
  const uint32_t swz = (((lane & 15) * RB) >> 7) & (RB / 16 - 1);
  for (int c = 0; c < K / KT; ++c, ++p.it) {
    // group 1 takes its turn after group 0 has waited for these tiles
    if (p.g == 0) mbar_wait(p.full + (p.it % NSTAGE) * 8, (p.it / NSTAGE) & 1u);
    const uint32_t b_addr = p.ring + (p.it % NSTAGE) * SLOT_BYTES + b_off;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_addr + (i * 16 * LDA + c * KT + kk) * 2);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        // b[0], b[1]: tile 2 jp (k rows 0-7, 8-15); b[2], b[3]: tile 2 jp + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_addr + kk * RB + (((2 * jp + (lane >> 4)) ^ swz) << 4));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
}

// Epilogue of a layer of width N on the accumulators of warp_mma: tanh(acc + b),
// with DROP the mask of layer key `key`; with STORE the bf16 result goes to
// out (leading dimension LDA), and, when head is given, its dot product with
// head (N,) goes to red[wn][row] (the warp's column quarter).
template <int N, bool DROP, bool STORE>
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
        if (STORE) *reinterpret_cast<uint32_t*>(out + row * LDA + col0 + 8 * j) = p;
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

// One wide layer (K -> N) of a sample pass for the calling warp's group: its
// turn at the tensor cores, its products, then its epilogue: with STORE over
// the layer's input in place, else into the head's sums alone.
template <int K, int N, bool DROP, bool STORE>
__device__ __forceinline__ void layer(Pass& p, const float* __restrict__ bias,
                                      const float* __restrict__ head, float* red, uint32_t key) {
  const uint32_t phases = 4u * (uint32_t)p.mc_times;
  float acc[MT][N / 32][4];
  if (p.turns && (p.g == 1 || p.phase > 0)) bar_sync(BAR_TURN + p.g, STHREADS);
  warp_mma<K, N>(p, acc);
  if (p.turns && (p.g == 0 || p.phase + 1 < phases)) bar_arrive(BAR_TURN + 1 - p.g, STHREADS);
  ++p.phase;
  free_tiles(p, K / KT);
  // a warp's products read the rows of its slice alone, which its slice's
  // epilogue writes
  const int slice = threadIdx.x >> 7;
  bar_sync(BAR_SLICE + slice, SLICE_THREADS);  // the slice's products have read the input
  epilogue<N, DROP, STORE>(acc, bias, p.act, head, red, key, p.lr0, p.thresh, p.inv_keep);
  if (STORE) bar_sync(BAR_SLICE + slice, SLICE_THREADS);  // ... and its epilogue has written it
}

// Layer 0 of a sample pass in float32 for the calling thread's row slice:
// h = tanh(x W0 + b0), masked, to bf16 in out.  Thread t of the slice owns
// columns 2 t + 0..1 of its 32 rows.
__device__ __forceinline__ void sample_layer0(const float* xs, const float* __restrict__ w0,
                                              const float* __restrict__ b0, uint16_t* out,
                                              uint32_t key, uint32_t lr0, uint32_t thresh,
                                              float inv_keep) {
  static_assert(SLICE_THREADS == H / 2, "a thread per column pair");
  const int c = 2 * (threadIdx.x % SLICE_THREADS), r0 = WROWS * (threadIdx.x / SLICE_THREADS);
  float w[D_IN][2];
#pragma unroll
  for (int k = 0; k < D_IN; ++k) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(w0 + k * H + c));
    w[k][0] = v.x;
    w[k][1] = v.y;
  }
  const float2 b = __ldg(reinterpret_cast<const float2*>(b0 + c));
#pragma unroll 2
  for (int r = r0; r < r0 + WROWS; ++r) {
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

// Add one sample's prediction to row r's sums: rows[0..3][r] = base, sum d,
// sum d^2, sum log var, with d = pred - base.
__device__ __forceinline__ void add_sample(int r, const float* red_mean, const float* red_var,
                                           float* rows, const float* __restrict__ mb,
                                           const float* __restrict__ v2b) {
  const float pred = ((red_mean[r] + red_mean[SROWS + r]) +
                      (red_mean[2 * SROWS + r] + red_mean[3 * SROWS + r])) + __ldg(mb);
  const float raw = ((red_var[r] + red_var[SROWS + r]) +
                     (red_var[2 * SROWS + r] + red_var[3 * SROWS + r])) + __ldg(v2b);
  const float d = __fsub_rn(pred, rows[r]);
  rows[SROWS + r] = __fadd_rn(rows[SROWS + r], d);
  rows[2 * SROWS + r] = __fadd_rn(rows[2 * SROWS + r], __fmul_rn(d, d));
  rows[3 * SROWS + r] = __fadd_rn(rows[3 * SROWS + r], log_softplus(raw));
}

__global__ void __launch_bounds__(STHREADS, 1)
mc_sample_kernel(const float* __restrict__ x, int n, SampleWeights wt,
                 const __grid_constant__ WideMaps maps, float* __restrict__ out, uint32_t seed,
                 uint32_t block0, int mc_times, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(1024) unsigned char ssmem[];
  unsigned char* base = ssmem + ((1024u - (smem_u32(ssmem) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(base);
  uint16_t* act = reinterpret_cast<uint16_t*>(base + RING_BYTES);
  float* xs = reinterpret_cast<float*>(base + RING_BYTES + ACT_BYTES);
  float* red_mean = xs + SROWS * D_IN;
  float* red_var = red_mean + 4 * SROWS;
  float* rows = red_var + 4 * SROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 4 * SROWS);
  uint32_t* done = reinterpret_cast<uint32_t*>(full + NSTAGE);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * SROWS;
  const int groups = n - row0 > GROWS ? 2 : 1;
  if (t < NSTAGE) {
    mbar_init(smem_u32(full + t), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t == 0) *done = 0;
  __syncthreads();
  if (t == 0) {
    for (uint32_t j = 0; j < NSTAGE && j < (uint32_t)mc_times * TILES; ++j) {
      stage_tile(&maps, j, ring, smem_u32(full));
    }
  }
  // x rows; rows past n are zeros, computed and never stored
  for (int q = t; q < SROWS * D_IN; q += STHREADS) {
    const int r = q / D_IN;
    xs[q] = row0 + r < n ? x[(size_t)row0 * D_IN + q] : 0.0f;
  }
  if (t < SROWS) {
    rows[t] = row0 + t < n ? out[(size_t)(row0 + t) * 4] : 0.0f;  // base, from mc_base_kernel
    rows[SROWS + t] = rows[2 * SROWS + t] = rows[3 * SROWS + t] = 0.0f;
  }
  __syncthreads();

  const int g = t / GTHREADS;
  if (g < groups) {
    const uint32_t lr0 = (uint32_t)row0 % MASK_BLOCK;
    Pass p{&maps, ring, act, smem_u32(full), smem_u32(done), 0u, 0u, mc_times, g, groups == 2,
           lr0, thresh, inv_keep};
    const uint32_t block_salt = seed * 7919u + (block0 + (uint32_t)row0 / MASK_BLOCK) * 104729u;
    // the first warp of each row slice adds its rows' sums, lane l row l
    const int slice = t / SLICE_THREADS, r = WROWS * slice + (t & 31);
    const bool adder = t % SLICE_THREADS < 32;
    for (int s = 0; s < mc_times; ++s) {
      const uint32_t salt = block_salt + (uint32_t)s * 15485863u;
      sample_layer0(xs, wt.w0, wt.b0, act, layer_key(hashed_salt(salt + 0u)), lr0, thresh,
                    inv_keep);
      bar_sync(BAR_SLICE + slice, SLICE_THREADS);
      // the previous sample's heads, summed by its last epilogues
      if (adder && s > 0) add_sample(r, red_mean, red_var, rows, wt.mb, wt.v2b);
      // trunk layers 1 and 2 share one copy of their code, layer 2 with the mean head
#pragma unroll 1
      for (int l = 1; l <= 2; ++l) {
        layer<H, H, true, true>(p, l == 1 ? wt.b1 : wt.b2, l == 1 ? nullptr : wt.mw, red_mean,
                                layer_key(hashed_salt(salt + (uint32_t)l)));
      }
      layer<H, V0, true, true>(p, wt.v0b, nullptr, nullptr, layer_key(hashed_salt(salt + 3u)));
      layer<V0, V1, false, false>(p, wt.v1b, wt.v2w, red_var, 0u);
    }
    bar_sync(BAR_SLICE + slice, SLICE_THREADS);
    if (adder) add_sample(r, red_mean, red_var, rows, wt.mb, wt.v2b);  // the last sample's
  }
  __syncthreads();

  if (t < SROWS && row0 + t < n) {
    float* o = out + (size_t)(row0 + t) * 4;
    o[1] = rows[SROWS + t];
    o[2] = rows[2 * SROWS + t];
    o[3] = rows[3 * SROWS + t];
  }
}

template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// The tensor map of a bf16 (k, n) row-major weight for the ring: (n / 4
// columns, k rows, 4 column quarters), so that a box of KT rows lands as a
// slot's four quarters one after another, each swizzled by its row length.
int encode_quarters(CUtensorMap* map, const uint16_t* w, int k, int n) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)n / 4, (cuuint64_t)k, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 2, (cuuint64_t)rb(n)};  // bytes: a row, a quarter
  const cuuint32_t box[3] = {(cuuint32_t)(n / 4), (cuuint32_t)KT, 4};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = rb(n) == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : rb(n) == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<uint16_t*>(w),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
  WideMaps maps;
  err = encode_quarters(&maps.w1, w1h, H, H);
  if (err == 0) err = encode_quarters(&maps.w2, w2h, H, H);
  if (err == 0) err = encode_quarters(&maps.v0, v0wh, H, V0);
  if (err == 0) err = encode_quarters(&maps.v1, v1wh, V0, V1);
  if (err != 0) return err;
  const SampleWeights sw{w0, b0, b1, b2, mw, mb, v0b, v1b, v2w, v2b};
  mc_sample_kernel<<<(n + SROWS - 1) / SROWS, STHREADS, SSMEM_BYTES, s>>>(
      x, n, sw, maps, out, seed, block0, mc_times, thresh, inv_keep);
  return (int)cudaGetLastError();
}
