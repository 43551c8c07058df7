// Fused MC-dropout sampler for the flagship MLP (8 -> 256 -> 256 -> 256, mean
// head 256 -> 1, variance head 256 -> 128 -> 64 -> 1).
//
// Replaces the TPU kernel pinnfc_tpu/ops/pallas_mc_dropout.py::mc_dropout_pallas
// (body _make_kernel, RNG _wang_hash/_random_bits).  Per row it runs one eval
// pass (base) and mc_times dropout passes (trunk layers 0-2 and the first
// variance layer dropped), and writes [base, sum(pred-base), sum((pred-base)^2),
// sum(logvar)].
//
// What bounds it on the H100: operations.  A row-sample costs 174,400 FMA
// (348,800 FLOP); the 15,600-row campaign at 2,000 samples is 1.09e13 FLOP,
// against 67 TFLOP/s of float32 outside the tensor cores.  The bytes are
// negligible (x in, 4 floats out per row, 0.7 MB of weights that stay in L2).
//
// Design: a CTA owns ROWS = 64 rows (244 CTAs for the campaign, so every SM
// is busy) and loops over all samples itself.  Its activations live in shared
// memory, transposed as [feature][row], across layers and samples: per-sample
// activations never touch device memory, which was the point of the TPU
// kernel.  Each dense layer stages KT = 32 rows of the weight matrix in shared
// memory (read from L2) and every thread computes an 8x8 (or smaller)
// register tile with float32 FMAs.  The sample sums are carried in registers
// by one thread per row, in sample order, as the TPU kernel does.
//
// The dropout masks are part of the random stream's contract and are bit-exact
// with the TPU kernel: global row r belongs to mask block blk = r / 256 at
// local row lr = r % 256, whatever the CTA tiling; element (lr, c) of layer l
// (width W) keeps its value iff
//   wang(lr*W + c ^ wang(salt + 0x9E3779B9)) >= thresh,
//   salt = seed*7919 + blk*104729 + s*15485863 + l   (uint32, wrapping),
// and a kept value is multiplied by the float32 constant 1/(1-p).
// tanhf/logf/expf/log1pf are the accurate versions (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int ROWS = 64;         // rows per CTA
constexpr int THREADS = 256;
constexpr int D_IN = 8;
constexpr int H = 256;           // trunk width
constexpr int V0 = 128;          // first variance layer
constexpr int V1 = 64;           // second variance layer
constexpr int KT = 32;           // weight rows staged in shared memory per step
constexpr uint32_t MASK_BLOCK = 256;

// shared memory, in floats
constexpr int SMEM_FLOATS = 2 * H * ROWS   // two activation buffers [H][ROWS]
                          + KT * H         // weight tile
                          + D_IN * ROWS    // x, transposed
                          + 4 * ROWS;      // row-dot partial sums
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

static_assert(MASK_BLOCK % ROWS == 0, "a CTA's rows must lie in one mask block");

struct Weights {
  const float *w0, *b0, *w1, *b1, *w2, *b2;  // trunk, w as (in, out)
  const float *mw, *mb;                      // mean head
  const float *v0w, *v0b, *v1w, *v1b, *v2w, *v2b;  // variance head
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

// out[N][ROWS] = tanh(in[K][ROWS]^T @ W(K, N) + b), then the dropout mask of
// hashed salt `hsalt` when DROP.  Ends with a barrier.
template <int K, int N, int TM, int TN, int KSTEP, bool DROP>
__device__ __forceinline__ void dense(const float* in, const float* __restrict__ W,
                                      const float* __restrict__ bias, float* out,
                                      float* wtile, uint32_t hsalt, uint32_t lr0,
                                      uint32_t thresh, float inv_keep) {
  constexpr int NCG = N / TN;
  static_assert(NCG * (ROWS / TM) == THREADS, "tile does not cover the CTA");
  static_assert(K % KSTEP == 0 && (KSTEP * N) % (4 * THREADS) == 0, "bad staging");
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
    for (int q = t; q < KSTEP * N / 4; q += THREADS) dst[q] = __ldg(src + q);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KSTEP; ++kk) {
      float a[TM], w[TN];
      load_vec<TM>(a, in + (k0 + kk) * ROWS + r0);
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
    for (int i = 0; i < TM; ++i) {
      float h = tanhf(acc[i][j] + bj);
      if (DROP) {
        const uint32_t ctr = (lr0 + (uint32_t)(r0 + i)) * (uint32_t)N + (uint32_t)(c0 + j);
        h = wang_hash(ctr ^ hsalt) >= thresh ? h * inv_keep : 0.0f;
      }
      out[(c0 + j) * ROWS + r0 + i] = h;
    }
  }
  __syncthreads();
}

// Partial dot products of each row of in[K][ROWS] with w (K,): four threads
// per row, each over a quarter of K, into red[4][ROWS].  Ends with a barrier.
template <int K>
__device__ __forceinline__ void row_dot(const float* in, const float* __restrict__ w,
                                        float* red) {
  const int t = threadIdx.x;
  const int r = t % ROWS, part = t / ROWS;
  constexpr int KP = K / (THREADS / ROWS);
  float s = 0.0f;
#pragma unroll 8
  for (int k = part * KP; k < (part + 1) * KP; ++k) s = fmaf(in[k * ROWS + r], __ldg(w + k), s);
  red[part * ROWS + r] = s;
  __syncthreads();
}

__device__ __forceinline__ float reduce_row(const float* red, int r, float b) {
  return ((red[r] + red[ROWS + r]) + (red[2 * ROWS + r] + red[3 * ROWS + r])) + b;
}

__device__ __forceinline__ float log_softplus(float v) {
  // log(softplus(v) + 1e-6) with softplus in the jax.nn.softplus form
  const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
  return logf(sp + 1e-6f);
}

// One pass for the CTA's rows.  Thread r < ROWS gets row r's (pred, logvar).
template <bool DROP>
__device__ __forceinline__ void forward(const Weights& wt, const float* xT, float* actA,
                                        float* actB, float* wtile, float* red,
                                        uint32_t salt, uint32_t lr0, uint32_t thresh,
                                        float inv_keep, float& pred, float& logvar) {
  const uint32_t g = 0x9E3779B9u;
  dense<D_IN, H, 8, 8, D_IN, DROP>(xT, wt.w0, wt.b0, actA, wtile,
                                   DROP ? wang_hash(salt + 0u + g) : 0u, lr0, thresh, inv_keep);
  dense<H, H, 8, 8, KT, DROP>(actA, wt.w1, wt.b1, actB, wtile,
                              DROP ? wang_hash(salt + 1u + g) : 0u, lr0, thresh, inv_keep);
  dense<H, H, 8, 8, KT, DROP>(actB, wt.w2, wt.b2, actA, wtile,
                              DROP ? wang_hash(salt + 2u + g) : 0u, lr0, thresh, inv_keep);
  row_dot<H>(actA, wt.mw, red);
  const int t = threadIdx.x;
  if (t < ROWS) pred = reduce_row(red, t, __ldg(wt.mb));
  dense<H, V0, 8, 4, KT, DROP>(actA, wt.v0w, wt.v0b, actB, wtile,
                               DROP ? wang_hash(salt + 3u + g) : 0u, lr0, thresh, inv_keep);
  dense<V0, V1, 4, 4, KT, false>(actB, wt.v1w, wt.v1b, actA, wtile, 0u, lr0, thresh, inv_keep);
  // row_dot below overwrites red only after the barriers of the two dense
  // layers above, so the mean-head reduction has been read by then
  row_dot<V1>(actA, wt.v2w, red);
  if (t < ROWS) logvar = log_softplus(reduce_row(red, t, __ldg(wt.v2b)));
}

__global__ void __launch_bounds__(THREADS, 1)
mc_dropout_kernel(const float* __restrict__ x, int n, Weights wt, float* __restrict__ out,
                  uint32_t seed, int mc_times, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  float* actA = smem;
  float* actB = actA + H * ROWS;
  float* wtile = actB + H * ROWS;
  float* xT = wtile + KT * H;
  float* red = xT + D_IN * ROWS;

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  // x rows, transposed; rows past n are zeros, computed and never stored
  for (int q = t; q < ROWS * D_IN; q += THREADS) {
    const int r = q / D_IN, d = q % D_IN;
    xT[d * ROWS + r] = row0 + r < n ? x[(size_t)(row0 + r) * D_IN + d] : 0.0f;
  }
  __syncthreads();

  const uint32_t blk = (uint32_t)row0 / MASK_BLOCK;
  const uint32_t lr0 = (uint32_t)row0 % MASK_BLOCK;
  const uint32_t block_salt = seed * 7919u + blk * 104729u;

  float base = 0.0f, unused = 0.0f;
  forward<false>(wt, xT, actA, actB, wtile, red, 0u, lr0, thresh, inv_keep, base, unused);

  float s_d = 0.0f, s_d2 = 0.0f, s_lv = 0.0f;
  for (int s = 0; s < mc_times; ++s) {
    const uint32_t salt = block_salt + (uint32_t)s * 15485863u;
    float pred = 0.0f, logvar = 0.0f;
    forward<true>(wt, xT, actA, actB, wtile, red, salt, lr0, thresh, inv_keep, pred, logvar);
    const float d = pred - base;
    s_d += d;
    s_d2 += d * d;
    s_lv += logvar;
  }

  if (t < ROWS && row0 + t < n) {
    float* o = out + (size_t)(row0 + t) * 4;
    o[0] = base;
    o[1] = s_d;
    o[2] = s_d2;
    o[3] = s_lv;
  }
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success).  All
// pointers are device pointers of contiguous float32 tensors, 16-byte aligned;
// weights are (in, out) row-major.  out is (n, 4).
extern "C" int pinnfc_mc_dropout(const float* x, int n, const float* w0, const float* b0,
                                 const float* w1, const float* b1, const float* w2,
                                 const float* b2, const float* mw, const float* mb,
                                 const float* v0w, const float* v0b, const float* v1w,
                                 const float* v1b, const float* v2w, const float* v2b,
                                 float* out, uint32_t seed, int mc_times, uint32_t thresh,
                                 float inv_keep, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mc_dropout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const Weights wt{w0, b0, w1, b1, w2, b2, mw, mb, v0w, v0b, v1w, v1b, v2w, v2b};
  const int blocks = (n + ROWS - 1) / ROWS;
  mc_dropout_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, n, wt, out, seed, mc_times, thresh, inv_keep);
  return (int)cudaGetLastError();
}
