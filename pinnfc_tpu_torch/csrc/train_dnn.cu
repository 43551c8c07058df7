// Whole DNN training stage for the flagship MLP (8 -> 256 -> 256 -> 256, mean
// head 256 -> 1, variance head 256 -> 128 -> 64 -> 1): n_iter full-batch steps
// of hash-masked dropout forward, heteroscedastic loss, hand-derived backward,
// and Adam with the StepLR staircase, all launched from one C entry point.
//
// Replaces the TPU kernel pinnfc_tpu/ops/pallas_train.py::train_dnn_pallas
// (body _make_train_kernel).  The plain PyTorch version is
// pinnfc_tpu_torch/ops/train_dnn.py::train_dnn_stage_plain.
//
// What bounds it on the H100: operations.  A step costs 521,152 MAC per row
// (174,400 forward, 174,400 for the weight gradients, 172,352 for the input
// gradients): 6.25 GFLOP at N = 6,000, 0.093 ms against 67 TFLOP/s of float32
// outside the tensor cores.  The data (0.19 MB) and the state (weights, Adam
// moments, 2.8 MB) stay in L2.
//
// Design.  The TPU kernel is one program that loops over steps and 512-row
// blocks with all state in VMEM; on the H100 that shape would use one SM.  Here
// every step is four launches on the caller's stream, queued from C with no
// host sync, and all state stays in device memory (in L2) for the stage:
//  1. fwd_bwd_kernel: a CTA owns ROWS = 32 rows (inside one 512-row mask block)
//     and runs the forward and the input-gradient backward for them.  Its
//     activations live in shared memory as [feature][row]; every dense layer
//     stages 32-row weight tiles through shared memory and each thread computes
//     a 4 x TN register tile with float32 FMAs.  The masks are recomputed from
//     the hash in the backward rather than stored.  It writes the masked
//     activations and the deltas of every layer to a global scratch, and the
//     per-row loss.
//  2. wgrad_kernel: every weight gradient is A^T D summed over the rows, with
//     the bias as an extra column of ones in A.  A CTA owns a 64 x 64 tile of
//     one gradient tensor and one of SPLIT fixed row segments, and walks its
//     rows in order into a partial buffer.  No float atomics: the result is the
//     same from run to run.
//  3. finalize_kernel: sums the SPLIT partials in segment order, flags a
//     non-finite gradient, and (its last CTA) reduces the per-row losses in a
//     fixed order into loss[t].
//  4. adam_kernel: Adam (0.9, 0.999, eps 1e-8 outside the root) with the
//     learning rate lr * gamma^floor(count / lr_step), over the flat parameter
//     buffer; it also refreshes the transposed weight copies the backward reads.
//     With skip_nonfinite a flagged step leaves the weights, both moments and
//     the Adam count as they were (the loss is still recorded and the masks
//     still advance with t).
//
// The masks are bit-exact with the TPU kernel: global row r lies in mask block
// blk = r / 512 at local row lr = r % 512; element (lr, c) of layer l (width W;
// l = 0..2 the trunk, 3 the first variance layer) is kept iff
//   wang(lr*W + c ^ wang(salt + 0x9E3779B9)) >= thresh,
//   salt = seed*2654435761 + t*40503 + blk*7919 + l   (uint32, wrapping),
// with t the step index inside the stage; a kept value is multiplied by the
// float32 constant 1/(1-p).  Rows past n take no part in the loss or the
// gradients, and the mean divides by the true n.  tanhf/logf/expf/log1pf are
// the accurate versions (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int D_IN = 8;
constexpr int H = 256;   // trunk width
constexpr int V0 = 128;  // first variance layer
constexpr int V1 = 64;   // second variance layer
constexpr int ROWS = 32;  // rows per CTA of fwd_bwd_kernel
constexpr int THREADS = 256;
constexpr int KT = 32;  // weight rows staged in shared memory per step
constexpr uint32_t MASK_BLOCK = 512;
constexpr int SPLIT = 4;   // row segments of the weight-gradient pass
constexpr int GT = 64;     // gradient tile edge
constexpr int GR = 32;     // rows per chunk of a gradient tile

static_assert(MASK_BLOCK % ROWS == 0, "a CTA's rows must lie in one mask block");

// Flat parameter layout: tensor block i is W_i (K x J, row-major (in, out))
// followed by its bias (J), i.e. a (K + 1) x J matrix; blocks start at
// multiples of 4 floats, and the gaps stay zero.
constexpr int align4(int v) { return (v + 3) / 4 * 4; }
constexpr int NT = 7;  // W1, W2, W3, Wm, V1, V2, V3
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = align4(OFF_W1 + (D_IN + 1) * H);
constexpr int OFF_W3 = align4(OFF_W2 + (H + 1) * H);
constexpr int OFF_WM = align4(OFF_W3 + (H + 1) * H);
constexpr int OFF_V1 = align4(OFF_WM + (H + 1) * 1);
constexpr int OFF_V2 = align4(OFF_V1 + (H + 1) * V0);
constexpr int OFF_V3 = align4(OFF_V2 + (V0 + 1) * V1);
constexpr int N_PARAM = align4(OFF_V3 + (V1 + 1) * 1);

// shared memory of fwd_bwd_kernel, in floats
constexpr int SMEM_FLOATS = D_IN * ROWS        // x, transposed
                          + 3 * H * ROWS       // tanh outputs h1, h2, h3 (unmasked)
                          + V0 * ROWS          // t1 (unmasked)
                          + V1 * ROWS          // t2
                          + 2 * H * ROWS       // ping-pong: masked inputs, then deltas
                          + KT * H             // weight tile
                          + 8 * ROWS           // row-dot partial sums
                          + 2 * ROWS;          // per-row dpred, dq3
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory per block");

__host__ __device__ constexpr size_t round4(size_t v) { return (v + 3) / 4 * 4; }

struct Scratch {
  float *h1d, *h2d, *h3d, *t1d, *t2;           // masked activations, [n][width]
  float *da1, *da2, *da3, *dq1, *dq2, *dpred, *dq3;  // deltas, [n][width]
  float* lossrow;                             // [n]
};

struct Step {
  const float* x;  // (n, 8)
  const float* y;  // (n, 1)
  int n;
  const float* p;  // flat parameters
  const float *w2t, *w3t, *v1t, *v2t;  // transposed copies (out, in)
  Scratch s;
  uint32_t seed;
  int t;
  uint32_t thresh;
  float inv_keep;
  float inv_n;
};

template <int NV>
__device__ __forceinline__ void load_vec(float (&dst)[NV], const float* src) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q + 0] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  } else {
    static_assert(NV % 2 == 0, "vector width must be even");
#pragma unroll
    for (int q = 0; q < NV / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(src)[q];
      dst[2 * q + 0] = v.x;
      dst[2 * q + 1] = v.y;
    }
  }
}

template <int NV>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[NV]) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
    }
  } else {
    static_assert(NV % 2 == 0, "vector width must be even");
#pragma unroll
    for (int q = 0; q < NV / 2; ++q) {
      reinterpret_cast<float2*>(dst)[q] = make_float2(src[2 * q], src[2 * q + 1]);
    }
  }
}

// The thread's tile of in[K][ROWS]^T @ W(K, N): rows r0..r0+TM, columns
// c0..c0+TN.  W is row-major (K, N) in device memory.  Ends with a barrier.
template <int K, int N, int TM, int TN, int KSTEP>
__device__ __forceinline__ void gemm_tile(const float* in, const float* __restrict__ W,
                                          float* wtile, float (&acc)[TM][TN], int r0,
                                          int c0) {
  static_assert(K % KSTEP == 0 && (KSTEP * N) % (4 * THREADS) == 0, "bad staging");
  const int t = threadIdx.x;
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
}

__device__ __forceinline__ bool keep(uint32_t hs, uint32_t local_row, uint32_t width,
                                     uint32_t col, uint32_t thresh) {
  return wang_hash((local_row * width + col) ^ hs) >= thresh;
}

// Forward layer: raw = tanh(in @ W + b), masked = dropout(raw) when DROP (else
// raw); masked goes to `out` (when given) and to the global scratch `g`.
template <int K, int N, int TN, int KSTEP, bool DROP>
__device__ __forceinline__ void fwd_layer(const Step& st, const float* in,
                                          const float* __restrict__ W,
                                          const float* __restrict__ bias, float* raw,
                                          float* out, float* g, float* wtile, uint32_t hs,
                                          int row0, uint32_t lr0) {
  constexpr int TM = 4;
  constexpr int NCG = N / TN;
  static_assert(NCG * (ROWS / TM) == THREADS, "tile does not cover the CTA");
  const int t = threadIdx.x;
  const int c0 = (t % NCG) * TN;
  const int r0 = (t / NCG) * TM;
  float acc[TM][TN];
  gemm_tile<K, N, TM, TN, KSTEP>(in, W, wtile, acc, r0, c0);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float bj = __ldg(bias + c0 + j);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float h = tanhf(acc[i][j] + bj);
      float hd = h;
      if (DROP) {
        hd = keep(hs, lr0 + r0 + i, N, c0 + j, st.thresh) ? h * st.inv_keep : 0.0f;
      }
      raw[(c0 + j) * ROWS + r0 + i] = h;
      if (out != nullptr) out[(c0 + j) * ROWS + r0 + i] = hd;
      acc[i][j] = hd;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (row0 + r0 + i < st.n) store_vec<TN>(g + (size_t)(row0 + r0 + i) * N + c0, acc[i]);
  }
  __syncthreads();
}

// Backward layer: d = in @ WT (WT row-major (K, N) = W^T), plus
// rowadd[row] * wadd[col] when given; then the dropout mask when DROP (kept
// values times 1/(1-p)), then times (1 - raw^2).  To `out` and to `g`.
template <int K, int N, int TN, bool DROP>
__device__ __forceinline__ void bwd_layer(const Step& st, const float* in,
                                          const float* __restrict__ WT, const float* raw,
                                          const float* rowadd, const float* __restrict__ wadd,
                                          float* out, float* g, float* wtile, uint32_t hs,
                                          int row0, uint32_t lr0) {
  constexpr int TM = 4;
  constexpr int NCG = N / TN;
  static_assert(NCG * (ROWS / TM) == THREADS, "tile does not cover the CTA");
  const int t = threadIdx.x;
  const int c0 = (t % NCG) * TN;
  const int r0 = (t / NCG) * TM;
  float acc[TM][TN];
  gemm_tile<K, N, TM, TN, KT>(in, WT, wtile, acc, r0, c0);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float wj = wadd != nullptr ? __ldg(wadd + c0 + j) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float d = acc[i][j];
      if (rowadd != nullptr) d = rowadd[r0 + i] * wj + d;
      if (DROP) {
        d = keep(hs, lr0 + r0 + i, N, c0 + j, st.thresh) ? d * st.inv_keep : 0.0f;
      }
      const float h = raw[(c0 + j) * ROWS + r0 + i];
      d = d * (1.0f - h * h);
      out[(c0 + j) * ROWS + r0 + i] = d;
      acc[i][j] = d;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (row0 + r0 + i < st.n) store_vec<TN>(g + (size_t)(row0 + r0 + i) * N + c0, acc[i]);
  }
  __syncthreads();
}

// Partial dot products of each row of in[K][ROWS] with w (K,): eight threads
// per row, each over an eighth of K, into red[8][ROWS].  Ends with a barrier.
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
  const float s01 = red[r] + red[ROWS + r];
  const float s23 = red[2 * ROWS + r] + red[3 * ROWS + r];
  const float s45 = red[4 * ROWS + r] + red[5 * ROWS + r];
  const float s67 = red[6 * ROWS + r] + red[7 * ROWS + r];
  return ((s01 + s23) + (s45 + s67)) + b;
}

__global__ void __launch_bounds__(THREADS, 1) fwd_bwd_kernel(Step st) {
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;
  float* R1 = xT + D_IN * ROWS;
  float* R2 = R1 + H * ROWS;
  float* R3 = R2 + H * ROWS;
  float* RT1 = R3 + H * ROWS;
  float* RT2 = RT1 + V0 * ROWS;
  float* P = RT2 + V1 * ROWS;
  float* Q = P + H * ROWS;
  float* wtile = Q + H * ROWS;
  float* red = wtile + KT * H;
  float* rowv = red + 8 * ROWS;  // [0, ROWS): dpred, [ROWS, 2 ROWS): dq3

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int n = st.n;
  for (int q = t; q < ROWS * D_IN; q += THREADS) {
    const int r = q / D_IN, d = q % D_IN;
    xT[d * ROWS + r] = row0 + r < n ? st.x[(size_t)(row0 + r) * D_IN + d] : 0.0f;
  }
  __syncthreads();

  const uint32_t blk = (uint32_t)row0 / MASK_BLOCK;
  const uint32_t lr0 = (uint32_t)row0 % MASK_BLOCK;
  const uint32_t salt = st.seed * 2654435761u + (uint32_t)st.t * 40503u + blk * 7919u;
  const uint32_t hs0 = hashed_salt(salt + 0u), hs1 = hashed_salt(salt + 1u);
  const uint32_t hs2 = hashed_salt(salt + 2u), hs3 = hashed_salt(salt + 3u);
  const float* p = st.p;
  const Scratch& s = st.s;

  // ---- forward ----
  fwd_layer<D_IN, H, 8, D_IN, true>(st, xT, p + OFF_W1, p + OFF_W1 + D_IN * H, R1, P, s.h1d,
                                    wtile, hs0, row0, lr0);
  fwd_layer<H, H, 8, KT, true>(st, P, p + OFF_W2, p + OFF_W2 + H * H, R2, Q, s.h2d, wtile, hs1,
                               row0, lr0);
  fwd_layer<H, H, 8, KT, true>(st, Q, p + OFF_W3, p + OFF_W3 + H * H, R3, P, s.h3d, wtile, hs2,
                               row0, lr0);
  row_dot<H>(P, p + OFF_WM, red);
  float pred = 0.0f;
  if (t < ROWS) pred = reduce_row(red, t, __ldg(p + OFF_WM + H));
  fwd_layer<H, V0, 4, KT, true>(st, P, p + OFF_V1, p + OFF_V1 + H * V0, RT1, Q, s.t1d, wtile,
                                hs3, row0, lr0);
  fwd_layer<V0, V1, 2, KT, false>(st, Q, p + OFF_V2, p + OFF_V2 + V0 * V1, RT2, nullptr, s.t2,
                                  wtile, 0u, row0, lr0);
  // the row_dot below overwrites red only after the barriers of the layers
  // above, so the mean-head reduction has been read by then
  row_dot<V1>(RT2, p + OFF_V3, red);

  // ---- loss and the head's deltas, one thread per row ----
  if (t < ROWS) {
    const int row = row0 + t;
    const bool valid = row < n;
    const float q3 = reduce_row(red, t, __ldg(p + OFF_V3 + V1));
    const float yv = valid ? st.y[row] : 0.0f;
    const float sp = fmaxf(q3, 0.0f) + log1pf(expf(-fabsf(q3)));  // jax.nn.softplus
    const float lv = logf(sp + 1e-6f);
    const float r = yv - pred;
    const float e = expf(-lv);
    const float loss = 0.5f * e * r * r + 0.5f * lv + 0.01f * fabsf(lv);
    const float sgn = lv > 0.0f ? 1.0f : (lv < 0.0f ? -1.0f : 0.0f);
    const float dpred = (-e * r) * st.inv_n;
    const float dlv = (0.5f * (1.0f - e * r * r) + 0.01f * sgn) * st.inv_n;
    const float sig = 1.0f / (1.0f + expf(-q3));
    const float dq3 = dlv * sig / (sp + 1e-6f);
    rowv[t] = valid ? dpred : 0.0f;
    rowv[ROWS + t] = valid ? dq3 : 0.0f;
    if (valid) {
      s.lossrow[row] = loss;
      s.dpred[row] = dpred;
      s.dq3[row] = dq3;
    }
  }
  __syncthreads();

  // ---- backward ----
  // dq2 = (dq3 V3^T) * (1 - t2^2), into Q[V1][ROWS]
  for (int q = t; q < ROWS * V1; q += THREADS) {
    const int r = q / V1, j = q % V1;
    const float t2 = RT2[j * ROWS + r];
    const float d = (rowv[ROWS + r] * __ldg(p + OFF_V3 + j)) * (1.0f - t2 * t2);
    Q[j * ROWS + r] = d;
    if (row0 + r < n) s.dq2[(size_t)(row0 + r) * V1 + j] = d;
  }
  __syncthreads();
  // dq1 = mask3(dq2 V2^T) * (1 - t1^2), into P[V0][ROWS]
  bwd_layer<V1, V0, 4, true>(st, Q, st.v2t, RT1, nullptr, nullptr, P, s.dq1, wtile, hs3, row0,
                             lr0);
  // da3 = mask2(dpred Wm^T + dq1 V1^T) * (1 - h3^2), into Q
  bwd_layer<V0, H, 8, true>(st, P, st.v1t, R3, rowv, p + OFF_WM, Q, s.da3, wtile, hs2, row0,
                            lr0);
  // da2 = mask1(da3 W3^T) * (1 - h2^2), into P
  bwd_layer<H, H, 8, true>(st, Q, st.w3t, R2, nullptr, nullptr, P, s.da2, wtile, hs1, row0,
                           lr0);
  // da1 = mask0(da2 W2^T) * (1 - h1^2), into Q
  bwd_layer<H, H, 8, true>(st, P, st.w2t, R1, nullptr, nullptr, Q, s.da1, wtile, hs0, row0,
                           lr0);
}

// One gradient tensor of wgrad_kernel: G (K + 1, J) = [A | 1]^T D over the rows.
struct GradTensor {
  const float* a;  // (n, k)
  const float* d;  // (n, j)
  int k, j, off;
};

struct GradPass {
  GradTensor g[NT];
  int unit0[NT + 1];  // first work unit of each tensor; unit0[NT] = total
  float* part;        // [SPLIT][N_PARAM]
  int n;
  int seg_rows;
};

__global__ void __launch_bounds__(THREADS) wgrad_kernel(GradPass gp) {
  __shared__ __align__(16) float As[GR][GT];
  __shared__ __align__(16) float Ds[GR][GT];
  const int t = threadIdx.x;
  const int u = blockIdx.x, seg = blockIdx.y;
  int i = 0;
  while (u >= gp.unit0[i + 1]) ++i;
  const GradTensor g = gp.g[i];
  const int jtiles = (g.j + GT - 1) / GT;
  const int k0 = ((u - gp.unit0[i]) / jtiles) * GT;
  const int j0 = ((u - gp.unit0[i]) % jtiles) * GT;
  const int rb = seg * gp.seg_rows;
  const int re = min(gp.n, rb + gp.seg_rows);
  const int tk = t / (GT / 4), tj = t % (GT / 4);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int r = rb; r < re; r += GR) {
    for (int q = t; q < GR * GT; q += THREADS) {
      const int rr = q / GT, c = q % GT;
      const int row = r + rr;
      const int k = k0 + c, j = j0 + c;
      float av = 0.0f, dv = 0.0f;
      if (row < re) {
        av = k < g.k ? g.a[(size_t)row * g.k + k] : (k == g.k ? 1.0f : 0.0f);
        if (j < g.j) dv = g.d[(size_t)row * g.j + j];
      }
      As[rr][c] = av;
      Ds[rr][c] = dv;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < GR; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[rr][tk * 4]);
      const float4 d = *reinterpret_cast<const float4*>(&Ds[rr][tj * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], dv[y], acc[x][y]);
    }
    __syncthreads();
  }

  float* out = gp.part + (size_t)seg * N_PARAM + g.off;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + tk * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tj * 4 + b;
      if (k <= g.k && j < g.j) out[k * g.j + j] = acc[a][b];
    }
  }
}

// grad = the SPLIT partials summed in segment order; the last CTA reduces the
// per-row losses in a fixed order into loss[t].  A non-finite gradient element
// or loss sets flags[t].
__global__ void __launch_bounds__(THREADS) finalize_kernel(const float* __restrict__ part,
                                                           float* grad,
                                                           const float* __restrict__ lossrow,
                                                           int n, float inv_n, float* loss,
                                                           int* flags, int t) {
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float red[THREADS];
    float s = 0.0f;
    for (int r = threadIdx.x; r < n; r += THREADS) s += lossrow[r];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float l = red[0] * inv_n;
      loss[t] = l;
      if (!isfinite(l)) atomicOr(flags + t, 1);
    }
    return;
  }
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= N_PARAM) return;
  float g = part[e];
#pragma unroll
  for (int sg = 1; sg < SPLIT; ++sg) g += part[(size_t)sg * N_PARAM + e];
  grad[e] = g;
  if (!isfinite(g)) atomicOr(flags + t, 1);
}

struct Transposed {
  float *w2t, *w3t, *v1t, *v2t;
};

// Write parameter e's value into the transposed copy of its matrix, if any.
__device__ __forceinline__ void put_transposed(const Transposed& tr, int e, float w) {
  if (e >= OFF_W2 && e < OFF_W2 + H * H) {
    const int q = e - OFF_W2;
    tr.w2t[(q % H) * H + q / H] = w;
  } else if (e >= OFF_W3 && e < OFF_W3 + H * H) {
    const int q = e - OFF_W3;
    tr.w3t[(q % H) * H + q / H] = w;
  } else if (e >= OFF_V1 && e < OFF_V1 + H * V0) {
    const int q = e - OFF_V1;
    tr.v1t[(q % V0) * H + q / V0] = w;
  } else if (e >= OFF_V2 && e < OFF_V2 + V0 * V1) {
    const int q = e - OFF_V2;
    tr.v2t[(q % V1) * V0 + q / V1] = w;
  }
}

__global__ void __launch_bounds__(THREADS) transpose_kernel(const float* __restrict__ p,
                                                            Transposed tr) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e < N_PARAM) put_transposed(tr, e, p[e]);
}

// Adam + StepLR over the flat parameters.  counts[t] is the Adam count before
// step t; CTA 0 writes counts[t + 1].
__global__ void __launch_bounds__(THREADS) adam_kernel(float* p, float* m, float* v,
                                                       const float* __restrict__ grad,
                                                       Transposed tr, const int* flags,
                                                       int* counts, int t, float lr, int lr_step,
                                                       float lr_gamma, int skip) {
  const bool apply = !(skip && flags[t] != 0);
  const int c = counts[t];
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[t + 1] = apply ? c + 1 : c;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (!apply || e >= N_PARAM) return;
  const float b1 = 0.9f, b2 = 0.999f;
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
  const float lr_t = lr * powf(lr_gamma, floorf((float)c / (float)lr_step));
  const float bc1 = 1.0f - powf(b1, (float)(c + 1));
  const float bc2 = 1.0f - powf(b2, (float)(c + 1));
  const float g = grad[e];
  const float mm = b1 * m[e] + omb1 * g;
  const float vv = b2 * v[e] + omb2 * (g * g);
  m[e] = mm;
  v[e] = vv;
  const float mhat = mm / bc1;
  const float vhat = vv / bc2;
  const float w = p[e] - lr_t * (mhat / (sqrtf(vhat) + 1e-8f));
  p[e] = w;
  put_transposed(tr, e, w);
}

struct Workspace {
  float *grad, *part;
  Transposed tr;
  Scratch s;
};

// Carve the workspace into its buffers; returns its length in floats (with
// work == nullptr it only measures).
size_t carve(float* work, int n, Workspace* w) {
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* ptr = work != nullptr ? work + off : nullptr;
    off += round4(floats);
    return ptr;
  };
  const size_t nn = (size_t)n;
  w->grad = take(N_PARAM);
  w->part = take((size_t)SPLIT * N_PARAM);
  w->tr.w2t = take(H * H);
  w->tr.w3t = take(H * H);
  w->tr.v1t = take(V0 * H);
  w->tr.v2t = take(V1 * V0);
  w->s.h1d = take(nn * H);
  w->s.h2d = take(nn * H);
  w->s.h3d = take(nn * H);
  w->s.t1d = take(nn * V0);
  w->s.t2 = take(nn * V1);
  w->s.da1 = take(nn * H);
  w->s.da2 = take(nn * H);
  w->s.da3 = take(nn * H);
  w->s.dq1 = take(nn * V0);
  w->s.dq2 = take(nn * V1);
  w->s.dpred = take(nn);
  w->s.dq3 = take(nn);
  w->s.lossrow = take(nn);
  return off;
}

}  // namespace

// Layout of the flat parameter buffer: out[i] (i < 7) is the offset of tensor
// block i (W1, W2, W3, Wm, V1, V2, V3: W (in, out) row-major, then its bias),
// out[7] the buffer's length in floats.
extern "C" void pinnfc_train_dnn_layout(int* out) {
  const int offs[NT + 1] = {OFF_W1, OFF_W2, OFF_W3, OFF_WM, OFF_V1, OFF_V2, OFF_V3, N_PARAM};
  for (int i = 0; i <= NT; ++i) out[i] = offs[i];
}

// Floats of the scratch workspace for n rows.
extern "C" long long pinnfc_train_dnn_workspace_floats(int n) {
  Workspace w;
  return (long long)carve(nullptr, n, &w);
}

// Run n_iter steps on `stream`; returns the first CUDA error (0 on success).
// params, m, v: flat buffers of the layout above (m, v zero at the start of a
// stage), updated in place.  work: workspace_floats(n) floats.  ints: 2 n_iter
// + 1 zeroed int32 (flags, then the Adam counts).  losses: (n_iter,).
extern "C" int pinnfc_train_dnn(const float* x, const float* y, int n, float* params, float* m,
                                float* v, float* work, int* ints, float* losses, uint32_t seed,
                                int n_iter, float lr, int lr_step, float lr_gamma,
                                uint32_t thresh, float inv_keep, float inv_n, int skip,
                                void* stream_ptr) {
  if (n <= 0 || n_iter <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = cudaFuncSetAttribute(fwd_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Workspace w;
  carve(work, n, &w);
  int* flags = ints;
  int* counts = ints + n_iter;

  GradPass gp;
  const float* a_src[NT] = {x, w.s.h1d, w.s.h2d, w.s.h3d, w.s.h3d, w.s.t1d, w.s.t2};
  const float* d_src[NT] = {w.s.da1, w.s.da2, w.s.da3, w.s.dpred, w.s.dq1, w.s.dq2, w.s.dq3};
  const int ks[NT] = {D_IN, H, H, H, H, V0, V1};
  const int js[NT] = {H, H, H, 1, V0, V1, 1};
  const int offs[NT] = {OFF_W1, OFF_W2, OFF_W3, OFF_WM, OFF_V1, OFF_V2, OFF_V3};
  gp.unit0[0] = 0;
  for (int i = 0; i < NT; ++i) {
    gp.g[i] = GradTensor{a_src[i], d_src[i], ks[i], js[i], offs[i]};
    const int units = ((ks[i] + 1 + GT - 1) / GT) * ((js[i] + GT - 1) / GT);
    gp.unit0[i + 1] = gp.unit0[i] + units;
  }
  gp.part = w.part;
  gp.n = n;
  gp.seg_rows = ((n + SPLIT - 1) / SPLIT + GR - 1) / GR * GR;

  Step st;
  st.x = x;
  st.y = y;
  st.n = n;
  st.p = params;
  st.w2t = w.tr.w2t;
  st.w3t = w.tr.w3t;
  st.v1t = w.tr.v1t;
  st.v2t = w.tr.v2t;
  st.s = w.s;
  st.seed = seed;
  st.thresh = thresh;
  st.inv_keep = inv_keep;
  st.inv_n = inv_n;

  // partial tiles never cover the layout's gaps: zero them once
  err = cudaMemsetAsync(w.part, 0, sizeof(float) * (size_t)SPLIT * N_PARAM, stream);
  if (err != cudaSuccess) return (int)err;
  const int pblocks = (N_PARAM + THREADS - 1) / THREADS;
  transpose_kernel<<<pblocks, THREADS, 0, stream>>>(params, w.tr);
  const int row_blocks = (n + ROWS - 1) / ROWS;
  const dim3 wgrid(gp.unit0[NT], SPLIT);
  for (int t = 0; t < n_iter; ++t) {
    st.t = t;
    fwd_bwd_kernel<<<row_blocks, THREADS, SMEM_BYTES, stream>>>(st);
    wgrad_kernel<<<wgrid, THREADS, 0, stream>>>(gp);
    finalize_kernel<<<pblocks + 1, THREADS, 0, stream>>>(w.part, w.grad, w.s.lossrow, n, inv_n,
                                                          losses, flags, t);
    adam_kernel<<<pblocks, THREADS, 0, stream>>>(params, m, v, w.grad, w.tr, flags, counts, t,
                                                 lr, lr_step, lr_gamma, skip);
    if (t == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
