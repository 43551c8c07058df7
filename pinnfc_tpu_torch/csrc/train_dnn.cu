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
// gradients): 6.25 GFLOP at N = 6,000.  Every product of output width >= 64
// runs on the tensor cores in 3xTF32, three TF32 products for each float32
// one, so float32 accuracy costs 18.8 GFLOP of TF32: 0.038 ms/step against
// 495 TFLOP/s.  The same work in float32 outside the tensor cores would take
// 0.093 ms/step at 67 TFLOP/s.  The data (0.19 MB) and the state (weights,
// Adam moments, 2.8 MB) stay in L2; the per-step scratch barely fits: the
// 3xTF32 form writes and reads back 7,692 bytes per row (960 masked
// activations and 962 deltas in float32), 46 MB at N = 6,000 against the
// card's 50 MB of L2.
//
// 3xTF32 ("highest", the TPU kernel's Precision.HIGHEST).  warp_mma_3xtf32 is
// the one tile routine of every product: a warp's C(16 TM x 8 TN) += A(16 TM x
// K) B(K x 8 TN) from shared memory, with the strides of A and B as template
// arguments, so that the forward, the input-gradient backward and the weight
// gradients (A transposed) share it.  Each float32 operand is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and
// mma.sync.m16n8k8 (TF32 in, float32 accumulate) adds a_lo b_hi, a_hi b_lo,
// then a_hi b_hi into a zeroed accumulator for each k8 step, which is then
// added to the running sum in float32 (summed over all of K inside the tensor
// core, the gradient was ~1e-5 of max|g| from a float64 one, 20-50x the
// float32 plain version's gap); the dropped a_lo b_lo is about 2^-22 of the
// product.  A NaN
// stays a NaN through the split, so a NaN row still reaches the flag.  cvt.rna
// is a sequence of instructions, so an operand that several warps read is
// split once, where it is written to shared memory, and kept as a hi and a lo
// plane; the weights, which one warp each reads, are split as they are loaded.
// (The shared templates' BF16 = true branches, the first port of the bf16
// form, are no longer instantiated.)
//
// bf16 ("default", the TPU kernel's mxu_prec = None: one bf16 MXU pass): the
// same entries with `bf16` set.  Its rounding contract, which the plain
// version with product_dtype=torch.bfloat16 shares: every product of a step
// takes operands rounded to bf16 (nearest even, cvt.rn.bf16x2.f32, as
// torch's .to(torch.bfloat16)) and accumulates in float32; the width-1 heads
// (Wm, V3: their row dots, the dq3 V3^T and dpred Wm^T outer products, their
// weight gradients) round both operands of each float32 FMA; a masked
// activation is rounded as the value h (1/(1-p)) that the next product reads.
// Bias adds, bias-gradient sums, tanh, softplus, the loss, the masks, the
// (1 - h^2) of the backward (from the float32 h), Adam and the master weights
// stay float32.  The bf16 work is 6.25 GFLOP per step at N = 6,000: 0.0063 ms
// against 989 TFLOP/s, so the form is bound by operations.  What held back
// its first port (0.19 ms/step: the 3xTF32 kernels with bf16 tile routines)
// was everything around the products: float32 operands rounded at every
// fragment load by every warp, the 3xTF32 layout (one 48-row CTA of 8 warps
// per SM, epilogues through shared memory), two hashes per mask element, and
// the float32 scratch.  It has kernels of its own:
//  - bf16_weights_kernel rounds the weights once per step into bf16 copies
//    in the workspace: W1 (padded with zero rows to K0 = 16), W2, W3, V1, V2,
//    and the transposes W2^T, W3^T, V1^T, V2^T that the backward reads.
//  - fwd_bwd_bf16_kernel: a CTA owns BROWS = 64 rows (94 CTAs at N = 6,000;
//    8 CTAs per 512-row mask block at row_off 0) with 16 warps, 2 row slices
//    x 8 column eighths of 32 x N/8 each, so an A fragment is loaded by 8
//    warps and a B fragment by 2, not by all.  Activations and deltas live in
//    shared memory as bf16 [row][feature], rounded once in the epilogue; the
//    bf16 weights stream through a cp.async ring of 64-row tiles (the next
//    layer's first tiles requested before each epilogue); every fragment
//    comes from ldmatrix (.trans for the (K, N) weights).  The epilogues work
//    on the accumulators in registers, four tanhf per out-of-line call.  The
//    forward hashes each masked element once (the row's part of the hash
//    folded into one key per row) and stores the backward's factor, (1 - h^2)
//    where kept and 0 where dropped, as float32 in fragment order (a float4
//    per thread and tile, coalesced), so the backward calls no hash and reads
//    no h.  The bias gradients (column sums
//    of the float32 deltas) and the width-1 heads' weight gradients are
//    summed over the CTA's rows in a fixed order (colsum).  The masked
//    activations and the deltas go to a bf16 scratch for the weight
//    gradients.
//  - wgrad_bf16_kernel: the tensor-core weight gradients A^T D from the bf16
//    scratch in 64 x 128 tiles (24 tiles x SPLIT row segments, one wave),
//    64-row chunks through a cp.async ring, both operands through
//    ldmatrix.trans, with no conversion; two groups of 8 warps split each
//    chunk's k16 steps and add their sums in group order at the end.  One
//    more CTA per segment adds the segment's colsum rows in CTA order.
//    finalize_kernel and adam_kernel are the 3xTF32 form's.
// Per row its scratch holds 3,744 bytes of bf16 operands (x padded, four
// masked activations, five deltas) and 3,584 of float32 factors; it shares
// the workspace with the 3xTF32 form's scratch.  Where its time goes, on an
// H100 (ops/train_ablation.py: clock stamps inside fwd_bwd_bf16_kernel, and
// copies of this file with one part removed each, PERF.md): the epilogues
// (tanh, hash, factor stores and loads) and the products take turns inside a
// CTA, and the weight stream (every CTA reads all 0.7 MB of bf16 weights)
// costs more than the tensor-core work.  A second 64-row CTA per SM, a
// deeper ring, L2 eviction hints, weight tiles by bulk copies (one warp
// issuing a row each, on mbarriers), and a 2-CTA cluster that splits each
// layer's columns (each CTA streaming half the weights) all ran slower;
// bulk-copy stores of the scratch ran no faster.

// Design.  The TPU kernel is one program that loops over steps and 512-row
// blocks with all state in VMEM; on the H100 that shape would use one SM.  Here
// every step is four launches on the caller's stream (five in the bf16 form,
// whose kernels 1 and 2 are the ones above), queued from C with no host sync,
// and all state stays in device memory for the stage:
//  1. fwd_bwd_kernel: a CTA owns ROWS = 48 rows (125 CTAs at N = 6,000, one
//     wave on 132 SMs, one CTA per SM) and runs the forward and the
//     input-gradient backward for them.  The layer's input lives in shared
//     memory as [row][feature], split into hi and lo planes with a leading
//     dimension of width + 4 (A fragment on banks 4g + q); the output replaces
//     it.  The weights stream from L2 in KT-row tiles through an NSTAGE-tile
//     cp.async ring (leading dimension width + 8: B fragment on banks 8q + g);
//     the next layer's first tiles are requested before this layer's
//     epilogue.  Each of the 8 warps owns all 48 rows of an eighth of the
//     output columns.  The epilogue puts the C tile in shared memory and then
//     walks it four columns at a time (a short loop: fully unrolled
//     epilogues made the kernel's code too large to stay in the instruction
//     cache): bias, tanh and the mask forward; the dpred Wm^T term, the mask
//     and (1 - h^2) backward, with h read back from the masked activations in
//     the global scratch.  The masks are recomputed from the hash in the
//     backward rather than stored.  The width-1 heads are row dot products
//     reduced by warp shuffles in a fixed order.  It writes the masked
//     activations and the deltas of every layer to the global scratch, and
//     the per-row loss.
//  2. wgrad_kernel: every weight gradient is A^T D summed over the rows: A
//     (the activations, or x) as the transposed mma A operand, D (the deltas)
//     as B, the rows as the mma's k.  A CTA owns a 64 x 64 tile of one gradient
//     tensor and one of SPLIT fixed row segments, and walks its rows in order,
//     32-row chunks of A and D through a cp.async ring with a leading dimension
//     of 72 (fragment loads conflict-free), each chunk split once into hi and lo.
//     The CTA of a column tile's first row tile also sums D's columns in the
//     same pass: the bias row.  The width-1 heads (Wm, V3) are column sums of
//     A scaled by D, in scalar float32.  No float atomics: the result is the
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
// float32 constant 1/(1-p).  A CTA's rows may straddle two mask blocks.  Rows
// past n take no part in the loss or the gradients, and the mean divides by
// the true n.  tanhf/logf/expf/log1pf are the accurate versions (no fast math).
//
// Data-parallel steps.  A whole-stage launch cannot sum gradients across
// devices, so two more entries split a step: pinnfc_train_dnn_grad runs
// kernels 1-3 for one row shard (its rows are global rows row_off ..
// row_off + n - 1 for the masks, and inv_n is 1 / the rows of all shards, so
// the shard's gradient and loss are its terms of the whole mean), and
// pinnfc_train_dnn_adam runs kernel 4 from the gradient summed over the
// shards.  The caller sums the shards' gradients, losses and flags in a fixed
// order between the two.  The whole-stage entry is the same code at
// row_off = 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int D_IN = 8;
constexpr int H = 256;   // trunk width
constexpr int V0 = 128;  // first variance layer
constexpr int V1 = 64;   // second variance layer
constexpr int ROWS = 48;  // rows per CTA of fwd_bwd_kernel
constexpr int MT = ROWS / 16;  // ... in 16-row mma tiles
constexpr int THREADS = 256;
constexpr int KT = 16;      // weight rows per staged tile
constexpr int NSTAGE = 4;   // tiles in fwd_bwd_kernel's weight ring
constexpr uint32_t MASK_BLOCK = 512;
constexpr int SPLIT = 5;     // row segments of the weight-gradient pass
constexpr int GT = 64;       // gradient tile edge
constexpr int GR = 32;       // rows per chunk of a gradient tile
constexpr int GLD = GT + 8;  // leading dimension of a staged chunk
constexpr int GPLANE = GR * GLD;  // floats of one staged chunk of A or D
constexpr int GSTAGE = 3;    // chunks in wgrad_kernel's ring
// shared memory of wgrad_kernel: the ring and the lo planes of one chunk (three
// CTAs fit on an SM)
constexpr size_t GSMEM_BYTES = (GSTAGE * 2 + 2) * GPLANE * sizeof(float);  // 73,728

static_assert(ROWS % 16 == 0 && ROWS <= (int)MASK_BLOCK,
              "whole mma tiles; a CTA's rows touch at most two mask blocks");
static_assert(THREADS == 256, "fwd_bwd_kernel's warp tiles: 8 warps x ROWS rows");

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

// Leading dimensions, in floats, of fwd_bwd_kernel's shared buffers of width
// w: mma A operands (the fragment load at row g, column q falls on bank
// 4g + q) and weight tiles (a B fragment at row q, column g on bank 8q + g).
__host__ __device__ constexpr int lda(int w) { return w + 4; }
__host__ __device__ constexpr int ldb(int w) { return w + 8; }
constexpr int WBUF = KT * ldb(H);  // floats of one staged weight tile
constexpr int X_PLANE = ROWS * lda(D_IN);  // floats between the hi and lo planes of x
constexpr int ACT_PLANE = ROWS * lda(H);   // ... of the activation or delta buffer

// shared memory of fwd_bwd_kernel, in floats
constexpr int SMEM_FLOATS = 2 * X_PLANE      // x, split
                          + 2 * ACT_PLANE    // the layer's input, then its output, split
                          + NSTAGE * WBUF    // weight-tile ring
                          + 2 * ROWS         // the two heads' row dot products
                          + 2 * ROWS;        // per-row dpred, dq3
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);  // 172,800
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
  int row_off;  // global row of row 0: the masks' rows
  uint32_t thresh;
  float inv_keep;
  float inv_n;
};

// x = hi + lo + O(2^-22 |x|), both TF32 (cvt.rna: round to nearest, ties away
// from zero, to 10 mantissa bits).  A NaN gives NaN in both; inf gives hi = inf
// and lo = NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// c += a b on one m16n8k8 tile: TF32 operands, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on one m16n8k16 tile: bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half; NaN stays NaN
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t p;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(p) : "f"(hi), "f"(lo));
  return p;
}

// A product operand in the form BF16: x rounded to bf16 (nearest even), as
// float32; x itself in the 3xTF32 form (whose products are float32-accurate).
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? __uint_as_float(pack_bf16x2(x, 0.0f) << 16) : x;
}

// 16 bytes from global to shared memory without passing through registers;
// with valid false the destination is filled with zeros and src is not read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One warp's C(16 TM x 8 TN) += A(16 TM x K) B(K x 8 TN) in 3xTF32, both
// operands in shared memory: A(m, k) = a[m * AM + k * AK], B(k, n) =
// b[k * BK + n * BN].  A is split already: its hi parts at a, its lo parts at
// a_lo in the same layout.  B likewise with B_PRE (lo parts at b_lo);
// without, B is float32 and is split here.  With g = lane / 4 and
// q = lane % 4, the fragments are A: (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4); B: (q, g), (q + 4, g); c[i][j][0..1] is C at row 16 i + g,
// columns 8 j + 2 q + 0..1, and c[i][j][2..3] the same columns eight rows
// below.
template <int TM, int TN, int K, int AM, int AK, int BK, int BN, bool B_PRE>
__device__ __forceinline__ void warp_mma_3xtf32(const float* a, const float* a_lo,
                                                const float* b, const float* b_lo,
                                                float (&c)[TM][TN][4]) {
  static_assert(K % 8 == 0, "the mma's depth is 8");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[TM][4], al[TM][4], bh[TN][2], bl[TN][2];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int o0 = (16 * i + g) * AM + (k0 + q) * AK;
      const int at[4] = {o0, o0 + 8 * AM, o0 + 4 * AK, o0 + 8 * AM + 4 * AK};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[i][e] = __float_as_uint(a[at[e]]);
        al[i][e] = __float_as_uint(a_lo[at[e]]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o0 = (k0 + q) * BK + (8 * j + g) * BN;
      const int bt[2] = {o0, o0 + 4 * BK};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (B_PRE) {
          bh[j][e] = __float_as_uint(b[bt[e]]);
          bl[j][e] = __float_as_uint(b_lo[bt[e]]);
        } else {
          split_tf32(b[bt[e]], bh[j][e], bl[j][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // this k8 step's three products, added to c in float32
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(p, al[i], bh[j]);
        mma_tf32(p, ah[i], bl[j]);
        mma_tf32(p, ah[i], bh[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] += p[e];
      }
  }
}

// One warp's C(16 TM x 8 TN) += A(16 TM x K) B(K x 8 TN) in bf16, both
// operands float32 in shared memory in the layout of warp_mma_3xtf32 (one
// plane each), rounded to bf16 as they are packed into the fragments of
// mma.sync.m16n8k16.  With g = lane / 4 and q = lane % 4, a fragment register
// holds two neighbours along k, the lower k in the low half: A at (g, 2q),
// (g + 8, 2q), (g, 2q + 8), (g + 8, 2q + 8); B at (2q, g), (2q + 8, g); C as in
// warp_mma_3xtf32.  K = 8 (layer 0) is one k16 step whose upper half is zero
// in both operands, read from nowhere.
template <int TM, int TN, int K, int AM, int AK, int BK, int BN>
__device__ __forceinline__ void warp_mma_bf16(const float* a, const float* b,
                                              float (&c)[TM][TN][4]) {
  static_assert(K == 8 || K % 16 == 0, "the mma's depth is 16 (K = 8: a zero upper half)");
  constexpr bool HALF = K == 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[TM][4], bf[TN][2];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float* p = a + (16 * i + g) * AM + (k0 + 2 * q) * AK;
      af[i][0] = pack_bf16x2(p[0], p[AK]);
      af[i][1] = pack_bf16x2(p[8 * AM], p[8 * AM + AK]);
      af[i][2] = HALF ? 0u : pack_bf16x2(p[8 * AK], p[9 * AK]);
      af[i][3] = HALF ? 0u : pack_bf16x2(p[8 * AM + 8 * AK], p[8 * AM + 9 * AK]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float* p = b + (k0 + 2 * q) * BK + (8 * j + g) * BN;
      bf[j][0] = pack_bf16x2(p[0], p[BK]);
      bf[j][1] = HALF ? 0u : pack_bf16x2(p[8 * BK], p[9 * BK]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) mma_bf16(c[i][j], af[i], bf[j]);
  }
}

// Stage rows [k0, k0 + KS) of W (row-major (K, N) in device memory) into buf
// (leading dimension ldb(N)) with cp.async, as one committed group.
template <int N, int KS>
__device__ __forceinline__ void stage_weights(const float* __restrict__ W, int k0, float* buf) {
  constexpr int V = KS * N / (4 * THREADS);  // 16-byte copies per thread
  static_assert(V >= 1 && V * 4 * THREADS == KS * N && KS * ldb(N) <= WBUF, "bad staging");
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = threadIdx.x + v * THREADS;  // float4 index inside the staged rows
    cp_async16(buf + (e / (N / 4)) * ldb(N) + (e % (N / 4)) * 4, W + (size_t)(k0 * N + 4 * e),
               true);
  }
  cp_async_commit();
}

// Put the first NSTAGE - 1 tiles of W (K, N) in flight, one committed group
// each (empty groups past K), into the ring wtile.  cta_gemm<K, N, KS> expects
// them; a layer calls this for the next layer before its own epilogue.
template <int K, int N, int KS>
__device__ __forceinline__ void prefetch_weights(const float* __restrict__ W, float* wtile) {
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < K / KS) {
      stage_weights<N, KS>(W, s * KS, wtile + s * WBUF);
    } else {
      cp_async_commit();
    }
  }
}

// The CTA's C(ROWS x N) = in(ROWS x K, leading dimension lda(K)) @ W in the
// form BF16: in the 3xTF32 form in is split already, hi parts at in and lo
// parts at in + PLANE; in the bf16 form in is one float32 plane.  W row-major
// (K, N) in device memory, streamed KS rows at a time through the NSTAGE-tile ring
// wtile, whose first NSTAGE - 1 tiles prefetch_weights<K, N, KS> has put in
// flight: while the tensor cores work on tile c, tiles c + 1 .. c + NSTAGE - 1
// are on their way.  Warp w owns columns [w N/8, (w + 1) N/8) of all ROWS
// rows.  Ends with a barrier.
template <bool BF16, int K, int N, int KS, int PLANE>
__device__ __forceinline__ void cta_gemm(const float* in, const float* __restrict__ W,
                                         float* wtile, float (&acc)[MT][N / 64][4]) {
  static_assert(K % KS == 0, "bad staging");
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < N / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int c = 0; c < K / KS; ++c) {
    cp_async_wait<NSTAGE - 2>();  // tile c has landed (this thread's part)
    __syncthreads();              // ... everyone's, and tile c - 1 is free
    const int next = c + NSTAGE - 1;
    if (next < K / KS) {
      stage_weights<N, KS>(W, next * KS, wtile + (next % NSTAGE) * WBUF);
    } else {
      cp_async_commit();
    }
    const float* b = wtile + (c % NSTAGE) * WBUF + (t >> 5) * (N / 8);
    if constexpr (BF16) {
      warp_mma_bf16<MT, N / 64, KS, lda(K), 1, ldb(N), 1>(in + c * KS, b, acc);
    } else {
      warp_mma_3xtf32<MT, N / 64, KS, lda(K), 1, ldb(N), 1, false>(
          in + c * KS, in + PLANE + c * KS, b, nullptr, acc);
    }
  }
  __syncthreads();
}

// Write the warp's C fragments (see warp_mma_3xtf32), as float32, into the
// [ROWS][lda(N)] tile c (warp w's columns [w N/8, (w + 1) N/8)).
template <int N>
__device__ __forceinline__ void store_c_tile(const float (&acc)[MT][N / 64][4], float* c) {
  const int lane = threadIdx.x & 31;
  const int cw = (threadIdx.x >> 5) * (N / 8) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < N / 64; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = 16 * i + (lane >> 2) + 8 * f;
        *reinterpret_cast<float2*>(c + r * lda(N) + cw + 8 * j) =
            make_float2(acc[i][j][2 * f], acc[i][j][2 * f + 1]);
      }
}

// Store four values, split, into the hi and lo planes of a pre-split mma A
// operand.
__device__ __forceinline__ void store_split4(float* hi, int plane, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
  *reinterpret_cast<float4*>(hi) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                               __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(hi + plane) = make_float4(
      __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// Store four values as an mma A operand of the form BF16: split into the hi
// and lo planes (3xTF32), or as they are into the one plane (bf16: the
// fragment loads round them).
template <bool BF16>
__device__ __forceinline__ void store_operand4(float* at, int plane, const float (&v)[4]) {
  if (BF16) {
    *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    store_split4(at, plane, v);
  }
}

// The hashed salts of one layer's mask in the (at most two) mask blocks that
// a CTA's rows touch (global rows: local row + row_off): global rows below
// `split` lie in the first.
struct LayerSalt {
  uint32_t first, second;
  int split;
  __device__ __forceinline__ uint32_t at(int row) const { return row < split ? first : second; }
};

__device__ __forceinline__ bool keep(uint32_t hs, uint32_t local_row, uint32_t width,
                                     uint32_t col, uint32_t thresh) {
  return wang_hash((local_row * width + col) ^ hs) >= thresh;
}

// Forward layer: h = tanh(in @ W + b), masked = dropout(h) when DROP (else h).
// The product's C tile goes to act's hi plane (in is dead by then), then four
// columns of a row at a time: masked goes to the global scratch `g` and, as
// an operand (store_operand4), back into act as the next layer's input, or,
// with SPLIT_OUT false, nowhere else.  next() runs between the product and the
// epilogue.
template <bool BF16, int K, int N, int KS, int IN_PLANE, bool SPLIT_OUT, bool DROP, class Next>
__device__ __forceinline__ void fwd_layer(const Step& st, const float* in,
                                          const float* __restrict__ W,
                                          const float* __restrict__ bias, float* act, float* g,
                                          float* wtile, const LayerSalt& hs, int row0,
                                          Next next) {
  float acc[MT][N / 64][4];
  cta_gemm<BF16, K, N, KS, IN_PLANE>(in, W, wtile, acc);
  next();
  store_c_tile<N>(acc, act);
  __syncthreads();
#pragma unroll 2
  for (int e = threadIdx.x; e < ROWS * N / 4; e += THREADS) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    const int row = row0 + r;
    const float4 a = *reinterpret_cast<const float4*>(act + r * lda(N) + c);
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c));
    float hd[4] = {tanhf(a.x + b.x), tanhf(a.y + b.y), tanhf(a.z + b.z), tanhf(a.w + b.w)};
    if (DROP) {
      const int grow = row + st.row_off;
      const uint32_t s = hs.at(grow), lr = (uint32_t)grow % MASK_BLOCK;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hd[q] = keep(s, lr, N, c + q, st.thresh) ? hd[q] * st.inv_keep : 0.0f;
      }
    }
    if (SPLIT_OUT) store_operand4<BF16>(act + r * lda(N) + c, ACT_PLANE, hd);
    if (row < st.n) {
      *reinterpret_cast<float4*>(g + (size_t)row * N + c) = make_float4(hd[0], hd[1], hd[2], hd[3]);
    }
  }
  __syncthreads();
}

// Backward layer: d = in @ WT (WT row-major (K, N) = W^T), plus
// rowadd[row] * wadd[col] when given; then the dropout mask (kept values times
// 1/(1-p)), then times (1 - h^2); to the global scratch `g` and, as an
// operand, back into act.  h is the forward's tanh output, read back from its
// masked copy hd in the global scratch (this CTA's rows, written by this CTA): where kept,
// h = hd (1 - p) within two ulps of the forward's value (exactly, without
// dropout); where dropped d is 0.  The C tile goes through act's hi plane as
// in fwd_layer.  next() runs between the product and the epilogue.
template <bool BF16, int K, int N, class Next>
__device__ __forceinline__ void bwd_layer(const Step& st, const float* __restrict__ WT,
                                          const float* hd, const float* rowadd,
                                          const float* __restrict__ wadd, float* act, float* g,
                                          float* wtile, const LayerSalt& hs, int row0,
                                          Next next) {
  float acc[MT][N / 64][4];
  cta_gemm<BF16, K, N, KT, ACT_PLANE>(act, WT, wtile, acc);
  next();
  store_c_tile<N>(acc, act);
  __syncthreads();
  const float keep_scale = 1.0f / st.inv_keep;
#pragma unroll 2
  for (int e = threadIdx.x; e < ROWS * N / 4; e += THREADS) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    const int row = row0 + r;
    const float4 a = *reinterpret_cast<const float4*>(act + r * lda(N) + c);
    float d[4] = {a.x, a.y, a.z, a.w};
    if (rowadd != nullptr) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wadd + c));
      const float ra = operand<BF16>(rowadd[r]);
      d[0] = ra * operand<BF16>(w.x) + d[0];
      d[1] = ra * operand<BF16>(w.y) + d[1];
      d[2] = ra * operand<BF16>(w.z) + d[2];
      d[3] = ra * operand<BF16>(w.w) + d[3];
    }
    const float4 hv = row < st.n ? __ldcg(reinterpret_cast<const float4*>(hd + (size_t)row * N + c))
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float h[4] = {hv.x * keep_scale, hv.y * keep_scale, hv.z * keep_scale,
                        hv.w * keep_scale};
    const int grow = row + st.row_off;
    const uint32_t s = hs.at(grow), lr = (uint32_t)grow % MASK_BLOCK;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[q] = keep(s, lr, N, c + q, st.thresh) ? d[q] * st.inv_keep : 0.0f;
      d[q] = d[q] * (1.0f - h[q] * h[q]);
    }
    store_operand4<BF16>(act + r * lda(N) + c, ACT_PLANE, d);
    if (row < st.n) {
      *reinterpret_cast<float4*>(g + (size_t)row * N + c) = make_float4(d[0], d[1], d[2], d[3]);
    }
  }
  __syncthreads();
}

// sum[r] = in[r] . w for this CTA's first `rows` rows of in (K floats each, in
// the global scratch, read through L2), 0 for the others: warp w takes rows w,
// w + 8, ...; its lanes take every 32nd k, summed by a fixed shuffle tree.
// The operands are those of the form BF16.  Ends with a barrier.
template <bool BF16, int K>
__device__ __forceinline__ void row_dot(const float* in, int rows, const float* __restrict__ w,
                                        float* sum) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = threadIdx.x >> 5; r < ROWS; r += THREADS / 32) {
    float v = 0.0f;
    if (r < rows) {
#pragma unroll
      for (int k = lane; k < K; k += 32) {
        v = fmaf(operand<BF16>(__ldcg(in + (size_t)r * K + k)), operand<BF16>(__ldg(w + k)), v);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sum[r] = v;
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) fwd_bwd_kernel(Step st) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // 2 planes of [ROWS][lda(D_IN)] (bf16: 1 used)
  float* act = xs + 2 * X_PLANE;        // 2 planes of [ROWS][lda(width)] (bf16: 1 used)
  float* wtile = act + 2 * ACT_PLANE;   // NSTAGE x [KT][ldb(width)]
  float* head = wtile + NSTAGE * WBUF;  // [0, ROWS): h3 . Wm, [ROWS, 2 ROWS): t2 . V3
  float* rowv = head + 2 * ROWS;        // [0, ROWS): dpred, [ROWS, 2 ROWS): dq3

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int n = st.n;
  const int rows = min(ROWS, n - row0);  // this CTA's rows inside n
  const float* p = st.p;
  const Scratch& s = st.s;
  prefetch_weights<D_IN, H, D_IN>(p + OFF_W1, wtile);
  for (int q = t; q < ROWS * D_IN; q += THREADS) {
    const int r = q / D_IN, d = q % D_IN;
    const float xv = r < rows ? st.x[(size_t)(row0 + r) * D_IN + d] : 0.0f;
    if (BF16) {
      xs[r * lda(D_IN) + d] = xv;
    } else {
      uint32_t hi, lo;
      split_tf32(xv, hi, lo);
      xs[r * lda(D_IN) + d] = __uint_as_float(hi);
      xs[X_PLANE + r * lda(D_IN) + d] = __uint_as_float(lo);
    }
  }

  // mask salts of the layers (0..2 the trunk, 3 the first variance layer) in
  // the mask blocks of this CTA's rows
  const uint32_t blk = (uint32_t)(row0 + st.row_off) / MASK_BLOCK;
  const uint32_t base = st.seed * 2654435761u + (uint32_t)st.t * 40503u;
  LayerSalt hs[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    hs[l] = LayerSalt{hashed_salt(base + blk * 7919u + (uint32_t)l),
                      hashed_salt(base + (blk + 1u) * 7919u + (uint32_t)l),
                      (int)((blk + 1u) * MASK_BLOCK)};
  }

  // ---- forward ----
  fwd_layer<BF16, D_IN, H, D_IN, X_PLANE, true, true>(
      st, xs, p + OFF_W1, p + OFF_W1 + D_IN * H, act, s.h1d, wtile, hs[0], row0,
      [&] { prefetch_weights<H, H, KT>(p + OFF_W2, wtile); });
  fwd_layer<BF16, H, H, KT, ACT_PLANE, true, true>(
      st, act, p + OFF_W2, p + OFF_W2 + H * H, act, s.h2d, wtile, hs[1], row0,
      [&] { prefetch_weights<H, H, KT>(p + OFF_W3, wtile); });
  fwd_layer<BF16, H, H, KT, ACT_PLANE, true, true>(
      st, act, p + OFF_W3, p + OFF_W3 + H * H, act, s.h3d, wtile, hs[2], row0,
      [&] { prefetch_weights<H, V0, KT>(p + OFF_V1, wtile); });
  row_dot<BF16, H>(s.h3d + (size_t)row0 * H, rows, p + OFF_WM, head);
  fwd_layer<BF16, H, V0, KT, ACT_PLANE, true, true>(
      st, act, p + OFF_V1, p + OFF_V1 + H * V0, act, s.t1d, wtile, hs[3], row0,
      [&] { prefetch_weights<V0, V1, KT>(p + OFF_V2, wtile); });
  fwd_layer<BF16, V0, V1, KT, ACT_PLANE, false, false>(
      st, act, p + OFF_V2, p + OFF_V2 + V0 * V1, act, s.t2, wtile, hs[0], row0,
      [&] { prefetch_weights<V1, V0, KT>(st.v2t, wtile); });
  row_dot<BF16, V1>(s.t2 + (size_t)row0 * V1, rows, p + OFF_V3, head + ROWS);

  // ---- loss and the head's deltas, one thread per row ----
  if (t < ROWS) {
    const int row = row0 + t;
    const bool valid = row < n;
    const float pred = head[t] + __ldg(p + OFF_WM + H);
    const float q3 = head[ROWS + t] + __ldg(p + OFF_V3 + V1);
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
  // dq2 = (dq3 V3^T) * (1 - t2^2), an operand in act; the t2 loads first
  constexpr int DQ2 = ROWS * V1 / THREADS;
  static_assert(DQ2 * THREADS == ROWS * V1, "dq2 elements per thread");
  float t2v[DQ2];
#pragma unroll
  for (int e = 0; e < DQ2; ++e) {
    const int r = (t + e * THREADS) / V1, j = (t + e * THREADS) % V1;
    t2v[e] = r < rows ? __ldcg(s.t2 + (size_t)(row0 + r) * V1 + j) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < DQ2; ++e) {
    const int r = (t + e * THREADS) / V1, j = (t + e * THREADS) % V1;
    const float t2 = t2v[e];
    const float d = (operand<BF16>(rowv[ROWS + r]) * operand<BF16>(__ldg(p + OFF_V3 + j))) *
                    (1.0f - t2 * t2);
    if (BF16) {
      act[r * lda(V1) + j] = d;
    } else {
      uint32_t hi, lo;
      split_tf32(d, hi, lo);
      act[r * lda(V1) + j] = __uint_as_float(hi);
      act[ACT_PLANE + r * lda(V1) + j] = __uint_as_float(lo);
    }
    if (r < rows) s.dq2[(size_t)(row0 + r) * V1 + j] = d;
  }
  // (cta_gemm's first barrier orders these stores before the product reads them)
  // dq1 = mask3(dq2 V2^T) * (1 - t1^2)
  bwd_layer<BF16, V1, V0>(st, st.v2t, s.t1d, nullptr, nullptr, act, s.dq1, wtile, hs[3], row0,
                          [&] { prefetch_weights<V0, H, KT>(st.v1t, wtile); });
  // da3 = mask2(dpred Wm^T + dq1 V1^T) * (1 - h3^2)
  bwd_layer<BF16, V0, H>(st, st.v1t, s.h3d, rowv, p + OFF_WM, act, s.da3, wtile, hs[2], row0,
                         [&] { prefetch_weights<H, H, KT>(st.w3t, wtile); });
  // da2 = mask1(da3 W3^T) * (1 - h2^2)
  bwd_layer<BF16, H, H>(st, st.w3t, s.h2d, nullptr, nullptr, act, s.da2, wtile, hs[1], row0,
                        [&] { prefetch_weights<H, H, KT>(st.w2t, wtile); });
  // da1 = mask0(da2 W2^T) * (1 - h1^2)
  bwd_layer<BF16, H, H>(st, st.w2t, s.h1d, nullptr, nullptr, act, s.da1, wtile, hs[0], row0,
                        [] {});
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

// A CTA: the 64 x 64 tile (k0, j0) of one gradient tensor over row segment
// blockIdx.y, walked in GR-row chunks through a GSTAGE-chunk ring of A and D
// in shared memory (cp.async; GSTAGE - 1 chunks in flight while the tensor
// cores work on one).  Once a chunk has landed, each thread splits its slots
// (rows sr and sr + GR/2, columns sc..sc+3 of A and of D) once: hi in place,
// lo into a plane of its own (the bf16 form leaves them as staged and rounds
// as it packs the fragments); from the same float32 values it sums, over its
// rows in order, its columns of D (the bias row K, in the tile with k0 = 0)
// and, for a width-1 head, its columns of A times D (bf16 operands in the
// bf16 form).  Tensors of width J >= 64 (k % 4 == 0, j % 8 == 0) then go
// through the tensor cores: warp w owns rows k0 + 16 (w / 2) and columns
// j0 + 32 (w % 2) of the tile.  The sixteen threads of a column's sums are
// added in a fixed order at the end.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 3) wgrad_kernel(GradPass gp) {
  extern __shared__ __align__(16) float gsm[];  // GSTAGE x (A, D), then A lo, D lo
  float* alo = gsm + GSTAGE * 2 * GPLANE;
  float* dlo = alo + GPLANE;
  float* red = alo;  // after the chunks: [2][GR / 2][GT], per-thread column sums (bias, head)
  static_assert(GR * GT <= 2 * GPLANE, "the column sums fit the lo planes");
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
  const int chunks = rb < re ? (re - rb + GR - 1) / GR : 0;
  const bool head = g.j == 1;
  const bool bias = k0 == 0;
  const int warp = t >> 5;
  const int wk = (warp >> 1) * 16, wj = (warp & 1) * 32;
  const bool mma = !head && k0 + wk < g.k;
  // this thread's slots: rows sr and sr + GR/2 of a chunk, columns sc..sc+3
  const int sr = t / (GT / 4), sc = (t % (GT / 4)) * 4;
  static_assert(THREADS * 8 == GR * GT, "two 4-column slots per thread cover a chunk");

  float acc[1][4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][jn][e] = 0.0f;
  float bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // Stage chunk ch of the segment into its ring slot as one committed group
  // (the thread's own slots); rows past the segment and columns past the
  // tensor are zeros, and a head's D is its column 0.  Past the last chunk the
  // group is empty.
  auto stage = [&](int ch) {
    if (ch < chunks) {
      float* as = gsm + (ch % GSTAGE) * 2 * GPLANE;
      float* ds = as + GPLANE;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int rr = sr + v * (GR / 2);
        const int row = rb + ch * GR + rr;
        const bool in_a = row < re && k0 + sc < g.k;
        cp_async16(as + rr * GLD + sc, in_a ? g.a + (size_t)row * g.k + k0 + sc : g.a, in_a);
        if (head) {
          const float dv = row < re && sc == 0 ? __ldg(g.d + row) : 0.0f;
          *reinterpret_cast<float4*>(ds + rr * GLD + sc) = make_float4(dv, 0.0f, 0.0f, 0.0f);
        } else {
          const bool in_d = row < re && j0 + sc < g.j;
          cp_async16(ds + rr * GLD + sc, in_d ? g.d + (size_t)row * g.j + j0 + sc : g.d, in_d);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < GSTAGE - 1; ++ch) stage(ch);
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<GSTAGE - 2>();  // chunk ch has landed (this thread's slots)
    __syncthreads();              // ... everyone's, and chunk ch - 1 is done with
    stage(ch + GSTAGE - 1);
    float* as = gsm + (ch % GSTAGE) * 2 * GPLANE;
    float* ds = as + GPLANE;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int o = (sr + v * (GR / 2)) * GLD + sc;
      const float4 a = *reinterpret_cast<const float4*>(as + o);
      const float4 d = *reinterpret_cast<const float4*>(ds + o);
      const float a4[4] = {a.x, a.y, a.z, a.w};
      const float d4[4] = {d.x, d.y, d.z, d.w};
      if (head) {  // no product: sums only, D left as staged
        const float dh = operand<BF16>(ds[(sr + v * (GR / 2)) * GLD]);
#pragma unroll
        for (int e = 0; e < 4; ++e) hsum[e] = fmaf(operand<BF16>(a4[e]), dh, hsum[e]);
      } else if (!BF16) {  // the bf16 form rounds as it packs the fragments
        uint32_t ah[4], al[4], dhi[4], dlw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(a4[e], ah[e], al[e]);
          split_tf32(d4[e], dhi[e], dlw[e]);
        }
        *reinterpret_cast<uint4*>(as + o) = make_uint4(ah[0], ah[1], ah[2], ah[3]);
        *reinterpret_cast<uint4*>(alo + o) = make_uint4(al[0], al[1], al[2], al[3]);
        *reinterpret_cast<uint4*>(ds + o) = make_uint4(dhi[0], dhi[1], dhi[2], dhi[3]);
        *reinterpret_cast<uint4*>(dlo + o) = make_uint4(dlw[0], dlw[1], dlw[2], dlw[3]);
      }
      if (bias) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bsum[e] += d4[e];
      }
    }
    __syncthreads();  // the chunk is split
    if (mma) {
      if constexpr (BF16) {
        warp_mma_bf16<1, 4, GR, 1, GLD, GLD, 1>(as + wk, ds + wj, acc);
      } else {
        warp_mma_3xtf32<1, 4, GR, 1, GLD, GLD, 1, true>(as + wk, alo + wk, ds + wj, dlo + wj,
                                                         acc);
      }
    }
  }

  float* out = gp.part + (size_t)seg * N_PARAM + g.off;
  if (mma) {
    const int lane = t & 31;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int j = j0 + wj + 8 * jn + 2 * (lane & 3);
#pragma unroll
      for (int f = 0; f < 4; f += 2) {
        const int k = k0 + wk + (lane >> 2) + 4 * f;
        if (k < g.k && j < g.j) {
          out[k * g.j + j] = acc[0][jn][f];
          out[k * g.j + j + 1] = acc[0][jn][f + 1];
        }
      }
    }
  }
  if (head || bias) {
    __syncthreads();  // the last chunk's product is done with the lo planes
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[sr * GT + sc + e] = bsum[e];
      red[(GR / 2 + sr) * GT + sc + e] = hsum[e];
    }
    __syncthreads();
    if (t < GT) {
      float b = 0.0f, h = 0.0f;
#pragma unroll
      for (int q = 0; q < GR / 2; ++q) {
        b += red[q * GT + t];
        h += red[(GR / 2 + q) * GT + t];
      }
      if (head && k0 + t < g.k) out[k0 + t] = h;
      if (bias && j0 + t < g.j) out[g.k * g.j + j0 + t] = b;
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

// ===========================================================================
// The bf16 form (precision "default"): bf16_weights_kernel,
// fwd_bwd_bf16_kernel and wgrad_bf16_kernel (see the note at the top).

constexpr int BROWS = 64;      // rows per CTA of fwd_bwd_bf16_kernel
constexpr int WMS = BROWS / 32;  // its 32-row slices
constexpr int BTHREADS = WMS * 256;  // its warps: WMS slices x 8 column eighths
constexpr int BKT = 64;        // weight rows per slot of its ring
constexpr int BNSTAGE = 4;     // slots in its weight ring
constexpr int K0 = 16;         // layer 0's depth: x and W1 padded with zeros
// leading dimension, in bf16, of a shared buffer of width w: the eight 16-byte
// rows of an ldmatrix 8x8 matrix fall on distinct banks
__host__ __device__ constexpr int ldh(int w) { return w + 8; }
constexpr int BSLOT = BKT * ldh(H);  // bf16 of one ring slot
constexpr int BACT = BROWS * ldh(H);  // bf16 of one activation buffer
// a CTA's backward factors of the four masked layers (widths H, H, H, V0)
constexpr int FACT_CTA = BROWS * (3 * H + V0);
// a CTA's column sums over its rows: the biases' gradients (the deltas'
// column sums), the width-1 heads' weight gradients and their biases'
constexpr int CS_B1 = 0, CS_B2 = H, CS_B3 = 2 * H, CS_WM = 3 * H, CS_C1 = 4 * H,
              CS_C2 = CS_C1 + V0, CS_V3 = CS_C2 + V1, CS_BM = CS_V3 + V1, CS_C3 = CS_BM + 1,
              NCS = CS_C3 + 1;
// shared memory of fwd_bwd_bf16_kernel: two activation buffers, t2, x and the
// weight ring (bf16), then the heads' partial dots [2][8][BROWS], the column
// sums [WMS][H] and dpred, dq3 [2][BROWS] (float32)
constexpr size_t BSMEM_BYTES =
    (size_t)(2 * BACT + BROWS * ldh(V1) + BROWS * ldh(K0) + BNSTAGE * BSLOT) * 2 +
    (size_t)(2 * 8 * BROWS + WMS * H + 2 * BROWS) * 4;  // 154,112
static_assert(BSMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory per block");
static_assert(BROWS % 32 == 0 && BTHREADS >= H, "whole 32-row warp slices");
static_assert(MASK_BLOCK * H <= (1u << 17) && (MASK_BLOCK % BROWS) == 0,
              "mask counters below 2^17; whole CTAs per mask block at row_off 0");

constexpr int WTK = 64;    // gradient rows (k) of a tile of wgrad_bf16_kernel
constexpr int WTJ = 128;   // ... and columns (j)
constexpr int WGR = 64;    // data rows per staged chunk
constexpr int WGSTAGE = 3;  // chunks in its ring
constexpr int WLDA = WTK + 8, WLDD = WTJ + 8;  // leading dimensions (bf16) of a chunk of A, D
constexpr int WMT = WTK / 32;  // 16-row mma tiles of a warp: 2 (k) x 4 (j) warps of WTK/2 x 32
constexpr int WSLOT = WGR * (WLDA + WLDD);     // bf16 of one ring slot
constexpr size_t WSMEM_BYTES = (size_t)WGSTAGE * WSLOT * 2;  // 79,872
constexpr int WGROUPS = 2;  // groups of 8 warps of wgrad_bf16_kernel, each over every other k16 step
constexpr int WTHREADS = WGROUPS * 256;
static_assert((WGROUPS - 1) * WTK * WTJ * 4 <= (int)WSMEM_BYTES, "the groups' sums fit the ring");
constexpr int NT16 = 5;    // W1, W2, W3, V1, V2: the tensor-core gradients
// row segments of wgrad_bf16_kernel are multiples of SEG_ALIGN rows: whole
// fwd_bwd CTAs and whole chunks
constexpr int SEG_ALIGN = BROWS > WGR ? BROWS : WGR;
static_assert(SEG_ALIGN % BROWS == 0 && SEG_ALIGN % WGR == 0, "powers of two");

struct Bf16Weights {
  uint16_t* w1;                     // W1 (K0, H), rows D_IN.. zero
  uint16_t *w2, *w3, *v1, *v2;      // (in, out) row-major
  uint16_t *w2t, *w3t, *v1t, *v2t;  // transposed (out, in)
};

struct Scratch16 {
  uint16_t* x16;                          // x [np][K0], columns D_IN.. zero
  uint16_t *h1d, *h2d, *h3d, *t1d;        // masked activations [np][width]
  uint16_t *da1, *da2, *da3, *dq1, *dq2;  // deltas [np][width]
  float* fact;    // [ncta][FACT_CTA], in fragment order
  float* colsum;  // [ncta][NCS]
  float* lossrow; // [n]
};

struct Bf16Bufs {
  Bf16Weights w;
  Scratch16 s;
};

// What a layer's mask needs of the step: the global row of row 0, the keep
// threshold, 1 / (1 - p).
struct MaskArgs {
  int row_off;
  uint32_t thresh;
  float inv_keep;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ uint16_t to_bf16(float x) {
  return (uint16_t)(pack_bf16x2(x, 0.0f) & 0xFFFFu);
}
__device__ __forceinline__ float bf16_val(uint16_t b) { return __uint_as_float((uint32_t)b << 16); }
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// wang_hash(ctr ^ hs) == wang_rest(row_key ^ c) for the counter ctr = base + c
// of column c < W of a row (base = local_row * W, W a power of two, ctr <
// 2^17): the hash's first step (x ^ 61) ^ (x >> 16) distributes over the XOR,
// and ctr >> 16 == base >> 16.
__device__ __forceinline__ uint32_t mask_row_key(uint32_t hs, uint32_t base) {
  return base ^ (base >> 16) ^ hs ^ 61u ^ (hs >> 16);
}
// tanhf of four values, out of line: the forward epilogues are unrolled over
// a thread's fragment, and 150 inlined copies of tanhf made the kernel's
// code too large for the instruction caches (10,720 SASS instructions;
// 9,368 and 5 % faster with one copy of a one-value call), while four
// independent values per call keep the chains of tanhf interleaved.
__device__ __noinline__ float4 tanh4(float4 z) {
  return make_float4(tanhf(z.x), tanhf(z.y), tanhf(z.z), tanhf(z.w));
}
__device__ __forceinline__ uint32_t wang_rest(uint32_t x) {
  x *= 9u;
  x = x ^ (x >> 4);
  x *= 0x27D4EB2Du;
  x = x ^ (x >> 15);
  x *= 2654435761u;
  x = x ^ (x >> 13);
  return x;
}

// The bf16 weight copies from the flat float32 parameters, rounded once per
// step (nearest even): W2, W3, V1, V2 and their transposes (the backward's
// operands), a 32 x 32 tile per CTA through shared memory so that every
// read and write is coalesced, then W1 padded to K0 rows, a 32-column block
// per CTA.
constexpr int CAST_TILES = 2 * (H / 32) * (H / 32) + (H / 32) * (V0 / 32) + (V0 / 32) * (V1 / 32);
constexpr int CAST_BLOCKS = CAST_TILES + H / 32;
__global__ void __launch_bounds__(THREADS) bf16_weights_kernel(const float* __restrict__ p,
                                                               Bf16Weights wb) {
  __shared__ uint16_t tile[32][33];
  int b = blockIdx.x;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if (b >= CAST_TILES) {
    const int c = (b - CAST_TILES) * 32 + tx;
    for (int r = ty; r < K0; r += THREADS / 32) {
      wb.w1[r * H + c] = to_bf16(r < D_IN ? p[OFF_W1 + r * H + c] : 0.0f);
    }
    return;
  }
  const float* src = p + OFF_W2;
  uint16_t *dst = wb.w2, *dst_t = wb.w2t;
  int K = H, N = H;
  if (b >= (H / 32) * (H / 32)) {
    b -= (H / 32) * (H / 32);
    src = p + OFF_W3, dst = wb.w3, dst_t = wb.w3t;
    if (b >= (H / 32) * (H / 32)) {
      b -= (H / 32) * (H / 32);
      src = p + OFF_V1, dst = wb.v1, dst_t = wb.v1t, N = V0;
      if (b >= (H / 32) * (V0 / 32)) {
        b -= (H / 32) * (V0 / 32);
        src = p + OFF_V2, dst = wb.v2, dst_t = wb.v2t, K = V0, N = V1;
      }
    }
  }
  const int k0 = (b / (N / 32)) * 32, n0 = (b % (N / 32)) * 32;
  for (int r = ty; r < 32; r += THREADS / 32) {
    const uint16_t v = to_bf16(src[(k0 + r) * N + n0 + tx]);
    dst[(k0 + r) * N + n0 + tx] = v;
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += THREADS / 32) dst_t[(n0 + r) * K + k0 + tx] = tile[tx][r];
}

// Stage rows [k0, k0 + KS) of W (bf16, row-major (K, N) in device memory) into
// a ring slot (leading dimension ldh(N)) with cp.async, as one committed group.
template <int N, int KS>
__device__ __forceinline__ void stage_w16(const uint16_t* __restrict__ W, int k0,
                                          uint16_t* slot) {
  constexpr int CHUNKS = KS * N / 8;  // 16-byte copies
  for (int e = threadIdx.x; e < CHUNKS; e += BTHREADS) {
    cp_async16(slot + (e / (N / 8)) * ldh(N) + (e % (N / 8)) * 8, W + (size_t)k0 * N + 8 * e);
  }
  cp_async_commit();
}

// Put the first BNSTAGE - 1 slots of W (K, N) in flight, one committed group
// each (empty groups past K); cta_mma16<K, N> expects them.
template <int K, int N>
__device__ __forceinline__ void prefetch_w16(const uint16_t* __restrict__ W, uint16_t* ring) {
  constexpr int KS = K < BKT ? K : BKT, T = K / KS;
#pragma unroll
  for (int s = 0; s < BNSTAGE - 1; ++s) {
    if (s < T) {
      stage_w16<N, KS>(W, s * KS, ring + s * BSLOT);
    } else {
      cp_async_commit();
    }
  }
}

// The CTA's C(BROWS x N) = in(BROWS x K, bf16, leading dimension ldh(K)) @ W
// (bf16 (K, N) in device memory), streamed KS rows at a time through the
// ring, whose first slots prefetch_w16<K, N> has put in flight.  Warp
// (wm, wn) = (warp / 8, warp % 8) owns rows [32 wm, 32 wm + 32) and columns
// [wn N/8, (wn + 1) N/8); fragments come from ldmatrix (.trans for W).  With
// g = lane / 4, q = lane % 4, acc[i][j][e] is C at row 32 wm + 16 i + g +
// 8 (e / 2), column wn N/8 + 8 j + 2 q + e % 2.  Ends with a barrier.
template <int K, int N>
__device__ __forceinline__ void cta_mma16(const uint16_t* in, const uint16_t* __restrict__ W,
                                          uint16_t* ring, float (&acc)[2][N / 64][4]) {
  constexpr int KS = K < BKT ? K : BKT, NT = N / 64, T = K / KS;
  static_assert(K % KS == 0 && KS % 16 == 0 && N % 64 == 0, "bad tiling");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 3, wn = warp & 7;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // lanes 0-15 address rows 0-15 of the first eight columns, lanes 16-31 the
  // same rows eight columns on
  const uint32_t a_addr = smem_u32(in + (wm * 32 + (lane & 15)) * ldh(K) + (lane >> 4) * 8);
  const uint32_t b_off = ((lane & 15) * ldh(N) + wn * (N / 8) + (lane >> 4) * 8) * 2;
  for (int c = 0; c < T; ++c) {
    cp_async_wait<BNSTAGE - 2>();  // slot c has landed (this thread's part)
    __syncthreads();               // ... everyone's, and slot c - 1 is free
    const int next = c + BNSTAGE - 1;
    if (next < T) {
      stage_w16<N, KS>(W, next * KS, ring + (next % BNSTAGE) * BSLOT);
    } else {
      cp_async_commit();
    }
    const uint32_t b_addr = smem_u32(ring + (c % BNSTAGE) * BSLOT) + b_off;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_addr + (i * 16 * ldh(K) + c * KS + kk) * 2);
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, b_addr + kk * ldh(N) * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][0], a[i], b);
      } else {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          // b[0], b[1]: tile 2 jp (k rows 0-7, 8-15); b[2], b[3]: tile 2 jp + 1
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_addr + (kk * ldh(N) + 16 * jp) * 2);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * jp], a[i], b0);
            mma_bf16(acc[i][2 * jp + 1], a[i], b1);
          }
        }
      }
    }
  }
  __syncthreads();
}

// Copy the CTA's bf16 tile [BROWS][ldh(N)] in shared memory to its rows of a
// [rows][N] buffer in device memory, 16 bytes a thread.
template <int N>
__device__ __forceinline__ void copy_tile16(const uint16_t* tile, uint16_t* dst) {
  for (int e = threadIdx.x; e < BROWS * N / 8; e += BTHREADS) {
    const int r = e / (N / 8), c = (e % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * N + c) =
        *reinterpret_cast<const uint4*>(tile + r * ldh(N) + c);
  }
}

// Forward layer of the bf16 form: h = tanh(in @ W + b) and, with DROP, the
// layer's mask (hs: its hashed salts in the mask blocks of global rows below
// split and from split on); the bf16 masked value goes to out (the next
// product's operand) and, with gout, to the CTA's rows of gout (the weight
// gradient's operand).  The
// backward's factor, (1 - h^2) where kept and 0 where dropped, goes to fact
// in fragment order (float4 per thread and (i, j)), or, without DROP, into
// ft.  With head, the dot of the bf16 output with bf16(head) goes to
// hred[wn][row] (one partial per column eighth).  Between the product and
// the epilogue the first tiles of the next layer's weights (next_w, (NK,
// NN)) are requested.  Ends with a barrier, then the copy to gout.
template <int K, int N, bool DROP, int NK, int NN>
__device__ __forceinline__ void fwd_layer16(MaskArgs ma, const uint16_t* in,
                                            const uint16_t* __restrict__ W,
                                            const float* __restrict__ bias, uint16_t* out,
                                            uint16_t* gout, uint16_t* ring, uint32_t hs0,
                                            uint32_t hs1, int split, float* fact,
                                            const float* __restrict__ head, float* hred,
                                            float* ft, int row0,
                                            const uint16_t* __restrict__ next_w) {
  constexpr int NT = N / 64;
  float acc[2][NT][4];
  cta_mma16<K, N>(in, W, ring, acc);
  prefetch_w16<NK, NN>(next_w, ring);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wm = warp >> 3, wn = warp & 7;
  const int g = lane >> 2, col0 = wn * (N / 8) + 2 * (lane & 3);
  uint32_t rk[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int grow = ma.row_off + row0 + wm * 32 + 16 * i + 8 * hh + g;
      rk[i][hh] = mask_row_key(grow < split ? hs0 : hs1, ((uint32_t)grow % MASK_BLOCK) * N);
    }
  float hp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col0 + 8 * j;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    float2 hw = make_float2(0.0f, 0.0f);
    if (head) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(head + c));
      hw = make_float2(operand<true>(w.x), operand<true>(w.y));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float f[4];
      const float4 th = tanh4(make_float4(acc[i][j][0] + b.x, acc[i][j][1] + b.y,
                                          acc[i][j][2] + b.x, acc[i][j][3] + b.y));
      const float tv[4] = {th.x, th.y, th.z, th.w};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 32 + 16 * i + 8 * hh + g;
        float v0 = tv[2 * hh], v1 = tv[2 * hh + 1];
        const float f0 = 1.0f - __fmul_rn(v0, v0), f1 = 1.0f - __fmul_rn(v1, v1);
        if constexpr (DROP) {
          const bool k0 = wang_rest(rk[i][hh] ^ (uint32_t)c) >= ma.thresh;
          const bool k1 = wang_rest(rk[i][hh] ^ (uint32_t)(c + 1)) >= ma.thresh;
          f[2 * hh] = k0 ? f0 : 0.0f;
          f[2 * hh + 1] = k1 ? f1 : 0.0f;
          v0 = k0 ? v0 * ma.inv_keep : 0.0f;
          v1 = k1 ? v1 * ma.inv_keep : 0.0f;
        } else {
          ft[(i * NT + j) * 4 + 2 * hh] = f0;
          ft[(i * NT + j) * 4 + 2 * hh + 1] = f1;
        }
        const uint32_t pk = pack_bf16x2(v0, v1);
        *reinterpret_cast<uint32_t*>(out + r * ldh(N) + c) = pk;
        if (head) hp[i][hh] = fmaf(bf16_hi(pk), hw.y, fmaf(bf16_lo(pk), hw.x, hp[i][hh]));
      }
      if constexpr (DROP) {
        __stcg(reinterpret_cast<float4*>(fact + ((i * NT + j) * BTHREADS + t) * 4),
               make_float4(f[0], f[1], f[2], f[3]));
      }
    }
  }
  if (head) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = hp[i][hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) hred[wn * BROWS + wm * 32 + 16 * i + 8 * hh + g] = v;
      }
  }
  __syncthreads();
  if (gout != nullptr) copy_tile16<N>(out, gout + (size_t)row0 * N);
}

// Sum v over the warp's 32 rows of its fragment (the thread's four rows, then
// the eight g's by shuffles): lanes 0-3 hold the sums.
__device__ __forceinline__ float warp_rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The column sums of the row slices in cred[WMS][H] into colsum (columns
// 0..N-1), in slice order; follows a barrier after cred was written.
template <int N>
__device__ __forceinline__ void put_colsum(const float* cred, float* colsum) {
  if (threadIdx.x < N) {
    float v = cred[threadIdx.x];
#pragma unroll
    for (int m = 1; m < WMS; ++m) v += cred[m * H + threadIdx.x];
    colsum[threadIdx.x] = v;
  }
}

// Backward layer of the bf16 form: d = ((in @ WT, plus bf16(rowadd[row]) *
// bf16(wadd[col]) when given) / (1 - p)) * fact, fact the forward's factor of
// the layer (0 where dropped); bf16 to out and to the CTA's rows of gout, the
// float32 column sums to colsum.  The next layer's first weight tiles
// (next_w, (NK, NN); none for NK = 0) are requested between the product and
// the epilogue.
template <int K, int N, int NK, int NN>
__device__ __forceinline__ void bwd_layer16(MaskArgs ma, const uint16_t* in,
                                            const uint16_t* __restrict__ WT, uint16_t* out,
                                            uint16_t* gout, uint16_t* ring, const float* fact,
                                            const float* rowadd, const float* __restrict__ wadd,
                                            float* cred, float* colsum, int row0,
                                            const uint16_t* __restrict__ next_w) {
  constexpr int NT = N / 64;
  float acc[2][NT][4];
  cta_mma16<K, N>(in, WT, ring, acc);
  if constexpr (NK > 0) prefetch_w16<NK, NN>(next_w, ring);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wm = warp >> 3, wn = warp & 7;
  const int g = lane >> 2, col0 = wn * (N / 8) + 2 * (lane & 3);
  // the thread's factors, all requested before the first is used
  float4 fv[2 * NT];
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) {
    fv[q] = __ldcs(reinterpret_cast<const float4*>(fact + (q * BTHREADS + t) * 4));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col0 + 8 * j;
    float2 w = make_float2(0.0f, 0.0f);
    if (rowadd != nullptr) {
      const float2 wv = __ldg(reinterpret_cast<const float2*>(wadd + c));
      w = make_float2(operand<true>(wv.x), operand<true>(wv.y));
    }
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float f[4] = {fv[i * NT + j].x, fv[i * NT + j].y, fv[i * NT + j].z, fv[i * NT + j].w};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 32 + 16 * i + 8 * hh + g;
        float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        if (rowadd != nullptr) {
          const float ra = operand<true>(rowadd[r]);
          v0 = fmaf(ra, w.x, v0);  // ra w is exact: the sum of two float32 terms
          v1 = fmaf(ra, w.y, v1);
        }
        const float d0 = (v0 * ma.inv_keep) * f[2 * hh], d1 = (v1 * ma.inv_keep) * f[2 * hh + 1];
        *reinterpret_cast<uint32_t*>(out + r * ldh(N) + c) = pack_bf16x2(d0, d1);
        s0 += d0;
        s1 += d1;
      }
    }
    s0 = warp_rows_sum(s0);
    s1 = warp_rows_sum(s1);
    if (g == 0) {
      cred[wm * H + c] = s0;
      cred[wm * H + c + 1] = s1;
    }
  }
  __syncthreads();
  put_colsum<N>(cred, colsum);
  copy_tile16<N>(out, gout + (size_t)row0 * N);
}

// Kernel 1 of the bf16 form: the forward and the input-gradient backward of
// BROWS rows, as fwd_bwd_kernel, with bf16 operands in shared memory and in
// the scratch, one hash per masked element (the backward reads the factors
// the forward stored), the epilogues on the accumulators in registers, and
// the bias gradients and the width-1 heads' weight gradients summed over the
// CTA's rows (colsum).  Rows past n compute zeros from x = 0 and their deltas
// are exactly 0, so the scratch's rows up to the CTA's end are written whole.
__global__ void __launch_bounds__(BTHREADS, 1) fwd_bwd_bf16_kernel(Step st, Bf16Bufs b) {
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* act0 = sm16;                  // [BROWS][ldh(width)]
  uint16_t* act1 = act0 + BACT;           // [BROWS][ldh(width)]
  uint16_t* t2s = act1 + BACT;            // [BROWS][ldh(V1)]
  uint16_t* xs = t2s + BROWS * ldh(V1);   // [BROWS][ldh(K0)]
  uint16_t* ring = xs + BROWS * ldh(K0);  // BNSTAGE x [BKT][ldh(width)]
  float* hred = reinterpret_cast<float*>(ring + BNSTAGE * BSLOT);  // [2][8][BROWS]
  float* cred = hred + 2 * 8 * BROWS;                              // [WMS][H]
  float* rowv = cred + WMS * H;  // [0, BROWS): dpred, [BROWS, 2 BROWS): dq3

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * BROWS;
  const int n = st.n;
  const float* p = st.p;
  const Bf16Weights& w = b.w;
  const Scratch16& s = b.s;
  float* fact = s.fact + (size_t)blockIdx.x * FACT_CTA;
  float* colsum = s.colsum + (size_t)blockIdx.x * NCS;
  prefetch_w16<K0, H>(w.w1, ring);
  for (int e = t; e < BROWS * K0; e += BTHREADS) {
    const int r = e / K0, d = e % K0;
    const uint16_t v = to_bf16(d < D_IN && row0 + r < n ? st.x[(size_t)(row0 + r) * D_IN + d] : 0.0f);
    xs[r * ldh(K0) + d] = v;
    s.x16[(size_t)row0 * K0 + e] = v;
  }

  // the salts of the masked layers (0..2 the trunk, 3 the first variance
  // layer) in the mask blocks of this CTA's rows
  const uint32_t blk = (uint32_t)(row0 + st.row_off) / MASK_BLOCK;
  const uint32_t base = st.seed * 2654435761u + (uint32_t)st.t * 40503u;
  const int split = (int)((blk + 1u) * MASK_BLOCK);
  uint32_t hs[4][2];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    hs[l][0] = hashed_salt(base + blk * 7919u + (uint32_t)l);
    hs[l][1] = hashed_salt(base + (blk + 1u) * 7919u + (uint32_t)l);
  }
  float ft[2 * 1 * 4];  // (1 - t2^2) of the thread's fragment of the V2 layer

  // ---- forward ----
  const MaskArgs ma{st.row_off, st.thresh, st.inv_keep};
  fwd_layer16<K0, H, true, H, H>(ma, xs, w.w1, p + OFF_W1 + D_IN * H, act0, s.h1d, ring,
                                 hs[0][0], hs[0][1], split, fact, nullptr, nullptr, nullptr,
                                 row0, w.w2);
  fwd_layer16<H, H, true, H, H>(ma, act0, w.w2, p + OFF_W2 + H * H, act1, s.h2d, ring, hs[1][0],
                                hs[1][1], split, fact + BROWS * H, nullptr, nullptr, nullptr,
                                row0, w.w3);
  fwd_layer16<H, H, true, H, V0>(ma, act1, w.w3, p + OFF_W3 + H * H, act0, s.h3d, ring,
                                 hs[2][0], hs[2][1], split, fact + 2 * BROWS * H, p + OFF_WM,
                                 hred, nullptr, row0, w.v1);
  fwd_layer16<H, V0, true, V0, V1>(ma, act0, w.v1, p + OFF_V1 + H * V0, act1, s.t1d, ring,
                                   hs[3][0], hs[3][1], split, fact + 3 * BROWS * H, nullptr,
                                   nullptr, nullptr, row0, w.v2);
  fwd_layer16<V0, V1, false, V1, V0>(ma, act1, w.v2, p + OFF_V2 + V0 * V1, t2s, nullptr, ring,
                                     0u, 0u, split, nullptr, p + OFF_V3, hred + 8 * BROWS, ft,
                                     row0, w.v2t);

  // ---- loss and the head's deltas, one thread per row ----
  if (t < BROWS) {
    const int row = row0 + t;
    const bool valid = row < n;
    float pred = 0.0f, q3 = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pred += hred[k * BROWS + t];
      q3 += hred[(8 + k) * BROWS + t];
    }
    pred += __ldg(p + OFF_WM + H);
    q3 += __ldg(p + OFF_V3 + V1);
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
    rowv[BROWS + t] = valid ? dq3 : 0.0f;
    if (valid) s.lossrow[row] = loss;
  }
  __syncthreads();

  // ---- the heads' weight and bias gradients over the CTA's rows ----
  for (int u = t; u < H + V1 + 2; u += BTHREADS) {
    float a = 0.0f;
    if (u < H) {
      for (int r = 0; r < BROWS; ++r) a = fmaf(bf16_val(act0[r * ldh(H) + u]), operand<true>(rowv[r]), a);
      colsum[CS_WM + u] = a;
    } else if (u < H + V1) {
      for (int r = 0; r < BROWS; ++r) {
        a = fmaf(bf16_val(t2s[r * ldh(V1) + u - H]), operand<true>(rowv[BROWS + r]), a);
      }
      colsum[CS_V3 + u - H] = a;
    } else {
      const float* v = rowv + (u - H - V1) * BROWS;
      for (int r = 0; r < BROWS; ++r) a += v[r];
      colsum[u == H + V1 ? CS_BM : CS_C3] = a;
    }
  }

  // ---- backward ----
  // dq2 = (bf16(dq3) bf16(V3)^T) * (1 - t2^2), on the V2 layer's fragment
  {
    const int lane = t & 31, warp = t >> 5, wm = warp >> 3, wn = warp & 7, g = lane >> 2;
    const int c = wn * (V1 / 8) + 2 * (lane & 3);
    const float w0 = operand<true>(__ldg(p + OFF_V3 + c));
    const float w1 = operand<true>(__ldg(p + OFF_V3 + c + 1));
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 32 + 16 * i + 8 * hh + g;
        const float dq = operand<true>(rowv[BROWS + r]);
        const float d0 = (dq * w0) * ft[i * 4 + 2 * hh], d1 = (dq * w1) * ft[i * 4 + 2 * hh + 1];
        *reinterpret_cast<uint32_t*>(act1 + r * ldh(V1) + c) = pack_bf16x2(d0, d1);
        s0 += d0;
        s1 += d1;
      }
    s0 = warp_rows_sum(s0);
    s1 = warp_rows_sum(s1);
    if (g == 0) {
      cred[wm * H + c] = s0;
      cred[wm * H + c + 1] = s1;
    }
  }
  __syncthreads();
  put_colsum<V1>(cred, colsum + CS_C2);
  copy_tile16<V1>(act1, s.dq2 + (size_t)row0 * V1);
  // (cta_mma16's first barrier orders these reads before the next epilogue's writes)
  // dq1 = mask3(dq2 V2^T) * (1 - t1^2)
  bwd_layer16<V1, V0, V0, H>(ma, act1, w.v2t, act0, s.dq1, ring, fact + 3 * BROWS * H, nullptr,
                             nullptr, cred, colsum + CS_C1, row0, w.v1t);
  // da3 = mask2(dpred Wm^T + dq1 V1^T) * (1 - h3^2)
  bwd_layer16<V0, H, H, H>(ma, act0, w.v1t, act1, s.da3, ring, fact + 2 * BROWS * H, rowv,
                           p + OFF_WM, cred, colsum + CS_B3, row0, w.w3t);
  // da2 = mask1(da3 W3^T) * (1 - h2^2)
  bwd_layer16<H, H, H, H>(ma, act1, w.w3t, act0, s.da2, ring, fact + BROWS * H, nullptr, nullptr,
                          cred, colsum + CS_B2, row0, w.w2t);
  // da1 = mask0(da2 W2^T) * (1 - h1^2)
  bwd_layer16<H, H, 0, 0>(ma, act0, w.w2t, act1, s.da1, ring, fact, nullptr, nullptr, cred,
                          colsum + CS_B1, row0, nullptr);
}

// One tensor-core gradient of wgrad_bf16_kernel: G (k, j) = A^T D over the
// rows, A bf16 [np][lda] (its first k columns), D bf16 [np][j].
struct GradTensor16 {
  const uint16_t* a;
  const uint16_t* d;
  int lda, k, j, off;
};

struct GradPass16 {
  GradTensor16 g[NT16];
  int unit0[NT16 + 1];  // first tile of each tensor; unit0[NT16]: the column-sum unit
  float* part;          // [SPLIT][N_PARAM]
  const float* colsum;  // [ncta][NCS]
  int ncta, np, seg_rows;  // seg_rows: a multiple of SEG_ALIGN
};

// Where column sum e of a CTA (CS_*) lies in the flat parameter layout.
__device__ __forceinline__ int colsum_dst(int e) {
  if (e < CS_B2) return OFF_W1 + D_IN * H + e;
  if (e < CS_B3) return OFF_W2 + H * H + (e - CS_B2);
  if (e < CS_WM) return OFF_W3 + H * H + (e - CS_B3);
  if (e < CS_C1) return OFF_WM + (e - CS_WM);
  if (e < CS_C2) return OFF_V1 + H * V0 + (e - CS_C1);
  if (e < CS_V3) return OFF_V2 + V0 * V1 + (e - CS_C2);
  if (e < CS_BM) return OFF_V3 + (e - CS_V3);
  return e == CS_BM ? OFF_WM + H : OFF_V3 + V1;
}

// Kernel 2 of the bf16 form.  A CTA owns a WTK x WTJ tile (k0, j0) of one
// tensor-core gradient and row segment blockIdx.y, and walks the segment's
// rows in order, WGR-row chunks of A and D (bf16, as fwd_bwd_bf16_kernel
// stored them) through a cp.async ring; both operands reach the tensor cores
// through ldmatrix.trans (A as the transposed mma A operand, the rows as the
// mma's k).  Warp w owns rows k0 + 32 (w / 4) and columns j0 + 32 (w % 4) of
// the tile.  The segment's column-sum unit (blockIdx.x == unit0[NT16]) adds
// the column sums of the fwd_bwd CTAs in the segment, in CTA order: the
// biases and the width-1 heads.  No float atomics.
__global__ void __launch_bounds__(WTHREADS, 1) wgrad_bf16_kernel(GradPass16 gp) {
  extern __shared__ __align__(16) uint16_t wsm[];  // WGSTAGE x (A chunk, D chunk)
  const int t = threadIdx.x;
  const int u = blockIdx.x, seg = blockIdx.y;
  const int rb = seg * gp.seg_rows;
  float* out = gp.part + (size_t)seg * N_PARAM;
  if (u == gp.unit0[NT16]) {
    constexpr int PER = (NCS + WTHREADS - 1) / WTHREADS;
    const int c0 = min(gp.ncta, rb / BROWS), c1 = min(gp.ncta, (rb + gp.seg_rows) / BROWS);
    float sum[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) sum[m] = 0.0f;
#pragma unroll 4
    for (int c = c0; c < c1; ++c) {
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int e = t + m * WTHREADS;
        if (e < NCS) sum[m] += gp.colsum[(size_t)c * NCS + e];
      }
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      if (t + m * WTHREADS < NCS) out[colsum_dst(t + m * WTHREADS)] = sum[m];
    }
    return;
  }
  int i = 0;
  while (u >= gp.unit0[i + 1]) ++i;
  const GradTensor16 g = gp.g[i];
  const int jtiles = (g.j + WTJ - 1) / WTJ;
  const int k0 = ((u - gp.unit0[i]) / jtiles) * WTK;
  const int j0 = ((u - gp.unit0[i]) % jtiles) * WTJ;
  const int re = min(gp.np, rb + gp.seg_rows);
  const int chunks = rb < re ? (re - rb) / WGR : 0;
  const int lane = t & 31, warp = (t >> 5) & 7, grp = t >> 8;
  const int wk = (warp >> 2) * (WTK / 2), wj = (warp & 3) * 32;
  // the warp's 16-row mma tiles inside the tensor: the first nm of WMT
  // (warp-uniform)
  const int nm = j0 + wj < g.j ? max(0, min(WMT, (g.k - k0 - wk + 15) / 16)) : 0;

  float acc[WMT][4][4];
#pragma unroll
  for (int a = 0; a < WMT; ++a)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][jn][e] = 0.0f;

  // Stage chunk ch of the segment into its ring slot as one committed group:
  // A's columns k0.. inside its width, D's columns j0.. inside j.  Past the
  // last chunk the group is empty.
  auto stage = [&](int ch) {
    if (ch < chunks) {
      uint16_t* as = wsm + (ch % WGSTAGE) * WSLOT;
      uint16_t* ds = as + WGR * WLDA;
      const size_t r0 = (size_t)rb + (size_t)ch * WGR;
      for (int e = t; e < WGR * (WTK + WTJ) / 8; e += WTHREADS) {
        if (e < WGR * WTK / 8) {
          const int r = e / (WTK / 8), c = (e % (WTK / 8)) * 8;
          if (k0 + c < g.lda) cp_async16(as + r * WLDA + c, g.a + (r0 + r) * g.lda + k0 + c);
        } else {
          const int e2 = e - WGR * WTK / 8, r = e2 / (WTJ / 8), c = (e2 % (WTJ / 8)) * 8;
          if (j0 + c < g.j) cp_async16(ds + r * WLDD + c, g.d + (r0 + r) * g.j + j0 + c);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < WGSTAGE - 1; ++ch) stage(ch);
  // ldmatrix lanes, both .trans: A's 8x8 matrices (k 0-7 | 8-15) x (data rows
  // 0-7 | 8-15) in the order of the mma's A fragment, D's (data rows 0-7 |
  // 8-15) x (j 0-7 | 8-15) in the order of two B fragments
  const int a_r = (lane & 7) + 8 * ((lane >> 4) & 1), a_c = wk + 8 * ((lane >> 3) & 1);
  const int b_r = lane & 15, b_c = wj + 8 * (lane >> 4);
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<WGSTAGE - 2>();  // chunk ch has landed (this thread's part)
    __syncthreads();               // ... everyone's, and chunk ch - 1 is done with
    stage(ch + WGSTAGE - 1);
    if (nm > 0) {
      const uint16_t* as = wsm + (ch % WGSTAGE) * WSLOT;
      const uint16_t* ds = as + WGR * WLDA;
#pragma unroll
      for (int kk = 16 * grp; kk < WGR; kk += 16 * WGROUPS) {
        uint32_t a[WMT][4];
#pragma unroll
        for (int i = 0; i < WMT; ++i) {
          if (i < nm) ldmatrix_x4_trans(a[i], smem_u32(as + (kk + a_r) * WLDA + a_c + 16 * i));
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, smem_u32(ds + (kk + b_r) * WLDD + b_c + 16 * jp));
          const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
#pragma unroll
          for (int i = 0; i < WMT; ++i) {
            if (i < nm) {
              mma_bf16(acc[i][2 * jp], a[i], b0);
              mma_bf16(acc[i][2 * jp + 1], a[i], b1);
            }
          }
        }
      }
    }
  }
  // the groups' sums, added in group order through the ring
  if (WGROUPS > 1) {
    cp_async_wait<0>();
    __syncthreads();  // the last chunk is done with
    float* red = reinterpret_cast<float*>(wsm);
    for (int gr = 1; gr < WGROUPS; ++gr) {
      if (grp == gr && nm > 0) {
#pragma unroll
        for (int a = 0; a < WMT; ++a)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            *reinterpret_cast<float4*>(red + (((gr - 1) * WMT + a) * 4 + jn) * 1024 + (t & 255) * 4) =
                make_float4(acc[a][jn][0], acc[a][jn][1], acc[a][jn][2], acc[a][jn][3]);
      }
    }
    __syncthreads();
    if (grp != 0) return;
    for (int gr = 1; gr < WGROUPS; ++gr) {
      if (nm > 0) {
#pragma unroll
        for (int a = 0; a < WMT; ++a)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const float4 v = *reinterpret_cast<const float4*>(
                red + (((gr - 1) * WMT + a) * 4 + jn) * 1024 + t * 4);
            acc[a][jn][0] += v.x;
            acc[a][jn][1] += v.y;
            acc[a][jn][2] += v.z;
            acc[a][jn][3] += v.w;
          }
      }
    }
  }
  if (nm > 0) {
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int a = 0; a < WMT; ++a)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int k = k0 + wk + 16 * a + gq + 8 * hh, j = j0 + wj + 8 * jn + 2 * q;
          if (k < g.k && j < g.j) {
            *reinterpret_cast<float2*>(out + g.off + k * g.j + j) =
                make_float2(acc[a][jn][2 * hh], acc[a][jn][2 * hh + 1]);
          }
        }
  }
}

struct Workspace {
  float *grad, *part;
  Transposed tr;
  Scratch s;
  Bf16Bufs b;
  size_t scratch16_floats;  // the bf16 form's per-step scratch, x16 .. lossrow
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
  const size_t common = off;
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
  // the bf16 form's buffers share the rest of the workspace with the 3xTF32
  // form's scratch
  const size_t f32_end = off;
  off = common;
  auto take16 = [&](size_t halves) { return reinterpret_cast<uint16_t*>(take((halves + 1) / 2)); };
  const size_t ncta = (nn + BROWS - 1) / BROWS, np = ncta * BROWS;
  Bf16Weights& bw = w->b.w;
  bw.w1 = take16(K0 * H);
  bw.w2 = take16(H * H);
  bw.w3 = take16(H * H);
  bw.v1 = take16(H * V0);
  bw.v2 = take16(V0 * V1);
  bw.w2t = take16(H * H);
  bw.w3t = take16(H * H);
  bw.v1t = take16(V0 * H);
  bw.v2t = take16(V1 * V0);
  Scratch16& bs = w->b.s;
  const size_t scratch16 = off;
  bs.x16 = take16(np * K0);
  bs.h1d = take16(np * H);
  bs.h2d = take16(np * H);
  bs.h3d = take16(np * H);
  bs.t1d = take16(np * V0);
  bs.da1 = take16(np * H);
  bs.da2 = take16(np * H);
  bs.da3 = take16(np * H);
  bs.dq1 = take16(np * V0);
  bs.dq2 = take16(np * V1);
  bs.fact = take(ncta * FACT_CTA);
  bs.colsum = take(ncta * NCS);
  bs.lossrow = take(nn);
  w->scratch16_floats = off - scratch16;
  return off > f32_end ? off : f32_end;
}

// The kernels' arguments for n rows of x and y: the workspace carved, the
// weight-gradient passes of both forms and the step (row_off 0, t 0); returns
// the first error of raising the kernels' shared-memory limits (both forms).
int prepare(const float* x, const float* y, int n, const float* params, float* work,
            uint32_t seed, uint32_t thresh, float inv_keep, float inv_n, Workspace* w,
            GradPass* gp, GradPass16* gb, Step* st) {
  const void* kernels[4] = {(const void*)fwd_bwd_kernel<false>, (const void*)wgrad_kernel<false>,
                            (const void*)fwd_bwd_bf16_kernel, (const void*)wgrad_bf16_kernel};
  const size_t bytes[4] = {SMEM_BYTES, GSMEM_BYTES, BSMEM_BYTES, WSMEM_BYTES};
  for (int f = 0; f < 4; ++f) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[f], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes[f]);
    if (err != cudaSuccess) return (int)err;
  }
  carve(work, n, w);
  const float* a_src[NT] = {x, w->s.h1d, w->s.h2d, w->s.h3d, w->s.h3d, w->s.t1d, w->s.t2};
  const float* d_src[NT] = {w->s.da1, w->s.da2, w->s.da3, w->s.dpred, w->s.dq1, w->s.dq2,
                            w->s.dq3};
  const int ks[NT] = {D_IN, H, H, H, H, V0, V1};
  const int js[NT] = {H, H, H, 1, V0, V1, 1};
  const int offs[NT] = {OFF_W1, OFF_W2, OFF_W3, OFF_WM, OFF_V1, OFF_V2, OFF_V3};
  gp->unit0[0] = 0;
  for (int i = 0; i < NT; ++i) {
    gp->g[i] = GradTensor{a_src[i], d_src[i], ks[i], js[i], offs[i]};
    const int units = ((ks[i] + GT - 1) / GT) * ((js[i] + GT - 1) / GT);
    gp->unit0[i + 1] = gp->unit0[i] + units;
  }
  gp->part = w->part;
  gp->n = n;
  gp->seg_rows = ((n + SPLIT - 1) / SPLIT + GR - 1) / GR * GR;

  const Scratch16& bs = w->b.s;
  const uint16_t* a16[NT16] = {bs.x16, bs.h1d, bs.h2d, bs.h3d, bs.t1d};
  const uint16_t* d16[NT16] = {bs.da1, bs.da2, bs.da3, bs.dq1, bs.dq2};
  const int lda16[NT16] = {K0, H, H, H, V0};
  const int k16[NT16] = {D_IN, H, H, H, V0};
  const int j16[NT16] = {H, H, H, V0, V1};
  const int off16[NT16] = {OFF_W1, OFF_W2, OFF_W3, OFF_V1, OFF_V2};
  gb->unit0[0] = 0;
  for (int i = 0; i < NT16; ++i) {
    gb->g[i] = GradTensor16{a16[i], d16[i], lda16[i], k16[i], j16[i], off16[i]};
    gb->unit0[i + 1] = gb->unit0[i] + ((k16[i] + WTK - 1) / WTK) * ((j16[i] + WTJ - 1) / WTJ);
  }
  gb->part = w->part;
  gb->colsum = bs.colsum;
  gb->ncta = (n + BROWS - 1) / BROWS;
  gb->np = gb->ncta * BROWS;
  gb->seg_rows = ((n + SPLIT - 1) / SPLIT + SEG_ALIGN - 1) / SEG_ALIGN * SEG_ALIGN;

  st->x = x;
  st->y = y;
  st->n = n;
  st->p = params;
  st->w2t = w->tr.w2t;
  st->w3t = w->tr.w3t;
  st->v1t = w->tr.v1t;
  st->v2t = w->tr.v2t;
  st->s = w->s;
  st->seed = seed;
  st->t = 0;
  st->row_off = 0;
  st->thresh = thresh;
  st->inv_keep = inv_keep;
  st->inv_n = inv_n;
  return 0;
}

// Kernels 1 and 2 of a step: in the bf16 form when bf16 is set, the bf16
// weight copies first, else 3xTF32.  Returns the per-row losses they write.
const float* launch_grad_pass(bool bf16, const Step& st, const GradPass& gp,
                              const GradPass16& gb, const Workspace& w, cudaStream_t stream) {
  if (bf16) {
    bf16_weights_kernel<<<CAST_BLOCKS, THREADS, 0, stream>>>(st.p, w.b.w);
    fwd_bwd_bf16_kernel<<<gb.ncta, BTHREADS, BSMEM_BYTES, stream>>>(st, w.b);
    wgrad_bf16_kernel<<<dim3(gb.unit0[NT16] + 1, SPLIT), WTHREADS, WSMEM_BYTES, stream>>>(gb);
    return w.b.s.lossrow;
  }
  const int row_blocks = (st.n + ROWS - 1) / ROWS;
  const dim3 wgrid(gp.unit0[NT], SPLIT);
  fwd_bwd_kernel<false><<<row_blocks, THREADS, SMEM_BYTES, stream>>>(st);
  wgrad_kernel<false><<<wgrid, THREADS, GSMEM_BYTES, stream>>>(gp);
  return w.s.lossrow;
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

// Bytes of the bf16 form's per-step scratch for n rows as carve lays it out:
// the buffers that fwd_bwd_bf16_kernel writes every step.
extern "C" long long pinnfc_train_dnn_bf16_scratch_bytes(int n) {
  Workspace w;
  carve(nullptr, n, &w);
  return (long long)(w.scratch16_floats * sizeof(float));
}

// Run steps t0 .. t0 + n_iter - 1 of a stage on `stream`; returns the first
// CUDA error (0 on success).  A stage may run as several calls (chunks): t0 is
// the index inside the stage of the call's first step, and it alone sets the
// masks' step salt, so a chunk starting at step s draws step s's masks.
// params, m, v: flat buffers of the layout above, updated in place; m and v
// hold the Adam moments carried into the call (zero at the start of a stage).
// work: workspace_floats(n) floats.  ints: 2 n_iter + 1 int32: the step flags
// (zeroed), then the Adam count before each step, ints[n_iter] holding the
// count carried into the call (0 at the start of a stage) and ints[2 n_iter]
// receiving the count after the last step.  losses: (n_iter,), by local step.
// bf16: 1 runs the bf16 form (precision "default"), 0 the 3xTF32 form.
extern "C" int pinnfc_train_dnn(const float* x, const float* y, int n, float* params, float* m,
                                float* v, float* work, int* ints, float* losses, uint32_t seed,
                                int t0, int n_iter, float lr, int lr_step, float lr_gamma,
                                uint32_t thresh, float inv_keep, float inv_n, int skip,
                                int bf16, void* stream_ptr) {
  if (n <= 0 || n_iter <= 0) return 0;
  // wgrad_kernel reads x's rows as float4
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Workspace w;
  GradPass gp;
  GradPass16 gb;
  Step st;
  int status = prepare(x, y, n, params, work, seed, thresh, inv_keep, inv_n, &w, &gp, &gb, &st);
  if (status != 0) return status;
  int* flags = ints;
  int* counts = ints + n_iter;

  // partial tiles never cover the layout's gaps: zero them once
  cudaError_t err = cudaMemsetAsync(w.part, 0, sizeof(float) * (size_t)SPLIT * N_PARAM, stream);
  if (err != cudaSuccess) return (int)err;
  const int pblocks = (N_PARAM + THREADS - 1) / THREADS;
  if (!bf16) transpose_kernel<<<pblocks, THREADS, 0, stream>>>(params, w.tr);
  for (int t = 0; t < n_iter; ++t) {
    st.t = t0 + t;  // the step inside the stage: the mask salt
    const float* lossrow = launch_grad_pass(bf16 != 0, st, gp, gb, w, stream);
    finalize_kernel<<<pblocks + 1, THREADS, 0, stream>>>(w.part, w.grad, lossrow, n, inv_n,
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

// Step t of a stage on one row shard of a data-parallel step, on `stream`:
// the transposed weight copies from params, then kernels 1-3 over the shard's
// n rows, which are global rows row_off .. row_off + n - 1 for the masks.
// grad (the layout above) receives the shard's gradient of the whole mean
// loss, loss[0] the shard's rows' loss sum times inv_n (1 / the rows of all
// shards), flag[0] 1 if either is not finite (else 0).  work:
// workspace_floats(n) floats.  bf16 as in pinnfc_train_dnn.  Returns the
// first CUDA error (0 on success).
extern "C" int pinnfc_train_dnn_grad(const float* x, const float* y, int n, int row_off,
                                     const float* params, float* work, float* grad,
                                     float* loss, int* flag, uint32_t seed, int t,
                                     uint32_t thresh, float inv_keep, float inv_n, int bf16,
                                     void* stream_ptr) {
  if (n <= 0 || row_off < 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Workspace w;
  GradPass gp;
  GradPass16 gb;
  Step st;
  int status = prepare(x, y, n, params, work, seed, thresh, inv_keep, inv_n, &w, &gp, &gb, &st);
  if (status != 0) return status;
  st.t = t;
  st.row_off = row_off;
  cudaError_t err = cudaMemsetAsync(w.part, 0, sizeof(float) * (size_t)SPLIT * N_PARAM, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int pblocks = (N_PARAM + THREADS - 1) / THREADS;
  if (!bf16) transpose_kernel<<<pblocks, THREADS, 0, stream>>>(params, w.tr);
  const float* lossrow = launch_grad_pass(bf16 != 0, st, gp, gb, w, stream);
  finalize_kernel<<<pblocks + 1, THREADS, 0, stream>>>(w.part, grad, lossrow, n, inv_n, loss,
                                                        flag, 0);
  return (int)cudaGetLastError();
}

// The Adam + StepLR update of a data-parallel step on `stream`, from grad
// (the layout above), the gradient summed over the shards.  ints: 3 int32:
// the shards' flags summed (the step is skipped when skip and it is not 0),
// the Adam count before the step, and the count after it (written).  params,
// m, v as in pinnfc_train_dnn; work: a workspace of pinnfc_train_dnn_grad,
// whose transposed weight copies are refreshed.
extern "C" int pinnfc_train_dnn_adam(float* params, float* m, float* v, const float* grad,
                                     float* work, int* ints, float lr, int lr_step,
                                     float lr_gamma, int skip, void* stream_ptr) {
  Workspace w;
  carve(work, 0, &w);
  const int pblocks = (N_PARAM + THREADS - 1) / THREADS;
  adam_kernel<<<pblocks, THREADS, 0, (cudaStream_t)stream_ptr>>>(
      params, m, v, grad, w.tr, ints, ints + 1, 0, lr, lr_step, lr_gamma, skip);
  return (int)cudaGetLastError();
}
