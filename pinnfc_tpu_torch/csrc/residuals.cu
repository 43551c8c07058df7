// Fused physics-residual kernel for the exporter's residual bundle.
//
// Replaces the TPU kernel pinnfc_tpu/ops/pallas_residuals.py::fused_residuals_pallas
// (body _residual_kernel): row-wise de-normalisation of the 8 inputs, then the
// voltage (Nernst + activation + ohmic + concentration), thermal-simple, and
// H2/O2 excess-ratio models, emitting the 8 exporter channels
//   f_v, f_t, f_h, f_o, v_phys_stack, t_phys, ratio_h, ratio_o.
//
// What bounds it on the H100: the launch and one row's latency, not bytes.
// Each row reads 36 bytes (8 inputs + the DNN output) and writes 32; at the
// 15,600-row campaign that is about 1.06 MB, a third of a microsecond at
// 3.35 TB/s, less than a launch.  Each row is one dependent chain (a powf,
// two expf, three logf, a sqrtf, about 14 IEEE divisions), and the kernel
// takes nearly as long on 37 rows as on 15,600 (chip_smoke.py phase 5): one
// warp's chain of loads, arithmetic and stores, not the grid, sets its time.
// Design:
// - one thread per row in 32-row CTAs (ROWS_PER_CTA): 488 CTAs at
//   N = 15,600, one wave over all 132 SMs; the fastest of the sizes timed
//   once on an H100 (32 to 256 rows per CTA), by a few percent;
// - each row's 8 inputs come in two 16-byte loads (the wrapper checks the
//   16-byte alignment of x);
// - the 17 lambdas and both scalers' constants are read in place from the
//   tensors that hold them (one struct of pointers passed by value), so the
//   wrapper issues no device work besides the output and the launch;
// - the outputs are written channel-major, (8, N): each channel a contiguous
//   column, each warp's store one 128-byte line per channel.
//
// Numerics follow the JAX function: float32 throughout, IEEE division by the
// scaler's scale, powf/expf/logf/sqrtf without fast math, and the file is
// compiled with -fmad=false so no multiply-add is contracted.  Rows where
// i > i_l give NaN in f_v and v_phys_stack exactly where the plain version does.
// Every clamp is nan_max/nan_min, which return NaN when either operand is NaN as
// jnp.maximum, jnp.clip and torch.clamp_min do: fmaxf/fminf return the other
// operand, which turned a NaN stack current into finite gas ratios of flow/1e-8.
// The square root of the O2 partial pressure keeps pow's +inf at -inf, as the JAX
// function's pp_o2**0.5 does.  So rows with NaN or +-inf inputs give the plain
// version's NaN sets.

#include <cuda_runtime.h>
#include <math.h>

// Where the kernel reads its scalars: each pointer is a contiguous float32
// tensor on the card, of the size in the comment.
struct ResidualScalars {
  const float* lam_v;     // (4,)
  const float* lam_t;     // (5,)
  const float* lam_h;     // (4,)
  const float* lam_o;     // (4,)
  const float* sx_scale;  // (8,) scaler_x.scale
  const float* sx_min;    // (8,) scaler_x.min
  const float* sy_scale;  // (1,) scaler_y.scale
  const float* sy_min;    // (1,) scaler_y.min
};

namespace {

constexpr float A_CELL = 270.0f;
constexpr float N_CELLS = 5.0f;
constexpr float KELVIN = 273.15f;
constexpr float R_GAS = 8.314f;
constexpr float ALPHA = 0.5f;
constexpr float TWO_F = 192970.0f;        // 2 * F
constexpr float FOUR_F = 385940.0f;       // 4 * F
constexpr float ALPHA_F_2 = 96485.0f;     // 2 * alpha * F
constexpr float E0 = (float)(220170.0 / 192970.0);  // -GF_LIQ / (2 F)
constexpr float V_MOLAR_STP = 22.4f;
constexpr float O2_FRACTION = 0.21f;
constexpr float I_NORM_BASE = 100.0f;

constexpr int ROWS_PER_CTA = 32;  // one thread per row

// max/min that propagate NaN from either operand (fmaxf/fminf drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__global__ void residuals_kernel(const float4* __restrict__ x,  // (n, 8) as (n, 2) float4
                                 const float* __restrict__ u,   // n values, stride u_stride
                                 long long u_stride, ResidualScalars s, float p_h2o,
                                 float* __restrict__ out,       // (8, n)
                                 int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  const float4 x03 = __ldg(x + 2 * (long long)r);
  const float4 x47 = __ldg(x + 2 * (long long)r + 1);
  const float xn[8] = {x03.x, x03.y, x03.z, x03.w, x47.x, x47.y, x47.z, x47.w};
  float real[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) real[k] = (xn[k] - __ldg(s.sx_min + k)) / __ldg(s.sx_scale + k);
  const float i_raw = real[0], m_cool = real[1], t_in = real[2], p_h2_k = real[3];
  const float p_air_k = real[4], t_out = real[5], h2_flow = real[6], air_flow = real[7];

  const float lam_v0 = __ldg(s.lam_v + 0), lam_v1 = __ldg(s.lam_v + 1);
  const float lam_v2 = __ldg(s.lam_v + 2);
  const float lt0 = __ldg(s.lam_t + 0), lt2 = __ldg(s.lam_t + 2), lt4 = __ldg(s.lam_t + 4);
  const float lh0 = __ldg(s.lam_h + 0), lh1 = __ldg(s.lam_h + 1), lh2 = __ldg(s.lam_h + 2);
  const float lo0 = __ldg(s.lam_o + 0), lo1 = __ldg(s.lam_o + 1), lo2 = __ldg(s.lam_o + 2);
  const float scale_y = __ldg(s.sy_scale), min_y = __ldg(s.sy_min);

  // ---- voltage (net_f_V) ----
  const float i = i_raw / A_CELL + 1e-5f;
  const float v_out = ((__ldg(u + r * u_stride) - min_y) / scale_y) / N_CELLS;
  const float p_h2 = p_h2_k / 101.0f + 1.0f;
  const float p_air = p_air_k / 101.0f + 1.0f;
  const float tk = t_out + KELVIN;
  const float tk_pow = powf(tk, 1.334f);
  const float pp_h2 = 0.5f * (p_h2 / expf(1.653f * i / tk_pow) - p_h2o);
  const float pp_o2 = p_air / expf(4.192f * i / tk_pow) - p_h2o;
  const float b = R_GAS * tk / ALPHA_F_2;
  const float v_act = -b * logf(i / lam_v1);
  const float v_ohmic = -(i * lam_v0);
  const float v_conc = ALPHA * b * logf(1.0f - (i / lam_v2));
  // pp_o2**0.5 is pow(pp_o2, 0.5) in the JAX function: +inf at -inf, where sqrtf is NaN
  const float e_nernst =
      E0 - ((R_GAS * tk) * logf(p_h2o / (pp_h2 * sqrtf(pp_o2 == -INFINITY ? INFINITY : pp_o2)))) /
               TWO_F;
  const float v_est = e_nernst + v_act + v_ohmic + v_conc;

  // ---- thermal simple (net_f_T_simple) ----
  const float i_t_total = (i_raw / A_CELL + 1e-6f) * A_CELL;
  const float t_pred = lt0 * i_t_total + lt2 * (m_cool + 1e-6f) + 0.5f * t_in + lt4;

  // ---- hydrogen (net_f_H) ----
  const float i_total = i * A_CELL;
  const float q_theo_h = nan_max(i_total / TWO_F * N_CELLS * V_MOLAR_STP * 60.0f, 1e-8f);
  const float tgt_h = i_total <= lh2 ? lh0 + lh1 * (i_total / I_NORM_BASE)
                                     : lh0 + lh1 * (lh2 / I_NORM_BASE);
  const float ratio_h = (h2_flow + 1e-6f) / q_theo_h;

  // ---- oxygen (net_f_O) ----
  const float q_theo_o = nan_max((i_total * N_CELLS) / FOUR_F * V_MOLAR_STP * 60.0f, 1e-8f);
  const float thr_o = fabsf(lo2);
  float tgt_o = i_total <= thr_o ? lo0 + lo1 * (i_total / I_NORM_BASE)
                                 : lo0 + lo1 * (thr_o / I_NORM_BASE);
  tgt_o = nan_min(nan_max(tgt_o, 1.05f), 15.0f);
  const float ratio_o = (air_flow + 1e-6f) * O2_FRACTION / q_theo_o;

  out[0 * n + r] = v_est - v_out;
  out[1 * n + r] = t_out - t_pred;
  out[2 * n + r] = ratio_h - tgt_h;
  out[3 * n + r] = ratio_o - tgt_o + nan_max(1.0f - ratio_o, 0.0f) * 10.0f;
  out[4 * n + r] = v_est * N_CELLS;
  out[5 * n + r] = t_pred;
  out[6 * n + r] = ratio_h;
  out[7 * n + r] = ratio_o;
}

// Nothing but the launch: the floor under residuals_kernel's time at the same grid.
__global__ void residuals_floor_kernel() {}

int grid_for(int n) { return (n + ROWS_PER_CTA - 1) / ROWS_PER_CTA; }

}  // namespace

// Launch on `stream`; x must be 16-byte aligned.  Returns cudaGetLastError()
// (0 on success).
extern "C" int pinnfc_residuals(const float* x, const float* u, long long u_stride,
                                ResidualScalars scalars, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  // saturation pressure at Tc = 55 C, in double then rounded, as the JAX
  // function's Python constant is
  const double tc = 55.0;
  const double e = -2.1794 + 0.02953 * tc - 9.1837e-5 * tc * tc + 1.4454e-7 * tc * tc * tc;
  const float p_h2o = (float)pow(10.0, e);
  residuals_kernel<<<grid_for(n), ROWS_PER_CTA, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), u, u_stride, scalars, p_h2o, out, n);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid pinnfc_residuals launches for n rows: the launch
// floor that a timing of the residual kernel is read against.
extern "C" int pinnfc_residuals_floor(int n, void* stream) {
  if (n <= 0) return 0;
  residuals_floor_kernel<<<grid_for(n), ROWS_PER_CTA, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
