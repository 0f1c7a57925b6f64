// scan_pair: best split per feature for a batch of B children.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_scan.py:scan_pair
// (_scan_kernel), the fused form of the reference's
// FeatureHistogram::FindBestThresholdSequentially
// (src/treelearner/feature_histogram.hpp:770-948) on the fast path: f32,
// L2 only, no monotone constraints, no max_delta_step.
//
// Contract (the port's ops/scan.py:scan_pair_plain is the same function in
// plain PyTorch):
//   scal  [B, 8] f32: sum_grad, sum_hess (+2e-15, added by the caller),
//         num_data, cnt_factor, min_data, min_hess, min_gain_shift, l2
//   gb, hb [B, Fp, Wp] f32 per-feature bin grad/hess
//   keep_r, keep_f [Fp, Wp] f32 prefix-sum masks per scan direction
//   valid_r, valid_f [Fp, Wp] (shared) or [B, Fp, Wp] f32 threshold masks
//   aux   [8, Fp] f32, row 0 the feature penalty
//   out   [B, 8, Fp] f32: gain, threshold, use_forward, left grad, left
//         hess, left count, has_split, 0
//
// What bounds it on an H100: latency. At the main path's shape (B = 2,
// Fp = 32, Wp = 256) it reads 2*2*32*256*4 + 4*32*256*4 bytes, about
// 0.2 MB, and does a few thousand operations per feature: far below a
// microsecond of the card's bandwidth or arithmetic. Its 64 blocks fill
// half the SMs once, so its time is the launch and the dependent chain of
// the Wp-step prefix sums and the block reductions.
//
// Design. One block per (feature, child), one thread per bin lane. The
// TPU's triangular-matmul prefix sums of the six masked quantities become
// six sequential f64 running sums in shared memory, one thread each,
// rounded to f32 at every lane: the plain version's cumsum in f64, bit for
// bit, so the card and the CPU pick the same splits. Each thread then
// evaluates both directions' gain and validity at its lane, and block
// reductions pick the best threshold with the reference's tie rules:
// REVERSE keeps the highest threshold among equal gains, forward the
// lowest, and forward wins only on a strictly greater gain. The arithmetic
// is compiled with -fmad=false so every product and sum rounds as in the
// plain version. Against the TPU kernel's f32 matmul prefix sums, gains
// agree to f32 rounding.
#include "block_reduce.cuh"

__global__ void scan_pair_kernel(const float* __restrict__ scal,
                                 const float* __restrict__ gb,
                                 const float* __restrict__ hb,
                                 const float* __restrict__ keep_r,
                                 const float* __restrict__ keep_f,
                                 const float* __restrict__ valid_r,
                                 const float* __restrict__ valid_f,
                                 int valid_batched,
                                 const float* __restrict__ aux, int Fp,
                                 int Wp, float* __restrict__ out) {
  __shared__ float pre[6 * SP_MAX_LANES];
  __shared__ float red[SP_MAX_WARPS];
  __shared__ float at_t[6];

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int w = threadIdx.x;
  const int lane = w & 31;
  const int warp = w >> 5;
  const int nwarps = blockDim.x >> 5;
  const float NEG_INF = -INFINITY;

  const float* s = scal + c * 8;
  const float sg = s[0], sh = s[1], nd = s[2], cf = s[3];
  const float min_data = s[4], min_hess = s[5], mgs = s[6], l2 = s[7];

  const size_t m_idx = (size_t)f * Wp + w;
  const size_t b_idx = ((size_t)c * Fp + f) * Wp + w;
  const size_t v_idx = valid_batched ? b_idx : m_idx;
  const float g = gb[b_idx];
  const float h = hb[b_idx];
  const float kr = keep_r[m_idx];
  const float kf = keep_f[m_idx];
  const float cnt = floorf(h * cf + 0.5f);

  // six masked inclusive prefix sums, r-direction (g, h, cnt) and
  // f-direction: each a sequential f64 sum over the lanes, rounded to f32
  // at every lane (one thread per quantity)
  pre[0 * Wp + w] = g * kr;
  pre[1 * Wp + w] = h * kr;
  pre[2 * Wp + w] = cnt * kr;
  pre[3 * Wp + w] = g * kf;
  pre[4 * Wp + w] = h * kf;
  pre[5 * Wp + w] = cnt * kf;
  __syncthreads();
  if (w < 6) {
    float* p = pre + w * Wp;
    double acc = 0.0;
    for (int i = 0; i < Wp; ++i) {
      acc += (double)p[i];
      p[i] = (float)acc;
    }
  }
  __syncthreads();
  const float gr_c = pre[0 * Wp + w], hr_c = pre[1 * Wp + w];
  const float cr_c = pre[2 * Wp + w], gl_c = pre[3 * Wp + w];
  const float hl_c = pre[4 * Wp + w], cl_c = pre[5 * Wp + w];
  const float gr_tot = pre[1 * Wp - 1], hr_tot = pre[2 * Wp - 1];
  const float cr_tot = pre[3 * Wp - 1];

  // REVERSE: the right side accumulates from the high bins
  const float r_grad = gr_tot - gr_c;
  const float r_hess = hr_tot - hr_c;
  const float r_cnt = cr_tot - cr_c;
  const float l_cnt = nd - r_cnt;
  const float l_grad = sg - r_grad;
  const float l_hess = sh - r_hess;
  bool ok_r = (valid_r[v_idx] > 0.f) && (r_cnt >= min_data) &&
              (r_hess >= min_hess) && (l_cnt >= min_data) &&
              (l_hess >= min_hess);
  float gain_r = (l_grad * l_grad) / (l_hess + l2) +
                 (r_grad * r_grad) / (r_hess + l2);
  ok_r = ok_r && (gain_r > mgs);
  gain_r = ok_r ? gain_r : NEG_INF;

  // forward: the left side accumulates from the low bins
  const float f_r_cnt = nd - cl_c;
  const float f_r_grad = sg - gl_c;
  const float f_r_hess = sh - hl_c;
  bool ok_f = (valid_f[v_idx] > 0.f) && (cl_c >= min_data) &&
              (hl_c >= min_hess) && (f_r_cnt >= min_data) &&
              (f_r_hess >= min_hess);
  float gain_f = (gl_c * gl_c) / (hl_c + l2) +
                 (f_r_grad * f_r_grad) / (f_r_hess + l2);
  ok_f = ok_f && (gain_f > mgs);
  gain_f = ok_f ? gain_f : NEG_INF;

  const float big = 1073741824.f;  // 2^30
  const float best_gain_r = block_max(gain_r, red, lane, warp, nwarps);
  const float best_t_r = block_max(
      (ok_r && gain_r == best_gain_r) ? (float)w : -1.f, red, lane, warp,
      nwarps);
  const float best_gain_f = block_max(gain_f, red, lane, warp, nwarps);
  const float best_t_f = block_min(
      (ok_f && gain_f == best_gain_f) ? (float)w : big, red, lane, warp,
      nwarps);

  const bool has_r = best_t_r >= 0.f;
  const bool has_f = best_t_f < big;
  const float bg_r = has_r ? best_gain_r : NEG_INF;
  const float bg_f = has_f ? best_gain_f : NEG_INF;
  const bool use_f = bg_f > bg_r;
  const float feat_gain = use_f ? bg_f : bg_r;
  const float feat_t = use_f ? best_t_f : best_t_r;
  const bool has_any = has_r || has_f;

  // prefix sums at the chosen threshold (zero when no lane is chosen)
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) at_t[k] = 0.f;
  }
  __syncthreads();
  if ((float)w == feat_t) {
    at_t[0] = gl_c; at_t[1] = hl_c; at_t[2] = cl_c;
    at_t[3] = gr_c; at_t[4] = hr_c; at_t[5] = cr_c;
  }
  __syncthreads();
  if (w == 0) {
    const float lg = use_f ? at_t[0] : sg - (gr_tot - at_t[3]);
    const float lh = use_f ? at_t[1] : sh - (hr_tot - at_t[4]);
    const float lc = use_f ? at_t[2] : nd - (cr_tot - at_t[5]);
    const float pen = aux[f];
    float* o = out + (size_t)c * 8 * Fp + f;
    o[0 * Fp] = has_any ? (feat_gain - mgs) * pen : NEG_INF;
    o[1 * Fp] = feat_t;
    o[2 * Fp] = use_f ? 1.f : 0.f;
    o[3 * Fp] = lg;
    o[4 * Fp] = lh;
    o[5 * Fp] = lc;
    o[6 * Fp] = has_any ? 1.f : 0.f;
    o[7 * Fp] = 0.f;
  }
}

// Launches the scan of B children on `stream`; one block per (feature,
// child), Wp threads (a multiple of 32, at most 1024). Returns
// cudaGetLastError() after the launch.
extern "C" int scan_pair_launch(const void* scal, const void* gb,
                                const void* hb, const void* keep_r,
                                const void* keep_f, const void* valid_r,
                                const void* valid_f, int valid_batched,
                                const void* aux, int B, int Fp, int Wp,
                                void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(Fp, B);
  scan_pair_kernel<<<grid, Wp, 0, s>>>(
      static_cast<const float*>(scal), static_cast<const float*>(gb),
      static_cast<const float*>(hb), static_cast<const float*>(keep_r),
      static_cast<const float*>(keep_f), static_cast<const float*>(valid_r),
      static_cast<const float*>(valid_f), valid_batched,
      static_cast<const float*>(aux), Fp, Wp, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
