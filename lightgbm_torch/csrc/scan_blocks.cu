// scan_blocks: bundle-native best split per (child, group) over [G, W]
// group planes, for EFB-bundled data.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_scan.py:scan_blocks
// (_scan_blocks_kernel at :372, pallas_call at :543). The TPU kernel takes
// whole-block prefix sums as triangular matmuls on the MXU and recovers each
// feature's window sums with segmented nearest-seed fills (log2(W) lane
// rolls); FixHistogram runs inside it.
//
// Contract (ops/block_scan.py:scan_blocks_plain is the same function in
// plain PyTorch, bit for bit on the CPU):
//   scal  [B, 9] f32: scan_pair's eight scalars and the raw hessian sum
//   gb, hb [B, Gp, Wp] f32 group planes
//   masks [8, Gp, Wp] f32, the BM_* rows (keep_r, keep_f, valid_r, valid_f,
//         window first lane, window last lane, fix lane, penalty)
//   out   [B, 8, Gp] f32: penalized gain, absolute lane, use_forward, left
//         grad, left hess, left count (0 when no lane is chosen), has, 0
//   With do_fix, a fix lane's value becomes x + (total - wsum), wsum the
//   f32 windowed prefix at its window's last lane (total: scal[0] for grad,
//   scal[8] for hess), before any prefix sum reads it.
//
// What bounds it on an H100: latency. At the Expo shape (B = 256 children,
// Gp = 24, Wp = 256) it reads 2 * 256 * 24 * 256 * 4 bytes of planes, about
// 12.6 MB, a few microseconds of the card's bandwidth; each block runs a
// Wp-step dependent chain of f64 adds per prefix sum.
//
// Design. One block per (group, child), one thread per lane. The prefix
// sums are sequential f64 sums in shared memory, one thread per quantity,
// restarted at each window's first lane and rounded to f32 at every lane:
// the order of scan_pair.cu, so a singleton group gives scan_pair's sums bit
// for bit, and no segmented fill is needed. Each thread then evaluates both
// directions at its lane, and block reductions pick the best lane with the
// reference's tie rules (REVERSE: highest lane; forward: lowest; forward
// only on a strictly greater gain). Compiled with -fmad=false, so every
// product and sum rounds as in the plain version.
#include "block_reduce.cuh"

enum {
  BM_KEEP_R = 0, BM_KEEP_F, BM_VALID_R, BM_VALID_F, BM_SEED_S, BM_SEED_E,
  BM_FIX, BM_PEN
};

// In-place windowed prefix of p[0, Wp): a sequential f64 sum restarted at
// the lanes where start[i] is set, rounded to f32 at every lane.
__device__ void windowed_prefix(float* p, const unsigned char* start,
                                int Wp) {
  double acc = 0.0;
  for (int i = 0; i < Wp; ++i) {
    if (start[i]) acc = 0.0;
    acc += (double)p[i];
    p[i] = (float)acc;
  }
}

__global__ void scan_blocks_kernel(const float* __restrict__ scal,
                                   const float* __restrict__ gb,
                                   const float* __restrict__ hb,
                                   const float* __restrict__ masks,
                                   int do_fix, int Gp, int Wp,
                                   float* __restrict__ out) {
  __shared__ float pre[6 * SP_MAX_LANES];
  __shared__ unsigned char start[SP_MAX_LANES];
  __shared__ unsigned char last[SP_MAX_LANES];
  __shared__ int wend[SP_MAX_LANES];
  __shared__ float red[SP_MAX_WARPS];
  __shared__ float at_t[6];

  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const int w = threadIdx.x;
  const int lane = w & 31;
  const int warp = w >> 5;
  const int nwarps = blockDim.x >> 5;
  const float NEG_INF = -INFINITY;

  const float* s = scal + c * 9;
  const float sg = s[0], sh = s[1], nd = s[2], cf = s[3];
  const float min_data = s[4], min_hess = s[5], mgs = s[6], l2 = s[7];
  const float sh_raw = s[8];

  const size_t plane = (size_t)Gp * Wp;
  const size_t m_idx = (size_t)g * Wp + w;
  const size_t b_idx = ((size_t)c * Gp + g) * Wp + w;
  float gv = gb[b_idx];
  float hv = hb[b_idx];
  const float kr = masks[BM_KEEP_R * plane + m_idx];
  const float kf = masks[BM_KEEP_F * plane + m_idx];
  const float vr = masks[BM_VALID_R * plane + m_idx];
  const float vf = masks[BM_VALID_F * plane + m_idx];
  const float fixm = masks[BM_FIX * plane + m_idx];
  const float pen = masks[BM_PEN * plane + m_idx];
  start[w] = masks[BM_SEED_S * plane + m_idx] > 0.f;
  last[w] = masks[BM_SEED_E * plane + m_idx] > 0.f;

  // FixHistogram: each fix lane takes total - window sum
  if (do_fix) {
    pre[w] = gv;
    pre[Wp + w] = hv;
  }
  __syncthreads();
  if (w == Wp - 1) {          // the window's last lane, seen from each lane
    int cur = Wp - 1;
    for (int i = Wp - 1; i >= 0; --i) {
      if (last[i]) cur = i;
      wend[i] = cur;
    }
  }
  if (do_fix && w < 2) windowed_prefix(pre + w * Wp, start, Wp);
  __syncthreads();
  const int e = wend[w];
  if (do_fix && fixm > 0.f) {
    gv = gv + (sg - pre[e]);
    hv = hv + (sh_raw - pre[Wp + e]);
  }
  __syncthreads();

  // six windowed prefix sums: REVERSE-side (g, h, cnt) and forward-side
  const float cnt = floorf(hv * cf + 0.5f);
  pre[0 * Wp + w] = gv * kr;
  pre[1 * Wp + w] = hv * kr;
  pre[2 * Wp + w] = cnt * kr;
  pre[3 * Wp + w] = gv * kf;
  pre[4 * Wp + w] = hv * kf;
  pre[5 * Wp + w] = cnt * kf;
  __syncthreads();
  if (w < 6) windowed_prefix(pre + w * Wp, start, Wp);
  __syncthreads();

  // REVERSE: the right side is the window's total minus the prefix
  const float r_grad = pre[0 * Wp + e] - pre[0 * Wp + w];
  const float r_hess = pre[1 * Wp + e] - pre[1 * Wp + w];
  const float r_cnt = pre[2 * Wp + e] - pre[2 * Wp + w];
  const float l_cnt = nd - r_cnt;
  const float l_grad = sg - r_grad;
  const float l_hess = sh - r_hess;
  bool ok_r = (vr > 0.f) && (r_cnt >= min_data) && (r_hess >= min_hess) &&
              (l_cnt >= min_data) && (l_hess >= min_hess);
  const float gain_r = (l_grad * l_grad) / (l_hess + l2) +
                       (r_grad * r_grad) / (r_hess + l2);
  ok_r = ok_r && (gain_r > mgs);
  const float pg_r = ok_r ? (gain_r - mgs) * pen : NEG_INF;

  // forward: the left side is the prefix
  const float f_l_grad = pre[3 * Wp + w];
  const float f_l_hess = pre[4 * Wp + w];
  const float f_l_cnt = pre[5 * Wp + w];
  const float f_r_cnt = nd - f_l_cnt;
  const float f_r_grad = sg - f_l_grad;
  const float f_r_hess = sh - f_l_hess;
  bool ok_f = (vf > 0.f) && (f_l_cnt >= min_data) && (f_l_hess >= min_hess) &&
              (f_r_cnt >= min_data) && (f_r_hess >= min_hess);
  const float gain_f = (f_l_grad * f_l_grad) / (f_l_hess + l2) +
                       (f_r_grad * f_r_grad) / (f_r_hess + l2);
  ok_f = ok_f && (gain_f > mgs);
  const float pg_f = ok_f ? (gain_f - mgs) * pen : NEG_INF;

  const float big = 1073741824.f;  // 2^30
  const float best_gain_r = block_max(pg_r, red, lane, warp, nwarps);
  const float best_t_r = block_max(
      (ok_r && pg_r == best_gain_r) ? (float)w : -1.f, red, lane, warp,
      nwarps);
  const float best_gain_f = block_max(pg_f, red, lane, warp, nwarps);
  const float best_t_f = block_min(
      (ok_f && pg_f == best_gain_f) ? (float)w : big, red, lane, warp,
      nwarps);

  const bool has_r = best_t_r >= 0.f;
  const bool has_f = best_t_f < big;
  const float bg_r = has_r ? best_gain_r : NEG_INF;
  const float bg_f = has_f ? best_gain_f : NEG_INF;
  const bool use_f = bg_f > bg_r;
  const float group_t = use_f ? best_t_f : best_t_r;
  const bool has_any = has_r || has_f;

  if (w == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) at_t[k] = 0.f;
  }
  __syncthreads();
  if ((float)w == group_t) {
    at_t[0] = f_l_grad; at_t[1] = f_l_hess; at_t[2] = f_l_cnt;
    at_t[3] = l_grad; at_t[4] = l_hess; at_t[5] = l_cnt;
  }
  __syncthreads();
  if (w == 0) {
    float* o = out + (size_t)c * 8 * Gp + g;
    o[0 * Gp] = has_any ? (use_f ? bg_f : bg_r) : NEG_INF;
    o[1 * Gp] = group_t;
    o[2 * Gp] = use_f ? 1.f : 0.f;
    o[3 * Gp] = use_f ? at_t[0] : at_t[3];
    o[4 * Gp] = use_f ? at_t[1] : at_t[4];
    o[5 * Gp] = use_f ? at_t[2] : at_t[5];
    o[6 * Gp] = has_any ? 1.f : 0.f;
    o[7 * Gp] = 0.f;
  }
}

// Launches the scan of B children on `stream`: one block per (group,
// child), Wp threads (a multiple of 32, at most 1024). Returns
// cudaGetLastError() after the launch.
extern "C" int scan_blocks_launch(const void* scal, const void* gb,
                                  const void* hb, const void* masks,
                                  int do_fix, int B, int Gp, int Wp,
                                  void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(Gp, B);
  scan_blocks_kernel<<<grid, Wp, 0, s>>>(
      static_cast<const float*>(scal), static_cast<const float*>(gb),
      static_cast<const float*>(hb), static_cast<const float*>(masks),
      do_fix, Gp, Wp, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
