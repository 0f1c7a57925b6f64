// cat_scan: best categorical split per (node, feature) for B nodes by C
// categorical features.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA ops,
// lightgbm_tpu/ops/split.py:find_best_split_categorical (:572, with
// _cat_onehot_scan :456 and _cat_sorted_scan :480), the reference's
// FindBestThresholdCategoricalInner (src/treelearner/feature_histogram.hpp:
// 263-474). It runs on every scanned node of a Dataset with a categorical
// column, beside scan_pair, which scans the numerical features.
//
// Contract (ops/cat_scan.py: cat_scan_plain is the same function in plain
// PyTorch, bit for bit):
//   scal  [B, 8] f32: sum_grad, sum_hess_adj, num_data, cnt_factor,
//         min_gain_shift, cmin, cmax, 0 (ops/cat_scan.py:cat_scalars)
//   gh, hh [R, TB] f32 grad and hess planes; node b's bin w of feature c is
//         gh[rows[b], start[c] + w] (rows [B] i64)
//   meta  [3, C] i32: each feature's global bin start, num_bin, used_bin
//   pen   [C] f32 feature penalties; fmask [B, C] f32 (1: node scans it)
//   par   [16] f32: l1, l2, max_delta_step, cat_l2, cat_smooth,
//         min_sum_hessian, min_data_in_leaf, min_data_per_group,
//         max_cat_threshold, max_cat_to_onehot, use_mc
//   W     the layout's width (the widest categorical feature, <= 256)
//   out   [B, C, 16] f32: reported gain (-inf: none), left grad, left hess
//         (kEpsilon included), left count, the outputs' l2, 0, 0, 0, then 8
//         uint32 words of left bins stored bit for bit
//
// What bounds it on an H100: latency. Each (node, feature) reads at most
// 2 KB of its planes and writes 64 bytes, so the byte bound at B = 256,
// C = 6 is about 1 us; its operations are a few thousand per pair. The
// time is the launch, a 36-stage bitonic sort with a barrier per stage,
// and the prefix walk, which is sequential by its stop and group state:
// one thread per direction, at most max_cat_threshold (32) steps, each
// with the IEEE divisions of two leaf gains.
//
// Design. One block of 256 threads per (node, feature), one thread per
// bin. The threads gather their bin's (grad, hess) into shared memory and
// recover its count as floor(hess * cnt_factor + 0.5). One-hot features
// (num_bin <= max_cat_to_onehot) evaluate each bin against the rest and
// reduce to the first best bin (warp shuffles, then one warp over the
// eight warp winners). Sorted features sort (ratio order, bin index) keys,
// a float's order as a u32 with -0.0 mapped to +0.0 and NaN last, in a
// bitonic sort in shared memory: distinct keys, so the order is the plain
// version's stable argsort exactly. Then thread 0 walks forward and thread
// 32 backward, in separate warps so the two walks run side by side, each
// stopping once no later step can be in range; they keep the first best
// step as argmax does. The winning side's bins become the mask words by
// one ballot per warp. Built with -fmad=false (ops/build.py), every float
// operation is the plain version's, in its order, so the gains, sums and
// masks are equal bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

#define CS_THREADS 256
#define CS_MAX_W 256
#define CS_WORDS 8
#define CS_COLS 16
#define CS_EPS 1e-15f

enum { CP_L1 = 0, CP_L2, CP_MDS, CP_CAT_L2, CP_CAT_SMOOTH, CP_MIN_HESS,
       CP_MIN_DATA, CP_MIN_GROUP, CP_MAX_CAT, CP_MAX_ONEHOT, CP_USE_MC };
enum { SC_SG = 0, SC_SH, SC_ND, SC_CF, SC_MGS, SC_CMIN, SC_CMAX };

struct WalkBest {
  float gain, lg, lh;
  int lc, i;
};

// a beats b under argmax's first-maximum rule (NaN is the maximum)
static __device__ __forceinline__ bool cs_better(float a, float b) {
  return a > b || (a != a && b == b);
}

// the order of a stable float argsort as a u32: -0.0 is +0.0, NaN last
static __device__ __forceinline__ unsigned cs_sort_bits(float x) {
  if (x != x) return 0xFFFFFFFFu;
  const unsigned b = __float_as_uint(x == 0.f ? 0.f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One direction of the sorted scan (split.py:_cat_sorted_scan's step):
// the prefix of the sorted bins from the front (reverse: from the last
// used bin back, then the unused tail), with the group counter and the
// stop flag. Steps past max_num or after a stop are never in range, so the
// walk ends there; the best step is the first maximum, step 0 when none
// splits.
static __device__ void cs_walk(bool reverse, const float* gs, const float* hs,
                               const int* cs, const unsigned char* vs, int u,
                               int W, int max_num, float sg, float sh, int nd,
                               int min_data, int mdpg, float min_hess,
                               const KnobScalars& k, WalkBest* res) {
  float slg = 0.f, slh = CS_EPS;
  int lcnt = 0, grp = 0;
  bool stopped = false;
  WalkBest best = {-INFINITY, 0.f, 0.f, 0, 0};
  for (int j = 0; j < W; ++j) {
    const int p = !reverse ? j : (j < u ? u - 1 - j : W - 1 - (j - u));
    const bool v = vs[p] != 0;
    slg = slg + (v ? gs[p] : 0.f);
    slh = slh + (v ? hs[p] : 0.f);
    const int cc = v ? cs[p] : 0;
    lcnt += cc;
    grp += cc;
    const bool in_range = v && j < max_num && !stopped;
    const int rc = nd - lcnt;
    const float rh = sh - slh;
    const bool brk = rc < min_data || rc < mdpg || rh < min_hess;
    stopped = stopped || (in_range && brk);
    const bool ok = in_range && !brk && lcnt >= min_data &&
                    slh >= min_hess && grp >= mdpg;
    const float gain =
        ok ? knob_split_gain(slg, slh, sg - slg, sh - slh, k) : -INFINITY;
    if (ok) grp = 0;
    if (j == 0 || cs_better(gain, best.gain)) {
      best.gain = gain;
      best.lg = slg;
      best.lh = slh;
      best.lc = lcnt;
      best.i = j;
    }
    if (j + 1 >= max_num || stopped) break;
  }
  *res = best;
}

__global__ void __launch_bounds__(CS_THREADS)
cat_scan_kernel(const float* __restrict__ scal, const float* __restrict__ gh,
                const float* __restrict__ hh,
                const long long* __restrict__ rows, long long tb,
                const int* __restrict__ meta, const float* __restrict__ pen,
                const float* __restrict__ fmask,
                const float* __restrict__ par, int B, int C, int W,
                float* __restrict__ out, long long* __restrict__ counter) {
  __shared__ float s_g[CS_MAX_W], s_h[CS_MAX_W];
  __shared__ int s_c[CS_MAX_W], s_pos[CS_MAX_W];
  __shared__ unsigned char s_part[CS_MAX_W];
  __shared__ unsigned long long s_key[CS_MAX_W];
  __shared__ float s_gs[CS_MAX_W], s_hs[CS_MAX_W];
  __shared__ int s_cs[CS_MAX_W];
  __shared__ unsigned char s_vs[CS_MAX_W];
  __shared__ float s_rg[CS_THREADS / 32];
  __shared__ int s_ri[CS_THREADS / 32];
  __shared__ WalkBest s_walk[2];
  __shared__ int s_best;
  __shared__ unsigned s_words[CS_WORDS];

  const int b = blockIdx.x / C, c = blockIdx.x % C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (blockIdx.x == 0 && t == 0 && counter != nullptr)
    atomicAdd(reinterpret_cast<unsigned long long*>(counter), 1ULL);

  const float* sc = scal + (long long)b * 8;
  const float sg = sc[SC_SG], sh = sc[SC_SH], cf = sc[SC_CF];
  const float mgs = sc[SC_MGS];
  const int nd = (int)sc[SC_ND];
  const int start = meta[c], nb = meta[C + c], used_bin = meta[2 * C + c];
  const int min_data = (int)par[CP_MIN_DATA];
  const int mdpg = (int)par[CP_MIN_GROUP];
  const int max_cat = (int)par[CP_MAX_CAT];
  const float min_hess = par[CP_MIN_HESS];
  KnobScalars k;
  k.l2 = par[CP_L2];
  k.l1 = par[CP_L1];
  k.mds = par[CP_MDS];
  k.cmin = sc[SC_CMIN];
  k.cmax = sc[SC_CMAX];
  k.use_mc = par[CP_USE_MC] > 0.f;
  k.mono = 0.f;

  // ---- the bins ---------------------------------------------------------
  const bool used = t < W && t < nb && t < used_bin;
  float g = 0.f, h = 0.f;
  if (used) {
    const long long row = rows[b] * tb + start + t;
    g = gh[row];
    h = hh[row];
  }
  const int cnt = (int)floorf(h * cf + 0.5f);
  s_g[t] = g;
  s_h[t] = h;
  s_c[t] = cnt;

  const bool onehot = nb <= (int)par[CP_MAX_ONEHOT];
  float gain;
  float lg = 0.f, lh = 0.f, l2_out;
  int lc = 0;
  bool left;
  if (onehot) {
    // ---- each used bin alone against the rest -------------------------
    const float hess_adj = h + CS_EPS;
    const float oh = (sh - h) - CS_EPS;
    const int oc = nd - cnt;
    const bool ok = used && cnt >= min_data && h >= min_hess &&
                    oc >= min_data && oh >= min_hess;
    float bg = ok ? knob_split_gain(sg - g, oh, g, hess_adj, k) : -INFINITY;
    int bi = t;
    for (int d = 16; d > 0; d >>= 1) {
      const float og = __shfl_down_sync(0xFFFFFFFFu, bg, d);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, bi, d);
      if (cs_better(og, bg) || (!cs_better(bg, og) && oi < bi)) {
        bg = og;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_rg[warp] = bg;
      s_ri[warp] = bi;
    }
    __syncthreads();
    if (t == 0) {
      float best = s_rg[0];
      int bw = s_ri[0];
      for (int i = 1; i < CS_THREADS / 32; ++i)
        if (cs_better(s_rg[i], best)) {
          best = s_rg[i];
          bw = s_ri[i];
        }
      s_best = bw;
      s_rg[0] = best;
    }
    __syncthreads();
    const int tb_ = s_best;
    gain = s_rg[0];
    lg = s_g[tb_];
    lh = s_h[tb_] + CS_EPS;
    lc = s_c[tb_];
    l2_out = k.l2;
    left = t == tb_;
  } else {
    // ---- sorted many-vs-many -------------------------------------------
    KnobScalars kc = k;
    kc.l2 = k.l2 + par[CP_CAT_L2];
    const float smooth = par[CP_CAT_SMOOTH];
    const bool part = used && (float)cnt >= smooth;
    s_part[t] = part ? 1 : 0;
    const float ratio = part ? g / (h + smooth) : INFINITY;
    const unsigned hi = t < W ? cs_sort_bits(ratio) : 0xFFFFFFFFu;
    s_key[t] = ((unsigned long long)hi << 32) | (unsigned)t;
    const int u = __syncthreads_count(part);
    for (int k2 = 2; k2 <= CS_THREADS; k2 <<= 1) {
      for (int j = k2 >> 1; j > 0; j >>= 1) {
        const int ixj = t ^ j;
        if (ixj > t) {
          const unsigned long long a = s_key[t], bk = s_key[ixj];
          if ((a > bk) == ((t & k2) == 0)) {
            s_key[t] = bk;
            s_key[ixj] = a;
          }
        }
        __syncthreads();
      }
    }
    const int idx = (int)(s_key[t] & 0xFFFFu);
    s_pos[idx] = t;
    s_gs[t] = s_g[idx];
    s_hs[t] = s_h[idx];
    s_cs[t] = s_c[idx];
    s_vs[t] = s_part[idx];
    __syncthreads();
    const int max_num = min(max_cat, (u + 1) / 2);
    if (t == 0 || t == 32)
      cs_walk(t == 32, s_gs, s_hs, s_cs, s_vs, u, W, max_num, sg, sh, nd,
              min_data, mdpg, min_hess, kc, &s_walk[t == 32]);
    __syncthreads();
    const WalkBest f = s_walk[0], r = s_walk[1];
    const bool use_r = r.gain > f.gain;
    const WalkBest w = use_r ? r : f;
    gain = w.gain;
    lg = w.lg;
    lh = w.lh;
    lc = w.lc;
    l2_out = kc.l2;
    const int pos = s_pos[t];
    left = part && (use_r ? pos >= u - 1 - w.i : pos <= w.i);
  }

  // ---- the record -------------------------------------------------------
  const unsigned word = __ballot_sync(0xFFFFFFFFu, left);
  if (lane == 0) s_words[warp] = word;
  __syncthreads();
  float* o = out + ((long long)b * C + c) * CS_COLS;
  if (t < CS_WORDS) o[8 + t] = __uint_as_float(s_words[t]);
  if (t == 0) {
    const bool ok = gain > mgs && fmask[(long long)b * C + c] > 0.f;
    o[0] = ok ? (gain - mgs) * pen[c] : -INFINITY;
    o[1] = lg;
    o[2] = lh;
    o[3] = (float)lc;
    o[4] = l2_out;
    o[5] = 0.f;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

// Queues the scan of B nodes by C categorical features on `stream`;
// returns the CUDA error of the launch, 0 on success.
extern "C" int cat_scan_launch(const void* scal, const void* gh,
                               const void* hh, const void* rows, long long tb,
                               const void* meta, const void* pen,
                               const void* fmask, const void* par, int B,
                               int C, int W, void* out, void* counter,
                               void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (W < 1 || W > CS_MAX_W) return (int)cudaErrorInvalidValue;
  cat_scan_kernel<<<B * C, CS_THREADS, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scal), static_cast<const float*>(gh),
      static_cast<const float*>(hh), static_cast<const long long*>(rows), tb,
      static_cast<const int*>(meta), static_cast<const float*>(pen),
      static_cast<const float*>(fmask), static_cast<const float*>(par), B, C,
      W, static_cast<float*>(out), static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}
