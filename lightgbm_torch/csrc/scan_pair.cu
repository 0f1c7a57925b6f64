// scan_pair: best split per feature for a batch of B children.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_scan.py:scan_pair (:262,
// kernel _scan_kernel at :128), the fused form of the reference's
// FeatureHistogram::FindBestThresholdSequentially
// (src/treelearner/feature_histogram.hpp:770-948) in f32, in two
// compile-time instantiations of one kernel, as the reference's
// USE_L1/USE_MAX_OUTPUT/USE_MC/USE_RAND template arms are:
//   KNOBS = false, the fast form (the Pallas kernel's): L2 only;
//   KNOBS = true, the knob form (the JAX package's general scan,
//     lightgbm_tpu/ops/split.py:find_best_split_numerical:241, for the same
//     f32 sums): lambda_l1, max_delta_step and monotone constraints in the
//     gains (scan_common.cuh: knob_split_gain), extra_trees (one drawn
//     threshold per child and feature) and feature_fraction_bynode (a
//     feature mask per child).
//
// Contract (ops/scan.py: scan_pair_plain on the gathered planes is the same
// function in plain PyTorch, bit for bit):
//   scal  [B, 8] f32: sum_grad, sum_hess (+2e-15, added by the caller),
//         num_data, cnt_factor, min_data, min_hess, min_gain_shift, l2;
//         the knob form [B, 16]: then l1, max_delta_step, cmin, cmax,
//         use_mc (ops/scan.py:knob_scalars)
//   gh, hh [R, TBp] f32 histogram planes; child c's bin lane w of feature
//         f is gh[rows[c], gidx[f, w]] (rows [B] i64, gidx [Fp, Wp] i64).
//         rows == NULL reads row c, gidx == NULL reads f * Wp + w: the
//         gathered form, [B, Fp, Wp] planes with TBp = Fp * Wp.
//   keep_r, keep_f [Fp, Wp] f32 prefix-sum masks per scan direction
//   valid_r, valid_f [Fp, Wp] (shared) or [B, Fp, Wp] f32 threshold masks
//   aux   [8, Fp] f32, row 0 the feature penalty; the knob form: row 1 the
//         monotone sign
//   node  the knob form only, [B, 2, Fp] f32: row 0 the extra_trees lane
//         (-1: any lane), row 1 the by-node feature mask (0 or 1)
//   out   [B, 8, Fp] f32: gain, threshold, use_forward, left grad, left
//         hess, left count, has_split, 0
//
// What bounds it on an H100: latency. At the per-split shape (B = 2,
// Fp = 32, Wp = 256) it reads about 0.2 MB (the byte bound is under 0.1 us)
// and does a few thousand operations per feature. Its time is the launch
// plus the longest dependent chain: Wp steps of an f64 add in each of the
// six masked prefix sums, which must run in lane order to keep the plain
// version's bits, then the IEEE divisions of the gains. At B = 256 the
// 8192 (feature, child) pairs run side by side, as many at once as their
// 12 KB of shared memory each lets an SM hold.
//
// Design. One warp per (feature, child) when the batch fills the card
// (B = 256: 8192 warps, 8 per block, no block barrier); at a small batch
// (B = 2: 64 pairs) K = 8 warps share each pair, one pair per block, so
// the staging and the gain evaluation, whose IEEE divisions dominate a
// lone warp, are split 8 ways (scan_common.cuh:scan_shape). The warps read
// the child's plane row through rows/gidx themselves, so the grower
// gathers nothing; a thread issues its index, mask and plane loads for up
// to 8 of its lanes at once, so the staging waits on two memory round
// trips, not on one per lane. They stage the six masked rows (g, h, count,
// each times keep_r and keep_f) in shared memory as f64, all lanes
// converting. Lanes 0-5 of the first warp then run the six prefix sums in
// lockstep, each a register f64 chain whose inputs are loaded a block
// ahead (scan_common.cuh:chain_prefix): the plain version's sequential
// cumsum, rounded to f32 when read, bit for bit. Each lane evaluates both
// directions at its thresholds (Wp / 32 / K of them) and keeps the best key
// per direction; one warp reduction per direction, plus one cross-warp
// stage when K > 1, picks the threshold. The key is a u64: the gain's
// order-preserving bits above, the tie-break below (REVERSE: the lane, so
// the highest threshold wins a tie; forward: Wp - 1 - lane, the lowest).
// Invalid lanes have no key. A valid gain exceeds min_gain_shift, which is
// the parent's leaf_gain plus min_gain_to_split (>= 0, the config's bound),
// so it is never -0.0 or NaN: its key orders exactly as the float
// comparisons of the plain version, +inf (l2 = 0 with a zero-hessian side)
// included. The knob form keeps this: its leaf_gain is
// ThresholdL1(g)^2 / (h + l2) >= 0, or with max_delta_step the gain of an
// output o clamped toward 0 from r = -ThresholdL1(g) / (h + l2), which is
// (h + l2) * o * (2r - o) with o of r's sign and |o| <= |r|, so >= 0 (or a
// zero of either sign, and -0.0 + 0.0 = +0.0). A split's monotone-clamped
// gain can be negative, and a bad split's is 0.0, but neither exceeds
// min_gain_shift >= +0.0, so neither is ever valid and packed. Forward
// wins only on a strictly greater gain, compared as floats after decoding.
// Compiled with -fmad=false; no fast math, no approximate division.
//
// The two count rows are integer-valued (floor(h * cf + 0.5) times a 0/1
// mask), so while their partial sums stay below 2^53 every f64 add is
// exact and any order gives the same bits (tests/test_torch_scan_rows.py
// checks this on the plain version). They run as chains here all the same:
// in the warp's lockstep, lanes 4-5 add no step to lanes 0-3, and a
// parallel scan would save only their share of the conversions.
//
// The knob form stages and scans as the fast form does; per lane it folds
// the child's node inputs into the two valid bits and evaluates the gains
// in the plain version's operations (knob_split_gain). Its launch shape is
// the fast form's. A simple form: the per-lane gain costs a few more
// divisions and branches, which later work may trim.
#include "scan_common.cuh"

template <bool KNOBS>
__global__ void scan_pair_kernel(const float* __restrict__ scal,
                                 const float* __restrict__ gh,
                                 const float* __restrict__ hh,
                                 const long long* __restrict__ rows,
                                 const long long* __restrict__ gidx,
                                 long long tbp,
                                 const float* __restrict__ keep_r,
                                 const float* __restrict__ keep_f,
                                 const float* __restrict__ valid_r,
                                 const float* __restrict__ valid_f,
                                 int valid_batched,
                                 const float* __restrict__ aux,
                                 const float* __restrict__ node, int B,
                                 int Fp, int Wp, int K,
                                 float* __restrict__ out,
                                 const long long* done, long long* counter) {
  if (done != nullptr && *done != 0) return;   // the grower's tree is done
  if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *counter += 1;
  extern __shared__ double scan_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // K = 1: warp `warp` of the block owns its pair; K > 1: the block's K
  // warps share one pair, warp kw taking the 32-lane chunks kw, kw + K, ...
  const int slot = K == 1 ? warp : 0;
  const int kw = K == 1 ? 0 : warp;
  const int pair = K == 1 ? blockIdx.x * nw + warp : blockIdx.x;
  if (pair >= B * Fp) return;            // the whole warp: no block barrier
  const int f = pair % Fp;
  const int c = pair / Fp;
  const int stride = row_stride(Wp);
  double* R = scan_smem + (size_t)slot * SCAN_ROWS * stride;
  unsigned long long* red = reinterpret_cast<unsigned long long*>(
      scan_smem + (size_t)(K == 1 ? nw : 1) * SCAN_ROWS * stride);
  const float NEG_INF = -INFINITY;

  const float* s = scal + c * (KNOBS ? 16 : 8);
  const float sg = s[0], sh = s[1], nd = s[2], cf = s[3];
  const float min_data = s[4], min_hess = s[5], mgs = s[6], l2 = s[7];
  // the knob form's scalars and this (child, feature)'s node inputs
  KnobScalars kn{};
  float rand_lane = -1.f;
  bool node_on = true;
  if (KNOBS) {
    kn = KnobScalars{l2, s[8], s[9], s[10], s[11], s[12] > 0.f, aux[Fp + f]};
    rand_lane = node[(size_t)c * 2 * Fp + f];
    node_on = node[(size_t)c * 2 * Fp + Fp + f] > 0.f;
  }
  const long long row = rows ? rows[c] : (long long)c;
  const float* gsrc = gh + row * tbp;
  const float* hsrc = hh + row * tbp;

  // stage the six masked rows: r-direction (g, h, cnt), then forward. A
  // thread's loads for up to SCAN_BATCH of its lanes are issued together
  // (index maps and masks, then the planes), and the valid masks are kept
  // as one bit per lane (bit j: the thread's j-th lane).
  const int nj = (Wp / 32 - kw + K - 1) / K;     // this warp's chunks
  unsigned valid_rb = 0, valid_fb = 0;
  for (int j0 = 0; j0 < nj; j0 += SCAN_BATCH) {
    long long src[SCAN_BATCH];
    float kr[SCAN_BATCH], kf[SCAN_BATCH], vr[SCAN_BATCH], vf[SCAN_BATCH];
    float g[SCAN_BATCH], h[SCAN_BATCH];
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      const int w = ((kw + (j0 + j) * K) << 5) + lane;
      const size_t m = (size_t)f * Wp + w;
      const size_t v = valid_batched ? (size_t)c * Fp * Wp + m : m;
      src[j] = gidx ? gidx[m] : (long long)m;
      kr[j] = keep_r[m];
      kf[j] = keep_f[m];
      vr[j] = valid_r[v];
      vf[j] = valid_f[v];
    }
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      g[j] = gsrc[src[j]];
      h[j] = hsrc[src[j]];
    }
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      const int w = ((kw + (j0 + j) * K) << 5) + lane;
      const float cnt = floorf(h[j] * cf + 0.5f);
      R[0 * stride + w] = (double)(g[j] * kr[j]);
      R[1 * stride + w] = (double)(h[j] * kr[j]);
      R[2 * stride + w] = (double)(cnt * kr[j]);
      R[3 * stride + w] = (double)(g[j] * kf[j]);
      R[4 * stride + w] = (double)(h[j] * kf[j]);
      R[5 * stride + w] = (double)(cnt * kf[j]);
      bool at = true;
      if (KNOBS)   // extra_trees: the drawn lane only; by-node: the mask
        at = node_on && (rand_lane < 0.f || (float)w == rand_lane);
      valid_rb |= (unsigned)(vr[j] > 0.f && at) << (j0 + j);
      valid_fb |= (unsigned)(vf[j] > 0.f && at) << (j0 + j);
    }
  }
  pair_sync(K);
  if (kw == 0 && lane < SCAN_ROWS) chain_prefix(R + lane * stride, 0, Wp - 1);
  pair_sync(K);

  const float gr_tot = (float)R[0 * stride + Wp - 1];
  const float hr_tot = (float)R[1 * stride + Wp - 1];
  const float cr_tot = (float)R[2 * stride + Wp - 1];
  unsigned long long best_r = 0, best_f = 0;
#pragma unroll 4
  for (int j = 0; j < nj; ++j) {
    const int w = ((kw + j * K) << 5) + lane;
    const float gr_c = (float)R[0 * stride + w];
    const float hr_c = (float)R[1 * stride + w];
    const float cr_c = (float)R[2 * stride + w];
    const float gl_c = (float)R[3 * stride + w];
    const float hl_c = (float)R[4 * stride + w];
    const float cl_c = (float)R[5 * stride + w];

    // REVERSE: the right side accumulates from the high bins
    const float r_grad = gr_tot - gr_c;
    const float r_hess = hr_tot - hr_c;
    const float r_cnt = cr_tot - cr_c;
    const float l_cnt = nd - r_cnt;
    const float l_grad = sg - r_grad;
    const float l_hess = sh - r_hess;
    const float gain_r =
        KNOBS ? knob_split_gain(l_grad, l_hess, r_grad, r_hess, kn)
              : (l_grad * l_grad) / (l_hess + l2) +
                    (r_grad * r_grad) / (r_hess + l2);
    const bool ok_r = ((valid_rb >> j) & 1u) && (r_cnt >= min_data) &&
                      (r_hess >= min_hess) && (l_cnt >= min_data) &&
                      (l_hess >= min_hess) && (gain_r > mgs);
    if (ok_r) {
      const unsigned long long key = pack_key(gain_r, (unsigned)w);
      best_r = key > best_r ? key : best_r;
    }

    // forward: the left side accumulates from the low bins
    const float f_r_cnt = nd - cl_c;
    const float f_r_grad = sg - gl_c;
    const float f_r_hess = sh - hl_c;
    const float gain_f =
        KNOBS ? knob_split_gain(gl_c, hl_c, f_r_grad, f_r_hess, kn)
              : (gl_c * gl_c) / (hl_c + l2) +
                    (f_r_grad * f_r_grad) / (f_r_hess + l2);
    const bool ok_f = ((valid_fb >> j) & 1u) && (cl_c >= min_data) &&
                      (hl_c >= min_hess) && (f_r_cnt >= min_data) &&
                      (f_r_hess >= min_hess) && (gain_f > mgs);
    if (ok_f) {
      const unsigned long long key =
          pack_key(gain_f, (unsigned)(Wp - 1 - w));
      best_f = key > best_f ? key : best_f;
    }
  }
  if (!pair_max_keys(&best_r, &best_f, red, K, kw, lane)) return;

  const bool has_r = best_r != 0;
  const bool has_f = best_f != 0;
  const float bg_r = has_r ? from_order_bits((unsigned)(best_r >> 32))
                           : NEG_INF;
  const float bg_f = has_f ? from_order_bits((unsigned)(best_f >> 32))
                           : NEG_INF;
  const int t_r = has_r ? (int)(unsigned)best_r : -1;
  const int t_f = has_f ? Wp - 1 - (int)(unsigned)best_f : -1;
  const bool use_f = bg_f > bg_r;
  const float feat_gain = use_f ? bg_f : bg_r;
  const int t = use_f ? t_f : t_r;
  const bool has_any = has_r || has_f;

  // the prefix sums at the chosen threshold (zero when none is chosen)
  float at[SCAN_ROWS];
#pragma unroll
  for (int q = 0; q < SCAN_ROWS; ++q)
    at[q] = t >= 0 ? (float)R[q * stride + t] : 0.f;
  const float lg = use_f ? at[3] : sg - (gr_tot - at[0]);
  const float lh = use_f ? at[4] : sh - (hr_tot - at[1]);
  const float lc = use_f ? at[5] : nd - (cr_tot - at[2]);
  float* o = out + (size_t)c * 8 * Fp + f;
  o[0 * Fp] = has_any ? (feat_gain - mgs) * aux[f] : NEG_INF;
  o[1 * Fp] = (float)t;
  o[2 * Fp] = use_f ? 1.f : 0.f;
  o[3 * Fp] = lg;
  o[4 * Fp] = lh;
  o[5 * Fp] = lc;
  o[6 * Fp] = has_any ? 1.f : 0.f;
  o[7 * Fp] = 0.f;
}

// scan_common.cuh:scan_allow_smem for one instantiation: the two share a
// function type, so each keeps its own opt-in here.
template <bool KNOBS>
static int allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      scan_pair_kernel<KNOBS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}

// Launches the scan of B children on `stream` (scan_common.cuh:scan_shape:
// K warps per (feature, child)): the knob form when `node` is not NULL,
// else the fast form. rows/gidx may be NULL (the gathered form). Wp is a multiple of 32 in [32, 1024]. With *done (a device int64;
// may be NULL) set the kernel returns at once; counter (may be NULL) is
// incremented once per scan. The scalars, rows and done flag are read from
// device memory, where the grower's step kernels write them. Returns the
// CUDA error of the launch, 0 on success.
extern "C" int scan_pair_launch(const void* scal, const void* gh,
                                const void* hh, const void* rows,
                                const void* gidx, long long tbp,
                                const void* keep_r, const void* keep_f,
                                const void* valid_r, const void* valid_f,
                                int valid_batched, const void* aux,
                                const void* node, int B, int Fp, int Wp,
                                void* out, const void* done, void* counter,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int pairs = B * Fp;
  const int pair_smem = SCAN_ROWS * row_stride(Wp) * (int)sizeof(double);
  const ScanShape sh = scan_shape(pairs, pair_smem, 1);
  const int smem = sh.K == 1 ? sh.nw * pair_smem
                             : pair_smem + 2 * sh.K * (int)sizeof(double);
  const int blocks = sh.K == 1 ? (pairs + sh.nw - 1) / sh.nw : pairs;
  const bool knobs = node != nullptr;
  const int err = knobs ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err) return err;
  auto kernel = knobs ? scan_pair_kernel<true> : scan_pair_kernel<false>;
  kernel<<<blocks, sh.nw * 32, smem, st>>>(
      static_cast<const float*>(scal), static_cast<const float*>(gh),
      static_cast<const float*>(hh), static_cast<const long long*>(rows),
      static_cast<const long long*>(gidx), tbp,
      static_cast<const float*>(keep_r), static_cast<const float*>(keep_f),
      static_cast<const float*>(valid_r), static_cast<const float*>(valid_f),
      valid_batched, static_cast<const float*>(aux),
      static_cast<const float*>(node), B, Fp, Wp, sh.K,
      static_cast<float*>(out), static_cast<const long long*>(done),
      static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

// The launch floor: one launch of a kernel that does nothing, timed beside
// the scans (chip_smoke.py); not on any path.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
