// scan_blocks: bundle-native best split per (child, group) over [G, W]
// group planes, for EFB-bundled data.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_scan.py:scan_blocks
// (:525, kernel _scan_blocks_kernel at :372, pallas_call at :543). The TPU
// kernel takes whole-block prefix sums as triangular matmuls on the MXU and
// recovers each feature's window sums with segmented nearest-seed fills
// (log2(W) lane rolls); FixHistogram runs inside it.
//
// Contract (ops/block_scan.py:scan_blocks_plain on the padded gathered
// planes is the same function in plain PyTorch, bit for bit on the CPU):
//   scal  [B, 9] f32: scan_pair's eight scalars and the raw hessian sum
//   gh, hh [R, G * W] f32 group planes (W <= Wp, G <= Gp); child c reads
//         row rows[c] (rows [B] i64; NULL reads row c), and lanes of a
//         group g >= G or a lane w >= W read as 0
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
// 12.6 MB, a few microseconds of the card's bandwidth. The dependent chains
// are each window's f64 prefix sums: as long as a dense group's 255 lanes,
// one or two lanes in a one-hot bundle (Expo: 640 one-hot features in 10
// of its 18 groups).
//
// Design. K warps per (group, child) as in scan_pair.cu: one at the
// level's B = 256 (6144 warps, no block barrier), up to eight at a small
// batch. The warps read the child's plane row through rows themselves (no
// padded copy), a thread issuing its loads for up to 8 of its lanes at once:
// one ballot per 32 lanes of the window-first, window-last and fix masks
// gives each lane its window end (the first last lane at or after it,
// __ffs) and the list of windows, in parallel. Each
// chain then runs from its window's first lane to its last, one thread per
// (window, quantity): FixHistogram's two sums (only windows with a fix
// lane; only the f32 total at the last lane is kept), then the six prefix
// sums of scan_pair (scan_common.cuh:chain_prefix, a register f64 chain).
// The windows of a group run at once on the pair's threads; a dense
// (singleton) group is one window as wide as the group, whose six chains run
// in lockstep on lanes 0-5 as in scan_pair. Restarting the sum at each
// window's first lane is what the plain version does, so the bits are the
// same; lanes outside every window are never chosen (their valid masks are
// 0) and are left as staged. Each thread evaluates both directions at its
// Wp / 32 / K lanes; the penalty is applied before the key, and one warp
// reduction of scan_pair's packed key per direction (plus one cross-warp
// stage when K > 1) picks the lane
// (REVERSE: the highest lane of the best penalized gain; forward: the
// lowest; forward only on a strictly greater gain). A penalized gain is
// NaN only as inf * 0 (l2 = 0 and a zero penalty); then the plain version's
// maximum is NaN and no lane equals it, so the direction has no split: the
// kernel gives such a lane a key above every other (SCAN_POISON) and reads
// a poisoned maximum as no split. Compiled with -fmad=false.
#include "scan_common.cuh"

enum {
  BM_KEEP_R = 0, BM_KEEP_F, BM_VALID_R, BM_VALID_F, BM_SEED_S, BM_SEED_E,
  BM_FIX, BM_PEN
};

// Bytes of shared memory one pair takes at Wp lanes: the six f64 rows, the
// two raw f32 rows, three ballot words per 32 lanes and the window list,
// rounded up to 16 so that the next pair's rows stay aligned.
static __host__ __device__ int blocks_pair_smem(int Wp) {
  const int bytes = SCAN_ROWS * row_stride(Wp) * 8 + 2 * Wp * 4 +
                    3 * (Wp / 32) * 4 + 2 * Wp * 2;
  return (bytes + 15) & ~15;
}

// A direction whose best penalized gain is NaN: above every real key, so
// it survives the maximum, and read back as "no split".
#define SCAN_POISON 0xffffffffffffffffull

// The last lane of the window holding lane w: the first set bit at or after
// w of the window-last ballots, Wp - 1 past the last one (the plain
// version's _window_end).
static __device__ __forceinline__ int window_end(const unsigned* ends,
                                                 int nwords, int w) {
  int k = w >> 5;
  unsigned m = ends[k] & (SCAN_FULL << (w & 31));
  while (!m && ++k < nwords) m = ends[k];
  return m ? (k << 5) + __ffs(m) - 1 : (nwords << 5) - 1;
}

// The bits of ballot word k (lanes 32k to 32k + 31) inside lanes [a, e].
static __device__ __forceinline__ unsigned window_bits(unsigned bits, int k,
                                                       int a, int e) {
  if (k == (a >> 5)) bits &= SCAN_FULL << (a & 31);
  if (k == (e >> 5)) bits &= (2u << (e & 31)) - 1u;   // 0 - 1 at e & 31 = 31
  return bits;
}

__global__ void scan_blocks_kernel(const float* __restrict__ scal,
                                   const float* __restrict__ gh,
                                   const float* __restrict__ hh,
                                   const long long* __restrict__ rows,
                                   int G, int W,
                                   const float* __restrict__ masks,
                                   int do_fix, int B, int Gp, int Wp, int K,
                                   float* __restrict__ out,
                                   const long long* done,
                                   long long* counter) {
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
  if (pair >= B * Gp) return;            // the whole warp: no block barrier
  const int g = pair % Gp;
  const int c = pair / Gp;
  const int stride = row_stride(Wp);
  const int nwords = Wp >> 5;
  const int tid = kw * 32 + lane;        // thread of the pair, of 32 K
  unsigned char* base = reinterpret_cast<unsigned char*>(scan_smem) +
                        (size_t)slot * blocks_pair_smem(Wp);
  double* R = reinterpret_cast<double*>(base);
  float* raw = reinterpret_cast<float*>(R + SCAN_ROWS * stride);
  unsigned* starts = reinterpret_cast<unsigned*>(raw + 2 * Wp);
  unsigned* ends = starts + nwords;
  unsigned* fixes = ends + nwords;
  short* ws = reinterpret_cast<short*>(fixes + nwords);
  short* we = ws + Wp;
  unsigned long long* red = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<unsigned char*>(scan_smem) +
      (size_t)(K == 1 ? nw : 1) * blocks_pair_smem(Wp));
  const float NEG_INF = -INFINITY;

  const float* s = scal + c * 9;
  const float sg = s[0], sh = s[1], nd = s[2], cf = s[3];
  const float min_data = s[4], min_hess = s[5], mgs = s[6], l2 = s[7];
  const float sh_raw = s[8];
  const size_t plane = (size_t)Gp * Wp;
  const float* mg = masks + (size_t)g * Wp;    // + BM_* * plane + lane

  // the window structure of the group, one ballot per 32 lanes, and the
  // child's raw plane row, zero past G groups and W lanes; a thread's
  // loads for up to SCAN_BATCH of its lanes are issued together
  const int nj = (nwords - kw + K - 1) / K;      // this warp's chunks
  const long long row = rows ? rows[c] : (long long)c;
  const float* gsrc = gh + row * ((long long)G * W) + (long long)g * W;
  const float* hsrc = hh + row * ((long long)G * W) + (long long)g * W;
  for (int j0 = 0; j0 < nj; j0 += SCAN_BATCH) {
    float ss[SCAN_BATCH], se[SCAN_BATCH], sx[SCAN_BATCH];
    float gv[SCAN_BATCH], hv[SCAN_BATCH];
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      const int w = ((kw + (j0 + j) * K) << 5) + lane;
      const bool in = g < G && w < W;
      ss[j] = mg[BM_SEED_S * plane + w];
      se[j] = mg[BM_SEED_E * plane + w];
      sx[j] = mg[BM_FIX * plane + w];
      gv[j] = in ? gsrc[w] : 0.f;
      hv[j] = in ? hsrc[w] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      const int k = kw + (j0 + j) * K;
      const unsigned bs = __ballot_sync(SCAN_FULL, ss[j] > 0.f);
      const unsigned be = __ballot_sync(SCAN_FULL, se[j] > 0.f);
      const unsigned bx = __ballot_sync(SCAN_FULL, sx[j] > 0.f);
      if (lane == 0) {
        starts[k] = bs;
        ends[k] = be;
        fixes[k] = bx;
      }
      raw[(k << 5) + lane] = gv[j];
      raw[Wp + (k << 5) + lane] = hv[j];
    }
  }
  pair_sync(K);
  // the list of windows in lane order: window i runs from ws[i] to we[i]
  int nwin = 0;
  for (int k = 0; k < nwords; ++k) {
    const unsigned bs = starts[k];
    if (k % K == kw && ((bs >> lane) & 1u)) {
      const int i = nwin + __popc(bs & ((1u << lane) - 1u));
      ws[i] = (short)((k << 5) + lane);
      we[i] = (short)window_end(ends, nwords, (k << 5) + lane);
    }
    nwin += __popc(bs);
  }
  pair_sync(K);

  // FixHistogram: a window's fix lane takes x + (total - the window's f32
  // sum of the raw values); one thread per (window, grad or hess), and
  // only windows holding a fix lane sum
  if (do_fix) {
    for (int t = tid; t < 2 * nwin; t += 32 * K) {
      const int i = t >> 1, q = t & 1;
      const int a = ws[i], e = we[i];
      bool any = false;
      for (int k = a >> 5; k <= e >> 5; ++k)
        any |= window_bits(fixes[k], k, a, e) != 0u;
      if (!any) continue;
      float* x = raw + q * Wp;
      double acc = 0.0;
      for (int l = a; l <= e; ++l) acc += (double)x[l];
      const float d = (q ? sh_raw : sg) - (float)acc;
      for (int k = a >> 5; k <= e >> 5; ++k) {
        for (unsigned m = window_bits(fixes[k], k, a, e); m; m &= m - 1u) {
          const int l = (k << 5) + __ffs(m) - 1;
          x[l] = x[l] + d;
        }
      }
    }
    pair_sync(K);
  }

  // stage the six masked rows: r-direction (g, h, cnt), then forward; the
  // valid masks become one bit per lane (bit j: the thread's j-th lane)
  // and the penalty takes the raw grad's place in `raw`
  unsigned valid_rb = 0, valid_fb = 0;
  for (int j0 = 0; j0 < nj; j0 += SCAN_BATCH) {
    float kr[SCAN_BATCH], kf[SCAN_BATCH], vr[SCAN_BATCH], vf[SCAN_BATCH];
    float pen[SCAN_BATCH];
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      const int w = ((kw + (j0 + j) * K) << 5) + lane;
      kr[j] = mg[BM_KEEP_R * plane + w];
      kf[j] = mg[BM_KEEP_F * plane + w];
      vr[j] = mg[BM_VALID_R * plane + w];
      vf[j] = mg[BM_VALID_F * plane + w];
      pen[j] = mg[BM_PEN * plane + w];
    }
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j) {
      if (j0 + j >= nj) break;
      const int w = ((kw + (j0 + j) * K) << 5) + lane;
      const float gv = raw[w], hv = raw[Wp + w];
      const float cnt = floorf(hv * cf + 0.5f);
      R[0 * stride + w] = (double)(gv * kr[j]);
      R[1 * stride + w] = (double)(hv * kr[j]);
      R[2 * stride + w] = (double)(cnt * kr[j]);
      R[3 * stride + w] = (double)(gv * kf[j]);
      R[4 * stride + w] = (double)(hv * kf[j]);
      R[5 * stride + w] = (double)(cnt * kf[j]);
      raw[w] = pen[j];
      valid_rb |= (unsigned)(vr[j] > 0.f) << (j0 + j);
      valid_fb |= (unsigned)(vf[j] > 0.f) << (j0 + j);
    }
  }
  pair_sync(K);
  // the six prefix sums of every window, one thread per (window, row)
  for (int t = tid; t < SCAN_ROWS * nwin; t += 32 * K) {
    const int i = t / SCAN_ROWS;
    chain_prefix(R + (t % SCAN_ROWS) * stride, ws[i], we[i]);
  }
  pair_sync(K);

  unsigned long long best_r = 0, best_f = 0;
#pragma unroll 4
  for (int j = 0; j < nj; ++j) {
    const int w = ((kw + j * K) << 5) + lane;
    const int e = window_end(ends, nwords, w);
    const float pen = raw[w];

    // REVERSE: the right side is the window's total minus the prefix
    const float r_grad = (float)R[0 * stride + e] - (float)R[0 * stride + w];
    const float r_hess = (float)R[1 * stride + e] - (float)R[1 * stride + w];
    const float r_cnt = (float)R[2 * stride + e] - (float)R[2 * stride + w];
    const float l_cnt = nd - r_cnt;
    const float l_grad = sg - r_grad;
    const float l_hess = sh - r_hess;
    const float gain_r = (l_grad * l_grad) / (l_hess + l2) +
                         (r_grad * r_grad) / (r_hess + l2);
    const bool ok_r = ((valid_rb >> j) & 1u) && (r_cnt >= min_data) &&
                      (r_hess >= min_hess) && (l_cnt >= min_data) &&
                      (l_hess >= min_hess) && (gain_r > mgs);
    if (ok_r) {
      const float pg = (gain_r - mgs) * pen;
      const unsigned long long key =
          isnan(pg) ? SCAN_POISON : pack_key(pg, (unsigned)w);
      best_r = key > best_r ? key : best_r;
    }

    // forward: the left side is the prefix
    const float f_l_grad = (float)R[3 * stride + w];
    const float f_l_hess = (float)R[4 * stride + w];
    const float f_l_cnt = (float)R[5 * stride + w];
    const float f_r_cnt = nd - f_l_cnt;
    const float f_r_grad = sg - f_l_grad;
    const float f_r_hess = sh - f_l_hess;
    const float gain_f = (f_l_grad * f_l_grad) / (f_l_hess + l2) +
                         (f_r_grad * f_r_grad) / (f_r_hess + l2);
    const bool ok_f = ((valid_fb >> j) & 1u) && (f_l_cnt >= min_data) &&
                      (f_l_hess >= min_hess) && (f_r_cnt >= min_data) &&
                      (f_r_hess >= min_hess) && (gain_f > mgs);
    if (ok_f) {
      const float pg = (gain_f - mgs) * pen;
      const unsigned long long key =
          isnan(pg) ? SCAN_POISON : pack_key(pg, (unsigned)(Wp - 1 - w));
      best_f = key > best_f ? key : best_f;
    }
  }
  if (!pair_max_keys(&best_r, &best_f, red, K, kw, lane)) return;
  if (best_r == SCAN_POISON) best_r = 0;
  if (best_f == SCAN_POISON) best_f = 0;

  const bool has_r = best_r != 0;
  const bool has_f = best_f != 0;
  const float bg_r = has_r ? from_order_bits((unsigned)(best_r >> 32))
                           : NEG_INF;
  const float bg_f = has_f ? from_order_bits((unsigned)(best_f >> 32))
                           : NEG_INF;
  const int t_r = has_r ? (int)(unsigned)best_r : -1;
  const int t_f = has_f ? Wp - 1 - (int)(unsigned)best_f : -1;
  const bool use_f = bg_f > bg_r;
  const int t = use_f ? t_f : t_r;
  const bool has_any = has_r || has_f;

  // the left side at the chosen lane (0 when no lane is chosen)
  float lg = 0.f, lh = 0.f, lc = 0.f;
  if (t >= 0 && use_f) {
    lg = (float)R[3 * stride + t];
    lh = (float)R[4 * stride + t];
    lc = (float)R[5 * stride + t];
  } else if (t >= 0) {
    const int e = window_end(ends, nwords, t);
    lg = sg - ((float)R[0 * stride + e] - (float)R[0 * stride + t]);
    lh = sh - ((float)R[1 * stride + e] - (float)R[1 * stride + t]);
    lc = nd - ((float)R[2 * stride + e] - (float)R[2 * stride + t]);
  }
  float* o = out + (size_t)c * 8 * Gp + g;
  o[0 * Gp] = has_any ? (use_f ? bg_f : bg_r) : NEG_INF;
  o[1 * Gp] = (float)t;
  o[2 * Gp] = use_f ? 1.f : 0.f;
  o[3 * Gp] = lg;
  o[4 * Gp] = lh;
  o[5 * Gp] = lc;
  o[6 * Gp] = has_any ? 1.f : 0.f;
  o[7 * Gp] = 0.f;
}

// Launches the scan of B children on `stream` (scan_common.cuh:scan_shape:
// K warps per (group, child)). rows may be NULL (row c for child c). Wp is
// a multiple of 32 in [32, 1024], W <= Wp, G <= Gp. With *done (a device
// int64; may be NULL) set the kernel returns at once; counter (may be
// NULL) is incremented once per scan. The scalars, rows and done flag are
// read from device memory, where the grower's step kernels write them.
// Returns the CUDA error of the launch, 0 on success.
extern "C" int scan_blocks_launch(const void* scal, const void* gh,
                                  const void* hh, const void* rows, int G,
                                  int W, const void* masks, int do_fix,
                                  int B, int Gp, int Wp, void* out,
                                  const void* done, void* counter,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int pairs = B * Gp;
  const int pair_smem = blocks_pair_smem(Wp);
  const ScanShape sh = scan_shape(pairs, pair_smem, 2);
  const int smem = sh.K == 1 ? sh.nw * pair_smem
                             : pair_smem + 2 * sh.K * (int)sizeof(double);
  const int err = scan_allow_smem(scan_blocks_kernel, smem);
  if (err) return err;
  const int blocks = sh.K == 1 ? (pairs + sh.nw - 1) / sh.nw : pairs;
  scan_blocks_kernel<<<blocks, sh.nw * 32, smem, st>>>(
      static_cast<const float*>(scal), static_cast<const float*>(gh),
      static_cast<const float*>(hh), static_cast<const long long*>(rows), G,
      W, static_cast<const float*>(masks), do_fix, B, Gp, Wp, sh.K,
      static_cast<float*>(out), static_cast<const long long*>(done),
      static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}
