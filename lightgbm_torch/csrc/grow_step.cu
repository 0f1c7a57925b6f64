// grow_step: the persistent grower's per-split bookkeeping on the card, so
// that a tree grows from device-resident state with no read-back between
// splits.
//
// No Pallas counterpart: on the TPU this is the jnp code of the grower's
// while_loop body (lightgbm_tpu/ops/grow_persist.py:1533-1678: the argmax
// of the leaves' gains, the split scalars, the children's state and the
// scan's scalars, the plane subtraction, the candidate assembly). The
// level phase and the v1 grower do the same on the host in numpy
// (ops/grow.py's assemble, ops/scan.py's pair_scalars,
// ops/grow_persist.py's _scalars); these kernels compute the same f32
// arithmetic, one IEEE operation at a time in the same order (built with
// -fmad=false and IEEE division), so the trees are bit for bit those of a
// host loop over that code. ops/grow_step.py holds each kernel's plain
// PyTorch version and the table layout, which the columns below must
// match.
//
// State (device memory, one grower):
//   lf [L, GS_LF] f32    per leaf: sum_hess, value, and the best
//                        candidate's gain, outputs and left/right sums
//   li [L, GS_LI] i64    per leaf: count, depth, segment (start, nrows),
//                        and the candidate's feature, threshold,
//                        default_left, left and right counts
//   rf [L-1, GS_RF] f32, ri [L-1, GS_RI] i64: the split records
//   st [GS_ST] i64       s (the next leaf id), done, the picked leaf, its
//                        buffer parity, then split_pass's (n_left, smaller
//                        child's start, its length)
//   scal [16] i32        the split's S_* scalars (split_common.cuh)
//   ps [2, 9] f32        the children's scan scalars (pair_scalars' eight
//                        columns and the raw hessian sum: scan_blocks')
//   ps8 [2, 8] f32       the same without the raw sum (scan_pair's)
//   rows [2] i64         the children's plane rows
//   feat [Fp, GS_FT] i32 per feature: the payload decode and split scalars
//                        and forced_right
// Every kernel but the root's returns at once when done is set, so a fixed
// trip count of steps grows the host loop's tree: the steps after the
// first that finds no positive gain do nothing. Each kernel's first thread
// increments its device counter when it does its work.
//
// What bounds them on an H100: latency. pick, commit and assemble are one
// block each over at most L (255) leaves or Fp (32) features, a few
// microseconds of dependent loads and one block reduction; planes moves
// 6 * G * 256 floats; apply_scores reads and writes each lane's score once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_common.cuh"

enum { LF_SUM_HESS = 0, LF_VALUE, LF_GAIN, LF_LOUT, LF_ROUT, LF_LSG, LF_LSH,
       LF_RSG, LF_RSH, GS_LF = 10 };
enum { LI_COUNT = 0, LI_DEPTH, LI_START, LI_NROWS, LI_FEAT, LI_THR, LI_DL,
       LI_LCNT, LI_RCNT, GS_LI = 10 };
enum { RF_GAIN = 0, RF_IVAL, GS_RF = 2 };
enum { RI_LEAF = 0, RI_FEAT, RI_THR, RI_DL, RI_ICNT, GS_RI = 5 };
enum { ST_S = 0, ST_DONE, ST_LEAF, ST_PARITY, ST_NLEFT, ST_CH_START,
       ST_CH_LEN, GS_ST = 8 };
enum { FT_WORD = 0, FT_SHIFT, FT_MASK, FT_NB, FT_MT, FT_DB, FT_LS, FT_LE,
       FT_MF, FT_FR, GS_FT = 10 };
enum { PS_COLS = 9 };
#define GS_THREADS 256

struct GsState {
  float* lf;
  long long* li;
  float* rf;
  long long* ri;
  long long* st;
  int* scal;
  float* ps;
  float* ps8;
  long long* rows;
  int L;
};

// The f32 constants of the split parameters, rounded on the host exactly
// as the numpy code rounds them.
struct GsConst {
  float l2;          // f32(lambda_l2)
  float eps2;        // f32(2 * kEpsilon)
  float min_data;    // f32(min_data_in_leaf)
  float min_hess;    // f32(min_sum_hessian_in_leaf)
  float mgts;        // f32(min_gain_to_split)
  int max_depth;
  int C;             // the payload's chunk lanes (S_NCH)
  int bagged;        // 1: the payload carries out-of-bag lanes (bagging or
                     // GOSS), so the leaf counts are the candidates'
                     // hessian-derived ones, not the segments' lengths
};

// Child b's row of the scan scalars: ops/scan.py:pair_scalars (in ps8
// and the first eight columns of ps) and the raw hessian sum (ps's
// ninth).
static __device__ void gs_pair_row(const GsState& S, int b, float sg,
                                   float sh_raw, long long cnt,
                                   const GsConst& k) {
  const float sh = sh_raw + k.eps2;
  const float c = (float)cnt;
  float p[PS_COLS];
  p[0] = sg;
  p[1] = sh;
  p[2] = c;
  p[3] = c / sh;
  p[4] = k.min_data;
  p[5] = k.min_hess;
  p[6] = (sg * sg) / (sh + k.l2) + k.mgts;
  p[7] = k.l2;
  p[8] = sh_raw;
  for (int q = 0; q < PS_COLS; ++q) S.ps[b * PS_COLS + q] = p[q];
  for (int q = 0; q < 8; ++q) S.ps8[b * 8 + q] = p[q];
}

// np.argmax's order: a NaN beats everything (the first NaN wins), else the
// larger value, and equal values go to the smaller index. (The gains the
// kernels compare are -inf or finite: assemble writes -inf for a non-finite
// scan gain, and a scan output is NaN only as inf * 0, which no valid
// feature penalty gives; the NaN rule keeps the kernel numpy's all the
// same.)
static __device__ __forceinline__ bool gs_better(float a, int ia, float b,
                                                 int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a > b;
}

// The first maximum of x[0, n) with stride `stride`, by the whole block;
// every thread gets the index.
static __device__ int gs_argmax(const float* x, int n, int stride) {
  __shared__ float bv[GS_THREADS];
  __shared__ int bi[GS_THREADS];
  float v = 0.f;
  int iv = -1;
  for (int i = threadIdx.x; i < n; i += GS_THREADS) {
    const float a = x[(long long)i * stride];
    if (iv < 0 || gs_better(a, i, v, iv)) {
      v = a;
      iv = i;
    }
  }
  bv[threadIdx.x] = v;
  bi[threadIdx.x] = iv;
  __syncthreads();
  for (int h = GS_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      const int j = threadIdx.x + h;
      if (bi[j] >= 0 &&
          (bi[threadIdx.x] < 0 ||
           gs_better(bv[j], bi[j], bv[threadIdx.x], bi[threadIdx.x]))) {
        bv[threadIdx.x] = bv[j];
        bi[threadIdx.x] = bi[j];
      }
    }
    __syncthreads();
  }
  const int r = bi[0];
  __syncthreads();                     // bv/bi are reused by the next call
  return r;
}

static __device__ __forceinline__ void gs_count(long long* counter) {
  if (counter != nullptr) *counter += 1;
}

// A new tree: every leaf and split record to its initial value (gain -inf,
// split_feature -1, the rest 0), the root's state from root_hist's totals
// sums [2] f32 (sum_grad, sum_hess), its scan scalars in ps row 0, rows[0]
// = 0, s = 1, done = 0. The root's count is *cnt (the bag step's in-bag
// count) when cnt is not NULL, else n; its segment is all n lanes. One
// block.
__global__ void __launch_bounds__(GS_THREADS)
gs_root(GsState S, const float* __restrict__ sums, long long n,
        const long long* __restrict__ cnt, GsConst k, long long* counter) {
  for (int i = threadIdx.x; i < S.L; i += GS_THREADS) {
    for (int c = 0; c < GS_LF; ++c) S.lf[(long long)i * GS_LF + c] = 0.f;
    for (int c = 0; c < GS_LI; ++c) S.li[(long long)i * GS_LI + c] = 0;
    S.lf[(long long)i * GS_LF + LF_GAIN] = -INFINITY;
    S.li[(long long)i * GS_LI + LI_FEAT] = -1;
    if (i < S.L - 1) {
      for (int c = 0; c < GS_RF; ++c) S.rf[(long long)i * GS_RF + c] = 0.f;
      for (int c = 0; c < GS_RI; ++c) S.ri[(long long)i * GS_RI + c] = 0;
      S.ri[(long long)i * GS_RI + RI_FEAT] = -1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float sg = sums[0], sh = sums[1];
    const long long count = cnt != nullptr ? *cnt : n;
    S.lf[LF_SUM_HESS] = sh;
    S.lf[LF_VALUE] = -sg / (sh + k.l2);
    S.li[LI_COUNT] = count;
    S.li[LI_NROWS] = n;
    gs_pair_row(S, 0, sg, sh, count, k);
    S.rows[0] = 0;
    for (int c = 0; c < GS_ST; ++c) S.st[c] = 0;
    S.st[ST_S] = 1;
    gs_count(counter);
  }
}

// pick: the leaf with the first maximum of the best gains (np.argmax);
// done unless its gain is positive and s < L; else the split's scalars,
// the leaf's buffer parity, split record s - 1 and the children's plane
// rows (l, s). One block.
__global__ void __launch_bounds__(GS_THREADS)
gs_pick(GsState S, const int* __restrict__ feat, GsConst k,
        long long* counter) {
  if (S.st[ST_DONE] != 0) return;
  const int l = gs_argmax(S.lf + LF_GAIN, S.L, GS_LF);
  if (threadIdx.x != 0) return;
  const long long s = S.st[ST_S];
  const float gain = S.lf[(long long)l * GS_LF + LF_GAIN];
  if (!(gain > 0.f) || s >= S.L) {
    S.st[ST_DONE] = 1;
    return;
  }
  const long long* lr = S.li + (long long)l * GS_LI;
  const int f = (int)lr[LI_FEAT];
  const int* ft = feat + (long long)f * GS_FT;
  const long long n_l = lr[LI_NROWS];
  int* sc = S.scal;
  sc[S_NCH] = (int)((n_l + k.C - 1) / k.C);
  sc[S_S0] = (int)lr[LI_START];
  sc[S_NL] = (int)n_l;
  sc[S_WG] = ft[FT_WORD];
  sc[S_SH] = ft[FT_SHIFT];
  sc[S_MASK] = ft[FT_MASK];
  sc[S_NB] = ft[FT_NB];
  sc[S_MT] = ft[FT_MT];
  sc[S_DB] = ft[FT_DB];
  sc[S_THR] = (int)lr[LI_THR];
  sc[S_DL] = (int)lr[LI_DL];
  sc[S_SMALL_L] = lr[LI_LCNT] <= lr[LI_RCNT] ? 1 : 0;
  sc[S_LS] = ft[FT_LS];
  sc[S_LE] = ft[FT_LE];
  sc[S_MF] = ft[FT_MF];
  S.st[ST_LEAF] = l;
  S.st[ST_PARITY] = lr[LI_DEPTH] % 2;
  long long* rec = S.ri + (s - 1) * GS_RI;
  rec[RI_LEAF] = l;
  rec[RI_FEAT] = f;
  rec[RI_THR] = lr[LI_THR];
  rec[RI_DL] = lr[LI_DL];
  rec[RI_ICNT] = lr[LI_COUNT];
  S.rf[(s - 1) * GS_RF + RF_GAIN] = gain;
  S.rf[(s - 1) * GS_RF + RF_IVAL] = S.lf[(long long)l * GS_LF + LF_VALUE];
  S.rows[0] = l;
  S.rows[1] = s;
  gs_count(counter);
}

// commit: after split_pass wrote n_left, the children's leaf state (left
// keeps id l, right is s) and their scan scalars. The children's segments
// come from n_left; their counts too, unless the payload is bagged: then
// the candidate's left and right counts (the JAX grower's stat_from_scan,
// grow_persist.py:1592-1595). One thread.
__global__ void gs_commit(GsState S, GsConst k, long long* counter) {
  if (S.st[ST_DONE] != 0) return;
  const long long l = S.st[ST_LEAF], s = S.st[ST_S];
  const long long n_left = S.st[ST_NLEFT];
  float* pf = S.lf + l * GS_LF;
  long long* pi = S.li + l * GS_LI;
  float* rfl = S.lf + s * GS_LF;
  long long* ril = S.li + s * GS_LI;
  const long long s0 = pi[LI_START], n_l = pi[LI_NROWS];
  const long long left_cnt = k.bagged ? pi[LI_LCNT] : n_left;
  const long long right_cnt =
      k.bagged ? pi[LI_RCNT] : pi[LI_COUNT] - n_left;
  const long long depth = pi[LI_DEPTH] + 1;
  const float lsg = pf[LF_LSG], lsh = pf[LF_LSH];
  const float rsg = pf[LF_RSG], rsh = pf[LF_RSH];
  const float lout = pf[LF_LOUT], rout = pf[LF_ROUT];
  pf[LF_SUM_HESS] = lsh;
  pf[LF_VALUE] = lout;
  pi[LI_COUNT] = left_cnt;
  pi[LI_DEPTH] = depth;
  pi[LI_START] = s0;
  pi[LI_NROWS] = n_left;
  rfl[LF_SUM_HESS] = rsh;
  rfl[LF_VALUE] = rout;
  ril[LI_COUNT] = right_cnt;
  ril[LI_DEPTH] = depth;
  ril[LI_START] = s0 + n_left;
  ril[LI_NROWS] = n_l - n_left;
  gs_pair_row(S, 0, lsg, lsh, left_cnt, k);
  gs_pair_row(S, 1, rsg, rsh, right_cnt, k);
  gs_count(counter);
}

// planes: the larger child's planes are the parent's minus the smaller
// child's (small [2, tbp]); by smaller_is_left the smaller goes to row l
// or s of gh/hh [L, tbp]. A grid-stride loop.
__global__ void gs_planes(GsState S, float* __restrict__ gh,
                          float* __restrict__ hh,
                          const float* __restrict__ small, long long tbp,
                          long long* counter) {
  if (S.st[ST_DONE] != 0) return;
  const long long l = S.st[ST_LEAF], s = S.st[ST_S];
  const bool sil = S.scal[S_SMALL_L] > 0;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < 2 * tbp; c += (long long)gridDim.x * blockDim.x) {
    float* P = c < tbp ? gh : hh;
    const long long j = c < tbp ? c : c - tbp;
    const float sm = small[c];
    const float big = P[l * tbp + j] - sm;
    P[s * tbp + j] = sil ? big : sm;
    P[l * tbp + j] = sil ? sm : big;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) gs_count(counter);
}

// assemble: each of the B children's best split from the scan output out
// [B, 8, Fp] (mode 0, scan_pair: the first maximum over features) or
// [B, 8, Gp] (mode 1, scan_blocks: the first maximum over groups, the
// feature from the owner map [Gp, Wp] at the clipped absolute lane, the
// threshold the lane minus the feature's window start), then
// ops/grow.py:assemble's arithmetic into the child's leaf row, and s += 1
// when `advance`. One block.
__global__ void __launch_bounds__(GS_THREADS)
gs_assemble(GsState S, const float* __restrict__ out, int B, int Fp,
            int mode, const int* __restrict__ owner, int Wp,
            const int* __restrict__ feat, GsConst k, int advance,
            long long* counter) {
  if (S.st[ST_DONE] != 0) return;
  for (int b = 0; b < B; ++b) {
    const float* ob = out + (long long)b * 8 * Fp;
    const int j = gs_argmax(ob, Fp, 1);
    if (threadIdx.x != 0) continue;
    const long long row = S.rows[b];
    float best[8];
    for (int q = 0; q < 8; ++q) best[q] = ob[(long long)q * Fp + j];
    int f;
    long long thr;
    if (mode == 0) {
      f = j;
      thr = (long long)best[1];
    } else {
      long long lane = (long long)best[1];
      lane = lane < 0 ? 0 : (lane > Wp - 1 ? Wp - 1 : lane);
      f = owner[(long long)j * Wp + lane];
      thr = (long long)best[1] - feat[(long long)f * GS_FT + FT_LS];
    }
    const bool forced_right = feat[(long long)f * GS_FT + FT_FR] != 0;
    float* lf = S.lf + row * GS_LF;
    long long* li = S.li + row * GS_LI;
    const float gain = best[0];
    bool valid = isfinite(gain);
    if (k.max_depth > 0) valid = valid && li[LI_DEPTH] < k.max_depth;
    const float* p = S.ps + (long long)b * PS_COLS;
    const float sg = p[0], sh = p[1], cnt = p[2];
    const float lg = best[3], lh = best[4], lc = best[5];
    const float rg = sg - lg, rh = sh - lh, rc = cnt - lc;
    lf[LF_GAIN] = valid ? gain : -INFINITY;
    lf[LF_LOUT] = -lg / (lh + k.l2);
    lf[LF_ROUT] = -rg / (rh + k.l2);
    lf[LF_LSG] = lg;
    lf[LF_LSH] = lh;
    lf[LF_RSG] = rg;
    lf[LF_RSH] = rh;
    li[LI_FEAT] = valid ? f : -1;
    li[LI_THR] = valid ? thr : 0;
    li[LI_DL] = valid ? (!(best[2] > 0.5f) && !forced_right) : 1;
    li[LI_LCNT] = (long long)floorf(lc + 0.5f);
    li[LI_RCNT] = (long long)floorf(rc + 0.5f);
  }
  if (threadIdx.x == 0) {
    if (advance) S.st[ST_S] += 1;
    gs_count(counter);
  }
}

// The consolidation's segment table tab [L, 2] (start, length): leaf k's
// segment when k < s, its depth is odd and it has lanes, else length 0.
// One block; never a no-op (it runs once per tree, after the steps).
__global__ void __launch_bounds__(GS_THREADS)
gs_cons_table(GsState S, long long* __restrict__ tab) {
  const long long s = S.st[ST_S];
  for (int i = threadIdx.x; i < S.L; i += GS_THREADS) {
    const long long* li = S.li + (long long)i * GS_LI;
    const bool odd = i < s && (li[LI_DEPTH] & 1) && li[LI_NROWS] > 0;
    tab[2LL * i] = li[LI_START];
    tab[2LL * i + 1] = odd ? li[LI_NROWS] : 0;
  }
}

// score += f32(value * shrink) on every lane of each of the tree's s
// leaves (none when s <= 1), one add per lane; `score` is the payload's
// f32 score row, `shrink` the learning rate in device memory (written by
// the host before the iteration, so one captured graph serves any rate).
// A fixed grid; each leaf's lanes are spread over all of it.
__global__ void gs_apply(GsState S, float* __restrict__ score,
                         const float* __restrict__ shrink_p,
                         long long* counter) {
  const long long s = S.st[ST_S];
  if (s <= 1) return;
  const float shrink = *shrink_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = 0; q < s; ++q) {
    const long long start = S.li[q * GS_LI + LI_START];
    const long long nr = S.li[q * GS_LI + LI_NROWS];
    const float v = S.lf[q * GS_LF + LF_VALUE] * shrink;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < nr; i += stride)
      score[start + i] = score[start + i] + v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) gs_count(counter);
}

// RF's running average (the JAX package's apply_scores_avg, grow_persist.
// py:1775-1805, jnp; no Pallas kernel): on every lane of each of the
// tree's s leaves (none when s <= 1: a tree of one leaf leaves the average
// as it is), score = (score * t + v) * inv with v = value + bias when the
// bias flag is set (else the value, so a -0.0 leaf keeps its sign), each
// operation rounded on its own (__fmul_rn / __fadd_rn: no contraction into
// a fused multiply-add). avg [4] f32 in device memory: t, 1 / (t + 1), the
// bias, its flag, written by the host before each iteration. The same
// grid as gs_apply.
__global__ void gs_apply_avg(GsState S, float* __restrict__ score,
                             const float* __restrict__ avg,
                             long long* counter) {
  const long long s = S.st[ST_S];
  if (s <= 1) return;
  const float t = avg[0], inv = avg[1], bias = avg[2];
  const bool use_bias = avg[3] != 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = 0; q < s; ++q) {
    const long long start = S.li[q * GS_LI + LI_START];
    const long long nr = S.li[q * GS_LI + LI_NROWS];
    float v = S.lf[q * GS_LF + LF_VALUE];
    if (use_bias) v = __fadd_rn(v, bias);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < nr; i += stride)
      score[start + i] =
          __fmul_rn(__fadd_rn(__fmul_rn(score[start + i], t), v), inv);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) gs_count(counter);
}

static int gs_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

static GsState gs_state(void* lf, void* li, void* rf, void* ri, void* st,
                        void* scal, void* ps, void* ps8, void* rows, int L) {
  return {static_cast<float*>(lf), static_cast<long long*>(li),
          static_cast<float*>(rf), static_cast<long long*>(ri),
          static_cast<long long*>(st), static_cast<int*>(scal),
          static_cast<float*>(ps), static_cast<float*>(ps8),
          static_cast<long long*>(rows), L};
}

#define GS_ARGS                                                          \
  void *lf, void *li, void *rf, void *ri, void *st, void *scal, void *ps, \
      void *ps8, void *rows, int L
#define GS_STATE gs_state(lf, li, rf, ri, st, scal, ps, ps8, rows, L)
#define GS_CONST_ARGS                                                   \
  float l2, float eps2, float min_data, float min_hess, float mgts,    \
      int max_depth, int C, int bagged
#define GS_CONST {l2, eps2, min_data, min_hess, mgts, max_depth, C, bagged}

static int gs_err() { return (int)cudaGetLastError(); }

// The launchers: each queues its kernel on `stream` and returns the CUDA
// error of the launch, 0 on success. counter may be NULL.
extern "C" int gs_root_launch(GS_ARGS, const void* sums, long long n,
                              const void* cnt, GS_CONST_ARGS, void* counter,
                              void* stream) {
  gs_root<<<1, GS_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<const float*>(sums), n,
      static_cast<const long long*>(cnt), GsConst GS_CONST,
      static_cast<long long*>(counter));
  return gs_err();
}

extern "C" int gs_pick_launch(GS_ARGS, const void* feat, GS_CONST_ARGS,
                              void* counter, void* stream) {
  gs_pick<<<1, GS_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<const int*>(feat), GsConst GS_CONST,
      static_cast<long long*>(counter));
  return gs_err();
}

extern "C" int gs_commit_launch(GS_ARGS, GS_CONST_ARGS, void* counter,
                                void* stream) {
  gs_commit<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, GsConst GS_CONST, static_cast<long long*>(counter));
  return gs_err();
}

extern "C" int gs_planes_launch(GS_ARGS, void* gh, void* hh,
                                const void* small, long long tbp,
                                void* counter, void* stream) {
  const long long want = (2 * tbp + 255) / 256;
  const int grid = (int)(want < 4LL * gs_sms() ? (want < 1 ? 1 : want)
                                                : 4LL * gs_sms());
  gs_planes<<<grid, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<float*>(gh), static_cast<float*>(hh),
      static_cast<const float*>(small), tbp,
      static_cast<long long*>(counter));
  return gs_err();
}

extern "C" int gs_assemble_launch(GS_ARGS, const void* out, int B, int Fp,
                                  int mode, const void* owner, int Wp,
                                  const void* feat, GS_CONST_ARGS,
                                  int advance, void* counter, void* stream) {
  gs_assemble<<<1, GS_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<const float*>(out), B, Fp, mode,
      static_cast<const int*>(owner), Wp, static_cast<const int*>(feat),
      GsConst GS_CONST, advance, static_cast<long long*>(counter));
  return gs_err();
}

extern "C" int gs_cons_table_launch(GS_ARGS, void* tab, void* stream) {
  gs_cons_table<<<1, GS_THREADS, 0,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<long long*>(tab));
  return gs_err();
}

// A fixed grid of four blocks of 256 threads per multiprocessor (fewer for
// a payload of fewer lanes).
extern "C" int gs_apply_launch(GS_ARGS, void* score, const void* shrink,
                               long long n, void* counter, void* stream) {
  const long long want = (n + 255) / 256;
  const int grid = (int)(want < 4LL * gs_sms() ? (want < 1 ? 1 : want)
                                                : 4LL * gs_sms());
  gs_apply<<<grid, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<float*>(score),
      static_cast<const float*>(shrink), static_cast<long long*>(counter));
  return gs_err();
}

// RF's running average: the same grid as gs_apply_launch.
extern "C" int gs_apply_avg_launch(GS_ARGS, void* score, const void* avg,
                                   long long n, void* counter,
                                   void* stream) {
  const long long want = (n + 255) / 256;
  const int grid = (int)(want < 4LL * gs_sms() ? (want < 1 ? 1 : want)
                                                : 4LL * gs_sms());
  gs_apply_avg<<<grid, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      GS_STATE, static_cast<float*>(score), static_cast<const float*>(avg),
      static_cast<long long*>(counter));
  return gs_err();
}

// The node count of a captured CUDA graph (a cudaGraph_t from the caller's
// runtime), for the smoke test's report. Returns the CUDA error or 0.
extern "C" int gs_graph_nodes(void* graph, long long* count) {
  size_t n = 0;
  const cudaError_t err =
      cudaGraphGetNodes(reinterpret_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = (long long)n;
  return (int)err;
}
