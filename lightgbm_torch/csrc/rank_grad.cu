// rank_grad: the per-query gradient passes of the ranking objectives.
//
// No Pallas counterpart: the JAX package computes both in jnp outside any
// Pallas kernel.
//
//   lambdarank_grad: LambdaRank-NDCG's pairwise lambdas, the counterpart of
//     lightgbm_tpu/objectives/rank.py:120-216 (one_query; reference
//     rank_objective.hpp:139-232), with the JAX package's exact sigmoid in
//     place of the reference's 1M-entry table.
//   xendcg_grad: XE-NDCG's per-query softmax chains, the counterpart of
//     lightgbm_tpu/objectives/rank.py:383-415 (RankXENDCG.grad_fn;
//     reference rank_objective.hpp:288-352).
//
// Both take the boosting scores in row order (f64); queries are contiguous
// row ranges given by the boundaries qb [Q + 1] (int32). Both compute in
// f64, accumulate every sum sequentially in row order (the plain versions
// in ops/rank.py repeat each order; no float atomics), multiply the sample
// weight (when given) before one rounding to f32, and are built with
// -fmad=false: kernel and plain version agree bit for bit wherever the
// card's exp/log2 round their last f64 bit as the host's do.
//
// lambdarank_grad, one block per query. A row's rank in its query is
// #{j : s_j > s_i} + #{j < i : s_j == s_i}, the stable descending order
// (comparisons treat -0.0 and +0.0 as equal, as the JAX package's
// lax.sort does), so no sort runs; its discount is disc[rank] from the
// uploaded table. Thread i walks j in increasing order and sums the pair
// terms where it is the higher label (A_i, hessian C_i) and where it is
// the lower (B_i, D_i): lambda_i = A_i - B_i, hess_i = C_i + D_i; the
// query's sum_lambdas = -2 * (A_0 + A_1 + ...) in row order by one thread.
// A query of at most LR_SMEM_ROWS rows is staged in dynamic shared memory
// (52 bytes a row); a longer one reads its scores, gains and labels from
// device memory and keeps its per-row values in a [4 n] f64 scratch. The
// pair loop is O(P^2) with one exp and up to two f64 divisions a pair;
// each pair of unequal labels is evaluated by both of its threads. What
// bounds it on an H100: the f64 operations of the pairs, not its bytes.
//
// xendcg_grad, one thread per query: the max, then five sequential f64
// passes over the query's rows (exp sum, phi sum, l1 sum, l2 sum, output).
// The uniform draws come from the host's LCG (ops/rank.py). Bound: bytes
// (a few reads of each row), the walk is latency-bound per thread.
//
// Each launch's first thread adds one to its device counter.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LR_THREADS 128
#define LR_SMEM_ROWS 1024
#define LR_ROW_BYTES 52
#define XE_THREADS 128
#define K_EPSILON 1e-15

struct QueryRows {
  const double* s;
  const double* gain;
  const int* lab;
  double* disc;
  double* A;
  double* L;
  double* H;
};

// The (lambda, hessian) terms of one pair, high row minus low row: d, the
// score difference; gap, the gain difference; pd, |disc_hi - disc_lo|.
__device__ __forceinline__ void pair_terms(double d, double gap, double pd,
                                           double inv, bool use_norm,
                                           double sigmoid, double neg_sigmoid,
                                           double sig2, double& pl,
                                           double& ph) {
  double delta = gap * pd;
  delta = delta * inv;
  if (use_norm) delta = delta / (0.01 + fabs(d));
  const double p = 1.0 / (1.0 + exp(d * sigmoid));
  const double hp = p * (1.0 - p);
  pl = neg_sigmoid * delta;
  pl = pl * p;
  ph = sig2 * delta;
  ph = ph * hp;
}

__global__ void __launch_bounds__(LR_THREADS)
lambdarank_grad(const double* __restrict__ score,
                const int* __restrict__ label,
                const double* __restrict__ gain,
                const double* __restrict__ inv_max_dcg,
                const double* __restrict__ disc_table,
                const float* __restrict__ weight, const int* __restrict__ qb,
                long long n, int cap, double* scratch, double sigmoid,
                double neg_sigmoid, double sig2, int norm, float* g, float* h,
                long long* counter) {
  extern __shared__ double smem[];
  __shared__ double red[2 * LR_THREADS];
  __shared__ double sh_sum;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  if (q == 0 && tid == 0 && counter != nullptr) *counter += 1;
  const long long start = qb[q];
  const int cnt = qb[q + 1] - qb[q];
  if (cnt <= 0) return;
  QueryRows R;
  if (cnt <= cap) {
    double* s = smem;
    double* gn = s + cap;
    R.disc = gn + cap;
    R.A = R.disc + cap;
    R.L = R.A + cap;
    R.H = R.L + cap;
    int* lb = reinterpret_cast<int*>(R.H + cap);
    for (int i = tid; i < cnt; i += LR_THREADS) {
      s[i] = score[start + i];
      gn[i] = gain[start + i];
      lb[i] = label[start + i];
    }
    R.s = s;
    R.gain = gn;
    R.lab = lb;
    __syncthreads();
  } else {
    R.s = score + start;
    R.gain = gain + start;
    R.lab = label + start;
    R.disc = scratch + start;
    R.A = scratch + n + start;
    R.L = scratch + 2 * n + start;
    R.H = scratch + 3 * n + start;
  }
  // ranks -> discounts; the best and worst scores
  double mx = -INFINITY, mn = INFINITY;
  for (int i = tid; i < cnt; i += LR_THREADS) {
    const double si = R.s[i];
    int r = 0;
    for (int j = 0; j < cnt; ++j) {
      const double sj = R.s[j];
      r += (sj > si) || (sj == si && j < i);
    }
    R.disc[i] = disc_table[r];
    mx = fmax(mx, si);
    mn = fmin(mn, si);
  }
  red[tid] = mx;
  red[LR_THREADS + tid] = mn;
  __syncthreads();
  if (tid == 0) {
    for (int t = 1; t < LR_THREADS; ++t) {
      mx = fmax(mx, red[t]);
      mn = fmin(mn, red[LR_THREADS + t]);
    }
    red[0] = mx;
    red[LR_THREADS] = mn;
  }
  __syncthreads();
  const bool use_norm = norm && (red[0] != red[LR_THREADS]);
  const double inv = inv_max_dcg[q];
  for (int i = tid; i < cnt; i += LR_THREADS) {
    const double si = R.s[i], gi = R.gain[i], di = R.disc[i];
    const int li = R.lab[i];
    double a = 0.0, b = 0.0, c = 0.0, e = 0.0;
    for (int j = 0; j < cnt; ++j) {
      const int lj = R.lab[j];
      if (lj == li) continue;
      const double sj = R.s[j], gj = R.gain[j], dj = R.disc[j];
      double pl, ph;
      if (li > lj) {
        pair_terms(si - sj, gi - gj, fabs(di - dj), inv, use_norm, sigmoid,
                   neg_sigmoid, sig2, pl, ph);
        a = a + pl;
        c = c + ph;
      } else {
        pair_terms(sj - si, gj - gi, fabs(dj - di), inv, use_norm, sigmoid,
                   neg_sigmoid, sig2, pl, ph);
        b = b + pl;
        e = e + ph;
      }
    }
    R.A[i] = a;
    R.L[i] = a - b;
    R.H[i] = c + e;
  }
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int i = 0; i < cnt; ++i) t = t + R.A[i];
    sh_sum = -2.0 * t;
  }
  __syncthreads();
  double factor = 1.0;
  if (norm) {
    const double sl = sh_sum;
    factor = sl > 0.0 ? log2(1.0 + sl) / sl : 1.0;
  }
  for (int i = tid; i < cnt; i += LR_THREADS) {
    double lam = R.L[i], hs = R.H[i];
    if (norm) {
      lam = lam * factor;
      hs = hs * factor;
    }
    if (weight != nullptr) {
      const double w = (double)weight[start + i];
      lam = lam * w;
      hs = hs * w;
    }
    g[start + i] = (float)lam;
    h[start + i] = (float)hs;
  }
}

__global__ void __launch_bounds__(XE_THREADS)
xendcg_grad(const double* __restrict__ score, const float* __restrict__ label,
            const double* __restrict__ rnd, const float* __restrict__ weight,
            const int* __restrict__ qb, int Q, float* g, float* h,
            long long* counter) {
  const int q = blockIdx.x * XE_THREADS + threadIdx.x;
  if (q == 0 && counter != nullptr) *counter += 1;
  if (q >= Q) return;
  const long long start = qb[q];
  const int cnt = qb[q + 1] - qb[q];
  if (cnt <= 0) return;
  const double* s = score + start;
  const float* lb = label + start;
  const double* u = rnd + start;
  double mx = -INFINITY;
  for (int r = 0; r < cnt; ++r) mx = fmax(mx, s[r]);
  double se = 0.0, sp = 0.0;
  for (int r = 0; r < cnt; ++r) {
    se = se + exp(s[r] - mx);
    sp = sp + (ldexp(1.0, (int)floor((double)lb[r])) - u[r]);
  }
  const double sum_labels = fmax(K_EPSILON, sp);
  double s1 = 0.0;
  for (int r = 0; r < cnt; ++r) {
    const double rho = exp(s[r] - mx) / se;
    const double phi = ldexp(1.0, (int)floor((double)lb[r])) - u[r];
    s1 = s1 + (-phi / sum_labels + rho);
  }
  double s2 = 0.0;
  for (int r = 0; r < cnt; ++r) {
    const double rho = exp(s[r] - mx) / se;
    const double phi = ldexp(1.0, (int)floor((double)lb[r])) - u[r];
    const double l1 = -phi / sum_labels + rho;
    s2 = s2 + (s1 - l1) / (1.0 - rho);
  }
  for (int r = 0; r < cnt; ++r) {
    const double rho = exp(s[r] - mx) / se;
    const double phi = ldexp(1.0, (int)floor((double)lb[r])) - u[r];
    const double l1 = -phi / sum_labels + rho;
    const double l2 = (s1 - l1) / (1.0 - rho);
    const double l3 = (s2 - l2) / (1.0 - rho);
    double lam = cnt <= 1 ? l1 : (l1 + rho * l2) + (rho * rho) * l3;
    double hs = rho * (1.0 - rho);
    if (weight != nullptr) {
      const double w = (double)weight[start + r];
      lam = lam * w;
      hs = hs * w;
    }
    g[start + r] = (float)lam;
    h[start + r] = (float)hs;
  }
}

// Queues lambdarank_grad over Q queries on `stream`; `cap` rows of a query
// fit in shared memory (min(longest query, LR_SMEM_ROWS)); scratch ([4 n]
// f64) is needed when the longest query exceeds cap. Returns the CUDA
// error of the launch, 0 on success.
extern "C" int lambdarank_grad_launch(
    const void* score, const void* label, const void* gain,
    const void* inv_max_dcg, const void* disc, const void* weight,
    const void* qb, int Q, long long n, int cap, void* scratch,
    double sigmoid, int norm, void* g, void* h, void* counter,
    void* stream) {
  if (Q <= 0) return 0;
  if (cap < 1 || cap > LR_SMEM_ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cap * LR_ROW_BYTES;
  // the opt-in above 48 KB, once, for the largest stage (the first call
  // runs eagerly; a CUDA graph's capture then sets nothing)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lambdarank_grad, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LR_SMEM_ROWS * LR_ROW_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  lambdarank_grad<<<Q, LR_THREADS, smem,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(score), static_cast<const int*>(label),
      static_cast<const double*>(gain),
      static_cast<const double*>(inv_max_dcg),
      static_cast<const double*>(disc), static_cast<const float*>(weight),
      static_cast<const int*>(qb), n, cap, static_cast<double*>(scratch),
      sigmoid, -sigmoid, sigmoid * sigmoid, norm, static_cast<float*>(g),
      static_cast<float*>(h), static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}

// Queues xendcg_grad over Q queries on `stream`; returns the CUDA error of
// the launch, 0 on success.
extern "C" int xendcg_grad_launch(const void* score, const void* label,
                                  const void* rnd, const void* weight,
                                  const void* qb, int Q, void* g, void* h,
                                  void* counter, void* stream) {
  if (Q <= 0) return 0;
  xendcg_grad<<<(Q + XE_THREADS - 1) / XE_THREADS, XE_THREADS, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(score), static_cast<const float*>(label),
      static_cast<const double*>(rnd), static_cast<const float*>(weight),
      static_cast<const int*>(qb), Q, static_cast<float*>(g),
      static_cast<float*>(h), static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}
