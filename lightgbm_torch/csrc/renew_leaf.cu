// renew_leaf: each leaf's output re-fit to a percentile of its rows'
// residuals (L1, Quantile and MAPE).
//
// No Pallas counterpart: the JAX package renews on the host in numpy, one
// leaf at a time (lightgbm_tpu/boosting/gbdt.py:747-766 _renew_tree_output
// -> objectives/base.py:214-256 percentile / weighted_percentile; reference
// regression_objective.hpp:18-90 PercentileFun / WeightedPercentileFun).
//
// Inputs: order [n] int64, the rows grouped by segment with ascending
// residual inside a segment and ties in row order (ops/renew.py:
// segment_order, two stable torch sorts); residual [n] f64 and weight [n]
// f32 (or NULL) by row; seg, segment i's (start, count) at
// seg[i * seg_stride + 0..1] (the persistent grower's device leaf table
// LI_START/LI_NROWS columns, or a [S, 2] table); nseg (or NULL), a device
// scalar: only segments below it are renewed, none when it is at most 1 (a
// tree without a split). Output: out[i * out_stride] (f32: the grower's
// LF_VALUE column; or f64), written for each renewed segment with rows,
// left as it is otherwise.
//
// Semantics kept exactly (bit for bit with the plain version and with the
// JAX package's numpy, built with -fmad=false):
//   unweighted: float_pos = (1 - alpha) * n, pos = (long long)float_pos,
//     the ends at pos < 1 and pos >= n, else s[pos-1] - (s[pos-1] -
//     s[pos]) * (float_pos - pos) with s the descending order;
//   weighted: cdf = the sequential f64 sum of the weights in ascending
//     residual order (numpy's cumsum; a parallel scan would round
//     differently), threshold = cdf[n-1] * alpha, pos = the first index
//     with cdf > threshold (searchsorted side="right" on a monotone cdf:
//     weights >= 0), clamped to n - 1, the ends at 0 and n - 1, the
//     interpolation where cdf[pos+1] - cdf[pos] >= 1.
//
// Design: one block per segment. Unweighted, a segment reads two of its
// lanes. Weighted, its threads stage the weights of 1024 lanes at a time
// into shared memory (reads of order are coalesced, the weight reads are
// gathers) and one thread adds them in order: a pass for the total, a
// second that stops at the threshold. What bounds it on an H100: the
// dependent f64 add chain of the largest segment (about 4 ns a lane), not
// its bytes (12 bytes a lane); a parallel walk that keeps the sequential
// rounding is later work. The kernel's first thread adds one to the device
// counter when the launch renews.
#include <cuda_runtime.h>
#include <stdint.h>

#define RL_THREADS 256
#define RL_CHUNK 1024

__global__ void __launch_bounds__(RL_THREADS)
renew_leaf(const long long* __restrict__ order,
           const double* __restrict__ residual,
           const float* __restrict__ weight, const long long* __restrict__ seg,
           int seg_stride, const long long* __restrict__ nseg, double alpha,
           float* out32, double* out64, int out_stride,
           long long* counter) {
  __shared__ double buf[RL_CHUNK];
  __shared__ double sh_val[2];
  __shared__ long long sh_pos;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  if (nseg != nullptr) {
    const long long s = *nseg;
    if (s <= 1 || i >= s) return;
  }
  if (i == 0 && tid == 0 && counter != nullptr) *counter += 1;
  const long long start = seg[(long long)i * seg_stride];
  const long long n = seg[(long long)i * seg_stride + 1];
  if (n <= 0) return;
  const long long* o = order + start;
  double v = 0.0;
  if (n == 1) {
    v = residual[o[0]];
  } else if (weight == nullptr) {
    const double float_pos = (1.0 - alpha) * (double)n;
    const long long pos = (long long)float_pos;
    if (pos < 1) {
      v = residual[o[n - 1]];
    } else if (pos >= n) {
      v = residual[o[0]];
    } else {
      const double bias = float_pos - (double)pos;
      const double v1 = residual[o[n - pos]];
      const double v2 = residual[o[n - 1 - pos]];
      v = v1 - (v1 - v2) * bias;
    }
  } else {
    // pass 1: the total, cdf[n - 1]
    double acc = 0.0;
    for (long long base = 0; base < n; base += RL_CHUNK) {
      const int m = (int)(n - base < RL_CHUNK ? n - base : RL_CHUNK);
      for (int j = tid; j < m; j += RL_THREADS)
        buf[j] = (double)weight[o[base + j]];
      __syncthreads();
      if (tid == 0)
        for (int j = 0; j < m; ++j) acc = acc + buf[j];
      __syncthreads();
    }
    const double threshold = acc * alpha;   // thread 0's is the one used
    // pass 2: the first cdf > threshold, and the cdf there
    if (tid == 0) sh_pos = -1;
    double cum = 0.0;
    for (long long base = 0; base < n; base += RL_CHUNK) {
      const int m = (int)(n - base < RL_CHUNK ? n - base : RL_CHUNK);
      for (int j = tid; j < m; j += RL_THREADS)
        buf[j] = (double)weight[o[base + j]];
      __syncthreads();
      if (tid == 0)
        for (int j = 0; j < m; ++j) {
          cum = cum + buf[j];
          if (cum > threshold) {
            sh_pos = base + j;
            sh_val[0] = cum;
            break;
          }
        }
      __syncthreads();
      if (sh_pos >= 0) break;
    }
    if (tid != 0) return;
    long long pos = sh_pos < 0 ? n : sh_pos;
    if (pos > n - 1) pos = n - 1;
    if (pos == 0 || pos == n - 1) {
      v = residual[o[pos]];
    } else {
      const double v1 = residual[o[pos - 1]];
      const double v2 = residual[o[pos]];
      const double c0 = sh_val[0];
      const double c1 = c0 + (double)weight[o[pos + 1]];
      v = (c1 - c0 >= 1.0) ? (threshold - c0) / (c1 - c0) * (v2 - v1) + v1
                           : v2;
    }
  }
  if (tid == 0) {
    if (out32 != nullptr)
      out32[(long long)i * out_stride] = (float)v;
    else
      out64[(long long)i * out_stride] = v;
  }
}

// Queues the renewal of S segments on `stream`; returns the CUDA error of
// the launch, 0 on success.
extern "C" int renew_leaf_launch(const void* order, const void* residual,
                                 const void* weight, const void* seg,
                                 int seg_stride, int S, const void* nseg,
                                 double alpha, void* out32, void* out64,
                                 int out_stride, void* counter,
                                 void* stream) {
  if (S <= 0) return 0;
  renew_leaf<<<S, RL_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(order),
      static_cast<const double*>(residual),
      static_cast<const float*>(weight), static_cast<const long long*>(seg),
      seg_stride, static_cast<const long long*>(nseg), alpha,
      static_cast<float*>(out32), static_cast<double*>(out64), out_stride,
      static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}
