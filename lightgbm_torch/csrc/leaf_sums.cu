// leaf_sums: each leaf's f64 sums of grad and hess and its row count, over
// the rows of one tree (refit's per-leaf statistics).
//
// No Pallas counterpart: the JAX package refits on the host, in numpy
// (lightgbm_tpu/boosting/gbdt.py:775-813 refit: np.bincount of each tree's
// leaf of every row, weighted by the f64 gradients; reference
// gbdt.cpp:267 RefitTree -> FitByExistingTree).
//
// Inputs: order [n] int64, the rows grouped by leaf in row order inside a
// leaf (ops/refit.py:leaf_segments, one stable torch sort of the leaf
// index); grad, hess [n] f32 by row (the precision refit takes them in),
// each widened to f64 as it is read, which is exact; seg [L, 2] int64, leaf
// i's (start, count) in `order`. Output: out [L, 3] f64, (sum grad, sum
// hess, count).
//
// Order of the sums, fixed so that the card and the CPU agree bit for bit:
// each leaf's values are added one after another from +0.0 in row order,
// as np.bincount adds its weights (so the sums equal the JAX package's on
// equal gradients) and as the plain version's CPU cumsum does. A parallel
// reduction would round differently.
//
// Design: one block per leaf. Its threads stage the grad and hess of 1024
// lanes at a time into shared memory (the order reads are coalesced, the
// value reads are gathers); then thread 0 adds the grads and thread 32
// (another warp, so the two dependent chains run side by side) the hesses.
// What bounds it on an H100: the dependent f64 add chain of the largest
// leaf, not its 16 bytes a row (an int64 order entry, f32 grad and hess). The kernel's first thread adds one to the
// device counter.
#include <cuda_runtime.h>
#include <stdint.h>

#define LS_THREADS 256
#define LS_CHUNK 1024

__global__ void __launch_bounds__(LS_THREADS)
leaf_sums(const long long* __restrict__ order,
          const float* __restrict__ grad, const float* __restrict__ hess,
          const long long* __restrict__ seg, double* __restrict__ out,
          long long* counter) {
  __shared__ double bg[LS_CHUNK];
  __shared__ double bh[LS_CHUNK];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  if (i == 0 && tid == 0 && counter != nullptr) *counter += 1;
  const long long start = seg[2LL * i];
  const long long n = seg[2LL * i + 1];
  const long long* o = order + start;
  double acc = 0.0;
  for (long long base = 0; base < n; base += LS_CHUNK) {
    const int m = (int)(n - base < LS_CHUNK ? n - base : LS_CHUNK);
    for (int j = tid; j < m; j += LS_THREADS) {
      const long long r = o[base + j];
      bg[j] = (double)grad[r];
      bh[j] = (double)hess[r];
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < m; ++j) acc = acc + bg[j];
    } else if (tid == 32) {
      for (int j = 0; j < m; ++j) acc = acc + bh[j];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[3LL * i] = acc;
    out[3LL * i + 2] = (double)n;
  } else if (tid == 32) {
    out[3LL * i + 1] = acc;
  }
}

// Queues the sums of L leaves on `stream`; returns the CUDA error of the
// launch, 0 on success.
extern "C" int leaf_sums_launch(const void* order, const void* grad,
                                const void* hess, const void* seg, int L,
                                void* out, void* counter, void* stream) {
  if (L <= 0) return 0;
  leaf_sums<<<L, LS_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(order),
      static_cast<const float*>(grad), static_cast<const float*>(hess),
      static_cast<const long long*>(seg), static_cast<double*>(out),
      static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}
