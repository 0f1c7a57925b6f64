// payload_hist.cuh: the (grad, hess) histogram of a run of payload lanes,
// shared by seg_hist.cu, root_hist.cu and split_pass.cu.
//
// The payload is the persistent grower's [WPA, NP] int32 matrix
// (lightgbm_torch/ops/payload.py): row r of lane i at pay[r * NP + i]. Group
// g's bin of lane i is (pay[w * NP + i] >> sh) & mk with (w, sh, mk) =
// plan[g] (byte slots, or 4-bit nibbles for groups of at most 16 bins);
// grad and hess are the f32 bits of rows grad_row and grad_row + 1.
//
// Contract (ops/payload_kernels.py:seg_hist_plain is the same function in
// plain PyTorch, bit for bit on the CPU):
//   lanes [start, start + length) are histogrammed, cut into row blocks of
//   rows_per_block lanes (the last one shorter; ops/histogram.py:row_blocks,
//   a function of the length and G only). Within a block each of the
//   G * 256 bins is one f32 chain, 0 + v[i1] + v[i2] + ... in lane order;
//   the blocks' sums are then added in block order. Output: two planes,
//   out[0][g * 256 + b] (grad) and out[1][g * 256 + b] (hess).
//   Optionally (root_hist) the f64 sums of grad and hess over the lanes,
//   rounded to f32 at the end.
//
// Design: the ownership scheme of hist_window.cu, with the bin decode
// folded into the staging loop. Block (row block, g) gives each of its 256
// threads one bin of group g; the block stages a tile of decoded bin bytes
// and the grad/hess of each lane in shared memory, and every thread reads
// the tile four lanes to a 32-bit word and compares them with its bin at
// once (__vcmpeq4), adding the matching lanes' values in lane order. A
// second kernel adds the row blocks in block order. No atomics: two
// launches give bit-identical results.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PH_THREADS 256
#define PH_BINS 256
#define PH_TILE 4096

__global__ void __launch_bounds__(PH_THREADS)
payload_hist_partial(const int32_t* __restrict__ pay, long long np_,
                     const int32_t* __restrict__ plan, int grad_row,
                     long long start, long long length, int G,
                     long long rows_per_block, float* __restrict__ partial,
                     double* __restrict__ sums_partial) {
  __shared__ __align__(16) uint8_t tb[PH_TILE];
  __shared__ float tg[PH_TILE];
  __shared__ float th[PH_TILE];
  __shared__ double red[2][PH_THREADS];
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int32_t* word = pay + (long long)plan[3 * g] * np_;
  const unsigned sh = (unsigned)plan[3 * g + 1];
  const unsigned mk = (unsigned)plan[3 * g + 2];
  const float* grad = reinterpret_cast<const float*>(pay + grad_row * np_);
  const float* hess = grad + np_;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(length, r_begin + rows_per_block);
  const unsigned pat = (unsigned)t * 0x01010101u;
  const bool do_sums = sums_partial != nullptr && g == 0;
  float acc_g = 0.f, acc_h = 0.f;
  double sum_g = 0.0, sum_h = 0.0;

  for (long long t0 = r_begin; t0 < r_end; t0 += PH_TILE) {
    const int n = (int)min((long long)PH_TILE, r_end - t0);
    __syncthreads();  // the previous tile is consumed
    const long long i0 = start + t0;
#pragma unroll 4
    for (int i = t; i < n; i += PH_THREADS) {
      tb[i] = (uint8_t)(((unsigned)word[i0 + i] >> sh) & mk);
      const float vg = grad[i0 + i];
      const float vh = hess[i0 + i];
      tg[i] = vg;
      th[i] = vh;
      if (do_sums) { sum_g += (double)vg; sum_h += (double)vh; }
    }
    __syncthreads();
    const int n4 = n & ~3;
    const unsigned* tw = reinterpret_cast<const unsigned*>(tb);
    for (int i = 0; i < n4; i += 4) {
      const unsigned m = __vcmpeq4(tw[i >> 2], pat);
      if (m) {                       // lanes i..i+3, in lane order
        if (m & 0x000000ffu) { acc_g += tg[i];     acc_h += th[i]; }
        if (m & 0x0000ff00u) { acc_g += tg[i + 1]; acc_h += th[i + 1]; }
        if (m & 0x00ff0000u) { acc_g += tg[i + 2]; acc_h += th[i + 2]; }
        if (m & 0xff000000u) { acc_g += tg[i + 3]; acc_h += th[i + 3]; }
      }
    }
    for (int i = n4; i < n; ++i) {
      if (tb[i] == t) { acc_g += tg[i]; acc_h += th[i]; }
    }
  }
  const long long cells = (long long)G * PH_BINS;
  float* o = partial + (long long)blockIdx.x * 2 * cells;
  o[g * PH_BINS + t] = acc_g;
  o[cells + g * PH_BINS + t] = acc_h;
  if (do_sums) {
    red[0][t] = sum_g;
    red[1][t] = sum_h;
    __syncthreads();
    for (int s = PH_THREADS / 2; s > 0; s >>= 1) {
      if (t < s) { red[0][t] += red[0][t + s]; red[1][t] += red[1][t + s]; }
      __syncthreads();
    }
    if (t == 0) {
      sums_partial[2 * blockIdx.x] = red[0][0];
      sums_partial[2 * blockIdx.x + 1] = red[1][0];
    }
  }
}

// out[c] = partial[0][c] + partial[1][c] + ... in block order (0 + p0 + ...,
// as the plain version's `out = out + part` loop); thread 0 of block 0 also
// adds the blocks' f64 sums in block order and rounds them to f32.
__global__ void payload_hist_reduce(const float* __restrict__ partial,
                                    int nblocks, long long cells2,
                                    float* __restrict__ out,
                                    const double* __restrict__ sums_partial,
                                    float* __restrict__ sums) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < cells2) {
    float acc = partial[c];
    for (int b = 1; b < nblocks; ++b) acc += partial[(long long)b * cells2 + c];
    out[c] = acc;
  }
  if (sums_partial != nullptr && c == 0) {
    double sg = 0.0, sh = 0.0;
    for (int b = 0; b < nblocks; ++b) {
      sg += sums_partial[2 * b];
      sh += sums_partial[2 * b + 1];
    }
    sums[0] = (float)sg;
    sums[1] = (float)sh;
  }
}

// Launches the histogram of lanes [start, start + length) on `stream`.
// `partial` is [nblocks, 2, G * 256] f32 scratch, or `out` itself when
// nblocks == 1 and no sums are asked for; `out` is [2, G * 256] f32.
// sums_partial ([nblocks, 2] f64) and sums ([2] f32) may be null.
// Returns cudaGetLastError() after the launches.
static inline int payload_hist_run(const void* pay, long long np_,
                                   const void* plan, int G, int grad_row,
                                   long long start, long long length,
                                   int nblocks, long long rows_per_block,
                                   void* partial, void* out,
                                   void* sums_partial, void* sums,
                                   cudaStream_t s) {
  dim3 grid(nblocks, G);
  payload_hist_partial<<<grid, PH_THREADS, 0, s>>>(
      static_cast<const int32_t*>(pay), np_,
      static_cast<const int32_t*>(plan), grad_row, start, length, G,
      rows_per_block, static_cast<float*>(partial),
      static_cast<double*>(sums_partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (partial == out) return 0;
  const long long cells2 = 2LL * G * PH_BINS;
  payload_hist_reduce<<<(unsigned)((cells2 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), nblocks, cells2,
      static_cast<float*>(out), static_cast<const double*>(sums_partial),
      static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
