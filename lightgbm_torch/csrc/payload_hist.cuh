// payload_hist.cuh: the contract of the payload histograms, the segment
// table of the many-segment form and the reduces that add row blocks in
// order (every payload histogram kernel), and the ownership routine, which
// is now the witness only. Every payload histogram on the grower's path
// (root_hist.cu, seg_hist.cu, level_seg_hist.cu and the in-pass histograms
// of split_pass.cu and level_pass.cu) builds its partials with
// payload_ordered.cuh (ordered_hist.cuh's counting sort). The ownership
// routine runs only through ownership_hist_launch (split_pass.cu) and
// ownership_multi_launch (level_pass.cu), which chip_smoke.py and
// tests/test_torch_hist_cuda.py hold the counting-sort kernels against.
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
//   Optionally the f64 sums of grad and hess over the lanes, rounded to
//   f32 at the end (payload_hist_reduce adds root_hist's).
//
// The ownership routine (payload_hist_rows): block (row block, g) gives
// each of its 256 threads one bin of group g; the block stages a tile of
// decoded bin bytes and the grad/hess of each lane in shared memory, and
// every thread reads the tile four lanes to a 32-bit word and compares
// them with its bin at once (__vcmpeq4), adding the matching lanes' values
// in lane order. It gives the same bits as payload_ordered.cuh, by another
// route (chip_smoke.py holds the two equal). No atomics: two launches give
// bit-identical results.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PH_THREADS 256
#define PH_BINS 256
#define PH_TILE 4096

// Thread t's sums (bin t of group g) over lanes [lo, hi), staged tile by
// tile through the block's shared buffers. The caller syncs before it
// reuses the buffers.
static __device__ __forceinline__ void payload_hist_rows(
    const int32_t* __restrict__ pay, long long np_,
    const int32_t* __restrict__ plan, int grad_row, int g, long long lo,
    long long hi, uint8_t* tb, float* tg, float* th, float& acc_g,
    float& acc_h) {
  const int t = threadIdx.x;
  const int32_t* word = pay + (long long)plan[3 * g] * np_;
  const unsigned sh = (unsigned)plan[3 * g + 1];
  const unsigned mk = (unsigned)plan[3 * g + 2];
  const float* grad = reinterpret_cast<const float*>(pay + grad_row * np_);
  const float* hess = grad + np_;
  const unsigned pat = (unsigned)t * 0x01010101u;
  for (long long i0 = lo; i0 < hi; i0 += PH_TILE) {
    const int n = (int)min((long long)PH_TILE, hi - i0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int i = t; i < n; i += PH_THREADS) {
      tb[i] = (uint8_t)(((unsigned)word[i0 + i] >> sh) & mk);
      tg[i] = grad[i0 + i];
      th[i] = hess[i0 + i];
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
}

__global__ void __launch_bounds__(PH_THREADS)
payload_hist_partial(const int32_t* __restrict__ pay, long long np_,
                     const int32_t* __restrict__ plan, int grad_row,
                     long long start, long long length, int G,
                     long long rows_per_block, float* __restrict__ partial) {
  __shared__ __align__(16) uint8_t tb[PH_TILE];
  __shared__ float tg[PH_TILE];
  __shared__ float th[PH_TILE];
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(length, r_begin + rows_per_block);
  float acc_g = 0.f, acc_h = 0.f;
  payload_hist_rows(pay, np_, plan, grad_row, g, start + r_begin,
                    start + r_end, tb, tg, th, acc_g, acc_h);
  const long long cells = (long long)G * PH_BINS;
  float* o = partial + (long long)blockIdx.x * 2 * cells;
  o[g * PH_BINS + t] = acc_g;
  o[cells + g * PH_BINS + t] = acc_h;
}

// out[c] = partial[0][c] + partial[1][c] + ... in block order (0 + p0 + ...,
// as the plain version's `out = out + part` loop); with sums_partial
// (root_hist.cu), thread 0 of block 0 also adds the blocks' f64 sums in
// block order and rounds them to f32.
__global__ void payload_hist_reduce(const float* __restrict__ partial,
                                    int nblocks, long long cells2,
                                    float* __restrict__ out,
                                    const double* __restrict__ sums_partial,
                                    float* __restrict__ sums,
                                    long long* counter) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (counter != nullptr && c == 0) *counter += 1;
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

// Queue the reduce of nblocks [2, G * 256] partials into out on `s`, and
// of the f64 sums where sums_partial is not null; counter (may be NULL) is
// incremented once.
static inline int payload_hist_finish(const void* partial, int nblocks,
                                      int G, void* out,
                                      const void* sums_partial, void* sums,
                                      cudaStream_t s,
                                      void* counter = nullptr) {
  const long long cells2 = 2LL * G * PH_BINS;
  payload_hist_reduce<<<(unsigned)((cells2 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), nblocks, cells2,
      static_cast<float*>(out), static_cast<const double*>(sums_partial),
      static_cast<float*>(sums), static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}

// Launches the histogram of lanes [start, start + length) on `stream`.
// `partial` is [nblocks, 2, G * 256] f32 scratch, or `out` itself when
// nblocks == 1; `out` is [2, G * 256] f32. Returns cudaGetLastError()
// after the launches.
static inline int payload_hist_run(const void* pay, long long np_,
                                   const void* plan, int G, int grad_row,
                                   long long start, long long length,
                                   int nblocks, long long rows_per_block,
                                   void* partial, void* out,
                                   cudaStream_t s) {
  dim3 grid(nblocks, G);
  payload_hist_partial<<<grid, PH_THREADS, 0, s>>>(
      static_cast<const int32_t*>(pay), np_,
      static_cast<const int32_t*>(plan), grad_row, start, length, G,
      rows_per_block, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (partial == out) return 0;
  return payload_hist_finish(partial, nblocks, G, out, nullptr, nullptr, s);
}

// ---- many segments in one launch (the table and the reduce:
// level_seg_hist.cu and level_pass.cu; the partial kernel: the witness) -----
//
// seg is [S, PH_SEG] int64 per segment: start lane, length, rows per block
// and block count (ops/histogram.py:row_blocks of the length, so each
// segment is cut as seg_hist cuts it) and the index of its first block in
// the flat block grid; slot_of_block maps each block of that grid to its
// segment. Each segment's histogram is then seg_hist's, bit for bit: the
// same row blocks, the same chains, the blocks added in order.
#define PH_SEG 5
enum { PH_START = 0, PH_LEN, PH_ROWS, PH_NBLK, PH_BASE };

__global__ void __launch_bounds__(PH_THREADS)
payload_hist_multi_partial(const int32_t* __restrict__ pay, long long np_,
                           const int32_t* __restrict__ plan, int grad_row,
                           int G, const long long* __restrict__ seg,
                           const int* __restrict__ slot_of_block,
                           float* __restrict__ partial) {
  __shared__ __align__(16) uint8_t tb[PH_TILE];
  __shared__ float tg[PH_TILE];
  __shared__ float th[PH_TILE];
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const long long* sj = seg + (long long)slot_of_block[blockIdx.x] * PH_SEG;
  const long long b = blockIdx.x - sj[PH_BASE];
  const long long r_begin = b * sj[PH_ROWS];
  const long long r_end = min(sj[PH_LEN], r_begin + sj[PH_ROWS]);
  float acc_g = 0.f, acc_h = 0.f;
  payload_hist_rows(pay, np_, plan, grad_row, g, sj[PH_START] + r_begin,
                    sj[PH_START] + r_end, tb, tg, th, acc_g, acc_h);
  const long long cells = (long long)G * PH_BINS;
  float* o = partial + (long long)blockIdx.x * 2 * cells;
  o[g * PH_BINS + t] = acc_g;
  o[cells + g * PH_BINS + t] = acc_h;
}

// out[k][j][c] = partial[base_j][k][c] + partial[base_j + 1][k][c] + ...
// in block order (k = 0 grad, 1 hess); grid (cells / 256, S, 2).
__global__ void payload_hist_multi_reduce(const float* __restrict__ partial,
                                          const long long* __restrict__ seg,
                                          int S, long long cells,
                                          float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (c >= cells) return;
  const long long* sj = seg + (long long)j * PH_SEG;
  const float* p = partial + (sj[PH_BASE] * 2 + k) * cells + c;
  float acc = p[0];
  for (long long b = 1; b < sj[PH_NBLK]; ++b) acc += p[b * 2 * cells];
  out[((long long)k * S + j) * cells + c] = acc;
}

// Queue the reduce of the segments' partials ([nblocks, 2, G * 256], each
// segment's from its first block on) into out [2, S, G * 256] on `s`.
static inline int payload_hist_multi_finish(const void* partial,
                                            const void* seg, int S, int G,
                                            void* out, cudaStream_t s) {
  const long long cells = (long long)G * PH_BINS;
  dim3 rgrid((unsigned)((cells + 255) / 256), S, 2);
  payload_hist_multi_reduce<<<rgrid, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const long long*>(seg),
      S, cells, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Launches the histograms of S segments on `stream` (seg and slot_of_block
// on the device, nblocks = the sum of the segments' block counts, each at
// least 1). partial is [nblocks, 2, G * 256] f32 scratch, out
// [2, S, G * 256] f32. Returns cudaGetLastError() after the launches.
static inline int payload_hist_multi_run(const void* pay, long long np_,
                                         const void* plan, int G,
                                         int grad_row, const void* seg,
                                         int S, const void* slot_of_block,
                                         int nblocks, void* partial,
                                         void* out, cudaStream_t s) {
  dim3 grid(nblocks, G);
  payload_hist_multi_partial<<<grid, PH_THREADS, 0, s>>>(
      static_cast<const int32_t*>(pay), np_,
      static_cast<const int32_t*>(plan), grad_row, G,
      static_cast<const long long*>(seg),
      static_cast<const int*>(slot_of_block), static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return payload_hist_multi_finish(partial, seg, S, G, out, s);
}
