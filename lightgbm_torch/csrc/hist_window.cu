// hist_window: (grad, hess) histogram of one contiguous row segment.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py:hist_window
// (_hist_kernel / _hist_kernel_radix), which builds one-hot tiles in VMEM
// and contracts them on the MXU with a bf16 hi/lo split of the values.
//
// Contract (the port's ops/histogram.py:hist_window_plain is the same
// function in plain PyTorch, bit for bit on the CPU):
//   bins  [N, G] uint8, row-major: group-local bin of every row (the
//         grower's partitioned payload; a leaf is a contiguous segment)
//   grad, hess [N] f32
//   rows [start, start + length) are histogrammed, cut into row blocks of
//         rows_per_block rows (the last one shorter); the cut depends on
//         the segment length only (ops/histogram.py:row_blocks)
//   out   [G, W, 2] f32, out[g, b] = sum over the segment's rows r with
//         bins[r, g] == b of (grad[r], hess[r]); bins >= W are ignored.
// Summation order: within a row block each bin is one f32 chain,
// 0 + v[r1] + v[r2] + ... in row order; the row blocks' sums are then
// added in block order. Two launches on the same input give bit-identical
// results, and the card grows the same trees as the CPU.
//
// What bounds it on an H100: bytes. Each row is read once, G bytes of bins
// plus 8 bytes of grad/hess: length * (G + 8) bytes, about 0.11 ms for the
// 10.5M-row x 28-group root at 3.35 TB/s. The work per byte is a compare
// and an add, far below the card's arithmetic rate.
//
// Design. The TPU's one-hot contraction is re-expressed as ownership, with
// no atomics: block (row block, g) gives each of its 256 threads one bin
// of group g. The block stages its rows tile by tile (group g's bin byte
// and the grad/hess of each row) in shared memory; every thread then reads
// the tile's bin bytes four rows to a 32-bit word (a broadcast read) and
// compares all four with its bin at once (__vcmpeq4), adding the values
// of the rows that match, in row order, to its two registers. A second
// kernel adds the row blocks' partial histograms in block order. The cost
// is that every thread of a group reads every row of its block: the
// compare work is W times the rows, four per instruction.
#include <cuda_runtime.h>
#include <stdint.h>

#define HW_THREADS 256
#define HW_TILE 4096

__global__ void __launch_bounds__(HW_THREADS)
hist_window_partial(const uint8_t* __restrict__ bins,
                    const float* __restrict__ grad,
                    const float* __restrict__ hess, long long start,
                    long long length, int G, int W,
                    long long rows_per_block, float* __restrict__ partial) {
  __shared__ __align__(16) uint8_t tb[HW_TILE];
  __shared__ float tg[HW_TILE];
  __shared__ float th[HW_TILE];
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(length, r_begin + rows_per_block);
  const unsigned pat = (unsigned)t * 0x01010101u;
  float acc_g = 0.f, acc_h = 0.f;

  for (long long t0 = r_begin; t0 < r_end; t0 += HW_TILE) {
    const int n = (int)min((long long)HW_TILE, r_end - t0);
    __syncthreads();  // the previous tile is consumed
    const long long r0 = start + t0;
#pragma unroll 4
    for (int i = t; i < n; i += HW_THREADS) {
      tb[i] = bins[(r0 + i) * (long long)G + g];
      tg[i] = grad[r0 + i];
      th[i] = hess[r0 + i];
    }
    __syncthreads();
    if (t < W) {
      const int n4 = n & ~3;
      const unsigned* tw = reinterpret_cast<const unsigned*>(tb);
      for (int i = 0; i < n4; i += 4) {
        const unsigned m = __vcmpeq4(tw[i >> 2], pat);
        if (m) {                       // rows i..i+3, in row order
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
  if (t < W) {
    float* o = partial + ((size_t)blockIdx.x * G + g) * W * 2;
    o[2 * t] = acc_g;
    o[2 * t + 1] = acc_h;
  }
}

__global__ void hist_window_reduce(const float* __restrict__ partial,
                                   int nblocks, int cells,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b) acc += partial[(size_t)b * cells + i];
  out[i] = acc;
}

// Launches the histogram of rows [start, start + length) on `stream`.
// `partial` is [nblocks, G, W, 2] scratch, or `out` itself when
// nblocks == 1. Returns cudaGetLastError() after the launches.
extern "C" int hist_window_launch(const void* bins, const void* grad,
                                  const void* hess, long long start,
                                  long long length, int G, int W,
                                  int nblocks, long long rows_per_block,
                                  void* partial, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(nblocks, G);
  hist_window_partial<<<grid, HW_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), start, length, G, W, rows_per_block,
      static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblocks == 1) return (int)err;
  const int cells = G * W * 2;
  hist_window_reduce<<<(cells + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), nblocks, cells,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
