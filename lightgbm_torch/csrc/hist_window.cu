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
// Design: the per-tile stable counting sort of ordered_hist.cuh. Block
// (chunk, row block) covers K consecutive groups of one row block
// (oh_groups_per_block: 5 at HIGGS's 28 groups and 19 row blocks), one
// 128-thread team per group; the chunk index is the grid's fastest
// dimension, so the blocks that read the same rows run together and all
// but the first find them in L2. Per tile (up to 1024 rows, and at most
// HW_SLAB bytes of them) the block copies the rows' contiguous [rows, G]
// slab with 16-byte cp.async into shared memory, with the rows' grad/hess
// once for its K groups, into the other of two buffers while the current
// tile is sorted; each team reads its group's bytes out of the slab, sorts
// the rows by bin and walks the chains. Rows wider than
// HW_SLAB / 128 groups are staged a byte per row and group instead. A
// second kernel adds the row blocks' partial histograms in block order.
// The slab copy reads whole 16-byte words: up to 15 bytes before the
// first row and after the last, inside the same aligned word of the
// tensor's allocation (the CUDA allocators align and round allocations to
// far more than 16 bytes).
//
// What bounds it on an H100: at the byte bound each row is read once,
// length * (G + 8) bytes, about 0.11 ms for the 10.5M-row x 28-group root
// at 3.35 TB/s. This design reads each row from device memory about once,
// but each of the G / K blocks of a row block reads the whole row from L2
// (the slab's sectors hold every group), and the rank-and-scatter work is
// a few dozen instructions per row and group. With bins spread over the
// width it is bound by those instructions and the L2 reads, not by the
// chains; where most rows of a tile share one bin, that bin's serial chain
// bounds the tile (ordered_hist.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_hist.cuh"

#define HW_SLAB 28672          // bytes of bins a tile stages: 1024 rows x 28

// One staging buffer: a tile's (grad, hess) and bin bytes (the slab, from
// byte `off` on; or, for wide rows, each group's bytes at [tm * OH_TILE]).
struct HwStage {
  float2 v[OH_TILE];
  uint8_t b[HW_SLAB + 32];
};

// Rows per tile: a slab of at most HW_SLAB bytes, or OH_TILE wide rows.
static __device__ __host__ __forceinline__ int hw_tile_rows(int G,
                                                           bool wide) {
  return wide || HW_SLAB / G > OH_TILE ? OH_TILE : HW_SLAB / G;
}

// Stage rows [r0, r0 + n) into `st`: grad/hess by cp.async; the slab by
// 16-byte cp.async, returning its offset in st.b; or, for wide rows, the
// block's groups' bytes with plain loads (returns 0).
template <bool WIDE, int K>
static __device__ __forceinline__ int hw_stage(
    HwStage& st, const uint8_t* __restrict__ bins, const float* grad,
    const float* hess, long long r0, int n, int G, int g0) {
  const int t = threadIdx.x;
  for (int i = t; i < n; i += K * OH_TEAM) {
    oh_copy4(&st.v[i].x, grad + r0 + i);
    oh_copy4(&st.v[i].y, hess + r0 + i);
  }
  if (WIDE) {
    for (int tm = 0; tm < K && g0 + tm < G; ++tm)
      for (int i = t; i < n; i += K * OH_TEAM)
        st.b[tm * OH_TILE + i] = bins[(r0 + i) * (long long)G + g0 + tm];
    return 0;
  }
  const uint8_t* src = bins + r0 * (long long)G;
  const int off = (int)((uintptr_t)src & 15);
  const uint8_t* a0 = src - off;
  const int chunks = (off + n * G + 15) >> 4;
  for (int c = t; c < chunks; c += K * OH_TEAM)
    oh_copy16(st.b + 16 * c, a0 + 16 * c);
  return off;
}

template <bool WIDE, int K>
__global__ void __launch_bounds__(K * OH_TEAM)
hist_window_partial(const uint8_t* __restrict__ bins,
                    const float* __restrict__ grad,
                    const float* __restrict__ hess, long long start,
                    long long length, int G, int W,
                    long long rows_per_block, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  OhShared<K>& s = *reinterpret_cast<OhShared<K>*>(smem);
  HwStage* stage = reinterpret_cast<HwStage*>(smem + sizeof(OhShared<K>));
  const int t = threadIdx.x;
  const int team = t / OH_TEAM;
  const int g0 = blockIdx.x * K;
  const int g = g0 + team;
  const int T = hw_tile_rows(G, WIDE);
  const int nbits = 32 - __clz(W - 1);       // bits of the bins below W
  const long long r_begin = (long long)blockIdx.y * rows_per_block;
  const long long r_end = min(length, r_begin + rows_per_block);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  oh_begin(s);
  int off = 0;                         // the current tile's slab offset
  if (r_begin < r_end)
    off = hw_stage<WIDE, K>(stage[0], bins, grad, hess, start + r_begin,
                            (int)min((long long)T, r_end - r_begin), G, g0);
  oh_commit();
  int k = 0;
  for (long long t0 = r_begin; t0 < r_end; t0 += T, ++k) {
    int off_next = 0;
    if (t0 + T < r_end)
      off_next = hw_stage<WIDE, K>(stage[(k + 1) & 1], bins, grad, hess,
                                   start + t0 + T,
                                   (int)min((long long)T, r_end - t0 - T),
                                   G, g0);
    oh_commit();
    oh_wait(1);                        // this tile's copies have landed
    __syncthreads();
    const HwStage& st = stage[k & 1];
    const int n = (int)min((long long)T, r_end - t0);
    const uint8_t* tb = WIDE ? st.b + team * OH_TILE : st.b + off + g;
    const int stride = WIDE ? 1 : G;
    oh_tile(s, st.v, n, W, nbits, g < G,
            [=](int i) { return (unsigned)tb[i * stride]; }, acc);
    off = off_next;
  }
  oh_wait(0);
  if (g < G) {
    float* o = partial + ((size_t)blockIdx.y * G + g) * W * 2;
    const int b0 = oh_bin0(team, t % OH_TEAM);
    if (b0 < W) { o[2 * b0] = acc[0]; o[2 * b0 + 1] = acc[1]; }
    if (b0 + 1 < W) { o[2 * b0 + 2] = acc[2]; o[2 * b0 + 3] = acc[3]; }
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

// Launch the partial kernel with K groups per block (grid: K-group chunk
// fastest, then the row block).
template <bool WIDE, int K>
static cudaError_t hw_partial(const uint8_t* bins, const float* grad,
                              const float* hess, long long start,
                              long long length, int G, int W, int nblocks,
                              long long rows_per_block, float* partial,
                              cudaStream_t s) {
  const size_t smem = sizeof(OhShared<K>) + 2 * sizeof(HwStage);
  cudaError_t err =
      oh_smem((const void*)hist_window_partial<WIDE, K>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G + K - 1) / K, nblocks);
  hist_window_partial<WIDE, K><<<grid, K * OH_TEAM, smem, s>>>(
      bins, grad, hess, start, length, G, W, rows_per_block, partial);
  return cudaGetLastError();
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
  const bool wide = hw_tile_rows(G, false) < 128;
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  const float* gr = static_cast<const float*>(grad);
  const float* he = static_cast<const float*>(hess);
  float* p = static_cast<float*>(partial);
  cudaError_t err =
      oh_with_groups(oh_groups_per_block(G, nblocks), [&](auto k) {
        constexpr int K = decltype(k)::value;
        return wide ? hw_partial<true, K>(b, gr, he, start, length, G, W,
                                          nblocks, rows_per_block, p, s)
                    : hw_partial<false, K>(b, gr, he, start, length, G, W,
                                           nblocks, rows_per_block, p, s);
      });
  if (err != cudaSuccess || nblocks == 1) return (int)err;
  const int cells = G * W * 2;
  hist_window_reduce<<<(cells + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), nblocks, cells,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
