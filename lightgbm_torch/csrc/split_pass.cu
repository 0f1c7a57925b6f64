// split_pass: the per-split partition of one leaf's payload segment from
// one payload buffer into the other, and the consolidation of the second
// buffer back into the first at the end of a tree.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_grow.py:make_split_pass
// (kernel at :315, pallas_call at :502). The TPU kernel streams the segment
// chunk by chunk, decides go_left per lane, compacts each chunk with a
// Kogge-Stone hole shift and writes the two sides back IN PLACE through a
// two-ended FIFO, so its children are not in their old order; it can also
// accumulate the smaller child's histogram in the same pass.
//
// Contract (ops/payload_kernels.py:split_pass_plain, bit for bit on the
// CPU; the stable order of lightgbm_tpu/ops/grow_persist.py:
// make_xla_split_pass:398):
//   scalars S[15] in the S_* slots of pallas_grow.py:83-98. Lanes
//   [s0, s0 + n_l) with s0 = S[S_S0], n_l = S[S_NL] form the leaf's segment.
//   go_left per lane is DenseBin::Split at the bin level (split_common.cuh).
//   Rows 0 .. wp_live - 1 of the segment are read from `src` and written to
//   `dst` at the same lanes, partitioned STABLY: the left lanes first, then
//   the right ones, each side in its old order. `src` is not written; rows
//   wp_live .. of `dst` and every lane of `dst` outside the segment are left
//   untouched. n_left is written to device memory. The smaller child's
//   histogram, where the grower asks for it (G <= 20), is
//   payload_ordered.cuh's counting sort over the child in `dst`
//   (split_pass_hist_launch), seg_hist.cu's routine.
//
// The two buffers are the grower's (ops/grow_persist.py): buffer 0 is the
// payload, buffer 1 a second int32 matrix of wp_live rows with the same
// lane stride. A leaf at depth d has been partitioned d times, so its
// segment lives in buffer d % 2; a split reads its leaf's buffer and writes
// both children to the other one. At the end of a tree one consolidate
// launch copies every odd-depth leaf's segment from buffer 1 back into
// buffer 0, so the payload is leaf-partitioned as a single in-place
// partition would leave it.
//
// What bounds it on an H100: bytes. The segment's wp_live rows are read
// once and written once: 2 * wp_live * n_l * 4 bytes, about 0.30 ms for a
// 10.5M-lane root split of the HIGGS payload (wp_live = 12) at 3.35 TB/s.
// The consolidation moves the same bytes for the odd-depth leaves' lanes,
// at most the whole payload's wp_live rows once per tree.
//
// Design: three launches, no atomics, deterministic. (1) one block per tile
// of 1024 lanes counts its left lanes (warp ballot + popc), reading only
// the split feature's word row; (2) one block scans the tile counts into
// tile offsets and n_left; (3) each lane finds its destination from its
// tile's offset and its rank inside the tile (ballot prefix) and copies its
// wp_live words from `src` straight to `dst`. Each word is read once and
// written once, and the other buffer takes the place of a scratch copy.
// The consolidation is a copy over a segment table: one block per
// 1024-lane tile of a segment, each thread four lanes of every row.
#include "payload_ordered.cuh"
#include "split_common.cuh"

struct SplitScalars {
  int s[N_SCALARS];
};

__global__ void __launch_bounds__(SP_TILE)
split_count(const int32_t* __restrict__ src, long long np_, SplitScalars S,
            int* __restrict__ tile_left) {
  __shared__ int wc[SP_WARPS];
  const long long i = (long long)blockIdx.x * SP_TILE + threadIdx.x;
  bool gl = false;
  if (i < S.s[S_NL])
    gl = sp_go_left(src[(long long)S.s[S_WG] * np_ + S.s[S_S0] + i], S.s);
  const unsigned bal = __ballot_sync(0xffffffffu, gl);
  if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = __popc(bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < SP_WARPS; ++w) c += wc[w];
    tile_left[blockIdx.x] = c;
  }
}

// Exclusive scan of the tile counts in one block, 1024 tiles per step.
__global__ void __launch_bounds__(SP_TILE)
split_scan(const int* __restrict__ tile_left, int ntiles,
           int* __restrict__ tile_off, int* __restrict__ n_left) {
  __shared__ int ws[SP_WARPS];
  __shared__ int carry_s;
  const int total = sp_scan_tiles(tile_left, ntiles, tile_off, ws, &carry_s);
  if (threadIdx.x == 0) *n_left = total;
}

__global__ void __launch_bounds__(SP_TILE)
split_scatter(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
              long long np_, int wp_live, SplitScalars S,
              const int* __restrict__ tile_off,
              const int* __restrict__ n_left) {
  __shared__ int wl[SP_WARPS];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * SP_TILE;
  const long long i = base + t;
  const bool valid = i < S.s[S_NL];
  const long long s0 = S.s[S_S0];
  bool gl = false;
  if (valid) gl = sp_go_left(src[(long long)S.s[S_WG] * np_ + s0 + i], S.s);
  const long long d = sp_destination(gl, wl, tile_off[blockIdx.x], base,
                                     *n_left);
  if (!valid) return;
  for (int r = 0; r < wp_live; ++r)
    dst[(long long)r * np_ + s0 + d] = src[(long long)r * np_ + s0 + i];
}

// Partitions the segment of `scal` (host int[15], the S_* slots) from `src`
// into `dst` on `stream`. tile_left and tile_off are int[ceil(n_l / 1024)]
// scratch, n_left an int on the device. n_l must be positive. Returns the
// first CUDA error of the launches, or 0.
extern "C" int split_pass_launch(const void* src, void* dst, long long np_,
                                 int wp_live, const int* scal,
                                 void* tile_left, void* tile_off,
                                 void* n_left, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  SplitScalars S;
  for (int k = 0; k < N_SCALARS; ++k) S.s[k] = scal[k];
  const int ntiles = (int)(((long long)S.s[S_NL] + SP_TILE - 1) / SP_TILE);
  const int32_t* p = static_cast<const int32_t*>(src);
  split_count<<<ntiles, SP_TILE, 0, s>>>(p, np_, S,
                                         static_cast<int*>(tile_left));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_scan<<<1, SP_TILE, 0, s>>>(static_cast<const int*>(tile_left), ntiles,
                                   static_cast<int*>(tile_off),
                                   static_cast<int*>(n_left));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_scatter<<<ntiles, SP_TILE, 0, s>>>(
      p, static_cast<int32_t*>(dst), np_, wp_live, S,
      static_cast<const int*>(tile_off), static_cast<const int*>(n_left));
  return (int)cudaGetLastError();
}

// ---- the smaller child's histogram --------------------------------------

struct SplitPassHist {};   // the partial kernel's caller tag

// The smaller child's histogram after the partition (the grower's G <= 20
// branch): payload_ordered.cuh's partial kernel over lanes [start, start +
// length) of `pay` (the partition's dst), as seg_hist_launch runs it.
extern "C" int split_pass_hist_launch(const void* pay, long long np_,
                                      const void* plan, int G, int grad_row,
                                      long long start, long long length,
                                      int nblocks, long long rows_per_block,
                                      void* partial, void* out,
                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = payload_ordered_run<SplitPassHist>(
      pay, np_, plan, G, grad_row, start, length, rows_per_block, nullptr,
      nullptr, nblocks, partial, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  if (partial == out) return 0;
  return payload_hist_finish(partial, nblocks, G, out, nullptr, nullptr, s);
}

// The ownership routine of payload_hist.cuh over the same lanes: not on the
// grower's path; chip_smoke.py and the card tests hold the counting-sort
// histograms against it, an independent implementation of their contract.
extern "C" int ownership_hist_launch(const void* pay, long long np_,
                                     const void* plan, int G, int grad_row,
                                     long long start, long long length,
                                     int nblocks, long long rows_per_block,
                                     void* partial, void* out,
                                     void* stream) {
  return payload_hist_run(pay, np_, plan, G, grad_row, start, length,
                          nblocks, rows_per_block, partial, out,
                          reinterpret_cast<cudaStream_t>(stream));
}

// ---- consolidation --------------------------------------------------------

#define CS_THREADS 256
#define CS_LANES 4                       // lanes per thread and row
#define CS_TILE (CS_THREADS * CS_LANES)  // lanes per block
// segment table, int64 [K, CS_TAB]
#define CS_TAB 3
enum { CS_START = 0, CS_LEN, CS_TILE0 };

// Block b copies tile (b - first tile of its segment) of its segment, rows
// 0 .. wp_live - 1, from src to dst; thread t takes lanes t, t + 256, ...
// of the tile, so each warp's loads and stores are coalesced.
__global__ void __launch_bounds__(CS_THREADS)
consolidate_copy(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                 long long np_, int wp_live,
                 const long long* __restrict__ seg,
                 const int* __restrict__ slot_of_tile) {
  const long long* sj = seg + (long long)slot_of_tile[blockIdx.x] * CS_TAB;
  const long long i0 = (blockIdx.x - sj[CS_TILE0]) * CS_TILE + threadIdx.x;
  const long long len = sj[CS_LEN];
  const long long lane0 = sj[CS_START] + i0;
  for (int r = 0; r < wp_live; ++r) {
    const long long row = (long long)r * np_ + lane0;
    int32_t v[CS_LANES];
#pragma unroll
    for (int k = 0; k < CS_LANES; ++k)
      if (i0 + k * CS_THREADS < len) v[k] = src[row + k * CS_THREADS];
#pragma unroll
    for (int k = 0; k < CS_LANES; ++k)
      if (i0 + k * CS_THREADS < len) dst[row + k * CS_THREADS] = v[k];
  }
}

// Copies rows 0 .. wp_live - 1 of K segments from src to dst on `stream`.
// seg is the device int64 [K, 3] table (start lane, length, first tile of
// CS_TILE lanes), slot_of_tile int[ntiles] the segment of each tile. The
// segments are disjoint. Returns the CUDA error of the launch, or 0.
extern "C" int consolidate_launch(const void* src, void* dst, long long np_,
                                  int wp_live, const void* seg,
                                  const void* slot_of_tile, int ntiles,
                                  void* stream) {
  if (ntiles == 0) return 0;
  consolidate_copy<<<ntiles, CS_THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), np_,
      wp_live, static_cast<const long long*>(seg),
      static_cast<const int*>(slot_of_tile));
  return (int)cudaGetLastError();
}
