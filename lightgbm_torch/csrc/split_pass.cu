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
//   scalars S[15] in the S_* slots of pallas_grow.py:83-98, in device
//   memory. Lanes [s0, s0 + n_l) with s0 = S[S_S0], n_l = S[S_NL] form the
//   leaf's segment.
//   go_left per lane is DenseBin::Split at the bin level (split_common.cuh).
//   Rows 0 .. wp_live - 1 of the segment are read from `src` and written to
//   `dst` at the same lanes, partitioned STABLY: the left lanes first, then
//   the right ones, each side in its old order. `src` is not written; rows
//   wp_live .. of `dst` and every lane of `dst` outside the segment are left
//   untouched. n_left and the smaller child's (start, length) are written
//   to device memory; with the done flag set nothing is written. A parity
//   flag in device memory exchanges the roles of the two buffers. The
//   smaller child's
//   histogram, where the grower asks for it (G <= 20), is
//   payload_ordered.cuh's counting sort over the child in `dst`
//   (split_pass_hist_launch), seg_hist.cu's routine.
//
// The two buffers are the grower's (ops/grow_persist.py): buffer 0 is the
// payload, buffer 1 a second int32 matrix of wp_live rows with the same lane
// stride. A leaf at depth d has been partitioned d times, so its segment lives
// in buffer d % 2; a split reads its leaf's buffer and writes both children to
// the other one (the grower passes buffer 0 as src and the leaf's depth parity
// as the swap flag, both known only on the card). At the end of a tree one
// consolidate launch copies every odd-depth leaf's segment from buffer 1 back
// into buffer 0, so the payload is leaf-partitioned as a single in-place
// partition would leave it.
//
// What bounds it on an H100: bytes. The segment's wp_live rows are read
// once and written once: 2 * wp_live * n_l * 4 bytes, about 0.30 ms for a
// 10.5M-lane root split of the HIGGS payload (wp_live = 12) at 3.35 TB/s.
// The consolidation moves the same bytes for the odd-depth leaves' lanes,
// at most the whole payload's wp_live rows once per tree.
//
// Design: three launches, no atomics, deterministic. The 15 scalars, the
// segment and a "done" flag are read from device memory (the counterpart of
// the TPU kernel's scalar prefetch), so the grid cannot come from the
// segment's length: every launch has a fixed grid, and the blocks find
// their work from the device length. (1) a persistent grid (at most two
// blocks of 1024 threads per multiprocessor) walks the segment's tiles of
// 1024 lanes, each block counting one tile's left lanes at a time (warp
// ballot + popc), reading only the split feature's word row; (2) one block
// scans the tile counts into tile offsets and writes n_left and the
// smaller child's (start, length) to device memory; (3) the persistent
// grid walks the tiles again, each lane finding its destination from its
// tile's offset and its rank inside the tile (ballot prefix) and copying
// its wp_live words from `src` straight to `dst`. Each word is read once
// and written once, and the other buffer takes the place of a scratch
// copy. With the done flag set, every launch returns at once and nothing
// is written: the grower's steps after its tree has stopped growing are
// no-ops. The destinations are those of a one-block-per-tile grid, so the
// partition is the same stable one. The consolidation is a copy over a
// segment table: the persistent grid walks each segment's 1024-lane tiles,
// each thread four lanes of every row.
#include "payload_ordered.cuh"
#include "split_common.cuh"

// The scalars of the split in shared memory, or false when the grower's
// done flag is set (the whole block returns).
static __device__ __forceinline__ bool sp_load(const int* __restrict__ scal,
                                               const long long* done,
                                               int* S) {
  if (done != nullptr && *done != 0) return false;
  if (threadIdx.x < N_SCALARS) S[threadIdx.x] = scal[threadIdx.x];
  __syncthreads();
  return true;
}

__global__ void __launch_bounds__(SP_TILE)
split_count(const int32_t* src, const int32_t* dst, long long np_,
            const int* __restrict__ scal, const long long* done,
            const long long* swap, int* __restrict__ tile_left) {
  __shared__ int S[N_SCALARS];
  __shared__ int wc[SP_WARPS];
  if (!sp_load(scal, done, S)) return;
  if (swap != nullptr && *swap != 0) src = dst;
  const long long nl = S[S_NL];
  const long long ntiles = (nl + SP_TILE - 1) / SP_TILE;
  const int32_t* word = src + (long long)S[S_WG] * np_ + S[S_S0];
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long i = tile * SP_TILE + threadIdx.x;
    const bool gl = i < nl && sp_go_left(word[i], S);
    const unsigned bal = __ballot_sync(0xffffffffu, gl);
    if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = __popc(bal);
    __syncthreads();
    if (threadIdx.x == 0) {
      int c = 0;
      for (int w = 0; w < SP_WARPS; ++w) c += wc[w];
      tile_left[tile] = c;
    }
    __syncthreads();
  }
}

// Exclusive scan of the tile counts in one block, 1024 tiles per step;
// writes res = (n_left, the smaller child's start, its length) and counts
// the launch.
__global__ void __launch_bounds__(SP_TILE)
split_scan(const int* __restrict__ scal, const long long* done,
           const int* __restrict__ tile_left, int* __restrict__ tile_off,
           long long* __restrict__ res, long long* counter) {
  __shared__ int S[N_SCALARS];
  __shared__ int ws[SP_WARPS];
  __shared__ int carry_s;
  if (!sp_load(scal, done, S)) return;
  const int ntiles = (S[S_NL] + SP_TILE - 1) / SP_TILE;
  const int total = sp_scan_tiles(tile_left, ntiles, tile_off, ws, &carry_s);
  if (threadIdx.x == 0) {
    const bool small_l = S[S_SMALL_L] > 0;
    res[0] = total;
    res[1] = small_l ? S[S_S0] : (long long)S[S_S0] + total;
    res[2] = small_l ? total : (long long)S[S_NL] - total;
    if (counter != nullptr) *counter += 1;
  }
}

__global__ void __launch_bounds__(SP_TILE)
split_scatter(const int32_t* src_, int32_t* dst_, long long np_,
              int wp_live, const int* __restrict__ scal,
              const long long* done, const long long* swap,
              const int* __restrict__ tile_off,
              const long long* __restrict__ res) {
  __shared__ int S[N_SCALARS];
  __shared__ int wl[SP_WARPS];
  if (!sp_load(scal, done, S)) return;
  const bool sw = swap != nullptr && *swap != 0;
  const int32_t* __restrict__ src = sw ? dst_ : src_;
  int32_t* __restrict__ dst = sw ? const_cast<int32_t*>(src_) : dst_;
  const int t = threadIdx.x;
  const long long nl = S[S_NL];
  const long long ntiles = (nl + SP_TILE - 1) / SP_TILE;
  const long long s0 = S[S_S0];
  const long long n_left = res[0];
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long base = tile * SP_TILE;
    const long long i = base + t;
    const bool valid = i < nl;
    bool gl = false;
    if (valid) gl = sp_go_left(src[(long long)S[S_WG] * np_ + s0 + i], S);
    const long long d = sp_destination(gl, wl, tile_off[tile], base, n_left);
    if (valid)
      for (int r = 0; r < wp_live; ++r)
        dst[(long long)r * np_ + s0 + d] = src[(long long)r * np_ + s0 + i];
    __syncthreads();                   // wl is reused by the next tile
  }
}

// Blocks of the persistent grids: two blocks of 1024 threads per
// multiprocessor, at most one per tile of the longest segment.
static int sp_grid(long long max_tiles) {
  const long long g = 2LL * oh_multiprocessors();
  return (int)(max_tiles < g ? (max_tiles < 1 ? 1 : max_tiles) : g);
}

// Partitions the segment of the device scalars `scal` (int[15], the S_* slots)
// from `src` into `dst` on `stream` (from `dst` into `src` when *swap, a
// device int64 that may be NULL, is set: the grower's buffer parity), unless
// *done (device int64; may be NULL) is set. tile_left and tile_off are
// int[max_tiles] scratch, max_tiles at least ceil(S_NL / 1024) of any segment
// the scalars will name; res is the device int64[3] (n_left, smaller child's
// start, its length); counter (may be NULL) is incremented once per partition.
// Returns the first CUDA error of the launches, or 0.
extern "C" int split_pass_launch(const void* src, void* dst, long long np_,
                                 int wp_live, const void* scal,
                                 const void* done, const void* swap,
                                 long long max_tiles,
                                 void* tile_left, void* tile_off, void* res,
                                 void* counter, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = sp_grid(max_tiles);
  const int32_t* p = static_cast<const int32_t*>(src);
  const int* sc = static_cast<const int*>(scal);
  const long long* dn = static_cast<const long long*>(done);
  const long long* sw = static_cast<const long long*>(swap);
  split_count<<<grid, SP_TILE, 0, s>>>(p, static_cast<const int32_t*>(dst),
                                       np_, sc, dn, sw,
                                       static_cast<int*>(tile_left));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_scan<<<1, SP_TILE, 0, s>>>(sc, dn, static_cast<const int*>(tile_left),
                                   static_cast<int*>(tile_off),
                                   static_cast<long long*>(res),
                                   static_cast<long long*>(counter));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_scatter<<<grid, SP_TILE, 0, s>>>(
      p, static_cast<int32_t*>(dst), np_, wp_live, sc, dn, sw,
      static_cast<const int*>(tile_off), static_cast<const long long*>(res));
  return (int)cudaGetLastError();
}

// ---- the smaller child's histogram --------------------------------------

struct SplitPassHist {};   // the partial kernel's caller tag

// The smaller child's histogram after the partition (the grower's G <= 20
// branch): payload_ordered.cuh's device-segment form over the child that
// split_pass wrote to res[1], res[2], in `pay` (the partition's dst; `alt`
// when *swap is set), as seg_hist_launch runs it.
extern "C" int split_pass_hist_launch(const void* pay, const void* alt,
                                      const void* swap, long long np_,
                                      const void* plan, int G, int grad_row,
                                      const void* seg, const void* done,
                                      int max_nblocks, void* partial,
                                      void* out, void* stream) {
  return (int)payload_ordered_run_dev<SplitPassHist>(
      pay, alt, swap, np_, plan, G, grad_row, seg, done, max_nblocks,
      partial, out, nullptr, reinterpret_cast<cudaStream_t>(stream));
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
#define CS_TILE (CS_THREADS * CS_LANES)  // lanes per tile
// segment table, int64 [K, CS_TAB]: start lane, length (0: no segment)
#define CS_TAB 2

// The persistent grid walks the segments in table order; tile j of a
// segment whose tiles start at global tile t0 goes to block (t0 + j) %
// gridDim, so consecutive segments' tiles spread over the blocks. A block
// copies a tile's rows 0 .. wp_live - 1 from src to dst; thread t takes
// lanes t, t + 256, ... of the tile, so each warp's loads and stores are
// coalesced. Block 0 counts the launch when some segment has lanes.
__global__ void __launch_bounds__(CS_THREADS)
consolidate_copy(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                 long long np_, int wp_live,
                 const long long* __restrict__ seg, int K,
                 long long* counter) {
  long long t0 = 0;
  const long long grid = gridDim.x;
  for (int k = 0; k < K; ++k) {
    const long long len = seg[(long long)k * CS_TAB + 1];
    if (len <= 0) continue;
    const long long start = seg[(long long)k * CS_TAB];
    const long long ntiles = (len + CS_TILE - 1) / CS_TILE;
    for (long long j = ((long long)blockIdx.x - t0 % grid + grid) % grid;
         j < ntiles; j += grid) {
      const long long i0 = j * CS_TILE + threadIdx.x;
      const long long lane0 = start + i0;
      for (int r = 0; r < wp_live; ++r) {
        const long long row = (long long)r * np_ + lane0;
        int32_t v[CS_LANES];
#pragma unroll
        for (int q = 0; q < CS_LANES; ++q)
          if (i0 + q * CS_THREADS < len) v[q] = src[row + q * CS_THREADS];
#pragma unroll
        for (int q = 0; q < CS_LANES; ++q)
          if (i0 + q * CS_THREADS < len) dst[row + q * CS_THREADS] = v[q];
      }
    }
    t0 += ntiles;
  }
  if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && t0 > 0)
    *counter += 1;
}

// Copies rows 0 .. wp_live - 1 of the K segments of the device table seg
// (int64 [K, 2]: start lane, length; a length of 0 is no segment) from src
// to dst on `stream`, over a fixed grid of at most eight blocks per
// multiprocessor (fewer when max_tiles, the most tiles of 1024 lanes the
// table may hold, is smaller). The segments are disjoint. counter (may be
// NULL) is incremented when some segment has lanes. Returns the CUDA
// error of the launch, or 0.
extern "C" int consolidate_launch(const void* src, void* dst, long long np_,
                                  int wp_live, const void* seg, int K,
                                  long long max_tiles, void* counter,
                                  void* stream) {
  const long long g = 8LL * oh_multiprocessors();
  const int grid = (int)(max_tiles < 1 ? 1 : (max_tiles < g ? max_tiles : g));
  consolidate_copy<<<grid, CS_THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), np_,
      wp_live, static_cast<const long long*>(seg), K,
      static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}
