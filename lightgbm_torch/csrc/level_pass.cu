// level_pass: the partition of every splitting leaf of one tree level, from
// one payload buffer into the other.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_grow.py:make_level_pass
// (kernel at :577, pallas_call at :747): split_pass for up to S_max slots in
// one launch, the slot of each sequential grid step taken from prefetched
// step tables, each slot's segment written back in place through
// split_pass's two-ended FIFO (so its children are not in their old order),
// with each slot's smaller-child histogram accumulated in the same pass.
//
// Contract (ops/payload_kernels.py:level_pass_plain, bit for bit on the
// CPU: a loop of split_pass_plain over the slots):
//   scal [S, 16] int32, one row per slot in the S_* columns of
//   split_common.cuh (column 15 unused). The slots' segments
//   [S_S0, S_S0 + S_NL) are disjoint. Each is read from `src` and written
//   to `dst` at the same lanes, partitioned STABLY over rows 0 ..
//   wp_live - 1 (left lanes first, each side in its old order, as
//   split_pass.cu does), and n_left[j] is written to device memory. `src`
//   is not written; rows wp_live .. of `dst` and every lane of `dst`
//   outside the segments stay untouched. The smaller children's
//   histograms, where the grower asks for them (G <= 20), are
//   payload_ordered.cuh's counting sort over the children in `dst`
//   (level_pass_hist_launch), level_seg_hist.cu's routine.
//
// Every slot of one level program has the same depth (the grower asserts
// it), so all of its segments live in one buffer, that depth's parity
// (split_pass.cu), and the level writes the other one.
//
// What bounds it on an H100: bytes. Every lane of the level's segments is
// read once and written once over its wp_live rows: 2 * wp_live * lanes * 4
// bytes, about 0.30 ms when a level covers all 10.5M lanes of the HIGGS
// payload (wp_live = 12) at 3.35 TB/s.
//
// Design: split_pass.cu's three stages, each run for all slots in one grid,
// since the segments are disjoint and no stage of one slot waits for
// another slot. A flat grid of 1024-lane tiles covers the slots' segments
// (slot_of_tile and each slot's first tile, the counterpart of the TPU's
// slot_of_step and base_of_slot): (1) per-tile ballot counts; (2) one block
// per slot scans its tiles into tile offsets and n_left; (3) each lane's
// wp_live words go from `src` straight to their destination in `dst`.
// Deterministic, no atomics; each word is read once and written once.
#include "payload_ordered.cuh"
#include "split_common.cuh"

#define LP_COLS 16
// per-slot table, int64 [S, LP_TAB]
#define LP_TAB 2
enum { LP_TILE0 = 0, LP_NTILES };

// Slot j's scalars into the block's shared s[LP_COLS].
static __device__ __forceinline__ void lp_load(const int* __restrict__ scal,
                                               int j, int* s) {
  if (threadIdx.x < LP_COLS) s[threadIdx.x] = scal[j * LP_COLS + threadIdx.x];
  __syncthreads();
}

__global__ void __launch_bounds__(SP_TILE)
level_count(const int32_t* __restrict__ src, long long np_,
            const int* __restrict__ scal, const long long* __restrict__ tab,
            const int* __restrict__ slot_of_tile,
            int* __restrict__ tile_left) {
  __shared__ int s[LP_COLS];
  __shared__ int wc[SP_WARPS];
  const int j = slot_of_tile[blockIdx.x];
  lp_load(scal, j, s);
  const long long i =
      (blockIdx.x - tab[j * LP_TAB + LP_TILE0]) * SP_TILE + threadIdx.x;
  bool gl = false;
  if (i < s[S_NL])
    gl = sp_go_left(src[(long long)s[S_WG] * np_ + s[S_S0] + i], s);
  const unsigned bal = __ballot_sync(0xffffffffu, gl);
  if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = __popc(bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < SP_WARPS; ++w) c += wc[w];
    tile_left[blockIdx.x] = c;
  }
}

// One block per slot: its tiles' offsets and its n_left.
__global__ void __launch_bounds__(SP_TILE)
level_scan(const int* __restrict__ tile_left,
           const long long* __restrict__ tab, int* __restrict__ tile_off,
           int* __restrict__ n_left) {
  __shared__ int ws[SP_WARPS];
  __shared__ int carry_s;
  const int j = blockIdx.x;
  const long long t0 = tab[j * LP_TAB + LP_TILE0];
  const int total = sp_scan_tiles(tile_left + t0,
                                  (int)tab[j * LP_TAB + LP_NTILES],
                                  tile_off + t0, ws, &carry_s);
  if (threadIdx.x == 0) n_left[j] = total;
}

__global__ void __launch_bounds__(SP_TILE)
level_scatter(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
              long long np_, int wp_live, const int* __restrict__ scal,
              const long long* __restrict__ tab,
              const int* __restrict__ slot_of_tile,
              const int* __restrict__ tile_off,
              const int* __restrict__ n_left) {
  __shared__ int s[LP_COLS];
  __shared__ int wl[SP_WARPS];
  const int j = slot_of_tile[blockIdx.x];
  lp_load(scal, j, s);
  const long long s0 = s[S_S0];
  const long long base = (blockIdx.x - tab[j * LP_TAB + LP_TILE0]) * SP_TILE;
  const long long i = base + threadIdx.x;
  const bool valid = i < s[S_NL];
  bool gl = false;
  if (valid) gl = sp_go_left(src[(long long)s[S_WG] * np_ + s0 + i], s);
  const long long d = sp_destination(gl, wl, tile_off[blockIdx.x], base,
                                     n_left[j]);
  if (!valid) return;
  for (int r = 0; r < wp_live; ++r)
    dst[(long long)r * np_ + s0 + d] = src[(long long)r * np_ + s0 + i];
}

// Partitions the S slots of `scal` (device int[S, 16]) from `src` into
// `dst` on `stream`. tab is the device int64 [S, 2] table (first tile,
// tile count), slot_of_tile int[ntiles] the slot of each tile; tile_left
// and tile_off are int[ntiles] scratch, n_left int[S]. Returns the first
// CUDA error of the launches, or 0.
extern "C" int level_pass_launch(const void* src, void* dst, long long np_,
                                 int wp_live, const void* scal,
                                 const void* tab, int S,
                                 const void* slot_of_tile, int ntiles,
                                 void* tile_left, void* tile_off,
                                 void* n_left, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(src);
  const int* sc = static_cast<const int*>(scal);
  const long long* tb = static_cast<const long long*>(tab);
  const int* sot = static_cast<const int*>(slot_of_tile);
  cudaError_t err;
  if (ntiles > 0) {
    level_count<<<ntiles, SP_TILE, 0, st>>>(p, np_, sc, tb, sot,
                                            static_cast<int*>(tile_left));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  level_scan<<<S, SP_TILE, 0, st>>>(static_cast<const int*>(tile_left), tb,
                                    static_cast<int*>(tile_off),
                                    static_cast<int*>(n_left));
  err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 0) return (int)err;
  level_scatter<<<ntiles, SP_TILE, 0, st>>>(
      p, static_cast<int32_t*>(dst), np_, wp_live, sc, tb, sot,
      static_cast<const int*>(tile_off), static_cast<const int*>(n_left));
  return (int)cudaGetLastError();
}

struct LevelPassHist {};   // the partial kernel's caller tag

// The smaller children's histograms after the partition (the grower's
// G <= 20 branch): payload_ordered.cuh's partial kernel over the segments
// of `seg` in `pay` (the partition's dst), as level_seg_hist_launch runs
// it.
extern "C" int level_pass_hist_launch(const void* pay, long long np_,
                                      const void* plan, int G, int grad_row,
                                      const void* seg, int S,
                                      const void* slot_of_block, int nblocks,
                                      void* partial, void* out,
                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = payload_ordered_run<LevelPassHist>(
      pay, np_, plan, G, grad_row, 0, 0, 0, seg, slot_of_block, nblocks,
      partial, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  return payload_hist_multi_finish(partial, seg, S, G, out, s);
}

// payload_hist.cuh's ownership routine over the same segments: not on the
// grower's path; the witness that chip_smoke.py and the card tests hold the
// many-segment counting-sort histograms against.
extern "C" int ownership_multi_launch(const void* pay, long long np_,
                                      const void* plan, int G, int grad_row,
                                      const void* seg, int S,
                                      const void* slot_of_block, int nblocks,
                                      void* partial, void* out,
                                      void* stream) {
  return payload_hist_multi_run(pay, np_, plan, G, grad_row, seg, S,
                                slot_of_block, nblocks, partial, out,
                                reinterpret_cast<cudaStream_t>(stream));
}
