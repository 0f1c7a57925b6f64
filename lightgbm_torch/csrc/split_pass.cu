// split_pass: the per-split partition of one leaf's payload segment.
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
//   go_left per lane is DenseBin::Split at the bin level: the bin b_raw is
//   (pay[S_WG][lane] >> S_SH) & S_MASK; a byte outside [S_LS, S_LE) reads
//   as S_MF, else b = b_raw - S_LS; the NaN bin (S_MT == 2, b == S_NB - 1)
//   and the zero bin (S_MT == 1, b == S_DB) go the default way (S_DL > 0),
//   every other bin goes left when b <= S_THR.
//   Rows 0 .. wp_live - 1 of the segment are partitioned STABLY: the left
//   lanes first, then the right ones, each side in its old order. Rows
//   wp_live .. WPA and every lane outside the segment are left untouched.
//   n_left is written to device memory. The smaller child's histogram,
//   where the grower asks for it (G <= 20), is payload_hist.cuh over the
//   child's segment after the partition (split_pass_hist_launch).
//
// What bounds it on an H100: bytes. The segment's wp_live rows are read
// once and written once: 2 * wp_live * n_l * 4 bytes, about 0.30 ms for a
// 10.5M-lane root split of the HIGGS payload (wp_live = 12) at 3.35 TB/s.
//
// Design: four launches, no atomics, deterministic. (1) one block per tile
// of 1024 lanes counts its left lanes (warp ballot + popc); (2) one block
// scans the tile counts into tile offsets and n_left; (3) each lane finds
// its destination from its tile's offset and its rank inside the tile
// (ballot prefix) and copies its wp_live words into a segment-sized scratch
// buffer; (4) the scratch is copied back over the segment. This moves the
// segment twice more than the TPU's in-place FIFO, for a simple kernel
// whose order is the oracle's.
#include "payload_hist.cuh"
#include "split_common.cuh"

struct SplitScalars {
  int s[N_SCALARS];
};

__global__ void __launch_bounds__(SP_TILE)
split_count(const int32_t* __restrict__ pay, long long np_, SplitScalars S,
            int* __restrict__ tile_left) {
  __shared__ int wc[SP_WARPS];
  const long long i = (long long)blockIdx.x * SP_TILE + threadIdx.x;
  bool gl = false;
  if (i < S.s[S_NL])
    gl = sp_go_left(pay[(long long)S.s[S_WG] * np_ + S.s[S_S0] + i], S.s);
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
split_scatter(const int32_t* __restrict__ pay, long long np_, int wp_live,
              SplitScalars S, const int* __restrict__ tile_off,
              const int* __restrict__ n_left, int32_t* __restrict__ scratch) {
  __shared__ int wl[SP_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long n_l = S.s[S_NL];
  const long long s0 = S.s[S_S0];
  const long long base = (long long)blockIdx.x * SP_TILE;
  const long long i = base + t;
  const bool valid = i < n_l;
  bool gl = false;
  if (valid) gl = sp_go_left(pay[(long long)S.s[S_WG] * np_ + s0 + i], S.s);
  const unsigned bal = __ballot_sync(0xffffffffu, gl);
  if (lane == 0) wl[warp] = __popc(bal);
  __syncthreads();
  if (t == 0) {
    int c = 0;
    for (int w = 0; w < SP_WARPS; ++w) {
      const int x = wl[w];
      wl[w] = c;
      c += x;
    }
  }
  __syncthreads();
  if (!valid) return;
  const long long left_before = wl[warp] + __popc(bal & ((1u << lane) - 1u));
  const long long off = tile_off[blockIdx.x];
  // every tile before this one is full, so it holds (base - off) right lanes
  const long long dst = gl ? off + left_before
                           : (long long)*n_left + (base - off) + (t - left_before);
  for (int r = 0; r < wp_live; ++r)
    scratch[(long long)r * n_l + dst] = pay[(long long)r * np_ + s0 + i];
}

__global__ void split_copy_back(int32_t* __restrict__ pay, long long np_,
                                long long s0, long long n_l,
                                const int32_t* __restrict__ scratch) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = blockIdx.y;
  if (i < n_l) pay[r * np_ + s0 + i] = scratch[r * n_l + i];
}

// Partitions the segment of `scal` (host int[15], the S_* slots) on
// `stream`. tile_left and tile_off are int[ceil(n_l / 1024)] scratch,
// n_left an int on the device, scratch int32[wp_live * n_l]. n_l must be
// positive. Returns the first CUDA error of the launches, or 0.
extern "C" int split_pass_launch(void* pay, long long np_, int wp_live,
                                 const int* scal, void* tile_left,
                                 void* tile_off, void* n_left,
                                 void* scratch, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  SplitScalars S;
  for (int k = 0; k < N_SCALARS; ++k) S.s[k] = scal[k];
  const long long n_l = S.s[S_NL];
  const int ntiles = (int)((n_l + SP_TILE - 1) / SP_TILE);
  int32_t* p = static_cast<int32_t*>(pay);
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
      p, np_, wp_live, S, static_cast<const int*>(tile_off),
      static_cast<const int*>(n_left), static_cast<int32_t*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n_l + 255) / 256), (unsigned)wp_live);
  split_copy_back<<<grid, 256, 0, s>>>(p, np_, S.s[S_S0], n_l,
                                       static_cast<const int32_t*>(scratch));
  return (int)cudaGetLastError();
}

// The smaller child's histogram after the partition (the grower's G <= 20
// branch): payload_hist.cuh over lanes [start, start + length).
extern "C" int split_pass_hist_launch(const void* pay, long long np_,
                                      const void* plan, int G, int grad_row,
                                      long long start, long long length,
                                      int nblocks, long long rows_per_block,
                                      void* partial, void* out,
                                      void* stream) {
  return payload_hist_run(pay, np_, plan, G, grad_row, start, length,
                          nblocks, rows_per_block, partial, out,
                          reinterpret_cast<cudaStream_t>(stream));
}
