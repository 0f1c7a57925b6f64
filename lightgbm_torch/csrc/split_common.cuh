// split_common.cuh: the split decision of one payload lane, the stable
// destination of a lane and the scan of the tile counts, shared by
// split_pass.cu and level_pass.cu.
//
// A split's scalars are the S_* slots of lightgbm_tpu/ops/pallas_grow.py:
// 83-98 (ops/payload_kernels.py's S_* constants). go_left is
// DenseBin::Split at the bin level: the bin b_raw is (word >> S_SH) &
// S_MASK; a byte outside [S_LS, S_LE) reads as S_MF, else b = b_raw - S_LS;
// the NaN bin (S_MT == 2, b == S_NB - 1) and the zero bin (S_MT == 1,
// b == S_DB) go the default way (S_DL > 0), every other bin goes left when
// b <= S_THR.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define SP_TILE 1024
#define SP_WARPS (SP_TILE / 32)

enum {
  S_NCH = 0, S_S0, S_NL, S_WG, S_SH, S_MASK, S_NB, S_MT, S_DB, S_THR, S_DL,
  S_SMALL_L, S_LS, S_LE, S_MF, N_SCALARS
};

static __device__ __forceinline__ bool sp_go_left(int32_t w, const int* s) {
  const int b_raw = (int)(((unsigned)w >> (unsigned)s[S_SH]) &
                          (unsigned)s[S_MASK]);
  const bool in_r = b_raw >= s[S_LS] && b_raw < s[S_LE];
  const int b = in_r ? b_raw - s[S_LS] : s[S_MF];
  const bool is_na = s[S_MT] == 2 && b == s[S_NB] - 1;
  const bool is_zero = s[S_MT] == 1 && b == s[S_DB];
  return (is_na || is_zero) ? s[S_DL] > 0 : b <= s[S_THR];
}

// Exclusive scan, by one block of SP_TILE threads, of the per-tile left
// counts tile_left[0, ntiles) into tile_off; returns the total to thread 0
// (and every thread). ws and carry_s are the block's shared scratch.
static __device__ int sp_scan_tiles(const int* __restrict__ tile_left,
                                    int ntiles, int* __restrict__ tile_off,
                                    int* ws, int* carry_s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) *carry_s = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += SP_TILE) {
    const int k = base + t;
    const int v = k < ntiles ? tile_left[k] : 0;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int wv = ws[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wv, d);
        if (lane >= d) wv += y;
      }
      ws[lane] = wv;
    }
    __syncthreads();
    const int incl = x + (warp > 0 ? ws[warp - 1] : 0);
    const int carry = *carry_s;
    if (k < ntiles) tile_off[k] = carry + incl - v;
    __syncthreads();
    if (t == SP_TILE - 1) *carry_s = carry + incl;
    __syncthreads();
  }
  return *carry_s;
}

// The destination, relative to the segment's start, of this thread's lane
// in the stable partition: left lanes first, then right ones, each side in
// lane order. `off` is the tile's exclusive left offset (the left lanes of
// the segment's earlier tiles), `base` the tile's first lane in the
// segment. Every earlier tile of the segment is full, so they hold
// (base - off) right lanes. Called by every thread of the block (ballots
// and barriers); wl is the block's shared int[SP_WARPS].
static __device__ __forceinline__ long long sp_destination(
    bool gl, int* wl, long long off, long long base, long long n_left) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
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
  const long long left_before = wl[warp] + __popc(bal & ((1u << lane) - 1u));
  return gl ? off + left_before : n_left + (base - off) + (t - left_before);
}
