// block_reduce.cuh: block-wide max and min of one float per thread, shared
// by scan_pair.cu and scan_blocks.cu. Every thread gets the result; `red`
// is shared scratch of one float per warp. Max and min are exact, so the
// order of the reduction does not change the result.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define SP_MAX_WARPS 32
#define SP_MAX_LANES 1024

static __device__ float block_max(float v, float* red, int lane, int warp,
                           int nwarps) {
  for (int d = 16; d > 0; d >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nwarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

static __device__ float block_min(float v, float* red, int lane, int warp,
                           int nwarps) {
  for (int d = 16; d > 0; d >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, d));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nwarps; ++w) r = fminf(r, red[w]);
  __syncthreads();
  return r;
}
