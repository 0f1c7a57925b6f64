// scan_common.cuh: what scan_pair.cu and scan_blocks.cu share.
//
// Both kernels give each (feature or group, child) pair K warps: one
// (K = 1, several pairs per block) when the batch fills the card, up to
// eight (one pair per block) when it is small (scan_shape). The pair's
// warps stage six f64 rows of masked per-lane quantities in shared memory,
// run each row's prefix sums as sequential f64 chains (chain_prefix), then
// evaluate every lane's gains and pick the best lane of each direction
// with one warp reduction of a packed u64 key (pack_key, warp_max_key) and,
// when K > 1, one cross-warp stage (pair_max_keys). With K = 1 no block
// barrier is used: a warp reads and writes only its own rows.
//
// Row layout: SCAN_ROWS rows of row_stride(Wp) doubles. The two extra
// doubles per row shift row q by 4q banks, so the chain lanes, which read
// rows 0-5 at one offset in the same step, hit different banks.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define SCAN_ROWS 6
#define SCAN_FULL 0xffffffffu
// shared memory one block may take: at most two blocks share an SM
#define SCAN_BLOCK_SMEM (110 * 1024)
#define SCAN_MAX_WARPS 8
// lanes of its row (one every 32) whose global loads a thread issues
// together before using any of them
#define SCAN_BATCH 8

static __host__ __device__ __forceinline__ int row_stride(int Wp) {
  return Wp + 2;
}

// Inclusive prefix sums of row[s..e], in place: one f64 sum from 0.0,
// lane after lane, as the plain versions' cumsum. The dependency from one
// step to the next is a single register add: each block of 8 inputs is
// loaded while the block before it is summed, and the 8 sums are stored
// after their adds, so no shared-memory access lies on the chain.
static __device__ __forceinline__ void chain_prefix(double* row, int s,
                                                    int e) {
  double acc = 0.0;
  int i = s;
  if (i + 7 <= e) {
    double x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = row[i + k];
    for (; i + 15 <= e; i += 8) {
      double y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = row[i + 8 + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc += x[k];
        row[i + k] = acc;
        x[k] = y[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc += x[k];
      row[i + k] = acc;
    }
    i += 8;
  }
  for (; i <= e; ++i) {
    acc += row[i];
    row[i] = acc;
  }
}

// An f32 gain as a u32 whose unsigned order is the float order: negative
// values are complemented, the others get the sign bit. -0.0 is mapped as
// +0.0 first, so the two zeros tie as they compare equal. NaN is never
// packed (the callers keep it out).
static __device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned b = __float_as_uint(x == 0.f ? 0.f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

static __device__ __forceinline__ float from_order_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The key of a valid lane: the gain's order bits above, the tie-break
// below. Every key is above 0 (order_bits(-inf) is 0x007fffff), so 0
// stands for "no valid lane".
static __device__ __forceinline__ unsigned long long pack_key(float gain,
                                                              unsigned tie) {
  return ((unsigned long long)order_bits(gain) << 32) | tie;
}

// The largest key of the warp, in every lane (max is exact, so the order
// of the butterfly does not matter).
static __device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long k) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(SCAN_FULL, k, d);
    k = o > k ? o : k;
  }
  return k;
}

// The launch shape of a scan over `pairs` (feature or group, child) pairs:
// K warps per pair and NW warps per block. A small batch leaves most SMs
// idle, so K warps share each pair (K = 2, 4 or 8, one pair per block,
// while pairs * 2K fit one warp per SM sub-partition); otherwise K =
// min_k and, at K = 1, a block holds NW pairs, enough blocks to reach every
// SM first, up to SCAN_MAX_WARPS, within SCAN_BLOCK_SMEM. (scan_blocks
// takes min_k = 2: its windows' chains spread over 64 threads.)
struct ScanShape {
  int K, nw;
};

static ScanShape scan_shape(int pairs, int warp_smem, int min_k) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  int K = min_k;
  while (K < SCAN_MAX_WARPS && pairs * K * 2 <= sms * 4) K *= 2;
  if (K > 1) return {K, K};
  int nw = pairs / sms;
  if (nw > SCAN_MAX_WARPS) nw = SCAN_MAX_WARPS;
  if (nw * warp_smem > SCAN_BLOCK_SMEM) nw = SCAN_BLOCK_SMEM / warp_smem;
  return {1, nw < 1 ? 1 : nw};
}

// The threads of one pair wait for each other: the warp alone when K = 1
// (no block barrier), the whole block (one pair) otherwise.
static __device__ __forceinline__ void pair_sync(int K) {
  if (K == 1)
    __syncwarp();
  else
    __syncthreads();
}

// The largest of each direction's keys over the K warps of a pair: every
// warp's lane 0 posts its two keys to `red` [K][2], and after one barrier
// thread 0 takes the maximum (the one cross-warp stage). Returns true in
// the thread that holds the result (lane 0 of warp 0 of the pair).
static __device__ __forceinline__ bool pair_max_keys(
    unsigned long long* best_r, unsigned long long* best_f,
    unsigned long long* red, int K, int kw, int lane) {
  *best_r = warp_max_key(*best_r);
  *best_f = warp_max_key(*best_f);
  if (K == 1) return lane == 0;
  if (lane == 0) {
    red[2 * kw] = *best_r;
    red[2 * kw + 1] = *best_f;
  }
  __syncthreads();
  if (kw != 0 || lane != 0) return false;
  for (int i = 1; i < K; ++i) {
    *best_r = red[2 * i] > *best_r ? red[2 * i] : *best_r;
    *best_f = red[2 * i + 1] > *best_f ? red[2 * i + 1] : *best_f;
  }
  return true;
}

// ---- the knob form's gain (ops/split.py, in the same f32 operations) ----
// Every min/max below lets NaN through as jnp.minimum/torch.minimum do
// (fminf/fmaxf would drop it), and sign is torch.sign's: 0 for +-0 and NaN
// (the factor it multiplies is NaN then, so the product is jnp.sign's).

struct KnobScalars {
  float l2, l1, mds, cmin, cmax;
  bool use_mc;
  float mono;        // the feature's monotone sign
};

static __device__ __forceinline__ float knob_sign(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

static __device__ __forceinline__ float knob_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

static __device__ __forceinline__ float knob_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// ThresholdL1: sign(s) * max(0, |s| - l1)
static __device__ __forceinline__ float knob_threshold_l1(float s, float l1) {
  const float z = fabsf(s) - l1;
  return knob_sign(s) * (z < 0.f ? 0.f : z);
}

// CalculateSplittedLeafOutput: -ThresholdL1(g) / (h + l2), clamped to
// +-mds when mds > 0
static __device__ __forceinline__ float knob_output(float g, float h,
                                                    const KnobScalars& k) {
  const float ret = -knob_threshold_l1(g, k.l1) / (h + k.l2);
  const float clipped = knob_sign(ret) * knob_min(fabsf(ret), k.mds);
  return k.mds > 0.f ? clipped : ret;
}

// GetLeafGainGivenOutput: -(2 * ThresholdL1(g) * o + (h + l2) * o * o)
static __device__ __forceinline__ float knob_gain_given(float g, float h,
                                                        float o,
                                                        const KnobScalars& k) {
  const float sg = knob_threshold_l1(g, k.l1);
  return -((2.f * sg) * o + ((h + k.l2) * o) * o);
}

// GetLeafGain: ThresholdL1(g)^2 / (h + l2), or the clamped output's gain
static __device__ __forceinline__ float knob_leaf_gain(float g, float h,
                                                       const KnobScalars& k) {
  const float sg = knob_threshold_l1(g, k.l1);
  const float plain = (sg * sg) / (h + k.l2);
  if (!(k.mds > 0.f)) return plain;
  return knob_gain_given(g, h, knob_output(g, h, k), k);
}

// GetSplitGains: without monotone constraints the two leaf gains; with
// them, the gains of the outputs clamped into [cmin, cmax], and 0 for a
// split whose outputs go against the feature's sign
static __device__ __forceinline__ float knob_split_gain(float gl, float hl,
                                                        float gr, float hr,
                                                        const KnobScalars& k) {
  if (!k.use_mc) return knob_leaf_gain(gl, hl, k) + knob_leaf_gain(gr, hr, k);
  const float lo = knob_min(knob_max(knob_output(gl, hl, k), k.cmin), k.cmax);
  const float ro = knob_min(knob_max(knob_output(gr, hr, k), k.cmin), k.cmax);
  const bool bad = (k.mono > 0.f && lo > ro) || (k.mono < 0.f && lo < ro);
  const float gain = knob_gain_given(gl, hl, lo, k) +
                     knob_gain_given(gr, hr, ro, k);
  return bad ? 0.f : gain;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the default
// 48 KB only after this call). Returns the CUDA error, 0 on success.
template <typename K>
static int scan_allow_smem(K kernel, int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}
