// bag: the persistent grower's row sampling (bagging and GOSS) on the card,
// inside the per-iteration CUDA graph.
//
// No Pallas counterpart: on the TPU these are jnp statements of the JAX
// package's fused driver (lightgbm_tpu/ops/grow_persist.py:
// make_bag_transform:569-644, _hash_uniform:498-518, _kth_largest:521-537,
// make_goss_weight_fn:540-566), run between the gradient fill and the tree.
// ops/bag.py holds each kernel's plain PyTorch version, which the kernels
// compute bit for bit.
//
// bag_apply: one pass over the payload's n live lanes. Lane i's uniform
// draw is a hash of its row id (the payload's row-id row) and the window
// key: u32 arithmetic, then __uint2float_rn (u32 -> f32 rounded to
// nearest, so u can be 1.0: the JAX package's documented quirk) times
// 2^-32. Its weight w:
//   fraction:  u < fraction;
//   balanced:  label > 0 ? u < pos_fraction : u < neg_fraction;
//   GOSS:      1 where |g * h| >= the threshold goss_select wrote, else
//              amp where u < p_rest, else 0; every lane 1 (nothing to
//              do) while the iteration is below the skip count.
//   rows:      mask[rid] (RF's host-drawn bag, an [N] uint8 mask uploaded
//              before the iteration: the JAX package's apply_row_weights,
//              grow_persist.py:1828-1843);
// grad and hess are multiplied by w in place, in f32 (a multiply, so a
// negative gradient times 0 is -0.0, as JAX's g * w), and the count of
// lanes with w > 0 goes to `count`: per-block integer sums, added with one
// integer atomic per block after a memset (integer addition: the same
// total in any order).
//
// goss_select: the exact k-th largest |g * h| (f32) over the n live lanes,
// by a radix select on the u32 bit patterns (a non-negative float's bits
// order as the float): four passes of 8-bit digits, most significant
// first; each pass histograms the digit of the lanes whose higher digits
// match the prefix found so far (per-warp shared histograms, then integer
// atomics into a global one), and one block then picks the digit where the
// count from the top reaches k. The result is the value JAX's 32-round
// bitwise select returns, ties included: the largest t with
// count(bits >= t) >= k (0 when fewer than k lanes are live). No host
// read-back: the threshold and the keep-every-row flag stay in device
// memory for bag_apply.
//
// Device scalars, written by the host before each iteration (so one
// captured graph serves every window key, iteration and fraction):
//   ints [BAG_NI] i64: the window key's two words, the iteration, the
//                      skip count int(1 / learning_rate), top_k
//   flts [BAG_NF] f32: fraction, pos_fraction, neg_fraction, p_rest, amp
//   sel  [SEL_LEN] i64: goss_select's threshold bits and keep flag, its
//                      prefix and remaining rank, its 256-bin histogram
//
// What bounds them on an H100: bytes. bag_apply reads the row-id, grad
// and hess rows (and the label row when balanced, a gathered mask byte in
// the rows mode) and writes grad and hess: 20-24 bytes a lane. goss_select reads grad and hess once per pass
// (four passes; the bound counts one). Each kernel's first thread adds one
// to its device counter when the launch does its work (goss_select: when
// it selects, not while the iteration is below the skip count).
#include <cuda_runtime.h>
#include <stdint.h>

enum { BI_KEY0 = 0, BI_KEY1, BI_IT, BI_SKIP, BI_TOPK, BAG_NI = 5 };
enum { BF_FRAC = 0, BF_POS, BF_NEG, BF_PREST, BF_AMP, BAG_NF = 5 };
enum { SEL_THR = 0, SEL_KEEP, SEL_PREFIX, SEL_KREM, SEL_HIST,
       SEL_LEN = SEL_HIST + 256 };
enum { MODE_FRACTION = 0, MODE_BALANCED = 1, MODE_GOSS = 2, MODE_ROWS = 3 };
#define BAG_THREADS 256
#define BAG_WARPS (BAG_THREADS / 32)

static __device__ __forceinline__ float bag_uniform(uint32_t rid,
                                                    uint32_t k0,
                                                    uint32_t k1) {
  uint32_t x = rid ^ k0;
  x = x * 0x85EBCA6Bu;
  x = x ^ (x >> 13);
  x = (x + k1) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return __uint2float_rn(x) * (1.0f / 4294967296.0f);
}

__global__ void __launch_bounds__(BAG_THREADS)
bag_apply(const int* __restrict__ rid, const float* __restrict__ label,
          float* __restrict__ g, float* __restrict__ h, long long n,
          int mode, const long long* __restrict__ ints,
          const float* __restrict__ flts, const long long* __restrict__ sel,
          const uint8_t* __restrict__ rows, unsigned long long* count,
          long long* counter) {
  __shared__ unsigned int warp_cnt[BAG_WARPS];
  if (blockIdx.x == 0 && threadIdx.x == 0 && counter != nullptr)
    *counter += 1;
  if (mode == MODE_GOSS && sel[SEL_KEEP] != 0) {
    // below the skip count: every live lane keeps weight 1 (x * 1 = x)
    if (blockIdx.x == 0 && threadIdx.x == 0)
      atomicAdd(count, (unsigned long long)n);
    return;
  }
  const uint32_t k0 = (uint32_t)ints[BI_KEY0], k1 = (uint32_t)ints[BI_KEY1];
  const float frac = flts[BF_FRAC], pos = flts[BF_POS], neg = flts[BF_NEG];
  const float p_rest = flts[BF_PREST], amp = flts[BF_AMP];
  const float thr = mode == MODE_GOSS
                        ? __uint_as_float((uint32_t)sel[SEL_THR]) : 0.f;
  unsigned int c = 0;
  const long long stride = (long long)gridDim.x * BAG_THREADS;
  for (long long i = (long long)blockIdx.x * BAG_THREADS + threadIdx.x;
       i < n; i += stride) {
    const int r = rid[i];
    const float u = mode == MODE_ROWS ? 0.f : bag_uniform((uint32_t)r, k0, k1);
    const float gi = g[i], hi = h[i];
    float w;
    if (mode == MODE_ROWS) {
      w = __ldg(rows + r) != 0 ? 1.f : 0.f;
    } else if (mode == MODE_GOSS) {
      const float s = fabsf(gi * hi);
      w = s >= thr ? 1.f : (u < p_rest ? amp : 0.f);
    } else if (mode == MODE_BALANCED) {
      w = (label[i] > 0.f ? u < pos : u < neg) ? 1.f : 0.f;
    } else {
      w = u < frac ? 1.f : 0.f;
    }
    g[i] = gi * w;
    h[i] = hi * w;
    c += w > 0.f ? 1u : 0u;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < BAG_WARPS; ++w) t += warp_cnt[w];
    if (t != 0) atomicAdd(count, t);
  }
}

// goss_select, step 0: the keep flag from the iteration and the skip
// count, the prefix and remaining rank reset, the histogram zeroed. One
// block.
__global__ void __launch_bounds__(BAG_THREADS)
gsel_init(const long long* __restrict__ ints, long long* sel,
          long long* counter) {
  const bool keep = ints[BI_IT] < ints[BI_SKIP];
  sel[SEL_HIST + threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    sel[SEL_THR] = 0;
    sel[SEL_KEEP] = keep ? 1 : 0;
    sel[SEL_PREFIX] = 0;
    sel[SEL_KREM] = ints[BI_TOPK];
    if (!keep && counter != nullptr) *counter += 1;
  }
}

// One radix pass: the histogram of digit (bits >> shift) & 255 over the
// live lanes whose digits above `shift` equal the prefix.
__global__ void __launch_bounds__(BAG_THREADS)
gsel_hist(const float* __restrict__ g, const float* __restrict__ h,
          long long n, long long* sel, int shift) {
  __shared__ unsigned int hist[BAG_WARPS][256];
  if (sel[SEL_KEEP] != 0) return;
  for (int j = threadIdx.x; j < BAG_WARPS * 256; j += BAG_THREADS)
    hist[j >> 8][j & 255] = 0;
  __syncthreads();
  const uint32_t prefix = (uint32_t)sel[SEL_PREFIX];
  const uint32_t high = shift >= 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
  unsigned int* mine = hist[threadIdx.x >> 5];
  const long long stride = (long long)gridDim.x * BAG_THREADS;
  // every thread of the block takes every step (the bound is on the
  // block's first lane), so a warp's lanes with one digit add together:
  // one shared atomic per distinct digit in the warp
  for (long long base = (long long)blockIdx.x * BAG_THREADS; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int bin = -1;
    if (i < n) {
      const uint32_t b = __float_as_uint(fabsf(g[i] * h[i]));
      if ((b & high) == prefix) bin = (int)((b >> shift) & 255u);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&mine[bin], (unsigned int)__popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += BAG_THREADS) {
    unsigned long long t = 0;
    for (int w = 0; w < BAG_WARPS; ++w) t += hist[w][d];
    if (t != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(sel + SEL_HIST + d),
                t);
  }
}

// After a pass: the largest digit d whose count from the top reaches the
// remaining rank (0 when none does), appended to the prefix; the rank
// less the lanes above d; the histogram zeroed. After the last pass the
// prefix is the threshold. One block.
__global__ void __launch_bounds__(BAG_THREADS)
gsel_pick(long long* sel, int shift) {
  __shared__ long long cnt[256];
  if (sel[SEL_KEEP] != 0) return;
  cnt[threadIdx.x] = sel[SEL_HIST + threadIdx.x];
  sel[SEL_HIST + threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long krem = sel[SEL_KREM];
  long long above = 0;
  int d = 255;
  for (; d >= 0; --d) {
    if (above + cnt[d] >= krem) break;
    above += cnt[d];
  }
  if (d < 0) {
    d = 0;
    above -= cnt[0];
  }
  const uint32_t prefix = (uint32_t)sel[SEL_PREFIX] | ((uint32_t)d << shift);
  sel[SEL_PREFIX] = prefix;
  sel[SEL_KREM] = krem - above;
  if (shift == 0) sel[SEL_THR] = prefix;
}

static int bag_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

// A grid of four blocks per multiprocessor, fewer for fewer lanes.
static int bag_grid(long long n) {
  const long long want = (n + BAG_THREADS - 1) / BAG_THREADS;
  const long long most = 4LL * bag_sms();
  return (int)(want < 1 ? 1 : (want < most ? want : most));
}

// The launchers queue their kernels on `stream` and return the CUDA error
// of the launches, 0 on success. counter may be NULL; label is read only
// in the balanced mode, sel only in the GOSS mode, rows only in the rows
// mode.
extern "C" int bag_apply_launch(const void* rid, const void* label, void* g,
                                void* h, long long n, int mode,
                                const void* ints, const void* flts,
                                const void* sel, const void* rows,
                                void* count, void* counter, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  bag_apply<<<bag_grid(n), BAG_THREADS, 0, s>>>(
      static_cast<const int*>(rid), static_cast<const float*>(label),
      static_cast<float*>(g), static_cast<float*>(h), n, mode,
      static_cast<const long long*>(ints), static_cast<const float*>(flts),
      static_cast<const long long*>(sel), static_cast<const uint8_t*>(rows),
      static_cast<unsigned long long*>(count),
      static_cast<long long*>(counter));
  return (int)cudaGetLastError();
}

extern "C" int goss_select_launch(const void* g, const void* h, long long n,
                                  const void* ints, void* sel, void* counter,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  long long* sl = static_cast<long long*>(sel);
  gsel_init<<<1, BAG_THREADS, 0, s>>>(static_cast<const long long*>(ints),
                                      sl, static_cast<long long*>(counter));
  for (int shift = 24; shift >= 0; shift -= 8) {
    gsel_hist<<<bag_grid(n), BAG_THREADS, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(h), n, sl,
        shift);
    gsel_pick<<<1, BAG_THREADS, 0, s>>>(sl, shift);
  }
  return (int)cudaGetLastError();
}
