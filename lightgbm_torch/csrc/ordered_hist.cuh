// ordered_hist.cuh: the order-exact histogram of a tile of lanes by a
// per-tile stable counting sort, shared by hist_window.cu and the payload
// histograms of payload_ordered.cuh (root_hist, seg_hist, level_seg_hist).
//
// Contract (the same arithmetic as ops/histogram.py:hist_window_plain and
// ops/payload_kernels.py:seg_hist_plain, bit for bit): within a row block
// every (group, bin) is one f32 chain, 0 + v[i1] + v[i2] + ... with the
// lanes in order. A block of K * OH_TEAM threads covers K groups of one row
// block, one team of OH_TEAM threads per group; each thread of a team owns
// two bins of its group (oh_bin0) and carries their two (grad, hess)
// chains in registers from tile to tile.
//
// Per tile of at most OH_TILE lanes, once the caller has staged the lanes'
// grad and hess and whatever its bin_of(i) reads:
//   1. rank: each warp of a team takes OH_TILE / OH_WARPS consecutive
//      lanes, 32 at a time in lane order. One ballot per bit of the bin
//      (8 for 256 bins, 4 for a nibble group) gives each lane the mask of
//      the lanes with its bin, __popc of the lower ones its rank among them
//      (__match_any_sync computes the same mask, but its cost grows with
//      the number of distinct bins among the 32 lanes); where all 32 lanes
//      share one bin a vote says so and the ballots are skipped. Per-warp
//      per-bin counts in shared memory carry the rank from one round to
//      the next, so a lane's rank counts the earlier lanes of its bin in
//      the warp's range;
//   2. offsets: an exclusive scan over (bin, warp) turns the counts into
//      each (warp, bin)'s first slot of a tile-local array: the lanes of
//      one bin then sit in lane order, warp after warp;
//   3. scatter: every lane writes its (grad, hess) to its slot;
//   4. walk: each thread adds the slots of its two bins, in order, to its
//      chains: the same additions in the same order as a loop over the
//      lanes, so the sums are bit-identical to the plain version's.
// oh_sort runs steps 1-3 for one team and oh_walk step 4, so that several
// teams can sort consecutive tiles of one group at once and one of them
// walk the sorted tiles in lane order; oh_tile runs all four for a team's
// own tile.
// Integer bookkeeping only, in shared memory; no float atomics. Work per
// group is O(lanes): a few instructions per lane to rank and scatter it,
// and one add in the walk. The kernels stage tile k + 1 with cp.async
// while tile k is sorted and walked (two staging buffers), so the loads'
// latency hides behind the sort.
//
// Grid shape (hist_window.cu; payload_ordered.cuh picks its own): a
// segment has nblocks row blocks and G groups, so nblocks * G (row block,
// group) units, each a serial pass over its row block. All of them run in
// one wave: oh_groups_per_block picks K, the groups per block,
// so that every multiprocessor holds at most one block (the units per
// multiprocessor then differ by at most K; with K = 4 the 133 blocks of the
// 10.5M-row HIGGS root would put two blocks on one of 132 multiprocessors,
// which then takes about twice as long as the others). The group index is
// the grid's fastest dimension, so the blocks that read the same lanes run
// together and all but the first find them in L2.
//
// What bounds it: the walk of a tile takes as long as its heaviest bin's
// chain, which is serial by contract. Over uniform bins that is about
// OH_TILE / 128 adds per thread; a tile whose lanes all fall in one bin
// (an all-zero column, the most_freq bin of a one-hot bundle) costs one
// thread OH_TILE dependent adds while the team's other threads wait, so
// such a group runs slower than a uniform one. The walk starts the next
// eight slots' loads before it adds the current eight, so a long chain
// waits on its adds and not on shared memory; nothing can shorten the
// chain itself. With bins spread over the width the rank bounds the tile:
// about a dozen warp-wide ballots, shuffles and votes per 32 lanes, and
// each warp's counts carried from round to round.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define OH_TEAM 128                      // threads per group
#define OH_WARPS (OH_TEAM / 32)          // warps per group
#define OH_MAX_GROUPS 8                  // groups per block, at most
#define OH_TILE 1024                     // lanes per tile
#define OH_BINS 256
#define OH_ROUNDS (OH_TILE / OH_TEAM)    // rounds of 32 lanes per warp
#define OH_SKIP 0xffffffffu

template <int K>
struct OhShared {
  float2 sorted[K][OH_TILE];             // each group's tile by bin
  int cnt[K][OH_WARPS][OH_BINS];         // counts, then first slots
  int wsum[K][OH_WARPS];                 // the scan's warp totals
};

// ---- cp.async: global -> shared without registers --------------------------

static __device__ __forceinline__ void oh_copy4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void oh_copy16(void* dst,
                                                 const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void oh_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are in
// flight (0 or 1).
static __device__ __forceinline__ void oh_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the tile routine ------------------------------------------------------

// Zero the counts before the first tile (the caller syncs before oh_tile).
template <int K>
static __device__ __forceinline__ void oh_begin(OhShared<K>& s) {
  int* c = &s.cnt[0][0][0];
  for (int i = threadIdx.x; i < K * OH_WARPS * OH_BINS; i += K * OH_TEAM)
    c[i] = 0;
}

// The first of the two bins thread tt of `team` owns. A bin's owner sits
// in another warp in each team (the bins rotate by a warp per team), and
// a warp's scheduler is its index mod 4, so where every group's lanes
// share one bin the block's serial chains spread over the four
// schedulers.
static __device__ __forceinline__ int oh_bin0(int team, int tt) {
  return 2 * ((tt + 32 * team) % OH_TEAM);
}

// acc += the n slots p[0], p[1], ... in order (grad into ag, hess into
// ah): batches of eight, each batch's loads started before the adds of
// the batch before it.
static __device__ __forceinline__ void oh_load8(float2 (&x)[8],
                                                const float2* p) {
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = p[u];
}

static __device__ __forceinline__ void oh_add8(const float2 (&x)[8],
                                               float& ag, float& ah) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    ag += x[u].x;
    ah += x[u].y;
  }
}

static __device__ __forceinline__ void oh_chain(const float2* p, int n,
                                                float& ag, float& ah) {
  int k = 0;
  if (n >= 8) {
    float2 x[8], y[8];
    oh_load8(x, p);                    // x holds slots [k - 8, k)
    for (k = 8; k + 16 <= n; k += 16) {
      oh_load8(y, p + k);
      oh_add8(x, ag, ah);
      oh_load8(x, p + k + 8);
      oh_add8(y, ag, ah);
    }
    if (k + 8 <= n) {
      oh_load8(y, p + k);
      oh_add8(x, ag, ah);
      oh_add8(y, ag, ah);
      k += 8;
    } else {
      oh_add8(x, ag, ah);
    }
  }
  for (; k < n; ++k) {
    const float2 v = p[k];
    ag += v.x;
    ah += v.y;
  }
}

// Steps 1-3 for the calling thread's team: rank the staged tile of n
// lanes into s.cnt[team], scatter their (grad, hess) into s.sorted[team]
// by bin, and return where the calling thread's two bins, oh_bin0(rot,
// tt) and the one after it, sit there: {first slot, count} of each.
// bin_of(i) is the team's group's bin of lane i, below 2^nbits (nbits <=
// 8); bins >= W, the lanes >= n, and every lane of a team whose group does
// not exist (live is false) are left out. val[i] is lane i's (grad, hess).
// The caller syncs between staging and this call. When it returns, every
// thread is done reading the staged tile and the scatter is complete
// (its last barrier follows the scatter), and the counts are zero again
// for the next tile.
template <int K, class BinOf>
static __device__ __forceinline__ int4 oh_sort(OhShared<K>& s, int team,
                                               int rot, const float2* val,
                                               int n, int W, int nbits,
                                               bool live, BinOf bin_of) {
  const int tt = threadIdx.x % OH_TEAM;
  const int warp = tt / 32;
  const int lane = tt % 32;
  const unsigned lower = (1u << lane) - 1u;
  int* cnt = s.cnt[team][warp];

  // 1. rank: the bins and same-bin masks of all rounds first (independent
  //    ballots), then the per-warp counts round after round; rk[j] ends as
  //    bin << 16 | rank of lane i within its bin in the warp's range, or
  //    OH_SKIP
  unsigned rk[OH_ROUNDS], same[OH_ROUNDS];
  bool mixed[OH_ROUNDS];
#pragma unroll
  for (int j = 0; j < OH_ROUNDS; ++j) {
    const int i = warp * (OH_TILE / OH_WARPS) + j * 32 + lane;
    const unsigned b = (live && i < n) ? bin_of(i) : OH_SKIP;
    rk[j] = b >= (unsigned)W ? OH_SKIP : b;
    same[j] = __ballot_sync(0xffffffffu, rk[j] != OH_SKIP);
    // all kept lanes in one bin: their mask is `same` already
    const int lead = same[j] ? __ffs((int)same[j]) - 1 : 0;
    const unsigned first = __shfl_sync(0xffffffffu, rk[j], lead);
    mixed[j] = !__all_sync(0xffffffffu, rk[j] == OH_SKIP || rk[j] == first);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < nbits) {
#pragma unroll
      for (int j = 0; j < OH_ROUNDS; ++j) {
        if (mixed[j]) {
          const unsigned set = (rk[j] >> k) & 1u;
          const unsigned bit = __ballot_sync(0xffffffffu, set);
          same[j] &= set ? bit : ~bit;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OH_ROUNDS; ++j) {
    const unsigned b = rk[j];
    int base = 0;
    if (b != OH_SKIP) base = cnt[b];
    __syncwarp();
    if (b != OH_SKIP && (same[j] & lower) == 0)
      cnt[b] = base + __popc(same[j]);
    __syncwarp();
    rk[j] = b == OH_SKIP ? OH_SKIP
                         : (b << 16) | (unsigned)(base + __popc(same[j] & lower));
  }
  __syncthreads();

  // 2. offsets: this thread's two bins, scanned over the team (in thread
  //    order: any order of the bins will do, each bin's slots stay in
  //    lane order)
  const int b0 = oh_bin0(rot, tt);
  int t0 = 0, t1 = 0;
#pragma unroll
  for (int w = 0; w < OH_WARPS; ++w) {
    t0 += s.cnt[team][w][b0];
    t1 += s.cnt[team][w][b0 + 1];
  }
  int incl = t0 + t1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s.wsum[team][warp] = incl;
  __syncthreads();
  int start0 = incl - t0 - t1;
  for (int w = 0; w < warp; ++w) start0 += s.wsum[team][w];
  int off0 = start0, off1 = start0 + t0;
#pragma unroll
  for (int w = 0; w < OH_WARPS; ++w) {
    const int c0 = s.cnt[team][w][b0];
    const int c1 = s.cnt[team][w][b0 + 1];
    s.cnt[team][w][b0] = off0;
    s.cnt[team][w][b0 + 1] = off1;
    off0 += c0;
    off1 += c1;
  }
  __syncthreads();

  // 3. scatter every lane's (grad, hess) to its slot, then clear the
  //    counts of this thread's bins for the next tile (nobody reads them
  //    after the barrier)
  float2* so = s.sorted[team];
#pragma unroll
  for (int j = 0; j < OH_ROUNDS; ++j) {
    if (rk[j] != OH_SKIP) {
      const int i = warp * (OH_TILE / OH_WARPS) + j * 32 + lane;
      so[cnt[rk[j] >> 16] + (int)(rk[j] & 0xffffu)] = val[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < OH_WARPS; ++w) {
    s.cnt[team][w][b0] = 0;
    s.cnt[team][w][b0 + 1] = 0;
  }
  return make_int4(start0, t0, start0 + t0, t1);
}

// Step 4: add the slots of the calling thread's two bins in a sorted tile
// (sp from oh_sort) to its chains, in slot order: acc = {grad, hess} of
// the first bin, then of the second. Both together while both have slots
// (two independent chains), then the longer one alone.
static __device__ __forceinline__ void oh_walk(const float2* so, int4 sp,
                                               float (&acc)[4]) {
  const float2* p0 = so + sp.x;
  const float2* p1 = so + sp.z;
  const int both = min(sp.y, sp.w);
#pragma unroll 4
  for (int k = 0; k < both; ++k) {
    const float2 a = p0[k];
    const float2 c = p1[k];
    acc[0] += a.x;
    acc[1] += a.y;
    acc[2] += c.x;
    acc[3] += c.y;
  }
  if (sp.y > both)
    oh_chain(p0 + both, sp.y - both, acc[0], acc[1]);
  else
    oh_chain(p1 + both, sp.w - both, acc[2], acc[3]);
}

// One tile, sorted and walked by the calling thread's team alone:
// acc = {grad, hess} of bin oh_bin0(team, tt), then of the bin after it
// (oh_sort has the arguments).
template <int K, class BinOf>
static __device__ __forceinline__ void oh_tile(OhShared<K>& s,
                                               const float2* val, int n,
                                               int W, int nbits,
                                               bool live, BinOf bin_of,
                                               float (&acc)[4]) {
  const int team = threadIdx.x / OH_TEAM;
  oh_walk(s.sorted[team],
          oh_sort(s, team, team, val, n, W, nbits, live, bin_of), acc);
}

// Groups per block: the fewest that put the launch's blocks in one wave
// of at most one block per multiprocessor, capped at OH_MAX_GROUPS (past
// that the launch takes several waves).
static inline int oh_multiprocessors() {
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

static inline int oh_groups_per_block(int G, int nblocks) {
  const int sms = oh_multiprocessors();
  int k = 1;
  while (k < OH_MAX_GROUPS && k < G &&
         (long long)((G + k - 1) / k) * nblocks > sms)
    ++k;
  return k;
}

// f(std::integral_constant<int, k>()): the kernels are templates on their
// groups per block, 1 <= k <= OH_MAX_GROUPS.
template <class F>
static inline cudaError_t oh_with_groups(int k, F f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
  }
  return cudaErrorInvalidValue;
}

// Ask for `bytes` of dynamic shared memory for `kernel` (above 48 KB it
// must be asked for; the call is cheap, so every launch makes it).
static inline cudaError_t oh_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
