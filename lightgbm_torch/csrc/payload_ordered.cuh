// payload_ordered.cuh: the payload histograms on ordered_hist.cuh's
// counting sort, shared by root_hist.cu, seg_hist.cu and level_seg_hist.cu.
//
// The payload is the persistent grower's [WPA, NP] int32 matrix
// (payload_hist.cuh has its layout and the contract): group g's bin of
// lane i is (pay[w * NP + i] >> sh) & mk with (w, sh, mk) = plan[g], grad
// and hess are the f32 bits of rows grad_row and grad_row + 1. A segment
// is cut into row blocks (ops/histogram.py:row_blocks); within a row
// block each (group, bin) is one f32 chain in lane order, and
// payload_hist.cuh's reduces add the row blocks in order.
//
// One partial kernel body serves every caller. Its lanes are one segment
// (start, length, rows per block: root_hist over [0, n), seg_hist) or
// the segments of a [S, PH_SEG] table (level_seg_hist: each flat row
// block finds its segment through slot_of_block and the segment's first
// block, as payload_hist.cuh's many-segment form does). Block (group, row
// block) covers one group of one row block with T teams of 128 threads,
// on a one-dimensional grid with the group as the fastest index, so that
// the blocks of one row block run together and all but the first read
// its lanes from L2. Per super-tile of T * 1024 lanes the block stages,
// with 4-byte cp.async into the other of two buffers while the current
// one is sorted, the lanes' grad/hess and its group's payload word; the
// 4-byte copies need no alignment, so a segment may start at any lane.
// Each team decodes its tile's bins (plan[g]) and sorts it (oh_sort);
// the first team walks the T sorted tiles in lane order (oh_walk), so
// each bin stays one chain in lane order. A row block with no lanes (a
// zero-length segment) stages nothing and still writes its zero
// partials. With sums_partial, the group-0 block of each row block also
// writes the f64 sums of the row block's grad and hess (root_hist's
// totals).
//
// The device-segment form (payload_ordered_run_dev: seg_hist and the
// in-pass histogram of split_pass on the persistent grower's per-split
// loop) reads (start, length) from device memory and may be skipped by
// the grower's done flag, so its grid is fixed: each block computes the
// segment's row blocks (po_row_blocks, ops/histogram.py:row_blocks's
// integer formula) and the team count from the device length, and a block
// past the segment's row blocks, or of a team count other than the one
// the length picks, returns at once. One launch per team count (4, 2 and
// 1, each sized for the longest segment that picks it) covers every
// length; the team count changes the speed, never the bits.
//
// payload_ordered_run picks T: 4 while the G * nblocks blocks fit
// one wave at one block of 512 threads per multiprocessor, 2 at two of
// 256, else 1 (six blocks of 128 share a multiprocessor, so that one
// block's barriers hide behind another's work). PERF.md has the shape
// sweep on an H100 that chose one group per block over K groups per
// block sharing one staged tile (hist_window.cu's shape).
//
// The kernel is a template on its caller (a tag type of root_hist.cu,
// seg_hist.cu or level_seg_hist.cu), so that a profile tells the three
// apart by name.
//
// What bounds it on an H100: at the byte bound each lane's bin words and
// grad/hess are read once, length * (4 * nbw + 8) bytes. The grad/hess
// rows are read once per group, all but the first from L2, and each
// word row once per group. With bins spread over the width the
// rank-and-scatter instructions (a few dozen per lane and group) and
// those L2 reads bound it; where most lanes of a tile share one bin
// (leaf-ordered children on their ancestors' split features, Expo's
// one-hot bundles), that bin's serial chain bounds the tile
// (ordered_hist.cuh).
#pragma once
#include <algorithm>

#include "ordered_hist.cuh"
#include "payload_hist.cuh"

// (row blocks, rows per block) of a segment of `length` lanes over G
// groups: ops/histogram.py:row_blocks (about 528 blocks over all groups,
// none under 16384 rows), the same integers on the host and the card.
static __host__ __device__ __forceinline__ void po_row_blocks(
    long long length, int G, long long* nb, long long* rows) {
  const long long gg = G > 1 ? G : 1;
  const long long per_group = (528 + gg - 1) / gg;
  long long r = (length + per_group - 1) / per_group;
  if (r < 16384) r = 16384;
  const long long n = (length + r - 1) / r;
  *rows = r;
  *nb = n < 1 ? 1 : n;
}

// The team count of a launch of `blocks` blocks: 4 while they fit one
// wave at lim4 resident blocks of 512 threads, 2 at lim2 of 256, else 1.
static __host__ __device__ __forceinline__ int po_teams(long long blocks,
                                                        long long lim4,
                                                        long long lim2) {
  return blocks <= lim4 ? 4 : blocks <= lim2 ? 2 : 1;
}

// One staging buffer: a super-tile's (grad, hess) and bin words, T tiles.
template <int T>
struct PoStage {
  float2 v[T * OH_TILE];
  int32_t w[T * OH_TILE];
};

// Queue the copies of lanes [i0, i0 + m) into `st`: grad, hess and the
// group's payload word row.
template <int T>
static __device__ __forceinline__ void po_stage(
    PoStage<T>& st, const int32_t* __restrict__ word_row,
    const float* grad, const float* hess, long long i0, int m) {
  for (int i = threadIdx.x; i < m; i += T * OH_TEAM) {
    oh_copy4(&st.v[i].x, grad + i0 + i);
    oh_copy4(&st.v[i].y, hess + i0 + i);
    oh_copy4(&st.w[i], word_row + i0 + i);
  }
}

// Each team's returned slots, read by the first team (none with one
// team).
template <int T>
struct PoSpans {
  int4 span[T][OH_TEAM];
};

template <>
struct PoSpans<1> {};

// The shared memory of a block: the teams' sort buffers, their slots and
// two staging buffers.
template <int T>
struct PoShared {
  OhShared<T> sort;
  PoSpans<T> spans;
  PoStage<T> stage[2];
};

// Block (group, row block) of the grid: the partials of group g over one
// row block's lanes, T teams. seg == nullptr: row block rb of lanes
// [start, start + length) cut every rows_per_block lanes; else row block
// rb of the table seg (PH_SEG columns) through slot_of_block. partial is
// [row blocks, 2, G * 256]; sums_partial, where not null, [row blocks, 2]
// f64.
//
// Team r takes tile r of each super-tile of T * 1024 lanes, and the T
// teams sort their tiles at once; then the first team walks the T sorted
// tiles in lane order. Every team owns the same bins (oh_bin0 with one
// rotation), so the first team's threads find their bins' slots in each.
template <class Caller, int T>
__global__ void __launch_bounds__(T * OH_TEAM)
payload_ordered_partial(const int32_t* pay, long long np_,
                        const int32_t* __restrict__ plan, int grad_row,
                        int G, long long start, long long length,
                        long long rows_per_block,
                        const long long* __restrict__ seg,
                        const int* __restrict__ slot_of_block,
                        float* __restrict__ partial,
                        double* __restrict__ sums_partial,
                        const long long* __restrict__ dseg,
                        const long long* __restrict__ done, int lim4,
                        int lim2, const int32_t* pay_alt,
                        const long long* swap) {
  constexpr int NT = T * OH_TEAM;              // threads per block
  constexpr int SUPER = T * OH_TILE;           // lanes per super-tile
  extern __shared__ __align__(16) unsigned char smem[];
  PoShared<T>& sh_ = *reinterpret_cast<PoShared<T>*>(smem);
  OhShared<T>& s = sh_.sort;
  const int t = threadIdx.x;
  const int tt = t % OH_TEAM;
  const int r = t / OH_TEAM;                   // team: tile of the super-tile
  const long long rb = blockIdx.x / G;
  const int g = (int)(blockIdx.x % G);
  if (dseg != nullptr) {               // the device-segment form
    if (done != nullptr && *done != 0) return;
    start = dseg[0];
    length = dseg[1];
    long long nb;
    po_row_blocks(length, G, &nb, &rows_per_block);
    if (rb >= nb || po_teams(G * nb, lim4, lim2) != T) return;
    if (swap != nullptr && *swap != 0) pay = pay_alt;
  }
  long long r_begin, r_end;
  if (seg != nullptr) {
    const long long* sj = seg + (long long)slot_of_block[rb] * PH_SEG;
    const long long b = rb - sj[PH_BASE];
    r_begin = sj[PH_START] + b * sj[PH_ROWS];
    r_end = sj[PH_START] + min(sj[PH_LEN], (b + 1) * sj[PH_ROWS]);
  } else {
    r_begin = start + rb * rows_per_block;
    r_end = start + min(length, (rb + 1) * rows_per_block);
  }
  const int32_t* word_row = pay + (long long)plan[3 * g] * np_;
  const unsigned sh = (unsigned)plan[3 * g + 1];
  const unsigned mk = (unsigned)plan[3 * g + 2];
  const int nbits = 32 - __clz((int)mk);     // 8 for a byte, 4 for a nibble
  const float* grad = reinterpret_cast<const float*>(pay + grad_row * np_);
  const float* hess = grad + np_;
  const bool do_sums = sums_partial != nullptr && g == 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  double sum_g = 0.0, sum_h = 0.0;
  oh_begin(s);
  if (r_begin < r_end)
    po_stage(sh_.stage[0], word_row, grad, hess, r_begin,
             (int)min((long long)SUPER, r_end - r_begin));
  oh_commit();
  int k = 0;
  for (long long i0 = r_begin; i0 < r_end; i0 += SUPER, ++k) {
    if (i0 + SUPER < r_end)
      po_stage(sh_.stage[(k + 1) & 1], word_row, grad, hess, i0 + SUPER,
               (int)min((long long)SUPER, r_end - i0 - SUPER));
    oh_commit();
    oh_wait(1);                        // this tile's copies have landed
    __syncthreads();
    const PoStage<T>& st = sh_.stage[k & 1];
    const int m = (int)min((long long)SUPER, r_end - i0);
    if (do_sums) {
      for (int i = t; i < m; i += NT) {
        sum_g += (double)st.v[i].x;
        sum_h += (double)st.v[i].y;
      }
    }
    const int n = max(0, min(OH_TILE, m - r * OH_TILE));
    const int32_t* word = st.w + r * OH_TILE;
    const int4 sp = oh_sort(s, r, 0, st.v + r * OH_TILE, n, OH_BINS, nbits,
                            true, [=](int i) {
                              return ((unsigned)word[i] >> sh) & mk;
                            });
    if constexpr (T == 1) {
      oh_walk(s.sorted[0], sp, acc);
    } else {
      sh_.spans.span[r][tt] = sp;
      __syncthreads();
      if (r == 0)
        for (int q = 0; q < T; ++q)
          oh_walk(s.sorted[q], sh_.spans.span[q][tt], acc);
    }
  }
  oh_wait(0);
  const long long cells = (long long)G * OH_BINS;
  if (r == 0) {
    float* o = partial + rb * 2 * cells + g * OH_BINS;
    const int b0 = oh_bin0(0, tt);
    o[b0] = acc[0];
    o[b0 + 1] = acc[2];
    o[cells + b0] = acc[1];
    o[cells + b0 + 1] = acc[3];
  }
  if (do_sums) {
    __syncthreads();                   // the walk is done with s.sorted
    double* red = reinterpret_cast<double*>(&s.sorted[0][0]);
    red[t] = sum_g;
    red[NT + t] = sum_h;
    __syncthreads();
    for (int k2 = NT / 2; k2 > 0; k2 >>= 1) {
      if (t < k2) {
        red[t] += red[t + k2];
        red[NT + t] += red[NT + t + k2];
      }
      __syncthreads();
    }
    if (t == 0) {
      sums_partial[2 * rb] = red[0];
      sums_partial[2 * rb + 1] = red[NT];
    }
  }
}

// Blocks of payload_ordered_partial<Caller, T> that one multiprocessor
// holds at once (the occupancy calculator, once per kernel).
template <class Caller, int T>
static inline int po_resident() {
  static int n = 0;
  if (n == 0) {
    const void* f = (const void*)payload_ordered_partial<Caller, T>;
    const size_t smem = sizeof(PoShared<T>);
    if (oh_smem(f, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f, T * OH_TEAM,
                                                      smem) != cudaSuccess ||
        n < 1)
      n = 1;
  }
  return n;
}

// Launch the partial kernel with T teams over nblocks row blocks.
// (The shared-memory attribute is set once per kernel, on its first
// launch, so that a later launch inside a graph capture makes no runtime
// call but the launch.)
template <class Caller, int T>
static cudaError_t po_partial(const int32_t* pay, long long np_,
                              const int32_t* plan, int grad_row, int G,
                              long long start, long long length,
                              long long rows_per_block, const long long* seg,
                              const int* slot_of_block, int nblocks,
                              float* partial, double* sums_partial,
                              cudaStream_t s,
                              const long long* dseg = nullptr,
                              const long long* done = nullptr, int lim4 = 0,
                              int lim2 = 0, const int32_t* pay_alt = nullptr,
                              const long long* swap = nullptr) {
  const size_t smem = sizeof(PoShared<T>);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        oh_smem((const void*)payload_ordered_partial<Caller, T>, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long grid = (long long)G * nblocks;
  payload_ordered_partial<Caller, T><<<(unsigned)grid, T * OH_TEAM, smem, s>>>(
      pay, np_, plan, grad_row, G, start, length, rows_per_block, seg,
      slot_of_block, partial, sums_partial, dseg, done, lim4, lim2, pay_alt,
      swap);
  return cudaGetLastError();
}

// Queue the partials of nblocks row blocks on `s`: of lanes [start, start
// + length) (seg == nullptr) or of the segment table seg, with 4 teams
// while the G * nblocks blocks fit the card in one wave at 512 threads a
// block, 2 while they fit at 256, else 1. The caller adds the row blocks
// with one of payload_hist.cuh's reduces.
template <class Caller>
static inline cudaError_t payload_ordered_run(
    const void* pay, long long np_, const void* plan, int G, int grad_row,
    long long start, long long length, long long rows_per_block,
    const void* seg, const void* slot_of_block, int nblocks, void* partial,
    void* sums_partial, cudaStream_t s) {
  auto run = [&](auto tc) {
    return po_partial<Caller, decltype(tc)::value>(
        static_cast<const int32_t*>(pay), np_,
        static_cast<const int32_t*>(plan), grad_row, G, start, length,
        rows_per_block, static_cast<const long long*>(seg),
        static_cast<const int*>(slot_of_block), nblocks,
        static_cast<float*>(partial), static_cast<double*>(sums_partial), s);
  };
  const long long blocks = (long long)G * nblocks;
  const long long sms = oh_multiprocessors();
  using std::integral_constant;
  switch (po_teams(blocks, sms * po_resident<Caller, 4>(),
                   sms * po_resident<Caller, 2>())) {
    case 4: return run(integral_constant<int, 4>());
    case 2: return run(integral_constant<int, 2>());
    default: return run(integral_constant<int, 1>());
  }
}

// out = the row blocks of partial added in order, (start, length) = dseg
// on the device; nothing when *done is set. Block 0 counts the histogram.
__global__ void payload_hist_reduce_dev(const float* __restrict__ partial,
                                        const long long* __restrict__ dseg,
                                        const long long* done, int G,
                                        float* __restrict__ out,
                                        long long* counter) {
  if (done != nullptr && *done != 0) return;
  long long nb, rows;
  po_row_blocks(dseg[1], G, &nb, &rows);
  const long long cells2 = 2LL * G * PH_BINS;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < cells2) {
    float acc = partial[c];
    for (long long b = 1; b < nb; ++b) acc += partial[b * cells2 + c];
    out[c] = acc;
  }
  if (counter != nullptr && c == 0) *counter += 1;
}

// The histogram of the device segment dseg = (start, length) of `pay` (of
// `alt` when *swap is set) into out [2, G * 256] on `s`, unless *done: one
// partial launch per team count over a fixed grid (each sized for the longest
// segment of at most max_nblocks row blocks that picks it), then the reduce.
// partial is [max_nblocks, 2, G * 256] scratch.
template <class Caller>
static inline cudaError_t payload_ordered_run_dev(
    const void* pay, const void* alt, const void* swap, long long np_,
    const void* plan, int G, int grad_row,
    const void* dseg, const void* done, int max_nblocks, void* partial,
    void* out, void* counter, cudaStream_t s) {
  const long long sms = oh_multiprocessors();
  const long long lim4 = sms * po_resident<Caller, 4>();
  const long long lim2 = sms * po_resident<Caller, 2>();
  const long long* ds = static_cast<const long long*>(dseg);
  const long long* dn = static_cast<const long long*>(done);
  auto run = [&](auto tc, long long nb) -> cudaError_t {
    if (nb < 1) return cudaSuccess;
    return po_partial<Caller, decltype(tc)::value>(
        static_cast<const int32_t*>(pay), np_,
        static_cast<const int32_t*>(plan), grad_row, G, 0, 0, 0, nullptr,
        nullptr, (int)nb, static_cast<float*>(partial), nullptr, s, ds, dn,
        (int)lim4, (int)lim2, static_cast<const int32_t*>(alt),
        static_cast<const long long*>(swap));
  };
  using std::integral_constant;
  // the most row blocks for which each team count is picked
  const long long nb4 = std::min<long long>(max_nblocks, lim4 / G);
  const long long nb2 = std::min<long long>(max_nblocks, lim2 / G);
  cudaError_t err = run(integral_constant<int, 4>(), nb4);
  if (err == cudaSuccess && nb2 > nb4)
    err = run(integral_constant<int, 2>(), nb2);
  if (err == cudaSuccess && max_nblocks > std::max(nb2, nb4))
    err = run(integral_constant<int, 1>(), max_nblocks);
  if (err != cudaSuccess) return err;
  const long long cells2 = 2LL * G * PH_BINS;
  payload_hist_reduce_dev<<<(unsigned)((cells2 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), ds, dn, G,
      static_cast<float*>(out), static_cast<long long*>(counter));
  return cudaGetLastError();
}
