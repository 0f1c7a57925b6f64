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
#include "ordered_hist.cuh"
#include "payload_hist.cuh"

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
payload_ordered_partial(const int32_t* __restrict__ pay, long long np_,
                        const int32_t* __restrict__ plan, int grad_row,
                        int G, long long start, long long length,
                        long long rows_per_block,
                        const long long* __restrict__ seg,
                        const int* __restrict__ slot_of_block,
                        float* __restrict__ partial,
                        double* __restrict__ sums_partial) {
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
template <class Caller, int T>
static cudaError_t po_partial(const int32_t* pay, long long np_,
                              const int32_t* plan, int grad_row, int G,
                              long long start, long long length,
                              long long rows_per_block, const long long* seg,
                              const int* slot_of_block, int nblocks,
                              float* partial, double* sums_partial,
                              cudaStream_t s) {
  const size_t smem = sizeof(PoShared<T>);
  cudaError_t err =
      oh_smem((const void*)payload_ordered_partial<Caller, T>, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)G * nblocks;
  payload_ordered_partial<Caller, T><<<(unsigned)grid, T * OH_TEAM, smem, s>>>(
      pay, np_, plan, grad_row, G, start, length, rows_per_block, seg,
      slot_of_block, partial, sums_partial);
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
  if (blocks <= sms * po_resident<Caller, 4>())
    return run(integral_constant<int, 4>());
  if (blocks <= sms * po_resident<Caller, 2>())
    return run(integral_constant<int, 2>());
  return run(integral_constant<int, 1>());
}
