// root_hist: the root histogram of the payload and its grad/hess totals.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_grow.py:make_root_hist
// (kernel at :956, pallas_call at :996): one streaming pass over all n
// lanes, radix-16 one-hot MXU contractions per chunk, and the totals as f32
// chunk-partial sums.
//
// Contract: ops/payload_kernels.py:root_hist_plain, bit for bit on the CPU:
// the seg_hist arithmetic over lanes [0, n) (row blocks of
// ops/histogram.py:row_blocks, one f32 chain per (group, bin) in lane order
// inside a block, the blocks added in order), and the totals as f64 sums
// rounded to f32 (the port's v1 convention, ops/grow.py:156-158), not the
// TPU kernel's f32 chunk partials. The f64 sums here add per-thread
// partials, then the block's tree, then the blocks in order, which is
// another order than torch's f64 sum on the CPU; the f64 results differ by
// a few units of 2^-53 at most, and the rounded f32 totals are equal unless
// the f64 sum lies that close to an f32 rounding boundary (chip_smoke.py
// checks them for equality).
//
// Design: the per-tile stable counting sort of ordered_hist.cuh. Block
// (chunk, row block) covers K consecutive groups of one row block
// (oh_groups_per_block: 5 at the HIGGS root, 28 groups in 19 row blocks,
// and at Expo's, 18 groups in 30), one 128-thread team per group, with the
// chunk index fastest in the grid so that the blocks of one row block run
// together. Per tile of 1024 lanes the block stages, with cp.async into
// the other of two buffers while the current tile is sorted, the lanes'
// grad/hess once for its K groups and each distinct payload word row of
// its groups once (HIGGS's byte groups share a word four to one); each
// team decodes its group's bins from the staged word (plan[g]), sorts them
// and walks the chains. payload_hist.cuh's reduce adds the row blocks in
// order and the f64 totals.
//
// What bounds it on an H100: at the byte bound, n * (4 * nbw + 8) bytes,
// about 0.1 ms for the 10.5M-lane HIGGS root (nbw = 7) at 3.35 TB/s. This
// design reads each lane from device memory about once; the grad/hess
// rows are read once per chunk from L2 and the word rows once per group.
// With bins spread over the width it is bound by the rank-and-scatter
// instructions (a few dozen per lane and group) and those L2 reads; where
// most lanes of a tile share one bin (Expo's one-hot bundles, whose
// shared zero bin holds most lanes), that bin's serial chain bounds the
// tile (ordered_hist.cuh).
#include "ordered_hist.cuh"
#include "payload_hist.cuh"

// One staging buffer: a tile's (grad, hess) and bin words.
template <int K>
struct RhStage {
  float2 v[OH_TILE];
  int32_t w[K][OH_TILE];
};

// Queue the copies of lanes [i0, i0 + m) into `st`: grad, hess, and word
// row rows[tm] into slot tm (a negative row: no copy).
template <int K>
static __device__ __forceinline__ void rh_stage(
    RhStage<K>& st, const int32_t* __restrict__ pay, long long np_,
    const int (&rows)[K], const float* grad, const float* hess,
    long long i0, int m) {
  const int t = threadIdx.x;
  for (int i = t; i < m; i += K * OH_TEAM) {
    oh_copy4(&st.v[i].x, grad + i0 + i);
    oh_copy4(&st.v[i].y, hess + i0 + i);
  }
#pragma unroll
  for (int tm = 0; tm < K; ++tm) {
    if (rows[tm] < 0) continue;
    const int32_t* src = pay + (long long)rows[tm] * np_ + i0;
    for (int i = t; i < m; i += K * OH_TEAM) oh_copy4(&st.w[tm][i], src + i);
  }
}

template <int K>
__global__ void __launch_bounds__(K * OH_TEAM)
root_hist_partial(const int32_t* __restrict__ pay, long long np_,
                  const int32_t* __restrict__ plan, int grad_row, long long n,
                  int G, long long rows_per_block,
                  float* __restrict__ partial,
                  double* __restrict__ sums_partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  OhShared<K>& s = *reinterpret_cast<OhShared<K>*>(smem);
  RhStage<K>* stage =
      reinterpret_cast<RhStage<K>*>(smem + sizeof(OhShared<K>));
  const int t = threadIdx.x;
  const int team = t / OH_TEAM;
  const int g0 = blockIdx.x * K;
  const int g = g0 + team;
  const bool live = g < G;
  // each distinct word row of the block's groups is staged once, in the
  // slot of the first group that reads it; `slot` is this team's
  int rows[K];
  int slot = team;
#pragma unroll
  for (int tm = 0; tm < K; ++tm) {
    const int w = g0 + tm < G ? plan[3 * (g0 + tm)] : -1;
    int first = tm;
    for (int u = 0; u < tm; ++u)
      if (first == tm && g0 + u < G && plan[3 * (g0 + u)] == w) first = u;
    rows[tm] = first == tm ? w : -1;
    if (tm == team && first != tm) slot = first;
  }
  const unsigned sh = live ? (unsigned)plan[3 * g + 1] : 0u;
  const unsigned mk = live ? (unsigned)plan[3 * g + 2] : 0u;
  const int nbits = 32 - __clz((int)mk);     // 8 for a byte, 4 for a nibble
  const long long r_begin = (long long)blockIdx.y * rows_per_block;
  const long long r_end = min(n, r_begin + rows_per_block);
  const float* grad = reinterpret_cast<const float*>(pay + grad_row * np_);
  const float* hess = grad + np_;
  const bool do_sums = blockIdx.x == 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  double sum_g = 0.0, sum_h = 0.0;
  oh_begin(s);
  if (r_begin < r_end)
    rh_stage(stage[0], pay, np_, rows, grad, hess, r_begin,
             (int)min((long long)OH_TILE, r_end - r_begin));
  oh_commit();
  int k = 0;
  for (long long i0 = r_begin; i0 < r_end; i0 += OH_TILE, ++k) {
    if (i0 + OH_TILE < r_end)
      rh_stage(stage[(k + 1) & 1], pay, np_, rows, grad, hess, i0 + OH_TILE,
               (int)min((long long)OH_TILE, r_end - i0 - OH_TILE));
    oh_commit();
    oh_wait(1);                        // this tile's copies have landed
    __syncthreads();
    const RhStage<K>& st = stage[k & 1];
    const int m = (int)min((long long)OH_TILE, r_end - i0);
    if (do_sums) {
      for (int i = t; i < m; i += K * OH_TEAM) {
        sum_g += (double)st.v[i].x;
        sum_h += (double)st.v[i].y;
      }
    }
    const int32_t* word = st.w[slot];
    oh_tile(s, st.v, m, OH_BINS, nbits, live,
            [=](int i) { return ((unsigned)word[i] >> sh) & mk; }, acc);
  }
  oh_wait(0);
  const long long cells = (long long)G * OH_BINS;
  if (live) {
    float* o = partial + (long long)blockIdx.y * 2 * cells + g * OH_BINS;
    const int b0 = oh_bin0(team, t % OH_TEAM);
    o[b0] = acc[0];
    o[b0 + 1] = acc[2];
    o[cells + b0] = acc[1];
    o[cells + b0 + 1] = acc[3];
  }
  if (do_sums) {
    __syncthreads();                   // the walk is done with s.sorted
    double* red = reinterpret_cast<double*>(&s.sorted[0][0]);
    red[t] = sum_g;
    red[K * OH_TEAM + t] = sum_h;
    __syncthreads();
    // a tree over the block's threads (K * OH_TEAM need not be a power
    // of two: the first step folds the top down onto a power of two)
    int top = 1;
    while (2 * top < K * OH_TEAM) top *= 2;
    for (int k2 = top; k2 > 0; k2 >>= 1) {
      if (t < k2 && t + k2 < K * OH_TEAM) {
        red[t] += red[t + k2];
        red[K * OH_TEAM + t] += red[K * OH_TEAM + t + k2];
      }
      __syncthreads();
    }
    if (t == 0) {
      sums_partial[2 * blockIdx.y] = red[0];
      sums_partial[2 * blockIdx.y + 1] = red[K * OH_TEAM];
    }
  }
}

// Launch the partial kernel with K groups per block (grid: K-group chunk
// fastest, then the row block).
template <int K>
static cudaError_t rh_partial(const int32_t* pay, long long np_,
                              const int32_t* plan, int grad_row, long long n,
                              int G, int nblocks, long long rows_per_block,
                              float* partial, double* sums_partial,
                              cudaStream_t s) {
  const size_t smem = sizeof(OhShared<K>) + 2 * sizeof(RhStage<K>);
  cudaError_t err = oh_smem((const void*)root_hist_partial<K>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G + K - 1) / K, nblocks);
  root_hist_partial<K><<<grid, K * OH_TEAM, smem, s>>>(
      pay, np_, plan, grad_row, n, G, rows_per_block, partial, sums_partial);
  return cudaGetLastError();
}

extern "C" int root_hist_launch(const void* pay, long long np_,
                                const void* plan, int G, int grad_row,
                                long long n, int nblocks,
                                long long rows_per_block, void* partial,
                                void* out, void* sums_partial, void* sums,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(pay);
  const int32_t* pl = static_cast<const int32_t*>(plan);
  float* part = static_cast<float*>(partial);
  double* sp = static_cast<double*>(sums_partial);
  cudaError_t err =
      oh_with_groups(oh_groups_per_block(G, nblocks), [&](auto k) {
        return rh_partial<decltype(k)::value>(p, np_, pl, grad_row, n, G,
                                              nblocks, rows_per_block, part,
                                              sp, s);
      });
  if (err != cudaSuccess) return (int)err;
  const long long cells2 = 2LL * G * OH_BINS;
  payload_hist_reduce<<<(unsigned)((cells2 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), nblocks, cells2,
      static_cast<float*>(out), static_cast<const double*>(sums_partial),
      static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
