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
// Design: payload_ordered.cuh's partial kernel over the one segment
// [0, n) with the totals (one group and one team per block at the HIGGS
// root, 28 groups in 19 row blocks, and at Expo's, 18 groups in 30), then
// payload_hist.cuh's reduce adds the row blocks in order and the f64
// totals.
//
// What bounds it on an H100: at the byte bound, n * (4 * nbw + 8) bytes,
// about 0.1 ms for the 10.5M-lane HIGGS root (nbw = 7) at 3.35 TB/s; the
// counting sort's rank-and-scatter instructions and, on skewed tiles, the
// heaviest bin's chain keep it well above that (payload_ordered.cuh).
#include "payload_ordered.cuh"

struct RootHist {};  // the partial kernel's caller tag

// counter (a device int64; may be NULL) is incremented once per launch.
extern "C" int root_hist_launch(const void* pay, long long np_,
                                const void* plan, int G, int grad_row,
                                long long n, int nblocks,
                                long long rows_per_block, void* partial,
                                void* out, void* sums_partial, void* sums,
                                void* counter, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = payload_ordered_run<RootHist>(
      pay, np_, plan, G, grad_row, 0, n, rows_per_block, nullptr, nullptr,
      nblocks, partial, sums_partial, s);
  if (err != cudaSuccess) return (int)err;
  return payload_hist_finish(partial, nblocks, G, out, sums_partial, sums,
                             s, counter);
}
