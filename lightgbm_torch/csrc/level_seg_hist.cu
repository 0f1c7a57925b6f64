// level_seg_hist: (grad, hess) histograms of S contiguous payload segments
// in one launch.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_grow.py:make_level_seg_hist
// (kernel at :802, pallas_call at :839): seg_hist for up to S_max segments,
// the slot of each sequential grid step taken from prefetched step tables,
// radix-16 one-hot MXU contractions per chunk.
//
// Contract: ops/payload_kernels.py:level_seg_hist_plain, bit for bit on the
// CPU: slot j's planes are seg_hist_plain of its segment (the same row
// blocks, the same f32 chain per bin, the blocks added in order). A
// zero-length segment gives zeros (the TPU kernel leaves it undefined).
// The persistent grower's level phase calls it for the smaller children
// after level_pass when G > 20.
//
// Design: payload_ordered.cuh's partial kernel over the segment table
// (payload_hist.cuh's [S, PH_SEG] table and slot_of_block, the
// counterparts of the TPU's base_of_slot and slot_of_step): block (group,
// flat row block) finds its segment and its lanes there, then
// payload_hist.cuh's many-segment reduce adds each segment's row blocks
// in order. No atomics.
//
// What bounds it on an H100: bytes at the bound, each lane of the segments
// read once (4 * nbw + 8 bytes) and 2 * S * G * 256 floats written; the
// counting sort's instructions keep it above that. The grid of a deep
// level takes several waves (128 children of about 41k HIGGS lanes: about
// 390 row blocks x 28 groups); one group and one team per block lets six
// blocks share a multiprocessor, which hides the sort's barriers better
// than fewer, wider blocks (PERF.md has the measured shapes).
#include "payload_ordered.cuh"

struct LevelSegHist {};  // the partial kernel's caller tag

extern "C" int level_seg_hist_launch(const void* pay, long long np_,
                                     const void* plan, int G, int grad_row,
                                     const void* seg, int S,
                                     const void* slot_of_block, int nblocks,
                                     void* partial, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = payload_ordered_run<LevelSegHist>(
      pay, np_, plan, G, grad_row, 0, 0, 0, seg, slot_of_block, nblocks,
      partial, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  return payload_hist_multi_finish(partial, seg, S, G, out, s);
}
