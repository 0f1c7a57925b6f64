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
// What bounds it on an H100: bytes, each lane of the segments read once
// (4 * nbw + 8 bytes) and 2 * S * G * 256 floats written. Like seg_hist it
// runs far above that bound (the ownership design of payload_hist.cuh:
// every thread of a group reads every lane of its row block).
//
// Design: payload_hist.cuh's multi-segment form. A flat grid of (row block,
// group) blocks covers every segment's row blocks, each block finding its
// segment through slot_of_block and the segment's first block (the
// counterpart of the TPU's slot_of_step and base_of_slot); a second kernel
// adds each segment's blocks in order. No atomics.
#include "payload_hist.cuh"

extern "C" int level_seg_hist_launch(const void* pay, long long np_,
                                     const void* plan, int G, int grad_row,
                                     const void* seg, int S,
                                     const void* slot_of_block, int nblocks,
                                     void* partial, void* out, void* stream) {
  return payload_hist_multi_run(pay, np_, plan, G, grad_row, seg, S,
                                slot_of_block, nblocks, partial, out,
                                reinterpret_cast<cudaStream_t>(stream));
}
