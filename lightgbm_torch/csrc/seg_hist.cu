// seg_hist: (grad, hess) histogram of one contiguous payload segment.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_grow.py:make_seg_hist
// (kernel at :884, pallas_call at :916), which streams the segment chunk by
// chunk into VMEM and accumulates radix-16 one-hot contractions on the MXU
// with a bf16 hi/lo split of the values. On Hopper the values are added in
// f32 directly, in a fixed order (payload_hist.cuh).
//
// Contract: ops/payload_kernels.py:seg_hist_plain, bit for bit on the CPU.
// The persistent grower calls it after split_pass for the smaller child,
// whose lanes are then contiguous and start at any lane.
//
// The segment (start, length) is read from device memory, where the
// grower's split_pass wrote the smaller child's, and the grower's done
// flag turns the call into a no-op; the grid is therefore fixed
// (payload_ordered.cuh's device-segment form). A host caller uploads its
// (start, length) and calls the same launcher.
//
// Design: payload_ordered.cuh's partial kernel over lanes [start, start +
// length), one group per block, then a reduce adds the row blocks in
// order. A child of up to 4 row blocks (65536 lanes at 28 groups) is
// at most 112 (row block, group) units for 132 multiprocessors; each unit
// is a serial pass over its row block, so there four teams per group sort
// four tiles at once and one walks them in order (two teams per group up
// to 9 row blocks).
//
// What bounds it on an H100: bytes at the bound, each lane of the segment
// read once (its nbw bin words and grad/hess) and 2 * G * 256 floats
// written. The counting sort's rank-and-scatter instructions keep it
// above that at a million lanes; a small child is bound by the latency of
// one row block's serial pass (about 0.04 ms for 16384 lanes) and the
// launches, against about 0.017 ms for one index_add_ there.
#include "payload_ordered.cuh"

struct SegHist {};   // the partial kernel's caller tag

// The histogram of lanes [seg[0], seg[0] + seg[1]) (seg: device int64[2]) of
// `pay` (of `alt` when *swap, a device int64 that may be NULL, is set: the
// grower's buffer parity) into out [2, G * 256] f32 on `stream`, unless *done
// (device int64; may be NULL) is set. partial is [max_nblocks, 2, G * 256] f32
// scratch, where max_nblocks is row_blocks' count of the longest segment the
// call may name; counter (may be NULL) is incremented once per histogram.
// Returns the first CUDA error of the launches, or 0.
extern "C" int seg_hist_launch(const void* pay, const void* alt,
                               const void* swap, long long np_,
                               const void* plan, int G, int grad_row,
                               const void* seg, const void* done,
                               int max_nblocks, void* partial, void* out,
                               void* counter, void* stream) {
  return (int)payload_ordered_run_dev<SegHist>(
      pay, alt, swap, np_, plan, G, grad_row, seg, done, max_nblocks,
      partial, out, counter, reinterpret_cast<cudaStream_t>(stream));
}
