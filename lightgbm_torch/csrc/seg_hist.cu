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
// Design: payload_ordered.cuh's partial kernel over lanes [start, start +
// length), one group per block, then payload_hist.cuh's reduce adds the
// row blocks in order; a segment of one row block writes its planes
// directly. A child of up to 4 row blocks (65536 lanes at 28 groups) is
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

extern "C" int seg_hist_launch(const void* pay, long long np_,
                               const void* plan, int G, int grad_row,
                               long long start, long long length,
                               int nblocks, long long rows_per_block,
                               void* partial, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = payload_ordered_run<SegHist>(
      pay, np_, plan, G, grad_row, start, length, rows_per_block, nullptr,
      nullptr, nblocks, partial, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  if (partial == out) return 0;
  return payload_hist_finish(partial, nblocks, G, out, nullptr, nullptr, s);
}
