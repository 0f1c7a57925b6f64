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
// whose lanes are then contiguous.
//
// What bounds it on an H100: bytes. Each lane of the segment is read once:
// its bin words (nbw 32-bit words) and grad/hess (8 bytes); the output is
// 2 * G * 256 floats. The work per byte is a compare and an add. The
// ownership design makes every thread of a group read every lane of its row
// block, so the compare work is 256/4 per lane and group: the kernel runs
// well above its byte bound (PERF.md), as hist_window.cu does, in exchange
// for a fixed summation order without atomics.
#include "payload_hist.cuh"

extern "C" int seg_hist_launch(const void* pay, long long np_,
                               const void* plan, int G, int grad_row,
                               long long start, long long length,
                               int nblocks, long long rows_per_block,
                               void* partial, void* out, void* stream) {
  return payload_hist_run(pay, np_, plan, G, grad_row, start, length,
                          nblocks, rows_per_block, partial, out,
                          reinterpret_cast<cudaStream_t>(stream));
}
