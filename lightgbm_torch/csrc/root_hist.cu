// root_hist: the root histogram of the payload and its grad/hess totals.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_grow.py:make_root_hist
// (kernel at :956, pallas_call at :996): one streaming pass over all n
// lanes, radix-16 one-hot MXU contractions per chunk, and the totals as f32
// chunk-partial sums.
//
// Contract: ops/payload_kernels.py:root_hist_plain, bit for bit on the CPU:
// the seg_hist arithmetic over lanes [0, n) (payload_hist.cuh), and the
// totals as f64 sums rounded to f32 (the port's v1 convention,
// ops/grow.py:156-158), not the TPU kernel's f32 chunk partials. The f64
// sums here add per-thread partials, then the block's tree, then the
// blocks in order, which is another order than torch's f64 sum on the
// CPU; the f64 results differ by a few units of 2^-53 at most, and the
// rounded f32 totals are equal unless the f64 sum lies that close to an
// f32 rounding boundary (chip_smoke.py checks them for equality).
//
// What bounds it on an H100: bytes, n * (4 * nbw + 8), about 0.1 ms for
// the 10.5M-row HIGGS root (nbw = 7) at 3.35 TB/s; like seg_hist it runs
// well above that bound (PERF.md).
#include "payload_hist.cuh"

extern "C" int root_hist_launch(const void* pay, long long np_,
                                const void* plan, int G, int grad_row,
                                long long n, int nblocks,
                                long long rows_per_block, void* partial,
                                void* out, void* sums_partial, void* sums,
                                void* stream) {
  return payload_hist_run(pay, np_, plan, G, grad_row, 0, n, nblocks,
                          rows_per_block, partial, out, sums_partial, sums,
                          reinterpret_cast<cudaStream_t>(stream));
}
