// The tree walk of prediction: raw scores or leaf indices of raw feature
// rows under a compiled ensemble.
//
// No Pallas counterpart: the JAX package walks its compiled ensemble in
// XLA (lightgbm_tpu/predict/runtime.py:_traverse_bucket:85, a fori_loop of
// gather-selects per depth bucket, then a sequential lax.scan over the
// iterations, :197, so that the f64 sums equal the numpy walk's). Written
// as PyTorch ops that is a dozen launches per tree level; here one launch
// walks every tree of the ensemble over every row.
//
// Rows: X [n, F] row-major, f64 (or f32 in the f32 mode). Trees
// (lightgbm_torch/predict/compile.py:flatten): node records [Nn, 8] int32,
// one 32-byte record per node slot (feature, decision type, left, right,
// categorical word offset and count, the threshold's bits: f64 as low and
// high word, or the f32's bits and 0), tree t's nodes from tree_node[t],
// its leaf values (f64 or f32) from tree_leaf[t]; words [W] u32, the
// bitsets of every categorical node. A child >= 0 is a node of the same
// tree, < 0 the leaf ~child; a tree of one leaf is a stub node whose
// children are both leaf 0.
//
// The decision is models/tree.py:_decision's, exactly: a NaN is 0 unless
// the missing type is NaN; zero (|v| <= kZeroThreshold) or NaN takes the
// default direction by missing type; otherwise v <= threshold. A
// categorical node tests int(v) against its bitset words: NaN counts as
// category 0 (NaN with missing type NaN goes right), a negative value goes
// right, a word past the node's count goes right. A value of 2^34 or more
// goes right without a cast (its word is past any count; numpy's cast of a
// value past int64 gives a negative number, which goes right too).
//
// raw mode: one thread per (row r, class k) walks the trees t = k, k + K,
// ... in model order and sums their leaf values from +0.0, one add per
// tree, the order of GBDT.predict_raw's numpy walk (out[:, i % K] +=), so
// the f64 result equals it bit for bit (built with -fmad=false; no add is
// reordered or fused). With average_output the sum is then divided by the
// number of iterations T / K (IEEE division), as numpy's out /= niter.
// Output [n, K]. leaf mode: one thread per (row r, tree t) writes the leaf
// index (int32) to out [n, T].
//
// What bounds it: every node visit is a dependent load (the record, then
// the row's feature value), so the walk is bound by load latency, far
// above the bytes bound (X read once, the output written once). The
// records are read through the read-only cache; the ensemble (100 trees of
// 255 leaves: 0.8 MB) stays in L2. Design for later: stage a tree block in
// shared memory and walk several trees per thread to overlap the chains.
#include <cuda_runtime.h>
#include <stdint.h>

#define PW_THREADS 256
#define PW_K_ZERO 1e-35

template <typename V>
static __device__ __forceinline__ V pw_threshold(int4 b);

template <>
__device__ __forceinline__ double pw_threshold<double>(int4 b) {
  return __hiloint2double(b.w, b.z);
}

template <>
__device__ __forceinline__ float pw_threshold<float>(int4 b) {
  return __int_as_float(b.z);
}

// The leaf of one row `x` in the tree whose nodes start at record `base`.
template <typename V>
static __device__ __forceinline__ int pw_leaf(
    const V* __restrict__ x, const int4* __restrict__ rec, int base,
    const unsigned* __restrict__ words, int n_words) {
  int node = 0;
  while (node >= 0) {
    const int4 a = __ldg(rec + 2 * (base + node));
    const int4 b = __ldg(rec + 2 * (base + node) + 1);
    const V v = __ldg(x + a.x);
    const int dt = a.y;
    const int mt = (dt >> 2) & 3;
    const bool is_nan = v != v;
    bool left;
    if (dt & 1) {
      if (is_nan && mt == 2) {
        left = false;
      } else {
        const V fv = is_nan ? V(0) : v;
        if (fv < V(0) || fv >= V(17179869184.0)) {   // negative, or >= 2^34
          left = false;
        } else {
          const long long iv = (long long)fv;
          const long long w = iv >> 5;
          const long long at = (long long)b.x + w;
          left = w < b.y && at < n_words &&
                 ((__ldg(words + at) >> (unsigned)(iv & 31)) & 1u) != 0;
        }
      }
    } else {
      const V fv = (is_nan && mt != 2) ? V(0) : v;
      const bool dflt = (mt == 1 && fabs(fv) <= V(PW_K_ZERO)) ||
                        (mt == 2 && is_nan);
      left = dflt ? (dt & 2) != 0 : fv <= pw_threshold<V>(b);
    }
    node = left ? a.z : a.w;
  }
  return ~node;
}

template <typename V>
__global__ void __launch_bounds__(PW_THREADS)
predict_raw(const V* __restrict__ X, long long n, int F,
            const int4* __restrict__ rec, const int* __restrict__ tree_node,
            const int* __restrict__ tree_leaf, int T,
            const V* __restrict__ leaves, const unsigned* __restrict__ words,
            int n_words, int K, int average, V* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * K) return;
  const long long r = i / K;
  const int k = (int)(i - r * K);
  const V* x = X + r * F;
  V acc = V(0);
  for (int t = k; t < T; t += K) {
    const int leaf = pw_leaf<V>(x, rec, __ldg(tree_node + t), words, n_words);
    acc = acc + __ldg(leaves + __ldg(tree_leaf + t) + leaf);
  }
  if (average) acc = acc / V(T / K);
  out[i] = acc;
}

template <typename V>
__global__ void __launch_bounds__(PW_THREADS)
predict_leaf(const V* __restrict__ X, long long n, int F,
             const int4* __restrict__ rec, const int* __restrict__ tree_node,
             int T, const unsigned* __restrict__ words, int n_words,
             int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * T) return;
  const long long r = i / T;
  const int t = (int)(i - r * T);
  out[i] = pw_leaf<V>(X + r * F, rec, __ldg(tree_node + t), words, n_words);
}

// Queues the walk on `stream`; returns the CUDA error of the launch, 0 on
// success. f32: X, leaves and out (raw mode) are f32, else f64. leaf_mode:
// out is int32 [n, T], else [n, K] scores.
extern "C" int predict_walk_launch(const void* X, long long n, int F,
                                   int f32, const void* records,
                                   const void* tree_node,
                                   const void* tree_leaf, int T,
                                   const void* leaves, const void* words,
                                   int n_words, int K, int average,
                                   int leaf_mode, void* out, void* stream) {
  const long long work = n * (leaf_mode ? T : K);
  if (work <= 0) return 0;
  const long long grid = (work + PW_THREADS - 1) / PW_THREADS;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* rec = static_cast<const int4*>(records);
  const int* tn = static_cast<const int*>(tree_node);
  const int* tl = static_cast<const int*>(tree_leaf);
  const unsigned* w = static_cast<const unsigned*>(words);
  if (leaf_mode) {
    if (f32)
      predict_leaf<float><<<(unsigned)grid, PW_THREADS, 0, s>>>(
          static_cast<const float*>(X), n, F, rec, tn, T, w, n_words,
          static_cast<int*>(out));
    else
      predict_leaf<double><<<(unsigned)grid, PW_THREADS, 0, s>>>(
          static_cast<const double*>(X), n, F, rec, tn, T, w, n_words,
          static_cast<int*>(out));
  } else if (f32) {
    predict_raw<float><<<(unsigned)grid, PW_THREADS, 0, s>>>(
        static_cast<const float*>(X), n, F, rec, tn, tl, T,
        static_cast<const float*>(leaves), w, n_words, K, average,
        static_cast<float*>(out));
  } else {
    predict_raw<double><<<(unsigned)grid, PW_THREADS, 0, s>>>(
        static_cast<const double*>(X), n, F, rec, tn, tl, T,
        static_cast<const double*>(leaves), w, n_words, K, average,
        static_cast<double*>(out));
  }
  return (int)cudaGetLastError();
}
