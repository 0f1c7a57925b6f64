// The binned tree walk of the validation scores: score[r] += leaf_value[
// leaf(r)] for every row r of a validation set, for one tree.
//
// No Pallas counterpart: the JAX package walks each new tree over the
// binned validation rows on the host, in numpy
// (lightgbm_tpu/boosting/score_updater.py:114-144 -> models/tree.py:420-481
// predict_leaf_binned). Here one launch walks one tree over all rows.
//
// Rows: bins [n, G] uint8, row-major, the group-local bins of the
// validation set (binned against the training set's mappers and groups).
// Nodes: [num_nodes, VW_COLS] int32 records of the tree's internal nodes,
// each with its feature's group metadata folded in by the host
// (ops/valid_walk.py:node_records): the group column, the feature's
// group-local bin range [lo, hi), its most frequent bin (the bin of a row
// outside the range, an EFB bundle's other features), its default bin,
// its last bin (the NaN bin), the threshold bin, the decision type
// (bits 2-3 the missing type, bit 1 default-left) and the children
// (~leaf for a leaf). Leaves: [num_nodes + 1] f64 leaf values.
// A categorical node (decision type bit 0) holds, in place of its last bin
// and threshold, the count and the first index of its inner bitset's words
// in `words` ([n_words] u32, one array for all trees of an upload): a row
// goes left when bit b % 32 of word b / 32 is set, b its feature-local bin
// (the most frequent bin outside the range), as the JAX package's
// _decision_inner (models/tree.py:447-474) looks b up with FindInBitset; a
// word past the node's count, or past the array, is 0.
//
// Design: one thread per row walks from the root; the node table sits in
// shared memory when it fits (255 leaves: 10 KB), else it is read from
// global memory. The decision is integer compares only and each row gets
// one f64 add, so the result is the plain version's (and the JAX package's
// numpy walk's) bit for bit. A tree without a split (num_nodes = 0) adds
// leaf 0 to every row.
//
// The payload form (valid_walk_pay): DART's drop and normalize on the
// persistent grower, the JAX package's add_score_delta
// (lightgbm_tpu/ops/grow_persist.py:1816-1826, jnp; no Pallas kernel). One
// thread per live lane l < n of the payload: r = rid[l] (the payload's
// row-id row), the walk over bins[r] of the training rows, then
// score[l] = score[l] + __double2float_rn(leaf_value), the f64 leaf value
// (pre-scaled on the host by Tree.shrink) rounded to the payload's f32
// scores, one f32 add per lane (JAX: delta_row.astype(sc.dtype), then the
// add). Lanes past n are left alone. What bounds it: bytes, 4 (row id) +
// G (the gathered row of bins) + 8 (score read and write) a lane.
#include <cuda_runtime.h>
#include <stdint.h>

#define VW_COLS 10
#define VW_THREADS 256
#define VW_SMEM_MAX (48 * 1024)

enum { VW_G = 0, VW_LO, VW_HI, VW_MFB, VW_DB, VW_NB1, VW_THR, VW_DT,
       VW_LEFT, VW_RIGHT };

// The leaf of one row of bins under the node records `nd`.
static __device__ __forceinline__ int vw_leaf(
    const uint8_t* __restrict__ row, const int* nd, int num_nodes,
    const unsigned* __restrict__ words, int n_words) {
  int node = 0;
  if (num_nodes == 0) return 0;
  while (node >= 0) {
    const int* rec = nd + node * VW_COLS;
    const int col = row[rec[VW_G]];
    const int b = (col >= rec[VW_LO] && col < rec[VW_HI])
                      ? col - rec[VW_LO] : rec[VW_MFB];
    const int dt = rec[VW_DT];
    bool left;
    if (dt & 1) {
      const int wi = b >> 5, at = rec[VW_THR] + wi;
      left = wi < rec[VW_NB1] && at < n_words &&
             ((__ldg(words + at) >> (b & 31)) & 1u) != 0;
    } else {
      const int mt = (dt >> 2) & 3;
      const bool dflt = (mt == 1 && b == rec[VW_DB]) ||
                        (mt == 2 && b == rec[VW_NB1]);
      left = dflt ? (dt & 2) != 0 : b <= rec[VW_THR];
    }
    node = left ? rec[VW_LEFT] : rec[VW_RIGHT];
  }
  return ~node;
}

// The node records in shared memory when SMEM (the caller sized it).
template <bool SMEM>
static __device__ __forceinline__ const int* vw_nodes(const int* nodes,
                                                      int num_nodes) {
  extern __shared__ int vw_smem[];
  if (!SMEM) return nodes;
  for (int i = threadIdx.x; i < num_nodes * VW_COLS; i += blockDim.x)
    vw_smem[i] = nodes[i];
  __syncthreads();
  return vw_smem;
}

template <bool SMEM>
__global__ void __launch_bounds__(VW_THREADS)
valid_walk(const uint8_t* __restrict__ bins, long long n, int G,
           const int* __restrict__ nodes, const double* __restrict__ leaves,
           int num_nodes, const unsigned* __restrict__ words, int n_words,
           double* __restrict__ score) {
  const int* nd = vw_nodes<SMEM>(nodes, num_nodes);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int leaf = vw_leaf(bins + r * G, nd, num_nodes, words, n_words);
    score[r] = score[r] + __ldg(leaves + leaf);
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(VW_THREADS)
valid_walk_pay(const uint8_t* __restrict__ bins, int G,
               const int* __restrict__ rid, long long n,
               const int* __restrict__ nodes,
               const double* __restrict__ leaves, int num_nodes,
               const unsigned* __restrict__ words, int n_words,
               float* __restrict__ score) {
  const int* nd = vw_nodes<SMEM>(nodes, num_nodes);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       l < n; l += stride) {
    const long long r = (long long)__ldg(rid + l);
    const int leaf = vw_leaf(bins + r * G, nd, num_nodes, words, n_words);
    score[l] = __fadd_rn(score[l], __double2float_rn(__ldg(leaves + leaf)));
  }
}

static int vw_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

// Queues the walk of one tree on `stream`; returns the CUDA error of the
// launch, 0 on success. A grid of at most four blocks per multiprocessor,
// each striding over the rows, so the node table is staged into shared
// memory once per block.
extern "C" int valid_walk_launch(const void* bins, long long n, int G,
                                 const void* nodes, const void* leaves,
                                 int num_nodes, const void* words,
                                 int n_words, void* score, void* stream) {
  if (n <= 0) return 0;
  const long long want = (n + VW_THREADS - 1) / VW_THREADS;
  const int grid = (int)(want < 4LL * vw_sms() ? want : 4LL * vw_sms());
  const size_t smem = (size_t)num_nodes * VW_COLS * sizeof(int);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (smem <= VW_SMEM_MAX)
    valid_walk<true><<<grid, VW_THREADS, smem, s>>>(
        static_cast<const uint8_t*>(bins), n, G,
        static_cast<const int*>(nodes), static_cast<const double*>(leaves),
        num_nodes, static_cast<const unsigned*>(words), n_words,
        static_cast<double*>(score));
  else
    valid_walk<false><<<grid, VW_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(bins), n, G,
        static_cast<const int*>(nodes), static_cast<const double*>(leaves),
        num_nodes, static_cast<const unsigned*>(words), n_words,
        static_cast<double*>(score));
  return (int)cudaGetLastError();
}

// The payload form: queues the walk of one tree over the n live lanes of a
// payload (their rows of the training bins through `rid`) onto its f32
// score row; the same grid and shared-memory rule as valid_walk_launch.
extern "C" int valid_walk_payload_launch(const void* bins, int G,
                                         const void* rid, long long n,
                                         const void* nodes,
                                         const void* leaves, int num_nodes,
                                         const void* words, int n_words,
                                         void* score, void* stream) {
  if (n <= 0) return 0;
  const long long want = (n + VW_THREADS - 1) / VW_THREADS;
  const int grid = (int)(want < 4LL * vw_sms() ? want : 4LL * vw_sms());
  const size_t smem = (size_t)num_nodes * VW_COLS * sizeof(int);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (smem <= VW_SMEM_MAX)
    valid_walk_pay<true><<<grid, VW_THREADS, smem, s>>>(
        static_cast<const uint8_t*>(bins), G, static_cast<const int*>(rid),
        n, static_cast<const int*>(nodes),
        static_cast<const double*>(leaves), num_nodes,
        static_cast<const unsigned*>(words), n_words,
        static_cast<float*>(score));
  else
    valid_walk_pay<false><<<grid, VW_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(bins), G, static_cast<const int*>(rid),
        n, static_cast<const int*>(nodes),
        static_cast<const double*>(leaves), num_nodes,
        static_cast<const unsigned*>(words), n_words,
        static_cast<float*>(score));
  return (int)cudaGetLastError();
}
