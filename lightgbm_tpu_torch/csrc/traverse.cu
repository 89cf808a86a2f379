// Tree traversal and margin sums of the serving path for Hopper (sm_90a).
//
// Not TPU kernels: the JAX package serves with XLA code.  lgbt_traverse
// replaces lightgbm_tpu/inference.py:317 _traverse (a vmap over trees of a
// while_loop over depth, each step eight gathers from the SoA node tables
// and four from the binned rows) and :396 _traverse_packed (the same
// descent over two folded node words and one data word a row, down a
// fixed fori ladder).  lgbt_margin replaces the host loop at
// inference.py:826-833, which adds each tree's leaf value to its class's
// score, trees oldest first, in float64.
//
// lgbt_traverse: one thread per (tree, row).  A block holds kThreads rows
// of one tree, so a warp's threads read one tree's node records (the
// tables of a pass of trees are a few hundred KB and stay in L2) and the
// binned rows of a column at neighbouring addresses.  Each thread descends
// from node 0 until its child is a leaf (encoded ~leaf below 0): the
// data-dependent stop of _traverse, not a fixed ladder.  A node whose two
// children are one and the same (a stump's node 0, which sends every row
// to leaf 0) is passed without reading the row.  Two node layouts, as the
// template parameter:
//   kSoA    : int32 [T, P] feat, thr, miss, left, right, cat_ref, bool
//             [T, P] default_left, is_cat, bool [C, W] cat_mask, over
//             int32 [Fc, B] threshold ranks and category values and bool
//             [Fc, B] NaN and zero masks: NumericalDecision and
//             CategoricalDecision (tree.h:257-313) as ops/traverse.py:go_left
//             takes them;
//   kPacked : int32 [T, P] w0 = feat | thr << 12 | default_left << 28 |
//             miss << 29 and w1 = left | right << 16 (int16 halves), over
//             int32 [Fc, B] data words rank | nan << 24 | zero << 25
//             (inference.py:223-229, :428), numerical nodes only.
// Output: int32 [T, B] leaf indices.  Of bytes and operations, bytes
// bound it (the node records the rows' paths visit and the columns those
// nodes read, each read once, the leaves written once; a compare a
// visited node takes less), and they take microseconds.  Its time
// follows latency instead: two dependent loads a level (node record, then
// the row's word of that node's column) down the path.  The design keeps
// enough (tree, row) threads in flight to hide the chain.
//
// lgbt_margin: one thread per (class, row); thread (k, r) adds, to the
// score already in out[k, r], leaf_value[t, leaf[t, r]] for t = k, k + K,
// k + 2K, ... < T, oldest first, each add a float64 add rounded to
// nearest: the sequential order of the JAX engine, so the result is its
// raw_scores bit for bit.  Called once per pass of trees (a multiple of K
// trees), it continues the same sequence.  Of bytes and operations, bytes
// bound it (the leaves read once, the leaf values they name read once,
// the scores read and written once).  At a microbatch's few thousand
// rows its time follows latency instead: K x B threads, each a chain of
// T / K adds, each after two dependent loads; a thread loads kBatch
// trees' leaves and values before adding them, so that their loads are
// in flight together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 16;        // lgbt_margin: trees whose loads overlap
constexpr int kSoA = 0;
constexpr int kPacked = 1;
constexpr int kMissingZero = 1;   // predictor.py MISSING_ZERO
constexpr int kMissingNan = 2;    // predictor.py MISSING_NAN

}  // namespace

// The argument block of lgbt_traverse, packed by the Python wrapper
// (ops/traverse.py:_TRAVERSE_ARGS, struct format "@17P6iP").
struct TraverseArgs {
  const int32_t* bins;       // int32 [Fc, B] threshold ranks (kSoA)
  const int32_t* cats;       // int32 [Fc, B] category values (kSoA)
  const uint8_t* nanm;       // bool [Fc, B] (kSoA)
  const uint8_t* zerom;      // bool [Fc, B] (kSoA)
  const int32_t* feat;       // int32 [T, P] (kSoA)
  const int32_t* thr;
  const int32_t* miss;
  const int32_t* left;
  const int32_t* right;
  const int32_t* cat_ref;
  const uint8_t* default_left;  // bool [T, P] (kSoA)
  const uint8_t* is_cat;
  const uint8_t* cat_mask;   // bool [C, W] (kSoA)
  const int32_t* data;       // int32 [Fc, B] data words (kPacked)
  const int32_t* w0;         // int32 [T, P] (kPacked)
  const int32_t* w1;
  int32_t* leaf;             // int32 [T, B]
  int num_trees;
  int rows;                  // B, the row stride of the binned rows
  int nodes;                 // P, the row stride of the node tables
  int cat_width;             // W
  int layout;                // kSoA or kPacked
  int device;
  void* stream;
};

// The argument block of lgbt_margin (ops/traverse.py:_MARGIN_ARGS,
// struct format "@3P5iP").
struct MarginArgs {
  const int32_t* leaf;         // int32 [T, B]
  const double* leaf_value;    // f64 [T, P + 1]
  double* out;                 // f64 [K, B], added to in place
  int num_trees;
  int rows;
  int leaf_stride;             // P + 1
  int num_class;               // K
  int device;
  void* stream;
};

template <int kLayout>
__global__ void __launch_bounds__(kThreads)
lgbt_traverse_kernel(const TraverseArgs a, const int tiles) {
  const int t = blockIdx.x / tiles;
  const int r = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (r >= a.rows) return;
  const int64_t rows = a.rows;
  const int64_t base = (int64_t)t * a.nodes;
  int node = 0;
  int leaf = 0;
  // a tree's path has at most P internal nodes
  for (int step = 0; step < a.nodes && node >= 0; ++step) {
    const int64_t at = base + node;
    int nxt;
    if (kLayout == kPacked) {
      const int w0 = __ldg(a.w0 + at);
      const int w1 = __ldg(a.w1 + at);
      const int lc = (int)(short)(w1 & 0xffff);
      const int rc = w1 >> 16;
      if (lc == rc) {
        nxt = lc;
      } else {
        const int f = w0 & 0xfff;
        const int thr = (w0 >> 12) & 0xffff;
        const int mt = (w0 >> 29) & 3;
        const int dw = __ldg(a.data + (int64_t)f * rows + r);
        const bool missing = (mt == kMissingNan && ((dw >> 24) & 1))
            || (mt == kMissingZero && ((dw >> 25) & 1));
        const bool go = missing ? ((w0 >> 28) & 1) != 0
                                : (dw & 0xffffff) <= thr;
        nxt = go ? lc : rc;
      }
    } else {
      const int lc = __ldg(a.left + at);
      const int rc = __ldg(a.right + at);
      if (lc == rc) {
        nxt = lc;
      } else {
        const int64_t off = (int64_t)__ldg(a.feat + at) * rows + r;
        const int mt = __ldg(a.miss + at);
        const bool nan_missing = mt == kMissingNan && __ldg(a.nanm + off);
        bool go;
        if (__ldg(a.is_cat + at)) {
          const int c = __ldg(a.cats + off);
          go = !nan_missing && c >= 0 && c < a.cat_width
               && __ldg(a.cat_mask + (int64_t)__ldg(a.cat_ref + at)
                                         * a.cat_width + c);
        } else {
          const bool missing = nan_missing
              || (mt == kMissingZero && __ldg(a.zerom + off));
          go = missing ? __ldg(a.default_left + at) != 0
                       : __ldg(a.bins + off) <= __ldg(a.thr + at);
        }
        nxt = go ? lc : rc;
      }
    }
    if (nxt < 0) leaf = ~nxt;
    node = nxt;
  }
  a.leaf[(int64_t)t * rows + r] = leaf;
}

__global__ void __launch_bounds__(kThreads)
lgbt_margin_kernel(const MarginArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t rows = a.rows;
  if (i >= rows * a.num_class) return;
  const int k = (int)(i / rows);
  const int64_t r = i - (int64_t)k * rows;
  const int K = a.num_class;
  double acc = a.out[i];
  int t = k;
  // kBatch trees at a time: their leaves, then their values, are loaded
  // before the adds, so that the loads overlap; the adds stay in tree
  // order
  for (; t + (kBatch - 1) * K < a.num_trees; t += kBatch * K) {
    int leaf[kBatch];
    double v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      leaf[j] = __ldg(a.leaf + (int64_t)(t + j * K) * rows + r);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = __ldg(a.leaf_value + (int64_t)(t + j * K) * a.leaf_stride
                   + leaf[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += v[j];
  }
  for (; t < a.num_trees; t += K) {
    acc += __ldg(a.leaf_value + (int64_t)t * a.leaf_stride
                 + __ldg(a.leaf + (int64_t)t * rows + r));
  }
  a.out[i] = acc;
}

namespace {

// Launch on the argument block's device and stream, restoring the
// caller's device; returns the launch's CUDA error.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  launch();
  const int rc = (int)cudaGetLastError();
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}

}  // namespace

extern "C" int lgbt_traverse(const TraverseArgs* x) {
  const TraverseArgs& a = *x;
  if (a.num_trees < 0 || a.rows < 0 || a.nodes < 1 || a.cat_width < 1
      || (a.layout != kSoA && a.layout != kPacked))
    return (int)cudaErrorInvalidValue;
  if (a.num_trees == 0 || a.rows == 0) return 0;
  const int tiles = (a.rows + kThreads - 1) / kThreads;
  const int64_t blocks = (int64_t)tiles * a.num_trees;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)a.stream;
  return on_device(a.device, [&] {
    if (a.layout == kPacked)
      lgbt_traverse_kernel<kPacked><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(a, tiles);
    else
      lgbt_traverse_kernel<kSoA><<<(unsigned)blocks, kThreads, 0,
                                   stream>>>(a, tiles);
  });
}

extern "C" int lgbt_margin(const MarginArgs* x) {
  const MarginArgs& a = *x;
  if (a.num_trees < 0 || a.rows < 0 || a.num_class < 1
      || a.leaf_stride < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)a.rows * a.num_class;
  if (threads == 0 || a.num_trees == 0) return 0;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return on_device(a.device, [&] {
    lgbt_margin_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)a.stream>>>(a);
  });
}
