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
// lgbt_traverse: a block takes a group of G trees and a tile of R rows
// (the plan: ops/traverse.py:traverse_plan), one thread a row, and each
// thread walks its row down the group's trees one after another.  Each
// descent runs from node 0 until its child is a leaf (encoded ~leaf
// below 0): the data-dependent stop of _traverse, not a fixed ladder.  A
// node whose two children are one and the same (a stump's node 0, which
// sends every row to leaf 0) is passed without reading the row.  Two node
// layouts, as a template parameter:
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
// bound it at a few rows (the node records the rows' paths visit and the
// columns those nodes read, each read once, the leaves written once) and
// the instructions a level issues at many (chip_smoke.py counts both);
// both take microseconds.  What the time follows is latency and the
// load units: two dependent loads a level (node record, then the row's
// word of that node's column), whose addresses differ from lane to lane.
// For the packed layout, the serving path's, the block stages with
// cp.async its group's node words as 8-byte (w0, w1) pairs (one load a
// node, about 2 KB a 255-leaf tree) and, where they fit beside them, the
// tile's data words, each thread its own row's, so both loads of a level
// come from shared memory, the data word's without a bank conflict (a
// column's R words lie in R neighbouring banks, whatever column each
// lane reads).  The group is a few trees (as many as leave eight blocks
// an SM, at most 8): one at a few rows, so that every SM takes part.
// Where the group's words and the tile's do not fit together (many
// columns, or a tree past the stage: packed children are int16, up to
// 32,767 nodes, 256 KB a tree) the same kernel reads both from global
// memory (kStageNone): staging the nodes alone lost at a row pass of 300
// columns and was dropped (PERF.md §6).  The SoA layout reads
// everything through the L1 cache: staging it measured no faster.  What
// was tried and measured (PERF.md §6): several trees a thread at
// once, in fixed or refilling chains, and larger groups, were slower at
// every size.  Shared memory past 48 KB is opted into once per
// instantiation and card in the C entry point.
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

constexpr int kThreads = 256;     // lgbt_margin
constexpr int kBatch = 16;        // lgbt_margin: trees whose loads overlap
constexpr int kMaxRows = 128;     // lgbt_traverse: rows a block at most
                                  // (ops/traverse.py ROWS_TILE)
constexpr int kStageNone = 0;     // ops/traverse.py STAGE_*: nothing staged
constexpr int kStageAll = 1;      // the group's nodes and the tile's words
constexpr int kMaxSmem = 96 * 1024;   // ops/traverse.py STAGE_BYTES
constexpr int kMaxDevices = 64;
constexpr int kSoA = 0;
constexpr int kPacked = 1;
constexpr int kMissingZero = 1;   // predictor.py MISSING_ZERO
constexpr int kMissingNan = 2;    // predictor.py MISSING_NAN

}  // namespace

// The argument block of lgbt_traverse, packed by the Python wrapper
// (ops/traverse.py:_TRAVERSE_ARGS, struct format "@17P10iP").
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
  // the plan (ops/traverse.py:traverse_plan)
  int num_cols;              // Fc, the rows of the binned tensors
  int rows_tile;             // R: rows a block, a power of 2 <= kMaxRows
  int group;                 // G: trees a block
  int stage;                 // kStageNone or kStageAll (kPacked)
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

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

}  // namespace

// Bytes of a block's shared memory (G trees of P node slots, R rows of Fc
// columns; kPacked only, where kStage == kStageAll): the node words as
// (w0, w1) pairs, 8 x G x P, then the tile's data words, 4 x Fc x R.
// ops/traverse.py:traverse_plan computes the same sum.  kSoA stages nothing (kStageNone): staging its 26-byte nodes
// and 10-byte (column, row) words measured no faster than reading them
// through the L1 cache (PERF.md §6).
template <int kLayout, int kStage>
__global__ void __launch_bounds__(kMaxRows)
lgbt_traverse_kernel(const TraverseArgs a, const int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStaged = kStage == kStageAll;
  const int R = a.rows_tile;
  const int P = a.nodes;
  const int W = a.cat_width;
  const int group = blockIdx.x / tiles;
  const int t0 = group * a.group;
  const int nt = min(a.group, a.num_trees - t0);   // trees of the group
  const int r0 = (blockIdx.x - group * tiles) * R;
  const int nr = min(R, a.rows - r0);              // rows of the tile
  const int64_t B = a.rows;
  const int64_t gbase = (int64_t)t0 * P;
  const int r = threadIdx.x;                       // the thread's row
  const bool row = r < nr;
  const int64_t dstride = kStaged ? R : B;
  const int2* pairs = reinterpret_cast<const int2*>(smem);
  int32_t* sd = reinterpret_cast<int32_t*>(smem + 8 * a.group * P);
  if constexpr (kStaged) {
    // the group's node words as pairs, the tile's words each thread its
    // own row's, column by column
    int32_t* s = reinterpret_cast<int32_t*>(smem);
    for (int i = threadIdx.x; i < nt * P; i += blockDim.x) {
      cp_async4(s + 2 * i, a.w0 + gbase + i);
      cp_async4(s + 2 * i + 1, a.w1 + gbase + i);
    }
    if (row)
      for (int f = 0; f < a.num_cols; ++f)
        cp_async4(sd + f * R + r, a.data + f * B + r0 + r);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  if (!row) return;
  const int32_t* d0 = kLayout == kPacked ? (kStaged ? sd : a.data + r0) + r
                                         : a.bins + r0 + r;
  int32_t* out = a.leaf + (int64_t)t0 * B + r0 + r;
  // the group's trees one after another, each from node 0 until its
  // child is a leaf; a tree's path has at most P internal nodes
  for (int t = 0; t < nt; ++t) {
    const int64_t base = gbase + (int64_t)t * P;
    int node = 0;
    int leaf = 0;
    for (int step = 0; step < P && node >= 0; ++step) {
      int nxt;
      if constexpr (kLayout == kPacked) {
        int w0, w1;
        if constexpr (kStaged) {
          const int2 v = pairs[t * P + node];
          w0 = v.x;
          w1 = v.y;
        } else {
          w0 = __ldg(a.w0 + base + node);
          w1 = __ldg(a.w1 + base + node);
        }
        const int lc = (int)(short)(w1 & 0xffff);
        const int rc = w1 >> 16;
        if (lc == rc) {
          nxt = lc;
        } else {
          const int64_t off = (int64_t)(w0 & 0xfff) * dstride;
          const int dw = kStaged ? d0[off] : __ldg(d0 + off);
          const int mt = (w0 >> 29) & 3;
          const bool missing = (mt == kMissingNan && ((dw >> 24) & 1))
              || (mt == kMissingZero && ((dw >> 25) & 1));
          const bool go = missing ? ((w0 >> 28) & 1) != 0
                                  : (dw & 0xffffff) <= ((w0 >> 12) & 0xffff);
          nxt = go ? lc : rc;
        }
      } else {
        const int64_t at = base + node;
        const int lc = __ldg(a.left + at);
        const int rc = __ldg(a.right + at);
        if (lc == rc) {
          nxt = lc;
        } else {
          const int64_t off = (int64_t)__ldg(a.feat + at) * B;
          const int mt = __ldg(a.miss + at);
          const bool nan_missing = mt == kMissingNan && __ldg(a.nanm + r0 + r + off);
          bool go;
          if (__ldg(a.is_cat + at)) {
            const int c = __ldg(a.cats + r0 + r + off);
            go = !nan_missing && c >= 0 && c < W
                 && __ldg(a.cat_mask + (int64_t)__ldg(a.cat_ref + at) * W
                          + c);
          } else {
            const bool missing = nan_missing
                || (mt == kMissingZero && __ldg(a.zerom + r0 + r + off));
            go = missing ? __ldg(a.default_left + at) != 0
                         : __ldg(d0 + off) <= __ldg(a.thr + at);
          }
          nxt = go ? lc : rc;
        }
      }
      if (nxt < 0) leaf = ~nxt;
      node = nxt;
    }
    out[(int64_t)t * B] = leaf;
  }
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

namespace {

// One launch of an instantiation, opting it into shared memory past 48 KB
// once per card; returns the first CUDA error.
template <int kLayout, int kStage>
cudaError_t launch_traverse(const TraverseArgs& a, int tiles, int blocks,
                            int threads, int smem, cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  auto kernel = lgbt_traverse_kernel<kLayout, kStage>;
  if (smem > 48 * 1024 && !opted[a.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted[a.device] = true;
  }
  kernel<<<blocks, threads, smem, stream>>>(a, tiles);
  return cudaSuccess;
}

cudaError_t traverse_launch(const TraverseArgs& a, int tiles, int blocks,
                            int threads, int smem, cudaStream_t stream) {
  if (a.layout == kSoA)
    return launch_traverse<kSoA, kStageNone>(a, tiles, blocks, threads, smem,
                                             stream);
  if (a.stage == kStageAll)
    return launch_traverse<kPacked, kStageAll>(a, tiles, blocks, threads,
                                               smem, stream);
  return launch_traverse<kPacked, kStageNone>(a, tiles, blocks, threads, smem,
                                              stream);
}

// Bytes of shared memory a block of this plan uses (the kernel's layout,
// above lgbt_traverse_kernel).
int64_t traverse_smem(const TraverseArgs& a) {
  if (a.stage != kStageAll) return 0;
  return 8 * (int64_t)a.group * a.nodes +
         4 * (int64_t)a.num_cols * a.rows_tile;
}

}  // namespace

extern "C" int lgbt_traverse(const TraverseArgs* x) {
  const TraverseArgs& a = *x;
  const int R = a.rows_tile;
  if (a.num_trees < 0 || a.rows < 0 || a.nodes < 1 || a.cat_width < 1
      || a.num_cols < 0 || (a.layout != kSoA && a.layout != kPacked)
      || R < 1 || R > kMaxRows || (R & (R - 1)) != 0
      || a.group < 1 || a.stage < kStageNone || a.stage > kStageAll
      || (a.layout == kSoA && a.stage != kStageNone)
      || a.device < 0 || a.device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (a.num_trees == 0 || a.rows == 0) return 0;
  const int64_t smem = traverse_smem(a);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int tiles = (a.rows + R - 1) / R;
  const int64_t blocks =
      (int64_t)tiles * ((a.num_trees + a.group - 1) / a.group);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = R < 32 ? 32 : R;
  cudaStream_t stream = (cudaStream_t)a.stream;
  cudaError_t err = cudaSuccess;
  const int rc = on_device(a.device, [&] {
    err = traverse_launch(a, tiles, (int)blocks, threads, (int)smem, stream);
  });
  return err != cudaSuccess ? (int)err : rc;
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
