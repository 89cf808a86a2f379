// Routing kernels for Hopper (sm_90a): which rows of the splitting leaf go
// left, read entirely from device memory.
//
// Not TPU kernels: the JAX package routes a split in XLA
// (lightgbm_tpu/grower.py:372 route_goes_left), inside make_grower's loop
// body for the serial learner and inside make_gspmd_grower's
// (lightgbm_tpu/parallel/gspmd.py:305-320) for the data-parallel one.  Both
// growers' split steps run as captured CUDA graphs, in which the host holds
// neither the chosen leaf nor its rows, so routing is one kernel that
// reads all of it from device memory:
//   - the splitting leaf, an int64[1], and through it the leaf's pooled
//     split: (feature, threshold, default_left) from an int32 [leaves, 3]
//     row, is_cat and the [B] bins-left row when the data has categorical
//     columns;
//   - the column's missing type, bin count and default bin;
// with the semantics of route_goes_left (tree.h:257-313): a missing bin
// (the NaN bin, or the default bin of a zero-missing column) goes the
// default way, another bin left when it is <= the threshold, and a
// categorical split sends a bin left when its row says so.
//
// lgbt_route (the serial grower) routes the leaf's window: it reads the
// window (start, cnt), an int64[2], and the parity of the buffer that
// holds it (the leaf's depth % 2), an int32[1], and writes goes_left[p]
// (1 = left) for the window's positions p in [0, cnt).  The split column
// is read from the leaf-ordered bins of the window's buffer
// (ordered_bins=on: contiguous) or gathered through the buffer's `order`
// from the natural bin matrix.  What bounds it on the H100: bytes, and
// their latency: per position the order entry (4 B, coalesced), one bin
// byte (a random 32-byte sector when gathered) and the output byte.  A
// window of zero positions (a step after the tree stopped) reads its
// (start, cnt) and returns.  The grid covers the largest window the
// caller can pass with a grid-stride loop, so a small window leaves most
// blocks idle at once.
//
// lgbt_route_rows (the data-parallel learner) updates a device's row ->
// leaf map in place: every row r of its held row shards with
// row_leaf[r] == leaf that goes right gets row_leaf[r] = new, a second
// int64[1].  The split column is one row of the column-major bins of
// those rows, so a warp reads 32 neighbouring bytes.  blockIdx.y is the
// shard; each block counts the rows it moved, sums them over the block
// (warp shuffles, then shared memory) and adds them to the shard's count
// of `new` and takes them from that of `leaf` (counts, int32
// [shards, leaves]) with one integer atomicAdd each: exact, whatever the
// order, so every run gives the same counts.  What bounds it on the H100:
// bytes, 4 of row_leaf a row read, the column read only at the leaf's rows
// (a 32-byte sector each where they are scattered, the whole column at the
// root) and 4 a moved row written; after the tree's stop no row holds the
// sink leaf and nothing is written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMissingZero = 1;   // split.py MISSING_ZERO
constexpr int kMissingNan = 2;    // split.py MISSING_NAN

}  // namespace

// The argument block of lgbt_route, packed by the Python wrapper
// (ops/route.py:_ARGS, struct format "@14Pq4iP").
struct Args {
  const void* sc;          // int64[2] (start, cnt)
  const void* odd;         // int32[1]: the window's buffer, by parity
  const void* leaf;        // int64[1]: the splitting leaf
  const void* split_i32;   // int32 [leaves, 3]: feature, threshold, dleft
  const void* split_cat;   // bool [leaves], or null
  const void* split_catb;  // bool [leaves, cat_width], or null
  const void* num_bin;     // int32 [F]
  const void* missing_type;
  const void* default_bin;
  const void* bins[2];     // uint8 [rows, F] of buffer 0 and 1
  const void* order[2];    // int32 [rows] of buffer 0 and 1, or null: the
                           // bins are the window's rows in order
  void* goes_left;         // uint8 [>= cnt]
  long long rows;
  int n_feat;
  int cat_width;
  int grid;
  int device;
  void* stream;
};

namespace {

__global__ void __launch_bounds__(kThreads) lgbt_route_kernel(Args a) {
  const long long* sc = static_cast<const long long*>(a.sc);
  const long long start = sc[0];
  long long cnt = sc[1];
  if (cnt > a.rows - start) cnt = a.rows - start;
  if (cnt <= 0 || start < 0) return;
  const int par = *static_cast<const int32_t*>(a.odd) & 1;
  const long long l = *static_cast<const long long*>(a.leaf);
  const int32_t* sp = static_cast<const int32_t*>(a.split_i32) + 3 * l;
  const int feat = sp[0];
  if (feat < 0 || feat >= a.n_feat) return;
  const int thr = sp[1];
  const bool dleft = sp[2] != 0;
  const bool is_cat =
      a.split_cat != nullptr && static_cast<const bool*>(a.split_cat)[l];
  const uint8_t* cat_row =
      is_cat ? static_cast<const uint8_t*>(a.split_catb) + l * a.cat_width
             : nullptr;
  const int mt = static_cast<const int32_t*>(a.missing_type)[feat];
  const int nb = static_cast<const int32_t*>(a.num_bin)[feat];
  const int db = static_cast<const int32_t*>(a.default_bin)[feat];
  const uint8_t* bins = static_cast<const uint8_t*>(a.bins[par]) + feat;
  const int32_t* order = static_cast<const int32_t*>(a.order[par]);
  uint8_t* out = static_cast<uint8_t*>(a.goes_left);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < cnt;
       p += stride) {
    const long long row = order ? (long long)__ldg(order + start + p)
                                : start + p;
    const int b = __ldg(bins + row * a.n_feat);
    bool left;
    if (is_cat) {
      left = __ldg(cat_row + min(b, a.cat_width - 1)) != 0;
    } else {
      const bool missing = (mt == kMissingNan && b == nb - 1) ||
                           (mt == kMissingZero && b == db);
      left = missing ? dleft : b <= thr;
    }
    out[p] = left;
  }
}

}  // namespace

// Writes goes_left for the window x->sc of the buffer that x->odd picks,
// on the split that x->leaf holds in the pool: one launch of x->grid
// blocks on stream x->stream of card x->device, made current only if it is
// not.  Returns the cudaError_t (0 on success).
extern "C" int lgbt_route(const Args* x) {
  const Args& a = *x;
  if (a.grid < 1 || a.n_feat < 1 || a.rows < 0 ||
      (a.split_cat != nullptr && (a.split_catb == nullptr ||
                                  a.cat_width < 1)) ||
      a.bins[0] == nullptr || a.bins[1] == nullptr ||
      (a.order[0] == nullptr) != (a.order[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  lgbt_route_kernel<<<a.grid, kThreads, 0, (cudaStream_t)a.stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}

// The argument block of lgbt_route_rows, packed by the Python wrapper
// (ops/route.py:_ROWS_ARGS, struct format "@11Pq6iP").
struct RowsArgs {
  void* row_leaf;          // int32 [shards * n_loc], updated in place
  const void* bins_t;      // uint8 [F, shards * n_loc], column-major
  const void* leaf;        // int64[1]: the splitting leaf
  const void* new_leaf;    // int64[1]: the leaf its right rows move to
  const void* split_i32;   // int32 [leaves, 3]: feature, threshold, dleft
  const void* split_cat;   // bool [leaves], or null
  const void* split_catb;  // bool [leaves, cat_width], or null
  const void* num_bin;     // int32 [F]
  const void* missing_type;
  const void* default_bin;
  void* counts;            // int32 [shards, n_leaves]: rows of each leaf
  long long n_loc;         // rows of a shard
  int shards;
  int n_feat;
  int cat_width;
  int n_leaves;            // columns of counts: every leaf id, sinks too
  int grid_x;              // blocks a shard
  int device;
  void* stream;
};

namespace {

__global__ void __launch_bounds__(kThreads) lgbt_route_rows_kernel(
    RowsArgs a) {
  __shared__ int warp_moved[kThreads / 32];
  const long long l = *static_cast<const long long*>(a.leaf);
  const int32_t nw = (int32_t)*static_cast<const long long*>(a.new_leaf);
  if (l < 0 || l >= a.n_leaves) return;
  const int32_t* sp = static_cast<const int32_t*>(a.split_i32) + 3 * l;
  const int feat = sp[0];
  if (feat < 0 || feat >= a.n_feat) return;
  const int thr = sp[1];
  const bool dleft = sp[2] != 0;
  const bool is_cat =
      a.split_cat != nullptr && static_cast<const bool*>(a.split_cat)[l];
  const uint8_t* cat_row =
      is_cat ? static_cast<const uint8_t*>(a.split_catb) + l * a.cat_width
             : nullptr;
  const int mt = static_cast<const int32_t*>(a.missing_type)[feat];
  const int nb = static_cast<const int32_t*>(a.num_bin)[feat];
  const int db = static_cast<const int32_t*>(a.default_bin)[feat];
  const int shard = blockIdx.y;
  const long long base = (long long)shard * a.n_loc;
  int32_t* rl = static_cast<int32_t*>(a.row_leaf) + base;
  const uint8_t* col = static_cast<const uint8_t*>(a.bins_t) +
                       (long long)feat * a.shards * a.n_loc + base;
  int moved = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < a.n_loc; p += stride) {
    if (rl[p] != l) continue;
    const int b = __ldg(col + p);
    bool left;
    if (is_cat) {
      left = __ldg(cat_row + min(b, a.cat_width - 1)) != 0;
    } else {
      const bool missing = (mt == kMissingNan && b == nb - 1) ||
                           (mt == kMissingZero && b == db);
      left = missing ? dleft : b <= thr;
    }
    if (!left) {
      rl[p] = nw;
      ++moved;
    }
  }
  moved = __reduce_add_sync(0xffffffffu, moved);
  if ((threadIdx.x & 31) == 0) warp_moved[threadIdx.x >> 5] = moved;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_moved[w];
    if (total) {
      int* c = static_cast<int*>(a.counts) + (long long)shard * a.n_leaves;
      atomicAdd(c + nw, total);
      atomicAdd(c + l, -total);
    }
  }
}

}  // namespace

// Routes the rows of x->leaf in every shard of x->row_leaf on the split
// that x->leaf holds in the pool, moving its right rows to x->new_leaf and
// their counts with them: one launch of (x->grid_x, x->shards) blocks on
// stream x->stream of card x->device, made current only if it is not.
// Returns the cudaError_t (0 on success).
extern "C" int lgbt_route_rows(const RowsArgs* x) {
  const RowsArgs& a = *x;
  if (a.grid_x < 1 || a.shards < 1 || a.shards > 65535 || a.n_feat < 1 ||
      a.n_loc < 0 || a.n_leaves < 1 ||
      (a.split_cat != nullptr && (a.split_catb == nullptr ||
                                  a.cat_width < 1)))
    return (int)cudaErrorInvalidValue;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  lgbt_route_rows_kernel<<<dim3(a.grid_x, a.shards), kThreads, 0,
                           (cudaStream_t)a.stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}
