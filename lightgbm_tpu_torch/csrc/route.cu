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
//   - the feature's missing type, bin count and default bin and, when the
//     data is bundled (EFB), its physical column col[feat] and first slot
//     offset[feat] (both null when columns and features are 1:1);
// with the semantics of route_goes_left (lightgbm_tpu/grower.py:372-395,
// tree.h:257-313), in its order: the bundle's slot is decoded into the
// feature's bin first (decode_bundle_bin, grower.py:145-158: a slot in
// [offset, offset + num_bin - 2] is the feature's bin with the default one
// left out, any other slot the default bin), then a missing bin (the NaN
// bin, or the default bin of a zero-missing column) goes the default way,
// another bin left when it is <= the threshold, and a categorical split
// sends a bin left when its row says so.
//
// lgbt_route (the serial grower) routes the leaf's window: it reads the
// window (start, cnt), an int64[2], and the parity of the buffer that
// holds it (the leaf's depth % 2), an int32[1], and writes goes_left[p]
// (1 = left) for the window's positions p in [0, cnt).  The split column
// is read from the leaf-ordered bins of the window's buffer
// (ordered_bins=on: contiguous) or gathered through the buffer's `order`
// from the natural bin matrix.  Bins are uint8, or uint16 when a column
// has more than 256 bins (both kernels are instantiated for each; a
// categorical split's bins-left row is then as wide as the histogram).
// What bounds it on the H100: bytes, and
// their latency: per position the order entry (4 B, coalesced), one bin
// (a random 32-byte sector when gathered) and the output byte; a
// bundled column adds two 4-byte reads a call (col and offset), none a
// row.  A
// window of zero positions (a step after the tree stopped) reads its
// (start, cnt) and returns.  The grid covers the largest window the
// caller can pass with a grid-stride loop, so a small window leaves most
// blocks idle at once.
//
// lgbt_route_rows (the data-parallel learner and the streamed grower)
// updates a row -> leaf map in place: every row r of its row shards with
// row_leaf[r] == leaf that goes right gets row_leaf[r] = new, a second
// int64[1].  The bins are read through two strides, in elements: column
// c of row r is bins[c * col_stride + r * row_stride].  The data-parallel
// learner passes a column-major copy of a device's rows (col_stride the
// rows, row_stride 1); the streamed grower passes the block as it arrived
// from the host, the row-major [n, F] slice of the bin matrix (col_stride
// 1, row_stride F), so each row's bin lies in a sector of its own once a
// row is 32 bytes or more.  blockIdx.y is the shard; each block counts
// the rows it moved, sums them over the block (warp shuffles, then shared
// memory) and adds them to the shard's count of `new` and takes them from
// that of `leaf` (counts, int32 [shards, leaves]) with one integer
// atomicAdd each: exact, whatever the order, so every run gives the same
// counts.  What bounds it on the H100: bytes, 4 of row_leaf a row read,
// the column's bin read only at the leaf's rows (1 or 2 bytes a row
// column-major, where a warp's rows share sectors at the root; a 32-byte
// sector a row row-major once F bins are 32 bytes or more; a sector each
// wherever the leaf's rows are scattered) and 4 a moved row written (a
// bundled column adds two 4-byte reads a call, none a row); after the
// tree's stop no row holds the sink leaf and nothing is written.  At a
// million rows those bytes take about a microsecond, so what a call costs
// is latency and fixed work.  Column-major (kColumn), the design goes
// after those:
//   - one wave: the grid (ops/route.py:rows_grid) gives a thread
//     kRowsUnroll vectors of 4 rows and is capped at one wave, so that
//     every block is resident at once (kRowsBlocksPerSm blocks an SM,
//     held by __launch_bounds__) and pays its prologue once;
//   - the split-independent loads first: a thread issues its first
//     round of row_leaf loads before it resolves the split chain (leaf ->
//     split row -> column and offset -> the feature's bin count, missing
//     type and default bin), so the chain's latency hides behind them;
//   - row_leaf in 16-byte vectors of 4 rows, kRowsUnroll of them in flight
//     a thread, with the streaming cache hint; the rows before the
//     shard's first 16-byte boundary (its base is shard * n_loc, any
//     residue mod 4) and after its last whole vector go one row a thread
//     in block 0;
//   - the bins of a 4-row group are read as one 4-byte (uint8) or 8-byte
//     (uint16) word, and only for a group that holds a row of the leaf
//     (one bin a leaf row where the shard's column is not aligned to the
//     word);
//   - a group with a moved row is written back as one 16-byte store.
// Row-major, one row a thread over a grid-stride loop, the split chain
// resolved first, one bin a leaf row: the vector design measured slower
// there (PERF.md §6), at the root and most at a leaf of a thousand rows.
//
// lgbt_block_route (the data-parallel learner with block-sharded
// bins, shard_axes=batch,feature) is lgbt_route_rows over bins that no
// tensor holds whole: each (batch shard i, feature shard j) slot keeps
// only its row-major [n_loc, w_j] column slice of its batch shard.  The
// kernel gets a table of the slots' base addresses, int64 [shards, fs]
// (0 where another card holds the slot), and the slices' first columns,
// int32 [fs + 1].  It maps the split's logical feature to its physical
// column c (through col/offset when bundled), finds the feature shard j
// with first[j] <= c < first[j + 1], and reads row r's bin at
// base[i][j] + r * w_j + (c - first[j]).  A shard whose owning slot is not
// on this card is left as it is (the eager loop over several cards takes
// the owner's rows afterwards, parallel/gspmd.py).  Everything else is
// lgbt_route_rows: uint8 and uint16, the bundle decode, the per-shard
// counts.  Not a TPU kernel: the JAX package's block-sharded route is the
// same XLA code over a P(batch, feature) matrix, the partitioner reading
// the column across the feature axis (lightgbm_tpu/parallel/gspmd.py:89,
// :305-320).  What bounds it on the H100: bytes, as the row-major block's
// route: 4 of row_leaf a row, a 32-byte sector a row of the leaf once a
// slice row is 32 bytes or more, and 4 a moved row written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMissingZero = 1;   // split.py MISSING_ZERO
constexpr int kMissingNan = 2;    // split.py MISSING_NAN

// The bin of a logical feature in the slot b of its bundle column: the
// feature owns slots [off, off + nb - 2]; any other slot means another
// feature of the bundle is non-default, so this one sits in its default
// bin db.  off < 0: the feature has the column to itself.
__device__ __forceinline__ int decode_slot(int b, int off, int nb, int db) {
  if (off < 0) return b;
  const int local = b - off;
  if (local < 0 || local >= nb - 1) return db;
  return local + (local >= db ? 1 : 0);
}

}  // namespace

// The argument block of lgbt_route, packed by the Python wrapper
// (ops/route.py:_ARGS, struct format "@16Pq6iP").
struct Args {
  const void* sc;          // int64[2] (start, cnt)
  const void* odd;         // int32[1]: the window's buffer, by parity
  const void* leaf;        // int64[1]: the splitting leaf
  const void* split_i32;   // int32 [leaves, 3]: feature, threshold, dleft
  const void* split_cat;   // bool [leaves], or null
  const void* split_catb;  // bool [leaves, cat_width], or null
  const void* num_bin;     // int32 [E]
  const void* missing_type;
  const void* default_bin;
  const void* col;         // int32 [E]: the feature's column, or null
  const void* offset;      // int32 [E]: its first slot, or null
  const void* bins[2];     // uint8/uint16 [rows, F] of buffer 0 and 1
  const void* order[2];    // int32 [rows] of buffer 0 and 1, or null: the
                           // bins are the window's rows in order
  void* goes_left;         // uint8 [>= cnt]
  long long rows;
  int n_feat;              // physical columns F
  int n_logical;           // logical features E (F when unbundled)
  int cat_width;
  int grid;
  int device;
  int bin_bytes;           // 1: uint8 bins, 2: uint16
  void* stream;
};

namespace {

template <class T>
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
  if (feat < 0 || feat >= a.n_logical) return;
  const int c = a.col ? static_cast<const int32_t*>(a.col)[feat] : feat;
  const int off = a.col ? static_cast<const int32_t*>(a.offset)[feat] : -1;
  if (c < 0 || c >= a.n_feat) return;
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
  const T* bins = static_cast<const T*>(a.bins[par]) + c;
  const int32_t* order = static_cast<const int32_t*>(a.order[par]);
  uint8_t* out = static_cast<uint8_t*>(a.goes_left);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < cnt;
       p += stride) {
    const long long row = order ? (long long)__ldg(order + start + p)
                                : start + p;
    const int b = decode_slot(__ldg(bins + row * a.n_feat), off, nb, db);
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
  if (a.grid < 1 || a.n_feat < 1 || a.n_logical < 1 || a.rows < 0 ||
      (a.bin_bytes != 1 && a.bin_bytes != 2) ||
      (a.col == nullptr) != (a.offset == nullptr) ||
      (a.split_cat != nullptr && (a.split_catb == nullptr ||
                                  a.cat_width < 1)) ||
      a.bins[0] == nullptr || a.bins[1] == nullptr ||
      (a.order[0] == nullptr) != (a.order[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.bin_bytes == 2)
    lgbt_route_kernel<uint16_t>
        <<<a.grid, kThreads, 0, (cudaStream_t)a.stream>>>(a);
  else
    lgbt_route_kernel<uint8_t>
        <<<a.grid, kThreads, 0, (cudaStream_t)a.stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}

// The argument block of lgbt_route_rows, packed by the Python wrapper
// (ops/route.py:_ROWS_ARGS, struct format "@13P3q8iP").
struct RowsArgs {
  void* row_leaf;          // int32 [shards * n_loc], updated in place
  const void* bins;        // uint8/uint16: column c of row r at
                           // c * col_stride + r * row_stride
  const void* leaf;        // int64[1]: the splitting leaf
  const void* new_leaf;    // int64[1]: the leaf its right rows move to
  const void* split_i32;   // int32 [leaves, 3]: feature, threshold, dleft
  const void* split_cat;   // bool [leaves], or null
  const void* split_catb;  // bool [leaves, cat_width], or null
  const void* num_bin;     // int32 [E]
  const void* missing_type;
  const void* default_bin;
  const void* col;         // int32 [E]: the feature's column, or null
  const void* offset;      // int32 [E]: its first slot, or null
  void* counts;            // int32 [shards, n_leaves]: rows of each leaf
  long long n_loc;         // rows of a shard
  long long row_stride;    // elements from a row to the next
  long long col_stride;    // elements from a column to the next
  int shards;
  int n_feat;              // physical columns F
  int n_logical;           // logical features E (F when unbundled)
  int cat_width;
  int n_leaves;            // columns of counts: every leaf id, sinks too
  int grid_x;              // blocks a shard
  int device;
  int bin_bytes;           // 1: uint8 bins, 2: uint16
  void* stream;
};

namespace {

constexpr int kRowsUnroll = 4;       // ops/route.py ROWS_UNROLL: 16-byte
                                     // row_leaf vectors in flight a thread
constexpr int kRowsBlocksPerSm = 4;  // ops/route.py ROWS_BLOCKS_PER_SM

// The bins of the 4-row group whose first bin is at col (aligned to the
// word): one 4-byte (uint8) or 8-byte (uint16) load, little-endian.
__device__ __forceinline__ void group_word(const uint8_t* col, int b[4]) {
  const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(col));
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = (w >> (8 * i)) & 0xff;
}

__device__ __forceinline__ void group_word(const uint16_t* col, int b[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(col));
  b[0] = w.x & 0xffff;
  b[1] = w.x >> 16;
  b[2] = w.y & 0xffff;
  b[3] = w.y >> 16;
}

// kColumn: the bins' row stride is 1 (the column-major copy of the
// data-parallel learner): row_leaf in 4-row vectors, loaded before the
// split chain, and a 4-row group's bins read as one word.  Otherwise (the
// streamed grower's row-major block) one row a thread, grid-stride, the
// split chain first: that loop measured faster there (PERF.md §6).
template <class T, bool kColumn>
__global__ void __launch_bounds__(kThreads, kRowsBlocksPerSm)
lgbt_route_rows_kernel(RowsArgs a) {
  __shared__ int warp_moved[kThreads / 32];
  const long long l = *static_cast<const long long*>(a.leaf);
  const int32_t nw = (int32_t)*static_cast<const long long*>(a.new_leaf);
  const int shard = blockIdx.y;
  const long long n = a.n_loc;
  const long long base = (long long)shard * n;
  int32_t* rl = static_cast<int32_t*>(a.row_leaf) + base;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  // column-major, the shard's rows: a head up to the first 16-byte
  // boundary of row_leaf, vectors of 4 rows, a tail after the last whole
  // vector; the head and tail rows go one a thread to block 0
  long long head = 0, nvec = 0, solo = -1;
  int solo_leaf = -1;
  int4 v[kRowsUnroll];
  int4* vec = nullptr;
  if constexpr (kColumn) {
    head = min((long long)((4 - (((uintptr_t)rl >> 2) & 3)) & 3), n);
    nvec = (n - head) >> 2;
    const long long tail0 = head + 4 * nvec;
    vec = reinterpret_cast<int4*>(rl + head);
    if (blockIdx.x == 0) {
      if (threadIdx.x < head)
        solo = threadIdx.x;
      else if (threadIdx.x >= 32 && threadIdx.x - 32 < n - tail0)
        solo = tail0 + threadIdx.x - 32;
    }
    // the first round's row_leaf loads go out before the split chain
    solo_leaf = solo >= 0 ? __ldcs(rl + solo) : -1;
#pragma unroll
    for (int k = 0; k < kRowsUnroll; ++k) {
      const long long j = g + k * stride;
      v[k] = j < nvec ? __ldcs(vec + j) : make_int4(-1, -1, -1, -1);
    }
  }
  if (l < 0 || l >= a.n_leaves) return;
  const int32_t* sp = static_cast<const int32_t*>(a.split_i32) + 3 * l;
  const int feat = sp[0];
  if (feat < 0 || feat >= a.n_logical) return;
  const int c = a.col ? static_cast<const int32_t*>(a.col)[feat] : feat;
  const int off = a.col ? static_cast<const int32_t*>(a.offset)[feat] : -1;
  if (c < 0 || c >= a.n_feat) return;
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
  const T* col = static_cast<const T*>(a.bins) + (long long)c * a.col_stride +
                 base * a.row_stride;
  auto goes_right = [&](int raw) {
    const int b = decode_slot(raw, off, nb, db);
    bool left;
    if (is_cat) {
      left = __ldg(cat_row + min(b, a.cat_width - 1)) != 0;
    } else {
      const bool missing = (mt == kMissingNan && b == nb - 1) ||
                           (mt == kMissingZero && b == db);
      left = missing ? dleft : b <= thr;
    }
    return !left;
  };
  int moved = 0;
  if constexpr (kColumn) {
    // whether this shard's groups of 4 bins start on a word boundary
    const bool words =
        ((uintptr_t)(col + head) & (4 * sizeof(T) - 1)) == 0;
    if (solo_leaf == l && goes_right(__ldg(col + solo))) {
      rl[solo] = nw;
      ++moved;
    }
    for (long long j0 = g; j0 < nvec;) {
      // every group's bins first (only where the group holds a leaf
      // row), then the decisions
      int b[kRowsUnroll][4];
#pragma unroll
      for (int k = 0; k < kRowsUnroll; ++k) {
        const int r[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
        const long long p = head + 4 * (j0 + k * stride);
        const bool any = r[0] == l || r[1] == l || r[2] == l || r[3] == l;
        if (any && words) {
          group_word(col + p, b[k]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            b[k][i] = r[i] == l ? __ldg(col + p + i) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsUnroll; ++k) {
        int r[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
        int here = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r[i] == l && goes_right(b[k][i])) {
            r[i] = nw;
            ++here;
          }
        }
        if (here) {
          vec[j0 + k * stride] = make_int4(r[0], r[1], r[2], r[3]);
          moved += here;
        }
      }
      j0 += kRowsUnroll * stride;
#pragma unroll
      for (int k = 0; k < kRowsUnroll; ++k) {
        const long long j = j0 + k * stride;
        v[k] = j < nvec ? __ldcs(vec + j) : make_int4(-1, -1, -1, -1);
      }
    }
  } else {
    for (long long p = g; p < n; p += stride) {
      if (rl[p] != l) continue;
      if (goes_right(__ldg(col + p * a.row_stride))) {
        rl[p] = nw;
        ++moved;
      }
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
      int* cn = static_cast<int*>(a.counts) + (long long)shard * a.n_leaves;
      atomicAdd(cn + nw, total);
      atomicAdd(cn + l, -total);
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
      a.n_logical < 1 || a.n_loc < 0 || a.n_leaves < 1 ||
      a.row_stride < 1 || a.col_stride < 1 ||
      (a.bin_bytes != 1 && a.bin_bytes != 2) ||
      (a.col == nullptr) != (a.offset == nullptr) ||
      (a.split_cat != nullptr && (a.split_catb == nullptr ||
                                  a.cat_width < 1)))
    return (int)cudaErrorInvalidValue;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.grid_x, a.shards);
  cudaStream_t stream = (cudaStream_t)a.stream;
  if (a.bin_bytes == 2) {
    if (a.row_stride == 1)
      lgbt_route_rows_kernel<uint16_t, true><<<grid, kThreads, 0, stream>>>(a);
    else
      lgbt_route_rows_kernel<uint16_t, false><<<grid, kThreads, 0, stream>>>(a);
  } else {
    if (a.row_stride == 1)
      lgbt_route_rows_kernel<uint8_t, true><<<grid, kThreads, 0, stream>>>(a);
    else
      lgbt_route_rows_kernel<uint8_t, false><<<grid, kThreads, 0, stream>>>(a);
  }
  const int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}

// The argument block of lgbt_block_route, packed by the Python wrapper
// (ops/route.py:_BLOCK_ARGS, struct format "@14Pq8iP").
struct BlockArgs {
  void* row_leaf;          // int32 [shards * n_loc], updated in place
  const void* ptrs;        // int64 [shards, fs]: slot (i, j)'s slice, or 0
  const void* first;       // int32 [fs + 1]: the slices' column edges
  const void* leaf;        // int64[1]: the splitting leaf
  const void* new_leaf;    // int64[1]: the leaf its right rows move to
  const void* split_i32;   // int32 [leaves, 3]: feature, threshold, dleft
  const void* split_cat;   // bool [leaves], or null
  const void* split_catb;  // bool [leaves, cat_width], or null
  const void* num_bin;     // int32 [E]
  const void* missing_type;
  const void* default_bin;
  const void* col;         // int32 [E]: the feature's column, or null
  const void* offset;      // int32 [E]: its first slot, or null
  void* counts;            // int32 [shards, n_leaves]: rows of each leaf
  long long n_loc;         // rows of a shard
  int shards;
  int fs;                  // feature shards: the table's columns
  int n_logical;           // logical features E
  int cat_width;
  int n_leaves;            // columns of counts: every leaf id, sinks too
  int grid_x;              // blocks a shard
  int device;
  int bin_bytes;           // 1: uint8 bins, 2: uint16
  void* stream;
};

namespace {

template <class T>
__global__ void __launch_bounds__(kThreads) lgbt_block_route_kernel(
    BlockArgs a) {
  __shared__ int warp_moved[kThreads / 32];
  const long long l = *static_cast<const long long*>(a.leaf);
  const int32_t nw = (int32_t)*static_cast<const long long*>(a.new_leaf);
  if (l < 0 || l >= a.n_leaves) return;
  const int32_t* sp = static_cast<const int32_t*>(a.split_i32) + 3 * l;
  const int feat = sp[0];
  if (feat < 0 || feat >= a.n_logical) return;
  const int c = a.col ? static_cast<const int32_t*>(a.col)[feat] : feat;
  const int off = a.col ? static_cast<const int32_t*>(a.offset)[feat] : -1;
  const int32_t* first = static_cast<const int32_t*>(a.first);
  if (c < first[0] || c >= first[a.fs]) return;
  int j = 0;
  while (j + 1 < a.fs && first[j + 1] <= c) ++j;
  const int shard = blockIdx.y;
  const T* base = reinterpret_cast<const T*>(
      static_cast<const long long*>(a.ptrs)[(long long)shard * a.fs + j]);
  if (base == nullptr) return;   // the owning slot lies on another card
  const long long width = first[j + 1] - first[j];
  const T* colp = base + (c - first[j]);
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
  int32_t* rl = static_cast<int32_t*>(a.row_leaf) + (long long)shard * a.n_loc;
  int moved = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < a.n_loc; p += stride) {
    if (rl[p] != l) continue;
    const int b = decode_slot(__ldg(colp + p * width), off, nb, db);
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
      int* cn = static_cast<int*>(a.counts) + (long long)shard * a.n_leaves;
      atomicAdd(cn + nw, total);
      atomicAdd(cn + l, -total);
    }
  }
}

}  // namespace

// Routes the rows of x->leaf in every shard of x->row_leaf whose owning
// slot's slice x->ptrs lists, on the split that x->leaf holds in the pool,
// moving its right rows to x->new_leaf and their counts with them: one
// launch of (x->grid_x, x->shards) blocks on stream x->stream of card
// x->device, made current only if it is not.  Returns the cudaError_t (0
// on success).
extern "C" int lgbt_block_route(const BlockArgs* x) {
  const BlockArgs& a = *x;
  if (a.grid_x < 1 || a.shards < 1 || a.shards > 65535 || a.fs < 1 ||
      a.n_logical < 1 || a.n_loc < 0 || a.n_leaves < 1 ||
      a.ptrs == nullptr || a.first == nullptr ||
      (a.bin_bytes != 1 && a.bin_bytes != 2) ||
      (a.col == nullptr) != (a.offset == nullptr) ||
      (a.split_cat != nullptr && (a.split_catb == nullptr ||
                                  a.cat_width < 1)))
    return (int)cudaErrorInvalidValue;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.grid_x, a.shards);
  if (a.bin_bytes == 2)
    lgbt_block_route_kernel<uint16_t>
        <<<grid, kThreads, 0, (cudaStream_t)a.stream>>>(a);
  else
    lgbt_block_route_kernel<uint8_t>
        <<<grid, kThreads, 0, (cudaStream_t)a.stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}
