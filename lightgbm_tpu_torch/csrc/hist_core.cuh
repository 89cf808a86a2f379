// The histogram core that hist_gather.cu (K1) and hist_local.cu (K3)
// share, for Hopper (sm_90a).
//
// Both kernels compute out[f][b] = (sum g, sum h, count) over a set of
// rows of the [N, F] bin matrix, uint8 or uint16 (the bin type T of every
// function below: the JAX package stores uint16 when a column has more
// than 256 bins, lightgbm_tpu/data/dataset.py:140); they differ only in
// how the rows are found, which this header takes as a "row source":
//   GatherRows - positions p of the window order[start, start + cnt), row
//                order[start + p]; (start, cnt) are read from device memory;
//   MaskedRows - positions p of the row shard, a coalesced scan of
//                row_leaf; p is a row of the leaf iff row_leaf[p] == leaf.
//                Given the shard's per-leaf row counts in device memory
//                (leaf_rows), the leaf's count is read there: the scan
//                still covers every position, but the gate below compares
//                the true count, and a leaf of no rows scans nothing.
//
// Two regimes, chosen on the host from a bound it already holds (the
// launch plan, lightgbm_tpu_torch/ops/histogram.py:plan_launch), or on the
// device from the true count (the "device" regime of the growers' split
// steps, plan_device and plan_device_local: both kernels are launched,
// each over the grid of the largest count it can take, and each returns
// at once unless the count lies in its range):
//   small - no shared-memory histogram.  Each matching row reads its bins
//           four columns at a time with one 32-bit load (uint8) or one
//           64-bit load (uint16), two where they straddle, and adds its
//           three weights straight into `out` with global reductions
//           (red.global.add.f32: an atomicAdd whose result is unused).  No
//           block zeroes or flushes a histogram, so a small window costs
//           about its own reductions, as index_add_ does, without a
//           separate gather;
//   large - a privatised histogram of one group of columns in shared
//           memory: blockIdx.y picks the group, blockIdx.x a contiguous
//           slice of the positions.  A block zeroes its group's
//           [w, bins, 3] histogram, adds its rows with shared-memory
//           atomics and flushes the non-zero entries to `out` with global
//           reductions.  Groups are narrow (4 columns, 12 KB at 255 bins),
//           so several blocks stay resident on an SM and a small window
//           under a large bound zeroes and flushes little.  A wide
//           histogram takes fewer columns a group (the host plan derives
//           the width from the bins, ops/histogram.py:plan_launch): at most
//           48 KB a block up to 4,096 bins; one column a group above it,
//           in dynamic shared memory past 48 KB up to the card's opt-in
//           limit (227 KB, 19,370 bins); past that the bins of the column
//           are cut into slices on blockIdx.z, each block counting only
//           the rows whose bin lies in its slice (uint16 only).
//   The large regime's groups were timed on an H100 against a thread block
//   cluster form, whose blocks each held a column slice of one histogram
//   and added into each other's slices through distributed shared memory;
//   the groups won at every window (hist_gather.cu says why).
//
// A second set of row source and weights may be given with a selector in
// device memory (`sel`, odd: the second set): the serial grower keeps a
// leaf's window in one of two buffers by its depth parity, which only the
// device knows inside the captured step.
//
// `out` is zeroed by the C entry point (cudaMemsetAsync on the kernel's
// stream) before the launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hist {

constexpr int kThreads = 256;
constexpr int kRegimeSmall = 0;
constexpr int kRegimeLarge = 1;
constexpr int kRegimeDevice = 2;   // both kernels, each gated by the count

// How a kernel reads bins of type T: Bins<T>::load4(p, k) returns the
// k <= 4 bins at p (any alignment of T) as the low lanes of one word,
// Bins<T>::bin(word, j) the j-th of them.  Only words that hold a wanted
// bin are read, so a load never passes the row's last bin.
template <class T>
struct Bins;

template <>
struct Bins<uint8_t> {
  using Word = uint32_t;
  static constexpr bool kSliced = false;   // 256 bins fit any block
  // one 32-bit load, two when the k bytes straddle a word
  __device__ static __forceinline__ Word load4(const uint8_t* p, int k) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const int shift = int(a & 3) * 8;
    const uint32_t lo = __ldg(w);
    const uint32_t hi = shift + 8 * k > 32 ? __ldg(w + 1) : 0u;
    return __funnelshift_r(lo, hi, shift);
  }
  __device__ static __forceinline__ int bin(Word w, int j) {
    return (w >> (8 * j)) & 0xff;
  }
};

template <>
struct Bins<uint16_t> {
  using Word = unsigned long long;
  static constexpr bool kSliced = true;    // a block may count a slice
  // one 64-bit load, two when the 2k bytes straddle a word: a row of F
  // uint16 bins starts at a 2F-byte stride, so it may be only 2-byte
  // aligned
  __device__ static __forceinline__ Word load4(const uint16_t* p, int k) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const Word* w = reinterpret_cast<const Word*>(a & ~uintptr_t(7));
    const int shift = int(a & 7) * 8;      // 0, 16, 32 or 48
    const Word lo = __ldg(w);
    if (shift == 0) return lo;
    const Word hi = shift + 16 * k > 64 ? __ldg(w + 1) : 0ull;
    return (lo >> shift) | (hi << (64 - shift));
  }
  __device__ static __forceinline__ int bin(Word w, int j) {
    return int((w >> (16 * j)) & 0xffff);
  }
};

// Adds (g, h, c) of one row into the entries of its k bins of columns
// f0, f0 + 1, ... of a histogram of `stride` bins a column that starts at
// bin lo: global reductions (small regime) or shared-memory atomics
// (large regime), both with the result unused.  A bin outside
// [lo, lo + stride) belongs to another block's slice (uint16 only).
template <class T>
__device__ __forceinline__ void add_word(float* base, int f0,
                                         typename Bins<T>::Word word, int k,
                                         int stride, int lo, float g,
                                         float h, float c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < k) {
      int b = Bins<T>::bin(word, j);
      if (Bins<T>::kSliced) {
        b -= lo;
        if ((unsigned)b >= (unsigned)stride) continue;
      }
      float* e = base + ((f0 + j) * stride + b) * 3;
      atomicAdd(e, g);
      atomicAdd(e + 1, h);
      atomicAdd(e + 2, c);
    }
  }
}

// Adds the nf columns of one row, whose bins start at r, into `base`,
// which holds them from its entry 0, `stride` bins a column from bin lo.
template <class T>
__device__ __forceinline__ void add_row(float* base, const T* r, int nf,
                                        int stride, int lo, float g,
                                        float h, float c) {
  for (int w = 0; w < nf; w += 4) {
    const int k = min(4, nf - w);
    add_word<T>(base, w, Bins<T>::load4(r + w, k), k, stride, lo, g, h, c);
  }
}

struct GatherRows {
  static constexpr bool kMasked = false;
  const int32_t* order;
  const int32_t* sc;  // (start, cnt) in device memory
  long long start;
  __device__ void rebase(const void* p) {
    order = static_cast<const int32_t*>(p);
  }
  // number of positions, and the count the gate compares; call once
  __device__ long long begin(long long* count) {
    start = sc[0];
    *count = sc[1];
    return sc[1];
  }
  __device__ bool row(long long p, long long* r) const {
    *r = order[start + p];
    return true;
  }
};

struct MaskedRows {
  static constexpr bool kMasked = true;
  const int32_t* row_leaf;
  const int32_t* leaf_id;    // in device memory
  const int32_t* leaf_rows;  // every leaf's rows in the shard, or null
  long long n_loc;
  int32_t leaf;
  __device__ void rebase(const void* p) {
    row_leaf = static_cast<const int32_t*>(p);
  }
  __device__ long long begin(long long* count) {
    leaf = *leaf_id;
    if (!leaf_rows) {  // the host's plan: the scan's positions
      *count = n_loc;
      return n_loc;
    }
    *count = leaf_rows[leaf];
    return *count > 0 ? n_loc : 0;
  }
  __device__ bool row(long long p, long long* r) const {
    *r = p;
    return row_leaf[p] == leaf;
  }
};

struct Weights {
  const void* bins;   // T [N, F]
  const float* gw;
  const float* hw;
  const float* cw;
  float* out;
  int n_feat;
  int num_bins;
  int slice_bins;     // bins a large-regime block counts (num_bins: all)
  // the kernel returns at once unless the row source's count lies in
  // [min_rows, max_rows] (the device regime's gate; 0 and the maximum
  // when the host picked the regime)
  long long min_rows;
  long long max_rows;
  // the second set (null sel: none): rows, bins and weights
  const int32_t* sel;
  const void* alt_rows;
  const void* alt_bins;
  const float* alt_gw;
  const float* alt_hw;
  const float* alt_cw;
};

// The set the selector picks, then the count of positions, or -1 when the
// kernel's gate excludes the row source's count.  Call once, at the top of
// a kernel.
template <class Rows>
__device__ __forceinline__ long long open_rows(Rows& rows, Weights& a) {
  if (a.sel && (*a.sel & 1)) {
    rows.rebase(a.alt_rows);
    a.bins = a.alt_bins;
    a.gw = a.alt_gw;
    a.hw = a.alt_hw;
    a.cw = a.alt_cw;
  }
  long long count;
  const long long n = rows.begin(&count);
  return count < a.min_rows || count > a.max_rows ? -1 : n;
}

// Positions per block when nb blocks cover n of them in contiguous slices,
// a multiple of the block size.
__device__ __forceinline__ long long slice_len(long long n, int nb) {
  long long c = (n + nb - 1) / nb;
  return (c + kThreads - 1) / kThreads * kThreads;
}

// Small regime: adds weight w of statistic s (0: g, 1: h, 2: count) of one
// row into the entries of its k bins of columns f0, f0 + 1, ... of `out`
// with global reductions.  Three neighbouring lanes take the three
// statistics of one entry, so a warp's reduction touches each entry's
// 12 bytes at once, mostly in one 32-byte sector.
template <class T>
__device__ __forceinline__ void red_stat(float* out, int f0,
                                         typename Bins<T>::Word word, int k,
                                         int num_bins, int s, float w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < k)
      atomicAdd(out + ((long long)(f0 + j) * num_bins + Bins<T>::bin(word, j))
                    * 3 + s, w);
  }
}

// Lane q of a row's (4-column group, statistic) lanes adds its part of row
// r into `out`.
template <class T>
__device__ __forceinline__ void red_lane(const Weights& a, long long r,
                                         int q) {
  const int grp = q / 3;
  const int s = q - 3 * grp;
  const int f0 = 4 * grp;
  const int k = min(4, a.n_feat - f0);
  const float* w = s == 0 ? a.gw : (s == 1 ? a.hw : a.cw);
  red_stat<T>(a.out, f0,
              Bins<T>::load4(static_cast<const T*>(a.bins) + r * a.n_feat +
                                 f0, k),
              k, a.num_bins, s, w[r]);
}

// Small regime, gather: a thread per (position, 4-column group,
// statistic), so even a window of a few thousand rows spreads over the
// card.
template <class T, class Rows>
__device__ void small_gather(Rows rows, Weights a) {
  const long long n = open_rows(rows, a);
  if (n < 0) return;
  const int lanes = 3 * ((a.n_feat + 3) / 4);
  const long long total = n * lanes;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += stride) {
    const long long p = t / lanes;
    long long r;
    if (rows.row(p, &r)) red_lane<T>(a, r, int(t - p * lanes));
  }
}

// Small regime, masked scan: a thread per position tests its row; then
// the warp adds each of its matching rows together, a lane per (4-column
// group, statistic).
template <class T, class Rows>
__device__ void small_scan(Rows rows, Weights a) {
  const long long n = open_rows(rows, a);
  if (n < 0) return;
  const int lane = threadIdx.x & 31;
  const int lanes = 3 * ((a.n_feat + 3) / 4);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x - lane;
       base < n; base += stride) {  // uniform over the warp
    const long long p = base + lane;
    long long r = 0;
    unsigned m = __ballot_sync(0xffffffffu, p < n && rows.row(p, &r));
    while (m) {
      const long long rr = __shfl_sync(0xffffffffu, r, __ffs(m) - 1);
      m &= m - 1;
      for (int q = lane; q < lanes; q += 32) red_lane<T>(a, rr, q);
    }
  }
}

// Large regime, groups form: blockIdx.y is the column group of width
// group_w, blockIdx.x the slice of positions and blockIdx.z the slice of
// slice_bins bins (one, of all bins, unless a column's histogram is wider
// than a block's shared memory; then the group is one column).
template <class T, class Rows>
__device__ void large_groups(Rows rows, Weights a, int group_w) {
  extern __shared__ float sh[];
  const long long n = open_rows(rows, a);
  if (n < 0) return;
  const long long len = slice_len(n, gridDim.x);
  const long long lo = (long long)blockIdx.x * len;
  if (lo >= n) return;  // no position: no zeroing, no flush
  const long long hi = min(n, lo + len);
  if (Rows::kMasked) {  // skip a slice that holds no row of the leaf
    int any = 0;
    long long r;
    for (long long p = lo + threadIdx.x; p < hi && !any; p += kThreads)
      any = rows.row(p, &r);
    if (!__syncthreads_or(any)) return;
  }
  const int f0 = blockIdx.y * group_w;
  const int nf = min(group_w, a.n_feat - f0);
  const int b0 = blockIdx.z * a.slice_bins;
  const int nb = min(a.slice_bins, a.num_bins - b0);
  const int nsh = nf * nb * 3;
  const T* bins = static_cast<const T*>(a.bins) + f0;
  for (int i = threadIdx.x; i < nsh; i += kThreads) sh[i] = 0.f;
  __syncthreads();
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    long long r;
    if (!rows.row(p, &r)) continue;
    add_row<T>(sh, bins + r * a.n_feat, nf, nb, b0, a.gw[r], a.hw[r],
               a.cw[r]);
  }
  __syncthreads();
  // one slice of bins, or all of them: the block's entries are contiguous
  // in `out` either way
  float* o = a.out + ((long long)f0 * a.num_bins + b0) * 3;
  for (int i = threadIdx.x; i < nsh; i += kThreads) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

// The argument block of both C entry points, packed by the Python wrapper
// (ops/histogram.py:_ARGS, struct format "@14Pq13iP"): one ctypes argument
// instead of twenty-nine, each of which costs the host a conversion per
// call.
struct Args {
  const void* rows_a;  // order (hist_gather) or row_leaf (hist_local)
  const void* rows_b;  // (start, cnt) or leaf_id, in device memory
  const void* bins;
  const void* gw;
  const void* hw;
  const void* cw;
  void* out;
  const void* sel;     // int32[1] in device memory, or null: no second set
  const void* alt_rows;
  const void* alt_bins;
  const void* alt_gw;
  const void* alt_hw;
  const void* alt_cw;
  const void* leaf_rows;  // hist_local: int32 per-leaf rows of the shard,
                          // or null (the scan's gate takes n_loc)
  long long n_loc;     // local rows of the masked scan (hist_local)
  int n_feat;
  int num_bins;
  int regime;
  int grid_x;
  int grid_y;
  int group_w;
  int smem;
  int device;
  int small_grid_x;    // device regime: the small kernel's grid
  int split_rows;      // device regime: the small kernel's largest count
  int grid_z;          // large regime: slices of the bins (1: none)
  int slice_bins;      // bins a slice holds (num_bins when grid_z is 1)
  int bin_bytes;       // 1: uint8 bins, 2: uint16
  void* stream;
};

// Launch parameters from the host's plan; the C entry points check them.
struct Plan {
  int regime;
  int grid_x;        // large regime (device regime: its large kernel)
  int grid_y;
  int group_w;   // columns per shared-memory group (large regime)
  int smem;      // dynamic shared memory per block, bytes
  int small_grid_x;
  int split_rows;
  int grid_z;
  int slice_bins;
};

// Dynamic shared memory a block may take without cudaFuncSetAttribute; a
// 4-column group at 256 bins takes 12 KB.  Above it, up to the H100's
// opt-in limit, only after cudaFuncSetAttribute (allow_smem).
constexpr int kMaxSmem = 48 * 1024;
constexpr int kMaxSmemOptIn = 232448;   // 227 KB
constexpr int kMaxDevices = 64;

inline bool plan_ok(const Plan& p, int n_feat, int num_bins, int bin_bytes) {
  if (p.grid_x < 1 || p.grid_y < 1 || p.grid_y > 65535 || p.smem < 0 ||
      p.smem > kMaxSmemOptIn || p.grid_z < 1 || p.grid_z > 65535 ||
      (bin_bytes != 1 && bin_bytes != 2) ||
      num_bins > (bin_bytes == 1 ? 256 : 65536) ||
      (long long)n_feat * num_bins * 3 > 0x7fffffffll)
    return false;
  if (p.regime == kRegimeSmall) return p.grid_y == 1 && p.grid_z == 1;
  if (p.regime == kRegimeDevice &&
      (p.small_grid_x < 1 || p.split_rows < 0))
    return false;
  // bins are sliced only one column a group, and only uint16
  return (p.regime == kRegimeLarge || p.regime == kRegimeDevice) &&
         p.group_w >= 1 && p.slice_bins >= 1 &&
         (long long)p.grid_z * p.slice_bins >= num_bins &&
         (p.grid_z == 1 ? p.slice_bins == num_bins
                        : p.group_w == 1 && bin_bytes == 2) &&
         p.smem >= p.group_w * p.slice_bins * 3 * (int)sizeof(float) &&
         (long long)p.grid_y * p.group_w >= n_feat;
}

// The dynamic shared memory limit of the large kernel raised to the
// opt-in limit, once per card, when a plan needs more than 48 KB.
// `done` is the kernel's own record: one per (bin type, row source).
template <class Rows>
int allow_smem(void (*groups)(Rows, Weights, int), int bytes, int device,
               bool* done) {
  if (bytes <= kMaxSmem) return 0;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  if (done[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      groups, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemOptIn);
  if (err == cudaSuccess) done[device] = true;
  return (int)err;
}

// Zeroes `out` and launches the kernel of the plan's regime (both kernels,
// each gated by the count, in the device regime) on `stream` of the
// current card; returns the cudaError_t (0 on success).
template <class Rows>
int launch_on(void (*small)(Rows, Weights),
              void (*groups)(Rows, Weights, int), Rows rows, Weights a,
              const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      a.out, 0, (size_t)a.n_feat * a.num_bins * 3 * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  if (p.regime == kRegimeSmall) {
    small<<<p.grid_x, kThreads, 0, stream>>>(rows, a);
  } else if (p.regime == kRegimeLarge) {
    groups<<<grid, kThreads, p.smem, stream>>>(rows, a, p.group_w);
  } else {
    Weights s = a, l = a;
    s.max_rows = p.split_rows;
    l.min_rows = (long long)p.split_rows + 1;
    small<<<p.small_grid_x, kThreads, 0, stream>>>(rows, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    groups<<<grid, kThreads, p.smem, stream>>>(rows, l, p.group_w);
  }
  return (int)cudaGetLastError();
}

// launch_on with card `device` current, made so for the launch only when
// it is not (a mesh slot may sit on any visible card).  `done` is the
// large kernel's record of the cards on which its shared memory limit is
// raised (allow_smem).
template <class Rows>
int launch(void (*small)(Rows, Weights), void (*groups)(Rows, Weights, int),
           bool* done, Rows rows, const Args& x) {
  const Weights a{x.bins, (const float*)x.gw,
                  (const float*)x.hw, (const float*)x.cw, (float*)x.out,
                  x.n_feat, x.num_bins, x.slice_bins, 0,
                  0x7fffffffffffffffll, (const int32_t*)x.sel, x.alt_rows,
                  x.alt_bins, (const float*)x.alt_gw,
                  (const float*)x.alt_hw, (const float*)x.alt_cw};
  const Plan p{x.regime, x.grid_x, x.grid_y, x.group_w, x.smem,
               x.small_grid_x, x.split_rows, x.grid_z, x.slice_bins};
  const int device = x.device;
  const cudaStream_t stream = (cudaStream_t)x.stream;
  if (!plan_ok(p, a.n_feat, a.num_bins, x.bin_bytes) ||
      (a.sel && !(a.alt_rows && a.alt_bins && a.alt_gw && a.alt_hw &&
                  a.alt_cw)))
    return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int rc = p.regime == kRegimeSmall ? 0
                                    : allow_smem(groups, p.smem, device, done);
  if (rc == 0) rc = launch_on(small, groups, rows, a, p, stream);
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}

}  // namespace hist
