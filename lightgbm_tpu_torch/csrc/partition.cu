// Stable window-partition kernel for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_compact.py:compact_pallas (the Pallas
// kernel behind compact_window): the grower's split step, which stably
// partitions a leaf's window [start, start + cnt) by a goes_left mask -
// lefts first, both sides in their original order - and returns the left
// count nl.  It moves one or more row-major matrices (`order`, and the
// leaf-ordered bins and weights of ordered_bins=on) the same way.  It
// computes the same function, not the same blocks: the TPU kernel applied
// one-hot permutation matmuls on the MXU to f32-encoded 512-row blocks;
// here each tile of the window ranks its positions and moves their rows.
//
// Out of place: every matrix is read from `src` and written to the same
// positions of `dst` (the grower keeps two buffers and alternates them by
// depth parity).  Windows of different leaves never overlap, so no block
// reads a position that another block writes, and no pass copies the
// window back.  (start, cnt) and the parity are read from device memory,
// so the serial grower's captured split step, which knows neither the
// count nor which buffer holds the window, calls it as it is: the host
// passes only a bound on cnt that sizes the grid (the step passes the
// rows), and an int32 parity in device memory swaps src and dst when it
// is odd.  Tiles past the count return at once; the cost of the empty
// launches is in PERF.md.
//
// What bounds it on the H100: bytes.  Per window position it reads the
// mask (1 B) and each matrix row, and writes each row once; there is no
// arithmetic to speak of.  The design keeps the launches few and every
// global access coalesced:
//   - a block takes a tile of 2,048 positions: it reads their mask, ranks
//     them with a block scan (lefts first), and reads every matrix's rows
//     into shared memory at their rank with asynchronous copies (cp.async,
//     all matrices in flight at once, one wait).  It then stores its left
//     run and its right run as two contiguous ranges of each matrix in
//     `dst`, 16 bytes a store where the rows are whole words: each run is
//     staged at the same address modulo 16 as its destination;
//   - a tile needs its left base (the lefts before it) and nl.  Every
//     call makes three launches, and the true cnt picks which of them do
//     the work (each of the others returns at once):
//     small (cnt <= kSmallMax), one launch: every tile sums the whole
//       window's mask itself (a byte a position, read from L2 16 bytes at
//       a time), which gives both numbers with no other pass; a window of
//       one tile is one block;
//     large (the rest), two launches: a count pass (the mask only) writes
//       each tile's left count as its status word, and its last block
//       writes nl; the write pass then finds each tile's left base by
//       decoupled look-back (Merrill and Garland): a tile reads its
//       predecessors' status words, 32 at a time, back to the nearest one
//       that has published its inclusive prefix, and publishes its own.
//       Every status word already holds its tile's count when the write
//       pass starts, so no tile ever waits on another, in whatever order
//       the tiles are scheduled: the look-back is short when the
//       predecessors ran first, and correct in any order.  The count pass
//       rewrites every status word on the stream, so a stale word of an
//       earlier call is never read.
//   Timed in turns on an H100 (PERF.md), the small launch wins up to some
//   two hundred thousand positions, where summing the whole mask in every
//   tile starts to cost more than the second launch.  Three passes for
//   the large windows (count, a one-block scan of the tile counts, write) lost
//   to the look-back at every window, and a tile that issued its row
//   copies in the rows' own order before ranking (16-byte copies, stores
//   gathered through a rank -> position map) lost to staging at the
//   rank; both were deleted.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxMats = 9;            // order + 8 payload matrices

// The argument block of the C entry point, packed by the Python wrapper
// (ops/partition.py:_ARGS, struct format "@9P9P9q5P3q2iP").
struct Args {
  const void* src[kMaxMats];
  void* dst[kMaxMats];
  long long width[kMaxMats];   // bytes a row
  const void* goes_left;       // [>= cnt] bool / uint8, nonzero = left
  const void* sc;              // int64[2] (start, cnt) on the device
  void* nl_out;                // int32[1]
  void* scratch;               // uint64 status[tiles], then a uint32 ticket
  const void* odd;             // int32[1] on the device, or null: when odd,
                               // src and dst swap
  long long rows;              // rows of every matrix
  long long bound;             // host bound on cnt: the grid's positions
  long long scratch_tiles;     // status words the scratch holds
  int n_mats;
  int device;
  void* stream;
};

namespace {

// the small launch takes windows of at most this many positions, the
// count and write launches the larger ones (ops/partition.py
// SMALL_MAX_ROWS, the H100's crossover)
constexpr long long kSmallMax = 196608;

// tile geometry: a block of any launch takes one tile of positions
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // 2,048 positions
// staged rows a block holds at most (dynamic shared memory, 4-byte words):
// the Expo-shaped path's rows fit whole, order and payload: 24 bytes with
// uint8 bins (12,348 words a tile), 32 with uint16 bins (16,444 words);
// a tile takes only the words its rows need
constexpr int kStageWords = 20480;         // 80 KB
constexpr int kRunPad = 12;               // words a matrix adds for shifts

// Staged words of one matrix's n rows of wpr words: a multiple of 4, so
// that the next matrix starts 16-byte aligned, with room for both runs'
// shifts (runs_at).
__host__ __device__ __forceinline__ int region(int n, int wpr) {
  return ((n * wpr + 3) & ~3) + kRunPad;
}

// status words: flag in the top bits, a left count in the low 32
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kValue = 0xffffffffull;

// The window as the device holds it: start, and cnt clamped to the host's
// bound and to the matrices' rows.
struct Window {
  long long start, cnt;
};

__device__ __forceinline__ Window window(const Args& a) {
  const long long* sc = static_cast<const long long*>(a.sc);
  Window w;
  w.start = sc[0];
  long long c = sc[1];
  if (c > a.bound) c = a.bound;
  if (c > a.rows - w.start) c = a.rows - w.start;
  w.cnt = c > 0 && w.start >= 0 ? c : 0;
  return w;
}

__device__ __forceinline__ bool left_at(const uint8_t* gl, long long p) {
  return __ldg(gl + p) != 0;
}

// Whether src and dst swap: the parity in device memory is odd.
__device__ __forceinline__ bool swapped(const Args& a) {
  return a.odd != nullptr && (*static_cast<const int32_t*>(a.odd) & 1);
}

// Matrix j's source and destination after the parity's swap.
__device__ __forceinline__ const void* src_of(const Args& a, int j,
                                              bool swap) {
  return swap ? a.dst[j] : a.src[j];
}

__device__ __forceinline__ void* dst_of(const Args& a, int j, bool swap) {
  return swap ? const_cast<void*>(a.src[j]) : a.dst[j];
}

// Exclusive block scan of one int a thread; returns the thread's prefix
// and the block's total in *total.
__device__ __forceinline__ int block_scan(int v, int* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kThreads / 32;
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();   // warp_sums is rewritten by the next scan
  return before + x - v;
}

// Static shared memory of one tile; the staged rows are dynamic.
struct TileSmem {
  uint16_t rank[kTile];              // local rank of each position
  int warp_sums[kThreads / 32];
  long long base;                    // broadcast of the tile's left base
};

// Ranks the n positions [lo, lo + n) of the window (thread t owns
// kItems consecutive ones): lefts 0..L-1, rights L..n-1.  Returns L.
__device__ int rank_tile(const uint8_t* gl, long long lo, int n,
                         TileSmem& sm) {
  const int p0 = threadIdx.x * kItems;
  bool f[kItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    f[i] = p0 + i < n && left_at(gl, lo + p0 + i);
    c += f[i];
  }
  int L;
  int before = block_scan(c, sm.warp_sums, &L);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = p0 + i;
    if (p < n) {
      sm.rank[p] = (uint16_t)(f[i] ? before : L + (p - before));
      before += f[i];
    }
  }
  __syncthreads();
  return L;
}

// A 4-byte copy from global to shared memory that does not wait for its
// data: a thread issues all of its tile's copies, then waits once.
__device__ __forceinline__ void copy_async4(uint32_t* sm, const uint32_t* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(sm);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stores nwords staged words to dst, which agrees with sm modulo 16
// bytes: single words up to dst's first 16-byte boundary, 16 bytes a
// store through the body, single words for the tail.
__device__ __forceinline__ void store_run(uint32_t* dst, const uint32_t* sm,
                                          int nwords) {
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
  if (head > nwords) head = nwords;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = sm[threadIdx.x];
  const int body = (nwords - head) >> 2;
  const uint4* s4 = reinterpret_cast<const uint4*>(sm + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads) d4[i] = s4[i];
  for (int i = head + 4 * body + threadIdx.x; i < nwords; i += kThreads)
    dst[i] = sm[i];
}

__device__ __forceinline__ int div_small(int k, int s) {
  return s == 1 ? k : (s == 2 ? k >> 1 : k / s);
}

__device__ __forceinline__ bool word_rows(const Args& a, int j) {
  return (a.width[j] & 3) == 0 &&
         ((reinterpret_cast<uintptr_t>(a.src[j]) |
           reinterpret_cast<uintptr_t>(a.dst[j])) & 3) == 0;
}

// Where matrix j's two runs start in the staged words from `off`: each at
// its destination's address modulo 16 when the rows move whole (s words
// of wpr), so that store_run stores 16 bytes at a time.
struct Runs {
  int offl, offr;
};

__device__ __forceinline__ Runs runs_at(int off, const uint32_t* dst,
                                        long long dl, long long dr, int wpr,
                                        int s, int L) {
  const bool whole = s == wpr;
  const int offl = off + (whole ? (int)((reinterpret_cast<uintptr_t>(
                                      dst + dl * wpr) >> 2) & 3) : 0);
  const int offr = ((offl + L * s + 3) & ~3) +
                   (whole ? (int)((reinterpret_cast<uintptr_t>(
                                dst + dr * wpr) >> 2) & 3) : 0);
  return {offl, offr};
}

// Moves the rows of the n positions [lo, lo + n) of every matrix: lefts to
// dst rows start + lbase.., rights to start + nl + rbase..  sm.rank holds
// the positions' local ranks, L of them left; `stage` holds stage_words.
// Matrices of whole words move in groups that fit the stage at once: one
// phase of asynchronous copies into rank order, one wait, then each
// matrix's two runs stored.  A matrix too wide for the stage moves in
// column slabs, and one whose rows are not whole words byte by byte.
__device__ void move_tile(const Args& a, bool swap, long long start,
                          long long lo, int n, int L, long long lbase,
                          long long rbase, long long nl, const TileSmem& sm,
                          uint32_t* stage, int stage_words) {
  const long long row0 = start + lo;
  const long long dl = start + lbase;        // dst row of the left run
  const long long dr = start + nl + rbase;   // dst row of the right run
  int j = 0;
  while (j < a.n_mats) {
    int j1 = j, used = 0;
    while (j1 < a.n_mats && word_rows(a, j1)) {
      const int need = region(n, (int)(a.width[j1] >> 2));
      if (used + need > stage_words) break;
      used += need;
      ++j1;
    }
    if (j1 > j) {   // a group of whole matrices
      int off = 0;
      for (int m = j; m < j1; ++m) {
        const int wpr = (int)(a.width[m] >> 2);
        const Runs r = runs_at(off, static_cast<const uint32_t*>(
                                        dst_of(a, m, swap)),
                               dl, dr, wpr, wpr, L);
        const uint32_t* s32 =
            static_cast<const uint32_t*>(src_of(a, m, swap)) + row0 * wpr;
        for (int k = threadIdx.x; k < n * wpr; k += kThreads) {
          const int p = div_small(k, wpr);
          const int q = sm.rank[p];
          copy_async4(stage + (q < L ? r.offl + q * wpr
                                     : r.offr + (q - L) * wpr) + (k - p * wpr),
                      s32 + k);
        }
        off += region(n, wpr);
      }
      copy_async_wait();
      __syncthreads();
      off = 0;
      for (int m = j; m < j1; ++m) {
        const int wpr = (int)(a.width[m] >> 2);
        uint32_t* d32 = static_cast<uint32_t*>(dst_of(a, m, swap));
        const Runs r = runs_at(off, d32, dl, dr, wpr, wpr, L);
        store_run(d32 + dl * wpr, stage + r.offl, L * wpr);
        store_run(d32 + dr * wpr, stage + r.offr, (n - L) * wpr);
        off += region(n, wpr);
      }
      __syncthreads();
      j = j1;
      continue;
    }
    const long long w = a.width[j];
    if (word_rows(a, j)) {   // too wide: column slabs of s words
      const int wpr = (int)(w >> 2);
      const uint32_t* s32 = static_cast<const uint32_t*>(src_of(a, j, swap));
      uint32_t* d32 = static_cast<uint32_t*>(dst_of(a, j, swap));
      const int slab = max(1, (stage_words - kRunPad) / max(n, 1));
      for (int c0 = 0; c0 < wpr; c0 += slab) {
        const int s = min(slab, wpr - c0);
        const Runs r = runs_at(0, d32, dl, dr, wpr, s, L);
        for (int k = threadIdx.x; k < n * s; k += kThreads) {
          const int p = div_small(k, s);
          const int c = k - p * s;
          const int q = sm.rank[p];
          copy_async4(stage + (q < L ? r.offl + q * s : r.offr + (q - L) * s) +
                          c,
                      s32 + (row0 + p) * wpr + c0 + c);
        }
        copy_async_wait();
        __syncthreads();
        for (int k = threadIdx.x; k < n * s; k += kThreads) {
          const int q = div_small(k, s);
          const int c = k - q * s;
          const long long row = q < L ? dl + q : dr + (q - L);
          d32[row * wpr + c0 + c] =
              stage[(q < L ? r.offl + q * s : r.offr + (q - L) * s) + c];
        }
        __syncthreads();
      }
    } else {   // rows of bytes: the same staging, a byte at a time
      const uint8_t* src = static_cast<const uint8_t*>(src_of(a, j, swap));
      uint8_t* dst = static_cast<uint8_t*>(dst_of(a, j, swap));
      uint8_t* st = reinterpret_cast<uint8_t*>(stage);
      const int wb = (int)w;
      const int slab = max(1, min(wb, 4 * stage_words / max(n, 1)));
      for (int c0 = 0; c0 < wb; c0 += slab) {
        const int s = min(slab, wb - c0);
        for (int k = threadIdx.x; k < n * s; k += kThreads) {
          const int p = k / s;
          const int c = k - p * s;
          st[sm.rank[p] * s + c] = __ldg(src + (row0 + p) * w + c0 + c);
        }
        __syncthreads();
        for (int k = threadIdx.x; k < n * s; k += kThreads) {
          const int q = k / s;
          const int c = k - q * s;
          const long long row = q < L ? dl + q : dr + (q - L);
          dst[row * w + c0 + c] = st[k];
        }
        __syncthreads();
      }
    }
    ++j;
  }
}

// The large windows' count pass: tile t's left count into status[t]; the
// last block to finish sums them into nl and resets the ticket.  Only the
// window's tiles (at least one) take part; the others return at once.
__global__ void __launch_bounds__(kThreads)
lgbt_partition_count(Args a) {
  __shared__ bool last;
  __shared__ long long warp_total[kThreads / 32];
  unsigned long long* status = static_cast<unsigned long long*>(a.scratch);
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(status + a.scratch_tiles);
  const Window win = window(a);
  if (win.cnt <= kSmallMax) return;   // the small launch's window
  const long long tiles = win.cnt > 0 ? (win.cnt + kTile - 1) / kTile : 1;
  if ((long long)blockIdx.x >= tiles) return;
  const uint8_t* gl = static_cast<const uint8_t*>(a.goes_left);
  const long long lo = (long long)blockIdx.x * kTile;
  int total = 0;
  for (int it = 0; it < kItems; ++it) {
    const long long p = lo + it * kThreads + threadIdx.x;
    total += __syncthreads_count(p < win.cnt && left_at(gl, p));
  }
  if (threadIdx.x == 0) {
    status[blockIdx.x] = kAggregate | (unsigned long long)total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)(tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  long long sum = 0;
  for (long long t = threadIdx.x; t < tiles; t += kThreads)
    sum += (long long)(((volatile unsigned long long*)status)[t] & kValue);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_total[w];
    *static_cast<int32_t*>(a.nl_out) = (int32_t)s;
    *ticket = 0u;
  }
}

// The nonzero bytes of a word (0x80 in each byte's top bit where the
// byte's low seven bits or its top bit are set).
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  return __popc((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u);
}

// Lefts in the window's mask (bytes, nonzero = left) before position lo
// (a multiple of 16) and in all of it, summed by the block: 16 bytes a
// load where the mask is 16-byte aligned.
__device__ void count_lefts(const uint8_t* gl, long long cnt, long long lo,
                            long long* before, long long* total,
                            long long* red) {
  long long b = 0, t = 0;
  const long long whole = (reinterpret_cast<uintptr_t>(gl) & 15) == 0
                              ? cnt / 16 : 0;
  const uint4* g4 = reinterpret_cast<const uint4*>(gl);
  for (long long c = threadIdx.x; c < whole; c += kThreads) {
    const uint4 v = __ldg(g4 + c);
    const int n = nonzero_bytes(v.x) + nonzero_bytes(v.y) +
                  nonzero_bytes(v.z) + nonzero_bytes(v.w);
    t += n;
    if (16 * c < lo) b += n;
  }
  for (long long p = 16 * whole + threadIdx.x; p < cnt; p += kThreads) {
    const int n = left_at(gl, p);
    t += n;
    if (p < lo) b += n;
  }
  for (int o = 16; o > 0; o >>= 1) {
    b += __shfl_down_sync(0xffffffffu, b, o);
    t += __shfl_down_sync(0xffffffffu, t, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = b;
    red[2 * (threadIdx.x >> 5) + 1] = t;
  }
  __syncthreads();
  b = t = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    b += red[2 * w];
    t += red[2 * w + 1];
  }
  *before = b;
  *total = t;
  __syncthreads();
}

// The small windows' one launch: each tile sums the window's mask itself for
// its left base and nl (the mask is a byte a position and sits in L2),
// then ranks and moves its rows; tile 0 writes nl, also of an empty
// window.
__global__ void __launch_bounds__(kThreads)
lgbt_partition_small(Args a, int stage_words) {
  __shared__ TileSmem sm;
  __shared__ long long red[2 * kThreads / 32];
  extern __shared__ __align__(16) uint32_t stage[];
  const Window win = window(a);
  if (win.cnt > kSmallMax) return;    // the large windows'
  const uint8_t* gl = static_cast<const uint8_t*>(a.goes_left);
  const long long lo = (long long)blockIdx.x * kTile;
  const int n = (int)max(0ll, min((long long)kTile, win.cnt - lo));
  if (n == 0 && blockIdx.x > 0) return;
  long long lbase, nl;
  count_lefts(gl, win.cnt, lo, &lbase, &nl, red);
  const int L = rank_tile(gl, lo, n, sm);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *static_cast<int32_t*>(a.nl_out) = (int32_t)nl;
  move_tile(a, swapped(a), win.start, lo, n, L, lbase, lo - lbase, nl, sm,
            stage, stage_words);
}

// The large windows' write pass: rank the tile, find its left base by
// look-back over the status words, publish its inclusive prefix, move.
__global__ void __launch_bounds__(kThreads)
lgbt_partition_write(Args a, int stage_words) {
  __shared__ TileSmem sm;
  extern __shared__ __align__(16) uint32_t stage[];
  volatile unsigned long long* status =
      static_cast<volatile unsigned long long*>(a.scratch);
  const Window win = window(a);
  if (win.cnt <= kSmallMax) return;   // the small launch's window
  const uint8_t* gl = static_cast<const uint8_t*>(a.goes_left);
  const long long t = blockIdx.x;
  const long long lo = t * kTile;
  if (lo >= win.cnt) return;   // past the window: no later tile reads it
  const int n = (int)min((long long)kTile, win.cnt - lo);
  const int L = rank_tile(gl, lo, n, sm);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long acc = 0;
    for (long long j = t - 1;; j -= 32) {
      const long long idx = j - lane;   // lane 0 nearest
      const unsigned long long s =
          idx >= 0 ? (unsigned long long)status[idx] : kPrefix;
      const unsigned done = __ballot_sync(0xffffffffu, (s & kPrefix) != 0);
      const int stop = done ? __ffs(done) - 1 : 31;
      unsigned long long v = lane <= stop ? (s & kValue) : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      acc += __shfl_sync(0xffffffffu, v, 0);
      if (done) break;
    }
    if (lane == 0) {
      status[t] = kPrefix | (acc + (unsigned long long)L);
      sm.base = (long long)acc;
    }
  }
  __syncthreads();
  const long long lbase = sm.base;
  const long long nl = *static_cast<const volatile int32_t*>(a.nl_out);
  move_tile(a, swapped(a), win.start, lo, n, L, lbase, lo - lbase, nl, sm,
            stage, stage_words);
}

// Staged words a block of `tile` positions uses: every matrix's rows whole
// and its runs' shift room, up to `cap`.
int stage_words(const Args& a, int tile, int cap) {
  long long need = 0;
  for (int j = 0; j < a.n_mats; ++j)
    need += region(tile, (int)((a.width[j] + 3) / 4));
  return need < cap ? (int)need : cap;
}

constexpr int kMaxDevices = 64;
bool g_small_smem[kMaxDevices];
bool g_large_smem[kMaxDevices];

// The dynamic shared memory limit of `kernel` raised above 48 KB, once per
// card.
int allow_smem(const void* kernel, int bytes, int device, bool* done) {
  if (bytes <= 48 * 1024 || done[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageWords * 4);
  if (err == cudaSuccess) done[device] = true;
  return (int)err;
}

int launch_on(const Args& a) {
  const cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  const long long tiles = (a.bound + kTile - 1) / kTile;
  const long long most = a.bound < kSmallMax ? a.bound : kSmallMax;
  const long long small_tiles = (most + kTile - 1) / kTile;
  const int words =
      stage_words(a, (int)(a.bound < kTile ? a.bound : kTile), kStageWords);
  int rc = allow_smem((const void*)lgbt_partition_small, words * 4, a.device,
                      g_small_smem);
  if (rc) return rc;
  rc = allow_smem((const void*)lgbt_partition_write, words * 4, a.device,
                  g_large_smem);
  if (rc) return rc;
  lgbt_partition_small<<<(unsigned)small_tiles, kThreads, words * 4, s>>>(
      a, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lgbt_partition_count<<<(unsigned)tiles, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lgbt_partition_write<<<(unsigned)tiles, kThreads, words * 4, s>>>(a,
                                                                    words);
  return (int)cudaGetLastError();
}

}  // namespace

// Partitions the window (start, cnt) = x->sc (device int64[2], cnt at most
// x->bound) of each of the x->n_mats matrices from src into dst (dst into
// src when x->odd is given and odd) and writes nl to x->nl_out: three
// launches on stream x->stream of card x->device, which is made current
// only if it is not.  The scratch starts zeroed and is left so (its
// ticket) for the next call.  Returns the cudaError_t (0 on success).
extern "C" int lgbt_partition(const Args* x) {
  const Args& a = *x;
  if (a.n_mats < 1 || a.n_mats > kMaxMats || a.bound < 1 ||
      a.device < 0 || a.device >= kMaxDevices ||
      (a.bound + kTile - 1) / kTile > a.scratch_tiles)
    return (int)cudaErrorInvalidValue;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_on(a);
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}
