// Stable window-partition kernel for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_compact.py:compact_pallas (the Pallas
// kernel behind compact_window): the grower's split step, which stably
// partitions a leaf's window order[start, start + cnt) by a goes_left mask
// - lefts first, both sides in their original order - and moves zero or
// more payload matrices (row-major [N, width] bytes, rows indexed like
// order) the same way, and returns the left count nl.  It computes the
// same function, not the same blocks: the TPU kernel applied one-hot
// permutation matmuls on the MXU to f32-encoded 512-row blocks (u16
// payload halves, 128-lane padded output); here each thread computes the
// stable rank of its positions directly and moves their rows.
//
// What bounds it on the H100: bytes.  Per window position it must read
// the order entry (4 B) and the mask (1 B), write the order entry (4 B),
// and read and write each payload row (2 x width B); there is no
// arithmetic to speak of.  The design keeps the passes few and their
// reads sequential:
//   1. count: each block owns a tile of kTile consecutive positions and
//      counts its lefts with __syncthreads_count;
//   2. scan: one block turns the tile counts into each tile's left base
//      (exclusive scan) and writes nl; a tile's right base follows as
//      nl + tile * kTile - left base;
//   3. write: each block recomputes the stable rank of every position of
//      its tile (warp ballot prefix + a shared scan of the warp counts,
//      iteration by iteration in position order) and writes the order
//      entry and payload rows to their ranks in a scratch buffer;
//   4. copy back: the scratch replaces the window.
// The scratch pass is what makes the in-place partition safe: no block
// ever reads a position of the window that another block writes.  The
// row writes of pass 3 scatter (the ranks of a tile spread over two
// runs), the rest is sequential.
//
// (start, cnt) are read from a device int32[2], as hist_gather reads
// them; the host passes only an upper bound on cnt that sizes the grid
// and the scratch layout.  Offsets are 64-bit throughout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // positions per thread
constexpr long long kTile = kThreads * kItems;  // positions per block
constexpr int kScanThreads = 1024;
constexpr int kMaxPayload = 8;
constexpr long long kAlign = 256;

struct Payload {
  uint8_t* data[kMaxPayload];   // row-major [N, width] bytes
  uint8_t* tmp[kMaxPayload];    // scratch rows, [cap, width] bytes
  long long width[kMaxPayload];
  int words[kMaxPayload];       // 1: rows move as 4-byte words
  int n;
};

__device__ __forceinline__ long long window_cnt(const int32_t* sc,
                                                long long cap) {
  const long long cnt = sc[1];
  return cnt < cap ? cnt : cap;  // never past the scratch the host sized
}

__global__ void __launch_bounds__(kThreads)
lgbt_partition_count(const int32_t* __restrict__ sc,
                     const uint8_t* __restrict__ goes_left,
                     int32_t* __restrict__ tile_lefts, long long cap) {
  const long long cnt = window_cnt(sc, cap);
  const long long lo = (long long)blockIdx.x * kTile;
  if (lo >= cnt) return;  // whole block: the barrier count stays uniform
  int total = 0;
  for (int it = 0; it < kItems; ++it) {
    const long long p = lo + it * kThreads + threadIdx.x;
    const int flag = (p < cnt) && goes_left[p];
    total += __syncthreads_count(flag);
  }
  if (threadIdx.x == 0) tile_lefts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
lgbt_partition_scan(const int32_t* __restrict__ sc,
                    const int32_t* __restrict__ tile_lefts,
                    long long* __restrict__ tile_base,
                    int32_t* __restrict__ nl_out, long long cap) {
  __shared__ long long warp_sum[kScanThreads / 32];
  const long long cnt = window_cnt(sc, cap);
  const long long tiles = (cnt + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const long long t = t0 + threadIdx.x;
    const long long v = t < tiles ? tile_lefts[t] : 0;
    long long x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long s = warp_sum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    const long long incl = x + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (t < tiles) tile_base[t] = carry + incl - v;
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
  if (threadIdx.x == 0) nl_out[0] = (int32_t)carry;
}

__device__ __forceinline__ void copy_row(const uint8_t* src, uint8_t* dst,
                                         long long width, int words) {
  if (words) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (long long i = 0; i < width / 4; ++i) d[i] = s[i];
  } else {
    for (long long i = 0; i < width; ++i) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
lgbt_partition_write(const int32_t* __restrict__ sc,
                     const uint8_t* __restrict__ goes_left,
                     const int32_t* __restrict__ order,
                     const long long* __restrict__ tile_base,
                     const int32_t* __restrict__ nl_in,
                     int32_t* __restrict__ tmp_order, Payload pay,
                     long long cap) {
  __shared__ int warp_lefts[kWarps];
  const long long start = sc[0];
  const long long cnt = window_cnt(sc, cap);
  const long long lo = (long long)blockIdx.x * kTile;
  if (lo >= cnt) return;
  const long long lbase = tile_base[blockIdx.x];
  const long long rbase = (long long)nl_in[0] + lo - lbase;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long run = 0;  // lefts of this tile before the current iteration
  for (int it = 0; it < kItems; ++it) {
    const long long q = (long long)it * kThreads + threadIdx.x;
    const long long p = lo + q;
    const bool valid = p < cnt;
    const bool left = valid && goes_left[p];
    const unsigned ballot = __ballot_sync(0xffffffffu, left);
    if (lane == 0) warp_lefts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_lefts[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (valid) {
      const long long lefts_before =
          run + before + __popc(ballot & ((1u << lane) - 1u));
      const long long dst = left ? lbase + lefts_before
                                 : rbase + (q - lefts_before);
      const long long row = start + p;
      tmp_order[dst] = order[row];
      for (int j = 0; j < pay.n; ++j) {
        const long long w = pay.width[j];
        copy_row(pay.data[j] + row * w, pay.tmp[j] + dst * w, w,
                 pay.words[j]);
      }
    }
    run += total;
    __syncthreads();  // warp_lefts is rewritten by the next iteration
  }
}

// blockIdx.y: 0 copies the order window, j + 1 payload j
__global__ void __launch_bounds__(kThreads)
lgbt_partition_copy(const int32_t* __restrict__ sc, int32_t* order,
                    const int32_t* __restrict__ tmp_order, Payload pay,
                    long long cap) {
  const long long start = sc[0];
  const long long cnt = window_cnt(sc, cap);
  const int seg = blockIdx.y;
  const long long step = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (seg == 0) {
    for (long long i = i0; i < cnt; i += step) order[start + i] = tmp_order[i];
    return;
  }
  const int j = seg - 1;
  const long long w = pay.width[j];
  if (pay.words[j]) {
    const long long n = cnt * (w / 4);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(pay.tmp[j]);
    uint32_t* d = reinterpret_cast<uint32_t*>(pay.data[j] + start * w);
    for (long long i = i0; i < n; i += step) d[i] = s[i];
  } else {
    const long long n = cnt * w;
    uint8_t* d = pay.data[j] + start * w;
    for (long long i = i0; i < n; i += step) d[i] = pay.tmp[j][i];
  }
}

long long align_up(long long v) { return (v + kAlign - 1) / kAlign * kAlign; }

// scratch layout for a grid sized at `cap` window positions: tile counts,
// tile bases, the order window, then each payload's rows
struct Layout {
  long long tiles, counts, bases, order, payload[kMaxPayload], total;
};

Layout layout(long long cap, int n_payload, const long long* widths) {
  Layout l;
  l.tiles = cap > 0 ? (cap + kTile - 1) / kTile : 1;
  long long off = 0;
  l.counts = off;
  off += align_up(l.tiles * 4);
  l.bases = off;
  off += align_up(l.tiles * 8);
  l.order = off;
  off += align_up((cap > 0 ? cap : 1) * 4);
  for (int j = 0; j < n_payload; ++j) {
    l.payload[j] = off;
    off += align_up((cap > 0 ? cap : 1) * widths[j]);
  }
  l.total = off;
  return l;
}

}  // namespace

extern "C" long long lgbt_partition_scratch_bytes(long long cap,
                                                  int n_payload,
                                                  const long long* widths) {
  if (n_payload < 0 || n_payload > kMaxPayload) return -1;
  return layout(cap, n_payload, widths).total;
}

// Partitions order[start, start + cnt) in place, (start, cnt) = sc[0..1]
// on the device, cnt <= cap; payload j is a row-major [N, widths[j]]-byte
// matrix whose rows follow order.  scratch must hold
// lgbt_partition_scratch_bytes(cap, ...) bytes; nl_out receives the left
// count.  Four launches on `stream`; returns the first cudaError_t (0 on
// success).
extern "C" int lgbt_partition(void* order, const void* sc,
                              const void* goes_left, int n_payload,
                              void* const* payload, const long long* widths,
                              void* scratch, void* nl_out, long long cap,
                              void* stream) {
  if (n_payload < 0 || n_payload > kMaxPayload || cap < 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(cap, n_payload, widths);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  int32_t* tile_lefts = reinterpret_cast<int32_t*>(base + l.counts);
  long long* tile_base = reinterpret_cast<long long*>(base + l.bases);
  int32_t* tmp_order = reinterpret_cast<int32_t*>(base + l.order);
  Payload pay;
  pay.n = n_payload;
  for (int j = 0; j < n_payload; ++j) {
    pay.data[j] = static_cast<uint8_t*>(payload[j]);
    pay.tmp[j] = base + l.payload[j];
    pay.width[j] = widths[j];
    pay.words[j] = widths[j] % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(payload[j]) % 4 == 0;
  }
  for (int j = n_payload; j < kMaxPayload; ++j) {
    pay.data[j] = pay.tmp[j] = nullptr;
    pay.width[j] = 0;
    pay.words[j] = 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sc32 = static_cast<const int32_t*>(sc);
  const uint8_t* gl = static_cast<const uint8_t*>(goes_left);
  int32_t* nl = static_cast<int32_t*>(nl_out);
  const unsigned tiles = (unsigned)l.tiles;

  lgbt_partition_count<<<tiles, kThreads, 0, s>>>(sc32, gl, tile_lefts, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lgbt_partition_scan<<<1, kScanThreads, 0, s>>>(sc32, tile_lefts, tile_base,
                                                 nl, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lgbt_partition_write<<<tiles, kThreads, 0, s>>>(
      sc32, gl, static_cast<const int32_t*>(order), tile_base, nl, tmp_order,
      pay, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // about four resident blocks per SM for each segment, grid-stride beyond
  long long blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > 528) blocks = 528;
  if (blocks < 1) blocks = 1;
  lgbt_partition_copy<<<dim3((unsigned)blocks, 1 + n_payload), kThreads, 0,
                        s>>>(sc32, static_cast<int32_t*>(order), tmp_order,
                             pay, cap);
  return (int)cudaGetLastError();
}
