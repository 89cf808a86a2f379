// max_cat_group accounting of the categorical split scan, for Hopper
// (sm_90a).
//
// Replaces the sequential lax.scan of lightgbm_tpu/ops/split.py:300
// (_categorical_candidates' group_step; FindBestThresholdCategorical,
// feature_histogram.hpp:142-147,169-177), which XLA runs as a loop on the
// device.  It is not a Pallas kernel: in PyTorch the same loop is some
// ten small operations per candidate position, 255 positions per scan,
// and a grower that scans after every split spent most of its time
// launching them.
//
// A lane is one (leaf, feature, direction) of the scan; along its
// candidate positions t it accumulates the sorted bins' counts, and
// accepts t when ok[t] holds and the count since the last accept reaches
// the current minimum group size; each accept resets the count, spends one
// of max_cat_group groups and, while groups remain, sets the minimum to
// max(1, floor(right_count[t] / groups_left)).  The float32 operations are
// the JAX scan's, in its order (__fadd_rn, __fdiv_rn, floorf, fmaxf), so
// the accepts are identical.
//
// What bounds it: latency, not bytes.  The work is a loop-carried chain of
// a few float operations per position over K * F * 2 lanes (32 on the main
// path), far below the card's width.  The design keeps global memory off
// that chain: one lane a warp (the lanes' chains never diverge within a
// warp; on the Expo-shaped path a lane accepts about every fourth
// position, so lanes that shared a warp would each wait for all the
// others' accepts), its inputs loaded once, coalesced and all in flight
// together, before the walk: the warp copies its lane's row into shared
// memory (cp.async for step and right_count, ok as a float gate: 0 where
// ok, -inf where not) and its first thread walks it position by position,
// four 16-byte loads a window of eight positions.  Timed in turns on an
// H100 (PERF.md), three other walks were no faster on the Expo-shaped
// path's lanes, which accept about every fourth position, and were
// deleted: 32 threads walking a lane from registers (steps broadcast by
// shuffles), a windowed walk (a window's eight counts and tests without a
// branch, one branch a window, the window taken again after each accept),
// and this walk with its next window and right counts loaded a window
// ahead.
// A lane holds T = min(max_cat_threshold, B) positions, past 256 only with
// a uint16 bin matrix.  It is staged and walked a chunk of kChunk
// positions at a time, the walk's state (count, groups left, minimum)
// carried in the walking thread's registers from one chunk to the next:
// the same accepts for any T, in at most 48 KB of shared memory.
// ok and accept are 1-byte 0/1 (torch.bool) as the caller holds them; the
// minimum group size mdpg0 may be given per run of `group` lanes (per leaf).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The argument block of the C entry point, packed by the Python wrapper
// (ops/split.py:_GROUP_ARGS, struct format "@5Pq3ifiP").
struct Args {
  const void* step;         // [lanes, T] f32
  const void* ok;           // [lanes, T] bool
  const void* right_count;  // [lanes, T] f32
  const void* mdpg0;        // [lanes / group] f32
  void* accept;             // [lanes, T] bool
  long long lanes;
  int positions;            // T
  int group;                // lanes sharing one mdpg0 entry
  int device;
  float max_cat_group;
  int pad_;
  void* stream;
};

namespace {

constexpr int kLanes = 2;              // lanes (warps) a block
constexpr int kWin = 8;                // positions a window
constexpr int kChunk = 1792;           // positions staged at once: the
                                       // most that 48 KB holds for 2 lanes

// Positions a lane's row holds in shared memory: T rounded up to whole
// windows, so that a window's loads are 16-byte aligned.
__host__ __device__ __forceinline__ int padded(int T) {
  return (T + kWin - 1) / kWin * kWin;
}

__device__ __forceinline__ void copy_async4(void* sm, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(sm)),
               "l"(g)
               : "memory");
}

// The accept of position t: it spends a group and, while groups remain,
// sets the minimum group size from t's right count.
__device__ __forceinline__ void accept_at(float r, float& rest,
                                          float& mdpg) {
  rest = __fsub_rn(rest, 1.f);
  if (rest > 0.f) mdpg = fmaxf(1.f, floorf(__fdiv_rn(r, fmaxf(rest, 1.f))));
}

__global__ void __launch_bounds__(32 * kLanes)
lgbt_cat_group_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int T = a.positions;
  const int TP = padded(T < kChunk ? T : kChunk);   // positions a chunk
  const int w = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const long long lane = (long long)blockIdx.x * kLanes + w;
  if (lane >= a.lanes) return;
  // the warp's chunk, padded to TP positions: step, gate, right_count
  // (f32) and its accepts (u8)
  float* st = reinterpret_cast<float*>(smem) + w * 3 * TP;
  float* gate = st + TP;
  float* rc = gate + TP;
  uint8_t* out = reinterpret_cast<uint8_t*>(smem) +
                 kLanes * 3 * TP * 4 + w * TP;
  const long long off = lane * T;
  // the walk's state, in the walking thread (l == 0)
  float cnt = 0.f;
  float rest = a.max_cat_group;
  float mdpg = static_cast<const float*>(a.mdpg0)[lane / a.group];
  for (int c0 = 0; c0 < T; c0 += TP) {
    const int n = min(TP, T - c0);     // real positions of the chunk
    const float* gs = static_cast<const float*>(a.step) + off + c0;
    const float* gr = static_cast<const float*>(a.right_count) + off + c0;
    const uint8_t* gok = static_cast<const uint8_t*>(a.ok) + off + c0;
    // the gate is added to the count for the accept test only: 0 keeps
    // the count (exactly), -inf fails the test.  Padding positions have
    // step 0 and gate -inf.
#pragma unroll 8
    for (int t = l; t < TP; t += 32) {
      if (t < n) {
        copy_async4(st + t, gs + t);
        copy_async4(rc + t, gr + t);
        gate[t] = __ldg(gok + t) ? 0.f : -INFINITY;
      } else {
        st[t] = 0.f;
        gate[t] = -INFINITY;
      }
      out[t] = 0;   // no accepts
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if (l == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(st);
      const float4* g4 = reinterpret_cast<const float4*>(gate);
      for (int t0 = 0; t0 < TP; t0 += kWin) {
        // a window's steps and gates in four 16-byte loads
        const float4 sa = s4[t0 / 4], sb = s4[t0 / 4 + 1];
        const float4 ga = g4[t0 / 4], gb = g4[t0 / 4 + 1];
        const float sv[kWin] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z,
                                sb.w};
        const float gv[kWin] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z,
                                gb.w};
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          cnt = __fadd_rn(cnt, sv[j]);
          if (__fadd_rn(cnt, gv[j]) >= mdpg) {
            out[t0 + j] = 1;
            accept_at(rc[t0 + j], rest, mdpg);
            cnt = 0.f;
          }
        }
      }
    }
    __syncwarp();
    uint8_t* acc = static_cast<uint8_t*>(a.accept) + off + c0;
    for (int t = l; t < n; t += 32) acc[t] = out[t];
    __syncwarp();   // the chunk's rows are read before the next is staged
  }
}

// The kernel's shared memory: each warp's three padded float rows and
// its accepts, for a chunk of at most kChunk positions.
int smem_bytes(int positions) {
  return kLanes * padded(positions < kChunk ? positions : kChunk) *
         (3 * 4 + 1);
}

}  // namespace

// Walks every lane of x->step / x->ok / x->right_count ([lanes, positions]
// row-major) into x->accept, on stream x->stream of card x->device, which
// is made current only if it is not.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int lgbt_cat_group(const Args* x) {
  const Args& a = *x;
  if (a.lanes <= 0 || a.positions <= 0) return 0;
  if (a.group < 1 || a.lanes % a.group != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(a.positions);
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)a.stream;
  const long long blocks = (a.lanes + kLanes - 1) / kLanes;
  lgbt_cat_group_kernel<<<(unsigned)blocks, 32 * kLanes, smem, s>>>(a);
  int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) rc = (int)err;
  }
  return rc;
}
