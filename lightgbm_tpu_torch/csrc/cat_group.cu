// max_cat_group accounting of the categorical split scan, for Hopper
// (sm_90a).
//
// Replaces the sequential lax.scan of lightgbm_tpu/ops/split.py:300
// (_categorical_candidates' group_step; FindBestThresholdCategorical,
// feature_histogram.hpp:142-147,169-177), which XLA runs as a loop on the
// device.  It is not a Pallas kernel: in PyTorch the same loop is some
// ten small operations per candidate position, 255 positions per scan,
// and a grower that scans after every split spent most of its time
// launching them.  Here one thread walks one lane's positions.
//
// A lane is one (leaf, feature, direction) of the scan; along its
// candidate positions t it accumulates the sorted bins' counts, and
// accepts t when ok[t] holds and the count since the last accept reaches
// the current minimum group size; each accept resets the count, spends one
// of max_cat_group groups and, while groups remain, sets the minimum to
// max(1, floor(right_count[t] / groups_left)).  The float32 operations are
// the JAX scan's, in its order, so the accepts are identical.
//
// What bounds it: latency.  The work is a loop-carried chain of a few
// float operations per position over K * F * 2 lanes (32 on the main
// path), far below the card's width; the loads do not depend on the chain
// and run ahead of it.  One launch replaces some 2,500.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
lgbt_cat_group_kernel(const float* __restrict__ step,
                      const uint8_t* __restrict__ ok,
                      const float* __restrict__ right_count,
                      const float* __restrict__ mdpg0,
                      uint8_t* __restrict__ accept, long long lanes,
                      int positions, float max_cat_group) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const long long base = lane * positions;
  float cnt = 0.f;
  float rest = max_cat_group;
  float mdpg = mdpg0[lane];
  for (int t = 0; t < positions; ++t) {
    cnt = cnt + step[base + t];
    const bool acc = ok[base + t] && cnt >= mdpg;
    accept[base + t] = acc;
    if (acc) {
      rest = rest - 1.f;
      if (rest > 0.f)
        mdpg = fmaxf(1.f, floorf(__fdiv_rn(right_count[base + t],
                                           fmaxf(rest, 1.f))));
      cnt = 0.f;
    }
  }
}

}  // namespace

// step, ok, right_count, accept: [lanes, positions] row-major; mdpg0:
// [lanes].  Returns the cudaError_t of the launch (0 on success).
extern "C" int lgbt_cat_group(const void* step, const void* ok,
                              const void* right_count, const void* mdpg0,
                              void* accept, long long lanes, int positions,
                              float max_cat_group, void* stream) {
  if (lanes <= 0 || positions <= 0) return 0;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  lgbt_cat_group_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)step, (const uint8_t*)ok, (const float*)right_count,
      (const float*)mdpg0, (uint8_t*)accept, lanes, positions,
      max_cat_group);
  return (int)cudaGetLastError();
}
