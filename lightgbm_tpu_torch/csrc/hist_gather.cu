// Gather-histogram kernel for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_hist.py:hist6_fused (the Pallas kernel
// behind ops/histogram.py:subset_histogram_fused): the per-leaf histogram
// of the rows order[start, start + cnt), out[f][b] = (sum g, sum h, count)
// over the rows whose feature f falls in bin b.  It computes the same
// function, not the same blocks: the TPU kernel gathered panel rows by DMA
// and contracted a nibble one-hot against bf16 hi/lo weight halves on the
// MXU; here each thread takes one row and adds its weights into a
// shared-memory histogram with float atomics, in full f32.
//
// What bounds it on the H100: the bytes it gathers - for each row of the
// window one 4-byte order entry, F bin bytes and three 4-byte weights,
// each a random 32-byte sector of device memory - and the shared-memory
// atomics, 3 * F per row.  The design keeps everything else off the
// device-memory path: each block owns a contiguous slice of the window
// and accumulates a private [features, bins, 3] histogram in shared
// memory (86 KB at 28 features x 256 bins), zeroes it only if its slice
// holds a row, and flushes only the non-zero entries to the output with
// global atomics, so a small leaf costs few blocks and few global writes.
// Wide data is split into feature groups on blockIdx.y, each group's
// histogram sized to the shared-memory budget.
//
// (start, cnt) are read from device memory, so the launch needs no host
// copy of them: the host passes only an upper bound on cnt that sizes the
// grid, and blocks past the window return at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows each block should own at the host's upper bound of cnt: amortizes
// zeroing and flushing the shared histogram over enough atomics
constexpr long long kRowsPerBlock = 2048;
// at most this many blocks per feature group (2 resident per SM x 132 SMs)
constexpr int kMaxBlocks = 264;
// shared-memory histogram budget per block (H100 allows 227 KB)
constexpr int kSmemBudget = 96 * 1024;

__global__ void __launch_bounds__(kThreads)
hist_gather_kernel(const int32_t* __restrict__ order,
                   const int32_t* __restrict__ sc,
                   const uint8_t* __restrict__ bins,
                   const float* __restrict__ gw,
                   const float* __restrict__ hw,
                   const float* __restrict__ cw,
                   float* __restrict__ out,
                   int n_feat, int num_bins, int feat_per_group) {
  extern __shared__ float sh[];
  const long long start = sc[0];
  const long long cnt = sc[1];
  // contiguous slice of the window per block, a multiple of the block size
  long long chunk = (cnt + gridDim.x - 1) / gridDim.x;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  const long long lo = (long long)blockIdx.x * chunk;
  if (lo >= cnt) return;  // no row of the window: no zeroing, no flush
  const long long hi = min(cnt, lo + chunk);

  const int f0 = blockIdx.y * feat_per_group;
  const int nf = min(feat_per_group, n_feat - f0);
  const int nsh = nf * num_bins * 3;
  for (int i = threadIdx.x; i < nsh; i += kThreads) sh[i] = 0.f;
  __syncthreads();

  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    const long long row = order[start + p];
    const float g = gw[row];
    const float h = hw[row];
    const float c = cw[row];
    const uint8_t* r = bins + row * n_feat + f0;
    for (int f = 0; f < nf; ++f) {
      float* e = sh + (f * num_bins + r[f]) * 3;
      atomicAdd(e, g);
      atomicAdd(e + 1, h);
      atomicAdd(e + 2, c);
    }
  }
  __syncthreads();

  float* o = out + (long long)f0 * num_bins * 3;
  for (int i = threadIdx.x; i < nsh; i += kThreads) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

}  // namespace

// out must hold n_feat * num_bins * 3 zeroed floats.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lgbt_hist_gather(const void* order, const void* sc,
                                const void* bins, const void* gw,
                                const void* hw, const void* cw, void* out,
                                int n_feat, int num_bins,
                                long long rows_upper_bound, void* stream) {
  int fpg = kSmemBudget / (num_bins * 3 * (int)sizeof(float));
  if (fpg > n_feat) fpg = n_feat;
  if (fpg < 1) return (int)cudaErrorInvalidValue;
  const int groups = (n_feat + fpg - 1) / fpg;
  const int smem = fpg * num_bins * 3 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (rows_upper_bound + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dim3 grid((unsigned)blocks, (unsigned)groups);
  hist_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)order, (const int32_t*)sc, (const uint8_t*)bins,
      (const float*)gw, (const float*)hw, (const float*)cw, (float*)out,
      n_feat, num_bins, fpg);
  return (int)cudaGetLastError();
}
