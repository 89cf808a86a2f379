// Shard-local histogram kernel for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_hist.py:hist6_fused_local (behind
// ops/histogram.py:subset_histogram_fused_local): one row shard's PARTIAL
// histogram of a leaf, out[f][b] = (sum g, sum h, count) over the shard's
// rows r with row_leaf[r] == leaf_id and bins[r, f] == b, in full f32.
// The data-parallel learner keeps the leaf membership as a row -> leaf map,
// not as an order window.  The TPU form first compacted the matching rows
// with a cumsum scatter into an order array (padded for an aligned
// over-fetch) and then ran the gather-histogram kernel over it.  Here there
// is no compaction pass: this is a predicate-masked variant of
// hist_gather.cu.  Threads stride over contiguous local rows, read row_leaf
// coalesced, and a matching row adds its weights into a per-block
// shared-memory [features, bins, 3] histogram with float atomics.
//
// What bounds it on the H100: the bytes it reads - 4 bytes of row_leaf for
// every local row, and for each matching row its Fc bin bytes and three
// 4-byte weights - and the shared-memory atomics, 3 * Fc per matching row.
// The design keeps the rest off the device-memory path: a block first asks
// whether its contiguous slice holds any matching row (__syncthreads_or
// over a pass of row_leaf), and only then zeroes its shared histogram, adds
// and flushes the non-zero entries to the output with global atomics.  So
// a block whose slice holds no row of the leaf costs one read of its slice
// of row_leaf.  Wide slices are split into feature groups on blockIdx.y,
// each sized to the shared-memory budget.
//
// leaf_id is read from device memory, so the launch needs no host copy of
// it; the grid is sized from n_loc, which the host knows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows each block owns: amortizes zeroing and flushing the shared
// histogram over enough rows
constexpr long long kRowsPerBlock = 2048;
// at most this many blocks per feature group (2 resident per SM x 132 SMs)
constexpr int kMaxBlocks = 264;
// shared-memory histogram budget per block (H100 allows 227 KB)
constexpr int kSmemBudget = 96 * 1024;

__global__ void __launch_bounds__(kThreads)
hist_local_kernel(const int32_t* __restrict__ row_leaf,
                  const int32_t* __restrict__ leaf_id,
                  const uint8_t* __restrict__ bins,
                  const float* __restrict__ gw,
                  const float* __restrict__ hw,
                  const float* __restrict__ cw,
                  float* __restrict__ out,
                  long long n_loc, long long chunk, int n_feat,
                  int num_bins, int feat_per_group) {
  extern __shared__ float sh[];
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(n_loc, lo + chunk);
  const int32_t leaf = *leaf_id;

  // does this block's slice hold a row of the leaf?
  int any = 0;
  for (long long p = lo + threadIdx.x; p < hi && !any; p += kThreads)
    any = row_leaf[p] == leaf;
  if (!__syncthreads_or(any)) return;  // no zeroing, no flush

  const int f0 = blockIdx.y * feat_per_group;
  const int nf = min(feat_per_group, n_feat - f0);
  const int nsh = nf * num_bins * 3;
  for (int i = threadIdx.x; i < nsh; i += kThreads) sh[i] = 0.f;
  __syncthreads();

  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    if (row_leaf[p] != leaf) continue;
    const float g = gw[p];
    const float h = hw[p];
    const float c = cw[p];
    const uint8_t* r = bins + p * n_feat + f0;
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
extern "C" int lgbt_hist_local(const void* row_leaf, const void* leaf_id,
                               const void* bins, const void* gw,
                               const void* hw, const void* cw, void* out,
                               long long n_loc, int n_feat, int num_bins,
                               void* stream) {
  int fpg = kSmemBudget / (num_bins * 3 * (int)sizeof(float));
  if (fpg > n_feat) fpg = n_feat;
  if (fpg < 1 || n_loc < 0) return (int)cudaErrorInvalidValue;
  const int groups = (n_feat + fpg - 1) / fpg;
  const int smem = fpg * num_bins * 3 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_loc + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // contiguous slice per block, a multiple of the block size
  long long chunk = (n_loc + blocks - 1) / blocks;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  dim3 grid((unsigned)blocks, (unsigned)groups);
  hist_local_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)row_leaf, (const int32_t*)leaf_id,
      (const uint8_t*)bins, (const float*)gw, (const float*)hw,
      (const float*)cw, (float*)out, n_loc, chunk, n_feat, num_bins, fpg);
  return (int)cudaGetLastError();
}
