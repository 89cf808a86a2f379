// Gather-histogram kernel (K1) for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_hist.py:223 hist6_fused (the Pallas
// kernel behind ops/histogram.py:subset_histogram_fused, which stops at
// 256 bins; past them the JAX grower takes subset_histogram_segment, a
// scatter-add, and this kernel reads the uint16 bin matrix): the per-leaf
// histogram of the rows order[start, start + cnt), out[f][b] = (sum g,
// sum h, count) over the rows whose feature f falls in bin b, in full f32.
// It computes the same function, not the same blocks: the TPU kernel
// gathered panel rows by DMA and contracted a nibble one-hot against bf16
// hi/lo weight halves on the MXU; here rows are gathered through `order`
// and added with float atomics.  The core (both regimes, the row source
// interface) is hist_core.cuh, shared with hist_local.cu.
//
// (start, cnt) are read from device memory, so the launch needs no host
// copy of them.  The host passes a bound on cnt (the parent leaf's count)
// from which its launch plan (ops/histogram.py:plan_launch) picks:
//   - the small regime at a bound of at most 32,768 rows, so that a split's
//     smaller child holds at most 16,384: a thread per (row, 4-column
//     group, statistic) with global reductions, the grid spread over the
//     card;
//   - the large regime above it: 4-column groups on blockIdx.y, each a
//     12 KB shared-memory histogram at 255 bins (narrower groups, or one
//     column's bins cut into slices on blockIdx.z, past 1,024 bins), and
//     slices of the window on
//     blockIdx.x, sized so that four blocks are resident on every SM.
//     The true count is spread over all the blocks.
// Inside the serial grower's captured split step the host holds no bound
// but the rows; there the "device" regime launches both kernels, the small
// one over the grid of a 16,384-row window and the large one over the
// rows' grid, and each returns at once unless the window's true count
// falls in its range.  The large kernel spreads the count over all its
// blocks: a cap of one block for every 512 or 1,024 rows of the count
// took 1.2-1.6x the device time on the Expo-shaped task (PERF.md).  The window's buffer (one of two, by the leaf's
// depth parity) is picked in the kernel as well (hist_core.cuh).
//
// Large-window design kept: the feature groups.  Timed in turns against
// a thread block cluster form (each block of a cluster holding a column
// slice of one histogram, adding into the others' slices through
// distributed shared memory) on an H100, the groups took 0.24 ms at the
// 1,000,000-row root, clusters of 2 to 7 blocks 1.3 to 3.0 ms.  A cluster
// reads each row once, but most of its adds land in another block's slice,
// where a float atomicAdd on the mapped address is a compare-and-swap loop
// (ATOM.E.CAST.SPIN in the SASS).  PERF.md holds the timings.
//
// What bounds it on the H100: not the bytes (each row's order entry, bins
// and three weights, each a random 32-byte sector; the kernel reaches
// about 5 % of that bound at the root).  In the large regime it is the
// 3 * F shared-memory float atomics of a row, each a compare-and-swap loop
// (ATOMS.CAST.SPIN); in the small regime the launch, the output's zeroing
// (a second device operation) and the global reductions in L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include "hist_core.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(hist::kThreads)
hist_gather_small(hist::GatherRows rows, hist::Weights a) {
  hist::small_gather<T>(rows, a);
}

template <class T>
__global__ void __launch_bounds__(hist::kThreads)
hist_gather_large(hist::GatherRows rows, hist::Weights a, int group_w) {
  hist::large_groups<T>(rows, a, group_w);
}

}  // namespace

// Zeroes out (n_feat * num_bins * 3 floats) and launches the plan on
// stream x->stream of card x->device (hist_core.cuh: Args), with the
// kernels of x->bin_bytes (1: uint8, 2: uint16) bins.  Returns the
// cudaError_t (0 on success).
extern "C" int lgbt_hist_gather(const hist::Args* x) {
  // the cards on which each large kernel may take more than 48 KB
  static bool done8[hist::kMaxDevices], done16[hist::kMaxDevices];
  const hist::GatherRows rows{(const int32_t*)x->rows_a,
                              (const int32_t*)x->rows_b, 0};
  if (x->bin_bytes == 2)
    return hist::launch(hist_gather_small<uint16_t>,
                        hist_gather_large<uint16_t>, done16, rows, *x);
  return hist::launch(hist_gather_small<uint8_t>, hist_gather_large<uint8_t>,
                      done8, rows, *x);
}
