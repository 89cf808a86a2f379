// Shard-local histogram kernel (K3) for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_hist.py:284 hist6_fused_local (behind
// ops/histogram.py:subset_histogram_fused_local): one row shard's PARTIAL
// histogram of a leaf, out[f][b] = (sum g, sum h, count) over the shard's
// rows r with row_leaf[r] == leaf_id and bins[r, f] == b, in full f32.
// The data-parallel learner keeps the leaf membership as a row -> leaf map,
// not as an order window.  The TPU form first compacted the matching rows
// with a cumsum scatter into an order array and then ran the
// gather-histogram kernel over it.  Here there is no compaction pass: this
// is the histogram core of hist_gather.cu (hist_core.cuh) with a row source
// that is a coalesced, masked scan of row_leaf in place of a gather.
//
// leaf_id is read from device memory, so the launch needs no host copy of
// it.  Inside the data-parallel learner's split step the host knows no
// count: the step keeps every leaf's rows in each shard in device memory
// (leaf_rows), and the "device" regime launches both kernels below, each
// gated by the leaf's true count there (the small one up to 65,536 rows,
// the large one above; a leaf of no rows, as after the tree's stop, scans
// nothing).  Otherwise the host passes a bound on the leaf's rows in the
// shard, from which its launch plan picks:
//   - the small regime at a bound of at most 65,536 rows: a thread per
//     local row reads row_leaf, and the warp adds each matching row's
//     columns with global reductions.  A block whose rows hold none of the
//     leaf writes nothing; no block zeroes or flushes a histogram;
//   - the large regime above it: 4-column groups on blockIdx.y, each a
//     12 KB shared-memory histogram at 255 bins (narrower groups, or one
//     column's bins cut into slices on blockIdx.z, past 1,024 bins), and
//     contiguous slices of the shard on
//     blockIdx.x; a block whose slice holds no row of the leaf
//     (__syncthreads_or over its slice of row_leaf) returns before zeroing.
// The large regime keeps the feature groups, not the thread block cluster
// form, for the reason hist_gather.cu gives (0.054 ms against 0.36 to
// 1.07 ms on a 250,000 x 28 shard, all rows, on an H100).
//
// What bounds it on the H100: the bytes it must read are 4 bytes of
// row_leaf for every local row and, for each matching row, its bins and
// three 4-byte weights.  At all rows it reaches about 6 % of that bound,
// held back by the 3 * Fc shared-memory float atomics of a row, each a
// compare-and-swap loop.  At a leaf of about a thousand rows the launch
// and the output's zeroing dominate: the scan of 1 MB of row_leaf is
// 0.3 us of the bound, the kernel takes about 3 us and the zeroing 1 us.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include "hist_core.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(hist::kThreads)
hist_local_small(hist::MaskedRows rows, hist::Weights a) {
  hist::small_scan<T>(rows, a);
}

template <class T>
__global__ void __launch_bounds__(hist::kThreads)
hist_local_large(hist::MaskedRows rows, hist::Weights a, int group_w) {
  hist::large_groups<T>(rows, a, group_w);
}

}  // namespace

// Zeroes out (n_feat * num_bins * 3 floats) and launches the plan on
// stream x->stream of card x->device (hist_core.cuh: Args), over the
// x->n_loc local rows, with the kernels of x->bin_bytes (1: uint8, 2:
// uint16) bins.  Returns the cudaError_t (0 on success).
extern "C" int lgbt_hist_local(const hist::Args* x) {
  // the cards on which each large kernel may take more than 48 KB
  static bool done8[hist::kMaxDevices], done16[hist::kMaxDevices];
  if (x->n_loc < 0) return (int)cudaErrorInvalidValue;
  const hist::MaskedRows rows{(const int32_t*)x->rows_a,
                              (const int32_t*)x->rows_b,
                              (const int32_t*)x->leaf_rows, x->n_loc, 0};
  if (x->bin_bytes == 2)
    return hist::launch(hist_local_small<uint16_t>,
                        hist_local_large<uint16_t>, done16, rows, *x);
  return hist::launch(hist_local_small<uint8_t>, hist_local_large<uint8_t>,
                      done8, rows, *x);
}
