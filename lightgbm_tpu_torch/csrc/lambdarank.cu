// LambdaRank gradients for Hopper (sm_90a): one thread block a query.
//
// Not a TPU kernel: the JAX package computes these gradients as one XLA
// program (lightgbm_tpu/objectives.py:405-463 LambdarankNDCG.get_gradients):
// queries padded to the longest, D, and lax.map over chunks of C queries
// (C * D^2 <= 16e6), each chunk a dense [C, D, D] pair matrix.  Eagerly,
// on an MS-LTR-shaped set (D = 1,251), that is some 1,900 chunks of about
// 35 PyTorch ops a round.  Here one launch computes every query, with the
// same arithmetic, for each query q (rows bounds[q] .. bounds[q + 1]):
//   1. rank the documents by descending score, ties in their original
//      order (the stable argsort of -s at :413): rank_i = #{j: s_j > s_i}
//      + #{j < i: s_j == s_i}, counted in O(n^2) like the pair loop;
//   2. the query is degenerate when its best score equals its worst
//      (:419-423);
//   3. for each pair with label_a > label_b (labels as int32):
//        ds    = s_a - s_b
//        delta = (gain_a - gain_b) * |disc[rank_a] - disc[rank_b]| * inv
//        delta /= (0.01 + |ds|)          unless the query is degenerate
//        p     = 2 / (1 + exp(2 sigma ds))
//        lam   = -delta * p,  hes = p (2 - p) * 2 * delta     (:425-436);
//   4. g_i = sum of lam over the pairs where i is the higher-labelled
//      document minus the sum over those where it is the lower; h_i sums
//      hes over both (:437-438);
//   5. both times the row's weight, when there are weights (:460-462).
// gain = label_gain[label], disc = 1 / log2(rank + 2) and inv = 1 / (the
// query's max DCG at max_position) come from the host as float32 tables,
// built once as the JAX objective's init builds them (:365-403).
//
// Each thread owns documents i and walks every j, so each pair is
// computed twice (once for each of its documents) and nothing is summed
// across threads: no atomics, the same sums in the same order every run.
// A query of at most kStageMax documents is staged in shared memory
// (score, label, rank, gain and discount: 20 B a document, 40 KB); a
// longer one reads its scores and labels from global memory and keeps its
// ranks in a global scratch of int32 [rows], so every length runs.
// What bounds it on the H100: operations.  Each pair takes an exp and two
// reciprocals (1 / (0.01 + |ds|), 2 / (1 + e)) on the special-function
// units, 16 a clock an SM; the bytes (score, label, weight, g and h, each
// row once) are a few MB.  A simple kernel that is right: a thread a
// document leaves threads idle in the many short queries, and the long
// ones take the time of their O(n^2) loop on one SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageMax = 2048;   // ops/lambdarank.py STAGE_MAX

}  // namespace

// The argument block of lgbt_lambdarank, packed by the Python wrapper
// (ops/lambdarank.py:_ARGS, struct format "@10P2ifiP").
struct Args {
  const float* score;        // f32 [rows]
  const int32_t* label;      // int32 [rows]
  const int32_t* bounds;     // int32 [queries + 1]
  const float* inv_max_dcg;  // f32 [queries]
  const float* gains;        // f32 [num_gains]
  const float* discount;     // f32 [>= the longest query]
  const float* weight;       // f32 [rows], or null
  int32_t* rank_scratch;     // int32 [rows], or null: no query is longer
                             // than kStageMax
  float* grad;               // f32 [rows]
  float* hess;               // f32 [rows]
  int num_queries;
  int num_gains;
  float two_sigma;           // 2 * sigmoid
  int device;
  const void* stream;
};

namespace {

__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : fminf(v, w);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w)
    r = is_max ? fmaxf(r, red[w]) : fminf(r, red[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
    lgbt_lambdarank_kernel(const Args a) {
  __shared__ float s_sh[kStageMax];
  __shared__ int32_t y_sh[kStageMax];
  __shared__ int32_t r_sh[kStageMax];
  __shared__ float gain_sh[kStageMax];
  __shared__ float disc_sh[kStageMax];
  __shared__ float red[kThreads / 32];

  const int q = blockIdx.x;
  const int b = a.bounds[q];
  const int n = a.bounds[q + 1] - b;
  if (n <= 0) return;
  const bool staged = n <= kStageMax;
  const int top = a.num_gains - 1;
  if (staged) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_sh[i] = a.score[b + i];
      y_sh[i] = a.label[b + i];
    }
    __syncthreads();
  }
  const float* S = staged ? s_sh : a.score + b;
  const int32_t* Y = staged ? y_sh : a.label + b;
  int32_t* R = staged ? r_sh : a.rank_scratch + b;

  // best and worst score: the degenerate test
  float mx = -INFINITY, mn = INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    mx = fmaxf(mx, S[i]);
    mn = fminf(mn, S[i]);
  }
  mx = block_reduce(mx, true, red);
  mn = block_reduce(mn, false, red);
  const bool nondegen = mx != mn;

  // 1. ranks: a stable descending order
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float si = S[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const float sj = S[j];
      r += (sj > si) || (sj == si && j < i);
    }
    R[i] = r;
  }
  __syncthreads();
  if (staged) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      gain_sh[i] = a.gains[min(max(y_sh[i], 0), top)];
      disc_sh[i] = a.discount[r_sh[i]];
    }
    __syncthreads();
  }

  // 3-5. every pair of each of the thread's documents
  const float inv = a.inv_max_dcg[q];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float si = S[i];
    const int yi = Y[i];
    const float gi = staged ? gain_sh[i] : a.gains[min(max(yi, 0), top)];
    const float di = staged ? disc_sh[i] : a.discount[R[i]];
    float g = 0.f, h = 0.f;
    for (int j = 0; j < n; ++j) {
      const int yj = Y[j];
      if (yj == yi) continue;
      const float sj = S[j];
      const float gj = staged ? gain_sh[j] : a.gains[min(max(yj, 0), top)];
      const float dj = staged ? disc_sh[j] : a.discount[R[j]];
      const bool high = yi > yj;     // i is the pair's higher label
      const float ds = high ? si - sj : sj - si;
      float delta = (high ? gi - gj : gj - gi) *
                    fabsf(high ? di - dj : dj - di) * inv;
      if (nondegen) delta = delta / (0.01f + fabsf(ds));
      const float p = 2.0f / (1.0f + expf(a.two_sigma * ds));
      const float lam = -delta * p;
      const float hes = p * (2.0f - p) * 2.0f * delta;
      g += high ? lam : -lam;
      h += hes;
    }
    if (a.weight != nullptr) {
      const float w = a.weight[b + i];
      g *= w;
      h *= w;
    }
    a.grad[b + i] = g;
    a.hess[b + i] = h;
  }
}

}  // namespace

// The gradients and hessians of every query: one launch of num_queries
// blocks on stream x->stream of card x->device, made current only if it is
// not.  Returns the cudaError_t (0 on success).
extern "C" int lgbt_lambdarank(const Args* x) {
  const Args& a = *x;
  if (a.num_queries < 0 || a.num_gains < 1)
    return (int)cudaErrorInvalidValue;
  if (a.num_queries == 0) return 0;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  lgbt_lambdarank_kernel<<<a.num_queries, kThreads, 0,
                           (cudaStream_t)a.stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}
