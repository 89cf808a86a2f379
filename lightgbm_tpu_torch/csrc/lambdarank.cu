// LambdaRank gradients for Hopper (sm_90a): each unordered pair of
// unequal labels computed once, over label-grouped queries, on a schedule
// of work items built once a Dataset (ops/lambdarank.py
// lambdarank_schedule).
//
// Not a TPU kernel: the JAX package computes these gradients as one XLA
// program (lightgbm_tpu/objectives.py:405-463 LambdarankNDCG.get_gradients):
// queries padded to the longest and a dense [C, D, D] pair matrix a chunk.
// The arithmetic, for each query (rows bounds[q] .. bounds[q + 1]):
//   1. rank the documents by descending score, ties in their original
//      order (the stable argsort of -s at :413);
//   2. the query is degenerate when its best score equals its worst;
//   3. for each pair with label_a > label_b:
//        ds    = s_a - s_b
//        delta = (gain_a - gain_b) * |disc[rank_a] - disc[rank_b]| * inv
//        delta /= (0.01 + |ds|)          unless the query is degenerate
//        p     = 2 / (1 + exp(2 sigma ds))
//        lam   = -delta * p,  hes = p (2 - p) * 2 * delta     (:425-436);
//   4. g_i = sum of lam over the pairs where i is the higher-labelled
//      document minus the sum over those where it is the lower; h_i sums
//      hes over both; 5. both times the row's weight, when there are any.
// gain = label_gain[label], disc = 1 / log2(rank + 2) and inv = 1 / (the
// query's max DCG) are the host's float32 tables.
//
// Design.
// * Label groups.  The schedule orders each query's documents by label,
//   highest first (perm: grouped slot -> row; dgain: the slot's gain).
//   Then a document of label group b pairs with exactly the documents
//   before its group, [0, start_b): the pairs of unequal labels are the
//   rectangles group b x [0, start_b), each pair once, and no equal-label
//   pair is visited.
// * Warp tiles.  A rectangle is cut into tiles of 32 low documents (one a
//   lane, in registers) by 32 high documents (staged in the warp's 512 B of
//   shared memory).  At step k lane l takes staged document l ^ k, so the
//   32 steps visit all 32 x 32 pairs with no bank conflict; each high
//   document's two sums travel with it by __shfl_xor, on four chains (step
//   k on chain k & 3), and are back on lane l after the 32nd step.  A
//   ragged edge is padded with documents whose score is +-1e30: p is then
//   below 2^-125 and both contributions round to exactly 0, so the tile
//   has no branch on labels.  A query of at most 32 documents takes one
//   masked 32 x 32 tile (y_high > y_low selects the pair).
// * The pair itself: ex2.approx (as __expf) and rcp.approx for the two
//   reciprocals, three MUFU results; q = 1 / (1 + e) gets one Newton step,
//   so that 1 - q, where q is near 1, rounds as the plain version's 2 - p
//   does.  inv, -2 and 8 (p = 2q, lam = -2 delta q, hes = 8 delta q (1 -
//   q)) factor out of the sums and are applied once a document.  A
//   degenerate query's delta is divided by 0.01 like any tied pair's and
//   multiplied back by 0.01 with inv.
// * Ranks: a bitonic sort of the keys (descending score bits, original
//   position, slot) in registers: a warp's query R keys a lane, a block
//   item two a thread with its strides of 64 and more through shared
//   memory.  An item that holds every document of its query reads the
//   rank off the sorted position; a part of a long query streams the
//   query's scores once and counts, for each of its documents, the keys
//   before it (a binary search into its sorted keys, an integer
//   histogram).
// * Work items (one a block, heaviest first): a bundle of 8 queries of at
//   most kWarpDocs documents, one a warp in its own kWarpBytes of shared
//   memory; a whole query of at most kItemDocs documents; a longer
//   query's prefix of whole label groups within kItemDocs, and tiles of
//   kTile x kTile pairs of each later group's rectangle.  A block item
//   takes 80 B of shared memory a document (score, discount, gain, each
//   warp's sums) and 4 KB of stages; the launch's dynamic shared memory
//   is the larger of its largest block item's and a bundle's 52 KB.  64
//   registers a thread leave four blocks an SM.
// * Fixed-order sums, no float atomics.  A warp's query is summed by its
//   warp alone.  In a block item every warp adds its tiles into its own
//   row of sums in a fixed order, and the rows are added in warp order.
//   A long query's items write their sums to a scratch buffer; the last of
//   them to finish (an integer ticket) adds each document's partial sums
//   in the schedule's order and writes g and h.  The same inputs give the
//   same bits every run.
// What bounds it on the H100: operations.  Each pair takes an exp and two
// reciprocals on the special-function units, 16 a clock an SM, and 17
// float32 operations; the bytes (score, label, weight, g, h and the
// schedule's slot tables, each row once) are a few MB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lightgbm_tpu_torch/ops/build.py does this).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaskedDocs = 32;    // ops/lambdarank.py MASKED_MAX
constexpr int kWarpDocs = 256;     // ops/lambdarank.py WARP_QUERY_MAX
// a warp's query: its stage, its documents, their sums
constexpr int kWarpBytes = 16 * 32 + 16 * kWarpDocs + 8 * kWarpDocs;
constexpr int kItemDocs = 512;     // ops/lambdarank.py ITEM_DOCS
constexpr int kSlotBits = 9;       // log2(kItemDocs): the key's slot field
constexpr int kTile = 256;         // ops/lambdarank.py TILE
constexpr float kPad = 1e30f;      // a padding document's score
constexpr unsigned kFull = 0xffffffffu;

// work item kinds (ops/lambdarank.py: the items table's first column)
enum Kind { kWarpBundle = 0, kWhole = 1, kPrefix = 2, kPairTile = 3 };

}  // namespace

// The argument block of lgbt_lambdarank, packed by the Python wrapper
// (ops/lambdarank.py:_ARGS, struct format "@18P2ifiP").
struct Args {
  const float* score;         // f32 [rows]
  const int32_t* label;       // int32 [rows]
  const int32_t* bounds;      // int32 [queries + 1]
  const float* inv_max_dcg;   // f32 [queries]
  const float* discount;      // f32 [>= the longest query]
  const float* weight;        // f32 [rows], or null
  const int32_t* perm;        // int32 [rows]: grouped slot -> row
  const float* dgain;         // f32 [rows]: the grouped slot's gain
  const int32_t* items;       // int32 [items, 8]: kind, query, a0, a1, c0,
                              // c1, ordinal, cost
  const int32_t* warp_q;      // int32: the bundles' queries
  const int32_t* qgroup;      // int32 [queries + 1]: offsets into gstarts
  const int32_t* gstarts;     // int32: each query's group starts, then n
  const int32_t* qsplit;      // int32 [queries]: split index or -1
  const int32_t* split_info;  // int32 [splits, 4]: scratch offset, items,
                              // prefix end, 0
  int32_t* tickets;           // int32 [splits], 0 between calls
  float2* scratch;            // [split items x kItemDocs] partial sums
  float* grad;                // f32 [rows]
  float* hess;                // f32 [rows]
  int num_items;
  int smem_docs;              // documents of the largest block item
  float k2;                   // 2 * sigmoid * log2(e)
  int device;
  const void* stream;
};

namespace {

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The high word of a sort key: ascending order of these bits is
// descending order of the score, -0 taken as +0 (they compare equal).
__device__ __forceinline__ uint32_t desc_bits(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

// One warp tile: the lane's low document (score s, discount d, gain gn;
// label y where kMasked) against the 32 documents staged in st.  Adds to
// gl/hl the low document's sums and leaves in gh/hh those of staged
// document `lane`.  Sums are of lam' = t r q and hes' = lam' (1 - q),
// with t = (gain_hi - gain_lo) |d_hi - d_lo|, r = 1 / (0.01 + |ds|) and
// q = 1 / (1 + exp(2 sigma ds)): lam = -2 inv lam', hes = 8 inv hes'.
// q gets one Newton step, so that 1 - q, where q is near 1, rounds as the
// plain version's 2 - p does; exp's argument stops at 126, so that the
// step meets no infinity (p is then below 2^-125, where the plain
// version's exp overflows to p = 0).  The high documents' sums ride four
// chains (step k on chain k & 3), so a chain's add and shuffle have four
// steps' time.
template <bool kMasked>
__device__ __forceinline__ void sweep(const float4* st, float s, float d,
                                      float gn, int y, float k2, float& gl,
                                      float& hl, float& gh, float& hh) {
  const int lane = threadIdx.x & 31;
  float cg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ch[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float4 hv = st[lane ^ k];
    const float ds = hv.x - s;
    const float r = rcp_approx(fabsf(ds) + 0.01f);
    const float dn = 1.0f + ex2_approx(fminf(ds * k2, 126.0f));
    const float q0 = rcp_approx(dn);
    const float q = fmaf(q0, fmaf(-dn, q0, 1.0f), q0);
    float t = (hv.z - gn) * fabsf(hv.y - d);
    if (kMasked) t = __float_as_int(hv.w) > y ? t : 0.0f;
    const float lam = t * r * q;
    const float hq = fmaf(-lam, q, lam);
    gl += lam;
    hl += hq;
    // chain k & 3 holds document lane ^ k; at its next step lane ^ (k + 4)
    // (on lane lane ^ k ^ (k + 4)), after its last the lane's own
    const int c = k & 3, m = k < 28 ? k ^ (k + 4) : k;
    cg[c] = __shfl_xor_sync(kFull, cg[c] + lam, m);
    ch[c] = __shfl_xor_sync(kFull, ch[c] + hq, m);
  }
  gh = (cg[0] + cg[1]) + (cg[2] + cg[3]);
  hh = (ch[0] + ch[1]) + (ch[2] + ch[3]);
}

// The warp tiles of rectangle lows [lo0, lo1) x highs [0, hi1) of doc,
// numbered from t on; this warp takes those with t % stride == pick and
// adds its sums into aw.  Returns the next number.
__device__ int rect_tiles(const float4* doc, float4* st, float2* aw, int lo0,
                          int lo1, int hi1, int t, int stride, int pick,
                          float k2) {
  const int lane = threadIdx.x & 31;
  for (int l0 = lo0; l0 < lo1; l0 += 32) {
    for (int h0 = 0; h0 < hi1; h0 += 32, ++t) {
      if ((t & (stride - 1)) != pick) continue;
      const int x = l0 + lane, hx = h0 + lane;
      const bool lv = x < lo1, hv = hx < hi1;
      const float4 lw = lv ? doc[x] : make_float4(-kPad, 0.0f, 0.0f, 0.0f);
      st[lane] = hv ? doc[hx] : make_float4(kPad, 0.0f, 0.0f, 0.0f);
      __syncwarp();
      float gl = 0.0f, hl = 0.0f, gh, hh;
      sweep<false>(st, lw.x, lw.y, lw.z, 0, k2, gl, hl, gh, hh);
      if (lv) {
        float2 u = aw[x];
        u.x -= gl;
        u.y += hl;
        aw[x] = u;
      }
      if (hv) {
        float2 u = aw[hx];
        u.x += gh;
        u.y += hh;
        aw[hx] = u;
      }
      __syncwarp();
    }
  }
  return t;
}

__device__ __forceinline__ void write_doc(const Args& a, int row, float G,
                                          float H, float mult) {
  float g = (-2.0f * mult) * G;
  float h = (8.0f * mult) * H;
  if (a.weight != nullptr) {
    const float w = a.weight[row];
    g *= w;
    h *= w;
  }
  a.grad[row] = g;
  a.hess[row] = h;
}

// max (is_max) or min of v over the block; every thread gets it
__device__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = is_max ? fmaxf(v, w) : fminf(v, w);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    r = is_max ? fmaxf(r, red[w]) : fminf(r, red[w]);
  __syncthreads();
  return r;
}

// in-place inclusive prefix sum of h[0 .. n), n <= 2 * kThreads
__device__ void block_scan(int* h, int n, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = 2 * tid;
  const int v0 = i < n ? h[i] : 0;
  const int v1 = i + 1 < n ? h[i + 1] : 0;
  int s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += u;
  }
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  const int excl = before + s - v0 - v1;
  if (i < n) h[i] = excl + v0;
  if (i + 1 < n) h[i + 1] = excl + v0 + v1;
  __syncthreads();
}

// A query of at most 32 documents: ranks by a bitonic sort across the
// lanes, then one masked tile of all 32 x 32 ordered pairs.
__device__ void masked_query(const Args& a, int q, float4* st) {
  const int lane = threadIdx.x & 31;
  const int qb = a.bounds[q], n = a.bounds[q + 1] - qb;
  const bool v = lane < n;
  int row = 0, y = INT_MAX;
  float s = 0.0f, gn = 0.0f;
  if (v) {
    row = a.perm[qb + lane];
    s = a.score[row];
    gn = a.dgain[qb + lane];
    y = a.label[row];
  }
  uint64_t key = v ? ((uint64_t)desc_bits(s) << 32) |
                         ((uint64_t)(row - qb) << 5) | (uint64_t)lane
                   : ~0ull;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, key, stride);
      const bool up = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      key = (lower == up) ? (key < o ? key : o) : (key < o ? o : key);
    }
  }
  // lane r holds the key of rank r; its low bits name the document's lane
  float* disc = reinterpret_cast<float*>(st);
  if (v) disc[key & 31] = a.discount[lane];
  __syncwarp();
  const float d = v ? disc[lane] : 0.0f;
  float mx = v ? s : -INFINITY, mn = v ? s : INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
  }
  const float mult = a.inv_max_dcg[q] * (mx == mn ? 0.01f : 1.0f);
  __syncwarp();
  st[lane] = v ? make_float4(s, d, gn, __int_as_float(y))
               : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(INT_MIN));
  __syncwarp();
  float gl = 0.0f, hl = 0.0f, gh, hh;
  sweep<true>(st, s, d, gn, y, a.k2, gl, hl, gh, hh);
  if (v) write_doc(a, row, gh - gl, hh + hl, mult);
}

// Bitonic sort, ascending, of the 32 R keys a warp holds R a lane:
// element lane * R + j in k[j].  Strides below R compare within the lane,
// the others across lanes by shuffles.
template <int R>
__device__ __forceinline__ void warp_sort(uint64_t (&k)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool up = ((lane * R + j) & size) == 0;
        if (stride < R) {
          if ((j ^ stride) > j) {
            const uint64_t p = k[j], o = k[j ^ stride];
            const bool swap = (p > o) == up;
            k[j] = swap ? o : p;
            k[j ^ stride] = swap ? p : o;
          }
        } else {
          const uint64_t o = __shfl_xor_sync(kFull, k[j], stride / R);
          const bool keep_min = (((lane * R + j) & stride) == 0) == up;
          k[j] = keep_min ? (k[j] < o ? k[j] : o) : (k[j] < o ? o : k[j]);
        }
      }
    }
  }
}

// A warp query's documents into doc (score, gain), sorted by key in
// registers, and each one's discount at its rank into doc[].y; the
// scores' max and min into mx, mn.
template <int R>
__device__ __forceinline__ void warp_ranks(const Args& a, int qb, int n,
                                           float4* doc, float& mx,
                                           float& mn) {
  const int lane = threadIdx.x & 31;
  uint64_t k[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int x = j * 32 + lane;
    k[j] = ~0ull;
    if (x < n) {
      const int row = a.perm[qb + x];
      const float s = a.score[row];
      doc[x] = make_float4(s, 0.0f, a.dgain[qb + x], 0.0f);
      k[j] = ((uint64_t)desc_bits(s) << 32) |
             ((uint64_t)(row - qb) << kSlotBits) | (uint64_t)x;
      mx = fmaxf(mx, s);
      mn = fminf(mn, s);
    }
  }
  warp_sort<R>(k);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = lane * R + j;
    if (e < n) doc[k[j] & (kItemDocs - 1)].y = a.discount[e];
  }
}

// A query of 33 to kWarpDocs documents by one warp in its kWarpBytes of
// shared memory: ranks by a bitonic sort of its keys in registers, then
// the warp tiles of its label groups' rectangles, summed in order.
__device__ void warp_query(const Args& a, int q, unsigned char* wsm) {
  const int lane = threadIdx.x & 31;
  const int qb = a.bounds[q], n = a.bounds[q + 1] - qb;
  float4* st = reinterpret_cast<float4*>(wsm);
  float4* doc = st + 32;
  float2* acc = reinterpret_cast<float2*>(doc + kWarpDocs);
  float mx = -INFINITY, mn = INFINITY;
  if (n <= 64)
    warp_ranks<2>(a, qb, n, doc, mx, mn);
  else if (n <= 128)
    warp_ranks<4>(a, qb, n, doc, mx, mn);
  else
    warp_ranks<8>(a, qb, n, doc, mx, mn);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
  }
  const float mult = a.inv_max_dcg[q] * (mx == mn ? 0.01f : 1.0f);
  __syncwarp();
  for (int x = lane; x < n; x += 32) acc[x] = make_float2(0.0f, 0.0f);
  __syncwarp();
  const int qg = a.qgroup[q], ng = a.qgroup[q + 1] - qg - 1;
  int t = 0;
  for (int g = 1; g < ng; ++g) {
    const int lo0 = a.gstarts[qg + g];
    t = rect_tiles(doc, st, acc, lo0, a.gstarts[qg + g + 1], lo0, t, 1, 0,
                   a.k2);
  }
  for (int x = lane; x < n; x += 32)
    write_doc(a, a.perm[qb + x], acc[x].x, acc[x].y, mult);
}

// A bundle: up to kWarps queries of at most kWarpDocs documents, one a
// warp, each in its own kWarpBytes of shared memory.
__device__ void warp_bundle(const Args& a, const int* it,
                            unsigned char* smem) {
  const int warp = threadIdx.x >> 5;
  if (warp >= it[3]) return;
  const int q = a.warp_q[it[2] + warp];
  unsigned char* wsm = smem + warp * kWarpBytes;
  if (a.bounds[q + 1] - a.bounds[q] <= kMaskedDocs)
    masked_query(a, q, reinterpret_cast<float4*>(wsm));
  else
    warp_query(a, q, wsm);
}

// Bitonic sort, ascending, of keys[0, npad) (npad a power of two, at
// most 2 * kThreads): thread t holds elements 2t and 2t + 1; strides below
// 64 compare within the warp by shuffles, longer ones through keys
// between the block's barriers.
__device__ void block_sort(uint64_t* keys, int npad) {
  const int t = threadIdx.x;
  const bool act = 2 * t < npad;
  uint64_t k0 = act ? keys[2 * t] : ~0ull, k1 = act ? keys[2 * t + 1] : ~0ull;
  for (int size = 2; size <= npad; size <<= 1) {
    const bool up = ((2 * t) & size) == 0;
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_min = (((2 * t) & stride) == 0) == up;
      uint64_t o0, o1;
      if (stride == 1) {
        const bool swap = (k0 > k1) == up;
        o0 = swap ? k1 : k0;
        k1 = swap ? k0 : k1;
        k0 = o0;
        continue;
      }
      if (stride < 64) {
        o0 = __shfl_xor_sync(kFull, k0, stride >> 1);
        o1 = __shfl_xor_sync(kFull, k1, stride >> 1);
      } else {
        __syncthreads();
        if (act) {
          keys[2 * t] = k0;
          keys[2 * t + 1] = k1;
        }
        __syncthreads();
        o0 = act ? keys[(2 * t) ^ stride] : k0;
        o1 = act ? keys[(2 * t + 1) ^ stride] : k1;
      }
      k0 = keep_min ? (k0 < o0 ? k0 : o0) : (k0 < o0 ? o0 : k0);
      k1 = keep_min ? (k1 < o1 ? k1 : o1) : (k1 < o1 ? o1 : k1);
    }
  }
  __syncthreads();
  if (act) {
    keys[2 * t] = k0;
    keys[2 * t + 1] = k1;
  }
  __syncthreads();
}

// A whole query, a long query's prefix of whole label groups, or a tile
// of one group's rectangle, by the block.
__device__ void block_item(const Args& a, const int* it,
                           unsigned char* smem) {
  __shared__ float red[kWarps];
  __shared__ int wsum[kWarps];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int kind = it[0], q = it[1];
  const int qb = a.bounds[q], n = a.bounds[q + 1] - qb;
  const bool tile = kind == kPairTile;
  const int nH = tile ? it[3] - it[2] : 0;
  const int nd = tile ? nH + it[5] - it[4] : it[3];
  int npad = 1;
  while (npad < nd) npad <<= 1;
  float4* stage = reinterpret_cast<float4*>(smem);     // [kWarps][32]
  float4* doc = stage + kWarps * 32;                   // [smem_docs]
  unsigned char* region = reinterpret_cast<unsigned char*>(doc + a.smem_docs);
  uint64_t* keys = reinterpret_cast<uint64_t*>(region);  // [npad]
  int* hist = reinterpret_cast<int*>(keys + npad);       // [nd]
  float2* acc = reinterpret_cast<float2*>(region);       // [kWarps][nd]

  // 1. the item's documents (slot x: grouped position it[2] + x, or for a
  // tile highs then lows) and their sort keys
  float mx = -INFINITY, mn = INFINITY;
  for (int x = tid; x < npad; x += kThreads) {
    if (x < nd) {
      const int k = !tile ? x : (x < nH ? it[2] + x : it[4] + x - nH);
      const int row = a.perm[qb + k];
      const float s = a.score[row];
      doc[x] = make_float4(s, 0.0f, a.dgain[qb + k], 0.0f);
      keys[x] = ((uint64_t)desc_bits(s) << 32) |
                ((uint64_t)(row - qb) << kSlotBits) | (uint64_t)x;
      mx = fmaxf(mx, s);
      mn = fminf(mn, s);
    } else {
      keys[x] = ~0ull;
    }
  }
  __syncthreads();

  // 2. bitonic sort of the keys, ascending
  block_sort(keys, npad);

  // 3. ranks: the sorted position, or the keys of the query before it
  if (kind == kWhole) {
    for (int m = tid; m < nd; m += kThreads)
      doc[keys[m] & (kItemDocs - 1)].y = a.discount[m];
  } else {
    for (int c = tid; c < nd; c += kThreads) hist[c] = 0;
    __syncthreads();
    mx = -INFINITY;
    mn = INFINITY;
    for (int j = tid; j < n; j += kThreads) {
      const float s = a.score[qb + j];
      mx = fmaxf(mx, s);
      mn = fminf(mn, s);
      const uint64_t kj = ((uint64_t)desc_bits(s) << 32) |
                          ((uint64_t)j << kSlotBits) | (kItemDocs - 1);
      int lo = 0, hi = nd;   // the item's keys at or before kj
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] <= kj) lo = mid + 1; else hi = mid;
      }
      if (lo < nd) atomicAdd(&hist[lo], 1);
    }
    __syncthreads();
    block_scan(hist, nd, wsum);
    for (int m = tid; m < nd; m += kThreads)
      doc[keys[m] & (kItemDocs - 1)].y = a.discount[hist[m]];
  }
  mx = block_reduce(mx, true, red);
  mn = block_reduce(mn, false, red);
  const float mult = a.inv_max_dcg[q] * (mx == mn ? 0.01f : 1.0f);

  // 4. each warp's row of sums
  for (int i = tid; i < kWarps * nd; i += kThreads)
    acc[i] = make_float2(0.0f, 0.0f);
  __syncthreads();

  // 5. warp tiles of the rectangles, dealt to the warps in turn
  const int qg = a.qgroup[q];
  const int nrect = tile ? 1 : a.qgroup[q + 1] - qg - 2;
  int t = 0;
  for (int rc = 0; rc < nrect; ++rc) {
    int lo0 = nH, lo1 = nd;
    if (!tile) {
      lo0 = a.gstarts[qg + rc + 1];
      if (lo0 >= nd) break;
      lo1 = a.gstarts[qg + rc + 2];
    }
    t = rect_tiles(doc, stage + warp * 32, acc + warp * nd, lo0, lo1,
                   tile ? nH : lo0, t, kWarps, warp, a.k2);
  }
  __syncthreads();

  // 6. each document's sums in warp order: written, or a partial
  const int sp = kind == kWhole ? -1 : a.qsplit[q];
  const int* si = a.split_info + 4 * (sp < 0 ? 0 : sp);
  float2* scr = a.scratch + (sp < 0 ? 0 : si[0]);
  for (int x = tid; x < nd; x += kThreads) {
    float G = 0.0f, H = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 u = acc[w * nd + x];
      G += u.x;
      H += u.y;
    }
    if (kind == kWhole)
      write_doc(a, a.perm[qb + x], G, H, mult);
    else
      scr[it[6] * kItemDocs + x] = make_float2(G, H);
  }
  if (kind == kWhole) return;

  // 7. the query's last item to finish adds its partial sums
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(&a.tickets[sp], 1);
    last = done == si[1] - 1;
    if (last) a.tickets[sp] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int e = si[2];
  const int ng = a.qgroup[q + 1] - qg - 1;
  const int* gs = a.gstarts + qg;
  for (int k = tid; k < n; k += kThreads) {
    float G = 0.0f, H = 0.0f;
    if (k < e) {
      const float2 u = __ldcg(scr + k);
      G += u.x;
      H += u.y;
    }
    int ord = 1;
    for (int g = 1; g < ng; ++g) {
      const int gst = gs[g], gen = gs[g + 1];
      if (gen <= e) continue;
      const int nlt = (gen - gst + kTile - 1) / kTile;
      const int nht = (gst + kTile - 1) / kTile;
      if (k >= gst && k < gen) {          // a low document of these tiles
        const int lt = (k - gst) / kTile, off = k - gst - lt * kTile;
        for (int ht = 0; ht < nht; ++ht) {
          const int nh = min(kTile, gst - ht * kTile);
          const float2 u = __ldcg(
              scr + (ord + lt * nht + ht) * kItemDocs + nh + off);
          G += u.x;
          H += u.y;
        }
      } else if (k < gst) {               // a high document of these tiles
        const int ht = k / kTile, off = k - ht * kTile;
        for (int lt = 0; lt < nlt; ++lt) {
          const float2 u = __ldcg(scr + (ord + lt * nht + ht) * kItemDocs +
                                  off);
          G += u.x;
          H += u.y;
        }
      }
      ord += nlt * nht;
    }
    write_doc(a, a.perm[qb + k], G, H, mult);
  }
}

// 64 registers a thread: four blocks an SM
__global__ void __launch_bounds__(kThreads, 4)
    lgbt_lambdarank_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* it = a.items + 8 * blockIdx.x;
  if (it[0] == kWarpBundle)
    warp_bundle(a, it, smem);
  else
    block_item(a, it, smem);
}

}  // namespace

// The gradients and hessians of every query: one launch of one block a
// work item on stream x->stream of card x->device, made current only if
// it is not.  Returns the cudaError_t (0 on success).
extern "C" int lgbt_lambdarank(const Args* x) {
  const Args& a = *x;
  if (a.num_items < 0 || a.smem_docs < 0 || a.smem_docs > kItemDocs)
    return (int)cudaErrorInvalidValue;
  if (a.num_items == 0) return 0;
  int prev = a.device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != a.device) err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = sizeof(float4) * kWarps * 32 + (size_t)80 * a.smem_docs;
  if (smem < (size_t)kWarps * kWarpBytes) smem = (size_t)kWarps * kWarpBytes;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(lgbt_lambdarank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int rc = (int)err;
  if (rc == 0) {
    lgbt_lambdarank_kernel<<<a.num_items, kThreads, smem,
                             (cudaStream_t)a.stream>>>(a);
    rc = (int)cudaGetLastError();
  }
  if (prev != a.device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return (int)err;
  }
  return rc;
}
