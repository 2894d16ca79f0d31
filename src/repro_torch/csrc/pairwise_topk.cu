// Fused pairwise distance + streaming exact top-k + in-radius count.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_topk.py::_kernel
// (the pl.pallas_call in pairwise_topk_padded).  For each query: the k
// smallest distances to all points with their indices, ordered by
// (distance, index), and the number of points with distance <= thr.  The
// self index (query_ids[row]) is skipped; query_ids == n means "no self".
//
// Design: two passes.  The first runs on a grid of (query tiles x S point
// ranges): each block streams only its own contiguous range of the points
// through shared memory and keeps, per query row, the range's k-best list
// and in-radius count, written to workspace that the wrapper allocates:
// lists (S, Q, k), counts (S, Q).  The host picks S from (Q, N, k) and the
// first pass's rows a block (pairwise_topk_rows_per_block below) so that
// several blocks per SM are in flight even at Q = 100 (the Alg. 2
// sampler); with S = 1 the first pass writes the outputs and the second is
// skipped.  The second pass merges each row's S partial lists in range
// order: ranges are contiguous and increasing, so taking the earlier range
// on an equal distance, which is the lower index, is the global (distance,
// lowest index) order; counts are summed in int32.  The (Q, N) distance
// matrix never exists.
//
// The lists.  Both passes keep each query's list with a whole warp, and
// insert one candidate at a time:
//  - k <= kMaxWarpK = 1024: a WarpTopK (topk_list.cuh) in registers, KPL =
//    1, 2, 4, 8, 16 or 32 entries a lane, the fewest whose 32 * KPL
//    entries hold k, right-aligned so the k-th entry (the gate) is the last
//    slot of lane 31.  A candidate strictly below the gate is inserted by
//    the whole warp: each lane moves its own entries above it up one slot
//    and takes the last entry of the lane below by one shuffle (at KPL = 1
//    a ballot finds the place), then one shuffle reads the gate back: O(KPL)
//    steps a lane whatever the list's length.
//  - k > 1024 (the range route's second call on balls of more than 1024
//    points): a RowWarpTopK, the list in the query's workspace or output
//    row.  A 32-way search finds the place and the warp moves the entries
//    above it up one slot, 32 consecutive words at a time: O(k / 32)
//    coalesced steps an insertion, through L1 and L2.
// About k ln(N / k) + k insertions a query and range on points in random
// order; more where the points come in an order that approaches the query.
//
// Order argument: candidates are offered in index order (a chunk's lanes in
// lane order), each against the gate as it stands, and an insertion goes
// after every entry of equal distance.  So the list's first k entries are
// always the k least (distance, index) pairs seen so far: a candidate not
// admitted is at or above the k-th by distance and later by index.  This
// is the order of lax.top_k and of the plain version's stable sort, bit for
// bit; +inf and NaN are never below a gate, so empty slots stay (+inf, n).
//
// First pass: a warp serves QPW queries (four where the tile holds float4
// rows and KPL <= 8, two at KPL = 16, else one) and its lanes take 32
// consecutive staged points at a time, so each shared load of a point
// serves QPW tests; a chunk in which no lane beats its query's gate costs
// one vote.  (With one thread a query, a thread's insertion sort would
// hold up its warp whenever any lane had a candidate, which early in every
// range is nearly always, and a warp's list accesses would touch 32 rows.)
// Merge: a warp a row (topk_list.cuh::warp_merge, which grid_round's
// merge shares).  Split 0's list is taken as it is; then the heads of 32
// splits at a time are read at once, and only a split whose head is below
// the gate is walked, 32 entries at a time in order until one is not below
// the gate (the lists are sorted, so no later one is).
//
// Bound on this card: operations.  Per pair the L2 form costs d subtractions
// and d multiply-adds, 3d FP32 flops, against O((Q + N) d) bytes moved.  The
// inner loop keeps to the distance, one compare for the count and one for
// the list: the self index is not tested per pair; a range that holds it
// takes its pair back out of the count once, at the end.  For L2 at d = 2
// and 3 the tile holds float4 rows (one shared load a point).
//
// Distance forms, chosen on the REAL feature dim d:
//   L2,  d <= 8: diff form, acc = q0'^2, then acc = fma(qa', qa', acc) with
//                qa' = q_a - p_a.  Explicit __fmul_rn/__fmaf_rn intrinsics pin
//                this chain whatever -fmad says, so the values are bitwise
//                those of the JAX reference's jitted brute engine.
//   L2,  d > 8:  matmul identity max(qn + pn - 2 q.p, 0), every term an FP32
//                FMA chain (no tensor cores, no TF32).
//   L1:          sequential sum of |q_a - p_a|.
//   Linf:        running max of |q_a - p_a|.
//   L2 diff (metric 3, "l2diff"): the d <= 8 L2 chain at ANY d -- the
//                placed shard fabric's squared-L2 form, which the JAX
//                reference computes as sum(diff * diff) at every d.  At
//                d <= 8 it is the L2 kernel itself; above, the query row is
//                read from global memory (as the identity form reads it) and
//                the chain runs over the staged (tp, d) tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.h"
#include "topk_list.cuh"

namespace {

using repro_torch::kAllLanes;
using repro_torch::kpl_of;
using repro_torch::RowWarpTopK;
using repro_torch::WarpTopK;
using repro_torch::warp_merge;
using repro_torch::with_list;

constexpr int kThreads = 128;
constexpr int kTileFloats = 8192;  // 32 KB of shared memory per block
constexpr int kMaxTile = 2048;
constexpr int kMergeThreads = 128;
constexpr int kLowD = 8;
enum { kL2 = 0, kL1 = 1, kLinf = 2, kL2Diff = 3 };

template <int METRIC>
__device__ __forceinline__ float lowd_dist(const float (&qv)[kLowD],
                                           const float* pv, int d) {
  float df = __fsub_rn(qv[0], pv[0]);
  float acc = (METRIC == kL2) ? __fmul_rn(df, df) : fabsf(df);
#pragma unroll
  for (int a = 1; a < kLowD; ++a) {
    if (a < d) {
      df = __fsub_rn(qv[a], pv[a]);
      if (METRIC == kL2) {
        acc = __fmaf_rn(df, df, acc);
      } else if (METRIC == kL1) {
        acc = __fadd_rn(acc, fabsf(df));
      } else {
        acc = fmaxf(acc, fabsf(df));
      }
    }
  }
  return acc;
}

// The same L2 chain at a compile-time d (2 or 3) on a float4 row.
template <int D>
__device__ __forceinline__ float l2_dist4(const float (&qv)[kLowD],
                                          const float4 pv) {
  float df = __fsub_rn(qv[0], pv.x);
  float acc = __fmul_rn(df, df);
  df = __fsub_rn(qv[1], pv.y);
  acc = __fmaf_rn(df, df, acc);
  if (D > 2) {
    df = __fsub_rn(qv[2], pv.z);
    acc = __fmaf_rn(df, df, acc);
  }
  return acc;
}

template <int METRIC>
__device__ __forceinline__ float highd_dist(const float* qr, float qn,
                                            const float* pv, float pn, int d) {
  if (METRIC == kL2Diff) {
    float df = __fsub_rn(qr[0], pv[0]);
    float acc = __fmul_rn(df, df);
    for (int a = 1; a < d; ++a) {
      df = __fsub_rn(qr[a], pv[a]);
      acc = __fmaf_rn(df, df, acc);
    }
    return acc;
  }
  if (METRIC == kL2) {
    float cross = __fmul_rn(qr[0], pv[0]);
    for (int a = 1; a < d; ++a) cross = __fmaf_rn(qr[a], pv[a], cross);
    return fmaxf(__fsub_rn(__fadd_rn(qn, pn), __fmul_rn(2.0f, cross)), 0.0f);
  }
  float acc = fabsf(__fsub_rn(qr[0], pv[0]));
  for (int a = 1; a < d; ++a) {
    const float ad = fabsf(__fsub_rn(qr[a], pv[a]));
    acc = (METRIC == kL1) ? __fadd_rn(acc, ad) : fmaxf(acc, ad);
  }
  return acc;
}

__device__ __forceinline__ float sq_norm(const float* v, int d) {
  float s = __fmul_rn(v[0], v[0]);
  for (int a = 1; a < d; ++a) s = __fmaf_rn(v[a], v[a], s);
  return s;
}

// FORM: 2 or 3 = L2 at that d on float4 tiles; 0 = any d <= 8 on (tp, d)
// tiles; -1 = d > 8 (identity form for L2, the diff chain for L2 diff).
constexpr int form_of(int metric, int d) {
  return (metric == kL2 || metric == kL2Diff) && (d == 2 || d == 3) ? d
         : d <= kLowD                                               ? 0
                                                                    : -1;
}

// Query rows a warp serves: four where the tile holds float4 rows and the
// lists are short, two at 16 entries a lane, else one (the registers of
// QPW lists stay at most 64 a thread; one for the row list).
constexpr int qpw_of(int form, int kpl) {
  return form <= 0 || kpl == 0 ? 1 : kpl <= 8 ? 4 : kpl == 16 ? 2 : 1;
}

// Query rows a block of the first pass serves: its warps' rows.
constexpr int rows_per_block(int form, int k) {
  return kThreads / 32 * qpw_of(form, kpl_of(k));
}

// Stages points [base, base + m) in the block's tile: float4 rows for
// FORM > 0, else (m, d) floats and, for the L2 identity form, their norms.
template <int METRIC, int FORM>
__device__ __forceinline__ void stage_tile(const float* __restrict__ p,
                                           int base, int m, int d,
                                           float4* smem4, float* tile,
                                           float* norms) {
  __syncthreads();  // the previous tile is no longer read
  const float* src = p + (size_t)base * d;
  if (FORM > 0) {
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      smem4[j] = make_float4(src[j * FORM], src[j * FORM + 1],
                             FORM > 2 ? src[j * FORM + 2] : 0.0f, 0.0f);
  } else {
    for (int e = threadIdx.x; e < m * d; e += blockDim.x) tile[e] = src[e];
  }
  __syncthreads();
  if (FORM < 0 && METRIC == kL2) {
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      norms[j] = sq_norm(tile + j * d, d);
    __syncthreads();
  }
}

// One pair in the kernel's form, the point read from global memory: the
// self pair, which the first pass counts and then takes back out.
template <int METRIC, int FORM>
__device__ __forceinline__ float pair_dist(const float (&qv)[kLowD],
                                           const float* qr, float qn,
                                           const float* ps, int d) {
  if (FORM >= 0) return lowd_dist<METRIC>(qv, ps, d);
  return highd_dist<METRIC>(qr, qn, ps, METRIC == kL2 ? sq_norm(ps, d) : 0.0f,
                            d);
}

// One warp serves QPW queries of the block's tile of queries.  Its lanes
// take 32 consecutive candidates at a time (lane l the l-th), so a shared
// load of one point serves QPW tests, and each query's list is kept by the
// whole warp: a WarpTopK<KPL> in registers (k <= kMaxWarpK) or a
// RowWarpTopK in the query's workspace row.  A candidate below its query's
// gate is inserted by the whole warp, the candidates of a chunk in lane
// order, which is index order.
template <int METRIC, int FORM, int QPW, class List>
__global__ void __launch_bounds__(kThreads)
pairwise_warp_kernel(const float* __restrict__ q, const int* __restrict__ qid,
                     const float* __restrict__ p,
                     const unsigned char* __restrict__ row_mask, int nq,
                     int n, int d, int k, int span, int tp, float thr,
                     float* __restrict__ part_d, int* __restrict__ part_i,
                     int* __restrict__ part_c) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // (tp, d) coordinates
  float* norms = tile + tp * d;  // (tp,) squared norms, L2 identity only
  constexpr bool kLow = FORM >= 0;
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int row[QPW], self[QPW], count[QPW];
  float qv[QPW][kLowD], qn[QPW], gate[QPW];
  List list[QPW];
  bool any_active = false;
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    row[u] = (blockIdx.x * kWarps + warp) * QPW + u;
    const bool act =
        row[u] < nq && (row_mask == nullptr || row_mask[row[u]] != 0);
    any_active = any_active || act;
    self[u] = act ? qid[row[u]] : -1;
    const float* qr = q + (size_t)(act ? row[u] : 0) * d;
#pragma unroll
    for (int a = 0; a < kLowD; ++a) qv[u][a] = (kLow && a < d) ? qr[a] : 0.0f;
    qn[u] = (!kLow && METRIC == kL2) ? sq_norm(qr, d) : 0.0f;
    count[u] = 0;
    const size_t out_row = ((size_t)blockIdx.y * nq + row[u]) * k;
    if (act) list[u].init(part_d + out_row, part_i + out_row, k, lane, n);
    // an inactive query admits nothing
    gate[u] = act ? CUDART_INF_F : -1.0f;
  }
  if (!__syncthreads_or(any_active)) return;  // the block leaves together
  const int lo = blockIdx.y * span;
  const int hi = min(n, lo + span);

  // one chunk of 32 candidates of the m staged in the tile; whole (a
  // std::bool_constant): all 32 are staged (a tile of a generic form holds
  // tp rows, which need not be a multiple of 32, so the last chunk of any
  // tile may be short).  Each of the two forms has one call site, so both
  // are inlined and the lists stay in registers.
  auto chunk = [&](int base, int m, int c0, auto whole) {
    const bool valid = decltype(whole)::value || c0 + lane < m;
    const int j = valid ? c0 + lane : 0;  // the rest reads a staged row
    float dist[QPW];
    bool pass = false;
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      const float* qr = q + (size_t)(row[u] < nq ? row[u] : 0) * d;
      if (FORM > 0) {
        dist[u] = l2_dist4<(FORM > 0 ? FORM : 2)>(qv[u], smem4[j]);
      } else if (FORM == 0) {
        dist[u] = lowd_dist<METRIC>(qv[u], tile + j * d, d);
      } else {
        dist[u] = highd_dist<METRIC>(qr, qn[u], tile + j * d, norms[j], d);
      }
      count[u] += (valid && dist[u] <= thr);
      pass = pass || (valid && dist[u] < gate[u]);
    }
    if (!__any_sync(kAllLanes, pass)) return;
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      unsigned todo = __ballot_sync(kAllLanes, valid && dist[u] < gate[u]);
      while (todo != 0) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float dd = __shfl_sync(kAllLanes, dist[u], src);
        const int gid = base + c0 + src;
        if (!(dd < gate[u]) || gid == self[u]) continue;  // warp-uniform
        list[u].insert(dd, gid, lane);
        gate[u] = list[u].gate();
      }
    }
  };

  for (int base = lo; base < hi; base += tp) {
    const int m = min(tp, hi - base);
    stage_tile<METRIC, FORM>(p, base, m, d, smem4, tile, norms);
    int c0 = 0;
    for (; c0 + 32 <= m; c0 += 32) chunk(base, m, c0, std::true_type{});
    if (c0 < m) chunk(base, m, c0, std::false_type{});
  }

#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    if (gate[u] < 0.0f) continue;  // inactive: nothing is written
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      count[u] += __shfl_xor_sync(kAllLanes, count[u], off);
    const size_t out_row = ((size_t)blockIdx.y * nq + row[u]) * k;
    list[u].store(part_d + out_row, part_i + out_row, k, lane);
    if (lane == 0) {
      // the self pair was counted; take it back out with the same
      // arithmetic on the same values
      int c = count[u];
      if (self[u] >= lo && self[u] < hi)
        c -= pair_dist<METRIC, FORM>(qv[u], q + (size_t)row[u] * d, qn[u],
                                     p + (size_t)self[u] * d, d) <= thr;
      part_c[(size_t)blockIdx.y * nq + row[u]] = c;
    }
  }
}

// Merge: a warp a row, its list a WarpTopK<KPL> (k <= kMaxWarpK) or a
// RowWarpTopK in the output row.
template <class List>
__global__ void __launch_bounds__(kMergeThreads)
pairwise_merge_kernel(const float* __restrict__ part_d,
                      const int* __restrict__ part_i,
                      const int* __restrict__ part_c,
                      const unsigned char* __restrict__ row_mask, int nq,
                      int splits, int k, int n, float* __restrict__ out_d,
                      int* __restrict__ out_i, int* __restrict__ out_c) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  // warp-uniform: the whole warp leaves
  if (row >= nq || (row_mask != nullptr && row_mask[row] == 0)) return;
  const size_t split_stride = (size_t)nq * k;
  int count = 0;
  for (int s = lane; s < splits; s += 32)
    count += part_c[(size_t)s * nq + row];
  List list;
  warp_merge(list, part_d + (size_t)row * k, part_i + (size_t)row * k,
             split_stride, splits, k, n, lane, out_d + (size_t)row * k,
             out_i + (size_t)row * k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(kAllLanes, count, off);
  if (lane == 0) out_c[row] = count;
}

struct Args {
  const float* q;
  const int* qid;
  const float* p;
  const unsigned char* row_mask;
  int nq, n, d, k, span, tp;
  float thr;
  float* part_d;
  int* part_i;
  int* part_c;
};

template <int METRIC, int FORM>
cudaError_t launch_form(int splits, int smem, cudaStream_t stream,
                        const Args& a) {
  const int per_block = rows_per_block(FORM, a.k);
  const dim3 grid((a.nq + per_block - 1) / per_block, splits);
  with_list(a.k, [&](auto list) {
    using List = decltype(list);
    pairwise_warp_kernel<METRIC, FORM, qpw_of(FORM, List::kPerLane), List>
        <<<grid, kThreads, smem, stream>>>(a.q, a.qid, a.p, a.row_mask, a.nq,
                                           a.n, a.d, a.k, a.span, a.tp, a.thr,
                                           a.part_d, a.part_i, a.part_c);
  });
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(int splits, int smem, cudaStream_t stream,
                          const Args& a) {
  switch (form_of(METRIC, a.d)) {
    case 3:
      return launch_form<METRIC, 3>(splits, smem, stream, a);
    case 2:
      return launch_form<METRIC, 2>(splits, smem, stream, a);
    case 0:
      return launch_form<METRIC, 0>(splits, smem, stream, a);
    default:
      return launch_form<METRIC, -1>(splits, smem, stream, a);
  }
}

}  // namespace

// The C entry points; their contract is in launch.h.
extern "C" int pairwise_topk_launch(const float* q, const int* qid,
                                    const float* p,
                                    const unsigned char* row_mask, int nq,
                                    int n, int d, int k, int splits, int span,
                                    float thr, int metric, float* part_d,
                                    int* part_i, int* part_c, void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (n <= 0 || d <= 0 || k <= 0 || splits <= 0 || span <= 0 ||
      (long long)(splits - 1) * span >= n || (long long)splits * span < n)
    return cudaErrorInvalidValue;
  // float4 rows for L2 at d = 2, 3; (tp, d) floats (+ norms) otherwise
  const bool vec = form_of(metric, d) > 0;
  int tp = vec ? kTileFloats / 4 : kTileFloats / (d + 1);
  tp = tp > kMaxTile ? kMaxTile : tp;
  if (tp < 1) return cudaErrorInvalidValue;  // d > 8191
  const int smem = vec ? tp * 16 : tp * (d + 1) * (int)sizeof(float);
  const Args a{q, qid, p, row_mask, nq, n, d, k, span, tp, thr,
               part_d, part_i, part_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      return launch_metric<kL2>(splits, smem, s, a);
    case kL1:
      return launch_metric<kL1>(splits, smem, s, a);
    case kLinf:
      return launch_metric<kLinf>(splits, smem, s, a);
    case kL2Diff:  // at d <= 8 the L2 kernel runs this very chain
      return d <= kLowD ? launch_metric<kL2>(splits, smem, s, a)
                        : launch_form<kL2Diff, -1>(splits, smem, s, a);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int pairwise_topk_merge_launch(const float* part_d,
                                          const int* part_i, const int* part_c,
                                          const unsigned char* row_mask,
                                          int nq, int splits, int k, int n,
                                          float* out_d, int* out_i,
                                          int* out_c, void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (splits <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int rows = kMergeThreads / 32;
  const dim3 grid((nq + rows - 1) / rows);
  with_list(k, [&](auto list) {
    pairwise_merge_kernel<decltype(list)><<<grid, kMergeThreads, 0, s>>>(
        part_d, part_i, part_c, row_mask, nq, splits, k, n, out_d, out_i,
        out_c);
  });
  return cudaGetLastError();
}

extern "C" int pairwise_topk_rows_per_block(int d, int k, int metric) {
  return rows_per_block(form_of(metric, d), k);
}
