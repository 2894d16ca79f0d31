// Fused pairwise distance + streaming exact top-k + in-radius count.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_topk.py::_kernel
// (the pl.pallas_call in pairwise_topk_padded).  For each query: the k
// smallest distances to all points with their indices, ordered by
// (distance, index), and the number of points with distance <= thr.  The
// self index (query_ids[row]) is skipped; query_ids == n means "no self".
//
// Design: one thread per query, kThreads queries per block.  The block
// streams point tiles through shared memory (every thread reads the same
// point, so the loads broadcast) and each thread keeps its running k-best
// list in registers (k <= 32) or in its own output row (any larger k, as the
// range route's second pass asks for).  The (Q, N) distance matrix never
// exists.
//
// Bound on this card: operations.  Per pair the L2 form costs d subtractions
// and d multiply-adds, 3d FP32 flops, against O((Q + N) d) bytes moved; at
// the main path's shapes (Q in the thousands, N = 2^20) the FP32 pipe, not
// HBM, is the limit.  This first version is the simple, exact one: a block
// walks all N points, so with few queries only a few SMs work (splitting N
// across blocks with a merge pass is the next step).
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"
#include "topk_list.cuh"

namespace {

using repro_torch::GlobalTopK;
using repro_torch::RegTopK;

constexpr int kThreads = 64;
constexpr int kTileFloats = 8192;  // 32 KB of shared memory per block
constexpr int kMaxTile = 2048;
constexpr int kLowD = 8;
enum { kL2 = 0, kL1 = 1, kLinf = 2 };

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

template <int METRIC>
__device__ __forceinline__ float highd_dist(const float* qr, float qn,
                                            const float* pv, float pn, int d) {
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

template <class List, int METRIC, bool LOWD>
__global__ void __launch_bounds__(kThreads)
pairwise_topk_kernel(const float* __restrict__ q, const int* __restrict__ qid,
                     const float* __restrict__ p,
                     const unsigned char* __restrict__ row_mask, int nq, int n,
                     int d, int k, int tp, float thr, float* __restrict__ out_d,
                     int* __restrict__ out_i, int* __restrict__ out_c) {
  extern __shared__ float smem[];
  float* tile = smem;           // (tp, d) point coordinates
  float* norms = smem + tp * d;  // (tp,) squared norms, L2 identity form only

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active =
      row < nq && (row_mask == nullptr || row_mask[row] != 0);
  if (!__syncthreads_or(active)) return;  // the whole block leaves together

  const int self = active ? qid[row] : -1;
  const float* qr = q + (size_t)(active ? row : 0) * d;
  float qv[kLowD];
  float qn = 0.0f;
  if (LOWD) {
#pragma unroll
    for (int a = 0; a < kLowD; ++a) qv[a] = (active && a < d) ? qr[a] : 0.0f;
  } else if (METRIC == kL2 && active) {
    qn = sq_norm(qr, d);
  }

  List list;
  if (active) list.init(out_d + (size_t)row * k, out_i + (size_t)row * k, k, n);
  int count = 0;

  for (int base = 0; base < n; base += tp) {
    const int m = min(tp, n - base);
    __syncthreads();  // the previous tile is no longer read
    const float* src = p + (size_t)base * d;
    for (int e = threadIdx.x; e < m * d; e += kThreads) tile[e] = src[e];
    __syncthreads();
    if (!LOWD && METRIC == kL2) {
      for (int j = threadIdx.x; j < m; j += kThreads)
        norms[j] = sq_norm(tile + j * d, d);
      __syncthreads();
    }
    if (!active) continue;
    for (int j = 0; j < m; ++j) {
      const int gidx = base + j;
      if (gidx == self) continue;
      const float* pv = tile + j * d;
      const float dist = LOWD ? lowd_dist<METRIC>(qv, pv, d)
                              : highd_dist<METRIC>(qr, qn, pv, norms[j], d);
      count += (dist <= thr);
      if (dist < list.worst) list.push(dist, gidx, k);
    }
  }
  if (active) {
    list.store(out_d + (size_t)row * k, out_i + (size_t)row * k, k);
    out_c[row] = count;
  }
}

template <class List, int METRIC>
cudaError_t launch_form(bool lowd, dim3 grid, int smem, cudaStream_t stream,
                        const float* q, const int* qid, const float* p,
                        const unsigned char* row_mask, int nq, int n, int d,
                        int k, int tp, float thr, float* out_d, int* out_i,
                        int* out_c) {
  if (lowd) {
    pairwise_topk_kernel<List, METRIC, true><<<grid, kThreads, smem, stream>>>(
        q, qid, p, row_mask, nq, n, d, k, tp, thr, out_d, out_i, out_c);
  } else {
    pairwise_topk_kernel<List, METRIC, false><<<grid, kThreads, smem, stream>>>(
        q, qid, p, row_mask, nq, n, d, k, tp, thr, out_d, out_i, out_c);
  }
  return cudaGetLastError();
}

template <class List>
cudaError_t launch_list(int metric, bool lowd, dim3 grid, int smem,
                        cudaStream_t stream, const float* q, const int* qid,
                        const float* p, const unsigned char* row_mask, int nq,
                        int n, int d, int k, int tp, float thr, float* out_d,
                        int* out_i, int* out_c) {
  switch (metric) {
    case kL2:
      return launch_form<List, kL2>(lowd, grid, smem, stream, q, qid, p,
                                    row_mask, nq, n, d, k, tp, thr, out_d,
                                    out_i, out_c);
    case kL1:
      return launch_form<List, kL1>(lowd, grid, smem, stream, q, qid, p,
                                    row_mask, nq, n, d, k, tp, thr, out_d,
                                    out_i, out_c);
    case kLinf:
      return launch_form<List, kLinf>(lowd, grid, smem, stream, q, qid, p,
                                      row_mask, nq, n, d, k, tp, thr, out_d,
                                      out_i, out_c);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C entry point; its contract is in launch.h.
extern "C" int pairwise_topk_launch(const float* q, const int* qid,
                                    const float* p,
                                    const unsigned char* row_mask, int nq,
                                    int n, int d, int k, float thr, int metric,
                                    float* out_d, int* out_i, int* out_c,
                                    void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (n <= 0 || d <= 0 || k <= 0) return cudaErrorInvalidValue;
  const bool lowd = d <= kLowD;
  int tp = kTileFloats / (d + 1);
  tp = tp < 1 ? 1 : (tp > kMaxTile ? kMaxTile : tp);
  const int smem = tp * (d + 1) * (int)sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // d > 8191
  const dim3 grid((nq + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8)
    return launch_list<RegTopK<8>>(metric, lowd, grid, smem, s, q, qid, p,
                                   row_mask, nq, n, d, k, tp, thr, out_d,
                                   out_i, out_c);
  if (k <= 32)
    return launch_list<RegTopK<32>>(metric, lowd, grid, smem, s, q, qid, p,
                                    row_mask, nq, n, d, k, tp, thr, out_d,
                                    out_i, out_c);
  return launch_list<GlobalTopK>(metric, lowd, grid, smem, s, q, qid, p,
                                 row_mask, nq, n, d, k, tp, thr, out_d, out_i,
                                 out_c);
}
