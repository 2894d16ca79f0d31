// One fixed-radius round on the spatial hash grid: the paper's RT-core step.
//
// Replaces src/repro/core/fixed_radius.py::_chunk_candidates, the XLA
// grid-stencil round of the JAX reference (no Pallas kernel there: it is
// ported by hand because it is the main path's hot loop).  Done as tensor
// gathers it would build (rows, 3^d * cap, d) candidate blocks per chunk;
// here each query walks its own stencil and nothing but the answer is
// written.
//
// Design: one thread per query row.  The thread finds its cell, walks the
// 3^d stencil cells in stencil_offsets order and, in each in-range cell, the
// bucket's slots until the first padding slot.  Per candidate, in this
// order: the exact cell-coordinate match (kills hash collisions), the
// squared distance as an FMA chain over (p - q), NaN mapped to +inf, then
// the not-self and d2 <= r2 tests.  `found` counts every in-radius
// candidate; the k best are kept ordered by (d2, candidate position), with
// position = stencil index * cap + slot, the order lax.top_k gives the
// reference.  n_tests counts matched candidates of finite queries in 64-bit
// integers (the reference sums them in float32).
//
// Bound on this card: bytes.  Each matched candidate costs a bucket entry,
// its cell coords and its point (28 bytes for d = 3) against ~3d flops, so
// the gathers from HBM/L2 are the limit.  Threads of a warp walk different
// cells, so the gathers do not coalesce; sorting queries by cell (Morton
// order) is the next step.
//
// Fused mode (unres != null): rows whose unres flag is 0 are skipped and
// left untouched; a row that runs REPLACES its outputs, and when it finds
// >= k neighbours its res_round is set to t and its unres flag cleared.
// Any row that runs sets *executed = 1, which is how the host learns, after
// its single sync, how many scheduled rounds the on-device loop executed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"
#include "topk_list.cuh"

namespace {

using repro_torch::GlobalTopK;
using repro_torch::RegTopK;

constexpr int kThreads = 128;
constexpr int kMaxD = 3;  // one Teschner hash prime per axis

template <class List>
__global__ void __launch_bounds__(kThreads)
grid_round_kernel(const float* __restrict__ pts, const int* __restrict__ buckets,
                  const int* __restrict__ point_cells,
                  const float* __restrict__ origin,
                  const float* __restrict__ inv_cell,
                  const int* __restrict__ res, const float* __restrict__ q,
                  const int* __restrict__ qid, int nq, int n, int d,
                  int table_size, int cap, int k, float r2,
                  float* __restrict__ out_d2, int* __restrict__ out_i,
                  int* __restrict__ found_out, unsigned char* __restrict__ unres,
                  int* __restrict__ res_round, int t,
                  unsigned long long* __restrict__ tests,
                  int* __restrict__ executed) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < nq && (unres == nullptr || unres[row] != 0);
  unsigned long long my_tests = 0;

  if (active) {
    const float* qr = q + (size_t)row * d;
    const int self = qid[row];
    float qv[kMaxD];
    int cc[kMaxD];
    int rs[kMaxD];
#pragma unroll
    for (int a = 0; a < kMaxD; ++a) {
      if (a < d) {
        qv[a] = qr[a];
        const float qf = isfinite(qv[a]) ? qv[a] : 0.0f;
        // floor, then the reference's saturating int32 convert + clip,
        // done as a float clamp (res <= 2^20 is exact in float32)
        float c = floorf(__fmul_rn(__fsub_rn(qf, origin[a]), inv_cell[a]));
        rs[a] = res[a];
        c = fminf(fmaxf(c, 0.0f), (float)(rs[a] - 1));
        cc[a] = (int)c;
      } else {
        qv[a] = 0.0f;
        cc[a] = 0;
        rs[a] = 1;
      }
    }
    const bool qvalid = isfinite(qv[0]);  // padding rows count nothing

    List list;
    list.init(out_d2 + (size_t)row * k, out_i + (size_t)row * k, k, n);
    int found = 0;

    int n_stencil = 1;
    for (int a = 0; a < d; ++a) n_stencil *= 3;
    for (int s = 0; s < n_stencil && qvalid; ++s) {
      // stencil_offsets(d): meshgrid "ij" order, the last axis fastest
      int rem = s;
      int nb[kMaxD];
      bool in_range = true;
#pragma unroll
      for (int a = kMaxD - 1; a >= 0; --a) {
        if (a < d) {
          nb[a] = cc[a] + (rem % 3) - 1;
          rem /= 3;
          in_range = in_range && nb[a] >= 0 && nb[a] < rs[a];
        } else {
          nb[a] = 0;
        }
      }
      if (!in_range) continue;
      // Teschner spatial hash in uint32 wraparound arithmetic
      unsigned h = (unsigned)nb[0] * 73856093u;
      if (d > 1) h ^= (unsigned)nb[1] * 19349663u;
      if (d > 2) h ^= (unsigned)nb[2] * 83492791u;
      const int* bucket =
          buckets + (size_t)(h & (unsigned)(table_size - 1)) * cap;
      for (int slot = 0; slot < cap; ++slot) {
        const int c = bucket[slot];
        if (c >= n) break;  // buckets fill from slot 0; the rest is padding
        const int* pc = point_cells + (size_t)c * d;
        bool match = true;
#pragma unroll
        for (int a = 0; a < kMaxD; ++a) {
          if (a < d) match = match && pc[a] == nb[a];
        }
        if (!match) continue;
        ++my_tests;
        const float* pp = pts + (size_t)c * d;
        float df = __fsub_rn(pp[0], qv[0]);
        float d2 = __fmul_rn(df, df);
#pragma unroll
        for (int a = 1; a < kMaxD; ++a) {
          if (a < d) {
            df = __fsub_rn(pp[a], qv[a]);
            d2 = __fmaf_rn(df, df, d2);
          }
        }
        if (isnan(d2)) d2 = CUDART_INF_F;
        if (c == self || !(d2 <= r2)) continue;
        ++found;
        if (d2 < list.worst) list.push(d2, c, k);
      }
    }
    list.store(out_d2 + (size_t)row * k, out_i + (size_t)row * k, k);
    found_out[row] = found;
    if (unres != nullptr) {
      if (found >= k) {
        res_round[row] = t;
        unres[row] = 0;
      }
      *executed = 1;
    }
  }

  // every thread of the block reaches this point (no early return above);
  // the warp sum stays 64-bit: 32 rows of a one-cell grid test 32 * N
  // candidates, past 2^32 once N > 2^27
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_tests += __shfl_down_sync(0xffffffffu, my_tests, off);
  if ((threadIdx.x & 31) == 0 && my_tests != 0) atomicAdd(tests, my_tests);
}

template <class List>
cudaError_t launch(cudaStream_t stream, const float* pts, const int* buckets,
                   const int* point_cells, const float* origin,
                   const float* inv_cell, const int* res, const float* q,
                   const int* qid, int nq, int n, int d, int table_size,
                   int cap, int k, float r2, float* out_d2, int* out_i,
                   int* found, unsigned char* unres, int* res_round, int t,
                   unsigned long long* tests, int* executed) {
  const dim3 grid((nq + kThreads - 1) / kThreads);
  grid_round_kernel<List><<<grid, kThreads, 0, stream>>>(
      pts, buckets, point_cells, origin, inv_cell, res, q, qid, nq, n, d,
      table_size, cap, k, r2, out_d2, out_i, found, unres, res_round, t, tests,
      executed);
  return cudaGetLastError();
}

}  // namespace

// The C entry point; its contract is in launch.h.
extern "C" int grid_round_launch(const float* pts, const int* buckets,
                                 const int* point_cells, const float* origin,
                                 const float* inv_cell, const int* res,
                                 const float* q, const int* qid, int nq, int n,
                                 int d, int table_size, int cap, int k,
                                 float r2, float* out_d2, int* out_i,
                                 int* found, unsigned char* unres,
                                 int* res_round, int t,
                                 unsigned long long* tests, int* executed,
                                 void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (d < 1 || d > kMaxD || k <= 0 || cap <= 0 || table_size <= 0 ||
      (table_size & (table_size - 1)) != 0)
    return cudaErrorInvalidValue;
  if ((unres == nullptr) != (res_round == nullptr) ||
      (unres == nullptr) != (executed == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8)
    return launch<RegTopK<8>>(s, pts, buckets, point_cells, origin, inv_cell,
                              res, q, qid, nq, n, d, table_size, cap, k, r2,
                              out_d2, out_i, found, unres, res_round, t, tests,
                              executed);
  if (k <= 32)
    return launch<RegTopK<32>>(s, pts, buckets, point_cells, origin, inv_cell,
                               res, q, qid, nq, n, d, table_size, cap, k, r2,
                               out_d2, out_i, found, unres, res_round, t,
                               tests, executed);
  return launch<GlobalTopK>(s, pts, buckets, point_cells, origin, inv_cell,
                            res, q, qid, nq, n, d, table_size, cap, k, r2,
                            out_d2, out_i, found, unres, res_round, t, tests,
                            executed);
}
