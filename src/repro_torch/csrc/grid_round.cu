// One fixed-radius round on the spatial hash grid: the paper's RT-core step.
//
// Replaces src/repro/core/fixed_radius.py::_chunk_candidates, the XLA
// grid-stencil round of the JAX reference (no Pallas kernel there: it is
// ported by hand because it is the main path's hot loop).  Done as tensor
// gathers it would build (rows, 3^d * cap, d) candidate blocks per chunk;
// here nothing but the answer is written.
//
// Per query the contract is the reference's: find the query's cell, walk
// the 3^d stencil cells in stencil_offsets order (the last axis fastest)
// and, in each in-range cell, the bucket's slots up to the first padding
// slot.  Per candidate: the exact cell-coordinate match (kills hash
// collisions), the squared distance as an FMA chain over (p - q), then the
// not-self and d2 <= r2 tests (NaN counts as +inf).  `found` counts every
// in-radius candidate; the k best are kept ordered by (d2, candidate
// position), position = stencil index * cap + slot, the order lax.top_k
// gives the reference.  n_tests counts matched candidates of finite queries
// in 64-bit integers (the reference sums them in float32).
//
// Two designs, chosen by the wrapper from the grid (core/fixed_radius.py):
//
// * Fine grids (few points a cell; round 0 has about one test a query):
//   one thread per query, in the rows' own order, walks its own stencil
//   through global memory.  The work is a few bucket, cell and point loads
//   per query, so the bound is bytes.  Sorting the rows by cell first was
//   measured to cost more than it saves here (PERF.md: the keys and the
//   sort cost about half the walk, and the walk over sorted rows is
//   slower, since a scanned cloud's own order is already local and sorted
//   rows gather their queries and scatter their outputs), so this path
//   takes no permutation.
//
// * Coarse grids (many points a cell; the coarsened grids of later rounds,
//   where a res (2, 2, 2) grid makes every query test all N points): the
//   wrapper hands a permutation `perm` of the rows, stable-sorted by the
//   rows' linear cell keys (in fused mode by (resolved, key), so
//   unresolved rows come first).  Position i works on row perm[i] and writes that row;
//   nothing is reordered.  A block takes kTThreads * QPT consecutive
//   positions and serves their queries cell by cell (the smallest pending
//   cell key of the block first); it recomputes every query's cell
//   itself, so the order only decides which queries share a block.  For
//   one cell it walks the stencil; each bucket is staged through shared
//   memory in tiles of kTile slots: the block loads the slots with 16-byte
//   loads, does the cell-match test once per slot, and compacts the
//   matched candidates in slot order as float4 (x, y, z, id).  Every
//   thread then tests its in-cell queries against the tile (all lanes read
//   the same float4: a broadcast), QPT queries a thread (two for k <= 8,
//   which ran faster than one or four on a heaviest-grid round with all,
//   a fifth or a twentieth of the rows), so one shared load serves QPT
//   tests.  The queries' k-best lists live in shared memory, not in
//   registers: the hot loop holds only each query's `gate` (the list's
//   worst, capped by the radius), and a candidate below it takes one rare
//   branch.  n_tests adds matched slots x valid in-cell queries per tile.
//   Here the bound is operations: 2^40 tests on 2^20 points move about
//   0.2 GB but need 3d FP32 flops each.  A block pays the staging of every
//   cell its queries span, so the design pays where many queries share a
//   cell; the wrapper's rule for choosing it is in core/fixed_radius.py.
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

using repro_torch::MemTopK;
using repro_torch::RegTopK;

constexpr int kThreads = 128;   // fine path
constexpr int kTThreads = 128;  // coarse path
constexpr int kPer = 4;         // bucket slots a thread stages per tile
constexpr int kTile = kTThreads * kPer;
constexpr int kWarps = kTThreads / 32;
constexpr int kMaxD = 3;  // one Teschner hash prime per axis
constexpr long long kNoKey = 0x7fffffffffffffffLL;

__device__ __forceinline__ unsigned teschner(const int* nb, int d) {
  unsigned h = (unsigned)nb[0] * 73856093u;
  if (d > 1) h ^= (unsigned)nb[1] * 19349663u;
  if (d > 2) h ^= (unsigned)nb[2] * 83492791u;
  return h;
}

// The reference's cell of one coordinate: floor((q - origin) * inv_cell),
// then its saturating int32 convert + clip, done as a float clamp
// (res <= 2^20 is exact in float32).  Non-finite coordinates count as 0.
__device__ __forceinline__ int cell_of(float v, float org, float inv, int rs) {
  const float qf = isfinite(v) ? v : 0.0f;
  float c = floorf(__fmul_rn(__fsub_rn(qf, org), inv));
  c = fminf(fmaxf(c, 0.0f), (float)(rs - 1));
  return (int)c;
}

// ---------------------------------------------------------------- fine path

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
        rs[a] = res[a];
        cc[a] = cell_of(qv[a], origin[a], inv_cell[a], rs[a]);
      } else {
        qv[a] = 0.0f;
        cc[a] = 0;
        rs[a] = 1;
      }
    }
    const bool qvalid = isfinite(qv[0]);  // padding rows count nothing

    List list;
    list.init(out_d2 + (size_t)row * k, out_i + (size_t)row * k, 1, k, n);
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
      const int* bucket =
          buckets + (size_t)(teschner(nb, d) & (unsigned)(table_size - 1)) * cap;
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

// -------------------------------------------------------------- coarse path

// One query of a coarse-path thread.  A thread's queries are separate
// struct members (Pack), not an array: nvcc keeps only a small budget of
// local arrays in registers and puts the rest in local memory.
struct QState {
  float x, y, z;  // coordinates, 0 past d
  float r2q;      // this pass's squared radius; -1 (nothing in radius) when
                  // the query is not in the pass's cell
  float gate;     // a candidate may enter the list only below this: the
                  // list's worst, and just above r2q (see gate_of)
  bool active, pending;
  int row, self, found;
  long long key;
  MemTopK list;  // in shared memory, or in the output row when k > 32
};

// The list takes a candidate iff it is in radius (d2 <= r2q) and below
// the list's worst; for finite r2q >= 0 that is d2 < min(worst, the float
// just above r2q).  A NaN d2 has been mapped to +inf, which no gate admits;
// a negative or NaN r2q admits nothing.
__device__ __forceinline__ float gate_of(float worst, float r2q) {
  if (!(r2q >= 0.0f)) return -1.0f;
  if (r2q == CUDART_INF_F) return worst;
  return fminf(worst, __uint_as_float(__float_as_uint(r2q) + 1u));
}

template <class S, int QPT>
struct Pack;
template <class S>
struct Pack<S, 1> {
  S s0;
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(s0, 0);
  }
};
template <class S>
struct Pack<S, 2> {
  S s0, s1;
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(s0, 0);
    f(s1, 1);
  }
};

template <int D, int QPT, int KSM>
__global__ void __launch_bounds__(kTThreads)
grid_round_tiled_kernel(const float* __restrict__ pts,
                        const int* __restrict__ buckets,
                        const int* __restrict__ point_cells,
                        const float* __restrict__ origin,
                        const float* __restrict__ inv_cell,
                        const int* __restrict__ res,
                        const float* __restrict__ q,
                        const int* __restrict__ qid,
                        const long long* __restrict__ perm, int nq, int n,
                        int table_size, int cap, int k, float r2,
                        float* __restrict__ out_d2, int* __restrict__ out_i,
                        int* __restrict__ found_out,
                        unsigned char* __restrict__ unres,
                        int* __restrict__ res_round, int t,
                        unsigned long long* __restrict__ tests,
                        int* __restrict__ executed) {
  using S = QState;
  __shared__ float4 cand[kTile];  // matched candidates: x, y, z, id bits
  // the queries' lists, slot j of query u at [u * KSM + j][tid]; with
  // KSM = 0 the lists live in the output rows
  constexpr int kSlots = QPT * KSM > 0 ? QPT * KSM : 1;
  __shared__ float s_ld[kSlots][kTThreads];
  __shared__ int s_li[kSlots][kTThreads];
  __shared__ long long s_key[kWarps];
  __shared__ int s_cnt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float org[D], inv[D];
  int rs[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    org[a] = origin[a];
    inv[a] = inv_cell[a];
    rs[a] = res[a];
  }

  Pack<S, QPT> qs;
  qs.each([&](S& st, int u) {
    const long long pos =
        (long long)blockIdx.x * (kTThreads * QPT) + u * kTThreads + tid;
    st.row = pos < nq ? (int)perm[pos] : 0;
    st.active = pos < nq && (unres == nullptr || unres[st.row] != 0);
    st.found = 0;
    st.self = st.active ? qid[st.row] : -1;
    st.key = kNoKey;
    st.r2q = -1.0f;
    st.gate = -1.0f;
    st.pending = false;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (st.active) {
      long long kk = 0;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        v[a] = q[(size_t)st.row * D + a];
        kk = kk * rs[a] + cell_of(v[a], org[a], inv[a], rs[a]);
      }
      st.key = kk;
      st.pending = isfinite(v[0]);  // padding rows count nothing
      if (KSM > 0)
        st.list.init(&s_ld[u * KSM][tid], &s_li[u * KSM][tid], kTThreads, k,
                     n);
      else
        st.list.init(out_d2 + (size_t)st.row * k, out_i + (size_t)st.row * k,
                     1, k, n);
    }
    st.x = v[0];
    st.y = v[1];
    st.z = v[2];
  });
  unsigned long long my_tests = 0;

  while (true) {
    // the block's smallest pending cell key
    long long m = kNoKey;
    qs.each([&](S& st, int) {
      if (st.pending && st.key < m) m = st.key;
    });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long o = __shfl_xor_sync(0xffffffffu, m, off);
      m = o < m ? o : m;
    }
    if (lane == 0) s_key[warp] = m;
    __syncthreads();
    long long cur = s_key[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) cur = s_key[w] < cur ? s_key[w] : cur;
    __syncthreads();  // s_key is rewritten by the next pass
    if (cur == kNoKey) break;

    int cc[D];
    long long rem = cur;
#pragma unroll
    for (int a = D - 1; a >= 0; --a) {
      cc[a] = (int)(rem % rs[a]);
      rem /= rs[a];
    }
    // this pass's queries of the thread: the rest get a radius nothing meets
    unsigned long long nv = 0;
    qs.each([&](S& st, int) {
      const bool in = st.pending && st.key == cur;
      st.pending = st.pending && !in;
      // -1: no distance (>= 0, or +inf for NaN) is in radius
      st.r2q = in ? r2 : -1.0f;
      st.gate = in ? gate_of(st.list.worst, r2) : -1.0f;
      nv += in;
    });

    int n_stencil = 1;
#pragma unroll
    for (int a = 0; a < D; ++a) n_stencil *= 3;
    for (int s = 0; s < n_stencil; ++s) {
      int nb[kMaxD] = {0, 0, 0};
      int srem = s;
      bool in_range = true;
#pragma unroll
      for (int a = D - 1; a >= 0; --a) {
        nb[a] = cc[a] + (srem % 3) - 1;
        srem /= 3;
        in_range = in_range && nb[a] >= 0 && nb[a] < rs[a];
      }
      if (!in_range) continue;  // uniform over the block
      const unsigned h = teschner(nb, D) & (unsigned)(table_size - 1);
      const int* bucket = buckets + (size_t)h * cap;
      for (int slot0 = 0; slot0 < cap; slot0 += kTile) {
        // stage: thread tid takes slots [slot0 + tid * kPer, + kPer)
        const int base = slot0 + tid * kPer;
        int cs[kPer];
        if (base < cap) {
          const int4 v = *reinterpret_cast<const int4*>(bucket + base);
          cs[0] = v.x;
          cs[1] = v.y;
          cs[2] = v.z;
          cs[3] = v.w;
        } else {
#pragma unroll
          for (int r = 0; r < kPer; ++r) cs[r] = n;
        }
        bool mt[kPer];
        int nm = 0, live = 0;
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int c = cs[r];
          const bool lv = c < n;  // buckets fill from slot 0
          bool match = lv;
          if (lv) {
#pragma unroll
            for (int a = 0; a < D; ++a)
              match = match && point_cells[(size_t)c * D + a] == nb[a];
          }
          mt[r] = match;
          nm += match;
          live += lv;
        }
        // exclusive scan of the per-thread match counts, in slot order
        int incl = nm;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += o;
        }
        if (lane == 31) s_cnt[warp] = incl;
        // a slot that is not live ends the bucket: the rest is padding
        const int ended = __syncthreads_or(live < kPer);
        int at = incl - nm, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int cw = s_cnt[w];
          if (w < warp) at += cw;
          total += cw;
        }
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          if (mt[r]) {
            const int c = cs[r];
            const float* pp = pts + (size_t)c * D;
            cand[at++] = make_float4(pp[0], D > 1 ? pp[1] : 0.0f,
                                     D > 2 ? pp[2] : 0.0f, __int_as_float(c));
          }
        }
        __syncthreads();
        my_tests += (unsigned long long)total * nv;
        for (int j = 0; j < total; ++j) {
          const float4 cd = cand[j];
          const int id = __float_as_int(cd.w);
          // the thread's queries first, with no branch between them; one
          // rare branch then takes the list insertions in query order
          float d2q[QPT];
          bool any = false;
          qs.each([&](S& st, int u) {
            float df = __fsub_rn(cd.x, st.x);
            float d2 = __fmul_rn(df, df);
            if (D > 1) {
              df = __fsub_rn(cd.y, st.y);
              d2 = __fmaf_rn(df, df, d2);
            }
            if (D > 2) {
              df = __fsub_rn(cd.z, st.z);
              d2 = __fmaf_rn(df, df, d2);
            }
            d2 = fminf(d2, CUDART_INF_F);  // NaN is +inf to the reference
            st.found += (d2 <= st.r2q && id != st.self);
            d2q[u] = d2;
            any = any || d2 < st.gate;
          });
          if (any) {
            qs.each([&](S& st, int u) {
              if (d2q[u] < st.gate && id != st.self) {
                st.list.push(d2q[u], id, k);
                st.gate = gate_of(st.list.worst, st.r2q);
              }
            });
          }
        }
        __syncthreads();  // cand and s_cnt are rewritten by the next tile
        if (ended) break;
      }
    }
  }

  qs.each([&](S& st, int) {
    if (!st.active) return;
    st.list.store(out_d2 + (size_t)st.row * k, out_i + (size_t)st.row * k, k);
    found_out[st.row] = st.found;
    if (unres != nullptr) {
      if (st.found >= k) {
        res_round[st.row] = t;
        unres[st.row] = 0;
      }
      *executed = 1;
    }
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_tests += __shfl_down_sync(0xffffffffu, my_tests, off);
  if (lane == 0 && my_tests != 0) atomicAdd(tests, my_tests);
}

struct Args {
  const float* pts;
  const int* buckets;
  const int* point_cells;
  const float* origin;
  const float* inv_cell;
  const int* res;
  const float* q;
  const int* qid;
  const long long* perm;
  int nq, n, d, table_size, cap, k;
  float r2;
  float* out_d2;
  int* out_i;
  int* found;
  unsigned char* unres;
  int* res_round;
  int t;
  unsigned long long* tests;
  int* executed;
};

template <class List>
cudaError_t launch_fine(cudaStream_t stream, const Args& a) {
  const dim3 grid((a.nq + kThreads - 1) / kThreads);
  grid_round_kernel<List><<<grid, kThreads, 0, stream>>>(
      a.pts, a.buckets, a.point_cells, a.origin, a.inv_cell, a.res, a.q,
      a.qid, a.nq, a.n, a.d, a.table_size, a.cap, a.k, a.r2, a.out_d2,
      a.out_i, a.found, a.unres, a.res_round, a.t, a.tests, a.executed);
  return cudaGetLastError();
}

template <int D, int QPT, int KSM>
cudaError_t launch_tiled_d(cudaStream_t stream, const Args& a) {
  const int per_block = kTThreads * QPT;
  const dim3 grid((a.nq + per_block - 1) / per_block);
  grid_round_tiled_kernel<D, QPT, KSM><<<grid, kTThreads, 0, stream>>>(
      a.pts, a.buckets, a.point_cells, a.origin, a.inv_cell, a.res, a.q,
      a.qid, a.perm, a.nq, a.n, a.table_size, a.cap, a.k, a.r2, a.out_d2,
      a.out_i, a.found, a.unres, a.res_round, a.t, a.tests, a.executed);
  return cudaGetLastError();
}

template <int QPT, int KSM>
cudaError_t launch_tiled(cudaStream_t stream, const Args& a) {
  switch (a.d) {
    case 1:
      return launch_tiled_d<1, QPT, KSM>(stream, a);
    case 2:
      return launch_tiled_d<2, QPT, KSM>(stream, a);
    default:
      return launch_tiled_d<3, QPT, KSM>(stream, a);
  }
}

}  // namespace

// The C entry point; its contract is in launch.h.
extern "C" int grid_round_launch(const float* pts, const int* buckets,
                                 const int* point_cells, const float* origin,
                                 const float* inv_cell, const int* res,
                                 const float* q, const int* qid,
                                 const long long* perm, int nq, int n, int d,
                                 int table_size, int cap, int k, float r2,
                                 int tiled, float* out_d2, int* out_i,
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
  // the coarse path stages buckets with 16-byte loads; the fine path
  // works on the rows in their own order
  if (tiled ? (perm == nullptr || cap % kPer != 0 ||
               reinterpret_cast<uintptr_t>(buckets) % 16 != 0)
            : perm != nullptr)
    return cudaErrorInvalidValue;
  const Args a{pts, buckets, point_cells, origin, inv_cell, res, q, qid,
               perm, nq, n, d, table_size, cap, k, r2, out_d2, out_i, found,
               unres, res_round, t, tests, executed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) {
    if (k <= 8) return launch_tiled<2, 8>(s, a);
    if (k <= 32) return launch_tiled<1, 32>(s, a);
    return launch_tiled<1, 0>(s, a);
  }
  if (k <= 8) return launch_fine<RegTopK<8>>(s, a);
  if (k <= 32) return launch_fine<RegTopK<32>>(s, a);
  return launch_fine<MemTopK>(s, a);
}
