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
// gives the reference.  Every design below offers a query's candidates to
// its list in increasing position, each against the list's gate as it
// stands, and places it after every entry of equal d2 (topk_list.cuh), so
// the list holds the k least (d2, position) pairs.  n_tests counts matched
// candidates of finite queries in 64-bit integers (the reference sums them
// in float32).
//
// Two designs, chosen by the wrapper from the grid (core/fixed_radius.py):
//
// * Fine grids (few points a cell; round 0 has about one test a query), in
//   the rows' own order.  k <= 32: one thread a query walks its own stencil
//   through global memory, its list in registers.  k > 32: one warp a
//   query, its lanes over 32 consecutive slots of a bucket at a time, its
//   list kept by the warp (below).  The work is a few bucket, cell and
//   point loads per query, so the bound is bytes.  Sorting the rows by cell
//   first was measured to cost more than it saves here (PERF.md: the keys
//   and the sort cost about half the walk, and the walk over sorted rows is
//   slower, since a scanned cloud's own order is already local and sorted
//   rows gather their queries and scatter their outputs), so this design
//   takes no permutation.
//
// * Coarse grids (many points a cell; the coarsened grids of later rounds,
//   where a res (2, 2, 2) grid makes every query test all N points): the
//   wrapper hands a permutation `perm` of the rows, stable-sorted by the
//   rows' linear cell keys (in fused mode by (resolved, key), so the
//   unresolved rows take the first positions).  Position i works on row
//   perm[i] and writes that row; nothing is reordered.  A block takes a
//   tile of consecutive positions and serves their queries cell by cell
//   (the smallest pending cell key of the block first, one "pass" a cell);
//   it recomputes every query's cell itself, so the order only decides
//   which queries share a block.  In a pass it walks the cell's stencil;
//   each bucket is staged through shared memory in tiles of kPer slots a
//   thread: the block loads the slots with 16-byte loads, does the
//   cell-match test once per slot, and compacts the matched candidates in
//   slot order as float4 (x, y, z, id).  n_tests adds matched slots x the
//   valid queries of the pass per tile.  Here the bound is operations: 2^40
//   tests on 2^20 points move about 0.2 GB but need 3d FP32 flops each.  A
//   block pays the staging of every cell its queries span, so the design
//   pays where many queries share a cell; the wrapper's rule for choosing
//   it is in core/fixed_radius.py.  Two block shapes:
//   - k <= 32: 128 threads, each serving QPT queries (two
//     for k <= 8, which ran faster than one or four on a heaviest-grid
//     round with all, a fifth or a twentieth of the rows) against every
//     staged candidate (all lanes read the same float4: a broadcast), so one
//     shared load serves QPT tests.  The lists live in shared memory
//     (MemTopK), not in registers: the hot loop holds only each query's
//     `gate` (the list's worst, capped by the radius), and a candidate below
//     it takes one rare branch.
//   - k > 32: 256 threads, 8 warps, each warp serving QPW queries with one
//     warp list each (coarse_qpw: four while a list holds at most 8 entries
//     a lane, two at 16, one at 32 and for the row list, as
//     pairwise_topk.cu's first pass; the registers of the lists stay at most
//     64 a thread).  On the counted range's every-row round four beat one
//     query a warp by 2.6-2.9x and two by 1.5-1.6x at k = 64, 128 and 256
//     (PERF.md, an A/B of two builds): each staged tile serves 32 queries,
//     not 8 or 16, and one shared load QPW tests.
//     The lanes take 32 consecutive staged candidates at a time; a chunk in
//     which no lane beats its query's gate costs one vote, and the
//     candidates below a gate are inserted by the whole warp in lane order,
//     which is slot order.  What the walk does not read (each query's row
//     and cell key) sits in shared memory, so the lists and the hot loop
//     fit the registers of warp_blocks() blocks an SM.  A list of a thread
//     in shared or global memory would hold up its warp at every insertion
//     and touch 32 rows at once.
//
// The warp lists (topk_list.cuh): k <= 1024 a WarpTopK<KPL> in registers,
// KPL = 2 ... 32 entries a lane (right-aligned, the gate in lane 31's last
// slot); k > 1024 a RowWarpTopK in the row the list is written to (the
// output row, or the workspace row of a split), a 32-way search for the
// place and coalesced shifts.  Every sync call takes kAllLanes.
//
// Splitting a coarse round (the few-row rounds of the fused loop).  The
// wrapper passes `n_active`, a device count of the rows that run (the
// unresolved rows in fused mode, which the sort puts first).  Each block
// reads it and derives T = the tiles of the active rows and S = the
// largest power of two <= kMaxSplit with T * S <= wave, wave = the split
// kernel's resident blocks an SM (occupancy) x the SMs (1 when T alone
// fills half the card).  The host never learns T or S, so the fused loop
// keeps its single host sync; a caller that wants them (a report, a test)
// passes `plan`, where block 0 of the serving instantiation writes (T, S).
// The host asks grid_round_workspace_rows for the workspace a launch
// needs, so this policy lives here alone.  Each coarse kernel has two instantiations,
// SPLIT = false for S = 1 and true for S > 1, so the unsplit walk carries
// no split state in its registers; where the host cannot know S (fused
// mode) it launches both, over the tiles of all nq rows and over the
// wave, and the blocks of the one whose S the count does not give leave
// at once.  In the split launch block b serves tile b / S and split
// b % S, and blocks past T * S leave.
//  - S = 1: the block walks every tile of every pass and writes the rows
//    directly.
//  - S > 1: in each pass, the pass's tiles are numbered g = 0 .. G - 1 in
//    walk order (the in-range stencil cells in order, each bucket's tiles
//    up to its fill, found by a binary search for its first padding slot),
//    and split s walks g in [G * s / S, G * (s + 1) / S): a contiguous
//    share.  Each pass still does the cell-match test once per slot it
//    stages and adds its n_tests.  The split writes its rows' partial lists
//    and found counts to the workspace (row b * per_block + the query's
//    place in the tile; sized by the host from wave, per_block and k, never
//    from the active count), and grid_round_merge_kernel (a warp a row,
//    topk_list.cuh::warp_merge, as pairwise_topk's merge) merges the S lists
//    of each active row with the earlier split first on equal d2, sums
//    found, and writes the outputs and the fused flags.  Why that order is
//    the unsplit one: a query's candidates all come from its own pass, and
//    the splits cut that pass's walk, which is in increasing position, into
//    contiguous increasing ranges; so every candidate of split s precedes,
//    by position, every candidate of split s + 1, split s's list holds its
//    range's k least (d2, position) pairs, and (d2, split, order within the
//    split) is (d2, position).  Answers, found and n_tests (integer sums)
//    are bitwise those of S = 1 for every S.
//
// Fused mode (unres != null): rows whose unres flag is 0 are skipped and
// left untouched; a row that runs REPLACES its outputs, and when it finds
// >= k neighbours its res_round is set to t and its unres flag cleared.
// Any row that runs sets *executed = 1, which is how the host learns, after
// its single sync, how many scheduled rounds the on-device loop executed.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "launch.h"
#include "topk_list.cuh"

namespace {

using repro_torch::kAllLanes;
using repro_torch::MemTopK;
using repro_torch::RegTopK;
using repro_torch::RowWarpTopK;
using repro_torch::warp_merge;
using repro_torch::WarpTopK;
using repro_torch::with_list;

constexpr int kThreads = 128;   // fine designs: 128 queries, or 4 warps
constexpr int kTThreads = 128;  // coarse design, k <= 32
constexpr int kWThreads = 256;  // coarse design, k > 32: 8 warps
constexpr int kMergeThreads = 128;
constexpr int kPer = 4;  // bucket slots a thread stages per tile
constexpr int kMaxD = 3;  // one Teschner hash prime per axis
constexpr int kMaxStencil = 27;
constexpr int kMaxSplit = 1024;
constexpr long long kNoKey = 0x7fffffffffffffffLL;

// Everything one launch needs; kernels take it by value.
struct Round {
  const float* pts;
  const int* buckets;
  const int* point_cells;
  const float* origin;
  const float* inv_cell;
  const int* res;
  const float* q;
  const int* qid;
  const long long* perm;
  const int* n_active;
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
  float* ws_d;
  int* ws_i;
  int* ws_f;
  int* plan;        // null, or (T, S) as the coarse launch used them
  int wave;         // blocks that fill the card (coarse design)
  int force_split;  // 0: S from the active count; else this S
};

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

// Stencil cell s of the cell cc (stencil_offsets order: meshgrid "ij", the
// last axis fastest) in nb; whether it lies in the grid.
template <int D>
__device__ __forceinline__ bool stencil_cell(int s, const int (&cc)[D],
                                             const int (&rs)[D],
                                             int (&nb)[kMaxD]) {
  bool in_range = true;
#pragma unroll
  for (int a = D; a < kMaxD; ++a) nb[a] = 0;
#pragma unroll
  for (int a = D - 1; a >= 0; --a) {
    nb[a] = cc[a] + (s % 3) - 1;
    s /= 3;
    in_range = in_range && nb[a] >= 0 && nb[a] < rs[a];
  }
  return in_range;
}

// The squared distance as the reference's FMA chain over (p - q), NaN as
// +inf.
template <int D>
__device__ __forceinline__ float dist2(const float4 p, float x, float y,
                                       float z) {
  float df = __fsub_rn(p.x, x);
  float d2 = __fmul_rn(df, df);
  if (D > 1) {
    df = __fsub_rn(p.y, y);
    d2 = __fmaf_rn(df, df, d2);
  }
  if (D > 2) {
    df = __fsub_rn(p.z, z);
    d2 = __fmaf_rn(df, df, d2);
  }
  return fminf(d2, CUDART_INF_F);  // fminf drops a NaN
}

// The list takes a candidate iff it is in radius (d2 <= r2q) and below
// the list's worst; for finite r2q >= 0 that is d2 < min(worst, the float
// just above r2q).  A NaN d2 has been mapped to +inf, which no gate admits;
// a negative or NaN r2q admits nothing.
__device__ __forceinline__ float gate_of(float worst, float r2q) {
  if (!(r2q >= 0.0f)) return -1.0f;
  if (r2q == CUDART_INF_F) return worst;
  return fminf(worst, __uint_as_float(__float_as_uint(r2q) + 1u));
}

// ------------------------------------------------------------ the split

// Rows that run: the device count in fused mode, else all.
__device__ __forceinline__ int active_rows(const Round& a) {
  return a.n_active != nullptr ? min(*a.n_active, a.nq) : a.nq;
}

// S for T active tiles: the largest power of two <= kMaxSplit whose T * S
// blocks fit in `wave` (1 when T alone fills it); force > 0 sets it.
__host__ __device__ __forceinline__ int split_count(long long tiles, int wave,
                                                    int force) {
  if (force > 0) return force;
  int s = 1;
  while (s < kMaxSplit && tiles * s * 2 <= wave) s *= 2;
  return s;
}

// The tiles and S one coarse block derives; block 0 of the instantiation
// that serves S reports them to `plan`.
__device__ __forceinline__ int block_split(const Round& a, int per_block,
                                           int& tiles) {
  tiles = (active_rows(a) + per_block - 1) / per_block;
  return split_count(tiles, a.wave, a.force_split);
}

__device__ __forceinline__ void report_plan(const Round& a, int tiles,
                                            int S) {
  if (a.plan != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    a.plan[0] = tiles;
    a.plan[1] = S;
  }
}

// The first padding slot of a bucket (buckets fill from slot 0).
__device__ __forceinline__ int bucket_fill(const int* bucket, int cap,
                                           int n) {
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bucket[mid] < n) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A split block's tiles of TILE slots in each stencil cell of one pass,
// [s_j[s], s_j[kMaxStencil + s]) for cell s: the pass's tiles up to each
// bucket's fill are numbered g = 0 .. G - 1 in walk order and split
// `split` of S takes [G * split / S, G * (split + 1) / S).  Kept in shared
// memory, so the walk holds no split state in registers.  Called by the
// whole block, after every read of the previous pass's s_j.
template <int D, int TILE>
__device__ __forceinline__ void split_tiles(const Round& a,
                                            const int (&cc)[D],
                                            const int (&rs)[D], int S,
                                            int* s_j) {
  int n_stencil = 1;
#pragma unroll
  for (int i = 0; i < D; ++i) n_stencil *= 3;
  const int s = threadIdx.x;
  int tiles = 0;
  if (s < n_stencil) {
    int nb[kMaxD];
    if (stencil_cell<D>(s, cc, rs, nb)) {
      const unsigned h = teschner(nb, D) & (unsigned)(a.table_size - 1);
      tiles = (bucket_fill(a.buckets + (size_t)h * a.cap, a.cap, a.n) +
               TILE - 1) / TILE;
    }
    s_j[2 * kMaxStencil + s] = tiles;
  }
  __syncthreads();
  if (s < n_stencil) {
    long long first = 0, total = 0;
    for (int i = 0; i < n_stencil; ++i) {
      const int t = s_j[2 * kMaxStencil + i];
      first += i < s ? t : 0;
      total += t;
    }
    const int split = blockIdx.x % S;
    const long long g0 = total * split / S, g1 = total * (split + 1) / S;
    s_j[s] = (int)min(max(g0 - first, 0LL), (long long)tiles);
    s_j[kMaxStencil + s] = (int)min(max(g1 - first, 0LL), (long long)tiles);
  }
  __syncthreads();
}

// Stages the slots [slot0, slot0 + NT * kPer) of a bucket into `cand`:
// thread tid loads slots slot0 + tid * kPer .. + kPer with one 16-byte
// load, tests each live slot's cell against nb once, and the matched
// candidates are compacted in slot order as float4 (x, y, z, id bits).
// Returns the matched count, after a __syncthreads; `ended` says whether a
// slot of the tile was padding, so the bucket ends in it.  Called by the
// whole block; the caller syncs again before the next tile.
template <int D, int NT>
__device__ __forceinline__ int stage_tile(const Round& a, const int* bucket,
                                          int slot0, const int (&nb)[kMaxD],
                                          float4* cand, int* s_cnt,
                                          bool& ended) {
  constexpr int kWarps = NT / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = slot0 + tid * kPer;
  int cs[kPer];
  if (base < a.cap) {
    const int4 v = *reinterpret_cast<const int4*>(bucket + base);
    cs[0] = v.x;
    cs[1] = v.y;
    cs[2] = v.z;
    cs[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r) cs[r] = a.n;
  }
  bool mt[kPer];
  int nm = 0, live = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int c = cs[r];
    const bool lv = c < a.n;  // buckets fill from slot 0
    bool match = lv;
    if (lv) {
#pragma unroll
      for (int x = 0; x < D; ++x)
        match = match && a.point_cells[(size_t)c * D + x] == nb[x];
    }
    mt[r] = match;
    nm += match;
    live += lv;
  }
  // exclusive scan of the per-thread match counts, in slot order
  int incl = nm;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kAllLanes, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_cnt[warp] = incl;
  // a slot that is not live ends the bucket: the rest is padding
  ended = __syncthreads_or(live < kPer);
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
      const float* pp = a.pts + (size_t)c * D;
      cand[at++] = make_float4(pp[0], D > 1 ? pp[1] : 0.0f,
                               D > 2 ? pp[2] : 0.0f, __int_as_float(c));
    }
  }
  __syncthreads();
  return total;
}

// The block's smallest pending cell key (each thread offers its own
// minimum m); kNoKey when no query is pending.  Called by the whole block.
template <int NT>
__device__ __forceinline__ long long block_min_key(long long m,
                                                   long long* s_key) {
  constexpr int kWarps = NT / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(kAllLanes, m, off);
    m = o < m ? o : m;
  }
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = m;
  __syncthreads();
  long long cur = s_key[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) cur = s_key[w] < cur ? s_key[w] : cur;
  __syncthreads();  // s_key is rewritten by the next pass
  return cur;
}

// The fused-mode bookkeeping of a row that ran.
__device__ __forceinline__ void finish_row(const Round& a, int row,
                                           int found) {
  a.found[row] = found;
  if (a.unres != nullptr) {
    if (found >= a.k) {
      a.res_round[row] = a.t;
      a.unres[row] = 0;
    }
    *a.executed = 1;
  }
}

// ------------------------------------------------ fine design, k <= 32

// A fine-design query at a run-time d: its coordinates qv, cell cc and the
// grid's res rs (0, 0 and 1 past d).
__device__ __forceinline__ void fine_query(const Round& a, int row,
                                           float (&qv)[kMaxD],
                                           int (&cc)[kMaxD],
                                           int (&rs)[kMaxD]) {
  const float* qr = a.q + (size_t)row * a.d;
#pragma unroll
  for (int x = 0; x < kMaxD; ++x) {
    if (x < a.d) {
      qv[x] = qr[x];
      rs[x] = a.res[x];
      cc[x] = cell_of(qv[x], a.origin[x], a.inv_cell[x], rs[x]);
    } else {
      qv[x] = 0.0f;
      cc[x] = 0;
      rs[x] = 1;
    }
  }
}

// Stencil cell s of cc at a run-time d (stencil_offsets(d): meshgrid "ij"
// order, the last axis fastest) in nb; whether it lies in the grid.
__device__ __forceinline__ bool fine_stencil_cell(int s, int d,
                                                  const int (&cc)[kMaxD],
                                                  const int (&rs)[kMaxD],
                                                  int (&nb)[kMaxD]) {
  bool in_range = true;
#pragma unroll
  for (int x = kMaxD - 1; x >= 0; --x) {
    if (x < d) {
      nb[x] = cc[x] + (s % 3) - 1;
      s /= 3;
      in_range = in_range && nb[x] >= 0 && nb[x] < rs[x];
    } else {
      nb[x] = 0;
    }
  }
  return in_range;
}

template <class List>
__global__ void __launch_bounds__(kThreads)
grid_round_kernel(const Round a) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active =
      row < a.nq && (a.unres == nullptr || a.unres[row] != 0);
  const int d = a.d, k = a.k, n = a.n;
  unsigned long long my_tests = 0;

  if (active) {
    const int self = a.qid[row];
    float qv[kMaxD];
    int cc[kMaxD], rs[kMaxD];
    fine_query(a, row, qv, cc, rs);
    const bool qvalid = isfinite(qv[0]);  // padding rows count nothing

    List list;
    list.init(nullptr, nullptr, 1, k, n);
    int found = 0;

    int n_stencil = 1;
    for (int x = 0; x < d; ++x) n_stencil *= 3;
    for (int s = 0; s < n_stencil && qvalid; ++s) {
      int nb[kMaxD];
      if (!fine_stencil_cell(s, d, cc, rs, nb)) continue;
      const int* bucket =
          a.buckets +
          (size_t)(teschner(nb, d) & (unsigned)(a.table_size - 1)) * a.cap;
      for (int slot = 0; slot < a.cap; ++slot) {
        const int c = bucket[slot];
        if (c >= n) break;  // buckets fill from slot 0; the rest is padding
        const int* pc = a.point_cells + (size_t)c * d;
        bool match = true;
#pragma unroll
        for (int x = 0; x < kMaxD; ++x) {
          if (x < d) match = match && pc[x] == nb[x];
        }
        if (!match) continue;
        ++my_tests;
        const float* pp = a.pts + (size_t)c * d;
        float df = __fsub_rn(pp[0], qv[0]);
        float d2 = __fmul_rn(df, df);
#pragma unroll
        for (int x = 1; x < kMaxD; ++x) {
          if (x < d) {
            df = __fsub_rn(pp[x], qv[x]);
            d2 = __fmaf_rn(df, df, d2);
          }
        }
        if (isnan(d2)) d2 = CUDART_INF_F;
        if (c == self || !(d2 <= a.r2)) continue;
        ++found;
        if (d2 < list.worst) list.push(d2, c, k);
      }
    }
    list.store(a.out_d2 + (size_t)row * k, a.out_i + (size_t)row * k, k);
    finish_row(a, row, found);
  }

  // every thread of the block reaches this point (no early return above);
  // the warp sum stays 64-bit: 32 rows of a one-cell grid test 32 * N
  // candidates, past 2^32 once N > 2^27
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_tests += __shfl_down_sync(kAllLanes, my_tests, off);
  if ((threadIdx.x & 31) == 0 && my_tests != 0) atomicAdd(a.tests, my_tests);
}

// ------------------------------------------------- fine design, k > 32

// A warp a query, in the rows' own order: for each stencil cell, its lanes
// take 32 consecutive slots of the bucket at a time (one coalesced load),
// test the cells and distances, and the warp inserts the candidates below
// the gate in lane order, which is slot order.
template <class List>
__global__ void __launch_bounds__(kThreads)
grid_round_fine_warp_kernel(const Round a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  // warp-uniform: the whole warp leaves (the kernel has no block sync)
  if (row >= a.nq || (a.unres != nullptr && a.unres[row] == 0)) return;
  const int d = a.d, k = a.k, n = a.n;
  const int self = a.qid[row];
  float qv[kMaxD];
  int cc[kMaxD], rs[kMaxD];
  fine_query(a, row, qv, cc, rs);
  const bool qvalid = isfinite(qv[0]);  // padding rows count nothing
  float* od = a.out_d2 + (size_t)row * k;
  int* oi = a.out_i + (size_t)row * k;
  List list;
  list.init(od, oi, k, lane, n);
  float gate = gate_of(list.gate(), a.r2);
  int found = 0;
  unsigned long long my_tests = 0;

  int n_stencil = 1;
  for (int x = 0; x < d; ++x) n_stencil *= 3;
  for (int s = 0; s < n_stencil && qvalid; ++s) {
    int nb[kMaxD];
    if (!fine_stencil_cell(s, d, cc, rs, nb)) continue;
    const int* bucket =
        a.buckets +
        (size_t)(teschner(nb, d) & (unsigned)(a.table_size - 1)) * a.cap;
    for (int slot0 = 0; slot0 < a.cap; slot0 += 32) {
      const int slot = slot0 + lane;
      const int c = slot < a.cap ? bucket[slot] : n;
      const bool live = c < n;
      bool match = live;
      if (live) {
        const int* pc = a.point_cells + (size_t)c * d;
#pragma unroll
        for (int x = 0; x < kMaxD; ++x) {
          if (x < d) match = match && pc[x] == nb[x];
        }
      }
      float d2 = CUDART_INF_F;
      if (match) {
        const float* pp = a.pts + (size_t)c * d;
        float df = __fsub_rn(pp[0], qv[0]);
        d2 = __fmul_rn(df, df);
#pragma unroll
        for (int x = 1; x < kMaxD; ++x) {
          if (x < d) {
            df = __fsub_rn(pp[x], qv[x]);
            d2 = __fmaf_rn(df, df, d2);
          }
        }
        d2 = fminf(d2, CUDART_INF_F);  // NaN is +inf to the reference
      }
      my_tests += __popc(__ballot_sync(kAllLanes, match));
      found += match && c != self && d2 <= a.r2;
      unsigned todo = __ballot_sync(kAllLanes, match && d2 < gate);
      while (todo != 0) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float dd = __shfl_sync(kAllLanes, d2, src);
        const int gid = __shfl_sync(kAllLanes, c, src);
        if (!(dd < gate) || gid == self) continue;  // warp-uniform
        list.insert(dd, gid, lane);
        gate = gate_of(list.gate(), a.r2);
      }
      // a slot that is not live ends the bucket: the rest is padding
      if (__ballot_sync(kAllLanes, live) != kAllLanes) break;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    found += __shfl_xor_sync(kAllLanes, found, off);
  list.store(od, oi, k, lane);
  if (lane == 0) {
    finish_row(a, row, found);
    if (my_tests != 0) atomicAdd(a.tests, my_tests);
  }
}

// ---------------------------------------------- coarse design, k <= 32

// One query of a coarse-design thread.  A thread's queries are separate
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
  MemTopK list;  // in shared memory
};

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

template <int D, int QPT, int KSM, bool SPLIT>
__global__ void __launch_bounds__(kTThreads)
grid_round_tiled_kernel(const Round a) {
  using S_ = QState;
  constexpr int kTile = kTThreads * kPer;
  constexpr int kPerBlock = kTThreads * QPT;
  __shared__ float4 cand[kTile];  // matched candidates: x, y, z, id bits
  // the queries' lists, slot j of query u at [u * KSM + j][tid]
  __shared__ float s_ld[QPT * KSM][kTThreads];
  __shared__ int s_li[QPT * KSM][kTThreads];
  __shared__ long long s_key[kTThreads / 32];
  __shared__ int s_cnt[kTThreads / 32];
  __shared__ int s_j[3 * kMaxStencil];
  const int tid = threadIdx.x;
  const int k = a.k;

  int tiles;
  const int S = block_split(a, kPerBlock, tiles);
  // the launch holds both instantiations; this one serves S = 1 or S > 1
  if ((S > 1) != SPLIT) return;  // the whole block
  report_plan(a, tiles, S);
  const int tile = SPLIT ? blockIdx.x / S : blockIdx.x;
  if (tile >= tiles) return;

  float org[D], inv[D];
  int rs[D];
#pragma unroll
  for (int x = 0; x < D; ++x) {
    org[x] = a.origin[x];
    inv[x] = a.inv_cell[x];
    rs[x] = a.res[x];
  }

  Pack<S_, QPT> qs;
  qs.each([&](S_& st, int u) {
    const long long pos = (long long)tile * kPerBlock + u * kTThreads + tid;
    st.row = pos < a.nq ? (int)a.perm[pos] : 0;
    st.active = pos < a.nq && (a.unres == nullptr || a.unres[st.row] != 0);
    st.found = 0;
    st.self = st.active ? a.qid[st.row] : -1;
    st.key = kNoKey;
    st.r2q = -1.0f;
    st.gate = -1.0f;
    st.pending = false;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (st.active) {
      long long kk = 0;
#pragma unroll
      for (int x = 0; x < D; ++x) {
        v[x] = a.q[(size_t)st.row * D + x];
        kk = kk * rs[x] + cell_of(v[x], org[x], inv[x], rs[x]);
      }
      st.key = kk;
      st.pending = isfinite(v[0]);  // padding rows count nothing
      st.list.init(&s_ld[u * KSM][tid], &s_li[u * KSM][tid], kTThreads, k,
                   a.n);
    }
    st.x = v[0];
    st.y = v[1];
    st.z = v[2];
  });
  unsigned long long my_tests = 0;

  while (true) {
    long long m = kNoKey;
    qs.each([&](S_& st, int) {
      if (st.pending && st.key < m) m = st.key;
    });
    const long long cur = block_min_key<kTThreads>(m, s_key);
    if (cur == kNoKey) break;

    int cc[D];
    long long rem = cur;
#pragma unroll
    for (int x = D - 1; x >= 0; --x) {
      cc[x] = (int)(rem % rs[x]);
      rem /= rs[x];
    }
    // this pass's queries of the thread: the rest get a radius nothing meets
    unsigned long long nv = 0;
    qs.each([&](S_& st, int) {
      const bool in = st.pending && st.key == cur;
      st.pending = st.pending && !in;
      // -1: no distance (>= 0, or +inf for NaN) is in radius
      st.r2q = in ? a.r2 : -1.0f;
      st.gate = in ? gate_of(st.list.worst, a.r2) : -1.0f;
      nv += in;
    });
    if (SPLIT) split_tiles<D, kTile>(a, cc, rs, S, s_j);

    int n_stencil = 1;
#pragma unroll
    for (int x = 0; x < D; ++x) n_stencil *= 3;
    for (int s = 0; s < n_stencil; ++s) {
      int nb[kMaxD];
      if (!stencil_cell<D>(s, cc, rs, nb)) continue;  // uniform over the block
      const unsigned h = teschner(nb, D) & (unsigned)(a.table_size - 1);
      const int* bucket = a.buckets + (size_t)h * a.cap;
      // S = 1: every tile up to the bucket's first padding slot
      const int j1 =
          SPLIT ? s_j[kMaxStencil + s] : (a.cap + kTile - 1) / kTile;
      for (int j = SPLIT ? s_j[s] : 0; j < j1; ++j) {
        bool ended;
        const int total = stage_tile<D, kTThreads>(a, bucket, j * kTile, nb,
                                                   cand, s_cnt, ended);
        my_tests += (unsigned long long)total * nv;
        for (int c = 0; c < total; ++c) {
          const float4 cd = cand[c];
          const int id = __float_as_int(cd.w);
          // the thread's queries first, with no branch between them; one
          // rare branch then takes the list insertions in query order
          float d2q[QPT];
          bool any = false;
          qs.each([&](S_& st, int u) {
            const float d2 = dist2<D>(cd, st.x, st.y, st.z);
            st.found += (d2 <= st.r2q && id != st.self);
            d2q[u] = d2;
            any = any || d2 < st.gate;
          });
          if (any) {
            qs.each([&](S_& st, int u) {
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

  qs.each([&](S_& st, int u) {
    if (!st.active) return;
    if (!SPLIT) {
      st.list.store(a.out_d2 + (size_t)st.row * k,
                    a.out_i + (size_t)st.row * k, k);
      finish_row(a, st.row, st.found);
    } else {  // a partial list, merged by grid_round_merge_kernel
      const size_t w = (size_t)blockIdx.x * kPerBlock + u * kTThreads + tid;
      st.list.store(a.ws_d + w * k, a.ws_i + w * k, k);
      a.ws_f[w] = st.found;
    }
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_tests += __shfl_down_sync(kAllLanes, my_tests, off);
  if ((tid & 31) == 0 && my_tests != 0) atomicAdd(a.tests, my_tests);
}

// ----------------------------------------------- coarse design, k > 32

// Queries a warp of the coarse k > 32 design serves: four while a list
// holds at most 8 entries a lane, two at 16, else one (the registers of
// QPW lists stay at most 64 a thread).
constexpr int coarse_qpw(int kpl) {
  return kpl == 0 ? 1 : kpl <= 8 ? 4 : kpl == 16 ? 2 : 1;
}

// Resident blocks an SM the coarse k > 32 kernel is compiled for: three
// while four queries' lists hold at most 4 entries a lane (the registers
// of a block's 256 threads then fit 85 a thread), else two (128 a
// thread).  On the counted range's every-row round three ran 1.25x faster
// than two at k = 128, and 3.9x slower at k = 256 and 6% slower at
// k = 1024, where the lists need the registers (PERF.md, an A/B of two
// builds).
constexpr int warp_blocks(int kpl) { return kpl >= 1 && kpl <= 4 ? 3 : 2; }

template <int D, int QPW, class List, bool SPLIT>
__global__ void __launch_bounds__(kWThreads, warp_blocks(List::kPerLane))
grid_round_warp_kernel(const Round a) {
  constexpr int kTile = kWThreads * kPer;
  constexpr int kWarps = kWThreads / 32;
  constexpr int kPerBlock = kWarps * QPW;
  __shared__ float4 cand[kTile];  // matched candidates: x, y, z, id bits
  __shared__ long long s_key[kWarps];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_j[3 * kMaxStencil];
  // what the walk does not read, out of registers: each query's row (-1
  // when it does not run) and cell key (kNoKey once its pass is done)
  __shared__ int s_row[kPerBlock];
  __shared__ long long s_qkey[kPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = a.k;

  int tiles;
  const int S = block_split(a, kPerBlock, tiles);
  // the launch holds both instantiations; this one serves S = 1 or S > 1
  if ((S > 1) != SPLIT) return;  // the whole block
  report_plan(a, tiles, S);
  const int tile = SPLIT ? blockIdx.x / S : blockIdx.x;
  if (tile >= tiles) return;

  float org[D], inv[D];
  int rs[D];
#pragma unroll
  for (int x = 0; x < D; ++x) {
    org[x] = a.origin[x];
    inv[x] = a.inv_cell[x];
    rs[x] = a.res[x];
  }

  // the warp's queries; every value is the same on all its lanes
  float qx[QPW], qy[QPW], qz[QPW], r2q[QPW], gate[QPW];
  int self[QPW], found[QPW];
  List list[QPW];
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const int j = warp * QPW + u;  // the query's place in the tile
    const long long pos = (long long)tile * kPerBlock + j;
    const int row = pos < a.nq ? (int)a.perm[pos] : 0;
    const bool active =
        pos < a.nq && (a.unres == nullptr || a.unres[row] != 0);
    self[u] = active ? a.qid[row] : -1;
    float v[3] = {0.0f, 0.0f, 0.0f};
    long long kk = kNoKey;
    if (active) {
      kk = 0;
#pragma unroll
      for (int x = 0; x < D; ++x) {
        v[x] = a.q[(size_t)row * D + x];
        kk = kk * rs[x] + cell_of(v[x], org[x], inv[x], rs[x]);
      }
      // the list's row: the output row, or the split's workspace row
      const size_t w =
          SPLIT ? (size_t)blockIdx.x * kPerBlock + j : (size_t)row;
      float* od = (SPLIT ? a.ws_d : a.out_d2) + w * k;
      int* oi = (SPLIT ? a.ws_i : a.out_i) + w * k;
      list[u].init(od, oi, k, lane, a.n);
    }
    qx[u] = v[0];
    qy[u] = v[1];
    qz[u] = v[2];
    found[u] = 0;
    r2q[u] = -1.0f;
    gate[u] = -1.0f;
    if (lane == 0) {
      s_row[j] = active ? row : -1;
      // padding rows (non-finite) run no pass and count nothing
      s_qkey[j] = active && isfinite(v[0]) ? kk : kNoKey;
    }
  }
  __syncwarp();
  unsigned long long my_tests = 0;  // lane 0's

  int total = 0;
  // one chunk of 32 staged candidates; whole (a std::bool_constant): all
  // 32 are staged.  Each form has one call site, so both are inlined and
  // the lists stay in registers.
  auto chunk = [&](int c0, auto whole) {
    const bool valid = decltype(whole)::value || c0 + lane < total;
    const float4 cd = cand[valid ? c0 + lane : 0];
    const int id = __float_as_int(cd.w);
    float d2[QPW];
    bool pass = false;
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      d2[u] = dist2<D>(cd, qx[u], qy[u], qz[u]);
      // & and |, not && and ||: predicates, no branches
      found[u] += valid & (d2[u] <= r2q[u]) & (id != self[u]);
      pass = pass | (valid & (d2[u] < gate[u]));
    }
    if (!__any_sync(kAllLanes, pass)) return;
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      unsigned todo = __ballot_sync(kAllLanes, valid && d2[u] < gate[u]);
      while (todo != 0) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float dd = __shfl_sync(kAllLanes, d2[u], src);
        const int gid = __shfl_sync(kAllLanes, id, src);
        if (!(dd < gate[u]) || gid == self[u]) continue;  // warp-uniform
        list[u].insert(dd, gid, lane);
        gate[u] = gate_of(list[u].gate(), r2q[u]);
      }
    }
  };

  while (true) {
    long long m = kNoKey;
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      const long long kq = s_qkey[warp * QPW + u];
      m = kq < m ? kq : m;
    }
    const long long cur = block_min_key<kWThreads>(m, s_key);
    if (cur == kNoKey) break;

    int cc[D];
    long long rem = cur;
#pragma unroll
    for (int x = D - 1; x >= 0; --x) {
      cc[x] = (int)(rem % rs[x]);
      rem /= rs[x];
    }
    // this pass's queries of the warp: the rest get a radius nothing meets
    int nvw = 0;
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      const bool in = s_qkey[warp * QPW + u] == cur;
      __syncwarp();
      if (in && lane == 0) s_qkey[warp * QPW + u] = kNoKey;  // its pass
      r2q[u] = in ? a.r2 : -1.0f;
      // `in` is warp-uniform: the warp calls gate() together, or not at all
      gate[u] = in ? gate_of(list[u].gate(), a.r2) : -1.0f;
      nvw += in;
    }
    __syncwarp();  // the next pass reads s_qkey after lane 0's writes
    if (SPLIT) split_tiles<D, kTile>(a, cc, rs, S, s_j);

    int n_stencil = 1;
#pragma unroll
    for (int x = 0; x < D; ++x) n_stencil *= 3;
    for (int s = 0; s < n_stencil; ++s) {
      int nb[kMaxD];
      if (!stencil_cell<D>(s, cc, rs, nb)) continue;  // uniform over the block
      const unsigned h = teschner(nb, D) & (unsigned)(a.table_size - 1);
      const int* bucket = a.buckets + (size_t)h * a.cap;
      // S = 1: every tile up to the bucket's first padding slot
      const int j1 =
          SPLIT ? s_j[kMaxStencil + s] : (a.cap + kTile - 1) / kTile;
      for (int j = SPLIT ? s_j[s] : 0; j < j1; ++j) {
        bool ended;
        total = stage_tile<D, kWThreads>(a, bucket, j * kTile, nb, cand,
                                         s_cnt, ended);
        if (lane == 0) my_tests += (unsigned long long)total * nvw;
        if (nvw > 0) {  // warp-uniform
          int c0 = 0;
          for (; c0 + 32 <= total; c0 += 32) chunk(c0, std::true_type{});
          if (c0 < total) chunk(c0, std::false_type{});
        }
        __syncthreads();  // cand and s_cnt are rewritten by the next tile
        if (ended) break;
      }
    }
  }

#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const int row = s_row[warp * QPW + u];
    if (row < 0) continue;  // warp-uniform: the query does not run
    int f = found[u];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      f += __shfl_xor_sync(kAllLanes, f, off);
    if (!SPLIT) {
      list[u].store(a.out_d2 + (size_t)row * k, a.out_i + (size_t)row * k, k,
                    lane);
      if (lane == 0) finish_row(a, row, f);
    } else {  // a partial list, merged by grid_round_merge_kernel
      const size_t w = (size_t)blockIdx.x * kPerBlock + warp * QPW + u;
      list[u].store(a.ws_d + w * k, a.ws_i + w * k, k, lane);
      if (lane == 0) a.ws_f[w] = f;
    }
  }
  if (lane == 0 && my_tests != 0) atomicAdd(a.tests, my_tests);
}

// ---------------------------------------------------------- the merge

// After a split coarse launch: a warp a row that ran, over the active
// positions (a grid-stride loop: the host sizes the grid without the
// count).  The S partial lists of the row's tile sit at workspace rows
// (tile * S + s) * per_block + its place in the tile; they are merged with
// the earlier split first on equal d2 (see the header), found summed, and
// the outputs and fused flags written.  Does nothing when S = 1.
template <class List>
__global__ void __launch_bounds__(kMergeThreads)
grid_round_merge_kernel(const Round a, int per_block) {
  const int active = active_rows(a);
  int tiles;
  const int S = block_split(a, per_block, tiles);
  if (S == 1) return;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kMergeThreads / 32);
  const int k = a.k;
  for (int pos = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
       pos < active; pos += warps) {
    const int row = (int)a.perm[pos];
    if (a.unres != nullptr && a.unres[row] == 0) continue;  // warp-uniform
    const int tile = pos / per_block;
    const size_t w0 = (size_t)tile * S * per_block + (pos - tile * per_block);
    int f = 0;
    for (int s = lane; s < S; s += 32) f += a.ws_f[w0 + (size_t)s * per_block];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      f += __shfl_xor_sync(kAllLanes, f, off);
    List list;
    warp_merge(list, a.ws_d + w0 * k, a.ws_i + w0 * k,
               (size_t)per_block * k, S, k, a.n, lane,
               a.out_d2 + (size_t)row * k, a.out_i + (size_t)row * k);
    if (lane == 0) finish_row(a, row, f);
  }
}

// ----------------------------------------------------------- host side

typedef void (*RoundKernel)(const Round);

// Blocks of `kernel` resident on the card at once: its occupancy times the
// SMs, read once a kernel and device.
int wave_of(RoundKernel kernel, int threads, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) !=
            cudaSuccess)
      return 0;
    cache[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  return cache[dev];
}

// The coarse design's two instantiations for (D, k), the one that serves
// S = 1 and the split one: calls f(plain, split, threads, per_block, wave)
// with wave the split kernel's -- the one place where k picks them.
template <int D, class F>
cudaError_t with_coarse_d(int k, F f) {
  if (k <= 8) {
    static int cache[16];
    const RoundKernel split = grid_round_tiled_kernel<D, 2, 8, true>;
    return f(grid_round_tiled_kernel<D, 2, 8, false>, split, kTThreads,
             kTThreads * 2, wave_of(split, kTThreads, cache));
  }
  if (k <= 32) {
    static int cache[16];
    const RoundKernel split = grid_round_tiled_kernel<D, 1, 32, true>;
    return f(grid_round_tiled_kernel<D, 1, 32, false>, split, kTThreads,
             kTThreads, wave_of(split, kTThreads, cache));
  }
  return with_list(k, [&](auto list) {
    using List = decltype(list);
    constexpr int qpw = coarse_qpw(List::kPerLane);
    static int cache[16];
    const RoundKernel split = grid_round_warp_kernel<D, qpw, List, true>;
    return f(grid_round_warp_kernel<D, qpw, List, false>, split, kWThreads,
             kWThreads / 32 * qpw, wave_of(split, kWThreads, cache));
  });
}

template <class F>
cudaError_t with_coarse(int d, int k, F f) {
  switch (d) {
    case 1:
      return with_coarse_d<1>(k, f);
    case 2:
      return with_coarse_d<2>(k, f);
    default:
      return with_coarse_d<3>(k, f);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The blocks of a coarse launch's split instantiation over `tiles` tiles:
// 0 when the host knows S = 1, S blocks a tile when it knows S > 1 (a
// forced S, or all nq rows run), else (fused: only the device knows S) the
// wave.  `known` gets S when the host knows it, else 0.
long long split_blocks(long long tiles, int wave, bool fused, int splits,
                       int& known) {
  known = splits > 0 ? splits : !fused ? split_count(tiles, wave, 0) : 0;
  return known == 1 ? 0 : known > 1 ? tiles * known : wave;
}

}  // namespace

// The C entry points; their contract is in launch.h.
extern "C" int grid_round_workspace_rows(int d, int k, int nq, int fused,
                                         int splits, long long* rows) {
  if (d < 1 || d > kMaxD || k <= 0 || nq < 0 || splits < 0)
    return cudaErrorInvalidValue;
  return with_coarse(d, k, [&](RoundKernel, RoundKernel, int, int per_block,
                               int wave) -> cudaError_t {
    if (wave <= 0) return cudaErrorInvalidDevice;
    int known;
    *rows = split_blocks((nq + per_block - 1) / per_block, wave, fused != 0,
                         splits, known) *
            per_block;
    return cudaSuccess;
  });
}

extern "C" int grid_round_launch(
    const float* pts, const int* buckets, const int* point_cells,
    const float* origin, const float* inv_cell, const int* res,
    const float* q, const int* qid, const long long* perm,
    const int* n_active, int nq, int n, int d, int table_size, int cap, int k,
    float r2, int tiled, float* out_d2, int* out_i, int* found,
    unsigned char* unres, int* res_round, int t, unsigned long long* tests,
    int* executed, float* ws_d, int* ws_i, int* ws_f, long long ws_rows,
    int* plan, int splits, void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (d < 1 || d > kMaxD || k <= 0 || cap <= 0 || table_size <= 0 ||
      (table_size & (table_size - 1)) != 0 || splits < 0)
    return cudaErrorInvalidValue;
  if ((unres == nullptr) != (res_round == nullptr) ||
      (unres == nullptr) != (executed == nullptr))
    return cudaErrorInvalidValue;
  // the coarse design stages buckets with 16-byte loads; the fine design
  // works on the rows in their own order
  if (tiled ? (perm == nullptr || cap % kPer != 0 ||
               reinterpret_cast<uintptr_t>(buckets) % 16 != 0)
            : (perm != nullptr || n_active != nullptr || plan != nullptr ||
               splits != 0))
    return cudaErrorInvalidValue;
  Round a{pts,   buckets, point_cells, origin,   inv_cell, res,     q,
          qid,   perm,    n_active,    nq,       n,        d,       table_size,
          cap,   k,       r2,          out_d2,   out_i,    found,   unres,
          res_round, t,   tests,       executed, ws_d,     ws_i,    ws_f,
          plan,  0,       splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tiled) {
    const int rows_a_block = k <= 32 ? kThreads : kThreads / 32;
    const dim3 grid((nq + rows_a_block - 1) / rows_a_block);
    if (k <= 8) {
      grid_round_kernel<RegTopK<8>><<<grid, kThreads, 0, s>>>(a);
    } else if (k <= 32) {
      grid_round_kernel<RegTopK<32>><<<grid, kThreads, 0, s>>>(a);
    } else {
      with_list(k, [&](auto list) {
        grid_round_fine_warp_kernel<decltype(list)>
            <<<grid, kThreads, 0, s>>>(a);
      });
    }
    return cudaGetLastError();
  }
  return with_coarse(d, k, [&](RoundKernel plain, RoundKernel split,
                               int threads, int per_block,
                               int wave) -> cudaError_t {
    if (wave <= 0) return cudaErrorInvalidDevice;
    a.wave = wave;
    const long long tiles = (nq + per_block - 1) / per_block;
    // S when the host knows it picks one instantiation; else both are
    // launched, and the one whose S the device derives runs while the
    // other's blocks leave
    int known;
    const long long blocks =
        split_blocks(tiles, wave, n_active != nullptr, splits, known);
    void* args[] = {&a};
    if (known <= 1) {
      const cudaError_t err = cudaLaunchKernel(
          reinterpret_cast<const void*>(plain), dim3((unsigned)tiles),
          dim3(threads), args, 0, s);
      if (err != cudaSuccess || known == 1) return err;
    }
    if (ws_d == nullptr || ws_i == nullptr || ws_f == nullptr ||
        ws_rows < blocks * per_block || blocks > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(split),
                                       dim3((unsigned)blocks),
                                       dim3(threads), args, 0, s);
    if (err != cudaSuccess) return err;
    // the merge: a warp a row, at most 8 blocks an SM
    const long long rows = kMergeThreads / 32;
    long long mblocks = (nq + rows - 1) / rows;
    const long long cap_blocks = 8LL * sm_count();
    if (mblocks > cap_blocks) mblocks = cap_blocks;
    with_list(k, [&](auto list) {
      grid_round_merge_kernel<decltype(list)>
          <<<(unsigned)mblocks, kMergeThreads, 0, s>>>(a, per_block);
    });
    return cudaGetLastError();
  });
}
