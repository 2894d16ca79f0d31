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
// * The sub-grid walk, a third design for the grids the wrapper's sizing
//   probe coarsened (core/grid.py::SubGrid; the wrapper takes it where a
//   grid carries one that covers the round's radius, in the fused loop
//   always and elsewhere where the sub-grid's estimate of distances a row
//   beats the reference's tests).  There a reference
//   stencil holds up to every point of the cloud, while the answer lies
//   within r.  The walk finds candidates through the cap-free sub-grid of
//   cells of about the build radius: a row walks its 3^d sub-cells, each
//   column's three cells on the last axis one contiguous range of float4
//   (x, y, z, id) (the column's cells found through a dense column table
//   and a binary search in the column), computes d2 as the reference's FMA
//   chain, and keeps a candidate only if it is in radius, not the row
//   itself, and in the reference's stencil (its reference cell within one
//   of the query's on every axis).  The sub-grid holds every point such a
//   round can keep (the bound is in SubGrid's docstring).  Candidates come
//   in no position order, so the list compares the reference's order
//   explicitly: a 64-bit key of (d2 bits, the stencil index of the
//   candidate's reference cell, its index), which is (d2, position) since
//   a bucket holds a cell's points in index order.  n_tests are the
//   reference's: for each in-range stencil column the points of its
//   (clamped) last-axis cells, one range of the reference's sorted cell
//   keys, from cumulative counts made at build.  The work is the distances
//   to the points of 3^d cells of about r (about 10^2 a row on the
//   benchmark's clouds, against up to N in a reference stencil), and
//   `evaluated` counts them.  The wrapper sorts the rows by sub-cell (the
//   rows that run first; once a search, whose later walks keep the order),
//   so a warp's rows share cells; a
//   thread a row keeps k <= 32 keys in registers (KeyRegTopK), a warp a row
//   above (KeyWarpTopK, its lanes over 32 consecutive candidates).  A row
//   with more candidates than that walk takes (kThreadWalkMax,
//   kWarpWalkMax) is queued on the device instead, and launches of their
//   own walk each queued row with a warp (up to kWarpWalkMax) or a block
//   of 16 warps, whose lists are merged in shared memory: the rows that
//   resolve only at large radii hold 10^4 to 10^6 candidates, and one
//   thread walking them alone held whole rounds up for 15-200 ms on the
//   H100 (PERF.md).
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
using repro_torch::KeyRegTopK;
using repro_torch::KeyWarpTopK;
using repro_torch::kKeyIndexBits;
using repro_torch::MemTopK;
using repro_torch::RegTopK;
using repro_torch::RowWarpTopK;
using repro_torch::warp_merge;
using repro_torch::WarpTopK;
using repro_torch::with_key_list;
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

// ------------------------------------------------------ the sub-grid walk

// What the walk reads beside Round: the sub-grid and the reference's
// per-cell counts (core/grid.py::SubGrid).
struct Walk {
  const float4* pts;      // (m,) x, y, z, index bits, sorted by sub-cell
  const int* cell_start;  // (cells + 1,) each occupied sub-cell's first row
  const int* cell_z;      // (cells,) its last-axis coordinate
  const int* col_start;   // (cols + 1,) each column's first occupied cell
  const float* origin;
  const float* inv_cell;
  const int* res;
  const long long* ref_keys;  // (n_ref,) the reference's occupied cells
  const long long* ref_cum;   // (n_ref + 1,) their points, summed
  int n_ref;
  unsigned long long* evaluated;  // distances computed, or null
  // the rows left to a wider walk: queue 0 to the warp walk, 1 to the
  // block walk, each (nq,) rows at queue_rows + q * nq, counted (from 0 at
  // the launch) at queue_count[q]
  int* queue_rows;
  int* queue_count;
  bool from_queue;  // the warp walk takes queue 0's rows, not positions
};

// Most candidates a row's thread walks (k <= 32) or its warp; a row with
// more goes to the warp walk or the block walk, so that no round waits on
// one thread or warp walking tens of thousands of points.  Rows on the
// benchmark's clouds hold about 10^2 (PERF.md), a few up to 10^6.
constexpr int kThreadWalkMax = 512;
constexpr int kWarpWalkMax = 8192;
constexpr int kBlockThreads = 512;  // the block walk: 16 warps a row
// From this many rows that run, a thread walks rows up to kWarpWalkMax
// itself: the card is full of threads, and the threads of one sub-cell
// read the same candidates at once (an every-row round on kitti's map at
// 1,850 candidates a row took 9.9 ms so and 17.3 ms with such rows queued).
constexpr int kManyRows = 1 << 16;

// The first position in [lo, hi) whose value is >= x (hi where none);
// v is sorted there.
template <class T>
__device__ __forceinline__ int lower_bound(const T* v, int lo, int hi, T x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A walk row: its coordinates, its reference cell cc in the reference's
// res rs, and its sub-cell sc in the sub-grid's res ss (0, 0, 1 past d).
struct WalkRow {
  float qv[kMaxD];
  int cc[kMaxD], rs[kMaxD], sc[kMaxD], ss[kMaxD];
  bool finite;  // every coordinate finite: only such a row finds points
};

__device__ __forceinline__ void walk_row(const Round& a, const Walk& w,
                                         int row, WalkRow& r) {
  fine_query(a, row, r.qv, r.cc, r.rs);
  r.finite = true;
#pragma unroll
  for (int x = 0; x < kMaxD; ++x) {
    if (x < a.d) {
      r.finite = r.finite && isfinite(r.qv[x]);
      r.ss[x] = w.res[x];
      r.sc[x] = cell_of(r.qv[x], w.origin[x], w.inv_cell[x], r.ss[x]);
    } else {
      r.sc[x] = 0;
      r.ss[x] = 1;
    }
  }
}

// Column o (stencil_offsets(d - 1) order) of the cell c in a grid of res
// rs: its linear key over the first d - 1 axes (the last of them
// fastest), and whether it lies in the grid.
__device__ __forceinline__ bool stencil_column(int o, int d,
                                               const int (&c)[kMaxD],
                                               const int (&rs)[kMaxD],
                                               long long& col) {
  int nb[kMaxD];
  bool in = true;
#pragma unroll
  for (int x = kMaxD - 1; x >= 0; --x) {
    if (x < d - 1) {
      nb[x] = c[x] + o % 3 - 1;
      o /= 3;
      in = in && nb[x] >= 0 && nb[x] < rs[x];
    }
  }
  col = 0;
#pragma unroll
  for (int x = 0; x < kMaxD; ++x) {
    if (x < d - 1) col = col * rs[x] + nb[x];
  }
  return in;
}

// The reference's tests of a row: the points of its in-range stencil
// cells.  In each in-range column the cells of the last axis's three
// coordinates around the row's (clamped to the grid) are one range of
// the sorted keys, whose points the cumulative counts give.
__device__ __forceinline__ unsigned long long ref_tests(const Round& a,
                                                        const Walk& w,
                                                        const WalkRow& r,
                                                        int n_col) {
  const int last = a.d - 1;
  const int zlo = max(r.cc[last] - 1, 0);
  const int zhi = min(r.cc[last] + 1, r.rs[last] - 1);
  unsigned long long t = 0;
  if (zlo > zhi) return t;  // the row's cell lies outside the grid
  for (int o = 0; o < n_col; ++o) {
    long long col;
    if (!stencil_column(o, a.d, r.cc, r.rs, col)) continue;
    const long long base = col * r.rs[last];
    const int lo = lower_bound(w.ref_keys, 0, w.n_ref, base + zlo);
    const int hi = lower_bound(w.ref_keys, lo, w.n_ref, base + zhi + 1);
    t += (unsigned long long)(w.ref_cum[hi] - w.ref_cum[lo]);
  }
  return t;
}

// Column o of the row's sub-stencil: [b, e) in w.pts, the points of the
// column's occupied sub-cells at the row's last-axis coordinate +-1;
// false where the column lies outside the sub-grid or holds none.
__device__ __forceinline__ bool walk_column(const Round& a, const Walk& w,
                                            const WalkRow& r, int o, int& b,
                                            int& e) {
  long long col;
  if (!stencil_column(o, a.d, r.sc, r.ss, col)) return false;
  const int c0 = w.col_start[col], c1 = w.col_start[col + 1];
  const int z = r.sc[a.d - 1];
  const int lo = lower_bound(w.cell_z, c0, c1, z - 1);
  const int hi = lower_bound(w.cell_z, lo, c1, z + 2);
  b = w.cell_start[lo];
  e = w.cell_start[hi];
  return b < e;
}

// The candidates of the row's sub-stencil (the walk's distances).
__device__ __forceinline__ int walk_count(const Round& a, const Walk& w,
                                          const WalkRow& r, int n_col) {
  int total = 0;
  for (int o = 0; o < n_col && r.finite; ++o) {
    int b, e;
    if (walk_column(a, w, r, o, b, e)) total += e - b;
  }
  return total;
}

// A row with more candidates than its walk takes (`most`): queued for the
// warp walk or the block walk, which write its outputs.
__device__ __forceinline__ bool leave_row(const Round& a, const Walk& w,
                                          int row, int count, int most) {
  if (count <= most) return false;
  const int q = count <= kWarpWalkMax ? 0 : 1;
  w.queue_rows[(size_t)q * a.nq + atomicAdd(w.queue_count + q, 1)] = row;
  return true;
}

// A candidate the walk keeps: in radius, not the row itself, and in the
// reference stencil of the row's cell (its cell in range and within one of
// the row's on every axis); then its key, (d2 bits, stencil
// index of its reference cell, index): the reference's (d2, position)
// order, for d2 >= 0.
__device__ __forceinline__ bool walk_keep(const Round& a, const WalkRow& r,
                                          const float4 p, int self,
                                          unsigned long long& key) {
  float df = __fsub_rn(p.x, r.qv[0]);
  float d2 = __fmul_rn(df, df);
  if (a.d > 1) {
    df = __fsub_rn(p.y, r.qv[1]);
    d2 = __fmaf_rn(df, df, d2);
  }
  if (a.d > 2) {
    df = __fsub_rn(p.z, r.qv[2]);
    d2 = __fmaf_rn(df, df, d2);
  }
  if (!(d2 <= a.r2)) return false;
  const int id = __float_as_int(p.w);
  if (id == self) return false;
  const int* pc = a.point_cells + (size_t)id * a.d;
  int s = 0;
#pragma unroll
  for (int x = 0; x < kMaxD; ++x) {
    if (x < a.d) {
      const int o = pc[x] - r.cc[x];
      if (o < -1 || o > 1 || pc[x] < 0 || pc[x] >= r.rs[x]) return false;
      s = s * 3 + o + 1;
    }
  }
  key = ((unsigned long long)__float_as_uint(d2) << 32) |
        ((unsigned long long)s << kKeyIndexBits) | (unsigned)id;
  return true;
}

// A warp's share of one column's candidates: lane l takes w.pts[i] for i =
// i0, i0 + stride, ... below e (i0 = the range's start + the warp's place +
// l), and the warp inserts those below its list's gate.
template <class List>
__device__ __forceinline__ void walk_range(const Round& a, const Walk& w,
                                           const WalkRow& r, int self,
                                           int i0, int e, int stride,
                                           List& list, int& found,
                                           int lane) {
  unsigned long long gate = list.gate();
  // every lane runs the same number of steps: a ballot each
  for (int base = i0 - lane; base < e; base += stride) {
    const int i = base + lane;
    unsigned long long key = 0;
    const bool keep = i < e && walk_keep(a, r, w.pts[i], self, key);
    found += keep;
    unsigned todo = __ballot_sync(kAllLanes, keep && key < gate);
    while (todo != 0) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned long long kk = __shfl_sync(kAllLanes, key, src);
      if (!(kk < gate)) continue;  // warp-uniform
      list.insert(kk, lane);
      gate = list.gate();
    }
  }
}

// k <= 32: a thread a row, its keys in registers.  Position pos serves row
// perm[pos].  A row with more candidates than kThreadWalkMax (kWarpWalkMax
// in a round of kManyRows rows or more) is queued for a wider walk.
template <int KCAP>
__global__ void __launch_bounds__(kThreads)
grid_round_walk_kernel(const Round a, const Walk w) {
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  const int row = pos < a.nq ? (int)a.perm[pos] : 0;
  const bool active =
      pos < a.nq && (a.unres == nullptr || a.unres[row] != 0);
  unsigned long long my_tests = 0, my_eval = 0;
  if (active) {
    WalkRow r;
    walk_row(a, w, row, r);
    const int self = a.qid[row];
    int n_col = 1;
    for (int x = 1; x < a.d; ++x) n_col *= 3;
    if (isfinite(r.qv[0])) my_tests = ref_tests(a, w, r, n_col);
    const int count = walk_count(a, w, r, n_col);
    const int most =
        active_rows(a) >= kManyRows ? kWarpWalkMax : kThreadWalkMax;
    if (!leave_row(a, w, row, count, most)) {
      KeyRegTopK<KCAP> list;
      list.init();
      int found = 0;
      my_eval = count;
      for (int o = 0; o < n_col && r.finite; ++o) {
        int b, e;
        if (!walk_column(a, w, r, o, b, e)) continue;
        for (int i = b; i < e; ++i) {
          unsigned long long key;
          if (!walk_keep(a, r, w.pts[i], self, key)) continue;
          ++found;
          if (key < list.worst) list.push(key, a.k);
        }
      }
      list.store(a.out_d2 + (size_t)row * a.k, a.out_i + (size_t)row * a.k,
                 a.k, a.n);
      finish_row(a, row, found);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    my_tests += __shfl_down_sync(kAllLanes, my_tests, off);
    my_eval += __shfl_down_sync(kAllLanes, my_eval, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (my_tests != 0) atomicAdd(a.tests, my_tests);
    if (my_eval != 0 && w.evaluated != nullptr)
      atomicAdd(w.evaluated, my_eval);
  }
}

// One row of the warp walk (called by the whole warp).
template <class List>
__device__ __forceinline__ void walk_warp_row(const Round& a, const Walk& w,
                                              int row, int lane) {
  WalkRow r;
  walk_row(a, w, row, r);
  const int self = a.qid[row];
  int n_col = 1;
  for (int x = 1; x < a.d; ++x) n_col *= 3;
  if (lane == 0 && !w.from_queue) {
    const unsigned long long t =
        isfinite(r.qv[0]) ? ref_tests(a, w, r, n_col) : 0;
    if (t != 0) atomicAdd(a.tests, t);
  }
  const int count = walk_count(a, w, r, n_col);
  bool left = false;
  if (lane == 0) left = leave_row(a, w, row, count, kWarpWalkMax);
  if (__shfl_sync(kAllLanes, left, 0)) return;  // the whole warp
  List list;
  list.init(a.k, lane);
  int found = 0;
  for (int o = 0; o < n_col && r.finite; ++o) {
    int b, e;
    if (!walk_column(a, w, r, o, b, e)) continue;
    walk_range(a, w, r, self, b + lane, e, 32, list, found, lane);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    found += __shfl_xor_sync(kAllLanes, found, off);
  list.store(a.out_d2 + (size_t)row * a.k, a.out_i + (size_t)row * a.k, a.k,
             lane, a.n);
  if (lane == 0) {
    finish_row(a, row, found);
    if (count != 0 && w.evaluated != nullptr) atomicAdd(w.evaluated, count);
  }
}

// A warp a row: k > 32 over the positions (row perm[pos]), or, with
// w.from_queue, over the rows the thread walk queued (then every warp
// takes queued rows in turn, and their n_tests are counted already).  Its
// lanes take 32 consecutive candidates of a column's range at a time, and
// the warp inserts those below the gate.
template <class List>
__global__ void __launch_bounds__(kThreads)
grid_round_walk_warp_kernel(const Round a, const Walk w) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const int items = w.from_queue ? *w.queue_count : a.nq;
  // warp-uniform: the whole warp takes an item or leaves
  for (int item = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       item < items; item += warps) {
    const int row = w.from_queue ? w.queue_rows[item] : (int)a.perm[item];
    if (a.unres != nullptr && a.unres[row] == 0) continue;
    walk_warp_row<List>(a, w, row, lane);
  }
}

// The rows the thread and warp walks left (more candidates than they
// take): a block a row, over the queue (the launch's blocks fill the
// card once and take the queued rows in turn).  Each of the block's warps
// walks every 16th run of 32 candidates of each column with its own
// list; then the warps' lists are merged into warp 0's, one at a time
// through shared memory, and warp 0 writes the row.
template <class List>
__global__ void __launch_bounds__(kBlockThreads)
grid_round_walk_block_kernel(const Round a, const Walk w) {
  constexpr int kWarps = kBlockThreads / 32;
  __shared__ unsigned long long s_keys[32 * List::kPerLane];
  __shared__ int s_found;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n_col = 1;
  for (int x = 1; x < a.d; ++x) n_col *= 3;
  const int queued = w.queue_count[1];
  for (int item = blockIdx.x; item < queued; item += gridDim.x) {
    const int row = w.queue_rows[(size_t)a.nq + item];
    WalkRow r;
    walk_row(a, w, row, r);  // a queued row is finite
    const int self = a.qid[row];
    if (threadIdx.x == 0) s_found = 0;
    __syncthreads();
    List list;
    list.init(a.k, lane);
    int found = 0, count = 0;
    for (int o = 0; o < n_col; ++o) {
      int b, e;
      if (!walk_column(a, w, r, o, b, e)) continue;
      count += e - b;
      walk_range(a, w, r, self, b + warp * 32 + lane, e, kBlockThreads, list,
                 found, lane);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      found += __shfl_xor_sync(kAllLanes, found, off);
    if (lane == 0) atomicAdd(&s_found, found);
    for (int src = 1; src < kWarps; ++src) {
      __syncthreads();  // s_keys is free
      if (warp == src) list.store_keys(s_keys, a.k, lane);
      __syncthreads();
      if (warp == 0) list.merge_keys(s_keys, a.k, lane);
    }
    __syncthreads();  // s_found is complete
    if (warp == 0) {
      list.store(a.out_d2 + (size_t)row * a.k, a.out_i + (size_t)row * a.k,
                 a.k, lane, a.n);
      if (lane == 0) {
        finish_row(a, row, s_found);
        if (w.evaluated != nullptr) atomicAdd(w.evaluated, count);
      }
    }
    __syncthreads();  // s_found and s_keys are rewritten by the next row
  }
}

// ------------------------------------------------------- the row order

// The wrappers' row order in one launch: each query row's linear cell key
// in a grid of (origin, inv_cell, res) (core/fixed_radius.py::cell_keys:
// non-finite coordinates as 0, clamped, the last axis fastest), folded
// into 31 bits (modulo 2^31 - 1, which keeps a cell's rows together and
// the order of any grid of fewer cells), so that the sort takes four radix
// passes, not eight; a row whose unres flag is 0 gets 2^31 - 1, so a
// stable sort puts the rows that run first.  n_active, where not null,
// counts the rows that run.
__global__ void __launch_bounds__(kThreads)
grid_round_keys_kernel(const float* q, int nq, int d, const float* origin,
                       const float* inv_cell, const int* res,
                       const unsigned char* unres, int* keys,
                       int* n_active) {
  constexpr long long kFold = 0x7fffffffLL;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  bool run = false;
  if (row < nq) {
    long long key = 0;
    for (int x = 0; x < d; ++x)
      key = key * res[x] +
            cell_of(q[(size_t)row * d + x], origin[x], inv_cell[x], res[x]);
    run = unres == nullptr || unres[row] != 0;
    keys[row] = (int)(run ? key % kFold : kFold);
  }
  // every thread of the warp reaches the vote
  const unsigned votes = __ballot_sync(kAllLanes, run);
  if (n_active != nullptr && (threadIdx.x & 31) == 0 && votes != 0)
    atomicAdd(n_active, __popc(votes));
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
template <class Kernel>
int wave_of(Kernel kernel, int threads, int* cache) {
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

extern "C" int grid_round_keys_launch(const float* q, int nq, int d,
                                      const float* origin,
                                      const float* inv_cell, const int* res,
                                      const unsigned char* unres, int* keys,
                                      int* n_active, void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  grid_round_keys_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      q, nq, d, origin, inv_cell, res, unres, keys, n_active);
  return cudaGetLastError();
}

extern "C" int grid_round_walk_launch(
    const int* point_cells, const float* origin, const float* inv_cell,
    const int* res, const float* q, const int* qid, const long long* perm,
    const int* n_active, int nq, int n, int d, int k, float r2,
    const float* sub_pts, const int* cell_start, const int* cell_z,
    const int* col_start, const float* sub_origin, const float* sub_inv_cell,
    const int* sub_res, const long long* ref_keys, const long long* ref_cum,
    int n_ref, float* out_d2, int* out_i, int* found, unsigned char* unres,
    int* res_round, int t, unsigned long long* tests,
    unsigned long long* evaluated, int* executed, int* queue_rows,
    int* queue_count, void* stream) {
  if (nq <= 0) return cudaSuccess;
  if (d < 1 || d > kMaxD || k <= 0 || k > repro_torch::kMaxWarpK ||
      n < 0 || n > (1 << kKeyIndexBits) || perm == nullptr ||
      reinterpret_cast<uintptr_t>(sub_pts) % 16 != 0 ||
      queue_rows == nullptr || queue_count == nullptr)
    return cudaErrorInvalidValue;
  if ((unres == nullptr) != (res_round == nullptr) ||
      (unres == nullptr) != (executed == nullptr))
    return cudaErrorInvalidValue;
  Round a{};
  a.point_cells = point_cells;
  a.origin = origin;
  a.inv_cell = inv_cell;
  a.res = res;
  a.q = q;
  a.qid = qid;
  a.perm = perm;
  a.n_active = n_active;
  a.nq = nq;
  a.n = n;
  a.d = d;
  a.k = k;
  a.r2 = r2;
  a.out_d2 = out_d2;
  a.out_i = out_i;
  a.found = found;
  a.unres = unres;
  a.res_round = res_round;
  a.t = t;
  a.tests = tests;
  a.executed = executed;
  const Walk w{reinterpret_cast<const float4*>(sub_pts),
               cell_start,
               cell_z,
               col_start,
               sub_origin,
               sub_inv_cell,
               sub_res,
               ref_keys,
               ref_cum,
               n_ref,
               evaluated,
               queue_rows,
               queue_count,
               false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(queue_count, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return err;
  // the rows in walk order: a thread a row at k <= 32, a warp above
  if (k <= 8) {
    grid_round_walk_kernel<8>
        <<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, w);
  } else if (k <= 32) {
    grid_round_walk_kernel<32>
        <<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, w);
  } else {
    with_key_list(k, [&](auto list) {
      grid_round_walk_warp_kernel<decltype(list)>
          <<<(nq + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
              a, w);
    });
  }
  // the queued rows: the warp walk over queue 0 (filled at k <= 32 only),
  // then the block walk over queue 1, each one wave of blocks
  with_key_list(k, [&](auto list) {
    using List = decltype(list);
    if ((err = cudaGetLastError()) != cudaSuccess) return;
    if (k <= 32) {
      static int cache[16];
      const int wave =
          wave_of(grid_round_walk_warp_kernel<List>, kThreads, cache);
      if (wave <= 0) {
        err = cudaErrorInvalidDevice;
        return;
      }
      Walk wq = w;
      wq.from_queue = true;
      grid_round_walk_warp_kernel<List><<<wave, kThreads, 0, s>>>(a, wq);
      if ((err = cudaGetLastError()) != cudaSuccess) return;
    }
    static int cache[16];
    const int wave = wave_of(grid_round_walk_block_kernel<List>,
                             kBlockThreads, cache);
    if (wave <= 0) {
      err = cudaErrorInvalidDevice;
      return;
    }
    grid_round_walk_block_kernel<List><<<wave, kBlockThreads, 0, s>>>(a, w);
    err = cudaGetLastError();
  });
  return err;
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
