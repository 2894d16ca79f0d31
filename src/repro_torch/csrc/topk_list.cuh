// Running k-best lists shared by the port's CUDA kernels.
//
// Candidates reach a list in increasing id (pairwise_topk) or candidate
// position (grid_round) order, and a new entry is placed after every entry
// whose distance is <= its own.  The list is therefore ordered by the
// (distance, arrival) pair, which is the order lax.top_k gives the JAX
// reference: equal distances go to the lowest index.  A candidate is offered
// only when its distance is strictly below the current k-th best (`worst`,
// or `gate()` for the warp lists), so NaN distances and +inf are never
// kept, and empty slots stay (+inf, sentinel).
//
// RegTopK and MemTopK are one thread's lists (grid_round at k <= 32).
// WarpTopK is one list spread over a warp's 32 lanes in registers (both
// kernels at 32 < k <= 32 * 32, and every merge up to there): every lane
// moves its own entries in one insertion, so the warp inserts a candidate
// in O(KPL) steps a lane and one shuffle.  RowWarpTopK is one list of any k
// in a row of memory, kept by a whole warp (above 32 * 32): an insertion
// moves the entries above its place 32 at a time, every access coalesced.
// warp_merge combines the sorted partial lists of several splits with
// either warp list.
#pragma once

#include <math_constants.h>
#include <stddef.h>

namespace repro_torch {

// The mask of every warp-synchronous call: the whole warp takes part.
constexpr unsigned kAllLanes = 0xffffffffu;

// k <= KCAP: the list lives in registers (nvcc keeps an 8-entry list there;
// a 32-entry one it puts in local memory).  init's pointers and stride are
// those of MemTopK's, and unused here.
template <int KCAP>
struct RegTopK {
  float d[KCAP];
  int i[KCAP];
  float worst;

  __device__ __forceinline__ void init(float*, int*, int, int,
                                       int sentinel) {
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      d[j] = CUDART_INF_F;
      i[j] = sentinel;
    }
    worst = CUDART_INF_F;
  }

  // Caller guarantees dist < worst.
  __device__ __forceinline__ void push(float dist, int id, int k) {
#pragma unroll
    for (int j = KCAP - 1; j > 0; --j) {
      if (d[j - 1] > dist) {
        d[j] = d[j - 1];
        i[j] = i[j - 1];
      } else if (d[j] > dist) {
        d[j] = dist;
        i[j] = id;
      }
    }
    if (d[0] > dist) {
      d[0] = dist;
      i[0] = id;
    }
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      if (j == k - 1) worst = d[j];
    }
  }

  __device__ __forceinline__ void store(float* od, int* oi, int k) const {
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      if (j < k) {
        od[j] = d[j];
        oi[j] = i[j];
      }
    }
  }
};

// A list in shared memory: slot j of a list at d[j * stride],
// i[j * stride], stride = the block's threads, so a warp's lanes touch
// consecutive words; it keeps the hot loop free of the list's registers.
// An insertion shifts only the entries after the new one.
struct MemTopK {
  float* d;
  int* i;
  int stride;
  float worst;

  __device__ __forceinline__ void init(float* sd, int* si, int step, int k,
                                       int sentinel) {
    d = sd;
    i = si;
    stride = step;
    for (int j = 0; j < k; ++j) {
      d[j * stride] = CUDART_INF_F;
      i[j * stride] = sentinel;
    }
    worst = CUDART_INF_F;
  }

  // Caller guarantees dist < worst.
  __device__ __forceinline__ void push(float dist, int id, int k) {
    int p = k - 1;
    while (p > 0 && d[(p - 1) * stride] > dist) {
      d[p * stride] = d[(p - 1) * stride];
      i[p * stride] = i[(p - 1) * stride];
      --p;
    }
    d[p * stride] = dist;
    i[p * stride] = id;
    worst = d[(k - 1) * stride];
  }

  // Copies the list to the row (od, oi).
  __device__ __forceinline__ void store(float* od, int* oi, int k) const {
    for (int j = 0; j < k; ++j) {
      od[j] = d[j * stride];
      oi[j] = i[j * stride];
    }
  }
};

// A list of k entries spread over the 32 lanes of a warp, KPL entries a
// lane in registers: lane l holds positions [l * KPL, (l + 1) * KPL) in
// order, so k <= 32 * KPL.  The list is right-aligned: its k entries sit at
// the last k positions and the first 32 * KPL - k hold -inf, which no
// insertion passes.  So the k-th entry, the gate, is always the last slot
// of lane 31, and an insertion drops the entry it pushes past the end.
// Every call is made by the whole warp with warp-uniform arguments; every
// register index is a constant, so the list stays out of local memory.
template <int KPL>
struct WarpTopK {
  static constexpr int kPerLane = KPL;
  float d[KPL];
  int i[KPL];

  // Position of entry e is e + pad, pad = 32 * KPL - k.
  __device__ __forceinline__ static int pad(int k) { return 32 * KPL - k; }

  // k empty entries (+inf, sentinel).  The row (od, oi) is where store
  // writes; the register list does not use it.
  __device__ __forceinline__ void init(float*, int*, int k, int lane,
                                       int sentinel) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      d[j] = lane * KPL + j < pad(k) ? -CUDART_INF_F : CUDART_INF_F;
      i[j] = sentinel;
    }
  }

  // The k entries of a list stored in order at (sd, si).
  __device__ __forceinline__ void load(float*, int*, const float* sd,
                                       const int* si, int k, int lane,
                                       int sentinel) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int e = lane * KPL + j - pad(k);
      d[j] = e >= 0 ? sd[e] : -CUDART_INF_F;
      i[j] = e >= 0 ? si[e] : sentinel;
    }
  }

  // Places (dist, id) after every entry whose distance is <= dist and
  // drops the last entry: each lane moves its entries above dist up one
  // slot, its first slot taking the last entry of the lane below when that
  // one moves up too (at one entry a lane, a ballot finds the place).
  // Caller guarantees dist < gate().
  __device__ __forceinline__ void insert(float dist, int id, int lane) {
    if constexpr (KPL == 1) {
      const int at = __popc(__ballot_sync(kAllLanes, d[0] <= dist));
      const float up_d = __shfl_up_sync(kAllLanes, d[0], 1);
      const int up_i = __shfl_up_sync(kAllLanes, i[0], 1);
      if (lane > at) {
        d[0] = up_d;
        i[0] = up_i;
      } else if (lane == at) {
        d[0] = dist;
        i[0] = id;
      }
      return;
    }
    float below_d = __shfl_up_sync(kAllLanes, d[KPL - 1], 1);
    const int below_i = __shfl_up_sync(kAllLanes, i[KPL - 1], 1);
    if (lane == 0) below_d = -CUDART_INF_F;  // nothing below position 0
    // selects, not branches: nvcc turns the if-else form into branches
    // at KPL >= 2, which a warp takes apart lane by lane
#pragma unroll
    for (int j = KPL - 1; j > 0; --j) {
      const bool up = d[j - 1] > dist;
      const bool put = d[j] > dist;
      d[j] = up ? d[j - 1] : put ? dist : d[j];
      i[j] = up ? i[j - 1] : put ? id : i[j];
    }
    const bool up = below_d > dist;
    const bool put = d[0] > dist;
    d[0] = up ? below_d : put ? dist : d[0];
    i[0] = up ? below_i : put ? id : i[0];
  }

  // The k-th entry's distance, on every lane.
  __device__ __forceinline__ float gate() const {
    return __shfl_sync(kAllLanes, d[KPL - 1], 31);
  }

  // The k entries to (od, oi) in order.
  __device__ __forceinline__ void store(float* od, int* oi, int k,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int e = lane * KPL + j - pad(k);
      if (e >= 0) {
        od[e] = d[j];
        oi[e] = i[j];
      }
    }
  }
};

// A list of any k kept by a whole warp in a row of memory (stride 1: a
// workspace or output row): entries in order at d[0, k), the `filled`
// finite ones first, then (+inf, sentinel).  An insertion finds its place
// with a 32-way search over the finite entries and moves those above it up
// one slot, 32 at a time from the top, so every access of the warp is to
// consecutive words; the warp's lanes keep the gate and the count.  Same
// calls as WarpTopK, so one kernel template takes either.
struct RowWarpTopK {
  static constexpr int kPerLane = 0;  // no register entries
  float* d;
  int* i;
  int k;
  int filled;
  float kth;

  // k empty entries in the row (od, oi).
  __device__ __forceinline__ void init(float* od, int* oi, int k_, int lane,
                                       int sentinel) {
    d = od;
    i = oi;
    k = k_;
    filled = 0;
    kth = CUDART_INF_F;
    for (int e = lane; e < k; e += 32) {
      d[e] = CUDART_INF_F;
      i[e] = sentinel;
    }
    __syncwarp();
  }

  // The list stored in order at (sd, si), copied to the row (od, oi).
  __device__ __forceinline__ void load(float* od, int* oi, const float* sd,
                                       const int* si, int k_, int lane,
                                       int) {
    d = od;
    i = oi;
    k = k_;
    for (int e = lane; e < k; e += 32) {
      d[e] = sd[e];
      i[e] = si[e];
    }
    __syncwarp();
    filled = k;
    filled = place(3.402823466e+38f, lane);  // the finite entries
    kth = filled < k ? CUDART_INF_F : d[k - 1];
  }

  // The number of entries whose distance is <= dist (all of them finite).
  __device__ __forceinline__ int place(float dist, int lane) const {
    int lo = 0, hi = filled;  // entries below lo are <= dist, from hi on >
    while (hi - lo > 32) {
      const int step = (hi - lo + 31) / 32;
      const int e = lo + (lane + 1) * step - 1;  // the last of segment lane
      const int c =
          __popc(__ballot_sync(kAllLanes, e < hi && d[e] <= dist));
      lo += c * step;  // segment c holds the place
      hi = min(hi, lo + step);
    }
    const int e = lo + lane;
    return lo + __popc(__ballot_sync(kAllLanes, e < hi && d[e] <= dist));
  }

  // Places (dist, id) after every entry whose distance is <= dist; the
  // last entry drops out once the row is full.  Caller guarantees
  // dist < gate().
  __device__ __forceinline__ void insert(float dist, int id, int lane) {
    const int at = place(dist, lane);
    const int top = filled < k ? filled : k - 1;  // the last slot written
    for (int hi = top; hi > at; hi -= 32) {
      const int e = hi - lane;  // moves from e - 1 to e
      float vd = 0.0f;
      int vi = 0;
      if (e > at) {
        vd = d[e - 1];
        vi = i[e - 1];
      }
      __syncwarp();
      if (e > at) {
        d[e] = vd;
        i[e] = vi;
      }
      __syncwarp();
    }
    if (lane == 0) {
      d[at] = dist;
      i[at] = id;
    }
    __syncwarp();
    filled += filled < k;
    kth = filled < k ? CUDART_INF_F : d[k - 1];
  }

  __device__ __forceinline__ float gate() const { return kth; }

  // The list already lives in its row.
  __device__ __forceinline__ void store(float*, int*, int, int) const {}
};

// The largest WarpTopK: 32 entries a lane.
constexpr int kMaxWarpK = 1024;

// Entries a lane of the warp list holds: the fewest of 1, 2, 4, 8, 16, 32
// whose 32 * KPL entries hold k; 0 above kMaxWarpK, where the list is a
// RowWarpTopK in a row of memory (its kPerLane).
constexpr int kpl_of(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : k <= 256 ? 8
         : k <= 512 ? 16 : k <= kMaxWarpK ? 32 : 0;
}

// Calls f with an (empty) warp list of the type that keeps a k-best list:
// the one place where k picks the warp list, for every kernel that keeps
// one.  Returns what f returns.
template <class F>
auto with_list(int k, F f) -> decltype(f(RowWarpTopK{})) {
  switch (kpl_of(k)) {
    case 0:
      return f(RowWarpTopK{});
    case 1:
      return f(WarpTopK<1>{});
    case 2:
      return f(WarpTopK<2>{});
    case 4:
      return f(WarpTopK<4>{});
    case 8:
      return f(WarpTopK<8>{});
    case 16:
      return f(WarpTopK<16>{});
    default:
      return f(WarpTopK<32>{});
  }
}

// Merges `splits` partial lists of k entries each, every one in (distance,
// arrival) order with empty slots (+inf, n), split s's at rd + s * stride
// and ri + s * stride, into `list` and writes it to the row (od, oi).
// Split 0's list is taken as it is; then the heads of 32 splits at a time
// are read at once, and only a split whose head is below the gate is
// walked, 32 entries at a time in order until one is not below the gate
// (the lists are sorted, so no later one is).  An entry goes after every
// entry of equal distance, so on a tie the earlier split comes first.
// Called by the whole warp; `list` is an empty WarpTopK or RowWarpTopK.
template <class List>
__device__ __forceinline__ void warp_merge(List& list, const float* rd,
                                           const int* ri, size_t stride,
                                           int splits, int k, int n,
                                           int lane, float* od, int* oi) {
  list.load(od, oi, rd, ri, k, lane, n);  // split 0 alone gives its own list
  float gate = list.gate();
  for (int s0 = 1; s0 < splits; s0 += 32) {
    // the heads of 32 splits at once; one at or above the gate adds
    // nothing, since the gate only falls
    const int s = s0 + lane;
    const float head = s < splits ? rd[s * stride] : CUDART_INF_F;
    unsigned todo = __ballot_sync(kAllLanes, head < gate);
    while (todo != 0) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const size_t at = (size_t)(s0 + src) * stride;
      // the split's entries in order, 32 at a time, until one is not
      // below the gate
      bool more = true;
      for (int c0 = 0; more && c0 < k; c0 += 32) {
        const bool valid = c0 + lane < k;
        const float dv = valid ? rd[at + c0 + lane] : CUDART_INF_F;
        const int iv = valid ? ri[at + c0 + lane] : n;
        unsigned take = __ballot_sync(kAllLanes, dv < gate);
        more = take == kAllLanes;
        while (take != 0) {
          const int from = __ffs(take) - 1;
          take &= take - 1;
          const float dd = __shfl_sync(kAllLanes, dv, from);
          const int id = __shfl_sync(kAllLanes, iv, from);
          if (!(dd < gate)) {  // warp-uniform; no later entry is below
            more = false;
            break;
          }
          list.insert(dd, id, lane);
          gate = list.gate();
        }
      }
    }
  }
  list.store(od, oi, k, lane);
}

}  // namespace repro_torch
