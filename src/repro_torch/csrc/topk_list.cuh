// Per-thread running k-best lists shared by the port's CUDA kernels.
//
// Candidates reach a list in increasing id (pairwise_topk) or candidate
// position (grid_round) order, and a new entry is placed after every entry
// whose distance is <= its own.  The list is therefore ordered by the
// (distance, arrival) pair, which is the order lax.top_k gives the JAX
// reference: equal distances go to the lowest index.  A candidate is offered
// only when its distance is strictly below the current k-th best (`worst`),
// so NaN distances and +inf are never kept, and empty slots stay
// (+inf, sentinel).
#pragma once

#include <math_constants.h>

namespace repro_torch {

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

// A list in memory: slot j of a list at d[j * stride], i[j * stride].  In
// shared memory (stride = the block's threads, so a warp's lanes touch
// consecutive words) it keeps the hot loop free of the list's registers;
// in the output row itself (global memory, stride 1, cached in L1/L2) it
// takes any k the callers ask for.  An insertion shifts only the entries
// after the new one.
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

  // Copies the list to (od, oi) unless it lives there already.
  __device__ __forceinline__ void store(float* od, int* oi, int k) const {
    if (od == d) return;
    for (int j = 0; j < k; ++j) {
      od[j] = d[j * stride];
      oi[j] = i[j * stride];
    }
  }
};

}  // namespace repro_torch
