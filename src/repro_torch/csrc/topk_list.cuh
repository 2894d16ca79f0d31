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

// k <= KCAP: the list lives in registers.  Every index below is a
// compile-time constant after unrolling, so nothing spills to local memory.
template <int KCAP>
struct RegTopK {
  float d[KCAP];
  int i[KCAP];
  float worst;

  __device__ __forceinline__ void init(float*, int*, int k, int sentinel) {
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

// k > the largest register list: the list lives in the output row itself
// (global memory, cached in L1/L2), so any k the callers ask for works.
struct GlobalTopK {
  float* d;
  int* i;
  float worst;

  __device__ __forceinline__ void init(float* od, int* oi, int k,
                                       int sentinel) {
    d = od;
    i = oi;
    for (int j = 0; j < k; ++j) {
      d[j] = CUDART_INF_F;
      i[j] = sentinel;
    }
    worst = CUDART_INF_F;
  }

  __device__ __forceinline__ void push(float dist, int id, int k) {
    int p = k - 1;
    while (p > 0 && d[p - 1] > dist) {
      d[p] = d[p - 1];
      i[p] = i[p - 1];
      --p;
    }
    d[p] = dist;
    i[p] = id;
    worst = d[k - 1];
  }

  __device__ __forceinline__ void store(float*, int*, int) const {}
};

}  // namespace repro_torch
