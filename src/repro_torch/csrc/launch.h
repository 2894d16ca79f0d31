// C entry points of the port's CUDA kernels, called by binding.cpp.
//
// Each launches its kernel on `stream` (a cudaStream_t) and returns the
// launch's cudaError_t; it allocates nothing and does not synchronise.
// Every pointer is a device pointer to a contiguous tensor.  The .cu files
// include this header, so a definition that drifts from it does not build.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// q (nq, d) f32, qid (nq,) i32, p (n, d) f32, row_mask (nq,) u8 or null
// (rows with 0 are skipped and their outputs left untouched), out_d (nq, k)
// f32, out_i (nq, k) i32, out_c (nq,) i32.  metric: 0 = l2 (squared),
// 1 = l1, 2 = linf.
int pairwise_topk_launch(const float* q, const int* qid, const float* p,
                         const unsigned char* row_mask, int nq, int n, int d,
                         int k, float thr, int metric, float* out_d,
                         int* out_i, int* out_c, void* stream);

// pts (n, d) f32 (only matched rows are read), buckets (table_size, cap)
// i32 padded with n, point_cells (n + 1, d) i32, origin / inv_cell (d,)
// f32, res (d,) i32, q (nq, d) f32, qid (nq,) i32, out_d2 / out_i (nq, k),
// found (nq,) i32, tests one u64 that is added to.  unres (nq,) u8,
// res_round (nq,) i32 and executed (one i32) are null outside the fused
// loop.  1 <= d <= 3.
int grid_round_launch(const float* pts, const int* buckets,
                      const int* point_cells, const float* origin,
                      const float* inv_cell, const int* res, const float* q,
                      const int* qid, int nq, int n, int d, int table_size,
                      int cap, int k, float r2, float* out_d2, int* out_i,
                      int* found, unsigned char* unres, int* res_round, int t,
                      unsigned long long* tests, int* executed, void* stream);

#ifdef __cplusplus
}
#endif
