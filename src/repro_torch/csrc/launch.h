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

// pairwise_topk, first pass: grid (query tiles x splits); split s scans
// the points [s * span, min((s + 1) * span, n)).  q (nq, d) f32, qid (nq,)
// i32, p (n, d) f32, row_mask (nq,) u8 or null (rows with 0 are skipped and
// their outputs left untouched).  Partial outputs, split-major: part_d /
// part_i (splits, nq, k) f32 / i32, part_c (splits, nq) i32; with
// splits == 1 they may be the final outputs themselves.  metric: 0 = l2
// (squared), 1 = l1, 2 = linf, 3 = l2diff (squared, the diff form at any
// d).
int pairwise_topk_launch(const float* q, const int* qid, const float* p,
                         const unsigned char* row_mask, int nq, int n, int d,
                         int k, int splits, int span, float thr, int metric,
                         float* part_d, int* part_i, int* part_c,
                         void* stream);

// Query rows one block of the pairwise_topk first pass serves at this
// (d, k, metric): the host chooses splits from it.
int pairwise_topk_rows_per_block(int d, int k, int metric);

// pairwise_topk, merge pass: per row, the splits' partial lists merged in
// split order (the earlier split wins a tie), counts summed.  Writes
// out_d / out_i (nq, k) and out_c (nq,) for the rows row_mask selects (all
// rows when it is null).  n is the sentinel index of empty slots.
int pairwise_topk_merge_launch(const float* part_d, const int* part_i,
                               const int* part_c,
                               const unsigned char* row_mask, int nq,
                               int splits, int k, int n, float* out_d,
                               int* out_i, int* out_c, void* stream);

// pts (n, d) f32 (only matched rows are read), buckets (table_size, cap)
// i32 padded with n, point_cells (n + 1, d) i32, origin / inv_cell (d,)
// f32, res (d,) i32, q (nq, d) f32, qid (nq,) i32, out_d2 / out_i (nq,
// k), found (nq,) i32, tests one u64 that is added to.  unres (nq,) u8,
// res_round (nq,) i32 and executed (one i32) are null outside the fused
// loop.  tiled != 0 takes the coarse-grid design (cap a multiple of 4,
// buckets 16-byte aligned) and needs perm (nq,) i64, a permutation of the
// rows (position i works on row perm[i]; in fused mode the rows whose unres
// flag is set come first); the fine design works on the rows in their own
// order and takes perm = n_active = null, splits = 0.  1 <= d <= 3.
// Coarse design only: n_active (one i32: the rows that run, the set unres
// flags in fused mode) or null (all nq); the workspace ws_d / ws_i
// (ws_rows, k) f32 / i32 and ws_f (ws_rows,) i32, where split lists go;
// splits = 0 picks S on the device from the active count, splits = S > 0
// forces S; ws_rows >= grid_round_workspace_rows (the workspace may be
// null where that is 0).  plan (two i32) or null: (T, S) as the launch
// used them.  A launch with S > 1 possible also launches the merge pass.
int grid_round_launch(const float* pts, const int* buckets,
                      const int* point_cells, const float* origin,
                      const float* inv_cell, const int* res, const float* q,
                      const int* qid, const long long* perm,
                      const int* n_active, int nq, int n, int d,
                      int table_size, int cap, int k, float r2, int tiled,
                      float* out_d2, int* out_i, int* found,
                      unsigned char* unres, int* res_round, int t,
                      unsigned long long* tests, int* executed, float* ws_d,
                      int* ws_i, int* ws_f, long long ws_rows, int* plan,
                      int splits, void* stream);

// The workspace rows a coarse launch of nq rows at (d, k) needs on the
// current device: fused != 0 when it takes an active count (n_active),
// splits as for grid_round_launch; 0 when it runs unsplit.
int grid_round_workspace_rows(int d, int k, int nq, int fused, int splits,
                              long long* rows);

#ifdef __cplusplus
}
#endif
