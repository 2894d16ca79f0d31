// PyTorch binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers (the kernels themselves do not, so they build fast).
//
// Each function takes the wrapper's tensors, refuses what the kernel cannot
// take (not on the one CUDA device, wrong dtype, not contiguous), launches
// on that device's current stream under a device guard, and raises on a
// launch error.  Shapes are checked by the Python wrappers
// (repro_torch.kernels.pairwise_topk, repro_torch.core.fixed_radius).
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include <optional>
#include <tuple>

#include "launch.h"

namespace {

template <class T>
T* ptr(const torch::Tensor& t, c10::ScalarType type, const c10::Device& dev,
       const char* name) {
  TORCH_CHECK(t.device() == dev, name, ": expected a tensor on ", dev,
              ", got ", t.device());
  TORCH_CHECK(t.scalar_type() == type, name, ": expected ", type, ", got ",
              t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), name, ": must be contiguous");
  return static_cast<T*>(t.data_ptr());
}

template <class T>
T* opt_ptr(const std::optional<torch::Tensor>& t, c10::ScalarType type,
           const c10::Device& dev, const char* name) {
  return t.has_value() ? ptr<T>(*t, type, dev, name) : nullptr;
}

void check_launch(int err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, name, " launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void pairwise_topk(const torch::Tensor& q, const torch::Tensor& qid,
                   const torch::Tensor& p,
                   const std::optional<torch::Tensor>& row_mask, int64_t k,
                   int64_t splits, int64_t span, double thr, int64_t metric,
                   const torch::Tensor& part_d, const torch::Tensor& part_i,
                   const torch::Tensor& part_c) {
  const c10::Device dev = p.device();
  TORCH_CHECK(dev.is_cuda(), "pairwise_topk: needs CUDA tensors");
  const c10::cuda::CUDAGuard guard(dev);
  const auto f32 = torch::kFloat32, i32 = torch::kInt32;
  check_launch(
      pairwise_topk_launch(
          ptr<const float>(q, f32, dev, "queries"),
          ptr<const int>(qid, i32, dev, "query_ids"),
          ptr<const float>(p, f32, dev, "points"),
          opt_ptr<const unsigned char>(row_mask, torch::kUInt8, dev,
                                       "row_mask"),
          static_cast<int>(q.size(0)), static_cast<int>(p.size(0)),
          static_cast<int>(q.size(1)), static_cast<int>(k),
          static_cast<int>(splits), static_cast<int>(span),
          static_cast<float>(thr), static_cast<int>(metric),
          ptr<float>(part_d, f32, dev, "part_d"),
          ptr<int>(part_i, i32, dev, "part_i"),
          ptr<int>(part_c, i32, dev, "part_c"),
          c10::cuda::getCurrentCUDAStream(dev.index()).stream()),
      "pairwise_topk");
}

void pairwise_topk_merge(const torch::Tensor& part_d,
                         const torch::Tensor& part_i,
                         const torch::Tensor& part_c,
                         const std::optional<torch::Tensor>& row_mask,
                         int64_t n, const torch::Tensor& out_d,
                         const torch::Tensor& out_i,
                         const torch::Tensor& out_c) {
  const c10::Device dev = part_d.device();
  TORCH_CHECK(dev.is_cuda(), "pairwise_topk_merge: needs CUDA tensors");
  const c10::cuda::CUDAGuard guard(dev);
  const auto f32 = torch::kFloat32, i32 = torch::kInt32;
  check_launch(
      pairwise_topk_merge_launch(
          ptr<const float>(part_d, f32, dev, "part_d"),
          ptr<const int>(part_i, i32, dev, "part_i"),
          ptr<const int>(part_c, i32, dev, "part_c"),
          opt_ptr<const unsigned char>(row_mask, torch::kUInt8, dev,
                                       "row_mask"),
          static_cast<int>(out_d.size(0)), static_cast<int>(part_d.size(0)),
          static_cast<int>(out_d.size(1)), static_cast<int>(n),
          ptr<float>(out_d, f32, dev, "out_d"),
          ptr<int>(out_i, i32, dev, "out_i"),
          ptr<int>(out_c, i32, dev, "out_c"),
          c10::cuda::getCurrentCUDAStream(dev.index()).stream()),
      "pairwise_topk_merge");
}

int64_t rows_per_block(int64_t d, int64_t k, int64_t metric) {
  return pairwise_topk_rows_per_block(static_cast<int>(d),
                                      static_cast<int>(k),
                                      static_cast<int>(metric));
}

void grid_round(const torch::Tensor& pts, const torch::Tensor& buckets,
                const torch::Tensor& point_cells, const torch::Tensor& origin,
                const torch::Tensor& inv_cell, const torch::Tensor& res,
                const torch::Tensor& q, const torch::Tensor& qid,
                const std::optional<torch::Tensor>& perm,
                const std::optional<torch::Tensor>& n_active, int64_t k,
                double r2, bool tiled, const torch::Tensor& out_d2,
                const torch::Tensor& out_i, const torch::Tensor& found,
                const std::optional<torch::Tensor>& unres,
                const std::optional<torch::Tensor>& res_round, int64_t t,
                const torch::Tensor& tests,
                const std::optional<torch::Tensor>& executed,
                const std::optional<torch::Tensor>& ws_d,
                const std::optional<torch::Tensor>& ws_i,
                const std::optional<torch::Tensor>& ws_f,
                const std::optional<torch::Tensor>& plan, int64_t splits) {
  const c10::Device dev = q.device();
  TORCH_CHECK(dev.is_cuda(), "grid_round: needs CUDA tensors");
  const c10::cuda::CUDAGuard guard(dev);
  const auto f32 = torch::kFloat32, i32 = torch::kInt32;
  const int64_t ws_rows = ws_f.has_value() ? ws_f->size(0) : 0;
  if (plan.has_value())
    TORCH_CHECK(plan->numel() >= 2, "grid_round: plan must hold (T, S)");
  if (ws_d.has_value() || ws_i.has_value())
    TORCH_CHECK(ws_d.has_value() && ws_i.has_value() && ws_f.has_value() &&
                    ws_d->dim() == 2 && ws_i->dim() == 2 &&
                    ws_d->size(0) == ws_rows && ws_i->size(0) == ws_rows &&
                    ws_d->size(1) == k && ws_i->size(1) == k,
                "grid_round: workspace must be (rows, k), (rows, k), (rows,)");
  check_launch(
      grid_round_launch(
          ptr<const float>(pts, f32, dev, "points"),
          ptr<const int>(buckets, i32, dev, "buckets"),
          ptr<const int>(point_cells, i32, dev, "point_cells"),
          ptr<const float>(origin, f32, dev, "origin"),
          ptr<const float>(inv_cell, f32, dev, "inv_cell"),
          ptr<const int>(res, i32, dev, "res"),
          ptr<const float>(q, f32, dev, "queries"),
          ptr<const int>(qid, i32, dev, "query_ids"),
          opt_ptr<const long long>(perm, torch::kInt64, dev, "perm"),
          opt_ptr<const int>(n_active, i32, dev, "n_active"),
          static_cast<int>(q.size(0)), static_cast<int>(pts.size(0)),
          static_cast<int>(q.size(1)), static_cast<int>(buckets.size(0)),
          static_cast<int>(buckets.size(1)), static_cast<int>(k),
          static_cast<float>(r2), tiled ? 1 : 0,
          ptr<float>(out_d2, f32, dev, "out_d2"),
          ptr<int>(out_i, i32, dev, "out_i"),
          ptr<int>(found, i32, dev, "found"),
          opt_ptr<unsigned char>(unres, torch::kUInt8, dev, "unres"),
          opt_ptr<int>(res_round, i32, dev, "res_round"),
          static_cast<int>(t),
          ptr<unsigned long long>(tests, torch::kInt64, dev, "tests"),
          opt_ptr<int>(executed, i32, dev, "executed"),
          opt_ptr<float>(ws_d, f32, dev, "ws_d"),
          opt_ptr<int>(ws_i, i32, dev, "ws_i"),
          opt_ptr<int>(ws_f, i32, dev, "ws_f"), ws_rows,
          opt_ptr<int>(plan, i32, dev, "plan"), static_cast<int>(splits),
          c10::cuda::getCurrentCUDAStream(dev.index()).stream()),
      "grid_round");
}

int64_t grid_workspace_rows(int64_t d, int64_t k, int64_t nq, bool fused,
                            int64_t splits, int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  long long rows = 0;
  check_launch(grid_round_workspace_rows(
                   static_cast<int>(d), static_cast<int>(k),
                   static_cast<int>(nq), fused ? 1 : 0,
                   static_cast<int>(splits), &rows),
               "grid_round_workspace_rows");
  return rows;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("pairwise_topk", &pairwise_topk);
  m.def("pairwise_topk_merge", &pairwise_topk_merge);
  m.def("pairwise_topk_rows_per_block", &rows_per_block);
  m.def("grid_round", &grid_round);
  m.def("grid_round_workspace_rows", &grid_workspace_rows);
}
