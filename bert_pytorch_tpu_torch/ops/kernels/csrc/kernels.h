// Host launchers of the port's hand-written Hopper kernels.
//
// The .cu files include no PyTorch header: they take raw device pointers,
// sizes and a stream, launch, and return cudaGetLastError(). binding.cpp is
// the one file that includes PyTorch's headers; it checks and allocates the
// tensors, calls these launchers and raises on a non-zero status.
#pragma once

#include <cstdint>
#include <cuda_runtime_api.h>

namespace bert_kernels {

// element type of an activation tensor
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// y = LN(x) over the last axis of a contiguous (rows, cols) x; scale and
// bias are (cols,) f32. Writes y in x's dtype and f32 mean / rstd (rows,).
cudaError_t layer_norm_fwd(const void* x, const float* scale,
                           const float* bias, void* y, float* mean,
                           float* rstd, int64_t rows, int cols, float eps,
                           DType dtype, cudaStream_t stream);

// Strides are in elements; q/k/v share (B, S, H, D) with a unit last-axis
// stride. out is a contiguous (B, S, H, D) tensor, lse a contiguous
// (B, H, S) f32 tensor. bias (B, S) f32 and seg (B, S) int32 may be null;
// skipped (one int32) may be null, else it gains the number of
// (q-tile, k-tile) pairs whose segment ranges do not meet.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const int32_t* seg;
  void* out;
  float* lse;
  int32_t* skipped;
  int64_t q_strides[3];  // batch, seq, head
  int64_t k_strides[3];
  int64_t v_strides[3];
  int batch, seq, heads, head_dim;
  float scale;
};

cudaError_t flash_attention_fwd(const FlashParams& p, DType dtype,
                                cudaStream_t stream);

}  // namespace bert_kernels
