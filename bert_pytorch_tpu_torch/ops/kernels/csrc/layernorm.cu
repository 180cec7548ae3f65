// LayerNorm forward for Hopper.
//
// Replaces the Pallas kernel `_fwd_kernel` behind `layer_norm_pallas`
// (bert_pytorch_tpu/ops/pallas/layernorm.py): y = (x - mean) * rstd * scale
// + bias over the last axis, eps 1e-12, statistics in f32, y in the input
// dtype, mean and rstd written in f32 for the backward pass.
//
// What bounds it: memory. At the serving shapes, (8 * bucket, 1024) rows,
// it does ~8 flops per element against 4 bytes moved in bf16 (read x,
// write y), two orders of magnitude below the card's balance point. So the
// design reads x from device memory exactly once: one warp owns one row,
// loads it with 16-byte accesses, keeps it in shared memory as f32 for the
// two reduction passes (mean, then the centred variance as the reference
// computes it), and writes y with 16-byte stores. Four warps per block give
// enough blocks (R / 4) to keep 132 SMs busy at R = 512 and above. There is
// no E % 128 gate: any width runs, with scalar accesses when E is not a
// multiple of the vector width.
#include "common.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kWarps = 4;

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const typename T::raw* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      typename T::raw* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int64_t rows, int cols,
                      float eps) {
  using raw = typename T::raw;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  // element i of lane's chunk sits at chunk_base + i * 32 + lane:
  // consecutive lanes hit consecutive banks. A warp's buffer is cols
  // rounded up to whole chunks, since that layout spans the last chunk.
  constexpr int kChunk = 32 * VEC;
  const int padded = (cols + kChunk - 1) / kChunk * kChunk;
  float* buf = smem + static_cast<size_t>(warp) * padded;
  const raw* xr = x + row * cols;
  raw* yr = y + row * cols;

  float sum = 0.f;
  for (int base = 0; base < cols; base += kChunk) {
    const int c = base + lane * VEC;
    if (c < cols) {
      raw v[VEC];
      load_vec<VEC>(xr + c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = T::to_f32(v[i]);
        buf[base + i * 32 + lane] = f;
        sum += f;
      }
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(cols);

  float sq = 0.f;
  for (int base = 0; base < cols; base += kChunk) {
    if (base + lane * VEC < cols) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = buf[base + i * 32 + lane] - mu;
        sq += d * d;
      }
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / static_cast<float>(cols) + eps);

  for (int base = 0; base < cols; base += kChunk) {
    const int c = base + lane * VEC;
    if (c < cols) {
      raw o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float yv = (buf[base + i * 32 + lane] - mu) * rs;
        o[i] = T::from_f32(yv * scale[c + i] + bias[c + i]);
      }
      store_vec<VEC>(yr + c, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rs;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, float* mean, float* rstd, int64_t rows, int cols,
                   float eps, cudaStream_t stream) {
  using raw = typename T::raw;
  auto kernel = layer_norm_fwd_kernel<T, VEC>;
  const int padded = (cols + 32 * VEC - 1) / (32 * VEC) * (32 * VEC);
  const size_t smem = static_cast<size_t>(kWarps) * padded * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const raw*>(x), scale, bias, static_cast<raw*>(y), mean,
      rstd, rows, cols, eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t layer_norm_fwd(const void* x, const float* scale,
                           const float* bias, void* y, float* mean,
                           float* rstd, int64_t rows, int cols, float eps,
                           DType dtype, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (dtype == kBFloat16) {
    if (aligned && cols % 8 == 0)
      return launch<BF16, 8>(x, scale, bias, y, mean, rstd, rows, cols, eps,
                             stream);
    return launch<BF16, 1>(x, scale, bias, y, mean, rstd, rows, cols, eps,
                           stream);
  }
  if (aligned && cols % 4 == 0)
    return launch<F32, 4>(x, scale, bias, y, mean, rstd, rows, cols, eps,
                          stream);
  return launch<F32, 1>(x, scale, bias, y, mean, rstd, rows, cols, eps,
                        stream);
}

}  // namespace bert_kernels
