// Fused multi-tensor LAMB, stages 1 and 2, for Hopper.
//
// Replaces the two Pallas kernels of bert_pytorch_tpu/ops/pallas/fused_optim.py:
//
//   _stage1_kernel (lamb_stage1 -> _stage1_flat) -> lamb_stage1
//   _stage2_kernel (lamb_stage2 -> _stage2_flat) -> lamb_stage2
//
// Stage 1, per element of every parameter tensor (`_stage1_math`):
//   gn = g / denom
//   mu = b1 * mu + (1 - b1) * gn
//   nu = b2 * nu + (1 - b2) * gn^2
//   u  = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p
// mu and nu are updated in place, u is written. Stage 2: out = t * u, or,
// with `apply`, p = p + t * u in place, t = -lr * trust ratio of the tensor.
//
// The TPU version concatenates the leaves into flat buckets of at most
// 4 MiB, pads them to (256, 128) tiles, launches once per bucket and splits
// the outputs back out: two extra passes over the state and ~320 launches
// per stage for BERT-Large. Here one launch per stage covers every tensor
// where it lies (multi-tensor apply): a table of per-tensor pointers, sizes
// and scalars, and a table of (tensor, start) chunks, one CTA per chunk.
// The host builds both tables and copies them in one transfer per call, so
// a table never outlives the tensors it points at.
//
// Beyond the Pallas kernels: gradients are read in their own dtype (bf16
// under bf16 gradients) and upcast in registers, which is exact and saves
// the f32 cast pass the JAX package makes before stage 1; wd and t are one
// f32 scalar per tensor instead of a vector broadcast to the leaf's shape;
// and stage 2 can add the update to the f32 master in the same pass.
//
// Numerics: every operation is an explicitly rounded intrinsic, so no
// multiply-add contracts into an FMA. Each step rounds where the plain
// PyTorch version (ops/fused_optim.lamb_stage1_ref / lamb_stage2_ref),
// which runs every operation as its own kernel, rounds: the kernel gives
// the same bits. In stage 2 the product t * u is rounded before the add,
// as in the unfused `p.add_(t * u)`.
//
// What bounds them: memory. Stage 1 moves 26 bytes per element with bf16
// gradients (g 2, mu/nu/p read 12, mu/nu/u written 12) for ~15 flops;
// stage 2 with the apply 12 bytes (u, p read; p written). So each thread
// moves 16-byte vectors (8 bytes for a bf16 gradient) wherever the tensor's
// pointers are aligned, and the chunk's scalar tail runs in the same CTA.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kThreads = 256;

// elements of the chunk that starts at `start` of a tensor of n
__device__ __forceinline__ int64_t chunk_len(int64_t n, int64_t start,
                                             int chunk_size) {
  const int64_t rest = n - start;
  return rest < chunk_size ? rest : chunk_size;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// four gradient elements from a 16-byte (f32) or 8-byte (bf16) aligned
// address, as f32
template <bool kBf16>
__device__ __forceinline__ void load_g4(const void* g, int64_t i, float out[4]) {
  if (kBf16) {
    const uint2 raw = reinterpret_cast<const uint2*>(g)[i];
    out[0] = bf16_bits_to_float(raw.x & 0xFFFFu);
    out[1] = __uint_as_float(raw.x & 0xFFFF0000u);
    out[2] = bf16_bits_to_float(raw.y & 0xFFFFu);
    out[3] = __uint_as_float(raw.y & 0xFFFF0000u);
  } else {
    const float4 v = reinterpret_cast<const float4*>(g)[i];
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <bool kBf16>
__device__ __forceinline__ float load_g1(const void* g, int64_t i) {
  if (kBf16) return bf16_bits_to_float(reinterpret_cast<const uint16_t*>(g)[i]);
  return reinterpret_cast<const float*>(g)[i];
}

// `_stage1_math`, one rounding per operation in the reference's order
__device__ __forceinline__ void stage1_math(float g, float& mu, float& nu,
                                            float p, float& u, float wd,
                                            float denom,
                                            const LambStage1Scalars& s) {
  const float gn = __fdiv_rn(g, denom);
  mu = __fadd_rn(__fmul_rn(s.b1, mu), __fmul_rn(s.one_minus_b1, gn));
  nu = __fadd_rn(__fmul_rn(s.b2, nu),
                 __fmul_rn(s.one_minus_b2, __fmul_rn(gn, gn)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.c2)), s.eps);
  u = __fadd_rn(__fdiv_rn(__fdiv_rn(mu, s.c1), den), __fmul_rn(wd, p));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    lamb_stage1_kernel(const LambStage1Tensor* __restrict__ tensors,
                       const LambChunk* __restrict__ chunks, int chunk_size,
                       const float* __restrict__ denom_ptr,
                       LambStage1Scalars s) {
  const LambChunk c = chunks[blockIdx.x];
  const LambStage1Tensor t = tensors[c.tensor];
  const float denom = *denom_ptr;
  const int64_t len = chunk_len(t.n, c.start, chunk_size);
  const size_t g_bytes = kBf16 ? 2 : 4;
  const void* g = static_cast<const char*>(t.g) + c.start * g_bytes;
  float* mu = t.mu + c.start;
  float* nu = t.nu + c.start;
  const float* p = t.p + c.start;
  float* u = t.u + c.start;
  int64_t done = 0;
  if (t.vec) {
    const int64_t n4 = len / 4;
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float gv[4];
      load_g4<kBf16>(g, i, gv);
      float4 m = reinterpret_cast<const float4*>(mu)[i];
      float4 v = reinterpret_cast<const float4*>(nu)[i];
      const float4 pv = reinterpret_cast<const float4*>(p)[i];
      float4 uv;
      stage1_math(gv[0], m.x, v.x, pv.x, uv.x, t.wd, denom, s);
      stage1_math(gv[1], m.y, v.y, pv.y, uv.y, t.wd, denom, s);
      stage1_math(gv[2], m.z, v.z, pv.z, uv.z, t.wd, denom, s);
      stage1_math(gv[3], m.w, v.w, pv.w, uv.w, t.wd, denom, s);
      reinterpret_cast<float4*>(mu)[i] = m;
      reinterpret_cast<float4*>(nu)[i] = v;
      reinterpret_cast<float4*>(u)[i] = uv;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    float m = mu[i], v = nu[i], uo;
    stage1_math(load_g1<kBf16>(g, i), m, v, p[i], uo, t.wd, denom, s);
    mu[i] = m;
    nu[i] = v;
    u[i] = uo;
  }
}

template <bool kApply>
__device__ __forceinline__ float stage2_math(float t, float u, float out) {
  const float upd = __fmul_rn(t, u);
  return kApply ? __fadd_rn(out, upd) : upd;
}

template <bool kApply>
__global__ void __launch_bounds__(kThreads)
    lamb_stage2_kernel(const LambStage2Tensor* __restrict__ tensors,
                       const LambChunk* __restrict__ chunks, int chunk_size,
                       const float* __restrict__ t_vec) {
  const LambChunk c = chunks[blockIdx.x];
  const LambStage2Tensor t = tensors[c.tensor];
  const float tv = t_vec[c.tensor];
  const int64_t len = chunk_len(t.n, c.start, chunk_size);
  const float* u = t.u + c.start;
  float* out = t.out + c.start;
  int64_t done = 0;
  if (t.vec) {
    const int64_t n4 = len / 4;
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      const float4 uv = reinterpret_cast<const float4*>(u)[i];
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kApply) o = reinterpret_cast<const float4*>(out)[i];
      o.x = stage2_math<kApply>(tv, uv.x, o.x);
      o.y = stage2_math<kApply>(tv, uv.y, o.y);
      o.z = stage2_math<kApply>(tv, uv.z, o.z);
      o.w = stage2_math<kApply>(tv, uv.w, o.w);
      reinterpret_cast<float4*>(out)[i] = o;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    out[i] = stage2_math<kApply>(tv, u[i], kApply ? out[i] : 0.f);
  }
}

}  // namespace

cudaError_t lamb_stage1(const LambStage1Tensor* tensors,
                        const LambChunk* chunks, int64_t n_chunks,
                        int chunk_size, const float* denom,
                        const LambStage1Scalars& s, DType g_dtype,
                        cudaStream_t stream) {
  if (n_chunks <= 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(n_chunks));
  if (g_dtype == kBFloat16) {
    lamb_stage1_kernel<true><<<grid, kThreads, 0, stream>>>(
        tensors, chunks, chunk_size, denom, s);
  } else {
    lamb_stage1_kernel<false><<<grid, kThreads, 0, stream>>>(
        tensors, chunks, chunk_size, denom, s);
  }
  return cudaGetLastError();
}

cudaError_t lamb_stage2(const LambStage2Tensor* tensors,
                        const LambChunk* chunks, int64_t n_chunks,
                        int chunk_size, const float* t, bool apply,
                        cudaStream_t stream) {
  if (n_chunks <= 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(n_chunks));
  if (apply) {
    lamb_stage2_kernel<true><<<grid, kThreads, 0, stream>>>(
        tensors, chunks, chunk_size, t);
  } else {
    lamb_stage2_kernel<false><<<grid, kThreads, 0, stream>>>(
        tensors, chunks, chunk_size, t);
  }
  return cudaGetLastError();
}

}  // namespace bert_kernels
