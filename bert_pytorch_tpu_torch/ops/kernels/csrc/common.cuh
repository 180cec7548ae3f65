// Device helpers shared by the port's kernels: element-type traits (bf16 is
// handled as raw 16-bit words and widened to f32 by a shift, so no file
// needs the bf16 conversion operators that PyTorch's build flags switch
// off) and warp reductions.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bert_kernels {

struct F32 {
  using raw = float;
  static __device__ __forceinline__ float to_f32(raw v) { return v; }
  static __device__ __forceinline__ raw from_f32(float v) { return v; }
};

struct BF16 {
  using raw = uint16_t;
  static __device__ __forceinline__ float to_f32(raw v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ raw from_f32(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// two f32 -> one 32-bit word of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t out;
  memcpy(&out, &v, sizeof(out));
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC consecutive elements through one 16-byte access when VEC * sizeof
// fills it, else element by element
template <int VEC, typename R>
__device__ __forceinline__ void load_vec(const R* p, R (&v)[VEC]) {
  if constexpr (VEC * sizeof(R) == 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &u, 16);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

template <int VEC, typename R>
__device__ __forceinline__ void store_vec(R* p, const R (&v)[VEC]) {
  if constexpr (VEC * sizeof(R) == 16) {
    uint4 u;
    memcpy(&u, v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

}  // namespace bert_kernels
