// What the flash kernels (flash_attention.cu and flash_attention_bwd.cu)
// share: the Pallas kernels' segment tile-skip test and the counter-hash
// dropout mask.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kSegBig = 1 << 30;  // above any real segment id

// Do two tiles' [min non-pad, max] segment ranges meet? (`_seg_overlap`)
__device__ __forceinline__ bool seg_overlap(int qmn, int qmx, int kmn,
                                            int kmx) {
  return qmx > 0 && kmx > 0 && qmx >= kmn && kmx >= qmn;
}

// The two multiply-xorshift rounds of `_keep_mask` on the mixed word x =
// (row * 0x9E3779B1) ^ (col * 0x85EBCA77) ^ seed_bh; an element is kept
// iff the top 23 bits of the result are >= the threshold.
__device__ __forceinline__ uint32_t flash_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x;
}

// `_keep_mask` for one (query, key) element. seed_bh = seed + bh *
// 0xC2B2AE3D in uint32.
__device__ __forceinline__ bool flash_keep(uint32_t row, uint32_t col,
                                           uint32_t seed_bh,
                                           uint32_t threshold) {
  return (flash_hash((row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ seed_bh) >>
          9) >= threshold;
}

__device__ __forceinline__ uint32_t seed_bh_of(const FlashDropout& d, int b,
                                               int heads, int h) {
  return d.seed + static_cast<uint32_t>(b * heads + h) * 0xC2B2AE3Du;
}

}  // namespace
}  // namespace bert_kernels
