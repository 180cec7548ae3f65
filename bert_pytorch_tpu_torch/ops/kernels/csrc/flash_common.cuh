// What the flash kernels share: the Pallas kernels' segment tile-skip
// test, the segment range of a tile and the counter-hash dropout mask.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
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

// [min non-pad, max] segment id of n = 32 * N positions from `start`, the
// whole warp taking part
template <int N>
__device__ __forceinline__ void warp_seg_range(const int32_t* seg_row,
                                               int start, int lane, int& mn,
                                               int& mx) {
  int hi = 0, lo = kSegBig;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = seg_row[start + 32 * i + lane];
    hi = max(hi, v);
    if (v > 0) lo = min(lo, v);
  }
  mx = warp_max(hi);
  mn = warp_min(lo);
}

// the rest of `_keep_mask` once the row and column terms are mixed:
// x = (r ^ (r >> 16)) ^ (c ^ (c >> 16)) is the hash's input after its
// first xorshift
__device__ __forceinline__ uint32_t keep_mix(uint32_t x) {
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x;
}

__device__ __forceinline__ uint32_t seed_bh_of(const FlashDropout& d, int b,
                                               int heads, int h) {
  return d.seed + static_cast<uint32_t>(b * heads + h) * 0xC2B2AE3Du;
}

}  // namespace
}  // namespace bert_kernels
