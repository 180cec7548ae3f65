// LayerNorm forward and backward, and the fused residual-dropout-LayerNorm
// forward and backward, for Hopper.
//
// Replaces four Pallas kernels of bert_pytorch_tpu/ops/pallas/layernorm.py:
//
//   _fwd_kernel       (layer_norm_pallas)          -> layer_norm_fwd
//   _bwd_kernel       (its _bwd_rule)              -> layer_norm_bwd
//   _adln_fwd_kernel  (add_dropout_layer_norm_pallas) -> adln_fwd
//   _adln_bwd_kernel  (its _adln_bwd_rule)         -> adln_bwd
//
// Forward: y = (h - mean) * rstd * scale + bias over the last axis, eps
// 1e-12, statistics in f32, y in the input dtype, mean and rstd written in
// f32 for the backward pass. For LayerNorm h = x; for the fused op
// h = f32(residual) + dropout(f32(x)), where dropout keeps an element iff
// the counter hash of (flat row, column, seed) exceeds rate * 2^32
// (ops/layernorm.row_col_keep) and divides kept values by f32(1 - rate).
// The mask is evaluated in the kernel, forward and backward, and never
// stored. The division is a true IEEE division (no fast math), as the
// reference divides.
//
// Backward: with xhat = (h - mean) * rstd and gs = g * scale,
//   dh = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
// dx = dh for LayerNorm; for the fused op dres = dh and
// dx = keep ? dh / (1 - rate) : 0. dscale = sum over rows of g * xhat and
// dbias = sum over rows of g.
//
// What bounds them: memory. At BERT-Large's training shape (12288, 1024)
// in bf16 they do tens of flops per element against 4-10 bytes moved,
// far below the card's balance point. So each reads every input from
// device memory once: one warp owns one row and loads it with 16-byte
// accesses. The forward at BERT-Large's width (1024) is specialised on
// the width (ln_fwd_row_kernel): a lane's share of the row (32 elements)
// and of the residual is loaded by 16-byte accesses
// all issued before the first use, so the row's DRAM round trips overlap
// instead of following one another, and the row stays in registers for
// the two reduction passes; scale and bias are read as float4, and the
// launch needs no dynamic shared memory (no attribute call). Other widths
// take ln_fwd_kernel, which stages the row in shared memory as f32. Both
// give the same statistics and y: the same per-lane sum order, the same
// mask, the same IEEE division.
//
// The backward at width 1024 in bf16 (ln_bwd_row_kernel, the training
// paths' backward) moves 5 bytes of DRAM traffic an element (3 for #2) for
// each 30-odd operations; what held the first version (ln_bwd_kernel, kept
// for other widths, f32 and unaligned tensors) at 3.5x its bound was
// latency: each warp staged one row at a time in shared memory as f32
// (64 KB a CTA, so 3 CTAs an SM), and no row's loads overlapped another's
// work. So each lane copies its 16-byte runs of a row's x, residual and g
// into a ring of three rows in shared memory by cp.async, two rows ahead
// of the row it works on: 8 warps an SM keep 16 rows (96 KB) in flight.
// The row's arithmetic runs in registers (32 elements a lane), scale stays
// in registers across the warp's rows, the keep mask is one uint32 a lane
// a row (the hash runs once an element), and dscale and dbias accumulate
// in registers over the warp's rows; the warps combine them through shared
// memory once, at the end.
//
// The cross-row sums of the backward: the Pallas kernel adds each grid
// step's partial into one output block, which is legal only because TPU
// grid steps run in order. Hopper CTAs run in no fixed order, and float
// atomics would make the sums depend on it. So each CTA owns a fixed set
// of rows, fixed by the shape alone (never by the SM count), adds its
// warps' partials in warp order and writes one (cols,) partial per CTA;
// a second launch spread over the card (column_sum_kernel: 32 columns a
// CTA, each warp a fixed slice of the partials, the slices added in warp
// order) sums them in an order fixed by the shape. A rerun gives
// identical bits.
#include "common.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kWarps = 4;
// rows each warp of a backward CTA owns: a CTA covers kWarps * this rows
constexpr int kRowsPerWarp = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a Hopper block's limit

// row_col_keep for one element: two multiply-xorshift rounds over the
// (row, column) counter and the seed (`seed_term` = seed * 0xC2B2AE3D),
// kept iff the hash is above `threshold` = rate * 2^32.
__device__ __forceinline__ bool keep_element(uint32_t row, uint32_t col,
                                             uint32_t seed_term,
                                             uint32_t threshold) {
  uint32_t h = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  h ^= seed_term;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h > threshold;
}

// Element i of a lane's chunk sits at chunk_base + i * 32 + lane in the
// warp's shared-memory row: consecutive lanes hit consecutive banks. The
// buffer is cols rounded up to whole chunks, since that layout spans the
// last chunk.
template <int VEC>
__host__ __device__ __forceinline__ int padded_cols(int cols) {
  return (cols + 32 * VEC - 1) / (32 * VEC) * (32 * VEC);
}

// h for VEC elements starting at column c of `row`: x alone, or
// f32(residual) + dropout(f32(x)).
template <typename T, int VEC, bool kResidual>
__device__ __forceinline__ void load_h(const typename T::raw* xr,
                                       const typename T::raw* rr, int64_t row,
                                       int c, const DropoutArgs& d,
                                       float (&h)[VEC], bool (&keep)[VEC]) {
  using raw = typename T::raw;
  raw v[VEC];
  load_vec<VEC>(xr + c, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    h[i] = T::to_f32(v[i]);
    keep[i] = true;
  }
  if constexpr (kResidual) {
    raw r[VEC];
    load_vec<VEC>(rr + c, r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (d.apply) {
        keep[i] = keep_element(static_cast<uint32_t>(row),
                               static_cast<uint32_t>(c + i), d.seed_term,
                               d.threshold);
        h[i] = keep[i] ? h[i] / d.keep_div : 0.f;
      }
      h[i] = T::to_f32(r[i]) + h[i];
    }
  }
}

template <typename T, int VEC, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const typename T::raw* __restrict__ x,
              const typename T::raw* __restrict__ residual,
              const float* __restrict__ scale, const float* __restrict__ bias,
              typename T::raw* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int64_t rows, int cols, float eps,
              DropoutArgs d) {
  using raw = typename T::raw;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  constexpr int kChunk = 32 * VEC;
  float* buf = smem + static_cast<size_t>(warp) * padded_cols<VEC>(cols);
  const raw* xr = x + row * cols;
  const raw* rr = kResidual ? residual + row * cols : nullptr;
  raw* yr = y + row * cols;

  float sum = 0.f;
  for (int base = 0; base < cols; base += kChunk) {
    const int c = base + lane * VEC;
    if (c < cols) {
      float h[VEC];
      bool keep[VEC];
      load_h<T, VEC, kResidual>(xr, rr, row, c, d, h, keep);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        buf[base + i * 32 + lane] = h[i];
        sum += h[i];
      }
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(cols);

  float sq = 0.f;
  for (int base = 0; base < cols; base += kChunk) {
    if (base + lane * VEC < cols) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float dv = buf[base + i * 32 + lane] - mu;
        sq += dv * dv;
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

// ln_fwd_kernel at a width COLS fixed at compile time, the row in
// registers: lane `lane` holds columns j * 32 * VEC + lane * VEC + i (the
// generic kernel's chunks, summed in the same order).
template <typename T, int VEC, int COLS, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_row_kernel(const typename T::raw* __restrict__ x,
                  const typename T::raw* __restrict__ residual,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  typename T::raw* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int64_t rows, float eps, DropoutArgs d) {
  using raw = typename T::raw;
  constexpr int kChunk = 32 * VEC;   // columns one warp access covers
  constexpr int kN = COLS / kChunk;  // accesses a lane makes
  static_assert(COLS % kChunk == 0 && VEC % 4 == 0, "whole chunks");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const raw* xr = x + row * COLS + lane * VEC;
  raw xv[kN][VEC], rv[kN][VEC];
#pragma unroll
  for (int j = 0; j < kN; ++j) load_vec<VEC>(xr + j * kChunk, xv[j]);
  if constexpr (kResidual) {
    const raw* rr = residual + row * COLS + lane * VEC;
#pragma unroll
    for (int j = 0; j < kN; ++j) load_vec<VEC>(rr + j * kChunk, rv[j]);
  }

  float h[kN][VEC];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = T::to_f32(xv[j][i]);
      if constexpr (kResidual) {
        if (d.apply) {
          const int c = j * kChunk + lane * VEC + i;
          v = keep_element(static_cast<uint32_t>(row), static_cast<uint32_t>(c),
                           d.seed_term, d.threshold)
                  ? v / d.keep_div
                  : 0.f;
        }
        v = T::to_f32(rv[j][i]) + v;
      }
      h[j][i] = v;
      sum += v;
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(COLS);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float dv = h[j][i] - mu;
      sq += dv * dv;
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / static_cast<float>(COLS) + eps);

  raw* yr = y + row * COLS + lane * VEC;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int c = j * kChunk + lane * VEC;
    float sc[VEC], bi[VEC];
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(scale + c + q);
      const float4 b4 = *reinterpret_cast<const float4*>(bias + c + q);
      sc[q] = s4.x, sc[q + 1] = s4.y, sc[q + 2] = s4.z, sc[q + 3] = s4.w;
      bi[q] = b4.x, bi[q + 1] = b4.y, bi[q + 2] = b4.z, bi[q + 3] = b4.w;
    }
    raw o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float yv = (h[j][i] - mu) * rs;
      o[i] = T::from_f32(yv * sc[i] + bi[i]);
    }
    store_vec<VEC>(yr + j * kChunk, o);
  }
  if (lane == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rs;
  }
}

// ln_bwd_kernel at width 1024 in bf16. Warp w of CTA b owns rows
// b * kRowWarps * rows_per_warp + w + k * kRowWarps for k = 0, 1, ...
// (rows_per_warp of them, fewer in the last CTA); lane `lane` holds
// columns j * 256 + lane * 8 + i of each. Each lane copies its own 16-byte
// runs of a row's x, residual and g (12) into a ring of kRowStages rows in
// shared memory by cp.async, kRowStages - 1 rows ahead of the row it works
// on, and reads back only what it copied: no barrier, no mbarrier, only
// its own cp.async groups.
constexpr int kRowWarps = 8;
// rows_per_warp = ceil(rows / this): 1024 warps, 128 CTAs, one an SM
constexpr int kRowTargetWarps = 1024;
constexpr int kRowCols = 1024;  // BERT-Large's width, the one every path
                                // on the card runs
constexpr int kRowN = kRowCols / 256;  // 16-byte runs a lane a tensor
constexpr int kRowStages = 3;
// one ring slot: a warp's row of x, [residual,] g, 16-byte runs in the
// order (tensor, j, lane)
template <bool kResidual>
__host__ __device__ constexpr int row_slot_bytes() {
  return (kResidual ? 3 : 2) * kRowN * 32 * 16;
}
template <bool kResidual>
__host__ __device__ constexpr int row_smem_bytes() {
  return kRowWarps * kRowStages * row_slot_bytes<kResidual>();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this lane's runs of `row` into its ring slot
template <bool kResidual>
__device__ __forceinline__ void copy_bwd_row(uint4* slot, const uint16_t* x,
                                             const uint16_t* residual,
                                             const uint16_t* g, int64_t row,
                                             int lane) {
  const int64_t off = row * kRowCols + lane * 8;
  int t = 0;
#pragma unroll
  for (int j = 0; j < kRowN; ++j)
    cp_async16(slot + (t * kRowN + j) * 32 + lane, x + off + j * 256);
  if constexpr (kResidual) {
    ++t;
#pragma unroll
    for (int j = 0; j < kRowN; ++j)
      cp_async16(slot + (t * kRowN + j) * 32 + lane,
                 residual + off + j * 256);
  }
  ++t;
#pragma unroll
  for (int j = 0; j < kRowN; ++j)
    cp_async16(slot + (t * kRowN + j) * 32 + lane, g + off + j * 256);
}

// An empty asm that claims to change v: values computed from v before it
// are not reused after it, so the compiler keeps v's 4 registers live
// rather than every value it derived from them.
__device__ __forceinline__ void opaque(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

// element e (0..7, known at compile time) of a 16-byte run of bf16,
// widened to f32
__device__ __forceinline__ float bf16_at(const uint4& v, int e) {
  const int k = e >> 1;
  const uint32_t w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// one row from this lane's ring slot: dx (and dres) stored, g * xhat and g
// added to the lane's dscale and dbias sums
template <bool kResidual>
__device__ __forceinline__ void bwd_row(const uint4* slot, float mu, float rs,
                                        int64_t row, int lane,
                                        const float (&sc)[kRowN][8],
                                        float (&acc_s)[kRowN][8],
                                        float (&acc_b)[kRowN][8],
                                        uint16_t* dx, uint16_t* dres,
                                        const DropoutArgs& d, float inv_keep) {
  constexpr int kG = kResidual ? 2 : 1;  // g's tensor index in the slot
  // keep bit j * 8 + i of column j * 256 + lane * 8 + i (all set when no
  // dropout applies): row_col_keep's hash, the row term once a row
  uint32_t keep = 0xFFFFFFFFu;
  if (kResidual && d.apply) {
    keep = 0;
    const uint32_t row_term =
        (static_cast<uint32_t>(row) * 0x9E3779B1u) ^ d.seed_term;
    const uint32_t lane_term = static_cast<uint32_t>(lane * 8) * 0x85EBCA77u;
#pragma unroll
    for (int j = 0; j < kRowN; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t h = row_term ^ (lane_term + static_cast<uint32_t>(
                                                 j * 256 + i) * 0x85EBCA77u);
        h ^= h >> 16;
        h *= 0x7FEB352Du;
        h ^= h >> 15;
        h *= 0x846CA68Bu;
        keep |= static_cast<uint32_t>(h > d.threshold) << (j * 8 + i);
      }
    }
  }
  float h[kRowN][8];
  uint4 gw[kRowN];
  float s1 = 0.f, s2 = 0.f;  // sum(gs), sum(gs * xhat)
#pragma unroll
  for (int j = 0; j < kRowN; ++j) {
    const uint4 xw = slot[j * 32 + lane];
    [[maybe_unused]] uint4 rw{};
    if constexpr (kResidual) rw = slot[(kRowN + j) * 32 + lane];
    gw[j] = slot[(kG * kRowN + j) * 32 + lane];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = bf16_at(xw, i);
      if constexpr (kResidual) {
        if (d.apply) v = (keep >> (j * 8 + i)) & 1u ? v * inv_keep : 0.f;
        v = bf16_at(rw, i) + v;
      }
      h[j][i] = v;
      const float gs = bf16_at(gw[j], i) * sc[j][i];
      s1 += gs;
      s2 += gs * ((v - mu) * rs);
    }
  }
  const float m1 = warp_sum(s1) / static_cast<float>(kRowCols);
  const float m2 = warp_sum(s2) / static_cast<float>(kRowCols);
  // between the two passes only h and g's 16 words stay live: g and
  // g * scale are formed again from them
#pragma unroll
  for (int j = 0; j < kRowN; ++j) opaque(gw[j]);

  const int64_t off = row * kRowCols + lane * 8;
#pragma unroll
  for (int j = 0; j < kRowN; ++j) {
    uint32_t ox[4], orr[4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float dh[2], dxv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float gf = bf16_at(gw[j], i + u);
        const float xhat = (h[j][i + u] - mu) * rs;
        const float gs = gf * sc[j][i + u];
        dh[u] = rs * (gs - m1 - xhat * m2);
        acc_s[j][i + u] += gf * xhat;
        acc_b[j][i + u] += gf;
        dxv[u] = dh[u];
        if (kResidual && d.apply)
          dxv[u] = (keep >> (j * 8 + i + u)) & 1u ? dh[u] * inv_keep : 0.f;
      }
      ox[i / 2] = pack_bf16(dxv[0], dxv[1]);
      orr[i / 2] = pack_bf16(dh[0], dh[1]);
    }
    *reinterpret_cast<uint4*>(dx + off + j * 256) =
        make_uint4(ox[0], ox[1], ox[2], ox[3]);
    if constexpr (kResidual)
      *reinterpret_cast<uint4*>(dres + off + j * 256) =
          make_uint4(orr[0], orr[1], orr[2], orr[3]);
  }
}

// One (kRowCols,) partial of a CTA: its warps' register sums added in
// warp order through shared memory (`stage`, 32 KB), one column a thread.
__device__ __forceinline__ void cta_partial(const float (&acc)[kRowN][8],
                                            float4* stage, int warp, int lane,
                                            float* out) {
  float4* mine = stage + warp * (kRowCols / 4);
#pragma unroll
  for (int j = 0; j < kRowN; ++j) {
    mine[j * 64 + lane * 2] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    mine[j * 64 + lane * 2 + 1] =
        make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
  }
  __syncthreads();
  const float* flat = reinterpret_cast<const float*>(stage);
  for (int c = threadIdx.x; c < kRowCols; c += kRowWarps * 32) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) v += flat[w * kRowCols + c];
    out[c] = v;
  }
  __syncthreads();
}

template <bool kResidual>
__global__ void __launch_bounds__(kRowWarps * 32, 1)
ln_bwd_row_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ residual,
                  const float* __restrict__ scale,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const uint16_t* __restrict__ g, uint16_t* __restrict__ dx,
                  uint16_t* __restrict__ dres, float* __restrict__ partial,
                  int64_t rows, int rows_per_warp, DropoutArgs d) {
  extern __shared__ uint4 ring[];
  constexpr int kSlot = row_slot_bytes<kResidual>() / 16;  // uint4s
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint4* slots = ring + warp * kRowStages * kSlot;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowWarps *
                            rows_per_warp + warp;
  // the warp's rows: first + k * kRowWarps for k < n
  int n = 0;
  if (first < rows) {
    const int64_t left = (rows - first + kRowWarps - 1) / kRowWarps;
    n = left < rows_per_warp ? static_cast<int>(left) : rows_per_warp;
  }
  // rows 0 .. kRowStages - 2 in flight before the first is worked on; one
  // cp.async group a row (empty past the last), so that waiting for all
  // but the newest kRowStages - 1 groups means row k has landed
#pragma unroll
  for (int k = 0; k < kRowStages - 1; ++k) {
    if (k < n)
      copy_bwd_row<kResidual>(slots + k * kSlot, x, residual, g,
                              first + static_cast<int64_t>(k) * kRowWarps,
                              lane);
    cp_async_commit();
  }
  const float inv_keep = 1.f / d.keep_div;
  float sc[kRowN][8], acc_s[kRowN][8], acc_b[kRowN][8];
#pragma unroll
  for (int j = 0; j < kRowN; ++j) {
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          scale + j * 256 + lane * 8 + q);
      sc[j][q] = s4.x, sc[j][q + 1] = s4.y, sc[j][q + 2] = s4.z,
      sc[j][q + 3] = s4.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_s[j][i] = acc_b[j][i] = 0.f;
  }
  float mu = 0.f, rs = 0.f;
  if (n > 0) mu = mean[first], rs = rstd[first];
  for (int k = 0; k < n; ++k) {
    const int64_t row = first + static_cast<int64_t>(k) * kRowWarps;
    const int ahead = k + kRowStages - 1;
    if (ahead < n)
      copy_bwd_row<kResidual>(slots + (ahead % kRowStages) * kSlot, x,
                              residual, g,
                              first + static_cast<int64_t>(ahead) * kRowWarps,
                              lane);
    cp_async_commit();
    // the next row's statistics, in flight while this row is worked on
    float mu_next = 0.f, rs_next = 0.f;
    if (k + 1 < n) {
      mu_next = mean[row + kRowWarps];
      rs_next = rstd[row + kRowWarps];
    }
    cp_async_wait<kRowStages - 1>();
    bwd_row<kResidual>(slots + (k % kRowStages) * kSlot, mu, rs, row, lane,
                       sc, acc_s, acc_b, dx, dres, d, inv_keep);
    mu = mu_next;
    rs = rs_next;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: its first 32 KB stage the partials

  // this CTA's partials of dscale, then dbias
  float4* stage = reinterpret_cast<float4*>(ring);
  float* out = partial + static_cast<size_t>(blockIdx.x) * kRowCols;
  cta_partial(acc_s, stage, warp, lane, out);
  cta_partial(acc_b, stage, warp, lane,
              out + static_cast<size_t>(gridDim.x) * kRowCols);
}

// Shared memory of a backward CTA, per warp: h and g of the current row
// (f32), and the warp's running dscale and dbias partials.
template <typename T, int VEC, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_kernel(const typename T::raw* __restrict__ x,
              const typename T::raw* __restrict__ residual,
              const float* __restrict__ scale,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const typename T::raw* __restrict__ g,
              typename T::raw* __restrict__ dx,
              typename T::raw* __restrict__ dres,
              float* __restrict__ partial, int64_t rows, int cols,
              DropoutArgs d) {
  using raw = typename T::raw;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kChunk = 32 * VEC;
  const int padded = padded_cols<VEC>(cols);
  float* hbuf = smem + static_cast<size_t>(warp) * 4 * padded;
  float* gbuf = hbuf + padded;
  float* acc_s = gbuf + padded;
  float* acc_b = acc_s + padded;
  for (int j = lane; j < padded; j += 32) {
    acc_s[j] = 0.f;
    acc_b[j] = 0.f;
  }

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps *
                        kRowsPerWarp;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int64_t row = first + static_cast<int64_t>(k) * kWarps + warp;
    if (row >= rows) break;
    const raw* xr = x + row * cols;
    const raw* rr = kResidual ? residual + row * cols : nullptr;
    const raw* gr = g + row * cols;
    const float mu = mean[row];
    const float rs = rstd[row];

    float s1 = 0.f, s2 = 0.f;  // sum(gs), sum(gs * xhat)
    for (int base = 0; base < cols; base += kChunk) {
      const int c = base + lane * VEC;
      if (c < cols) {
        float h[VEC];
        bool keep[VEC];
        load_h<T, VEC, kResidual>(xr, rr, row, c, d, h, keep);
        raw gv[VEC];
        load_vec<VEC>(gr + c, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gf = T::to_f32(gv[i]);
          const float xhat = (h[i] - mu) * rs;
          const float gs = gf * scale[c + i];
          s1 += gs;
          s2 += gs * xhat;
          hbuf[base + i * 32 + lane] = h[i];
          gbuf[base + i * 32 + lane] = gf;
        }
      }
    }
    const float m1 = warp_sum(s1) / static_cast<float>(cols);
    const float m2 = warp_sum(s2) / static_cast<float>(cols);

    raw* dxr = dx + row * cols;
    raw* drr = kResidual ? dres + row * cols : nullptr;
    for (int base = 0; base < cols; base += kChunk) {
      const int c = base + lane * VEC;
      if (c < cols) {
        raw ox[VEC], orr[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int j = base + i * 32 + lane;
          const float gf = gbuf[j];
          const float xhat = (hbuf[j] - mu) * rs;
          const float gs = gf * scale[c + i];
          const float dh = rs * (gs - m1 - xhat * m2);
          acc_s[j] += gf * xhat;
          acc_b[j] += gf;
          if constexpr (kResidual) {
            orr[i] = T::from_f32(dh);
            float dxv = dh;
            if (d.apply)
              dxv = keep_element(static_cast<uint32_t>(row),
                                 static_cast<uint32_t>(c + i), d.seed_term,
                                 d.threshold)
                        ? dh / d.keep_div
                        : 0.f;
            ox[i] = T::from_f32(dxv);
          } else {
            ox[i] = T::from_f32(dh);
          }
        }
        store_vec<VEC>(dxr + c, ox);
        if constexpr (kResidual) store_vec<VEC>(drr + c, orr);
      }
    }
  }
  __syncthreads();
  // this CTA's partial: its warps' sums added in warp order; slot j of the
  // chunked layout holds column base + lane * VEC + i
  float* out_s = partial + static_cast<size_t>(blockIdx.x) * cols;
  float* out_b = partial + (static_cast<size_t>(gridDim.x) +
                            blockIdx.x) * cols;
  for (int j = threadIdx.x; j < padded; j += blockDim.x) {
    const int base = j / kChunk * kChunk;
    const int rem = j - base;
    const int col = base + (rem & 31) * VEC + rem / 32;
    if (col >= cols) continue;
    float s = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += smem[static_cast<size_t>(w) * 4 * padded + 2 * padded + j];
      b += smem[static_cast<size_t>(w) * 4 * padded + 3 * padded + j];
    }
    out_s[col] = s;
    out_b[col] = b;
  }
}

// dscale / dbias: the (2, parts, cols) partials summed column by column.
// CTA b owns 32 columns of one of the two sums; its warp w adds partials
// w, w + kColWarps, ... in that order (a lane a column: 128-byte reads),
// and warp 0 adds the warps' sums in warp order.
constexpr int kColWarps = 8;

__global__ void __launch_bounds__(kColWarps * 32)
column_sum_kernel(const float* __restrict__ partial, int parts, int cols,
                  float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float sums[kColWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (cols + 31) / 32;
  const int which = blockIdx.x / groups;
  const int col = (blockIdx.x - which * groups) * 32 + lane;
  float s = 0.f;
  if (col < cols) {
    const float* p = partial + static_cast<size_t>(which) * parts * cols + col;
#pragma unroll 4
    for (int b = warp; b < parts; b += kColWarps)
      s += p[static_cast<size_t>(b) * cols];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) t += sums[w][lane];
    (which == 0 ? dscale : dbias)[col] = t;
  }
}

cudaError_t launch_column_sum(const BwdParams& p, int parts,
                              cudaStream_t stream) {
  const int groups = (p.cols + 31) / 32;
  column_sum_kernel<<<2 * groups, kColWarps * 32, 0, stream>>>(
      p.partial, parts, p.cols, p.dscale, p.dbias);
  return cudaGetLastError();
}

int generic_bwd_ctas(int64_t rows) {
  const int64_t per_cta = static_cast<int64_t>(kWarps) * kRowsPerWarp;
  return static_cast<int>((rows + per_cta - 1) / per_cta);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int VEC, bool kResidual>
cudaError_t launch_fwd(const void* x, const void* residual,
                       const float* scale, const float* bias, void* y,
                       float* mean, float* rstd, int64_t rows, int cols,
                       float eps, const DropoutArgs& d, cudaStream_t stream) {
  using raw = typename T::raw;
  auto kernel = ln_fwd_kernel<T, VEC, kResidual>;
  const size_t smem =
      static_cast<size_t>(kWarps) * padded_cols<VEC>(cols) * sizeof(float);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const raw*>(x), static_cast<const raw*>(residual), scale,
      bias, static_cast<raw*>(y), mean, rstd, rows, cols, eps, d);
  return cudaGetLastError();
}

template <typename T, int VEC, bool kResidual>
cudaError_t launch_bwd(const BwdParams& p, const DropoutArgs& d,
                       cudaStream_t stream) {
  using raw = typename T::raw;
  auto kernel = ln_bwd_kernel<T, VEC, kResidual>;
  const size_t smem = static_cast<size_t>(kWarps) * 4 *
                      padded_cols<VEC>(p.cols) * sizeof(float);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const int ctas = generic_bwd_ctas(p.rows);
  kernel<<<ctas, kWarps * 32, smem, stream>>>(
      static_cast<const raw*>(p.x), static_cast<const raw*>(p.residual),
      p.scale, p.mean, p.rstd, static_cast<const raw*>(p.g),
      static_cast<raw*>(p.dx), static_cast<raw*>(p.dres), p.partial, p.rows,
      p.cols, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(p, ctas, stream);
}

// rows a warp of ln_bwd_row_kernel owns, and its CTAs: fixed by the row
// count alone
int row_rows_per_warp(int64_t rows) {
  return static_cast<int>((rows + kRowTargetWarps - 1) / kRowTargetWarps);
}

int row_bwd_ctas(int64_t rows) {
  const int64_t per_cta =
      static_cast<int64_t>(kRowWarps) * row_rows_per_warp(rows);
  return static_cast<int>((rows + per_cta - 1) / per_cta);
}

template <bool kResidual>
cudaError_t launch_bwd_row(const BwdParams& p, const DropoutArgs& d,
                           cudaStream_t stream) {
  static_assert(row_smem_bytes<kResidual>() >= kRowWarps * kRowCols * 4,
                "the ring stages the CTA's partials after the loop");
  constexpr int smem = row_smem_bytes<kResidual>();
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(ln_bwd_row_kernel<kResidual>), smem);
  if (err != cudaSuccess) return err;
  const int ctas = row_bwd_ctas(p.rows);
  ln_bwd_row_kernel<kResidual><<<ctas, kRowWarps * 32, smem, stream>>>(
      static_cast<const uint16_t*>(p.x),
      static_cast<const uint16_t*>(p.residual), p.scale, p.mean, p.rstd,
      static_cast<const uint16_t*>(p.g), static_cast<uint16_t*>(p.dx),
      static_cast<uint16_t*>(p.dres), p.partial, p.rows,
      row_rows_per_warp(p.rows), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(p, ctas, stream);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int VEC, int COLS, bool kResidual>
cudaError_t launch_fwd_row(const void* x, const void* residual,
                           const float* scale, const float* bias, void* y,
                           float* mean, float* rstd, int64_t rows, float eps,
                           const DropoutArgs& d, cudaStream_t stream) {
  using raw = typename T::raw;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  auto kernel = ln_fwd_row_kernel<T, VEC, COLS, kResidual>;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const raw*>(x), static_cast<const raw*>(residual), scale,
      bias, static_cast<raw*>(y), mean, rstd, rows, eps, d);
  return cudaGetLastError();
}

template <bool kResidual>
cudaError_t dispatch_fwd(const void* x, const void* residual,
                         const float* scale, const float* bias, void* y,
                         float* mean, float* rstd, int64_t rows, int cols,
                         float eps, DType dtype, const DropoutArgs& d,
                         cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const bool aligned = aligned16(x) && aligned16(y) && aligned16(residual);
  if (cols == kRowCols && aligned && aligned16(scale) && aligned16(bias)) {
    if (dtype == kBFloat16)
      return launch_fwd_row<BF16, 8, kRowCols, kResidual>(
          x, residual, scale, bias, y, mean, rstd, rows, eps, d, stream);
    return launch_fwd_row<F32, 4, kRowCols, kResidual>(
        x, residual, scale, bias, y, mean, rstd, rows, eps, d, stream);
  }
  if (dtype == kBFloat16) {
    if (aligned && cols % 8 == 0)
      return launch_fwd<BF16, 8, kResidual>(x, residual, scale, bias, y, mean,
                                            rstd, rows, cols, eps, d, stream);
    return launch_fwd<BF16, 1, kResidual>(x, residual, scale, bias, y, mean,
                                          rstd, rows, cols, eps, d, stream);
  }
  if (aligned && cols % 4 == 0)
    return launch_fwd<F32, 4, kResidual>(x, residual, scale, bias, y, mean,
                                         rstd, rows, cols, eps, d, stream);
  return launch_fwd<F32, 1, kResidual>(x, residual, scale, bias, y, mean,
                                       rstd, rows, cols, eps, d, stream);
}

// the backward's route: ln_bwd_row_kernel for bf16 at width 1024 with
// every row tensor and scale 16-byte aligned, else ln_bwd_kernel
bool takes_row_kernel(const BwdParams& p, DType dtype) {
  return dtype == kBFloat16 && p.cols == kRowCols && aligned16(p.x) &&
         aligned16(p.residual) && aligned16(p.g) && aligned16(p.dx) &&
         aligned16(p.dres) && aligned16(p.scale);
}

template <bool kResidual>
cudaError_t dispatch_bwd(const BwdParams& p, DType dtype,
                         const DropoutArgs& d, cudaStream_t stream) {
  if (p.rows == 0) return cudaSuccess;
  if (takes_row_kernel(p, dtype))
    return launch_bwd_row<kResidual>(p, d, stream);
  const bool aligned = aligned16(p.x) && aligned16(p.residual) &&
                       aligned16(p.g) && aligned16(p.dx) &&
                       aligned16(p.dres);
  if (dtype == kBFloat16) {
    if (aligned && p.cols % 8 == 0)
      return launch_bwd<BF16, 8, kResidual>(p, d, stream);
    return launch_bwd<BF16, 1, kResidual>(p, d, stream);
  }
  if (aligned && p.cols % 4 == 0)
    return launch_bwd<F32, 4, kResidual>(p, d, stream);
  return launch_bwd<F32, 1, kResidual>(p, d, stream);
}

}  // namespace

int bwd_ctas(const BwdParams& p, DType dtype) {
  return takes_row_kernel(p, dtype) ? row_bwd_ctas(p.rows)
                                    : generic_bwd_ctas(p.rows);
}

int max_bwd_cols() {
  // four f32 rows of shared memory per warp, rounded to whole bf16 chunks
  return static_cast<int>(kMaxSmem / (kWarps * 4 * sizeof(float))) / 256 *
         256;
}

cudaError_t layer_norm_fwd(const void* x, const float* scale,
                           const float* bias, void* y, float* mean,
                           float* rstd, int64_t rows, int cols, float eps,
                           DType dtype, cudaStream_t stream) {
  return dispatch_fwd<false>(x, nullptr, scale, bias, y, mean, rstd, rows,
                             cols, eps, dtype, DropoutArgs{}, stream);
}

cudaError_t adln_fwd(const void* x, const void* residual, const float* scale,
                     const float* bias, void* y, float* mean, float* rstd,
                     int64_t rows, int cols, float eps, DType dtype,
                     const DropoutArgs& dropout, cudaStream_t stream) {
  return dispatch_fwd<true>(x, residual, scale, bias, y, mean, rstd, rows,
                            cols, eps, dtype, dropout, stream);
}

cudaError_t layer_norm_bwd(const BwdParams& p, DType dtype,
                           cudaStream_t stream) {
  return dispatch_bwd<false>(p, dtype, DropoutArgs{}, stream);
}

cudaError_t adln_bwd(const BwdParams& p, DType dtype,
                     const DropoutArgs& dropout, cudaStream_t stream) {
  return dispatch_bwd<true>(p, dtype, dropout, stream);
}

}  // namespace bert_kernels
