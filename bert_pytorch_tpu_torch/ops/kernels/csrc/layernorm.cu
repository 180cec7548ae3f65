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
// The cross-row sums of the backward: the Pallas kernel adds each grid
// step's partial into one output block, which is legal only because TPU
// grid steps run in order. Hopper CTAs run in no fixed order, and float
// atomics would make the sums depend on it. So each CTA owns a fixed set
// of rows, its warps accumulate per-column partials in shared memory,
// combine them in warp order and write one (cols,) partial per CTA; a
// second small launch sums the CTA partials column by column in CTA order.
// A rerun gives identical bits.
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

// dscale / dbias: the (2, ctas, cols) partials summed over CTAs in order.
__global__ void column_sum_kernel(const float* __restrict__ partial,
                                  int ctas, int cols,
                                  float* __restrict__ dscale,
                                  float* __restrict__ dbias) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * cols) return;
  const int which = t / cols;
  const int col = t - which * cols;
  const float* p = partial + static_cast<size_t>(which) * ctas * cols + col;
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s += p[static_cast<size_t>(b) * cols];
  (which == 0 ? dscale : dbias)[col] = s;
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
  const int ctas = bwd_ctas(p.rows);
  kernel<<<ctas, kWarps * 32, smem, stream>>>(
      static_cast<const raw*>(p.x), static_cast<const raw*>(p.residual),
      p.scale, p.mean, p.rstd, static_cast<const raw*>(p.g),
      static_cast<raw*>(p.dx), static_cast<raw*>(p.dres), p.partial, p.rows,
      p.cols, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  column_sum_kernel<<<(2 * p.cols + threads - 1) / threads, threads, 0,
                      stream>>>(p.partial, ctas, p.cols, p.dscale, p.dbias);
  return cudaGetLastError();
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

// BERT-Large's width, the one every path on the card runs
constexpr int kRowCols = 1024;

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

template <bool kResidual>
cudaError_t dispatch_bwd(const BwdParams& p, DType dtype,
                         const DropoutArgs& d, cudaStream_t stream) {
  if (p.rows == 0) return cudaSuccess;
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

int bwd_ctas(int64_t rows) {
  const int64_t per_cta = static_cast<int64_t>(kWarps) * kRowsPerWarp;
  return static_cast<int>((rows + per_cta - 1) / per_cta);
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
