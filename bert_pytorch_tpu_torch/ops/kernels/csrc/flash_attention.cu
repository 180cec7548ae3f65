// Flash-attention forward for Hopper.
//
// Replaces the Pallas forward kernels `_fwd_kernel_native` and `_fwd_kernel`
// (bert_pytorch_tpu/ops/pallas/flash_attention.py), one function in two
// grid layouts there: softmax(q k^T / sqrt(D) + bias) v with an online
// softmax, the packed-sequence mask (attend iff q_seg == k_seg and
// q_seg > 0, masked scores at -1e30), whole tiles skipped when their
// segment ranges do not meet (`_seg_overlap`), outputs of pad (segment-0)
// rows zeroed, and lse = m + log(max(l, 1e-30)) per row. No dropout: the
// serving path is deterministic, and the wrapper refuses a rate above 0.
//
// What bounds it: at BERT-Large's serving shape (8, 512, 16, 64) in bf16
// the function needs 8.6 GFLOP (less with packing) against 33.5 MB of
// q/k/v/out, about 8.7 us of dense bf16 tensor-core time against 10 us of
// HBM time on an H100 SXM: close to the balance point, so neither the
// (S, S) score matrix nor any transposed copy may touch device memory.
// The design: one CTA per (q-tile of 64 rows, head, batch); the q tile sits
// in shared memory (bf16: in registers as mma fragments); a loop streams
// K/V tiles through shared memory; scores, the running max/sum and the
// output accumulator stay in f32 registers. q/k/v are read in the model's
// (B, S, H, D) layout through their strides, so the fused QKV projection's
// output feeds the kernel without a transpose or a copy. bf16 products go
// through mma.sync m16n8k16 (bf16 in, f32 accumulate) on the tensor cores;
// f32 inputs go through f32 FMA. This is the simple version: no cp.async
// pipelining, no wgmma or TMA, which later work adds.
#include "common.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr int kSegBig = 1 << 30;   // above any real segment id
constexpr int kThreads = 128;

// [min non-pad, max] segment id over `n` positions starting at `start`
// (positions past `seq` count as pad). Every thread of the block calls it
// and gets the same answer; `red` is 8 ints of shared memory.
__device__ __forceinline__ void seg_range(const int32_t* __restrict__ seg_row,
                                          int start, int n, int seq, int* red,
                                          int& mn, int& mx) {
  const int tid = threadIdx.x;
  int v = 0;
  if (tid < n && start + tid < seq) v = seg_row[start + tid];
  int vmx = warp_max(v);
  int vmn = warp_min(v > 0 ? v : kSegBig);
  if ((tid & 31) == 0) {
    red[tid >> 5] = vmx;
    red[4 + (tid >> 5)] = vmn;
  }
  __syncthreads();
  mx = max(max(red[0], red[1]), max(red[2], red[3]));
  mn = min(min(red[4], red[5]), min(red[6], red[7]));
  __syncthreads();
}

__device__ __forceinline__ bool seg_overlap(int qmn, int qmx, int kmn,
                                            int kmx) {
  return qmx > 0 && kmx > 0 && qmx >= kmn && kmx >= qmn;
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. 4 warps x 16 q rows, 64-key tiles. Fragment layouts
// are PTX's for m16n8k16: lane = 4 * g + t; an A fragment holds rows g and
// g + 8, columns 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1 (+ 8) of
// column g; the f32 accumulator holds rows g and g + 8, columns 2t, 2t + 1.
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(FlashParams p) {
  constexpr int kPad = HD + 8;  // row pitch in bf16: conflict-free fragments
  __shared__ __align__(16) uint16_t qs[kBM][kPad];
  __shared__ __align__(16) uint16_t ks[kBN][kPad];
  __shared__ __align__(16) uint16_t vs[kBN][kPad];
  __shared__ float bias_s[kBN];
  __shared__ int segk_s[kBN];
  __shared__ int red[8];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int S = p.seq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* qg = static_cast<const uint16_t*>(p.q) +
                       b * p.q_strides[0] + h * p.q_strides[2];
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) +
                       b * p.k_strides[0] + h * p.k_strides[2];
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) +
                       b * p.v_strides[0] + h * p.v_strides[2];
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;

  // q tile -> shared memory, 16 bytes per access
  constexpr int kChunks = HD / 8;
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_strides[1] + c);
    *reinterpret_cast<uint4*>(&qs[r][c]) = val;
  }
  int qmn = 0, qmx = 0;
  if (seg_row) seg_range(seg_row, q0, kBM, S, red, qmn, qmx);
  __syncthreads();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int segq_a = (seg_row && row_a < S) ? seg_row[row_a] : 0;
  const int segq_b = (seg_row && row_b < S) ? seg_row[row_b] : 0;

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int r = warp * 16 + g, c = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&qs[r][c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&qs[r + 8][c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&qs[r][c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&qs[r + 8][c + 8]);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const int n_tiles = (S + kBN - 1) / kBN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    if (seg_row) {
      int kmn, kmx;
      seg_range(seg_row, k0, kBN, S, red, kmn, kmx);
      if (!seg_overlap(qmn, qmx, kmn, kmx)) {
        if (tid == 0 && p.skipped) atomicAdd(p.skipped, 1);
        continue;  // block-uniform: every thread computed the same ranges
      }
    }
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_strides[1] + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_strides[1] + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    if (tid < kBN) {
      const bool in = k0 + tid < S;
      bias_s[tid] = (bias_row && in) ? bias_row[k0 + tid] : 0.f;
      segk_s[tid] = (seg_row && in) ? seg_row[k0 + tid] : 0;
    }
    __syncthreads();

    // scores: (16 rows of this warp) x 64 keys, 8 n-tiles of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ks[nt * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ks[nt * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16_16816(s[nt], qf[kk], b0, b1);
      }
    }

    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float v = s[nt][e] * p.scale + bias_s[col];
        if (seg_row) {
          const int sq = (e < 2) ? segq_a : segq_b;
          if (!(sq == segk_s[col] && sq > 0)) v = kNegInf;
        }
        if (k0 + col >= S) v = -INFINITY;
        s[nt][e] = v;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn_a);
      s[nt][1] = expf(s[nt][1] - mn_a);
      s[nt][2] = expf(s[nt][2] - mn_b);
      s[nt][3] = expf(s[nt][3] - mn_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= alpha_a;
      o[dt][1] *= alpha_a;
      o[dt][2] *= alpha_b;
      o[dt][3] *= alpha_b;
    }

    // o += p v: p (bf16, as the reference casts it) is the A operand,
    // straight from the score accumulators; v's B fragments pair two rows,
    // so they are gathered as 16-bit halves
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int r0 = kc * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int c = dt * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(vs[r0][c]) |
                            (static_cast<uint32_t>(vs[r0 + 1][c]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vs[r0 + 8][c]) |
                            (static_cast<uint32_t>(vs[r0 + 9][c]) << 16);
        mma_bf16_16816(o[dt], a, b0, b1);
      }
    }
  }

  const float ls_a = fmaxf(l_a, 1e-30f), ls_b = fmaxf(l_b, 1e-30f);
  const bool zero_a = seg_row && segq_a == 0;
  const bool zero_b = seg_row && segq_b == 0;
  uint16_t* out = static_cast<uint16_t*>(p.out);
  const int H = p.heads;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row_a < S) {
      const uint32_t w = zero_a ? 0u : pack_bf16(o[dt][0] / ls_a, o[dt][1] / ls_a);
      *reinterpret_cast<uint32_t*>(out + ((static_cast<int64_t>(b) * S + row_a) * H + h) * HD + c) = w;
    }
    if (row_b < S) {
      const uint32_t w = zero_b ? 0u : pack_bf16(o[dt][2] / ls_b, o[dt][3] / ls_b);
      *reinterpret_cast<uint32_t*>(out + ((static_cast<int64_t>(b) * S + row_b) * H + h) * HD + c) = w;
    }
  }
  if (t == 0) {
    float* lse = p.lse + (static_cast<int64_t>(b) * H + h) * S;
    if (row_a < S) lse[row_a] = m_a + logf(ls_a);
    if (row_b < S) lse[row_b] = m_b + logf(ls_b);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA. A pair of threads owns one of the 64 q rows; each thread scores
// every other key of a 32-key tile and accumulates every other output
// column. 41.6 KB of static shared memory.
// ---------------------------------------------------------------------------

constexpr int kFM = 64;
constexpr int kFN = 32;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(FlashParams p) {
  __shared__ float qs[kFM][HD + 1];
  __shared__ float ks[kFN][HD + 1];
  __shared__ __align__(16) float vs[kFN][HD];
  __shared__ float ps[kFM][kFN + 1];
  __shared__ float bias_s[kFN];
  __shared__ int segk_s[kFN];
  __shared__ int red[8];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFM;
  const int S = p.seq;
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] + h * p.q_strides[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_strides[0] + h * p.k_strides[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_strides[0] + h * p.v_strides[2];
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;

  constexpr int kChunks = HD / 4;
  for (int i = tid; i < kFM * kChunks; i += kThreads) {
    const int rr = i / kChunks, c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + rr < S)
      val = *reinterpret_cast<const float4*>(qg + (q0 + rr) * p.q_strides[1] + c);
    qs[rr][c] = val.x;
    qs[rr][c + 1] = val.y;
    qs[rr][c + 2] = val.z;
    qs[rr][c + 3] = val.w;
  }
  int qmn = 0, qmx = 0;
  if (seg_row) seg_range(seg_row, q0, kFM, S, red, qmn, qmx);
  __syncthreads();

  const int row = q0 + r;
  const int segq = (seg_row && row < S) ? seg_row[row] : 0;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = (S + kFN - 1) / kFN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFN;
    if (seg_row) {
      int kmn, kmx;
      seg_range(seg_row, k0, kFN, S, red, kmn, kmx);
      if (!seg_overlap(qmn, qmx, kmn, kmx)) {
        if (tid == 0 && p.skipped) atomicAdd(p.skipped, 1);
        continue;
      }
    }
    __syncthreads();
    for (int i = tid; i < kFN * kChunks; i += kThreads) {
      const int rr = i / kChunks, c = (i % kChunks) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + rr < S) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + rr) * p.k_strides[1] + c);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + rr) * p.v_strides[1] + c);
      }
      ks[rr][c] = kv.x;
      ks[rr][c + 1] = kv.y;
      ks[rr][c + 2] = kv.z;
      ks[rr][c + 3] = kv.w;
      *reinterpret_cast<float4*>(&vs[rr][c]) = vv;
    }
    if (tid < kFN) {
      const bool in = k0 + tid < S;
      bias_s[tid] = (bias_row && in) ? bias_row[k0 + tid] : 0.f;
      segk_s[tid] = (seg_row && in) ? seg_row[k0 + tid] : 0;
    }
    __syncthreads();

    float s[kFN / 2];
#pragma unroll
    for (int c = 0; c < kFN / 2; ++c) s[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[r][d];
#pragma unroll
      for (int c = 0; c < kFN / 2; ++c) s[c] = fmaf(qd, ks[half + 2 * c][d], s[c]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kFN / 2; ++c) {
      const int col = half + 2 * c;
      float v = s[c] * p.scale + bias_s[col];
      if (seg_row && !(segq == segk_s[col] && segq > 0)) v = kNegInf;
      if (k0 + col >= S) v = -INFINITY;
      s[c] = v;
      mx = fmaxf(mx, v);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kFN / 2; ++c) {
      const float pv = expf(s[c] - mn);
      ps[r][half + 2 * c] = pv;
      sum += pv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = mn;
    __syncwarp();  // the partner thread's half of this row's p is in ps
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) o[c] *= alpha;
    for (int j = 0; j < kFN; ++j) {
      const float pj = ps[r][j];
#pragma unroll
      for (int c = 0; c < HD / 2; ++c) o[c] = fmaf(pj, vs[j][half + 2 * c], o[c]);
    }
  }

  if (row < S) {
    const float ls = fmaxf(l, 1e-30f);
    const bool zero = seg_row && segq == 0;
    float* out = static_cast<float*>(p.out) +
                 ((static_cast<int64_t>(b) * S + row) * p.heads + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) out[half + 2 * c] = zero ? 0.f : o[c] / ls;
    if (half == 0)
      p.lse[(static_cast<int64_t>(b) * p.heads + h) * S + row] = m + logf(ls);
  }
}

}  // namespace

cudaError_t flash_attention_fwd(const FlashParams& p, DType dtype,
                                cudaStream_t stream) {
  if (p.batch == 0 || p.seq == 0 || p.heads == 0) return cudaSuccess;
  if (p.head_dim != 64) return cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    const dim3 grid((p.seq + kBM - 1) / kBM, p.heads, p.batch);
    flash_fwd_bf16_kernel<64><<<grid, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid((p.seq + kFM - 1) / kFM, p.heads, p.batch);
    flash_fwd_f32_kernel<64><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace bert_kernels
