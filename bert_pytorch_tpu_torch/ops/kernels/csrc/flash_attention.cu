// Flash attention for Hopper: the f32 forward (with its dropout arm) and
// the backward pair. The bf16 forward is flash_attention_fwd.cu's, the
// fused bf16 backward flash_attention_bwd.cu's.
//
// Replaces the Pallas kernels of bert_pytorch_tpu/ops/pallas/
// flash_attention.py. Forward: `_fwd_kernel_native` and `_fwd_kernel`, one
// function in two grid layouts there: softmax(q k^T / sqrt(D) + bias) v
// with an online softmax, the packed-sequence mask (attend iff q_seg ==
// k_seg and q_seg > 0, masked scores at -1e30), whole tiles skipped when
// their segment ranges do not meet (`_seg_overlap`), outputs of pad
// (segment-0) rows zeroed, lse = m + log(max(l, 1e-30)) per row, and in
// training dropout with the counter-hash `_keep_mask`: the row sum l is of
// the undropped probabilities, dropped ones are zeroed before the PV
// product, and the output is divided by 1 - rate after the divide by l.
// Backward: `_dq_kernel` and `_dkv_kernel`, the split grid layouts of one
// function (dq, dk, dv recomputed from lse with the same masks and tile
// skip) whose fused layouts `_dqkv_kernel_native` and `_dqkv_kernel` are
// flash_attention_bwd.cu's, here two kernels: one CTA per (64-row q tile,
// head, batch) for dq, one per (64-key tile, head, batch) for dk and dv,
// so every output element has one owner and a rerun gives the same bits
// (no atomics in any numeric output). delta =
// rowsum(dO * out), which the Pallas wrappers compute outside any kernel,
// is formed in the dq kernel's prologue and written out for the dk/dv
// kernel, which runs after it.
//
// What bounds them: at BERT-Large's phase-2 shape (16, 512, 16, 64) in
// bf16 the backward pair needs 6 + 8 products of S^2 D per head
// (dq: s, dp, dq; dk/dv: s, dp, dv, dk) against ~10 tensors of traffic:
// close to the balance point, so neither the (S, S) score matrix nor any
// transposed copy may touch device memory. The design: the CTA's own tile
// (q, or k and v) sits in registers as mma fragments; a loop streams the
// other tiles through shared memory; scores, probabilities and
// accumulators stay in f32 registers, and an accumulator of one product is
// the A operand of the next without leaving registers. q/k/v are read in
// the model's (B, S, H, D) layout through their strides, so the fused QKV
// projection's output feeds the kernels without a transpose or a copy.
// bf16 products go through mma.sync m16n8k16 (bf16 in, f32 accumulate) on
// the tensor cores; f32 inputs go through f32 FMA. The dropout mask is
// evaluated in registers from the global (query, key) position, never
// stored. This is the simple version: no cp.async pipelining, no wgmma or
// TMA, and the backward pair evaluates s, p and the mask in both kernels.
// bf16 backwards at head dim 64 and S <= 512 (phase 2's) take the fused
// kernel of flash_attention_bwd.cu instead; the pair serves f32 and longer
// sequences.
#include "common.cuh"
#include "flash_common.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
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

// Is the tile starting at `start` (n positions) skipped against the range
// [mn, mx] of the CTA's own tile? Counts the skip once per CTA.
__device__ __forceinline__ bool skip_tile(const int32_t* seg_row, int start,
                                          int n, int seq, int* red, int mn,
                                          int mx, int32_t* skipped) {
  if (seg_row == nullptr) return false;
  int omn, omx;
  seg_range(seg_row, start, n, seq, red, omn, omx);
  if (seg_overlap(mn, mx, omn, omx)) return false;
  if (threadIdx.x == 0 && skipped) atomicAdd(skipped, 1);
  return true;  // block-uniform: every thread computed the same ranges
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
// bf16: tensor cores. 4 warps x 16 rows of the CTA's own 64-row tile, the
// other operand streamed in 64-row tiles. Fragment layouts are PTX's for
// m16n8k16: lane = 4 * g + t; an A fragment holds rows g and g + 8, columns
// 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1 (+ 8) of column g; the f32
// accumulator holds rows g and g + 8, columns 2t, 2t + 1.
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;

// the same rows of two panels (K and V, or q and dO) -> two tiles, the two
// loads of a row issued together so their latencies overlap
template <int ROWS, int HD, int PITCH>
__device__ __forceinline__ void load_rows2_bf16(
    uint16_t (*ta)[PITCH], const uint16_t* sa, int64_t stride_a,
    uint16_t (*tb)[PITCH], const uint16_t* sb, int64_t stride_b, int row0,
    int seq) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq) {
      va = *reinterpret_cast<const uint4*>(sa + (row0 + r) * stride_a + c);
      vb = *reinterpret_cast<const uint4*>(sb + (row0 + r) * stride_b + c);
    }
    *reinterpret_cast<uint4*>(&ta[r][c]) = va;
    *reinterpret_cast<uint4*>(&tb[r][c]) = vb;
  }
}

// A fragments of rows r0..r0+15 of a (.., HD) bf16 tile
template <int HD, int PITCH>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[HD / 16][4],
                                             const uint16_t (*tile)[PITCH],
                                             int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int r = r0 + g, c = kk * 16 + 2 * t;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(&tile[r][c]);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(&tile[r + 8][c]);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(&tile[r][c + 8]);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(&tile[r + 8][c + 8]);
  }
}

// acc (16 x N) += A (16 x HD) T^T, T an (N, HD) bf16 tile
template <int N, int HD, int PITCH>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const uint32_t (&a)[HD / 16][4],
                                        const uint16_t (*tile)[PITCH], int g,
                                        int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&tile[nt * 8 + g][kk * 16 + 2 * t]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&tile[nt * 8 + g][kk * 16 + 8 + 2 * t]);
      mma_bf16_16816(acc[nt], a[kk], b0, b1);
    }
  }
}

// acc (16 x HD) += bf16(P) T: P (16 x K) in accumulator layout, rounded to
// bf16 as the reference casts it, is the A operand straight from the
// registers; T a (K, HD) bf16 tile whose B fragments pair two rows, so they
// are gathered as 16-bit halves
template <int K, int HD, int PITCH>
__device__ __forceinline__ void mma_pt(float (&acc)[HD / 8][4],
                                       const float (&pm)[K / 8][4],
                                       const uint16_t (*tile)[PITCH], int g,
                                       int t) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(pm[2 * kc][0], pm[2 * kc][1]);
    a[1] = pack_bf16(pm[2 * kc][2], pm[2 * kc][3]);
    a[2] = pack_bf16(pm[2 * kc + 1][0], pm[2 * kc + 1][1]);
    a[3] = pack_bf16(pm[2 * kc + 1][2], pm[2 * kc + 1][3]);
    const int r0 = kc * 16 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int c = dt * 8 + g;
      const uint32_t b0 = static_cast<uint32_t>(tile[r0][c]) |
                          (static_cast<uint32_t>(tile[r0 + 1][c]) << 16);
      const uint32_t b1 = static_cast<uint32_t>(tile[r0 + 8][c]) |
                          (static_cast<uint32_t>(tile[r0 + 9][c]) << 16);
      mma_bf16_16816(acc[dt], a, b0, b1);
    }
  }
}

// dq: one CTA per (64-row q tile, head, batch). q and dO sit in registers
// as A fragments; K/V tiles stream through shared memory; per tile s = q
// k^T and dp = dO v^T on the tensor cores, then in registers p = exp(s -
// lse) (undropped), dp dropped and scaled, ds = p (dp - delta), and dq +=
// bf16(ds) k. 37 KB of static shared memory.
template <int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(FlashBwdParams bp) {
  const FlashParams& p = bp.f;
  constexpr int kPad = HD + 8;
  __shared__ __align__(16) uint16_t qs[kBM][kPad];
  __shared__ __align__(16) uint16_t dos[kBM][kPad];
  __shared__ __align__(16) uint16_t ks[kBN][kPad];
  __shared__ __align__(16) uint16_t vs[kBN][kPad];
  __shared__ float bias_s[kBN];
  __shared__ int segk_s[kBN];
  __shared__ float delta_s[kBM];
  __shared__ int red[8];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* qg = static_cast<const uint16_t*>(p.q) +
                       b * p.q_strides[0] + h * p.q_strides[2];
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) +
                       b * p.k_strides[0] + h * p.k_strides[2];
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) +
                       b * p.v_strides[0] + h * p.v_strides[2];
  // out, dO and dq: contiguous (B, S, H, D)
  const int64_t row_stride = static_cast<int64_t>(H) * HD;
  const int64_t bh_off = (static_cast<int64_t>(b) * S * H + h) * HD;
  const uint16_t* og = static_cast<const uint16_t*>(p.out) + bh_off;
  const uint16_t* dg = static_cast<const uint16_t*>(bp.dout) + bh_off;
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;
  const float* lse_row = p.lse + (static_cast<int64_t>(b) * H + h) * S;
  float* delta_row = bp.delta + (static_cast<int64_t>(b) * H + h) * S;

  load_rows2_bf16<kBM, HD, kPad>(qs, qg, p.q_strides[1], dos, dg, row_stride,
                                 q0, S);
  __syncthreads();
  {  // delta = rowsum(f32(dO) * f32(out)): two threads per row
    const int r = tid >> 1, c0 = (tid & 1) * (HD / 2);
    float acc = 0.f;
    if (q0 + r < S) {
      const uint16_t* orow = og + (q0 + r) * row_stride + c0;
      for (int c = 0; c < HD / 2; c += 8) {
        uint16_t ov[8];
        load_vec<8>(orow + c, ov);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc += BF16::to_f32(dos[r][c0 + c + j]) * BF16::to_f32(ov[j]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (q0 + r < S) delta_row[q0 + r] = acc;
    }
  }
  int qmn = 0, qmx = 0;
  if (seg_row) seg_range(seg_row, q0, kBM, S, red, qmn, qmx);
  __syncthreads();

  uint32_t qf[HD / 16][4], dof[HD / 16][4];
  load_a_frags<HD, kPad>(qf, qs, warp * 16, g, t);
  load_a_frags<HD, kPad>(dof, dos, warp * 16, g, t);
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int segq_a = (seg_row && row_a < S) ? seg_row[row_a] : 0;
  const int segq_b = (seg_row && row_b < S) ? seg_row[row_b] : 0;
  // pad (segment-0) and out-of-range rows contribute nothing
  const bool live_a = row_a < S && (!seg_row || segq_a > 0);
  const bool live_b = row_b < S && (!seg_row || segq_b > 0);
  const float lse_a = live_a ? lse_row[row_a] : 0.f;
  const float lse_b = live_b ? lse_row[row_b] : 0.f;
  const float dl_a = delta_s[warp * 16 + g], dl_b = delta_s[warp * 16 + g + 8];
  const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, b, H, h) : 0u;

  float dq[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const int n_tiles = (S + kBN - 1) / kBN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    if (skip_tile(seg_row, k0, kBN, S, red, qmn, qmx, p.skipped)) continue;
    __syncthreads();
    load_rows2_bf16<kBN, HD, kPad>(ks, kg, p.k_strides[1], vs, vg,
                                   p.v_strides[1], k0, S);
    if (tid < kBN) {
      const bool in = k0 + tid < S;
      bias_s[tid] = (bias_row && in) ? bias_row[k0 + tid] : 0.f;
      segk_s[tid] = (seg_row && in) ? seg_row[k0 + tid] : 0;
    }
    __syncthreads();

    float s[kBN / 8][4], dp[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_abt<kBN, HD, kPad>(s, qf, ks, g, t);
    mma_abt<kBN, HD, kPad>(dp, dof, vs, g, t);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1), key = k0 + col;
        const bool hi = e >= 2;
        float sv = s[nt][e] * p.scale + bias_s[col];
        if (seg_row) {
          const int sq = hi ? segq_b : segq_a;
          if (!(sq == segk_s[col] && sq > 0)) sv = kNegInf;
        }
        const bool live = (hi ? live_b : live_a) && key < S;
        const float pv = live ? expf(sv - (hi ? lse_b : lse_a)) : 0.f;
        float dpv = dp[nt][e];
        if constexpr (kDrop) {
          dpv = flash_keep(hi ? row_b : row_a, key, seed_bh, p.drop.threshold)
                    ? dpv / p.drop.keep_div
                    : 0.f;
        }
        s[nt][e] = pv * (dpv - (hi ? dl_b : dl_a));  // ds
      }
    }
    mma_pt<kBN, HD, kPad>(dq, s, ks, g, t);
  }

  uint16_t* dqg = static_cast<uint16_t*>(bp.dq) + bh_off;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(dqg + row_a * row_stride + c) =
          pack_bf16(dq[dt][0] * p.scale, dq[dt][1] * p.scale);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(dqg + row_b * row_stride + c) =
          pack_bf16(dq[dt][2] * p.scale, dq[dt][3] * p.scale);
  }
}

// dk, dv: one CTA per (64-key tile, head, batch). k and v sit in registers
// as A fragments; q/dO tiles with their lse, delta and segment ids stream
// through shared memory; per tile s^T = k q^T and dp^T = v dO^T on the
// tensor cores, then p^T, p_drop^T and ds^T in registers, dv +=
// bf16(p_drop^T) dO and dk += bf16(ds^T) q. 37 KB of static shared memory.
template <int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(FlashBwdParams bp) {
  const FlashParams& p = bp.f;
  constexpr int kPad = HD + 8;
  __shared__ __align__(16) uint16_t ks[kBN][kPad];
  __shared__ __align__(16) uint16_t vs[kBN][kPad];
  __shared__ __align__(16) uint16_t qs[kBM][kPad];
  __shared__ __align__(16) uint16_t dos[kBM][kPad];
  __shared__ float lse_s[kBM];
  __shared__ float delta_s[kBM];
  __shared__ int segq_s[kBM];
  __shared__ int red[8];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBN;
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* qg = static_cast<const uint16_t*>(p.q) +
                       b * p.q_strides[0] + h * p.q_strides[2];
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) +
                       b * p.k_strides[0] + h * p.k_strides[2];
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) +
                       b * p.v_strides[0] + h * p.v_strides[2];
  const int64_t row_stride = static_cast<int64_t>(H) * HD;
  const int64_t bh_off = (static_cast<int64_t>(b) * S * H + h) * HD;
  const uint16_t* dg = static_cast<const uint16_t*>(bp.dout) + bh_off;
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;
  const float* lse_row = p.lse + (static_cast<int64_t>(b) * H + h) * S;
  const float* delta_row = bp.delta + (static_cast<int64_t>(b) * H + h) * S;

  load_rows2_bf16<kBN, HD, kPad>(ks, kg, p.k_strides[1], vs, vg,
                                 p.v_strides[1], k0, S);
  int kmn = 0, kmx = 0;
  if (seg_row) seg_range(seg_row, k0, kBN, S, red, kmn, kmx);
  __syncthreads();

  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  load_a_frags<HD, kPad>(kf, ks, warp * 16, g, t);
  load_a_frags<HD, kPad>(vf, vs, warp * 16, g, t);
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const int segk_a = (seg_row && key_a < S) ? seg_row[key_a] : 0;
  const int segk_b = (seg_row && key_b < S) ? seg_row[key_b] : 0;
  const float bias_a = (bias_row && key_a < S) ? bias_row[key_a] : 0.f;
  const float bias_b = (bias_row && key_b < S) ? bias_row[key_b] : 0.f;
  const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, b, H, h) : 0u;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int n_tiles = (S + kBM - 1) / kBM;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBM;
    if (skip_tile(seg_row, q0, kBM, S, red, kmn, kmx, p.skipped)) continue;
    __syncthreads();
    load_rows2_bf16<kBM, HD, kPad>(qs, qg, p.q_strides[1], dos, dg,
                                   row_stride, q0, S);
    if (tid < kBM) {
      const bool in = q0 + tid < S;
      lse_s[tid] = in ? lse_row[q0 + tid] : 0.f;
      delta_s[tid] = in ? delta_row[q0 + tid] : 0.f;
      segq_s[tid] = (seg_row && in) ? seg_row[q0 + tid] : 0;
    }
    __syncthreads();

    float st[kBM / 8][4], dpt[kBM / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBM / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
    mma_abt<kBM, HD, kPad>(st, kf, qs, g, t);
    mma_abt<kBM, HD, kPad>(dpt, vf, dos, g, t);
#pragma unroll
    for (int nt = 0; nt < kBM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1), qrow = q0 + col;
        const bool hi = e >= 2;
        const int key = hi ? key_b : key_a;
        const int sq = segq_s[col];
        float sv = st[nt][e] * p.scale + (hi ? bias_b : bias_a);
        if (seg_row && !(sq == (hi ? segk_b : segk_a) && sq > 0)) sv = kNegInf;
        const bool live = qrow < S && key < S && (!seg_row || sq > 0);
        const float pv = live ? expf(sv - lse_s[col]) : 0.f;
        float dpv = dpt[nt][e], pd = pv;
        if constexpr (kDrop) {
          const bool keep = flash_keep(qrow, key, seed_bh, p.drop.threshold);
          dpv = keep ? dpv / p.drop.keep_div : 0.f;
          pd = keep ? pv / p.drop.keep_div : 0.f;
        }
        dpt[nt][e] = pv * (dpv - delta_s[col]);  // ds^T
        st[nt][e] = pd;                           // p_drop^T
      }
    }
    mma_pt<kBM, HD, kPad>(dv, st, dos, g, t);
    mma_pt<kBM, HD, kPad>(dk, dpt, qs, g, t);
  }

  uint16_t* dkg = static_cast<uint16_t*>(bp.dk) + bh_off;
  uint16_t* dvg = static_cast<uint16_t*>(bp.dv) + bh_off;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (key_a < S) {
      *reinterpret_cast<uint32_t*>(dkg + key_a * row_stride + c) =
          pack_bf16(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + key_a * row_stride + c) =
          pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (key_b < S) {
      *reinterpret_cast<uint32_t*>(dkg + key_b * row_stride + c) =
          pack_bf16(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + key_b * row_stride + c) =
          pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA. The forward: a pair of threads owns one of the 64 q rows; each
// thread scores every other key of a 32-key tile and accumulates every
// other output column. 41.6 KB of static shared memory.
// ---------------------------------------------------------------------------

constexpr int kFM = 64;
constexpr int kFN = 32;

__device__ __forceinline__ void store4(float* dst, float4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// rows row0.. of a strided f32 (rows, HD) panel -> tile, zero past `seq`
template <int ROWS, int HD, int PITCH>
__device__ __forceinline__ void load_rows_f32(float (*tile)[PITCH],
                                              const float* src,
                                              int64_t stride, int row0,
                                              int seq) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    store4(&tile[r][c], val);
  }
}

// the same rows of two f32 panels -> two tiles, loads issued together
template <int ROWS, int HD, int PITCH>
__device__ __forceinline__ void load_rows2_f32(
    float (*ta)[PITCH], const float* sa, int64_t stride_a,
    float (*tb)[PITCH], const float* sb, int64_t stride_b, int row0,
    int seq) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
    if (row0 + r < seq) {
      va = *reinterpret_cast<const float4*>(sa + (row0 + r) * stride_a + c);
      vb = *reinterpret_cast<const float4*>(sb + (row0 + r) * stride_b + c);
    }
    store4(&ta[r][c], va);
    store4(&tb[r][c], vb);
  }
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(FlashParams p) {
  __shared__ float qs[kFM][HD + 1];
  __shared__ float ks[kFN][HD + 1];
  __shared__ float vs[kFN][HD + 1];
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

  load_rows_f32<kFM, HD, HD + 1>(qs, qg, p.q_strides[1], q0, S);
  int qmn = 0, qmx = 0;
  if (seg_row) seg_range(seg_row, q0, kFM, S, red, qmn, qmx);
  __syncthreads();

  const int row = q0 + r;
  const int segq = (seg_row && row < S) ? seg_row[row] : 0;
  const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, b, p.heads, h) : 0u;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = (S + kFN - 1) / kFN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFN;
    if (skip_tile(seg_row, k0, kFN, S, red, qmn, qmx, p.skipped)) continue;
    __syncthreads();
    load_rows2_f32<kFN, HD, HD + 1>(ks, kg, p.k_strides[1], vs, vg,
                                    p.v_strides[1], k0, S);
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
      sum += pv;  // the undropped sum
      bool keep = true;
      if constexpr (kDrop)
        keep = flash_keep(row, k0 + half + 2 * c, seed_bh, p.drop.threshold);
      ps[r][half + 2 * c] = keep ? pv : 0.f;
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
    for (int c = 0; c < HD / 2; ++c) {
      float v = o[c] / ls;
      if constexpr (kDrop) v = v / p.drop.keep_div;
      out[half + 2 * c] = zero ? 0.f : v;
    }
    if (half == 0)
      p.lse[(static_cast<int64_t>(b) * p.heads + h) * S + row] = m + logf(ls);
  }
}

// dq, f32: a pair of threads per q row of a 64-row tile, 16-key tiles; each
// thread scores every other key and accumulates every other dq column.
// 46 KB of static shared memory.
constexpr int kDqM = 64;
constexpr int kDqN = 16;

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(FlashBwdParams bp) {
  const FlashParams& p = bp.f;
  __shared__ float qs[kDqM][HD + 1];
  __shared__ float dos[kDqM][HD + 1];
  __shared__ float ks[kDqN][HD + 1];
  __shared__ float vs[kDqN][HD + 1];
  __shared__ float ds_s[kDqM][kDqN + 1];
  __shared__ float bias_s[kDqN];
  __shared__ int segk_s[kDqN];
  __shared__ int red[8];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kDqM;
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] + h * p.q_strides[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_strides[0] + h * p.k_strides[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_strides[0] + h * p.v_strides[2];
  const int64_t row_stride = static_cast<int64_t>(H) * HD;
  const int64_t bh_off = (static_cast<int64_t>(b) * S * H + h) * HD;
  const float* og = static_cast<const float*>(p.out) + bh_off;
  const float* dg = static_cast<const float*>(bp.dout) + bh_off;
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;

  load_rows2_f32<kDqM, HD, HD + 1>(qs, qg, p.q_strides[1], dos, dg,
                                   row_stride, q0, S);
  __syncthreads();
  const int row = q0 + r;
  float dl = 0.f;  // delta of this row: each thread sums half the columns
  if (row < S) {
    const float* orow = og + row * row_stride;
#pragma unroll 8
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d)
      dl += dos[r][d] * orow[d];
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  if (half == 0 && row < S)
    bp.delta[(static_cast<int64_t>(b) * H + h) * S + row] = dl;
  int qmn = 0, qmx = 0;
  if (seg_row) seg_range(seg_row, q0, kDqM, S, red, qmn, qmx);

  const int segq = (seg_row && row < S) ? seg_row[row] : 0;
  const bool live = row < S && (!seg_row || segq > 0);
  const float lse = live ? p.lse[(static_cast<int64_t>(b) * H + h) * S + row] : 0.f;
  const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, b, H, h) : 0u;
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  const int n_tiles = (S + kDqN - 1) / kDqN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqN;
    if (skip_tile(seg_row, k0, kDqN, S, red, qmn, qmx, p.skipped)) continue;
    __syncthreads();
    load_rows2_f32<kDqN, HD, HD + 1>(ks, kg, p.k_strides[1], vs, vg,
                                     p.v_strides[1], k0, S);
    if (tid < kDqN) {
      const bool in = k0 + tid < S;
      bias_s[tid] = (bias_row && in) ? bias_row[k0 + tid] : 0.f;
      segk_s[tid] = (seg_row && in) ? seg_row[k0 + tid] : 0;
    }
    __syncthreads();

    float s[kDqN / 2], dp[kDqN / 2];
#pragma unroll
    for (int c = 0; c < kDqN / 2; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[r][d], dd = dos[r][d];
#pragma unroll
      for (int c = 0; c < kDqN / 2; ++c) {
        s[c] = fmaf(qd, ks[half + 2 * c][d], s[c]);
        dp[c] = fmaf(dd, vs[half + 2 * c][d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kDqN / 2; ++c) {
      const int col = half + 2 * c, key = k0 + col;
      float sv = s[c] * p.scale + bias_s[col];
      if (seg_row && !(segq == segk_s[col] && segq > 0)) sv = kNegInf;
      const float pv = (live && key < S) ? expf(sv - lse) : 0.f;
      float dpv = dp[c];
      if constexpr (kDrop)
        dpv = flash_keep(row, key, seed_bh, p.drop.threshold)
                  ? dpv / p.drop.keep_div
                  : 0.f;
      ds_s[r][col] = pv * (dpv - dl);
    }
    __syncwarp();  // the partner's half of this row's ds is in ds_s
    for (int j = 0; j < kDqN; ++j) {
      const float dsj = ds_s[r][j];
#pragma unroll
      for (int c = 0; c < HD / 2; ++c) dq[c] = fmaf(dsj, ks[j][half + 2 * c], dq[c]);
    }
  }

  if (row < S) {
    float* out = static_cast<float*>(bp.dq) + bh_off + row * row_stride;
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) out[half + 2 * c] = dq[c] * p.scale;
  }
}

// dk, dv, f32: four threads per key of a 32-key tile, 32-row q tiles; each
// thread scores every fourth query and accumulates every fourth dk and dv
// column. 42 KB of static shared memory.
constexpr int kKvN = 32;
constexpr int kKvM = 32;

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(FlashBwdParams bp) {
  const FlashParams& p = bp.f;
  __shared__ float ks[kKvN][HD + 1];
  __shared__ float vs[kKvN][HD + 1];
  __shared__ float qs[kKvM][HD + 1];
  __shared__ float dos[kKvM][HD + 1];
  __shared__ float pd_s[kKvN][kKvM + 1];
  __shared__ float ds_s[kKvN][kKvM + 1];
  __shared__ float lse_s[kKvM];
  __shared__ float delta_s[kKvM];
  __shared__ int segq_s[kKvM];
  __shared__ int red[8];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKvN;
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, r = tid >> 2, quarter = tid & 3;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] + h * p.q_strides[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_strides[0] + h * p.k_strides[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_strides[0] + h * p.v_strides[2];
  const int64_t row_stride = static_cast<int64_t>(H) * HD;
  const int64_t bh_off = (static_cast<int64_t>(b) * S * H + h) * HD;
  const float* dg = static_cast<const float*>(bp.dout) + bh_off;
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;
  const float* lse_row = p.lse + (static_cast<int64_t>(b) * H + h) * S;
  const float* delta_row = bp.delta + (static_cast<int64_t>(b) * H + h) * S;

  load_rows2_f32<kKvN, HD, HD + 1>(ks, kg, p.k_strides[1], vs, vg,
                                   p.v_strides[1], k0, S);
  int kmn = 0, kmx = 0;
  if (seg_row) seg_range(seg_row, k0, kKvN, S, red, kmn, kmx);
  __syncthreads();

  const int key = k0 + r;
  const int segk = (seg_row && key < S) ? seg_row[key] : 0;
  const float bias_k = (bias_row && key < S) ? bias_row[key] : 0.f;
  const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, b, H, h) : 0u;
  float dk[HD / 4], dv[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (S + kKvM - 1) / kKvM;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kKvM;
    if (skip_tile(seg_row, q0, kKvM, S, red, kmn, kmx, p.skipped)) continue;
    __syncthreads();
    load_rows2_f32<kKvM, HD, HD + 1>(qs, qg, p.q_strides[1], dos, dg,
                                     row_stride, q0, S);
    if (tid < kKvM) {
      const bool in = q0 + tid < S;
      lse_s[tid] = in ? lse_row[q0 + tid] : 0.f;
      delta_s[tid] = in ? delta_row[q0 + tid] : 0.f;
      segq_s[tid] = (seg_row && in) ? seg_row[q0 + tid] : 0;
    }
    __syncthreads();

    float st[kKvM / 4], dpt[kKvM / 4];
#pragma unroll
    for (int c = 0; c < kKvM / 4; ++c) st[c] = dpt[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[r][d], vd = vs[r][d];
#pragma unroll
      for (int c = 0; c < kKvM / 4; ++c) {
        st[c] = fmaf(kd, qs[quarter + 4 * c][d], st[c]);
        dpt[c] = fmaf(vd, dos[quarter + 4 * c][d], dpt[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kKvM / 4; ++c) {
      const int col = quarter + 4 * c, qrow = q0 + col;
      const int sq = segq_s[col];
      float sv = st[c] * p.scale + bias_k;
      if (seg_row && !(sq == segk && sq > 0)) sv = kNegInf;
      const bool live = qrow < S && key < S && (!seg_row || sq > 0);
      const float pv = live ? expf(sv - lse_s[col]) : 0.f;
      float dpv = dpt[c], pd = pv;
      if constexpr (kDrop) {
        const bool keep = flash_keep(qrow, key, seed_bh, p.drop.threshold);
        dpv = keep ? dpv / p.drop.keep_div : 0.f;
        pd = keep ? pv / p.drop.keep_div : 0.f;
      }
      ds_s[r][col] = pv * (dpv - delta_s[col]);
      pd_s[r][col] = pd;
    }
    __syncwarp();  // the key's four threads have written its row
    for (int j = 0; j < kKvM; ++j) {
      const float pj = pd_s[r][j], dj = ds_s[r][j];
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        dv[c] = fmaf(pj, dos[j][quarter + 4 * c], dv[c]);
        dk[c] = fmaf(dj, qs[j][quarter + 4 * c], dk[c]);
      }
    }
  }

  if (key < S) {
    float* dko = static_cast<float*>(bp.dk) + bh_off + key * row_stride;
    float* dvo = static_cast<float*>(bp.dv) + bh_off + key * row_stride;
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      dko[quarter + 4 * c] = dk[c] * p.scale;
      dvo[quarter + 4 * c] = dv[c];
    }
  }
}

// one launch of kernel<64, drop> over (ceil(S / rows), H, B)
template <typename Params>
cudaError_t launch(void (*with_drop)(Params), void (*without)(Params),
                   const Params& params, const FlashParams& f, int rows,
                   cudaStream_t stream) {
  if (f.batch == 0 || f.seq == 0 || f.heads == 0) return cudaSuccess;
  if (f.head_dim != 64) return cudaErrorInvalidValue;
  const dim3 grid((f.seq + rows - 1) / rows, f.heads, f.batch);
  void (*kernel)(Params) = f.drop.apply ? with_drop : without;
  kernel<<<grid, kThreads, 0, stream>>>(params);
  return cudaGetLastError();
}

}  // namespace

cudaError_t flash_attention_fwd(const FlashParams& p, DType dtype,
                                cudaStream_t stream) {
  if (dtype == kBFloat16) return flash_attention_fwd_bf16(p, stream);
  return launch(flash_fwd_f32_kernel<64, true>,
                flash_fwd_f32_kernel<64, false>, p, p, kFM, stream);
}

cudaError_t flash_attention_bwd_dq(const FlashBwdParams& p, DType dtype,
                                   cudaStream_t stream) {
  if (dtype == kBFloat16)
    return launch(flash_bwd_dq_bf16_kernel<64, true>,
                  flash_bwd_dq_bf16_kernel<64, false>, p, p.f, kBM, stream);
  return launch(flash_bwd_dq_f32_kernel<64, true>,
                flash_bwd_dq_f32_kernel<64, false>, p, p.f, kDqM, stream);
}

cudaError_t flash_attention_bwd_dkv(const FlashBwdParams& p, DType dtype,
                                    cudaStream_t stream) {
  if (dtype == kBFloat16)
    return launch(flash_bwd_dkv_bf16_kernel<64, true>,
                  flash_bwd_dkv_bf16_kernel<64, false>, p, p.f, kBN, stream);
  return launch(flash_bwd_dkv_f32_kernel<64, true>,
                flash_bwd_dkv_f32_kernel<64, false>, p, p.f, kKvN, stream);
}

void flash_tiles(DType dtype, FlashTile tiles[3]) {
  if (dtype == kBFloat16) {
    tiles[0] = flash_fwd_tile();
    tiles[1] = {kBM, kBN};
    tiles[2] = {kBM, kBN};
  } else {
    tiles[0] = {kFM, kFN};
    tiles[1] = {kDqM, kDqN};
    tiles[2] = {kKvM, kKvN};
  }
}

}  // namespace bert_kernels
