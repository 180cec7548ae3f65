// Flash attention for Hopper in f32, the checking dtype: the forward (with
// its dropout arm) and the backward pair. The bf16 forward is
// flash_attention_fwd.cu's, the fused bf16 backward flash_attention_bwd.cu's
// and the bf16 pair flash_attention_split_bwd.cu's; this file's entry
// points send bf16 there.
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
// skip), here two kernels: one CTA per (64-row q tile, head, batch) for
// dq, one per (32-key tile, head, batch) for dk and dv, so every output
// element has one owner and a rerun gives the same bits (no atomics in any
// numeric output). delta = rowsum(dO * out), which the Pallas wrappers
// compute outside any kernel, is formed in the dq kernel's prologue and
// written out for the dk/dv kernel, which runs after it.
//
// The design: f32 inputs go through f32 FMA (the tensor cores take no
// f32), the CTA's own rows in shared memory, the other tiles streamed
// through it; scores, probabilities and accumulators stay in registers
// and no (S, S) tile touches device memory. The dropout mask is evaluated
// in registers from the global (query, key) position, never stored. q/k/v
// are read in the model's (B, S, H, D) layout through their strides.
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
  if (dtype == kBFloat16) return flash_attention_bwd_dq_bf16(p, stream);
  return launch(flash_bwd_dq_f32_kernel<64, true>,
                flash_bwd_dq_f32_kernel<64, false>, p, p.f, kDqM, stream);
}

cudaError_t flash_attention_bwd_dkv(const FlashBwdParams& p, DType dtype,
                                    cudaStream_t stream) {
  if (dtype == kBFloat16) return flash_attention_bwd_dkv_bf16(p, stream);
  return launch(flash_bwd_dkv_f32_kernel<64, true>,
                flash_bwd_dkv_f32_kernel<64, false>, p, p.f, kKvN, stream);
}

void flash_tiles(DType dtype, FlashTile tiles[3]) {
  if (dtype == kBFloat16) {
    tiles[0] = flash_fwd_tile();
    tiles[1] = flash_bwd_dq_tile();
    tiles[2] = flash_bwd_dkv_tile();
  } else {
    tiles[0] = {kFM, kFN};
    tiles[1] = {kDqM, kDqN};
    tiles[2] = {kKvM, kKvN};
  }
}

}  // namespace bert_kernels
