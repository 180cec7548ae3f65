// The fused flash-attention backward for Hopper: dq, dk and dv in one
// launch, bf16, head dim 64, sequences of whole 128-key tiles up to
// flash_bwd_fused_max_seq() (512 on an H100; the flash route only takes
// multiples of 128).
//
// Replaces the fused Pallas backward kernels of bert_pytorch_tpu/ops/
// pallas/flash_attention.py, `_dqkv_kernel_native` (grid (B,), the model's
// (B, S, H, D) layout) and `_dqkv_kernel` (grid (B * H,), the bh layout):
// one function, which reads q, k, v, the forward's output and lse and the
// cotangent dO, recomputes p = exp(s - lse) under the padding bias or the
// packed-segment mask (pad rows p = 0, whole tiles whose segment ranges do
// not meet skipped), applies the flash dropout mask (`_keep_mask`) at the
// forward's seed and rate, and writes dq = ds k * scale, dk = ds^T q *
// scale and dv = p_drop^T dO, with ds = p (dp_drop - delta), delta =
// rowsum(dO out). The zero bias cotangent is the caller's. The split pair
// of flash_attention.cu (dq, then dk/dv) stays for f32 and longer
// sequences, as the Pallas package keeps its split kernels beyond its
// fused gate.
//
// What bounds it: at BERT-Large's phase-2 shape (16, 512, 16, 64) the
// function needs 5 products of 2 S^2 D flops a head (s, dp, dv, dk, dq):
// 43.0 GFLOP, 43.5 us at the H100's dense bf16 rate, against 134.8 MB of
// q/k/v/out/dO/dq/dk/dv/lse/bias, 40.2 us at 3.35 TB/s: operation-bound,
// near the balance point. So s, p and the mask are formed once (the split
// pair formed them twice: 7 products), no (S, S) tile touches device
// memory, and the products run as wgmma with their operands fed by TMA.
//
// The design: one CTA of 8 warps (two warpgroups) per (batch, head), 256
// CTAs at phase 2's microbatch of 16 x 16 heads. The prologue brings out
// and dO of every row by TMA into the f32 dq accumulator before it is
// zeroed, forms delta there, and keeps it beside lse and the bias (both
// times log2 e) and the segment ids; the dq accumulator (S x 64 f32, 128
// KiB at S = 512) then stays in shared memory for the whole launch, so dq
// needs no atomics and no second pass. An outer loop walks key tiles of
// 128 (16 keys a warp): k and v arrive by TMA once and sit in registers as
// A fragments, and the dk and dv accumulators stay in registers until the
// tile's epilogue. The inner loop streams 64-row q and dO tiles through a
// two-stage TMA ring with an mbarrier a stage, one thread issuing the next
// tile's two copies under this tile's products. A (q tile, key tile) pair
// runs in two halves of 32 queries, pipelined so that the second half's
// s^T = k q^T and dp^T = v dO^T run on the tensor cores under the first
// half's softmax gradient: in registers p^T = exp2(s^T scale log2e + bias
// log2e - lse log2e) with the mask and pad rules, one hash an element,
// p_drop^T and dp_drop^T by a multiply with 1 / (1 - rate), ds^T = p^T
// (dp_drop^T - delta); then dv += bf16(p_drop^T) dO and dk += bf16(ds^T)
// q with the packed accumulators as register A operands, and bf16(ds^T)
// staged to shared memory. After a barrier, dq_tile += ds k_tile (64
// queries x 32 head-dim columns a warpgroup, both operands from shared
// memory) is issued and left in flight under the next tile's s^T and
// dp^T; its sum lands in the dq accumulator by the one thread that owns
// each element, in key-tile order, so a rerun gives the same bits (a
// second ds^T tile lets the next tile stage while it runs). After the last
// key tile dq * scale leaves shared memory as bf16.
//
// Tensor cores: all five products are wgmma (m64n32k16, m64n64k16; bf16
// in, f32 accumulate): s^T and dp^T and dv and dk with A in registers and
// B by descriptor (K-major for s^T and dp^T, MN-major for dv and dk), dq
// with both operands by descriptor (MN-major). Every tile lies in the
// 128-byte swizzle that TMA writes and wgmma reads; ldmatrix reads the k
// and v fragments from it conflict-free. Every wgmma wait is a
// wait_group 0 at a point the whole warpgroup passes: a wait_group 1, or a
// wait ptxas has to add on a data-dependent path, makes it serialize every
// wgmma of the kernel. What is left is mma-side latency with 8 warps an
// SM (the dq accumulator takes one CTA an SM); warp-specialised producer
// and consumer warpgroups are the next step.
//
// Shared memory at S rows: the dq accumulator (256 B a
// row, its float2 columns XOR-swizzled by row so the dq update is
// conflict-free), lse, delta, segment ids and bias (16 B a row), the q/dO
// ring (2 stages x 2 tiles x 8 KiB), the k tile and two ds^T tiles (3 x
// 16 KiB; the ds^T tile of a key tile's first q tile carries v until its
// fragments are out), the segment-skip ranges and four mbarriers (288 B):
// 221,472 B at S = 512, one CTA an SM.
#include "common.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kWarps = 8;
constexpr int kFThreads = kWarps * 32;
constexpr int kHD = 64;                  // head dim
constexpr int kChunks = kHD / 8;         // 16-byte chunks a row
constexpr int kQT = 64;                  // q rows a streamed tile
constexpr int kKT = kWarps * 16;         // keys a CTA step: 16 a warp
constexpr int kQTileBytes = kQT * kHD * 2;      // 8,192
constexpr int kKTileBytes = kKT * kHD * 2;      // 16,384
constexpr int kRingBytes = 2 * 2 * kQTileBytes;  // 2 stages x (q, dO)
constexpr int kMaxTiles = 16;            // q tiles a range table holds
// the segment ranges (4 x kMaxTiles ints) and 4 mbarriers
constexpr int kBookBytes = 4 * kMaxTiles * 4 + 4 * 8;
constexpr int kMaxSmem = 232448;         // what one block may use (227 KB)
static_assert(kHD == kMapCols, "tensor maps of whole 64-column rows");

// dynamic shared memory of one launch: 272 B a row + 82,208 B
constexpr int fused_smem(int seq) {
  return seq * (kHD * 4 + 4 * 4) + kRingBytes + 3 * kKTileBytes + kBookBytes;
}

// -- the kernel --------------------------------------------------------------

// dq_s[row, col] += acc for this warp's 16 q rows from row0 and head-dim
// columns hc.., acc in the m16n8k16 accumulator layout (one [4] per 8
// columns): each element has this thread as its one owner
__device__ __forceinline__ int dq_index(int row, int col) {
  return row * kHD + (col ^ ((row & 3) << 3));
}

__device__ __forceinline__ void add_dq(float* dq_s, const float (&acc)[4][4],
                                       int row0, int hc, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2* cell = reinterpret_cast<float2*>(
          &dq_s[dq_index(row0 + g + half * 8, hc + j * 8 + 2 * t)]);
      float2 v = *cell;
      v.x += acc[j][2 * half];
      v.y += acc[j][2 * half + 1];
      *cell = v;
    }
  }
}

// The tensor maps of one launch: q and dO in boxes of one chunk by kQT
// rows (the ring), k, v, out and dO by kKT rows.
struct FusedMaps {
  CUtensorMap q, dout, k, v, out_k, dout_k;
};

template <bool kDrop>
__global__ void __launch_bounds__(kFThreads, 1)
flash_bwd_fused_bf16_kernel(const __grid_constant__ FusedMaps maps,
                            FlashBwdParams bp, float inv_keep) {
  const FlashParams& p = bp.f;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int S = p.seq, H = p.heads;  // S: whole key tiles
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float* dq_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + S * kHD * 4;
  unsigned char* k_s = ring + kRingBytes;
  unsigned char* dst_base = k_s + kKTileBytes;  // two ds^T tiles
  float* lse_s = reinterpret_cast<float*>(dst_base + 2 * kKTileBytes);
  float* delta_s = lse_s + S;
  int* seg_s = reinterpret_cast<int*>(delta_s + S);
  float* bias_s = reinterpret_cast<float*>(seg_s + S);
  // the segment ranges: q tiles' min, max; key tiles' min, max
  int* rng_s = reinterpret_cast<int*>(bias_s + S);
  // mbarriers: the two ring stages, the key tile, the prologue
  uint64_t* bars = reinterpret_cast<uint64_t*>(rng_s + 4 * kMaxTiles);
  uint64_t* bar_kv = bars + 2;
  uint64_t* bar_pro = bars + 3;

  // out, dO, dq, dk, dv: contiguous (B, S, H, D)
  const int64_t row_stride = static_cast<int64_t>(H) * kHD;
  const int64_t bh_off = (static_cast<int64_t>(b) * S * H + h) * kHD;
  const int32_t* seg_row = p.seg ? p.seg + static_cast<int64_t>(b) * S : nullptr;
  const float* bias_row = p.bias ? p.bias + static_cast<int64_t>(b) * S : nullptr;
  const float* lse_row = p.lse + (static_cast<int64_t>(b) * H + h) * S;

  const int nq = S / kQT, nk = S / kKT;
  const int n_iter = nq * nk;

  if (tid == 0 && (smem_addr(smem) & 1023) != 0) __trap();  // swizzle base
  // prologue: thread 0 sets up the barriers and starts the copies of the
  // first q tile into the ring and of out and dO of every row into the dq
  // accumulator, not yet in use (S * 256 bytes either way)
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars, 2 * kQTileBytes);
    tma_load(ring, &maps.q, h, 0, b, bars);
    tma_load(ring + kQTileBytes, &maps.dout, h, 0, b, bars);
    mbar_expect(bar_pro, 2 * S * kHD * 2);
    for (int r0 = 0; r0 < S; r0 += kKT) {
      tma_load(smem + r0 * kHD * 2, &maps.out_k, h, r0, b, bar_pro);
      tma_load(smem + (S + r0) * kHD * 2, &maps.dout_k, h, r0, b, bar_pro);
    }
  }
  // lse and the bias (times log2 e) and segment ids
  for (int r = tid; r < S; r += kFThreads) {
    lse_s[r] = lse_row[r] * kLog2e;
    seg_s[r] = seg_row ? seg_row[r] : 0;
    bias_s[r] = bias_row ? bias_row[r] * kLog2e : 0.f;
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(bar_pro, 0);
  // delta = rowsum(f32(dO) f32(out)), a thread a row; out and dO share
  // the swizzle, so their chunks pair up in any order: lane r starts at
  // stored chunk r % 8, which keeps a warp's reads on distinct banks
  for (int r = tid; r < S; r += kFThreads) {
    const unsigned char* o_row = smem + r * kHD * 2;
    const unsigned char* d_row = o_row + S * kHD * 2;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = ((j + r) & 7) << 4;
      uint16_t ov[8], dv_[8];
      load_vec<8>(reinterpret_cast<const uint16_t*>(o_row + c), ov);
      load_vec<8>(reinterpret_cast<const uint16_t*>(d_row + c), dv_);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc += BF16::to_f32(dv_[e]) * BF16::to_f32(ov[e]);
    }
    delta_s[r] = acc;
  }
  __syncthreads();  // out and dO are read: the accumulator starts at zero
  for (int i = tid; i < S * kHD / 4; i += kFThreads)
    reinterpret_cast<float4*>(dq_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (seg_row) {
    // [min non-pad, max] segment id of every q tile and key tile: the
    // skip test of `_seg_overlap`, one warp a tile
    for (int tile = warp; tile < nq + nk; tile += kWarps) {
      const bool is_q = tile < nq;
      const int start = is_q ? tile * kQT : (tile - nq) * kKT;
      const int n = is_q ? kQT : kKT;
      int mx = 0, mn = kSegBig;
      for (int i = lane; i < n; i += 32) {
        const int v = seg_s[start + i];
        mx = max(mx, v);
        if (v > 0) mn = min(mn, v);
      }
      mx = warp_max(mx);
      mn = warp_min(mn);
      if (lane == 0) {
        const int slot = is_q ? tile : 2 * kMaxTiles + tile - nq;
        rng_s[slot] = mn;
        rng_s[slot + kMaxTiles] = mx;
      }
    }
  }
  // (the first iteration's barrier publishes the zeros and the ranges)

  const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, b, H, h) : 0u;
  // keep iff hash >> 9 >= threshold, i.e. hash >= threshold << 9
  const uint32_t keep_min = p.drop.threshold << 9;
  const float scale_l2 = p.scale * kLog2e;
  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
  int key_a = 0, key_b = 0, segk_a = 0, segk_b = 0, kmn = 0, kmx = 0;
  float kb_a = 0.f, kb_b = 0.f;
  uint32_t kh_a = 0u, kh_b = 0u;
  int n_skipped = 0;
  // the dq product: warp w owns q rows (w % 4) * 16.. and head-dim
  // columns (w / 4) * 32.. of the tile; its wgmma runs under the next
  // tile's s^T and dp^T, and its sum lands in dq_s there (add_dq), so
  // `acc` holds the partial of the q tile from row `pend`, -1 for none
  const int qr = (warp & 3) * 16, hc = (warp >> 2) * 32;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  int pend = -1;

  for (int it = 0; it < n_iter; ++it) {
    const int kt = it / nq, qt = it - kt * nq;
    const int k0 = kt * kKT, q0 = qt * kQT;
    unsigned char* q_s = ring + (it & 1) * 2 * kQTileBytes;
    unsigned char* do_s = q_s + kQTileBytes;
    // this tile's ds^T; the other one may still feed the last dq product
    unsigned char* dst_s = dst_base + (it & 1) * kKTileBytes;
    // ds^T writes (st.shared) of the last iteration are ordered before
    // the TMA copies into the stage and tiles they may overwrite
    fence_proxy_async();
    // iteration it - 1 is done with the other stage
    __syncthreads();

    if (qt == 0) {
      // a new key tile: the last dq product reads k_s, so it lands first
      // (every wait sits where the whole warpgroup passes, so that ptxas
      // adds none of its own and keeps the wgmma pipeline)
      wgmma_wait_all();
      reg_fence(acc);
      if (pend >= 0) add_dq(dq_s, acc, pend + qr, hc, g, t);
      pend = -1;
      __syncthreads();
      // k into k_s and v through this tile's ds^T buffer, both once
      if (tid == 0) {
        mbar_expect(bar_kv, 2 * kKTileBytes);
        tma_load(k_s, &maps.k, h, k0, b, bar_kv);
        tma_load(dst_s, &maps.v, h, k0, b, bar_kv);
      }
      mbar_wait(bar_kv, kt & 1);
      // A fragments of this warp's 16 keys: matrix m = lane / 8 covers
      // keys + (m & 1) * 8, head-dim columns + (m >> 1) * 8
      const int fr = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_x4(kf[kk], k_s + sw(fr, kk * 2 + (lane >> 4)));
        ldsm_x4(vf[kk], dst_s + sw(fr, kk * 2 + (lane >> 4)));
      }
      key_a = k0 + warp * 16 + g;
      key_b = key_a + 8;
      kb_a = bias_s[key_a];
      kb_b = bias_s[key_b];
      segk_a = seg_s[key_a];
      segk_b = seg_s[key_b];
      kh_a = (static_cast<uint32_t>(key_a) * 0x85EBCA77u) ^ seed_bh;
      kh_b = (static_cast<uint32_t>(key_b) * 0x85EBCA77u) ^ seed_bh;
      if (seg_row) {
        kmn = rng_s[2 * kMaxTiles + kt];
        kmx = rng_s[3 * kMaxTiles + kt];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
        dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
      }
      __syncthreads();  // every warp has its v fragments out of dst_s
    }
    mbar_wait(bars + (it & 1), (it >> 1) & 1);  // this q tile has landed

    // block-uniform: every thread reads the same ranges
    const bool skip =
        seg_row && !seg_overlap(rng_s[qt], rng_s[kMaxTiles + qt], kmn, kmx);
    n_skipped += skip;
    if (skip) {
      // land the last dq product now: its ds^T buffer is the next tile's
      wgmma_wait_all();
      reg_fence(acc);
      if (pend >= 0) add_dq(dq_s, acc, pend + qr, hc, g, t);
      pend = -1;
    }
    if (!skip) {
      // The 64 queries in two halves of 32, so that only a half's scores
      // live in registers beside k, v, dk and dv, pipelined: the second
      // half's s^T and dp^T run on the tensor cores under the first half's
      // softmax gradient. Warpgroup w / 4 multiplies for keys (w / 4) *
      // 64.., its warp w % 4 holding rows 16 (w % 4).. of each product:
      // this warp's keys k0 + 16 w..
      float st0[4][4], dp0[4][4], st1[4][4], dp1[4][4];
      uint32_t pw[4][2], dw[4][2];
      // s^T = k q^T, dp^T = v dO^T for queries qh.., 16 keys x 32 queries
      // a warp: A from the k and v fragments, B the K-major q and dO rows
      auto issue_sdp = [&](float (&st)[4][4], float (&dpt)[4][4], int qh) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
          dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        }
        reg_fence(st);
        reg_fence(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int off = qh * 128 + kk * 32;
          wgmma_m64n32k16(st, kf[kk], gmma_desc(q_s + off));
          wgmma_m64n32k16(dpt, vf[kk], gmma_desc(do_s + off));
        }
        wgmma_commit();
      };
      // p^T, p_drop^T, ds^T in registers for queries qh.., packed to bf16
      // pairs: [nt][0] is key g, [nt][1] key g + 8, each at queries nt * 8
      // + 2t, + 1; bf16(ds^T) staged to the ds^T tile
      auto softmax_grad = [&](const float (&st)[4][4],
                              const float (&dpt)[4][4], int qh) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int qc = q0 + qh + nt * 8 + 2 * t;
          const float2 lq = *reinterpret_cast<const float2*>(&lse_s[qc]);
          const float2 dl = *reinterpret_cast<const float2*>(&delta_s[qc]);
          const int2 sq = *reinterpret_cast<const int2*>(&seg_s[qc]);
          float pd[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2, odd = e & 1;
            const int query = qc + odd;
            bool live = true;
            if (seg_row) {
              const int sqv = odd ? sq.y : sq.x;
              live = sqv > 0 && sqv == (hi ? segk_b : segk_a);
            }
            const float pv =
                live ? fast_exp2(fmaf(st[nt][e], scale_l2,
                                      (hi ? kb_b : kb_a) - (odd ? lq.y : lq.x)))
                     : 0.f;
            float dpv = dpt[nt][e], pdv = pv;
            if constexpr (kDrop) {
              // one hash an element; dropped: dp and p times 0
              const float m =
                  flash_hash((static_cast<uint32_t>(query) * 0x9E3779B1u) ^
                             (hi ? kh_b : kh_a)) >= keep_min
                      ? inv_keep
                      : 0.f;
              dpv *= m;
              pdv *= m;
            }
            ds[e] = pv * (dpv - (odd ? dl.y : dl.x));
            pd[e] = pdv;
          }
          pw[nt][0] = pack_bf16(pd[0], pd[1]);
          pw[nt][1] = pack_bf16(pd[2], pd[3]);
          dw[nt][0] = pack_bf16(ds[0], ds[1]);
          dw[nt][1] = pack_bf16(ds[2], ds[3]);
          const int chunk = (qh >> 3) + nt;
          *reinterpret_cast<uint32_t*>(dst_s + sw(warp * 16 + g, chunk) +
                                       4 * t) = dw[nt][0];
          *reinterpret_cast<uint32_t*>(dst_s + sw(warp * 16 + g + 8, chunk) +
                                       4 * t) = dw[nt][1];
        }
      };
      // dv += bf16(p_drop^T) dO, dk += bf16(ds^T) q for queries qh..: A
      // from the registers (the accumulator layout packed is the A
      // layout), B the MN-major dO and q rows qh + 16 kc..
      auto issue_dkv = [&](int qh) {
        reg_fence(pw);
        reg_fence(dw);
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const uint32_t ap[4] = {pw[2 * kc][0], pw[2 * kc][1],
                                  pw[2 * kc + 1][0], pw[2 * kc + 1][1]};
          const uint32_t ad[4] = {dw[2 * kc][0], dw[2 * kc][1],
                                  dw[2 * kc + 1][0], dw[2 * kc + 1][1]};
          const int off = (qh + 16 * kc) * 128;
          wgmma_m64n64k16(dv, ap, gmma_desc(do_s + off));
          wgmma_m64n64k16(dk, ad, gmma_desc(q_s + off));
        }
        wgmma_commit();
      };

      issue_sdp(st0, dp0, 0);
      // these and the last tile's dq product, committed before them, are
      // done
      wgmma_wait_all();
      reg_fence(acc);
      if (pend >= 0) add_dq(dq_s, acc, pend + qr, hc, g, t);
      pend = -1;
      reg_fence(st0);
      reg_fence(dp0);
      issue_sdp(st1, dp1, 32);
      softmax_grad(st0, dp0, 0);
      issue_dkv(0);
      wgmma_wait_all();
      reg_fence(st1);
      reg_fence(dp1);
      reg_fence(dv);
      reg_fence(dk);
      softmax_grad(st1, dp1, 32);
      issue_dkv(32);
      wgmma_wait_all();
      reg_fence(dv);
      reg_fence(dk);
    }
    fence_proxy_async();  // the ds^T stores are read by wgmma
    __syncthreads();      // the ds^T tile is whole
    if (!skip) {
      // dq_tile += ds k_tile, 64 queries x 32 head-dim columns a
      // warpgroup: A the ds^T tile read MN-major (ds), B the MN-major k
      // tile; left in flight
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kKT / 16; ++kc) {
        wgmma_m64n32k16_ss(acc, gmma_desc(dst_s + 16 * kc * 128),
                                 gmma_desc(k_s + 16 * kc * 128 + hc * 2),
                                 kc > 0);
      }
      wgmma_commit();
      pend = q0;
    }
    if (tid == 0 && it + 1 < n_iter) {
      // the next q tile into the other stage, which iteration it - 1 left
      // (its products all waited for), in flight under the rest of this
      // one; issued here, off the path to this tile's products
      const int nxt = (it + 1 - (it + 1) / nq * nq) * kQT;
      unsigned char* stage = ring + ((it + 1) & 1) * 2 * kQTileBytes;
      uint64_t* bar = bars + ((it + 1) & 1);
      mbar_expect(bar, 2 * kQTileBytes);
      tma_load(stage, &maps.q, h, nxt, b, bar);
      tma_load(stage + kQTileBytes, &maps.dout, h, nxt, b, bar);
    }

    if (qt == nq - 1) {
      // the key tile is done: dk * scale and dv leave the registers
      uint16_t* dkg = static_cast<uint16_t*>(bp.dk) + bh_off;
      uint16_t* dvg = static_cast<uint16_t*>(bp.dv) + bh_off;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const int c = dt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkg + key_a * row_stride + c) =
            pack_bf16(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + key_a * row_stride + c) =
            pack_bf16(dv[dt][0], dv[dt][1]);
        *reinterpret_cast<uint32_t*>(dkg + key_b * row_stride + c) =
            pack_bf16(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + key_b * row_stride + c) =
            pack_bf16(dv[dt][2], dv[dt][3]);
      }
    }
  }
  wgmma_wait_all();
  reg_fence(acc);
  if (pend >= 0) add_dq(dq_s, acc, pend + qr, hc, g, t);

  __syncthreads();  // every dq update is in
  uint16_t* dqg = static_cast<uint16_t*>(bp.dq) + bh_off;
  for (int i = tid; i < S * kChunks; i += kFThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(&dq_s[dq_index(r, c)]);
    const float4 hi = *reinterpret_cast<const float4*>(&dq_s[dq_index(r, c) + 4]);
    const float sc = p.scale;
    const uint4 w = make_uint4(pack_bf16(lo.x * sc, lo.y * sc),
                               pack_bf16(lo.z * sc, lo.w * sc),
                               pack_bf16(hi.x * sc, hi.y * sc),
                               pack_bf16(hi.z * sc, hi.w * sc));
    *reinterpret_cast<uint4*>(dqg + r * row_stride + c) = w;
  }
  if (tid == 0 && n_skipped > 0 && p.skipped) atomicAdd(p.skipped, n_skipped);
}

using FusedKernel = void (*)(const FusedMaps, FlashBwdParams, float);

FusedKernel fused_kernel(bool drop) {
  return drop ? flash_bwd_fused_bf16_kernel<true>
              : flash_bwd_fused_bf16_kernel<false>;
}

}  // namespace

int flash_bwd_fused_smem(int seq) { return fused_smem(seq); }

int flash_bwd_fused_max_seq() {
  int seq = 0;
  while (fused_smem(seq + kKT) <= kMaxSmem && (seq + kKT) / kQT <= kMaxTiles)
    seq += kKT;
  return seq;
}

FlashTile flash_bwd_fused_tile() { return {kQT, kKT}; }

cudaError_t flash_attention_bwd_fused(const FlashBwdParams& p,
                                      cudaStream_t stream) {
  const FlashParams& f = p.f;
  if (f.batch == 0 || f.seq == 0 || f.heads == 0) return cudaSuccess;
  if (f.head_dim != kHD || f.seq % kKT != 0 ||
      f.seq > flash_bwd_fused_max_seq())
    return cudaErrorInvalidValue;
  // out and dO: contiguous (B, S, H, D)
  const int64_t packed[3] = {static_cast<int64_t>(f.seq) * f.heads * kHD,
                             static_cast<int64_t>(f.heads) * kHD, kHD};
  FusedMaps maps;
  if (!make_map(&maps.q, f.q, f, f.q_strides, kQT) ||
      !make_map(&maps.dout, p.dout, f, packed, kQT) ||
      !make_map(&maps.k, f.k, f, f.k_strides, kKT) ||
      !make_map(&maps.v, f.v, f, f.v_strides, kKT) ||
      !make_map(&maps.out_k, f.out, f, packed, kKT) ||
      !make_map(&maps.dout_k, p.dout, f, packed, kKT))
    return cudaErrorInvalidValue;
  const int smem = fused_smem(f.seq);
  FusedKernel kernel = fused_kernel(f.drop.apply);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float inv_keep = f.drop.apply ? 1.f / f.drop.keep_div : 1.f;
  kernel<<<dim3(f.heads, f.batch), kFThreads, smem, stream>>>(maps, p,
                                                              inv_keep);
  return cudaGetLastError();
}

cudaError_t flash_bwd_fused_info(bool dropout, KernelInfo* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fused_kernel(dropout));
  if (err != cudaSuccess) return err;
  info->registers = a.numRegs;
  info->local_bytes = static_cast<int>(a.localSizeBytes);
  info->static_smem_bytes = static_cast<int>(a.sharedSizeBytes);
  info->max_threads = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace bert_kernels
