// The split flash-attention backward for Hopper: the dq kernel and the
// dk/dv kernel, bf16 at head dim 64, sequences of whole 128-key tiles
// (every length the flash route takes).
//
// Replaces the split Pallas backward kernels of bert_pytorch_tpu/ops/
// pallas/flash_attention.py, `_dq_kernel` and `_dkv_kernel`: one function
// in two launches, which recomputes p = exp(s - lse) from the forward's lse
// under the padding bias or the packed-segment mask (pad rows p = 0, whole
// tiles whose segment ranges do not meet skipped), applies the flash
// dropout mask (`_keep_mask`) at the forward's seed and rate, and writes
// dq = ds k * scale, then dk = ds^T q * scale and dv = p_drop^T dO, with
// ds = p (dp_drop - delta). delta = rowsum(dO out), which the Pallas
// wrapper computes outside any kernel, is formed in the dq kernel and
// written out for the dk/dv kernel, which runs after it on the stream.
// Each output element has one owner, so no numeric output takes an atomic
// and a rerun gives the same bits. The f32 pair stays in
// flash_attention.cu; bf16 backwards at seq <= 512 take the fused kernel
// of flash_attention_bwd.cu (ops/attention.fused_bwd_takes).
//
// What bounds them: at (16, 512, 16, 64) the dq kernel needs 3 products of
// 2 S^2 D flops a head (s, dp, dq: 25.8 GFLOP, 26.1 us at the H100's dense
// bf16 rate) against 101.7 MB of traffic (30.4 us at 3.35 TB/s), the dk/dv
// kernel 4 (s^T, dp^T, dv, dk: 34.4 GFLOP, 34.7 us) against the same
// bytes; at seq 1024 and 2048 (the same 8192 tokens) the products double
// and quadruple while the bytes stay, so both are bound by the tensor
// cores, and the element-wise work (an exp2, the mask and a hash a score)
// has to run beside them.
//
// The design of both is the forward's (flash_attention_fwd.cu): a
// persistent grid of one CTA an SM walks work items of one (batch, head),
// each CTA three warpgroups: a producer warpgroup whose first warp loads
// by TMA, and two consumer warpgroups of 64 rows each, which multiply
// with wgmma. setmaxnreg moves registers from the producer (40 a thread)
// to the consumers (232). The producer brings the item's own tile once
// (two buffers, so the next item's loads overlap this one's tail) and
// streams the other operand through a ring of kStages stages with a full
// and an empty mbarrier each, in the 128-byte swizzle that TMA writes and
// wgmma reads, with the per-row terms of the tile beside it. With packed
// segments it forms each streamed tile's segment range from ids it loaded
// a tile ahead and marks which warpgroups read the tile; a tile neither
// reads is not loaded. A marker stage ends each item. The two consumer
// warpgroups run free: one's element-wise work runs while the other's
// products hold the tensor cores.
//
// dq: a work item is 128 queries, a streamed tile 128 keys (k and v, the
// keys' bias and segment ids by TMA, the hash's column terms written by
// the producer). A consumer warpgroup forms delta for its 64 rows from dO
// in shared memory and out in device memory and writes it out; then, a key
// tile at a time, s = q k^T and dp = dO v^T (wgmma m64n128k16, both
// operands K-major from shared memory), p = exp2(s scale log2e + bias
// log2e - lse log2e) under the mask, ds = p (dp keep / (1 - rate) -
// delta), and dq += bf16(ds) k (wgmma m64n64k16, ds packed in registers as
// the A operand, k an MN-major B operand: the forward's P V).
//
// dk/dv: a work item is 128 keys, whose k and v tiles stay in shared
// memory for the item, and a streamed tile 64 queries (q and dO, and their
// lse, delta and segment ids by TMA, the hash's row terms written by the
// producer). Per tile, s^T = k q^T and dp^T = v dO^T (wgmma m64n64k16,
// both operands K-major from shared memory), p^T, p_drop^T and ds^T in
// registers, then dv += bf16(p_drop^T) dO and dk += bf16(ds^T) q (the
// packed registers as A operands, dO and q MN-major B operands). No state
// grows with the sequence.
//
// Every wgmma group is waited for by a wait_group 0 in the block that
// issued it, at a point the whole warpgroup passes, and no instruction
// touches its registers before: ptxas keeps the wgmma pipeline (no
// C75xx serialization, which chip_smoke.py's build phase checks).
//
// Shared memory, one CTA an SM: dq 203,392 B (q and dO of two items, 4
// stages of k and v, their key terms, the barriers); dk/dv 135,808 B (k
// and v of two items, 4 stages of q and dO, their row terms, the
// barriers).
#include <algorithm>

#include "common.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kHD = 64;                  // head dim
constexpr int kRowBytes = kHD * 2;       // a bf16 row: one swizzle atom
constexpr int kWGRows = 64;              // rows a consumer warpgroup owns
constexpr int kItemRows = 2 * kWGRows;   // rows a work item owns
constexpr int kConsumerWarps = 8;
// + the producer warpgroup, whose first warp works
constexpr int kThreads = (kConsumerWarps + 4) * 32;
// Registers a thread: 168 at launch; setmaxnreg moves them from the
// producer warpgroup to the consumers (the forward's split).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 3 * 168 - 2 * kConsumerRegs;  // the balance
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg");
constexpr int kStages = 4;
constexpr int kItemBytes = kItemRows * kRowBytes;  // 16,384
constexpr int kEnd = 4;  // stage flag: no tile, the work item ends
static_assert(kHD == kMapCols, "tensor maps of whole 64-column rows");

// dq: 128-key tiles
constexpr int kDqKeys = 128;
constexpr int kDqTileBytes = kDqKeys * kRowBytes;  // 16,384
// dk/dv: 64-query tiles
constexpr int kKvQRows = 64;
constexpr int kKvTileBytes = kKvQRows * kRowBytes;  // 8,192

// What a dq stage holds beside its k and v tiles.
struct alignas(128) DqMeta {
  float bias[kDqKeys];     // the keys' bias (TMA; zeros without a bias)
  int seg[kDqKeys];        // their segment ids (TMA with packed segments)
  uint32_t colh[kDqKeys];  // the hash's column term: c ^ (c >> 16), c =
                           // key * 0x85EBCA77
  int flags;               // bit w: warpgroup w reads the tile; kEnd
};

struct DqSmem {  // the dynamic shared memory, 1024-byte aligned
  unsigned char q[2][kItemBytes];  // two items' q: the next loads early
  unsigned char dout[2][kItemBytes];
  unsigned char k[kStages][kDqTileBytes];
  unsigned char v[kStages][kDqTileBytes];
  DqMeta meta[kStages];
  uint64_t full[kStages];   // the producer's two arrivals + the bytes
  uint64_t empty[kStages];  // one arrival a consumer warp
  uint64_t q_full[2];
  uint64_t q_empty[2];      // one arrival a consumer warp
};

// What a dk/dv stage holds beside its q and dO tiles.
struct alignas(128) KvMeta {
  float lse[kKvQRows];      // the queries' lse (TMA)
  float delta[kKvQRows];    // their delta (TMA)
  int seg[kKvQRows];        // their segment ids (TMA with packed segments)
  uint32_t rowh[kKvQRows];  // the hash's row term: r ^ (r >> 16), r =
                            // query * 0x9E3779B1 ^ seed_bh
  int flags;                // bit w: warpgroup w reads the tile; kEnd
};

struct KvSmem {  // the dynamic shared memory, 1024-byte aligned
  unsigned char k[2][kItemBytes];  // two items' k and v
  unsigned char v[2][kItemBytes];
  unsigned char q[kStages][kKvTileBytes];
  unsigned char dout[kStages][kKvTileBytes];
  KvMeta meta[kStages];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full[2];
  uint64_t kv_empty[2];
};

// dq: q and dO in items of 128 rows, k and v in tiles of 128 keys, the
// keys' bias and segment ids (B, S) in rows of one tile (each only when
// present)
struct DqMaps {
  CUtensorMap q, dout, k, v, bias, seg;
};

// dk/dv: k and v in items of 128 rows, q and dO in tiles of 64 rows, lse
// and delta (B * H, S) and the segment ids (B, S) in rows of one tile
struct KvMaps {
  CUtensorMap k, v, q, dout, lse, delta, seg;
};

// work item -> (batch, head, first row), 128-row blocks fastest so that
// CTAs working at once share the streamed operand in L2
struct Item {
  int b, h, r0;
};

__device__ __forceinline__ Item item_of(int item, int seq, int heads) {
  const int nb = seq / kItemRows;
  const int bh = item / nb;
  return {bh / heads, bh - bh / heads * heads, (item - bh * nb) * kItemRows};
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* own_full,
                                              uint64_t* own_empty) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&full[i], 2);
    mbar_init(&empty[i], kConsumerWarps);
  }
  for (int i = 0; i < 2; ++i) {
    mbar_init(&own_full[i], 1);
    mbar_init(&own_empty[i], kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// -- dq -----------------------------------------------------------------------

template <bool kDrop, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ DqMaps maps,
                         FlashBwdParams bp, float inv_keep, int n_items) {
  const FlashParams& p = bp.f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    if ((smem_addr(smem_raw) & 1023) != 0) __trap();  // the swizzle's base
    init_barriers(sm.full, sm.empty, sm.q_full, sm.q_empty);
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp == kConsumerWarps) {
      // -- the producer warp -------------------------------------------------
      int pos = 0, n_skipped = 0;
      for (int it = 0, item = blockIdx.x; item < n_items;
           ++it, item += gridDim.x) {
        const Item w = item_of(item, S, H);
        if (lane == 0) {
          // both warpgroups are done with the item two back
          mbar_wait(&sm.q_empty[it & 1], ((it >> 1) & 1) ^ 1);
          mbar_expect(&sm.q_full[it & 1], 2 * kItemBytes);
          tma_load(sm.q[it & 1], &maps.q, w.h, w.r0, w.b, &sm.q_full[it & 1]);
          tma_load(sm.dout[it & 1], &maps.dout, w.h, w.r0, w.b,
                   &sm.q_full[it & 1]);
        }
        const int32_t* seg_row =
            kSeg ? p.seg + static_cast<int64_t>(w.b) * S : nullptr;
        int qmn0 = 0, qmx0 = 0, qmn1 = 0, qmx1 = 0, ks[kDqKeys / 32];
        if constexpr (kSeg) {
          warp_seg_range<2>(seg_row, w.r0, lane, qmn0, qmx0);
          warp_seg_range<2>(seg_row, w.r0 + kWGRows, lane, qmn1, qmx1);
#pragma unroll
          for (int i = 0; i < kDqKeys / 32; ++i) ks[i] = seg_row[32 * i + lane];
        }
        for (int k0 = 0; k0 < S; k0 += kDqKeys) {
          int flags = 3;
          if constexpr (kSeg) {
            // the key tile's segment range from ids loaded a tile ahead
            int hi = 0, lo = kSegBig;
#pragma unroll
            for (int i = 0; i < kDqKeys / 32; ++i) {
              hi = max(hi, ks[i]);
              if (ks[i] > 0) lo = min(lo, ks[i]);
            }
            const int kmx = warp_max(hi), kmn = warp_min(lo);
            if (k0 + kDqKeys < S) {
#pragma unroll
              for (int i = 0; i < kDqKeys / 32; ++i)
                ks[i] = seg_row[k0 + kDqKeys + 32 * i + lane];
            }
            flags = (seg_overlap(qmn0, qmx0, kmn, kmx) ? 1 : 0) |
                    (seg_overlap(qmn1, qmx1, kmn, kmx) ? 2 : 0);
            n_skipped += (flags & 1 ? 0 : 1) + (flags & 2 ? 0 : 1);
            if (flags == 0) continue;  // neither warpgroup reads it
          }
          const int s = pos % kStages;
          mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
          DqMeta& m = sm.meta[s];
          if (lane == 0) {
            // the first arrival: the bytes of every copy into the stage
            mbar_expect(&sm.full[s], 2 * kDqTileBytes +
                                         (p.bias ? kDqKeys * 4 : 0) +
                                         (kSeg ? kDqKeys * 4 : 0));
            tma_load(sm.k[s], &maps.k, w.h, k0, w.b, &sm.full[s]);
            tma_load(sm.v[s], &maps.v, w.h, k0, w.b, &sm.full[s]);
            if (p.bias) tma_load_row(m.bias, &maps.bias, k0, w.b, &sm.full[s]);
            if (kSeg) tma_load_row(m.seg, &maps.seg, k0, w.b, &sm.full[s]);
          }
#pragma unroll
          for (int i = 0; i < kDqKeys / 32; ++i) {
            const int c = 32 * i + lane;
            const uint32_t ch = static_cast<uint32_t>(k0 + c) * 0x85EBCA77u;
            m.colh[c] = ch ^ (ch >> 16);
            if (!p.bias) m.bias[c] = 0.f;
          }
          if (lane == 0) m.flags = flags;
          __syncwarp();  // the warp's writes precede lane 0's release
          if (lane == 0) mbar_arrive(&sm.full[s]);  // the second arrival
          ++pos;
        }
        // the item's end marker
        const int s = pos % kStages;
        mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
        if (lane == 0) {
          sm.meta[s].flags = kEnd;
          mbar_arrive(&sm.full[s]);
          mbar_arrive(&sm.full[s]);
        }
        ++pos;
      }
      if (lane == 0 && n_skipped > 0 && p.skipped)
        atomicAdd(p.skipped, n_skipped);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  // -- the consumer warpgroups ------------------------------------------------
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float scale_l2 = p.scale * kLog2e;
  // keep iff hash >> 9 >= threshold, i.e. hash >= threshold << 9
  const uint32_t keep_min = p.drop.threshold << 9;
  const int64_t row_stride = static_cast<int64_t>(H) * kHD;
  // scores and dp of one key tile in f32, then bf16(ds) (the A operand of
  // dq += ds k), and dq
  float sc[16][4], dp[16][4], dq[8][4];
  uint32_t dsw[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
  int pos = 0;

  for (int it = 0, item = blockIdx.x; item < n_items;
       ++it, item += gridDim.x) {
    const Item w = item_of(item, S, H);
    const int rt = wg * kWGRows + wq * 16;  // this warp's first row in q_s
    const int row_a = w.r0 + rt + g, row_b = row_a + 8;
    const int64_t bh_off = (static_cast<int64_t>(w.b) * S * H + w.h) * kHD;
    int sq_a = 0, sq_b = 0;  // a key matches iff its id equals these
    if constexpr (kSeg) {
      const int32_t* seg_row = p.seg + static_cast<int64_t>(w.b) * S;
      sq_a = seg_row[row_a];
      sq_b = seg_row[row_b];
      // no key has segment -1: pad rows match none (p = 0 on them)
      if (sq_a == 0) sq_a = -1;
      if (sq_b == 0) sq_b = -1;
    }
    uint32_t rh_a = 0u, rh_b = 0u;  // the hash's row terms
    if constexpr (kDrop) {
      const uint32_t seed_bh = seed_bh_of(p.drop, w.b, H, w.h);
      rh_a = (static_cast<uint32_t>(row_a) * 0x9E3779B1u) ^ seed_bh;
      rh_b = (static_cast<uint32_t>(row_b) * 0x9E3779B1u) ^ seed_bh;
      rh_a ^= rh_a >> 16;
      rh_b ^= rh_b >> 16;
    }
    const float* lse_row = p.lse + (static_cast<int64_t>(w.b) * H + w.h) * S;
    const float lq_a = lse_row[row_a] * kLog2e;
    const float lq_b = lse_row[row_b] * kLog2e;
    const unsigned char* q_s = sm.q[it & 1] + wg * kWGRows * kRowBytes;
    const unsigned char* do_s = sm.dout[it & 1] + wg * kWGRows * kRowBytes;

    mbar_wait(&sm.q_full[it & 1], (it >> 1) & 1);
    // delta = rowsum(f32(dO) f32(out)) of this warp's 16 rows, two lanes a
    // row (half the columns each), dO from shared memory
    float dl_a, dl_b;
    {
      const int r = lane >> 1, half = lane & 1;
      const int row = w.r0 + rt + r;
      const uint16_t* orow =
          static_cast<const uint16_t*>(p.out) + bh_off + row * row_stride;
      float acc = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = half * 4 + cc;
        uint16_t ov[8], dv_[8];
        load_vec<8>(orow + c * 8, ov);
        load_vec<8>(reinterpret_cast<const uint16_t*>(
                        sm.dout[it & 1] + sw(rt + r, c)),
                    dv_);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += BF16::to_f32(dv_[e]) * BF16::to_f32(ov[e]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0)
        bp.delta[(static_cast<int64_t>(w.b) * H + w.h) * S + row] = acc;
      dl_a = __shfl_sync(0xffffffffu, acc, 2 * g);
      dl_b = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

    for (;;) {
      const int st = pos % kStages;
      mbar_wait(&sm.full[st], (pos / kStages) & 1);
      ++pos;
      const int f = sm.meta[st].flags;
      if (f & (1 << wg)) {
        // s = q k^T, dp = dO v^T: 64 rows x 128 keys each
        reg_fence(sc);
        reg_fence(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k16_ss(sc, gmma_desc(q_s + kk * 32),
                              gmma_desc(sm.k[st] + kk * 32), kk > 0);
          wgmma_m64n128k16_ss(dp, gmma_desc(do_s + kk * 32),
                              gmma_desc(sm.v[st] + kk * 32), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(dp);
        // ds = p (dp_drop - delta) in registers, packed to bf16 pairs
        const DqMeta& mt = sm.meta[st];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 bk = *reinterpret_cast<const float2*>(&mt.bias[col]);
          const float b0 = bk.x * kLog2e, b1 = bk.y * kLog2e;
          float p0 = fast_exp2(fmaf(sc[j][0], scale_l2, b0 - lq_a));
          float p1 = fast_exp2(fmaf(sc[j][1], scale_l2, b1 - lq_a));
          float p2 = fast_exp2(fmaf(sc[j][2], scale_l2, b0 - lq_b));
          float p3 = fast_exp2(fmaf(sc[j][3], scale_l2, b1 - lq_b));
          if constexpr (kSeg) {
            const int2 sk = *reinterpret_cast<const int2*>(&mt.seg[col]);
            p0 = sk.x == sq_a ? p0 : 0.f;
            p1 = sk.y == sq_a ? p1 : 0.f;
            p2 = sk.x == sq_b ? p2 : 0.f;
            p3 = sk.y == sq_b ? p3 : 0.f;
          }
          float d0 = dp[j][0], d1 = dp[j][1], d2 = dp[j][2], d3 = dp[j][3];
          if constexpr (kDrop) {
            // one hash an element; dropped: dp times 0
            const uint2 ch = *reinterpret_cast<const uint2*>(&mt.colh[col]);
            d0 *= keep_mix(rh_a ^ ch.x) >= keep_min ? inv_keep : 0.f;
            d1 *= keep_mix(rh_a ^ ch.y) >= keep_min ? inv_keep : 0.f;
            d2 *= keep_mix(rh_b ^ ch.x) >= keep_min ? inv_keep : 0.f;
            d3 *= keep_mix(rh_b ^ ch.y) >= keep_min ? inv_keep : 0.f;
          }
          dsw[j][0] = pack_bf16(p0 * (d0 - dl_a), p1 * (d1 - dl_a));
          dsw[j][1] = pack_bf16(p2 * (d2 - dl_b), p3 * (d3 - dl_b));
        }
        // dq += bf16(ds) k: A from the registers, B the MN-major k rows
        reg_fence(dsw);
        reg_fence(dq);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kDqKeys / 16; ++kc) {
          const uint32_t a[4] = {dsw[2 * kc][0], dsw[2 * kc][1],
                                 dsw[2 * kc + 1][0], dsw[2 * kc + 1][1]};
          wgmma_m64n64k16(dq, a, gmma_desc(sm.k[st] + 16 * kc * kRowBytes));
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dq);
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
      if (f & kEnd) break;
    }
    // this warp is done with the item's q and dO
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.q_empty[it & 1]);

    // dq * scale leaves the registers as bf16
    uint16_t* dqg = static_cast<uint16_t*>(bp.dq) + bh_off;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int c = d * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dqg + row_a * row_stride + c) =
          pack_bf16(dq[d][0] * p.scale, dq[d][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dqg + row_b * row_stride + c) =
          pack_bf16(dq[d][2] * p.scale, dq[d][3] * p.scale);
    }
  }
}

// -- dk/dv --------------------------------------------------------------------

template <bool kDrop, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ KvMaps maps,
                          FlashBwdParams bp, float inv_keep, int n_items) {
  const FlashParams& p = bp.f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  KvSmem& sm = *reinterpret_cast<KvSmem*>(smem_raw);
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    if ((smem_addr(smem_raw) & 1023) != 0) __trap();  // the swizzle's base
    init_barriers(sm.full, sm.empty, sm.kv_full, sm.kv_empty);
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp == kConsumerWarps) {
      // -- the producer warp -------------------------------------------------
      int pos = 0, n_skipped = 0;
      for (int it = 0, item = blockIdx.x; item < n_items;
           ++it, item += gridDim.x) {
        const Item w = item_of(item, S, H);
        if (lane == 0) {
          // both warpgroups are done with the item two back
          mbar_wait(&sm.kv_empty[it & 1], ((it >> 1) & 1) ^ 1);
          mbar_expect(&sm.kv_full[it & 1], 2 * kItemBytes);
          tma_load(sm.k[it & 1], &maps.k, w.h, w.r0, w.b, &sm.kv_full[it & 1]);
          tma_load(sm.v[it & 1], &maps.v, w.h, w.r0, w.b, &sm.kv_full[it & 1]);
        }
        const int32_t* seg_row =
            kSeg ? p.seg + static_cast<int64_t>(w.b) * S : nullptr;
        const int bh = w.b * H + w.h;
        const uint32_t seed_bh = kDrop ? seed_bh_of(p.drop, w.b, H, w.h) : 0u;
        int kmn0 = 0, kmx0 = 0, kmn1 = 0, kmx1 = 0, qs[kKvQRows / 32];
        if constexpr (kSeg) {
          warp_seg_range<2>(seg_row, w.r0, lane, kmn0, kmx0);
          warp_seg_range<2>(seg_row, w.r0 + kWGRows, lane, kmn1, kmx1);
#pragma unroll
          for (int i = 0; i < kKvQRows / 32; ++i) qs[i] = seg_row[32 * i + lane];
        }
        for (int q0 = 0; q0 < S; q0 += kKvQRows) {
          int flags = 3;
          if constexpr (kSeg) {
            // the query tile's segment range from ids loaded a tile ahead
            int hi = 0, lo = kSegBig;
#pragma unroll
            for (int i = 0; i < kKvQRows / 32; ++i) {
              hi = max(hi, qs[i]);
              if (qs[i] > 0) lo = min(lo, qs[i]);
            }
            const int qmx = warp_max(hi), qmn = warp_min(lo);
            if (q0 + kKvQRows < S) {
#pragma unroll
              for (int i = 0; i < kKvQRows / 32; ++i)
                qs[i] = seg_row[q0 + kKvQRows + 32 * i + lane];
            }
            flags = (seg_overlap(qmn, qmx, kmn0, kmx0) ? 1 : 0) |
                    (seg_overlap(qmn, qmx, kmn1, kmx1) ? 2 : 0);
            n_skipped += (flags & 1 ? 0 : 1) + (flags & 2 ? 0 : 1);
            if (flags == 0) continue;  // neither warpgroup reads it
          }
          const int s = pos % kStages;
          mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
          KvMeta& m = sm.meta[s];
          if (lane == 0) {
            mbar_expect(&sm.full[s], 2 * kKvTileBytes + 2 * kKvQRows * 4 +
                                         (kSeg ? kKvQRows * 4 : 0));
            tma_load(sm.q[s], &maps.q, w.h, q0, w.b, &sm.full[s]);
            tma_load(sm.dout[s], &maps.dout, w.h, q0, w.b, &sm.full[s]);
            tma_load_row(m.lse, &maps.lse, q0, bh, &sm.full[s]);
            tma_load_row(m.delta, &maps.delta, q0, bh, &sm.full[s]);
            if (kSeg) tma_load_row(m.seg, &maps.seg, q0, w.b, &sm.full[s]);
          }
          if constexpr (kDrop) {
#pragma unroll
            for (int i = 0; i < kKvQRows / 32; ++i) {
              const int r = 32 * i + lane;
              const uint32_t rh =
                  (static_cast<uint32_t>(q0 + r) * 0x9E3779B1u) ^ seed_bh;
              m.rowh[r] = rh ^ (rh >> 16);
            }
          }
          if (lane == 0) m.flags = flags;
          __syncwarp();  // the warp's writes precede lane 0's release
          if (lane == 0) mbar_arrive(&sm.full[s]);  // the second arrival
          ++pos;
        }
        // the item's end marker
        const int s = pos % kStages;
        mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
        if (lane == 0) {
          sm.meta[s].flags = kEnd;
          mbar_arrive(&sm.full[s]);
          mbar_arrive(&sm.full[s]);
        }
        ++pos;
      }
      if (lane == 0 && n_skipped > 0 && p.skipped)
        atomicAdd(p.skipped, n_skipped);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  // -- the consumer warpgroups ------------------------------------------------
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float scale_l2 = p.scale * kLog2e;
  const uint32_t keep_min = p.drop.threshold << 9;
  const int64_t row_stride = static_cast<int64_t>(H) * kHD;
  // s^T and dp^T of one query tile in f32 (keys x queries), then
  // bf16(p_drop^T) and bf16(ds^T) (the A operands of dv and dk), and dk, dv
  float st[8][4], dpt[8][4], dk[8][4], dv[8][4];
  uint32_t pw[8][2], dw[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
  int pos = 0;

  for (int it = 0, item = blockIdx.x; item < n_items;
       ++it, item += gridDim.x) {
    const Item w = item_of(item, S, H);
    const int key_a = w.r0 + wg * kWGRows + wq * 16 + g, key_b = key_a + 8;
    const int64_t bh_off = (static_cast<int64_t>(w.b) * S * H + w.h) * kHD;
    int sk_a = 0, sk_b = 0;  // a query matches iff its id equals these
    if constexpr (kSeg) {
      const int32_t* seg_row = p.seg + static_cast<int64_t>(w.b) * S;
      sk_a = seg_row[key_a];
      sk_b = seg_row[key_b];
      // no query has segment -1: pad keys match none, and pad queries
      // (segment 0) match no key
      if (sk_a == 0) sk_a = -1;
      if (sk_b == 0) sk_b = -1;
    }
    float kb_a = 0.f, kb_b = 0.f;  // the keys' bias times log2 e
    if (p.bias) {
      const float* bias_row = p.bias + static_cast<int64_t>(w.b) * S;
      kb_a = bias_row[key_a] * kLog2e;
      kb_b = bias_row[key_b] * kLog2e;
    }
    uint32_t ch_a = 0u, ch_b = 0u;  // the hash's column terms
    if constexpr (kDrop) {
      ch_a = static_cast<uint32_t>(key_a) * 0x85EBCA77u;
      ch_b = static_cast<uint32_t>(key_b) * 0x85EBCA77u;
      ch_a ^= ch_a >> 16;
      ch_b ^= ch_b >> 16;
    }
    const unsigned char* k_s = sm.k[it & 1] + wg * kWGRows * kRowBytes;
    const unsigned char* v_s = sm.v[it & 1] + wg * kWGRows * kRowBytes;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
    }
    mbar_wait(&sm.kv_full[it & 1], (it >> 1) & 1);

    for (;;) {
      const int sn = pos % kStages;
      mbar_wait(&sm.full[sn], (pos / kStages) & 1);
      ++pos;
      const int f = sm.meta[sn].flags;
      if (f & (1 << wg)) {
        // s^T = k q^T, dp^T = v dO^T: 64 keys x 64 queries each
        reg_fence(st);
        reg_fence(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(st, gmma_desc(k_s + kk * 32),
                             gmma_desc(sm.q[sn] + kk * 32), kk > 0);
          wgmma_m64n64k16_ss(dpt, gmma_desc(v_s + kk * 32),
                             gmma_desc(sm.dout[sn] + kk * 32), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        reg_fence(dpt);
        // p^T, p_drop^T and ds^T in registers, packed to bf16 pairs:
        // [j][0] key g, [j][1] key g + 8, each at queries 8j + 2t, + 1
        const KvMeta& mt = sm.meta[sn];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 lq = *reinterpret_cast<const float2*>(&mt.lse[col]);
          const float2 dl = *reinterpret_cast<const float2*>(&mt.delta[col]);
          const float l0 = lq.x * kLog2e, l1 = lq.y * kLog2e;
          float p0 = fast_exp2(fmaf(st[j][0], scale_l2, kb_a - l0));
          float p1 = fast_exp2(fmaf(st[j][1], scale_l2, kb_a - l1));
          float p2 = fast_exp2(fmaf(st[j][2], scale_l2, kb_b - l0));
          float p3 = fast_exp2(fmaf(st[j][3], scale_l2, kb_b - l1));
          if constexpr (kSeg) {
            const int2 sq = *reinterpret_cast<const int2*>(&mt.seg[col]);
            p0 = sq.x == sk_a ? p0 : 0.f;
            p1 = sq.y == sk_a ? p1 : 0.f;
            p2 = sq.x == sk_b ? p2 : 0.f;
            p3 = sq.y == sk_b ? p3 : 0.f;
          }
          float m0 = 1.f, m1 = 1.f, m2 = 1.f, m3 = 1.f;
          if constexpr (kDrop) {
            // one hash an element; dropped: dp and p times 0
            const uint2 rh = *reinterpret_cast<const uint2*>(&mt.rowh[col]);
            m0 = keep_mix(rh.x ^ ch_a) >= keep_min ? inv_keep : 0.f;
            m1 = keep_mix(rh.y ^ ch_a) >= keep_min ? inv_keep : 0.f;
            m2 = keep_mix(rh.x ^ ch_b) >= keep_min ? inv_keep : 0.f;
            m3 = keep_mix(rh.y ^ ch_b) >= keep_min ? inv_keep : 0.f;
          }
          pw[j][0] = pack_bf16(p0 * m0, p1 * m1);
          pw[j][1] = pack_bf16(p2 * m2, p3 * m3);
          dw[j][0] = pack_bf16(p0 * (dpt[j][0] * m0 - dl.x),
                               p1 * (dpt[j][1] * m1 - dl.y));
          dw[j][1] = pack_bf16(p2 * (dpt[j][2] * m2 - dl.x),
                               p3 * (dpt[j][3] * m3 - dl.y));
        }
        // dv += bf16(p_drop^T) dO, dk += bf16(ds^T) q: A from the
        // registers, B the MN-major dO and q rows 16 kc..
        reg_fence(pw);
        reg_fence(dw);
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kKvQRows / 16; ++kc) {
          const uint32_t ap[4] = {pw[2 * kc][0], pw[2 * kc][1],
                                  pw[2 * kc + 1][0], pw[2 * kc + 1][1]};
          const uint32_t ad[4] = {dw[2 * kc][0], dw[2 * kc][1],
                                  dw[2 * kc + 1][0], dw[2 * kc + 1][1]};
          const int off = 16 * kc * kRowBytes;
          wgmma_m64n64k16(dv, ap, gmma_desc(sm.dout[sn] + off));
          wgmma_m64n64k16(dk, ad, gmma_desc(sm.q[sn] + off));
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dv);
        reg_fence(dk);
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[sn]);
      if (f & kEnd) break;
    }
    // this warp is done with the item's k and v
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.kv_empty[it & 1]);

    // dk * scale and dv leave the registers as bf16
    uint16_t* dkg = static_cast<uint16_t*>(bp.dk) + bh_off;
    uint16_t* dvg = static_cast<uint16_t*>(bp.dv) + bh_off;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int c = d * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + key_a * row_stride + c) =
          pack_bf16(dk[d][0] * p.scale, dk[d][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + key_a * row_stride + c) =
          pack_bf16(dv[d][0], dv[d][1]);
      *reinterpret_cast<uint32_t*>(dkg + key_b * row_stride + c) =
          pack_bf16(dk[d][2] * p.scale, dk[d][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + key_b * row_stride + c) =
          pack_bf16(dv[d][2], dv[d][3]);
    }
  }
}

// -- host ---------------------------------------------------------------------

using DqKernel = void (*)(const DqMaps, FlashBwdParams, float, int);
using KvKernel = void (*)(const KvMaps, FlashBwdParams, float, int);

DqKernel dq_kernel(bool drop, bool seg) {
  if (drop)
    return seg ? flash_bwd_dq_bf16_kernel<true, true>
               : flash_bwd_dq_bf16_kernel<true, false>;
  return seg ? flash_bwd_dq_bf16_kernel<false, true>
             : flash_bwd_dq_bf16_kernel<false, false>;
}

KvKernel kv_kernel(bool drop, bool seg) {
  if (drop)
    return seg ? flash_bwd_dkv_bf16_kernel<true, true>
               : flash_bwd_dkv_bf16_kernel<true, false>;
  return seg ? flash_bwd_dkv_bf16_kernel<false, true>
             : flash_bwd_dkv_bf16_kernel<false, false>;
}

// above 48 KiB of dynamic shared memory a kernel has to opt in, once an
// arm; `opted` is the arm's flag
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& opted) {
  if (opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) opted = true;
  return err;
}

template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, KernelInfo* info) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  info->registers = a.numRegs;
  info->local_bytes = static_cast<int>(a.localSizeBytes);
  info->static_smem_bytes = static_cast<int>(a.sharedSizeBytes);
  info->max_threads = a.maxThreadsPerBlock;
  return cudaSuccess;
}

// out, dO, dq, dk, dv: contiguous (B, S, H, D)
void packed_strides(const FlashParams& f, int64_t strides[3]) {
  strides[0] = static_cast<int64_t>(f.seq) * f.heads * kHD;
  strides[1] = static_cast<int64_t>(f.heads) * kHD;
  strides[2] = kHD;
}

}  // namespace

FlashTile flash_bwd_dq_tile() { return {kWGRows, kDqKeys}; }
FlashTile flash_bwd_dkv_tile() { return {kKvQRows, kWGRows}; }

int flash_split_bwd_smem(bool dkv) {
  return static_cast<int>(dkv ? sizeof(KvSmem) : sizeof(DqSmem));
}

cudaError_t flash_attention_bwd_dq_bf16(const FlashBwdParams& p,
                                        cudaStream_t stream) {
  const FlashParams& f = p.f;
  if (f.batch == 0 || f.seq == 0 || f.heads == 0) return cudaSuccess;
  if (f.head_dim != kHD || f.seq % kItemRows != 0)
    return cudaErrorInvalidValue;
  int64_t packed[3];
  packed_strides(f, packed);
  DqMaps maps;
  if (!make_map(&maps.q, f.q, f, f.q_strides, kItemRows) ||
      !make_map(&maps.dout, p.dout, f, packed, kItemRows) ||
      !make_map(&maps.k, f.k, f, f.k_strides, kDqKeys) ||
      !make_map(&maps.v, f.v, f, f.v_strides, kDqKeys) ||
      (f.bias && !make_row_map(&maps.bias, f.bias,
                               CU_TENSOR_MAP_DATA_TYPE_FLOAT32, f.batch,
                               f.seq, kDqKeys)) ||
      (f.seg && !make_row_map(&maps.seg, f.seg, CU_TENSOR_MAP_DATA_TYPE_INT32,
                              f.batch, f.seq, kDqKeys)))
    return cudaErrorInvalidValue;
  const int n_items = f.batch * f.heads * (f.seq / kItemRows);
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  DqKernel kernel = dq_kernel(f.drop.apply, f.seg != nullptr);
  static bool opted[4] = {false, false, false, false};
  const int which = (f.drop.apply ? 2 : 0) + (f.seg != nullptr ? 1 : 0);
  cudaError_t err = opt_in(kernel, flash_split_bwd_smem(false), opted[which]);
  if (err != cudaSuccess) return err;
  const float inv_keep = f.drop.apply ? 1.f / f.drop.keep_div : 1.f;
  kernel<<<std::min(n_items, sms), kThreads, flash_split_bwd_smem(false),
           stream>>>(maps, p, inv_keep, n_items);
  return cudaGetLastError();
}

cudaError_t flash_attention_bwd_dkv_bf16(const FlashBwdParams& p,
                                         cudaStream_t stream) {
  const FlashParams& f = p.f;
  if (f.batch == 0 || f.seq == 0 || f.heads == 0) return cudaSuccess;
  if (f.head_dim != kHD || f.seq % kItemRows != 0)
    return cudaErrorInvalidValue;
  int64_t packed[3];
  packed_strides(f, packed);
  KvMaps maps;
  const int bh_rows = f.batch * f.heads;
  if (!make_map(&maps.k, f.k, f, f.k_strides, kItemRows) ||
      !make_map(&maps.v, f.v, f, f.v_strides, kItemRows) ||
      !make_map(&maps.q, f.q, f, f.q_strides, kKvQRows) ||
      !make_map(&maps.dout, p.dout, f, packed, kKvQRows) ||
      !make_row_map(&maps.lse, f.lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    bh_rows, f.seq, kKvQRows) ||
      !make_row_map(&maps.delta, p.delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    bh_rows, f.seq, kKvQRows) ||
      (f.seg && !make_row_map(&maps.seg, f.seg, CU_TENSOR_MAP_DATA_TYPE_INT32,
                              f.batch, f.seq, kKvQRows)))
    return cudaErrorInvalidValue;
  const int n_items = f.batch * f.heads * (f.seq / kItemRows);
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  KvKernel kernel = kv_kernel(f.drop.apply, f.seg != nullptr);
  static bool opted[4] = {false, false, false, false};
  const int which = (f.drop.apply ? 2 : 0) + (f.seg != nullptr ? 1 : 0);
  cudaError_t err = opt_in(kernel, flash_split_bwd_smem(true), opted[which]);
  if (err != cudaSuccess) return err;
  const float inv_keep = f.drop.apply ? 1.f / f.drop.keep_div : 1.f;
  kernel<<<std::min(n_items, sms), kThreads, flash_split_bwd_smem(true),
           stream>>>(maps, p, inv_keep, n_items);
  return cudaGetLastError();
}

cudaError_t flash_split_bwd_info(bool dkv, bool dropout, bool segments,
                                 KernelInfo* info) {
  return dkv ? kernel_info(kv_kernel(dropout, segments), info)
             : kernel_info(dq_kernel(dropout, segments), info);
}

}  // namespace bert_kernels
