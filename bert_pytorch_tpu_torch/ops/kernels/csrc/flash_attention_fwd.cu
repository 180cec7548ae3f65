// The flash-attention forward for Hopper, bf16 at head dim 64, sequences
// of whole 128-key tiles (every length the flash route takes).
//
// Replaces the Pallas forward kernels of bert_pytorch_tpu/ops/pallas/
// flash_attention.py, `_fwd_kernel_native` (the model's (B, S, H, D)
// layout) and `_fwd_kernel` (the bh layout): one function, softmax(q k^T
// / sqrt(D) + bias) v with an online softmax, the packed-sequence mask
// (attend iff q_seg == k_seg and q_seg > 0, masked scores at -1e30), whole
// tiles skipped when their segment ranges do not meet (`_seg_overlap`),
// outputs of pad (segment-0) rows zeroed, lse = m + log(max(l, 1e-30)) per
// row, and in training dropout with the counter-hash `_keep_mask`: the
// row sum l is of the undropped probabilities, dropped ones are zeroed
// before the PV product, and the output is divided by 1 - rate after l.
// q, k and v are read through their strides, so the serving engine's fused
// (B, S, 3, H, D) QKV view and the bh layout both feed it without a copy.
// The f32 forward stays in flash_attention.cu.
//
// What bounds it: at BERT-Large's phase-2 shape (16, 512, 16, 64) the
// function needs 2 products of 2 S^2 D flops a head, 17.2 GFLOP (17.4 us
// at the H100's dense bf16 rate), against 67.7 MB of q/k/v/out/lse (20.2
// us at 3.35 TB/s), and one exp2 an element of the 67.1 M scores (~18 us
// on the SMs' 16 MUFU lanes each). With dropout the hash adds about seven
// integer operations an element (~40 us of integer issue on 132 x 64
// lanes), more than either bound: the element-wise work has to run under
// the tensor cores, not after them.
//
// The design: a persistent grid of one CTA an SM walks work items of 128
// queries of one (batch, head), 128-query blocks fastest so that CTAs
// working at once share k and v in L2. A CTA has two consumer warpgroups
// (64 queries each) and one producer warp. The producer brings each
// item's q tile by TMA and then its key tiles of 128 keys, k and v,
// through a ring of kStages stages with a full and an empty mbarrier
// each, in the 128-byte swizzle that wgmma reads; the keys' bias and
// segment ids come by TMA into the same stage, so no load of the producer
// waits on memory before the tile's copies are issued. Beside each tile
// it writes the hash's column terms and which warpgroups read the tile:
// with packed segments it forms each key tile's [min non-pad, max]
// segment range once, from ids it loaded a tile ahead, and compares it
// with each warpgroup's range, so the skip keeps 64-query granularity
// with no block reduction on the consumers' path, and a tile neither
// warpgroup reads is not loaded at all. A marker stage ends the item.
//
// A consumer warpgroup computes S = q k^T with wgmma m64n128k16, both
// operands K-major from shared memory, and O += P V with wgmma m64n64k16,
// P packed to bf16 in registers as the A operand and the v tile an
// MN-major B operand. When the next stage holds its next tile, that
// tile's S is issued together with this tile's P V; the warpgroup waits
// for S alone and runs the next tile's softmax - the mask, the hash and
// exp2 - while P V runs on the tensor cores (FlashAttention-3's
// intra-warpgroup overlap), so scores, probabilities and output take 128
// registers a thread, one tile of each. The softmax runs in the log2
// domain: s * scale log2e + bias log2e in one fma, the running max and
// row sum in registers (each thread keeps a partial l of its columns,
// summed across the quad at the end), exp2 by ex2.approx. The hash of
// (query, key, seed_bh) is split into a row term (once per row) and a
// column term (once per key, by the producer), which one xor mixes: the
// first xorshift of `_keep_mask` distributes over xor. The epilogue takes
// one reciprocal a row, writes bf16 out from registers and lse in f32. No
// state sized by the sequence lives on chip.
//
// Every wgmma wait sits at a point the warpgroup always passes, and no
// instruction touches the registers of a wgmma in flight (the one
// wait_group 1 leaves P V in flight while the softmax works on the scores
// only), so ptxas keeps the wgmma pipeline (no C7514/C7518
// serialization).
//
// Shared memory: q of two work items (16 KiB each), kStages x (k, v) (32
// KiB each), the stages' key terms (1,664 B each) and the barriers:
// 170,624 B, one CTA an SM.
#include <algorithm>

#include "common.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"
#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr int kHD = 64;                      // head dim
constexpr int kQB = 128;                     // queries a work item
constexpr int kKB = 128;                     // keys a tile
constexpr int kWGRows = 64;                  // queries a consumer warpgroup
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
// + the producer warpgroup, whose first warp works
constexpr int kFwdThreads = (kConsumerWarps + 4) * 32;
// Registers a thread: 168 at launch (65,536 / 384, rounded down to 8);
// setmaxnreg moves them from the producer warpgroup to the consumers,
// whose scores, probabilities and output need more. 232 / 40 spill
// nowhere; 240 / 24 spills the producer.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 3 * 168 - 2 * kConsumerRegs;  // the balance
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg");
constexpr int kTileBytes = kKB * kHD * 2;    // 16,384
constexpr int kQBytes = kQB * kHD * 2;       // 16,384
constexpr float kNegInf = -1e30f;            // the Pallas kernels' NEG_INF
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kEnd = 4;  // stage flag: no tile, the work item ends
static_assert(kHD == kMapCols, "tensor maps of whole 64-column rows");

// What a stage holds beside its k and v tiles.
struct alignas(128) StageMeta {
  float bias[kKB];      // the keys' bias (TMA; zeros without a bias)
  int seg[kKB];         // their segment ids (TMA with packed segments)
  uint32_t colh[kKB];   // the hash's column term: c ^ (c >> 16), c = key *
                        // 0x85EBCA77
  int flags;            // bit w: warpgroup w reads the tile; kEnd
};

struct Smem {  // the dynamic shared memory, 1024-byte aligned
  unsigned char q[2][kQBytes];  // two work items' q: the next one loads early
  unsigned char k[kStages][kTileBytes];
  unsigned char v[kStages][kTileBytes];
  StageMeta meta[kStages];
  uint64_t full[kStages];   // the producer's two arrivals + the bytes
  uint64_t empty[kStages];  // one arrival a consumer warp
  uint64_t q_full[2];
  uint64_t q_empty[2];      // one arrival a consumer warp
};

// q, k and v in whole 64-column rows; the bias and segment ids (B, S) in
// rows of one tile's keys (each only when present)
struct FwdMaps {
  CUtensorMap q, k, v, bias, seg;
};

// work item -> (batch, head, first query), 128-query blocks fastest
struct Item {
  int b, h, q0;
};

__device__ __forceinline__ Item item_of(int item, int seq, int heads) {
  const int nqb = seq / kQB;
  const int bh = item / nqb;
  return {bh / heads, bh - bh / heads * heads, (item - bh * nqb) * kQB};
}

template <bool kDrop, bool kSeg>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ FwdMaps maps, FlashParams p,
                 float inv_keep, int n_items) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int S = p.seq, H = p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    if ((smem_addr(smem_raw) & 1023) != 0) __trap();  // the swizzle's base
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 2);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer warpgroup hands registers to the consumer warpgroups
  // (setmaxnreg moves them within the CTA: the launch's 168 a thread would
  // spill the consumers and serialize their wgmma pipeline). The two roles
  // run in two branches that never meet again.
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
          // both warpgroups are past the S products of the item two back
          mbar_wait(&sm.q_empty[it & 1], ((it >> 1) & 1) ^ 1);
          mbar_expect(&sm.q_full[it & 1], kQBytes);
          tma_load(sm.q[it & 1], &maps.q, w.h, w.q0, w.b, &sm.q_full[it & 1]);
        }
        const int32_t* seg_row =
            kSeg ? p.seg + static_cast<int64_t>(w.b) * S : nullptr;
        int qmn0 = 0, qmx0 = 0, qmn1 = 0, qmx1 = 0, ks[kKB / 32];
        if constexpr (kSeg) {
          warp_seg_range<2>(seg_row, w.q0, lane, qmn0, qmx0);
          warp_seg_range<2>(seg_row, w.q0 + kWGRows, lane, qmn1, qmx1);
#pragma unroll
          for (int i = 0; i < kKB / 32; ++i) ks[i] = seg_row[32 * i + lane];
        }
        for (int k0 = 0; k0 < S; k0 += kKB) {
          int flags = 3;
          if constexpr (kSeg) {
            // the key tile's segment range from ids loaded a tile ahead
            int hi = 0, lo = kSegBig;
#pragma unroll
            for (int i = 0; i < kKB / 32; ++i) {
              hi = max(hi, ks[i]);
              if (ks[i] > 0) lo = min(lo, ks[i]);
            }
            const int kmx = warp_max(hi), kmn = warp_min(lo);
            if (k0 + kKB < S) {
#pragma unroll
              for (int i = 0; i < kKB / 32; ++i)
                ks[i] = seg_row[k0 + kKB + 32 * i + lane];
            }
            flags = (seg_overlap(qmn0, qmx0, kmn, kmx) ? 1 : 0) |
                    (seg_overlap(qmn1, qmx1, kmn, kmx) ? 2 : 0);
            n_skipped += (flags & 1 ? 0 : 1) + (flags & 2 ? 0 : 1);
            if (flags == 0) continue;  // neither warpgroup reads it
          }
          const int s = pos % kStages;
          mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
          StageMeta& m = sm.meta[s];
          if (lane == 0) {
            // the first arrival: the bytes of every copy into the stage
            mbar_expect(&sm.full[s],
                        2 * kTileBytes + (p.bias ? kKB * 4 : 0) +
                            (kSeg ? kKB * 4 : 0));
            tma_load(sm.k[s], &maps.k, w.h, k0, w.b, &sm.full[s]);
            tma_load(sm.v[s], &maps.v, w.h, k0, w.b, &sm.full[s]);
            if (p.bias) tma_load_row(m.bias, &maps.bias, k0, w.b, &sm.full[s]);
            if (kSeg) tma_load_row(m.seg, &maps.seg, k0, w.b, &sm.full[s]);
          }
#pragma unroll
          for (int i = 0; i < kKB / 32; ++i) {
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
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    // -- the consumer warpgroups --------------------------------------------
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const float scale_l2 = p.scale * kLog2e;
    // keep iff hash >> 9 >= threshold, i.e. hash >= threshold << 9
    const uint32_t keep_min = p.drop.threshold << 9;
    // scores, then the probabilities in f32; the bf16 probabilities (the
    // A operand of O += P V); the output
    float sc[16][4], o[8][4];
    uint32_t pw[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    int pos = 0;

    // Without packed segments both warpgroups issue the same products in
    // the same order, and they take turns issuing them (FlashAttention-3's
    // ping-pong): a warpgroup issues after the other has issued, so one's
    // softmax runs while the other's products hold the tensor cores. Named
    // barrier 1 + w gates warpgroup w; the first turn is warpgroup 0's.
    // (With packed segments the two skip different tiles and run free.)
    auto turn_wait = [&]() {
      if constexpr (!kSeg)
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto turn_pass = [&]() {
      if constexpr (!kSeg)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (!kSeg && wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    // the next stage position's stage, once it has landed
    auto wait_stage = [&]() {
      const int s = pos % kStages;
      mbar_wait(&sm.full[s], (pos / kStages) & 1);
      return s;
    };
    // this warp is done with stage s (its products waited for)
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    };

    for (int it = 0, item = blockIdx.x; item < n_items;
         ++it, item += gridDim.x) {
      const Item w = item_of(item, S, H);
      const int row_a = w.q0 + wg * kWGRows + wq * 16 + g, row_b = row_a + 8;
      int sq_a = 0, sq_b = 0;  // a key matches iff its id equals these
      if constexpr (kSeg) {
        const int32_t* seg_row = p.seg + static_cast<int64_t>(w.b) * S;
        sq_a = seg_row[row_a];
        sq_b = seg_row[row_b];
      }
      // no key has segment -1: pad rows match none
      if (kSeg && sq_a == 0) sq_a = -1;
      if (kSeg && sq_b == 0) sq_b = -1;
      uint32_t rh_a = 0u, rh_b = 0u;  // the hash's row terms
      if constexpr (kDrop) {
        const uint32_t seed_bh = seed_bh_of(p.drop, w.b, H, w.h);
        rh_a = (static_cast<uint32_t>(row_a) * 0x9E3779B1u) ^ seed_bh;
        rh_b = (static_cast<uint32_t>(row_b) * 0x9E3779B1u) ^ seed_bh;
        rh_a ^= rh_a >> 16;
        rh_b ^= rh_b >> 16;
      }
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      float alpha_a = 1.f, alpha_b = 1.f;  // O's rescale before its next P V
#pragma unroll
      for (int d = 0; d < 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
      const unsigned char* q_s = sm.q[it & 1] + wg * kWGRows * 128;

      // S = q k^T of the tile in stage st, issued and committed
      auto issue_s = [&](int st) {
        reg_fence(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_ss(sc, gmma_desc(q_s + kk * 32),
                              gmma_desc(sm.k[st] + kk * 32), kk > 0);
        wgmma_commit();
      };
      // O = alpha O + P V of the tile in stage st, issued and committed
      auto issue_pv = [&](int st) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          o[d][0] *= alpha_a;
          o[d][1] *= alpha_a;
          o[d][2] *= alpha_b;
          o[d][3] *= alpha_b;
        }
        reg_fence(pw);
        reg_fence(o);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kKB / 16; ++kc) {
          const uint32_t a[4] = {pw[2 * kc][0], pw[2 * kc][1],
                                 pw[2 * kc + 1][0], pw[2 * kc + 1][1]};
          wgmma_m64n64k16(o, a, gmma_desc(sm.v[st] + 16 * kc * 128));
        }
        wgmma_commit();
      };
      // the softmax of the scores in sc (tile in stage st): the running max
      // and row sums, alpha for O, and the probabilities, dropped ones
      // zeroed, left in sc
      auto softmax = [&](int st) {
        const StageMeta& mt = sm.meta[st];
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 bk = *reinterpret_cast<const float2*>(&mt.bias[col]);
          const float b0 = bk.x * kLog2e, b1 = bk.y * kLog2e;
          float v0 = fmaf(sc[j][0], scale_l2, b0);
          float v1 = fmaf(sc[j][1], scale_l2, b1);
          float v2 = fmaf(sc[j][2], scale_l2, b0);
          float v3 = fmaf(sc[j][3], scale_l2, b1);
          if constexpr (kSeg) {
            const int2 sk = *reinterpret_cast<const int2*>(&mt.seg[col]);
            v0 = sk.x == sq_a ? v0 : kNegInf;
            v1 = sk.y == sq_a ? v1 : kNegInf;
            v2 = sk.x == sq_b ? v2 : kNegInf;
            v3 = sk.y == sq_b ? v3 : kNegInf;
          }
          sc[j][0] = v0;
          sc[j][1] = v1;
          sc[j][2] = v2;
          sc[j][3] = v3;
          mx_a = fmaxf(mx_a, fmaxf(v0, v1));
          mx_b = fmaxf(mx_b, fmaxf(v2, v3));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        alpha_a = fast_exp2(m_a - mx_a);
        alpha_b = fast_exp2(m_b - mx_b);
        m_a = mx_a;
        m_b = mx_b;
        l_a *= alpha_a;
        l_b *= alpha_b;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float p0 = fast_exp2(sc[j][0] - m_a);
          float p1 = fast_exp2(sc[j][1] - m_a);
          float p2 = fast_exp2(sc[j][2] - m_b);
          float p3 = fast_exp2(sc[j][3] - m_b);
          l_a += p0;  // the undropped sum
          l_a += p1;
          l_b += p2;
          l_b += p3;
          if constexpr (kDrop) {
            const uint2 ch =
                *reinterpret_cast<const uint2*>(&mt.colh[8 * j + 2 * t]);
            p0 = keep_mix(rh_a ^ ch.x) >= keep_min ? p0 : 0.f;
            p1 = keep_mix(rh_a ^ ch.y) >= keep_min ? p1 : 0.f;
            p2 = keep_mix(rh_b ^ ch.x) >= keep_min ? p2 : 0.f;
            p3 = keep_mix(rh_b ^ ch.y) >= keep_min ? p3 : 0.f;
          }
          sc[j][0] = p0;
          sc[j][1] = p1;
          sc[j][2] = p2;
          sc[j][3] = p3;
        }
      };
      // the probabilities to bf16 pairs, the A operand's layout
      auto pack = [&]() {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          pw[j][0] = pack_bf16(sc[j][0], sc[j][1]);
          pw[j][1] = pack_bf16(sc[j][2], sc[j][3]);
        }
      };
      // this warp's S products of the item are done: the producer may load
      // the next item's q
      auto release_q = [&]() {
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.q_empty[it & 1]);
      };
      // the first tile of this warpgroup at or after `pos`: its S issued
      // and waited for, the stages it skips released; false at the item's
      // end
      auto first_from = [&](int& cur) {
        for (;;) {
          const int st = wait_stage();
          const int f = sm.meta[st].flags;
          ++pos;
          if (f & (1 << wg)) {
            turn_wait();
            issue_s(st);
            turn_pass();
            wgmma_wait_all();
            reg_fence(sc);
            cur = st;
            return true;
          }
          release(st);
          if (f & kEnd) return false;
        }
      };

      // Each tile: its softmax runs while the last tile's O += P V runs on
      // the tensor cores, and its S was issued with that product. Only the
      // next stage is looked at before this tile's stage is released, so a
      // warpgroup holds at most two stages and the ring cannot stall on a
      // run of skipped tiles.
      mbar_wait(&sm.q_full[it & 1], (it >> 1) & 1);
      int cur = 0;
      if (first_from(cur)) {
        softmax(cur);
        pack();
        for (;;) {
          const int sn = wait_stage();
          const int f = sm.meta[sn].flags;
          if (f & (1 << wg)) {
            ++pos;
            turn_wait();
            issue_s(sn);
            issue_pv(cur);
            turn_pass();
            wgmma_wait_one();  // S; P V stays in flight
            reg_fence(sc);
            softmax(sn);
            wgmma_wait_all();
            reg_fence(o);
            release(cur);
            cur = sn;
            pack();
            continue;
          }
          // no S follows at the item's end: the next item's q may load
          // under this tile's product
          if (f & kEnd) release_q();
          turn_wait();
          issue_pv(cur);
          turn_pass();
          wgmma_wait_all();
          reg_fence(o);
          release(cur);
          if (!first_from(cur)) {
            if (!(f & kEnd)) release_q();
            break;
          }
          softmax(cur);
          pack();
        }
      } else {
        release_q();
      }

      // epilogue: the row sums across the quad, one reciprocal a row
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float ls_a = fmaxf(l_a, 1e-30f), ls_b = fmaxf(l_b, 1e-30f);
      float inv_a = 1.f / ls_a, inv_b = 1.f / ls_b;
      if constexpr (kDrop) {
        inv_a *= inv_keep;
        inv_b *= inv_keep;
      }
      uint16_t* out = static_cast<uint16_t*>(p.out) +
                      (static_cast<int64_t>(w.b) * S * H + w.h) * kHD;
      const int64_t row_stride = static_cast<int64_t>(H) * kHD;
      const bool pad_a = kSeg && sq_a < 0, pad_b = kSeg && sq_b < 0;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int c = d * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(out + row_a * row_stride + c) =
            pad_a ? 0u : pack_bf16(o[d][0] * inv_a, o[d][1] * inv_a);
        *reinterpret_cast<uint32_t*>(out + row_b * row_stride + c) =
            pad_b ? 0u : pack_bf16(o[d][2] * inv_b, o[d][3] * inv_b);
      }
      if (t == 0) {
        // m is in log2 units; a row that saw only masked scores keeps -1e30
        float* lse = p.lse + (static_cast<int64_t>(w.b) * H + w.h) * S;
        lse[row_a] = (m_a == kNegInf ? kNegInf : m_a * kLn2) + logf(ls_a);
        lse[row_b] = (m_b == kNegInf ? kNegInf : m_b * kLn2) + logf(ls_b);
      }
    }
  }
}

using FwdKernel = void (*)(const FwdMaps, FlashParams, float, int);

FwdKernel fwd_kernel(bool drop, bool seg) {
  if (drop)
    return seg ? flash_fwd_kernel<true, true> : flash_fwd_kernel<true, false>;
  return seg ? flash_fwd_kernel<false, true> : flash_fwd_kernel<false, false>;
}

}  // namespace

int flash_fwd_smem() { return static_cast<int>(sizeof(Smem)); }

FlashTile flash_fwd_tile() { return {kWGRows, kKB}; }

cudaError_t flash_attention_fwd_bf16(const FlashParams& f,
                                     cudaStream_t stream) {
  if (f.batch == 0 || f.seq == 0 || f.heads == 0) return cudaSuccess;
  if (f.head_dim != kHD || f.seq % kKB != 0) return cudaErrorInvalidValue;
  FwdMaps maps;
  if (!make_map(&maps.q, f.q, f, f.q_strides, kQB) ||
      !make_map(&maps.k, f.k, f, f.k_strides, kKB) ||
      !make_map(&maps.v, f.v, f, f.v_strides, kKB) ||
      (f.bias && !make_row_map(&maps.bias, f.bias,
                               CU_TENSOR_MAP_DATA_TYPE_FLOAT32, f.batch,
                               f.seq, kKB)) ||
      (f.seg && !make_row_map(&maps.seg, f.seg, CU_TENSOR_MAP_DATA_TYPE_INT32,
                              f.batch, f.seq, kKB)))
    return cudaErrorInvalidValue;
  const int n_items = f.batch * f.heads * (f.seq / kQB);
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  FwdKernel kernel = fwd_kernel(f.drop.apply, f.seg != nullptr);
  // above 48 KiB of dynamic shared memory a kernel has to opt in, once
  static bool opted[4] = {false, false, false, false};
  const int which = (f.drop.apply ? 2 : 0) + (f.seg != nullptr ? 1 : 0);
  if (!opted[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, flash_fwd_smem());
    if (err != cudaSuccess) return err;
    opted[which] = true;
  }
  const float inv_keep = f.drop.apply ? 1.f / f.drop.keep_div : 1.f;
  kernel<<<std::min(n_items, sms), kFwdThreads, flash_fwd_smem(), stream>>>(
      maps, f, inv_keep, n_items);
  return cudaGetLastError();
}

cudaError_t flash_fwd_info(bool dropout, bool segments, KernelInfo* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fwd_kernel(dropout, segments));
  if (err != cudaSuccess) return err;
  info->registers = a.numRegs;
  info->local_bytes = static_cast<int>(a.localSizeBytes);
  info->static_smem_bytes = static_cast<int>(a.sharedSizeBytes);
  info->max_threads = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace bert_kernels
