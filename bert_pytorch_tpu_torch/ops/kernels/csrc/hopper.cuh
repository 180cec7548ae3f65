// Hopper building blocks the flash kernels share (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_split_bwd.cu): shared-memory
// addresses, ldmatrix, the 128-byte swizzle, wgmma descriptors, the wgmma
// instructions and their fences, mbarriers, TMA loads, ex2, and the host
// side: the card's SM count and TMA tensor maps (of a bf16 (B, S, H, 64)
// tensor read through its strides, and of rows of 4-byte elements).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace bert_kernels {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices out of shared memory: lane i names row i % 8 of
// matrix i / 8; r[m] receives matrix m, lane 4g + t holding its row g,
// columns 2t and 2t + 1 (the A fragment layout of m16n8k16 and of wgmma's
// register A operand).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// Every bf16 tile of 64 columns (128 bytes a row) lies in the 128-byte
// swizzle of TMA and wgmma: rows one after another, the 16-byte chunk c of
// row r at chunk c ^ (r % 8) of its row, tiles 1024-byte aligned. A TMA
// box of whole rows writes it; every 8 x 8 matrix an ldmatrix reads, and
// every 8-row column of ds^T the staging writes, spreads over all banks.
// Byte offset of (row, chunk):
__device__ __forceinline__ int sw(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, the stride between 8-row groups (1024 bytes), swizzle mode 1.
// K-major operands step through K by advancing the start 32 bytes a
// k16 slice inside the swizzled row; MN-major ones hold 64 columns, one
// swizzle atom, so the other stride is unused.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for every wgmma group this warpgroup committed. (A wait_group
// above 0 makes ptxas serialize every wgmma of the kernel.)
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits for every wgmma group but the most recent. ptxas keeps the
// pipeline only where no instruction touches the registers of the group
// left in flight before a wgmma_wait_all.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy that wgmma reads through and TMA writes through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accesses to wgmma operands across the
// fences and waits
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&w)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) asm volatile("" : "+r"(w[i][e])::"memory");
}

// d (64 x 32, this warp's 16 rows) += a (64 x 16 from registers, the
// m16n8k16 A layout a warp) b (16 x 32, K-major, by descriptor). The
// accumulator layout a warp is m16n8k16's, one [4] per 8 columns.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128) = (scale_d ? d : 0) + a (64 x 16) b (16 x 128), both
// K-major by descriptor; the accumulator is sixteen [4] of 8 columns
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[16][4],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same at 64 x 64, b MN-major
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64) = (scale_d ? d : 0) + a (64 x 16) b (16 x 64), both
// K-major by descriptor; the accumulator is eight [4] of 8 columns
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32) = (scale_d ? d : 0) + a (64 x 16) b (16 x 32), both
// MN-major by descriptor
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[4][4],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// -- TMA and mbarriers -------------------------------------------------------

// a barrier whose phases complete after `count` arrivals (and the bytes
// announced by mbar_expect)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival, announcing no bytes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the one arrival of a phase, announcing the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of `parity` to complete. A copy that never lands
// traps (the launch fails) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// one box of `map` (rows row.. of one (batch, head), as many as the box
// holds) into a swizzled tile, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int head, int row, int batch,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(head), "r"(row),
      "r"(batch), "r"(smem_addr(bar))
      : "memory");
}

// 2^x, one MUFU instruction (flushes results below 2^-126 to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// `box` consecutive 4-byte elements of row `row` of a (rows, cols) map
// into shared memory (128-byte aligned), completing on `bar`
__device__ __forceinline__ void tma_load_row(void* dst, const CUtensorMap* map,
                                             int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// -- host: tensor maps --------------------------------------------------------

// SMs of the current card, read once per device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

constexpr int kMapCols = 64;  // head dim: one 128-byte swizzle atom a row

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  }
  return fn;
}

// A bf16 (B, S, H, 64) tensor with element strides `strides` (batch, seq,
// head) as a 4-d map (head-dim column, head, row, batch) whose box is
// `box_rows` whole rows, written 128-byte swizzled.
bool make_map(CUtensorMap* map, const void* base, const FlashParams& f,
              const int64_t strides[3], int box_rows) {
  const auto fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(kMapCols),
                        static_cast<cuuint64_t>(f.heads),
                        static_cast<cuuint64_t>(f.seq),
                        static_cast<cuuint64_t>(f.batch)};
  cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                         static_cast<cuuint64_t>(strides[1]) * 2,
                         static_cast<cuuint64_t>(strides[0]) * 2};
  cuuint32_t box[4] = {kMapCols, 1, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, bytes, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous (rows, cols) tensor of 4-byte elements (f32 or int32) as a
// 2-d map whose box is `box` consecutive elements of one row.
bool make_row_map(CUtensorMap* map, const void* base,
                  CUtensorMapDataType type, int rows, int cols, int box) {
  const auto fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t bytes[1] = {static_cast<cuuint64_t>(cols) * 4};
  cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), 1};
  cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, bytes, boxes, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace bert_kernels
