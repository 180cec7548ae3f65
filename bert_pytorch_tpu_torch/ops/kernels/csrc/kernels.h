// Host launchers of the port's hand-written Hopper kernels.
//
// The .cu files include no PyTorch header: they take raw device pointers,
// sizes and a stream, launch, and return cudaGetLastError(). binding.cpp is
// the one file that includes PyTorch's headers; it checks and allocates the
// tensors, calls these launchers and raises on a non-zero status.
#pragma once

#include <cstdint>
#include <cuda_runtime_api.h>

namespace bert_kernels {

// element type of an activation tensor
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// y = LN(x) over the last axis of a contiguous (rows, cols) x; scale and
// bias are (cols,) f32. Writes y in x's dtype and f32 mean / rstd (rows,).
cudaError_t layer_norm_fwd(const void* x, const float* scale,
                           const float* bias, void* y, float* mean,
                           float* rstd, int64_t rows, int cols, float eps,
                           DType dtype, cudaStream_t stream);

// The dropout arm of the fused residual-dropout-LayerNorm: keep an element
// iff row_col_keep's hash of (flat row, column) exceeds `threshold`
// (rate * 2^32); `seed_term` is uint32(seed) * 0xC2B2AE3D; kept values are
// divided by `keep_div` = f32(1 - rate). `apply` false: no dropout (rate 0).
struct DropoutArgs {
  uint32_t seed_term = 0;
  uint32_t threshold = 0;
  float keep_div = 1.f;
  bool apply = false;
};

// h = f32(residual) + dropout(f32(x)), y = LN(h): x and residual are
// contiguous (rows, cols) tensors of one dtype, the rest as layer_norm_fwd.
cudaError_t adln_fwd(const void* x, const void* residual, const float* scale,
                     const float* bias, void* y, float* mean, float* rstd,
                     int64_t rows, int cols, float eps, DType dtype,
                     const DropoutArgs& dropout, cudaStream_t stream);

// Backward of layer_norm_fwd (residual, dres null) and of adln_fwd. x,
// residual, g, dx and dres are contiguous (rows, cols) tensors of one
// dtype; scale (cols,), mean and rstd (rows,) f32; dscale and dbias (cols,)
// f32 outputs; `partial` is f32 scratch of 2 * bwd_ctas(p, dtype) * cols.
struct BwdParams {
  const void* x;
  const void* residual;
  const float* scale;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  void* dres;
  float* dscale;
  float* dbias;
  float* partial;
  int64_t rows;
  int cols;
};

cudaError_t layer_norm_bwd(const BwdParams& p, DType dtype,
                           cudaStream_t stream);
cudaError_t adln_bwd(const BwdParams& p, DType dtype,
                     const DropoutArgs& dropout, cudaStream_t stream);
// CTAs of the row pass of a backward launch with these parameters (its
// route: bf16 at width 1024, aligned, or the generic kernel), a function
// of the shape and the route alone; and the widest row it takes
int bwd_ctas(const BwdParams& p, DType dtype);
int max_bwd_cols();

// The flash kernels' dropout (`_keep_mask` of the Pallas kernels): keep a
// probability iff the top 23 bits of the hash of (query, key, seed + bh *
// 0xC2B2AE3D), bh = batch * heads + head, are >= `threshold` (int(rate *
// 2^23)); `seed` is the int32 seed's bits; kept values are scaled by
// dividing by `keep_div` = f32(1 - rate). `apply` false: no dropout.
struct FlashDropout {
  uint32_t seed = 0;
  uint32_t threshold = 0;
  float keep_div = 1.f;
  bool apply = false;
};

// A (query rows, keys) tile of a flash kernel.
struct FlashTile {
  int rows;
  int keys;
};

// Strides are in elements; q/k/v share (B, S, H, D) with a unit last-axis
// stride. out is a contiguous (B, S, H, D) tensor, lse a contiguous
// (B, H, S) f32 tensor. bias (B, S) f32 and seg (B, S) int32 may be null;
// skipped (one int32) may be null, else it gains the number of
// (q-tile, k-tile) pairs whose segment ranges do not meet.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const int32_t* seg;
  void* out;
  float* lse;
  int32_t* skipped;
  int64_t q_strides[3];  // batch, seq, head
  int64_t k_strides[3];
  int64_t v_strides[3];
  int batch, seq, heads, head_dim;
  float scale;
  FlashDropout drop;
};

// The forward: bf16 runs flash_attention_fwd_bf16, f32 the f32 kernel of
// flash_attention.cu.
cudaError_t flash_attention_fwd(const FlashParams& p, DType dtype,
                                cudaStream_t stream);

// The bf16 forward (flash_attention_fwd.cu), head_dim 64: sequences of
// whole flash_fwd_tile().keys-key tiles, others refused with
// cudaErrorInvalidValue. Its (query rows, keys) tile is the grain of its
// segment tile skip; flash_fwd_smem() is the dynamic shared memory of a
// launch.
cudaError_t flash_attention_fwd_bf16(const FlashParams& p,
                                     cudaStream_t stream);
FlashTile flash_fwd_tile();
int flash_fwd_smem();

// The backward pair. q/k/v, bias, seg, skipped and the dropout as in
// FlashParams; out (the forward's output), dout, dq, dk and dv contiguous
// (B, S, H, D) of q's dtype; lse and delta contiguous (B, H, S) f32.
// flash_attention_bwd_dq reads out and writes delta = rowsum(dout * out)
// and dq; flash_attention_bwd_dkv reads that delta and writes dk and dv,
// so it runs after the dq launch on the same stream.
struct FlashBwdParams {
  FlashParams f;  // f.out is the forward output, f.lse its lse
  const void* dout;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
};

cudaError_t flash_attention_bwd_dq(const FlashBwdParams& p, DType dtype,
                                   cudaStream_t stream);
cudaError_t flash_attention_bwd_dkv(const FlashBwdParams& p, DType dtype,
                                    cudaStream_t stream);

// The bf16 pair (flash_attention_split_bwd.cu), head_dim 64: sequences of
// whole 128-row tiles, others refused with cudaErrorInvalidValue. Their
// (query rows, keys) tiles are the grain of their segment tile skip;
// flash_split_bwd_smem(dkv) is the dynamic shared memory of a launch of
// the dq (false) or the dk/dv (true) kernel.
cudaError_t flash_attention_bwd_dq_bf16(const FlashBwdParams& p,
                                        cudaStream_t stream);
cudaError_t flash_attention_bwd_dkv_bf16(const FlashBwdParams& p,
                                         cudaStream_t stream);
FlashTile flash_bwd_dq_tile();
FlashTile flash_bwd_dkv_tile();
int flash_split_bwd_smem(bool dkv);

// The (query rows, keys) tile of the forward, dq and dk/dv kernels for a
// dtype, in that order: the grain of their segment tile skip.
void flash_tiles(DType dtype, FlashTile tiles[3]);

// The fused backward (flash_attention_bwd.cu), bf16 with head_dim 64: one
// launch writes dq, dk and dv from q/k/v, bias, seg, skipped and the
// dropout as in FlashParams, out, lse and dout (p.delta is unused: delta
// is formed in shared memory). It takes sequences of whole tiles (a
// multiple of flash_bwd_fused_tile().keys) up to flash_bwd_fused_max_seq()
// and refuses others with cudaErrorInvalidValue. Its (query rows, keys)
// tile is the grain of its segment tile skip; flash_bwd_fused_smem(seq) is
// the dynamic shared memory of one launch.
cudaError_t flash_attention_bwd_fused(const FlashBwdParams& p,
                                      cudaStream_t stream);
int flash_bwd_fused_smem(int seq);
int flash_bwd_fused_max_seq();
FlashTile flash_bwd_fused_tile();

// What the compiler gave a kernel: registers a thread, local memory
// (spills) bytes a thread, static shared memory bytes, threads a block.
struct KernelInfo {
  int registers;
  int local_bytes;
  int static_smem_bytes;
  int max_threads;
};
cudaError_t flash_bwd_fused_info(bool dropout, KernelInfo* info);
// the bf16 forward's arms: with or without dropout, packed segments
cudaError_t flash_fwd_info(bool dropout, bool segments, KernelInfo* info);
// the bf16 pair's arms: the dq (dkv false) or dk/dv kernel, with or
// without dropout, packed segments
cudaError_t flash_split_bwd_info(bool dkv, bool dropout, bool segments,
                                 KernelInfo* info);

// Fused multi-tensor LAMB (fused_optim.cu). The host passes device copies
// of a per-tensor table and a chunk table; one CTA takes the elements
// [start, min(start + chunk_size, n)) of its chunk's tensor. `vec` is 1
// when every pointer of the tensor allows 16-byte vector access (8-byte
// for a bf16 gradient); chunk starts are multiples of 4.
struct LambChunk {
  int64_t tensor;
  int64_t start;
};

// g (f32 or bf16, one dtype per call) is read; mu and nu (f32) updated in
// place; p (f32) read; u (f32) written. All contiguous with n elements.
struct LambStage1Tensor {
  const void* g;
  float* mu;
  float* nu;
  const float* p;
  float* u;
  int64_t n;
  float wd;
  int32_t vec;
};

// The f32 values of the reference's Python-float multipliers.
struct LambStage1Scalars {
  float b1, one_minus_b1, b2, one_minus_b2, eps, c1, c2;
};

// denom is one f32 on the card.
cudaError_t lamb_stage1(const LambStage1Tensor* tensors,
                        const LambChunk* chunks, int64_t n_chunks,
                        int chunk_size, const float* denom,
                        const LambStage1Scalars& s, DType g_dtype,
                        cudaStream_t stream);

// out = t[tensor] * u, or with `apply` out += t[tensor] * u (out is then
// the f32 master p); u and out f32, contiguous, n elements; t one f32 per
// tensor on the card.
struct LambStage2Tensor {
  const float* u;
  float* out;
  int64_t n;
  int32_t vec;
  int32_t unused;
};

cudaError_t lamb_stage2(const LambStage2Tensor* tensors,
                        const LambChunk* chunks, int64_t n_chunks,
                        int chunk_size, const float* t, bool apply,
                        cudaStream_t stream);

}  // namespace bert_kernels
