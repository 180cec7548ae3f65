// PyTorch binding of the port's kernels: the only source that includes
// PyTorch's headers, and only the tensor, pybind and CUDA-stream ones (not
// torch/extension.h, whose C++-frontend headers would lengthen every
// build). Each function checks its tensors, allocates outputs with
// at::empty, launches on the current stream and raises if the launch
// failed.
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/utils/pybind.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <utility>
#include <vector>

#include "kernels.h"

namespace {

bert_kernels::DType activation_dtype(const at::Tensor& t, const char* name) {
  if (t.scalar_type() == at::kFloat) return bert_kernels::kFloat32;
  if (t.scalar_type() == at::kBFloat16) return bert_kernels::kBFloat16;
  TORCH_CHECK(false, name, " must be float32 or bfloat16, got ", t.scalar_type());
}

void check_cuda(const at::Tensor& t, const at::Tensor& ref, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == ref.device(), name, " is on ", t.device(),
              ", expected ", ref.device());
}

void check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, " launch failed: ", cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// x-shaped activation `t` of x's dtype, contiguous, on x's card
void check_like(const at::Tensor& t, const at::Tensor& x, const char* name) {
  check_cuda(t, x, name);
  TORCH_CHECK(t.scalar_type() == x.scalar_type(), name, " must be ",
              x.scalar_type(), ", got ", t.scalar_type());
  TORCH_CHECK(t.sizes() == x.sizes(), name, " must have x's shape");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_vector(const at::Tensor& t, const at::Tensor& x, int64_t n,
                  const char* name) {
  check_cuda(t, x, name);
  TORCH_CHECK(t.scalar_type() == at::kFloat && t.is_contiguous() &&
                  t.dim() == 1 && t.size(0) == n,
              name, " must be a contiguous float32 (", n, ",) tensor");
}

bert_kernels::DropoutArgs dropout_args(int64_t seed, int64_t threshold,
                                       double keep_div, bool apply) {
  TORCH_CHECK(seed >= INT32_MIN && seed <= INT32_MAX, "seed must be an int32");
  TORCH_CHECK(threshold >= 0 && threshold <= UINT32_MAX,
              "threshold must be a uint32");
  bert_kernels::DropoutArgs d;
  d.seed_term = static_cast<uint32_t>(static_cast<int32_t>(seed)) * 0xC2B2AE3Du;
  d.threshold = static_cast<uint32_t>(threshold);
  d.keep_div = static_cast<float>(keep_div);
  d.apply = apply;
  return d;
}

// y, mean, rstd of LN(h); h = x (residual undefined) or
// f32(residual) + dropout(f32(x))
std::vector<at::Tensor> ln_fwd_common(const at::Tensor& x,
                                      const at::Tensor* residual,
                                      const at::Tensor& scale,
                                      const at::Tensor& bias, double eps,
                                      const bert_kernels::DropoutArgs& d,
                                      const char* what) {
  check_cuda(x, x, "x");
  const auto dtype = activation_dtype(x, "x");
  TORCH_CHECK(x.dim() >= 1 && x.numel() > 0, "x must be non-empty");
  TORCH_CHECK(x.is_contiguous(), "x must be contiguous");
  const int64_t cols = x.size(-1);
  TORCH_CHECK(cols <= 12288, what, " supports widths up to 12288, got ", cols);
  check_vector(scale, x, cols, "scale");
  check_vector(bias, x, cols, "bias");
  if (residual != nullptr) check_like(*residual, x, "residual");
  const int64_t rows = x.numel() / cols;
  const c10::cuda::CUDAGuard guard(x.device());
  auto y = at::empty_like(x);
  auto stats = x.options().dtype(at::kFloat);
  auto mean = at::empty({rows}, stats);
  auto rstd = at::empty({rows}, stats);
  const auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (residual == nullptr) {
    err = bert_kernels::layer_norm_fwd(
        x.data_ptr(), scale.data_ptr<float>(), bias.data_ptr<float>(),
        y.data_ptr(), mean.data_ptr<float>(), rstd.data_ptr<float>(), rows,
        static_cast<int>(cols), static_cast<float>(eps), dtype, stream);
  } else {
    err = bert_kernels::adln_fwd(
        x.data_ptr(), residual->data_ptr(), scale.data_ptr<float>(),
        bias.data_ptr<float>(), y.data_ptr(), mean.data_ptr<float>(),
        rstd.data_ptr<float>(), rows, static_cast<int>(cols),
        static_cast<float>(eps), dtype, d, stream);
  }
  check_launch(err, what);
  return {y, mean, rstd};
}

std::vector<at::Tensor> layer_norm_fwd(const at::Tensor& x,
                                       const at::Tensor& scale,
                                       const at::Tensor& bias, double eps) {
  return ln_fwd_common(x, nullptr, scale, bias, eps,
                       bert_kernels::DropoutArgs{}, "layer_norm_fwd");
}

std::vector<at::Tensor> add_dropout_layer_norm_fwd(
    const at::Tensor& x, const at::Tensor& residual, const at::Tensor& scale,
    const at::Tensor& bias, int64_t seed, int64_t threshold, double keep_div,
    bool apply, double eps) {
  return ln_fwd_common(x, &residual, scale, bias, eps,
                       dropout_args(seed, threshold, keep_div, apply),
                       "add_dropout_layer_norm_fwd");
}

// dx, [dres,] dscale, dbias (dscale and dbias f32)
std::vector<at::Tensor> ln_bwd_common(const at::Tensor& x,
                                      const at::Tensor* residual,
                                      const at::Tensor& scale,
                                      const at::Tensor& mean,
                                      const at::Tensor& rstd,
                                      const at::Tensor& g,
                                      const bert_kernels::DropoutArgs& d,
                                      const char* what) {
  check_cuda(x, x, "x");
  const auto dtype = activation_dtype(x, "x");
  TORCH_CHECK(x.dim() >= 1 && x.numel() > 0, "x must be non-empty");
  TORCH_CHECK(x.is_contiguous(), "x must be contiguous");
  const int64_t cols = x.size(-1);
  TORCH_CHECK(cols <= bert_kernels::max_bwd_cols(), what,
              " supports widths up to ", bert_kernels::max_bwd_cols(),
              ", got ", cols);
  const int64_t rows = x.numel() / cols;
  check_vector(scale, x, cols, "scale");
  check_vector(mean, x, rows, "mean");
  check_vector(rstd, x, rows, "rstd");
  check_like(g, x, "g");
  if (residual != nullptr) check_like(*residual, x, "residual");
  const c10::cuda::CUDAGuard guard(x.device());
  auto dx = at::empty_like(x);
  at::Tensor dres;
  if (residual != nullptr) dres = at::empty_like(x);
  auto f32 = x.options().dtype(at::kFloat);
  auto dscale = at::empty({cols}, f32);
  auto dbias = at::empty({cols}, f32);
  bert_kernels::BwdParams p{};
  p.x = x.data_ptr();
  p.residual = residual != nullptr ? residual->data_ptr() : nullptr;
  p.scale = scale.data_ptr<float>();
  p.mean = mean.data_ptr<float>();
  p.rstd = rstd.data_ptr<float>();
  p.g = g.data_ptr();
  p.dx = dx.data_ptr();
  p.dres = residual != nullptr ? dres.data_ptr() : nullptr;
  p.dscale = dscale.data_ptr<float>();
  p.dbias = dbias.data_ptr<float>();
  p.rows = rows;
  p.cols = static_cast<int>(cols);
  auto partial = at::empty({2 * bert_kernels::bwd_ctas(p, dtype) * cols}, f32);
  p.partial = partial.data_ptr<float>();
  const auto stream = c10::cuda::getCurrentCUDAStream().stream();
  if (residual == nullptr) {
    check_launch(bert_kernels::layer_norm_bwd(p, dtype, stream), what);
    return {dx, dscale, dbias};
  }
  check_launch(bert_kernels::adln_bwd(p, dtype, d, stream), what);
  return {dx, dres, dscale, dbias};
}

std::vector<at::Tensor> layer_norm_bwd(const at::Tensor& x,
                                       const at::Tensor& scale,
                                       const at::Tensor& mean,
                                       const at::Tensor& rstd,
                                       const at::Tensor& g) {
  return ln_bwd_common(x, nullptr, scale, mean, rstd, g,
                       bert_kernels::DropoutArgs{}, "layer_norm_bwd");
}

std::vector<at::Tensor> add_dropout_layer_norm_bwd(
    const at::Tensor& x, const at::Tensor& residual, const at::Tensor& scale,
    const at::Tensor& mean, const at::Tensor& rstd, const at::Tensor& g,
    int64_t seed, int64_t threshold, double keep_div, bool apply) {
  return ln_bwd_common(x, &residual, scale, mean, rstd, g,
                       dropout_args(seed, threshold, keep_div, apply),
                       "add_dropout_layer_norm_bwd");
}

bert_kernels::FlashDropout flash_dropout(int64_t seed, int64_t threshold,
                                         double keep_div, bool apply) {
  TORCH_CHECK(seed >= INT32_MIN && seed <= INT32_MAX, "seed must be an int32");
  TORCH_CHECK(threshold >= 0 && threshold < (1 << 23),
              "threshold must be below 2^23");
  bert_kernels::FlashDropout d;
  d.seed = static_cast<uint32_t>(static_cast<int32_t>(seed));
  d.threshold = static_cast<uint32_t>(threshold);
  d.keep_div = static_cast<float>(keep_div);
  d.apply = apply;
  return d;
}

// Checks q/k/v, the bias, segment ids and skip counter of a flash launch
// and fills the parameters they give.
bert_kernels::FlashParams flash_params(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const c10::optional<at::Tensor>& bias,
    const c10::optional<at::Tensor>& segment_ids,
    const c10::optional<at::Tensor>& skipped, double scale,
    const bert_kernels::FlashDropout& drop, const char* what) {
  check_cuda(q, q, "q");
  check_cuda(k, q, "k");
  check_cuda(v, q, "v");
  const auto dtype = activation_dtype(q, "q");
  TORCH_CHECK(k.scalar_type() == q.scalar_type() && v.scalar_type() == q.scalar_type(),
              "q, k and v must share a dtype");
  TORCH_CHECK(q.dim() == 4, "q must be (B, S, H, D)");
  TORCH_CHECK(k.sizes() == q.sizes() && v.sizes() == q.sizes(),
              "q, k and v must share one (B, S, H, D) shape");
  const int64_t B = q.size(0), S = q.size(1), H = q.size(2), D = q.size(3);
  TORCH_CHECK(D == 64, what, " supports head_dim 64, got ", D);
  // 16-byte row accesses: unit last stride, other strides whole vectors
  const int64_t vec = dtype == bert_kernels::kBFloat16 ? 8 : 4;
  for (const auto* t : {&q, &k, &v}) {
    TORCH_CHECK(t->stride(3) == 1, "q, k and v need a unit head_dim stride");
    TORCH_CHECK(t->stride(0) % vec == 0 && t->stride(1) % vec == 0 &&
                    t->stride(2) % vec == 0,
                "q, k and v strides must be multiples of ", vec, " elements");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "q, k and v must be 16-byte aligned");
  }
  bert_kernels::FlashParams p{};
  if (bias.has_value()) {
    const auto& bt = *bias;
    check_cuda(bt, q, "bias");
    TORCH_CHECK(bt.scalar_type() == at::kFloat && bt.is_contiguous() &&
                    bt.numel() == B * S,
                "bias must be a contiguous float32 (B, 1, 1, S) tensor");
    p.bias = bt.data_ptr<float>();
  }
  if (segment_ids.has_value()) {
    const auto& st = *segment_ids;
    check_cuda(st, q, "segment_ids");
    TORCH_CHECK(st.scalar_type() == at::kInt && st.is_contiguous() &&
                    st.dim() == 2 && st.size(0) == B && st.size(1) == S,
                "segment_ids must be a contiguous int32 (B, S) tensor");
    p.seg = st.data_ptr<int32_t>();
  }
  if (skipped.has_value()) {
    const auto& ct = *skipped;
    check_cuda(ct, q, "skipped");
    TORCH_CHECK(ct.scalar_type() == at::kInt && ct.numel() == 1,
                "skipped must be one int32");
    p.skipped = ct.data_ptr<int32_t>();
  }
  p.q = q.data_ptr();
  p.k = k.data_ptr();
  p.v = v.data_ptr();
  for (int i = 0; i < 3; ++i) {
    p.q_strides[i] = q.stride(i);
    p.k_strides[i] = k.stride(i);
    p.v_strides[i] = v.stride(i);
  }
  p.batch = static_cast<int>(B);
  p.seq = static_cast<int>(S);
  p.heads = static_cast<int>(H);
  p.head_dim = static_cast<int>(D);
  p.scale = static_cast<float>(scale);
  p.drop = drop;
  return p;
}

// a contiguous (B, H, S) float32 tensor for q
void check_bhs(const at::Tensor& t, const at::Tensor& q, const char* name) {
  check_cuda(t, q, name);
  TORCH_CHECK(t.scalar_type() == at::kFloat && t.is_contiguous() &&
                  t.dim() == 3 && t.size(0) == q.size(0) &&
                  t.size(1) == q.size(2) && t.size(2) == q.size(1),
              name, " must be a contiguous float32 (B, H, S) tensor");
}

// The bf16 pair takes sequences of whole tiles of its work items (its
// dq tile's keys).
void check_pair_seq(const at::Tensor& q, const char* what) {
  if (q.scalar_type() != at::kBFloat16) return;
  const int64_t keys = bert_kernels::flash_bwd_dq_tile().keys;
  TORCH_CHECK(q.size(1) % keys == 0, what, " takes bfloat16 sequences of "
              "whole ", keys, "-key tiles, got ", q.size(1));
}

std::vector<at::Tensor> flash_attention_fwd(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const c10::optional<at::Tensor>& bias,
    const c10::optional<at::Tensor>& segment_ids,
    const c10::optional<at::Tensor>& skipped, double scale, int64_t seed,
    int64_t threshold, double keep_div, bool apply) {
  auto p = flash_params(q, k, v, bias, segment_ids, skipped, scale,
                        flash_dropout(seed, threshold, keep_div, apply),
                        "flash_attention_fwd");
  if (q.scalar_type() == at::kBFloat16) {
    const int64_t keys = bert_kernels::flash_fwd_tile().keys;
    TORCH_CHECK(q.size(1) % keys == 0, "flash_attention_fwd takes bfloat16 "
                "sequences of whole ", keys, "-key tiles, got ", q.size(1));
  }
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = at::empty(q.sizes(), q.options());
  auto lse = at::empty({q.size(0), q.size(2), q.size(1)},
                       q.options().dtype(at::kFloat));
  p.out = out.data_ptr();
  p.lse = lse.data_ptr<float>();
  check_launch(bert_kernels::flash_attention_fwd(
                   p, activation_dtype(q, "q"),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention_fwd");
  return {out, lse};
}

std::vector<at::Tensor> flash_attention_bwd_dq(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const c10::optional<at::Tensor>& bias,
    const c10::optional<at::Tensor>& segment_ids, const at::Tensor& out,
    const at::Tensor& lse, const at::Tensor& dout,
    const c10::optional<at::Tensor>& skipped, double scale, int64_t seed,
    int64_t threshold, double keep_div, bool apply) {
  bert_kernels::FlashBwdParams p{};
  p.f = flash_params(q, k, v, bias, segment_ids, skipped, scale,
                     flash_dropout(seed, threshold, keep_div, apply),
                     "flash_attention_bwd_dq");
  check_pair_seq(q, "flash_attention_bwd_dq");
  check_like(out, q, "out");
  check_like(dout, q, "dout");
  check_bhs(lse, q, "lse");
  const c10::cuda::CUDAGuard guard(q.device());
  auto dq = at::empty(q.sizes(), q.options());
  auto delta = at::empty_like(lse);
  p.f.out = out.data_ptr();
  p.f.lse = lse.data_ptr<float>();
  p.dout = dout.data_ptr();
  p.delta = delta.data_ptr<float>();
  p.dq = dq.data_ptr();
  check_launch(bert_kernels::flash_attention_bwd_dq(
                   p, activation_dtype(q, "q"),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention_bwd_dq");
  return {dq, delta};
}

std::vector<at::Tensor> flash_attention_bwd_dkv(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const c10::optional<at::Tensor>& bias,
    const c10::optional<at::Tensor>& segment_ids, const at::Tensor& lse,
    const at::Tensor& delta, const at::Tensor& dout,
    const c10::optional<at::Tensor>& skipped, double scale, int64_t seed,
    int64_t threshold, double keep_div, bool apply) {
  bert_kernels::FlashBwdParams p{};
  p.f = flash_params(q, k, v, bias, segment_ids, skipped, scale,
                     flash_dropout(seed, threshold, keep_div, apply),
                     "flash_attention_bwd_dkv");
  check_pair_seq(q, "flash_attention_bwd_dkv");
  check_like(dout, q, "dout");
  check_bhs(lse, q, "lse");
  check_bhs(delta, q, "delta");
  const c10::cuda::CUDAGuard guard(q.device());
  auto dk = at::empty(q.sizes(), q.options());
  auto dv = at::empty(q.sizes(), q.options());
  p.f.lse = lse.data_ptr<float>();
  p.dout = dout.data_ptr();
  p.delta = delta.data_ptr<float>();
  p.dk = dk.data_ptr();
  p.dv = dv.data_ptr();
  check_launch(bert_kernels::flash_attention_bwd_dkv(
                   p, activation_dtype(q, "q"),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention_bwd_dkv");
  return {dk, dv};
}

std::vector<at::Tensor> flash_attention_bwd(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const c10::optional<at::Tensor>& bias,
    const c10::optional<at::Tensor>& segment_ids, const at::Tensor& out,
    const at::Tensor& lse, const at::Tensor& dout,
    const c10::optional<at::Tensor>& skipped, double scale, int64_t seed,
    int64_t threshold, double keep_div, bool apply) {
  bert_kernels::FlashBwdParams p{};
  p.f = flash_params(q, k, v, bias, segment_ids, skipped, scale,
                     flash_dropout(seed, threshold, keep_div, apply),
                     "flash_attention_bwd");
  TORCH_CHECK(q.scalar_type() == at::kBFloat16,
              "flash_attention_bwd takes bfloat16, got ", q.scalar_type());
  const int64_t keys = bert_kernels::flash_bwd_fused_tile().keys;
  TORCH_CHECK(q.size(1) % keys == 0 &&
                  q.size(1) <= bert_kernels::flash_bwd_fused_max_seq(),
              "flash_attention_bwd takes sequences of whole ", keys,
              "-key tiles up to ", bert_kernels::flash_bwd_fused_max_seq(),
              ", got ", q.size(1));
  check_like(out, q, "out");
  check_like(dout, q, "dout");
  check_bhs(lse, q, "lse");
  const c10::cuda::CUDAGuard guard(q.device());
  auto dq = at::empty(q.sizes(), q.options());
  auto dk = at::empty(q.sizes(), q.options());
  auto dv = at::empty(q.sizes(), q.options());
  p.f.out = out.data_ptr();
  p.f.lse = lse.data_ptr<float>();
  p.dout = dout.data_ptr();
  p.dq = dq.data_ptr();
  p.dk = dk.data_ptr();
  p.dv = dv.data_ptr();
  check_launch(bert_kernels::flash_attention_bwd_fused(
                   p, c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention_bwd");
  return {dq, dk, dv};
}

// {kernel name: (query rows, keys)} of the flash kernels for bf16 (or f32)
// inputs, from the kernels' own tile constants; the fused backward
// (bf16 only) as "flash_attention_bwd".
std::map<std::string, std::pair<int, int>> flash_tiles(bool bf16) {
  bert_kernels::FlashTile t[3];
  bert_kernels::flash_tiles(
      bf16 ? bert_kernels::kBFloat16 : bert_kernels::kFloat32, t);
  std::map<std::string, std::pair<int, int>> out = {
      {"flash_attention_fwd", {t[0].rows, t[0].keys}},
      {"flash_attention_bwd_dq", {t[1].rows, t[1].keys}},
      {"flash_attention_bwd_dkv", {t[2].rows, t[2].keys}}};
  if (bf16) {
    const auto f = bert_kernels::flash_bwd_fused_tile();
    out["flash_attention_bwd"] = {f.rows, f.keys};
  }
  return out;
}

// The fused backward as compiled: registers, local (spill) and static
// shared bytes of its dropout and no-dropout variants, the dynamic shared
// memory of a launch at `seq` and the longest sequence it takes.
std::map<std::string, int64_t> flash_bwd_fused_info(int64_t seq) {
  std::map<std::string, int64_t> out;
  for (const bool drop : {true, false}) {
    bert_kernels::KernelInfo info{};
    const cudaError_t err = bert_kernels::flash_bwd_fused_info(drop, &info);
    TORCH_CHECK(err == cudaSuccess, "cudaFuncGetAttributes: ",
                cudaGetErrorString(err));
    const std::string arm = drop ? "dropout_" : "plain_";
    out[arm + "registers"] = info.registers;
    out[arm + "local_bytes"] = info.local_bytes;
    out[arm + "static_smem_bytes"] = info.static_smem_bytes;
    out[arm + "max_threads"] = info.max_threads;
  }
  out["dynamic_smem_bytes"] =
      bert_kernels::flash_bwd_fused_smem(static_cast<int>(seq));
  out["max_seq"] = bert_kernels::flash_bwd_fused_max_seq();
  return out;
}

// The bf16 pair as compiled: registers, local (spill) and static shared
// bytes of each arm of its dq and dk/dv kernels (dropout or not, packed
// segments or not), keyed "dq_" / "dkv_" + arm, and each kernel's dynamic
// shared memory.
std::map<std::string, int64_t> flash_split_bwd_info() {
  std::map<std::string, int64_t> out;
  for (const bool dkv : {false, true}) {
    const std::string kern = dkv ? "dkv_" : "dq_";
    for (const bool drop : {true, false}) {
      for (const bool seg : {false, true}) {
        bert_kernels::KernelInfo info{};
        const cudaError_t err =
            bert_kernels::flash_split_bwd_info(dkv, drop, seg, &info);
        TORCH_CHECK(err == cudaSuccess, "cudaFuncGetAttributes: ",
                    cudaGetErrorString(err));
        const std::string arm = kern + (drop ? "dropout" : "plain") +
                                (seg ? "_packed_" : "_");
        out[arm + "registers"] = info.registers;
        out[arm + "local_bytes"] = info.local_bytes;
        out[arm + "static_smem_bytes"] = info.static_smem_bytes;
        out[arm + "max_threads"] = info.max_threads;
      }
    }
    out[kern + "dynamic_smem_bytes"] = bert_kernels::flash_split_bwd_smem(dkv);
  }
  return out;
}

// The bf16 forward as compiled: registers, local (spill) and static
// shared bytes of its four arms (dropout or not, packed segments or not),
// the dynamic shared memory of a launch and its (query rows, keys) tile.
std::map<std::string, int64_t> flash_fwd_info() {
  std::map<std::string, int64_t> out;
  for (const bool drop : {true, false}) {
    for (const bool seg : {false, true}) {
      bert_kernels::KernelInfo info{};
      const cudaError_t err = bert_kernels::flash_fwd_info(drop, seg, &info);
      TORCH_CHECK(err == cudaSuccess, "cudaFuncGetAttributes: ",
                  cudaGetErrorString(err));
      const std::string arm = std::string(drop ? "dropout" : "plain") +
                              (seg ? "_packed_" : "_");
      out[arm + "registers"] = info.registers;
      out[arm + "local_bytes"] = info.local_bytes;
      out[arm + "static_smem_bytes"] = info.static_smem_bytes;
      out[arm + "max_threads"] = info.max_threads;
    }
  }
  out["dynamic_smem_bytes"] = bert_kernels::flash_fwd_smem();
  out["tile_rows"] = bert_kernels::flash_fwd_tile().rows;
  out["tile_keys"] = bert_kernels::flash_fwd_tile().keys;
  return out;
}

// Fused LAMB. The tensor lists are checked here and turned into the
// kernels' per-tensor table; `chunks` is the (C, 2) int64 CPU chunk table
// (ops/fused_optim.chunk_table). Both tables go to the card in one
// transfer from pinned memory on the current stream, fresh every call, so
// no table outlives the tensors it names.

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// the chunk table checked against the tensors' sizes, then the device copy
// of [tensor rows | chunks]; returns it with the chunks' byte offset
template <typename Row>
std::pair<at::Tensor, size_t> lamb_tables(const std::vector<Row>& rows,
                                          const at::Tensor& chunks,
                                          int64_t chunk_size,
                                          const at::Tensor& ref,
                                          const char* what) {
  TORCH_CHECK(!chunks.is_cuda() && chunks.scalar_type() == at::kLong &&
                  chunks.is_contiguous() && chunks.dim() == 2 &&
                  chunks.size(1) == 2,
              what, ": chunks must be a contiguous (C, 2) int64 CPU tensor");
  TORCH_CHECK(chunk_size > 0 && chunk_size % 4 == 0 && chunk_size <= INT32_MAX,
              what, ": chunk_size must be a positive multiple of 4");
  const int64_t n_chunks = chunks.size(0);
  TORCH_CHECK(n_chunks <= INT32_MAX, what, ": too many chunks");
  const int64_t* c = chunks.data_ptr<int64_t>();
  for (int64_t i = 0; i < n_chunks; ++i) {
    const int64_t t = c[2 * i], start = c[2 * i + 1];
    TORCH_CHECK(t >= 0 && t < static_cast<int64_t>(rows.size()) &&
                    start >= 0 && start < rows[t].n && start % 4 == 0,
                what, ": chunk ", i, " (tensor ", t, ", start ", start,
                ") is outside its tensor");
  }
  const size_t row_bytes = rows.size() * sizeof(Row);
  const size_t total = row_bytes + n_chunks * sizeof(bert_kernels::LambChunk);
  auto host = at::empty({static_cast<int64_t>(total)},
                        at::TensorOptions().dtype(at::kByte).pinned_memory(true));
  auto* dst = static_cast<char*>(host.data_ptr());
  std::memcpy(dst, rows.data(), row_bytes);
  std::memcpy(dst + row_bytes, c, n_chunks * sizeof(bert_kernels::LambChunk));
  auto dev = at::empty({static_cast<int64_t>(total)},
                       ref.options().dtype(at::kByte));
  dev.copy_(host, /*non_blocking=*/true);
  return {dev, row_bytes};
}

void check_f32_like(const at::Tensor& t, const at::Tensor& g,
                    const char* name) {
  check_cuda(t, g, name);
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32, got ",
              t.scalar_type());
  TORCH_CHECK(t.sizes() == g.sizes(), name, " must have its gradient's shape");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void lamb_stage1(const std::vector<at::Tensor>& g,
                 const std::vector<at::Tensor>& mu,
                 const std::vector<at::Tensor>& nu,
                 const std::vector<at::Tensor>& p,
                 const std::vector<at::Tensor>& u,
                 const std::vector<double>& wd, const at::Tensor& denom,
                 const at::Tensor& chunks, int64_t chunk_size, double c1,
                 double c2, double b1, double b2, double eps) {
  const size_t n = g.size();
  TORCH_CHECK(n > 0 && mu.size() == n && nu.size() == n && p.size() == n &&
                  u.size() == n && wd.size() == n,
              "lamb_stage1: g, mu, nu, p, u and wd must be lists of one length");
  const at::Tensor& ref = g[0];
  check_cuda(ref, ref, "g");
  const auto g_dtype = activation_dtype(ref, "g");
  check_cuda(denom, ref, "denom");
  TORCH_CHECK(denom.scalar_type() == at::kFloat && denom.numel() == 1,
              "denom must be one float32");
  const uintptr_t g_vec = g_dtype == bert_kernels::kBFloat16 ? 8 : 16;
  std::vector<bert_kernels::LambStage1Tensor> rows(n);
  for (size_t i = 0; i < n; ++i) {
    check_cuda(g[i], ref, "g");
    TORCH_CHECK(g[i].scalar_type() == ref.scalar_type(),
                "every gradient must have one dtype");
    TORCH_CHECK(g[i].is_contiguous(), "g must be contiguous");
    check_f32_like(mu[i], g[i], "mu");
    check_f32_like(nu[i], g[i], "nu");
    check_f32_like(p[i], g[i], "p");
    check_f32_like(u[i], g[i], "u");
    auto& r = rows[i];
    r.g = g[i].data_ptr();
    r.mu = mu[i].data_ptr<float>();
    r.nu = nu[i].data_ptr<float>();
    r.p = p[i].data_ptr<float>();
    r.u = u[i].data_ptr<float>();
    r.n = g[i].numel();
    r.wd = static_cast<float>(wd[i]);
    r.vec = aligned(r.g, g_vec) && aligned(r.mu, 16) && aligned(r.nu, 16) &&
            aligned(r.p, 16) && aligned(r.u, 16);
  }
  const c10::cuda::CUDAGuard guard(ref.device());
  auto [table, chunk_off] =
      lamb_tables(rows, chunks, chunk_size, ref, "lamb_stage1");
  const auto* base = static_cast<const char*>(table.data_ptr());
  // torch multiplies f32 tensors by a Python float rounded to f32; 1 - b1
  // is formed in double first, as Python forms it
  bert_kernels::LambStage1Scalars s;
  s.b1 = static_cast<float>(b1);
  s.one_minus_b1 = static_cast<float>(1.0 - b1);
  s.b2 = static_cast<float>(b2);
  s.one_minus_b2 = static_cast<float>(1.0 - b2);
  s.eps = static_cast<float>(eps);
  s.c1 = static_cast<float>(c1);
  s.c2 = static_cast<float>(c2);
  check_launch(
      bert_kernels::lamb_stage1(
          reinterpret_cast<const bert_kernels::LambStage1Tensor*>(base),
          reinterpret_cast<const bert_kernels::LambChunk*>(base + chunk_off),
          chunks.size(0), static_cast<int>(chunk_size),
          denom.data_ptr<float>(), s, g_dtype,
          c10::cuda::getCurrentCUDAStream().stream()),
      "lamb_stage1");
}

void lamb_stage2(const at::Tensor& t, const std::vector<at::Tensor>& u,
                 const std::vector<at::Tensor>& out, const at::Tensor& chunks,
                 int64_t chunk_size, bool apply) {
  const size_t n = u.size();
  TORCH_CHECK(n > 0 && out.size() == n,
              "lamb_stage2: u and out must be lists of one length");
  const at::Tensor& ref = u[0];
  check_cuda(ref, ref, "u");
  check_cuda(t, ref, "t");
  TORCH_CHECK(t.scalar_type() == at::kFloat && t.is_contiguous() &&
                  t.numel() == static_cast<int64_t>(n),
              "t must be a contiguous float32 tensor of one value per tensor");
  std::vector<bert_kernels::LambStage2Tensor> rows(n);
  for (size_t i = 0; i < n; ++i) {
    check_f32_like(u[i], u[i], "u");
    check_cuda(u[i], ref, "u");
    check_f32_like(out[i], u[i], apply ? "p" : "out");
    auto& r = rows[i];
    r.u = u[i].data_ptr<float>();
    r.out = out[i].data_ptr<float>();
    r.n = u[i].numel();
    r.vec = aligned(r.u, 16) && aligned(r.out, 16);
    r.unused = 0;
  }
  const c10::cuda::CUDAGuard guard(ref.device());
  auto [table, chunk_off] =
      lamb_tables(rows, chunks, chunk_size, ref, "lamb_stage2");
  const auto* base = static_cast<const char*>(table.data_ptr());
  check_launch(
      bert_kernels::lamb_stage2(
          reinterpret_cast<const bert_kernels::LambStage2Tensor*>(base),
          reinterpret_cast<const bert_kernels::LambChunk*>(base + chunk_off),
          chunks.size(0), static_cast<int>(chunk_size), t.data_ptr<float>(),
          apply, c10::cuda::getCurrentCUDAStream().stream()),
      "lamb_stage2");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("layer_norm_fwd", &layer_norm_fwd, "LayerNorm forward (y, mean, rstd)");
  m.def("layer_norm_bwd", &layer_norm_bwd,
        "LayerNorm backward (dx, dscale, dbias)");
  m.def("add_dropout_layer_norm_fwd", &add_dropout_layer_norm_fwd,
        "residual-dropout-LayerNorm forward (y, mean, rstd)");
  m.def("add_dropout_layer_norm_bwd", &add_dropout_layer_norm_bwd,
        "residual-dropout-LayerNorm backward (dx, dres, dscale, dbias)");
  m.def("flash_attention_fwd", &flash_attention_fwd,
        "flash-attention forward (out, lse)");
  m.def("flash_attention_bwd_dq", &flash_attention_bwd_dq,
        "flash-attention backward: (dq, delta)");
  m.def("flash_attention_bwd_dkv", &flash_attention_bwd_dkv,
        "flash-attention backward: (dk, dv) from the dq launch's delta");
  m.def("flash_attention_bwd", &flash_attention_bwd,
        "fused flash-attention backward, bf16: (dq, dk, dv)");
  m.def("flash_bwd_fused_info", &flash_bwd_fused_info,
        "the fused backward's registers, spills and shared memory");
  m.def("flash_split_bwd_info", &flash_split_bwd_info,
        "the bf16 backward pair's registers, spills and shared memory");
  m.def("flash_fwd_info", &flash_fwd_info,
        "the bf16 flash forward's registers, spills and shared memory");
  m.def("flash_tiles", &flash_tiles,
        "{flash kernel: (query rows, keys) tile} for bf16 or f32 inputs");
  m.def("lamb_stage1", &lamb_stage1,
        "fused LAMB stage 1: mu, nu in place, u written");
  m.def("lamb_stage2", &lamb_stage2,
        "fused LAMB stage 2: out = t * u, or p += t * u with apply");
}
