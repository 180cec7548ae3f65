"""Multi-head attention: plain versions, the flash kernel wrapper and the
dispatcher.

Counterpart of bert_pytorch_tpu/ops/attention.py, deterministic path only.
Layout is the JAX package's: q/k/v (B, S, H, D), an additive (B, 1, 1, S)
padding bias, packed-sequence `segment_ids` (B, S) with 1..n per row and
0 for pad. Scores and softmax are f32 whatever the compute dtype.

- `attention_ref` is `_xla_attention`: dense f32 scores, softmax, probs
  cast to the compute dtype before the PV product, outputs of pad
  (segment-0) queries zeroed.
- `flash_attention_ref` is the plain version of the flash kernel: the same
  function as the kernel computes it (unnormalised probs cast to the
  compute dtype before PV, the sum divided out after), and it returns the
  per-row log-sum-exp the kernel writes.
- `flash_attention` wraps the CUDA kernel that replaces the Pallas flash
  forward (ops/kernels/csrc/flash_attention.cu).
- `dot_product_attention` is the "auto" rule of ops/attention.py: flash
  above seq 256, plain attention at 256 and below.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from bert_pytorch_tpu_torch.ops.kernels import count_launch

# Additive padding bias (reference value -10000, representable in bf16).
MASK_BIAS = -10000.0
# Packed-sequence mask: the flash kernels' NEG_INF, so every path gives
# cross-segment probabilities of exactly 0.0.
SEGMENT_MASK_BIAS = -1e30
# Above this sequence length dot_product_attention takes the flash kernel.
FLASH_MIN_SEQ = 256
# The flash kernel's (q rows, keys) tile per dtype, as flash_attention.cu
# sets them (kBM/kBN, kFM/kFN): the grain of its segment tile skip.
FLASH_TILES = {torch.bfloat16: (64, 64), torch.float32: (64, 32)}


def make_attention_bias(attention_mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) {0,1} mask -> (B, 1, 1, S) additive bias."""
    bias = (1.0 - attention_mask.float()) * MASK_BIAS
    return bias[:, None, None, :].to(dtype)


def make_segment_attention_bias(segment_ids: torch.Tensor,
                                dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """(B, S) packing segments -> (B, 1, S, S) additive bias: 0 where q and
    k share a non-pad segment, SEGMENT_MASK_BIAS elsewhere."""
    qs = segment_ids[:, None, :, None]
    ks = segment_ids[:, None, None, :]
    allowed = (qs == ks) & (qs > 0)
    zero = torch.zeros((), dtype=torch.float32, device=segment_ids.device)
    neg = torch.full((), SEGMENT_MASK_BIAS, dtype=torch.float32,
                     device=segment_ids.device)
    return torch.where(allowed, zero, neg).to(dtype)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    # f32 scores from the stored dtype: bf16 x bf16 products are exact in
    # f32, so this is the f32-accumulated product of the JAX einsum
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Plain dense attention; returns (B, S, H, D) in q.dtype."""
    scores = _scores(q, k)
    if bias is not None:
        scores = scores + bias.float()
    if segment_ids is not None:
        scores = scores + make_segment_attention_bias(segment_ids)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if segment_ids is not None:
        out = out * (segment_ids > 0).to(out.dtype)[:, :, None, None]
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash kernel: (out (B, S, H, D) in q.dtype,
    lse (B, H, S) f32)."""
    s = _scores(q, k)
    if bias is not None:
        s = s + bias.float()
    if segment_ids is not None:
        qs = segment_ids[:, None, :, None]
        allowed = (qs == segment_ids[:, None, None, :]) & (qs > 0)
        s = torch.where(allowed, s, torch.full_like(s, SEGMENT_MASK_BIAS))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(),
                       v.float()) / l_safe
    if segment_ids is not None:
        out = out * (segment_ids > 0).float()[:, None, :, None]
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    skipped: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (out, lse). CUDA tensors launch the kernel, which
    reads q/k/v through their strides (unit head_dim stride, 16-byte
    aligned rows, head_dim 64) and takes a contiguous f32 bias of B * S
    entries and contiguous int32 (B, S) segment ids; anything else raises.
    CPU tensors take the plain version. `skipped`, a one-element int32
    CUDA tensor, gains the count of (q-tile, k-tile) pairs the kernel
    skipped because their segment ranges do not meet.

    Attention dropout is not ported yet: a rate above 0 raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention: the dropout arm is not ported; serving is "
            "deterministic (dropout_rate must be 0)")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, bias, segment_ids)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    out, lse = load_kernels().flash_attention_fwd(
        q, k, v, bias, segment_ids, skipped, 1.0 / math.sqrt(q.shape[-1]))
    count_launch("flash_attention_fwd")
    return out, lse


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None,
                          plain: bool = False) -> torch.Tensor:
    """(B, S, H, D) attention by the "auto" rule: the flash kernel above
    seq 256, plain attention at 256 and below. `plain=True` computes the
    same split with the flash kernel's plain version (a reference run to
    hold the kernels against)."""
    if q.shape[1] > FLASH_MIN_SEQ:
        if plain:
            return flash_attention_ref(q, k, v, bias, segment_ids)[0]
        return flash_attention(q, k, v, bias, segment_ids)[0]
    return attention_ref(q, k, v, bias, segment_ids)
