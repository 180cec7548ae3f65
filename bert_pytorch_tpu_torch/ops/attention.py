"""Multi-head attention: plain versions, the flash kernel wrapper, the
dispatcher and the positional-hash dropout.

Counterpart of bert_pytorch_tpu/ops/attention.py.
Layout is the JAX package's: q/k/v (B, S, H, D), an additive (B, 1, 1, S)
padding bias, packed-sequence `segment_ids` (B, S) with 1..n per row and
0 for pad. Scores and softmax are f32 whatever the compute dtype.

- `attention_ref` is `_xla_attention`: dense f32 scores, softmax, probs
  cast to the compute dtype, then (training) `hash_dropout` on the probs,
  before the PV product; outputs of pad (segment-0) queries zeroed.
- `hash_dropout` is the JAX package's custom-VJP dropout: the keep mask is
  `row_col_keep` over the flattened (rows, last axis) view, regenerated in
  the backward pass instead of saved. It is XLA code there, plain PyTorch
  here.
- `flash_attention_ref` is the plain version of the flash kernel: the same
  function as the kernel computes it (unnormalised probs cast to the
  compute dtype before PV, the sum divided out after), and it returns the
  per-row log-sum-exp the kernel writes.
- `flash_attention` wraps the CUDA kernel that replaces the Pallas flash
  forward (ops/kernels/csrc/flash_attention.cu).
- `dot_product_attention` is the "auto" rule of ops/attention.py: flash
  above seq 256, plain attention at 256 and below. The flash kernel's
  dropout arm is not ported yet, so a rate above 0 there raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from bert_pytorch_tpu_torch.ops.kernels import count_launch
from bert_pytorch_tpu_torch.ops.layernorm import hash_keep_mask

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


def _hash_dropout_apply(x: torch.Tensor, seed: int, rate: float
                        ) -> torch.Tensor:
    keep = hash_keep_mask(seed, x.shape, rate, x.device)
    # divide by 1 - rate rounded to x's dtype (0.8984375 in bf16), as
    # jnp.asarray(1.0 - rate, x.dtype) does
    div = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


class HashDropoutFn(torch.autograd.Function):
    """Dropout with the counter-hash keep mask; saves only the seed, and
    the backward applies the same mask and scale to the gradient."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return _hash_dropout_apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _hash_dropout_apply(g, ctx.seed, ctx.rate), None, None


def hash_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Dropout whose keep mask is `row_col_keep` of the int32 `seed` over
    x's flattened (rows, last axis) view, regenerated in the backward pass
    (the JAX package's `hash_dropout`)."""
    return HashDropoutFn.apply(x, int(seed), float(rate))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  dropout_seed: Optional[int] = None,
                  dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain dense attention; returns (B, S, H, D) in q.dtype. With a
    `dropout_seed` and a rate above 0 (training), the probabilities go
    through `hash_dropout` after the cast to the compute dtype."""
    scores = _scores(q, k)
    if bias is not None:
        scores = scores + bias.float()
    if segment_ids is not None:
        scores = scores + make_segment_attention_bias(segment_ids)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_seed is not None and dropout_rate > 0.0:
        probs = hash_dropout(probs, dropout_seed, dropout_rate)
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
                          plain: bool = False,
                          dropout_seed: Optional[int] = None,
                          dropout_rate: float = 0.0) -> torch.Tensor:
    """(B, S, H, D) attention by the "auto" rule: the flash kernel above
    seq 256, plain attention at 256 and below. `plain=True` computes the
    same split with the flash kernel's plain version (a reference run to
    hold the kernels against). `dropout_seed` (training) turns on dropout
    of the probabilities at `dropout_rate`."""
    rate = dropout_rate if dropout_seed is not None else 0.0
    if q.shape[1] > FLASH_MIN_SEQ:
        if rate > 0.0:
            raise NotImplementedError(
                "attention dropout above seq 256 needs the flash kernel's "
                "dropout arm, which is not ported yet (ROADMAP queue B "
                "#5/#6)")
        if plain:
            return flash_attention_ref(q, k, v, bias, segment_ids)[0]
        return flash_attention(q, k, v, bias, segment_ids)[0]
    return attention_ref(q, k, v, bias, segment_ids, dropout_seed, rate)
