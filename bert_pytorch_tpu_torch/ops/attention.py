"""Multi-head attention: plain versions, the flash kernel wrappers and
their autograd Function, the dispatcher and the positional-hash dropout.

Counterpart of bert_pytorch_tpu/ops/attention.py and of the custom VJP of
bert_pytorch_tpu/ops/pallas/flash_attention.py.
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
- `flash_keep_mask` is the flash kernels' own keep mask (`_keep_mask`), a
  different hash from `row_col_keep`, bit for bit in int32 arithmetic.
- `flash_attention_ref` is the plain version of the flash forward kernel:
  the same function as the kernel computes it (unnormalised probs, dropped
  ones zeroed, cast to the compute dtype before PV, the undropped sum
  divided out after, then 1 - rate), and it returns the per-row
  log-sum-exp of the undropped softmax that the kernel writes.
  `flash_attention_bwd_dq_ref` and `flash_attention_bwd_dkv_ref` are the
  plain versions of the two backward kernels, `flash_attention_bwd_ref`
  the whole backward: dq, dk, dv recomputed from that lse with the same
  masks.
- `flash_attention`, `flash_attention_bwd_dq` and `flash_attention_bwd_dkv`
  wrap the CUDA kernels that replace the Pallas flash forward (bf16:
  ops/kernels/csrc/flash_attention_fwd.cu, sequences of whole 128-key
  tiles; f32: flash_attention.cu) and split backward (bf16:
  flash_attention_split_bwd.cu, sequences of whole 128-key tiles; f32:
  flash_attention.cu); `flash_attention_bwd`
  wraps the fused dq/dk/dv kernel that replaces the fused Pallas backward
  (ops/kernels/csrc/flash_attention_bwd.cu), which `fused_bwd_takes`
  sends bf16 at head dim 64 and seq <= FUSED_BWD_MAX_SEQ (512) to;
  `FlashAttentionFn` is the autograd Function over them (their plain
  versions on the CPU).
- `dot_product_attention` is the "auto" rule of ops/attention.py: flash
  when seq > 256, seq % 128 == 0 and q and k have one shape, plain
  attention with `hash_dropout` otherwise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from bert_pytorch_tpu_torch.ops.kernels import count_launch
from bert_pytorch_tpu_torch.ops.layernorm import (_U32, _as_int32, _to_int32,
                                                  hash_keep_mask)

# Additive padding bias (reference value -10000, representable in bf16).
MASK_BIAS = -10000.0
# Packed-sequence mask: the flash kernels' NEG_INF, so every path gives
# cross-segment probabilities of exactly 0.0.
SEGMENT_MASK_BIAS = -1e30
# Above this sequence length dot_product_attention takes the flash kernel
# (when the length is a multiple of FLASH_SEQ_MULTIPLE and q, k share a
# shape, the JAX package's gate).
FLASH_MIN_SEQ = 256
FLASH_SEQ_MULTIPLE = 128


# The fused backward kernel takes whole 128-key tiles up to this sequence
# length, the longest whose f32 dq accumulator and TMA ring fit the 227 KB
# of shared memory a Hopper block may use (flash_attention_bwd.cu;
# chip_smoke.py checks it against the kernel's own limit on the card).
FUSED_BWD_MAX_SEQ = 512
FUSED_BWD_SEQ_MULTIPLE = 128


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


def keep_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float
                 ) -> torch.Tensor:
    """x / (1 - rate) where `keep`, else 0, dividing by 1 - rate rounded
    to x's dtype (0.8984375 in bf16), as jnp.asarray(1.0 - rate, x.dtype)
    and flax nn.Dropout's `inputs / keep_prob` do."""
    div = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep.to(x.device), x / div,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _hash_dropout_apply(x: torch.Tensor, seed: int, rate: float,
                        row0: int = 0) -> torch.Tensor:
    return keep_dropout(x, hash_keep_mask(seed, x.shape, rate, x.device,
                                          row0), rate)


class HashDropoutFn(torch.autograd.Function):
    """Dropout with the counter-hash keep mask; saves only the seed, and
    the backward applies the same mask and scale to the gradient."""

    @staticmethod
    def forward(ctx, x, seed, rate, row0=0):
        ctx.seed, ctx.rate, ctx.row0 = seed, rate, row0
        return _hash_dropout_apply(x, seed, rate, row0)

    @staticmethod
    def backward(ctx, g):
        return (_hash_dropout_apply(g, ctx.seed, ctx.rate, ctx.row0), None,
                None, None)


def hash_dropout(x: torch.Tensor, seed, rate: float,
                 row0: int = 0) -> torch.Tensor:
    """Dropout whose keep mask is `row_col_keep` of the int32 `seed` over
    x's flattened (rows, last axis) view, regenerated in the backward pass
    (the JAX package's `hash_dropout`). `row0`: the view's first row in
    the global array: a data-parallel rank hashes its rows of the global
    batch, as GSPMD partitions the JAX package's global-view mask."""
    return HashDropoutFn.apply(x, int(seed), float(rate), int(row0))


# The flash kernels' per-shard seed fold of the JAX package
# (ops/attention._flash_sharded): shard i of a data-parallel mesh XORs the
# site's seed with i * 0x9E3779B9, with int32 wrap.
FLASH_SHARD_FOLD = 0x9E3779B9


def flash_shard_seed(seed, shard: int) -> int:
    """The int32 seed data-parallel shard `shard` hands the flash
    kernels: `seed` itself on shard 0."""
    return _as_int32(int(seed) ^ ((int(shard) * FLASH_SHARD_FOLD) & _U32))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  dropout_seed: Optional[int] = None,
                  dropout_rate: float = 0.0,
                  dropout_shard: int = 0) -> torch.Tensor:
    """Plain dense attention; returns (B, S, H, D) in q.dtype. With a
    `dropout_seed` and a rate above 0 (training), the probabilities go
    through `hash_dropout` after the cast to the compute dtype; on
    data-parallel shard `dropout_shard` the (B, H, S, S) view's rows
    start at that shard's rows of the global batch."""
    scores = _scores(q, k)
    if bias is not None:
        scores = scores + bias.float()
    if segment_ids is not None:
        scores = scores + make_segment_attention_bias(segment_ids)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_seed is not None and dropout_rate > 0.0:
        b, h, s, _ = probs.shape
        probs = hash_dropout(probs, dropout_seed, dropout_rate,
                             dropout_shard * b * h * s)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if segment_ids is not None:
        out = out * (segment_ids > 0).to(out.dtype)[:, :, None, None]
    return out


# -- the flash kernels' dropout mask ------------------------------------------


def flash_keep_threshold(rate: float) -> int:
    """The flash keep test's threshold on the hash's top 23 bits, computed
    on the host as the JAX package computes it: int(rate * 2^23)."""
    return int(rate * (1 << 23))


def _flash_hash_keep(seed_bh: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, rate: float) -> torch.Tensor:
    """`_keep_mask` over int64 position vectors `rows` x `cols`, for each
    int32 (seed + bh * 0xC2B2AE3D) of `seed_bh` (shape (N,)): (N, rows,
    cols) bool. The hash runs in int32 with the bits uint32 arithmetic
    would give (see row_col_keep): wrapping multiplies, arithmetic shifts
    masked to the bits a logical shift keeps."""
    r_term = _to_int32(((rows & _U32) * 0x9E3779B1) & _U32)
    c_term = _to_int32(((cols & _U32) * 0x85EBCA77) & _U32)
    x = (r_term[:, None] ^ c_term[None, :])[None] ^ seed_bh[:, None, None]
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _as_int32(0x7FEB352D)
    x = x ^ ((x >> 15) & 0x1FFFF)
    x = x * _as_int32(0x846CA68B)
    return ((x >> 9) & 0x7FFFFF) >= flash_keep_threshold(rate)


def _seed_bh(seed, bh: int) -> int:
    """uint32(seed) + bh * 0xC2B2AE3D, mod 2^32, as an int32."""
    return _as_int32((int(seed) & _U32) + (int(bh) & _U32) * 0xC2B2AE3D)


def flash_keep_mask(seed, bh: int, q0: int, k0: int, rows: int, cols: int,
                    rate: float, device: Optional[torch.device] = None
                    ) -> torch.Tensor:
    """(rows, cols) bool keep mask of the flash kernels' `_keep_mask`, bit
    for bit: query positions q0.. by key positions k0.. of flattened
    (batch * heads + head) `bh`, the int32 `seed` reinterpreted as uint32,
    kept iff the top 23 hash bits are >= int(rate * 2^23)."""
    r = torch.arange(rows, dtype=torch.int64, device=device) + int(q0)
    c = torch.arange(cols, dtype=torch.int64, device=device) + int(k0)
    seed_bh = torch.tensor([_seed_bh(seed, bh)], dtype=torch.int32,
                           device=device)
    return _flash_hash_keep(seed_bh, r, c, rate)[0]


def flash_keep_all(seed, batch: int, heads: int, seq: int, rate: float,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """The whole (B, H, S, S) flash keep mask of one call."""
    pos = torch.arange(seq, dtype=torch.int64, device=device)
    seed_bh = torch.tensor([_seed_bh(seed, bh) for bh in range(batch * heads)],
                           dtype=torch.int32, device=device)
    return _flash_hash_keep(seed_bh, pos, pos, rate).reshape(
        batch, heads, seq, seq)


def _flash_rate(seed, rate: float) -> float:
    if rate > 0.0 and seed is None:
        raise ValueError("flash attention with dropout_rate > 0 needs a "
                         "dropout_seed")
    return float(rate) if rate > 0.0 else 0.0


def _keep_div(rate: float, device) -> torch.Tensor:
    # f32(1 - rate) as a tensor: a true f32 division, as the kernels and
    # the Pallas kernels divide (a Python-scalar divisor may become a
    # multiply by its reciprocal on the card)
    return torch.tensor(1.0 - rate, dtype=torch.float32, device=device)


# -- the flash kernels' plain versions ----------------------------------------


def _flash_scores(q: torch.Tensor, k: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, S, S) f32 scores as the kernels form them: scaled q k^T plus
    the bias, NEG_INF (-1e30) where the packed-segment mask forbids."""
    s = _scores(q, k)
    if bias is not None:
        s = s + bias.float()
    if segment_ids is not None:
        qs = segment_ids[:, None, :, None]
        allowed = (qs == segment_ids[:, None, None, :]) & (qs > 0)
        s = torch.where(allowed, s, torch.full_like(s, SEGMENT_MASK_BIAS))
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        segment_ids: Optional[torch.Tensor] = None,
                        dropout_seed=None, dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernel: (out (B, S, H, D) in
    q.dtype, lse (B, H, S) f32). With dropout the order is the Pallas
    kernel's: the row sum l is of the undropped probs, dropped probs are
    zeroed before the cast and the PV product, out = acc / max(l, 1e-30) /
    f32(1 - rate), lse is the undropped one, pad rows are zeroed last."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    b, s_len, h, _ = q.shape
    s = _flash_scores(q, k, bias, segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0.0:
        keep = flash_keep_all(dropout_seed, b, h, s_len, rate, q.device)
        p = torch.where(keep, p, torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(),
                       v.float()) / l_safe
    if rate > 0.0:
        out = out / _keep_div(rate, q.device)
    if segment_ids is not None:
        out = out * (segment_ids > 0).float()[:, None, :, None]
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention_delta_ref(out: torch.Tensor, do: torch.Tensor
                              ) -> torch.Tensor:
    """delta = rowsum(f32(dO) * f32(out)), (B, H, S) f32, from the stored
    (dropped, dtype-rounded) forward output."""
    return (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1)


def _flash_bwd_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     segment_ids: Optional[torch.Tensor], lse: torch.Tensor,
                     delta: torch.Tensor, do: torch.Tensor, seed, rate: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ds, p_drop), (B, H, S, S) f32, as both backward kernels form them.
    p = exp(s - lse) is the undropped softmax, 0 on pad (segment-0) query
    rows; dp = dO v^T is dropped and scaled by the mask; ds = p * (dp -
    delta) uses the undropped p and is rounded to q's dtype; p_drop =
    keep ? p / (1 - rate) : 0."""
    b, s_len, h, _ = q.shape
    p = torch.exp(_flash_scores(q, k, bias, segment_ids) - lse[..., None])
    if segment_ids is not None:
        p = p * (segment_ids > 0).float()[:, None, :, None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    p_drop = p
    if rate > 0.0:
        keep = flash_keep_all(seed, b, h, s_len, rate, q.device)
        div, zero = _keep_div(rate, q.device), torch.zeros((), device=q.device)
        dp = torch.where(keep, dp / div, zero)
        p_drop = torch.where(keep, p / div, zero)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return ds, p_drop


def flash_attention_bwd_dq_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: Optional[torch.Tensor],
                               segment_ids: Optional[torch.Tensor],
                               lse: torch.Tensor, delta: torch.Tensor,
                               do: torch.Tensor, dropout_seed=None,
                               dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain version of the dq kernel: dq = cast(ds) k * scale in q.dtype,
    the scale applied in f32 after the product."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    ds, _ = _flash_bwd_probs(q, k, v, bias, segment_ids, lse, delta, do,
                             dropout_seed, rate)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            * scale).to(q.dtype)


def flash_attention_bwd_dkv_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: Optional[torch.Tensor],
                                segment_ids: Optional[torch.Tensor],
                                lse: torch.Tensor, delta: torch.Tensor,
                                do: torch.Tensor, dropout_seed=None,
                                dropout_rate: float = 0.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: (dk, dv) in q.dtype, dv =
    cast(p_drop)^T dO and dk = cast(ds)^T q * scale."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    ds, p_drop = _flash_bwd_probs(q, k, v, bias, segment_ids, lse, delta, do,
                                  dropout_seed, rate)
    dt, scale = q.dtype, 1.0 / math.sqrt(q.shape[-1])
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop.to(dt).float(),
                      do.float()).to(dt)
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale).to(dt)
    return dk, dv


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor],
                            segment_ids: Optional[torch.Tensor],
                            out: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, dropout_seed=None,
                            dropout_rate: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the whole backward, (dq, dk, dv) in q.dtype, as the
    Pallas backward kernels compute it: delta = rowsum(dO * out) of the
    stored output, then the dq and dk/dv kernels' plain versions.

    Pad (segment-0) query rows contribute nothing: p is 0 on them, so
    their dq is 0 and they add nothing to dk or dv. (Pallas gives them
    p = 1 on the tiles its skip keeps, which matters only when their
    cotangent is non-zero; no loss term reads pad positions.)"""
    delta = flash_attention_delta_ref(out, do)
    dq = flash_attention_bwd_dq_ref(q, k, v, bias, segment_ids, lse, delta,
                                    do, dropout_seed, dropout_rate)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, bias, segment_ids, lse,
                                         delta, do, dropout_seed,
                                         dropout_rate)
    return dq, dk, dv


# -- the kernel wrappers ------------------------------------------------------


def _dropout_args(seed, rate: float) -> Tuple[int, int, float, bool]:
    """(int32 seed, threshold, f32 1 - rate, apply) for the kernels."""
    if rate <= 0.0:
        return 0, 0, 1.0, False
    return int(seed), flash_keep_threshold(rate), 1.0 - rate, True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    dropout_seed=None, dropout_rate: float = 0.0,
                    skipped: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper: (out, lse). CUDA tensors launch the kernel,
    which reads q/k/v through their strides (unit head_dim stride, 16-byte
    aligned rows, head_dim 64; bf16 sequences a multiple of 128) and takes
    a contiguous f32 bias of B * S entries and contiguous int32 (B, S)
    segment ids; anything else raises. CPU tensors take the plain version.
    `skipped`, a one-element int32 CUDA tensor, gains the count of
    (q-tile, k-tile) pairs the kernel skipped because their segment ranges
    do not meet (bf16: 64-query, 128-key tiles). A rate above 0
    drops probabilities with `flash_keep_mask` of the int32
    `dropout_seed`."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, bias, segment_ids, dropout_seed,
                                   rate)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    out, lse = load_kernels().flash_attention_fwd(
        q, k, v, bias, segment_ids, skipped, 1.0 / math.sqrt(q.shape[-1]),
        *_dropout_args(dropout_seed, rate))
    count_launch("flash_attention_fwd")
    return out, lse


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           segment_ids: Optional[torch.Tensor],
                           out: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, dropout_seed=None,
                           dropout_rate: float = 0.0,
                           skipped: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq kernel wrapper: (dq, delta (B, H, S) f32). The kernel forms
    delta = rowsum(dO * out) for its q tile and writes it out for the
    dk/dv kernel. CUDA tensors: q/k/v as the forward takes them (bf16
    sequences a multiple of 128), out and do contiguous (B, S, H, D) in
    q's dtype, lse (B, H, S) f32; anything else raises. `skipped` gains
    the (q-tile, k-tile) pairs skipped by the segment test (bf16: 64
    queries by 128 keys). CPU tensors take the plain version."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    if not q.is_cuda:
        delta = flash_attention_delta_ref(out, do)
        return flash_attention_bwd_dq_ref(q, k, v, bias, segment_ids, lse,
                                          delta, do, dropout_seed,
                                          rate), delta
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    dq, delta = load_kernels().flash_attention_bwd_dq(
        q, k, v, bias, segment_ids, out, lse, do, skipped,
        1.0 / math.sqrt(q.shape[-1]), *_dropout_args(dropout_seed, rate))
    count_launch("flash_attention_bwd_dq")
    return dq, delta


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor],
                            segment_ids: Optional[torch.Tensor],
                            lse: torch.Tensor, delta: torch.Tensor,
                            do: torch.Tensor, dropout_seed=None,
                            dropout_rate: float = 0.0,
                            skipped: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel wrapper: (dk, dv), from the lse of the forward and the
    delta of flash_attention_bwd_dq; CUDA tensors as that wrapper takes
    them, delta contiguous (B, H, S) f32. `skipped` gains the (q-tile,
    k-tile) pairs skipped by the segment test (bf16: 64 queries by 64
    keys). CPU tensors take the plain version."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    if not q.is_cuda:
        return flash_attention_bwd_dkv_ref(q, k, v, bias, segment_ids, lse,
                                           delta, do, dropout_seed, rate)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    dk, dv = load_kernels().flash_attention_bwd_dkv(
        q, k, v, bias, segment_ids, lse, delta, do, skipped,
        1.0 / math.sqrt(q.shape[-1]), *_dropout_args(dropout_seed, rate))
    count_launch("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        segment_ids: Optional[torch.Tensor],
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, dropout_seed=None,
                        dropout_rate: float = 0.0,
                        skipped: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused backward kernel wrapper: (dq, dk, dv) in one launch, delta
    formed inside it. CUDA tensors: bf16 q/k/v as the forward takes them
    (head_dim 64, seq a multiple of 128 up to FUSED_BWD_MAX_SEQ), out and
    do contiguous (B, S, H, D) bf16, lse (B, H, S) f32; anything else
    raises. `skipped`
    gains the (64-query, 128-key) tile pairs skipped by the segment test.
    CPU tensors take the plain version, flash_attention_bwd_ref."""
    rate = _flash_rate(dropout_seed, dropout_rate)
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, bias, segment_ids, out, lse,
                                       do, dropout_seed, rate)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    dq, dk, dv = load_kernels().flash_attention_bwd(
        q, k, v, bias, segment_ids, out, lse, do, skipped,
        1.0 / math.sqrt(q.shape[-1]), *_dropout_args(dropout_seed, rate))
    count_launch("flash_attention_bwd")
    return dq, dk, dv


def fused_bwd_takes(q: torch.Tensor) -> bool:
    """Does the backward of flash attention over q take the fused kernel?
    bf16, head dim 64 and seq a multiple of 128 up to FUSED_BWD_MAX_SEQ
    (its dq accumulator and q/dO ring fit a block's shared memory); f32,
    the checking dtype, and longer sequences take the dq and dk/dv pair,
    as the JAX package keeps its split kernels beyond its fused gate. A
    rule on dtype and shape, not a fallback: a failing kernel raises."""
    seq = q.shape[1]
    return (q.dtype == torch.bfloat16 and q.shape[-1] == 64
            and seq % FUSED_BWD_SEQ_MULTIPLE == 0
            and seq <= FUSED_BWD_MAX_SEQ)


# While `counting_skips()` is open: one-element int32 CUDA tensors, by
# kernel, that gain the (q-tile, k-tile) pairs FlashAttentionFn's kernels
# skip by the segment test (a caller reads how much packing saved).
_SKIPS: Optional[Dict[str, torch.Tensor]] = None


@contextlib.contextmanager
def counting_skips(device) -> Iterator[Dict[str, torch.Tensor]]:
    """Count the tiles the model path's flash kernels skip, by kernel name
    (flash_attention_fwd, flash_attention_bwd, flash_attention_bwd_dq,
    flash_attention_bwd_dkv), in the yielded dict's tensors."""
    global _SKIPS
    _SKIPS = {k: torch.zeros(1, dtype=torch.int32, device=device)
              for k in ("flash_attention_fwd", "flash_attention_bwd",
                        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    try:
        yield _SKIPS
    finally:
        _SKIPS = None


def _skips(name: str, q: torch.Tensor) -> Optional[torch.Tensor]:
    return _SKIPS[name] if _SKIPS is not None and q.is_cuda else None


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention whose forward is the forward kernel (#5/#6) and
    whose backward is the fused dq/dk/dv kernel (#7/#8) where
    `fused_bwd_takes`, else the dq and dk/dv kernels (#9/#10); CPU tensors
    run their plain versions. Saves q, k, v, the bias and segment ids, out,
    lse and the int32 seed, as the Pallas custom VJP saves its residuals;
    the bias, segment ids, seed and rate get no gradient (the zero
    cotangents of `_bwd_epilogue`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids, seed, rate):
        out, lse = flash_attention(q, k, v, bias, segment_ids, seed, rate,
                                   _skips("flash_attention_fwd", q))
        ctx.save_for_backward(q, k, v, bias, segment_ids, out, lse)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seg, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if fused_bwd_takes(q):
            dq, dk, dv = flash_attention_bwd(
                q, k, v, bias, seg, out, lse, g, ctx.seed, ctx.rate,
                _skips("flash_attention_bwd", q))
        else:
            dq, delta = flash_attention_bwd_dq(
                q, k, v, bias, seg, out, lse, g, ctx.seed, ctx.rate,
                _skips("flash_attention_bwd_dq", q))
            dk, dv = flash_attention_bwd_dkv(
                q, k, v, bias, seg, lse, delta, g, ctx.seed, ctx.rate,
                _skips("flash_attention_bwd_dkv", q))
        return dq, dk, dv, None, None, None, None


def takes_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's gate to the flash kernel (ops/attention.py): seq
    above 256, a multiple of 128, and q and k of one shape."""
    seq = q.shape[1]
    return (seq > FLASH_MIN_SEQ and seq % FLASH_SEQ_MULTIPLE == 0
            and q.shape == k.shape)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None,
                          plain: bool = False,
                          dropout_seed: Optional[int] = None,
                          dropout_rate: float = 0.0,
                          dropout_shard: int = 0) -> torch.Tensor:
    """(B, S, H, D) attention by the "auto" rule: the flash kernels where
    `takes_flash`, plain attention otherwise. `plain=True` computes the
    same split with the flash kernel's plain version, differentiated by
    autograd (a reference run to hold the kernels against).
    `dropout_seed` (training) turns on dropout of the probabilities at
    `dropout_rate`: the flash mask on the flash route, `hash_dropout`
    (`row_col_keep`) on the plain one, as in the JAX package. On
    data-parallel shard `dropout_shard` each route draws what the JAX
    package's data-parallel mesh draws on that shard: the flash seed
    XOR-folded (`flash_shard_seed`), the plain mask at the shard's rows
    of the global batch."""
    rate = dropout_rate if dropout_seed is not None else 0.0
    if takes_flash(q, k):
        seed = dropout_seed if rate > 0.0 else None
        if seed is not None and dropout_shard:
            seed = flash_shard_seed(seed, dropout_shard)
        if plain:
            return flash_attention_ref(q, k, v, bias, segment_ids, seed,
                                       rate)[0]
        return FlashAttentionFn.apply(q, k, v, bias, segment_ids, seed, rate)
    return attention_ref(q, k, v, bias, segment_ids, dropout_seed, rate,
                         dropout_shard)
