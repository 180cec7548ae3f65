"""Tensor parallelism over the mesh's model axis (Megatron-LM's column and
row splits; counterpart of what GSPMD makes of the JAX package's rules
table under a model axis).

A rank of model coordinate m holds heads [m H / M, (m + 1) H / M) of the
attention, columns [m I / M, ...) of the MLP's up-projection and those
rows of its down-projection, and rows [m V / M, ...) of the word
embeddings (tied to the MLM decoder) and of the decoder's bias
(parallel/rules.py). Two operators carry the activations across the
split, each a torch.autograd.Function over the port's own collectives
(parallel/dist.all_reduce_any over the model group, a reduce-scatter and
an all-gather, so every model peer holds the same bits):

- `copy_to_model`: the identity forward and an all-reduce of the
  gradient backward, before a column split (the MLM decoder; the QKV
  projection and the MLP's up-projection take `column_linear`, which
  does the same inside the Linear): each peer's input gradient is a
  partial sum over its columns;
- `reduce_from_model`: an all-reduce forward and the identity backward,
  after a row split (the attention output, the MLP's down-projection,
  the word-embedding lookup, the MLM loss's softmax sums): a row split's
  bias is added once, after the sum.

The two split Linears keep one rounding to the compute dtype where the
one-card Linear has one: `row_linear` forms the rank's partial product in
f32 (a bf16 GEMM with an f32 output on a card), sums the partials in f32,
adds the bias and rounds once; `column_linear`'s backward forms its
input gradient the same way before the sum. (Summing bf16 partials
rounds three times a layer and moved a 6-layer model's loss 2.2e-4 from
the one-card run's in 3 steps on the card, against 3.6e-5 for the data
axis.)

`ModelShard` says which part a model holds; None (or size 1) is the
whole model on one rank, whose forward is the one-card forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from bert_pytorch_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Model coordinate `index` of `size`, and its model group (the
    ranks of the other coordinates at this rank's data and fsdp
    coordinates; None outside a process group)."""
    index: int = 0
    size: int = 1
    group: Optional[dist.Group] = None

    def part(self, n: int, what: str) -> int:
        """n / size, checked: a width the model axis does not divide
        raises ValueError naming the tensor and the sizes."""
        if n % self.size:
            raise ValueError(f"{what}: {n} does not divide over the model "
                             f"axis of {self.size} (the port splits "
                             "evenly; GSPMD would pad)")
        return n // self.size


def is_split(shard: Optional[ModelShard]) -> bool:
    return shard is not None and shard.size > 1


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dist.all_reduce_any(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return dist.all_reduce_any(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]
                  ) -> torch.Tensor:
    """Identity forward, the gradient summed over the model group
    backward (before a column split); `x` itself without a split."""
    return _CopyToModel.apply(x, shard.group) if is_split(shard) else x


def reduce_from_model(x: torch.Tensor, shard: Optional[ModelShard]
                      ) -> torch.Tensor:
    """`x` summed over the model group forward, the identity backward
    (after a row split); `x` itself without a split."""
    return _ReduceFromModel.apply(x, shard.group) if is_split(shard) else x


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and an f32 result: a bf16 / f16 GEMM
    with an f32 output on a card (cuBLAS), the f32 product elsewhere
    (exact products of the low-precision values)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _PartialLinear(torch.autograd.Function):
    """x @ w^T as an f32 tensor (x, w in the compute dtype); the backward
    takes the f32 gradient back to the compute dtype, as the one-card
    Linear's backward receives it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        lead = x.shape[:-1]
        return _mm_f32(x.reshape(-1, x.shape[-1]), w.t()).view(
            *lead, w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).reshape(-1, w.shape[0])
        dx = (g @ w).view(x.shape)
        dw = g.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw


class _ColumnLinear(torch.autograd.Function):
    """F.linear(x, w, b) whose input gradient, a partial sum over the
    rank's columns, is formed in f32, summed over the model group in f32
    and rounded once (copy_to_model's sum without its extra roundings)."""

    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, w.shape[0])
        dx = dist.all_reduce_any(_mm_f32(g2, w), ctx.group)
        dx = dx.to(x.dtype).view(x.shape)
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw, g2.sum(0), None


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  shard: Optional[ModelShard]) -> torch.Tensor:
    """A column-split Linear in x's dtype (the rank's output columns and
    their bias); its input gradient summed over the model group. Without
    a split, F.linear."""
    dt = x.dtype
    if not is_split(shard):
        return F.linear(x, weight.to(dt), bias.to(dt))
    return _ColumnLinear.apply(x, weight.to(dt), bias.to(dt), shard.group)


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               shard: Optional[ModelShard]) -> torch.Tensor:
    """A row-split Linear in x's dtype: the rank's partial product in
    f32, summed over the model group, the (whole) bias added, then one
    rounding to x's dtype. Without a split, F.linear with its bias."""
    dt = x.dtype
    if not is_split(shard):
        return F.linear(x, weight.to(dt), bias.to(dt))
    part = _PartialLinear.apply(x, weight.to(dt))
    return (reduce_from_model(part, shard)
            + bias.to(dt).float()).to(dt)


def max_over_model(x: torch.Tensor, shard: Optional[ModelShard]
                   ) -> torch.Tensor:
    """The elementwise max over the model group (no gradient): every
    peer's values gathered, then their max, so all hold the same bits."""
    if not is_split(shard):
        return x
    rows = dist.all_gather_rows(x.detach().contiguous(), shard.group)
    return rows.amax(0).view(x.shape)
