"""LayerNorm and the fused residual-dropout-LayerNorm: plain versions,
kernel wrappers, autograd Functions and dispatchers.

Counterpart of bert_pytorch_tpu/ops/layernorm.py and the custom VJPs of
bert_pytorch_tpu/ops/pallas/layernorm.py. Statistics are f32 whatever the
input dtype, eps 1e-12, outputs in the input dtype; scale and bias may
arrive f32 or bf16 (the bf16 copy a bf16-gradient train step runs
against) and are upcast, which is exact.

- `layer_norm_stats_ref` / `layer_norm_bwd_ref`: plain versions of the
  LayerNorm forward and backward kernels (#1, #2); `layer_norm_ref` is the
  forward alone, differentiable by autograd (`_layer_norm_xla`).
- `row_col_keep`: the counter-hash keep mask of the JAX package, bit for
  bit, in int32 torch arithmetic.
- `add_dropout_layer_norm_stats_ref` / `add_dropout_layer_norm_bwd_ref`:
  plain versions of the fused kernels (#3, #4): y = LN(f32(residual) +
  dropout(f32(x))), the mask regenerated in the backward pass;
  `add_dropout_layer_norm_ref` is the forward alone, differentiable.
- `layer_norm_fwd`, `layer_norm_bwd`, `add_dropout_layer_norm_fwd`,
  `add_dropout_layer_norm_bwd`: the kernel wrappers. A CUDA tensor launches
  the kernel (ops/kernels/csrc/layernorm.cu) or raises; a CPU tensor takes
  the plain version.
- `layer_norm` and `add_dropout_layer_norm`: the dispatchers, autograd
  Functions whose forward and backward are the wrappers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from bert_pytorch_tpu_torch.ops.kernels import count_launch

_U32 = 0xFFFFFFFF


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def layer_norm_stats_ref(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-12
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) as the kernel returns them: y in x's dtype, mean
    and rstd f32 with one entry per row of x's (rows, E) view."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd
    y = y * scale.float() + bias.float()
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    return layer_norm_stats_ref(x, scale, bias, eps)[0]


def _ln_backward_rows(h: torch.Tensor, scale: torch.Tensor,
                      mean: torch.Tensor, rstd: torch.Tensor,
                      g: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic on f32 (rows, E) views: (dh,
    dscale, dbias), all f32 (`_bwd_kernel` / `_adln_bwd_kernel`)."""
    g = g.float()
    mean, rstd = mean[:, None], rstd[:, None]
    xhat = (h - mean) * rstd
    gs = g * scale.float()
    cols = h.shape[-1]
    m1 = gs.sum(dim=-1, keepdim=True) / cols
    m2 = (gs * xhat).sum(dim=-1, keepdim=True) / cols
    dh = rstd * (gs - m1 - xhat * m2)
    return dh, (g * xhat).sum(dim=0), g.sum(dim=0)


def layer_norm_bwd_ref(x: torch.Tensor, scale: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor,
                       g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dx in x's dtype, dscale,
    dbias f32) from the forward's f32 mean and rstd."""
    dh, dscale, dbias = _ln_backward_rows(_rows(x).float(), scale, mean,
                                          rstd, _rows(g))
    return dh.reshape(x.shape).to(x.dtype), dscale, dbias


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-12
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (y, mean, rstd). A CUDA x launches the kernel
    (contiguous bf16/f32 x, else it raises); a CPU x takes the plain
    version."""
    if not x.is_cuda:
        return layer_norm_stats_ref(x, scale, bias, eps)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    y, mean, rstd = load_kernels().layer_norm_fwd(x, _f32(scale), _f32(bias),
                                                  float(eps))
    count_launch("layer_norm_fwd")
    return y, mean, rstd


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (dx, dscale, dbias), dscale and dbias f32. A CUDA x
    launches the kernel (contiguous x and g of one dtype); a CPU x takes
    the plain version."""
    if not x.is_cuda:
        return layer_norm_bwd_ref(x, scale, mean, rstd, g)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    out = load_kernels().layer_norm_bwd(x, _f32(scale), mean, rstd, g)
    count_launch("layer_norm_bwd")
    return tuple(out)


class LayerNormFn(torch.autograd.Function):
    """LayerNorm whose forward is kernel #1 and backward kernel #2 (their
    plain versions on the CPU); saves x, scale and the f32 mean and rstd,
    as the Pallas custom VJP does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, mean, rstd,
                                           g.contiguous())
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis: the kernels for CUDA tensors, the
    plain versions for CPU tensors, differentiable either way."""
    return LayerNormFn.apply(x, scale, bias, eps)


# -- the counter-hash keep mask -----------------------------------------------


def _as_int32(v: int) -> int:
    """A uint32 bit pattern (or any int, taken mod 2^32) as the int32 of
    the same bits."""
    v &= _U32
    return v - (1 << 32) if v >= 1 << 31 else v


def _to_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def keep_threshold(rate: float) -> int:
    """The keep test's uint32 threshold, computed on the host as the JAX
    package computes it: keep iff hash > int(rate * 2^32)."""
    return int(rate * float(2 ** 32))


def row_col_keep(seed, row0: int, rows: int, cols: int, rate: float,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """(rows, cols) bool keep mask of `ops/layernorm.row_col_keep`, bit for
    bit: two multiply-xorshift rounds over (row0 + row, col) and the int32
    seed (reinterpreted as uint32), kept iff above rate * 2^32.

    torch has no uint32 arithmetic, so the hash runs in int32 with the
    same bits: multiplies wrap mod 2^32 as uint32 multiplies do, logical
    right shifts are arithmetic shifts masked to the kept bits, and the
    unsigned compare is a signed compare of both sides with the top bit
    flipped. The row and column terms are exact in int64 first, then
    folded to int32, so only two full-size multiplies run. `row0` may
    also be an int64 tensor of the `rows` rows' own indices (a model
    rank's heads are rows that are not one run of the global view)."""
    seed_term = ((int(seed) & _U32) * 0xC2B2AE3D) & _U32
    if torch.is_tensor(row0):
        r = row0.to(device=device, dtype=torch.int64).reshape(-1)
        if r.numel() != rows:
            raise ValueError(f"{r.numel()} row indices for {rows} rows")
    else:
        r = torch.arange(rows, dtype=torch.int64, device=device) + int(row0)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    r_term = _to_int32(((r & _U32) * 0x9E3779B1 & _U32) ^ seed_term)
    c_term = _to_int32((c * 0x85EBCA77) & _U32)
    h = r_term[:, None] ^ c_term[None, :]
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * _as_int32(0x7FEB352D)
    h = h ^ ((h >> 15) & 0x1FFFF)
    h = h * _as_int32(0x846CA68B)
    flip = _as_int32(1 << 31)
    return (h ^ flip) > _as_int32(keep_threshold(rate) ^ (1 << 31))


def hash_keep_mask(seed, shape: Sequence[int], rate: float,
                   device: Optional[torch.device] = None,
                   row0: int = 0) -> torch.Tensor:
    """row_col_keep over the flattened (R, E) view of `shape`, reshaped
    (`_hash_keep_mask`); `row0`: the view's first row in a larger array
    (a data-parallel rank's rows of the global batch), or a tensor of
    each row's index there."""
    rows = 1
    for s in shape[:-1]:
        rows *= s
    return row_col_keep(seed, row0, rows, shape[-1], rate,
                        device).reshape(shape)


# The fused residual-dropout-LayerNorm's per-shard seed fold of the JAX
# package (ops/layernorm._adln_sharded): shard i of a data-parallel mesh
# adds i * 0x3C6EF35F to the site's seed, with int32 wrap.
ADLN_SHARD_FOLD = 0x3C6EF35F


def adln_shard_seed(seed, shard: int) -> int:
    """The int32 seed data-parallel shard `shard` hands the fused
    residual-dropout-LayerNorm: `seed` itself on shard 0."""
    return _as_int32(int(seed) + int(shard) * ADLN_SHARD_FOLD)


# -- the fused residual-dropout-LayerNorm -------------------------------------


def _dropped(x32: torch.Tensor, seed, rate: float
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dropout(x32) in f32, keep mask or None at rate 0): kept values
    divided by f32(1 - rate), as the kernels divide."""
    if rate <= 0.0:
        return x32, None
    keep = hash_keep_mask(seed, x32.shape, rate, x32.device)
    return torch.where(keep, x32 / (1.0 - rate), torch.zeros_like(x32)), keep


def add_dropout_layer_norm_stats_ref(
        x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor, seed, rate: float, eps: float = 1e-12
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused forward kernel: (y in x's dtype, mean,
    rstd) of LN(f32(residual) + dropout(f32(x)))."""
    xd, _ = _dropped(x.float(), seed, rate)
    y, mean, rstd = layer_norm_stats_ref(residual.float() + xd, scale, bias,
                                         eps)
    return y.to(x.dtype), mean, rstd


def add_dropout_layer_norm_ref(x, residual, scale, bias, seed, rate: float,
                               eps: float = 1e-12) -> torch.Tensor:
    return add_dropout_layer_norm_stats_ref(x, residual, scale, bias, seed,
                                            rate, eps)[0]


def add_dropout_layer_norm_bwd_ref(
        x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
        mean: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor, seed,
        rate: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused backward kernel: (dx, dres in x's dtype,
    dscale, dbias f32), the mask regenerated from the seed."""
    xd, keep = _dropped(_rows(x).float(), seed, rate)
    h = _rows(residual).float() + xd
    dh, dscale, dbias = _ln_backward_rows(h, scale, mean, rstd, _rows(g))
    dx = dh if keep is None else torch.where(keep, dh / (1.0 - rate),
                                             torch.zeros_like(dh))
    return (dx.reshape(x.shape).to(x.dtype), dh.reshape(x.shape).to(x.dtype),
            dscale, dbias)


def _seed32(seed) -> int:
    return _as_int32(int(seed))


def add_dropout_layer_norm_fwd(x, residual, scale, bias, seed, rate: float,
                               eps: float = 1e-12):
    """Kernel wrapper: (y, mean, rstd). CUDA tensors launch the kernel
    (contiguous x and residual of one dtype); CPU tensors take the plain
    version. `seed` is an int32 (a Python int or a one-element tensor on
    the host)."""
    if not x.is_cuda:
        return add_dropout_layer_norm_stats_ref(x, residual, scale, bias,
                                                seed, rate, eps)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    out = load_kernels().add_dropout_layer_norm_fwd(
        x, residual, _f32(scale), _f32(bias), _seed32(seed),
        keep_threshold(rate), 1.0 - rate, rate > 0.0, float(eps))
    count_launch("add_dropout_layer_norm_fwd")
    return tuple(out)


def add_dropout_layer_norm_bwd(x, residual, scale, mean, rstd, g, seed,
                               rate: float):
    """Kernel wrapper: (dx, dres, dscale, dbias), dscale and dbias f32.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return add_dropout_layer_norm_bwd_ref(x, residual, scale, mean, rstd,
                                              g, seed, rate)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    out = load_kernels().add_dropout_layer_norm_bwd(
        x, residual, _f32(scale), mean, rstd, g, _seed32(seed),
        keep_threshold(rate), 1.0 - rate, rate > 0.0)
    count_launch("add_dropout_layer_norm_bwd")
    return tuple(out)


class AddDropoutLayerNormFn(torch.autograd.Function):
    """LN(residual + dropout(x)) whose forward is kernel #3 and backward
    kernel #4 (their plain versions on the CPU). Saves x, residual, scale,
    mean and rstd: no mask, no dropped tensor, no LN input."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, seed, rate, eps):
        y, mean, rstd = add_dropout_layer_norm_fwd(x, residual, scale, bias,
                                                   seed, rate, eps)
        ctx.save_for_backward(x, residual, scale, mean, rstd)
        ctx.seed, ctx.rate, ctx.bias_dtype = seed, rate, bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, residual, scale, mean, rstd = ctx.saved_tensors
        dx, dres, dscale, dbias = add_dropout_layer_norm_bwd(
            x, residual, scale, mean, rstd, g.contiguous(), ctx.seed,
            ctx.rate)
        return (dx, dres.to(residual.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None, None)


def add_dropout_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor, seed,
                           rate: float, eps: float = 1e-12) -> torch.Tensor:
    """y = LayerNorm(residual + dropout(x, rate)), the residual tail of
    every BertLayer in training, as one op: the mask is the counter hash
    of (flat row, column, seed), evaluated forward and backward and never
    stored. `seed` is an int32, fresh per call site per micro-step."""
    return AddDropoutLayerNormFn.apply(x, residual, scale, bias, _seed32(seed),
                                       float(rate), eps)
