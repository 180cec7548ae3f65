"""LayerNorm: the plain version, the kernel wrapper and the dispatcher.

Counterpart of bert_pytorch_tpu/ops/layernorm.py. `layer_norm_ref` is
`_layer_norm_xla`: statistics in f32 whatever the input dtype, eps 1e-12,
the output cast back to the input dtype. `layer_norm_fwd` is the wrapper of
the CUDA kernel that replaces the Pallas `layer_norm_pallas` forward
(ops/kernels/csrc/layernorm.cu); `layer_norm` sends CUDA tensors to it and
CPU tensors to the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bert_pytorch_tpu_torch.ops.kernels import count_launch


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


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-12
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (y, mean, rstd). A CUDA x launches the kernel
    (contiguous bf16/f32 x, f32 scale and bias, else it raises); a CPU x
    takes the plain version."""
    if not x.is_cuda:
        return layer_norm_stats_ref(x, scale, bias, eps)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    y, mean, rstd = load_kernels().layer_norm_fwd(x, scale, bias, float(eps))
    count_launch("layer_norm_fwd")
    return y, mean, rstd


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return layer_norm_fwd(x, scale, bias, eps)[0]
    return layer_norm_ref(x, scale, bias, eps)
