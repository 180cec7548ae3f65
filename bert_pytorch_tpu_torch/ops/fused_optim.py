"""Fused multi-tensor LAMB stages: plain versions, the chunk table and the
kernel wrappers (counterpart of bert_pytorch_tpu/ops/pallas/fused_optim.py).

- `stage1_math`: the one math body of stage 1 (`_stage1_math`), per tensor:
  gn = g / denom; mu = b1 mu + (1 - b1) gn; nu = b2 nu + (1 - b2) gn^2;
  u = (mu / c1) / (sqrt(nu / c2) + eps) + wd p. Every operation is its own
  PyTorch op, so each rounds once.
- `lamb_stage1_ref` / `lamb_stage2_ref`: the plain versions over aligned
  tensor lists; stage 2 is out = t * u per tensor, or p += t * u with `p`.
- `chunk_table`: the (tensor, start) rows the kernels take one CTA each.
- `lamb_stage1` / `lamb_stage2`: the kernel wrappers. On CUDA tensors they
  launch the kernels of ops/kernels/csrc/fused_optim.cu (one launch per
  stage over every tensor) or raise; on CPU tensors they run the plain
  versions.

The JAX package's stage 1 takes f32 gradients and parameters and returns
new moments; here mu and nu are updated in place and gradients may be bf16
(upcast exactly). denom is a 0-d f32 tensor on the tensors' device; c1 and
c2 are Python floats holding f32 values, which the plain version turns
into 0-d tensors on that device so that the divisions by them are true
divisions on the card too (PyTorch's CUDA division by a Python float
multiplies by its reciprocal), as they are in the kernel and in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch.ops.kernels import count_launch

# elements per CTA of the kernels (a multiple of 4: 16-byte vectors)
CHUNK = 16384

Tensors = Sequence[torch.Tensor]


def stage1_math(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                p: torch.Tensor, wd: float, denom: torch.Tensor,
                c1: torch.Tensor, c2: torch.Tensor, b1: float, b2: float,
                eps: float) -> torch.Tensor:
    """Stage 1 of one tensor: updates mu and nu in place, returns u."""
    gn = g.float() / denom
    mu.copy_(b1 * mu + (1 - b1) * gn)
    nu.copy_(b2 * nu + (1 - b2) * gn.square())
    return (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * p


def bias_corrections(c1: float, c2: float, device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """c1 and c2 as 0-d f32 tensors on `device` (a fill each, no copy
    from the host and so no wait for the card)."""
    return (torch.full((), c1, dtype=torch.float32, device=device),
            torch.full((), c2, dtype=torch.float32, device=device))


def lamb_stage1_ref(g: Tensors, mu: Tensors, nu: Tensors, p: Tensors,
                    wd: Sequence[float], denom: torch.Tensor, c1: float,
                    c2: float, b1: float, b2: float, eps: float
                    ) -> List[torch.Tensor]:
    """Plain stage 1 over aligned lists: mu and nu updated in place, the
    list of u returned."""
    c1t, c2t = bias_corrections(c1, c2, denom.device)
    return [stage1_math(*args, denom, c1t, c2t, b1, b2, eps)
            for args in zip(g, mu, nu, p, wd)]


def lamb_stage2_ref(t: torch.Tensor, u: Tensors,
                    p: Optional[Tensors] = None
                    ) -> Optional[List[torch.Tensor]]:
    """Plain stage 2: t is one f32 value per tensor. Without `p` returns
    [t_i * u_i]; with `p` adds t_i * u_i to each p_i in place (the product
    rounded first) and returns None."""
    if p is None:
        return [t[i] * x for i, x in enumerate(u)]
    for i, (x, pi) in enumerate(zip(u, p)):
        pi.add_(t[i] * x)
    return None


def chunk_table(sizes: Sequence[int], chunk: int = CHUNK) -> torch.Tensor:
    """(C, 2) int64 CPU tensor of (tensor index, start) rows: every tensor
    cut into chunks of `chunk` elements, its last chunk shorter; empty
    tensors have none."""
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"chunk must be a positive multiple of 4, got "
                         f"{chunk}")
    counts = [-(-int(n) // chunk) for n in sizes]
    idx = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    first = np.repeat(np.cumsum([0] + counts[:-1]), counts)
    starts = (np.arange(len(idx), dtype=np.int64) - first) * chunk
    return torch.from_numpy(np.stack([idx, starts], axis=1)
                            .reshape(-1, 2).astype(np.int64))


def _aligned_like(tensors: Tensors) -> List[torch.Tensor]:
    """f32 tensors shaped like `tensors`: views of one buffer, each
    starting on a 16-byte boundary (one allocation for the whole list)."""
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-t.numel() // 4) * 4
    flat = torch.empty(total, dtype=torch.float32, device=tensors[0].device)
    return [flat[o:o + t.numel()].view(t.shape)
            for o, t in zip(offsets, tensors)]


def lamb_stage1(g: Tensors, mu: Tensors, nu: Tensors, p: Tensors,
                wd: Sequence[float], denom: torch.Tensor, c1: float,
                c2: float, b1: float, b2: float, eps: float
                ) -> List[torch.Tensor]:
    """Kernel wrapper of stage 1: mu and nu updated in place, the list of
    u returned. CUDA tensors launch the kernel (contiguous f32 mu, nu, p;
    contiguous f32 or bf16 g of one dtype; else it raises); CPU tensors
    take the plain version."""
    if not g[0].is_cuda:
        return lamb_stage1_ref(g, mu, nu, p, wd, denom, c1, c2, b1, b2, eps)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    u = _aligned_like(g)
    chunks = chunk_table([t.numel() for t in g])
    load_kernels().lamb_stage1(
        list(g), list(mu), list(nu), list(p), u, [float(w) for w in wd],
        denom, chunks, CHUNK, float(c1), float(c2), float(b1), float(b2),
        float(eps))
    if len(chunks):
        count_launch("lamb_stage1")
    return u


def lamb_stage2(t: torch.Tensor, u: Tensors, p: Optional[Tensors] = None
                ) -> Optional[List[torch.Tensor]]:
    """Kernel wrapper of stage 2 (see lamb_stage2_ref). CUDA tensors
    launch the kernel (contiguous f32 u and p, t one f32 per tensor; else
    it raises); CPU tensors take the plain version."""
    if not u[0].is_cuda:
        return lamb_stage2_ref(t, u, p)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    out = list(p) if p is not None else _aligned_like(u)
    chunks = chunk_table([x.numel() for x in u])
    load_kernels().lamb_stage2(t, list(u), out, chunks, CHUNK, p is not None)
    if len(chunks):
        count_launch("lamb_stage2")
    return None if p is not None else out
