"""LAMB, unfused (counterpart of bert_pytorch_tpu/optim/lamb.py, the
`fused=False` path; the fused multi-tensor kernels are a later slice).

NVLAMB semantics as the JAX package implements them:

1. the global gradient norm over every leaf, each upcast to f32 first,
   and the pre-normalisation g / max(1, ||g|| / max_grad_norm);
2. Adam moments in f32 with bias correction;
3. u = m_hat / (sqrt(v_hat) + eps) + wd * p, with wd 0 for biases and
   LayerNorm parameters (`default_weight_decay_mask`);
4. one trust ratio ||p|| / ||u|| per tensor, 1 where either norm is 0;
5. p <- p - lr * ratio * u, lr = schedule(count - 1).

The port keeps every encoder weight as its own tensor (the JAX package's
unstacked layout), so one ratio per tensor is the per-layer ratio that
`default_trust_batch_axes` gives the stacked layout. Gradients may arrive
bf16; moments and the update are computed in f32 against the f32 master
parameters, which this module updates in place (PyTorch tensors are
mutable; JAX returns new arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def default_weight_decay_mask(name: str) -> bool:
    """True for parameters that get weight decay: everything except biases
    and LayerNorm scales and biases (the reference's no_decay groups)."""
    joined = name.lower()
    if joined.endswith(".bias") or joined == "bias":
        return False
    return "layer_norm" not in joined and "layernorm" not in joined


def global_norm_f32(tensors) -> torch.Tensor:
    """L2 norm over all tensors, each upcast to f32 before its sum of
    squares (a bf16 sum of millions of squares misreports the norm)."""
    total = None
    for t in tensors:
        sq = t.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@dataclasses.dataclass
class LambState:
    count: int
    mu: Params
    nu: Params


class Lamb:
    """`update(grads, state, params)` applies one LAMB step in place to the
    f32 `params` and the moments of `state`; `learning_rate` is a float or
    a schedule step -> lr. Weight decay follows
    `default_weight_decay_mask` of each parameter's name."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Params) -> LambState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa
                         for k, p in params.items()}
        return LambState(count=0, mu=zeros(), nu=zeros())

    def lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return float(self.learning_rate)

    @torch.no_grad()
    def update(self, grads: Params, state: LambState, params: Params
               ) -> None:
        state.count += 1
        b1, b2 = self.b1, self.b2
        gnorm = global_norm_f32(grads[k] for k in params)
        denom = torch.clamp(gnorm / self.max_grad_norm, min=1.0)
        cf = np.float32(state.count)
        c1 = float(np.float32(1.0) - np.float32(b1) ** cf)
        c2 = float(np.float32(1.0) - np.float32(b2) ** cf)
        lr = self.lr(state.count - 1)
        for name, p in params.items():
            g = grads[name].float() / denom
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * g.square())
            wd = self.weight_decay if default_weight_decay_mask(name) else 0.0
            pf = p.float()
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + wd * pf
            pn = torch.linalg.vector_norm(pf)
            un = torch.linalg.vector_norm(u)
            ratio = torch.where((pn > 0) & (un > 0),
                                pn / torch.clamp(un, min=1e-30),
                                torch.ones_like(pn))
            p.add_((-lr * ratio * u).to(p.dtype))
