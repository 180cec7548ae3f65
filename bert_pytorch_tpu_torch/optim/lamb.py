"""LAMB (counterpart of bert_pytorch_tpu/optim/lamb.py), on two routes.

NVLAMB semantics as the JAX package implements them:

1. the global gradient norm over every leaf, each upcast to f32 first,
   and the pre-normalisation g / max(1, ||g|| / max_grad_norm);
2. Adam moments in f32 with bias correction;
3. u = m_hat / (sqrt(v_hat) + eps) + wd * p, with wd 0 for biases and
   LayerNorm parameters (`default_weight_decay_mask`);
4. one trust ratio ||p|| / ||u|| per tensor, 1 where either norm is 0;
5. p <- p - lr * ratio * u, lr = schedule(count - 1).

`fused` mirrors the JAX package's --fused_optim (`lamb(fused=...)`):
"off" and "xla" run the five steps tensor by tensor with the plain
stage-1 math of ops/fused_optim.py (one tensor's temporaries alive at a
time); "auto" and "pallas" run them as stages over the whole list
through the wrappers (stage 1 over every tensor, the trust norms, the
ratios, stage 2), which launch the fused multi-tensor kernels on CUDA
tensors (one launch per stage) and take the plain versions on CPU
tensors, giving the same bits as "off" there. Both routes compute the
trust norms with one function (`trust_norms`) and keep one mu and one nu
tensor per parameter name, so a state written under one route resumes
under the other.

The port keeps every encoder weight as its own tensor (the JAX package's
unstacked layout), so one ratio per tensor is the per-layer ratio that
`default_trust_batch_axes` gives the stacked layout. Gradients may arrive
bf16; moments and the update are computed in f32 against the f32 master
parameters, which this module updates in place (PyTorch tensors are
mutable; JAX returns new arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bert_pytorch_tpu_torch.ops import fused_optim

Params = Dict[str, torch.Tensor]
FUSED_CHOICES = ("off", "auto", "xla", "pallas")


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


def trust_norms(ps: Sequence[torch.Tensor], us: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(||p_i||, ||u_i||) as two f32 vectors of one entry per tensor: the
    trust norms of both routes (the JAX package keeps them outside its
    kernels too)."""
    return (torch.stack(torch._foreach_norm(list(ps))),
            torch.stack(torch._foreach_norm(list(us))))


def trust_ratio_t(pn: torch.Tensor, un: torch.Tensor, lr: float
                  ) -> torch.Tensor:
    """t = -lr * ratio per tensor, ratio = ||p|| / ||u|| or 1 where either
    norm is 0."""
    ratio = torch.where((pn > 0) & (un > 0),
                        pn / torch.clamp(un, min=1e-30), torch.ones_like(pn))
    return -lr * ratio


@dataclasses.dataclass
class LambState:
    count: int
    mu: Params
    nu: Params


class Lamb:
    """`update(grads, state, params)` applies one LAMB step in place to the
    f32 `params` and the moments of `state`; `learning_rate` is a float or
    a schedule step -> lr. Weight decay follows
    `default_weight_decay_mask` of each parameter's name; `fused` is the
    route (FUSED_CHOICES, see the module docstring)."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 fused: str = "off"):
        if fused not in FUSED_CHOICES:
            raise ValueError(f"fused must be one of {FUSED_CHOICES}, got "
                             f"{fused!r}")
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.fused = fused

    def init(self, params: Params) -> LambState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa
                         for k, p in params.items()}
        return LambState(count=0, mu=zeros(), nu=zeros())

    def lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return float(self.learning_rate)

    @torch.no_grad()
    def update(self, grads: Params, state: LambState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """`grad_norm`: global_norm_f32 of `grads`, when the caller has it
        already (the train step does); computed here otherwise."""
        state.count += 1
        names = list(params)
        if grad_norm is None:
            grad_norm = global_norm_f32(grads[k] for k in names)
        denom = torch.clamp(grad_norm / self.max_grad_norm, min=1.0)
        cf = np.float32(state.count)
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** cf)
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** cf)
        lr = self.lr(state.count - 1)
        wd = [self.weight_decay if default_weight_decay_mask(k) else 0.0
              for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        p = [params[k] for k in names]
        if self.fused in ("off", "xla"):
            c1t, c2t = fused_optim.bias_corrections(c1, c2, denom.device)
            for args in zip(g, mu, nu, p, wd):
                u = fused_optim.stage1_math(*args, denom, c1t, c2t, self.b1,
                                            self.b2, self.eps)
                pi = args[3]
                t = trust_ratio_t(*trust_norms([pi], [u]), lr)
                pi.add_(t[0] * u)
            return
        u = fused_optim.lamb_stage1(g, mu, nu, p, wd, denom, c1, c2,
                                    self.b1, self.b2, self.eps)
        fused_optim.lamb_stage2(trust_ratio_t(*trust_norms(p, u), lr), u, p)
