"""Adam for finetuning (counterpart of bert_pytorch_tpu/optim/adam.py:
`fused_adam`, chained after optax.clip_by_global_norm as the SQuAD and
NER tasks chain it, and `bert_adam`, BertAdam, which no recipe selects).

apex-FusedAdam semantics as the JAX package implements them:

1. (optional) the global-norm clip: every gradient t becomes
   t * max_norm / max(||g||, max_norm) in f32 (optax's
   `select(norm < max_norm, t, t / norm * max_norm)`, up to rounding);
2. mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, f32;
3. u = (mu / c1) / (sqrt(nu / c2) + eps) + wd p, with c1 = 1 - b1^count
   and c2 = 1 - b2^count under `bias_correction`, else 1 (the SQuAD and
   NER recipes: no bias correction); wd 0 for biases and LayerNorm
   parameters (`lamb.default_weight_decay_mask`);
4. p <- p - lr u, lr = schedule(count - 1).

The update runs as in-place `torch._foreach_*` calls over the tensor
list, with one f32 temporary (the denominator); the decayed group takes
its `- lr wd p` first. The JAX package has no Pallas
site for Adam (XLA fuses its tree maps), so there is no hand-written
kernel here; a multi-tensor kernel is queued in ROADMAP B.2. A parameter
the loss does not reach (the pooler, which BERT-Large's config builds and
neither task head calls) arrives with a zero gradient: its moments stay 0
and it moves by weight decay alone, as in JAX.

The state keeps one mu and one nu tensor per parameter name and a count,
the layout `TrainState.state_dict()` saves for LAMB too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from bert_pytorch_tpu_torch.optim.lamb import (default_weight_decay_mask,
                                               global_norm_f32)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Params
    nu: Params


def clip_by_global_norm_(grads: List[torch.Tensor], grad_norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm on f32 gradients, in place, given their
    global norm (the step computes it once): every t is multiplied by
    max_norm / max(norm, max_norm), computed in f32 on the device (exactly
    1 under the norm, so no host sync decides whether to clip)."""
    norm = grad_norm.float()
    limit = torch.full_like(norm, max_norm)
    torch._foreach_mul_(grads, limit / torch.maximum(norm, limit))


class FusedAdam:
    """`update(grads, state, params, grad_norm=)` applies one step in place
    to the f32 `params` and the moments of `state`, the interface `Lamb`
    has. `learning_rate` is a float or a schedule step -> lr;
    `max_grad_norm` (None or <= 0: off) is the clip that runs first."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = False,
                 max_grad_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.max_grad_norm = (max_grad_norm if max_grad_norm
                              and max_grad_norm > 0 else None)

    def init(self, params: Params) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa
                         for k, p in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    def lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return float(self.learning_rate)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """`grad_norm`: global_norm_f32 of `grads`, when the caller has it
        already (the train step does); computed here otherwise. The clip
        scales f32 `grads` in place (the step's own gradients; other
        dtypes are converted to f32 copies first)."""
        state.count += 1
        names = list(params)
        g = [grads[k].float() for k in names]
        if self.max_grad_norm is not None:
            if grad_norm is None:
                grad_norm = global_norm_f32(g)
            clip_by_global_norm_(g, grad_norm, self.max_grad_norm)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=float(np.float32(1.0 - self.b1)))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g,
                                value=float(np.float32(1.0 - self.b2)))
        del g
        lr = self.lr(state.count - 1)
        p = [params[k] for k in names]
        decay = [params[k] for k in names
                 if self.weight_decay and default_weight_decay_mask(k)]
        if decay:
            # wd p is part of u, so it is taken before p moves
            torch._foreach_add_(decay, decay, alpha=-lr * self.weight_decay)
        if self.bias_correction:
            cf = np.float32(state.count)
            c1 = float(np.float32(1.0) - np.float32(self.b1) ** cf)
            c2 = float(np.float32(1.0) - np.float32(self.b2) ** cf)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
        else:
            c1 = 1.0
            denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(p, mu, denom, value=-lr / c1)


class BertAdam:
    """The reference's BertAdam (counterpart of the JAX package's
    `bert_adam`): Adam without bias correction, u = mu / (sqrt(nu) + eps)
    + wd p, p <- p - lr u with lr = schedule(count - 1), after a
    global-norm clip that divides every gradient by max(1, ||g|| /
    max_norm). `weight_decay_mask(name) -> bool` picks the decayed
    parameters (None: all of them, as in JAX). No finetune recipe selects
    it and the JAX package has no kernel for it: plain torch ops. The
    interface and the state are FusedAdam's."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 weight_decay_mask: Optional[Callable[[str], bool]] = None,
                 max_grad_norm: Optional[float] = 1.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.weight_decay_mask = weight_decay_mask
        self.max_grad_norm = max_grad_norm

    init = FusedAdam.init
    lr = FusedAdam.lr

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        names = list(params)
        g = [grads[k].float() for k in names]
        if self.max_grad_norm is not None:
            norm = global_norm_f32(g) if grad_norm is None else grad_norm
            denom = torch.clamp_min(norm.float() / self.max_grad_norm, 1.0)
            g = [t / denom for t in g]
        state.count += 1
        lr = self.lr(state.count - 1)
        for k, gk in zip(names, g):
            mu, nu, p = state.mu[k], state.nu[k], params[k]
            mu.mul_(self.b1).add_((1 - self.b1) * gk)
            nu.mul_(self.b2).add_((1 - self.b2) * gk * gk)
            wd = (self.weight_decay if self.weight_decay_mask is None
                  or self.weight_decay_mask(k) else 0.0)
            p.add_(-lr * (mu / (torch.sqrt(nu) + self.eps) + wd * p))


# the JAX package's name for it
bert_adam = BertAdam
