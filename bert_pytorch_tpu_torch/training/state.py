"""Train state (counterpart of bert_pytorch_tpu/training/state.py,
trimmed): the global step, the f32 master parameters and the LAMB state.

`params` are the model's own parameter tensors (detached views of them),
so the model and the state always hold the same weights; the step updates
them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from bert_pytorch_tpu_torch.optim.lamb import Lamb, LambState


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: LambState


def make_train_state(model: nn.Module, tx: Lamb) -> TrainState:
    """A fresh state over `model`'s parameters, which must be f32."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    bad = [k for k, p in params.items() if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"master parameters must be float32: {bad[:3]}")
    return TrainState(step=0, params=params, opt_state=tx.init(params))
