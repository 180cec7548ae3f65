"""Activation functions (counterpart of bert_pytorch_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, not the tanh approximation."""
    return F.gelu(x, approximate="none")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


# the JAX model applies its bias before the activation either way, so
# "bias_gelu" is gelu here
ACT2FN = {"gelu": gelu, "bias_gelu": gelu, "relu": relu, "swish": swish,
          "tanh": tanh}
