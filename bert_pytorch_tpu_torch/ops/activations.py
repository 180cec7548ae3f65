"""Activation functions (counterpart of bert_pytorch_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, not the tanh approximation."""
    return F.gelu(x, approximate="none")


# the JAX model applies its bias before the activation either way, so
# "bias_gelu" is gelu here
ACT2FN = {"gelu": gelu, "bias_gelu": gelu}
