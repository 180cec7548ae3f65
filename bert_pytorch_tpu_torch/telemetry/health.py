"""Numerical health of a train step (counterpart of
bert_pytorch_tpu/telemetry/health.py, trimmed to the non-finite counts and
the --nonfinite_action policy; the grad-norm spike z-score and the
param-norm drift are not ported yet).

The signals are computed on the card from the step's loss and
post-accumulation gradients. Under action "skip" the step reads the bad
flag on the host before the optimizer runs and leaves params and
optimizer state untouched when it is set, as the JAX step's in-graph
select does; "log" and "halt" are host policies applied by the entry
point when it reads the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

NONFINITE_ACTIONS = ("log", "skip", "halt")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    action: str = "log"

    def __post_init__(self):
        if self.action not in NONFINITE_ACTIONS:
            raise ValueError(f"action must be one of {NONFINITE_ACTIONS}, "
                             f"got {self.action!r}")


def _nonfinite(t: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(t)).sum().to(torch.int32)


def health_signals(loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                   grad_norm: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(metrics, bad): loss_nonfinite, grad_nonfinite_<group> per top-level
    parameter group (bert, cls_predictions, ...) and their total
    grad_nonfinite, all int32 tensors on the card; `bad` is a bool tensor,
    true when any count is nonzero or the gradient norm is not finite."""
    metrics = {"loss_nonfinite": _nonfinite(loss.float())}
    groups: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        group = name.split(".", 1)[0]
        c = _nonfinite(g)
        groups[group] = c if group not in groups else groups[group] + c
    total = torch.zeros((), dtype=torch.int32, device=loss.device)
    for group, c in groups.items():
        metrics[f"grad_nonfinite_{group}"] = c
        total = total + c
    metrics["grad_nonfinite"] = total
    bad = ((metrics["loss_nonfinite"] > 0) | (total > 0)
           | ~torch.isfinite(grad_norm))
    return metrics, bad
