"""Numerical health of a train step (counterpart of
bert_pytorch_tpu/telemetry/health.py).

The signals are computed on the card from the step's loss and
post-accumulation gradients, and returned through the step's metrics:

- non-finite element counts of the loss and of each top-level parameter
  group's gradients (`health_signals`);
- a gradient-norm EMA with a bias-corrected variance and a z-score spike
  flag, gated to 0 until `warmup_steps` good steps were seen, and the
  global parameter norm after the update with its relative drift
  (`health_update`).

The EMA carry (`TelemetryState`: a count and three f32 scalars on the
step's device) rides on TrainState.telemetry. It is attached after a
restore and never saved (TrainState.state_dict leaves it out), so a
checkpoint's structure is the same with the pack on or off; a few
warmup steps rebuild it after a resume.

Under action "skip" the step reads the bad flag on the host before the
optimizer runs and leaves params and optimizer state untouched when it
is set, as the JAX step's in-graph select does; "log" and "halt" are
host policies applied by the entry point when it reads the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

NONFINITE_ACTIONS = ("log", "skip", "halt")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    action: str = "log"
    ema_decay: float = 0.98
    spike_z: float = 6.0
    warmup_steps: int = 10

    def __post_init__(self):
        if self.action not in NONFINITE_ACTIONS:
            raise ValueError(f"action must be one of {NONFINITE_ACTIONS}, "
                             f"got {self.action!r}")


@dataclasses.dataclass
class TelemetryState:
    """The health pack's carry: `count` good steps folded into the EMAs
    (a bad step does not update them, so one NaN cannot poison the spike
    detector), the grad-norm EMA and variance, the last parameter norm."""
    count: torch.Tensor           # int32 scalar
    grad_norm_ema: torch.Tensor   # f32 scalars below
    grad_norm_var: torch.Tensor
    param_norm_prev: torch.Tensor


def init_telemetry_state(device=None) -> TelemetryState:
    return TelemetryState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        grad_norm_ema=torch.zeros((), dtype=torch.float32, device=device),
        grad_norm_var=torch.zeros((), dtype=torch.float32, device=device),
        param_norm_prev=torch.zeros((), dtype=torch.float32, device=device))


def _nonfinite(t: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(t)).sum().to(torch.int32)


def health_signals(loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                   grad_norm: torch.Tensor,
                   names: Optional[Iterable[str]] = None,
                   reduce: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(metrics, bad): loss_nonfinite, grad_nonfinite_<group> per top-level
    parameter group (bert, cls_predictions, ...) and their total
    grad_nonfinite, all int32 tensors on the card; `bad` is a bool tensor,
    true when any count is nonzero or the gradient norm is not finite.

    Under ZeRO-1 `grads` are this rank's pieces (keys "<name>@<start>"):
    `names`, every parameter's name, fixes the groups on every rank, and
    `reduce` sums the (groups,) counts over the ranks, so the counts are
    the whole gradient's."""
    metrics = {"loss_nonfinite": _nonfinite(loss.float())}
    groups: Dict[str, torch.Tensor] = {}
    if names is not None:
        zero = torch.zeros((), dtype=torch.int32, device=loss.device)
        groups = {n.split(".", 1)[0]: zero for n in names}
    for name, g in grads.items():
        group = name.split(".", 1)[0]
        c = _nonfinite(g)
        groups[group] = c if group not in groups else groups[group] + c
    if reduce is not None:
        summed = reduce(torch.stack(list(groups.values())))
        groups = dict(zip(groups, summed.unbind(0)))
    total = torch.zeros((), dtype=torch.int32, device=loss.device)
    for group, c in groups.items():
        metrics[f"grad_nonfinite_{group}"] = c
        total = total + c
    metrics["grad_nonfinite"] = total
    bad = ((metrics["loss_nonfinite"] > 0) | (total > 0)
           | ~torch.isfinite(grad_norm))
    return metrics, bad


def health_update(cfg: HealthConfig, telem: Optional[TelemetryState],
                  grad_norm: torch.Tensor, bad: torch.Tensor,
                  params_after: Iterable[torch.Tensor],
                  param_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[TelemetryState, Dict[str, torch.Tensor]]:
    """Fold this step into the carry; returns (new carry, metrics:
    grad_norm_ema, grad_norm_z, grad_spike, param_norm, param_norm_drift).

    The z-score is taken against the pre-update EMA, gated to 0 until
    `warmup_steps` good steps, and the variance EMA is bias-corrected
    (it starts at 0, so after k updates only 1 - d^k of it has
    accumulated). Every update is selected on `bad`, so a non-finite norm
    never enters the EMAs. The parameter norm is the global f32 norm of
    `params_after` (optim/lamb.global_norm_f32), or `param_norm` when the
    caller has it (under ZeRO-1, summed over the ranks' pieces)."""
    from bert_pytorch_tpu_torch.optim.lamb import global_norm_f32

    if telem is None:
        telem = init_telemetry_state(grad_norm.device)
    f32 = torch.float32
    good = ~bad
    zero = torch.zeros((), dtype=f32, device=grad_norm.device)
    gn = torch.where(good, grad_norm.to(f32), zero)
    d = torch.tensor(cfg.ema_decay, dtype=f32, device=grad_norm.device)
    first = telem.count == 0
    warm = telem.count >= cfg.warmup_steps

    var_updates = torch.clamp(telem.count - 1, min=1).to(f32)
    var_hat = telem.grad_norm_var / torch.clamp(1.0 - d ** var_updates,
                                                min=1e-6)
    z = torch.where(warm & good,
                    (gn - telem.grad_norm_ema) / torch.sqrt(var_hat + 1e-12),
                    zero)
    spike = (z > cfg.spike_z).to(torch.int32)

    ema = torch.where(first, gn, d * telem.grad_norm_ema + (1 - d) * gn)
    var = torch.where(first, zero,
                      d * telem.grad_norm_var + (1 - d) * (gn - ema) ** 2)
    new_ema = torch.where(good, ema, telem.grad_norm_ema)
    new_var = torch.where(good, var, telem.grad_norm_var)

    pn = (param_norm if param_norm is not None
          else global_norm_f32(params_after))
    drift = torch.where(telem.param_norm_prev > 0,
                        (pn - telem.param_norm_prev)
                        / torch.clamp(telem.param_norm_prev, min=1e-12),
                        zero)
    new = TelemetryState(count=telem.count + good.to(torch.int32),
                         grad_norm_ema=new_ema, grad_norm_var=new_var,
                         param_norm_prev=pn)
    return new, {"grad_norm_ema": new_ema, "grad_norm_z": z,
                 "grad_spike": spike, "param_norm": pn,
                 "param_norm_drift": drift}


# metric keys that training/pretrain.chain_steps max-accumulates over the
# steps of a --steps_per_loop chunk: the host reads the last inner step's
# metrics, and a flag raised by any inner step must survive to that read
STICKY_METRIC_KEYS = ("loss_nonfinite", "grad_nonfinite", "grad_spike",
                      "skipped_nonfinite", "mlm_dropped")


def is_sticky_metric(key: str) -> bool:
    """True for the metrics chain_steps max-accumulates: the fixed set and
    the per-group counts (grad_nonfinite_bert, ...), so a chunk localizes
    a blowup to the group a single step would."""
    return key in STICKY_METRIC_KEYS or key.startswith("grad_nonfinite_")
