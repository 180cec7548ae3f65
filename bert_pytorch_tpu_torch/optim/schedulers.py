"""Warmup + decay learning-rate schedules (counterpart of
bert_pytorch_tpu/optim/schedulers.py).

A schedule is a function step -> learning rate, evaluated on the host in
float32 as the JAX package evaluates it on the device. `offset` makes a
phase-2 run see phase-local steps (pass the previous phase's end step).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def _phase(step: int, total_steps: int, warmup: float, offset: int
           ) -> Tuple[np.float32, np.float32, float]:
    s = _f32(max(step - offset, 0))
    progress = s / _f32(max(total_steps, 1))
    return s, progress, warmup * total_steps


def _warm(s: np.float32, warmup_steps: float) -> np.float32:
    if warmup_steps > 0:
        return s / _f32(max(warmup_steps, 1e-9))
    return _f32(1.0)


def _clip01(p: np.float32) -> np.float32:
    return min(max(p, _f32(0.0)), _f32(1.0))


def poly_warmup_schedule(base_lr: float, total_steps: int,
                         warmup: float = 0.01, degree: float = 0.5,
                         offset: int = 0) -> Schedule:
    """Linear warmup, then polynomial decay (1 - progress) ** degree."""

    def schedule(step: int) -> float:
        s, progress, warmup_steps = _phase(step, total_steps, warmup, offset)
        decay = (_f32(1.0) - _clip01(progress)) ** _f32(degree)
        value = _warm(s, warmup_steps) if progress < _f32(warmup) else decay
        return float(_f32(base_lr) * value)

    return schedule


def linear_warmup_schedule(base_lr: float, total_steps: int,
                           warmup: float = 0.01, offset: int = 0) -> Schedule:
    """Linear warmup, then linear decay to 0."""

    def schedule(step: int) -> float:
        s, progress, warmup_steps = _phase(step, total_steps, warmup, offset)
        decay = max(_f32(1.0) - _clip01(progress), _f32(0.0))
        value = _warm(s, warmup_steps) if progress < _f32(warmup) else decay
        return float(_f32(base_lr) * value)

    return schedule


def cosine_warmup_schedule(base_lr: float, total_steps: int,
                           warmup: float = 0.01, offset: int = 0) -> Schedule:
    """Linear warmup, then 0.5 * (1 + cos(pi * progress)) decay."""

    def schedule(step: int) -> float:
        s, progress, warmup_steps = _phase(step, total_steps, warmup, offset)
        decay = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi)
                                                * _clip01(progress)))
        value = _warm(s, warmup_steps) if progress < _f32(warmup) else decay
        return float(_f32(base_lr) * value)

    return schedule


def constant_warmup_schedule(base_lr: float, total_steps: int,
                             warmup: float = 0.01, offset: int = 0
                             ) -> Schedule:
    """Linear warmup, then constant."""

    def schedule(step: int) -> float:
        s, progress, warmup_steps = _phase(step, total_steps, warmup, offset)
        value = _warm(s, warmup_steps) if progress < _f32(warmup) else 1.0
        return float(_f32(base_lr) * _f32(value))

    return schedule


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "poly": poly_warmup_schedule,
    "linear": linear_warmup_schedule,
    "cosine": cosine_warmup_schedule,
    "constant": constant_warmup_schedule,
}


def make_schedule(name: str, base_lr: float, total_steps: int,
                  warmup: float = 0.01, offset: int = 0) -> Schedule:
    """The schedule keyed by the entry points' --lr_decay value."""
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule '{name}'; choose from "
                         f"{sorted(SCHEDULES)}")
    return SCHEDULES[name](base_lr, total_steps, warmup=warmup, offset=offset)
