"""The price of a device-hour (counterpart of the cost knob of
bert_pytorch_tpu/telemetry/stepwatch.py; the step accounting itself is
not ported yet).

The serving scheduler prices its device-seconds at this rate per
device-hour. The default of 1.0 makes the cost gauges normalized
device-hours per 1k tokens, a hardware-relative number that survives
price changes; pass the real price per card-hour to quote money.
"""

from __future__ import annotations

import os
from typing import Optional

DEFAULT_COST_PER_DEVICE_HOUR = 1.0


def resolve_cost_per_device_hour(value: Optional[float] = None) -> float:
    """An explicit value, else the BERT_COST_PER_DEVICE_HOUR environment
    variable, else 1.0."""
    if value is not None:
        return float(value)
    env = os.environ.get("BERT_COST_PER_DEVICE_HOUR", "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return DEFAULT_COST_PER_DEVICE_HOUR
