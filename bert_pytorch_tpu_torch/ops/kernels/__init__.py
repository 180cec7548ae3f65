"""Hand-written Hopper kernels of the port and their launch counts.

`LAUNCHES` counts, per kernel, the launches its wrapper made since the
last `reset_launches()`: a wrapper adds one right after it launched its
kernel and nowhere else, so a run can show that its path went through the
kernels (chip_smoke.py reads it around the serving run).
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"layer_norm_fwd": 0, "flash_attention_fwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1
