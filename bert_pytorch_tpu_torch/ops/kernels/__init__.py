"""Hand-written Hopper kernels of the port and their launch counts.

`LAUNCHES` counts, per kernel, the launches its wrapper made since the
last `reset_launches()`: a wrapper adds one right after it launched its
kernel and nowhere else, so a run can show that its path went through the
kernels (chip_smoke.py reads it around the serving and the training
run). A backward that takes two launches (the row pass and the column
sum of its cross-row reductions) counts once.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "layer_norm_fwd": 0, "layer_norm_bwd": 0,
    "add_dropout_layer_norm_fwd": 0, "add_dropout_layer_norm_bwd": 0,
    "flash_attention_fwd": 0, "flash_attention_bwd": 0,
    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
    "lamb_stage1": 0, "lamb_stage2": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1
