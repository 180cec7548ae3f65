"""Hand-written Hopper kernels of the port and their launch counts.

`LAUNCHES` counts, per kernel, the launches its wrapper made since the
last `reset_launches()`: a wrapper adds one right after it launched its
kernel and nowhere else, so a run can show that its path went through the
kernels (chip_smoke.py reads it around the serving and the training
run). A backward that takes two launches (the row pass and the column
sum of its cross-row reductions) counts once.

A CUDA graph launches nothing while it is captured and every captured
kernel at each replay. So inside `recording_launches()` a wrapper's count
goes to the recording instead, and `replay_launches(recording)` adds the
recording to `LAUNCHES` once a replay: the counts of a graph's replays are
the count at capture times the replays (serving/engine.py).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

LAUNCHES: Dict[str, int] = {
    "layer_norm_fwd": 0, "layer_norm_bwd": 0,
    "add_dropout_layer_norm_fwd": 0, "add_dropout_layer_norm_bwd": 0,
    "flash_attention_fwd": 0, "flash_attention_bwd": 0,
    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
    "lamb_stage1": 0, "lamb_stage2": 0}

_recording: Optional[Dict[str, int]] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    if _recording is not None:
        _recording[name] += 1
    else:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Within the block (a graph's capture), the wrappers' counts go to
    the yielded recording, not to `LAUNCHES`."""
    global _recording
    if _recording is not None:
        raise RuntimeError("launches are already being recorded")
    _recording = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _recording
    finally:
        _recording = None


def replay_launches(recording: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded `recording`."""
    for name, n in recording.items():
        LAUNCHES[name] += n
