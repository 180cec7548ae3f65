"""Sequence packing (counterpart of bert_pytorch_tpu/data/packing.py): the
greedy first-fit bin packer that the serving scheduler uses to put
several short requests into one fixed-length row, and packed finetuning
(training/finetune.py) several short examples."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def first_fit(lengths: Sequence[int], n_bins: int, capacity: int,
              max_segments: int, segs_per_unit: int = 1) -> List[List[int]]:
    """Place each example, in arrival order, into the first of `n_bins`
    bins with `capacity` token slots and `segs_per_unit` of its
    `max_segments` example slots free. Returns per-bin lists of example
    indices; examples that fit nowhere are absent (the caller keeps them
    for the next batch). Deterministic and order-preserving: no sorting.
    `segs_per_unit` > 1 places multi-segment units whole (a
    multiple-choice example's C choice rows stay in one bin)."""
    used = [0] * n_bins
    segs = [0] * n_bins
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i, ln in enumerate(lengths):
        ln = int(ln)
        if ln > capacity:
            raise ValueError(f"example length {ln} exceeds row capacity "
                             f"{capacity}")
        for b in range(n_bins):
            if used[b] + ln <= capacity \
                    and segs[b] + segs_per_unit <= max_segments:
                used[b] += ln
                segs[b] += segs_per_unit
                bins[b].append(i)
                break
    return bins


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Real tokens / slot tokens of a packed (or plain-masked) batch."""
    seg = np.asarray(segment_ids)
    return float((seg > 0).mean()) if seg.size else 0.0
