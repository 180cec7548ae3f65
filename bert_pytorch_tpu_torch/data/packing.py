"""Sequence packing (counterpart of bert_pytorch_tpu/data/packing.py):
the greedy first-fit bin packer the serving scheduler uses to put several
short requests into one fixed-length row."""

from __future__ import annotations

from typing import List, Sequence


def first_fit(lengths: Sequence[int], n_bins: int, capacity: int,
              max_segments: int) -> List[List[int]]:
    """Place each example, in arrival order, into the first of `n_bins`
    bins with `capacity` token slots and `max_segments` example slots
    free. Returns per-bin lists of example indices; examples that fit
    nowhere are absent (the caller keeps them for the next batch).
    Deterministic and order-preserving: no sorting."""
    used = [0] * n_bins
    segs = [0] * n_bins
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i, ln in enumerate(lengths):
        ln = int(ln)
        if ln > capacity:
            raise ValueError(f"example length {ln} exceeds row capacity "
                             f"{capacity}")
        for b in range(n_bins):
            if used[b] + ln <= capacity and segs[b] < max_segments:
                used[b] += ln
                segs[b] += 1
                bins[b].append(i)
                break
    return bins
