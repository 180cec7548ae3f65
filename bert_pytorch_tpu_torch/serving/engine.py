"""Serving engine: one model per task, run per sequence bucket
(counterpart of bert_pytorch_tpu/serving/engine.py).

The JAX engine compiles one program per (task, bucket) ahead of traffic.
PyTorch runs eagerly, so here a bucket is simply the fixed (batch_rows,
bucket) shape every batch of that length class is padded to; `warmup()`
runs each (task, bucket) once on an all-pad batch so the kernels are built
and the allocator has seen every shape before the first request. Every
batch is the packed form (data/packing.py contract): a one-request-per-row
batch is the degenerate packing with one segment per row.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = (64, 128, 256, 512)

# the (B, S) int32 fields every bucketed forward consumes
BATCH_FIELDS = ("input_ids", "token_type_ids", "attention_mask",
                "position_ids", "segment_ids")


def select_bucket(length: int,
                  buckets: Sequence[int] = DEFAULT_BUCKETS) -> Optional[int]:
    """Smallest bucket that fits `length` (a request exactly at a bucket
    boundary rides that bucket); None when it exceeds the largest bucket —
    the frontend turns that into HTTP 413."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    return None


def zero_batch(batch_rows: int, bucket: int) -> Dict[str, np.ndarray]:
    """The all-pad batch of a bucket (segment_ids 0 everywhere)."""
    return {k: np.zeros((batch_rows, bucket), np.int32)
            for k in BATCH_FIELDS}


class TorchServingEngine:
    """Per-task forwards (tasks/predict.py builders over models already on
    `device`) run at one fixed (batch_rows, bucket) shape per bucket.

    `forward_counts[(task, bucket)]` counts the batches run, so a caller can
    relate kernel launch counts to forwards."""

    def __init__(self, forwards: Dict[str, Callable],
                 device: torch.device,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 batch_rows: int = 8,
                 max_segments: int = 8,
                 output_kinds: Optional[Dict[str, str]] = None):
        self._output_kinds = dict(output_kinds or {})
        bad = {t: k for t, k in self._output_kinds.items()
               if k not in ("token", "segment")}
        if bad:
            raise ValueError(f"unknown output kind(s): {bad} "
                             "(want 'token' or 'segment')")
        self._forwards = dict(forwards)
        self.tasks = tuple(sorted(forwards))
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.batch_rows = int(batch_rows)
        self.max_segments = int(max_segments)
        self.device = torch.device(device)
        self.forward_counts: Dict[Tuple[str, int], int] = {
            (t, b): 0 for t in self.tasks for b in self.buckets}

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    @property
    def n_devices(self) -> int:
        return 1

    def output_kind(self, task: str) -> str:
        """How a request's outputs come out of its row: 'token' (its token
        span: the QA and NER heads) or 'segment' (one pooled output per
        packed segment: classify, choice, embed), as the task's
        TaskSpec.output_kind says."""
        return self._output_kinds.get(task, "token")

    def select_bucket(self, length: int) -> Optional[int]:
        return select_bucket(length, self.buckets)

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k],
                                                         np.int32)
                                    ).to(self.device)
                for k in BATCH_FIELDS}

    def warmup(self, log: Callable[[str], None] = lambda m: None) -> int:
        """Run every (task, bucket) once on its all-pad batch. Returns the
        number of (task, bucket) pairs run."""
        n = 0
        for task in self.tasks:
            for bucket in self.buckets:
                t0 = time.perf_counter()
                self.forward(task, zero_batch(self.batch_rows, bucket))
                n += 1
                log(f"serving: warmed {task} bucket {bucket} "
                    f"({time.perf_counter() - t0:.2f}s)")
        return n

    def forward(self, task: str, batch: Dict[str, np.ndarray]):
        """Run one (batch_rows, bucket) batch; returns the forward's outputs
        as host f32 numpy arrays, a tuple where the forward returns one
        (QA: (start, end), each (B, S)) and one array otherwise (NER
        (B, S, C); classify (B, G, C); choice (B, G); embed (B, G, E))."""
        bucket = int(np.shape(batch["input_ids"])[1])
        if (task, bucket) not in self.forward_counts:
            raise KeyError(f"no forward for task={task!r} bucket={bucket} "
                           f"(buckets: {self.buckets})")
        with torch.inference_mode():
            out = self._forwards[task](self._device_batch(batch))
            self.forward_counts[(task, bucket)] += 1
            if isinstance(out, tuple):
                return tuple(o.float().cpu().numpy() for o in out)
            return out.float().cpu().numpy()
