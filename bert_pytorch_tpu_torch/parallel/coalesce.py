"""The norm reductions of a sharded update, per tensor or in buckets
(counterpart of bert_pytorch_tpu/parallel/coalesce.py).

Under ZeRO-1 each rank holds a piece of a tensor at most, so LAMB's two
trust norms of every tensor and the global gradient norm are sums of the
ranks' partial sums of squares. `NormReducer.reduce` takes a (k, T)
matrix of this rank's partials (k norms of T tensors; a tensor this rank
holds no piece of contributes 0) and returns the (k, T) totals on every
rank:

- coalesce off: one collective per tensor (its k partials), as the JAX
  package's GSPMD lowers the per-tensor norms;
- coalesce on: the (k, T) partials travel in buckets of at most
  `bucket_bytes` (DEFAULT_BUCKET_BYTES, 4 MB, the JAX package's), one
  collective a bucket.

Either way the partials are all-gathered and summed in rank order
(dist.sum_rows_in_order), so every total has the same bits with the
reduction coalesced or not. `summary()` records the buckets of the last
call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from bert_pytorch_tpu_torch.parallel import dist

DEFAULT_BUCKET_BYTES = 4 << 20


def _bucketize(sizes: Sequence[int], cap_bytes: int,
               itemsize: int = 4) -> List[List[int]]:
    """Deterministic greedy buckets (JAX's `_bucketize`): walk the entries
    in order, starting a new bucket when the payload would pass the cap;
    every entry lands in exactly one bucket."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, n in enumerate(sizes):
        b = int(n) * itemsize
        if cur and cur_bytes + b > cap_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        buckets.append(cur)
    return buckets


class NormReducer:
    """Sums of per-tensor partials over the ranks (module docstring)."""

    def __init__(self, coalesce: bool = False,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        self.coalesce = bool(coalesce)
        self.bucket_bytes = int(bucket_bytes)
        self.collectives = 0      # collectives issued, every call
        self._summary: Optional[Dict[str, Any]] = None

    def reduce(self, partials: torch.Tensor) -> torch.Tensor:
        """(k, T) partials of this rank -> (k, T) sums over the ranks."""
        k, t = partials.shape
        cols = partials.t().contiguous()          # (T, k): a tensor a row
        if self.coalesce:
            groups = _bucketize([k] * t, self.bucket_bytes,
                                cols.element_size())
        else:
            groups = [[i] for i in range(t)]
        out = torch.empty_like(cols)
        for g in groups:
            lo, hi = g[0], g[-1] + 1
            rows = dist.all_gather_rows(cols[lo:hi].reshape(-1))
            out[lo:hi] = dist.sum_rows_in_order(rows).view(hi - lo, k)
        self.collectives += len(groups)
        self._summary = {"coalesce": self.coalesce,
                         "bucket_bytes": self.bucket_bytes,
                         "tensors": t, "norms_per_tensor": k,
                         "collectives": len(groups),
                         "bucket_elems": [(g[-1] + 1 - g[0]) * k
                                          for g in groups]
                         if self.coalesce else None}
        return out.t()

    def summary(self) -> Optional[Dict[str, Any]]:
        """The buckets of the last `reduce` (run-header material); None
        before the first."""
        return self._summary
