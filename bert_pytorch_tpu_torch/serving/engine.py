"""Serving engine: one model per task, one CUDA graph per (task, bucket)
(counterpart of bert_pytorch_tpu/serving/engine.py).

The JAX engine compiles one program per (task, bucket) ahead of traffic
and steady traffic never recompiles. Here a bucket is the fixed
(batch_rows, bucket) shape every batch of that length class is padded to,
and on CUDA `warmup()` captures one `torch.cuda.CUDAGraph` per (task,
bucket): it first runs the forward once eagerly on the capture stream (the
kernels are built and their attributes set, cuBLAS has its workspace),
then captures it over static int32 input buffers with static outputs, in
one memory pool every graph shares (the scheduler runs one forward at a
time). `forward()` then copies the batch into the bucket's static buffers
from pinned host memory, replays, and copies the outputs to the host; a
failed capture or replay raises, nothing falls back to the eager forward.
`captures` counts the graphs captured (the counterpart of the JAX
CompileWatch pin): warmup sets it, traffic leaves it flat. The wrappers'
kernel launch counts survive the graphs: each capture records them and
each replay adds the recording (ops/kernels). On the CPU there are no
graphs: the forward runs eagerly and `captures` counts the (task, bucket)
forwards warmup built. `forward_eager` is the eager forward on the card,
the reference a replay is held against. Every batch is the packed form
(data/packing.py contract): a one-request-per-row batch is the degenerate
packing with one segment per row.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch.ops.kernels import (recording_launches,
                                                replay_launches)

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


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class _Graph:
    """One captured (task, bucket) forward: the graph, its f32 static
    outputs and the kernel launches its capture recorded."""

    def __init__(self, graph, outputs: Tuple[torch.Tensor, ...],
                 tuple_out: bool, launches: Dict[str, int]):
        self.graph = graph
        self.outputs = outputs
        self.tuple_out = tuple_out
        self.launches = launches


class TorchServingEngine:
    """Per-task forwards (tasks/predict.py builders over models already on
    `device`) at one fixed (batch_rows, bucket) shape per bucket, replayed
    from CUDA graphs on a card.

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
        self.graphs_on = self.device.type == "cuda"
        self.forward_counts: Dict[Tuple[str, int], int] = {
            (t, b): 0 for t in self.tasks for b in self.buckets}
        self.captures = 0
        self._graphs: Dict[Tuple[str, int], _Graph] = {}
        # one forward at a time: the graphs share their pool and a
        # bucket's static buffers
        self._lock = threading.Lock()
        self._host: Dict[int, torch.Tensor] = {}
        self._static: Dict[int, torch.Tensor] = {}
        if self.graphs_on:
            for b in self.buckets:
                shape = (len(BATCH_FIELDS), self.batch_rows, b)
                self._host[b] = torch.zeros(shape, dtype=torch.int32,
                                            pin_memory=True)
                self._static[b] = torch.zeros(shape, dtype=torch.int32,
                                              device=self.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=self.device)

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

    def _bucket_of(self, task: str, batch: Dict[str, np.ndarray]) -> int:
        rows, bucket = np.shape(batch["input_ids"])
        if (task, int(bucket)) not in self.forward_counts \
                or rows != self.batch_rows:
            raise KeyError(f"no forward for task={task!r} shape "
                           f"{(rows, bucket)} (buckets: {self.buckets}, "
                           f"batch_rows {self.batch_rows})")
        return int(bucket)

    def _static_batch(self, bucket: int) -> Dict[str, torch.Tensor]:
        return dict(zip(BATCH_FIELDS, self._static[bucket].unbind(0)))

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k],
                                                         np.int32)
                                    ).to(self.device)
                for k in BATCH_FIELDS}

    def _capture(self, task: str, bucket: int) -> _Graph:
        """Run the forward once eagerly on the capture stream, then
        capture it over the bucket's static buffers."""
        fwd = self._forwards[task]
        inputs = self._static_batch(bucket)
        self._static[bucket].zero_()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), torch.cuda.stream(self._stream):
            fwd(inputs)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), recording_launches() as launches:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                out = fwd(inputs)
                outputs = tuple(o.float() for o in _as_tuple(out))
        torch.cuda.synchronize(self.device)
        self.captures += 1
        return _Graph(graph, outputs, isinstance(out, tuple),
                      dict(launches))

    def warmup(self, log: Callable[[str], None] = lambda m: None) -> int:
        """Build every (task, bucket): on CUDA capture its graph, on the
        CPU run it once on its all-pad batch. Returns the number of
        (task, bucket) pairs built."""
        n = 0
        for task in self.tasks:
            for bucket in self.buckets:
                t0 = time.perf_counter()
                if self.graphs_on:
                    with self._lock:
                        self._graphs[(task, bucket)] = self._capture(
                            task, bucket)
                else:
                    self.forward_eager(task, zero_batch(self.batch_rows,
                                                        bucket))
                    self.captures += 1
                n += 1
                log(f"serving: {'captured' if self.graphs_on else 'warmed'}"
                    f" {task} bucket {bucket} "
                    f"({time.perf_counter() - t0:.2f}s)")
        return n

    def graph(self, task: str, bucket: int):
        """The captured torch.cuda.CUDAGraph of (task, bucket), for a
        caller that times its replay alone (its inputs are whatever the
        last forward copied in)."""
        g = self._graphs.get((task, int(bucket)))
        if g is None:
            raise RuntimeError(f"no CUDA graph for task={task!r} bucket="
                               f"{bucket}: call warmup() first")
        return g.graph

    def forward_eager(self, task: str, batch: Dict[str, np.ndarray]):
        """The forward run eagerly, outputs as `forward` returns them: the
        CPU's forward, and on a card the reference a replay is held
        against."""
        self._bucket_of(task, batch)
        with torch.inference_mode():
            out = self._forwards[task](self._device_batch(batch))
            host = tuple(o.float().cpu().numpy() for o in _as_tuple(out))
        return host if isinstance(out, tuple) else host[0]

    def forward(self, task: str, batch: Dict[str, np.ndarray]):
        """Run one (batch_rows, bucket) batch; returns the forward's outputs
        as host f32 numpy arrays, a tuple where the forward returns one
        (QA: (start, end), each (B, S)) and one array otherwise (NER
        (B, S, C); classify (B, G, C); choice (B, G); embed (B, G, E))."""
        bucket = self._bucket_of(task, batch)
        if not self.graphs_on:
            out = self.forward_eager(task, batch)
            self.forward_counts[(task, bucket)] += 1
            return out
        g = self._graphs.get((task, bucket))
        if g is None:
            raise RuntimeError(f"no CUDA graph for task={task!r} bucket="
                               f"{bucket}: call warmup() first")
        with self._lock:
            host = self._host[bucket]
            for i, k in enumerate(BATCH_FIELDS):
                host[i].numpy()[...] = batch[k]
            self._static[bucket].copy_(host, non_blocking=True)
            g.graph.replay()
            replay_launches(g.launches)
            outs = tuple(o.cpu().numpy() for o in g.outputs)
            self.forward_counts[(task, bucket)] += 1
        return outs if g.tuple_out else outs[0]
