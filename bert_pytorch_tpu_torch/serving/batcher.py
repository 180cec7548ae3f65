"""Continuous batching: bounded queue -> packed rows -> per-request demux
(counterpart of bert_pytorch_tpu/serving/batcher.py, one engine, without
request tracing or cost accounting).

Several short requests share one (bucket,) row; segment-aware attention
keeps them apart. A token-local head's outputs for a request are a slice
of its row (`[row, offset:offset+len]`); a pooled head gives one output
per packed segment, and the request's is `[row, segment]` (the engine's
`output_kind`).

Flow control, in order:

- `submit()` raises `TooLong` when the request exceeds the largest bucket
  (HTTP 413) and `Overloaded` when the bounded queue is full (HTTP 503).
- the dispatcher thread drains the queue, expires requests older than the
  admission timeout (`RequestTimeout`, HTTP 504), takes the head request's
  task and natural bucket, first-fits every pending request of that task
  that fits the bucket into `batch_rows` rows, runs the batch on the
  engine and resolves each request with its part of every output (its
  token span, or its segment's pooled output). Packing off is the same
  first_fit with one segment per row.
- requests that do not fit the current batch stay pending in arrival
  order for the next one.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bert_pytorch_tpu_torch.data.packing import first_fit
from bert_pytorch_tpu_torch.serving.engine import zero_batch

_log = logging.getLogger(__name__)


class Overloaded(Exception):
    """Queue full — shed at admission (HTTP 503)."""


class RequestTimeout(Exception):
    """Waited longer than the admission timeout (HTTP 504)."""


class TooLong(Exception):
    """Longer than the largest bucket (HTTP 413)."""


@dataclass
class InferenceRequest:
    """One queued forward: featurized token ids (length L <= the largest
    bucket), resolved to its output slice."""

    task: str
    input_ids: np.ndarray            # (L,) int32
    token_type_ids: np.ndarray       # (L,) int32
    t_enqueue: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[Exception] = None

    @property
    def length(self) -> int:
        return int(len(self.input_ids))

    def resolve(self, result: Any = None,
                error: Optional[Exception] = None) -> None:
        self.result = result
        self.error = error
        self.done.set()


# (request, row, offset, segment index in the row: 0-based)
Placement = Tuple[InferenceRequest, int, int, int]


def pack_requests(reqs: List[InferenceRequest], bins: List[List[int]],
                  rows: int, bucket: int
                  ) -> Tuple[Dict[str, np.ndarray], List[Placement]]:
    """A first_fit bin layout -> the packed (rows, bucket) batch (segments
    1..n per row, positions reset per segment, 0 = pad) plus each
    request's (request, row, offset, segment) placement."""
    batch = zero_batch(rows, bucket)
    placements: List[Placement] = []
    for row, members in enumerate(bins):
        cursor = 0
        for seg, ri in enumerate(members):
            req = reqs[ri]
            ln = req.length
            sl = slice(cursor, cursor + ln)
            batch["input_ids"][row, sl] = req.input_ids
            batch["token_type_ids"][row, sl] = req.token_type_ids
            batch["attention_mask"][row, sl] = 1
            batch["segment_ids"][row, sl] = seg + 1
            batch["position_ids"][row, sl] = np.arange(ln, dtype=np.int32)
            placements.append((req, row, cursor, seg))
            cursor += ln
    return batch, placements


class Scheduler:
    """The continuous-batching loop around one TorchServingEngine."""

    def __init__(self, engine, queue_size: int = 128,
                 admission_timeout_s: float = 10.0,
                 batch_wait_ms: float = 2.0, packing: bool = True):
        self.engine = engine
        self.packing = bool(packing)
        self.admission_timeout_s = float(admission_timeout_s)
        self.batch_wait_s = float(batch_wait_ms) / 1e3
        self._q: "queue.Queue[InferenceRequest]" = queue.Queue(
            maxsize=int(queue_size))
        self._pending: List[InferenceRequest] = []
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        # outcome -> count, and (task, bucket) -> batches run
        self.outcomes: Dict[str, int] = collections.Counter()
        self.batches: Dict[Tuple[str, int], int] = collections.Counter()

    def _count(self, outcome: str) -> None:
        with self._stats_lock:
            self.outcomes[outcome] += 1

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return {"outcomes": dict(self.outcomes),
                    "batches": {f"{t}/{b}": n
                                for (t, b), n in sorted(self.batches.items())},
                    "queue_depth": self._q.qsize() + len(self._pending)}

    # -- client side ----------------------------------------------------------

    def submit(self, task: str, input_ids: np.ndarray,
               token_type_ids: Optional[np.ndarray] = None
               ) -> InferenceRequest:
        """Admit one request (raises TooLong / Overloaded); the caller
        waits on `result(req)`."""
        input_ids = np.asarray(input_ids, np.int32).reshape(-1)
        if token_type_ids is None:
            token_type_ids = np.zeros_like(input_ids)
        token_type_ids = np.asarray(token_type_ids, np.int32).reshape(-1)
        if self.engine.select_bucket(len(input_ids)) is None:
            self._count("too_long")
            raise TooLong(
                f"request length {len(input_ids)} exceeds the largest "
                f"bucket {self.engine.max_bucket}")
        req = InferenceRequest(task=task, input_ids=input_ids,
                               token_type_ids=token_type_ids)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._count("overloaded")
            raise Overloaded(f"request queue full ({self._q.maxsize}); "
                             "shedding — retry with backoff")
        return req

    def result(self, req: InferenceRequest,
               timeout: Optional[float] = None) -> Any:
        """Block until the request resolves; re-raises its error."""
        timeout = (self.admission_timeout_s + 30.0
                   if timeout is None else timeout)
        if not req.done.wait(timeout):
            req.error = RequestTimeout(f"no result within {timeout:.1f}s")
        if req.error is not None:
            self._count("timeout" if isinstance(req.error, RequestTimeout)
                        else "error")
            raise req.error
        self._count("ok")
        return req.result

    # -- scheduler side -------------------------------------------------------

    def start(self) -> "Scheduler":
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        for req in self._drain_all():
            if not req.done.is_set():
                req.resolve(error=RequestTimeout("server shutting down"))

    def _drain_all(self) -> List[InferenceRequest]:
        out, self._pending = list(self._pending), []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def _drain_into_pending(self) -> None:
        cap = self.engine.batch_rows * self.engine.max_segments * 4
        while len(self._pending) < cap:
            try:
                self._pending.append(self._q.get_nowait())
            except queue.Empty:
                return

    def _expire(self, now: float) -> None:
        keep = []
        for req in self._pending:
            if now - req.t_enqueue > self.admission_timeout_s:
                req.resolve(error=RequestTimeout(
                    f"queued {now - req.t_enqueue:.1f}s > admission "
                    f"timeout {self.admission_timeout_s:.1f}s"))
            else:
                keep.append(req)
        self._pending = keep

    def _loop(self) -> None:
        while not self._closed.is_set():
            if not self._pending:
                try:
                    self._pending.append(self._q.get(timeout=0.05))
                except queue.Empty:
                    continue
            # drain what arrived, then give stragglers one batching window
            self._drain_into_pending()
            if self.batch_wait_s > 0:
                time.sleep(self.batch_wait_s)
                self._drain_into_pending()
            self._expire(time.perf_counter())
            if not self._pending:
                continue
            task = self._pending[0].task
            wave = [r for r in self._pending if r.task == task]
            try:
                placed = self._run(task, wave)
            except Exception as e:
                # packing itself failed: fail the head request, the one a
                # broken layout implicates, so the loop makes progress
                _log.exception("packing a %r batch failed", task)
                wave[0].resolve(error=e)
                placed = {id(wave[0])}
            self._pending = [r for r in self._pending
                             if id(r) not in placed]

    def _run(self, task: str, wave: List[InferenceRequest]) -> set:
        """Pack one batch in the head request's bucket, run it, resolve its
        requests (with the engine's error if the forward failed). Returns
        the ids of the requests placed."""
        bucket = self.engine.select_bucket(wave[0].length)
        wave = [r for r in wave if r.length <= bucket]
        max_segments = self.engine.max_segments if self.packing else 1
        bins = first_fit([r.length for r in wave],
                         n_bins=self.engine.batch_rows,
                         capacity=bucket, max_segments=max_segments)
        batch, placements = pack_requests(wave, bins,
                                          self.engine.batch_rows, bucket)
        try:
            outputs = self.engine.forward(task, batch)
        except Exception as e:
            # fail only the requests that rode this batch, keep serving
            _log.exception("serving batch for task %r failed", task)
            for req, *_ in placements:
                req.resolve(error=e)
        else:
            with self._stats_lock:
                self.batches[(task, bucket)] += 1
            kind = self.engine.output_kind(task)
            for req, row, offset, seg in placements:
                req.resolve(result=self._demux(outputs, row, offset,
                                               req.length, seg, kind))
        return set(id(req) for req, *_ in placements)

    @staticmethod
    def _demux(outputs: Any, row: int, offset: int, length: int, seg: int,
               kind: str) -> Any:
        """One request's part of the batch outputs (a tuple of arrays or
        one array): kind 'token', its tokens `[row, offset:offset+length]`
        (QA span logits, NER token logits); kind 'segment', its segment's
        pooled output `[row, seg]` (classify logits, a choice score, an
        embedding)."""
        def part(o):
            o = np.asarray(o)
            if kind == "segment":
                return o[row, seg].copy()
            return o[row, offset:offset + length].copy()

        if isinstance(outputs, tuple):
            return tuple(part(o) for o in outputs)
        return part(outputs)
