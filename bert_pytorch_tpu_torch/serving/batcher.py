"""Continuous batching: bounded queue -> packed rows -> per-request demux
(counterpart of bert_pytorch_tpu/serving/batcher.py, one engine: no
replicas and no work stealing).

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

Every signal lands in the server's metrics registry (the JAX server's
`bert_serve_*` families, names, types and labels): requests by task and
outcome, the end-to-end latency histogram, the queue depth, batches by
(task, bucket), real and slot tokens, the last batch's occupancy and
segments, device-seconds by task and the cost per 1k real tokens at
`cost_per_device_hour`. Request tracing (serving/request_trace.py) gives
every admitted request host-side spans (admit, queue_wait, pack, dispatch,
compute, demux, respond, or a terminal shed / timeout / too_long /
error) retired into the scheduler's TraceRing; the compute span carries
the request's share of the batch's device-seconds (the batch's wall time,
pro-rated by real tokens). Tracing records timestamps around the calls
and touches no batch, so it cannot move an output.
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
from bert_pytorch_tpu_torch.serving.request_trace import (TraceRing,
                                                          note_trace_id)
from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry
from bert_pytorch_tpu_torch.telemetry.stepwatch import (
    resolve_cost_per_device_hour)

_log = logging.getLogger(__name__)


class Overloaded(Exception):
    """Queue full — shed at admission (HTTP 503)."""


class RequestTimeout(Exception):
    """Waited longer than the admission timeout (HTTP 504)."""


class TooLong(Exception):
    """Longer than the largest bucket (HTTP 413)."""


# histogram buckets for end-to-end request latency (ms)
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


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
    trace: Any = None                # RequestTrace when tracing is on
    t_resolve: float = 0.0           # respond-span start (set by resolve)

    @property
    def length(self) -> int:
        return int(len(self.input_ids))

    def resolve(self, result: Any = None,
                error: Optional[Exception] = None) -> None:
        self.result = result
        self.error = error
        self.t_resolve = time.perf_counter()
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
    """The continuous-batching loop around one TorchServingEngine.

    `registry` is the server's MetricsRegistry (a new one with
    `phase="serve"` when None); `tracing` on keeps a TraceRing
    (`trace_ring`, or a default one); `cost_per_device_hour` resolves as
    telemetry/stepwatch.py says."""

    def __init__(self, engine, queue_size: int = 128,
                 admission_timeout_s: float = 10.0,
                 batch_wait_ms: float = 2.0, packing: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 trace_ring: Optional[TraceRing] = None,
                 tracing: bool = True,
                 cost_per_device_hour: Optional[float] = None):
        self.engine = engine
        self.packing = bool(packing)
        self.admission_timeout_s = float(admission_timeout_s)
        self.batch_wait_s = float(batch_wait_ms) / 1e3
        self.trace_ring: Optional[TraceRing] = (
            (trace_ring if trace_ring is not None else TraceRing())
            if tracing else None)
        self.cost_per_device_hour = resolve_cost_per_device_hour(
            cost_per_device_hour)
        self._q: "queue.Queue[InferenceRequest]" = queue.Queue(
            maxsize=int(queue_size))
        self._pending: List[InferenceRequest] = []
        self._running = 0            # requests of the batch on the engine
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        # outcome -> count, and (task, bucket) -> batches run
        self.outcomes: Dict[str, int] = collections.Counter()
        self.batches: Dict[Tuple[str, int], int] = collections.Counter()
        self._task_device_seconds: Dict[str, float] = collections.Counter()
        self._task_real_tokens: Dict[str, float] = collections.Counter()
        self._init_metrics(registry)

    # -- metrics --------------------------------------------------------------

    def _init_metrics(self, registry: Optional[MetricsRegistry]) -> None:
        if registry is None:
            registry = MetricsRegistry(constant_labels={"phase": "serve"})
        self.registry = registry
        self._m_requests = registry.counter(
            "bert_serve_requests_total",
            "requests by task and outcome (ok/too_long/overloaded/"
            "timeout/error)", labels=("task", "outcome"))
        self._m_latency = registry.histogram(
            "bert_serve_request_latency_ms",
            "end-to-end request latency (enqueue -> result), ms",
            labels=("task",), buckets=LATENCY_BUCKETS_MS)
        self._m_depth = registry.gauge(
            "bert_serve_queue_depth",
            "requests admitted but not yet dispatched")
        self._m_batches = registry.counter(
            "bert_serve_batches_total", "forward batches dispatched",
            labels=("task", "bucket"))
        self._m_real_tokens = registry.counter(
            "bert_serve_real_tokens_total",
            "non-pad tokens dispatched to the device")
        self._m_slot_tokens = registry.counter(
            "bert_serve_slot_tokens_total",
            "token slots the device computed (batch_rows x bucket per "
            "batch, pad included)")
        self._m_occupancy = registry.gauge(
            "bert_serve_batch_occupancy",
            "last batch's real tokens / computed slots")
        self._m_segments = registry.gauge(
            "bert_serve_batch_segments",
            "last batch's packed request count")
        self._m_device_seconds = registry.counter(
            "bert_serve_device_seconds_total",
            "device-seconds of engine compute (batch wall time x the "
            "engine's device count)", labels=("task",))
        self._m_cost = registry.gauge(
            "bert_serve_cost_per_1k_tokens",
            "cumulative device-seconds priced at cost_per_device_hour, "
            "per 1000 real (non-pad) tokens served", labels=("task",))
        self._m_cost_rate = registry.gauge(
            "bert_serve_cost_per_device_hour",
            "the price knob the cost gauges are quoted in "
            "(currency units per device-hour)")
        self._m_cost_rate.set(self.cost_per_device_hour)

    def _count(self, task: str, outcome: str) -> None:
        with self._stats_lock:
            self.outcomes[outcome] += 1
        self._m_requests.inc(task=task, outcome=outcome)

    def _update_depth(self) -> None:
        self._m_depth.set(self._q.qsize() + len(self._pending))

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
        tr = None
        if self.trace_ring is not None:
            tr = self.trace_ring.new_trace(task)
            note_trace_id(tr.trace_id)
        if self.engine.select_bucket(len(input_ids)) is None:
            self._count(task, "too_long")
            if tr is not None:
                self._finish_trace(tr, "too_long",
                                   length=int(len(input_ids)))
            raise TooLong(
                f"request length {len(input_ids)} exceeds the largest "
                f"bucket {self.engine.max_bucket}")
        req = InferenceRequest(task=task, input_ids=input_ids,
                               token_type_ids=token_type_ids)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._count(task, "overloaded")
            if tr is not None:
                self._finish_trace(tr, "shed",
                                   queue_size=int(self._q.maxsize))
            raise Overloaded(f"request queue full ({self._q.maxsize}); "
                             "shedding — retry with backoff")
        if tr is not None:
            tr.span("admit", tr.t_admit, req.t_enqueue, length=req.length)
            req.trace = tr
        self._update_depth()
        return req

    def result(self, req: InferenceRequest,
               timeout: Optional[float] = None) -> Any:
        """Block until the request resolves; re-raises its error. The
        latency histogram observes here: enqueue -> result, the path the
        client waited."""
        timeout = (self.admission_timeout_s + 30.0
                   if timeout is None else timeout)
        if not req.done.wait(timeout):
            req.error = RequestTimeout(f"no result within {timeout:.1f}s")
        ms = (time.perf_counter() - req.t_enqueue) * 1e3
        if req.error is not None:
            outcome = ("timeout" if isinstance(req.error, RequestTimeout)
                       else "error")
            self._count(req.task, outcome)
            if req.trace is not None:
                self._finish_trace(req.trace, outcome, t0=req.t_enqueue)
            raise req.error
        self._count(req.task, "ok")
        self._m_latency.observe(ms, task=req.task)
        if req.trace is not None:
            self._finish_trace(req.trace, "ok",
                               t0=req.t_resolve or req.t_enqueue)
        return req.result

    def _finish_trace(self, tr, outcome: str, t0: Optional[float] = None,
                      **attrs: Any) -> None:
        """The closing span ('respond' for ok, the terminal name
        otherwise), then the trace retires into the ring; the first of
        racing terminators wins."""
        now = time.perf_counter()
        tr.span("respond" if outcome == "ok" else outcome,
                tr.t_admit if t0 is None else t0, now, **attrs)
        if tr.finish(outcome, now):
            self.trace_ring.add(tr)

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
                if req.trace is not None:
                    self._finish_trace(req.trace, "timeout",
                                       t0=req.t_enqueue, reason="shutdown")
                req.resolve(error=RequestTimeout("server shutting down"))

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every admitted request has resolved (queue empty,
        nothing pending, no batch on the engine); False when `timeout`
        passed first. The graceful drain calls it before closing."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if (self._q.qsize() == 0 and not self._pending
                    and not self._running):
                return True
            time.sleep(0.01)
        return False

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
                if req.trace is not None:
                    self._finish_trace(req.trace, "timeout",
                                       t0=req.t_enqueue,
                                       waited_s=round(now - req.t_enqueue,
                                                      3))
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
                    self._update_depth()
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
                head = wave[0]
                if head.trace is not None:
                    self._finish_trace(head.trace, "error",
                                       t0=head.t_enqueue, site="pack")
                head.resolve(error=e)
                placed = {id(head)}
            finally:
                self._running = 0
            self._pending = [r for r in self._pending
                             if id(r) not in placed]
            self._update_depth()

    def _run(self, task: str, wave: List[InferenceRequest]) -> set:
        """Pack one batch in the head request's bucket, run it, resolve its
        requests (with the engine's error if the forward failed). Returns
        the ids of the requests placed."""
        t_pack0 = time.perf_counter()
        bucket = self.engine.select_bucket(wave[0].length)
        wave = [r for r in wave if r.length <= bucket]
        max_segments = self.engine.max_segments if self.packing else 1
        bins = first_fit([r.length for r in wave],
                         n_bins=self.engine.batch_rows,
                         capacity=bucket, max_segments=max_segments)
        batch, placements = pack_requests(wave, bins,
                                          self.engine.batch_rows, bucket)
        self._running = len(placements)
        t0 = time.perf_counter()
        for req, *_ in placements:
            if req.trace is not None:
                req.trace.span("queue_wait", req.t_enqueue, t_pack0)
                req.trace.span("pack", t_pack0, t0, bucket=int(bucket),
                               wave_segments=len(placements))
                req.trace.span("dispatch", t0, t0, replica=0,
                               queued_on=0, stolen=False)
        try:
            outputs = self.engine.forward(task, batch)
        except Exception as e:
            # fail only the requests that rode this batch, keep serving
            _log.exception("serving batch for task %r failed", task)
            for req, *_ in placements:
                if req.trace is not None:
                    self._finish_trace(req.trace, "error", t0=t0,
                                       replica=0, site="forward")
                req.resolve(error=e)
        else:
            t1 = time.perf_counter()
            real = sum(req.length for req, *_ in placements)
            n_dev = int(getattr(self.engine, "n_devices", 1) or 1)
            device_seconds = (t1 - t0) * n_dev
            self._note_batch(task, bucket, placements, real)
            self._note_cost(task, device_seconds, real)
            kind = self.engine.output_kind(task)
            for req, row, offset, seg in placements:
                if req.trace is None:
                    req.resolve(result=self._demux(outputs, row, offset,
                                                   req.length, seg, kind))
                    continue
                share = req.length / real if real else 0.0
                req.trace.span("compute", t0, t1, replica=0,
                               bucket=int(bucket), n_devices=n_dev,
                               device_seconds=round(device_seconds * share,
                                                    9))
                td0 = time.perf_counter()
                out = self._demux(outputs, row, offset, req.length, seg,
                                  kind)
                req.trace.span("demux", td0, time.perf_counter())
                req.resolve(result=out)
        return set(id(req) for req, *_ in placements)

    def _note_batch(self, task: str, bucket: int, placements, real: int
                    ) -> None:
        slots = self.engine.batch_rows * bucket
        with self._stats_lock:
            self.batches[(task, bucket)] += 1
        self._m_batches.inc(task=task, bucket=str(bucket))
        self._m_real_tokens.inc(real)
        self._m_slot_tokens.inc(slots)
        self._m_occupancy.set(real / slots)
        self._m_segments.set(len(placements))

    def _note_cost(self, task: str, device_seconds: float,
                   real_tokens: float) -> None:
        """Per-task device-seconds, and the cost gauge: the cumulative
        device-hours times the price, per 1000 real tokens served."""
        with self._stats_lock:
            self._task_device_seconds[task] += device_seconds
            self._task_real_tokens[task] += real_tokens
            ds = self._task_device_seconds[task]
            tk = self._task_real_tokens[task]
        self._m_device_seconds.inc(device_seconds, task=task)
        if tk > 0:
            cost = ds / 3600.0 * self.cost_per_device_hour
            self._m_cost.set(cost / (tk / 1000.0), task=task)

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
