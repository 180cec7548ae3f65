"""Request-path tracing: a span timeline for every request the server
admits (counterpart of bert_pytorch_tpu/serving/request_trace.py).

Every admitted request gets a trace id and host-side spans through its
life:

    admit -> queue_wait -> pack -> dispatch -> compute -> demux -> respond

or a terminal span on an error exit (`shed` 503, `timeout` 504,
`too_long` 413, `error` 500). The compute span carries the request's share
of the batch's device-seconds, pro-rated by real tokens. A bounded
TraceRing keeps the slowest traces of the current and the previous
rotating window plus every K-th trace, and exports them as one Chrome
trace JSON document (`ph: "X"` events, microseconds, names prefixed
`req/`), served at GET /v1/traces. Plain host Python: nothing here
touches a batch or a forward.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional

# span names exported as f"{REQUEST_SPAN_PREFIX}{name}" so they can never
# collide with HLO op names or host/ phases in a merged trace view
REQUEST_SPAN_PREFIX = "req/"

# the lifecycle vocabulary, in request order
REQUEST_PHASES = ("admit", "queue_wait", "pack", "dispatch", "compute",
                  "demux", "respond")

# terminal spans: the error exits; exactly one terminal OR `respond`
# closes a trace
TERMINAL_SPANS = ("shed", "timeout", "too_long", "error")


class RequestTrace:
    """One request's span timeline. Spans are (name, t0, t1, attrs)
    tuples on the perf_counter clock; `finish()` freezes the trace
    (first caller wins — late span/finish calls are no-ops), so a trace
    retained by the ring is immutable from the moment it is exported."""

    __slots__ = ("trace_id", "task", "seq", "t_admit", "spans",
                 "outcome", "total_ms", "finished")

    def __init__(self, trace_id: str, task: str, t_admit: float, seq: int):
        self.trace_id = trace_id
        self.task = task
        self.seq = seq
        self.t_admit = t_admit
        self.spans: List[tuple] = []
        self.outcome: Optional[str] = None
        self.total_ms = 0.0
        self.finished = False

    def span(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        """Record one closed span. Attr values must be JSON-scalar
        (str/int/float/bool) — the export is strict JSON."""
        if self.finished:
            return
        self.spans.append((name, t0, t1, attrs or None))

    def finish(self, outcome: str, t_end: float) -> bool:
        """Close the trace with its terminal outcome; True only for the
        first caller (racing terminators — client-side wait timeout vs a
        late demux — keep the first outcome, and the loser's ring.add is
        skipped)."""
        if self.finished:
            return False
        self.finished = True
        self.outcome = outcome
        self.total_ms = max(t_end - self.t_admit, 0.0) * 1e3
        return True

    def to_events(self) -> List[Dict[str, Any]]:
        """Chrome trace complete events (ph="X", ts/dur in us). Every
        event's args carry trace_id/task/outcome/total_ms so a single
        span is self-describing when traces are merged into one file."""
        events = []
        for name, t0, t1, attrs in self.spans:
            args: Dict[str, Any] = {
                "trace_id": self.trace_id,
                "task": self.task,
                "outcome": self.outcome or "open",
                "total_ms": round(self.total_ms, 3),
            }
            if attrs:
                args.update(attrs)
            events.append({
                "name": REQUEST_SPAN_PREFIX + name,
                "cat": "request",
                "ph": "X",
                "pid": 1,
                "tid": self.seq,
                "ts": round(t0 * 1e6, 3),
                "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
                "args": args,
            })
        return events


class TraceRing:
    """Bounded flight recorder for finished request traces.

    Keeps the `keep_slowest` slowest traces per rotating `window_s`
    window (current + previous, so a scrape right after rotation still
    sees the recent tail) and an every-`sample_every`-th sampled
    cross-section capped at `keep_sampled`. Thread-safe; `add()` is the
    hot-path cost — one lock, one heap push."""

    def __init__(self, keep_slowest: int = 32, sample_every: int = 16,
                 keep_sampled: int = 64, window_s: float = 60.0,
                 time_fn=time.monotonic):
        self.keep_slowest = max(1, int(keep_slowest))
        self.sample_every = max(1, int(sample_every))
        self.window_s = float(window_s)
        self._time = time_fn
        self._lock = threading.Lock()
        self._cur: List[tuple] = []      # min-heap of (total_ms, seq, trace)
        self._prev: List[tuple] = []
        self._window_start = self._time()
        self._sampled: deque = deque(maxlen=max(1, int(keep_sampled)))
        self._count = 0
        self._by_outcome: Dict[str, int] = {}
        self._seq = itertools.count(1)

    def new_trace(self, task: str,
                  t_admit: Optional[float] = None) -> RequestTrace:
        seq = next(self._seq)
        return RequestTrace(f"{task}-{seq:06x}", task,
                            time.perf_counter() if t_admit is None
                            else t_admit, seq)

    def add(self, trace: RequestTrace) -> None:
        with self._lock:
            now = self._time()
            if now - self._window_start >= self.window_s:
                self._prev = self._cur
                self._cur = []
                self._window_start = now
            self._count += 1
            self._by_outcome[trace.outcome] = \
                self._by_outcome.get(trace.outcome, 0) + 1
            if self._count % self.sample_every == 0:
                self._sampled.append(trace)
            item = (trace.total_ms, trace.seq, trace)
            if len(self._cur) < self.keep_slowest:
                heapq.heappush(self._cur, item)
            elif item > self._cur[0]:
                heapq.heapreplace(self._cur, item)

    def traces(self, ids: Optional[Iterable[str]] = None,
               limit: Optional[int] = None) -> List[RequestTrace]:
        """Retained traces, slowest first, deduped by trace_id (a trace
        can sit in both the slowest heap and the sampled deck)."""
        with self._lock:
            pool = ([t for _, _, t in self._cur]
                    + [t for _, _, t in self._prev]
                    + list(self._sampled))
        seen: Dict[str, RequestTrace] = {}
        for t in pool:
            seen.setdefault(t.trace_id, t)
        out = sorted(seen.values(), key=lambda t: (-t.total_ms, t.seq))
        if ids is not None:
            want = set(ids)
            out = [t for t in out if t.trace_id in want]
        if limit:
            out = out[:limit]
        return out

    def snapshot_events(self, ids: Optional[Iterable[str]] = None,
                        limit: Optional[int] = None) -> Dict[str, Any]:
        """The /v1/traces payload: one Chrome-trace JSON document whose
        traceEvents hold every retained (or requested) trace's spans."""
        retained = self.traces(ids=ids, limit=limit)
        events: List[Dict[str, Any]] = []
        for t in retained:
            events.extend(t.to_events())
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        doc["metadata"] = dict(self.stats(), exported=len(retained))
        return doc

    def stats(self) -> Dict[str, Any]:
        """Retention counters for /healthz."""
        with self._lock:
            return {
                "seen": self._count,
                "retained_slowest": len(self._cur) + len(self._prev),
                "retained_sampled": len(self._sampled),
                "by_outcome": dict(self._by_outcome),
                "keep_slowest": self.keep_slowest,
                "sample_every": self.sample_every,
                "window_s": self.window_s,
            }


# -- trace-id handoff to the HTTP layer ---------------------------------------
# The frontend handler thread opens a collection scope around the service
# call; Scheduler.submit notes each new trace id into it; the handler
# stamps the joined ids into the X-Trace-Id response header. Thread-local
# so concurrent handler threads cannot see each other's ids; a no-op
# (one getattr) when no scope is open — e.g. direct Scheduler use.

_collector = threading.local()


@contextmanager
def collect_trace_ids():
    """Collect every trace id created on this thread inside the scope."""
    ids: List[str] = []
    prev = getattr(_collector, "ids", None)
    _collector.ids = ids
    try:
        yield ids
    finally:
        _collector.ids = prev


def note_trace_id(trace_id: str) -> None:
    ids = getattr(_collector, "ids", None)
    if ids is not None:
        ids.append(trace_id)
