"""Metrics registry: counters, gauges, histograms with declared labels and
constant labels, rendered in the Prometheus text format (counterpart of
bert_pytorch_tpu/telemetry/registry.py, trimmed to what the server uses).

Families are get-or-create (two producers naming the same family share
it); re-declaring a name with a different kind or labels raises. A
registry may carry constant labels (the server's `phase="serve"`)
stamped on every series. Stdlib only and thread-safe: the HTTP threads
render while the scheduler writes.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the exposition format's content type, served with /metrics
CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"

# step-time-ish default buckets, in ms: spans a CPU-smoke step (~10 ms)
# through a pod-scale BERT-Large step (~seconds)
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and line feed only (text-format spec);
    # an unescaped newline in a help string would truncate the scrape
    # mid-family
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One metric family: a name, a help string, declared label names, and
    a map of label-value tuples -> series state. Base for the three kinds;
    subclasses define the per-series state and the render shape."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            # label-less families expose their zero immediately: /metrics
            # must show bert_train_steps_total 0 before the first step,
            # not omit the series until something increments it
            self._series[()] = self._new_series()

    def _new_series(self):
        return 0.0

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} declared labels "
                f"{self.labelnames}, got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _get(self, labels: Dict[str, str]):
        key = self._key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._new_series()
            return key

    def labeled_series(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(zip(self.labelnames, key)), value)
                for key, value in items]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r}: negative inc")
        key = self._get(labels)
        with self._lock:
            self._series[key] += amount

    def inc_to(self, value: float, **labels: str) -> None:
        """Monotonic set, for sampled cumulative sources (a snapshot of a
        count kept elsewhere). Never decreases the series."""
        key = self._get(labels)
        with self._lock:
            if value > self._series[key]:
                self._series[key] = value

    def value(self, **labels: str) -> float:
        key = self._get(labels)
        with self._lock:
            return self._series[key]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._get(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: str) -> float:
        key = self._get(labels)
        with self._lock:
            return self._series[key]


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r}: no buckets")
        super().__init__(name, help, labelnames, lock)

    def _new_series(self):
        return _HistSeries(len(self.buckets) + 1)  # + the +Inf bucket

    def observe(self, value: float, **labels: str) -> None:
        key = self._get(labels)
        value = float(value)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if value <= b:
                i = j
                break
        with self._lock:
            s = self._series[key]
            s.counts[i] += 1
            s.sum += value
            s.count += 1


class MetricsRegistry:
    """Thread-safe collection of metric families with get-or-create
    declaration and optional constant labels stamped on every series."""

    def __init__(self,
                 constant_labels: Optional[Dict[str, str]] = None):
        self.constant_labels = dict(constant_labels or {})
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # -- declaration ---------------------------------------------------------

    def _declare(self, cls, name: str, help: str,
                 labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, cls) \
                    or existing.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already declared as "
                    f"{existing.kind} with labels {existing.labelnames}")
            return existing
        metric = cls(name, help, labelnames, threading.Lock(), **kw)
        with self._lock:
            # lost a declare race: keep the winner (same kind by check above)
            return self._metrics.setdefault(name, metric)

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labels,
                             buckets=buckets)

    def families(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- export --------------------------------------------------------------

    def _label_str(self, labels: Dict[str, str],
                   extra: Optional[Dict[str, str]] = None) -> str:
        merged = {**self.constant_labels, **labels, **(extra or {})}
        if not merged:
            return ""
        inner = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in merged.items())
        return "{" + inner + "}"

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for m in self.families():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, value in m.labeled_series():
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m.buckets, value.counts):
                        cum += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{self._label_str(labels, {'le': _fmt_value(b)})}"
                            f" {cum}")
                    cum += value.counts[-1]
                    lines.append(
                        f"{m.name}_bucket"
                        f"{self._label_str(labels, {'le': '+Inf'})} {cum}")
                    lines.append(f"{m.name}_sum{self._label_str(labels)} "
                                 f"{_fmt_value(value.sum)}")
                    lines.append(f"{m.name}_count{self._label_str(labels)} "
                                 f"{value.count}")
                else:
                    lines.append(f"{m.name}{self._label_str(labels)} "
                                 f"{_fmt_value(value)}")
        return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal parser of the exposition format — enough for tests and the
    perfboard to assert on a live /metrics payload without a prometheus
    client dependency. Returns {metric_name: {label_str: value}} where
    label_str is the raw '{...}' chunk ('' for label-less series);
    `parse_prometheus_labels` turns a chunk back into the original
    (unescaped) label values for round-trip assertions."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_labels, _, raw = line.rpartition(" ")
        if not name_labels:
            raise ValueError(f"unparseable exposition line: {line!r}")
        if "{" in name_labels:
            name, _, rest = name_labels.partition("{")
            labels = "{" + rest
        else:
            name, labels = name_labels, ""
        out.setdefault(name, {})[labels] = float(raw)
    return out
