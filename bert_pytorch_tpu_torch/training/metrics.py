"""Metric logging with several sinks (counterpart of
bert_pytorch_tpu/training/metrics.py).

`logger.log(tag, step, **metrics)` fans one record out to every sink: a
text line to `echo` (print by default) and to `<log_prefix>.txt`, a JSON
object `{"tag", "step", "time", ...}` to `<log_prefix>.jsonl`, a row
to `<log_prefix>_metrics.csv` (whose header widens, rows rewritten, when
a record brings a new key; a resumed run adopts the existing header),
and with `tensorboard=True` a scalar `<tag>/<key>` at `step` for every
numeric value, through torch.utils.tensorboard's SummaryWriter into
`<log_prefix>_tb` (the JAX sink's tags and steps). Without the
`tensorboard` package that sink is off, and the logger says so once.
With a `registry`, every numeric value also lands in the gauges
`bert_metric{tag, name}` and `bert_last_logged_step{tag}`, so a /metrics
scrape sees what the sinks see.

`log_header` writes one `{"tag": "header", ...}` record (the run's
provenance) to the text and jsonl sinks, unless the last header already
in the jsonl covers it (equal, or a subset of it, wall-clock stamps
aside): a resumed run does not append the same header again. `info`
writes free text to the text sinks. Without a `log_prefix` only `echo`
is written.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Callable, Dict, Optional, TextIO


class MetricLogger:
    # header fields that differ between a run and its resume by nature
    VOLATILE_HEADER_KEYS = ("time", "time_unix")

    def __init__(self, log_prefix: Optional[str] = None,
                 echo: Callable[[str], None] = print, registry=None,
                 tensorboard: bool = False):
        self._echo = echo
        self._closed = False
        self._file: Optional[TextIO] = None
        self._jsonl: Optional[TextIO] = None
        self.jsonl_path: Optional[str] = None
        self._csv_path: Optional[str] = None
        self._csv_fields: Optional[list] = None
        self._csv_file: Optional[TextIO] = None
        self._tb = None
        self.tensorboard_dir: Optional[str] = None
        self._reg_gauge = self._reg_step = None
        if registry is not None:
            self._reg_gauge = registry.gauge(
                "bert_metric", "last logged value per record tag + key",
                labels=("tag", "name"))
            self._reg_step = registry.gauge(
                "bert_last_logged_step", "last step logged per record tag",
                labels=("tag",))
        self._last_header = None    # seeded from the jsonl sink on first use
        if log_prefix:
            os.makedirs(os.path.dirname(os.path.abspath(log_prefix)),
                        exist_ok=True)
            self._file = open(f"{log_prefix}.txt", "a", encoding="utf-8")
            self._csv_path = f"{log_prefix}_metrics.csv"
            self.jsonl_path = f"{log_prefix}.jsonl"
            self._jsonl = open(self.jsonl_path, "a", encoding="utf-8")
            if tensorboard:
                self._open_tensorboard(f"{log_prefix}_tb")

    def _open_tensorboard(self, log_dir: str) -> None:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            self._line(f"tensorboard: sink off ({e})")
            return
        self._tb = SummaryWriter(log_dir=log_dir)
        self.tensorboard_dir = log_dir

    def _line(self, line: str) -> None:
        self._echo(line)
        if self._file:
            print(line, file=self._file, flush=True)

    def log(self, tag: str, step: int, **metrics: Any) -> None:
        if self._closed:
            return
        if self._reg_gauge is not None:
            self._reg_step.set(step, tag=tag)
            for k, v in metrics.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                self._reg_gauge.set(float(v), tag=tag, name=k)
        record = {"tag": tag, "step": step, "time": time.time(), **metrics}
        self._line(f"[{tag}] step {step} " + " ".join(
            f"{k}={_fmt(v)}" for k, v in metrics.items()))
        if self._jsonl:
            self._jsonl.write(json.dumps(record, default=str) + "\n")
            self._jsonl.flush()
        if self._csv_path:
            self._append_csv(record)
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{tag}/{k}", v, step)

    def _append_csv(self, record: Dict[str, Any]) -> None:
        if self._csv_fields is None:
            # appending to an existing file: adopt its header
            self._csv_fields = []
            if os.path.exists(self._csv_path):
                with open(self._csv_path, newline="", encoding="utf-8") as f:
                    first = f.readline().strip()
                self._csv_fields = first.split(",") if first else []
        new_keys = [k for k in record if k not in self._csv_fields]
        if new_keys:
            # widen the header: rewrite the rows so far under the union
            if self._csv_file is not None:
                self._csv_file.close()
                self._csv_file = None
            rows = []
            if os.path.exists(self._csv_path):
                with open(self._csv_path, newline="", encoding="utf-8") as f:
                    rows = list(csv.DictReader(f))
            self._csv_fields = self._csv_fields + new_keys
            with open(self._csv_path, "w", newline="",
                      encoding="utf-8") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields)
                w.writeheader()
                for r in rows:
                    w.writerow({k: r.get(k, "") for k in self._csv_fields})
        if self._csv_file is None:
            self._csv_file = open(self._csv_path, "a", newline="",
                                  encoding="utf-8")
            if self._csv_file.tell() == 0 and self._csv_fields:
                csv.writer(self._csv_file).writerow(self._csv_fields)
        csv.DictWriter(self._csv_file, fieldnames=self._csv_fields).writerow(
            {k: record.get(k, "") for k in self._csv_fields})
        self._csv_file.flush()

    @classmethod
    def _header_norm(cls, fields: Dict[str, Any]) -> Dict[str, str]:
        """A header's identity: wall-clock stamps left out, values
        JSON-canonicalised (so a tuple logged now equals the list read
        back from the jsonl)."""
        return {k: json.dumps(v, sort_keys=True, default=str)
                for k, v in fields.items()
                if k not in cls.VOLATILE_HEADER_KEYS}

    @staticmethod
    def _header_covered(new: Dict[str, str],
                        last: Optional[Dict[str, str]]) -> bool:
        """True when `new` carries nothing the LAST header lacks: equal,
        or an item-subset of it. Judged against the last header only, so
        a flip-back (A -> B -> A across resumes) is still recorded."""
        if last is None:
            return False
        return all(last.get(k) == v for k, v in new.items())

    def _existing_last_header(self) -> Optional[Dict[str, str]]:
        """The normalised fields of the last header already in the jsonl
        sink (None without one): the resume-append case."""
        if not self.jsonl_path or not os.path.exists(self.jsonl_path):
            return None
        last = None
        try:
            with open(self.jsonl_path, encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("tag") == "header":
                        last = rec
        except OSError:
            return None
        if last is None:
            return None
        return self._header_norm({k: v for k, v in last.items()
                                  if k != "tag"})

    def log_header(self, **fields: Any) -> None:
        """One self-describing record at the top of a run (provenance:
        telemetry/provenance.py), to the text and jsonl sinks; skipped
        when the last header in the jsonl covers it."""
        if self._closed:
            return
        norm = self._header_norm(fields)
        if self._last_header is None:
            self._last_header = self._existing_last_header()
        if self._header_covered(norm, self._last_header):
            self._echo("[header] unchanged on resume (not re-appended)")
            return
        self._last_header = norm
        self._line("[header] " + " ".join(
            f"{k}={_fmt(v)}" for k, v in fields.items()))
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"tag": "header", "time": time.time(), **fields},
                default=str) + "\n")
            self._jsonl.flush()

    def info(self, msg: str) -> None:
        if not self._closed:
            self._line(msg)

    def close(self) -> None:
        """Close every sink; later calls are no-ops. Idempotent."""
        self._closed = True
        for f in (self._file, self._jsonl, self._csv_file):
            if f:
                f.close()
        self._file = self._jsonl = self._csv_file = None
        self._csv_path = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
