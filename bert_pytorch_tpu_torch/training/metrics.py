"""Metric logging with several sinks (counterpart of
bert_pytorch_tpu/training/metrics.py, trimmed: no TensorBoard sink and no
registry publication).

`logger.log(tag, step, **metrics)` fans one record out to every sink: a
text line to `echo` (print by default) and to `<log_prefix>.txt`, a JSON
object to `<log_prefix>.jsonl`, and a row to `<log_prefix>_metrics.csv`
(whose header widens when a record brings a new key). `log_header` writes
one `{"tag": "header", ...}` record (the run's provenance) to the text
and jsonl sinks; `info` writes free text to the text sinks. Without a
`log_prefix` only `echo` is written.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Callable, Dict, Optional, TextIO


class MetricLogger:
    def __init__(self, log_prefix: Optional[str] = None,
                 echo: Callable[[str], None] = print):
        self._echo = echo
        self._closed = False
        self._file: Optional[TextIO] = None
        self._jsonl: Optional[TextIO] = None
        self._csv_path: Optional[str] = None
        self._csv_fields: Optional[list] = None
        self._csv_file: Optional[TextIO] = None
        if log_prefix:
            os.makedirs(os.path.dirname(os.path.abspath(log_prefix)),
                        exist_ok=True)
            self._file = open(f"{log_prefix}.txt", "a", encoding="utf-8")
            self._csv_path = f"{log_prefix}_metrics.csv"
            self._jsonl = open(f"{log_prefix}.jsonl", "a", encoding="utf-8")

    def _line(self, line: str) -> None:
        self._echo(line)
        if self._file:
            print(line, file=self._file, flush=True)

    def log(self, tag: str, step: int, **metrics: Any) -> None:
        if self._closed:
            return
        record = {"tag": tag, "step": step, "time": time.time(), **metrics}
        self._line(f"[{tag}] step {step} " + " ".join(
            f"{k}={_fmt(v)}" for k, v in metrics.items()))
        if self._jsonl:
            self._jsonl.write(json.dumps(record, default=str) + "\n")
            self._jsonl.flush()
        if self._csv_path:
            self._append_csv(record)

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
        csv.DictWriter(self._csv_file, fieldnames=self._csv_fields).writerow(
            {k: record.get(k, "") for k in self._csv_fields})
        self._csv_file.flush()

    def log_header(self, **fields: Any) -> None:
        """One self-describing record at the top of a run (provenance:
        telemetry/provenance.py), to the text and jsonl sinks."""
        if self._closed:
            return
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


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
