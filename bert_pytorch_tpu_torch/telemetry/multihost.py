"""Cross-rank perf aggregation: per-rank metrics jsonl + rank-0 fold
(a copy of bert_pytorch_tpu/telemetry/multihost.py).

On a run over several ranks every process keeps its own StepWatch, but
only rank 0's logger has sinks, so the perf record would describe ONE
rank and a straggler (a slow disk feeding `data_wait`, a throttled card
inflating `step_time_ms`) would be invisible exactly when it matters:
data-parallel training runs at the speed of the slowest rank.

A shared directory (`<output_dir>/metrics_hosts/`) holds one append-only
jsonl a process (`host00000.jsonl`, ...). Every rank `publish()`es the
numeric fields of each StepWatch interval record; rank 0's `fold()`
reads the LAST record of every host file (a bounded tail read) and folds
cross-rank min/mean/max of the fold fields (`step_time_ms`,
`data_wait_ms` by default) into its own perf record, plus a straggler
warning when one rank's step time z-scores above `z_threshold` against
the others.

Files, not collectives, on purpose: a collective in the metrics path
would add a sync point to every interval, and files stay readable after
the run dies. Folds see each rank's *latest* interval, which may lag a
step behind rank 0's; records carry their step id so the fold reports
the spread (`hosts_step_min`/`max`).

Stdlib-only: process index and count are constructor arguments.

On a mesh with a model axis several ranks train one data shard: they
step through the same rows, so their throughput is one shard's, not
theirs added. `data_shard_of` (a data shard index for each process)
makes the fold count each shard once: `seq_per_sec_global` sums the
`seq_per_sec` of the lowest-numbered process of every data shard (the
fold fields stay per process: every rank's step time is reported). The
loss is the whole batch's on every rank, logged once by rank 0.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_FOLD_FIELDS = ("step_time_ms", "data_wait_ms")
_TAIL_BYTES = 65536


def host_file(root_dir: str, process_index: int) -> str:
    return os.path.join(root_dir, f"host{process_index:05d}.jsonl")


def read_last_record(path: str) -> Optional[Dict[str, Any]]:
    """Last complete JSON line of a host file, reading only a bounded tail.
    A torn final line (a concurrent writer mid-append) falls back to the
    previous complete one; missing/empty files return None."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - _TAIL_BYTES))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn write: try the line before it
        if isinstance(rec, dict):
            return rec
    return None


class HostMetricsAggregator:
    """Per-host publish + process-0 fold over a shared directory."""

    def __init__(self, root_dir: str, process_index: int,
                 process_count: int, z_threshold: float = 3.0,
                 fold_fields: Sequence[str] = DEFAULT_FOLD_FIELDS,
                 data_shard_of: Optional[Sequence[int]] = None):
        self.root_dir = root_dir
        self.data_shard_of = (list(data_shard_of)
                              if data_shard_of is not None else None)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.z_threshold = float(z_threshold)
        self.fold_fields = tuple(fold_fields)
        os.makedirs(root_dir, exist_ok=True)
        self.path = host_file(root_dir, self.process_index)
        self._file = open(self.path, "a", encoding="utf-8")

    # -- every process -------------------------------------------------------

    def publish(self, step: int, record: Dict[str, Any]) -> None:
        """Append this host's interval record (numeric fields only — the
        fold needs numbers, and host files should not balloon with
        strings) with host/step/time stamps."""
        rec = {"host": self.process_index, "step": int(step),
               "time": round(time.time(), 3)}
        for k, v in record.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if isinstance(v, float) and not math.isfinite(v):
                continue  # a NaN metric must never kill the publish path
            rec[k] = v
        self._file.write(json.dumps(rec, allow_nan=False, default=str)
                         + "\n")
        self._file.flush()

    # -- process 0 -----------------------------------------------------------

    def fold(self) -> Tuple[Dict[str, Any], Optional[str]]:
        """Cross-host aggregate of every host's latest record, plus a
        straggler warning string (or None). Empty dict when fewer than two
        hosts have reported — a fold must never pretend a fleet exists."""
        latest: Dict[int, Dict[str, Any]] = {}
        for i in range(self.process_count):
            rec = read_last_record(host_file(self.root_dir, i))
            if rec is not None:
                latest[i] = rec
        if len(latest) < 2:
            return {}, None

        agg: Dict[str, Any] = {
            "hosts_reporting": len(latest),
            "hosts_step_min": min(r.get("step", 0) for r in latest.values()),
            "hosts_step_max": max(r.get("step", 0) for r in latest.values()),
        }
        warning = None
        if self.data_shard_of is not None:
            first: Dict[int, int] = {}
            for i, shard in enumerate(self.data_shard_of):
                first.setdefault(shard, i)
            rates = [latest[i].get("seq_per_sec") for i in first.values()
                     if i in latest]
            if rates and all(isinstance(r, (int, float)) for r in rates):
                agg["seq_per_sec_global"] = round(sum(rates), 2)
                agg["data_shards_reporting"] = len(rates)
        for field in self.fold_fields:
            vals = {i: float(r[field]) for i, r in latest.items()
                    if isinstance(r.get(field), (int, float))}
            if len(vals) < 2:
                continue
            xs = list(vals.values())
            mean = sum(xs) / len(xs)
            agg[f"{field}_host_min"] = round(min(xs), 3)
            agg[f"{field}_host_mean"] = round(mean, 3)
            agg[f"{field}_host_max"] = round(max(xs), 3)
            if field == "step_time_ms":
                var = sum((x - mean) ** 2 for x in xs) / len(xs)
                std = var ** 0.5
                if std > 0:
                    worst, worst_val = max(vals.items(),
                                           key=lambda kv: kv[1])
                    z = (worst_val - mean) / std
                    agg["straggler_z"] = round(z, 2)
                    if z > self.z_threshold:
                        agg["straggler_host"] = worst
                        warning = (
                            f"straggler: host {worst} step_time_ms "
                            f"{worst_val:.1f} is z={z:.1f} above the "
                            f"{len(xs)}-host mean {mean:.1f} ms "
                            f"(threshold z={self.z_threshold:g}) — the "
                            "fleet steps at the slowest host's pace")
        return agg, warning

    def hosts_seen(self) -> List[int]:
        """Host indices with a file on disk (diagnostics)."""
        out = []
        for i in range(self.process_count):
            if os.path.exists(host_file(self.root_dir, i)):
                out.append(i)
        return out

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "HostMetricsAggregator":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
