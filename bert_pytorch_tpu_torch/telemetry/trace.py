"""Trace-event summarizer: device time (compute, collectives), host phases
and the device's idle share from a profiler's Chrome trace (counterpart of
bert_pytorch_tpu/telemetry/trace.py, whose engine this module copies).

Two kinds of trace reach it:

- the port's: `torch.profiler`'s Chrome trace (`export_chrome_trace`,
  what run_pretraining's --profile_steps writes under
  `<output_dir>/traces/`). Device time is the CUDA kernel, memcpy and
  memset events (`cat` "kernel", "gpu_memcpy", "gpu_memset"); of those
  the `nccl*` kernels are collectives (none on one card). Host time is
  the train loop's `record_function` ranges named `host/<phase>`
  (telemetry/stepwatch.StepWatch.phase opens one a phase, `cat`
  "user_annotation"). The CPU-side op events, the CUDA runtime calls and
  the device-side copies of the annotations count as neither;
- the JAX package's (events without a torch category): the JAX rule,
  `classify` by HLO name, so one reader serves both and the summary's
  keys are JAX's.

Durations are interval-merged per (pid, tid) and bucket before summing,
as in JAX: a kernel stream is one tid, so overlapping events of one
stream count once and concurrent streams add. Beyond JAX's keys the
summary carries `device_ms` (compute + collective), `device_top_ops_ms`
(the device ops with the most merged time) and, over the traced window
(the first to the last classified event), the union of every device
interval across streams (`device_busy_ms`, `window_ms`) and
`idle_share` = 1 - busy / window.

Standard library only (gzip, json): the summarizer runs on any host
against a trace copied off the card's machine.
`bert_pytorch_tpu_torch/tools/trace_summary.py` is the command.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

# HLO collective roots (the JAX traces' op names)
COLLECTIVE_PREFIXES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "collective-broadcast",
    "all-to-all",
    "ragged-all-to-all",
    "partition-id",
    "replica-id",
    "send",
    "recv",
)

# an HLO instruction name; framework wrappers fail it
_HLO_NAME_RE = re.compile(r"^[a-z][a-z0-9_\-.]*$")

HOST_PREFIX = "host/"

# serving request spans (serving/request_trace.py) ride the same Chrome
# event format under this prefix; device summaries exclude them,
# summarize_request_events aggregates them
REQUEST_PREFIX = "req/"

# request lifecycle phases in request order, then the terminal spans
REQUEST_PHASE_ORDER = ("admit", "queue_wait", "pack", "dispatch",
                       "compute", "demux", "respond",
                       "shed", "timeout", "too_long", "error")

COLLECTIVE_KIND_CLASSES = ("all-gather", "all-reduce", "reduce-scatter",
                           "collective-permute", "all-to-all")

# torch.profiler's categories: the card's events, and the host's
# record_function ranges
TORCH_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TORCH_ANNOTATION_CAT = "user_annotation"
# a torch trace's other categories, which count as neither
TORCH_OTHER_CATS = ("cpu_op", "gpu_user_annotation", "cuda_runtime",
                    "cuda_driver", "python_function", "ac2g", "overhead",
                    "Trace", "cpu_instant_event", "fwdbwd", "Kernel",
                    "Memcpy", "Memset", "cuda_profiler_range")

# NCCL kernel name fragments -> JAX's collective kind classes
_NCCL_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
               ("reducescatter", "reduce-scatter"),
               ("alltoall", "all-to-all"), ("sendrecv", "collective-permute"),
               ("broadcast", "collective-broadcast"))


def collective_kind(root: str) -> str:
    """The kind class of one collective root (an HLO root, or an NCCL
    kernel's name)."""
    if root in COLLECTIVE_KIND_CLASSES:
        return root
    low = root.lower().replace("_", "")
    if low.startswith("nccl"):
        for frag, kind in _NCCL_KINDS:
            if frag in low:
                return kind if kind in COLLECTIVE_KIND_CLASSES else "other"
    return "other"


def classify(name: str) -> Optional[str]:
    """JAX's rule for one event name: 'collective' | 'compute' | a
    'host/...' phase | None (framework noise, excluded)."""
    if name.startswith(HOST_PREFIX):
        return name
    if name.startswith(REQUEST_PREFIX):
        return None
    if not _HLO_NAME_RE.match(name):
        return None
    for p in COLLECTIVE_PREFIXES:
        if name.startswith(p):
            return "collective"
    return "compute"


def classify_event(event: Dict[str, Any]) -> Optional[str]:
    """The bucket of one trace event: a torch.profiler event by its
    category (a device event 'compute', or 'collective' for an `nccl*`
    kernel; a `host/...` record_function range its phase; anything else
    None), an event without a torch category by JAX's name rule."""
    name = event.get("name", "")
    cat = event.get("cat")
    if cat in TORCH_DEVICE_CATS:
        return "collective" if name.lower().startswith("nccl") else "compute"
    if cat == TORCH_ANNOTATION_CAT:
        return name if name.startswith(HOST_PREFIX) else None
    if cat in TORCH_OTHER_CATS:
        return None
    return classify(name)


def _merged_total_us(intervals: List[Tuple[float, float]]) -> float:
    """Sum of a set of [start, end) intervals with overlaps merged."""
    total = 0.0
    end = -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def find_trace_file(path: str) -> str:
    """Resolve a trace directory (or a file) to the newest trace under it:
    torch.profiler's `*.pt.trace.json[.gz]` or `*.trace.json[.gz]`, or a
    JAX profiler's `plugins/profile/<run>/*.trace.json.gz`."""
    if os.path.isfile(path):
        return path
    hits = []
    for pattern in ("*.trace.json", "*.trace.json.gz"):
        hits += glob.glob(os.path.join(path, pattern))
        hits += glob.glob(os.path.join(path, "plugins", "profile", "*",
                                       pattern))
    if not hits:
        raise FileNotFoundError(
            f"no *.trace.json[.gz] under {path} (run_pretraining "
            "--profile_steps writes <output_dir>/traces/)")
    return max(hits, key=os.path.getmtime)


def load_trace_events(trace_file: str) -> List[Dict[str, Any]]:
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt", encoding="utf-8") as f:
        trace = json.load(f)
    return trace.get("traceEvents", [])


def _per_op_totals(op_iv: Dict[Tuple[Any, Any, str],
                               List[Tuple[float, float]]]) -> Dict[str, float]:
    """Per-root device time: each thread's intervals merged, then summed
    across threads, as the bucket totals are."""
    totals: Dict[str, float] = {}
    for (pid, tid, root), iv in op_iv.items():
        totals[root] = totals.get(root, 0.0) + _merged_total_us(iv)
    return {op: round(us / 1e3, 3) for op, us in sorted(totals.items())}


def summarize_events(events: Iterable[Dict[str, Any]],
                     steps: Optional[int] = None,
                     n_devices: Optional[int] = None,
                     top_ops: int = 20) -> Dict[str, Any]:
    """Bucket trace events into collective / compute / host totals (JAX's
    keys), plus the device total, its top ops and the idle share (module
    docstring).

    Complete ('X') events are the common case; 'B'/'E' pairs per (pid,
    tid) and async 'b'/'e' ('S'/'F') pairs by (pid, id, cat, name) are
    understood too. Begins left open when the trace ends (a crashed run)
    close at the trace's end and are reported by `truncated: true` and
    `truncated_intervals`; an 'E' without its 'B' began before the capture
    and is skipped.

    `steps`: optimization steps the window covered (adds the per-step
    keys). `n_devices`: devices whose ops share this trace."""
    device_iv: Dict[Tuple[Any, Any, str], List[Tuple[float, float]]] = {}
    host_iv: Dict[str, List[Tuple[float, float]]] = {}
    op_iv: Dict[Tuple[Any, Any, str], List[Tuple[float, float]]] = {}
    name_iv: Dict[Tuple[Any, Any, str], List[Tuple[float, float]]] = {}
    n_classified = 0
    span = [None, None]

    def record(pid, tid, name: str, bucket: Optional[str], ts: float,
               end: float) -> bool:
        nonlocal n_classified
        if bucket is None:
            return False
        n_classified += 1
        span[0] = ts if span[0] is None else min(span[0], ts)
        span[1] = end if span[1] is None else max(span[1], end)
        if bucket.startswith(HOST_PREFIX):
            host_iv.setdefault(bucket, []).append((ts, end))
            return True
        device_iv.setdefault((pid, tid, bucket), []).append((ts, end))
        name_iv.setdefault((pid, tid, name), []).append((ts, end))
        if bucket == "collective":
            root = re.sub(r"\.\d+$", "", name)
            root = re.sub(r"-(start|done)$", "", root)
            op_iv.setdefault((pid, tid, root), []).append((ts, end))
        return True

    open_sync: Dict[Tuple[Any, Any], List[Tuple[str, Optional[str],
                                                float]]] = {}
    open_async: Dict[Tuple[Any, Any, Any, str],
                     List[Tuple[float, Any, Optional[str]]]] = {}
    max_ts = 0.0
    truncated = 0
    for e in events:
        ph = e.get("ph")
        name = e.get("name", "")
        ts = float(e.get("ts", 0.0))
        pid, tid = e.get("pid"), e.get("tid")
        if ph == "X":
            dur = float(e.get("dur", 0.0))
            max_ts = max(max_ts, ts + dur)
            record(pid, tid, name, classify_event(e), ts, ts + dur)
        elif ph == "B":
            max_ts = max(max_ts, ts)
            open_sync.setdefault((pid, tid), []).append(
                (name, classify_event(e), ts))
        elif ph == "E":
            max_ts = max(max_ts, ts)
            stack = open_sync.get((pid, tid))
            if stack:
                bname, bucket, bts = stack.pop()
                record(pid, tid, bname, bucket, bts, ts)
        elif ph in ("b", "S"):
            max_ts = max(max_ts, ts)
            key = (pid, e.get("id"), e.get("cat"), name)
            open_async.setdefault(key, []).append((ts, tid,
                                                   classify_event(e)))
        elif ph in ("e", "F"):
            max_ts = max(max_ts, ts)
            starts = open_async.get((pid, e.get("id"), e.get("cat"), name))
            if starts:
                bts, btid, bucket = starts.pop(0)
                record(pid, btid if btid is not None else tid, name,
                       bucket, bts, ts)
    # a crashed run's tail: every interval still open closes at the end
    for (pid, tid), stack in open_sync.items():
        for name, bucket, ts in stack:
            if record(pid, tid, name, bucket, ts, max(max_ts, ts)):
                truncated += 1
    for (pid, _id, _cat, name), starts in open_async.items():
        for ts, btid, bucket in starts:
            if record(pid, btid, name, bucket, ts, max(max_ts, ts)):
                truncated += 1

    def bucket_total(which: str) -> float:
        return sum(_merged_total_us(iv)
                   for (pid, tid, b), iv in device_iv.items() if b == which)

    collective_us = bucket_total("collective")
    compute_us = bucket_total("compute")
    host = {name[len(HOST_PREFIX):]: round(_merged_total_us(iv) / 1e3, 3)
            for name, iv in sorted(host_iv.items())}
    kind_iv: Dict[Tuple[Any, Any, str], List[Tuple[float, float]]] = {}
    for (pid, tid, root), iv in op_iv.items():
        kind_iv.setdefault((pid, tid, collective_kind(root)),
                           []).extend(iv)
    kind_ms: Dict[str, float] = {}
    for (pid, tid, kind), iv in kind_iv.items():
        kind_ms[kind] = kind_ms.get(kind, 0.0) + _merged_total_us(iv)
    kind_ms = {k: round(us / 1e3, 3) for k, us in sorted(kind_ms.items())}
    out: Dict[str, Any] = {
        "collective_ms": round(collective_us / 1e3, 3),
        "compute_ms": round(compute_us / 1e3, 3),
        "host_ms": host,
        "collective_fraction": round(
            collective_us / max(collective_us + compute_us, 1e-9), 4),
        "collective_by_op_ms": _per_op_totals(op_iv),
        "collective_kind_ms": kind_ms,
        "events_classified": n_classified,
    }
    # beyond JAX's keys: the device total, its top ops, the idle share
    out["device_ms"] = round((collective_us + compute_us) / 1e3, 3)
    ops = _per_op_totals(name_iv)
    out["device_top_ops_ms"] = dict(
        sorted(ops.items(), key=lambda kv: -kv[1])[:max(0, top_ops)])
    busy_us = _merged_total_us([iv for ivs in device_iv.values()
                                for iv in ivs])
    window_us = (span[1] - span[0]) if span[0] is not None else 0.0
    out["device_busy_ms"] = round(busy_us / 1e3, 3)
    out["window_ms"] = round(window_us / 1e3, 3)
    out["idle_share"] = (round(1.0 - busy_us / window_us, 4)
                         if window_us > 0 else None)
    if truncated:
        out["truncated"] = True
        out["truncated_intervals"] = truncated
    if n_devices:
        out["n_devices"] = int(n_devices)
        out["collective_ms_per_device"] = round(
            collective_us / 1e3 / n_devices, 3)
        out["compute_ms_per_device"] = round(compute_us / 1e3 / n_devices, 3)
    if steps:
        out["steps"] = int(steps)
        div = steps * (n_devices or 1)
        out["collective_ms_per_step_device"] = round(
            collective_us / 1e3 / div, 3)
        out["compute_ms_per_step_device"] = round(compute_us / 1e3 / div, 3)
        out["collective_kind_ms_per_step_device"] = {
            k: round(v / div, 3) for k, v in kind_ms.items()}
    return out


def _pct(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def _phase_key(name: str) -> Tuple[int, str]:
    try:
        return (REQUEST_PHASE_ORDER.index(name), name)
    except ValueError:
        return (len(REQUEST_PHASE_ORDER), name)


def summarize_request_events(
        events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate serving request spans (`req/` complete events from
    GET /v1/traces) into per-phase latency attribution: per-phase p50 /
    p99 / mean across traces, and over the traces at or above the p99 of
    totals the mean time a phase, the dominant phase, its share and the
    modal replica. Other events are ignored."""
    traces: Dict[str, Dict[str, Any]] = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or not name.startswith(REQUEST_PREFIX):
            continue
        args = e.get("args") or {}
        trace_id = args.get("trace_id")
        if trace_id is None:
            continue
        t = traces.setdefault(trace_id, {
            "phases": {}, "total_ms": 0.0, "task": args.get("task"),
            "outcome": None, "replica": None, "t0": None, "t1": 0.0})
        phase = name[len(REQUEST_PREFIX):]
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        t["phases"][phase] = t["phases"].get(phase, 0.0) + dur / 1e3
        t["t0"] = ts if t["t0"] is None else min(t["t0"], ts)
        t["t1"] = max(t["t1"], ts + dur)
        if args.get("total_ms"):
            t["total_ms"] = max(t["total_ms"], float(args["total_ms"]))
        if args.get("outcome") not in (None, "open"):
            t["outcome"] = args["outcome"]
        if phase == "compute" and "replica" in args:
            t["replica"] = args["replica"]
        elif t["replica"] is None and "replica" in args:
            t["replica"] = args["replica"]
    out: Dict[str, Any] = {"n_traces": len(traces), "by_outcome": {},
                           "by_task": {}, "phases": {}, "total_ms": {}}
    if not traces:
        return out
    totals: List[float] = []
    phase_samples: Dict[str, List[float]] = {}
    for t in traces.values():
        if not t["total_ms"] and t["t0"] is not None:
            t["total_ms"] = (t["t1"] - t["t0"]) / 1e3
        totals.append(t["total_ms"])
        key = t["outcome"] or "open"
        out["by_outcome"][key] = out["by_outcome"].get(key, 0) + 1
        task = t["task"] or "?"
        out["by_task"][task] = out["by_task"].get(task, 0) + 1
        for phase, ms in t["phases"].items():
            phase_samples.setdefault(phase, []).append(ms)
    totals.sort()
    for phase in sorted(phase_samples, key=_phase_key):
        vals = sorted(phase_samples[phase])
        out["phases"][phase] = {
            "count": len(vals),
            "mean_ms": round(sum(vals) / len(vals), 3),
            "p50_ms": round(_pct(vals, 50.0), 3),
            "p99_ms": round(_pct(vals, 99.0), 3),
        }
    out["total_ms"] = {
        "p50": round(_pct(totals, 50.0), 3),
        "p99": round(_pct(totals, 99.0), 3),
        "mean": round(sum(totals) / len(totals), 3),
        "max": round(totals[-1], 3),
    }
    p99_total = _pct(totals, 99.0)
    tail = [t for t in traces.values() if t["total_ms"] >= p99_total]
    n_tail = max(len(tail), 1)
    tail_phase: Dict[str, float] = {}
    for t in tail:
        for phase, ms in t["phases"].items():
            tail_phase[phase] = tail_phase.get(phase, 0.0) + ms
    tail_phase = {p: ms / n_tail for p, ms in tail_phase.items()}
    tail_total = sum(t["total_ms"] for t in tail) / n_tail
    dominant_phase, dominant_ms = (
        max(tail_phase.items(), key=lambda kv: kv[1])
        if tail_phase else (None, 0.0))
    replica_votes: Dict[Any, int] = {}
    for t in tail:
        if t["replica"] is not None:
            replica_votes[t["replica"]] = \
                replica_votes.get(t["replica"], 0) + 1
    replica = (f"r{max(replica_votes.items(), key=lambda kv: kv[1])[0]}"
               if replica_votes else None)
    out["p99"] = {
        "total_ms": round(p99_total, 3),
        "n_traces": len(tail),
        "phase_ms": {p: round(ms, 3) for p, ms
                     in sorted(tail_phase.items(),
                               key=lambda kv: _phase_key(kv[0]))},
        "dominant_phase": dominant_phase,
        "dominant_share": round(dominant_ms / tail_total, 4)
        if tail_total > 0 else 0.0,
        "replica": replica,
    }
    return out


def summarize_trace(path: str, steps: Optional[int] = None,
                    n_devices: Optional[int] = None) -> Dict[str, Any]:
    """find_trace_file + load + summarize, with the file it read."""
    trace_file = find_trace_file(path)
    out = summarize_events(load_trace_events(trace_file), steps=steps,
                           n_devices=n_devices)
    out["trace_file"] = trace_file
    return out


def headline(s: Dict[str, Any]) -> str:
    """One line of a summary: device time, idle share, the host phases and
    the top device op."""
    per = ""
    if "steps" in s:
        ms = (s["compute_ms_per_step_device"]
              + s["collective_ms_per_step_device"])
        per = f" ({ms:.1f} ms a step over {s['steps']})"
    host = ", ".join(f"{k} {v:.1f}" for k, v in
                     sorted(s["host_ms"].items(), key=lambda kv: -kv[1]))
    top = next(iter(s.get("device_top_ops_ms", {}).items()), None)
    idle = s.get("idle_share")
    return (f"device {s['device_ms']:.1f} ms{per}, idle share "
            + (f"{idle:.3f}" if idle is not None else "n/a")
            + f" over {s['window_ms']:.1f} ms; host ms {{{host}}}"
            + (f"; top op {top[0][:60]} {top[1]:.1f} ms" if top else ""))
