"""Where a profiled run's time went: device compute and collectives, the
host loop's phases, the device's idle share and its top ops, from a
profiler trace (counterpart of the JAX package's tools/trace_summary.py;
telemetry/trace.py is the engine, standard library only).

    python -m bert_pytorch_tpu_torch.tools.trace_summary \\
        --trace <output_dir>/traces [--steps N] [--json out.json]
    python -m bert_pytorch_tpu_torch.tools.trace_summary --requests \\
        --trace traces.json [--ids a,b]

Point --trace at run_pretraining's `--profile_steps` output (the
directory or one `*.pt.trace.json`) or any torch.profiler Chrome trace
(a JAX profiler's trace reads too). --steps and --devices add per-step
and per-device keys. --requests reads a serving `GET /v1/traces` export
(serving/request_trace.py) instead: per-phase p50/p99 across request
timelines (admit, queue_wait, pack, dispatch, compute, demux, respond)
and which phase dominates the p99 cohort; --ids keeps only those trace
ids. Prints a table; --json also writes the summary dict.
"""

from __future__ import annotations

import argparse
import json
import sys

from bert_pytorch_tpu_torch.telemetry.trace import (
    find_trace_file, load_trace_events, summarize_request_events,
    summarize_trace)


def format_summary(s: dict) -> str:
    lines = [f"trace: {s.get('trace_file', '?')}",
             f"events classified: {s['events_classified']}"]
    if s.get("truncated"):
        lines.append(
            f"WARNING: {s['truncated_intervals']} interval(s) never "
            "completed (the trace was cut mid-op: a crashed run?); closed "
            "at the trace end and included in the totals")
    dev = f" ({s['n_devices']} devices)" if "n_devices" in s else ""
    lines.append(
        f"device: {s['device_ms']:.1f} ms (compute {s['compute_ms']:.1f}, "
        f"collective {s['collective_ms']:.1f}, collective_fraction "
        f"{s['collective_fraction']:.1%}){dev}")
    if s.get("idle_share") is not None:
        lines.append(f"idle share: {s['idle_share']:.3f} (busy "
                     f"{s['device_busy_ms']:.1f} of {s['window_ms']:.1f} ms "
                     "traced)")
    if "collective_ms_per_step_device" in s:
        basis = ("per step per device" if "n_devices" in s
                 else "per step")
        lines.append(
            f"{basis}: collective "
            f"{s['collective_ms_per_step_device']:.2f} ms, compute "
            f"{s['compute_ms_per_step_device']:.2f} ms "
            f"({s['steps']} steps)")
    if s.get("collective_kind_ms"):
        total = max(s["collective_ms"], 1e-9)
        lines.append("collectives by kind (ms; merged within a class):")
        for kind, ms in sorted(s["collective_kind_ms"].items(),
                               key=lambda kv: -kv[1]):
            lines.append(f"  {kind:<24} {ms:>10.1f} ms "
                         f"({ms / total:6.1%} of collective)")
    if s["collective_by_op_ms"]:
        lines.append("collectives by op:")
        for op, ms in sorted(s["collective_by_op_ms"].items(),
                             key=lambda kv: -kv[1]):
            lines.append(f"  {op:<24} {ms:>10.1f} ms")
    if s.get("device_top_ops_ms"):
        lines.append("top device ops:")
        for op, ms in s["device_top_ops_ms"].items():
            lines.append(f"  {op[:64]:<64} {ms:>10.2f} ms")
    if s["host_ms"]:
        lines.append("host phases:")
        for phase, ms in sorted(s["host_ms"].items(),
                                key=lambda kv: -kv[1]):
            lines.append(f"  {phase:<24} {ms:>10.1f} ms")
    return "\n".join(lines)


def format_request_summary(s: dict) -> str:
    lines = [f"request traces: {s['n_traces']}"]
    if not s["n_traces"]:
        lines.append("(no req/ spans in this trace: is it a /v1/traces "
                     "export?)")
        return "\n".join(lines)
    lines.append("  by outcome: " + ", ".join(
        f"{k}={v}" for k, v in sorted(s["by_outcome"].items())))
    lines.append("  by task:    " + ", ".join(
        f"{k}={v}" for k, v in sorted(s["by_task"].items())))
    lines.append(f"{'phase':<12} {'count':>6} {'p50 ms':>10} "
                 f"{'p99 ms':>10} {'mean ms':>10}")
    for phase, st in s["phases"].items():
        lines.append(f"{phase:<12} {st['count']:>6} {st['p50_ms']:>10.2f} "
                     f"{st['p99_ms']:>10.2f} {st['mean_ms']:>10.2f}")
    tot = s["total_ms"]
    lines.append(f"{'total':<12} {s['n_traces']:>6} {tot['p50']:>10.2f} "
                 f"{tot['p99']:>10.2f} {tot['mean']:>10.2f}")
    p99 = s.get("p99") or {}
    if p99.get("dominant_phase"):
        where = f" on {p99['replica']}" if p99.get("replica") else ""
        lines.append(
            f"p99 is {p99['dominant_share']:.0%} "
            f"{p99['dominant_phase']}{where} "
            f"({p99['n_traces']} trace(s) at/above "
            f"{p99['total_ms']:.1f} ms)")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", required=True,
                    help="trace directory (or one trace file)")
    ap.add_argument("--requests", action="store_true",
                    help="summarize serving request spans (a /v1/traces "
                         "export) instead of device and host time")
    ap.add_argument("--ids", default=None,
                    help="--requests: only these comma-separated trace "
                         "ids (the ones a firing latency alert carries, "
                         "GET /v1/alerts)")
    ap.add_argument("--steps", type=int, default=None,
                    help="optimization steps the traced window covered")
    ap.add_argument("--devices", type=int, default=None,
                    help="devices sharing this trace")
    ap.add_argument("--json", default=None,
                    help="also write the summary dict to this path")
    args = ap.parse_args(argv)

    if args.requests:
        trace_file = find_trace_file(args.trace)
        events = load_trace_events(trace_file)
        if args.ids:
            want = {i.strip() for i in args.ids.split(",") if i.strip()}
            events = [e for e in events
                      if (e.get("args") or {}).get("trace_id") in want]
            if not events:
                print(f"trace_summary: none of the {len(want)} requested "
                      f"id(s) appear in {trace_file} (the ring keeps only "
                      "the slowest and sampled traces)", file=sys.stderr)
        summary = summarize_request_events(events)
        summary["trace_file"] = trace_file
        if args.ids:
            summary["filtered_ids"] = sorted(
                i.strip() for i in args.ids.split(",") if i.strip())
        print(format_request_summary(summary))
    else:
        summary = summarize_trace(args.trace, steps=args.steps,
                                  n_devices=args.devices)
        print(format_summary(summary))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return summary


if __name__ == "__main__":
    main()
