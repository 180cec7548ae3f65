"""The port's trace summarizer (telemetry/trace.py, tools/trace_summary.py)
against the JAX package's on the same event lists (the cases of
tests/test_trace.py: interval merging per thread, zero durations, async
pairs out of order, a crashed run's open intervals, framework noise, the
collective kinds, serving request spans): JAX's keys equal exactly. Then
the port's own reading of torch.profiler's Chrome trace (device events by
category, `host/*` record_function ranges, the idle share), a real trace
of a 2-step CPU pretraining run, and the command's --json and
--requests modes."""

import json
import os
import sys

import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.telemetry import trace as jax_trace  # noqa: E402
from bert_pytorch_tpu_torch.telemetry import trace as port_trace  # noqa: E402
from bert_pytorch_tpu_torch.telemetry.stepwatch import StepWatch  # noqa: E402
from bert_pytorch_tpu_torch.tools import trace_summary  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the summary's keys beyond JAX's
PORT_KEYS = {"device_ms", "device_top_ops_ms", "device_busy_ms",
             "window_ms", "idle_share"}


def X(name, ts, dur, pid=1, tid=1, **kw):
    return dict({"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid,
                 "tid": tid}, **kw)


CASES = {
    "overlap_same_thread": [X("all-gather-start.1", 0, 100),
                            X("all-gather-start.2", 50, 100),
                            X("all-gather-start.3", 0, 100, tid=2)],
    "zero_duration": [X("fusion.1", 10, 0), X("dot.1", 10, 5)],
    "async_out_of_order": [
        {"ph": "b", "name": "all-gather.1", "ts": 0, "pid": 1, "id": "a"},
        {"ph": "b", "name": "all-reduce.1", "ts": 10, "pid": 1, "id": "b"},
        {"ph": "e", "name": "all-reduce.1", "ts": 20, "pid": 1, "id": "b"},
        {"ph": "e", "name": "all-gather.1", "ts": 40, "pid": 1, "id": "a"}],
    "unmatched_async_start": [
        X("dot.1", 0, 100),
        {"ph": "b", "name": "all-gather-start.7", "ts": 20, "pid": 1,
         "id": "g"},
        X("fusion.2", 100, 400)],
    "truncated_merges_on_its_thread": [
        X("all-reduce.9", 0, 100, pid=1, tid=5),
        {"ph": "b", "name": "all-gather.2", "ts": 50, "pid": 1, "tid": 5,
         "id": "g"}],
    "async_close_uses_begin_tid": [
        X("all-to-all.1", 0, 40, pid=1, tid=3),
        {"ph": "b", "name": "all-to-all.2", "ts": 10, "pid": 1, "tid": 3,
         "id": "q"},
        {"ph": "e", "name": "all-to-all.2", "ts": 60, "pid": 1, "id": "q"}],
    "unmatched_sync_begin": [
        {"ph": "B", "name": "host/dispatch", "ts": 0, "pid": 9, "tid": 9},
        X("dot.3", 100, 100, pid=1, tid=1)],
    "b_e_pairs_and_stray_end": [
        {"ph": "E", "name": "host/h2d", "ts": 5, "pid": 1, "tid": 1},
        {"ph": "B", "name": "all-reduce.1", "ts": 10, "pid": 1, "tid": 1},
        {"ph": "E", "name": "all-reduce.1", "ts": 30, "pid": 1, "tid": 1}],
    "framework_noise": [
        {"ph": "B", "name": "ThunkExecutor::Run", "ts": 0, "pid": 1,
         "tid": 1},
        X("dot.1", 0, 10)],
    "collective_kinds": [
        X("all-gather-start.1", 0, 100), X("all-gather-done.1", 100, 20),
        X("all-reduce.7", 0, 50), X("collective-permute-start.2", 200, 30),
        X("all-to-all.1", 300, 10), X("partition-id.1", 400, 5),
        X("dot.1", 500, 40)],
    "kinds_merge_within_class": [
        X("all-gather-start.1", 0, 100), X("all-gather-start.2", 50, 100),
        X("all-reduce.1", 0, 100)],
    "host_phases_and_request_spans": [
        X("host/data_wait", 0, 30, pid=2, tid=2),
        X("host/dispatch", 30, 100, pid=2, tid=2),
        X("host/dispatch", 200, 50, pid=2, tid=2),
        X("req/queue_wait", 0, 70, args={"trace_id": "t1"}),
        X("fusion.3", 40, 60), X("PjitFunction(step)", 0, 300)],
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("norm", [{}, {"steps": 2, "n_devices": 4}])
def test_summarize_events_equals_jax(name, norm):
    events = CASES[name]
    want = jax_trace.summarize_events(events, **norm)
    got = port_trace.summarize_events(events, **norm)
    assert set(got) - set(want) == PORT_KEYS
    assert {k: got[k] for k in want} == want


def test_merged_total_and_classify_equal_jax():
    for iv in ([(0, 10), (5, 15), (20, 30), (21, 25)],
               [(20, 30), (0, 10), (5, 15)], [(5, 5), (5, 5), (7, 7)], []):
        assert port_trace._merged_total_us(iv) == \
            jax_trace._merged_total_us(iv)
    for name in ("all-gather-start.12", "reduce-scatter.1",
                 "transpose_copy_fusion", "host/data_wait",
                 "ThunkExecutor::Run", "PjitFunction(train_step)",
                 "req/compute", "send.3"):
        assert port_trace.classify(name) == jax_trace.classify(name)
    for root in ("all-gather", "reduce-scatter", "send", "all-to-all"):
        assert port_trace.collective_kind(root) == \
            jax_trace.collective_kind(root)


def _request_events():
    out = []
    for i in range(40):
        tid = f"r{i}"
        total = 10.0 + i + (300 if i >= 38 else 0)
        args = {"trace_id": tid, "task": ("squad", "ner")[i % 2],
                "total_ms": total, "outcome": "ok" if i != 5 else "shed",
                "replica": i % 2}
        out.append(X("req/admit", 1000 * i, 100, args=args))
        out.append(X("req/queue_wait", 1000 * i + 100,
                     (total - 5) * 1e3 * (0.8 if i >= 38 else 0.3),
                     args=args))
        out.append(X("req/compute", 1000 * i + 200, 4e3, args=args))
    out.append(X("fusion.1", 0, 10))
    return out


def test_summarize_request_events_equals_jax():
    events = _request_events()
    want = jax_trace.summarize_request_events(events)
    assert want["p99"]["dominant_phase"] == "queue_wait"
    assert port_trace.summarize_request_events(events) == want


def test_torch_trace_classification_and_idle_share():
    """A torch.profiler trace's events: kernels, copies and memsets are
    device time per stream (an nccl kernel a collective), `host/*`
    user_annotation ranges host time, and the CPU op events, runtime calls
    and the device-side copies of the annotations neither; the idle share
    is 1 - the union of device intervals over the traced window."""
    events = [
        X("host/dispatch", 0, 400, pid=10, tid=10, cat="user_annotation"),
        X("host/metric_flush", 400, 600, pid=10, tid=10,
          cat="user_annotation"),
        X("aten::mm", 10, 50, pid=10, tid=10, cat="cpu_op"),
        X("cudaLaunchKernel", 12, 5, pid=10, tid=10, cat="cuda_runtime"),
        X("host/dispatch", 100, 300, pid=0, tid=7,
          cat="gpu_user_annotation"),
        X("ln_fwd_row_kernel", 100, 100, pid=0, tid=7, cat="kernel"),
        X("ampere_sgemm_128x64_nn", 150, 100, pid=0, tid=7, cat="kernel"),
        X("Memcpy HtoD (Pinned -> Device)", 120, 60, pid=0, tid=13,
          cat="gpu_memcpy"),
        X("Memset (Device)", 600, 100, pid=0, tid=7, cat="gpu_memset"),
        X("ncclDevKernel_AllReduce_Sum_f32", 700, 100, pid=0, tid=7,
          cat="kernel"),
    ]
    s = port_trace.summarize_events(events, steps=1)
    assert s["host_ms"] == {"dispatch": 0.4, "metric_flush": 0.6}
    # stream 7: [100, 250) + [600, 800); stream 13: [120, 180)
    assert s["compute_ms"] == 0.31 and s["collective_ms"] == 0.1
    assert s["device_ms"] == 0.41
    assert s["collective_kind_ms"] == {"all-reduce": 0.1}
    assert s["device_busy_ms"] == 0.35 and s["window_ms"] == 1.0
    assert s["idle_share"] == 0.65
    assert s["device_top_ops_ms"]["ln_fwd_row_kernel"] == 0.1
    assert s["device_top_ops_ms"]["Memcpy HtoD (Pinned -> Device)"] == 0.06
    assert "aten::mm" not in s["device_top_ops_ms"]
    assert "host/dispatch" not in s["device_top_ops_ms"]


def test_stepwatch_phases_are_host_ranges_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    sw = StepWatch(flops_per_step=1.0, seqs_per_step=1.0, seq_len=1,
                   peak_flops=None)
    with sw.phase("dispatch"):
        pass                    # no profiler: no range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with sw.phase("data_wait"):
            torch.ones(4).sum()
        with sw.phase("dispatch"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"host/data_wait", "host/dispatch"} <= names


@pytest.fixture(scope="module")
def profiled_run(tmp_path_factory):
    """A 2-step CPU pretraining run under --profile_steps 0,2."""
    from bert_pytorch_tpu_torch import run_pretraining
    from tests.test_data import write_shard

    root = tmp_path_factory.mktemp("profiled")
    (root / "data").mkdir()
    for i in range(2):
        write_shard(str(root / "data" / f"part_{i}.hdf5"), 16, seq=32,
                    seed=i)
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, next_sentence=True)))
    lines = []
    result = run_pretraining.main([
        "--config_file", os.path.join(REPO, "configs",
                                      "bert_pretraining_phase1_config.json"),
        "--model_config_file", str(cfg), "--input_dir", str(root / "data"),
        "--output_dir", str(root / "out"), "--local_batch_size", "4",
        "--global_batch_size", "8", "--steps", "3", "--device", "cpu",
        "--tensorboard", "off", "--vocab_pad_multiple", "8",
        "--profile_steps", "0,2", "--skip_checkpoint"], log=lines.append)
    return result, lines, root / "out"


def test_profile_steps_trace_has_the_host_phases(profiled_run):
    result, lines, out = profiled_run
    prof = result.profile
    assert prof["steps"] == [1, 2]
    assert os.path.dirname(prof["trace_file"]) == str(out / "traces")
    host = prof["summary"]["host_ms"]
    assert {"data_prep", "data_wait", "dispatch", "h2d",
            "metric_flush"} <= set(host)
    assert host["dispatch"] > 0
    # the CPU run's trace holds no device event
    assert prof["summary"]["device_ms"] == 0.0
    assert any(m.startswith("profile: steps 1..2 traced to") for m in lines)


def test_trace_summary_command_and_json(profiled_run, tmp_path, capsys):
    _, _, out = profiled_run
    path = tmp_path / "s.json"
    summary = trace_summary.main(["--trace", str(out / "traces"),
                                  "--steps", "2", "--json", str(path)])
    text = capsys.readouterr().out
    assert "host phases:" in text and "dispatch" in text
    assert json.loads(path.read_text())["steps"] == 2
    assert summary["trace_file"].endswith(".pt.trace.json")
    assert summary == port_trace.summarize_trace(str(out / "traces"),
                                                 steps=2)


def test_trace_summary_requests_mode(tmp_path, capsys):
    """--requests over a /v1/traces export (serving/request_trace.py's
    TraceRing snapshot), with --ids."""
    from bert_pytorch_tpu_torch.serving.request_trace import TraceRing

    ring = TraceRing()
    for i in range(6):
        tr = ring.new_trace("squad")
        t0 = tr.t_admit
        tr.span("queue_wait", t0, t0 + 0.001 * (i + 1))
        tr.span("compute", t0 + 0.001 * (i + 1), t0 + 0.001 * (i + 2))
        tr.finish("ok", t0 + 0.001 * (i + 2))
        ring.add(tr)
    doc = ring.snapshot_events()
    path = tmp_path / "traces.json"
    path.write_text(json.dumps(doc))
    s = trace_summary.main(["--requests", "--trace", str(path)])
    assert s["n_traces"] == 6 and s["phases"]["queue_wait"]["count"] == 6
    assert "p99 is" in capsys.readouterr().out
    ids = sorted({e["args"]["trace_id"] for e in doc["traceEvents"]})[:2]
    s2 = trace_summary.main(["--requests", "--trace", str(path), "--ids",
                             ",".join(ids)])
    assert s2["n_traces"] == 2 and s2["filtered_ids"] == ids
    assert s == jax_trace.summarize_request_events(doc["traceEvents"]) | {
        "trace_file": str(path)}
