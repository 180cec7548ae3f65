"""The port server's planes against the JAX server, on the CPU, at 2
layers, E 64 and buckets (16, 32): squad and classify from the same
JAX-initialised parameters (the JAX server's checkpoints, the port's
`.npz` of the flat flax tree).

- GET /metrics: the `bert_serve_*` families of one engine (requests,
  latency, queue depth, batches, real and slot tokens, occupancy,
  segments, device-seconds, cost per 1k tokens and per device-hour, model
  params) with the JAX server's names, types and label names, and the
  same requests_total by (task, outcome), real_tokens_total and
  slot_tokens_total after the same sequential requests;
- GET /v1/traces: the span names and order of JAX's for one request,
  looked up by the X-Trace-Id the reply carried, strict JSON; tracing off
  drops both;
- the graceful drain: a new request gets 503 with Retry-After, the one in
  flight gets 200, /healthz reads draining; the entry point exits 0 on
  SIGTERM;
- the flags: every flag of the JAX server's parser is declared, and is
  served or listed in `_REFUSED`; each refused flag (replicas, the mesh,
  --force_cpu) raises when it switches its feature on;
- the price per device-hour: flag, then environment, then 1.0.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("the cat sat on a mat while dog ran in park and red blue green "
         "film was good bad who where did").split()
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [".", "?"]
CFG = {"vocab_size": len(VOCAB), "hidden_size": 64, "num_hidden_layers": 2,
       "num_attention_heads": 4, "intermediate_size": 128,
       "max_position_embeddings": 64, "next_sentence": True,
       "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
TASKS = ("classify", "squad")
# the JAX families of one engine; replicas and steals come with the
# features the port has not served yet
JAX_ONLY = ("bert_serve_replica_", "bert_serve_steals_total")
REQUESTS = [
    ("squad", {"question": "who sat ?", "context": "the cat sat on a mat ."}),
    ("classify", {"text": "the film was good", "text_pair": "red cat"}),
    ("squad", {"question": "where did the dog run ?",
               "context": " ".join(["the dog ran in the park ."] * 6)}),
    ("classify", {"text": "a bad film"}),
    ("squad", {"question": "who ?", "context": "blue green red ."}),
]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from bert_pytorch_tpu.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu.models import bert as jbert
    from bert_pytorch_tpu.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu.training.state import unbox

    root = tmp_path_factory.mktemp("torch_serving_planes")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    cfg_path = root / "model_config.json"
    cfg_path.write_text(json.dumps(CFG))
    config = BertConfig.from_json_file(str(cfg_path))
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    models = {"squad": jbert.BertForQuestionAnswering(config,
                                                      dtype=jnp.float32),
              "classify": jbert.BertForSequenceClassification(
                  config, num_labels=2, dtype=jnp.float32)}
    s = jnp.zeros((1, 16), jnp.int32)
    for i, (task, model) in enumerate(sorted(models.items())):
        params = unbox(model.init(jax.random.PRNGKey(20 + i), s, s,
                                  s)["params"])
        mgr = CheckpointManager(str(root / f"{task}_ckpt"))
        mgr.save(0, {"params": params})
        mgr.close()
        np.savez(root / f"{task}.npz", **{
            k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()})
    return root


def _argv(root, suffix, *extra):
    argv = ["--model_config_file", str(root / "model_config.json"),
            "--vocab_file", str(root / "vocab.txt"), "--port", "0",
            "--host", "127.0.0.1", "--buckets", "16,32", "--batch_rows", "2",
            "--serve_dtype", "float32", "--batch_wait_ms", "1"]
    for task in TASKS:
        argv += ["--task_checkpoint", f"{task}={root / (task + suffix)}"]
    return argv + list(extra)


def _port_serve(root, *extra):
    from bert_pytorch_tpu_torch import run_server

    return run_server.serve(run_server.parse_arguments(
        _argv(root, ".npz", "--device", "cpu", *extra)), log=lambda m: None)


def _post(url, route, body, timeout=60):
    """(status, reply, headers) of POST /v1/<route>, an error status too."""
    req = urllib.request.Request(url + f"/v1/{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.read().decode()


def _strict_json(text):
    def bad(token):
        raise ValueError(f"non-strict JSON token {token}")

    return json.loads(text, parse_constant=bad)


def _families(text):
    """{family: (type, sorted label names)} of the bert_serve_* families of
    an exposition, label names from its series (the histogram's without
    `le`)."""
    from bert_pytorch_tpu_torch.telemetry.registry import parse_prometheus

    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
    series = parse_prometheus(text)
    out = {}
    for name, kind in types.items():
        if not name.startswith("bert_serve_") or name.startswith(JAX_ONLY):
            continue
        key = name + "_bucket" if kind == "histogram" else name
        labels = set()
        for chunk in series.get(key, {}):
            labels |= {part.split("=")[0] for part in
                       chunk.strip("{}").split(",") if part}
        out[name] = (kind, sorted(labels - {"le"}))
    return out, series


def _exchange(url):
    replies = [_post(url, route, body) for route, body in REQUESTS]
    traces = _strict_json(_get(url, "/v1/traces"))
    return replies, _get(url, "/metrics"), traces


@pytest.fixture(scope="module")
def port_run(fixture_dir):
    handle = _port_serve(fixture_dir)
    try:
        return _exchange(handle.url)
    finally:
        handle.close()


@pytest.fixture(scope="module")
def jax_run(fixture_dir):
    import run_server as jax_run_server

    handle = jax_run_server.serve(jax_run_server.parse_arguments(
        _argv(fixture_dir, "_ckpt")))
    try:
        return _exchange(handle.url)
    finally:
        handle.close()


def test_metrics_families_and_counts_match_the_jax_server(port_run,
                                                          jax_run):
    p_replies, p_text, _ = port_run
    j_replies, j_text, _ = jax_run
    assert [r[0] for r in p_replies] == [r[0] for r in j_replies] \
        == [200] * len(REQUESTS)
    p_fam, p_series = _families(p_text)
    j_fam, j_series = _families(j_text)
    assert p_fam == j_fam
    assert len(p_fam) == 12
    for name in ("bert_serve_requests_total", "bert_serve_real_tokens_total",
                 "bert_serve_slot_tokens_total", "bert_serve_batches_total",
                 "bert_serve_model_params"):
        assert p_series[name] == j_series[name], name
    ok = {k: v for k, v in p_series["bert_serve_requests_total"].items()
          if 'outcome="ok"' in k}
    assert sum(ok.values()) >= len(REQUESTS)


def test_traces_spans_and_trace_id_header(fixture_dir, port_run, jax_run):
    p_replies, _, p_doc = port_run
    j_replies, _, j_doc = jax_run

    def spans(doc, trace_id):
        return [e["name"] for e in doc["traceEvents"]
                if e["args"]["trace_id"] == trace_id]

    for (_, _, p_hdr), (_, _, j_hdr) in zip(p_replies, j_replies):
        p_ids = p_hdr["X-Trace-Id"].split(",")
        j_ids = j_hdr["X-Trace-Id"].split(",")
        assert len(p_ids) == len(j_ids)
        for p_id, j_id in zip(p_ids, j_ids):
            assert spans(p_doc, p_id) == spans(j_doc, j_id) == [
                "req/" + s for s in ("admit", "queue_wait", "pack",
                                     "dispatch", "compute", "demux",
                                     "respond")]
    assert all({"ph", "ts", "dur", "pid", "tid"} <= set(e)
               for e in p_doc["traceEvents"])

    handle = _port_serve(fixture_dir)
    try:
        _, _, hdr = _post(handle.url, "squad", REQUESTS[0][1])
        one = _strict_json(_get(handle.url, "/v1/traces?id="
                                + hdr["X-Trace-Id"]))
        assert {e["args"]["trace_id"] for e in one["traceEvents"]} == {
            hdr["X-Trace-Id"]}
        compute = [e for e in one["traceEvents"]
                   if e["name"] == "req/compute"]
        assert compute[0]["args"]["device_seconds"] > 0
        assert len(_strict_json(_get(handle.url, "/v1/traces?n=1"))[
            "metadata"]) and _strict_json(_get(
                handle.url, "/v1/traces?n=1"))["metadata"]["exported"] == 1
    finally:
        handle.close()
    handle = _port_serve(fixture_dir, "--request_tracing", "off")
    try:
        code, _, hdr = _post(handle.url, "squad", REQUESTS[0][1])
        assert code == 200 and "X-Trace-Id" not in hdr
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(handle.url, "/v1/traces")
        assert e.value.code == 404
    finally:
        handle.close()


def test_drain_sheds_new_requests_and_finishes_admitted(fixture_dir):
    handle = _port_serve(fixture_dir)
    engine = handle.engine
    forward = engine.forward
    started = threading.Event()

    def slow(task, batch):
        started.set()
        time.sleep(1.0)
        return forward(task, batch)

    engine.forward = slow
    try:
        inflight = {}
        th = threading.Thread(target=lambda: inflight.setdefault(
            "reply", _post(handle.url, "squad", REQUESTS[0][1])))
        th.start()
        assert started.wait(30)
        handle.frontend.begin_drain()
        code, body, hdr = _post(handle.url, "classify", REQUESTS[1][1])
        assert code == 503 and "draining" in body["error"]
        assert hdr["Retry-After"] == "5"
        health = _strict_json(_get(handle.url, "/healthz"))
        assert health["draining"] is True and health["inflight"] == 1
        assert "bert_serve_requests_total" in _get(handle.url, "/metrics")
        th.join(30)
        assert inflight["reply"][0] == 200
        assert handle.frontend.wait_idle(5) and handle.scheduler.wait_idle(5)
    finally:
        engine.forward = forward
        handle.close()


def test_entry_point_drains_and_exits_zero_on_sigterm(fixture_dir, tmp_path):
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_server",
         *_argv(fixture_dir, ".npz", "--device", "cpu", "--port_file",
                str(port_file), "--drain_timeout", "10")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 120
        while not port_file.exists() and proc.poll() is None \
                and time.time() < deadline:
            time.sleep(0.1)
        assert port_file.exists(), proc.communicate(timeout=30)[0]
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        assert _post(url, "squad", REQUESTS[0][1])[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "drain: admission stopped" in out and "drain: complete" in out


# -- the flags ----------------------------------------------------------------

def _jax_parser():
    import bert_pytorch_tpu.config as jax_config
    import run_server as jax_run_server

    real = jax_config.merge_args_with_config
    seen = []

    def capture(parser, *a, **kw):
        seen.append(parser)
        return real(parser, *a, **kw)

    jax_config.merge_args_with_config = capture
    try:
        jax_run_server.parse_arguments(["--model_config_file", "x"])
    finally:
        jax_config.merge_args_with_config = real
    (parser,) = seen
    return parser


def _flags(parser):
    import argparse

    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_every_jax_server_flag_is_served_or_refused():
    from bert_pytorch_tpu_torch import run_server

    jax_flags = _flags(_jax_parser())
    port_flags = _flags(run_server.build_parser())
    refused, tuning = run_server._REFUSED, run_server._TUNING
    assert set(port_flags) - {"device"} == set(jax_flags)
    assert not set(refused) & set(tuning)
    assert set(refused) | set(tuning) <= set(jax_flags)
    assert set(tuning.values()) <= set(refused)
    for dest, flag in jax_flags.items():
        mine = port_flags[dest]
        assert mine.default == flag.default, dest
        assert (mine.choices is None) == (flag.choices is None), dest
        if flag.choices is not None:
            assert set(mine.choices) == set(flag.choices), dest
    # a refused flag's default leaves its feature off
    for dest, off in refused.items():
        assert jax_flags[dest].default in off, dest


# the SLO plane, the prober, the injector and --output_dir are served
# (tests/test_torch_slo.py::test_lifted_serve_flag_is_served)
ON = {"serve_replicas": ["--serve_replicas", "2"],
      "serve_mesh": ["--serve_mesh", "model=2"],
      "force_cpu": ["--force_cpu"]}


@pytest.mark.parametrize("dest", sorted(ON))
def test_refused_flag_raises_naming_queue_a_item_1(dest):
    from bert_pytorch_tpu_torch import run_server

    assert set(ON) == set(run_server._REFUSED)
    base = ["--model_config_file", "x", "--device", "cpu"]
    args = run_server.parse_arguments(base + ON[dest])
    with pytest.raises(NotImplementedError,
                       match="queue A item 1: the serving engine and the "
                             "serving planes") as e:
        run_server.serve(args, log=lambda m: None)
    if dest == "force_cpu":
        assert "--device cpu" in str(e.value)
    # the flags of the ported planes are accepted
    run_server.refuse_unported(run_server.parse_arguments(
        base + ["--probe_interval_s", "3", "--slo_inject_latency_ms", "9",
                "--prober", "on", "--output_dir", "out"]))


def test_cost_per_device_hour_flag_then_env_then_one(monkeypatch):
    from bert_pytorch_tpu_torch.telemetry.stepwatch import (
        resolve_cost_per_device_hour)

    monkeypatch.delenv("BERT_COST_PER_DEVICE_HOUR", raising=False)
    assert resolve_cost_per_device_hour() == 1.0
    monkeypatch.setenv("BERT_COST_PER_DEVICE_HOUR", "2.5")
    assert resolve_cost_per_device_hour() == 2.5
    assert resolve_cost_per_device_hour(4.0) == 4.0
    monkeypatch.setenv("BERT_COST_PER_DEVICE_HOUR", "n/a")
    assert resolve_cost_per_device_hour() == 1.0
