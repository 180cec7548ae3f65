"""The port's SLO plane, canary prober, fault injector and serve log
directory against the JAX package's, on the CPU.

- `SLOEngine`: the same event stream (counter increments, histogram
  observations, a gauge) on an injected clock through JAX's engine over
  JAX's MetricsRegistry and through the port's over its own:
  `alerts_view()`, `slo_view()`, `health_summary()` and `status()` equal
  at every tick, for an availability burst that pages and resolves, the
  `min_events` guard, a latency alert carrying trace ids, a threshold
  spec and an external alert source;
- `load_slo_config`: `configs/slo.json` loads as JAX loads it, and the
  malformed configs raise JAX's errors;
- the prober's verifiers and `canonicalize` give JAX's verdicts, and each
  `FaultInjector` mode does what JAX's does under `force()`;
- end to end: the port's server at 2 layers, width 32, the five tasks,
  buckets 32 and 64, with the drill configuration of scripts/check_slo.sh
  (page 3 s / 12 s at 2.0, ticket 6 s / 24 s at 1.5, budget 0.05,
  min_events 3, an evaluation every 0.25 s, a probe every 0.5 s): a clean
  run fires nothing and the prober's known answers round-trip for every
  task; `corrupt_answers` on squad flips squad alone; `error_burst` pages
  within the short window and resolves after `force(False)`; /v1/alerts
  and /v1/slo answer 404 with the plane off; `--output_dir` writes the
  three serve log files.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("choice", "classify", "embed", "ner", "squad")
NER_LABELS = ("O", "B-PER", "I-PER")
WORDS = ("the cat sat on mat a dog did run in park who film was good bad "
         "red blue green").split()
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [".", "?"]
CFG = {"vocab_size": len(VOCAB), "hidden_size": 32, "num_hidden_layers": 2,
       "num_attention_heads": 4, "intermediate_size": 64,
       "max_position_embeddings": 64, "next_sentence": True,
       "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
# scripts/check_slo.sh's miniature windows and specs
DRILL = {"windows": {"page": {"short_s": 3, "long_s": 12, "burn_rate": 2.0},
                     "ticket": {"short_s": 6, "long_s": 24,
                                "burn_rate": 1.5}},
         "serve": [{"name": "availability", "kind": "availability",
                    "budget": 0.05, "min_events": 3},
                   {"name": "latency_p99", "kind": "latency",
                    "bound_ms": 10000, "budget": 0.05, "min_events": 3}]}
BODIES = {
    "squad": {"question": "who ran ?",
              "context": "the dog did run in the park . the cat sat"},
    "ner": {"tokens": ["a", "dog", "did", "run"]},
    "classify": {"text": "the film was good", "text_pair": "red cat"},
    "choice": {"question": "who sat ?", "choices": ["a dog", "the cat"]},
    "embed": {"texts": ["blue green", "the park"]},
}


# -- the engine against JAX's -------------------------------------------------


class _Ring:
    """A trace ring stand-in both engines read: the slowest ids first."""

    class _T:
        def __init__(self, trace_id):
            self.trace_id = trace_id

    def __init__(self, ids):
        self.ids = list(ids)

    def traces(self, limit=None):
        return [self._T(t) for t in self.ids[:limit]]


def _both_engines(specs, windows, trace_ring=None, external=None):
    """(jax engine, jax registry, port engine, port registry) over the same
    specs, each evaluated with an explicit `now`."""
    from bert_pytorch_tpu.telemetry import registry as jreg
    from bert_pytorch_tpu.telemetry import slo as jslo
    from bert_pytorch_tpu_torch.telemetry import registry as preg
    from bert_pytorch_tpu_torch.telemetry import slo as pslo

    out = []
    for reg_mod, slo_mod in ((jreg, jslo), (preg, pslo)):
        reg = reg_mod.MetricsRegistry(constant_labels={"phase": "serve"})
        eng = slo_mod.SLOEngine(
            [slo_mod.SLOSpec(dict(s), "serve") for s in specs], windows,
            reg, phase="serve", trace_ring=trace_ring,
            time_fn=lambda: 0.0)
        if external is not None:
            eng.add_alert_source(external)
        out += [eng, reg]
    return out


def _families(reg):
    from bert_pytorch_tpu_torch.serving.batcher import LATENCY_BUCKETS_MS

    return (reg.counter("bert_serve_requests_total", "requests",
                        labels=("task", "outcome")),
            reg.histogram("bert_serve_request_latency_ms", "latency",
                          labels=("task",), buckets=LATENCY_BUCKETS_MS),
            reg.gauge("bert_serve_cost_per_1k_tokens", "cost",
                      labels=("task",)))


def _views(eng):
    return (eng.alerts_view(), eng.slo_view(), eng.health_summary(),
            eng.status(), eng.page_firing_since())


WIN = DRILL["windows"]
# scenario -> (specs, ticks); a tick is (seconds since start, ok requests,
# error requests, latencies ms, cost gauge or None)
SCENARIOS = {
    "availability_burst": (
        [{"name": "availability", "kind": "availability", "budget": 0.05,
          "min_events": 3}],
        [(0, 5, 0, (), None), (1, 5, 0, (), None), (2, 1, 6, (), None),
         (3, 0, 8, (), None), (4, 2, 4, (), None), (5, 6, 0, (), None),
         (7, 8, 0, (), None), (9, 8, 0, (), None), (14, 4, 0, (), None),
         (20, 3, 0, (), None)]),
    "min_events_guard": (
        [{"name": "availability", "kind": "availability", "budget": 0.05,
          "min_events": 20}],
        [(0, 0, 0, (), None), (1, 0, 4, (), None), (2, 0, 3, (), None),
         (6, 0, 2, (), None), (7, 0, 5, (), None), (11, 2, 0, (), None)]),
    "latency_trace_ids": (
        [{"name": "latency_p99", "kind": "latency", "bound_ms": 250,
          "budget": 0.05, "min_events": 3}],
        [(0, 0, 0, (10.0, 20.0), None), (1, 0, 0, (30.0, 900.0), None),
         (2, 0, 0, (600.0, 700.0, 40.0, 1200.0), None),
         (3, 0, 0, (2600.0, 300.0), None), (5, 0, 0, (5.0,) * 8, None),
         (9, 0, 0, (5.0,) * 8, None), (16, 0, 0, (7.0,), None)]),
    "threshold": (
        [{"name": "cost_per_1k_tokens", "kind": "threshold",
          "source": "gauge:bert_serve_cost_per_1k_tokens", "agg": "max",
          "bound": 1.0, "budget": 0.05}],
        [(0, 0, 0, (), 0.5), (1, 0, 0, (), 2.0), (2, 0, 0, (), 3.0),
         (3, 0, 0, (), 0.2), (4, 0, 0, (), None), (8, 0, 0, (), 0.1),
         (20, 0, 0, (), 0.1)]),
    "external_source": (
        [{"name": "availability", "kind": "availability", "budget": 0.05,
          "min_events": 3}],
        [(0, 4, 0, (), None), (1, 4, 0, (), None), (2, 4, 0, (), None),
         (3, 4, 0, (), None)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_views_equal_jax_at_every_tick(scenario):
    specs, ticks = SCENARIOS[scenario]
    external_on = {"on": False}

    def external():
        if not external_on["on"]:
            return []
        return [{"slo": "probe_squad", "severity": "page",
                 "source": "prober", "task": "squad", "since_unix": 1.0},
                {"slo": "junk"}]           # dropped: no severity

    ring = _Ring(["t-slow", "t-mid", "t-fast"])
    jeng, jreg, peng, preg = _both_engines(
        specs, WIN, trace_ring=ring,
        external=external if scenario == "external_source" else None)
    fams = [_families(jreg), _families(preg)]
    fired, resolved, burns = set(), set(), []
    for t, ok, err, lats, cost in ticks:
        external_on["on"] = t >= 2
        for counter, hist, gauge in fams:
            for _ in range(ok):
                counter.inc(task="squad", outcome="ok")
            for _ in range(err):
                counter.inc(task="ner", outcome="error")
            for ms in lats:
                hist.observe(ms, task="classify")
            if cost is not None:
                gauge.set(cost, task="embed")
        want = jeng.evaluate(now=100.0 + t)
        got = peng.evaluate(now=100.0 + t)
        assert got == want, (scenario, t)
        assert _views(peng) == _views(jeng), (scenario, t)
        burns.append(max(b["short"] for v in peng.slo_view()["slos"].values()
                         for b in v["burn"].values()))
        fired |= {a["slo"] for a in got["firing"]}
        resolved |= {a["slo"] for a in got["resolved"]}
    metrics = preg.render_prometheus()
    assert "bert_slo_evaluations_total" in metrics
    if scenario == "availability_burst":
        assert fired == {"availability"} == resolved
    elif scenario == "min_events_guard":
        # every short window burns far past its threshold on fewer
        # than 20 events
        assert not fired and max(burns) > 2.0
    elif scenario == "latency_trace_ids":
        assert fired == {"latency_p99"}
        firing = [v for v in peng._resolved] + list(peng._firing.values())
        assert any(a.get("trace_ids") == ring.ids for a in firing)
    elif scenario == "threshold":
        assert fired == {"cost_per_1k_tokens"} == resolved
    else:
        assert fired == {"probe_squad"}
        assert peng.status() == "failing"


def test_checked_in_config_loads_as_jax_loads_it():
    from bert_pytorch_tpu.telemetry import slo as jslo
    from bert_pytorch_tpu_torch.telemetry import slo as pslo

    path = os.path.join(REPO, "configs", "slo.json")
    want, got = jslo.load_slo_config(path), pslo.load_slo_config(path)
    assert got.windows == want.windows
    for phase in ("serve", "train"):
        assert ([vars(s) for s in got.specs_for(phase)]
                == [vars(s) for s in want.specs_for(phase)])
    assert [s.name for s in got.specs_for("serve")] == [
        "availability", "latency_p99", "cost_per_1k_tokens"]


BAD_CONFIGS = {
    "kind": {"serve": [{"name": "x", "kind": "nope"}]},
    "duplicate": {"serve": [
        {"name": "x", "kind": "availability", "budget": 0.1},
        {"name": "x", "kind": "availability", "budget": 0.1}]},
    "budget": {"serve": [{"name": "x", "kind": "availability",
                          "budget": 1.5}]},
    "short_s": {"windows": {"page": {"short_s": 60, "long_s": 5,
                                     "burn_rate": 2}},
                "serve": [{"name": "x", "kind": "availability",
                           "budget": 0.1}]},
    "phase": {"deploy": [{"name": "x", "kind": "availability",
                          "budget": 0.1}]},
    "severities": {"serve": [{"name": "x", "kind": "availability",
                              "budget": 0.1, "severities": ["sms"]}]},
    "burn_rate": {"windows": {"ticket": {"burn_rate": 0}}},
    "direction": {"serve": [{"name": "x", "kind": "threshold",
                             "source": "s", "bound": 1,
                             "direction": "sideways"}]},
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_validation_errors_match_jax(tmp_path, case):
    from bert_pytorch_tpu.telemetry import slo as jslo
    from bert_pytorch_tpu_torch.telemetry import slo as pslo

    path = tmp_path / "slo.json"
    path.write_text(json.dumps(BAD_CONFIGS[case]))
    with pytest.raises(ValueError) as want:
        jslo.load_slo_config(str(path))
    with pytest.raises(ValueError) as got:
        pslo.load_slo_config(str(path))
    assert str(got.value) == str(want.value)
    assert case in str(got.value)


# -- the prober and the injector against JAX's --------------------------------


def _probe_outputs():
    """(task, payload, output) triples: well-formed answers and each kind of
    malformed one."""
    from bert_pytorch_tpu.serving.prober import KNOWN_ANSWER_PAYLOADS as P

    emb = [0.6, 0.8]
    return [
        ("squad", P["squad"], {"answer": "the cat", "nbest": [{"t": 1}],
                               "n_windows": 1, "latency_ms": 3.2}),
        ("squad", P["squad"], {"answer": 3, "nbest": [1], "n_windows": 1}),
        ("squad", P["squad"], {"answer": "x", "nbest": [], "n_windows": 1}),
        ("squad", P["squad"], {"answer": "x", "nbest": [1], "n_windows": 0}),
        ("ner", P["ner"], {"labels": ["O"] * 6}),
        ("ner", P["ner"], {"labels": ["O"] * 5}),
        ("ner", P["ner"], {"labels": ["O"] * 5 + [""]}),
        ("classify", P["classify"], {"label": "pos", "scores": {
            "pos": 0.75, "neg": 0.25}}),
        ("classify", P["classify"], {"label": "pos", "scores": {
            "pos": 0.7, "neg": 0.2}}),
        ("classify", P["classify"], {"label": "x", "scores": {"pos": 1.0}}),
        ("classify", P["classify"], {"label": 1, "scores": {"pos": 1.0}}),
        ("choice", P["choice"], {"choice": 1, "scores": [0.4, 0.6]}),
        ("choice", P["choice"], {"choice": 2, "scores": [0.4, 0.6]}),
        ("choice", P["choice"], {"choice": 0, "scores": [1.0]}),
        ("choice", P["choice"], {"choice": 0, "scores": [0.5, 0.6]}),
        ("embed", P["embed"], {"embedding": emb, "dim": 2}),
        ("embed", P["embed"], {"embeddings": [emb], "dim": 2}),
        ("embed", P["embed"], {"embedding": emb, "dim": 3}),
        ("embed", P["embed"], {"embedding": [0.5, 0.5], "dim": 2}),
        ("embed", P["embed"], {}),
    ]


def test_prober_verdicts_and_canonical_form_equal_jax():
    from bert_pytorch_tpu.serving import prober as jprober
    from bert_pytorch_tpu_torch.serving import prober as pprober
    from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry

    assert pprober.KNOWN_ANSWER_PAYLOADS == jprober.KNOWN_ANSWER_PAYLOADS
    assert pprober.VOLATILE_KEYS == jprober.VOLATILE_KEYS
    verdicts = []
    for task, payload, out in _probe_outputs():
        got = pprober.VERIFIERS[task](payload, out)
        assert got == jprober.VERIFIERS[task](payload, out), (task, out)
        assert (pprober.canonicalize(out) == jprober.canonicalize(out))
        verdicts.append(got is None)
    assert 0 < sum(verdicts) < len(verdicts)
    obj = {"b": [1.23456789, True, (2.5, "x")], "latency_ms": 9.0,
           "a": {"z": 0.000049, "y": None}}
    assert pprober.canonicalize(obj) == jprober.canonicalize(obj) == {
        "a": {"y": None, "z": 0.0}, "b": [1.2346, True, [2.5, "x"]]}
    with pytest.raises(ValueError, match="known-answer"):
        pprober.CanaryProber("http://127.0.0.1:9", ["squad", "poetry"],
                             MetricsRegistry(), print)


class _FakeEngine:
    def __init__(self):
        self.calls = 0

    def forward(self, task, batch):
        self.calls += 1
        if task == "squad":
            return (np.array([1.0, -2.0]), np.array([0.5, 3.0]))
        return np.array([[1.0, 2.0]])


@pytest.mark.parametrize("mode", ["corrupt_answers", "error_burst",
                                  "latency_burst"])
def test_fault_injector_modes_equal_jax(mode):
    from bert_pytorch_tpu.telemetry import slo as jslo
    from bert_pytorch_tpu_torch.telemetry import slo as pslo

    clock = {"t": 0.0}
    engines = []
    for mod in (jslo, pslo):
        eng = _FakeEngine()
        inj = mod.FaultInjector(mode, after_s=5.0, task="squad",
                                latency_ms=30.0, time_fn=lambda: clock["t"])
        inj.install(eng)
        engines.append((eng, inj))

    def outcome(eng, task):
        t0 = time.perf_counter()
        try:
            out = eng.forward(task, None)
        except RuntimeError as e:
            return ("raised", str(e)), time.perf_counter() - t0
        flat = out if isinstance(out, tuple) else (out,)
        return tuple(np.asarray(o).tolist() for o in flat), \
            time.perf_counter() - t0

    # the timer before its arming time, forced on, forced off, the timer
    # after its arming time
    for state, t in ((None, 0.0), (True, 0.0), (False, 6.0), (None, 6.0)):
        clock["t"] = t
        results = []
        for eng, inj in engines:
            inj.force(state)
            results.append([outcome(eng, task) for task in ("squad", "ner")])
        jo, po = results
        assert [o for o, _ in po] == [o for o, _ in jo], (mode, state)
        active = engines[1][1].active()
        assert active == engines[0][1].active() == (state or (
            state is None and t >= 5.0))
        if mode == "latency_burst" and active:
            assert min(dt for _, dt in po) >= 0.03
        if mode == "corrupt_answers" and active:
            assert po[0][0] == ([-1.0, 2.0], [-0.5, -3.0])   # squad negated
            assert po[1][0] == ([[1.0, 2.0]],)              # ner untouched
        if mode == "error_burst" and active:
            assert po[0][0] == ("raised", "slo_inject: synthetic error "
                                          "burst")
    with pytest.raises(ValueError):
        pslo.FaultInjector("flood")
    inj = engines[1][1]
    inj.set_mode("error_burst")
    assert inj.mode == "error_burst"


# -- end to end: the port's server with the SLO plane on ----------------------


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _post(url, route, body, timeout=60):
    req = urllib.request.Request(url + f"/v1/{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait(cond, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def drill_server(tmp_path_factory):
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import init_weights
    from bert_pytorch_tpu_torch.tasks import registry

    root = tmp_path_factory.mktemp("torch_slo")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (root / "model_config.json").write_text(json.dumps(CFG))
    (root / "slo.json").write_text(json.dumps(DRILL))
    config = BertConfig.from_json_file(str(root / "model_config.json"))
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    opts = {"class_names": ["negative", "positive"], "embed_labels": 2,
            "labels": list(NER_LABELS), "max_segments": 8}
    argv = ["--model_config_file", str(root / "model_config.json"),
            "--vocab_file", str(root / "vocab.txt"), "--device", "cpu",
            "--port", "0", "--host", "127.0.0.1", "--buckets", "32,64",
            "--batch_rows", "4", "--serve_dtype", "float32",
            "--batch_wait_ms", "1", "--labels", *NER_LABELS,
            "--slo_config", str(root / "slo.json"),
            "--slo_eval_interval_s", "0.25", "--prober", "on",
            "--probe_interval_s", "0.5", "--slo_inject", "corrupt_answers",
            "--slo_inject_task", "squad", "--slo_inject_after_s", "1e9",
            "--output_dir", str(root / "serve_out")]
    for i, task in enumerate(TASKS):
        model = registry.get(task).build_serving_model(
            config, torch.float32, opts, "cpu")
        init_weights(model, torch.Generator().manual_seed(i), std=0.02)
        torch.save(model.state_dict(), root / f"{task}.pt")
        argv += ["--task_checkpoint", f"{task}={root / (task + '.pt')}"]
    lines = []
    handle = run_server.serve(run_server.parse_arguments(argv),
                              log=lines.append)
    # every task's baseline pinned before a test injects a fault
    assert handle.prober.wait_healthy(timeout=60), handle.prober.status()
    handle.lines = lines
    handle.root = root
    yield handle
    handle.close()


def _probes(handle):
    return {t: s["probes"] for t, s in handle.prober.status()["tasks"].items()}


def _probed_twice_more(handle):
    start = _probes(handle)
    _wait(lambda: all(n >= start[t] + 2 for t, n in _probes(handle).items()),
          what="two more probe rounds")


def test_clean_run_fires_nothing_and_known_answers_round_trip(drill_server):
    h = drill_server
    for _ in range(2):
        for task, body in BODIES.items():
            code, out = _post(h.url, task, body)
            assert code == 200, (task, out)
    _probed_twice_more(h)
    st = h.prober.status()
    assert st["healthy"] and not st["unhealthy_tasks"]
    for task in TASKS:
        s = st["tasks"][task]
        assert s["healthy"] is True and s["baseline_set"], (task, s)
        assert s["mismatches"] == s["errors"] == 0, (task, s)
    code, alerts = _get(h.url, "/v1/alerts")
    assert code == 200 and alerts["firing"] == [] and alerts["status"] == "ok"
    assert alerts["evaluations"] > 0
    code, health = _get(h.url, "/healthz")
    assert health["status"] == "ok" and health["slo"]["alerts_firing"] == 0
    assert health["prober"]["healthy"]
    code, slo = _get(h.url, "/v1/slo")
    assert code == 200 and set(slo["slos"]) == {"availability",
                                                "latency_p99"}
    assert slo["slos"]["availability"]["bad"] == 0


def test_corrupt_answers_flips_squad_alone(drill_server):
    h = drill_server
    assert h.injector.mode == "corrupt_answers"
    h.injector.force(True)
    try:
        _wait(lambda: h.prober.status()["unhealthy_tasks"] == ["squad"],
              what="squad unhealthy")
        _probed_twice_more(h)
        st = h.prober.status()
        assert st["unhealthy_tasks"] == ["squad"]
        assert st["tasks"]["squad"]["mismatches"] >= 1
        code, alerts = _get(h.url, "/v1/alerts")
        assert [a["slo"] for a in alerts["firing"]] == ["probe_squad"]
        assert alerts["status"] == "failing"
        assert _get(h.url, "/healthz")[1]["status"] == "failing"
        for task, body in BODIES.items():       # every request still 200s
            assert _post(h.url, task, body)[0] == 200, task
    finally:
        h.injector.force(False)
    _wait(lambda: h.prober.status()["healthy"], what="squad recovered")
    assert any("PROBE mismatch [squad]" in line for line in h.lines)


def test_error_burst_pages_within_the_short_window_and_resolves(drill_server):
    h = drill_server
    h.injector.set_mode("error_burst")
    h.injector.force(True)
    t0 = time.monotonic()
    try:
        for _ in range(4):
            assert _post(h.url, "classify", BODIES["classify"])[0] == 500

        def paged():
            firing = _get(h.url, "/v1/alerts")[1]["firing"]
            return any(a["slo"] == "availability" and a["severity"] == "page"
                       for a in firing)

        _wait(paged, timeout=DRILL["windows"]["page"]["short_s"] + 2,
              what="the availability page")
        paged_s = time.monotonic() - t0
        assert paged_s <= DRILL["windows"]["page"]["short_s"] + 1.0
        assert _get(h.url, "/healthz")[1]["status"] == "failing"
    finally:
        h.injector.force(False)
        h.injector.set_mode("corrupt_answers")
    t1 = time.monotonic()

    def resolved():
        view = _get(h.url, "/v1/alerts")[1]
        page = [a for a in view["firing"] + view["resolved"]
                if a["slo"] == "availability" and a["severity"] == "page"]
        return bool(page) and all("resolved_unix" in a for a in page)

    _wait(resolved, timeout=DRILL["windows"]["page"]["short_s"] + 3,
          what="the page resolved")
    assert time.monotonic() - t1 <= DRILL["windows"]["page"]["short_s"] + 2
    assert _post(h.url, "classify", BODIES["classify"])[0] == 200
    _wait(lambda: h.prober.status()["healthy"], what="prober recovered")


def test_alerts_and_slo_routes_answer_404_with_the_plane_off():
    from bert_pytorch_tpu_torch.serving.frontend import ServingFrontend
    from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry

    fe = ServingFrontend({}, MetricsRegistry(), host="127.0.0.1")
    try:
        for path in ("/v1/alerts", "/v1/slo"):
            code, out = _get(fe.url, path)
            assert code == 404 and "--slo_config" in out["error"], path
        code, out = _get(fe.url, "/v1/nope")
        assert code == 404 and "/v1/alerts" in out["error"] \
            and "/v1/slo" in out["error"]
    finally:
        fe.close()


@pytest.mark.parametrize("dest", ["output_dir", "prober", "slo_config",
                                  "slo_inject"])
def test_lifted_serve_flag_is_served(drill_server, dest):
    """Each flag the server refused before the SLO plane was ported now
    switches its feature on."""
    from bert_pytorch_tpu_torch import run_server

    h = drill_server
    assert dest not in run_server._REFUSED
    if dest == "slo_config":
        assert h.slo is not None and h.evaluator is not None
        assert _get(h.url, "/v1/slo")[0] == 200
        assert "bert_slo_evaluations_total" in h.registry.render_prometheus()
    elif dest == "prober":
        assert sorted(h.prober.tasks) == list(TASKS)
        assert "bert_probe_total" in h.registry.render_prometheus()
    elif dest == "slo_inject":
        assert h.injector is not None and h.injector.task == "squad"
        assert h.engine.forward.__name__ == "forward"      # wrapped
        assert "slo_inject: corrupt_answers" in " ".join(h.lines)
    else:
        assert (h.root / "serve_out" / "serve_log.txt").exists()


def test_output_dir_writes_the_three_serve_log_files(drill_server):
    h = drill_server
    out = h.root / "serve_out"
    h.close()
    text = (out / "serve_log.txt").read_text()
    assert "serving: listening on" in text and "slo:" in text
    records = [json.loads(x) for x in
               (out / "serve_log.jsonl").read_text().splitlines()]
    header = records[0]
    assert header["tag"] == "header"
    assert header["platform"] == "cpu" and header["torch_version"]
    assert {"git_sha", "cuda_version", "device_kind"} <= set(header)
    serve = [r for r in records if r["tag"] == "serve"]
    assert len(serve) == 1 and serve[0]["requests_ok"] > 0
    assert serve[0]["requests_error"] >= 4
    csv_lines = (out / "serve_log_metrics.csv").read_text().splitlines()
    assert csv_lines[0].startswith("tag,step,time,")
    assert len(csv_lines) == 2 and csv_lines[1].startswith("serve,")
