"""The port's SQuAD server (bert_pytorch_tpu_torch.run_server) end to end
on the CPU, against the JAX package's run_server on the same parameters.

A tiny QA model (2 layers, H=128, A=2, max_pos 512) is initialised in
JAX, saved as the JAX server's params-only checkpoint and exported as the
port's `.npz` of the flat flax tree. Both servers start in f32 with
buckets 32/64/512; the same /v1/squad requests — short ones that pack
into one row, and one whose feature rides the 512 bucket (the port's flash
route, plain on the CPU) — must decode to identical answers. The port's
packed responses are also held against its own --packing off responses.
Plus the scheduler's flow control (413/503/504) and the entry point's
refusal to fall back to the CPU."""

import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTEXTS = [
    ("who sat on the mat ?", "the cat sat on the mat while the dog ran in "
     "the park ."),
    ("where did the dog run ?", "a red dog did run fast in the green park "
     "and the blue cat was slow ."),
    ("what serves packed rows ?", "bert serves packed rows to the park and "
     "the cat sat on a mat ."),
]
LONG = ("when did the cat run ?", " ".join(
    "the {} cat sat on the {} mat and the {} dog did run in the park .".format(
        *("red blue green".split()[(i + j) % 3] for j in range(3)))
    for i in range(12)))


def _vocab_words():
    words = set()
    for q, c in CONTEXTS + [LONG]:
        words.update((q + " " + c).split())
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(words)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from bert_pytorch_tpu.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu.models import BertForQuestionAnswering
    from bert_pytorch_tpu.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu.training.state import unbox

    root = tmp_path_factory.mktemp("torch_serving")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(_vocab_words()) + "\n")
    cfg_path = root / "model_config.json"
    cfg_path.write_text(json.dumps({
        "vocab_size": len(_vocab_words()), "hidden_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 256, "max_position_embeddings": 512,
        "next_sentence": True, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0, "vocab_file": str(vocab)}))
    config = BertConfig.from_json_file(str(cfg_path))
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    model = BertForQuestionAnswering(config, dtype=jnp.float32)
    s = jnp.zeros((1, 16), jnp.int32)
    params = unbox(model.init(jax.random.PRNGKey(1), s, s, s)["params"])
    mgr = CheckpointManager(str(root / "squad_ckpt"))
    mgr.save(0, {"params": params})
    mgr.close()
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    np.savez(root / "squad.npz", **flat)
    return root


def _argv(root, ckpt, *extra):
    return ["--model_config_file", str(root / "model_config.json"),
            "--vocab_file", str(root / "vocab.txt"),
            "--task_checkpoint", f"squad={ckpt}", "--port", "0",
            "--buckets", "32,64,512", "--batch_rows", "4",
            "--serve_dtype", "float32", "--batch_wait_ms", "20", *extra]


def _post(url, body, timeout=120):
    req = urllib.request.Request(url + "/v1/squad",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _ask_all(url):
    """Post every request concurrently (so short ones pack), in order."""
    from concurrent.futures import ThreadPoolExecutor

    bodies = [{"question": q, "context": c} for q, c in CONTEXTS + [LONG]]
    with ThreadPoolExecutor(len(bodies)) as ex:
        futures = [ex.submit(_post, url, b) for b in bodies]
        return [f.result() for f in futures]


def _port_serve(root, *extra):
    from bert_pytorch_tpu_torch import run_server

    args = run_server.parse_arguments(
        _argv(root, root / "squad.npz", "--device", "cpu", *extra))
    return run_server.serve(args, log=lambda m: None)


@pytest.fixture(scope="module")
def port_answers(fixture_dir):
    handle = _port_serve(fixture_dir)
    try:
        out = _ask_all(handle.url)
        with urllib.request.urlopen(handle.url + "/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
    finally:
        handle.close()
    return out, health


def test_port_answers_match_jax_server(fixture_dir, port_answers):
    import run_server as jax_run_server

    args = jax_run_server.parse_arguments(
        _argv(fixture_dir, fixture_dir / "squad_ckpt",
              "--request_tracing", "off"))
    handle = jax_run_server.serve(args)
    try:
        jax_out = _ask_all(handle.url)
    finally:
        handle.close()
    port_out, _ = port_answers
    assert [c for c, _ in port_out] == [200] * len(port_out)
    assert [c for c, _ in jax_out] == [200] * len(jax_out)
    for (_, p), (_, j) in zip(port_out, jax_out):
        assert p["answer"] == j["answer"]
        assert p["n_windows"] == j["n_windows"]
        assert p["real_tokens"] == j["real_tokens"]
        assert [n["text"] for n in p["nbest"]] == \
            [n["text"] for n in j["nbest"]]
        np.testing.assert_allclose(
            [n["start_logit"] for n in p["nbest"]],
            [n["start_logit"] for n in j["nbest"]], rtol=1e-4, atol=1e-4)


def test_port_answers_are_spans_and_hit_512(port_answers):
    out, health = port_answers
    for (code, body), (_, ctx) in zip(out, CONTEXTS + [LONG]):
        assert code == 200
        assert body["answer"] and body["answer"] in ctx
    assert out[-1][1]["real_tokens"] > 64  # rode the 512 bucket
    batches = health["scheduler"]["batches"]
    assert batches.get("squad/512", 0) >= 1
    assert health["device"] == "cpu" and health["packing"] is True


def test_packed_matches_packing_off(fixture_dir, port_answers):
    packed, _ = port_answers
    handle = _port_serve(fixture_dir, "--packing", "off")
    try:
        padded = _ask_all(handle.url)
    finally:
        handle.close()
    for (_, p), (_, q) in zip(packed, padded):
        assert p["answer"] == q["answer"]
        np.testing.assert_allclose(
            [n["start_logit"] + n["end_logit"] for n in p["nbest"]],
            [n["start_logit"] + n["end_logit"] for n in q["nbest"]],
            rtol=1e-5, atol=1e-5)


def test_http_errors(fixture_dir):
    handle = _port_serve(fixture_dir, "--buckets", "32")
    try:
        assert _post(handle.url, {"question": "who ?"})[0] == 400
        code, body = _post(handle.url, {"question": LONG[0],
                                        "context": LONG[1]})
        assert code == 200 and body["n_windows"] > 1  # windows of 32
        req = urllib.request.Request(handle.url + "/v1/ner", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404
    finally:
        handle.close()


# -- scheduler flow control ---------------------------------------------------


class _StubEngine:
    buckets = (16,)
    batch_rows = 2
    max_segments = 2
    max_bucket = 16

    def __init__(self, stall_s=0.0):
        self.stall_s = stall_s

    def select_bucket(self, length):
        return 16 if length <= 16 else None

    def output_kind(self, task):
        return "token"

    def forward(self, task, batch):
        import time

        time.sleep(self.stall_s)
        ids = np.asarray(batch["input_ids"], np.float32)
        if (ids == 99).any():
            raise RuntimeError("engine fault")
        return ids, -ids


class _TwoBucketEngine(_StubEngine):
    buckets = (16, 32)
    max_bucket = 32

    def select_bucket(self, length):
        return next((b for b in self.buckets if length <= b), None)


def test_scheduler_runs_each_request_in_its_natural_bucket():
    """A short request queued behind a long head rides its own bucket, not
    the head's: its answer cannot depend on what else is queued."""
    from bert_pytorch_tpu_torch.serving.batcher import Scheduler

    sch = Scheduler(_TwoBucketEngine(), batch_wait_ms=200).start()
    try:
        reqs = [sch.submit("squad", np.arange(ln) + 1) for ln in (20, 5, 3)]
        for req, ln in zip(reqs, (20, 5, 3)):
            np.testing.assert_array_equal(sch.result(req, timeout=30)[0],
                                          np.arange(ln) + 1)
        assert sch.stats()["batches"] == {"squad/32": 1, "squad/16": 1}
    finally:
        sch.close()


def test_scheduler_runs_a_backlog_without_a_batching_window():
    """A batch started by a fresh arrival waits one batching window for
    stragglers; the requests it leaves behind (another bucket) run at
    once, not after a second window."""
    from bert_pytorch_tpu_torch.serving.batcher import Scheduler

    sch = Scheduler(_TwoBucketEngine(), batch_wait_ms=1000).start()
    try:
        t0 = time.perf_counter()
        first, second = (sch.submit("squad", np.arange(ln) + 1)
                         for ln in (20, 5))
        sch.result(first, timeout=30)
        t_first = time.perf_counter() - t0
        sch.result(second, timeout=30)
        t_second = time.perf_counter() - t0
        assert sch.stats()["batches"] == {"squad/32": 1, "squad/16": 1}
    finally:
        sch.close()
    assert t_first >= 1.0
    assert t_second - t_first < 0.5


def test_scheduler_packs_sheds_and_expires():
    from bert_pytorch_tpu_torch.serving.batcher import (
        Overloaded, RequestTimeout, Scheduler, TooLong)

    sch = Scheduler(_StubEngine(), queue_size=2)
    with pytest.raises(TooLong):
        sch.submit("squad", np.arange(17))
    sch.submit("squad", np.arange(4))
    sch.submit("squad", np.arange(4))
    with pytest.raises(Overloaded):
        sch.submit("squad", np.arange(4))
    assert sch.stats()["outcomes"] == {"too_long": 1, "overloaded": 1}

    sch = Scheduler(_StubEngine(), batch_wait_ms=20).start()
    try:
        reqs = [sch.submit("squad", np.arange(ln) + 1) for ln in (5, 7, 3)]
        for req, ln in zip(reqs, (5, 7, 3)):
            start, end = sch.result(req, timeout=30)
            np.testing.assert_array_equal(start, np.arange(ln) + 1)
            np.testing.assert_array_equal(end, -(np.arange(ln) + 1))
        assert sch.stats()["batches"] == {"squad/16": 1}  # one packed batch
        # a failing forward fails the requests that rode it, nothing else
        bad = sch.submit("squad", np.full(4, 99))
        with pytest.raises(RuntimeError, match="engine fault"):
            sch.result(bad, timeout=30)
        good = sch.submit("squad", np.arange(3) + 1)
        np.testing.assert_array_equal(sch.result(good, timeout=30)[0],
                                      np.arange(3) + 1)
    finally:
        sch.close()

    # the first batch stalls 1 s; the requests queued behind it outlive
    # the 0.5 s admission budget and resolve 504-style instead of running
    sch = Scheduler(_StubEngine(stall_s=1.0), admission_timeout_s=0.5,
                    batch_wait_ms=0).start()
    try:
        reqs = [sch.submit("squad", np.arange(10)) for _ in range(8)]
        outcomes = []
        for req in reqs:
            try:
                sch.result(req, timeout=30)
                outcomes.append("ok")
            except RequestTimeout:
                outcomes.append("timeout")
        assert "ok" in outcomes and "timeout" in outcomes
    finally:
        sch.close()


def test_scheduler_packs_the_next_batch_while_the_engine_runs():
    """The packing thread packs the next batch, batching window and all,
    while the engine runs this one, so the engine starts it as soon as
    it is free; every thread's busy seconds are in stats()."""
    from bert_pytorch_tpu_torch.serving.batcher import Scheduler

    class Timed(_TwoBucketEngine):
        def __init__(self):
            super().__init__(stall_s=0.4)
            self.spans = []

        def forward(self, task, batch):
            t0 = time.perf_counter()
            out = super().forward(task, batch)
            self.spans.append((t0, time.perf_counter()))
            return out

    engine = Timed()
    sch = Scheduler(engine, batch_wait_ms=200).start()
    try:
        first = sch.submit("squad", np.arange(20) + 1)
        while not engine.spans and sch.stats()["busy_s"]["pack"] == 0.0:
            time.sleep(0.01)
        time.sleep(0.05)
        # arrives while the first batch is on the engine: its own batch,
        # its window spent during the first batch's forward
        second = sch.submit("squad", np.arange(5) + 1)
        sch.result(first, timeout=30)
        np.testing.assert_array_equal(sch.result(second, timeout=30)[0],
                                      np.arange(5) + 1)
        busy = sch.stats()["busy_s"]
    finally:
        sch.close()
    (_, end0), (start1, _) = engine.spans
    assert start1 - end0 < 0.1
    assert set(busy) == {"pack", "forward", "complete"}
    assert busy["forward"] >= 0.8 and busy["pack"] > 0.0


def test_round_list_equals_round_per_float():
    """The embed response's rounding in numpy gives round()'s floats, sign
    of zero, ties and non-finite values included."""
    import math

    from bert_pytorch_tpu_torch.serving.frontend import round_list

    rng = np.random.RandomState(0)
    cases = [rng.randn(20000).astype(np.float32) * np.float32(0.05),
             rng.randn(20000).astype(np.float32),
             (rng.randint(-10 ** 7, 10 ** 7, 20000) / 1e6 + 5e-7),
             (rng.randint(-10 ** 7, 10 ** 7, 20000) / 1e6
              + 5e-7).astype(np.float32),
             np.array([0.0, -0.0, -1e-9, 5e-7, -5e-7, 1.5e-6, 2.5e-6,
                       np.inf, -np.inf, np.nan, 1e300, 123456789.1234565])]
    for values in cases:
        want = [round(float(x), 6) for x in values]
        got = round_list(values, 6)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert type(g) is float
            assert (w != w and g != g) or (
                w == g and math.copysign(1.0, w) == math.copysign(1.0, g))


# -- the entry point and the package's imports --------------------------------


def test_device_cuda_without_gpu_raises(fixture_dir, monkeypatch):
    from bert_pytorch_tpu_torch import resolve_device, run_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    args = run_server.parse_arguments(
        _argv(fixture_dir, fixture_dir / "squad.npz"))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_server.serve(args, log=lambda m: None)
    assert resolve_device("cpu") == torch.device("cpu")


_FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|flax|bert_pytorch_tpu)(\.|\s|$)", re.M)


def _port_sources():
    pkg = os.path.join(REPO, "bert_pytorch_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_never_imports_jax_or_the_jax_package():
    """Neither the source text nor the import graph of the port (and
    chip_smoke.py) reaches jax, flax or bert_pytorch_tpu; the pattern
    leaves the port's own name, bert_pytorch_tpu_torch, alone."""
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            hits = _FORBIDDEN.findall(f.read())
        assert not hits, f"{path} imports {hits}"
    mods = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3]
        if rel != "chip_smoke":
            mods.append(rel.replace(os.sep, ".").replace(".__init__", ""))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'bert_pytorch_tpu'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_serve_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's serving phase, run at a tiny width on the CPU (the
    plain versions): requests, answers, the 512 bucket and the packed
    batch against the plain-version model all work before a card is
    asked for."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "vocab_size": 30522, "hidden_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 256,
        "max_position_embeddings": 512, "next_sentence": True}))
    summary = {}
    chip_smoke.phase_serve(torch, np, summary, device="cpu",
                           cfg_path=str(cfg))
    serve = summary["serve"]
    assert serve["requests"] == 5
    assert serve["forwards"]["squad/512"] >= 1
    packed = serve["packed512"]
    assert packed["segments"] > 8                    # rows hold several
    for dtype in ("bfloat16", "float32"):
        assert packed[dtype]["max_abs_err"] == 0.0   # plain vs plain
