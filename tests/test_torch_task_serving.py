"""The port's five-task server (bert_pytorch_tpu_torch.run_server) end to
end on the CPU, against the JAX package's run_server on the same
parameters.

Tiny models of the five registered tasks (2 layers, E=64, 4 heads, I=128,
max_pos 128) are initialised in JAX, saved as the JAX server's
params-only checkpoints and exported as the port's `.npz` of the flat
flax tree. Both servers start in f32 with one bucket, 64, and serve POST
/v1/{squad,ner,classify,choice,embed}; the same requests, sent at once so
they pack, must give the same answers: labels, choices and span texts
exactly, probabilities and embeddings within 1e-4. The port's packed
answers are held against its own --packing off answers (the same tiers),
its status codes against the JAX services' on the same bad requests, and
/healthz must list the five tasks. Plus the entry point's refusals and a
CPU rehearsal of chip_smoke.py's five-route serve phase.
"""

import http.client
import json
import os
import sys
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("choice", "classify", "embed", "ner", "squad")
NER_LABELS = ["O", "B-PER", "I-PER", "B-LOC", "I-LOC"]
WORDS = ("the cat sat on a mat while dog ran in park and red blue green "
         "film was good bad great plot story slow fast which one is true "
         "john smith paris london met visited who where did").split()
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [".", "?"]
CFG = {"vocab_size": len(VOCAB), "hidden_size": 64, "num_hidden_layers": 2,
       "num_attention_heads": 4, "intermediate_size": 128,
       "max_position_embeddings": 128, "next_sentence": True,
       "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
FLOAT_TOL = 1e-4


def _text(rng, n):
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), n))


def _requests():
    """(route, body) pairs that fit the 64 bucket, several a route."""
    rng = np.random.RandomState(0)
    out = []
    for n in (6, 14, 25):
        out.append(("squad", {"question": "who sat on the mat ?",
                              "context": "the cat sat on the mat . "
                              + _text(rng, n)}))
        out.append(("ner", {"tokens": _text(rng, n).split()}))
        out.append(("classify", {"text": _text(rng, n),
                                 "text_pair": _text(rng, 8)}))
        out.append(("classify", {"text": _text(rng, n)}))
        out.append(("choice", {"question": "which one is true ?",
                               "choices": [_text(rng, 3 + c)
                                           for c in range(2 + n % 3)]}))
        out.append(("embed", {"texts": [_text(rng, k + n % 5)
                                        for k in (2, 5, 9)]}))
    out.append(("ner", {"text": "john smith visited paris ."}))
    out.append(("embed", {"text": "the cat sat on a mat"}))
    out.append(("choice", {"choices": ["red cat", "blue dog"]}))
    return out


def _jax_models(config):
    import jax.numpy as jnp

    from bert_pytorch_tpu.models import bert as jbert

    f32 = jnp.float32
    return {
        "squad": (jbert.BertForQuestionAnswering(config, dtype=f32), 2),
        "ner": (jbert.BertForTokenClassification(
            config, num_labels=len(NER_LABELS) + 1, dtype=f32), 2),
        "classify": (jbert.BertForSequenceClassification(
            config, num_labels=2, dtype=f32), 2),
        "choice": (jbert.BertForMultipleChoice(config, num_choices=4,
                                               dtype=f32), 3),
        "embed": (jbert.BertForSentenceEmbedding(config, num_labels=2,
                                                 dtype=f32), 2)}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from bert_pytorch_tpu.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu.training.state import unbox

    root = tmp_path_factory.mktemp("torch_task_serving")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg_path = root / "model_config.json"
    cfg_path.write_text(json.dumps(dict(CFG, vocab_file=str(vocab))))
    config = BertConfig.from_json_file(str(cfg_path))
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    for i, (task, (model, rank)) in enumerate(_jax_models(config).items()):
        s = jnp.zeros((1, 4, 16) if rank == 3 else (1, 16), jnp.int32)
        params = unbox(model.init(jax.random.PRNGKey(10 + i), s, s,
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
            "--port", "0", "--buckets", "64", "--batch_rows", "4",
            "--serve_dtype", "float32", "--batch_wait_ms", "20",
            "--labels", *NER_LABELS]
    for task in TASKS:
        argv += ["--task_checkpoint", f"{task}={root / (task + suffix)}"]
    return argv + list(extra)


def _post(url, route, body, raw=None, timeout=120):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url + f"/v1/{route}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _post_oversized(url, route):
    """A Content-Length over the 1 MiB body limit, sent as headers alone."""
    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=60)
    try:
        conn.putrequest("POST", f"/v1/{route}")
        conn.putheader("Content-Length", str((1 << 20) + 1))
        conn.endheaders()
        return conn.getresponse().status
    finally:
        conn.close()


BAD = [("ner", {"tokens": []}), ("ner", {"tokens": [1, 2]}),
       ("ner", {"tokens": ["the"] * 70}),
       ("classify", {"text": ""}), ("classify", {"text_pair": "a"}),
       ("classify", {"text": "the cat", "text_pair": 3}),
       ("choice", {"choices": ["the cat"]}),
       ("choice", {"question": 3, "choices": ["a", "b"]}),
       ("choice", {"choices": ["a", " "]}),
       ("choice", {"choices": ["the cat"] * 17}),
       ("embed", {"texts": []}), ("embed", {"texts": "the cat"}),
       ("embed", {"texts": ["the cat"] * 33}),
       ("squad", {"question": "who ?"}), ("glue", {"text": "a"})]


def _exchange(url):
    """Every request of _requests at once (so they pack), every bad
    request, the malformed bodies, the oversized ones, and /healthz."""
    reqs = _requests()
    with ThreadPoolExecutor(len(reqs)) as ex:
        answers = [f.result() for f in
                   [ex.submit(_post, url, r, b) for r, b in reqs]]
    codes = [_post(url, r, b)[0] for r, b in BAD]
    codes += [_post(url, r, None, raw=raw)[0]
              for r in ("classify", "embed")
              for raw in (b"{not json", b"[1, 2]")]
    codes += [_post_oversized(url, r) for r in ("classify", "choice")]
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    return answers, codes, health


def _port_serve(root, *extra):
    from bert_pytorch_tpu_torch import run_server

    args = run_server.parse_arguments(_argv(root, ".npz", "--device", "cpu",
                                            *extra))
    return run_server.serve(args, log=lambda m: None)


@pytest.fixture(scope="module")
def port_exchange(fixture_dir):
    handle = _port_serve(fixture_dir)
    try:
        return _exchange(handle.url)
    finally:
        handle.close()


@pytest.fixture(scope="module")
def jax_exchange(fixture_dir):
    import run_server as jax_run_server

    handle = jax_run_server.serve(jax_run_server.parse_arguments(
        _argv(fixture_dir, "_ckpt", "--request_tracing", "off")))
    try:
        return _exchange(handle.url)
    finally:
        handle.close()


def _assert_same_answer(route, got, want, tol):
    """Labels, choices and texts exactly; floats within `tol`."""
    if route == "squad":
        assert got["answer"] == want["answer"]
        assert [n["text"] for n in got["nbest"]] == \
            [n["text"] for n in want["nbest"]]
        np.testing.assert_allclose([n["start_logit"] for n in got["nbest"]],
                                   [n["start_logit"] for n in want["nbest"]],
                                   rtol=tol, atol=tol)
    elif route == "ner":
        assert got["labels"] == want["labels"]
        assert got["tokens"] == want["tokens"]
    elif route == "classify":
        assert got["label"] == want["label"]
        assert set(got["scores"]) == set(want["scores"])
        for k, v in want["scores"].items():
            assert abs(got["scores"][k] - v) <= tol, (k, got, want)
    elif route == "choice":
        assert got["choice"] == want["choice"]
        np.testing.assert_allclose(got["scores"], want["scores"], atol=tol)
    else:
        assert got["dim"] == want["dim"] == CFG["hidden_size"]
        assert ("embedding" in got) == ("embedding" in want)
        np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                                   atol=tol)
    assert got["real_tokens"] == want["real_tokens"]


def test_every_route_answers_as_the_jax_server(port_exchange, jax_exchange):
    got, _, _ = port_exchange
    want, _, _ = jax_exchange
    routes = [r for r, _ in _requests()]
    assert set(routes) == set(TASKS)
    assert [c for c, _ in got] == [200] * len(got)
    assert [c for c, _ in want] == [200] * len(want)
    for route, (_, g), (_, w) in zip(routes, got, want):
        _assert_same_answer(route, g, w, FLOAT_TOL)


def test_status_codes_match_the_jax_services(port_exchange, jax_exchange):
    _, got, _ = port_exchange
    _, want, _ = jax_exchange
    assert got == want
    assert got[:len(BAD)] == [400, 400, 413, 400, 400, 400, 400, 400, 400,
                              413, 400, 400, 413, 400, 404]
    assert got[len(BAD):] == [400] * 4 + [413] * 2


def test_healthz_lists_the_five_tasks(port_exchange):
    from bert_pytorch_tpu_torch.tasks import registry

    _, _, health = port_exchange
    assert sorted(health["tasks"]) == list(registry.all_tasks())
    for task, info in health["tasks"].items():
        spec = registry.get(task)
        assert info["head"] == spec.head
        assert info["request_schema"] == dict(spec.request_schema)
        assert info["model_params"] > 0
    # the scheduler ran the choice requests
    assert sum(n for k, n in health["scheduler"]["batches"].items()
               if k.startswith("choice/")) >= 1


def test_packed_answers_match_packing_off(fixture_dir, port_exchange):
    packed, _, _ = port_exchange
    handle = _port_serve(fixture_dir, "--packing", "off")
    try:
        reqs = _requests()
        with ThreadPoolExecutor(len(reqs)) as ex:
            alone = [f.result() for f in
                     [ex.submit(_post, handle.url, r, b) for r, b in reqs]]
    finally:
        handle.close()
    for (route, _), (_, p), (_, q) in zip(_requests(), packed, alone):
        _assert_same_answer(route, p, q, 1e-5)


def test_featurize_workers_answer_as_the_handler_threads(fixture_dir,
                                                         port_exchange):
    """Featurization in worker processes (the card's default): the same
    answers and status codes as in the handler threads, a featurization
    error re-raised in the handler, and the workers gone at close."""
    from bert_pytorch_tpu_torch.serving.frontend import Featurizer

    in_threads, codes, _ = port_exchange
    handle = _port_serve(fixture_dir)
    pool = Featurizer(handle.featurizer.tokenizer, workers=2)
    try:
        assert handle.featurizer.workers == 0    # the CPU's default
        for service in handle.frontend.services.values():
            service.featurize = pool
        workers = list(pool._pool._processes.values())
        assert len(workers) == 2
        answers, worker_codes, _ = _exchange(handle.url)
    finally:
        handle.close()
        pool.close()
    assert worker_codes == codes
    assert [c for c, _ in answers] == [200] * len(answers)
    for (route, _), (_, got), (_, want) in zip(_requests(), answers,
                                               in_threads):
        _assert_same_answer(route, got, want, 1e-5)
    assert not any(p.is_alive() for p in workers)


def test_entry_point_refusals(fixture_dir):
    from bert_pytorch_tpu_torch import run_server

    argv = _argv(fixture_dir, ".npz", "--device", "cpu")
    i = argv.index("--labels")
    no_labels = argv[:i] + argv[i + 1 + len(NER_LABELS):]
    with pytest.raises(SystemExit, match="serving ner requires --labels"):
        run_server.serve(run_server.parse_arguments(no_labels),
                         log=lambda m: None)
    with pytest.raises(SystemExit, match="registered: choice, classify, "
                                         "embed, ner, squad"):
        run_server.serve(run_server.parse_arguments(
            argv + ["--task_checkpoint", "glue=x.npz"]), log=lambda m: None)


def test_engine_and_scheduler_demux_by_output_kind():
    """The engine refuses an unknown kind; the scheduler hands a 'segment'
    task its segment's pooled output and a 'token' task its token span,
    from one packed batch each."""
    import torch

    from bert_pytorch_tpu_torch.serving.batcher import Scheduler
    from bert_pytorch_tpu_torch.serving.engine import TorchServingEngine

    with pytest.raises(ValueError, match="unknown output kind"):
        TorchServingEngine({}, torch.device("cpu"),
                           output_kinds={"x": "pooled"})

    def pooled(batch):        # (B, G=2, 2): the segment id and its length
        seg = batch["segment_ids"]
        hits = torch.stack([(seg == g).sum(-1) for g in (1, 2)], 1)
        return torch.stack([torch.tensor([1., 2.]).expand(len(seg), 2),
                            hits.float()], -1)

    def tokens(batch):
        return batch["input_ids"].float(), -batch["input_ids"].float()

    engine = TorchServingEngine({"seg": pooled, "tok": tokens},
                                torch.device("cpu"), buckets=(16,),
                                batch_rows=2, max_segments=2,
                                output_kinds={"seg": "segment",
                                              "tok": "token"})
    sch = Scheduler(engine, batch_wait_ms=30).start()
    try:
        reqs = [sch.submit("seg", np.arange(ln) + 1) for ln in (5, 7, 3)]
        outs = [sch.result(r, timeout=30) for r in reqs]
        toks = [sch.submit("tok", np.arange(ln) + 1) for ln in (4, 6)]
        spans = [sch.result(r, timeout=30) for r in toks]
    finally:
        sch.close()
    assert [o.tolist() for o in outs] == [[1.0, 5.0], [2.0, 7.0],
                                          [1.0, 3.0]]
    for (start, end), ln in zip(spans, (4, 6)):
        np.testing.assert_array_equal(start, np.arange(ln) + 1)
        np.testing.assert_array_equal(end, -(np.arange(ln) + 1))
    assert sch.stats()["batches"] == {"seg/16": 1, "tok/16": 1}


def test_chip_smoke_five_route_serve_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's serve phase at a tiny width on the CPU (the plain
    versions): one server for the five tasks, every route in every
    bucket, each new service's 400 and 413, packed against one request a
    row, and a packed 512 forward of each task."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_size=30522,
                                   max_position_embeddings=512)))
    summary = {}
    chip_smoke.phase_serve(torch, np, summary, device="cpu",
                           cfg_path=str(cfg))
    routes = summary["serve"]["routes"]
    assert routes["healthz_tasks"] == list(TASKS)
    # the routes are a main path of the kernels line
    assert summary["launches"]["serve_routes"] == routes["launches"]
    for task in ("ner", "classify", "choice", "embed"):
        assert all(routes["forwards"][f"{task}/{b}"] >= 1
                   for b in chip_smoke.BUCKETS)
        assert routes["error_codes"][task] == [400, 413]
    assert set(routes["packed_vs_padded"]) == set(TASKS)
    for task, r in routes["packed_vs_padded"].items():
        assert r["max_abs_err"] <= r["tol"] < r["planted_demux_fault_err"]
        assert r["sharing_a_row"] >= 2
    assert set(routes["forward512"]) == set(TASKS)
    embed = routes["replies"]["embed"][0]
    assert len(embed["embeddings"]) == 8 and embed["dim"] == 64
