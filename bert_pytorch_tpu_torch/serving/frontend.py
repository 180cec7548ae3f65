"""Stdlib HTTP frontend: POST /v1/<task>, GET /metrics, GET /healthz,
GET /v1/traces, GET /v1/alerts and GET /v1/slo (counterpart of
bert_pytorch_tpu/serving/frontend.py).

One service per registered task: squad, ner, classify, choice and embed.
Each handler thread featurizes its request (tasks/predict, through the
server's `Featurizer`: on a card in worker processes of its own, off this
process's interpreter lock), submits its segments to the
continuous-batching scheduler (a SQuAD request one per sliding window, a
choice request one per choice, an embed request one per text), blocks on
the results and decodes the answer. The request bodies, response keys and
status codes are the JAX services'.

Status mapping: 400 malformed JSON or missing fields, 404 unknown route,
413 longer than the largest bucket (or too many choices or texts), 503
queue full or draining (with Retry-After), 504 admission or result
timeout, 500 engine error.

/metrics renders the server's registry (the scheduler's `bert_serve_*`
families) in the Prometheus text format. Every POST reply carries an
`X-Trace-Id` header naming the trace ids the scheduler minted for it (one
a submitted segment, comma-joined), and `GET /v1/traces[?id=a,b][&n=K]`
serves the trace ring as one strict Chrome-trace JSON document. The
graceful drain: `begin_drain()` stops admission (503 + Retry-After) while
/metrics, /healthz (`draining`, `inflight`) and the requests already
admitted carry on, and `wait_idle()` blocks until those have finished.
With the SLO plane on (`slo_engine`, telemetry/slo.py), GET /v1/alerts
serves its firing and recently resolved alerts and GET /v1/slo its
per-SLO budget view; without it both answer 404 naming --slo_config.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs

import numpy as np

from bert_pytorch_tpu_torch.serving.batcher import (Overloaded,
                                                    RequestTimeout, TooLong)
from bert_pytorch_tpu_torch.serving.request_trace import collect_trace_ids
from bert_pytorch_tpu_torch.tasks import predict, squad
from bert_pytorch_tpu_torch.telemetry.registry import CONTENT_TYPE_PROM

MAX_BODY_BYTES = 1 << 20
# the listening socket's backlog: connections the kernel completes while
# the accept thread is busy. http.server's default of 5 drops the SYN of
# every further connection of a burst, and the client waits out TCP's
# retransmission (1 s, then 3 s, ...) or sees its connection reset: a
# request with no status at all. Far above the admission queue's bound,
# so a burst reaches the scheduler, which sheds with 503 when it must.
LISTEN_BACKLOG = 1024


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


class HTTPError(Exception):
    def __init__(self, code: int, message: str,
                 retry_after: Optional[int] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.retry_after = retry_after


def round_list(values, digits: int) -> list:
    """`[round(float(x), digits) for x in values]`, the same floats, in
    numpy: rint(x * 10**digits) / 10**digits is the double nearest the
    rounded decimal, as round()'s is, wherever the scaled value lies
    clear of a .5 tie; the few that lie within its rounding error of one
    (and any beyond 2**52, or not finite) take round() itself. An
    embedding's floats, rounded one by one, cost the handler thread
    more of the interpreter lock than the rest of its request."""
    x = np.asarray(values, np.float64).reshape(-1)
    scale = 10.0 ** digits
    scaled = x * scale
    out = (np.rint(scaled) / scale).tolist()
    with np.errstate(invalid="ignore"):
        near = ~(np.abs(scaled - np.floor(scaled) - 0.5) > 1e-6) \
            | ~(np.abs(scaled) < 2.0 ** 52)
    for i in np.flatnonzero(near).tolist():
        out[i] = round(float(x[i]), digits)
    return out


# -- featurization: fn(tokenizer, *args), in the caller or in a worker -------

_worker_tokenizer = None


def _init_worker(tokenizer) -> None:
    global _worker_tokenizer
    _worker_tokenizer = tokenizer


def _in_worker(fn, args):
    return fn(_worker_tokenizer, *args)


def _squad_features(tokenizer, question: str, context: str,
                    max_seq_length: int, doc_stride: int,
                    max_query_length: int):
    example = predict.make_squad_example("serve", question, context)
    return example, predict.qa_featurize(
        example, tokenizer, max_seq_length=max_seq_length,
        doc_stride=doc_stride, max_query_length=max_query_length)


def _ner_features(tokenizer, tokens, max_pieces: int):
    return predict.ner_encode_tokens(tokens, tokenizer,
                                     max_pieces=max_pieces)


def _pair_features(tokenizer, pairs, max_pieces: int):
    return [predict.encode_pair(tokenizer, a, b, max_pieces=max_pieces)
            for a, b in pairs]


class Featurizer:
    """Runs the services' featurization, `fn(tokenizer, *args)`, for
    every task. With `workers` > 0 it runs in that many processes of its
    own (spawned, each holding a copy of the tokenizer): a handler thread
    waits for its features without holding this process's interpreter
    lock, which the scheduler, the HTTP threads and the decoders share,
    and several requests tokenize at once. With `workers` 0 it runs in
    the calling thread under one lock (one tokenizer serves every task).
    A worker's exception re-raises in the caller. Spawning re-imports the
    main script in each worker, so a script that builds a Featurizer with
    workers guards its entry with `if __name__ == "__main__"`."""

    def __init__(self, tokenizer, workers: int = 0):
        self.tokenizer = tokenizer
        self.workers = int(workers)
        self._lock = threading.Lock()
        self._pool = None
        if self.workers > 0:
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(tokenizer,))
            # the pool starts a process a submit while none is idle: start
            # them all now, so that no request waits for one to import
            warm = [self._pool.submit(_in_worker, _pair_features,
                                      ([("warm", None)], 8))
                    for _ in range(self.workers)]
            for f in warm:
                f.result()

    def __call__(self, fn, *args):
        if self._pool is None:
            with self._lock:
                return fn(self.tokenizer, *args)
        return self._pool.submit(_in_worker, fn, args).result()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


class _TaskService:
    """What every task's service shares: the scheduler, the server's
    Featurizer (`featurize`) and `_submit_all`."""

    def __init__(self, scheduler, featurize: Featurizer):
        self.scheduler = scheduler
        self.featurize = featurize

    def _submit_all(self, submits) -> list:
        """Submit a request of several parts (an iterable of
        scheduler.submit argument tuples). When a part is shed, the parts
        already queued will still be computed: wait them out, so none is
        orphaned without its outcome counted, then raise the shed."""
        reqs = []
        try:
            for args in submits:
                reqs.append(self.scheduler.submit(*args))
        except Exception:
            for req in reqs:
                try:
                    self.scheduler.result(req)
                except Exception:
                    pass
            raise
        return reqs


class SquadService(_TaskService):
    """Featurize -> submit (one request per sliding window) -> n-best
    decode."""

    def __init__(self, scheduler, featurize: Featurizer, answer_cfg=None,
                 doc_stride: int = 128, max_query_length: int = 64):
        super().__init__(scheduler, featurize)
        self.answer_cfg = answer_cfg or squad.AnswerConfig()
        self.doc_stride = int(doc_stride)
        self.max_query_length = int(max_query_length)

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        question = body.get("question")
        context = body.get("context")
        if not isinstance(question, str) or not isinstance(context, str) \
                or not question.strip() or not context.strip():
            raise HTTPError(400, "body must carry non-empty string "
                                 "'question' and 'context'")
        try:
            example, feats = self.featurize(
                _squad_features, question, context,
                self.scheduler.engine.max_bucket, self.doc_stride,
                self.max_query_length)
        except ValueError as e:
            raise HTTPError(400, f"featurization failed: {e}")
        reqs = self._submit_all(
            ("squad", np.asarray(feat.input_ids[:ln], np.int32),
             np.asarray(feat.segment_ids[:ln], np.int32))
            for feat, ln in ((f, predict.feature_length(f))
                             for f in feats))
        raws = []
        for feat, req in zip(feats, reqs):
            start, end = self.scheduler.result(req)
            raws.append(squad.RawResult(unique_id=feat.unique_id,
                                        start_logits=start.tolist(),
                                        end_logits=end.tolist()))
        out = predict.qa_decode(example, feats, raws, self.answer_cfg)
        out["n_windows"] = len(feats)
        out["real_tokens"] = sum(predict.feature_length(f) for f in feats)
        return out


class NerService(_TaskService):
    """Pre-split words (or whitespace-split text) -> one segment -> a label
    per word."""

    def __init__(self, scheduler, featurize: Featurizer,
                 id_to_label: Dict[int, str]):
        super().__init__(scheduler, featurize)
        self.id_to_label = dict(id_to_label)

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        tokens = body.get("tokens")
        if isinstance(body.get("text"), str) and tokens is None:
            tokens = body["text"].split()
        if not isinstance(tokens, list) or not tokens \
                or not all(isinstance(t, str) for t in tokens):
            raise HTTPError(400, "body must carry 'tokens' (list of "
                                 "strings) or 'text'")
        try:
            ids, piece_word = self.featurize(
                _ner_features, tokens, self.scheduler.engine.max_bucket)
        except ValueError as e:
            raise HTTPError(413, str(e))
        req = self.scheduler.submit("ner", np.asarray(ids, np.int32))
        logits = self.scheduler.result(req)
        labels = predict.ner_decode(logits, piece_word, self.id_to_label,
                                    n_words=len(tokens))
        return {"tokens": tokens, "labels": labels,
                "real_tokens": len(ids)}


class ClassifyService(_TaskService):
    """GLUE-style pair classification: ([CLS] text [SEP] text_pair [SEP])
    by `encode_pair`, the training featurizer, as one segment; its pooled
    logits decode to a label and the softmax."""

    def __init__(self, scheduler, featurize: Featurizer, class_names):
        super().__init__(scheduler, featurize)
        self.class_names = list(class_names)

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        text = body.get("text")
        pair = body.get("text_pair")
        if not isinstance(text, str) or not text.strip():
            raise HTTPError(400, "body must carry non-empty string 'text' "
                                 "(optional 'text_pair')")
        if pair is not None and not isinstance(pair, str):
            raise HTTPError(400, "'text_pair' must be a string")
        try:
            (ids, types), = self.featurize(
                _pair_features, [(text, pair or None)],
                self.scheduler.engine.max_bucket)
        except ValueError as e:
            raise HTTPError(400, f"featurization failed: {e}")
        req = self.scheduler.submit("classify", np.asarray(ids, np.int32),
                                    np.asarray(types, np.int32))
        out = predict.classify_decode(self.scheduler.result(req),
                                      self.class_names)
        out["real_tokens"] = len(ids)
        return out


class ChoiceService(_TaskService):
    """Multiple choice: one segment per (question, choice) pair, the
    scores softmaxed across the choices on the host."""

    MAX_CHOICES = 16

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        question = body.get("question") or ""
        choices = body.get("choices")
        if not isinstance(question, str):
            raise HTTPError(400, "'question' must be a string")
        if not isinstance(choices, list) or len(choices) < 2 \
                or not all(isinstance(c, str) and c.strip()
                           for c in choices):
            raise HTTPError(400, "body must carry 'choices': a list of "
                                 ">=2 non-empty strings")
        if len(choices) > self.MAX_CHOICES:
            raise HTTPError(413, f"{len(choices)} choices > "
                                 f"{self.MAX_CHOICES}")
        try:
            encoded = self.featurize(
                _pair_features,
                [(question or choice, choice if question else None)
                 for choice in choices], self.scheduler.engine.max_bucket)
        except ValueError as e:
            raise HTTPError(400, f"featurization failed: {e}")
        reqs = self._submit_all(
            ("choice", np.asarray(ids, np.int32),
             np.asarray(types, np.int32))
            for ids, types in encoded)
        scores = [float(np.asarray(self.scheduler.result(req)))
                  for req in reqs]
        out = predict.choice_decode(scores)
        out["real_tokens"] = sum(len(ids) for ids, _ in encoded)
        return out


class EmbedService(_TaskService):
    """Batch embedding: one segment per text, each answered with its
    L2-normalised mean-pooled embedding ('texts' for a batch, 'text' for
    one)."""

    MAX_TEXTS = 32

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        texts = body.get("texts")
        single = body.get("text")
        if texts is None and isinstance(single, str):
            texts = [single]
        if not isinstance(texts, list) or not texts \
                or not all(isinstance(t, str) and t.strip()
                           for t in texts):
            raise HTTPError(400, "body must carry 'text' (string) or "
                                 "'texts' (list of non-empty strings)")
        if len(texts) > self.MAX_TEXTS:
            raise HTTPError(413, f"{len(texts)} texts > {self.MAX_TEXTS} "
                                 "per request; batch client-side")
        try:
            encoded = [ids for ids, _types in self.featurize(
                _pair_features, [(text, None) for text in texts],
                self.scheduler.engine.max_bucket)]
        except ValueError as e:
            raise HTTPError(400, f"featurization failed: {e}")
        reqs = self._submit_all(("embed", np.asarray(ids, np.int32))
                                for ids in encoded)
        embs = [np.asarray(self.scheduler.result(req), np.float32)
                for req in reqs]
        out = {"embeddings": [round_list(e, 6) for e in embs],
               "dim": int(embs[0].shape[-1]),
               "real_tokens": sum(len(ids) for ids in encoded)}
        if isinstance(single, str) and body.get("texts") is None:
            out["embedding"] = out["embeddings"][0]
        return out


class ServingFrontend:
    """One HTTP server: `services` maps task name to a
    callable(body_dict) -> response_dict, routed at POST /v1/<task>;
    GET /metrics renders `registry`, GET /healthz answers `healthz_fn()`
    (plus `draining` and `inflight`), GET /v1/traces exports `trace_ring`
    (404 when tracing is off), GET /v1/alerts and GET /v1/slo serve
    `slo_engine`'s views (404 when the SLO plane is off)."""

    def __init__(self, services: Dict[str, Callable], registry,
                 healthz_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 port: int = 0, host: str = "0.0.0.0", trace_ring=None,
                 slo_engine=None):
        self.services = dict(services)
        self.registry = registry
        self.healthz_fn = healthz_fn
        self.trace_ring = trace_ring
        self.slo_engine = slo_engine
        self._draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, body: str, ctype: str,
                      extra: Optional[Dict[str, str]] = None) -> None:
                payload = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _send_json(self, code: int, obj: Dict[str, Any],
                           extra: Optional[Dict[str, str]] = None) -> None:
                self._send(code, json.dumps(obj, sort_keys=True,
                                            default=str),
                           "application/json", extra)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, server.registry.render_prometheus(),
                                   CONTENT_TYPE_PROM)
                    elif path == "/healthz":
                        h = server.healthz_fn() if server.healthz_fn else {}
                        h["draining"] = server.draining
                        h["inflight"] = server.inflight
                        self._send_json(200, h)
                    elif path == "/v1/traces":
                        self._traces()
                    elif path in ("/v1/alerts", "/v1/slo"):
                        if server.slo_engine is None:
                            self._send_json(404, {
                                "error": "SLO plane is off (start with "
                                         "--slo_config)"})
                        elif path == "/v1/alerts":
                            self._send_json(
                                200, server.slo_engine.alerts_view())
                        else:
                            self._send_json(200,
                                            server.slo_engine.slo_view())
                    else:
                        self._send_json(404, {"error": "not found; try "
                                              "/metrics, /healthz, "
                                              "/v1/traces, /v1/alerts, "
                                              "/v1/slo, or POST "
                                              "/v1/<task>"})
                except BrokenPipeError:
                    pass

            def _traces(self):
                if server.trace_ring is None:
                    self._send_json(404, {"error": "request tracing is "
                                          "disabled"})
                    return
                q = parse_qs(self.path.partition("?")[2])
                ids = ([t for part in q["id"] for t in part.split(",") if t]
                       if q.get("id") else None)
                limit = None
                try:
                    if q.get("n"):
                        limit = max(1, int(q["n"][0]))
                except ValueError:
                    pass
                doc = server.trace_ring.snapshot_events(ids=ids, limit=limit)
                # strict JSON: a NaN here would be a span attribute bug
                self._send(200, json.dumps(doc, sort_keys=True,
                                           allow_nan=False),
                           "application/json")

            def do_POST(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                t0 = time.perf_counter()
                # every scheduler.submit on this thread notes its trace id
                # here; the reply, success or error, carries them
                with collect_trace_ids() as trace_ids:
                    self._do_post(path, t0, trace_ids)

            def _do_post(self, path, t0, trace_ids):
                def hdr(extra=None):
                    if trace_ids:
                        extra = dict(extra or {})
                        extra["X-Trace-Id"] = ",".join(trace_ids)
                    return extra

                try:
                    # consume the body before any reply: unread bytes on a
                    # keep-alive connection would parse as the next request
                    n = int(self.headers.get("Content-Length") or 0)
                    if n > MAX_BODY_BYTES:
                        self.close_connection = True
                        raise HTTPError(413, f"body {n} bytes > "
                                             f"{MAX_BODY_BYTES}")
                    raw = self.rfile.read(n)
                    service = None
                    if path.startswith("/v1/"):
                        service = server.services.get(path[len("/v1/"):])
                    if service is None:
                        raise HTTPError(
                            404, f"unknown route {path}; serving tasks: "
                            + ", ".join(f"/v1/{t}"
                                        for t in sorted(server.services)))
                    try:
                        body = json.loads(raw.decode("utf-8") or "{}")
                    except ValueError as e:
                        raise HTTPError(400, f"malformed JSON: {e}")
                    if not isinstance(body, dict):
                        raise HTTPError(400, "body must be a JSON object")
                    with server._inflight_cv:
                        if server._draining:
                            # admission stopped; requests admitted before
                            # the drain still finish
                            raise HTTPError(503, "draining: this server is "
                                            "shutting down", retry_after=5)
                        server._inflight += 1
                    try:
                        out = service(body)
                    finally:
                        with server._inflight_cv:
                            server._inflight -= 1
                            server._inflight_cv.notify_all()
                    out["latency_ms"] = round(
                        (time.perf_counter() - t0) * 1e3, 3)
                    self._send_json(200, out, hdr())
                except HTTPError as e:
                    extra = ({"Retry-After": str(e.retry_after)}
                             if e.retry_after else None)
                    self._send_json(e.code, {"error": e.message},
                                    hdr(extra))
                except TooLong as e:
                    self._send_json(413, {"error": str(e)}, hdr())
                except Overloaded as e:
                    self._send_json(503, {"error": str(e)},
                                    hdr({"Retry-After": "1"}))
                except RequestTimeout as e:
                    self._send_json(504, {"error": str(e)}, hdr())
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self._send_json(500, {"error": f"{type(e).__name__}: "
                                                   f"{e}"}, hdr())

            def log_message(self, fmt, *args):
                pass

        self._httpd = _HTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-frontend",
            daemon=True)
        self._thread.start()
        self._closed = False

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    @property
    def inflight(self) -> int:
        with self._inflight_cv:
            return self._inflight

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting task requests (503 + Retry-After); /metrics,
        /healthz and the requests already admitted carry on."""
        with self._inflight_cv:
            self._draining = True

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has finished; False when
        `timeout` passed first."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._inflight_cv.wait(timeout=remaining)
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
