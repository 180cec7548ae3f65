"""Stdlib HTTP frontend: POST /v1/squad and GET /healthz (counterpart of
bert_pytorch_tpu/serving/frontend.py, the SQuAD service).

Each handler thread featurizes its request (tasks/predict), submits one
segment per sliding window to the continuous-batching scheduler, blocks on
the results and decodes the answer.

Status mapping: 400 malformed JSON or missing fields, 404 unknown route,
413 longer than the largest bucket, 503 queue full (with Retry-After),
504 admission or result timeout, 500 engine error.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

from bert_pytorch_tpu_torch.serving.batcher import (Overloaded,
                                                    RequestTimeout, TooLong)
from bert_pytorch_tpu_torch.tasks import predict, squad

MAX_BODY_BYTES = 1 << 20


class HTTPError(Exception):
    def __init__(self, code: int, message: str,
                 retry_after: Optional[int] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.retry_after = retry_after


class SquadService:
    """Featurize -> submit (one request per sliding window) -> n-best
    decode."""

    def __init__(self, scheduler, tokenizer, answer_cfg=None,
                 doc_stride: int = 128, max_query_length: int = 64):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.answer_cfg = answer_cfg or squad.AnswerConfig()
        self.doc_stride = int(doc_stride)
        self.max_query_length = int(max_query_length)
        # the tokenizer is shared by every handler thread
        self._tok_lock = threading.Lock()

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        question = body.get("question")
        context = body.get("context")
        if not isinstance(question, str) or not isinstance(context, str) \
                or not question.strip() or not context.strip():
            raise HTTPError(400, "body must carry non-empty string "
                                 "'question' and 'context'")
        try:
            example = predict.make_squad_example("serve", question, context)
            with self._tok_lock:
                feats = predict.qa_featurize(
                    example, self.tokenizer,
                    max_seq_length=self.scheduler.engine.max_bucket,
                    doc_stride=self.doc_stride,
                    max_query_length=self.max_query_length)
        except ValueError as e:
            raise HTTPError(400, f"featurization failed: {e}")
        reqs = []
        try:
            for feat in feats:
                ln = predict.feature_length(feat)
                reqs.append(self.scheduler.submit(
                    "squad", np.asarray(feat.input_ids[:ln], np.int32),
                    np.asarray(feat.segment_ids[:ln], np.int32)))
        except (TooLong, Overloaded):
            # windows already queued will be computed; wait them out so
            # none is orphaned, then report the shed
            for req in reqs:
                req.done.wait(self.scheduler.admission_timeout_s + 30.0)
            raise
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


class ServingFrontend:
    """One HTTP server: `services` maps task name to a
    callable(body_dict) -> response_dict, routed at POST /v1/<task>;
    GET /healthz answers `healthz_fn()`."""

    def __init__(self, services: Dict[str, Callable],
                 healthz_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 port: int = 0, host: str = "0.0.0.0"):
        self.services = dict(services)
        self.healthz_fn = healthz_fn
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send_json(self, code: int, obj: Dict[str, Any],
                           extra: Optional[Dict[str, str]] = None) -> None:
                payload = json.dumps(obj, sort_keys=True,
                                     default=str).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/healthz":
                        self._send_json(200, server.healthz_fn()
                                        if server.healthz_fn else {})
                    else:
                        self._send_json(404, {"error": "not found; try "
                                              "/healthz or POST /v1/<task>"})
                except BrokenPipeError:
                    pass

            def do_POST(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                t0 = time.perf_counter()
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
                    out = service(body)
                    out["latency_ms"] = round(
                        (time.perf_counter() - t0) * 1e3, 3)
                    self._send_json(200, out)
                except HTTPError as e:
                    extra = ({"Retry-After": str(e.retry_after)}
                             if e.retry_after else None)
                    self._send_json(e.code, {"error": e.message}, extra)
                except TooLong as e:
                    self._send_json(413, {"error": str(e)})
                except Overloaded as e:
                    self._send_json(503, {"error": str(e)},
                                    {"Retry-After": "1"})
                except RequestTimeout as e:
                    self._send_json(504, {"error": str(e)})
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self._send_json(500, {"error": f"{type(e).__name__}: "
                                                   f"{e}"})

            def log_message(self, fmt, *args):
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
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

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
