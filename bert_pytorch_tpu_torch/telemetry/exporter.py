"""Live metrics export: /metrics (Prometheus text) and /healthz over HTTP
(counterpart of bert_pytorch_tpu/telemetry/exporter.py).

Standard library only (`http.server` on a daemon thread): the exporter
adds no dependency, never blocks the train loop and never keeps the
process alive.

- `GET /metrics`: `registry.render_prometheus()`, text/plain version
  0.0.4.
- `GET /healthz`: one JSON object from `healthz_fn` (telemetry/run.py:
  the run's last step, last perf interval, last health-pack flags and
  checkpoint freshness); 200 whenever the server is up.

The handler threads read only host values: the loop publishes floats it
has already read off the card, so a scrape never touches a CUDA tensor.
`port=0` binds an ephemeral port (read `.port`).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from bert_pytorch_tpu_torch.telemetry.registry import CONTENT_TYPE_PROM


class MetricsServer:
    """Serve a registry's /metrics and a /healthz JSON on a daemon
    thread."""

    def __init__(self, registry,
                 healthz_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 port: int = 0, host: str = "0.0.0.0"):
        self.registry = registry
        self.healthz_fn = healthz_fn
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: str, ctype: str) -> None:
                payload = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, server.registry.render_prometheus(),
                                   CONTENT_TYPE_PROM)
                    elif path == "/healthz":
                        h = (server.healthz_fn()
                             if server.healthz_fn is not None else {})
                        self._send(200, json.dumps(h, sort_keys=True,
                                                   default=str),
                                   "application/json")
                    else:
                        self._send(404, "not found: try /metrics or "
                                        "/healthz\n", "text/plain")
                except BrokenPipeError:
                    pass

            def log_message(self, fmt, *args):
                pass  # scrapes must not spam the training stdout

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-exporter",
            daemon=True)
        self._thread.start()
        self._closed = False

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        """Stop serving and release the port. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
