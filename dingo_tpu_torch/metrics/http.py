"""Plain-HTTP metrics exposition for scrapers (port of
dingo_tpu/metrics/http.py, plain ``http.server``). Prometheus scrapers
speak plain HTTP; ``metrics_http_port`` binds this sidecar endpoint
(``server/main.py::maybe_metrics_http``):

    GET /metrics   Prometheus text exposition (registry summaries incl.
                   the per-region store gauges the collector publishes)
    GET /vars      JSON dump (brpc /vars analog)
    GET /healthz   200 ok (liveness)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dingo_tpu_torch.common.metrics import METRICS


class MetricsHttpServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=METRICS):
        self.registry = registry
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._host = host
        self._port = port

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    # trace-id exemplars are a NONSTANDARD suffix the
                    # classic text parser rejects — served only on
                    # explicit opt-in (?exemplars=1) for tooling that
                    # understands it (tests, dashboards that
                    # pre-process). A plain Prometheus scrape always gets
                    # clean v0.0.4 text. (Accept-header OpenMetrics
                    # negotiation deliberately NOT attempted: modern
                    # Prometheus offers openmetrics-text by default, and
                    # this exposition isn't OM-conformant — counters
                    # lack _total, exemplars ride summaries.)
                    want_ex = "exemplars=1" in query.split("&")
                    body = registry.render_prometheus(
                        exemplars=want_ex).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/vars":
                    body = json.dumps(
                        registry.dump(), indent=1, sort_keys=True
                    ).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapers poll — keep stderr quiet
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
