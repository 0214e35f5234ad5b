"""HTTP /metrics endpoint: the stdlib HTTP server on a daemon thread,
serving a registry's prometheus text exposition (AntidoteDB serves it on
port 3001)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from antidote_tpu_torch.obs.metrics import MetricsRegistry

DEFAULT_METRICS_PORT = 3001


class MetricsServer:
    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        registry_ref = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = registry_ref.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"metrics:{self.port}",
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
