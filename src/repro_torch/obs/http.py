"""Live scrape endpoint: a stdlib ``ThreadingHTTPServer`` over the
observability plane.

Four routes, all GET, all read-only:

    /metrics   Prometheus text exposition (``obs/prom.render``)
    /healthz   liveness — ``ok`` and 200 while the server thread runs
    /slo       burn-rate monitor status as JSON (404 when no monitor)
    /vars      windowed live stats as JSON (404 when no monitor)

Thread-safety contract with the engine: every request re-evaluates
``registry_fn()`` and renders from whatever registry object it returns.
``Engine.reset_stats()`` *swaps* the registry attribute atomically (one
Python attribute store), so a concurrent scrape renders either the old
or the new registry — always a self-consistent object, never a torn
mix.  Histogram appends racing a render can at worst make ``_count``
lag ``_sum`` by the in-flight sample; the exposition stays parseable
(``chip_smoke.py`` scrapes mid-decode and round-trips ``prom.parse``).

``attach()`` duck-types the served object: an ``Engine`` (``.metrics``)
or a ``ReplicaRouter`` (``.merged_metrics()``: scrapes aggregate the
fleet), picking up ``windowed_vars``/``slo_state`` when present.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .prom import render

__all__ = ["MetricsServer", "attach", "split_listen"]


def split_listen(listen: str) -> tuple[str, int]:
    """``"HOST:PORT"`` -> (host, port); port 0 binds an ephemeral port
    (the server reports the real one)."""
    host, sep, port = listen.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--listen expects HOST:PORT, got {listen!r}"
        )
    return host, int(port)


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet: no per-scrape stderr
        return

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
        path = self.path.split("?", 1)[0]
        route = self.server.routes.get(path)  # type: ignore[attr-defined]
        if route is None:
            self._send(404, b"not found\n", "text/plain; charset=utf-8")
            return
        fn, ctype = route
        try:
            body = fn()
        except Exception as e:  # never kill the serving thread
            self._send(
                500,
                f"internal error: {e}\n".encode(),
                "text/plain; charset=utf-8",
            )
            return
        if isinstance(body, str):
            body = body.encode()
        self._send(200, body, ctype)


class MetricsServer:
    """Daemon-threaded scrape endpoint bound to ``host:port`` (port 0
    -> ephemeral; read the bound one back from ``.port`` / ``.url``)."""

    _PROM = "text/plain; version=0.0.4; charset=utf-8"
    _JSON = "application/json; charset=utf-8"

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        registry_fn: Callable,
        vars_fn: Callable | None = None,
        slo_fn: Callable | None = None,
    ):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        routes: dict[str, tuple[Callable, str]] = {
            "/metrics": (lambda: render(registry_fn()), self._PROM),
            "/healthz": (lambda: "ok\n", "text/plain; charset=utf-8"),
        }
        if vars_fn is not None:
            routes["/vars"] = (
                lambda: json.dumps(vars_fn(), sort_keys=True) + "\n",
                self._JSON,
            )
        if slo_fn is not None:
            routes["/slo"] = (
                lambda: json.dumps(slo_fn(), sort_keys=True) + "\n",
                self._JSON,
            )
        self._httpd.routes = routes  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-metrics-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def attach(served, listen: str = "127.0.0.1:0") -> MetricsServer:
    """Start a :class:`MetricsServer` over an ``Engine`` or a
    ``ReplicaRouter`` (``serve --listen HOST:PORT`` calls this)."""
    host, port = split_listen(listen)
    if hasattr(served, "merged_metrics"):
        registry_fn = served.merged_metrics
    else:
        registry_fn = lambda: served.metrics  # noqa: E731
    vars_fn = getattr(served, "windowed_vars", None)
    slo_fn = getattr(served, "slo_state", None)
    return MetricsServer(
        host,
        port,
        registry_fn=registry_fn,
        vars_fn=vars_fn,
        slo_fn=slo_fn,
    ).start()
