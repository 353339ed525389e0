"""Telemetry HTTP endpoint: ``/metrics`` + ``/healthz`` on a daemon thread.

Counterpart of ``distributed_tensorflow_tpu/obs/http.py``, the port's own
copy.  Stdlib ``http.server`` only; ``ThreadingHTTPServer`` so a slow
scraper cannot block a liveness probe; the thread is a daemon so a
training process never hangs on exit because a scraper holds a
connection.

* ``GET /metrics`` — Prometheus text exposition from the registry.
* ``GET /healthz`` — JSON health document from ``health_fn`` (default
  ``{"status": "ok"}``); a ``health_fn`` raising marks the replica
  unhealthy (HTTP 503) instead of crashing the server.
* ``GET /statusz`` — JSON *debug* snapshot: the active goodput split
  (``obs.goodput``), the active critical-path ledger, active-tracer
  event counts, request-trace ring occupancy, plus whatever
  ``statusz_fn`` contributes (a serving replica passes ``Engine.stats()``
  through here).

``port=0`` binds an ephemeral port (tests, several replicas a host);
the bound port is ``server.port`` after ``start()``.  The server binds
loopback (``127.0.0.1``) unless given another ``host``.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .metrics import Registry

__all__ = ["MetricsServer", "default_statusz"]


def default_statusz() -> dict:
    """The process-wide debug snapshot ``/statusz`` serves: whatever the
    module-level obs sinks are currently tracking.  Lazy imports keep
    http importable standalone; every section degrades to absence, so
    the endpoint always answers."""
    from . import critpath as critpath_lib
    from . import goodput as goodput_lib
    from . import reqtrace
    from . import trace as trace_lib
    doc: dict = {}
    acct = goodput_lib.active()
    if acct is not None:
        doc["goodput"] = acct.report()
    led = critpath_lib.active()
    if led is not None:
        # headline interference ratio + the top-K slow-request table
        # (docs/OBSERVABILITY.md §Critical path)
        doc["critpath"] = led.statusz()
    tracer = trace_lib.active_tracer()
    if tracer is not None and tracer.enabled:
        doc["trace"] = {"events": len(tracer.events()),
                        "instant_counts": dict(tracer.instant_counts)}
    doc["reqtrace"] = {"enabled": reqtrace.enabled(),
                       "live": len(reqtrace.live_ids()),
                       "completed_ring": len(reqtrace.completed()),
                       "forensics": len(reqtrace.forensics_log())}
    return doc

log = logging.getLogger(__name__)

_EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background HTTP server exposing a metrics registry + health."""

    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], dict]] = None,
                 statusz_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry
        self.host = host
        self.requested_port = int(port)
        self.health_fn = health_fn or (lambda: {"status": "ok"})
        # extra /statusz fields merged OVER the default snapshot (a
        # serving replica contributes Engine.stats() through this)
        self.statusz_fn = statusz_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ server

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stdout noise per scrape
                log.debug("metrics-http: " + fmt, *args)

            def _send(self, code: int, content_type: str,
                      body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server.registry.expose().encode("utf-8")
                    self._send(200, _EXPOSITION_CONTENT_TYPE, body)
                elif path == "/healthz":
                    try:
                        doc, code = dict(server.health_fn()), 200
                        if doc.get("status") not in (None, "ok"):
                            code = 503
                    except Exception as e:  # unhealthy, not crashed
                        doc, code = {"status": "error", "error": str(e)}, 503
                    self._send(code, "application/json",
                               json.dumps(doc).encode("utf-8"))
                elif path == "/statusz":
                    try:
                        doc = default_statusz()
                        if server.statusz_fn is not None:
                            doc.update(server.statusz_fn())
                        code = 200
                    except Exception as e:  # debuggable, not crashed
                        doc, code = {"error": str(e)}, 500
                    self._send(code, "application/json",
                               json.dumps(doc, default=str)
                               .encode("utf-8"))
                else:
                    self._send(404, "text/plain; charset=utf-8",
                               b"not found (try /metrics, /healthz, "
                               b"or /statusz)\n")

        self._httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dttpu-metrics-http",
                                        daemon=True)
        self._thread.start()
        log.info("telemetry endpoint at %s (/metrics, /healthz, "
                 "/statusz)", self.url)
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self.requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None
