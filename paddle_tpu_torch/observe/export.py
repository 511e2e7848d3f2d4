"""MetricsExporter: the live /metrics endpoint (background HTTP thread).

The registry (metrics.py) is post-mortem by default — a sidecar at
exit, a dump on crash. This module makes it LIVE: a daemon thread
serving

* ``/metrics``       — Prometheus text exposition (render_prometheus)
* ``/snapshot.json`` — the full JSON snapshot (``Registry.dump`` wire
  shape; what ``tools/stats_dump.py --watch`` and fleet_top poll)
* ``/healthz``       — liveness from the watchdog heartbeat: 200 while
  the process is idle or progressing, 503 once the oldest open
  dispatch has been busy past the stale deadline (JSON body carries
  the heartbeat snapshot either way)

Enablement is strictly opt-in, like ``PADDLE_TPU_TRACE``: with
``PADDLE_TPU_METRICS_PORT`` unset, :func:`start_from_env` returns None
— no thread, no socket, zero movement on any ``paddle_export_*``
family (tests pin exactly that). Port assignment follows the pserver
rendezvous pattern (bench.py ``_run_dist_ctr_pserver``): bind port 0
OURSELVES (no TOCTOU), then publish the real ``host:port`` atomically
to ``PADDLE_TPU_METRICS_PORT_FILE`` for whoever launched us —
tools/fleet_top.py and the fleet demo test read that file instead of
guessing ports.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["MetricsExporter", "active_exporter", "start_from_env",
           "stop_exporter", "default_instance",
           "ENV_PORT", "ENV_PORT_FILE"]

ENV_PORT = "PADDLE_TPU_METRICS_PORT"
ENV_PORT_FILE = "PADDLE_TPU_METRICS_PORT_FILE"


def default_instance() -> str:
    """This process's fleet identity: ``host:pid`` — unique across the
    single-host process fleets the tests/bench spawn, stable for the
    process lifetime, and human-readable in a dashboard row."""
    return "%s:%d" % (socket.gethostname(), os.getpid())


class _Handler(BaseHTTPRequestHandler):
    # the exporter must never spam a training job's stderr with
    # per-scrape access logs
    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib dispatch name
        from .families import EXPORT_HTTP_REQUESTS, REGISTRY

        exporter: "MetricsExporter" = self.server._exporter
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                # count first: a scrape sees itself, prometheus-style
                EXPORT_HTTP_REQUESTS.labels(endpoint="metrics").inc()
                body = REGISTRY.render_prometheus().encode()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/snapshot.json":
                EXPORT_HTTP_REQUESTS.labels(endpoint="snapshot").inc()
                snap = REGISTRY.snapshot()
                snap["instance"] = exporter.instance
                self._send(200, json.dumps(snap, sort_keys=True).encode(),
                           "application/json")
            elif path == "/healthz":
                EXPORT_HTTP_REQUESTS.labels(endpoint="healthz").inc()
                ok, payload = exporter.health()
                self._send(200 if ok else 503,
                           json.dumps(payload, sort_keys=True).encode(),
                           "application/json")
            else:
                EXPORT_HTTP_REQUESTS.labels(endpoint="other").inc()
                self._send(404, b"not found\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up mid-response; nothing to salvage


class MetricsExporter:
    """Background HTTP exposition of this process's registry.

    ``port=0`` (the default) lets the kernel pick — the REAL port is
    ``self.port`` after :meth:`start`, and is published atomically to
    ``port_file`` when one is given (tmp + os.replace, the same torn-
    read-proof hand-off as the pserver rendezvous)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 port_file: Optional[str] = None,
                 instance: Optional[str] = None,
                 stale_after_s: float = 300.0,
                 compile_grace_s: float = 1800.0):
        self._host = host
        self._want_port = int(port)
        self._port_file = port_file
        self.instance = instance or default_instance()
        self._stale_after_s = float(stale_after_s)
        self._compile_grace_s = float(compile_grace_s)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "MetricsExporter":
        from .families import EXPORT_LISTENING

        if self._server is not None:
            return self
        server = ThreadingHTTPServer((self._host, self._want_port),
                                     _Handler)
        server.daemon_threads = True
        server._exporter = self
        self._server = server
        self._thread = threading.Thread(target=server.serve_forever,
                                        name="MetricsExporter",
                                        daemon=True)
        self._thread.start()
        EXPORT_LISTENING.set(1)
        if self._port_file:
            tmp = self._port_file + ".tmp.%d" % os.getpid()
            with open(tmp, "w") as f:
                f.write(self.endpoint)
            os.replace(tmp, self._port_file)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        from .families import EXPORT_LISTENING

        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if thread is not None:
            thread.join(timeout=timeout)
        EXPORT_LISTENING.set(0)
        if self._port_file:
            try:
                os.remove(self._port_file)
            except OSError:
                pass  # never published, or the launcher cleaned up

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ----------------------------------------------------------- reading
    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("exporter not started")
        return self._server.server_address[1]

    @property
    def endpoint(self) -> str:
        """``host:port`` — the port-file payload and scrape target."""
        return "%s:%d" % (self._host, self.port)

    def health(self):
        """(ok, payload) for /healthz: unhealthy once the watchdog
        heartbeat's oldest open operation is busy past the stale
        deadline (compiles judged against the longer compile grace,
        same split as the Watchdog itself)."""
        from ..resilience.watchdog import heartbeat

        hb = heartbeat().snapshot()
        deadline = (self._compile_grace_s if hb["compiling"]
                    else self._stale_after_s)
        ok = hb["phase"] != "busy" or hb["age_s"] <= deadline
        return ok, {"ok": ok, "pid": os.getpid(),
                    "instance": self.instance, "heartbeat": hb}


# ------------------------------------------------- process-wide singleton
_ACTIVE: Optional[MetricsExporter] = None
_ACTIVE_LOCK = threading.Lock()


def active_exporter() -> Optional[MetricsExporter]:
    """The exporter :func:`start_from_env` started, if any."""
    return _ACTIVE


def start_from_env(instance: Optional[str] = None
                   ) -> Optional[MetricsExporter]:
    """Start the process-wide exporter iff ``PADDLE_TPU_METRICS_PORT``
    is set (its value is the port; 0 = kernel-assigned, published via
    ``PADDLE_TPU_METRICS_PORT_FILE`` when that is also set). Unset →
    None: no thread, no socket, no metric movement — THE zero-overhead
    off-switch. Idempotent: a second call returns the running one."""
    global _ACTIVE
    raw = os.environ.get(ENV_PORT, "").strip()
    if not raw:
        return None
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and _ACTIVE.running:
            return _ACTIVE
        _ACTIVE = MetricsExporter(
            port=int(raw),
            port_file=os.environ.get(ENV_PORT_FILE) or None,
            instance=instance).start()
        return _ACTIVE


def stop_exporter(timeout: float = 5.0) -> None:
    """Stop the process-wide exporter (idempotent; the graceful-
    shutdown path in observe/shutdown.py calls this)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        exp, _ACTIVE = _ACTIVE, None
    if exp is not None:
        exp.stop(timeout=timeout)
