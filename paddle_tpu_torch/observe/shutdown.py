"""Graceful-shutdown handlers: dump the evidence BEFORE dying.

The flight recorder dumps on crash/atexit (trace.py) and the registry
dumps when bench rows finish — but a SIGTERM from an orchestrator (or
a ctrl-C) kills the process through an exception path neither covers
reliably: daemon threads (the MetricsExporter) die mid-request, atexit
may never run if a second signal lands. This module installs
SIGTERM/SIGINT handlers that, in order:

1. count the signal (``paddle_shutdown_signals_total{signal}``),
2. dump the flight-recorder ring with ``reason="signal"``,
3. flush the telemetry sidecar — an atomic registry dump to
   ``PADDLE_TPU_TELEMETRY_SIDECAR`` when that knob is set,
4. stop the process-wide MetricsExporter (clean socket close, the
   port-file removed so a supervisor never scrapes a ghost),
5. chain to the previously-installed handler, or re-raise the signal
   under its default disposition — shutdown still LOOKS like the
   signal it was (exit code, parent's ``waitpid`` story) — so this is
   strictly an observer, never a trap that keeps a doomed process
   alive.

``install_shutdown_handlers()`` is idempotent;
``uninstall_shutdown_handlers()`` restores what was there (tests).
Handlers only install from the main thread (signal module rules);
elsewhere the call is a recorded no-op returning False.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Optional

__all__ = ["install_shutdown_handlers", "uninstall_shutdown_handlers",
           "ENV_SIDECAR"]

ENV_SIDECAR = "PADDLE_TPU_TELEMETRY_SIDECAR"

_installed: Dict[int, object] = {}  # signum -> previous handler
_lock = threading.Lock()


def _flush(signum: int) -> None:
    """The dump-everything sequence; every step is best-effort — a
    failing flush must not mask the shutdown."""
    from .families import REGISTRY, SHUTDOWN_SIGNALS
    from .trace import dump_flight_recorder

    try:
        SHUTDOWN_SIGNALS.labels(
            signal=signal.Signals(signum).name).inc()
    except Exception:  # noqa: BLE001
        pass
    dump_flight_recorder(reason="signal")  # never raises
    sidecar = os.environ.get(ENV_SIDECAR)
    if sidecar:
        try:
            REGISTRY.dump(sidecar)
        except Exception:  # noqa: BLE001
            pass
    try:
        from .export import stop_exporter

        stop_exporter(timeout=2.0)
    except Exception:  # noqa: BLE001
        pass


def _handler(signum, frame):
    _flush(signum)
    prev = _installed.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    if prev is signal.SIG_IGN:
        return
    # default disposition: die OF THIS SIGNAL (correct exit status),
    # not of a python-level exit — uninstall and re-send to ourselves
    with _lock:
        _installed.pop(signum, None)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install_shutdown_handlers(
        signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Install the graceful-shutdown handlers (idempotent). Returns
    True when installed, False off the main thread."""
    if threading.current_thread() is not threading.main_thread():
        return False
    with _lock:
        for signum in signals:
            signum = int(signum)
            if signum in _installed:
                continue
            _installed[signum] = signal.signal(signum, _handler)
    return True


def uninstall_shutdown_handlers() -> None:
    """Restore the previously-installed handlers (test isolation)."""
    if threading.current_thread() is not threading.main_thread():
        return
    with _lock:
        for signum, prev in list(_installed.items()):
            try:
                signal.signal(signum, prev)
            except (TypeError, ValueError):
                signal.signal(signum, signal.SIG_DFL)
            del _installed[signum]
