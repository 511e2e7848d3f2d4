"""Profiler: host annotations + aggregation tables + chrome trace export.

The port of paddle_tpu/profiler.py. The host side is the JAX package's:

* ``RecordEvent`` RAII markers (the reference's platform/profiler.h:81),
  recorded on a host timeline (``_events``, microseconds since
  ``_start_ts`` on ``time.perf_counter``) while profiling is on;
  ``observe.export_chrome_trace`` merges that timeline with its span
  ring, as the JAX package's does;
* ``start_profiler`` / ``stop_profiler`` + the aggregated event table
  (calls / total / min / max / avg per event key) and the
  chrome://tracing JSON of the host events.

The device side is ``torch.profiler`` where the JAX package starts
``jax.profiler``'s trace: with state ``GPU`` or ``All`` a
``torch.profiler.profile`` session (the card's kernels when there is
one, else the CPU's ops) runs until ``stop_profiler``, which writes its
chrome trace into ``trace_dir``; each ``RecordEvent`` then also opens a
``torch.profiler.record_function`` range, so the markers show up on
that trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "cuda_profiler", "RecordEvent", "is_profiler_enabled"]

_lock = threading.Lock()
_enabled = False
_device_trace = None  # the running torch.profiler.profile session
_trace_dir: Optional[str] = None
_events: List[tuple] = []  # (name, start_us, end_us, thread_id)
_start_ts: Optional[float] = None


def _default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_trace")


def is_profiler_enabled() -> bool:
    return _enabled


def start_profiler(state: str = "All", trace_dir: Optional[str] = None):
    """EnableProfiler analog (profiler.h:166). state: CPU|GPU|All — GPU/All
    also starts the device trace (``torch.profiler``)."""
    global _enabled, _device_trace, _trace_dir, _start_ts
    with _lock:
        if _enabled:
            return
        _events.clear()
        _enabled = True
        _start_ts = time.perf_counter()
    if state in ("GPU", "All"):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        _device_trace = profile(activities=acts)
        _device_trace.__enter__()
        _trace_dir = trace_dir or _default_trace_dir()


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    """DisableProfiler analog: stop traces, print the aggregated event
    table, optionally dump a chrome://tracing JSON to profile_path."""
    global _enabled, _device_trace
    with _lock:
        if not _enabled:
            return
        _enabled = False
        events = list(_events)
    if _device_trace is not None:
        prof, _device_trace = _device_trace, None
        prof.__exit__(None, None, None)
        os.makedirs(_trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            _trace_dir, "device_trace_%d.json" % os.getpid()))
    _print_table(events, sorted_key)
    if profile_path:
        _write_chrome_trace(events, profile_path)


def reset_profiler():
    with _lock:
        _events.clear()


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """Context manager (python/paddle/fluid/profiler.py:39 analog)."""
    start_profiler(state, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*a, **kw):  # the reference's name; the device trace
    with profiler():
        yield


class RecordEvent:
    """RAII trace annotation (platform/profiler.h:81). Always feeds the
    host aggregation table; additionally shows up in the device trace
    when one is running."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._ann = None

    def __enter__(self):
        if _enabled:
            self._t0 = time.perf_counter()
        if _device_trace is not None:
            from torch.profiler import record_function

            self._ann = record_function(self.name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if self._t0 is not None:
            t1 = time.perf_counter()
            with _lock:
                if _enabled:
                    _events.append((
                        self.name,
                        (self._t0 - _start_ts) * 1e6,
                        (t1 - _start_ts) * 1e6,
                        threading.get_ident(),
                    ))
            self._t0 = None
        return False


def record_event(name: str) -> RecordEvent:
    return RecordEvent(name)


# ---------------------------------------------------------------- reporting
def _print_table(events, sorted_key=None):
    if not events:
        return
    agg: Dict[str, List[float]] = {}
    for name, s, e, _tid in events:
        agg.setdefault(name, []).append(e - s)
    rows = []
    for name, ds in agg.items():
        rows.append((name, len(ds), sum(ds), sum(ds) / len(ds), min(ds),
                     max(ds)))
    keyfn = {
        None: lambda r: -r[2],
        "default": lambda r: -r[2],
        "total": lambda r: -r[2],
        "calls": lambda r: -r[1],
        "ave": lambda r: -r[3],
        "min": lambda r: r[4],
        "max": lambda r: -r[5],
    }.get(sorted_key, lambda r: -r[2])
    rows.sort(key=keyfn)
    print("-------------------------  Profiling Report  "
          "-------------------------")
    print("%-40s %8s %12s %12s %12s %12s" %
          ("Event", "Calls", "Total(us)", "Avg(us)", "Min(us)", "Max(us)"))
    for name, calls, total, avg, mn, mx in rows:
        print("%-40s %8d %12.1f %12.1f %12.1f %12.1f" %
              (name[:40], calls, total, avg, mn, mx))


def _write_chrome_trace(events, path: str):
    """chrome://tracing JSON (tools/timeline.py output format analog)."""
    tids = {}
    trace = []
    for name, s, e, tid in events:
        tids.setdefault(tid, len(tids))
        trace.append({
            "name": name, "cat": "host", "ph": "X",
            "ts": s, "dur": e - s, "pid": os.getpid(),
            "tid": tids[tid],
        })
    with open(path, "w") as f:
        json.dump({"traceEvents": trace,
                   "displayTimeUnit": "ms"}, f)
