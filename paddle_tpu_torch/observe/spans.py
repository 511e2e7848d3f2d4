"""Step spans: timed scopes that feed BOTH the metrics registry and the
profiler's chrome-trace timeline.

A ``span`` is the composition of two records: entering one starts a
``torch.profiler.record_function`` (so when the profiler is on, the span
lands in the same event table and chrome://tracing JSON as every other
host annotation) and, on exit, ALWAYS records the elapsed time into a
histogram — metrics accumulate whether or not a profiling
session is active. Instrumented call sites therefore never need two
wrappers.
"""

from __future__ import annotations

import threading
import time

from .families import REGISTRY, SPAN_SECONDS  # noqa: F401  (REGISTRY is
#   re-exported for span() declarers; the span family itself is declared
#   in families.py so every family name lives in one module — the
#   tools/repo_lint.py contract)

__all__ = ["Span", "span", "mark_batch_produced", "observe_feed_gap"]


class Span:
    """Context manager: chrome-trace annotation + latency histogram.

    ``histogram``: a Histogram child/family to record into (defaults to
    the generic ``paddle_span_seconds{span=<name>}`` series).
    ``counter``: optional Counter child/family inc'd once per exit.
    """

    __slots__ = ("name", "_hist", "_counter", "_t0", "_rec")

    def __init__(self, name: str, histogram=None, counter=None):
        self.name = name
        self._hist = histogram
        self._counter = counter
        self._t0 = None
        self._rec = None

    def __enter__(self):
        from torch.profiler import record_function

        self._rec = record_function(self.name)
        self._rec.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rec.__exit__(*exc)
        self._rec = None
        hist = self._hist if self._hist is not None \
            else SPAN_SECONDS.labels(span=self.name)
        hist.observe(dt)
        if self._counter is not None:
            self._counter.inc()
        return False


def span(name: str, histogram=None, counter=None) -> Span:
    return Span(name, histogram=histogram, counter=counter)


# ------------------------------------------------------- feed-to-run gap
# The input pipeline stamps "a batch was handed to this thread"
# (mark_batch_produced, from reader.batch / MultiSlotDataFeed /
# DevicePrefetcher hand-off); the executor reads-and-clears the stamp at
# dispatch entry (observe_feed_gap). The observed gap separates
# input-bound from compute-bound steady states without a profiler run.
# THREAD-LOCAL: a background fill thread (buffered(), DevicePrefetcher)
# runs the wrapped reader concurrently with the consumer's step loop —
# a shared stamp would let batch N+1's production overwrite batch N's
# hand-off between stamp and observe, recording a gap against the wrong
# batch. Thread-wrapping readers re-stamp at hand-off in the consumer.
_batch_stamp = threading.local()

from .families import FEED_TO_RUN_GAP_SECONDS  # noqa: E402


def mark_batch_produced() -> None:
    _batch_stamp.ts = time.perf_counter()


def observe_feed_gap() -> None:
    ts = getattr(_batch_stamp, "ts", None)
    if ts is not None:
        _batch_stamp.ts = None
        FEED_TO_RUN_GAP_SECONDS.observe(time.perf_counter() - ts)


def _clear_batch_stamp() -> None:
    _batch_stamp.ts = None
