"""Dynamic micro-batching for ``Predictor`` workloads.

Single-request serving leaves a dispatch-latency-bound device at ~1/B
of its batched throughput: every caller pays one whole XLA dispatch for
one row. The micro-batcher closes that gap host-side (the same
"restructure host scheduling to keep the device saturated" lever as
core/pipeline.py, applied to inference):

    caller threads ──▶ RequestQueue ──▶ batcher thread
                                         coalesce within max_wait_s
                                         (up to max_rows rows)
                                         one Predictor.run
                                         slice rows back per request
                                         └▶ per-request futures

The coalesced batch goes through ``Predictor.run``'s bucket router
(inference/__init__.py): it pads up to the nearest
``warmup_batch_sizes`` bucket, so steady-state traffic — whatever
request mix arrives — reuses the warmed executables and never triggers
a fresh XLA compile. Batcher and direct callers share that one code
path; the batcher only decides WHICH rows ride together.

Telemetry: ``paddle_serving_batches_total``,
``paddle_serving_batch_rows`` (rows per micro-batch, pre-padding), and
the queue/bucket families (docs/SERVING.md). Per-request latency lands
in ``paddle_serving_request_seconds``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..inference import batch_major
from ..observe import trace as _tr
from .queue import RequestQueue

__all__ = ["MicroBatcher"]


class MicroBatcher:
    """Coalesce concurrent ``Predictor`` requests into one dispatch.

    ``submit(feed)`` takes a dict of name -> batch-major array (all
    carrying the same leading row count, usually 1) and returns a
    ``ServingRequest`` whose ``result()`` is the list of fetch arrays
    for exactly those rows. The background thread takes the oldest
    queued request, then keeps coalescing until ``max_wait_s`` elapses
    or ``max_rows`` rows are gathered, runs ONE ``predictor.run`` and
    slices each request's rows back out.

    ``max_wait_s`` is the latency the first-arriving request donates to
    batching; under load the batch fills before the window closes and
    nobody waits. ``autostart=False`` leaves the thread stopped (tests
    build a deterministic backlog first, then ``start()``).
    """

    def __init__(self, predictor, max_rows: int = 32,
                 max_wait_s: float = 0.005, queue_capacity: int = 128,
                 autostart: bool = True):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        for v in predictor.fetch_vars:
            if not batch_major(v):
                raise ValueError(
                    "MicroBatcher needs batch-major fetches to slice "
                    "per-request rows back out; fetch %r has static "
                    "shape %s" % (v.name, (v.shape,)))
        block = predictor.program.global_block()
        for n in predictor.get_input_names():
            if not batch_major(block.vars.get(n)):
                # _dispatch concatenates EVERY feed along axis 0: a
                # fixed-shape input works solo but breaks the first
                # time two requests coalesce — reject it up front
                raise ValueError(
                    "MicroBatcher needs batch-major feeds to coalesce "
                    "requests; feed %r has static shape %s" %
                    (n, (getattr(block.vars.get(n), "shape", None),)))
        self._predictor = predictor
        self._feed_names = set(predictor.get_input_names())
        self._max_rows = max_rows
        self._max_wait_s = max_wait_s
        self.queue = RequestQueue(queue_capacity)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="MicroBatcher", daemon=True)
        self._started = False
        if autostart:
            self.start()

    # ------------------------------------------------------------ caller
    def submit(self, feed: Dict[str, np.ndarray],
               deadline_s: Optional[float] = None):
        """Enqueue one request. ``feed`` maps every predictor input
        name to a batch-major array; all arrays must share the same
        leading row count. Raises ``QueueFull`` under backpressure."""
        if set(feed) != self._feed_names:
            raise ValueError(
                "feed names %s do not match predictor inputs %s"
                % (sorted(feed), sorted(self._feed_names)))
        feed = {n: np.asarray(v) for n, v in feed.items()}
        rows = {v.shape[0] if v.ndim else 0 for v in feed.values()}
        if len(rows) != 1 or 0 in rows:
            raise ValueError(
                "all feeds must share one leading row count; got %s"
                % ({n: v.shape for n, v in feed.items()},))
        (n_rows,) = rows
        return self.queue.submit(feed, deadline_s=deadline_s,
                                 rows=n_rows)

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the batcher thread and fail pending requests with
        ``Cancelled`` (queue close). Idempotent."""
        self._stop.set()
        self.queue.close()
        if self._started:
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------ thread
    def _loop(self) -> None:
        carry = None   # request popped but too big for the last batch
        while not self._stop.is_set():
            first = carry or self.queue.get(timeout=0.05)
            carry = None
            if first is None:
                continue
            batch = [first]
            rows = first.rows
            window_end = time.monotonic() + self._max_wait_s
            while rows < self._max_rows:
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self.queue.get(timeout=remaining)
                if nxt is None:
                    break
                if rows + nxt.rows > self._max_rows:
                    # would overflow max_rows (and with it the largest
                    # warmup bucket — the recompile the batcher exists
                    # to prevent): seed the NEXT micro-batch instead.
                    # A single request larger than max_rows still rides
                    # alone (it can't be split) and may bucket-miss.
                    carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._dispatch(batch, rows)
        if carry is not None:
            # popped (so queue.close can't cancel it) but never
            # dispatched: fail it rather than strand its caller
            from .queue import Cancelled

            carry.set_exception(Cancelled("batcher stopped"))

    def _dispatch(self, batch, rows: int) -> None:
        from ..observe.families import SERVING_BATCH_ROWS, SERVING_BATCHES

        SERVING_BATCHES.inc()
        SERVING_BATCH_ROWS.observe(rows)
        # the batch span lists the traces it carries ("traces") so a
        # request's coalesce + bucket-routed dispatch time is
        # attributable even though B requests share one Predictor.run;
        # the executor's dispatch span nests under this one
        sp = _tr.trace_span("serving.batch.dispatch", rows=rows,
                            requests=len(batch))
        if sp.attrs is not None:
            sp.attrs["traces"] = [r.trace.trace_id for r in batch
                                  if r.trace is not None]
        with sp:
            try:
                feed = {n: np.concatenate([r.payload[n] for r in batch])
                        for n in self._feed_names}
                outs = self._predictor.run(feed)
            except BaseException as exc:  # noqa: BLE001 — fail the batch's futures
                for r in batch:
                    r.set_exception(exc)
                return
            off = 0
            for r in batch:
                r.set_result([o[off:off + r.rows] for o in outs])
                off += r.rows
