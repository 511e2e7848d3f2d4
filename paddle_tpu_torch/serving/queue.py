"""Bounded, thread-safe admission queue for serving requests.

The front door of the serving layer (docs/SERVING.md): callers submit
work and get a future back; schedulers (serving/batcher.py's
micro-batcher, serving/engine.py's continuous-batching loop) pop
admissible requests. Three contracts the reference framework leaves to
an external server, owned here:

* **Backpressure, never silent drops** — the queue is bounded; a
  submit against a full queue raises ``QueueFull`` and counts into
  ``paddle_serving_queue_rejected_total``. An overloaded server tells
  its callers so, instead of growing an unbounded backlog whose tail
  latency is infinite.
* **Deadlines** — a request may carry a relative deadline; if it is
  still queued when the deadline passes, the scheduler's pop skips it
  and fails it with ``DeadlineExpired``
  (``paddle_serving_deadline_expirations_total``) — compute is never
  spent on an answer nobody is waiting for. Deadlines cover QUEUE
  time: once admitted, a request runs to completion.
* **Cancellation** — ``request.cancel()`` wins only while the request
  is still pending; a cancelled request is skipped at pop time and its
  ``result()`` raises ``Cancelled``.

Every request reports a terminal outcome exactly once into
``paddle_serving_requests_total{outcome=ok|rejected|expired|cancelled|
error}``; time-in-queue lands in
``paddle_serving_queue_wait_seconds`` at admission.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional

from ..observe import trace as _tr

__all__ = ["Cancelled", "DeadlineExpired", "QueueFull", "RequestQueue",
           "ServingRequest"]


class QueueFull(RuntimeError):
    """The bounded admission queue rejected a submit (backpressure)."""


class Cancelled(RuntimeError):
    """The request was cancelled (by the caller, or by queue close)
    before it was dispatched."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed while it was still queued."""


# terminal states a request reports exactly once
_PENDING, _RUNNING, _DONE = "pending", "running", "done"


class ServingRequest:
    """A future over one serving request.

    ``payload`` is scheduler-defined (a feed dict for the
    micro-batcher, generation parameters for the decode engine).
    ``result(timeout)`` blocks for the value or raises the terminal
    exception (``Cancelled`` / ``DeadlineExpired`` / whatever the
    scheduler set); ``cancel()`` succeeds only while still queued.
    """

    __slots__ = ("payload", "rows", "submitted_at", "deadline", "trace",
                 "tenant", "report", "_lock", "_event", "_state",
                 "_value", "_exc", "_callbacks", "_finished")

    def __init__(self, payload: Any, deadline_s: Optional[float] = None,
                 rows: int = 1, tenant: str = "default",
                 trace_ctx=None, report: bool = True):
        if deadline_s is not None and deadline_s < 0:
            raise ValueError("deadline_s must be >= 0; got %r"
                             % (deadline_s,))
        self.payload = payload
        self.rows = int(rows)
        self.tenant = str(tenant)
        # report=False marks an INTERNAL attempt (the router re-submits
        # one logical request to engine replicas): it skips the
        # requests_total count and the submit/done trace events so the
        # caller-facing request stays the ONE reporting identity — the
        # exactly-once terminal-outcome invariant is per logical
        # request, not per attempt
        self.report = bool(report)
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + deadline_s
                         if deadline_s is not None else None)
        # one trace per request, born at submit and pinned on the object
        # — the explicit hand-off that lets the batcher/engine scheduler
        # threads link their spans back to this caller's request. A
        # caller-provided trace_ctx (the router's hop propagation) is
        # adopted instead of minting a second identity.
        if trace_ctx is not None:
            self.trace = trace_ctx
        else:
            self.trace = _tr.new_trace() if _tr.trace_enabled() else None
            if self.trace is not None and self.report:
                _tr.trace_event("serving.request.submit", ctx=self.trace,
                                rows=self.rows, tenant=self.tenant,
                                deadline_s=deadline_s)
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._state = _PENDING
        self._value = None
        self._exc: Optional[BaseException] = None
        self._callbacks: list = []
        self._finished = False

    # ------------------------------------------------------------ caller
    def cancel(self) -> bool:
        """Cancel a still-queued request. Returns True if the cancel
        won (the request will never be dispatched); False once the
        scheduler already admitted or finished it."""
        with self._lock:
            if self._state is not _PENDING:
                return False
            self._state = _DONE
            self._exc = Cancelled("request cancelled")
        self._finish("cancelled")
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the request completes; return its value or raise
        its terminal exception. ``timeout`` raises ``TimeoutError``
        WITHOUT finishing the request (it may still complete later)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not done within %ss" % timeout)
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not done within %ss" % timeout)
        return self._exc

    # --------------------------------------------------------- scheduler
    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (time.monotonic() if now is None else now) >= self.deadline

    def _admit(self) -> bool:
        """Pending -> running (pop-time transition). False when a
        concurrent cancel won."""
        with self._lock:
            if self._state is not _PENDING:
                return False
            self._state = _RUNNING
        return True

    def _expire(self) -> bool:
        from ..observe.families import SERVING_DEADLINE_EXPIRATIONS

        with self._lock:
            if self._state is not _PENDING:
                return False
            self._state = _DONE
            self._exc = DeadlineExpired(
                "deadline passed after %.3fs in queue"
                % (time.monotonic() - self.submitted_at))
        SERVING_DEADLINE_EXPIRATIONS.inc()
        self._finish("expired")
        return True

    def set_result(self, value) -> None:
        from ..observe.families import SERVING_REQUEST_SECONDS

        with self._lock:
            if self._state is _DONE:
                return  # cancel/expire already won
            self._state = _DONE
            self._value = value
        if self.report:
            SERVING_REQUEST_SECONDS.observe(
                time.monotonic() - self.submitted_at)
        self._finish("ok")

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._state is _DONE:
                return
            self._state = _DONE
            self._exc = exc
        # a scheduler cancelling admitted work (engine stop, batcher
        # shutdown) is a cancellation, not an error — routine shutdowns
        # must not read as error-rate spikes; a deadline surfacing
        # through the router hop is an expiry, same contract
        self._finish("cancelled" if isinstance(exc, Cancelled)
                     else "expired" if isinstance(exc, DeadlineExpired)
                     else "error")

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` once the request reaches its terminal
        state (immediately if already done). Callbacks run on whatever
        thread finishes the request, BEFORE ``result()`` waiters wake —
        so a router's bookkeeping (quota release, completion
        forwarding) is durable by the time the caller observes the
        outcome. Keep them cheap and non-blocking; exceptions are
        swallowed (a broken observer must not corrupt the scheduler
        thread that finished the request)."""
        run_now = False
        with self._lock:
            if self._finished:
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — observer must not kill caller
                pass

    def _reject(self, exc: BaseException) -> None:
        """Terminal-ize a stillborn request as outcome=rejected — the
        shared path for admission-time rejection (queue full, router
        quota/SLO), keeping the one-terminal-outcome invariant over
        every path."""
        with self._lock:
            if self._state is _DONE:
                return
            self._state = _DONE
            self._exc = exc
        self._finish("rejected")

    def _finish(self, outcome: str) -> None:
        from ..observe.families import SERVING_REQUESTS

        if self.report:
            # bounded cardinality contract: tenant ids are a deployment
            # configuration (quota keys), not caller-controlled free
            # text — docs/SERVING.md
            SERVING_REQUESTS.labels(outcome=outcome,
                                    tenant=self.tenant).inc()
            # the ONE terminal trace event per request — every terminal
            # path (ok / expired / cancelled / error, plus submit-time
            # rejection in RequestQueue.submit and the router's
            # quota/SLO rejections) funnels through here exactly once,
            # mirroring the requests_total{outcome} invariant
            if self.trace is not None:
                _tr.trace_event("serving.request.done", ctx=self.trace,
                                outcome=outcome)
        # callbacks BEFORE the event: result() waiters must observe a
        # world where the callbacks' bookkeeping already happened.
        # Terminal state (_value/_exc) is set by every caller before
        # _finish, so callbacks may read it directly.
        with self._lock:
            self._finished = True
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — observer must not kill scheduler
                pass
        self._event.set()


class RequestQueue:
    """Bounded FIFO of ``ServingRequest``s with reject-when-full
    admission, deadline/cancel skipping at pop time, and depth/wait
    telemetry. One queue feeds one scheduler loop; ``submit`` is safe
    from any number of caller threads."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("RequestQueue capacity must be >= 1")
        self.capacity = capacity
        self._cond = threading.Condition()
        self._q: "deque[ServingRequest]" = deque()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def submit(self, payload: Any, deadline_s: Optional[float] = None,
               rows: int = 1, tenant: str = "default", trace_ctx=None,
               report: bool = True) -> ServingRequest:
        """Enqueue and return the request future. Raises ``QueueFull``
        when the queue is at capacity (the rejection is counted — an
        overloaded server must be visible, not silent) and
        ``RuntimeError`` after ``close()``. ``tenant`` labels the
        request's terminal outcome; ``trace_ctx``/``report`` are the
        router's hop-propagation and attempt-demotion knobs (see
        ``ServingRequest``)."""
        from ..observe.families import (SERVING_QUEUE_DEPTH,
                                        SERVING_QUEUE_REJECTED)

        with self._cond:
            # closed check BEFORE constructing the request: a request
            # object mints a trace + submit event, and the closed path
            # raises without a terminal outcome — a trace with a submit
            # and no done event would break the exactly-once invariant
            if self._closed:
                raise RuntimeError("RequestQueue is closed")
            req = ServingRequest(payload, deadline_s=deadline_s, rows=rows,
                                 tenant=tenant, trace_ctx=trace_ctx,
                                 report=report)
            if len(self._q) >= self.capacity:
                SERVING_QUEUE_REJECTED.inc()
                exc = QueueFull(
                    "admission queue full (capacity %d); retry with "
                    "backoff or raise capacity" % self.capacity)
                # terminal-ize the stillborn request so the one-
                # terminal-outcome invariant (metric AND trace event)
                # covers rejection like every other path
                req._reject(exc)
                raise exc
            self._q.append(req)
            SERVING_QUEUE_DEPTH.set(len(self._q))
            self._cond.notify()
        return req

    def get(self, timeout: Optional[float] = None
            ) -> Optional[ServingRequest]:
        """Pop the next admissible request (FIFO), skipping cancelled
        requests and failing expired ones in passing. Returns None on
        timeout or when the queue is closed and drained. The returned
        request is already transitioned to running; observe its queue
        wait in ``paddle_serving_queue_wait_seconds``."""
        from ..observe.families import (SERVING_QUEUE_DEPTH,
                                        SERVING_QUEUE_WAIT_SECONDS)

        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cond:
            while True:
                while self._q:
                    req = self._q.popleft()
                    SERVING_QUEUE_DEPTH.set(len(self._q))
                    if req.done():      # cancelled while queued
                        continue
                    if req.expired():
                        req._expire()
                        continue
                    if not req._admit():
                        continue        # cancel raced the pop and won
                    wait = time.monotonic() - req.submitted_at
                    SERVING_QUEUE_WAIT_SECONDS.observe(wait)
                    if req.trace is not None:
                        # retroactive span: the wait is only known now
                        _tr.record_span("serving.queue.wait",
                                        time.perf_counter() - wait, wait,
                                        ctx=req.trace)
                    return req
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def close(self) -> None:
        """Refuse new submits and fail every still-pending request with
        ``Cancelled`` — a shutdown never strands a caller blocked in
        ``result()``. Idempotent."""
        from ..observe.families import SERVING_QUEUE_DEPTH

        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            SERVING_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        for req in pending:
            req.cancel()
